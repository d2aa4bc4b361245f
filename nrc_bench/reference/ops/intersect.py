"""Ray-scene intersection: triangle SoA, hit records and the dispatcher.

The benchmark's reference: a frozen copy of ``nrc_tpu_torch/ops/
intersect.py`` whose ``make_intersectors`` runs plain PyTorch on every
device: the plane form of ``ops/planes.py`` over every triangle (K1/K2's
arithmetic), or, for a scene in clusters (above ``BVH_THRESHOLD``),
Möller-Trumbore over every triangle of the boxes a ray meets
(``ops/brute.py``, the walk's arithmetic).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..utils.math import dot
from .gather import gather_rows

RT_MAX = float(np.float32(3.0e38))
BVH_THRESHOLD = 16384  # upload_scene builds the wide BVH above this many triangles


class TriSoA(NamedTuple):
    """Triangle SoA for the plane table and the Möller–Trumbore epilogue."""

    p0: torch.Tensor  # [T, 3]
    e1: torch.Tensor  # [T, 3] = p1 - p0
    e2: torch.Tensor  # [T, 3] = p2 - p0
    packed: Optional[torch.Tensor] = None  # [T, 9] = p0|e1|e2, the epilogue's row table

    @staticmethod
    def build(p0, p1, p2, device=None) -> "TriSoA":
        def f(x):
            return torch.as_tensor(np.asarray(x, np.float32), device=device)

        p0 = f(p0)
        e1, e2 = f(p1) - p0, f(p2) - p0
        return TriSoA(p0, e1, e2, torch.cat([p0, e1, e2], dim=-1))

    @property
    def num(self) -> int:
        return self.p0.shape[0]

    def gather_rows(self, idx):
        """(p0, e1, e2) rows by index through one packed row gather."""
        packed = self.packed if self.packed is not None else torch.cat(
            [self.p0, self.e1, self.e2], dim=-1)
        row = gather_rows(packed, idx)
        return row[:, 0:3], row[:, 3:6], row[:, 6:9]


class Hit(NamedTuple):
    t: torch.Tensor      # [N] f32, RT_MAX when missed
    prim: torch.Tensor   # [N] i64, -1 when missed
    u: torch.Tensor      # [N] f32 barycentric
    v: torch.Tensor      # [N] f32

    @property
    def valid(self) -> torch.Tensor:
        return self.prim >= 0


def hit_from_t_prim(org, direction, tris: TriSoA, t, prim) -> Hit:
    """Winner (t, prim) -> full Hit with the barycentrics re-derived by
    Möller–Trumbore for the single winner per ray (``intersect.py:486-506``)."""
    valid = prim >= 0
    pi = torch.clamp(prim, min=0)
    p0, e1, e2 = tris.gather_rows(pi)
    pvec = torch.linalg.cross(direction, e2, dim=-1)
    det = dot(e1, pvec)
    inv_det = torch.where(
        torch.abs(det) > 1e-12,
        1.0 / torch.where(det != 0, det, torch.ones_like(det)),
        torch.zeros_like(det),
    )
    tvec = org - p0
    u = dot(tvec, pvec) * inv_det
    qvec = torch.linalg.cross(tvec, e1, dim=-1)
    v = dot(direction, qvec) * inv_det
    zero = torch.zeros_like(u)
    return Hit(
        t=torch.where(valid, t, torch.full_like(t, RT_MAX)),
        prim=prim,
        u=torch.where(valid, u, zero),
        v=torch.where(valid, v, zero),
    )


def make_intersectors(tris: TriSoA, planes: Optional[torch.Tensor] = None, bvh=None):
    """Return (closest_hit_fn, any_hit_fn); both take (org [N,3], dir [N,3],
    tmin [N], tmax [N]).

    With ``bvh`` (the scene's ``Clusters``) every triangle of a met box is
    tested by Möller-Trumbore; without, every triangle through the packed
    plane table ``planes`` (built here when not given).
    """
    if bvh is not None:
        from .brute import intersect_mt, occluded_mt

        return (
            lambda o, d, tn, tf: intersect_mt(o, d, bvh, tris, tn, tf),
            lambda o, d, tn, tf: occluded_mt(o, d, bvh, tn, tf),
        )
    from .planes import build_plane_table, intersect_planes, occluded_planes

    if planes is None:
        planes = build_plane_table(tris)
    return (
        lambda o, d, tn, tf: intersect_planes(o, d, planes, tris, tn, tf),
        lambda o, d, tn, tf: occluded_planes(o, d, planes, tn, tf),
    )
