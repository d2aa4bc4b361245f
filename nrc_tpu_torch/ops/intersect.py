"""Ray-scene intersection: triangle SoA, hit records and the dispatcher.

Port of the brute-force side of ``nrc_tpu/ops/intersect.py``. For scenes
below ``BVH_THRESHOLD`` triangles every ray is tested against every triangle
in the plane form of ``ops/intersect_cuda.py``: on a CUDA tensor through
the hand-written kernels K1/K2, on a CPU tensor through their plain
versions. Larger scenes need the wide BVH, which is not ported yet: they
raise.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..utils.math import dot

RT_MAX = float(np.float32(3.0e38))
BVH_THRESHOLD = 16384  # scenes above this many triangles need the BVH walk


class TriSoA(NamedTuple):
    """Triangle SoA for the plane table and the Möller–Trumbore epilogue."""

    p0: torch.Tensor  # [T, 3]
    e1: torch.Tensor  # [T, 3] = p1 - p0
    e2: torch.Tensor  # [T, 3] = p2 - p0

    @staticmethod
    def build(p0, p1, p2, device=None) -> "TriSoA":
        def f(x):
            return torch.as_tensor(np.asarray(x, np.float32), device=device)

        p0 = f(p0)
        return TriSoA(p0, f(p1) - p0, f(p2) - p0)

    @property
    def num(self) -> int:
        return self.p0.shape[0]


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
    p0, e1, e2 = tris.p0[pi], tris.e1[pi], tris.e2[pi]
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


def check_brute_force(num_triangles: int) -> None:
    if num_triangles > BVH_THRESHOLD:
        raise NotImplementedError(
            f"{num_triangles} triangles > BVH_THRESHOLD={BVH_THRESHOLD}: "
            "the wide BVH walk is not ported yet"
        )


def make_intersectors(tris: TriSoA, planes: Optional[torch.Tensor] = None):
    """Return (closest_hit_fn, any_hit_fn) over all triangles.

    ``planes`` is the packed plane table of ``build_plane_table`` (built
    here when not given). Both functions take (org [N,3], dir [N,3],
    tmin [N], tmax [N]).
    """
    from .intersect_cuda import build_plane_table, intersect_planes, occluded_planes

    check_brute_force(tris.num)
    if planes is None:
        planes = build_plane_table(tris)
    return (
        lambda o, d, tn, tf: intersect_planes(o, d, planes, tris, tn, tf),
        lambda o, d, tn, tf: occluded_planes(o, d, planes, tn, tf),
    )
