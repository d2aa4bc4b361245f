"""Plane-form ray-triangle intersection over every triangle, in plain PyTorch.

A frozen copy of the plain versions in ``nrc_tpu_torch/ops/intersect_cuda.py``
(the packed plane table and the all-pairs test in K1/K2's operation order),
without the kernels: each triangle becomes its supporting plane and two
barycentric planes, so that per ray

    t = -(n.o + d0) / (n.d),   u = (a_u.o + b_u) + t (a_u.d),   v likewise,

and a hit needs u >= 0, v >= 0, u + v <= 1, tmin < t < tmax. The closest
hit keeps the smallest t, ties to the lowest triangle index.
"""

from __future__ import annotations

import torch

from ..utils.math import cross, dot
from .intersect import RT_MAX, Hit, TriSoA, hit_from_t_prim

# rays per chunk: one [chunk, T] float32 plane stays at 128 MB
_PLAIN_CHUNK_ELEMS = 1 << 25


def build_plane_table(tris: TriSoA) -> torch.Tensor:
    """[T, 24] packed plane table (``intersect_pallas.py:58-82``)."""
    n = cross(tris.e1, tris.e2)                      # [T, 3]
    nn = dot(n, n)                                   # [T]
    ok = nn > 0.0
    inv_nn = torch.where(ok, 1.0 / torch.where(ok, nn, torch.ones_like(nn)), torch.zeros_like(nn))
    a_u = cross(tris.e2, n) * inv_nn[:, None]
    a_v = cross(n, tris.e1) * inv_nn[:, None]
    n = torch.where(ok[:, None], n, torch.zeros_like(n))
    d0 = -dot(n, tris.p0)
    b_u = -dot(a_u, tris.p0)
    b_v = -dot(a_v, tris.p0)
    zero = torch.zeros_like(d0)

    def plane(vec, const):
        return torch.cat([vec, const[:, None]], dim=-1)

    return torch.cat(
        [plane(n, d0), plane(n, zero), plane(a_u, b_u), plane(a_u, zero),
         plane(a_v, b_v), plane(a_v, zero)],
        dim=-1,
    ).contiguous()


def _tile_hits(org, direction, planes, tmin, tmax):
    """All-pairs plane test for a chunk of rays -> (t [n, T], ok [n, T]).
    The operation order is the CUDA kernel's (``csrc/intersect_planes.cu``)."""
    ox, oy, oz = org[:, 0:1], org[:, 1:2], org[:, 2:3]
    dx, dy, dz = direction[:, 0:1], direction[:, 1:2], direction[:, 2:3]
    p = planes.T  # [24, T]

    def dot_o(k):
        return ((ox * p[k] + oy * p[k + 1]) + oz * p[k + 2]) + p[k + 3]

    def dot_d(k):
        return (dx * p[k] + dy * p[k + 1]) + dz * p[k + 2]

    an, bn = dot_o(0), dot_d(4)
    au, bu = dot_o(8), dot_d(12)
    av, bv = dot_o(16), dot_d(20)
    t = -an / bn                                   # NaN/inf on degenerate
    u = au + t * bu
    v = av + t * bv
    ok = (
        (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
        & (t > tmin[:, None]) & (t < tmax[:, None])
    )
    return t, ok


def _chunks(n: int, num_tris: int):
    step = max(1, _PLAIN_CHUNK_ELEMS // max(num_tris, 1))
    return [(s, min(s + step, n)) for s in range(0, n, step)]


def closest_plain(org, direction, planes, tmin, tmax):
    """Plain version of K1 -> (t [N] f32, prim [N] i64; RT_MAX / -1 = miss)."""
    n = org.shape[0]
    t_out = torch.full((n,), RT_MAX, dtype=torch.float32, device=org.device)
    prim = torch.full((n,), -1, dtype=torch.int64, device=org.device)
    if planes.shape[0] == 0:
        return t_out, prim
    for a, b in _chunks(n, planes.shape[0]):
        t, ok = _tile_hits(org[a:b], direction[a:b], planes, tmin[a:b], tmax[a:b])
        tt = torch.where(ok, t, torch.full_like(t, RT_MAX))
        best_t, best_i = torch.min(tt, dim=1)  # first (lowest) index on ties
        hit = best_t < RT_MAX
        t_out[a:b] = best_t
        prim[a:b] = torch.where(hit, best_i, torch.full_like(best_i, -1))
    return t_out, prim


def occluded_plain(org, direction, planes, tmin, tmax):
    """Plain version of K2 -> bool [N] (True = some hit in (tmin, tmax))."""
    n = org.shape[0]
    occ = torch.zeros((n,), dtype=torch.bool, device=org.device)
    if planes.shape[0] == 0:
        return occ
    for a, b in _chunks(n, planes.shape[0]):
        _, ok = _tile_hits(org[a:b], direction[a:b], planes, tmin[a:b], tmax[a:b])
        occ[a:b] = ok.any(dim=1)
    return occ


def _finish(org, direction, tris, t, prim) -> Hit:
    prim = torch.where(prim >= tris.num, torch.full_like(prim, -1), prim)  # padded-tri guard
    return hit_from_t_prim(org, direction, tris, t, prim)


def intersect_planes(org, direction, planes, tris: TriSoA, tmin, tmax) -> Hit:
    """Closest hit over all triangles. org/direction [N, 3], tmin/tmax [N]."""
    t, prim = closest_plain(org, direction, planes, tmin, tmax)
    return _finish(org, direction, tris, t, prim)


def occluded_planes(org, direction, planes, tmin, tmax) -> torch.Tensor:
    """Any-hit visibility -> bool [N] (True = occluded)."""
    return occluded_plain(org, direction, planes, tmin, tmax)
