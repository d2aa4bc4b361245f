"""Closest hit and visibility over every triangle by Möller-Trumbore, in plain PyTorch.

The reference's intersection for a scene above ``BVH_THRESHOLD`` triangles,
where the program walks its wide BVH (W1/W2) and rasters depth 0 (R1). No
tree is built: the triangles are taken in clusters of ``CLUSTER``
consecutive ones, each with its box grown by a margin, every ray is tested
against every box, and every triangle of a box the ray meets goes through
Möller-Trumbore in the operation order of the walk's leaf test
(``nrc_tpu_torch/ops/intersect_wide.py::_leaf_tri_t``, copied below), so
that t comes out with the same bits as the walk's. The closest hit keeps
the smallest t, ties to the lowest triangle index; a box only decides which
triangles are tested, never a result, since the margin (1e-4 of the scene's
extent) is far wider than any rounding of a hit point.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .intersect import RT_MAX, Hit, TriSoA, hit_from_t_prim

CLUSTER = 64
# bounds on the work of one pass: ray-box tests and (ray, cluster) pairs
_BOX_TESTS = 1 << 26
_PAIRS = 1 << 17


class Clusters(NamedTuple):
    """Triangles in clusters of ``CLUSTER``: [K, C, 9] rows p0|e1|e2 (the
    padding zero), [K, C] triangle ids (-1 on padding) and each cluster's
    grown box [K, 3] lo and hi."""

    rows: torch.Tensor
    pid: torch.Tensor
    lo: torch.Tensor
    hi: torch.Tensor


def build_clusters(tris: TriSoA) -> Clusters:
    t = tris.num
    k = -(-t // CLUSTER)
    dev = tris.p0.device
    rows = torch.zeros((k * CLUSTER, 9), dtype=torch.float32, device=dev)
    rows[:t] = torch.cat([tris.p0, tris.e1, tris.e2], dim=-1)
    pid = torch.full((k * CLUSTER,), -1, dtype=torch.int64, device=dev)
    pid[:t] = torch.arange(t, device=dev)
    corners = torch.stack([tris.p0, tris.p0 + tris.e1, tris.p0 + tris.e2], dim=1)  # [T, 3, 3]
    lo = torch.full((k * CLUSTER, 3), float("inf"), device=dev)
    hi = torch.full((k * CLUSTER, 3), float("-inf"), device=dev)
    lo[:t] = corners.amin(dim=1)
    hi[:t] = corners.amax(dim=1)
    lo = lo.view(k, CLUSTER, 3).amin(dim=1)
    hi = hi.view(k, CLUSTER, 3).amax(dim=1)
    margin = 1e-4 * float((hi.amax(dim=0) - lo.amin(dim=0)).amax()) + 1e-6
    return Clusters(rows.view(k, CLUSTER, 9), pid.view(k, CLUSTER), lo - margin, hi + margin)


def _leaf_tri_t(c, pid, org, direction, tmin, cap):
    """Component-major Möller-Trumbore (the walk's leaf test): ``c`` 9
    [N, C] columns; t [N, C], RT_MAX at invalid or missed slots."""
    p0x, p0y, p0z, e1x, e1y, e1z, e2x, e2y, e2z = c
    dx, dy, dz = direction[..., 0:1], direction[..., 1:2], direction[..., 2:3]
    pvx = dy * e2z - dz * e2y
    pvy = dz * e2x - dx * e2z
    pvz = dx * e2y - dy * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz
    ok = torch.abs(det) > 1e-12
    invd = torch.where(ok, 1.0 / torch.where(ok, det, 1.0), 0.0)
    tvx = org[..., 0:1] - p0x
    tvy = org[..., 1:2] - p0y
    tvz = org[..., 2:3] - p0z
    u = (tvx * pvx + tvy * pvy + tvz * pvz) * invd
    qvx = tvy * e1z - tvz * e1y
    qvy = tvz * e1x - tvx * e1z
    qvz = tvx * e1y - tvy * e1x
    v = (dx * qvx + dy * qvy + dz * qvz) * invd
    t = (e2x * qvx + e2y * qvy + e2z * qvz) * invd
    ok = (
        ok & (pid >= 0)
        & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
        & (t > tmin[..., None]) & (t < cap[..., None])
    )
    return torch.where(ok, t, RT_MAX)


def _pairs(org, direction, cl: Clusters, tmin, tmax):
    """(ray, cluster) pairs whose grown box the ray's [tmin, tmax] meets,
    as index tensors, a block of rays at a time."""
    n, k = org.shape[0], cl.lo.shape[0]
    inv = torch.where(direction.abs() > 1e-30, 1.0 / direction, 1e30)
    step = max(1, _BOX_TESTS // max(k, 1))
    rays, clus = [], []
    for a in range(0, n, step):
        o, iv = org[a:a + step, None, :], inv[a:a + step, None, :]
        t1, t2 = (cl.lo[None] - o) * iv, (cl.hi[None] - o) * iv
        near = torch.minimum(t1, t2).amax(dim=-1)
        far = torch.maximum(t1, t2).amin(dim=-1)
        meet = (near <= far) & (far >= tmin[a:a + step, None]) & (near <= tmax[a:a + step, None])
        r, c = torch.nonzero(meet, as_tuple=True)
        rays.append(r + a)
        clus.append(c)
    return torch.cat(rays), torch.cat(clus)


def _pair_t(org, direction, cl: Clusters, tmin, tmax, r, c):
    rows = cl.rows[c]  # [P, C, 9]
    cols = [rows[..., i] for i in range(9)]
    return _leaf_tri_t(cols, cl.pid[c], org[r], direction[r], tmin[r], tmax[r])


def closest_mt(org, direction, cl: Clusters, tmin, tmax):
    """(t [N] f32, prim [N] i64; RT_MAX / -1 on a miss)."""
    n = org.shape[0]
    best_t = torch.full((n,), RT_MAX, dtype=torch.float32, device=org.device)
    prim = torch.full((n,), -1, dtype=torch.int64, device=org.device)
    if n == 0 or cl.pid.numel() == 0:
        return best_t, prim
    r_all, c_all = _pairs(org, direction, cl, tmin, tmax)
    found = []
    for a in range(0, r_all.shape[0], _PAIRS):
        r, c = r_all[a:a + _PAIRS], c_all[a:a + _PAIRS]
        t = _pair_t(org, direction, cl, tmin, tmax, r, c)  # [P, C]
        best_t.scatter_reduce_(0, r, t.amin(dim=1), reduce="amin")
        found.append((r, c, t))
    big = torch.iinfo(torch.int64).max
    first = torch.full((n,), big, dtype=torch.int64, device=org.device)
    for r, c, t in found:
        at_best = (t == best_t[r][:, None]) & (t < RT_MAX)
        ids = torch.where(at_best, cl.pid[c], big)
        first.scatter_reduce_(0, r, ids.amin(dim=1), reduce="amin")
    prim = torch.where(first < big, first, -1)
    return best_t, prim


def occluded_mt(org, direction, cl: Clusters, tmin, tmax):
    """bool [N]: some triangle hit in (tmin, tmax)."""
    n = org.shape[0]
    occ = torch.zeros((n,), dtype=torch.bool, device=org.device)
    if n == 0 or cl.pid.numel() == 0:
        return occ
    r_all, c_all = _pairs(org, direction, cl, tmin, tmax)
    for a in range(0, r_all.shape[0], _PAIRS):
        r, c = r_all[a:a + _PAIRS], c_all[a:a + _PAIRS]
        hit = (_pair_t(org, direction, cl, tmin, tmax, r, c) < RT_MAX).any(dim=1)
        occ.index_put_((r[hit],), torch.ones_like(r[hit], dtype=torch.bool))
    return occ


def intersect_mt(org, direction, cl: Clusters, tris: TriSoA, tmin, tmax) -> Hit:
    t, prim = closest_mt(org, direction, cl, tmin, tmax)
    return hit_from_t_prim(org, direction, tris, t, prim)
