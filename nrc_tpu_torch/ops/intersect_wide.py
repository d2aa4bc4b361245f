"""Wide-BVH traversal: the device table, the plain lockstep walk and the
dispatch to the walk kernels.

Port of ``nrc_tpu/ops/intersect_wide.py``: the two leaf tests
``_leaf_tri_t`` (triangles) and ``_leaf_cone_t`` (round-cone curve
segments, ``:86-138``), ``sort8_by_key``, the walk of ``_make_walk_parts``,
``intersect_wbvh`` / ``occluded_wbvh`` and ``intersect_curves_wbvh`` /
``occluded_curves_wbvh`` (``:533-545``). ``WideBVH`` is the uploaded form of
the dictionary that ``ops/bvh_wide.py::build_wide_bvh`` or
``ops/curve_intersect.py::build_wide_curve_bvh`` (or the JAX package's
builds, which have the same layout) returns: the unified node + leaf row
table on the device, the build's sizes as plain Python values and the kind
of primitive its leaf rows hold. Both kinds have 9 floats a primitive, so
the rows alone cannot tell them apart: the kind is given at the upload, and
every walk entry point raises when it is handed the other kind's table.

The plain walk (``wide_traverse_plain``) advances all rays together, one
row fetch per ray and step, exactly as the JAX walk does: a ray's pending
row is a node (slab-test all children, sort them by entry distance, visit
the nearest, keep the others on a per-ray stack of child sets) or a leaf
(its leaf test over its ``leaf_size`` primitives). It is a Python ``while``
over a state of tensors and reads ``done.all()`` on the host every step, so
it serves the CPU path and the card's comparisons, not the card's frames:
on CUDA tensors the entry points launch the kernels of
``ops/intersect_wide_cuda.py`` (W1/W2 for triangles, C1/C2 for cones) or
raise.

Not ported: the refill driver, the coherence-sorted chunking (each ray's
result does not depend on its neighbours) and the split 16-bit tables.
"""

from __future__ import annotations

import functools
from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

from .bvh_wide import NONE as _NONE_I32
from .bvh_wide import wide_dims
from .gather_cuda import gather_rows
from .intersect import RT_MAX, Hit, TriSoA, hit_from_t_prim

NONE = int(_NONE_I32)  # empty child slot (INT32_MIN; no ~leaf index is)
TRI_ROW_W = 9          # floats per triangle in a leaf row: p0 | e1 | e2


class WideBVH(NamedTuple):
    """The wide BVH on a device (layout: ``ops/bvh_wide.py``)."""

    rows: torch.Tensor  # [W + L, P] f32: node rows, then leaf rows
    num_nodes: int      # W; leaf i is row W + i
    depth: int          # D, the walk's stack bound in levels
    branch: int         # B, children per node
    leaf_size: int      # primitives per leaf row
    root: Tuple[Tuple[float, float, float], Tuple[float, float, float]]  # AABB lo, hi
    kind: str = "triangle"  # what the leaf rows hold: "triangle" or "cone"


def upload_wide_bvh(wb: Dict[str, np.ndarray], device, kind: str = "triangle") -> WideBVH:
    """Build dictionary (numpy, or anything ``np.asarray`` takes) -> ``WideBVH``
    whose leaf rows hold ``kind`` primitives (``LEAF_TESTS``)."""
    if kind not in LEAF_TESTS:
        raise ValueError(f"primitive kind {kind!r}: the walk has leaf tests for {sorted(LEAF_TESTS)}")
    rows = np.ascontiguousarray(np.asarray(wb["rows"]), np.float32)
    dims = wide_dims(wb)
    if dims.prim_row_w != TRI_ROW_W:
        raise ValueError(f"{dims.prim_row_w} floats a primitive: the walk reads 9, as triangle leaf rows "
                         f"(p0 | e1 | e2) and cone leaf rows (pa | ba | ra, rb, m0) hold")
    if rows.shape[1] < max(7 * dims.branch, (TRI_ROW_W + 1) * dims.leaf_size):
        raise ValueError(f"row width {rows.shape[1]} too small for branch {dims.branch}, "
                         f"leaf {dims.leaf_size}")
    root = np.asarray(wb["root"], np.float32)
    return WideBVH(
        # bits, not values: metas and ids are NaN patterns (from_numpy keeps them)
        rows=torch.from_numpy(rows).to(device),
        num_nodes=dims.num_nodes,
        depth=dims.depth,
        branch=dims.branch,
        leaf_size=dims.leaf_size,
        root=(tuple(map(float, root[0])), tuple(map(float, root[1]))),
        kind=kind,
    )


def check_kind(bvh: WideBVH, kind: str) -> None:
    """Raise unless ``bvh``'s leaf rows hold ``kind`` primitives."""
    if bvh.kind != kind:
        raise ValueError(f"a wide BVH of {bvh.kind} leaf rows handed to the {kind} walk")


def _leaf_tri_t(c, pid, org, direction, tmin, cap):
    """Component-major Möller-Trumbore over a leaf's triangle columns.

    ``c``: 9 [N, ls] planes (p0x..p0z | e1x..e1z | e2x..e2z). Returns t
    [N, ls] with RT_MAX at invalid or missed slots. The operation order is
    the walk kernel's (``csrc/intersect_wide.cu``)."""
    p0x, p0y, p0z, e1x, e1y, e1z, e2x, e2y, e2z = c
    dx, dy, dz = direction[:, 0:1], direction[:, 1:2], direction[:, 2:3]
    # pvec = d x e2
    pvx = dy * e2z - dz * e2y
    pvy = dz * e2x - dx * e2z
    pvz = dx * e2y - dy * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz
    ok = torch.abs(det) > 1e-12
    invd = torch.where(ok, 1.0 / torch.where(ok, det, 1.0), 0.0)
    tvx = org[:, 0:1] - p0x
    tvy = org[:, 1:2] - p0y
    tvz = org[:, 2:3] - p0z
    u = (tvx * pvx + tvy * pvy + tvz * pvz) * invd
    # qvec = tvec x e1
    qvx = tvy * e1z - tvz * e1y
    qvy = tvz * e1x - tvx * e1z
    qvz = tvx * e1y - tvy * e1x
    v = (dx * qvx + dy * qvy + dz * qvz) * invd
    t = (e2x * qvx + e2y * qvy + e2z * qvz) * invd
    ok = (
        ok & (pid >= 0)
        & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
        & (t > tmin[:, None]) & (t < cap[:, None])
    )
    return torch.where(ok, t, RT_MAX)


def _leaf_cone_t(c, pid, org, direction, tmin, cap):
    """Component-major round-cone test over a leaf's curve-segment columns
    (``nrc_tpu/ops/intersect_wide.py:86-138``): the lateral surface's
    quadratic and the two end spheres, the smallest t in (tmin, cap).

    ``c``: 9 [N, ls] planes (pax..paz | bax..baz | ra | rb | m0), the rows of
    ``ops/curve_intersect.py::build_wide_curve_bvh``. Returns t [N, ls] with
    RT_MAX at invalid or missed slots. ``direction`` must be of unit length.
    The operation order is the cone walk kernel's (``csrc/intersect_wide.cu``
    ``cone_t``): sums of three products left to right."""
    pax, pay, paz, bax, bay, baz, ra, rb, m0 = c
    dx, dy, dz = direction[:, 0:1], direction[:, 1:2], direction[:, 2:3]
    oax = org[:, 0:1] - pax
    oay = org[:, 1:2] - pay
    oaz = org[:, 2:3] - paz
    obx = oax - bax
    oby = oay - bay
    obz = oaz - baz
    rr = ra - rb
    m1 = bax * oax + bay * oay + baz * oaz
    m2 = bax * dx + bay * dy + baz * dz
    m3 = dx * oax + dy * oay + dz * oaz
    m5 = oax * oax + oay * oay + oaz * oaz
    m6 = obx * dx + oby * dy + obz * dz
    m7 = obx * obx + oby * oby + obz * obz

    d2 = m0 - rr * rr
    k2 = d2 - m2 * m2
    k1 = d2 * m3 - m1 * m2 + m2 * rr * ra
    k0 = d2 * m5 - m1 * m1 + m1 * rr * ra * 2.0 - m0 * ra * ra
    h = k1 * k1 - k0 * k2
    ok2 = torch.abs(k2) > 1e-20
    t_body = (-torch.sqrt(torch.clamp(h, min=0.0)) - k1) / torch.where(ok2, k2, 1.0)
    y = m1 - ra * rr + t_body * m2
    tn = tmin[:, None]
    tx = cap[:, None]
    body_ok = (h >= 0.0) & ok2 & (y > 0.0) & (y < d2) & (t_body > tn) & (t_body < tx)
    t_body = torch.where(body_ok, t_body, RT_MAX)

    h1 = m3 * m3 - m5 + ra * ra
    t_ca = -m3 - torch.sqrt(torch.clamp(h1, min=0.0))
    t_ca = torch.where((h1 >= 0.0) & (t_ca > tn) & (t_ca < tx), t_ca, RT_MAX)
    h2 = m6 * m6 - m7 + rb * rb
    t_cb = -m6 - torch.sqrt(torch.clamp(h2, min=0.0))
    t_cb = torch.where((h2 >= 0.0) & (t_cb > tn) & (t_cb < tx), t_cb, RT_MAX)

    t = torch.minimum(t_body, torch.minimum(t_ca, t_cb))
    return torch.where(pid >= 0, t, RT_MAX)


# the leaf test of each primitive kind; both read 9 floats a primitive
LEAF_TESTS = {"triangle": _leaf_tri_t, "cone": _leaf_cone_t}


@functools.lru_cache(maxsize=None)
def _batcher_network(n: int):
    """Batcher odd-even mergesort comparator pairs for a power of two n
    (8 -> the classic 19 comparators, 16 -> 63)."""
    pairs = []

    def merge(lo, m, r):
        step = r * 2
        if step < m:
            merge(lo, m, step)
            merge(lo + r, m, step)
            for i in range(lo + r, lo + m - r, step):
                pairs.append((i, i + r))
        else:
            pairs.append((lo, lo + r))

    def sort(lo, m):
        if m > 1:
            k = m // 2
            sort(lo, k)
            sort(lo + k, k)
            merge(lo, m, 1)

    sort(0, n)
    return tuple(pairs)


def sort8_by_key(key, val):
    """Sort the B columns of ``val`` by ascending ``key`` ([N, B] each, B a
    power of two) with a Batcher network of selects. Masked entries arrive
    with key = +inf and the caller's sentinel as value; they sort last."""
    b = key.shape[1]
    keys = [key[:, i] for i in range(b)]
    vals = [val[:, i] for i in range(b)]
    for i, j in _batcher_network(b):
        ki, kj = keys[i], keys[j]
        vi, vj = vals[i], vals[j]
        swap = kj < ki
        keys[i] = torch.where(swap, kj, ki)
        keys[j] = torch.where(swap, ki, kj)
        vals[i] = torch.where(swap, vj, vi)
        vals[j] = torch.where(swap, vi, vj)
    return torch.stack(vals, dim=1)


def ray_inv_dir(direction):
    """1 / d per component; 3e38 where |d| <= 1e-20 (``intersect_wide.py:260-264``)."""
    return torch.where(
        torch.abs(direction) > 1e-20,
        1.0 / torch.where(direction != 0.0, direction, 1.0),
        3.0e38,
    )


def _slab_children(row, bvh: WideBVH, best_t, org, inv_d, tmin, tmax):
    """Box-test all children of a fetched node row -> the children sorted by
    entry distance (missed and empty slots NONE, sorted last)."""
    b = bvh.branch
    meta = row[:, 6 * b: 7 * b].view(torch.int32)
    near = torch.full_like(row[:, :b], -torch.inf)
    far = torch.full_like(near, torch.inf)
    for ax in range(3):
        lo_c = row[:, ax * b: (ax + 1) * b]
        hi_c = row[:, (3 + ax) * b: (4 + ax) * b]
        o_c = org[:, ax:ax + 1]
        i_c = inv_d[:, ax:ax + 1]
        t0 = (lo_c - o_c) * i_c
        t1 = (hi_c - o_c) * i_c
        near = torch.maximum(near, torch.minimum(t0, t1))
        far = torch.minimum(far, torch.maximum(t0, t1))
    cap = torch.minimum(tmax, best_t)
    hit = torch.maximum(near, tmin[:, None]) <= torch.minimum(far, cap[:, None])
    # empty slots are masked by meta, not by their inverted box, whose slabs
    # can overflow to (-inf, +inf) and read as a hit
    ok = hit & (meta != NONE)
    key = torch.where(ok, near, torch.inf)
    return sort8_by_key(key, torch.where(ok, meta, NONE))


def wide_traverse_plain(org, direction, bvh: WideBVH, tmin, tmax, any_hit: bool, rows_seen=None,
                        ray_fetches=None, leaf: str = "triangle"):
    """The plain lockstep walk with the leaf test of the primitive kind
    ``leaf`` (``LEAF_TESTS``; raises unless ``bvh`` holds that kind) ->
    (t [N] f32, prim [N] i64, rows fetched).

    ``t`` is RT_MAX and ``prim`` -1 on a miss; with ``any_hit`` a ray stops
    at its first hit. The third value counts the rows that live rays
    fetched over all steps (the walk's work in rows). ``rows_seen``, a bool
    tensor with one entry per table row, if given, is set where a live ray
    fetched that row: its sum is the distinct rows the walk read, which is
    its memory traffic when the table stays in the cache. ``ray_fetches``,
    an integer tensor [N], if given, gets each ray's own count of fetched
    rows added: the length of its chain of dependent fetches."""
    check_kind(bvh, leaf)
    leaf_test = LEAF_TESTS[leaf]
    n, dev = org.shape[0], org.device
    b, ls, w_nodes, depth_max = bvh.branch, bvh.leaf_size, bvh.num_nodes, bvh.depth
    ar = torch.arange(n, device=dev)
    inv_d = ray_inv_dir(direction)
    dead = tmax <= tmin

    children = torch.full((n, b), NONE, dtype=torch.int32, device=dev)
    stack = torch.full((n, depth_max, b), NONE, dtype=torch.int32, device=dev)
    depth = torch.zeros((n,), dtype=torch.int64, device=dev)
    pending = torch.where(dead, -1, 0)                  # the root's row, i64
    pend_leaf = torch.zeros((n,), dtype=torch.bool, device=dev)
    done = dead
    best_t = torch.full((n,), RT_MAX, dtype=torch.float32, device=dev)
    best_prim = torch.full((n,), -1, dtype=torch.int32, device=dev)
    fetched = 0

    while not bool(done.all()):
        live = ~done
        fetching = live & (pending >= 0)
        fetched += int(fetching.sum())
        if ray_fetches is not None:
            ray_fetches += fetching
        if rows_seen is not None:
            rows_seen[pending[fetching]] = True
        # ---- the one row fetch per ray and step ---------------------------
        row = gather_rows(bvh.rows, torch.clamp(pending, min=0))        # [N, P]

        # ---- leaf service --------------------------------------------------
        do_leaf = live & pend_leaf
        c = [row[:, k * ls: (k + 1) * ls] for k in range(TRI_ROW_W)]
        pid = row[:, TRI_ROW_W * ls: (TRI_ROW_W + 1) * ls].view(torch.int32)
        cap = torch.minimum(tmax, best_t)
        t_ok = leaf_test(c, pid, org, direction, tmin, cap)
        t_ok = torch.where(do_leaf[:, None], t_ok, RT_MAX)
        t_best, k_best = torch.min(t_ok, dim=1)          # first index on ties
        hit_any = t_best < cap
        pid_best = pid.gather(1, k_best[:, None])[:, 0]
        best_t = torch.where(hit_any, t_best, best_t)
        best_prim = torch.where(hit_any, pid_best, best_prim)
        if any_hit:
            done = done | (best_prim >= 0)
            live = ~done

        # ---- node service: slab-test the fetched row -> sorted child set ---
        do_node = live & ~pend_leaf & (pending >= 0)
        new_children = _slab_children(row, bvh, best_t, org, inv_d, tmin, tmax)
        children = torch.where(do_node[:, None], new_children, children)

        # ---- pop: rays whose set is exhausted take back saved siblings ------
        empty = ~(children != NONE).any(dim=1)
        out_of_work = live & empty & (depth == 0)
        done = done | out_of_work
        live = live & ~out_of_work
        do_pop = live & empty & (depth > 0)
        popped = stack[ar, torch.clamp(depth - 1, min=0)]
        children = torch.where(do_pop[:, None], popped, children)
        depth = torch.where(do_pop, depth - 1, depth)

        # ---- pick the nearest remaining child -> next step's pending row ----
        has = children != NONE
        pick = torch.argmax(has.to(torch.int32), dim=1)  # first non-NONE slot
        entry = children.gather(1, pick[:, None])[:, 0]
        take = live & has.any(dim=1)
        children = children.scatter(
            1, pick[:, None], torch.where(take, NONE, entry)[:, None]
        )
        is_leaf = take & (entry < 0) & (entry != NONE)
        is_inner = take & (entry >= 0)

        # inner descend: save the remaining siblings, if any
        remain = (children != NONE).any(dim=1)
        do_push = is_inner & remain
        level = torch.clamp(depth, max=depth_max - 1)
        stack[ar, level] = torch.where(do_push[:, None], children, stack[ar, level])
        depth = depth + do_push.to(torch.int64)

        entry = entry.to(torch.int64)
        pending = torch.where(is_inner, entry, torch.where(is_leaf, w_nodes + ~entry, -1))
        pend_leaf = is_leaf

    return best_t, best_prim.to(torch.int64), fetched


def _traverse(org, direction, bvh: WideBVH, tmin, tmax, any_hit: bool, leaf: str):
    check_kind(bvh, leaf)
    if org.device.type == "cuda":
        from .intersect_wide_cuda import wide_traverse_cuda

        return wide_traverse_cuda(org, direction, bvh, tmin, tmax, any_hit, leaf=leaf)
    if org.device.type != "cpu":
        raise ValueError(f"unsupported device {org.device}")
    t, prim, _ = wide_traverse_plain(org, direction, bvh, tmin, tmax, any_hit, leaf=leaf)
    return t, prim


def intersect_wbvh(org, direction, bvh: WideBVH, tris: TriSoA, tmin, tmax) -> Hit:
    """Closest hit over the wide BVH; the winner's barycentrics are
    re-derived by ``hit_from_t_prim``, as for the brute force."""
    t, prim = _traverse(org, direction, bvh, tmin, tmax, any_hit=False, leaf="triangle")
    return hit_from_t_prim(org, direction, tris, t, prim)


def occluded_wbvh(org, direction, bvh: WideBVH, tmin, tmax) -> torch.Tensor:
    """Any-hit visibility over the wide BVH -> bool [N] (True = occluded)."""
    _, prim = _traverse(org, direction, bvh, tmin, tmax, any_hit=True, leaf="triangle")
    return prim >= 0


def intersect_curves_wbvh(org, direction, bvh: WideBVH, tmin, tmax):
    """Closest hit over a wide BVH of curve segments -> (t [N] f32, prim [N]
    i64; RT_MAX / -1 on a miss). ``direction`` must be of unit length."""
    return _traverse(org, direction, bvh, tmin, tmax, any_hit=False, leaf="cone")


def occluded_curves_wbvh(org, direction, bvh: WideBVH, tmin, tmax) -> torch.Tensor:
    """Any-hit visibility over a wide BVH of curve segments -> bool [N]."""
    _, prim = _traverse(org, direction, bvh, tmin, tmax, any_hit=True, leaf="cone")
    return prim >= 0
