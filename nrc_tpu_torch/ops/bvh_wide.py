"""Wide BVH build on the host: collapse the binary SAH tree into nodes of
``branch`` children whose rows carry every child's AABB and child pointer.

Port of ``nrc_tpu/ops/bvh_wide.py`` (``collapse_wide``,
``collapse_wide_arrays``, ``build_wide_bvh``, ``flatten_wide_rows``), numpy
and native C only. The output dictionary keeps the JAX package's names,
shapes and bits, so either build can feed either walk:

- ``rows`` [W + L, P] f32: ONE table of node rows followed by leaf rows, so
  a walk step fetches exactly one row whatever it is about to do.

  - node row (0..W-1): component-major child boxes (lox*B | loy*B | loz*B |
    hix*B | hiy*B | hiz*B), then B child metas as bit-cast int32, zero
    padded to P. meta >= 0: inner child (wide node index); meta < 0: leaf
    child (row W + ~meta); meta == NONE: empty slot. Slots are in build
    order; the walk sorts the children by entry distance at visit time.
  - leaf row (W..W+L-1): component-major primitive columns (p0x*ls | p0y*ls
    | ... | e2z*ls), then ls primitive ids as bit-cast int32 (-1 padding),
    zero padded to P.

  P = max(7 * branch, (row_w + 1) * leaf_size). Many metas and ids are NaN
  bit patterns: rows are moved as 32-bit words, never through arithmetic.
- ``leaf_ids`` [L, leaf_size] i32, ``root`` [2, 3] f32 (the root's AABB).
- ``branch`` [1, B], ``wsplit`` [1, W], ``depth`` [1, D], ``leaf_row_w``
  [1, row_w] i32 zeros: B, W, the stack bound D and the per-primitive
  payload width are carried by these shapes, as in the JAX package (its
  traced programs cannot take them as values). ``wide_dims`` reads them.

``split_rows_u16`` (a TPU gather layout, measured slower in the walk there)
is not ported.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np

from ..native import get_lib
from .bvh import build_bvh

BRANCH = 8
NONE = np.int32(-2147483648)  # empty-slot meta (INT32_MIN; ~leaf never is)


def collapse_wide(
    left: np.ndarray,
    right: np.ndarray,
    start: np.ndarray,
    count: np.ndarray,
    order: np.ndarray,
    lo: np.ndarray,
    hi: np.ndarray,
    leaf_size: int,
    branch: int = BRANCH,
):
    """Binary (left/right/start/count) tree -> wide-node lists.

    A binary subtree whose total primitive count fits ``leaf_size``
    becomes one leaf child; otherwise the child set of a wide node is
    grown by repeatedly expanding the child subtree with the largest
    surface area until ``branch`` slots are used (the standard greedy
    binary->wide collapse).

    Returns (wide_children, wide_boxes, leaves) where wide_children[i] is
    a list of ('inner', wide_idx) / ('leaf', leaf_idx) slots, wide_boxes[i]
    the matching [len, 6] child AABBs, and leaves a list of prim-id lists.
    """
    n = lo.shape[0]
    # subtree primitive counts (iterative post-order)
    prims = np.zeros(n, np.int64)
    stack = [(0, False)]
    while stack:
        v, done = stack.pop()
        if done:
            prims[v] = prims[left[v]] + prims[right[v]]
        elif left[v] < 0:
            prims[v] = count[v]
        else:
            stack.append((v, True))
            stack.append((left[v], False))
            stack.append((right[v], False))

    area = np.prod(np.maximum(hi - lo, 0.0), axis=-1)  # proxy: volume
    ext = np.maximum(hi - lo, 0.0)
    area = 2.0 * (ext[:, 0] * ext[:, 1] + ext[:, 1] * ext[:, 2]
                  + ext[:, 2] * ext[:, 0])

    def collect(v):
        out, st = [], [v]
        while st:
            u = st.pop()
            if left[u] < 0:
                out.extend(order[start[u]: start[u] + count[u]].tolist())
            else:
                st.append(right[u])
                st.append(left[u])
        return out

    wide_children = []  # per wide node: list of ('inner'|'leaf', idx)
    wide_boxes = []     # per wide node: list of (lo3, hi3)
    leaves = []         # leaf idx -> prim id list
    depth_of = []       # per wide node

    def make_leaf(v):
        leaves.append(collect(v))
        return len(leaves) - 1

    # BFS so children wide-ids can be patched after allocation
    root_fits = prims[0] <= leaf_size
    if root_fits or left[0] < 0:
        # degenerate: single wide node with one leaf child
        wide_children.append([("leaf", make_leaf(0))])
        wide_boxes.append([(lo[0], hi[0])])
        depth_of.append(0)
    else:
        todo = [(0, 0)]  # (binary node, wide parent depth)
        wide_of = {}     # binary node -> wide idx
        wide_children.append(None)
        wide_boxes.append(None)
        depth_of.append(0)
        wide_of[0] = 0
        while todo:
            v, d = todo.pop()
            wi = wide_of[v]
            depth_of[wi] = d
            # grow child set: expand the largest-area inner, non-leaf-fitting
            # child until `branch` slots
            slots = [left[v], right[v]]
            while len(slots) < branch:
                best, best_a = -1, -1.0
                for i, u in enumerate(slots):
                    if left[u] >= 0 and prims[u] > leaf_size and area[u] > best_a:
                        best, best_a = i, area[u]
                if best < 0:
                    break
                u = slots.pop(best)
                slots.extend([left[u], right[u]])
            ch, bx = [], []
            for u in slots:
                if left[u] < 0 or prims[u] <= leaf_size:
                    ch.append(("leaf", make_leaf(u)))
                else:
                    wide_children.append(None)
                    wide_boxes.append(None)
                    depth_of.append(0)
                    wide_of[u] = len(wide_children) - 1
                    ch.append(("inner", wide_of[u]))
                    todo.append((u, d + 1))
                bx.append((lo[u], hi[u]))
            wide_children[wi] = ch
            wide_boxes[wi] = bx

    return wide_children, wide_boxes, leaves, max(depth_of) + 1


def collapse_wide_arrays(
    bvh: Dict[str, np.ndarray], leaf_size: int, branch: int = BRANCH
):
    """Collapse to flat arrays: (metas [W,B] i32, los/his [W,B,3] f32,
    ids_mat [L,leaf_size] i32, depth_levels). Native C fast path
    (``nrc_native.c::bvh_collapse_wide``) with the pure-Python fallback
    below it (slow on large scenes; its slot order differs from the C
    path's, both are valid trees)."""
    left = np.ascontiguousarray(bvh["left"], np.int32)
    right = np.ascontiguousarray(bvh["right"], np.int32)
    start = np.ascontiguousarray(bvh["start"], np.int32)
    count = np.ascontiguousarray(bvh["count"], np.int32)
    order = np.ascontiguousarray(bvh["order"], np.int32)
    lo = np.ascontiguousarray(bvh["lo"], np.float32)
    hi = np.ascontiguousarray(bvh["hi"], np.float32)
    n_old = left.shape[0]

    lib = get_lib()
    if lib is not None and hasattr(lib, "bvh_collapse_wide"):
        meta = np.empty((n_old, branch), np.int32)
        box = np.empty((n_old, branch, 6), np.float32)
        ids = np.empty((n_old, max(leaf_size, 1)), np.int32)
        cnt = np.zeros(3, np.int32)
        got = lib.bvh_collapse_wide(
            left.ctypes.data, right.ctypes.data,
            start.ctypes.data, count.ctypes.data, order.ctypes.data,
            lo.ctypes.data, hi.ctypes.data,
            np.int32(n_old), np.int32(leaf_size), np.int32(branch),
            meta.ctypes.data, box.ctypes.data, ids.ctypes.data,
            cnt.ctypes.data,
        )
        if got > 0:
            W, L, depth = int(cnt[0]), int(cnt[1]), int(cnt[2])
            return (
                meta[:W].copy(),
                box[:W, :, 0:3].copy(),
                box[:W, :, 3:6].copy(),
                ids[:max(L, 1)].copy(),
                depth,
            )

    wide_children, wide_boxes, leaves, depth = collapse_wide(
        left, right, start, count, order, lo, hi, leaf_size, branch
    )
    W = len(wide_children)
    metas = np.full((W, branch), NONE, np.int32)
    los = np.full((W, branch, 3), 3.0e38, np.float32)
    his = np.full((W, branch, 3), -3.0e38, np.float32)
    for wi, (ch, bx) in enumerate(zip(wide_children, wide_boxes)):
        for si, ((kind, idx), (blo, bhi)) in enumerate(zip(ch, bx)):
            metas[wi, si] = idx if kind == "inner" else ~np.int32(idx)
            los[wi, si] = blo
            his[wi, si] = bhi
    L = max(len(leaves), 1)
    ids_mat = np.full((L, leaf_size), -1, np.int32)
    for i, prim in enumerate(leaves):
        if len(prim) > leaf_size:
            raise ValueError(f"leaf of {len(prim)} primitives > leaf_size {leaf_size}")
        ids_mat[i, : len(prim)] = prim
    return metas, los, his, ids_mat, depth


def build_wide_bvh(
    p0: np.ndarray,
    p1: np.ndarray,
    p2: np.ndarray,
    leaf_size: int = 8,
    branch: int = BRANCH,
    max_leaf: int = 4,
) -> Dict[str, np.ndarray]:
    """Triangles -> wide flat BVH arrays (see module docstring)."""
    b = build_bvh(p0, p1, p2, max_leaf=max_leaf)
    return flatten_wide_rows(
        b,
        np.concatenate(
            [p0.astype(np.float32),
             (p1 - p0).astype(np.float32),
             (p2 - p0).astype(np.float32)],
            axis=-1,
        ),
        leaf_size=leaf_size,
        branch=branch,
    )


def flatten_wide_rows(
    bvh: Dict[str, np.ndarray],
    prim_rows: np.ndarray,   # [T, R] per-primitive payload
    leaf_size: int = 8,
    branch: int = BRANCH,
) -> Dict[str, np.ndarray]:
    """Generic (triangles/curve segments) wide flattening."""
    metas, los, his, ids_mat, depth = collapse_wide_arrays(
        bvh, leaf_size, branch
    )
    W = metas.shape[0]
    L = ids_mat.shape[0]
    row_w = prim_rows.shape[1]

    # ---- leaf rows: COMPONENT-major -------------------------------------
    # [L, row_w*ls + ls]: component k of all ls primitives contiguous
    # (p0x of tris 0..ls-1, then p0y, ... then ids), so the leaf test reads
    # each component of all ls primitives as one contiguous run.
    rows_mat = np.where(
        (ids_mat >= 0)[:, :, None],
        prim_rows[np.maximum(ids_mat, 0)],
        np.float32(0.0),
    ).astype(np.float32)                                   # [L, ls, row_w]
    comp_major = np.ascontiguousarray(
        rows_mat.transpose(0, 2, 1)
    ).reshape(L, row_w * leaf_size)
    leaf_pack = np.concatenate(
        [comp_major, ids_mat.view(np.float32)], axis=1
    )

    # ---- node rows: ONE variant, build slot order ------------------------
    # the walk orders children by actual slab entry distance at visit time
    # (see module docstring). Empty slots carry meta NONE — the traversal masks them
    # by meta, NOT by their inverted AABB: (3e38 - o) * inv_d overflows to
    # ±inf on BOTH slabs for near-axis directions, turning the inverted
    # box into an always-hit.
    valid = metas != NONE
    node_rows = np.concatenate(
        [
            np.ascontiguousarray(los.transpose(0, 2, 1)).reshape(W, -1),
            np.ascontiguousarray(his.transpose(0, 2, 1)).reshape(W, -1),
            metas.view(np.float32),
        ],
        axis=1,
    )                                                      # [W, 7*branch]

    # ---- unified table: node rows then leaf rows, padded to P ------------
    P = max(7 * branch, leaf_pack.shape[1])
    rows = np.zeros((W + L, P), np.float32)
    rows[:W, : 7 * branch] = node_rows
    rows[W:, : leaf_pack.shape[1]] = leaf_pack

    root = np.stack(
        [np.min(np.where(valid[0][:, None], los[0], np.inf), axis=0),
         np.max(np.where(valid[0][:, None], his[0], -np.inf), axis=0)]
    ).astype(np.float32)

    return {
        "rows": rows,                                    # [W + L, P] f32
        "branch": np.zeros((1, branch), np.int32),       # static via shape
        "wsplit": np.zeros((1, W), np.int32),            # static via shape
        "leaf_ids": ids_mat,
        "root": root,                                    # [2, 3] exact AABB
        "depth": np.zeros((1, depth + 1), np.int32),     # static via shape
        # (+1 safety slot over the exact max level count)
        # per-primitive payload width, shape-encoded like depth: consumers
        # derive leaf_size = leaf_ids.shape[1] instead of hardcoding the
        # 9-float triangle row layout
        "leaf_row_w": np.zeros((1, row_w), np.int32),
    }


class WideDims(NamedTuple):
    """The build's shape-carried sizes as plain Python values."""

    branch: int      # B, children per node
    leaf_size: int   # primitives per leaf row
    num_nodes: int   # W, node rows; leaf row i sits at W + i
    depth: int       # D, the walk's stack bound in levels
    prim_row_w: int  # floats per primitive in a leaf row (9 for triangles)


def wide_dims(wb: Dict[str, np.ndarray]) -> WideDims:
    return WideDims(
        branch=wb["branch"].shape[1],
        leaf_size=wb["leaf_ids"].shape[1],
        num_nodes=wb["wsplit"].shape[1],
        depth=wb["depth"].shape[1],
        prim_row_w=wb["leaf_row_w"].shape[1],
    )
