"""Binary BVH build on the host: binned SAH in native C, numpy fall-back.

Port of ``nrc_tpu/ops/bvh.py::build_bvh`` and ``_build_median_split``. The
build runs in the port's own native library
(``native/nrc_native.c::bvh_build_binned_sah``, 16-bin SAH) and, without a C
compiler, as a numpy median split. The flat tree feeds the wide collapse of
``ops/bvh_wide.py``; the binary skip-link layouts (``flatten_skip_links*``)
are not ported, since nothing walks the binary tree.
"""

from __future__ import annotations

import sys
from typing import Dict

import numpy as np

from ..native import get_lib


def build_bvh(p0: np.ndarray, p1: np.ndarray, p2: np.ndarray, max_leaf: int = 4) -> Dict[str, np.ndarray]:
    """Build a BVH; returns dict of flat arrays:

    - lo/hi [n, 3] node AABBs
    - left/right [n] child indices (-1 for leaves)
    - start/count [n] leaf primitive range into ``order`` (count 0 for inner)
    - order [T] primitive permutation
    """
    num = int(p0.shape[0])
    if num == 0:
        return {
            "lo": np.zeros((1, 3), np.float32),
            "hi": np.zeros((1, 3), np.float32),
            "left": np.full((1,), -1, np.int32),
            "right": np.full((1,), -1, np.int32),
            "start": np.zeros((1,), np.int32),
            "count": np.zeros((1,), np.int32),
            "order": np.zeros((0,), np.int32),
        }

    lib = get_lib()
    if lib is not None:
        cap = 2 * num
        order = np.zeros(num, np.int32)
        lo = np.zeros((cap, 3), np.float32)
        hi = np.zeros((cap, 3), np.float32)
        left = np.zeros(cap, np.int32)
        right = np.zeros(cap, np.int32)
        start = np.zeros(cap, np.int32)
        count = np.zeros(cap, np.int32)
        a0 = np.ascontiguousarray(p0, np.float32)
        a1 = np.ascontiguousarray(p1, np.float32)
        a2 = np.ascontiguousarray(p2, np.float32)
        n = lib.bvh_build_binned_sah(
            a0.ctypes.data, a1.ctypes.data, a2.ctypes.data, num, max_leaf,
            order.ctypes.data, lo.ctypes.data, hi.ctypes.data,
            left.ctypes.data, right.ctypes.data,
            start.ctypes.data, count.ctypes.data,
        )
        return {
            "lo": lo[:n], "hi": hi[:n],
            "left": left[:n], "right": right[:n],
            "start": start[:n], "count": count[:n],
            "order": order,
        }

    return _build_median_split(p0, p1, p2, max_leaf)


def _build_median_split(p0, p1, p2, max_leaf: int) -> Dict[str, np.ndarray]:
    """NumPy fallback: median split on the widest centroid axis."""
    num = p0.shape[0]
    lo_p = np.minimum(np.minimum(p0, p1), p2).astype(np.float32)
    hi_p = np.maximum(np.maximum(p0, p1), p2).astype(np.float32)
    cen = (lo_p + hi_p) * 0.5

    order = np.arange(num, dtype=np.int32)
    nodes = {k: [] for k in ("lo", "hi", "left", "right", "start", "count")}

    def emit():
        for k in nodes:
            nodes[k].append(0)
        return len(nodes["lo"]) - 1

    def build(start, end):
        node = emit()
        sel = order[start:end]
        nodes["lo"][node] = lo_p[sel].min(0)
        nodes["hi"][node] = hi_p[sel].max(0)
        n = end - start
        if n <= max_leaf:
            nodes["left"][node] = -1
            nodes["right"][node] = -1
            nodes["start"][node] = start
            nodes["count"][node] = n
            return node
        c = cen[sel]
        axis = int(np.argmax(c.max(0) - c.min(0)))
        mid = start + n // 2
        part = np.argpartition(c[:, axis], n // 2)
        order[start:end] = sel[part]
        nodes["start"][node] = -1
        nodes["count"][node] = 0
        nodes["left"][node] = build(start, mid)
        nodes["right"][node] = build(mid, end)
        return node

    old = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old, 2 * num + 100))
    try:
        build(0, num)
    finally:
        sys.setrecursionlimit(old)

    return {
        "lo": np.asarray(nodes["lo"], np.float32),
        "hi": np.asarray(nodes["hi"], np.float32),
        "left": np.asarray(nodes["left"], np.int32),
        "right": np.asarray(nodes["right"], np.int32),
        "start": np.asarray(nodes["start"], np.int32),
        "count": np.asarray(nodes["count"], np.int32),
        "order": order,
    }
