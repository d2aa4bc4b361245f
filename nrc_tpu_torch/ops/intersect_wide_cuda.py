"""The wide-BVH walk kernels W1/W2 and C1/C2: wrappers of ``csrc/intersect_wide.cu``.

``nrc_wbvh_closest`` (W1) and ``nrc_wbvh_any`` (W2) walk the unified row
table of ``ops/bvh_wide.py`` over triangles, ``nrc_wbvh_curves_closest``
(C1) and ``nrc_wbvh_curves_any`` (C2) the same layout over round-cone curve
segments (``ops/curve_intersect.py::build_wide_curve_bvh``): one walk
instantiated with two leaf tests. A block compacts the live rays of its
span of lanes, and a group of ``branch`` lanes walks one ray, with the
group's stack in shared memory (the source's header says why). W1/W2 stand
where ``nrc_tpu/ops/intersect_wide.py::intersect_wbvh`` and
``occluded_wbvh`` stand, C1/C2 where ``intersect_curves_wbvh`` and
``occluded_curves_wbvh`` stand; the JAX package has no hand kernel there
(its walk is a traced while loop). Their plain version is
``ops/intersect_wide.py::wide_traverse_plain`` with the same leaf test: the
closest ``t`` agrees with it bit for bit (the same operations in the same
order, built with ``-fmad=false``), and the winner can differ only where two
primitives give the same ``t``.
"""

from __future__ import annotations

import ctypes

import torch

from .cuda_build import CudaKernel, check_cuda_tensor, current_stream, ptr
from .intersect_wide import TRI_ROW_W, WideBVH, check_kind

MAX_STACK = 256    # csrc/intersect_wide.cu::kStack, entries a group
MAX_LEAF = 64      # csrc/intersect_wide.cu::kMaxLeaf
BRANCHES = (8, 16)  # the widths the kernel is instantiated for (lanes a group)

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGS = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P]
CLOSEST_KERNEL = CudaKernel("intersect_wide.cu", "nrc_wbvh_closest", _ARGS,
                            extra_flags=("-fmad=false",))
ANYHIT_KERNEL = CudaKernel("intersect_wide.cu", "nrc_wbvh_any", _ARGS,
                           extra_flags=("-fmad=false",))
CURVE_CLOSEST_KERNEL = CudaKernel("intersect_wide.cu", "nrc_wbvh_curves_closest", _ARGS,
                                  extra_flags=("-fmad=false",))
CURVE_ANYHIT_KERNEL = CudaKernel("intersect_wide.cu", "nrc_wbvh_curves_any", _ARGS,
                                 extra_flags=("-fmad=false",))
# (leaf kind, any hit) -> the entry point that walks it
WALK_KERNELS = {
    ("triangle", False): CLOSEST_KERNEL, ("triangle", True): ANYHIT_KERNEL,
    ("cone", False): CURVE_CLOSEST_KERNEL, ("cone", True): CURVE_ANYHIT_KERNEL,
}


def check_walkable(bvh: WideBVH) -> None:
    """Raise unless the kernels were compiled for this build's sizes."""
    width = bvh.rows.shape[1]
    if bvh.branch not in BRANCHES:
        raise ValueError(f"branch {bvh.branch}: the walk kernel is built for {BRANCHES}")
    if bvh.leaf_size % 4 or not 0 < bvh.leaf_size <= MAX_LEAF:
        raise ValueError(f"leaf_size {bvh.leaf_size}: need a multiple of 4 up to {MAX_LEAF}")
    if width % 4 or width < max(7 * bvh.branch, (TRI_ROW_W + 1) * bvh.leaf_size):
        raise ValueError(f"row width {width} does not fit branch {bvh.branch}, leaf {bvh.leaf_size}")
    need = (bvh.branch - 1) * bvh.depth + 1
    if need > MAX_STACK:
        raise ValueError(f"a tree of {bvh.depth} levels x {bvh.branch} children needs a stack of "
                         f"{need} entries; the walk kernel has {MAX_STACK}")
    if not 0 < bvh.num_nodes <= bvh.rows.shape[0]:
        raise ValueError(f"{bvh.num_nodes} node rows in a table of {bvh.rows.shape[0]} rows")


def wide_traverse_cuda(org, direction, bvh: WideBVH, tmin, tmax, any_hit: bool, leaf: str = "triangle"):
    """W1 (closest) or W2 (any hit) on the card, or with ``leaf="cone"`` C1
    or C2 -> (t [N] f32, prim [N] i64); RT_MAX / -1 on a miss. With
    ``any_hit`` the hit is the first one found. Raises unless ``bvh`` holds
    ``leaf`` primitives."""
    check_kind(bvh, leaf)
    t, prim = launch_walk(WALK_KERNELS[leaf, any_hit], org, direction, bvh, tmin, tmax)
    return t, prim.long()


def launch_walk(kernel: CudaKernel, org, direction, bvh: WideBVH, tmin, tmax):
    """One launch of ``kernel``, an entry point with the arguments of
    ``nrc_wbvh_closest`` -> (t [N] f32, prim [N] i32)."""
    check_walkable(bvh)
    dev = org.device
    org, direction = org.contiguous(), direction.contiguous()
    tmin, tmax = tmin.contiguous(), tmax.contiguous()
    n = org.shape[0]
    check_cuda_tensor("org", org, torch.float32, (n, 3), dev)
    check_cuda_tensor("direction", direction, torch.float32, (n, 3), dev)
    check_cuda_tensor("tmin", tmin, torch.float32, (n,), dev)
    check_cuda_tensor("tmax", tmax, torch.float32, (n,), dev)
    check_cuda_tensor("rows", bvh.rows, torch.float32, (None, None), dev)
    t = torch.empty((n,), dtype=torch.float32, device=dev)
    prim = torch.empty((n,), dtype=torch.int32, device=dev)
    if n:
        kernel.launch(
            ptr(org), ptr(direction), ptr(tmin), ptr(tmax), ptr(bvh.rows), n,
            bvh.rows.shape[1], bvh.num_nodes, bvh.branch, bvh.leaf_size,
            ptr(t), ptr(prim), current_stream(dev),
        )
    return t, prim
