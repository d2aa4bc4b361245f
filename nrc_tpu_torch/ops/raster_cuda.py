"""The primary raster kernel R1: the wrapper of ``csrc/raster_primary.cu``.

``nrc_raster_closest`` resolves every pixel's first hit against the
triangles binned to its screen tile (``ops/raster_primary.py``): a block a
chunk of ``CHUNK`` candidate slots of one tile, its threads taking the
(pixel, candidate) pairs of the candidates' boxes in turn, a pixel's hits
reduced by a 64-bit ``atomicMin`` on (t, triangle id) in the block and
over the chunks, then one pass that writes t and the id. It stands where
``nrc_tpu/ops/raster_primary.py::raster_closest_hit`` stands; the JAX
package has no hand kernel there (its test is XLA code). Its plain version
is ``raster_closest_hit_plain``: the same test in the same operation order
(built with ``-fmad=false``) and the same winner at equal t, the lowest id,
so the two agree bit for bit in t and triangle.
"""

from __future__ import annotations

import ctypes

import torch

from .cuda_build import CudaKernel, check_cuda_tensor, current_stream, ptr
from .raster_primary import RasterData, RasterMeta

MAX_TILE = 24  # csrc/raster_primary.cu::kMaxTile, a thread a pixel of a tile

_P = ctypes.c_void_p
_I = ctypes.c_int
# org, dir, rows, pids, boxes, blocks, blocks' count, width, height, tile, scratch, t, prim, stream
RASTER_KERNEL = CudaKernel("raster_primary.cu", "nrc_raster_closest",
                           [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P],
                           extra_flags=("-fmad=false",))


def raster_closest_cuda(meta: RasterMeta, rd: RasterData, org, direction):
    """R1 on the card -> (t [W*H] f32, prim [W*H] i64; RT_MAX / -1 on a
    miss) for pixel-linear org/direction [W*H, 3], tmin 0 and tmax RT_MAX."""
    if meta.tile > MAX_TILE:
        raise ValueError(f"tile {meta.tile}: the raster kernel takes tiles of at most {MAX_TILE} pixels")
    dev = org.device
    n = meta.width * meta.height
    org, direction = org.contiguous(), direction.contiguous()
    slots = rd.pids.shape[0]  # the rows held, at least the bins' (upload_raster)
    if slots < sum(k * g for k, g in zip(meta.group_k, meta.group_tiles)):
        raise ValueError(f"{slots} slots held for bins of {meta.group_k} x {meta.group_tiles}")
    check_cuda_tensor("org", org, torch.float32, (n, 3), dev)
    check_cuda_tensor("direction", direction, torch.float32, (n, 3), dev)
    check_cuda_tensor("rows", rd.rows, torch.float32, (slots, 9), dev)
    check_cuda_tensor("pids", rd.pids, torch.int32, (slots,), dev)
    check_cuda_tensor("boxes", rd.boxes, torch.int32, (slots,), dev)
    check_cuda_tensor("blocks", rd.blocks, torch.int32, (None, 4), dev)
    best = torch.empty((n,), dtype=torch.int64, device=dev)
    t = torch.empty((n,), dtype=torch.float32, device=dev)
    prim = torch.empty((n,), dtype=torch.int64, device=dev)
    RASTER_KERNEL.launch(
        ptr(org), ptr(direction), ptr(rd.rows), ptr(rd.pids), ptr(rd.boxes), ptr(rd.blocks), rd.blocks.shape[0],
        meta.width, meta.height, meta.tile, ptr(best), ptr(t), ptr(prim), current_stream(dev),
    )
    return t, prim
