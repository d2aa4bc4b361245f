"""Row gather ``out[i, :] = table[idx[i], :]``: kernels K7-K9 and their plain
version.

Counterpart of the three gather kernels of ``tools/bench_gather_pallas.py``
(``dma``, ``vmem``, ``blockspec``), which time how fast the wide walk's
unified node + leaf table (``[R, 160]`` float32, 640 bytes a row) can be
fetched by index. On the port's path the same function fetches the hit's
triangle row, its material row and the winner's ``p0|e1|e2``, and the plain
walk's table rows.

Rows are moved as 32-bit words. The walk's rows hold child metas and
primitive ids as bit-cast integers, many of them NaN patterns, so no
floating-point instruction may touch a row; the plain version is an index
select, which copies bits as well.

Device rule: on a CUDA tensor ``gather_rows`` launches ``csrc/gather_rows.cu``
or raises; on a CPU tensor it runs ``gather_rows_plain``. The three entry
points:

- ``GATHER_KERNEL`` (K7, ``nrc_gather_rows``): one launch a call, in one of
  two shapes fixed by the table's shape. Narrow rows (under 32 words or not
  a multiple of 4, as ``tris.packed`` and ``tri_shade``): output-major
  chunks, each thread storing 16-byte chunks of the flat output made of
  words read from the table, on a grid of at most one wave of resident
  blocks. Wide rows (a multiple of 4 words, at least 32, as ``mat_row`` and
  the walk's 160): a warp per row, 16-byte words, four rows' loads in flight
  per warp;
- ``RESIDENT_KERNEL`` (K8, ``nrc_gather_rows_resident``): the table kept in
  the L2 for the launch (rows read evict-last when the table fits half the
  L2, the output written evict-first), rows moved by bulk asynchronous
  copies through a ring of row slots in shared memory per thread; a table
  whose rows the bulk copies cannot move (not a multiple of 16 bytes, as
  the path's ``tri_shade`` and ``tris.packed``) takes K8's word loop, the
  warp loop with the same L2 policies;
- ``BLOCK_KERNEL`` (K9, ``nrc_gather_rows_block``): one thread block per
  gathered row.

``PATH_KERNEL`` is the one ``gather_rows`` launches: K7, the variant that
measured fastest on the path's tables and the walk's on the H100 (PERF.md
has the times of all three beside ``index_select``). K8 beats K7 on no
table, so there is no rule by table size between them.
"""

from __future__ import annotations

import ctypes

import torch

from .cuda_build import CudaKernel, check_cuda_tensor, current_stream, ptr

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGS = [_P, _P, _P, _I, _I, _I, _P]  # table, idx, out, n, row words, table rows, stream
GATHER_KERNEL = CudaKernel("gather_rows.cu", "nrc_gather_rows", _ARGS)
RESIDENT_KERNEL = CudaKernel("gather_rows.cu", "nrc_gather_rows_resident", _ARGS)
BLOCK_KERNEL = CudaKernel("gather_rows.cu", "nrc_gather_rows_block", _ARGS)
VARIANTS = {"warp": GATHER_KERNEL, "resident": RESIDENT_KERNEL, "block": BLOCK_KERNEL}
PATH_KERNEL = GATHER_KERNEL


def gather_rows_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain version: ``table[idx]`` for ``table [R, P]``, ``idx [N]``."""
    return table[idx]


def gather_rows_cuda(kernel: CudaKernel, table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """One of K7-K9 on the card. ``table [R, P]`` float32, ``idx [N]`` int64
    (int32 is converted), every index in [0, R): the kernels clamp an index
    outside it to stay inside the table, they do not report it."""
    dev = table.device
    check_cuda_tensor("table", table, torch.float32, (None, None), dev)
    if idx.dtype == torch.int32:
        idx = idx.to(torch.int64)
    idx = idx.contiguous()
    check_cuda_tensor("idx", idx, torch.int64, (None,), dev)
    rows, width = table.shape
    n = idx.shape[0]
    if rows == 0 and n:
        raise ValueError("gather from an empty table")
    out = torch.empty((n, width), dtype=torch.float32, device=dev)
    if n and width:
        kernel.launch(ptr(table), ptr(idx), ptr(out), n, width, rows, current_stream(dev))
    return out


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` for ``table [R, P]`` float32 and ``idx [N]``, bit for bit."""
    if table.device.type == "cuda":
        return gather_rows_cuda(PATH_KERNEL, table, idx)
    if table.device.type != "cpu":
        raise ValueError(f"unsupported device {table.device}")
    return gather_rows_plain(table, idx)
