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

- ``GATHER_KERNEL`` (K7, ``nrc_gather_rows``): table in device memory, one
  warp per row, four rows' loads in flight per warp;
- ``RESIDENT_KERNEL`` (K8, ``nrc_gather_rows_resident``): each block stages
  the table's leading rows (the top levels of the tree) in shared memory and
  serves those indices from there;
- ``BLOCK_KERNEL`` (K9, ``nrc_gather_rows_block``): one thread block per
  gathered row.

``PATH_KERNEL`` is the one ``gather_rows`` launches: the variant that
measured fastest at N = 102,400 on the H100 (PERF.md has the three times).
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
