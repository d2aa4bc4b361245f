"""Row gathers in plain PyTorch: ``table[idx]`` on any device (the plain
version of ``nrc_tpu_torch/ops/gather_cuda.py``'s K7-K9)."""

from __future__ import annotations

import torch


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` for ``table [R, P]`` and ``idx [N]``."""
    return table[idx]
