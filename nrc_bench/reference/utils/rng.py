"""Counter-based per-ray RNG: TEA seeding + LCG stream.

Bit-exact port of ``nrc_tpu/utils/rng.py`` (itself the reference's
``nrc/shaders/random_number_generators.h:38-131``): a TEA<4> hash of
(pixel_index, subframe_index) seeds a 32-bit LCG whose upper 24 bits give
uniform floats in [0, 1).

PyTorch's ``uint32`` supports little arithmetic, so seeds live in ``int64``
tensors holding values in [0, 2^32) and every step masks with
``& 0xFFFFFFFF``. Logical ``>>`` is exact because the values are
non-negative, and the largest product (``seed * 1664525`` < 2^53) fits in
int64 without wrapping.

A frame's counters reach ``tea`` as 0-d device tensors (``Renderer``) or as
Python ints (direct calls). An int stays a Python int: its rounds are
scalar operands of the tensor operations, so no tensor is made from it and
nothing is copied to the device.
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
_LCG_A = 1664525
_LCG_C = 1013904223


def as_seed(x, device=None) -> torch.Tensor:
    """Any integer tensor or array -> int64 seed tensor in [0, 2^32)."""
    return torch.as_tensor(x, dtype=torch.int64, device=device) & MASK32


def tea(val0, val1, rounds: int = 4) -> torch.Tensor:
    """Tiny Encryption Algorithm hash (reference ``tea<N>``); broadcasts.
    ``val1`` may be a Python int, which no tensor is made of."""
    v0 = as_seed(val0)
    v1 = val1 & MASK32 if isinstance(val1, int) else as_seed(val1, v0.device)
    s0 = 0
    for _ in range(rounds):
        s0 = (s0 + 0x9E3779B9) & MASK32
        v0 = (
            v0
            + (
                (((v1 << 4) + 0xA341316C) & MASK32)
                ^ ((v1 + s0) & MASK32)
                ^ (((v1 >> 5) + 0xC8013EA4) & MASK32)
            )
        ) & MASK32
        v1 = (
            v1
            + (
                (((v0 << 4) + 0xAD90777D) & MASK32)
                ^ ((v0 + s0) & MASK32)
                ^ (((v0 >> 5) + 0x7E95761E) & MASK32)
            )
        ) & MASK32
    return v0


def lcg_step(seed: torch.Tensor) -> torch.Tensor:
    return (seed * _LCG_A + _LCG_C) & MASK32


def rng(seed: torch.Tensor):
    """One LCG step; returns (new_seed, float32 in [0,1) from the upper 24 bits)."""
    seed = lcg_step(seed)
    return seed, (seed >> 8).to(torch.float32) * (1.0 / 16777216.0)


def _rng_n(seed: torch.Tensor, n: int):
    out = []
    for _ in range(n):
        seed, u = rng(seed)
        out.append(u)
    return seed, torch.stack(out, dim=-1)


def rng2(seed: torch.Tensor):
    return _rng_n(seed, 2)


def rng4(seed: torch.Tensor):
    return _rng_n(seed, 4)
