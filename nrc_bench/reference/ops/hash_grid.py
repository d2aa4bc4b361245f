"""The hash grid's lookup and adjoint in plain PyTorch, on any device.

A frozen copy of the plain versions in ``nrc_tpu_torch/ops/hash_cuda.py``
(the level constants, the corner index and weight, the lookup, and the
adjoint as a scatter-add in f32), without the kernels H1/H2 and their
launch code: the benchmark's reference computes the hash encoding with
these on the card as on the CPU.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import torch

MAX_LEVELS = 32
PRIMES = (1, 2654435761, 805459861)


class GridSpec(NamedTuple):
    """The grid's static shape: per-level resolutions, which levels are
    indexed densely, the table's log2 size and features per level
    (``ops/encodings.py::grid_spec`` makes it from a ``NetworkConfig``)."""

    res: Tuple[int, ...]
    dense: Tuple[bool, ...]
    log2_size: int
    features: int

    @property
    def levels(self) -> int:
        return len(self.res)

    @property
    def size(self) -> int:
        return 1 << self.log2_size

    @property
    def table_shape(self) -> Tuple[int, int, int]:
        return (self.levels, self.size, self.features)


class _LevelTensors(NamedTuple):
    res: torch.Tensor     # [L] f32
    verts: torch.Tensor   # [L] i64, res + 1
    dense: torch.Tensor   # [L] bool
    offset: torch.Tensor  # [L] i64, l * S: the level's first row of the flat table


@functools.lru_cache(maxsize=None)
def _level_tensors(spec: GridSpec, device: torch.device) -> _LevelTensors:
    """Made once per grid and device: they are copied from the host, which a
    captured frame cannot do."""
    return _LevelTensors(
        torch.tensor(spec.res, dtype=torch.float32, device=device),
        torch.tensor([r + 1 for r in spec.res], dtype=torch.int64, device=device),
        torch.tensor(spec.dense, dtype=torch.bool, device=device),
        torch.arange(spec.levels, dtype=torch.int64, device=device) * spec.size,
    )


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def corner_index_weight(pos: torch.Tensor, corner: int, spec: GridSpec):
    """Row within its level and trilinear weight of one voxel corner, all
    levels at once (``_corner_index_weight_all_levels``): pos [B, 3] ->
    (idx [B, L] int64 in [0, S), w [B, L] f32)."""
    lt = _level_tensors(spec, pos.device)
    p = pos[:, None, :] * lt.res[:, None]            # [B, L, 3]
    p0 = torch.floor(p)
    frac = p - p0
    p0 = p0.to(torch.int32).to(torch.int64)
    d = ((corner & 1), (corner >> 1) & 1, (corner >> 2) & 1)
    v = [p0[..., k] + d[k] for k in range(3)]
    m = spec.size - 1
    h = ((v[0] & m) * (PRIMES[0] & m)) ^ ((v[1] & m) * (PRIMES[1] & m)) ^ ((v[2] & m) * (PRIMES[2] & m))
    idx_hash = h & m
    # dense stride index over the (res + 1)^3 vertex grid, clamped in range
    # (positions can stray outside [0, 1]; hashed levels wrap by the hash)
    top = lt.verts - 1
    c = [torch.minimum(torch.clamp(vk, min=0), top) for vk in v]
    idx_dense = c[0] + lt.verts * (c[1] + lt.verts * c[2])
    idx = torch.where(lt.dense, idx_dense, idx_hash)
    w = [frac[..., k] if d[k] else 1.0 - frac[..., k] for k in range(3)]
    return idx, (w[0] * w[1]) * w[2]


def hash_grid_lookup_plain(pos: torch.Tensor, table: torch.Tensor, spec: GridSpec) -> torch.Tensor:
    """Plain PyTorch version of H1: pos [B, 3], table [L, S, F] -> [B, L * F]."""
    n = pos.shape[0]
    L, S, F = table.shape
    flat = table.reshape(L * S, F)
    ofs = _level_tensors(spec, pos.device).offset
    acc = torch.zeros((n, L, F), dtype=table.dtype, device=table.device)
    for corner in range(8):
        idx, w = corner_index_weight(pos, corner, spec)
        acc = acc + w[..., None] * flat[idx + ofs]
    return acc.reshape(n, L * F)


def hash_grid_adjoint_plain(pos: torch.Tensor, g: torch.Tensor, spec: GridSpec) -> torch.Tensor:
    """Plain PyTorch version of H2: the table's gradient [L, S, F] of the
    lookup at ``pos`` for the output gradient g [B, L * F] (a scatter-add of
    w * g over the 8 corners, corner by corner, in query order on the CPU)."""
    n = pos.shape[0]
    L, S, F = spec.table_shape
    ofs = _level_tensors(spec, pos.device).offset
    g3 = g.reshape(n, L, F)
    dflat = torch.zeros((L * S, F), dtype=torch.float32, device=pos.device)
    for corner in range(8):
        idx, w = corner_index_weight(pos, corner, spec)
        dflat.index_add_(0, (idx + ofs).reshape(-1), (w[..., None] * g3).reshape(-1, F))
    return dflat.view(L, S, F)


def hash_grid_lookup(pos: torch.Tensor, table: torch.Tensor, spec: GridSpec) -> torch.Tensor:
    """[B, L * F] on any device: the plain version."""
    return hash_grid_lookup_plain(pos, table, spec)


def hash_grid_adjoint(pos: torch.Tensor, g: torch.Tensor, spec: GridSpec) -> torch.Tensor:
    """[L, S, F] on any device: the plain version."""
    return hash_grid_adjoint_plain(pos, g, spec)


class HashGridLookup(torch.autograd.Function):
    """Differentiable lookup with respect to the table, plain both ways.
    ``apply(pos, table, spec)``."""

    @staticmethod
    def forward(ctx, pos, table, spec: GridSpec):
        ctx.spec = spec
        ctx.save_for_backward(pos)
        return hash_grid_lookup(pos, table, spec)

    @staticmethod
    def backward(ctx, g):
        (pos,) = ctx.saved_tensors
        dtable = hash_grid_adjoint(pos, g, ctx.spec) if ctx.needs_input_grad[1] else None
        return None, dtable, None
