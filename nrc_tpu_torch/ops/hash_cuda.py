"""The hash-grid encoding's lookup (H1) and adjoint (H2), and their plain versions.

Counterpart of ``nrc_tpu/ops/encodings.py:107-200,320-343``: for each query
position [3] and each of L levels, the 8 corners of the level's cell (a
dense stride index where the level's whole vertex grid fits the table, the
Instant-NGP spatial hash elsewhere), their rows of the [L, S, F] table
gathered and blended trilinearly into F features; [B, L * F] in all, column
l * F + f. The JAX package computes it with XLA gathers and takes the
adjoint (the table's gradient) by autodiff's scatter-add, or on a TPU by
one-hot matrix products, a workaround this port leaves out.

- H1 ``hash_grid_lookup_cuda`` (``csrc/hash_grid.cu::nrc_hash_lookup``): a
  block a tile of 32 queries, a warp a level, an aligned pair of x-corner
  rows in one read where ``idx1 == idx0 ^ 1``; equal to
  ``hash_grid_lookup_plain`` bit for bit.
- H2 ``hash_grid_adjoint_cuda`` (``nrc_hash_adjoint``): the corners
  recomputed, each term w * g quantised to a 64-bit fixed-point number
  (a power-of-two scale a level, from the batch's largest |g|, found on the
  device) and added with integer atomics, which give the same sum in any
  order; then rounded to f32 once. The same bits on every launch; held to
  ``hash_grid_adjoint_plain`` by ``tools/bench_hash.py::CARD_LIMITS`` and
  to ``bench_hash.fixed_point_adjoint``, the kernel's arithmetic in plain
  PyTorch, bit for bit.
- ``HashGridLookup``: the ``torch.autograd.Function`` over the pair, with
  respect to the table (positions get no gradient, as in the JAX package's
  training step, which differentiates the weights and the table only).

Device rule: on CUDA tensors each wrapper launches its kernel or raises; on
CPU tensors it runs the plain version.

The plain hash runs in int64 on the low bits: (a * b) & m and
(a & m) * (b & m) & m agree for m = 2^k - 1, and XOR commutes with the mask,
so masking each factor first keeps every product below 2^62 and the int32
to uint32 wrap of a negative cell coordinate is the two's complement's low
bits, as in the kernel.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch

from .cuda_build import CudaKernel, check_cuda_tensor, current_stream, ptr

MAX_LEVELS = 32            # csrc/hash_grid.cu::kMaxLevels
MAX_LOG2_SIZE = 30         # the kernels' limit; the plain hash needs <= 31
FEATURES = (1, 2, 4, 8)    # the kernels' row widths (tcnn's set)
PRIMES = (1, 2654435761, 805459861)

_P = ctypes.c_void_p
_I = ctypes.c_int
_RES = ctypes.POINTER(ctypes.c_int)
LOOKUP_KERNEL = CudaKernel(
    "hash_grid.cu", "nrc_hash_lookup", [_P, _P, _I, _I, _I, _I, _RES, _I, _P, _P],
    extra_flags=("-fmad=false",),
)
ADJOINT_ARGTYPES = [_P, _P, ctypes.c_longlong, _I, _I, _I, _I, _RES, _I, _P, _P, _P]
ADJOINT_KERNEL = CudaKernel("hash_grid.cu", "nrc_hash_adjoint", ADJOINT_ARGTYPES, extra_flags=("-fmad=false",))
# H2's scratch: a header of kMaxLevels 64-bit words (each level's largest
# |g|), then one 64-bit fixed-point sum a table float
SCRATCH_HEADER = MAX_LEVELS


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


@functools.lru_cache(maxsize=None)
def _res_array(spec: GridSpec):
    return (ctypes.c_int * spec.levels)(*spec.res)


def _dense_mask(spec: GridSpec) -> int:
    return sum(1 << l for l, d in enumerate(spec.dense) if d)


def check_spec(spec: GridSpec) -> None:
    if not 0 < spec.levels <= MAX_LEVELS or len(spec.dense) != spec.levels:
        raise ValueError(f"{spec.levels} levels: the kernels take 1 to {MAX_LEVELS}")
    if not 0 < spec.log2_size <= MAX_LOG2_SIZE:
        raise ValueError(f"log2 table size {spec.log2_size}: the kernels take 1 to {MAX_LOG2_SIZE}")
    if spec.features not in FEATURES:
        raise ValueError(f"{spec.features} features a level: the kernels take {FEATURES}")


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


# ---------------------------------------------------------------------------
# kernels on the card
# ---------------------------------------------------------------------------

def launch_lookup(kernel: CudaKernel, pos: torch.Tensor, table: torch.Tensor, spec: GridSpec) -> torch.Tensor:
    """Check the arguments and launch ``kernel``, an entry point with
    ``nrc_hash_lookup``'s arguments (the bench launches another tree's build
    through it): [B, 3], [L, S, F] -> [B, L * F] float32."""
    check_spec(spec)
    dev = pos.device
    pos, table = pos.contiguous(), table.contiguous()
    n = pos.shape[0]
    check_cuda_tensor("pos", pos, torch.float32, (n, 3), dev)
    check_cuda_tensor("table", table, torch.float32, spec.table_shape, dev)
    out = torch.empty((n, spec.levels * spec.features), dtype=torch.float32, device=dev)
    if n:
        kernel.launch(
            ptr(pos), ptr(table), n, spec.levels, spec.log2_size, spec.features,
            _res_array(spec), _dense_mask(spec), ptr(out), current_stream(dev),
        )
    return out


def hash_grid_lookup_cuda(pos: torch.Tensor, table: torch.Tensor, spec: GridSpec) -> torch.Tensor:
    """H1 on the card: [B, 3], [L, S, F] -> [B, L * F] float32."""
    return launch_lookup(LOOKUP_KERNEL, pos, table, spec)


def launch_adjoint(kernel: CudaKernel, pos: torch.Tensor, g: torch.Tensor, spec: GridSpec) -> torch.Tensor:
    """Check the arguments and launch ``kernel``, an entry point with
    ``nrc_hash_adjoint``'s arguments: the table's gradient [L, S, F]
    float32. ``g`` [B, L * F] is read through its row stride (the hash
    columns of K4's dX need no copy). An entry point without the scratch
    argument (an older tree's, which ``bench_hash --parent`` times) adds
    into a zeroed gradient."""
    check_spec(spec)
    dev = pos.device
    pos = pos.contiguous()
    n = pos.shape[0]
    check_cuda_tensor("pos", pos, torch.float32, (n, 3), dev)
    width = spec.levels * spec.features
    if g.device != dev:
        raise ValueError(f"g: on {g.device}, expected {dev}")
    if g.dtype != torch.float32:
        raise TypeError(f"g: dtype {g.dtype}, expected torch.float32")
    if tuple(g.shape) != (n, width):
        raise ValueError(f"g: shape {tuple(g.shape)}, expected {(n, width)}")
    if g.stride(1) != 1 or g.stride(0) < width:
        g = g.contiguous()
    fixed = len(kernel.argtypes) == len(ADJOINT_ARGTYPES)
    dtable = (torch.empty if n and fixed else torch.zeros)(spec.table_shape, dtype=torch.float32, device=dev)
    if n:
        args = [ptr(pos), ptr(g), g.stride(0), n, spec.levels, spec.log2_size, spec.features,
                _res_array(spec), _dense_mask(spec), ptr(dtable)]
        if fixed:
            scratch = torch.empty(SCRATCH_HEADER + dtable.numel(), dtype=torch.int64, device=dev)
            args.append(ptr(scratch))
        kernel.launch(*args, current_stream(dev))
    return dtable


def hash_grid_adjoint_cuda(pos: torch.Tensor, g: torch.Tensor, spec: GridSpec) -> torch.Tensor:
    """H2 on the card: the table's gradient [L, S, F] float32."""
    return launch_adjoint(ADJOINT_KERNEL, pos, g, spec)


# ---------------------------------------------------------------------------
# dispatch by device
# ---------------------------------------------------------------------------

def hash_grid_lookup(pos: torch.Tensor, table: torch.Tensor, spec: GridSpec) -> torch.Tensor:
    """[B, L * F]: H1 on a CUDA tensor, the plain version on a CPU one."""
    if pos.device.type == "cuda":
        return hash_grid_lookup_cuda(pos, table, spec)
    if pos.device.type == "cpu":
        return hash_grid_lookup_plain(pos, table, spec)
    raise ValueError(f"unsupported device {pos.device}")


def hash_grid_adjoint(pos: torch.Tensor, g: torch.Tensor, spec: GridSpec) -> torch.Tensor:
    """[L, S, F]: H2 on a CUDA tensor, the plain version on a CPU one."""
    if pos.device.type == "cuda":
        return hash_grid_adjoint_cuda(pos, g, spec)
    if pos.device.type == "cpu":
        return hash_grid_adjoint_plain(pos, g, spec)
    raise ValueError(f"unsupported device {pos.device}")


class HashGridLookup(torch.autograd.Function):
    """Differentiable lookup with respect to the table: H1 forward, H2
    backward on the card. ``apply(pos, table, spec)``."""

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
