"""Procedural 3D noise fields evaluated at shade time.

Port of ``nrc_tpu/ops/noise.py:23-202``: Perlin gradient noise with fBm
octaves, Worley cellular F1, and the MDL base module's noise texture
(``base::perlin_noise_texture`` / ``flow_noise_texture`` /
``worley_noise_texture``, the reference's ``noise_*_glossy.mdl``) as a tint
and as a bump of the shading normal, at the world hit position.

The lattice hash is u32 arithmetic. PyTorch's ``uint32`` supports little of
it, so values live in ``int64`` tensors in [0, 2^32), as the RNG's do
(``utils/rng.py``): a negative lattice coordinate becomes its u32 by
``& MASK32``, and a constant multiply is split into the constant's 16-bit
halves, so that each partial product stays under 2^49 before the mask (a
product of two u32 values would reach 2^64 and wrap int64).

Every lane computes every field, as the JAX program does: fBm, abs-fBm and
Worley, then a select by mode. The float arithmetic of each element is the
JAX package's, in its order; the port batches what the JAX code unrolls (a
Perlin cell's 8 corners, a Worley point's 27 cells, the fBm octaves and the
bump's four field evaluations) along an extra tensor dimension, so that a
frame issues one kernel where it would issue eight or 27. The fBm and
abs-fBm sums read the same octaves, which the JAX program also computes
once (XLA merges the two identical ``perlin3`` calls). The hash's linear
part is exact mod 2^32, so a neighbour cell's is the point's plus the
offset's (``_cell_hashes``): the same bits with one pass of the avalanche
a cell.
"""

from __future__ import annotations

import torch

from ..utils.rng import MASK32

# noise_mode values stored in the material row
NOISE_NONE = 0
NOISE_PERLIN = 1
NOISE_FLOW = 2
NOISE_WORLEY = 3

_INV_U32_MAX = 2.0 ** -32  # float32(1 / float32(2^32 - 1)), as the JAX package's ``inv``


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2^32 for a in [0, 2^32) and a u32 constant c, through its
    16-bit halves (every intermediate below 2^49)."""
    return (a * (c & 0xFFFF) + (((a * (c >> 16)) & 0xFFFF) << 16)) & MASK32


def _mix(ix: torch.Tensor, iy: torch.Tensor, iz: torch.Tensor) -> torch.Tensor:
    """The hash's linear part, ix * A + iy * B + iz * C mod 2^32."""
    return (_mul32(ix & MASK32, 0x8DA6B343) + _mul32(iy & MASK32, 0xD8163841)
            + _mul32(iz & MASK32, 0xCB1AB31F)) & MASK32


def _finish(h: torch.Tensor) -> torch.Tensor:
    """The hash's avalanche on its linear part."""
    h = h ^ (h >> 13)
    h = _mul32(h, 0x9E3779B1)
    return h ^ (h >> 16)


def _hash3(ix: torch.Tensor, iy: torch.Tensor, iz: torch.Tensor) -> torch.Tensor:
    """Lattice hash -> u32 in an int64 tensor (TEA-flavoured integer mix)."""
    return _finish(_mix(ix, iy, iz))


def _cell_hashes(ix, iy, iz, dx, dy, dz) -> torch.Tensor:
    """``_hash3`` of the cells (ix + dx, iy + dy, iz + dz) [..., K] for a
    point's cell [...] and K offsets: the linear part is exact arithmetic
    mod 2^32, so it is the point's part plus each offset's, and only the
    avalanche runs K times a point (the same bits as ``_hash3`` of each cell)."""
    return _finish((_mix(ix, iy, iz)[..., None] + _mix(dx, dy, dz)) & MASK32)


def _gradients(device) -> torch.Tensor:
    """Perlin's 12 cube-edge gradients [12, 3], gradient h % 12 of a hash,
    made on the device (a frame makes no tensor of host data)."""
    h = torch.arange(12, device=device)
    one = torch.ones(12, device=device)
    sign0 = torch.where((h & 1) == 0, one, -one)
    sign1 = torch.where((h & 2) == 0, one, -one)
    gx = torch.where(h < 8, sign0, 0.0)
    gy = torch.where(h < 4, sign1, torch.where(h >= 8, sign0, 0.0))
    gz = torch.where((h >= 4) & (h < 8), sign1, torch.where(h >= 8, sign1, 0.0))
    return torch.stack([gx, gy, gz], dim=-1)


def _grad_dot(h, fx, fy, fz):
    """dot(gradient(corner), offset) for corner hashes h with Perlin's 12
    cube-edge gradients (entries 0 and +-1: each product exact)."""
    g = _gradients(fx.device)[h % 12]
    return g[..., 0] * fx + g[..., 1] * fy + g[..., 2] * fz


def _fade(t):
    return t * t * t * (t * (t * 6.0 - 15.0) + 10.0)


def _lattice(p: torch.Tensor):
    """floor(p) as integers and the offset within the cell, per axis."""
    pf = torch.floor(p)
    i = pf.to(torch.int64)
    f = p - pf
    return (i[..., 0], i[..., 1], i[..., 2]), (f[..., 0], f[..., 1], f[..., 2])


def perlin3(p: torch.Tensor) -> torch.Tensor:
    """Classic Perlin gradient noise, p [..., 3] -> [...] in ~[-1, 1]; the
    cell's 8 corners along one extra dimension."""
    (ix, iy, iz), (fx, fy, fz) = _lattice(p)
    # the corners in the JAX package's order (dx fastest), made on the
    # device: a frame makes no tensor of host data
    k = torch.arange(8, device=p.device)
    dx, dy, dz = k & 1, (k >> 1) & 1, k >> 2
    n = _grad_dot(_cell_hashes(ix, iy, iz, dx, dy, dz), fx[..., None] - dx, fy[..., None] - dy, fz[..., None] - dz)
    u, v, w = _fade(fx), _fade(fy), _fade(fz)
    n000, n100, n010, n110, n001, n101, n011, n111 = n.unbind(-1)
    nx00 = n000 + u * (n100 - n000)
    nx10 = n010 + u * (n110 - n010)
    nx01 = n001 + u * (n101 - n001)
    nx11 = n011 + u * (n111 - n011)
    nxy0 = nx00 + v * (nx10 - nx00)
    nxy1 = nx01 + v * (nx11 - nx01)
    return nxy0 + w * (nxy1 - nxy0)


def _octaves(p: torch.Tensor, levels: int, phase: float = 0.0) -> torch.Tensor:
    """The fBm octaves' Perlin values [..., L]: q = p + phase, then q * 2 + 13.7
    from octave to octave."""
    q = p + phase
    qs = []
    for _ in range(max(int(levels), 1)):
        qs.append(q)
        q = q * 2.0 + 13.7
    return perlin3(torch.stack(qs, dim=-2))


def _fbm_sum(n: torch.Tensor, absolute: bool) -> torch.Tensor:
    """The fBm sum of octave values n [..., L], normalized to ~[0, 1]."""
    total = torch.zeros_like(n[..., 0])
    amp = 1.0
    norm = 0.0
    for level in range(n.shape[-1]):
        o = n[..., level]
        total = total + amp * (torch.abs(o) if absolute else o)
        norm += amp
        amp *= 0.5
    total = total / norm
    return total if absolute else total * 0.5 + 0.5


def fbm3(p: torch.Tensor, levels: int, absolute: bool, phase: float = 0.0) -> torch.Tensor:
    """Summed-octave Perlin (fBm), normalized to ~[0, 1]. ``absolute`` sums
    |octave| (turbulence, MDL's ``absolute_noise``); ``phase`` offsets the
    field (the flow noise's phase; a static scene renders phase 0)."""
    return _fbm_sum(_octaves(p, levels, phase), absolute)


def worley3(p: torch.Tensor) -> torch.Tensor:
    """Worley (cellular) F1 distance, p [..., 3] -> [...] in ~[0, 1]; the 27
    cells along one extra dimension (a minimum is exact in any order)."""
    (ix, iy, iz), (fx, fy, fz) = _lattice(p)
    # the 27 neighbour cells in the JAX package's order (dz fastest)
    k = torch.arange(27, device=p.device)
    dx, dy, dz = k // 9 - 1, k // 3 % 3 - 1, k % 3 - 1
    h = _cell_hashes(ix, iy, iz, dx, dy, dz)
    cx = dx + h.to(torch.float32) * _INV_U32_MAX
    h2 = _mul32(h, 0x85EBCA6B) ^ (h >> 15)
    cy = dy + h2.to(torch.float32) * _INV_U32_MAX
    h3 = _mul32(h2, 0xC2B2AE35) ^ (h2 >> 13)
    cz = dz + h3.to(torch.float32) * _INV_U32_MAX
    d2 = (cx - fx[..., None]) ** 2 + (cy - fy[..., None]) ** 2 + (cz - fz[..., None]) ** 2
    best = torch.clamp(d2.amin(dim=-1), max=1e30)
    return torch.clamp(torch.sqrt(best), 0.0, 1.0)


def noise_scalar(mode, q, levels: int, absolute, thr_low, thr_high, apply_marble):
    """Post-threshold scalar noise field in [0, 1] at pre-scaled ``q`` [..., 3];
    the per-lane inputs broadcast against q's leading dimensions."""
    octaves = _octaves(q, levels)
    n_per = _fbm_sum(octaves, False)
    n_abs = _fbm_sum(octaves, True)
    n_wor = worley3(q)
    base = torch.where(mode == NOISE_WORLEY, n_wor, torch.where(absolute != 0, n_abs, n_per))
    # marble: sin banding along x modulated by the noise (base module's
    # apply_marble), remapped to [0, 1]
    marble = 0.5 + 0.5 * torch.sin((q[..., 0] + base * 5.0) * 3.14159265)
    val = torch.where(apply_marble != 0, marble, base)
    # threshold window remap (noise_threshold_low/high)
    lo = thr_low
    hi = torch.maximum(thr_high, lo + 1e-6)
    return torch.clamp((val - lo) / (hi - lo), 0.0, 1.0)


def noise_tint(color1, color2, value):
    """MDL ``base::*_noise_texture`` colour: color1 + field * (color2 -
    color1), [N, 3], from ``value``, the field at the scaled world position
    (``noise_scalar`` at ``pos * scale``; ``bump_fields``' first where the
    bump has it). Mode-0 lanes get a colour too; callers mask."""
    return color1 + value[..., None] * (color2 - color1)


BUMP_STEP = 1e-2  # the forward differences' step in the scaled noise domain


def bump_fields(mode, pos, scale, levels: int, absolute, thr_low, thr_high, apply_marble, h: float = BUMP_STEP):
    """The field at q = pos * scale and at q plus h along x, y and z, [4, N]:
    the four evaluations of the bump in one batch."""
    q = pos * scale
    zero = torch.zeros_like(q[..., 0])
    steps = [torch.stack([zero + h if axis == k else zero for k in range(3)], dim=-1) for axis in range(3)]
    return noise_scalar(mode, torch.stack([q] + [q + s for s in steps]), levels, absolute, thr_low, thr_high,
                        apply_marble)


def noise_bump_normal(ns, scale, factor, f, h: float = BUMP_STEP):
    """MDL ``base::*_noise_bump_texture``: the shading normal moved against
    the tangential gradient of the noise field, from ``f``, the four fields
    of ``bump_fields`` (forward differences in the scaled noise domain). A
    unit normal; lanes with ``factor == 0`` get ``ns`` back unchanged."""
    f0 = f[0]
    g = torch.stack([(f[1] - f0) / h, (f[2] - f0) / h, (f[3] - f0) / h], dim=-1) * scale
    # tangential component only (a bump never changes the mean surface)
    g_t = g - (g * ns).sum(dim=-1, keepdim=True) * ns
    n2 = ns - factor[..., None] * g_t
    n2 = n2 / torch.clamp(torch.sqrt((n2 * n2).sum(dim=-1, keepdim=True)), min=1e-8)
    return torch.where((factor != 0.0)[..., None], n2, ns)
