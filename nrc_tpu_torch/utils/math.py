"""Vector math, orthonormal frames and spherical mappings on [..., 3] tensors.

Port of the parts of ``nrc_tpu/utils/math.py`` the port uses (reference
helpers: ``nrc/shaders/shader_common.h``), with the per-ray record-slot
reads and writes of the training wavefront (``pick1``, ``put1``,
``add1``). Every function keeps the JAX version's operation order, so CPU
results agree to float32 rounding.
"""

from __future__ import annotations

import math

import torch

M_PI = math.pi


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Dot product over the trailing axis, keepdims dropped."""
    return (a * b).sum(dim=-1)


def length(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.clamp(dot(v, v), min=0.0))


def normalize(v: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    return v * torch.reciprocal(torch.clamp(length(v), min=eps))[..., None]


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.linalg.cross(a, b, dim=-1)


def safe_div(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise a/b with 0 where b == 0 (reference ``raygeneration.cu:44-51``)."""
    nz = b != 0.0
    return torch.where(nz, a / torch.where(nz, b, torch.ones_like(b)), torch.zeros_like(a))


def balance_heuristic(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """MIS balance heuristic a/(a+b) (reference ``shader_common.h:246-249``)."""
    return safe_div(a, a + b)


def align_vector(axis: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Rotate w (defined about +z) to be about ``axis`` (``shader_common.h:251-259``)."""
    s = torch.where(axis[..., 2] >= 0.0, 1.0, -1.0)
    wz = w[..., 2] * s
    w = torch.stack([w[..., 0], w[..., 1], wz], dim=-1)
    h = torch.stack([axis[..., 0], axis[..., 1], axis[..., 2] + s], dim=-1)
    k = dot(w, h) / (1.0 + torch.abs(axis[..., 2]))
    return k[..., None] * h - w


def build_onb(n: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Orthonormal basis (t, b) around unit normal n (Duff et al., branchless)."""
    sign = torch.where(n[..., 2] >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + n[..., 2])
    b = n[..., 0] * n[..., 1] * a
    t = torch.stack(
        [1.0 + sign * n[..., 0] * n[..., 0] * a, sign * b, -sign * n[..., 0]],
        dim=-1,
    )
    bi = torch.stack([b, sign + n[..., 1] * n[..., 1] * a, -n[..., 1]], dim=-1)
    return t, bi


def to_world(t: torch.Tensor, b: torch.Tensor, n: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Transform local-frame v=(x,y,z) into world space given ONB (t,b,n)."""
    return v[..., 0:1] * t + v[..., 1:2] * b + v[..., 2:3] * n


def elevation(d: torch.Tensor) -> torch.Tensor:
    """Numerically stable elevation of a unit vector (``shader_common.h:316-325``)."""
    zm1 = d[..., 2] - 1.0
    dist = torch.sqrt(d[..., 0] ** 2 + d[..., 1] ** 2 + zm1 * zm1)
    return 2.0 * torch.arcsin(torch.clamp(0.5 * dist, -1.0, 1.0))


def cartesian_to_spherical_unit(d: torch.Tensor) -> torch.Tensor:
    """(theta, phi) of a unit vector — network input param (``shader_common.h:328-334``)."""
    theta = elevation(d)
    phi = torch.atan2(d[..., 1], d[..., 0])
    return torch.stack([theta, phi], dim=-1)


def reflect(wi: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Mirror reflection of incoming direction ``wi`` (pointing at surface)."""
    return wi - 2.0 * dot(wi, n)[..., None] * n


def _slot_onehot(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """[N, K] bool, True at column idx[n] of each row (broadcast to x's trailing dims)."""
    oh = idx[:, None] == torch.arange(x.shape[1], dtype=idx.dtype, device=idx.device)
    return oh[..., None] if x.dim() == 3 else oh


def pick1(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [N, K] or [N, K, C], idx [N] -> x[arange(N), idx]."""
    return torch.gather(x, 1, idx.view(-1, *([1] * (x.dim() - 1))).expand(-1, 1, *x.shape[2:])).squeeze(1)


def put1(x: torch.Tensor, idx: torch.Tensor, v: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """x[arange(N), idx] = v where mask; every other slot keeps its bits."""
    oh = _slot_onehot(x, idx) & (mask[:, None, None] if x.dim() == 3 else mask[:, None])
    return torch.where(oh, v[:, None], x)


def add1(x: torch.Tensor, idx: torch.Tensor, v: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """x[arange(N), idx] += v where mask; every other slot keeps its bits
    (it adds nothing, where the JAX version adds 0.0: -0.0 stays -0.0)."""
    oh = _slot_onehot(x, idx) & (mask[:, None, None] if x.dim() == 3 else mask[:, None])
    return torch.where(oh, x + v[:, None], x)


def luminance(rgb: torch.Tensor) -> torch.Tensor:
    """NTSC luminance as the reference tonemapper weighs it (``Application.cpp:2620``)."""
    return (rgb * torch.tensor([0.3, 0.59, 0.11], dtype=rgb.dtype, device=rgb.device)).sum(dim=-1)
