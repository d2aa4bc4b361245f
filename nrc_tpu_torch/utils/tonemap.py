"""Tonemapper: the reference's display tone curve over a whole HDR image.

Port of ``nrc_tpu/utils/tonemap.py`` (the reference implements the same
formula as a GLSL shader, ``nrc/src/Rasterizer.cpp:548-577``, and as a CPU
loop for screenshots, ``nrc/src/Application.cpp:2596-2645``): ``tonemap``,
``tonemap_to_u8`` and ``time_view_ramp``, the cold-to-hot colour ramp of
``RenderMode.DEBUG_TIME_VIEW``.
"""

from __future__ import annotations

import torch

from ..config import TonemapperConfig
from .math import luminance


def tonemap(hdr: torch.Tensor, cfg: TonemapperConfig) -> torch.Tensor:
    """HDR [..., 3] float -> LDR [..., 3] float in [0, 1]."""
    inv_gamma = 1.0 / cfg.gamma
    color_balance = torch.tensor(cfg.color_balance, dtype=hdr.dtype, device=hdr.device)
    inv_white_point = cfg.brightness / cfg.white_point
    burn = cfg.burn_highlights
    crush = cfg.crush_blacks + cfg.crush_blacks + 1.0
    saturation = cfg.saturation

    ldr = inv_white_point * color_balance * hdr
    ldr = ldr * ((ldr * burn) + 1.0) / (ldr + 1.0)

    lum = luminance(ldr)[..., None]
    ldr = lum + saturation * (ldr - lum)
    ldr = torch.clamp(ldr, min=0.0)

    lum = luminance(ldr)[..., None]
    crushed = torch.pow(torch.clamp(ldr, min=0.0), crush)
    t = torch.sqrt(torch.clamp(lum, min=0.0))
    ldr = torch.where(lum < 1.0, crushed + t * (ldr - crushed), ldr)
    ldr = torch.clamp(ldr, min=0.0)

    return torch.clamp(torch.pow(ldr, inv_gamma), 0.0, 1.0)


def tonemap_to_u8(hdr: torch.Tensor, cfg: TonemapperConfig) -> torch.Tensor:
    """HDR [..., 3] -> uint8 [..., 3], the tone curve scaled by 255 and
    truncated, as ``nrc_tpu/utils/tonemap.py:42`` casts."""
    return (tonemap(hdr, cfg) * 255.0).to(torch.uint8)


# Cold-to-hot ramp of the reference's USE_TIME_VIEW display path
# (``Rasterizer.cpp:306-345``): blue, green, red, yellow, white at
# u = 0, .25, .5, .75, 1.
_RAMP_U = (0.0, 0.25, 0.5, 0.75, 1.0)
_RAMP_C = (
    (0.0, 0.0, 1.0),
    (0.0, 1.0, 0.0),
    (1.0, 0.0, 0.0),
    (1.0, 1.0, 0.0),
    (1.0, 1.0, 1.0),
)


def time_view_ramp(x: torch.Tensor) -> torch.Tensor:
    """[...] in [0, 1] -> [..., 3] through the cold-to-hot colour ramp
    (``nrc_tpu/utils/tonemap.py:59``). The colours are Python floats, so no
    tensor is made from host data (a captured frame calls it)."""
    x = torch.clamp(x, 0.0, 1.0)
    out = torch.zeros((*x.shape, 3), dtype=x.dtype, device=x.device)
    for i in range(len(_RAMP_U) - 1):
        u0, u1 = _RAMP_U[i], _RAMP_U[i + 1]
        t = torch.clamp((x - u0) / (u1 - u0), 0.0, 1.0)
        seg = torch.stack([c0 + t * (c1 - c0) for c0, c1 in zip(_RAMP_C[i], _RAMP_C[i + 1])], dim=-1)
        lo = (x >= u0) if i else (x >= -1.0)
        hi = (x < u1) if i + 2 < len(_RAMP_U) else (x <= 1.0)
        out = torch.where((lo & hi)[..., None], seg, out)
    return out
