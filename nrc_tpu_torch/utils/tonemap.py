"""Tonemapper: the reference's display tone curve over a whole HDR image.

Port of ``nrc_tpu/utils/tonemap.py::tonemap`` (the reference implements the
same formula as a GLSL shader, ``nrc/src/Rasterizer.cpp:548-577``, and as a
CPU loop for screenshots, ``nrc/src/Application.cpp:2596-2645``), and its
``tonemap_to_u8``. The time-view ramp of that module is not ported yet.
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
