"""The per-frame step of the serving path: render, infer, accumulate.

Port of ``nrc_tpu/render/frame.py:162-316`` with ``cfg.train=False``
(reference ``Device::render``, ``nrc/src/Device.cpp:2292-2517``, without its
training half): primary rays for every pixel, the render wavefront, one
cache inference over the render queries (``Device::nrcInferRadiance``,
``Device.cpp:1272-1308``) and the mode-dependent accumulation
(``accumulate_render_radiance``, ``nrc_helpers.cu:77-129``) with the
incremental mean of ``raygeneration.cu:406-411``. ``DEBUG_TIME_VIEW`` waits
for the tonemapper port and raises.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import FrameConfig, NetworkConfig, RenderMode
from ..models import network as N
from ..scene.camera import generate_primary_rays
from ..utils import rng as R
from .integrator import check_frame_config, trace_wavefront
from .scene_device import DeviceScene


class FrameStats(NamedTuple):
    loss: float                  # 0: the serving path does not train
    num_train_records: int       # 0: the serving path does not train
    # rays actually cast this frame (closest-hit segments of live lanes +
    # shadow rays with a valid light sample) — the Mrays/s numerator
    traced_rays: torch.Tensor    # scalar i64 on the frame's device


class CameraArrays(NamedTuple):
    p: torch.Tensor
    u: torch.Tensor
    v: torch.Tensor
    w: torch.Tensor


def pixel_grid(cfg: FrameConfig, device: torch.device):
    """Pixel coordinates [H*W, 2] f32 and linear indices [H*W] (the RNG
    stream id of each pixel)."""
    lin = torch.arange(cfg.height * cfg.width, dtype=torch.int64, device=device)
    ys = lin // cfg.width
    xs = lin % cfg.width
    return torch.stack([xs, ys], dim=-1).to(torch.float32), ys * cfg.width + xs


def frame_step(
    scene: DeviceScene,
    net_state: N.NetworkState,
    image: torch.Tensor,          # [H*W, 3] accumulated HDR
    camera: CameraArrays,
    iteration_index: int,         # accumulation index (resets on camera move)
    total_subframe: int,          # ever-increasing (RNG stream)
    cfg: FrameConfig,
    net_cfg: NetworkConfig,
) -> tuple[torch.Tensor, FrameStats]:
    """One frame (1 spp). Returns (image', stats)."""
    check_frame_config(cfg)
    mode = cfg.render_mode
    if mode == RenderMode.DEBUG_TIME_VIEW:
        raise NotImplementedError("DEBUG_TIME_VIEW waits for the tonemapper port")

    pix, pidx = pixel_grid(cfg, image.device)
    seeds = R.tea(pidx, total_subframe)
    seeds, jitter = R.rng2(seeds)
    org, dirn = generate_primary_rays(
        pix, jitter, (cfg.width, cfg.height), camera.p, camera.u, camera.v, camera.w,
        lens=cfg.lens_shader,
    )
    out = trace_wavefront(scene, org, dirn, seeds, cfg)
    traced_rays = out.traced_count.sum()

    # ---- cache inference (Device::nrcInferRadiance) ---------------------
    query: Optional[torch.Tensor] = None
    if mode in (RenderMode.FULL, RenderMode.CACHE_ONLY,
                RenderMode.DEBUG_CACHE_NO_THROUGHPUT_MODULATION):
        query = out.render_query
    elif mode == RenderMode.CACHE_FIRST_VERTEX:
        query = out.cache_vis_query
    cache = N.infer(net_state, query, net_cfg) if query is not None else None

    # ---- accumulate into the image ---------------------------------------
    w_acc = float(np.float32(1.0) / (np.float32(iteration_index) + np.float32(1.0)))
    if mode == RenderMode.FULL:
        contrib = out.radiance + out.last_render_throughput * cache
        image = image + (contrib - image) * w_acc
    elif mode == RenderMode.NO_CACHE:
        image = image + (out.radiance - image) * w_acc
    elif mode == RenderMode.CACHE_ONLY:
        image = out.last_render_throughput * cache
    elif mode in (RenderMode.CACHE_FIRST_VERTEX,
                  RenderMode.DEBUG_CACHE_NO_THROUGHPUT_MODULATION):
        image = cache
    elif mode == RenderMode.DEBUG_THROUGHPUT_ONLY:
        image = out.last_render_throughput
    return image, FrameStats(loss=0.0, num_train_records=0, traced_rays=traced_rays)
