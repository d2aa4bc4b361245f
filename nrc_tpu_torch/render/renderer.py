"""Host-side renderer: accumulation and the frame loop of the serving path.

Port of ``nrc_tpu/render/renderer.py:45-407`` (reference
``Application::render/benchmark`` + ``Raytracer::render``,
``Application.cpp:417-540``): uploads the scene to one device, initializes
the cache network from a seeded ``torch.Generator``, runs ``frame_step``
once per subframe and restarts accumulation on state changes.

Only inference is ported: ``train=True`` raises. ``device`` decides where
everything runs; a CUDA device without a card raises, and nothing falls
back to the CPU.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from ..config import FrameConfig, NetworkConfig, RenderMode, SystemConfig
from ..models import network as N
from ..scene.scene_builder import Scene
from .frame import CameraArrays, FrameStats, frame_step
from .scene_device import DeviceScene, upload_scene


class Renderer:
    """Single-device renderer of the serving path (render + cache inference)."""

    def __init__(
        self,
        scene: Scene,
        system: SystemConfig,
        net_cfg: Optional[NetworkConfig] = None,
        render_mode: RenderMode = RenderMode.FULL,
        train: bool = False,
        device=torch.device("cuda"),
    ):
        if train:
            raise NotImplementedError("training lands with K4-K6")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Renderer(device='cuda'): no CUDA device is available")
        self.scene = scene
        self.system = system
        self.net_cfg = net_cfg or NetworkConfig()
        self.device_scene: DeviceScene = upload_scene(scene, self.device)

        # per-scene normalization of query positions (the reference hardcodes
        # 0.005 for Cornell, hit.cu:595-597; derived from the scene AABB)
        lo, hi = scene.aabb()
        extent = float(np.max(hi - lo)) if lo.size else 1.0

        w, h = system.resolution
        self.cfg = FrameConfig(
            width=w,
            height=h,
            tile_size=system.tile_size,
            max_depth=system.path_lengths[1],
            min_depth_rr=system.path_lengths[0],
            render_mode=render_mode,
            train=False,
            lens_shader=scene.lens_shader,
            scene_epsilon=system.scene_epsilon,
            walk_length=system.walk_length,
            position_scale=0.1 / max(extent, 1e-6),
        )
        # random weights from seed 0, as the JAX renderer's default
        self.net_state = N.init_network(
            torch.Generator().manual_seed(0), self.net_cfg, self.device
        )
        self.image = torch.zeros((w * h, 3), dtype=torch.float32, device=self.device)
        self.iteration = 0
        self.total_subframe = 0
        self.last_stats: Optional[FrameStats] = None

    # -- state management --------------------------------------------------

    def restart_accumulation(self) -> None:
        """Camera/material change restarts progressive accumulation."""
        self.iteration = 0
        self.image = torch.zeros_like(self.image)

    def set_render_mode(self, mode: RenderMode) -> None:
        self.cfg = dataclasses.replace(self.cfg, render_mode=mode)
        self.restart_accumulation()

    def _camera_arrays(self) -> CameraArrays:
        return CameraArrays(
            *(torch.as_tensor(a, device=self.device) for a in self.scene.camera.frustum())
        )

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- frame loop --------------------------------------------------------

    def render_frame(self) -> FrameStats:
        """One subframe (1 spp accumulated)."""
        self.image, stats = frame_step(
            self.device_scene,
            self.net_state,
            self.image,
            self._camera_arrays(),
            self.iteration,
            self.total_subframe,
            self.cfg,
            self.net_cfg,
        )
        self.iteration += 1
        self.total_subframe += 1
        self.last_stats = stats
        return stats

    def render(self, spp: int) -> FrameStats:
        for _ in range(spp):
            stats = self.render_frame()
        self._sync()
        return stats

    def benchmark(self, spp: int) -> dict:
        """Timed loop (``Application::benchmark``, Application.cpp:496-540):
        one warm-up frame, then ``spp`` timed frames from a fresh
        accumulation. The traced-ray count is read after the timer stops."""
        self.render_frame()
        self.restart_accumulation()
        self._sync()
        frame_stats = []
        t0 = time.perf_counter()
        for _ in range(spp):
            frame_stats.append(self.render_frame())
        self._sync()
        dt = time.perf_counter() - t0
        traced = sum(int(s.traced_rays) for s in frame_stats)
        return {
            "spp": spp,
            "seconds": dt,
            "ms_per_frame": 1e3 * dt / spp,
            "fps": spp / dt,
            "mrays_per_s": traced / dt / 1e6,
            "traced_rays_per_frame": traced / spp,
        }

    # -- output ------------------------------------------------------------

    def image_hdr(self) -> np.ndarray:
        """[H, W, 3] linear HDR, row 0 at the top (display orientation)."""
        img = self.image.detach().cpu().numpy().reshape(self.cfg.height, self.cfg.width, 3)
        return img[::-1]
