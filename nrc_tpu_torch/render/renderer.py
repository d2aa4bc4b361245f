"""Host-side renderer: accumulation, online training and the frame loop.

Port of ``nrc_tpu/render/renderer.py:45-407`` (reference
``Application::render/benchmark`` + ``Raytracer::render``,
``Application.cpp:417-540``): uploads the scene to one device, initializes
the cache network from a seeded ``torch.Generator``, runs ``frame_step``
once per subframe, restarts accumulation on state changes, and adapts the
training tile size between frames from a two-frame-old record count, read
from a non-blocking copy so that the frame loop never waits for it.

``device`` decides where everything runs; a CUDA device without a card
raises, and nothing falls back to the CPU.
"""

from __future__ import annotations

import dataclasses
import math
import time
from collections import deque
from typing import Optional

import numpy as np
import torch

from ..config import (
    FrameConfig,
    NetworkConfig,
    NRCHyperParams,
    RenderMode,
    SystemConfig,
    adjust_tile_size,
)
from ..models import network as N
from ..scene.scene_builder import Scene
from .frame import CameraArrays, FrameStats, frame_step
from .scene_device import DeviceScene, upload_scene


class Renderer:
    """Single-device renderer: render, cache inference and online training."""

    def __init__(
        self,
        scene: Scene,
        system: SystemConfig,
        net_cfg: Optional[NetworkConfig] = None,
        render_mode: RenderMode = RenderMode.FULL,
        train: bool = True,
        adaptive_tiles: bool = True,
        device=torch.device("cuda"),
    ):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Renderer(device='cuda'): no CUDA device is available")
        self.scene = scene
        self.system = system
        self.net_cfg = net_cfg or NetworkConfig()
        self.hyper = NRCHyperParams(learning_rate=self.net_cfg.learning_rate)
        self.adaptive_tiles = adaptive_tiles
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
            train=train,
            lens_shader=scene.lens_shader,
            scene_epsilon=system.scene_epsilon,
            walk_length=system.walk_length,
            position_scale=0.1 / max(extent, 1e-6),
        )
        self.reset_cache()
        # a device scalar: a learning-rate edit changes a value, not a kernel
        self.learning_rate = torch.tensor(
            self.hyper.learning_rate, dtype=torch.float32, device=self.device
        )
        self.image = torch.zeros((w * h, 3), dtype=torch.float32, device=self.device)
        self.iteration = 0
        self.total_subframe = 0
        self.last_stats: Optional[FrameStats] = None
        self.loss_history: deque = deque(maxlen=256)
        self._pending_stats: deque = deque()

    # -- state management --------------------------------------------------

    def restart_accumulation(self) -> None:
        """Camera/material change restarts progressive accumulation."""
        self.iteration = 0
        self.image = torch.zeros_like(self.image)

    def reset_cache(self) -> None:
        """Re-create the network (GUI 'reset cache' -> ``Device.cpp:2415-2421``)
        with random weights from seed 0, as the JAX renderer's default, drawn
        on the CPU."""
        self.net_state = N.init_network(
            torch.Generator().manual_seed(0), self.net_cfg, self.device
        )

    def set_render_mode(self, mode: RenderMode) -> None:
        self.cfg = dataclasses.replace(self.cfg, render_mode=mode)
        self.restart_accumulation()

    def set_hyper_params(
        self,
        learning_rate: Optional[float] = None,
        train_unbiased_ratio: Optional[float] = None,
        area_spread_factor: Optional[float] = None,
    ) -> None:
        """Live NRC hyper-parameter updates (the reference's Stats-window
        sliders -> ``DeviceState`` dirty diff, ``Device.cpp:1724-1842``)."""
        h = self.hyper
        if learning_rate is not None:
            h = dataclasses.replace(h, learning_rate=learning_rate)
            self.learning_rate.fill_(learning_rate)
        if train_unbiased_ratio is not None:
            h = dataclasses.replace(h, train_unbiased_ratio=train_unbiased_ratio)
        if area_spread_factor is not None:
            h = dataclasses.replace(h, area_spread_factor=area_spread_factor)
        self.hyper = h
        self.cfg = dataclasses.replace(
            self.cfg,
            area_spread_sqrt=math.sqrt(h.area_spread_factor),
            train_unbiased_ratio=h.train_unbiased_ratio,
        )

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
            self.learning_rate,
        )
        self.iteration += 1
        self.total_subframe += 1
        self.last_stats = stats
        if self.cfg.train:
            # start the copy of loss and record count now and read it two
            # frames later, when it has landed (the reference reads
            # numTrainingRecords synchronously mid-frame, Device.cpp:2487-2491)
            self._pending_stats.append(self._start_readback(stats))
            if len(self._pending_stats) > 2:
                self._consume_stats(self._pending_stats.popleft())
        return stats

    def _start_readback(self, stats: FrameStats):
        if self.device.type != "cuda":
            return stats.loss, stats.num_train_records, None
        host = [torch.empty((), dtype=t.dtype, pin_memory=True)
                for t in (stats.loss, stats.num_train_records)]
        for h, t in zip(host, (stats.loss, stats.num_train_records)):
            h.copy_(t, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host[0], host[1], done

    def _consume_stats(self, pending) -> None:
        loss, count, done = pending
        if done is not None:
            done.synchronize()
        # the stats window's loss ring buffer (256-frame plot,
        # Application.cpp:1020-1048)
        self.loss_history.append(float(loss))
        if self.adaptive_tiles:
            # Device::adjustTileSize (Device.cpp:818-828), two frames late
            new_ts = adjust_tile_size(self.cfg.tile_size, int(count))
            if new_ts != self.cfg.tile_size:
                self.cfg = dataclasses.replace(self.cfg, tile_size=new_ts)

    def flush_stats(self) -> None:
        """Drain the deferred per-frame stats (before reading
        ``loss_history`` at the end of a run)."""
        while self._pending_stats:
            self._consume_stats(self._pending_stats.popleft())

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
            "loss": float(frame_stats[-1].loss),
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
