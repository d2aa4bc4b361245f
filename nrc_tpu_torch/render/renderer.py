"""Host-side renderer: accumulation, online training and the frame loop.

Port of ``nrc_tpu/render/renderer.py:45-407`` (reference
``Application::render/benchmark`` + ``Raytracer::render``,
``Application.cpp:417-540``): uploads the scene to one device, initializes
the cache network from a seeded ``torch.Generator``, runs ``frame_step``
once per subframe, restarts accumulation on state changes, and adapts the
training tile size between frames from a two-frame-old record count, read
from a non-blocking copy so that the frame loop never waits for it.

On a CUDA device a frame is one CUDA graph replay: the counterpart of the
JAX package's ``jax.jit`` of the frame per static ``FrameConfig``
(``nrc_tpu/render/renderer.py:263-286``). The shapes of a frame depend only
on ``cfg``, so one graph per ``cfg`` serves, and at most ``MAX_GRAPHS`` are
kept. The first frame of a new ``cfg`` runs eagerly on a side stream (the
warm-up PyTorch asks for before a capture; it also builds every kernel),
and the same frame is then captured for the next ones, into a memory pool
of its own (no two graphs share one: the tile size can return to an older
graph at any frame). A graph reads and
writes fixed tensors, so the renderer keeps its state in place: the image,
the camera, the two frame counters (0-d int64 tensors, advanced by the
frame's last operation; ``iteration`` and ``total_subframe`` read a host
mirror), the learning rate, the network state (a new state is copied in)
and the traced-ray sum (``traced_rays``). A new scene drops the graphs, and
so does ``set_encoding``, whose state has other shapes and is bound anew. A capture that fails
raises; nothing falls back to eager frames. ``capture=False`` runs the same
frames eagerly on the card, to compare with.

A scene with curve segments (``Scene.curves``) uploads their BVH and
shading rows with the rest; the frame compiles the curve stream and the
hair lobe in where the device scene has them (``trace_wavefront``'s
``has_curves``, as the JAX package derives it from its device scene), so
no ``FrameConfig`` switch names them. A live material edit
(``update_material``; a hair material's row too) copies the new material and
light tables into the tensors the graphs read, and a render state
(``models/checkpoint.py::load_render_state``) is copied into the state and
image in place; where the shapes change, the graphs are dropped instead.
``screenshot`` writes a tonemapped PNG or a linear ``.hdr`` and
``save_system_description`` the system file (``utils/image_io.py``).

``device`` decides where everything runs; a CUDA device without a card
raises, and nothing falls back to the CPU.
"""

from __future__ import annotations

import dataclasses
import math
import time
from collections import OrderedDict, deque
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from ..config import (
    FrameConfig,
    InputEncoding,
    NetworkConfig,
    NRCHyperParams,
    RenderMode,
    SystemConfig,
    adjust_tile_size,
)
from ..models import network as N
from ..ops.cuda_build import CudaKernel, launch_counts
from ..scene.materials import MaterialTable
from ..scene.scene_builder import Scene
from ..utils.image_io import write_hdr, write_png
from ..utils.tonemap import tonemap_to_u8
from .frame import CameraArrays, FrameStats, frame_step
from .scene_device import DeviceScene, patch_materials, scene_flags, upload_scene

MAX_GRAPHS = 16  # as the JAX package bounds its compile cache


def frame_key(cfg: FrameConfig) -> tuple:
    """Every field of ``cfg`` as a hashable key: a change to any of them
    selects another graph, as it makes the JAX package compile again."""
    return tuple(
        tuple(sorted(v)) if isinstance(v, frozenset) else v for v in dataclasses.astuple(cfg)
    )


class FrameGraph(NamedTuple):
    """One captured frame: the graph, its output buffers, the kernel launches
    one replay makes, and the bytes its memory pool took at the capture."""

    graph: torch.cuda.CUDAGraph
    stats: FrameStats
    launches: Dict[CudaKernel, int]
    nbytes: int


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
        capture: bool = True,
        reflectance_factoring: bool = False,
    ):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Renderer(device='cuda'): no CUDA device is available")
        # frames on the card replay graphs; False runs them eagerly
        self.capture = capture
        self.graphs: "OrderedDict[tuple, FrameGraph]" = OrderedDict()
        self.scene = scene
        self.system = system
        self.net_cfg = net_cfg or NetworkConfig()
        self.hyper = NRCHyperParams(learning_rate=self.net_cfg.learning_rate)
        self.adaptive_tiles = adaptive_tiles
        self.device_scene = upload_scene(scene, self.device)

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
            reflectance_factoring=reflectance_factoring,
            # the lobe families the scene's archetypes use and the transport
            # features its materials switch on (nrc_tpu/render/renderer.py:
            # 88-120; its NRC_DIAG_OFF profiling knob, which makes results
            # wrong, is not ported)
            **scene_flags(scene),
        )
        self._net_state: Optional[N.NetworkState] = None
        self.reset_cache()
        # a device scalar: a learning-rate edit changes a value, not a kernel
        self.learning_rate = torch.tensor(
            self.hyper.learning_rate, dtype=torch.float32, device=self.device
        )
        self._image = torch.zeros((w * h, 3), dtype=torch.float32, device=self.device)
        # (iteration, total_subframe) on the device, and their host mirrors
        self._counters = torch.zeros(2, dtype=torch.int64, device=self.device)
        self._host_counters = [0, 0]
        # rays traced since the last zero_(), summed on the device by each frame
        self.traced_rays = torch.zeros((), dtype=torch.int64, device=self.device)
        self.replays = 0  # frames run as a graph replay
        self._frustum: Optional[np.ndarray] = None
        self._camera_rows = torch.zeros((4, 3), dtype=torch.float32, device=self.device)
        self._camera = CameraArrays(*self._camera_rows.unbind(0))
        self.last_stats: Optional[FrameStats] = None
        self.loss_history: deque = deque(maxlen=256)
        self._pending_stats: deque = deque()

    # -- state the graphs read, kept in place --------------------------------

    @property
    def image(self) -> torch.Tensor:
        """[H*W, 3] accumulated HDR; the frames write it in place."""
        return self._image

    @property
    def iteration(self) -> int:
        return self._host_counters[0]

    @iteration.setter
    def iteration(self, value: int) -> None:
        self._host_counters[0] = int(value)
        self._counters[0].fill_(int(value))  # a fill kernel, not a copy

    @property
    def total_subframe(self) -> int:
        return self._host_counters[1]

    @total_subframe.setter
    def total_subframe(self, value: int) -> None:
        self._host_counters[1] = int(value)
        self._counters[1].fill_(int(value))

    @property
    def net_state(self) -> N.NetworkState:
        return self._net_state

    @net_state.setter
    def net_state(self, state: N.NetworkState) -> None:
        """The first state is bound; a later one is copied into it, so the
        graphs go on reading the same tensors (one of other shapes raises:
        ``bind_state``)."""
        if self._net_state is None:
            self._net_state = state
        else:
            N.copy_state(self._net_state, state)

    def bind_state(self, state: N.NetworkState) -> None:
        """Bind a state of other shapes or encoding in place of the current
        one (``set_encoding``, a render state of another encoding): every
        graph, which reads the old state's tensors, is dropped."""
        self.graphs.clear()
        self._net_state = state

    @property
    def device_scene(self) -> DeviceScene:
        return self._device_scene

    @device_scene.setter
    def device_scene(self, scene: DeviceScene) -> None:
        self._device_scene = scene
        self.graphs.clear()  # they read the old scene's tensors

    # -- state management --------------------------------------------------

    def restart_accumulation(self) -> None:
        """Camera/material change restarts progressive accumulation."""
        self.iteration = 0
        self._image.zero_()

    def reset_cache(self, seed: int = 0) -> None:
        """Re-create the network (GUI 'reset cache' -> ``Device.cpp:2415-2421``)
        with random weights from ``seed`` (0, as the JAX renderer's default),
        drawn on the CPU and copied into the state the graphs read."""
        self.net_state = N.init_network(
            torch.Generator().manual_seed(seed), self.net_cfg, self.device
        )

    def set_encoding(self, encoding, seed: int = 0) -> None:
        """Live input-encoding switch (the reference GUI combo re-creates the
        tcnn model with the per-encoding learning rate and resets the cache,
        ``Application.cpp:671-689`` -> ``Device.cpp:2409-2421``;
        ``nrc_tpu/render/renderer.py:176-202``). ``ema_decay`` and
        ``adam_eps`` are reset so that ``NetworkConfig.__post_init__``
        resolves them for the new encoding (0.99 / 1e-15 for hash, 0.95 /
        1e-8 for frequency). The new state has other shapes, so it is bound,
        not copied, and every captured graph, which reads the old state's
        tensors, is dropped."""
        if isinstance(encoding, str):
            encoding = InputEncoding[encoding.upper()]
        if encoding == self.net_cfg.encoding:
            return
        self.net_cfg = dataclasses.replace(
            self.net_cfg, encoding=encoding, ema_decay=None, adam_eps=1e-8
        )
        self.hyper = dataclasses.replace(self.hyper, learning_rate=self.net_cfg.learning_rate)
        self.learning_rate.fill_(self.hyper.learning_rate)
        self.bind_state(N.init_network(torch.Generator().manual_seed(seed), self.net_cfg, self.device))
        self.restart_accumulation()

    def update_material(self, index: int, **changes) -> None:
        """Live material edit (``nrc_tpu/render/renderer.py:204-219``; the
        reference GUI's material editors -> ``Device::updateMaterial``,
        ``Device.cpp:1700-1722``): ``changes`` are ``Material`` field
        overrides of material ``index``. Geometry and BVH stay, and the
        texture atlas and the loaded measurements too: the table is rebuilt
        on them, so no texture is decoded and no measurement read again.
        The material, light, texture and measurement tables are re-derived;
        an edit of values (a colour, a roughness, a volume coefficient)
        copies them into the tensors the captured graphs read, and the next
        frame replays its graph. An edit that changes their shapes (a
        texture the atlas lacks, another measurement) replaces them and
        drops the graphs. The frame's switches are re-derived from the
        edited scene (``scene_flags``): an edit that turns a feature on or
        off (a volume, a layer, a measurement, noise, the archetype set, the
        textures) selects another graph, captured at the next frame, as a
        fresh renderer on the edited scene would compile the same; nothing
        raises. The accumulation restarts."""
        rows = self.scene.material_rows
        rows[index] = dataclasses.replace(rows[index], **changes)
        mt = self.scene.materials
        self.scene.materials = MaterialTable.build(rows, atlas=mt.atlas, measurements=mt.measurements)
        patched = patch_materials(self.device_scene, self.scene)
        if patched is not self.device_scene:
            self.device_scene = patched  # drops the graphs
        self.cfg = dataclasses.replace(self.cfg, **scene_flags(self.scene))
        self.restart_accumulation()

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
        """The camera's (P, U, V, W) on the device, copied there only when
        the camera has moved."""
        frustum = np.stack(self.scene.camera.frustum())
        if self._frustum is None or not np.array_equal(frustum, self._frustum):
            self._camera_rows.copy_(torch.from_numpy(frustum))
            self._frustum = frustum
        return self._camera

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- frame loop --------------------------------------------------------

    def _frame(self) -> FrameStats:
        """One frame on the renderer's state, as a graph captures it: the
        image written back in place, the traced rays summed and both
        counters advanced on the device."""
        with torch.no_grad():
            image, stats = frame_step(
                self.device_scene,
                self.net_state,
                self._image,
                self._camera,
                self._counters[0],
                self._counters[1],
                self.cfg,
                self.net_cfg,
                self.learning_rate,
            )
            self._image.copy_(image)
            self.traced_rays.add_(stats.traced_rays)
            self._counters.add_(1)
        return stats

    def _capture(self, key: tuple) -> FrameStats:
        """The frame eagerly on a side stream, then the same frame captured
        for the next frames with this ``cfg``. Returns the eager frame's
        stats."""
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            stats = self._frame()
        torch.cuda.current_stream(self.device).wait_stream(side)
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(self.device)
        before = launch_counts()
        graph = torch.cuda.CUDAGraph()
        stream = torch.cuda.current_stream(self.device)
        try:
            with torch.cuda.graph(graph):
                graph_stats = self._frame()
        except Exception as e:
            _release_failed_capture(self.device, stream)
            raise RuntimeError(f"capturing the frame of {self.cfg} failed") from e
        finally:
            # a launch under capture ran nothing: count it at each replay
            launches = {k: n - before[k] for k, n in launch_counts().items() if n != before[k]}
            for k in launches:
                k.launches = before[k]
        self._keep(key, FrameGraph(graph, graph_stats, launches,
                                   torch.cuda.memory_reserved(self.device) - reserved))
        return stats

    def _keep(self, key: tuple, entry: FrameGraph) -> None:
        """Cache a graph; beyond ``MAX_GRAPHS`` the one used longest ago goes."""
        self.graphs[key] = entry
        while len(self.graphs) > MAX_GRAPHS:
            self.graphs.popitem(last=False)

    def _replay(self) -> FrameStats:
        key = frame_key(self.cfg)
        entry = self.graphs.get(key)
        if entry is None:
            return self._capture(key)
        self.graphs.move_to_end(key)
        entry.graph.replay()
        self.replays += 1
        for k, n in entry.launches.items():
            k.launches += n
        return entry.stats

    def render_frame(self) -> FrameStats:
        """One subframe (1 spp accumulated). On the card the stats are the
        graph's own buffers, which the next frame of the same ``cfg``
        overwrites."""
        self._camera_arrays()
        if self.device.type == "cuda" and self.capture:
            stats = self._replay()
        else:
            stats = self._frame()
        self._host_counters[0] += 1
        self._host_counters[1] += 1
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
        accumulation. The frames sum their traced rays on the device; the
        sum is read after the timer stops."""
        self.render_frame()
        self.restart_accumulation()
        self.traced_rays.zero_()
        self._sync()
        t0 = time.perf_counter()
        for _ in range(spp):
            self.render_frame()
        self._sync()
        dt = time.perf_counter() - t0
        traced = int(self.traced_rays)
        return {
            "loss": float(self.last_stats.loss),
            "spp": spp,
            "seconds": dt,
            "ms_per_frame": 1e3 * dt / spp,
            "fps": spp / dt,
            "mrays_per_s": traced / dt / 1e6,
            # every path running all its segments (nrc_tpu/render/renderer.py:397-398)
            "potential_mrays_per_s": self.cfg.num_pixels * spp * (self.cfg.max_depth + 1) / dt / 1e6,
            "traced_rays_per_frame": traced / spp,
        }

    # -- output ------------------------------------------------------------

    def image_hdr(self) -> np.ndarray:
        """[H, W, 3] linear HDR, row 0 at the top (display orientation)."""
        img = self.image.detach().cpu().numpy().reshape(self.cfg.height, self.cfg.width, 3)
        return img[::-1]

    def save_system_description(self, path: str) -> str:
        """Write the current system state in the reference's system-file
        format (Key S -> ``Application::saveSystemDescription``,
        ``Application.cpp:1296-1335``; ``nrc_tpu/render/renderer.py:409-441``)."""
        s, tm, cam = self.system, self.system.tonemapper, self.scene.camera
        lines = [
            f"resolution {s.resolution[0]} {s.resolution[1]}",
            f"tileSize {s.tile_size[0]} {s.tile_size[1]}",
            f"samplesSqrt {s.samples_sqrt}",
            f"devicesMask {s.devices_mask}",
            f"arenaSize {s.arena_size_mib}",
            f"interop {s.interop}",
            f"present {s.present}",
            f"peerToPeer {s.peer_to_peer}",
            f"pathLengths {s.path_lengths[0]} {s.path_lengths[1]}",
            f"walkLength {s.walk_length}",
            f"epsilonFactor {s.epsilon_factor}",
            f"clockFactor {s.clock_factor}",
            f"lensShader {s.lens_shader}",
            "center " + " ".join(str(c) for c in cam.center),
            f"camera {cam.phi} {cam.theta} {cam.fov} {cam.distance}",
            f"prefixScreenshot \"{s.prefix_screenshot}\"",
            f"gamma {tm.gamma}",
            "colorBalance " + " ".join(str(c) for c in tm.color_balance),
            f"whitePoint {tm.white_point}",
            f"burnHighlights {tm.burn_highlights}",
            f"crushBlacks {tm.crush_blacks}",
            f"saturation {tm.saturation}",
            f"brightness {tm.brightness}",
        ]
        lines += [f"searchPath \"{p}\"" for p in s.search_paths]
        with open(path, "w") as f:
            f.write("\n".join(lines) + "\n")
        return path

    def screenshot(self, path: str, tonemap: bool = True) -> str:
        """The image as a tonemapped PNG, or with ``tonemap=False`` as a
        linear Radiance ``.hdr`` (``Application::screenshot``,
        ``Application.cpp:2562-2673``; ``nrc_tpu/render/renderer.py:444-465``).
        The time view's colours are display-ready: clamped and scaled to
        8 bits without the tone curve. The extension is appended when
        missing; returns the path written."""
        if self.cfg.render_mode == RenderMode.DEBUG_TIME_VIEW:
            ldr = (torch.clamp(torch.from_numpy(self.image_hdr().copy()), 0.0, 1.0) * 255.0).to(torch.uint8)
            path = path if path.endswith(".png") else path + ".png"
            write_png(path, ldr.numpy())
        elif tonemap:
            ldr = tonemap_to_u8(torch.from_numpy(self.image_hdr().copy()), self.system.tonemapper)
            path = path if path.endswith(".png") else path + ".png"
            write_png(path, ldr.numpy())
        else:
            path = path if path.endswith(".hdr") else path + ".hdr"
            write_hdr(path, self.image_hdr())
        return path


def _release_failed_capture(device: torch.device, stream: torch.cuda.Stream) -> None:
    """What a failed ``torch.cuda.graph`` leaves behind, put back. When the
    capture is invalidated (the frame read the device), ``capture_end``
    raises before it runs the default generator's capture epilogue and
    before the graph context puts the caller's stream back: the generator
    keeps counting its offsets for a capture that no longer exists and
    refuses every later draw ("Offset increment outside graph capture"),
    and later work would go to the capture stream. A fresh copy of the
    generator's state (its seed and offset, not capturing) and the stream
    the frame was called on undo both."""
    gen = torch.cuda.default_generators[device.index if device.index is not None else torch.cuda.current_device()]
    gen.graphsafe_set_state(gen.clone_state())
    torch.cuda.set_stream(stream)

