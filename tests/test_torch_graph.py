"""What a captured frame rests on, checked on the CPU at 32x32 with 8x8 tiles.

On the card ``Renderer`` replays one CUDA graph per ``FrameConfig``. A graph
replays the launches it recorded and nothing of the host, so the frame must
(1) take its counters as device tensors and give the same bits as with
Python ints; (2) run the bounce loop to ``max_depth`` without reading the
device, and give the same bits as the early exit; (3) make no tensor from
host data and read nothing back once it is warm. The renderer must key its
graphs on every field of ``cfg``, keep at most 16, count each kernel's
launches once per replay, and sum the traced rays of the frames it times on
the device, where every replay writes the same buffers. The graph replay
itself runs on the card only (``tests/test_torch_cuda.py``,
``chip_smoke.py``).

Every comparison here is exact: the bits of each float tensor (``-0.0`` is
not ``0.0``), and integers equal.
"""

import dataclasses
import enum

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import nrc_tpu_torch.render.integrator as port_integrator
from nrc_tpu_torch.config import FrameConfig, RenderMode
from nrc_tpu_torch.models import network as N
from nrc_tpu_torch.ops import cuda_build
from nrc_tpu_torch.render.frame import frame_step, pixel_grid, training_rays
from nrc_tpu_torch.render.renderer import MAX_GRAPHS, FrameGraph, Renderer, frame_key
from nrc_tpu_torch.scene.camera import generate_primary_rays
from nrc_tpu_torch.scene.scene_builder import cornell_box
from nrc_tpu_torch.utils import rng as R
from test_torch_intersect import one_torch_thread  # noqa: F401 (an autouse fixture)

RES = (32, 32)


def _renderer(mode=RenderMode.FULL, train=True, **kwargs) -> Renderer:
    scene, system = cornell_box(RES)
    system = dataclasses.replace(system, tile_size=(8, 8))
    return Renderer(scene, system, render_mode=mode, train=train, adaptive_tiles=False,
                    device="cpu", **kwargs)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def assert_same_bits(a, b, what):
    assert a.dtype == b.dtype and a.shape == b.shape, what
    assert torch.equal(_bits(a), _bits(b)), f"{what}: differs"


def _state_tensors(state: N.NetworkState):
    return [t for m in (state.params, state.ema, state.opt.mu, state.opt.nu) for t in m.tensors()] + [
        state.opt.step]


# ---- (a) device-tensor counters ---------------------------------------------

@pytest.mark.parametrize("mode,train", [(RenderMode.FULL, True), (RenderMode.NO_CACHE, False)],
                         ids=["FULL+train", "NO_CACHE"])
def test_device_counters_match_python_ints(mode, train):
    """Three frames from the same start, once with the counters as Python
    ints (the accumulation weight then computed on the host) and once as
    0-d int64 tensors advanced in place: image, weights, EMA, moments, step
    and stats equal bit for bit."""
    r = _renderer(mode, train)
    sides = []
    for counters_as_tensors in (False, True):
        state = N.init_network(torch.Generator().manual_seed(0), r.net_cfg, r.device)
        image = torch.zeros_like(r.image)
        counters = torch.zeros(2, dtype=torch.int64)
        stats = []
        for k in range(3):
            it, sub = (counters[0], counters[1]) if counters_as_tensors else (k, k)
            image, st = frame_step(r.device_scene, state, image, r._camera_arrays(), it, sub,
                                   r.cfg, r.net_cfg, r.learning_rate)
            counters.add_(1)
            stats.append([t.clone() for t in st])
        sides.append((image, state, stats))
    (img_i, state_i, stats_i), (img_t, state_t, stats_t) = sides
    assert_same_bits(img_t, img_i, "image")
    for k, (a, b) in enumerate(zip(_state_tensors(state_t), _state_tensors(state_i))):
        assert_same_bits(a, b, f"state tensor {k}")
    for f, (a, b) in enumerate(zip(stats_t, stats_i)):
        for name, x, y in zip(("loss", "num_train_records", "traced_rays"), a, b):
            assert_same_bits(x, y, f"frame {f} {name}")
    if train:
        assert int(state_t.opt.step) == 12 and int(stats_t[-1][1]) > 0
    assert img_t.std() > 0.0


def test_renderer_counters_read_and_write_as_ints():
    r = _renderer(RenderMode.NO_CACHE, train=False)
    r.render(2)
    assert (r.iteration, r.total_subframe) == (2, 2)
    assert r._counters.tolist() == [2, 2]
    r.total_subframe = 7
    r.restart_accumulation()
    assert (r.iteration, r.total_subframe) == (0, 7) and r._counters.tolist() == [0, 7]
    r.render_frame()
    assert (r.iteration, r.total_subframe) == (1, 8) and r._counters.tolist() == [1, 8]


# ---- (b) the fixed-depth bounce loop ------------------------------------------

def _wavefront_inputs(r: Renderer, train: bool, subframe: int):
    cam = r._camera_arrays()
    if train:
        org, d, seeds, unbiased = training_rays(r.cfg, subframe, cam, 0.5, r.device)
        return org, d, seeds, unbiased
    pix, pidx = pixel_grid(r.cfg, r.device)
    seeds, jitter = R.rng2(R.tea(pidx, subframe))
    org, d = generate_primary_rays(pix, jitter, (r.cfg.width, r.cfg.height), *cam)
    return org, d, seeds, None


@pytest.mark.parametrize("train", [False, True], ids=["render", "training"])
def test_fixed_depth_loop_matches_early_exit(monkeypatch, train):
    """The card's loop (all max_depth bounces, no read) against the CPU's
    early exit, on frames where the early exit fires: every output of the
    wavefront equal bit for bit."""
    r = _renderer(RenderMode.FULL, train=True)
    cfg = dataclasses.replace(r.cfg, max_depth=12)
    early_exit = port_integrator._all_done
    fired = []

    def recording(alive):
        done = early_exit(alive)
        fired.append(done)
        return done

    for subframe in range(3):
        org, d, seeds, unbiased = _wavefront_inputs(r, train, subframe)
        fired.clear()
        monkeypatch.setattr(port_integrator, "_all_done", recording)
        ref = port_integrator.trace_wavefront(r.device_scene, org, d, seeds, cfg, train=train,
                                              unbiased=unbiased)
        assert fired and fired[-1], f"subframe {subframe}: the early exit did not fire"
        assert len(fired) < cfg.max_depth
        monkeypatch.setattr(port_integrator, "_all_done", lambda alive: False)
        got = port_integrator.trace_wavefront(r.device_scene, org, d, seeds, cfg, train=train,
                                              unbiased=unbiased)
        for name, a, b in zip(got._fields, got, ref):
            assert (a is None) == (b is None), name
            if a is not None:
                assert_same_bits(a, b, f"subframe {subframe} {name}")


# ---- (c) nothing made from host data, nothing read back ----------------------

# an op that makes a tensor of host data (a copy to the device on the card),
# or that reads a value back (a synchronisation there)
HOST_OPS = ("aten.lift_fresh", "aten.lift_fresh_copy", "aten._local_scalar_dense",
            "aten.nonzero", "aten.masked_select", "aten._unique2", "aten.unique_consecutive",
            "aten.repeat_interleave.Tensor")


class _HostOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.seen = []
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops += 1
        name = str(func)
        if any(name == h or name.startswith(h + ".") for h in HOST_OPS):
            self.seen.append(name)
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("mode,train", [(RenderMode.FULL, True), (RenderMode.NO_CACHE, False)],
                         ids=["FULL+train", "NO_CACHE"])
def test_warm_frame_makes_no_host_tensor_and_reads_nothing(monkeypatch, mode, train):
    """The frame as the graph captures it (``Renderer._frame``, the card's
    bounce loop), after one warm-up frame."""
    monkeypatch.setattr(port_integrator, "_all_done", lambda alive: False)
    r = _renderer(mode, train)
    r._frame()
    with _HostOps() as rec:
        r._frame()
    assert rec.ops > 1000 and rec.seen == [], f"host data or reads in a warm frame: {rec.seen}"


def test_camera_is_copied_only_when_it_moves():
    r = _renderer(RenderMode.NO_CACHE, train=False)
    cam = r._camera_arrays()
    with _HostOps() as rec:
        assert r._camera_arrays() is cam
    assert rec.seen == []
    before = cam.p.clone()
    r.scene.camera.phi += 0.05
    with _HostOps() as rec:
        moved = r._camera_arrays()
    assert rec.seen == ["aten.lift_fresh.default"] and moved is cam
    assert not torch.equal(before, cam.p)


# ---- (d) the graph cache -----------------------------------------------------

def _other_value(value):
    if isinstance(value, bool):
        return not value
    if isinstance(value, enum.Enum):
        return next(m for m in type(value) if m != value)
    if isinstance(value, int):
        return value + 1
    if isinstance(value, float):
        return value * 2.0 + 1.0
    if isinstance(value, tuple):
        return tuple(2 * v for v in value)
    if value is None:
        return frozenset({1, 2})
    raise TypeError(f"no other value for {value!r}")


def test_graph_key_changes_with_every_field():
    cfg = FrameConfig()
    key = frame_key(cfg)
    hash(key)
    assert frame_key(dataclasses.replace(cfg)) == key
    for field in dataclasses.fields(FrameConfig):
        other = dataclasses.replace(cfg, **{field.name: _other_value(getattr(cfg, field.name))})
        assert frame_key(other) != key, field.name
    # a frozenset is keyed by its members, not by its order
    a = dataclasses.replace(cfg, archetype_set=frozenset({3, 1, 2}))
    assert frame_key(a) == frame_key(dataclasses.replace(cfg, archetype_set=frozenset({1, 2, 3})))
    # a learning-rate edit leaves cfg, and so the graph, as it was
    r = _renderer()
    before = frame_key(r.cfg)
    r.set_hyper_params(learning_rate=1e-3)
    assert frame_key(r.cfg) == before and float(r.learning_rate) == pytest.approx(1e-3)
    r.set_hyper_params(train_unbiased_ratio=0.25)
    assert frame_key(r.cfg) != before


class _FakeGraph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def test_graph_cache_holds_at_most_16_and_counts_launches_per_replay(monkeypatch):
    """``_replay`` with graphs standing in for captured ones: a hit replays
    and adds the launches recorded at the capture; a miss captures; the
    cache keeps the 16 used last."""
    r = _renderer()
    kernel = cuda_build.KERNELS[0]
    captured = []

    def fake_capture(key):
        captured.append(key)
        r._keep(key, FrameGraph(_FakeGraph(), r.last_stats, {kernel: 3}, 0))

    monkeypatch.setattr(r, "_capture", fake_capture)
    first = r.cfg
    sizes = [(2 ** (1 + i % 6), 2 ** (1 + i // 6)) for i in range(20)]
    for ts in sizes:
        r.cfg = dataclasses.replace(first, tile_size=ts)
        r._replay()
    assert len(captured) == 20 and len(r.graphs) == MAX_GRAPHS == 16
    assert list(r.graphs) == [frame_key(dataclasses.replace(first, tile_size=ts)) for ts in sizes[-16:]]
    r.cfg = dataclasses.replace(first, tile_size=sizes[-16])
    launches = kernel.launches
    r._replay()
    r._replay()
    entry = r.graphs[frame_key(r.cfg)]
    assert entry.graph.replays == 2 and r.replays == 2 and kernel.launches == launches + 6
    assert len(captured) == 20
    assert list(r.graphs)[-1] == frame_key(r.cfg)  # used last, evicted last


# ---- (e) the traced rays of a timed run --------------------------------------

def test_benchmark_sums_each_frames_traced_rays():
    """``benchmark`` sums the frames' counts on the device: the same as
    reading each frame's count on its own."""
    a, b = _renderer(), _renderer()
    res = a.benchmark(3)
    b.render_frame()
    b.restart_accumulation()
    counts = [int(b.render_frame().traced_rays) for _ in range(3)]
    assert res["traced_rays_per_frame"] * 3 == sum(counts) and len(set(counts)) > 1
    assert res["mrays_per_s"] == sum(counts) / res["seconds"] / 1e6 > 0.0
    assert torch.equal(a.image, b.image)


def test_new_state_is_copied_into_the_tensors_the_frame_reads():
    r = _renderer()
    held = _state_tensors(r.net_state)
    other = N.init_network(torch.Generator().manual_seed(5), r.net_cfg, r.device)
    r.net_state = other
    assert all(a is b for a, b in zip(_state_tensors(r.net_state), held))
    assert all(torch.equal(a, b) for a, b in zip(held, _state_tensors(other)))
    r.render_frame()
    r.reset_cache()  # seed 0 again, into the same tensors
    fresh = N.init_network(torch.Generator().manual_seed(0), r.net_cfg, r.device)
    assert all(a is b for a, b in zip(_state_tensors(r.net_state), held))
    assert all(torch.equal(a, b) for a, b in zip(held, _state_tensors(fresh)))
    image = r.image
    r.restart_accumulation()
    assert r.image is image and not bool(image.any())


@pytest.mark.parametrize("lines,expected", [
    (["1980, 2619, 178.10, 0x0000000000000000", "1755, 2619, 190.50, 0x0000000000000004",
      "1980, 2619, 176.00, 0x0000000000000000"],
     {"sm_mhz": [1755.0, 1980.0, 1980.0], "mem_mhz": [2619.0, 2619.0, 2619.0], "power_w": 178.1,
      "clock_event_reasons": ["0x0000000000000000", "0x0000000000000004"], "samples": 3}),
    (['Field "clocks_throttle_reasons.active" is not a valid field to query.'], {}),
    ([], {}),
])
def test_bench_reads_the_card_clocks_sampled_beside_a_rep(lines, expected):
    """The port bench's clock samples (``nvidia-smi``'s csv lines, one per
    100 ms) -> each clock's least, median and largest value, the median
    power and the event reasons seen; a sampler that printed no sample (a
    field this nvidia-smi does not know) gives an empty record, not an error."""
    import subprocess
    import sys

    from nrc_tpu_torch.tools.bench import read_clocks

    printer = subprocess.Popen([sys.executable, "-c", "import sys; print(sys.argv[1], end='')", "\n".join(lines)],
                               stdout=subprocess.PIPE, text=True)
    printer.wait(timeout=60)
    assert read_clocks(printer) == expected


def test_profile_names_each_sync_and_copy_by_call_site():
    """``profile_frame.call_sites`` on a trace of known shape: each runtime
    call goes under the innermost function of the port around it and the
    call it made there; one on a thread without a stack is counted apart."""
    from nrc_tpu_torch.tools.profile_frame import call_sites

    def py(name, ts, dur):
        return {"ph": "X", "cat": "python_function", "name": name, "ts": ts, "dur": dur, "tid": 1}

    def rt(name, ts, tid=1):
        return {"ph": "X", "cat": "cuda_runtime", "name": name, "ts": ts, "dur": 1, "tid": tid,
                "args": {"correlation": ts}}

    events = [
        py("chip_smoke.py(700): main", 0, 1000),
        py("nrc_tpu_torch/render/frame.py(150): frame_step", 10, 500),
        py("nrc_tpu_torch/ops/encodings.py(28): triangle_wave", 20, 50),
        py("<built-in method tensor of type object at 0x7f>", 22, 20),
        py("torch/_tensor.py(40): wrapped", 24, 10),
        rt("cudaMemcpyAsync", 26), rt("cudaStreamSynchronize", 28),
        py("nrc_tpu_torch/render/integrator.py(180): trace_wavefront", 100, 300),
        py("<built-in method __bool__ of Tensor object at 0x7f>", 150, 10),
        rt("cudaMemcpyAsync", 152), rt("cudaStreamSynchronize", 155),
        rt("cudaLaunchKernel", 300), rt("cudaDeviceSynchronize", 900),
        rt("cudaMemcpyAsync", 5, tid=2),
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH (Device -> Pinned)", "ts": 30, "dur": 1,
         "tid": 7, "args": {"correlation": 152}},
    ]
    sites = call_sites(events, frames=2)
    assert sites == {
        "encodings.py:triangle_wave -> tensor [cudaMemcpyAsync]": 0.5,
        "encodings.py:triangle_wave -> tensor [cudaStreamSynchronize]": 0.5,
        "integrator.py:trace_wavefront -> __bool__ [cudaMemcpyAsync, Memcpy DtoH]": 0.5,
        "integrator.py:trace_wavefront -> __bool__ [cudaStreamSynchronize]": 0.5,
        "chip_smoke.py:main [cudaDeviceSynchronize]": 0.5,
        "no Python stack on its thread": 0.5,
    }


def test_profile_sums_the_kernels_launched_inside_a_range():
    """``profile_frame.range_device_ms`` on a trace of known shape: the
    kernels whose launches fall inside the named ranges on the range's
    thread count, once per frame; other launches and threads do not."""
    from nrc_tpu_torch.tools.profile_frame import range_device_ms

    def rng(ts, dur, tid=1, name="hash table Adam + EMA"):
        return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": dur, "tid": tid}

    def launch(ts, corr, tid=1):
        return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts, "dur": 1, "tid": tid,
                "args": {"correlation": corr}}

    def kernel(corr, dur):
        return {"ph": "X", "cat": "kernel", "name": "elementwise", "ts": 1000 + corr, "dur": dur, "tid": 7,
                "args": {"correlation": corr}}

    events = [rng(10, 20), rng(100, 20), rng(200, 50, name="other"),
              launch(12, 1), launch(25, 2), launch(40, 3), launch(105, 4), launch(110, 5, tid=2),
              launch(210, 6), kernel(1, 30), kernel(2, 50), kernel(3, 70), kernel(4, 20), kernel(5, 90),
              kernel(6, 40)]
    assert range_device_ms(events, "hash table Adam + EMA", frames=2) == (30 + 50 + 20) / 2 / 1e3
    assert range_device_ms(events, "missing", frames=2) == 0.0
