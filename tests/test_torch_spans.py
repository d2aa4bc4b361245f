"""The renderer's spans and counters (``nrc_tpu_torch/utils/spans.py``) on the CPU.

On the CPU a device stamp reads the host clock. The tests hold the host
spans' nesting and self times, the frames' results bit for bit with the
spans on and off, the live-lane counts against a count of each bounce's
``alive`` mask made beside the integrator, the order in which the stamps
tile a frame, the graph switches, the report's gap attribution, and that
with the spans off nothing of the recorder runs. The card's side (no stamp
in a graph with the spans off, the stamps' order on the device, the clock's
calibration) is in ``tests/test_torch_cuda.py``.
"""

import dataclasses
import time
import types

import numpy as np
import pytest
import torch

import nrc_tpu_torch.render.integrator as port_integrator
from nrc_tpu_torch.config import InputEncoding, NetworkConfig, RenderMode
from nrc_tpu_torch.models import network as N
from nrc_tpu_torch.render.renderer import Renderer
from nrc_tpu_torch.scene.scene_builder import cornell_box
from nrc_tpu_torch.utils import spans as S

RES = (48, 32)
PHASES = ("frame.primary", "frame.render_wavefront", "frame.train_wavefront", "frame.inference",
          "frame.accumulate", "frame.train")


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _renderer(spans: bool, encoding=InputEncoding.FREQUENCY, **kw) -> Renderer:
    scene, system = cornell_box(RES)
    system = dataclasses.replace(system, tile_size=(8, 8))
    return Renderer(scene, system, net_cfg=NetworkConfig(encoding=encoding), render_mode=RenderMode.FULL,
                    train=True, device="cpu", spans=spans, **kw)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _state(r: Renderer):
    return [t for _, t in sorted(N.state_to_numpy(r.net_state).items())]


# ---- host spans ---------------------------------------------------------------

def test_nested_host_spans_have_their_parents_and_self_times(monkeypatch):
    """A fake clock that steps 10 ns a read: each span's parent is the span
    open around it, its self time its duration less its direct children's."""
    ticks = iter(range(0, 10_000, 10))
    monkeypatch.setattr(S, "time", types.SimpleNamespace(perf_counter_ns=lambda: next(ticks),
                                                         get_clock_info=time.get_clock_info))
    rec = S.SpanRecorder(torch.device("cpu"), torch.zeros((), dtype=torch.int64))
    with rec.span("a", frame=7):
        with rec.span("b"):
            pass
        with rec.span("c"):
            with rec.span("d"):
                pass
    with rec.span("e", frame=8):
        pass
    got = {s.name: s for s in rec.host}
    a, b, c, d, e = (got[k] for k in "abcde")
    assert a.parent == -1 and b.parent == a.id and c.parent == a.id and d.parent == c.id and e.parent == -1
    assert [s.frame for s in (a, b, c, d, e)] == [7, 7, 7, 7, 8]
    # a: reads 0 .. 70; b 10 .. 20; c 30 .. 60; d 40 .. 50; e 80 .. 90
    assert [(s.start_ns, s.end_ns) for s in (a, b, c, d, e)] == [(0, 70), (10, 20), (30, 60), (40, 50), (80, 90)]
    assert [s.self_ns for s in (a, b, c, d, e)] == [30, 10, 20, 10, 10]
    host = rec.report()["host_spans"]
    assert host["a"] == {"count": 1, "total_ms": 70e-6, "self_ms": 30e-6, "mean_ms": 70e-6}


def test_renderer_host_spans_nest_under_render_frame():
    r = _renderer(True)
    for _ in range(3):
        r.render_frame()
    names = {s.id: s for s in r.spans.host}
    for s in r.spans.host:
        if s.name in ("renderer.camera", "renderer.bin", "renderer.eager", "renderer.stats_wait"):
            assert names[s.parent].name == "renderer.render_frame" and names[s.parent].frame == s.frame
    frames = [s.frame for s in r.spans.host if s.name == "renderer.render_frame"]
    assert frames == [0, 1, 2]
    assert [s.name for s in r.spans.host][0] == "renderer.upload_scene"


# ---- the frames' results -------------------------------------------------------

@pytest.mark.parametrize("encoding", [InputEncoding.FREQUENCY, InputEncoding.HASH], ids=["frequency", "hash"])
def test_spans_change_no_result(encoding):
    """Three FULL + train frames at 48x32 with the spans on and off: image,
    stats and the whole network state equal bit for bit."""
    sides = []
    for on in (False, True):
        r = _renderer(on, encoding)
        stats = [r.render_frame() for _ in range(3)]
        r.flush_stats()
        sides.append((r, stats))
    (a, sa), (b, sb) = sides
    assert torch.equal(_bits(a.image), _bits(b.image))
    for x, y in zip(sa, sb):
        for u, v in zip(x, y):
            assert torch.equal(_bits(u), _bits(v))
    for u, v in zip(_state(a), _state(b)):
        assert u.dtype == v.dtype and u.tobytes() == v.tobytes()
    assert list(a.loss_history) == list(b.loss_history) and a.cfg == b.cfg
    assert b.span_report()["frames"] == 3 and a.span_report() is None


# ---- the counters --------------------------------------------------------------

@pytest.mark.parametrize("fixed_depth", [False, True], ids=["early-exit", "every-bounce"])
def test_live_lanes_equal_a_count_of_each_bounces_alive_mask(monkeypatch, fixed_depth):
    """Beside the integrator, ``_all_done`` sees each bounce's ``alive``
    before the bounce (depth 0 starts with every lane alive): the live and
    run lanes the report gives per wavefront and bounce are those counts.
    The render wavefront's bounces 2.. run on its live lanes compacted into
    ``compact_capacity`` lanes where they fit, which ``_all_done`` reads
    first (a 0-d flag of an overflow): there the live lanes are the same
    and the run lanes the capacity. With ``fixed_depth`` the loop runs every
    bounce and reads nothing, as on the card, where a replay's IF node then
    takes the compacted lanes too (``tests/test_torch_cuda.py``); here the
    compaction is then off."""
    seen = {}  # (wavefront, depth) -> [live, run]
    depth = {}
    n_render, n_train = RES[0] * RES[1], (RES[0] // 8) * (RES[1] // 8)
    cap = port_integrator.compact_capacity(n_render)
    wavefront = {n_render: "render", cap: "render", n_train: "train"}

    def count(alive):
        if alive.dim() == 0:  # the compaction's read: do the live lanes fit?
            return False if fixed_depth else not bool(alive.any())
        w = wavefront[alive.numel()]
        d = depth[w] = depth.get(w, 0) + 1
        done = False if fixed_depth else not bool(alive.any())
        if not done:
            c = seen.setdefault((w, d), [0, 0])
            c[0] += int(alive.sum())
            c[1] += alive.numel()
        return done

    monkeypatch.setattr(port_integrator, "_all_done", count)
    r = _renderer(True, adaptive_tiles=False)
    lanes = {"render": r.cfg.num_pixels, "train": r.cfg.num_tiles}
    assert lanes == {"render": n_render, "train": n_train} and cap < n_render
    for _ in range(3):
        depth.clear()
        r.render_frame()
        for w in depth:  # depth 0
            c = seen.setdefault((w, 0), [0, 0])
            c[0] += lanes[w]
            c[1] += lanes[w]
    rep = r.span_report()
    got = {(w, b["bounce"]): [b["live_lanes"], b["run_lanes"]] for w in lanes for b in rep["bounces"][w]}
    assert got == seen
    assert got[("render", 1)][1] == 3 * n_render
    assert got[("render", 2)][1] == 3 * (n_render if fixed_depth else cap)
    if fixed_depth:
        assert len(got) == 2 * (r.cfg.max_depth + 1)
    live = sum(v[0] for v in seen.values())
    run = sum(v[1] for v in seen.values())
    assert rep["counters"]["live_lanes"] == live and rep["counters"]["run_lanes"] == run
    assert rep["metrics"]["integrator.live_lanes"] == 100.0 * live / run


def test_compacted_share_counts_the_render_wavefronts_run_compacted(monkeypatch):
    """``integrator.compacted_share``: of the render wavefronts, those whose
    bounces 2.. ran on the compacted lanes. Two frames fit the capacity, a
    third with the capacity cut under the live count runs every lane, and
    NO_CACHE's wavefronts are never compacted."""
    r = _renderer(True, adaptive_tiles=False)
    r.render_frame()
    r.render_frame()
    monkeypatch.setattr(port_integrator, "compact_capacity", lambda n: 8)
    r.render_frame()
    rep = r.span_report()
    assert rep["counters"]["render_wavefronts"] == 3 and rep["counters"]["compacted_wavefronts"] == 2
    assert rep["metrics"]["integrator.compacted_share"] == pytest.approx(200.0 / 3, rel=1e-12)
    render = {b["bounce"]: b["run_lanes"] for b in rep["bounces"]["render"]}
    assert render[2] == 2 * 256 + RES[0] * RES[1]
    r.spans.reset()
    assert r.span_report()["metrics"]["integrator.compacted_share"] is None
    scene, system = cornell_box(RES)
    nc = Renderer(scene, dataclasses.replace(system, tile_size=(8, 8)), render_mode=RenderMode.NO_CACHE,
                  train=False, device="cpu", spans=True)
    nc.render_frame()
    rep = nc.span_report()
    assert rep["counters"]["render_wavefronts"] == 1 and rep["metrics"]["integrator.compacted_share"] == 0.0


def test_device_spans_tile_the_frame_in_frame_step_order(monkeypatch):
    """The stamps of a FULL + train frame with every bounce run (as on the
    card) come in ``frame_step``'s order, each wavefront's bounces inside its
    phase, and the phases add up to the frame from its first stamp to its
    last."""
    monkeypatch.setattr(port_integrator, "_all_done", lambda alive: False)
    r = _renderer(True)
    for _ in range(3):
        r.render_frame()
    layout = r.spans.layout
    depths = range(r.cfg.max_depth + 1)
    names = [s.name for s in layout]
    assert names == (["frame.primary", "frame.render_wavefront"] + [f"render.bounce{d}" for d in depths]
                     + ["frame.train_wavefront"] + [f"train.bounce{d}" for d in depths]
                     + ["frame.inference", "frame.accumulate", "frame.train", "frame.end"])
    assert all(s.parent == f"frame.{s.name.split('.')[0]}_wavefront" for s in layout if s.bounce >= 0)
    ring = r.spans.ring.numpy()
    for frame in range(3):
        t = ring[frame, :len(layout)]
        assert np.all(np.diff(t) >= 0) and t[0] > 0
    rep = r.span_report()
    spans = rep["device_spans"]
    assert set(spans) == set(PHASES) | {"frame"}
    whole = sum(spans[p]["mean_ms"] for p in PHASES)
    assert whole == pytest.approx(spans["frame"]["mean_ms"], rel=1e-12)
    assert rep["frames_ms"] + rep["gaps_ms"] == pytest.approx(rep["window_ms"], rel=1e-12)
    bounce_sum = sum(b["device_ms"] for b in rep["bounces"]["render"])
    assert spans["frame.render_wavefront"]["self_ms"] == pytest.approx(
        spans["frame.render_wavefront"]["mean_ms"] - bounce_sum, abs=1e-9)


def test_a_tile_change_counts_one_graph_switch():
    r = _renderer(True, adaptive_tiles=False)
    r.render_frame()
    r.render_frame()
    r.cfg = dataclasses.replace(r.cfg, tile_size=(4, 4))
    r.render_frame()
    r.render_frame()
    r.flush_stats()
    rep = r.span_report()
    assert rep["counters"]["graph_switches"] == 1 and rep["metrics"]["renderer.graph_switches"] == 25.0
    assert rep["counters"]["frames_by_tile"] == {"8x8": 2, "4x4": 2}
    by_tile = rep["device_spans_by_tile"]
    assert {k: v["frames"] for k, v in by_tile.items()} == {"8x8": 2, "4x4": 2}
    assert set(by_tile["4x4"]) == set(PHASES) | {"frame", "frames"}
    assert (by_tile["8x8"]["frame"] + by_tile["4x4"]["frame"]) / 2 == pytest.approx(
        rep["device_spans"]["frame"]["mean_ms"], rel=1e-12)
    # a reset keeps the last key: the next frame of the same graph is no switch
    r.spans.reset()
    r.render_frame()
    assert r.span_report()["counters"]["graph_switches"] == 0


def test_records_per_frame_are_the_frames_own_counts():
    r = _renderer(True, adaptive_tiles=False)
    counts = [int(r.render_frame().num_train_records) for _ in range(4)]
    r.flush_stats()
    assert r.spans.records == counts
    rec = r.span_report()["counters"]["records_per_frame"]
    assert rec == {"frames": 4, "mean": sum(counts) / 4, "least": min(counts), "most": max(counts)}
    # a reset drops the counts still to come of the frames before it
    r.render_frame()
    r.render_frame()
    r.spans.reset()
    r.render_frame()
    r.flush_stats()
    assert len(r.spans.records) == 1


def test_gaps_are_charged_to_the_innermost_host_span():
    """A report from stamps and host spans set by hand: the gap from each
    frame's last stamp to the next frame's first goes to the innermost host
    span open at its middle, or to none."""
    rec = S.SpanRecorder(torch.device("cpu"), torch.zeros((), dtype=torch.int64))
    layout = (S.Slot("frame.primary"), S.Slot("render.bounce0", "frame.primary", 0, 0), S.Slot("frame.end"))
    rec.layout = layout
    # frames 0-2 at [100, 160, 200], [300, 330, 400], [1000, 1010, 1100] ns
    for f, row in enumerate(([100, 160, 200], [300, 330, 400], [1000, 1010, 1100])):
        rec.ring[f, :3] = torch.tensor(row)
        rec.frame_done(f, "k", (8, 8), False)
    rec.host.extend([S.HostSpan("outer", 150, 900, -1, 0, 0, 1), S.HostSpan("inner", 240, 260, 1, 0, 0, 2)])
    rep = rec.report()
    # gaps 200 -> 300 (middle 250: inner) and 400 -> 1000 (middle 700: outer)
    assert rep["gaps"]["by_host_span"] == {"outer": {"gaps": 1, "total_ms": 600e-6},
                                           "inner": {"gaps": 1, "total_ms": 100e-6}}
    assert rep["metrics"]["renderer.gap_ms"] == pytest.approx(350e-6)
    assert rep["device_spans"]["frame.primary"]["mean_ms"] == pytest.approx(100e-6)
    # the lanes are the device's counts, which no bounce of these frames added to
    assert rep["bounces"]["render"] == [{"bounce": 0, "device_ms": pytest.approx(200e-6 / 3), "live_lanes": 0,
                                         "run_lanes": 0}]
    assert rep["window_ms"] == pytest.approx(1000e-6) and rep["frames_ms"] == pytest.approx(300e-6)
    rec.host.clear()
    assert rec.report()["gaps"]["by_host_span"] == {S.NO_HOST_SPAN: {"gaps": 2, "total_ms": 700e-6}}


def test_with_the_spans_off_nothing_of_the_recorder_runs(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a recorder method ran with the spans off")

    for name in ("__init__", "reset", "span", "open_frame", "stamp", "bounce", "render_wavefront", "slots",
                 "rewind", "rejoin", "close_frame", "frame_done", "count_records", "calibrate", "report"):
        monkeypatch.setattr(S.SpanRecorder, name, refuse)
    r = _renderer(False)
    for _ in range(3):
        r.render_frame()
    r.restart_accumulation()
    r.render_frame()
    r.flush_stats()
    assert r.spans is None and r.span_report() is None
