"""The benchmark of the PyTorch and CUDA port (``nrc_tpu_torch``).

Run from the root of a checkout on a machine with a CUDA card:

    python3 -m nrc_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell (``BENCHMARK.json``'s ``workloads``) is a configuration
(``configs/<name>.json``: the scene, the resolution, the starting tile
size and the network) under a traffic mix (``traffic/<name>.json``). A
run makes the scene's arrays (``scenes/``), the program's renderer and its
network from ``--seed`` on the card, warms up the graphs the mix needs,
then renders FULL + train frames for ``--seconds`` and the few the check
keeps, dispatched as the renderer allows (it keeps the host at most two frames ahead), with a CUDA
event recorded after each frame and read after the window. Then, with
``--trace 1``, a few more frames under the profiler. Then the window's last
frame is checked against the plain reference (``check.py``). The last line
of standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer ones, each read by ``metrics/<name>.py``),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``: each
compared number beside its limit, which also close standard error.

The run exits with 3 and prints no result when no card is there, with 4
when a module of JAX or of the JAX package is loaded at the end.
"""

from __future__ import annotations

import os
import time


def _process_age_s() -> float:
    """Seconds since this process started (Linux; 0 where /proc is not)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(uptime - start_ticks / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return 0.0


_T0 = time.perf_counter() - _process_age_s()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from typing import List, Optional  # noqa: E402

import torch  # noqa: E402

from . import check, registry, scenes  # noqa: E402
from .trace import Trace, capture  # noqa: E402
from .traffic import Traffic  # noqa: E402

_T_IMPORTED = time.perf_counter()

TRACE_FRAMES = 6
FORBIDDEN = ("jax", "jaxlib", "flax", "nrc_tpu")
CLOCK_FIELDS = ("clocks.sm", "clocks.mem", "power.draw", "clocks_throttle_reasons.active")


def forbidden_modules() -> List[str]:
    """Loaded modules whose whole top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


class Clock:
    """Timestamps of the device's stream (CUDA events), or of the host on
    the CPU, where every operation has ended when it returns."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.device = device

    def record(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def ms(self, a, b) -> float:
        return a.elapsed_time(b) if self.cuda else 1e3 * (b - a)

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize(self.device)


class Run:
    """What a run measured, for the metric readers (``metrics/*.py``)."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    @property
    def frame_ms(self) -> float:
        return self.window_ms / self.frames


def _smi(query: str) -> str:
    try:
        return subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader", "-i", "0"],
                              capture_output=True, text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return ""


def clock_sampler() -> Optional[subprocess.Popen]:
    """``nvidia-smi`` sampling ``CLOCK_FIELDS`` of card 0 every 100 ms (a
    copy of ``nrc_tpu_torch/tools/bench.py::clock_sampler``)."""
    try:
        return subprocess.Popen(
            ["nvidia-smi", f"--query-gpu={','.join(CLOCK_FIELDS)}", "--format=csv,noheader,nounits", "-i", "0",
             "-lms", "100"], stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    except OSError:
        return None


def read_clocks(proc: Optional[subprocess.Popen]) -> dict:
    """Stop the sampler: SM and memory clocks [least, median, largest] in
    MHz, the median power in W and the clock event reasons seen."""
    if proc is None:
        return {}
    proc.terminate()
    out, _ = proc.communicate(timeout=60)
    rows = []
    for line in out.splitlines():
        parts = [v.strip() for v in line.split(",")]
        try:
            rows.append((float(parts[0]), float(parts[1]), float(parts[2]), parts[3]))
        except (ValueError, IndexError):
            continue
    if not rows:
        return {}

    def spread(k):
        v = sorted(r[k] for r in rows)
        return [v[0], v[len(v) // 2], v[-1]]

    return {"sm_mhz": spread(0), "mem_mhz": spread(1), "power_w": spread(2)[1],
            "clock_event_reasons": sorted({r[3] for r in rows}), "samples": len(rows)}


class Phases:
    """The seconds each part of set-up takes, the device drained at each
    mark, for the run's log (set-up itself is timed from process start)."""

    def __init__(self, clock: Clock):
        self.clock = clock
        self.t = time.perf_counter()
        # the interpreter and the imports, then the card's first use
        self.parts = [("imports", _T_IMPORTED - _T0), ("card", self.t - _T_IMPORTED)]

    def mark(self, name: str) -> None:
        self.clock.sync()
        now = time.perf_counter()
        self.parts.append((name, now - self.t))
        self.t = now

    def line(self) -> str:
        return "set-up: " + ", ".join(f"{n} {s:.3f}" for n, s in self.parts) + " s"


def warm_tiles(r, mix: Traffic, tiles, tile_size, mark=lambda name: None) -> None:
    """Two frames of the mix at each training tile side in ``tiles`` (the
    run's first frame bins and rasters whatever the mix, the second is the
    mix's own), so that each frame graph the tuner can select is captured
    in set-up; then ``tile_size`` again."""
    for t in tiles:
        for _ in range(2):
            r.cfg = dataclasses.replace(r.cfg, tile_size=(t, t))
            mix.before_frame(r)
            r.render_frame()
        mark(f"tile {t}")
    r.cfg = dataclasses.replace(r.cfg, tile_size=tuple(tile_size))


def run_cell(bench: dict, cell: dict, seed: int, seconds: float, trace: bool, device: torch.device,
             config: Optional[dict] = None, limits: Optional[dict] = None, tiles=None, log=print) -> dict:
    """One run of ``cell``; returns the result line's object. ``config``,
    ``limits`` and ``tiles`` (the tile sides warmed; by default every side
    the program's tuner can choose) replace the cell's own (the CPU tests'
    small sizes)."""
    clock = Clock(device)
    phases = Phases(clock)
    from . import system

    config = config or registry.config(cell["config"])
    limits = limits or registry.limits(cell["name"])
    mix = Traffic.from_params(registry.traffic(cell["traffic"]))
    data = scenes.build(config["scene"], tuple(config["resolution"]))
    data.system["tile_size"] = tuple(config["tile_size"])
    held = system.training_constants()
    if held != config["training"]:
        raise ValueError(f"the program trains on {held}, the configuration states {config['training']}")
    phases.mark("scene")

    r = system.make_renderer(data, config["network"], device, seed)
    init = check.state_dict(r.net_state)
    r.total_subframe = seed & 0xFFFFFFFF
    mix.start(r.scene.camera, seed)
    phases.mark("renderer")
    warm_tiles(r, mix, system.tuner_tiles() if tiles is None else tiles, config["tile_size"], phases.mark)
    for _ in range(mix.warmup_frames):
        mix.before_frame(r)
        r.render_frame()
    pixels = torch.arange(r.cfg.num_pixels, device=device)
    phases.mark("warm-up")
    r.traced_rays.zero_()
    replays0 = r.replays
    setup_s = time.perf_counter() - _T0
    log(phases.line(), file=sys.stderr)

    # ---- the window ----------------------------------------------------
    sampler = clock_sampler() if device.type == "cuda" else None
    host_ms, ends, tiles_seen, queries = [], [], set(), []
    start = clock.record()
    deadline = time.perf_counter() + seconds
    kept = []  # (Before, After) of the window's last frames
    while len(kept) < check.CHECKED:
        last = time.perf_counter() >= deadline
        mix.before_frame(r)
        if last:
            b = check.before(r, pixels)
        tiles_seen.add(tuple(r.cfg.tile_size))
        queries.append(r.cfg.num_pixels + r.cfg.num_tiles)  # the tile this frame renders with
        t = time.perf_counter()
        stats = r.render_frame()
        host_ms.append(1e3 * (time.perf_counter() - t))
        ends.append(clock.record())
        if last:
            kept.append((b, check.after(r, pixels, stats)))
    clock.sync()
    clocks = read_clocks(sampler)
    frames = len(ends)
    window_ms = clock.ms(start, ends[-1])
    intervals = [clock.ms(start, ends[0])] + [clock.ms(p, q) for p, q in zip(ends, ends[1:])]
    traced_rays = int(r.traced_rays)
    captures = frames - (r.replays - replays0)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    q = sorted(intervals)
    log(f"window: {frames} frames in {window_ms:.3f} device ms, {window_ms / frames:.4f} ms a frame; frame "
        f"intervals least {q[0]:.3f}, median {q[len(q) // 2]:.3f}, largest {q[-1]:.3f} ms; tiles "
        f"{sorted(tiles_seen)}, {captures} captures; host {sum(host_ms) / frames:.3f} ms a frame; "
        f"clocks {clocks}", file=sys.stderr)

    tr: Optional[Trace] = None
    traced_queries = []
    if trace:
        def frames_under_trace():
            for _ in range(TRACE_FRAMES):
                mix.before_frame(r)
                traced_queries.append(r.cfg.num_pixels + r.cfg.num_tiles)
                r.render_frame()
        tr = capture(frames_under_trace, TRACE_FRAMES, clock.sync)
    r.flush_stats()
    del r, stats
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # ---- the check -------------------------------------------------------
    numbers = {"init_max_abs": check.init_max_abs(init, check.reference_init(config["network"], seed, device))}
    k, judged, _, _ = check.judge(data, config["network"], kept, pixels, device)
    numbers.update(judged)
    log(f"judged the window's frame {k - len(kept)} from its end: {judged['records']} training records, "
        f"the reference {judged['records_reference']}", file=sys.stderr)
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    run = Run(frames=frames, window_ms=window_ms, intervals_ms=intervals, setup_s=setup_s, host_ms=host_ms,
              captures=captures, traced_rays=traced_rays, trace=tr, queries=queries,
              traced_queries=traced_queries, batch=config["training"]["batch_size"],
              batches=config["training"]["batches"], network=config["network"])
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in registry.metrics_of(bench, cell["name"], kind):
        value = registry.metric_reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    p95_beyond = frames - int(0.95 * frames)
    log(f"frame_ms_p95: the 95th percentile of {frames} frame intervals ({p95_beyond} beyond it)", file=sys.stderr)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu", "kind": name, "count": 1,
           "memory_peak_bytes": peak}
    out = {"correct": correct, "attempted": frames, "failed": 0 if correct else 1, "metrics": metrics, "device": dev}
    if tr is not None:
        busy = tr.busy_us()
        dev.update(busy_s=busy / 1e6, window_s=tr.wall_us / 1e6)
        out["breakdown"] = {"device_ops": tr.top_ops(), "idle_gaps": tr.idle_gaps()}
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="the benchmark of the PyTorch and CUDA port")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = registry.benchmark()
    cell = registry.workload(bench, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"nrc_bench: the cell needs {cell['chips']} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    out = run_cell(bench, cell, args.seed, args.seconds, bool(args.trace), device)
    print(f"card: {_smi('name,power.limit')}", file=sys.stderr)
    found = forbidden_modules()
    if found:
        print(f"nrc_bench: modules of JAX or the JAX package are loaded: {found}", file=sys.stderr)
        return 4
    for k, c in out["checks"].items():
        print(f"check {k}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
