"""Spans and counters inside the port, kept in memory and read out once.

``Renderer(..., spans=True)`` holds one ``SpanRecorder``; with ``spans=False``
(the default) the renderer holds ``None``, every call site tests for it and
calls nothing here, and no stamp is captured into a graph. The recorder has
three parts.

- Host spans (``SpanRecorder.span``): name, start and end
  (``time.perf_counter_ns``), the enclosing span and the frame, which is the
  renderer's ``total_subframe`` when ``render_frame`` began (every span of one
  frame shares it). Each also opens ``torch.profiler.record_function`` under
  its name, so a profiler trace shows it on the trace's own clock. The
  port's bare profiler ranges live here too (``profiler_range``,
  ``TABLE_UPDATE_RANGE``).
- Device stamps (``stamp``, ``bounce``): one-thread kernels
  (``csrc/stamp.cu``) that write the card's ``%globaltimer`` into
  ``ring[frame % RING_FRAMES, slot]``, the frame read on the device from the
  renderer's frame counter, so each replay of a graph writes its own row.
  Slots are numbered in call order while a frame runs or is captured; their
  names (the frame's layout) are kept with the graph. A top-level stamp
  opens a phase of ``frame_step`` that lasts to the next top-level stamp
  (the last, ``frame.end``, opens none); a bounce stamp opens a bounce of a
  wavefront, a child of the phase, that lasts to the next stamp of any kind.
  So the phases tile the frame from its first stamp to its last. On the CPU
  a stamp reads the host clock: every operation has ended when it returns.
  A stamp is also a kernel in a profiler trace (``stamp_kernel``).
- Counters: on the device, summed in place like ``Renderer.traced_rays``,
  the lanes alive at the start of each bounce of each wavefront, the lanes
  each bounce runs (every lane, or the compacted lanes of the render
  wavefront's bounces 2.., ``render/integrator.py``), and the render
  wavefronts and those of them that ran compacted; on the host, graph
  switches (frames whose graph key differs from the frame before's),
  frames at each training tile side, and the records of each frame, from
  the stats the renderer reads two frames late anyway.

Where a frame branches on the device (the compacted or the full-width
bounces), each body of a captured frame stamps the same slots (``slots``,
``rewind``, ``rejoin``): a replay runs one of them. An eager frame runs one
body, which it reads the flag to choose.

``report`` calibrates ``%globaltimer`` against ``perf_counter_ns`` (a stamp
between two host reads around synchronizes, the tightest of several tries;
once at ``reset`` and once at the report, mapped linearly between them), so
device stamps and host spans sit on one timeline. It covers the frames since
``reset``, at most the last ``RING_FRAMES``.
"""

from __future__ import annotations

import contextlib
import ctypes
import math
import statistics
import time
from bisect import bisect_right
from collections import Counter, deque
from typing import Deque, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..ops.cuda_build import CudaKernel, current_stream, ptr

TABLE_UPDATE_RANGE = "hash table Adam + EMA"
RING_FRAMES = 4096   # frames the ring holds: more than a 45-s window renders
MAX_BOUNCES = 64
MAX_SLOTS = 160      # stamps a frame: the phases and both wavefronts' bounces
HOST_SPANS = 16 * RING_FRAMES
WAVEFRONTS = ("render", "train")
NO_HOST_SPAN = "(no host span)"
CALIBRATION_TRIES = 16
TIMER_READS = 200_000

_P, _I = ctypes.c_void_p, ctypes.c_int
STAMP_KERNEL = CudaKernel("stamp.cu", "nrc_stamp", [_P, _P, _I, _I, _I, _P])
TICKS_KERNEL = CudaKernel("stamp.cu", "nrc_timer_ticks", [_P, _I, _P])


def profiler_range(name: str):
    """The port's ``torch.profiler`` range of ``name`` around a block: a host
    span's, or a bare range that names the device time of an eager frame's
    launches (a graph replay hides it)."""
    return torch.profiler.record_function(name)


def span(rec: Optional["SpanRecorder"], name: str, frame: Optional[int] = None):
    """``rec.span(name, frame)``, or nothing where the spans are off."""
    return contextlib.nullcontext() if rec is None else rec.span(name, frame)


class Slot(NamedTuple):
    """One stamp of a frame's layout: its name, the phase it belongs to
    (None for a phase), and for a bounce its wavefront and depth."""

    name: str
    parent: Optional[str] = None
    wavefront: int = -1
    bounce: int = -1


class HostSpan(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    parent: int      # the enclosing span's id, -1 at the top
    frame: int
    self_ns: int     # the duration less that of the spans directly inside
    id: int


class Calibration(NamedTuple):
    device_ns: int   # the stamp
    host_ns: int     # the middle of the host reads around it
    width_ns: int    # the host reads apart


def _p95(values: List[float]) -> float:
    v = sorted(values)
    return v[max(math.ceil(0.95 * len(v)) - 1, 0)]


def _summary(values: List[float]) -> dict:
    return {"frames": len(values), "mean_ms": statistics.fmean(values), "median_ms": statistics.median(values),
            "p95_ms": _p95(values)}


class SpanRecorder:
    """The spans and counters of one renderer on ``device``; ``frame`` is the
    renderer's frame counter (a 0-d int64 tensor on the device) that the
    stamps read."""

    def __init__(self, device: torch.device, frame: torch.Tensor):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.frame = frame
        self.ring = torch.zeros((RING_FRAMES, MAX_SLOTS), dtype=torch.int64, device=self.device)
        self.live = torch.zeros((len(WAVEFRONTS), MAX_BOUNCES), dtype=torch.int64, device=self.device)
        self.run = torch.zeros((len(WAVEFRONTS), MAX_BOUNCES), dtype=torch.int64, device=self.device)
        # render wavefronts, and those whose bounces 2.. ran compacted
        self.compacted = torch.zeros(2, dtype=torch.int64, device=self.device)
        self._calib = torch.zeros((1, 1), dtype=torch.int64, device=self.device)
        self._zero = torch.zeros((), dtype=torch.int64, device=self.device)
        self.layout: Tuple[Slot, ...] = ()  # the frame last run, captured or replayed
        self.frame_id = 0
        self._open: Optional[List[Slot]] = None
        self._stack: List[list] = []       # open host spans: [id, name, start, children's ns, frame]
        self._ids = 0
        self._last_key = None
        self._awaiting: Deque[Tuple[int, int]] = deque()  # (epoch, frame) whose records are to come
        self._epoch = 0
        self._resolution_ns: Optional[int] = None
        self.reset()

    # -- set-up ---------------------------------------------------------------

    def reset(self) -> None:
        """Forget every frame, span and count so far (the key of the last
        frame stays, so that the next frame's switch is counted)."""
        self.frames: Deque[Tuple[int, Tuple[Slot, ...], str]] = deque(maxlen=RING_FRAMES)  # (frame, layout, tile)
        self.host: Deque[HostSpan] = deque(maxlen=HOST_SPANS)
        self.live.zero_()
        self.run.zero_()
        self.compacted.zero_()
        self.switches = 0
        self.tiles: Counter = Counter()
        self.records: List[int] = []
        self._epoch += 1
        self._start = self.calibrate() if self.cuda else None

    # -- host spans -----------------------------------------------------------

    @contextlib.contextmanager
    def span(self, name: str, frame: Optional[int] = None):
        """A host span around the block, under a profiler range of its name;
        ``frame`` sets the frame of this span and of those after it."""
        if frame is not None:
            self.frame_id = frame
        self._ids += 1
        entry = [self._ids, name, 0, 0, self.frame_id]
        parent = self._stack[-1] if self._stack else None
        with profiler_range(name):
            self._stack.append(entry)
            entry[2] = time.perf_counter_ns()
            try:
                yield
            finally:
                end = time.perf_counter_ns()
                self._stack.pop()
                dur = end - entry[2]
                if parent is not None:
                    parent[3] += dur
                self.host.append(HostSpan(name, entry[2], end, -1 if parent is None else parent[0], entry[4],
                                          dur - entry[3], entry[0]))

    # -- device stamps and counters -------------------------------------------

    def open_frame(self) -> None:
        self._open = []

    def _slot(self, slot: Slot) -> None:
        if self._open is None:
            raise RuntimeError(f"stamp {slot.name!r} outside a frame")
        index = len(self._open)
        if index >= MAX_SLOTS:
            raise ValueError(f"more than {MAX_SLOTS} stamps in a frame")
        self._open.append(slot)
        if self.cuda:
            STAMP_KERNEL.launch(ptr(self.ring), ptr(self.frame), RING_FRAMES, MAX_SLOTS, index,
                                current_stream(self.device))
        else:
            self.ring[int(self.frame) % RING_FRAMES, index] = time.perf_counter_ns()

    def stamp(self, name: str) -> None:
        """The start of the phase ``name`` of the open frame."""
        self._slot(Slot(name))

    def bounce(self, wavefront: str, depth: int, alive: torch.Tensor) -> None:
        """The start of bounce ``depth`` of ``wavefront``: a stamp, and the
        lanes alive there and the lanes it runs added to the device's
        counts."""
        if depth >= MAX_BOUNCES:
            raise ValueError(f"bounce {depth}: the spans count at most {MAX_BOUNCES}")
        w = WAVEFRONTS.index(wavefront)
        phase = next((s.name for s in reversed(self._open or []) if s.parent is None), None)
        self._slot(Slot(f"{wavefront}.bounce{depth}", phase, w, depth))
        self.live[w, depth].add_(alive.sum())
        self.run[w, depth].add_(alive.numel())

    def render_wavefront(self, compacted: Optional[torch.Tensor]) -> None:
        """A render wavefront ran; ``compacted`` is its 0-d bool flag on the
        device of bounces 2.. run compacted (None: not compacted)."""
        self.compacted[0].add_(1)
        if compacted is not None:
            self.compacted[1].add_(compacted.to(torch.int64))

    def slots(self) -> int:
        """The open frame's next slot: where each body of a branch starts."""
        return len(self._open)

    def rewind(self, mark: int) -> Tuple[Slot, ...]:
        """Take the slots from ``mark`` on back and return them: the next
        body of the branch stamps the same slots."""
        taken = tuple(self._open[mark:])
        del self._open[mark:]
        return taken

    def rejoin(self, mark: int, taken: Tuple[Slot, ...]) -> None:
        """The branch's last body has stamped from ``mark``: it must have
        stamped the slots ``taken`` of the body before."""
        if tuple(self._open[mark:]) != taken:
            raise RuntimeError("the bodies of a branch stamp different slots")

    def close_frame(self) -> Tuple[Slot, ...]:
        """The frame's last stamp (``frame.end``); returns its layout."""
        self.stamp("frame.end")
        self.layout, self._open = tuple(self._open), None
        return self.layout

    def frame_done(self, frame: int, key, tile: Tuple[int, int], train: bool) -> None:
        """Frame ``frame`` ran with ``layout`` (a replay's, or the one just
        run): its graph key and tile side are counted."""
        side = f"{tile[0]}x{tile[1]}"
        self.frames.append((frame, self.layout, side))
        if self._last_key is not None and key != self._last_key:
            self.switches += 1
        self._last_key = key
        self.tiles[side] += 1
        if train:
            self._awaiting.append((self._epoch, frame))

    def count_records(self, n: int) -> None:
        """The record count of the oldest trained frame not yet counted."""
        epoch, _ = self._awaiting.popleft() if self._awaiting else (None, None)
        if epoch == self._epoch:
            self.records.append(n)

    # -- the clock ------------------------------------------------------------

    def calibrate(self, tries: int = CALIBRATION_TRIES) -> Calibration:
        """A stamp between two host reads around synchronizes, the tightest
        of ``tries``."""
        best = None
        for _ in range(tries):
            torch.cuda.synchronize(self.device)
            t0 = time.perf_counter_ns()
            STAMP_KERNEL.launch(ptr(self._calib), ptr(self._zero), 1, 1, 0, current_stream(self.device))
            torch.cuda.synchronize(self.device)
            t1 = time.perf_counter_ns()
            c = Calibration(int(self._calib[0, 0]), (t0 + t1) // 2, t1 - t0)
            if best is None or c.width_ns < best.width_ns:
                best = c
        return best

    def timer_resolution_ns(self) -> int:
        """The least step of ``%globaltimer`` (of ``perf_counter`` on the CPU)."""
        if self._resolution_ns is None:
            if self.cuda:
                out = torch.zeros(2, dtype=torch.int64, device=self.device)
                TICKS_KERNEL.launch(ptr(out), TIMER_READS, current_stream(self.device))
                self._resolution_ns = int(out[0])
            else:
                self._resolution_ns = max(int(time.get_clock_info("perf_counter").resolution * 1e9), 1)
        return self._resolution_ns

    # -- the report -----------------------------------------------------------

    def report(self) -> dict:
        """Everything since ``reset`` as one JSON-ready dict (see the module
        docstring; ``metrics`` holds the numbers the benchmark's readers
        would take)."""
        if self.cuda:
            torch.cuda.synchronize(self.device)
        end = self.calibrate() if self.cuda else None
        to_host = _clock_map(self._start, end)
        ring = self.ring.cpu().numpy()
        live = self.live.cpu().numpy()
        run = self.run.cpu().numpy()
        render_wavefronts, compacted = (int(v) for v in self.compacted.cpu())

        covered, rows = [], set()  # newest first, each ring row once
        for frame, layout, side in reversed(self.frames):
            row = frame % RING_FRAMES
            if row in rows or not layout:
                break
            rows.add(row)
            covered.append((frame, layout, ring[row, :len(layout)].astype(np.int64), side))
        covered.reverse()

        phases: Dict[str, List[float]] = {}
        selfs: Dict[str, List[float]] = {}
        bounce_ms: Dict[Tuple[int, int], List[float]] = {}
        totals = []
        by_tile: Dict[str, Dict[str, List[float]]] = {}
        for _, layout, t, side in covered:
            tops = [i for i, s in enumerate(layout) if s.parent is None]
            children: Dict[str, float] = {}
            for i, s in enumerate(layout[:-1]):
                if s.parent is None:
                    nxt = next(j for j in tops if j > i)
                    phases.setdefault(s.name, []).append((t[nxt] - t[i]) / 1e6)
                else:
                    ms = (t[i + 1] - t[i]) / 1e6
                    bounce_ms.setdefault((s.wavefront, s.bounce), []).append(ms)
                    children[s.parent] = children.get(s.parent, 0.0) + ms
            tile = by_tile.setdefault(side, {})
            for name in (layout[i].name for i in tops[:-1]):
                selfs.setdefault(name, []).append(phases[name][-1] - children.get(name, 0.0))
                tile.setdefault(name, []).append(phases[name][-1])
            totals.append((t[-1] - t[0]) / 1e6)
            tile.setdefault("frame", []).append(totals[-1])
        n = len(covered)

        device_spans = {}
        for name, values in phases.items():
            device_spans[name] = dict(_summary(values), self_ms=statistics.fmean(selfs[name]))
        if totals:
            device_spans["frame"] = dict(_summary(totals), self_ms=0.0)

        bounces = {w: [] for w in WAVEFRONTS}
        for (w, b), values in sorted(bounce_ms.items()):
            bounces[WAVEFRONTS[w]].append({"bounce": b, "device_ms": statistics.fmean(values),
                                           "live_lanes": int(live[w, b]), "run_lanes": int(run[w, b])})

        host: Dict[str, dict] = {}
        for s in self.host:
            h = host.setdefault(s.name, {"count": 0, "total_ms": 0.0, "self_ms": 0.0})
            h["count"] += 1
            h["total_ms"] += (s.end_ns - s.start_ns) / 1e6
            h["self_ms"] += s.self_ns / 1e6
        for h in host.values():
            h["mean_ms"] = h["total_ms"] / h["count"]
            h["self_ms"] /= h["count"]

        gaps, by_span = [], {}
        spans = sorted(self.host, key=lambda s: s.start_ns)
        starts = [s.start_ns for s in spans]
        for (_, _, a, _), (_, _, b, _) in zip(covered, covered[1:]):
            gap = (b[0] - a[-1]) / 1e6
            gaps.append(gap)
            name = _innermost(spans, starts, to_host((a[-1] + b[0]) / 2))
            g = by_span.setdefault(name, {"gaps": 0, "total_ms": 0.0})
            g["gaps"] += 1
            g["total_ms"] += gap

        live_all, run_all = int(live.sum()), int(run.sum())
        frames_ms, gaps_ms = sum(totals), sum(gaps)
        clock = {"device": "cuda" if self.cuda else "cpu", "resolution_ns": self.timer_resolution_ns()}
        if self.cuda:
            clock.update(bracket_us=end.width_ns / 1e3, bracket_us_at_reset=self._start.width_ns / 1e3,
                         drift_ppm=_drift_ppm(self._start, end))

        def phase_ms(*names):
            return sum(sum(phases.get(k, ())) for k in names) / n if n else None

        return {
            "frames": n,
            "first_frame": covered[0][0] if n else None,
            "last_frame": covered[-1][0] if n else None,
            "window_ms": (covered[-1][2][-1] - covered[0][2][0]) / 1e6 if n else 0.0,
            "frames_ms": frames_ms,
            "gaps_ms": gaps_ms,
            "device_spans": device_spans,
            # each tile side's frames and their mean device ms by phase
            "device_spans_by_tile": {side: {"frames": len(v["frame"]),
                                            **{k: statistics.fmean(x) for k, x in v.items()}}
                                     for side, v in sorted(by_tile.items())},
            "bounces": bounces,
            "host_spans": host,
            "gaps": {"count": len(gaps), "mean_ms": statistics.fmean(gaps) if gaps else None,
                     "by_host_span": dict(sorted(by_span.items(), key=lambda kv: -kv[1]["total_ms"]))},
            "counters": {
                "live_lanes": live_all,
                "run_lanes": run_all,
                "render_wavefronts": render_wavefronts,
                "compacted_wavefronts": compacted,
                "graph_switches": self.switches,
                "frames_by_tile": dict(self.tiles),
                "records_per_frame": ({"frames": len(self.records), "mean": statistics.fmean(self.records),
                                       "least": min(self.records), "most": max(self.records)}
                                      if self.records else None),
            },
            "clock": clock,
            "metrics": {
                "frame.render_wavefront_ms": phase_ms("frame.primary", "frame.render_wavefront"),
                "frame.train_wavefront_ms": phase_ms("frame.train_wavefront"),
                "frame.inference_ms": phase_ms("frame.inference"),
                "frame.train_ms": phase_ms("frame.train"),
                "integrator.live_lanes": 100.0 * live_all / run_all if run_all else None,
                "integrator.compacted_share": (100.0 * compacted / render_wavefronts
                                               if render_wavefronts else None),
                "renderer.gap_ms": statistics.fmean(gaps) if gaps else None,
                "renderer.graph_switches": 100.0 * self.switches / n if n else None,
            },
        }


def _clock_map(start: Optional[Calibration], end: Optional[Calibration]):
    """Device ns to host ns: identity on the CPU, else the line through the
    two calibrations (one alone: its offset)."""
    if end is None:
        return lambda d: d
    if start is None or end.device_ns == start.device_ns:
        return lambda d: d - (end.device_ns - end.host_ns)
    slope = (end.host_ns - start.host_ns) / (end.device_ns - start.device_ns)
    return lambda d: start.host_ns + (d - start.device_ns) * slope


def _drift_ppm(start: Calibration, end: Calibration) -> Optional[float]:
    dd = end.device_ns - start.device_ns
    if dd <= 0:
        return None
    return 1e6 * ((end.device_ns - end.host_ns) - (start.device_ns - start.host_ns)) / dd


def _innermost(spans: List[HostSpan], starts: List[int], t: float, reach: int = 256) -> str:
    """The name of the innermost host span open at host time ``t``: of the
    nested spans that hold it, the one that started last."""
    i = bisect_right(starts, t) - 1
    for s in spans[max(i - reach, -1) + 1:i + 1][::-1]:
        if s.end_ns >= t:
            return s.name
    return NO_HOST_SPAN
