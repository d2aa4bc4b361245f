"""A profiler trace of a few frames, read into device intervals by kernel group.

The grouping of kernel names (``GROUPS``, ``group``) and the busy time as a
union of device intervals (``busy_us``) are frozen copies of
``nrc_tpu_torch/tools/profile_frame.py::GROUPS``, ``_group`` and
``_busy_us``. ``capture`` runs frames under ``torch.profiler`` (CPU and
CUDA activity; CUPTI records the kernels a CUDA graph launches), writes the
chrome trace into a temporary directory, reads it and removes it.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from typing import Callable, List, NamedTuple, Tuple

# (label, substrings that a kernel's name must all hold)
GROUPS = (("K1 nrc_planes_closest", ("planes_kernel<false>",)),
          ("K2 nrc_planes_any", ("planes_kernel<true>",)),
          ("W1 nrc_wbvh_closest", ("wbvh_kernel<", "false", "TriLeaf>")),
          ("W2 nrc_wbvh_any", ("wbvh_kernel<", "true", "TriLeaf>")),
          ("C1 nrc_wbvh_curves_closest", ("curves_kernel<false>",)),
          ("C2 nrc_wbvh_curves_any", ("curves_kernel<true>",)),
          ("R1 nrc_raster_closest", ("raster_kernel",)),
          ("R1 nrc_raster_closest", ("raster_finish_kernel",)),
          ("K7-K9 row gathers", ("gather_warp_kernel",)),
          ("K7-K9 row gathers", ("gather_bulk_kernel",)),
          ("K7-K9 row gathers", ("gather_block_kernel",)),
          ("K3 nrc_mlp_forward", ("mlp_forward_kernel",)),
          ("K4 nrc_mlp_backward", ("mlp_grad_kernel<false>",)),
          ("K5 nrc_mlp_train_grad", ("mlp_grad_kernel<true>",)),
          ("K4/K5 reduce_partials", ("reduce_partials",)),
          ("K6 nrc_mlp_train4", ("mlp_train4_kernel",)),
          ("H1 nrc_hash_lookup", ("hash_lookup_kernel",)),
          ("H2 nrc_hash_adjoint", ("hash_adjoint_kernel",)))
GLUE = "PyTorch kernels"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "python_function")


def group(name: str) -> str:
    for label, keys in GROUPS:
        if all(key in name for key in keys):
            return label
    return GLUE


def busy_us(intervals) -> float:
    busy, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


class Trace(NamedTuple):
    """The device's activities (name, category, start us, duration us), the
    host's calls (name, start us, duration us), the frames traced and the
    traced window's wall time in us."""

    device: List[Tuple[str, str, float, float]]
    host: List[Tuple[str, float, float]]
    frames: int
    wall_us: float

    def device_us_by_group(self) -> dict:
        out: dict = {}
        for name, cat, _, dur in self.device:
            key = group(name) if cat == "kernel" else cat
            out[key] = out.get(key, 0.0) + dur
        return out

    def busy_us(self) -> float:
        return busy_us((s, s + d) for _, _, s, d in self.device)

    def launches(self, label: str) -> List[float]:
        """Durations (us) of the kernels of group ``label``, in order."""
        return [d for name, cat, _, d in self.device if cat == "kernel" and group(name) == label]

    def top_ops(self, k: int = 10) -> list:
        """[name, seconds] of the ``k`` device operations that took most time."""
        by: dict = {}
        for name, _, _, dur in self.device:
            by[name] = by.get(name, 0.0) + dur
        return [[n, us / 1e6] for n, us in sorted(by.items(), key=lambda kv: -kv[1])[:k]]

    def idle_gaps(self, k: int = 10) -> list:
        """[host call, seconds] of the ``k`` longest gaps between device
        activities, each named by the innermost host call running at the
        gap's middle."""
        spans = sorted((s, s + d) for _, _, s, d in self.device)
        gaps, end = [], None
        for s, e in spans:
            if end is not None and s > end:
                gaps.append((end, s))
            end = e if end is None else max(end, e)
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for a, b in gaps[:k]:
            mid = 0.5 * (a + b)
            inside = [(d, name) for name, s, d in self.host if s <= mid <= s + d]
            out.append([min(inside)[1] if inside else "no host call", (b - a) / 1e6])
        return out


def capture(run_frames: Callable[[], None], frames: int, synchronize: Callable[[], None]) -> Trace:
    """``run_frames()`` under the profiler, between two synchronizes."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run_frames()
        synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    device = [(e["name"], e["cat"], float(e["ts"]), float(e["dur"])) for e in events if e.get("cat") in DEVICE_CATS]
    host = [(e["name"], float(e["ts"]), float(e["dur"])) for e in events if e.get("cat") in HOST_CATS]
    return Trace(device, host, frames, wall_us)
