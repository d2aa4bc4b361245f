"""Where a frame's time goes on the card: one traced window of Cornell frames.

Run from the root of a checkout on a machine with one CUDA card:

    python3 -m nrc_tpu_torch.tools.profile_frame

Three configurations of the 1224-triangle Cornell box at 320x320
(frequency encoding 64x5, seeded init): FULL and NO_CACHE with
``train=False`` (the serving side), then FULL + train, the main path, after
the adaptive tile size has settled. For each it first times 20 frames one by
one with the profiler off (host clock around each frame, ending in a
synchronise), then traces 4 frames with ``torch.profiler`` and reads the
trace: device busy time (the union of kernel, memcpy and memset intervals),
the device's idle share of the traced wall time, kernel launches and
host-to-device syncs per frame, and device time by kernel group: K1 (closest
hit), K2 (shadow rays), K3 (cache MLP), K5 (the training gradient, launched
by K6), K6's reduction and Adam + EMA kernels, and everything else, which is
PyTorch's own elementwise, gather, sort and reduction kernels (the six
largest of them are listed by name). The training
side of a frame is FULL + train less FULL. The last line is one JSON object
with the same numbers. The chrome traces (tens of MB each) go to a
temporary directory and are removed.
"""

from __future__ import annotations

import collections
import json
import os
import statistics
import subprocess
import tempfile
import time

import torch

from ..config import RenderMode
from ..render.renderer import Renderer
from ..scene.scene_builder import cornell_box

RES = 320
TIMED_FRAMES = 20
TRACED_FRAMES = 4

GROUPS = (("K1 nrc_planes_closest", "planes_kernel<false>"),
          ("K2 nrc_planes_any", "planes_kernel<true>"),
          ("K3 nrc_mlp_forward", "mlp_forward_kernel"),
          ("K4 nrc_mlp_backward", "mlp_grad_kernel<false>"),
          ("K5 nrc_mlp_train_grad", "mlp_grad_kernel<true>"),
          ("K6 reduce + Adam/EMA", "reduce_partials"),
          ("K6 reduce + Adam/EMA", "adam_ema_kernel"),
          ("K6 reduce + Adam/EMA", "advance_step"))


def _group(name: str) -> str:
    for label, key in GROUPS:
        if key in name:
            return label
    return "PyTorch kernels"


def _busy_us(intervals) -> float:
    busy, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


def profile_mode(r: Renderer, label: str, frames: int, timed: int) -> dict:
    r.render(2)  # warm: kernels built, caches filled
    times = []
    for _ in range(timed):
        t0 = time.perf_counter()
        r.render(1)
        times.append(1e3 * (time.perf_counter() - t0))
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        r.render(frames)
        wall_us = 1e6 * (time.perf_counter() - t0)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    device = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    if not device:
        raise RuntimeError("the profiler recorded no device activity")
    by_group = collections.Counter()
    glue = collections.Counter()  # PyTorch's own kernels by name
    for e in device:
        group = _group(e["name"]) if e["cat"] == "kernel" else e["cat"]
        by_group[group] += e["dur"]
        if group == "PyTorch kernels":
            glue[e["name"][:96]] += e["dur"]
    syncs = sum(1 for e in events if e.get("cat") == "cuda_runtime"
                and ("Synchronize" in e["name"] or e["name"] == "cudaMemcpyAsync"))
    busy = _busy_us((e["ts"], e["ts"] + e["dur"]) for e in device)
    kernels = sum(1 for e in device if e["cat"] == "kernel")
    return {
        "mode": label,
        "tile_size": list(r.cfg.tile_size),
        "ms_per_frame_median": statistics.median(times),
        "ms_per_frame_min": min(times),
        "ms_per_frame_max": max(times),
        "timed_frames": timed,
        "traced_frames": frames,
        "traced_wall_ms_per_frame": wall_us / frames / 1e3,
        "device_busy_ms_per_frame": busy / frames / 1e3,
        "device_idle_share": 1.0 - busy / wall_us,
        "kernel_launches_per_frame": kernels / frames,
        "host_syncs_and_copies_per_frame": syncs / frames,
        "device_ms_per_frame_by_group": {k: v / frames / 1e3 for k, v in by_group.most_common()},
        "top_pytorch_kernels_ms_per_frame": {k: v / frames / 1e3 for k, v in glue.most_common(6)},
    }


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("profile_frame: no CUDA device is available")
    scene, system = cornell_box((RES, RES))
    dev = torch.device("cuda", 0)
    results = []
    for mode in (RenderMode.FULL, RenderMode.NO_CACHE):
        r = Renderer(scene, system, render_mode=mode, train=False, device=dev)
        results.append(profile_mode(r, mode.name, TRACED_FRAMES, TIMED_FRAMES))
    r = Renderer(scene, system, render_mode=RenderMode.FULL, device=dev)
    r.render(8)  # the tile size follows the record count two frames late
    results.append(profile_mode(r, "FULL + train", TRACED_FRAMES, TIMED_FRAMES))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(smi)
    for res in results:
        print(json.dumps(res, indent=1))
    print(json.dumps({"device": smi, "results": results}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
