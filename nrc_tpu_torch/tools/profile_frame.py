"""Where a frame's time goes on the card, frames run eagerly and replayed.

Run from the root of a checkout on a machine with one CUDA card:

    python3 -m nrc_tpu_torch.tools.profile_frame

Six configurations at 320x320 (64x5 network, seeded init). On the
1224-triangle Cornell box with the frequency encoding: FULL and NO_CACHE
with ``train=False`` (the serving side), then FULL + train, the main path,
after the adaptive tile size has settled. The same FULL + train with the
hash encoding (``set_encoding``), whose frame runs four ``train_step``s
(H1, K3, K4, H2 and the table's Adam + EMA each) where the frequency frame
runs K6. On the 132 K-triangle ``cornell_objects`` scene, which goes
through the wide BVH: FULL + train, likewise settled. On ``cornell_glass``
(dielectric blocks and a translucent panel: the transmission lobes and the
IOR stack) FULL + train with reflectance factoring and shadow-ray Russian
roulette at tau = 0.5, likewise settled. On ``cornell_lights`` (a point, a
spot and an IES light beside the area light) and on ``env_textured`` (an
open scene under a 1024 x 512 equirect sky, textured albedo, a cutout
panel, a textured emitter), on ``cornell_materials`` (layered, measured
and noise materials), on ``cornell_volume`` (a scattering and an
absorbing medium) and on ``cornell_hair`` (16,384 strands, 262,144 round
cones: the curve walks C1/C2 and the Chiang hair BSDF): FULL and NO_CACHE
serving and FULL + train, likewise settled. ``--only NAME ...`` runs some
of them (``full``, ``no_cache``, ``train``, ``hash``, ``objects``,
``glass``, ``lights``, ``env``, ``materials``, ``volume``, ``hair``).

Each configuration runs twice from the same renderer: eagerly
(``Renderer.capture = False``; every kernel issued from Python) and
replayed (one CUDA graph per frame, the renderer's default on the card).
For each, it times 20 frames one by one with the profiler off (host clock
around each frame, ending in a synchronise), then traces 4 frames with
``torch.profiler`` and reads the trace: device busy time (the union of
kernel, memcpy and memset intervals), the device's idle share of the traced
wall time (and of the frames timed without it, since tracing slows the
host), kernel launches and host syncs and copies (``cudaMemcpyAsync``
and every ``*Synchronize``) per frame, and device time by kernel group: K1
(closest hit), K2 (shadow rays), W1/W2 (the wide-BVH walks that take their
place on the large scene), R1 (the primary raster there), the row gathers,
K3 (cache MLP), K4/K5 (the gradients and their reduction; K4 is on the hash
frame), K6 (the four training steps, one persistent kernel), H1/H2 (the
hash grid's lookup and adjoint), and everything else, which is PyTorch's
own elementwise, gather, sort and reduction kernels (the six largest are
listed by name). Of the eager frames it also sums the device time of the kernels launched inside a profiler
range (``range_device_ms``): the hash table's Adam + EMA
(``utils/spans.py::TABLE_UPDATE_RANGE``), plain PyTorch kernels a replay cannot
tell from the others, since a graph's kernels carry no launch of their own. CUPTI records the
kernels a graph launches, so the groups read the same in both columns.

Every sync and copy is named by its call site: two more frames are traced
with Python stacks, and each ``cudaMemcpyAsync`` or synchronize is put
under the innermost function of the port (or of this tool) that encloses it
and the call it made there; a copy also names its direction from the
device's record of it. The bytes each captured graph holds are listed.
The last line is one JSON object with all of it. The chrome traces (tens of
MB each) go to a temporary directory and are removed.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import os
import statistics
import subprocess
import tempfile
import time

import torch

from ..config import InputEncoding, RenderMode
from ..render.renderer import Renderer
from ..scene.scene_builder import cornell_box, cornell_glass, cornell_objects, named_scene
from ..utils.spans import TABLE_UPDATE_RANGE

RES = 320
TIMED_FRAMES = 20
TRACED_FRAMES = 4
STACK_FRAMES = 2

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
# the files whose functions name a call site
OWN_CODE = ("nrc_tpu_torch/", "chip_smoke.py")


def _group(name: str) -> str:
    for label, keys in GROUPS:
        if all(key in name for key in keys):
            return label
    return "PyTorch kernels"


def _busy_us(intervals) -> float:
    busy, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


def _is_sync_or_copy(e) -> bool:
    return e.get("cat") == "cuda_runtime" and ("Synchronize" in e["name"] or e["name"] == "cudaMemcpyAsync")


def _traced_events(r: Renderer, frames: int, with_stack: bool):
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts, with_stack=with_stack) as prof:
        t0 = time.perf_counter()
        r.render(frames)
        wall_us = 1e6 * (time.perf_counter() - t0)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    return events, wall_us


def _frame_name(e) -> str:
    """``path/to/file.py(12): fn`` -> ``file.py:fn``; a built-in keeps its name."""
    name = e["name"]
    if "): " in name and ".py(" in name:
        path, fn = name.split("): ", 1)
        return f"{os.path.basename(path.split('(')[0])}:{fn}"
    return name.replace("<built-in method ", "").split(" of ")[0].rstrip(">")


def call_sites(events, frames: int) -> dict:
    """Every ``cudaMemcpyAsync`` and synchronize of a trace taken with Python
    stacks -> {call site: count per frame}. The site is the innermost
    function of the port that encloses the call, and the call it made; a
    copy also names its direction (a device-to-device copy is no host
    transfer)."""
    py = collections.defaultdict(list)
    for e in events:
        if e.get("cat") == "python_function":
            py[e.get("tid")].append(e)
    # a copy's direction, from the device's record of it ("Memcpy DtoH ...")
    kinds = {e.get("args", {}).get("correlation"): e["name"].split(" (")[0]
             for e in events if e.get("cat") == "gpu_memcpy"}
    sites = collections.Counter()
    for tid, frames_of_tid in py.items():
        runtime = [e for e in events if _is_sync_or_copy(e) and e.get("tid") == tid]
        timeline = sorted([(e["ts"], -e["dur"], 0, i) for i, e in enumerate(frames_of_tid)]
                          + [(e["ts"], -e["dur"], 1, i) for i, e in enumerate(runtime)])
        stack = []
        for ts, _, kind, i in timeline:
            while stack and stack[-1]["ts"] + stack[-1]["dur"] < ts:
                stack.pop()
            if kind == 0:
                stack.append(frames_of_tid[i])
                continue
            own = [k for k, f in enumerate(stack) if any(o in f["name"] for o in OWN_CODE)]
            if own:
                k = own[-1]
                site = _frame_name(stack[k])
                if k + 1 < len(stack):
                    site += " -> " + _frame_name(stack[k + 1])
            else:
                site = "outside the port"
            call = runtime[i]["name"]
            kind = kinds.get(runtime[i].get("args", {}).get("correlation"))
            sites[f"{site} [{call}{', ' + kind if kind else ''}]"] += 1
    unplaced = sum(1 for e in events if _is_sync_or_copy(e)) - sum(sites.values())
    if unplaced:
        sites["no Python stack on its thread"] += unplaced
    return {k: v / frames for k, v in sites.most_common()}


def range_device_ms(events, name: str, frames: int) -> float:
    """Device ms a frame of the kernels launched inside the profiler ranges
    called ``name``: a launch (a runtime call) inside a range's span on the
    range's thread names its kernel by the correlation id."""
    spans = [(e["tid"], e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("cat") == "user_annotation" and e["name"] == name]
    inside = {e.get("args", {}).get("correlation") for e in events
              if e.get("cat") == "cuda_runtime" and "Launch" in e["name"]
              and any(tid == e.get("tid") and t0 <= e["ts"] <= t1 for tid, t0, t1 in spans)}
    us = sum(e["dur"] for e in events
             if e.get("cat") == "kernel" and e.get("args", {}).get("correlation") in inside)
    return us / frames / 1e3


def profile_mode(r: Renderer, frames: int, timed: int, stacks: bool = True) -> dict:
    """Time ``timed`` frames one by one, then trace ``frames``; with
    ``stacks`` also name the syncs and copies of ``STACK_FRAMES`` more."""
    r.render(2)  # warm: kernels built, caches filled, graphs captured
    times = []
    for _ in range(timed):
        t0 = time.perf_counter()
        r.render(1)
        times.append(1e3 * (time.perf_counter() - t0))
    events, wall_us = _traced_events(r, frames, with_stack=False)
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
    syncs = sum(1 for e in events if _is_sync_or_copy(e))
    busy = _busy_us((e["ts"], e["ts"] + e["dur"]) for e in device)
    kernels = sum(1 for e in device if e["cat"] == "kernel")
    out = {
        "tile_size": list(r.cfg.tile_size),
        "ms_per_frame_median": statistics.median(times),
        "ms_per_frame_min": min(times),
        "ms_per_frame_max": max(times),
        "timed_frames": timed,
        "traced_frames": frames,
        "traced_wall_ms_per_frame": wall_us / frames / 1e3,
        "device_busy_ms_per_frame": busy / frames / 1e3,
        "device_idle_share": 1.0 - busy / wall_us,
        # the profiler slows the host: the share of a frame timed without it
        "device_idle_share_unprofiled": 1.0 - busy / frames / 1e3 / statistics.median(times),
        "kernel_launches_per_frame": kernels / frames,
        "graph_launches_per_frame": sum(1 for e in events if e.get("name") == "cudaGraphLaunch") / frames,
        "host_syncs_and_copies_per_frame": syncs / frames,
        "device_ms_per_frame_by_group": {k: v / frames / 1e3 for k, v in by_group.most_common()},
        "top_pytorch_kernels_ms_per_frame": {k: v / frames / 1e3 for k, v in glue.most_common(6)},
        "hash_table_update_device_ms_per_frame": range_device_ms(events, TABLE_UPDATE_RANGE, frames),
    }
    if stacks:
        stack_events, _ = _traced_events(r, STACK_FRAMES, with_stack=True)
        out["syncs_and_copies_by_call_site_per_frame"] = call_sites(stack_events, STACK_FRAMES)
    return out


def profile_both(r: Renderer, label: str) -> dict:
    """The same renderer eagerly, then replayed."""
    r.capture = False
    eager = profile_mode(r, TRACED_FRAMES, TIMED_FRAMES)
    r.capture = True
    replayed = profile_mode(r, TRACED_FRAMES, TIMED_FRAMES)
    replayed["graphs"] = {f"tile {k[2][0]}x{k[2][1]}": g.nbytes for k, g in r.graphs.items()}
    return {"mode": label, "eager": eager, "replayed": replayed}


def profile_scene(name: str, dev: torch.device) -> list:
    """A named scene's FULL and NO_CACHE serving frames and its FULL + train
    frames after the tile size has settled."""
    scene, system = named_scene(name, (RES, RES))
    rows = []
    for mode in (RenderMode.FULL, RenderMode.NO_CACHE):
        r = Renderer(scene, system, render_mode=mode, train=False, device=dev)
        rows.append(profile_both(r, f"{name} {mode.name}"))
    r = Renderer(scene, system, render_mode=RenderMode.FULL, device=dev)
    r.render(8)
    rows.append(profile_both(r, f"{name} FULL + train"))
    return rows


def main(argv=None) -> int:
    configs = ("full", "no_cache", "train", "hash", "objects", "glass", "lights", "env", "materials", "volume",
               "hair")
    ap = argparse.ArgumentParser(description="where a frame's time goes on the card")
    ap.add_argument("--only", nargs="+", choices=configs, default=configs)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_frame: no CUDA device is available")
    scene, system = cornell_box((RES, RES))
    dev = torch.device("cuda", 0)
    results = []
    for name, mode in (("full", RenderMode.FULL), ("no_cache", RenderMode.NO_CACHE)):
        if name in args.only:
            r = Renderer(scene, system, render_mode=mode, train=False, device=dev)
            results.append(profile_both(r, mode.name))
    if "train" in args.only:
        r = Renderer(scene, system, render_mode=RenderMode.FULL, device=dev)
        r.render(8)  # the tile size follows the record count two frames late
        results.append(profile_both(r, "FULL + train"))
    if "hash" in args.only:
        r = Renderer(scene, system, render_mode=RenderMode.FULL, device=dev)
        r.set_encoding(InputEncoding.HASH)
        r.render(8)
        results.append(profile_both(r, "hash FULL + train"))
    if "objects" in args.only:
        big, big_system = cornell_objects((RES, RES))
        r = Renderer(big, big_system, render_mode=RenderMode.FULL, device=dev)
        r.render(8)
        results.append(profile_both(r, "cornell_objects FULL + train"))
    if "glass" in args.only:
        glass, glass_system = cornell_glass((RES, RES))
        r = Renderer(glass, glass_system, render_mode=RenderMode.FULL, device=dev, reflectance_factoring=True)
        r.cfg = dataclasses.replace(r.cfg, nee_rr_tau=0.5)
        r.render(8)
        results.append(profile_both(r, "cornell_glass FULL + train (factoring, shadow-ray roulette 0.5)"))
    for name, label in (("lights", "cornell_lights"), ("env", "env_textured"), ("materials", "cornell_materials"),
                        ("volume", "cornell_volume"), ("hair", "cornell_hair")):
        if name in args.only:
            results += profile_scene(label, dev)
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
