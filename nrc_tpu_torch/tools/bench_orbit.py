"""A dragged camera on the card: what a camera move costs a frame.

Run from the root of a checkout on a machine with one CUDA card:

    python3 -m nrc_tpu_torch.tools.bench_orbit [--scene cornell_objects] [--frames 32]

The live viewer (``app/viewer.py``) turns a mouse drag into ``orbit(dx,
dy)`` with dx the drag over the image's width, a few thousandths to a few
hundredths of a turn between two frames, and restarts the accumulation.
This tool renders the scene at 320x320 FULL + train (4x4 training tiles
held fixed) on a ``Renderer`` with captured graphs: three frames to warm
up, ``--frames`` frames with the camera still, then for each orbit step of
``STEPS`` ``--frames`` frames, each after ``orbit(step, 0)`` and a restart.
Every frame is timed on the host clock and ends in a synchronise, as the
viewer's loop reads each frame. Per run: ms a frame (median and mean) and
frames/s still and moving, the graphs captured while moving, the graphs
held and their pools' bytes, and the host time of the primary raster's
binning a move (``Renderer._bin_primaries``), where the tree has one (a
frame whose camera moved walks and bins nothing, so a drag reads 0). Runs
with the raster (the default on a scene above 16,384 triangles) and with
``raster_primary=False``; a tree whose ``Renderer`` has no such switch runs
once, as it is (to time a parent tree, copy this file into it). The last
line is one JSON object with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import inspect
import json
import statistics
import subprocess
import time

import torch

from ..config import RenderMode
from ..render.renderer import Renderer
from ..scene.scene_builder import named_scene

RES = 320
STEPS = (0.003, 0.01, 0.03)  # a turn's share a frame


def _timed(r: Renderer, frames: int, step: float | None) -> list:
    """Host ms of each of ``frames`` frames, the camera orbited by ``step``
    (and the accumulation restarted) before each when ``step`` is given."""
    out = []
    for _ in range(frames):
        t0 = time.perf_counter()
        if step is not None:
            r.scene.camera.orbit(step, 0.0)
            r.restart_accumulation()
        r.render_frame()
        torch.cuda.synchronize(r.device)
        out.append(1e3 * (time.perf_counter() - t0))
    return out


def orbit_run(scene_name: str, frames: int, dev, **renderer_kw) -> dict:
    scene, system = named_scene(scene_name, (RES, RES))
    r = Renderer(scene, system, render_mode=RenderMode.FULL, adaptive_tiles=False, device=dev, **renderer_kw)
    captures, bins = [0], []
    capture = r._capture

    def counted(key):
        captures[0] += 1
        return capture(key)
    r._capture = counted
    if hasattr(r, "_bin_primaries"):
        bin_primaries = r._bin_primaries

        def timed_bins():
            t0 = time.perf_counter()
            bin_primaries()
            bins.append(1e3 * (time.perf_counter() - t0))
        r._bin_primaries = timed_bins
    _timed(r, 3, None)
    still = _timed(r, frames, None)
    out = dict(still=dict(median_ms=statistics.median(still), mean_ms=statistics.mean(still),
                          fps=1e3 / statistics.mean(still)),
               raster=bool(getattr(r, "raster_enabled", False)), moving={})
    for step in STEPS:
        captures[0], bins[:] = 0, []
        ms = _timed(r, frames, step)
        moved_bins = [b for b in bins if b > 1.0]  # the frames that binned (the still ones return at once)
        out["moving"][str(step)] = dict(
            median_ms=statistics.median(ms), mean_ms=statistics.mean(ms), fps=1e3 / statistics.mean(ms),
            captures=captures[0], graphs=len(r.graphs), graph_bytes=sum(g.nbytes for g in r.graphs.values()),
            bin_ms=statistics.mean(moved_bins) if moved_bins else 0.0,
        )
        m = out["moving"][str(step)]
        print(f"{scene_name} raster={out['raster']} orbit {step} a frame: {m['median_ms']:.3f} ms median, "
              f"{m['mean_ms']:.3f} mean ({m['fps']:.2f} frames/s; still {out['still']['fps']:.2f}), "
              f"{m['captures']} captures, {m['graphs']} graphs held of {m['graph_bytes']} bytes, binning "
              f"{m['bin_ms']:.2f} ms a move", flush=True)
    out["reserved_bytes"] = torch.cuda.memory_reserved(dev)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scene", default="cornell_objects")
    ap.add_argument("--frames", type=int, default=32)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("bench_orbit: no CUDA device is available")
    dev = torch.device("cuda", 0)
    runs = {}
    if "raster_primary" in inspect.signature(Renderer).parameters:
        for raster in (True, False):
            runs["raster" if raster else "walk"] = orbit_run(args.scene, args.frames, dev, raster_primary=raster)
    else:
        runs["as is"] = orbit_run(args.scene, args.frames, dev)
    device = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
                            capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(device)
    print(json.dumps({"scene": args.scene, "frames": args.frames, "device": device, "runs": runs}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
