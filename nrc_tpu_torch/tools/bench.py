"""The port's benchmark: traced Mrays/s of a Cornell FULL + train frame on one card.

Run from the root of a checkout on a machine with one CUDA card:

    python3 -m nrc_tpu_torch.tools.bench [--encoding frequency|hash]
        [--scene cornell_box|cornell_objects|cornell_lights|env_textured|
                 cornell_materials|cornell_volume|cornell_hair]

The configuration of the JAX package's ``bench.py:82-89``: the Cornell box
(``cornell_box``, 1224 triangles) at 320x320, FULL render mode with online
training, 4x4 training tiles held fixed (``adaptive_tiles=False``),
64x5 network from a seeded init, the frequency encoding by default (the
first row's definition) or the hash encoding (``Renderer.set_encoding``). Three warm-up frames (the first
captures the frame's CUDA graph), then 5 reps of 32 frames, each frame one
graph replay, the accumulation and the training carried from rep to rep.
``--scene cornell_objects`` runs the same protocol on the 132,272-triangle
scene, whose rays go through the wide BVH and the walk kernels W1/W2 (the
BVH is built on the host before the warm-up); ``--scene cornell_lights``
on the box with a point, a spot and an IES light beside its area light, and
``--scene env_textured`` on the open scene under a 1024 x 512 equirect sky
with textured albedo, a cutout panel and a textured emitter (their files
are written and read in a temporary directory before the warm-up);
``--scene cornell_materials`` on the box of layered, measured and noise
materials, ``--scene cornell_volume`` on the box with a scattering and
an absorbing medium, and ``--scene cornell_hair`` on the box with a patch
of 16,384 strands (262,144 round cones: the curve walks C1/C2 and the
Chiang hair BSDF; the curve BVH is built on the host before the warm-up).

Per rep: host ms/frame (the host clock around the rep, which ends in a
synchronise), device ms/frame (CUDA events around the rep's replays on the
stream) and the rep's own traced rays (closest-hit segments of live lanes
+ shadow rays with a valid light sample, summed by the frames on the
device, ``Renderer.traced_rays``). The value is the median rep's traced
rays over that rep's own host time. Beside each rep, ``nvidia-smi`` samples
the card every 100 ms: the SM and memory clocks (least, median, largest),
the median power draw and the active clock event reasons, so that two runs
can be compared in the same state of the card. ``potential_mrays_per_s`` counts, as
``bench.py`` does, (pixels + tiles) x (max_depth + 1) x 2 rays a frame. The
spread is the reps' smallest and largest values. The last line is one JSON
object with the keys of ``bench.py``'s line (``metric``, ``value``,
``unit``, ``potential_mrays_per_s``, ``timing``), the per-rep numbers and
the card's name and power limit.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
import time

import torch

from ..config import InputEncoding, RenderMode
from ..render.renderer import Renderer
from ..scene.scene_builder import named_scene

RES = 320
SCENES = ("cornell_box", "cornell_objects", "cornell_lights", "env_textured", "cornell_materials",
          "cornell_volume", "cornell_hair")
TILE = (4, 4)
WARMUP = 3
FRAMES = 32
REPS = 5
CLOCK_FIELDS = ("clocks.sm", "clocks.mem", "power.draw", "clocks_throttle_reasons.active")


def clock_sampler() -> subprocess.Popen:
    """``nvidia-smi`` sampling ``CLOCK_FIELDS`` of card 0 every 100 ms until
    ``read_clocks`` stops it."""
    return subprocess.Popen(
        ["nvidia-smi", f"--query-gpu={','.join(CLOCK_FIELDS)}", "--format=csv,noheader,nounits", "-i", "0",
         "-lms", "100"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
    )


def read_clocks(proc: subprocess.Popen) -> dict:
    """Stop the sampler; the clocks' [least, median, largest] in MHz, the
    median power in W and the clock event reasons seen (empty: no sample)."""
    proc.terminate()
    out, _ = proc.communicate(timeout=60)
    samples = []
    for line in out.splitlines():
        parts = [v.strip() for v in line.split(",")]
        try:
            samples.append((float(parts[0]), float(parts[1]), float(parts[2]), parts[3]))
        except (ValueError, IndexError):
            continue
    if not samples:
        return {}

    def spread(k):
        v = sorted(s[k] for s in samples)
        return [v[0], statistics.median(v), v[-1]]

    return {"sm_mhz": spread(0), "mem_mhz": spread(1), "power_w": spread(2)[1],
            "clock_event_reasons": sorted({s[3] for s in samples}), "samples": len(samples)}


def run_rep(r: Renderer, frames: int) -> dict:
    """``frames`` frames; host and device ms/frame, the traced rays and the
    card's clocks over the rep."""
    r.traced_rays.zero_()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(r.device)
    sampler = clock_sampler()
    t0 = time.perf_counter()
    start.record()
    for _ in range(frames):
        r.render_frame()
    end.record()
    torch.cuda.synchronize(r.device)
    host_s = time.perf_counter() - t0
    traced = int(r.traced_rays)
    return {
        "host_ms_per_frame": 1e3 * host_s / frames,
        "device_ms_per_frame": start.elapsed_time(end) / frames,
        "traced_rays": traced,
        "mrays_per_s": traced / host_s / 1e6,
        "clocks": read_clocks(sampler),
    }


def run(frames: int = FRAMES, reps: int = REPS, encoding: InputEncoding = InputEncoding.FREQUENCY,
        scene_name: str = "cornell_box") -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("bench: no CUDA device is available")
    dev = torch.device("cuda", 0)
    scene, system = named_scene(scene_name, (RES, RES))
    system = dataclasses.replace(system, tile_size=TILE)
    r = Renderer(scene, system, render_mode=RenderMode.FULL, train=True, adaptive_tiles=False, device=dev)
    r.set_encoding(encoding)
    for _ in range(WARMUP):
        r.render_frame()
    replays = r.replays
    rows = [run_rep(r, frames) for _ in range(reps)]
    r.flush_stats()
    if r.replays - replays != frames * reps:
        raise RuntimeError("a timed frame was not a graph replay")
    median = sorted(rows, key=lambda row: row["host_ms_per_frame"])[reps // 2]
    fps = 1e3 / median["host_ms_per_frame"]
    cfg = r.cfg
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    values = [row["mrays_per_s"] for row in rows]
    return {
        "metric": "mrays_per_s",
        "value": median["mrays_per_s"],
        "unit": "Mrays/s",
        "potential_mrays_per_s": (cfg.num_pixels + cfg.num_tiles) * (cfg.max_depth + 1) * 2 * fps / 1e6,
        "timing": f"{frames} graph-replayed frames a rep, the median rep of {reps} by host time, "
                  "with that rep's own traced rays",
        "host_ms_per_frame": median["host_ms_per_frame"],
        "device_ms_per_frame": median["device_ms_per_frame"],
        "traced_rays_per_frame": median["traced_rays"] / frames,
        "spread_mrays_per_s": [min(values), max(values)],
        "spread_host_ms_per_frame": [min(row["host_ms_per_frame"] for row in rows),
                                     max(row["host_ms_per_frame"] for row in rows)],
        "reps": rows,
        "loss_last": r.loss_history[-1],
        "encoding": encoding.name.lower(),
        "scene": scene_name,
        "device": smi,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="traced Mrays/s of a Cornell FULL + train frame on one card")
    ap.add_argument("--encoding", choices=("frequency", "hash"), default="frequency")
    ap.add_argument("--scene", choices=SCENES, default="cornell_box")
    args = ap.parse_args(argv)
    result = run(encoding=InputEncoding[args.encoding.upper()], scene_name=args.scene)
    print(result["device"])
    for i, row in enumerate(result["reps"]):
        print(f"rep {i}: {row['host_ms_per_frame']:.3f} host ms/frame, {row['device_ms_per_frame']:.3f} device "
              f"ms/frame, {row['traced_rays']} traced rays, {row['mrays_per_s']:.3f} Mrays/s; clocks "
              f"{row['clocks']}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
