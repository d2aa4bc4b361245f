"""What the wide-BVH walk kernels W1/W2 (and C1/C2) cost a frame on the card, and why.

Run from the root of a checkout on a machine with one CUDA card:

    python3 -m nrc_tpu_torch.tools.bench_walk [--parent DIR] [--l2-probe] [--curves]

The integrator launches W1 (closest hit) and W2 (any hit) over all lanes at
every bounce and marks a dead lane with an empty t range. This tool renders
``cornell_objects`` (132,272 triangles, the wide BVH) FULL + train at
320x320 until the adaptive tile size has settled, records the inputs of
every W1 and W2 launch of one more frame (``bench_intersect.
record_frame_launches``) and, per launch and for the all-live sets of
``bench_intersect.ray_sets``:

- the lanes and the live rays, and the rows each live ray fetches in the
  plain walk (``wide_traverse_plain(..., ray_fetches=)``): mean, 99th
  percentile and largest, the length of a ray's chain of dependent fetches;
- each build's device time on the launch as recorded, and on the same rays
  with the live ones gathered to the front (a measurement only: PyTorch
  indexing outside the kernel). The first against the second is what the
  dead lanes cost; the second against the fetch counts what the longest
  chains cost;
- each build's result held against the plain walk: W1's t bit for bit on
  every ray and the winners on >= 99.99 % of them, W2's occlusion on
  >= 99.99 %.

The builds are the shipped ``csrc/intersect_wide.cu`` and, with ``--parent
DIR``, ``DIR/intersect_wide.cu``, another tree's source with the same entry
points (unpack it with ``git archive <commit> nrc_tpu_torch/csrc | tar -x
-C build/parent``). Builds are timed in turns on each launch (shipped,
parent, parent, shipped) and the two readings averaged. The frame-weighted time of a build is the sum over the
frame's launches. Times are device times (``bench_intersect.device_ms``:
ten launches captured in a CUDA graph, replayed). ``measure`` is the one
definition of a launch's reading: ``chip_smoke.py`` 7b calls it too.

``--curves`` adds the curve walks C1 (closest hit) and C2 (any hit), the
same walk with the round-cone leaf: ``cornell_hair`` (16,384 strands,
262,144 cones) FULL + train at 320x320 until the tile size settles, then
every C1 and C2 launch of one more frame (``record_curve_launches``)
measured as W1/W2's are, against the plain walk with the cone leaf (C1's t
bit for bit, the winners equal but at equal-t ties; C2's occlusion exact),
with their frame-weighted sums beside the W1/W2 frame's (the parent's
W1/W2 beside them with ``--parent``).

``--l2-probe`` then times the shipped build on the frame's launches again,
after ``bench_gather``'s run as ``chip_smoke.py`` makes it (K8 marks its
table's lines evict-last in the L2), and once more after 256 MiB have been
read through the L2: whether what an earlier kernel left in the L2 moves
the walk's time. The last line is one JSON object with the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
from pathlib import Path

import torch

from ..config import RenderMode
from ..ops import intersect_wide as IW
from ..ops import intersect_wide_cuda as WC
from ..ops.cuda_build import CudaKernel
from ..render.renderer import Renderer
from ..ops import curve_intersect as CI
from ..scene.scene_builder import cornell_hair, cornell_objects
from . import bench_gather as BG
from . import bench_intersect as BI

RES = 320


KINDS = {"W1": ("triangle", False), "W2": ("triangle", True), "C1": ("cone", False), "C2": ("cone", True)}


def curve_builds() -> dict:
    """name -> (C1 entry point, C2 entry point): the shipped build."""
    return {"shipped": (WC.CURVE_CLOSEST_KERNEL, WC.CURVE_ANYHIT_KERNEL)}


def record_curve_launches(renderer: Renderer) -> list:
    """Render one frame eagerly with the curve walks wrapped; returns
    [(kind, (org, dir, tmin, tmax))] in launch order, kind "C1" for the
    closest hit and "C2" for the any hit."""
    recorded = []
    originals = (CI.intersect_curves_bvh, CI.occluded_curves_bvh)

    def keep(kind, fn):
        def call(o, d, bvh, tn, tf):
            recorded.append((kind, tuple(x.detach().clone().contiguous() for x in (o, d, tn, tf))))
            return fn(o, d, bvh, tn, tf)
        return call

    CI.intersect_curves_bvh, CI.occluded_curves_bvh = keep("C1", originals[0]), keep("C2", originals[1])
    capture, renderer.capture = renderer.capture, False
    try:
        renderer.render_frame()
    finally:
        CI.intersect_curves_bvh, CI.occluded_curves_bvh = originals
        renderer.capture = capture
    return recorded


def walk_builds(parent: str | None = None) -> dict:
    """name -> (W1 entry point, W2 entry point)."""
    builds = {"shipped": (WC.CLOSEST_KERNEL, WC.ANYHIT_KERNEL)}
    if parent:
        source = str((Path(parent) / "intersect_wide.cu").resolve())
        builds["parent"] = tuple(CudaKernel(source, symbol, WC._ARGS, extra_flags=WC.CLOSEST_KERNEL.extra_flags)
                                 for symbol in ("nrc_wbvh_closest", "nrc_wbvh_any"))
    return builds


def fetch_stats(fetches: torch.Tensor, live: torch.Tensor) -> dict:
    """Mean, 99th percentile and largest count of rows a live ray fetched."""
    f = fetches[live].double()
    if f.numel() == 0:
        return dict(mean=0.0, p99=0.0, max=0)
    return dict(mean=f.mean().item(), p99=torch.quantile(f, 0.99).item(), max=int(f.max().item()))


def live_first(rays):
    """The same rays with the live ones gathered to the front, in order."""
    o, d, tn, tf = rays
    order = torch.argsort((tf <= tn).to(torch.int8), stable=True)
    return tuple(x[order].contiguous() for x in (o, d, tn, tf))


def agreement(kind, got, ref) -> dict:
    """A build's result against the plain walk's on the same rays: W1's t
    bit for bit and its winners on >= 99.99 %, W2's occlusion on >= 99.99 %;
    C1's t bit for bit and its winners equal wherever the plain walk's
    winner has another t (the rest are equal-t ties), C2's occlusion on
    every ray."""
    (tk, pk), (tp, pp) = got, ref
    if kind in ("W1", "C1"):
        same = pk.long() == pp
        winners = same.float().mean().item()
        t_bits = bool(torch.equal(tk, tp))
        if kind == "W1":
            return dict(ok=t_bits and winners >= 0.9999, t_bit_for_bit=t_bits, winners=winners)
        return dict(ok=t_bits and bool((pp[~same] >= 0).all()), t_bit_for_bit=t_bits, winners=winners,
                    ties=int((~same).sum()))
    occ = ((pk >= 0) == (pp >= 0)).float().mean().item()
    return dict(ok=occ >= 0.9999 if kind == "W2" else occ == 1.0, occlusion=occ)


def measure(kind, rays, bvh, builds: dict) -> dict:
    """One launch's reading: lanes, live rays, the plain walk's rows fetched
    (all, distinct, and per live ray), and per build its agreement with the
    plain walk and its device time as recorded and with the live rays first."""
    o, d, tn, tf = rays
    live = tf > tn
    leaf, any_hit = KINDS[kind]
    fetches = torch.zeros(o.shape[0], dtype=torch.int64, device=o.device)
    seen = torch.zeros(bvh.rows.shape[0], dtype=torch.bool, device=o.device)
    tp, pp, fetched = IW.wide_traverse_plain(o, d, bvh, tn, tf, any_hit, rows_seen=seen, ray_fetches=fetches,
                                             leaf=leaf)
    row = dict(kind=kind, lanes=o.shape[0], live=int(live.sum()), fetched=fetched, distinct=int(seen.sum()),
               fetches=fetch_stats(fetches, live), builds={})
    packed = live_first(rays)
    for name, kernels in builds.items():
        got = WC.launch_walk(kernels[any_hit], o, d, bvh, tn, tf)
        row["builds"][name] = dict(agreement(kind, got, (tp, pp)), ms=0.0, live_first_ms=0.0)
    order = list(builds) + list(reversed(builds))
    for name in order:
        k = builds[name][any_hit]
        res = row["builds"][name]
        res["ms"] += BI.device_ms(lambda: WC.launch_walk(k, o, d, bvh, tn, tf)) / 2
        res["live_first_ms"] += BI.device_ms(lambda: WC.launch_walk(k, *packed[:2], bvh, *packed[2:])) / 2
    return row


def curve_frame(dev) -> dict:
    """C1/C2 over one recorded ``cornell_hair`` FULL + train frame."""
    builds = curve_builds()
    scene, system = cornell_hair((RES, RES))
    r = Renderer(scene, system, render_mode=RenderMode.FULL, device=dev)
    bvh = r.device_scene.curve_bvh
    BI.settle_tiles(r)
    rows = []
    for i, (kind, rays) in enumerate(record_curve_launches(r)):
        row = dict(set=f"launch {i}", **measure(kind, rays, bvh, builds))
        rows.append(row)
        f = row["fetches"]
        x = row["builds"]["shipped"]
        print(f"launch {i:3d} {kind}: {row['lanes']:6d} lanes, {row['live']:6d} live, fetches a live ray mean "
              f"{f['mean']:.2f} p99 {f['p99']:.0f} max {f['max']}; {x['ms']:.4f} ms, live first "
              f"{x['live_first_ms']:.4f}{'' if x['ok'] else ' DISAGREES WITH THE PLAIN WALK'}")
    return dict(sets=rows, frame=frame_totals(rows, builds, kinds=("C1", "C2")),
                agree=all(row["builds"]["shipped"]["ok"] for row in rows))


def run(parent: str | None = None, l2_probe: bool = False, curves: bool = False) -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("bench_walk: no CUDA device is available")
    dev = torch.device("cuda", 0)
    builds = walk_builds(parent)
    for name, kernels in list(builds.items()) + ([("curves", curve_builds()["shipped"])] if curves else []):
        for line in kernels[0].build().splitlines():
            if "Used" in line or "spill" in line:
                print(f"{name}: {line.strip()}")
        kernels[1].build()
    scene, system = cornell_objects((RES, RES))
    r = Renderer(scene, system, render_mode=RenderMode.FULL, device=dev)
    bvh = r.device_scene.bvh
    sizes = BI.settle_tiles(r)
    recorded = BI.record_frame_launches(r)
    gen = torch.Generator(device=dev).manual_seed(1)
    sets = BI.ray_sets(r, lambda o, d, tn, tf: WC.wide_traverse_cuda(o, d, bvh, tn, tf, False)[0], gen)
    cases = ([(f"all-live {i}", "W1", s) for i, s in enumerate(sets["closest"])]
             + [(f"all-live {i}", "W2", s) for i, s in enumerate(sets["any"])]
             + [(f"launch {i}", {"K1": "W1", "K2": "W2"}[kind], rays) for i, (kind, rays) in enumerate(recorded)])
    rows = []
    for label, kind, rays in cases:
        row = dict(set=label, **measure(kind, rays, bvh, builds))
        rows.append(row)
        f = row["fetches"]
        print(f"{label:11s} {kind}: {row['lanes']:6d} lanes, {row['live']:6d} live, fetches a live ray mean "
              f"{f['mean']:.2f} p99 {f['p99']:.0f} max {f['max']}; "
              + "; ".join(f"{b}: {x['ms']:.4f} ms, live first {x['live_first_ms']:.4f}"
                          f"{'' if x['ok'] else ' DISAGREES WITH THE PLAIN WALK'}" for b, x in row["builds"].items()))
    frame = frame_totals([row for row in rows if row["set"].startswith("launch")], builds)
    agree = all(x["ok"] for row in rows for x in row["builds"].values())
    probe = None
    if l2_probe:
        shipped = {"shipped": builds["shipped"]}
        probe = {}
        for state, disturb in (("after bench_gather", lambda: BG.run(BG.TABLES, (2048, RES * RES), iters=20)),
                               ("after reading 256 MiB", lambda: torch.ones(1 << 26, device=dev).sum().item())):
            disturb()
            again = [dict(set=f"launch {i}", **measure({"K1": "W1", "K2": "W2"}[kind], rays, bvh, shipped))
                     for i, (kind, rays) in enumerate(recorded)]
            agree &= all(row["builds"]["shipped"]["ok"] for row in again)
            probe[state] = frame_totals(again, shipped, label=f"{state}: ")
    curve = None
    if curves:
        del r, recorded, sets
        curve = curve_frame(dev)
        agree &= curve["agree"]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    return {"device": smi, "tile_sizes": [list(s) for s in sizes], "all_agree": agree, "sets": rows,
            "frame": frame, "l2_probe": probe, "curves": curve}


def frame_totals(launches: list, builds: dict, label: str = "", kinds=("W1", "W2")) -> dict:
    """Each kind's sums over a frame's launch readings, printed."""
    frame = {}
    for kind in kinds:
        mine = [row for row in launches if row["kind"] == kind]
        frame[kind] = dict(
            launches=len(mine), lanes=sum(x["lanes"] for x in mine), live=sum(x["live"] for x in mine),
            fetched=sum(x["fetched"] for x in mine),
            builds={b: {key: sum(x["builds"][b][key] for x in mine) for key in ("ms", "live_first_ms")}
                    for b in builds},
        )
        tot = frame[kind]
        print(f"{label}{kind} over the frame: {tot['launches']} launches, {tot['lanes']} lanes, {tot['live']} live, "
              f"{tot['fetched']} rows fetched; frame-weighted "
              + "; ".join(f"{b}: {x['ms']:.4f} ms, live first {x['live_first_ms']:.4f}"
                          for b, x in tot["builds"].items()))
    return frame


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="W1/W2 over a cornell_objects frame (and C1/C2 over a "
                                             "cornell_hair frame) on one card")
    ap.add_argument("--parent", help="a directory holding another tree's intersect_wide.cu, timed beside")
    ap.add_argument("--l2-probe", action="store_true",
                    help="time the frame's launches again after bench_gather and after a read of 256 MiB")
    ap.add_argument("--curves", action="store_true",
                    help="C1/C2 over a recorded cornell_hair FULL + train frame as well")
    args = ap.parse_args(argv)
    result = run(args.parent, args.l2_probe, args.curves)
    print(result["device"])
    print(json.dumps(result))
    return 0 if result["all_agree"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
