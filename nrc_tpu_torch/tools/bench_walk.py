"""What the wide-BVH walk kernels W1/W2 (and C1/C2) cost a frame on the card, and why.

Run from the root of a checkout on a machine with one CUDA card:

    python3 -m nrc_tpu_torch.tools.bench_walk [--parent DIR] [--l2-probe] [--curves] [--no-triangles]
    python3 -m nrc_tpu_torch.tools.bench_walk --raster [--parent DIR]

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

The builds of W1/W2 are the shipped ``csrc/intersect_wide.cu`` and, with
``--parent DIR``, ``DIR/intersect_wide.cu``, another tree's source with the
same entry points (unpack it with ``git archive <commit> nrc_tpu_torch/csrc
| tar -x -C build/parent``). Builds are timed in turns on each launch (shipped,
parent, parent, shipped) and the two readings averaged. The frame-weighted time of a build is the sum over the
frame's launches. Times are device times (``bench_intersect.device_ms``:
ten launches captured in a CUDA graph, replayed). ``measure`` is the one
definition of a launch's reading: ``chip_smoke.py`` 7b calls it too.

``--curves`` adds the curve walks C1 (closest hit) and C2 (any hit) of
``csrc/intersect_curves.cu``, the walk over round-cone segments:
``cornell_hair`` (16,384 strands, 262,144 cones) FULL + train at 320x320
until the tile size settles, then every C1 and C2 launch of one more frame
(``record_curve_launches``) measured as W1/W2's are, against the plain walk
with the cone leaf (C1's t bit for bit, the winners equal but at equal-t
ties; C2's occlusion exact), with their frame-weighted sums beside the
W1/W2 frame's. With ``--parent DIR`` the parent's C1/C2 are timed beside
them in turns: ``DIR/intersect_curves.cu``, or ``DIR/intersect_wide.cu``
where the parent has no such file (the curve walks lived there until they
got a source of their own). ``--no-triangles`` skips W1/W2 (``DIR`` still
needs an ``intersect_wide.cu``).

``--l2-probe`` then times the shipped build on the frame's W1/W2 launches
again, after ``bench_gather``'s run as ``chip_smoke.py`` makes it (K8 marks
its table's lines evict-last in the L2), and once more after 256 MiB have
been read through the L2: whether what an earlier kernel left in the L2
moves the walk's time. With ``--curves`` it also times every C1/C2 launch
of the recorded frame cold, each launch right after a 256 MiB read
(``cold_ms``), beside its back-to-back time (``device_ms``, the table warm
in the L2). The last line is one JSON object with the card's name and
power limit.

``--raster`` measures the primary raster instead (``raster_reading``, the
reading ``chip_smoke.py`` 3c makes): ``cornell_objects`` at 320x320, its
bins built on the host for the camera (timed), the camera rays of frame 0,
then R1 (``csrc/raster_primary.cu``), the plain raster and W1 on the same
rays, the walk launch that R1 replaces at depth 0. R1 must equal the plain
raster bit for bit in t and triangle, and W1 in t, its triangles differing
only at equal-t ties (counted). R1 and W1 are timed by CUDA-graph replay,
the plain raster (host loops over the groups) by events around eager calls.
The bound is the larger of the bytes (rows, ids, boxes and the block table
read once, the rays read and t and the id written once) and 39 float32
operations for each pair the function tests: a pixel and a real candidate
whose box holds it. With ``--parent DIR`` an older ``raster_primary.cu``
in ``DIR`` (with the same arguments, or the first design's without the
boxes, which tests every pixel of the tile) is timed on the same bins in
turns with the shipped R1.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from pathlib import Path

import torch

from ..config import RenderMode
from ..ops import intersect_wide as IW
from ..ops import intersect_wide_cuda as WC
from ..ops import raster_cuda as RC
from ..ops import raster_primary as RP
from ..ops.cuda_build import CudaKernel
from ..ops.intersect import RT_MAX
from ..render.renderer import Renderer
from ..ops import curve_intersect as CI
from ..scene.scene_builder import cornell_hair, cornell_objects
from . import bench_gather as BG
from . import bench_intersect as BI

RES = 320
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
F32_OPS_PER_S = 67e12      # float32 outside the tensor cores, a fused multiply-add counted as two
PAIR_OPS = 39              # float32 operations of the triangle test a (ray, triangle) pair, K1's count


KINDS = {"W1": ("triangle", False), "W2": ("triangle", True), "C1": ("cone", False), "C2": ("cone", True)}


def curve_builds(parent: str | None = None) -> dict:
    """name -> (C1 entry point, C2 entry point): the shipped build and, with
    ``parent``, the one of ``parent/intersect_curves.cu`` or, where that
    file is absent, of ``parent/intersect_wide.cu``."""
    builds = {"shipped": (WC.CURVE_CLOSEST_KERNEL, WC.CURVE_ANYHIT_KERNEL)}
    if parent:
        source = Path(parent) / "intersect_curves.cu"
        if not source.exists():
            source = Path(parent) / "intersect_wide.cu"
        builds["parent"] = tuple(CudaKernel(str(source.resolve()), symbol, WC._ARGS,
                                            extra_flags=WC.CURVE_CLOSEST_KERNEL.extra_flags)
                                 for symbol in ("nrc_wbvh_curves_closest", "nrc_wbvh_curves_any"))
    return builds


def cold_ms(fn, flush, reps: int = 5) -> float:
    """Device time of one fn() right after flush() (a read that evicts the
    L2): ``reps`` of (flush, fn) captured in a CUDA graph and replayed
    twice, less ``reps`` of flush alone."""
    def replayed(body):
        body()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(reps):
                body()
        graph.replay()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / (2 * reps)

    def both():
        flush()
        fn()

    return replayed(both) - replayed(flush)


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
    if leaf == "cone":
        row["span_widths"] = WC.curve_span_widths(tn, tf, any_hit)
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


def curve_frame(dev, parent: str | None = None, l2_probe: bool = False) -> dict:
    """C1/C2 over one recorded ``cornell_hair`` FULL + train frame, the
    parent's build beside; with ``l2_probe`` each launch also cold."""
    builds = curve_builds(parent)
    scene, system = cornell_hair((RES, RES))
    r = Renderer(scene, system, render_mode=RenderMode.FULL, device=dev)
    bvh = r.device_scene.curve_bvh
    BI.settle_tiles(r)
    flush_buf = torch.ones(1 << 26, device=dev) if l2_probe else None
    rows = []
    for i, (kind, rays) in enumerate(record_curve_launches(r)):
        row = dict(set=f"launch {i}", **measure(kind, rays, bvh, builds))
        if l2_probe:
            k = builds["shipped"][KINDS[kind][1]]
            row["cold_ms"] = cold_ms(lambda: WC.launch_walk(k, *rays[:2], bvh, *rays[2:]), flush_buf.sum)
        rows.append(row)
        f = row["fetches"]
        sw = row["span_widths"]
        print(f"launch {i:3d} {kind}: {row['lanes']:6d} lanes, {row['live']:6d} live, spans at E = 1/4 "
              f"{sw[1]}/{sw[4]}, fetches a live ray mean {f['mean']:.2f} p99 {f['p99']:.0f} max {f['max']}; "
              + "; ".join(f"{b}: {x['ms']:.4f} ms, live first {x['live_first_ms']:.4f}"
                          f"{'' if x['ok'] else ' DISAGREES WITH THE PLAIN WALK'}" for b, x in row["builds"].items())
              + (f"; cold {row['cold_ms']:.4f} ms" if l2_probe else ""))
    frame = frame_totals(rows, builds, kinds=("C1", "C2"))
    cold = None
    if l2_probe:
        cold = {}
        for kind in ("C1", "C2"):
            mine = [row for row in rows if row["kind"] == kind]
            warm, c = sum(x["builds"]["shipped"]["ms"] for x in mine), sum(x["cold_ms"] for x in mine)
            cold[kind] = dict(warm_ms=warm, cold_ms=c, cold_over_warm=c / warm)
            print(f"{kind} over the frame, shipped: back to back {warm:.4f} ms, each launch after a 256 MiB read "
                  f"{c:.4f} ms ({100 * (c / warm - 1):+.1f} %)")
    return dict(sets=rows, frame=frame, cold=cold, agree=all(x["ok"] for row in rows for x in row["builds"].values()))


def event_ms(fn, iters: int = 3) -> float:
    """Mean time of one eager fn() by CUDA events, after one warm-up call."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def box_pairs(rd: RP.RasterData) -> int:
    """The (pixel, candidate) pairs the raster tests: the pixels of every
    real slot's box."""
    b = rd.boxes[rd.pids >= 0].to(torch.int64)
    return int((((b >> 8) & 255) - (b & 255) + 1).mul((b >> 24) - ((b >> 16) & 255) + 1).sum())


def parent_raster(parent: str) -> tuple:
    """R1 from an older source, and whether it takes the boxes (the first
    design takes the same arguments less the boxes)."""
    path = (Path(parent) / "raster_primary.cu").resolve()
    boxes = "const int* boxes" in path.read_text()
    args = RC.RASTER_KERNEL.argtypes
    return CudaKernel(str(path), "nrc_raster_closest", args if boxes else args[:4] + args[5:],
                      extra_flags=RC.RASTER_KERNEL.extra_flags), boxes


def raster_reading(r: Renderer, parent: str | None = None) -> dict:
    """R1, the plain raster and W1 on the camera rays of r's frame 0 (tmin
    0, tmax RT_MAX), r a renderer of a scene with a wide BVH on the card:
    their agreement, times and R1's bound. The bins are built here for r's
    camera. With ``parent``, an older R1 (``parent_raster``) timed in
    turns with the shipped one."""
    s, cfg, dev = r.scene, r.cfg, r.device
    t0 = time.perf_counter()
    meta, pids, perm, _, boxes = RP.build_raster_bins(s.p0, s.p1, s.p2, *s.camera.frustum(), cfg.width, cfg.height)
    bin_s = time.perf_counter() - t0
    rd = RP.upload_raster(meta, pids, perm, boxes, r.device_scene.tris.packed)
    org, d = BI.camera_rays(r)
    n = org.shape[0]
    tmin, tmax = torch.zeros(n, device=dev), torch.full((n,), RT_MAX, device=dev)
    bvh = r.device_scene.bvh
    t_k, p_k = RC.raster_closest_cuda(meta, rd, org, d)
    t_p, p_p = RP.raster_closest_hit_plain(meta, rd, org, d)
    t_w, p_w = WC.wide_traverse_cuda(org, d, bvh, tmin, tmax, False)
    torch.cuda.synchronize()
    plain_bits = torch.equal(t_k, t_p) and torch.equal(p_k, p_p)
    differ = p_k != p_w
    ties = differ & (t_k == t_w) & (p_k >= 0) & (p_w >= 0)
    walk_t_bits = torch.equal(t_k, t_w)
    candidates = int((rd.pids >= 0).sum())
    pairs, tile_pairs = box_pairs(rd), candidates * meta.tile * meta.tile
    nbytes = candidates * (9 * 4 + 4 + 4) + int((rd.blocks[:, 1] > 0).sum()) * 16 + n * (24 + 4 + 8)
    by_bytes, by_ops = 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * pairs * PAIR_OPS / F32_OPS_PER_S
    reading = dict(
        meta=meta._asdict(), bin_s=bin_s, blocks=rd.blocks.shape[0], slots=rd.pids.numel(),
        candidates=candidates, pairs=pairs, tile_pairs=tile_pairs, hit_share=(p_k >= 0).float().mean().item(),
        plain_bit_for_bit=plain_bits, max_abs_err=(t_k - t_p).abs().max().item(),
        walk_t_bit_for_bit=walk_t_bits, walk_differ=int(differ.sum()),
        walk_ties=int(ties.sum()), ok=plain_bits and walk_t_bits and bool(torch.equal(differ, ties)),
        ms=BI.device_ms(lambda: RC.raster_closest_cuda(meta, rd, org, d)),
        plain_ms=event_ms(lambda: RP.raster_closest_hit_plain(meta, rd, org, d)),
        w1_depth0_ms=BI.device_ms(lambda: WC.wide_traverse_cuda(org, d, bvh, tmin, tmax, False)),
        bound_ms=max(by_bytes, by_ops), bound_by="bytes" if by_bytes >= by_ops else "operations",
    )
    if parent:
        old, with_boxes = parent_raster(parent)
        old.build()

        def old_launch():
            # the same bins (less the boxes for the first design), at the source's own block of threads
            best = torch.empty((n,), dtype=torch.int64, device=dev)
            t = torch.empty((n,), dtype=torch.float32, device=dev)
            prim = torch.empty((n,), dtype=torch.int64, device=dev)
            inputs = (org, d, rd.rows, rd.pids) + ((rd.boxes,) if with_boxes else ()) + (rd.blocks,)
            old.launch(*(RC.ptr(x) for x in inputs), rd.blocks.shape[0],
                       meta.width, meta.height, meta.tile, RC.ptr(best), RC.ptr(t), RC.ptr(prim),
                       RC.current_stream(dev))
            return t, prim

        builds = {"shipped": lambda: RC.raster_closest_cuda(meta, rd, org, d), "parent": old_launch}
        rounds = {"shipped": [], "parent": []}
        for name in ("shipped", "parent", "parent", "shipped"):
            rounds[name].append(BI.device_ms(builds[name]))
        t_o, p_o = old_launch()
        torch.cuda.synchronize()
        reading["parent"] = dict(ms=rounds["parent"], shipped_ms=rounds["shipped"],
                                 t_bit_for_bit=bool(torch.equal(t_o, t_k)), differ=int((p_o != p_k).sum()))
        print(f"R1 in turns with the parent's (shipped, parent, parent, shipped): {rounds['shipped'][0]:.4f}, "
              f"{rounds['parent'][0]:.4f}, {rounds['parent'][1]:.4f}, {rounds['shipped'][1]:.4f} ms; the parent's t "
              f"bit for bit: {reading['parent']['t_bit_for_bit']}, {reading['parent']['differ']} triangles differ")
    print(f"raster bins of {s.num_triangles} triangles at {cfg.width}x{cfg.height} on the host in {bin_s:.3f} s: "
          f"tile {meta.tile}, groups K {meta.group_k} x tiles {meta.group_tiles}, {reading['slots']} slots held, "
          f"{candidates} real candidates, {reading['blocks']} blocks of R1, {pairs} pairs in the boxes of "
          f"{tile_pairs} in the tiles")
    print(f"R1 vs the plain raster: t and triangle bit for bit: {plain_bits}; vs W1 at depth 0: t bit for bit: "
          f"{walk_t_bits}, {reading['walk_differ']} triangles differ, {reading['walk_ties']} of them ties in t; "
          f"hit share {reading['hit_share']:.4f}")
    print(f"R1 {reading['ms']:.4f} ms (device), plain raster {reading['plain_ms']:.3f} ms, W1's depth-0 launch "
          f"{reading['w1_depth0_ms']:.4f} ms (device); bound {reading['bound_ms']:.4f} ms ({reading['bound_by']})")
    return reading


def raster_run(dev, parent: str | None = None) -> dict:
    """``raster_reading`` on ``cornell_objects`` at 320x320."""
    build = RC.RASTER_KERNEL.build()
    for line in build.splitlines():
        if "Used" in line or "spill" in line:
            print(f"R1: {line.strip()}")
    scene, system = cornell_objects((RES, RES))
    reading = raster_reading(Renderer(scene, system, render_mode=RenderMode.FULL, device=dev), parent)
    return {"device": _device_line(), "all_agree": reading["ok"], "raster": reading}


def run(parent: str | None = None, l2_probe: bool = False, curves: bool = False, triangles: bool = True,
        raster: bool = False) -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("bench_walk: no CUDA device is available")
    dev = torch.device("cuda", 0)
    if raster:
        return raster_run(dev, parent)
    builds = walk_builds(parent)
    for name, kernels in list(builds.items()) + ([(f"curves {b}", k) for b, k in curve_builds(parent).items()]
                                                 if curves else []):
        for line in kernels[0].build().splitlines():
            if "Used" in line or "spill" in line:
                print(f"{name}: {line.strip()}")
        kernels[1].build()
    if not triangles:
        curve = curve_frame(dev, parent, l2_probe)
        return {"device": _device_line(), "all_agree": curve["agree"], "curves": curve}
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
        curve = curve_frame(dev, parent, l2_probe)
        agree &= curve["agree"]
    return {"device": _device_line(), "tile_sizes": [list(s) for s in sizes], "all_agree": agree, "sets": rows,
            "frame": frame, "l2_probe": probe, "curves": curve}


def _device_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


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
    ap.add_argument("--parent", help="a directory holding another tree's intersect_wide.cu (and "
                                     "intersect_curves.cu, if it has one), timed beside")
    ap.add_argument("--l2-probe", action="store_true",
                    help="time the frame's launches again after bench_gather and after a read of 256 MiB; "
                         "with --curves each C1/C2 launch cold too")
    ap.add_argument("--curves", action="store_true",
                    help="C1/C2 over a recorded cornell_hair FULL + train frame as well")
    ap.add_argument("--no-triangles", action="store_true", help="with --curves, skip W1/W2 on cornell_objects")
    ap.add_argument("--raster", action="store_true",
                    help="the primary raster R1 instead: against the plain raster and W1's depth-0 launch on "
                         "cornell_objects' camera rays, timed beside them")
    args = ap.parse_args(argv)
    result = run(args.parent, args.l2_probe, args.curves, triangles=not args.no_triangles, raster=args.raster)
    print(result["device"])
    print(json.dumps(result))
    return 0 if result["all_agree"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
