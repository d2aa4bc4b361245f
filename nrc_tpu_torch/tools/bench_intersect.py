"""What the brute-force intersection kernels K1/K2 cost a frame on the card.

Run from the root of a checkout on a machine with one CUDA card:

    python3 -m nrc_tpu_torch.tools.bench_intersect

The integrator launches K1 (closest hit) and K2 (any hit) over all lanes at
every bounce and marks a dead lane with an empty t range, so a kernel's time
on a full ray set says little about a frame. This tool renders the Cornell
box FULL + train at 320x320 until the adaptive tile size has settled, records
the inputs of every K1 and K2 launch of one more frame (the two callables of
``make_intersectors`` are wrapped; the integrator is not changed), and
reports per launch the lanes, the live lanes and the kernel's device time,
and per kernel the sum over the frame's launches: the frame-weighted time.
The all-live sets (the camera rays and random rays from their hit points;
shadow rays to the lights and random segments) are timed beside them.

Two builds of the one source ``csrc/intersect_planes.cu`` are timed and held
against the plain version on every set: the build the port ships, with
``-fmad=false`` (the plain version's operation order, bit for bit), and a
build without that flag, whose sums the compiler contracts into fused
multiply-adds. The second exists only here, as the measurement of what the
exact order costs. Times are device times: ten launches captured in a CUDA
graph and replayed, so that a kernel of a few microseconds is not timed by
the host's launch pace. The last line is one JSON object with the card's
name and power limit.
"""

from __future__ import annotations

import json
import subprocess

import torch

from ..config import RenderMode
from ..ops import intersect_cuda as IC
from ..ops.cuda_build import CudaKernel, current_stream, ptr
from ..ops.intersect import RT_MAX
from ..render import integrator
from ..render.frame import pixel_grid
from ..render.renderer import Renderer
from ..scene.camera import generate_primary_rays
from ..scene.scene_builder import cornell_box
from ..utils import rng as R

RES = 320


def device_ms(fn, iters: int = 10) -> float:
    """Device time of one fn(): iters calls captured in a CUDA graph and
    replayed twice."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (2 * iters)


def ray_sets(r: Renderer, first_t, gen) -> dict:
    """All-live ray sets of r's frame on the card: the camera rays and random
    rays from their hit points (closest hit); shadow rays to random points of
    the mesh lights and random segments (any hit). ``first_t(org, d, tmin,
    tmax)`` gives the camera rays' hit distances."""
    dev, n = r.device, r.cfg.num_pixels
    pix, pidx = pixel_grid(r.cfg, dev)
    _, jitter = R.rng2(R.tea(pidx, 0))
    org, d = generate_primary_rays(pix, jitter, (r.cfg.width, r.cfg.height), *r._camera_arrays())
    zeros = torch.zeros(n, device=dev)
    far = torch.full((n,), RT_MAX, device=dev)
    t_cam = first_t(org, d, zeros, far)
    p_hit = torch.where((t_cam < RT_MAX)[:, None], org + t_cam[:, None] * d, org).contiguous()
    d2 = torch.randn((n, 3), generator=gen, device=dev)
    d2 = (d2 / d2.norm(dim=-1, keepdim=True)).contiguous()
    eps = torch.full((n,), r.cfg.scene_epsilon, device=dev)
    pool = r.device_scene.lights.mesh_row
    light = pool[torch.randint(0, pool.shape[0], (n,), generator=gen, device=dev)]
    uv = torch.rand((n, 2), generator=gen, device=dev)
    su = uv[:, :1].sqrt()
    target = (1 - su) * light[:, 0:3] + uv[:, 1:] * su * light[:, 3:6] + (su - uv[:, 1:] * su) * light[:, 6:9]
    to_light = target - p_hit
    dist = to_light.norm(dim=-1)
    return {
        "closest": [(org, d, zeros, far), (p_hit, d2, eps, far)],
        "any": [(p_hit, (to_light / dist[:, None]).contiguous(), eps, (dist - r.cfg.scene_epsilon).contiguous()),
                (p_hit, d2, eps, torch.rand((n,), generator=gen, device=dev) * 25.0)],
    }


def record_frame_launches(renderer: Renderer) -> list:
    """Render one frame eagerly (a graph replay calls no Python) with the two
    callables of ``make_intersectors`` wrapped; returns [(kind, (org, dir,
    tmin, tmax))] in launch order, kind "K1" for the closest hit and "K2"
    for the any hit."""
    recorded = []
    original = integrator.make_intersectors

    def recording(*args):
        def keep(kind, fn):
            def call(o, d, tn, tf):
                recorded.append((kind, tuple(x.detach().clone().contiguous() for x in (o, d, tn, tf))))
                return fn(o, d, tn, tf)
            return call

        closest, occluded = original(*args)
        return keep("K1", closest), keep("K2", occluded)

    integrator.make_intersectors = recording
    capture, renderer.capture = renderer.capture, False
    try:
        renderer.render_frame()
    finally:
        integrator.make_intersectors = original
        renderer.capture = capture
    return recorded


def pairs_to_first_hit(rays, planes) -> int:
    """Ray-triangle pairs an any-hit pass needs on these rays: every triangle
    up to a live ray's first hit in table order, all of them without one."""
    o, dd, tn, tf = rays
    num_tris, pairs = planes.shape[0], 0
    for c0, c1 in IC._chunks(o.shape[0], num_tris):
        _, hit = IC._tile_hits(o[c0:c1], dd[c0:c1], planes, tn[c0:c1], tf[c0:c1])
        first = torch.where(hit.any(dim=1), hit.int().argmax(dim=1) + 1, num_tris)
        pairs += int(first[tf[c0:c1] > tn[c0:c1]].sum())
    return pairs


def fma_build():
    """(closest, any): the two entry points of ``csrc/intersect_planes.cu``
    built without ``-fmad=false``, and launchers for them that take what the
    port's wrappers take. Only this tool builds or launches them."""
    k1 = CudaKernel("intersect_planes.cu", "nrc_planes_closest", IC.CLOSEST_ARGS)
    k2 = CudaKernel("intersect_planes.cu", "nrc_planes_any", IC.ANYHIT_ARGS)

    def closest(o, d, planes, tn, tf):
        t = torch.empty(o.shape[:1], dtype=torch.float32, device=o.device)
        prim = torch.empty(o.shape[:1], dtype=torch.int64, device=o.device)
        k1.launch(ptr(o), ptr(d), ptr(tn), ptr(tf), ptr(planes), o.shape[0], planes.shape[0],
                  ptr(t), ptr(prim), current_stream(o.device))
        return t, prim

    def occluded(o, d, planes, tn, tf):
        occ = torch.empty(o.shape[:1], dtype=torch.bool, device=o.device)
        k2.launch(ptr(o), ptr(d), ptr(tn), ptr(tf), ptr(planes), o.shape[0], planes.shape[0],
                  ptr(occ), current_stream(o.device))
        return occ

    return (k1, k2), (closest, occluded)


def settle_tiles(r: Renderer) -> list:
    """Render until the adaptive tile size has held for four frames (it
    follows the record count two frames late); returns the sizes seen."""
    sizes = [r.cfg.tile_size]
    for _ in range(12):
        r.render_frame()
        sizes.append(r.cfg.tile_size)
        if len(sizes) > 4 and len(set(sizes[-4:])) == 1:
            return sizes
    raise RuntimeError(f"the tile size did not settle: {sizes}")


def run() -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("bench_intersect: no CUDA device is available")
    dev = torch.device("cuda", 0)
    fma_kernels, fma_fns = fma_build()
    builds = {
        "exact order (-fmad=false, shipped)": (IC.closest_cuda, IC.occluded_cuda),
        "FMA contraction allowed": fma_fns,
    }
    for label, kernels in (("exact order", (IC.CLOSEST_KERNEL, IC.ANYHIT_KERNEL)), ("FMA", fma_kernels)):
        for line in kernels[0].build().splitlines():
            if "Used" in line or "spill" in line:
                print(f"{label}: {line.strip()}")
        kernels[1].build()
    scene, system = cornell_box((RES, RES))
    r = Renderer(scene, system, render_mode=RenderMode.FULL, device=dev)
    sizes = settle_tiles(r)
    planes = r.device_scene.planes
    recorded = record_frame_launches(r)
    gen = torch.Generator(device=dev).manual_seed(1)
    sets = ray_sets(r, lambda o, d, tn, tf: IC.closest_plain(o, d, planes, tn, tf)[0], gen)
    cases = ([("all-live K1", "K1", s) for s in sets["closest"]] + [("all-live K2", "K2", s) for s in sets["any"]]
             + [(f"launch {i}", kind, rays) for i, (kind, rays) in enumerate(recorded)])
    rows = []
    for label, kind, rays in cases:
        o, d, tn, tf = rays
        row = dict(set=label, kernel=kind, lanes=o.shape[0], live=int((tf > tn).sum()))
        ref = (IC.closest_plain if kind == "K1" else IC.occluded_plain)(o, d, planes, tn, tf)
        for build, (closest, occluded) in builds.items():
            if kind == "K1":
                t, prim = closest(o, d, planes, tn, tf)
                agree = (prim == ref[1]).float().mean().item()
                exact = torch.equal(t, ref[0]) and torch.equal(prim, ref[1])
                ms = device_ms(lambda: closest(o, d, planes, tn, tf))
            else:
                occ = occluded(o, d, planes, tn, tf)
                agree = (occ == ref).float().mean().item()
                exact = torch.equal(occ, ref)
                ms = device_ms(lambda: occluded(o, d, planes, tn, tf))
            row[build] = dict(ms=ms, agreement=agree, equal_bit_for_bit=exact)
        rows.append(row)
        print(f"{label:12s} {kind}: {row['lanes']:6d} lanes, {row['live']:6d} live ({row['live'] / row['lanes']:.4f}); "
              + "; ".join(f"{b}: {row[b]['ms']:.4f} ms, agreement {row[b]['agreement']:.6f}"
                          f"{' (bit for bit)' if row[b]['equal_bit_for_bit'] else ''}" for b in builds))
    frame = {}
    for kind in ("K1", "K2"):
        launches = [row for row in rows if row["set"].startswith("launch") and row["kernel"] == kind]
        frame[kind] = dict(
            launches=len(launches), lanes=sum(x["lanes"] for x in launches), live=sum(x["live"] for x in launches),
            **{b: sum(x[b]["ms"] for x in launches) for b in builds},
        )
        tot = frame[kind]
        print(f"{kind} over the frame: {tot['launches']} launches, {tot['lanes']} lanes, {tot['live']} live "
              f"({tot['live'] / tot['lanes']:.4f}); frame-weighted "
              + "; ".join(f"{b}: {tot[b]:.4f} ms" for b in builds))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    return {"device": smi, "tile_sizes": [list(s) for s in sizes], "sets": rows, "frame": frame}


def main() -> int:
    result = run()
    print(result["device"])
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
