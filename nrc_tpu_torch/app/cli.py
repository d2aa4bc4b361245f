"""Command-line application: the reference's app shell without the GUI.

Port of the batch path of ``nrc_tpu/app/cli.py``, with the same options
(``nrc/src/Options.cpp:45-157``):
  -w/--width, -h/--height  override render resolution
  -m/--mode 0|1            0 = progressive render loop, 1 = benchmark
  -s/--system              system description file
  -d/--scene               scene description file
  -o/--optimize            accepted (graph optimization is automatic here)

plus --spp, --render-mode, --encoding, --checkpoint/--resume (npz render
states, ``models/checkpoint.py``), --stats-log, --profile (a
``torch.profiler`` Chrome trace) and ``--device cuda|cpu``: the card by
default, which raises without one; the CPU only when asked. Not ported
yet, and refused with ``NotImplementedError``: the live viewer
(``--present`` or ``present 1`` in the system file with ``-m 0``), more
than one device (``--devices``) and the orbax checkpoint container.

Usage:
  python3 -m nrc_tpu_torch.app.cli -s system.txt -d scene.txt -m 1 --spp 8 --output out
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

import torch

from ..config import InputEncoding, NetworkConfig, RenderMode
from ..models.checkpoint import is_render_state, load_checkpoint, load_render_state, save_render_state
from ..render.renderer import Renderer
from ..scene.scene_builder import load_scene


def build_parser() -> argparse.ArgumentParser:
    """The JAX CLI's options (``nrc_tpu/app/cli.py:27-87``) and ``--device``."""
    p = argparse.ArgumentParser(
        prog="nrc_tpu_torch", add_help=False,
        description="neural radiance caching renderer on PyTorch and CUDA",
    )
    p.add_argument("--help", action="help")
    p.add_argument("-w", "--width", type=int, default=None)
    p.add_argument("-h", "--height", type=int, default=None)
    p.add_argument("-m", "--mode", type=int, default=0, choices=(0, 1))
    p.add_argument("-s", "--system", required=True)
    p.add_argument("-d", "--scene", required=True)
    p.add_argument("-o", "--optimize", action="store_true")
    p.add_argument("--spp", type=int, default=None,
                   help="total samples (default samplesSqrt^2 from system file)")
    p.add_argument("--render-mode", default="full",
                   choices=[m.name.lower() for m in RenderMode])
    p.add_argument("--encoding", default="frequency", choices=("frequency", "hash"))
    p.add_argument("--no-train", action="store_true")
    p.add_argument("--lr", type=float, default=None,
                   help="Adam learning rate (default per encoding: 1e-3 "
                        "frequency / 1e-2 hash)")
    p.add_argument("--unbiased-ratio", type=float, default=None,
                   help="fraction of training rays traced unbiased "
                        "(default 1/16)")
    p.add_argument("--reflectance-factoring", action="store_true",
                   help="train the cache on radiance/reflectance and scale "
                        "predictions by the query albedo (the paper's "
                        "reflectance factorization; USE_REFLECTANCE_FACTORING)")
    p.add_argument("--area-spread", type=float, default=None,
                   help="area-spread truncation constant c (default 0.01)")
    p.add_argument("--devices", type=int, default=1,
                   help="number of devices (only 1: multi-GPU is ROADMAP Queue 1 item 5)")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="render on the card (default; raises without one) or on the CPU")
    p.add_argument("--checkpoint", default=None,
                   help="save the full render state here when done")
    p.add_argument("--checkpoint-format", default="npz",
                   choices=("npz", "orbax"),
                   help="checkpoint container: portable single-file npz "
                        "(orbax is not ported)")
    p.add_argument("--checkpoint-every", type=int, default=0, metavar="N",
                   help="also checkpoint every N frames (atomic; crash/"
                        "preemption recovery)")
    p.add_argument("--resume", default=None,
                   help="restore a checkpoint first (full render state, or "
                        "a network-weights-only file)")
    p.add_argument("--output", default=None, help="screenshot path prefix")
    p.add_argument("--hdr", action="store_true", help="also write linear .hdr")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler Chrome trace of the render loop "
                        "to DIR/trace.json")
    p.add_argument("--save-system", default=None, metavar="PATH",
                   help="write the current system description (Key S parity)")
    p.add_argument("--stats-log", default=None,
                   help="write per-frame JSONL stats (loss, records, tile size)")
    p.add_argument("--present", action="store_true",
                   help="interactive viewer (not ported: ROADMAP Queue 1 item 4)")
    p.add_argument("--port", type=int, default=8000,
                   help="viewer port for --present (0 = ephemeral)")
    return p


def _print_material_report(scene) -> None:
    """Per-material load summary; loud about every fallback to diffuse
    (``nrc_tpu/app/cli.py:88-110``, the reference's MDL message relay,
    ``Raytracer.cpp:1655-1669``): each unresolved or unparseable
    declaration prints with its reason, plus a count."""
    report = scene.material_report or []
    warnings = scene.material_load_warnings()
    n_ok = len(report) - len(warnings)
    print(
        f"materials: {n_ok}/{len(report)} resolved"
        + (f", {len(warnings)} degraded to gray diffuse" if warnings else "")
    )
    for e in warnings[:20]:
        print(f"  WARNING material '{e['reference']}' ({e['path']}): "
              f"{e['status']} -> {e.get('fallback', 'fallback')}")
    if len(warnings) > 20:
        print(f"  ... and {len(warnings) - 20} more (Scene.material_report holds the full list)")


def _refuse_unported(args, present: bool) -> None:
    """What the port does not run yet, refused before any frame."""
    if args.mode == 0 and (args.present or present):
        raise NotImplementedError("the live viewer (--present, present 1) is not ported: ROADMAP Queue 1 item 4")
    if args.devices > 1:
        raise NotImplementedError(f"--devices {args.devices}: multi-GPU is not ported: ROADMAP Queue 1 item 5")
    if args.checkpoint_format == "orbax":
        raise NotImplementedError("--checkpoint-format orbax is not ported (ROADMAP, 'Do not port')")


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    scene, system = load_scene(args.system, args.scene)
    _refuse_unported(args, present=bool(system.present))
    _print_material_report(scene)
    if args.width:
        system.resolution = (args.width, system.resolution[1])
    if args.height:
        system.resolution = (system.resolution[0], args.height)
    scene.camera.aspect = system.resolution[0] / max(system.resolution[1], 1)

    net_cfg = NetworkConfig(
        encoding=InputEncoding.HASH if args.encoding == "hash" else InputEncoding.FREQUENCY
    )
    r = Renderer(
        scene, system, net_cfg=net_cfg, render_mode=RenderMode[args.render_mode.upper()],
        train=not args.no_train, reflectance_factoring=args.reflectance_factoring,
        device=torch.device(args.device),
    )
    if args.lr or args.unbiased_ratio or args.area_spread:
        r.set_hyper_params(
            learning_rate=args.lr,
            train_unbiased_ratio=args.unbiased_ratio,
            area_spread_factor=args.area_spread,
        )
    if args.resume:
        if is_render_state(args.resume):
            load_render_state(args.resume, r)
            print(f"resumed render state from {args.resume} (iteration {r.iteration})")
        else:
            r.net_state = load_checkpoint(args.resume, r.net_cfg, r.device)
            print(f"resumed network from {args.resume}")

    spp = args.spp if args.spp is not None else system.samples_sqrt ** 2
    activities = [torch.profiler.ProfilerActivity.CPU]
    if r.device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with contextlib.ExitStack() as stack:
        stats_f = stack.enter_context(open(args.stats_log, "w")) if args.stats_log else None
        # the frames sum their traced rays on the device; read after the barrier
        r.traced_rays.zero_()
        t0 = time.perf_counter()
        with (torch.profiler.profile(activities=activities) if args.profile
              else contextlib.nullcontext()) as prof:
            _render_loop(args, r, spp, stats_f, t0)
            if r.device.type == "cuda":
                torch.cuda.synchronize(r.device)
        dt = time.perf_counter() - t0
    if args.profile:
        os.makedirs(args.profile, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.profile, "trace.json"))
    # throughput report (the reference prints only fps,
    # Application.cpp:522-527; Mrays/s + cache queries/s added on top).
    # Primary Mrays/s counts rays actually cast (on-device counter, read
    # after the barrier); "potential" assumes every path traces every
    # closest-hit + shadow segment, which the area-spread truncation makes
    # a severalfold overstatement. The wall time includes the first frames'
    # kernel builds and graph captures.
    segs = r.cfg.max_depth + 1
    n_tiles = r.cfg.num_tiles if r.cfg.train else 0
    potential = (r.cfg.num_pixels + n_tiles) * segs * 2 * spp
    traced = int(r.traced_rays)
    uses_cache = r.cfg.render_mode != RenderMode.NO_CACHE
    n_queries = ((r.cfg.num_pixels if uses_cache else 0) + n_tiles) * spp
    print(
        f"{spp} spp in {dt:.2f}s -> {spp / dt:.2f} fps, "
        f"{traced / dt / 1e6:.2f} Mrays/s traced "
        f"({potential / dt / 1e6:.2f} potential), "
        f"{n_queries / dt / 1e6:.2f} M cache queries/s"
    )
    r.flush_stats()
    if r.loss_history:
        h = list(r.loss_history)
        print(
            f"loss: last {h[-1]:.4f}, min {min(h):.4f}, "
            f"mean(last 16) {sum(h[-16:]) / len(h[-16:]):.4f}"
        )

    prefix = args.output or system.prefix_screenshot
    print(r.screenshot(prefix + f"_{spp}spp", tonemap=True))
    if args.hdr:
        print(r.screenshot(prefix + f"_{spp}spp", tonemap=False))
    if args.save_system:
        print(r.save_system_description(args.save_system))
    if args.checkpoint:
        save_render_state(args.checkpoint, r)
        print(f"saved render state to {args.checkpoint}")
    return 0


def _render_loop(args, r: Renderer, spp: int, stats_f, t0: float) -> None:
    """``spp`` frames (``nrc_tpu/app/cli.py:398-430``), each written to the
    stats log when one is open, a render state saved every
    ``--checkpoint-every`` frames, and the frame rate printed every 16
    frames in mode 0."""
    for i in range(spp):
        stats = r.render_frame()
        if args.checkpoint and args.checkpoint_every and (i + 1) % args.checkpoint_every == 0:
            save_render_state(args.checkpoint, r)
        if stats_f is not None:
            stats_f.write(json.dumps({
                "frame": i,
                "loss": float(stats.loss),
                "num_train_records": int(stats.num_train_records),
                "traced_rays": int(stats.traced_rays),
                "tile_size": list(r.cfg.tile_size),
            }) + "\n")
        if args.mode == 0 and (i + 1) % 16 == 0:
            el = time.perf_counter() - t0
            print(f"[{i + 1}/{spp}] {(i + 1) / el:.2f} fps, loss {float(stats.loss):.4f}")


if __name__ == "__main__":
    sys.exit(main())
