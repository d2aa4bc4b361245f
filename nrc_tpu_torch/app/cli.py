"""Command-line application: the reference's app shell, with a live viewer.

Port of ``nrc_tpu/app/cli.py``, with the same options
(``nrc/src/Options.cpp:45-157``):
  -w/--width, -h/--height  override render resolution
  -m/--mode 0|1            0 = progressive render loop, 1 = benchmark
  -s/--system              system description file
  -d/--scene               scene description file
  -o/--optimize            accepted (graph optimization is automatic here)

plus --spp, --render-mode, --encoding, --checkpoint/--resume (npz render
states, ``models/checkpoint.py``), --stats-log, --profile (a
``torch.profiler`` Chrome trace, which shows the renderer's host spans and
stamp kernels where --spans is on), --spans PATH (``Renderer(spans=True)``,
its ``span_report`` written as JSON at exit; one device only) and
``--device cuda|cpu``: the card by default, which raises without one; the
CPU only when asked.

- ``--present`` (or ``present 1`` in the system file) with ``-m 0`` serves
  the live viewer (``app/viewer.py``) and renders until interrupted
  (``_present_loop``).
- ``--devices N`` renders the frame in N horizontal bands
  (``parallel/shard.py``): N spawned ranks, each on a card of its own over
  NCCL, or with ``--device cpu`` on the CPU over gloo. Rank 0 prints and
  writes the files. More ranks than cards raise before any frame. With
  ``--present``, rank 0 serves the viewer and hands what it drains to every
  rank before each pass; ctrl-c ends every rank (``_present_loop``,
  ``_run_ranks``).
- ``--checkpoint-format orbax`` is not ported ("Do not port").

Usage:
  python3 -m nrc_tpu_torch.app.cli -s system.txt -d scene.txt -m 1 --spp 8 --output out
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import multiprocessing
import os
import signal
import socket
import sys
import threading
import time

import torch
import torch.distributed as dist

from ..config import InputEncoding, NetworkConfig, RenderMode
from ..models.checkpoint import is_render_state, load_checkpoint, load_render_state, save_render_state
from ..parallel.shard import ParallelRenderer, init_data_group
from ..render.renderer import Renderer
from ..scene.scene_builder import load_scene
from ..utils.image_io import encode_png
from ..utils.tonemap import tonemap_to_u8
from .viewer import Viewer, apply_camera_events


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
                   help="render the frame in bands over N ranks (one card each; "
                        "with --device cpu, N CPU ranks)")
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
    p.add_argument("--spans", default=None, metavar="PATH",
                   help="record spans and counters inside the renderer and write "
                        "their report (Renderer.span_report) as JSON to PATH at exit")
    p.add_argument("--save-system", default=None, metavar="PATH",
                   help="write the current system description (Key S parity)")
    p.add_argument("--stats-log", default=None,
                   help="write per-frame JSONL stats (loss, records, tile size)")
    p.add_argument("--present", action="store_true",
                   help="interactive mode: serve a live HTTP viewer with "
                        "orbit/pan/dolly/zoom (also enabled by 'present 1' "
                        "in the system file)")
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


def _refuse_unported(args) -> None:
    """What the port does not run, refused before any frame."""
    if args.checkpoint_format == "orbax":
        raise NotImplementedError("--checkpoint-format orbax is not ported (ROADMAP, 'Do not port')")
    if args.spans and args.devices > 1:
        raise ValueError("--spans records a single-device renderer, not --devices N")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    if args.devices > 1:
        return _run_ranks(args, argv)
    return _run(args, torch.device(args.device))


def _run_ranks(args, argv) -> int:
    """``--devices N``: N spawned ranks, one card each (or N CPU ranks),
    joined in a data group at a free local port; each runs ``_run`` on its
    band. A rank that fails ends the others. An interrupt (ctrl-c) is
    passed on to rank 0, whose present loop then stops every rank at the
    next pass; a second one ends the ranks at once."""
    _refuse_unported(args)
    if args.device == "cuda":
        cards = torch.cuda.device_count()
        if args.devices > cards:
            raise ValueError(f"--devices {args.devices}: {cards} CUDA devices are present")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(argv, rank, args.devices, port)) for rank in range(args.devices)]
    for p in procs:
        p.start()
    interrupted = False
    try:
        while any(p.is_alive() for p in procs):
            failed = [rank for rank, p in enumerate(procs) if p.exitcode not in (None, 0)]
            if failed:
                raise RuntimeError(f"rank {failed[0]} of {args.devices} failed (exit code {procs[failed[0]].exitcode})")
            try:
                time.sleep(0.1)
            except KeyboardInterrupt:
                if interrupted or not procs[0].is_alive():
                    raise
                interrupted = True
                os.kill(procs[0].pid, signal.SIGINT)
        codes = [p.exitcode for p in procs]
        if codes != [0] * args.devices:
            raise RuntimeError(f"the ranks' exit codes: {codes}")
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
            p.join()
    return 0


def _rank_main(argv, rank: int, world: int, port: int) -> None:
    args = build_parser().parse_args(argv)
    device = torch.device("cuda", rank) if args.device == "cuda" else torch.device("cpu")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    else:  # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    init_data_group(device, rank, world, port)
    try:
        _run(args, device, rank, world)
    finally:
        dist.destroy_process_group()


def _run(args, device: torch.device, rank: int = 0, world: int = 1) -> int:
    """The CLI on one rank of ``world``: rank 0 prints and writes the files."""
    lead = rank == 0
    scene, system = load_scene(args.system, args.scene)
    _refuse_unported(args)
    if lead:
        _print_material_report(scene)
    if args.width:
        system.resolution = (args.width, system.resolution[1])
    if args.height:
        system.resolution = (system.resolution[0], args.height)
    scene.camera.aspect = system.resolution[0] / max(system.resolution[1], 1)

    net_cfg = NetworkConfig(
        encoding=InputEncoding.HASH if args.encoding == "hash" else InputEncoding.FREQUENCY
    )
    kind = ParallelRenderer if world > 1 else Renderer
    r = kind(
        scene, system, net_cfg=net_cfg, render_mode=RenderMode[args.render_mode.upper()],
        train=not args.no_train, reflectance_factoring=args.reflectance_factoring, device=device,
        spans=bool(args.spans),
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
            if lead:
                print(f"resumed render state from {args.resume} (iteration {r.iteration})")
        else:
            r.net_state = load_checkpoint(args.resume, r.net_cfg, r.device, level_block=r.state_block)
            if lead:
                print(f"resumed network from {args.resume}")

    spp = args.spp if args.spp is not None else system.samples_sqrt ** 2
    activities = [torch.profiler.ProfilerActivity.CPU]
    if r.device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    present = args.mode == 0 and (args.present or system.present)
    with contextlib.ExitStack() as stack:
        stats_f = stack.enter_context(open(args.stats_log, "w")) if args.stats_log and lead else None
        # the frames sum their traced rays on the device; read after the barrier
        r.traced_rays.zero_()
        t0 = time.perf_counter()
        with (torch.profiler.profile(activities=activities) if args.profile and lead
              else contextlib.nullcontext()) as prof:
            if present:
                frames = _present_loop(args, r, spp, t0)
            else:
                _render_loop(args, r, spp, stats_f, t0, lead)
                frames = spp
            if r.device.type == "cuda":
                torch.cuda.synchronize(r.device)
        dt = time.perf_counter() - t0
    r.flush_stats()
    if args.checkpoint:
        # every rank: a level-sharded table is gathered from the ranks' blocks
        save_render_state(args.checkpoint, r)
    if not lead:
        return 0
    if args.profile:
        os.makedirs(args.profile, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.profile, "trace.json"))
    if args.spans:
        with open(args.spans, "w") as f:
            json.dump(r.span_report(), f, indent=1)
        print(f"wrote the spans' report to {args.spans}")
    # throughput report (the reference prints only fps,
    # Application.cpp:522-527; Mrays/s + cache queries/s added on top).
    # Mrays/s counts rays actually cast (on-device counter, read after the
    # barrier; every band's with --devices). The wall time includes the
    # first frames' kernel builds and graph captures; in the viewer, the
    # time it served after the last frame too.
    n_tiles = r.cfg.num_tiles if r.cfg.train else 0
    traced = int(r.traced_rays)
    uses_cache = r.cfg.render_mode != RenderMode.NO_CACHE
    n_queries = ((r.cfg.num_pixels if uses_cache else 0) + n_tiles) * frames
    print(
        f"{frames} spp in {dt:.2f}s -> {frames / dt:.2f} fps, "
        f"{traced / dt / 1e6:.2f} Mrays/s traced, "
        f"{n_queries / dt / 1e6:.2f} M cache queries/s"
    )
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
        print(f"saved render state to {args.checkpoint}")
    return 0


def _render_loop(args, r: Renderer, spp: int, stats_f, t0: float, lead: bool = True) -> None:
    """``spp`` frames (``nrc_tpu/app/cli.py:398-430``), each written to the
    stats log when one is open, a render state saved every
    ``--checkpoint-every`` frames (by every rank with ``--devices``: a
    collective, rank 0 writes), and the frame rate printed every 16 frames
    in mode 0 (by rank 0 alone)."""
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
        if lead and args.mode == 0 and (i + 1) % 16 == 0:
            el = time.perf_counter() - t0
            print(f"[{i + 1}/{spp}] {(i + 1) / el:.2f} fps, loss {float(stats.loss):.4f}")


def _present_loop(args, r: Renderer, spp: int, t0: float) -> int:
    """Interactive presentation (``nrc_tpu/app/cli.py:234-290``; the
    reference's interactive mode, ``Application::render`` +
    ``guiEventHandler``): each pass applies the viewer's queued camera verbs
    (a move restarts the accumulation; the frame's graph is replayed, the
    new frustum copied into the rows it reads), its settings and its actions,
    then renders a frame while fewer than ``spp`` are accumulated, else
    sleeps 0.05 s. About once a second the tonemapped image is published as
    a PNG: the loop's one read of the image from the device. It serves until
    interrupted (ctrl-c); returns the frames it rendered.

    Over the ranks of a ``ParallelRenderer`` rank 0 alone serves the viewer,
    publishes and writes the files. It drains the viewer and hands what it
    drained and whether to stop to every rank in one exchange a pass
    (``_PassExchange``); every rank applies it with the same code and
    renders the same frames (their accumulations are equal), whose
    collectives pair them. SIGINT stops rank 0 at its next pass and every
    rank with it; the other ranks ignore it in the loop."""
    lead = r.lead
    exchange = _PassExchange() if isinstance(r, ParallelRenderer) else None
    viewer = None
    last_pub, frames = 0.0, 0
    try:
        if lead:
            viewer = Viewer(port=args.port)
            viewer.params_provider = lambda: _gui_params(r)
            print(f"presenting at {viewer.url} (ctrl-c to stop)", flush=True)
        while True:
            todo = None
            if lead:
                todo = {"verbs": viewer.drain_events(), "settings": viewer.drain_settings(),
                        "actions": viewer.drain_actions(),
                        "stop": exchange is not None and exchange.stop.is_set()}
            if exchange is not None:
                todo = exchange(todo)
            if todo["stop"]:
                break
            _apply_pass(args, r, todo)
            if r.iteration < spp:
                r.render_frame()
                frames += 1
            else:
                time.sleep(0.05)
            now = time.perf_counter()
            if lead and now - last_pub >= 1.0:  # about 1 Hz (Application.cpp:457-491)
                h, w = r.cfg.height, r.cfg.width
                ldr = tonemap_to_u8(r.image.view(h, w, 3).flip(0), r.system.tonemapper).cpu().numpy()
                loss = r.loss_history[-1] if r.loss_history else 0.0
                viewer.publish(encode_png(ldr), r.iteration, frames / max(now - t0, 1e-9), loss,
                               loss_history=list(r.loss_history))
                last_pub = now
    except KeyboardInterrupt:
        if exchange is not None:
            raise  # the ranks stop on the exchange's flag, never between two collectives
    finally:
        if viewer is not None:
            viewer.close()
        if exchange is not None:
            exchange.close()
    return frames


class _PassExchange:
    """The present loop's one exchange a pass over the ranks: rank 0's
    drained verbs, settings and actions and whether to stop, broadcast as
    host objects over a gloo group of their own (the data group's own where
    it is gloo), so that the exchange never touches the card's stream. SIGINT sets ``stop`` instead of raising (rank 0
    broadcasts it; the other ranks' flag is ignored), for the length of the
    loop: no rank leaves it between two collectives of a frame."""

    def __init__(self):
        self.group = dist.new_group(backend="gloo") if dist.get_backend() != "gloo" else None
        self.stop = threading.Event()
        self._saved = signal.signal(signal.SIGINT, lambda *_: self.stop.set())

    def __call__(self, todo):
        box = [todo]
        dist.broadcast_object_list(box, src=0, group=self.group)
        return box[0]

    def close(self) -> None:
        signal.signal(signal.SIGINT, signal.SIG_DFL if self._saved is None else self._saved)
        if self.group is not None:
            dist.destroy_process_group(self.group)


def _apply_pass(args, r: Renderer, todo: dict) -> None:
    """What one pass of the present loop drained from the viewer, applied to
    ``r``: the camera verbs (a move restarts the accumulation), the
    settings, then the actions (the files by the lead renderer alone)."""
    if apply_camera_events(r.scene.camera, todo["verbs"]):
        r.restart_accumulation()
    for s in todo["settings"]:
        _apply_setting(r, s)
    for act in todo["actions"]:
        if act == "reset_cache":
            r.reset_cache()
            r.restart_accumulation()
            continue
        if not r.lead:
            continue
        prefix = args.output or r.system.prefix_screenshot or "frame"
        tag = f"{prefix}_{r.iteration}spp"
        if act == "screenshot_png":
            print(r.screenshot(tag, tonemap=True), flush=True)
        elif act == "screenshot_hdr":
            print(r.screenshot(tag, tonemap=False), flush=True)
        elif act == "save_system":
            print(r.save_system_description(args.save_system or prefix + "_system.txt"), flush=True)


def _gui_params(r: Renderer) -> dict:
    """The state the viewer's control panel edits (``nrc_tpu/app/cli.py:
    293-329``): the reference's System window (render-mode radio, encoding
    combo, tonemapper), Stats window (learning rate, unbiased ratio, area
    spread) and per-material ``Param_info`` editors
    (``Application.cpp:650-1068``, ``inc/MaterialMDL.h:62-295``), and the
    materials' load report. Python values only: the viewer's thread reads
    them."""
    tm = r.system.tonemapper
    return {
        "render_mode": r.cfg.render_mode.name,
        "render_modes": [m.name for m in RenderMode],
        "encoding": r.net_cfg.encoding.name.lower(),
        "learning_rate": float(r.hyper.learning_rate),
        "train_unbiased_ratio": float(r.hyper.train_unbiased_ratio),
        "area_spread_factor": float(r.hyper.area_spread_factor),
        "tonemapper": {
            "gamma": tm.gamma, "white": tm.white_point,
            "burn": tm.burn_highlights, "crush": tm.crush_blacks,
            "sat": tm.saturation, "bright": tm.brightness,
        },
        "materials": [
            {
                "index": i,
                "name": m.name,
                "albedo": list(m.albedo),
                "roughness": list(m.roughness),
                "ior": float(m.ior),
                "thin_walled": bool(m.thin_walled),
                "emission_intensity": list(m.emission_intensity),
            }
            for i, m in enumerate(r.scene.material_rows)
        ],
        "material_report": r.scene.material_report or [],
    }


def _apply_setting(r: Renderer, s: dict) -> None:
    """One queued control-panel edit. Values from HTTP are untrusted: a
    malformed ``/set`` is printed and dropped, not raised into the loop."""
    try:
        _apply_setting_unchecked(r, s)
    except (KeyError, ValueError, IndexError, TypeError) as e:
        if r.lead:
            print(f"ignoring bad setting {s!r}: {type(e).__name__}: {e}", flush=True)


def _apply_setting_unchecked(r: Renderer, s: dict) -> None:
    """``nrc_tpu/app/cli.py:345-395``: a material field, the render mode, the
    encoding, a hyper-parameter or a tonemapper field."""
    key, raw = s["key"], s["value"]

    def vec(txt, n):
        parts = [float(x) for x in txt.split(",")]
        return tuple((parts + parts[-1:] * n)[:n])

    if s.get("material") is not None:
        idx = int(s["material"])
        if not 0 <= idx < len(r.scene.material_rows):
            raise IndexError(f"material index {idx} out of range")
        if key in ("albedo", "emission_intensity"):
            r.update_material(idx, **{key: vec(raw, 3)})
        elif key == "roughness":
            r.update_material(idx, roughness=vec(raw, 2))
        elif key == "ior":
            r.update_material(idx, ior=float(raw))
        elif key == "thin_walled":
            r.update_material(idx, thin_walled=bool(int(raw)))
        return
    if key == "render_mode":
        r.set_render_mode(RenderMode[raw])
    elif key == "encoding":
        r.set_encoding(raw)
    elif key == "learning_rate":
        r.set_hyper_params(learning_rate=float(raw))
    elif key == "train_unbiased_ratio":
        r.set_hyper_params(train_unbiased_ratio=float(raw))
    elif key == "area_spread_factor":
        r.set_hyper_params(area_spread_factor=float(raw))
        r.restart_accumulation()
    elif key.startswith("tm_"):
        field = {
            "tm_gamma": "gamma", "tm_white": "white_point",
            "tm_burn": "burn_highlights", "tm_crush": "crush_blacks",
            "tm_sat": "saturation", "tm_bright": "brightness",
        }[key]
        r.system.tonemapper = dataclasses.replace(r.system.tonemapper, **{field: float(raw)})


if __name__ == "__main__":
    sys.exit(main())
