"""A benchmark cell's window with the renderer's spans on, and their report.

Run from the root of a checkout on a machine with a CUDA card:

    python3 -m nrc_tpu_torch.tools.span_window --workload <cell> --seed <n>
        [--seconds 45] [--spans 0|1] [--trace 0|1] [--out PATH]

One run of the benchmark's cell (``nrc_bench.run.run_cell``: the same
scene, network, warm-up, window and check) with the program's renderer made
with ``spans=True`` (``--spans 0``: the harness's own renderer, for the
cost of the spans against a run without them). The spans are reset where
the harness logs its set-up, right before the window, and read where it
logs the window, right after it and before any profiled frame
(``--trace 1``), so the report covers the window's frames alone. The last
line of standard output is one JSON object: the harness's result line
(``result``), the report (``spans``, ``Renderer.span_report``; null with
``--spans 0``) and the
window's account (``window``): the frames' stamped device time plus the
gaps between them against the window the harness times with CUDA events.
Standard error carries the harness's log and the gaps by host span.
"""

from __future__ import annotations

import argparse
import json
import re
import sys
from typing import Optional

import torch

WINDOW_LINE = re.compile(r"window: (\d+) frames in ([0-9.]+) device ms")


def run(cell_name: str, seed: int, seconds: float, trace: bool, spans: bool, device: torch.device,
        config: Optional[dict] = None, tiles=None, log=print) -> dict:
    """One run of ``cell_name`` (``config`` and ``tiles`` as ``run_cell``
    takes them); returns the last line's object."""
    from nrc_bench import registry, system
    from nrc_bench import run as harness
    from nrc_tpu_torch import config as C
    from nrc_tpu_torch.render.renderer import Renderer

    bench = registry.benchmark()
    cell = registry.workload(bench, cell_name)
    held, window = {}, {}

    def make_renderer(data, network, dev, seed_):
        scene, sys_cfg = system.port_scene(data)
        r = Renderer(scene, sys_cfg, net_cfg=system.network_config(C, network), render_mode=C.RenderMode.FULL,
                     train=True, device=dev, spans=True)
        r.reset_cache(seed_)
        held["r"] = r
        return r

    def hook(*args, **kw):
        line = " ".join(str(a) for a in args)
        r = held.get("r")
        if r is not None and line.startswith("set-up:"):
            r.spans.reset()
        m = WINDOW_LINE.match(line)
        if m:
            window.update(frames=int(m.group(1)), window_ms=float(m.group(2)))
            if r is not None:
                held["report"] = r.span_report()
        log(*args, **kw)

    made = system.make_renderer
    if spans:
        system.make_renderer = make_renderer
    try:
        out = harness.run_cell(bench, cell, seed, seconds, trace, device, config=config, tiles=tiles, log=hook)
    finally:
        system.make_renderer = made
    rep = held.pop("report", None)
    held.clear()
    if rep is not None:
        window.update(stamped_frames=rep["frames"], frames_plus_gaps_ms=rep["frames_ms"] + rep["gaps_ms"],
                      share=(rep["frames_ms"] + rep["gaps_ms"]) / window["window_ms"])
        gaps = ", ".join(f"{k} {v['total_ms']:.3f} ms in {v['gaps']}"
                         for k, v in rep["gaps"]["by_host_span"].items())
        log(f"gaps by host span: {gaps}", file=sys.stderr)
    return {"cell": cell_name, "seed": seed, "spans_on": spans, "trace": trace, "result": out, "spans": rep,
            "window": window}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="a benchmark cell's window with the renderer's spans on")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=45.0)
    ap.add_argument("--spans", type=int, choices=(0, 1), default=1)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--out", default=None, help="also write the last line to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("span_window: no CUDA card", file=sys.stderr)
        return 3
    line = json.dumps(run(args.workload, args.seed, args.seconds, bool(args.trace), bool(args.spans),
                          torch.device("cuda", 0)))
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
