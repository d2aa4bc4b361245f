"""The readings the check's limits are set from, on the card at a cell's size.

    python3 -m nrc_bench.calibrate --workload <cell> [--seeds 12] [--controls 3] [--frames 100]

One renderer of the cell, as a run makes it; for each seed its network is
made anew from the seed, the counters and the camera set as a run sets
them, ``--frames`` frames of the cell's traffic run (the short window),
and the last few are checked as a run checks them: the program against the
reference (the lower readings). On the first ``--controls`` seeds the same
frame is also computed by the reference in the precision below the
configured one (fp8 operands, the control), and by the reference with a
fault planted: half of each training batch left out, the mean taken over
the rest; each is compared with the sound reference as the program is
(the upper readings). A step that leaves the state unchanged reads 1 in
``weights_gap`` by its definition and needs no run. An answer altered
where it is produced: one image row of the program's frame scaled by
1.01, counted in ``pixels_apart_ppm``. One JSON object a seed goes to standard
output, then a summary: each number's largest lower reading and least
upper reading.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from . import check, registry, scenes, system
from .run import warm_tiles
from .traffic import Traffic

NUMBERS = ("pixels_apart_ppm", "loss_gap", "weights_gap")


def half_batch(train_frame):
    """A fault: each training step on the first half of its batch."""
    def fault(state, batch_q, batch_t, num_records, cfg, learning_rate, **kw):
        half = batch_q.shape[1] // 2
        return train_frame(state, batch_q[:, :half].contiguous(), batch_t[:, :half].contiguous(), num_records,
                           cfg, learning_rate, **kw)
    return fault


def altered_row(after: check.After, pixels: torch.Tensor, width: int, row: int) -> check.After:
    """A fault: the pixels of image row ``row`` scaled by 1.01."""
    scale = torch.where((pixels // width == row)[:, None], 1.01, 1.0)
    return after._replace(image=after.image * scale)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="the check's readings on the card")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--first-seed", type=int, default=3_000_000_000)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--frames", type=int, default=100)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    bench = registry.benchmark()
    cell = registry.workload(bench, args.workload)
    config = registry.config(cell["config"])
    mix = Traffic.from_params(registry.traffic(cell["traffic"]))
    data = scenes.build(config["scene"], tuple(config["resolution"]))
    data.system["tile_size"] = tuple(config["tile_size"])
    r = system.make_renderer(data, config["network"], device, args.first_seed)
    warm_tiles(r, mix, system.tuner_tiles(), config["tile_size"])
    width = data.system["resolution"][0]
    lower = {k: [] for k in NUMBERS}
    upper = {"control": {k: [] for k in NUMBERS}, "half_batch": {k: [] for k in NUMBERS},
             "altered_row": {"pixels_apart_ppm": []}}
    for i in range(args.seeds):
        seed = args.first_seed + 7919 * i
        r.reset_cache(seed)
        init = check.state_dict(r.net_state)
        r.restart_accumulation()
        r.total_subframe = seed & 0xFFFFFFFF
        mix.start(r.scene.camera, seed)
        t0 = time.perf_counter()
        pixels = torch.arange(r.cfg.num_pixels, device=device)
        for _ in range(args.frames):
            mix.before_frame(r)
            r.render_frame()
        kept = []
        for _ in range(check.CHECKED):
            mix.before_frame(r)
            b = check.before(r, pixels)
            kept.append((b, check.after(r, pixels, r.render_frame())))
        torch.cuda.synchronize(device)
        row = {"seed": seed, "tile": list(r.cfg.tile_size), "iteration": kept[0][0].iteration,
               "init_max_abs": check.init_max_abs(init, check.reference_init(config["network"], seed, device))}
        k, row["program"], frame, ref = check.judge(data, config["network"], kept, pixels, device)
        b, a = kept[k]
        row["judged"] = k
        row["seconds"] = time.perf_counter() - t0
        for k in NUMBERS:
            lower[k].append(row["program"][k])
        if i < args.controls:
            ctl, ctl_state = check.reference_frame(data, config["network"], b, pixels, device, operands="fp8")
            row["control"] = check.compare(b, check.as_after(ctl, ctl_state), frame, ref)
            hb, hb_state = check.reference_frame(data, config["network"], b, pixels, device, patch=half_batch)
            row["half_batch"] = check.compare(b, check.as_after(hb, hb_state), frame, ref)
            alt = altered_row(a, pixels, width, row=data.system["resolution"][1] // 2)
            row["altered_row"] = {"pixels_apart_ppm": check.pixels_apart_ppm(alt.image, frame)}
            for fault in ("control", "half_batch", "altered_row"):
                for k, v in upper[fault].items():
                    v.append(row[fault][k])
        print(json.dumps(row), flush=True)
    summary = {"workload": args.workload, "lower": {k: max(v) for k, v in lower.items()},
               "upper": {f: {k: min(v) for k, v in d.items() if v} for f, d in upper.items()},
               "device": torch.cuda.get_device_name(device)}
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
