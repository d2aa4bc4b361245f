"""Render the Cornell box's ground truth on the card: NO_CACHE, no training,
4096 spp at 128x128, and write it as an ``.npz`` for the quality gate.

Run from the root of a checkout on a machine with one CUDA card:

    python3 -m nrc_tpu_torch.tools.make_ground_truth [--out PATH]

(default ``tests/data/torch_cornell_box_gt_128.npz``). The counterpart of
``tools/make_ground_truth.py``, for the port's own ``cornell_box`` (the
reference's ``cornell_gt_*.npz`` belong to its scene file, which is not
this scene). ``quality_gate.GT_SPP`` frames (4096) at ``RES`` x ``RES``
(128), each 1 spp and one CUDA graph replay; their sample streams start at
subframe ``quality_gate.GT_SEED`` (the TEA stream of every pixel is keyed
by the subframe), so the gate's own frames, which start at 0, draw other
samples. The file holds ``hdr`` [res, res, 3] float32 (row 0 at the top),
``spp``, ``seed``, ``scene``, ``res``, the card's name and power limit
(``nvidia-smi``) and the seconds the render took.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time

import numpy as np
import torch

from ..config import RenderMode
from ..render.renderer import Renderer
from ..scene.scene_builder import cornell_box
from .quality_gate import GT_PATH, GT_SEED, GT_SPP, RES


def render_ground_truth(spp: int, res: int, seed: int, device) -> np.ndarray:
    """[res, res, 3] float32: the mean of ``spp`` NO_CACHE frames from subframe ``seed``."""
    scene, system = cornell_box((res, res))
    r = Renderer(scene, system, render_mode=RenderMode.NO_CACHE, train=False, adaptive_tiles=False,
                 device=device)
    r.total_subframe = seed
    for i in range(spp):
        r.render_frame()
        if (i + 1) % 512 == 0:
            r._sync()
            print(f"[{i + 1}/{spp}]", file=sys.stderr, flush=True)
    r._sync()
    return r.image_hdr().astype(np.float32)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(GT_PATH))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("make_ground_truth: no CUDA device is available")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    t0 = time.perf_counter()
    hdr = render_ground_truth(GT_SPP, RES, GT_SEED, dev)
    seconds = time.perf_counter() - t0
    np.savez_compressed(
        args.out, hdr=hdr, spp=np.int32(GT_SPP), seed=np.int64(GT_SEED), res=np.int32(RES),
        scene=np.str_("cornell_box"), device=np.str_(smi), seconds=np.float64(seconds),
    )
    print(f"wrote {args.out}: {GT_SPP} spp at {RES}x{RES} in {seconds:.1f} s on {smi}; "
          f"mean {hdr.mean(axis=(0, 1))}, max {hdr.max():.3f}, finite {bool(np.isfinite(hdr).all())}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
