"""The quality gate of the port's Cornell box: FULL + train against a
4096-spp ground truth, for both encodings, on the card.

Run from the root of a checkout on a machine with one CUDA card:

    python3 -m nrc_tpu_torch.tools.quality_gate

As ``tests/test_quality_gate.py:36-57`` measures the reference's gate:
``cornell_box`` at 128x128, FULL render mode with online training, 4x4
training tiles held fixed, 128 frames (1 spp each) from a seeded init; the
image tonemapped to 8 bits with the scene's tonemapper, then PSNR and SSIM
(``utils/metrics.py``) against the ground truth tonemapped the same way. The
ground truth is ``tests/data/torch_cornell_box_gt_128.npz``, rendered once
on the card by ``tools/make_ground_truth.py`` (NO_CACHE, no training, 4096
spp, frames from subframe ``GT_SEED``). A NO_CACHE row at 64 spp gives the
noise floor: what plain path tracing reaches with half the gate's samples.

``LIMITS`` is the one place the gate's limits live; ``chip_smoke.py`` and
``tests/test_torch_quality_gate.py`` read them here. Each limit sits about
2 dB (PSNR) and 0.02 (SSIM) under the port's reading on an H100, as the
reference sets its own (``test_quality_gate.py:7-9``); the reference's
25.0 / 23.0 dB belong to its scene and are not copied. The last line is one
JSON object.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
from pathlib import Path

import numpy as np
import torch

from ..config import InputEncoding, NetworkConfig, RenderMode
from ..render.renderer import Renderer
from ..scene.scene_builder import cornell_box
from ..utils.metrics import psnr, ssim
from ..utils.tonemap import tonemap_to_u8

GT_PATH = Path(__file__).resolve().parents[2] / "tests" / "data" / "torch_cornell_box_gt_128.npz"
GT_SPP = 4096
GT_SEED = 1 << 20   # the ground truth's first subframe: far from the gate's frames
RES = 128
TILE = (4, 4)
FRAMES = 128
FLOOR_SPP = 64

# (least PSNR in dB, least SSIM) of each row, about 2 dB and 0.02 under the
# reading on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py, the first run
# against this ground truth): hash 26.874 dB / 0.9273, frequency
# 30.227 / 0.9301, NO_CACHE at 64 spp 31.247 / 0.8898
LIMITS = {
    "hash": (24.8, 0.90),
    "frequency": (28.2, 0.91),
    "no_cache_64spp": (29.2, 0.87),
}


def load_ground_truth() -> np.ndarray:
    with np.load(GT_PATH) as z:
        return z["hdr"]


def score(hdr: np.ndarray, gt: np.ndarray, tonemapper) -> tuple:
    """(PSNR, SSIM) of two HDR images after the 8-bit tone curve."""
    def ldr(x):
        return tonemap_to_u8(torch.from_numpy(np.ascontiguousarray(x)), tonemapper).numpy().astype(np.float32) / 255.0
    a, b = ldr(hdr), ldr(gt)
    return psnr(a, b), ssim(a, b)


def render_row(row: str, device) -> tuple:
    """The row's image [RES, RES, 3] and the tonemapper to score it with."""
    scene, system = cornell_box((RES, RES))
    system = dataclasses.replace(system, tile_size=TILE)
    if row == "no_cache_64spp":
        r = Renderer(scene, system, render_mode=RenderMode.NO_CACHE, train=False, adaptive_tiles=False,
                     device=device)
        r.render(FLOOR_SPP)
    else:
        encoding = InputEncoding.HASH if row == "hash" else InputEncoding.FREQUENCY
        r = Renderer(scene, system, net_cfg=NetworkConfig(encoding=encoding), render_mode=RenderMode.FULL,
                     train=True, adaptive_tiles=False, device=device)
        r.render(FRAMES)
    return r.image_hdr(), system.tonemapper


def run(device) -> dict:
    """Every row's readings beside its limits."""
    gt = load_ground_truth()
    rows = {}
    for row, (min_psnr, min_ssim) in LIMITS.items():
        hdr, tonemapper = render_row(row, device)
        p, s = score(hdr, gt, tonemapper)
        ok = p >= min_psnr and s >= min_ssim
        rows[row] = {"psnr": float(p), "ssim": float(s), "min_psnr": min_psnr, "min_ssim": min_ssim, "ok": ok,
                     "finite": bool(np.isfinite(hdr).all())}
    return rows


def check(rows: dict) -> None:
    bad = {k: v for k, v in rows.items() if not (v["ok"] and v["finite"])}
    if bad:
        raise AssertionError(f"quality gate failed: {bad}")


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("quality_gate: no CUDA device is available")
    rows = run(torch.device("cuda", 0))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(json.dumps({"device": smi, "rows": rows}))
    check(rows)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
