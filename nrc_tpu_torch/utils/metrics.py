"""Image quality metrics for the quality gate: PSNR and SSIM over
tonemapped images.

A numpy copy of ``nrc_tpu/utils/metrics.py`` (the port never imports the
JAX package). The reference has no automated quality tests; its implicit
oracle is RenderMode Full against NoCache at high spp. These make that
comparison numeric over TONEMAPPED images (what the user sees).
"""

from __future__ import annotations

import numpy as np


def psnr(a: np.ndarray, b: np.ndarray, peak: float = 1.0) -> float:
    """Peak signal-to-noise ratio in dB over [0, peak] images."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    mse = float(np.mean((a - b) ** 2))
    if mse == 0.0:
        return float("inf")
    return 10.0 * np.log10(peak * peak / mse)


def ssim(a: np.ndarray, b: np.ndarray, peak: float = 1.0) -> float:
    """Mean SSIM (Wang et al. 2004), 8x8 uniform windows, per channel:
    uniform filter by integral images; C1 = (0.01 peak)^2, C2 = (0.03 peak)^2."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.ndim == 2:
        a = a[..., None]
        b = b[..., None]
    C1 = (0.01 * peak) ** 2
    C2 = (0.03 * peak) ** 2
    w = 8

    def box(x):
        # [H, W, C] -> sliding-window mean with an integral image
        c = np.cumsum(np.cumsum(x, axis=0), axis=1)
        c = np.pad(c, ((1, 0), (1, 0), (0, 0)))
        s = c[w:, w:] - c[:-w, w:] - c[w:, :-w] + c[:-w, :-w]
        return s / (w * w)

    mu_a = box(a)
    mu_b = box(b)
    var_a = box(a * a) - mu_a * mu_a
    var_b = box(b * b) - mu_b * mu_b
    cov = box(a * b) - mu_a * mu_b
    num = (2 * mu_a * mu_b + C1) * (2 * cov + C2)
    den = (mu_a**2 + mu_b**2 + C1) * (var_a + var_b + C2)
    return float(np.mean(num / den))
