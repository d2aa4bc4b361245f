"""Network input encoding, frequency path: TriangleWave + OneBlob + Identity.

Port of ``nrc_tpu/ops/encodings.py:39-104`` (tiny-cuda-nn's composite
encoding, ``nrc/inc/NRCNetworkConfigs.h:49-127``): TriangleWave(3 position
dims x 12 frequencies -> 36) + OneBlob(6 dims [dir2, normal2, roughness2] x
4 bins -> 24) + Identity(6 dims [diffuse3, specular3]) = 66 features. The
column order is the JAX package's (dim-major), which is the weight layout.
The hash-grid encoding is not ported yet.
"""

from __future__ import annotations

import math

import torch

from ..config import NetworkConfig

M_PI = math.pi

# raw query column layout (render/integrator.make_query)
POS = slice(0, 3)


def triangle_wave(x: torch.Tensor, n_frequencies: int) -> torch.Tensor:
    """[..., D] -> [..., D * F]; column d*F + j is tri(x_d * 2^j), a
    unit-period triangle wave in [0, 1]."""
    d = x.shape[-1]
    freqs = torch.tensor(
        [2.0 ** j for j in range(n_frequencies)], dtype=x.dtype, device=x.device
    ).repeat(d)
    xs = torch.repeat_interleave(x, n_frequencies, dim=-1) * freqs
    return torch.abs(2.0 * (xs - torch.floor(xs + 0.5)))


def one_blob(x: torch.Tensor, n_bins: int) -> torch.Tensor:
    """One-blob encoding (Gaussian kernel over bin centers), domain [0, 1]:
    [..., D] -> [..., D * K], column d*K + k."""
    d = x.shape[-1]
    centers = (
        (torch.arange(n_bins, dtype=x.dtype, device=x.device) + 0.5) / n_bins
    ).repeat(d)
    sigma = 1.0 / n_bins
    diff = torch.repeat_interleave(x, n_bins, dim=-1) - centers
    return torch.exp(-0.5 * (diff / sigma) ** 2)


def _normalized_blob_inputs(query: torch.Tensor) -> torch.Tensor:
    """dir/normal/roughness -> [0, 1] domain for OneBlob."""
    theta_d = query[..., 3] / M_PI
    phi_d = (query[..., 4] + M_PI) / (2.0 * M_PI)
    theta_n = query[..., 5] / M_PI
    phi_n = (query[..., 6] + M_PI) / (2.0 * M_PI)
    return torch.stack(
        [theta_d, phi_d, theta_n, phi_n, query[..., 7], query[..., 8]], dim=-1
    )


def encode_frequency(query: torch.Tensor, cfg: NetworkConfig) -> torch.Tensor:
    """Frequency-path composite encoding: [.., 15] -> [.., 66]."""
    tri = triangle_wave(query[..., POS] * cfg.freq_domain_scale, cfg.freq_n_frequencies)
    blob = one_blob(_normalized_blob_inputs(query), cfg.oneblob_n_bins)
    ident = query[..., 9:15]
    return torch.cat([tri, blob, ident], dim=-1)


def frequency_encoded_dims(cfg: NetworkConfig) -> int:
    return 3 * cfg.freq_n_frequencies + 6 * cfg.oneblob_n_bins + 6
