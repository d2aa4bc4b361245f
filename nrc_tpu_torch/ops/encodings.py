"""Network input encodings: TriangleWave + OneBlob + Identity, and the
multiresolution hash grid.

Port of ``nrc_tpu/ops/encodings.py`` (tiny-cuda-nn's composite encoding,
``nrc/inc/NRCNetworkConfigs.h:49-127``):

- frequency path: TriangleWave(3 position dims x 12 frequencies -> 36) +
  OneBlob(6 dims [dir2, normal2, roughness2] x 4 bins -> 24) + Identity(6
  dims [diffuse3, specular3]) = 66 features;
- hash path: HashGrid(3 dims, 16 levels, 2 features a level, 2^15 rows,
  base resolution 16, scale 2.0 -> 32) + OneBlob(24) + Identity(6) = 62.

The column order is the JAX package's (dim-major), which is the weight
layout. The grid's lookup and its adjoint run through ``ops/hash_cuda``
(kernels H1/H2 on the card, their plain versions on the CPU). Not ported:
the TPU's one-hot matrix-product adjoint (``_use_onehot_adjoint``,
``_grid_gather``), a workaround for the TPU's slow scatter, and
``sharded_hash_grid_lookup``, which waits for the multi-GPU port.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from ..config import NetworkConfig
from .hash_cuda import GridSpec, HashGridLookup, corner_index_weight

M_PI = math.pi

# raw query column layout (render/integrator.make_query)
POS = slice(0, 3)


@functools.lru_cache(maxsize=None)
def _frequencies(n_frequencies: int, d: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """[d * F]: 2^j for j < F, repeated d times. Made once per device and
    shape: it is copied from the host, which a captured frame cannot do."""
    return torch.tensor([2.0 ** j for j in range(n_frequencies)], dtype=dtype, device=device).repeat(d)


def triangle_wave(x: torch.Tensor, n_frequencies: int) -> torch.Tensor:
    """[..., D] -> [..., D * F]; column d*F + j is tri(x_d * 2^j), a
    unit-period triangle wave in [0, 1]."""
    freqs = _frequencies(n_frequencies, x.shape[-1], x.dtype, x.device)
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


# ---------------------------------------------------------------------------
# Multiresolution hash grid (Instant-NGP style; tcnn HashGrid)
# ---------------------------------------------------------------------------

class HashGridParams(NamedTuple):
    """Trainable hash tables: [n_levels, 2^log2_size, n_features]."""

    table: torch.Tensor


def init_hash_grid(generator: torch.Generator, cfg: NetworkConfig) -> HashGridParams:
    """U(-1e-4, 1e-4), as tcnn initializes the table, drawn from a
    ``torch.Generator`` on the CPU."""
    shape = (cfg.hash_n_levels, 2 ** cfg.hash_log2_size, cfg.hash_n_features_per_level)
    table = (torch.rand(shape, generator=generator, dtype=torch.float32) * 2.0 - 1.0) * 1e-4
    return HashGridParams(table=table)


def _level_resolutions(cfg: NetworkConfig) -> tuple:
    return tuple(
        int(cfg.hash_base_resolution * (cfg.hash_per_level_scale ** level))
        for level in range(cfg.hash_n_levels)
    )


def _dense_levels(cfg: NetworkConfig) -> tuple:
    """tcnn grid semantics: a level whose full vertex grid (res+1)^3 fits the
    table is indexed directly by stride (no hash collisions at coarse
    levels); only levels that overflow the table hash."""
    size = 2 ** cfg.hash_log2_size
    return tuple((r + 1) ** 3 <= size for r in _level_resolutions(cfg))


def grid_spec(cfg: NetworkConfig) -> GridSpec:
    """The static shape the lookup and its kernels take."""
    return GridSpec(_level_resolutions(cfg), _dense_levels(cfg), cfg.hash_log2_size,
                    cfg.hash_n_features_per_level)


def _corner_index_weight_all_levels(pos: torch.Tensor, corner: int, cfg: NetworkConfig):
    """Table row (within its level) + trilinear weight of one voxel corner,
    all levels at once: pos [B, 3] -> (idx [B, L] int64, w [B, L] f32)."""
    return corner_index_weight(pos, corner, grid_spec(cfg))


def hash_grid_lookup(pos: torch.Tensor, params: HashGridParams, cfg: NetworkConfig) -> torch.Tensor:
    """Trilinear hash-grid features. pos: [..., 3] in roughly [0, 1]^3 ->
    [..., n_levels * n_features]; differentiable in the table (H1 forward,
    H2 backward on the card)."""
    lead = pos.shape[:-1]
    out = HashGridLookup.apply(pos.reshape(-1, 3), params.table, grid_spec(cfg))
    return out.reshape(*lead, out.shape[-1])


def encode_hash(query: torch.Tensor, params: HashGridParams, cfg: NetworkConfig) -> torch.Tensor:
    """Hash-path composite encoding: [.., 15] -> [.., 62]. Positions arrive
    pre-scaled by ``FrameConfig.position_scale`` (roughly [-0.05, 0.05] for
    Cornell); re-centered into [0, 1]^3 for the grid."""
    pos01 = query[..., POS] * 5.0 + 0.5
    grid = hash_grid_lookup(pos01, params, cfg)
    blob = one_blob(_normalized_blob_inputs(query), cfg.oneblob_n_bins)
    ident = query[..., 9:15]
    return torch.cat([grid, blob, ident], dim=-1)


def hash_encoded_dims(cfg: NetworkConfig) -> int:
    return cfg.hash_n_levels * cfg.hash_n_features_per_level + 6 * cfg.oneblob_n_bins + 6
