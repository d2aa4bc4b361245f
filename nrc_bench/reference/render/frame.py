"""The per-frame step: render, infer, accumulate, and train the cache.

The benchmark's reference: the parts of ``nrc_tpu_torch/render/frame.py``
that a frame is made of (the training rays, radiance propagation, the
batches, the accumulation weight), frozen, and ``sampled_frame``:
``frame_step`` in FULL + train for a set of pixels, without the primary
raster (depth 0 is traced like every other bounce, which gives the same
first hits). A pixel's
path depends on nothing but its index, the frame counters, the camera and
the scene, and its cache query is answered row by row, so the sample's
image equals those pixels of the whole frame; the training wavefront, the
batches and the four steps are the whole frame's.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import BATCH_SIZE, NUM_BATCHES, FrameConfig, NetworkConfig, RenderMode
from ..models import network as N
from ..scene.camera import generate_primary_rays
from ..utils import rng as R
from .integrator import trace_wavefront
from .scene_device import DeviceScene


class CameraArrays(NamedTuple):
    p: torch.Tensor
    u: torch.Tensor
    v: torch.Tensor
    w: torch.Tensor


def training_rays(cfg: FrameConfig, total_subframe: int, camera: CameraArrays,
                  train_unbiased_ratio: float, device: torch.device,
                  tile_rows: Optional[int] = None, row_offset: int = 0):
    """One training ray per screen tile (``isTrainingRay``,
    ``raygeneration.cu:123-136``): (org, dir, seeds, unbiased). The same
    pixel of every tile traces it, drawn per frame (host ``rand()`` in the
    reference, ``Device.cpp:2423-2428``; a TEA stream here). A band of the
    frame takes its ``tile_rows`` rows of tiles, their origins offset by the
    band's first row ``row_offset`` (``nrc_tpu/render/frame.py:89-98``)."""
    tsx, tsy = cfg.tile_size
    ntx, nty = cfg.num_tiles_xy
    nty = nty if tile_rows is None else tile_rows
    lin = torch.arange(ntx * nty, dtype=torch.int64, device=device)
    _, u = R.rng(R.tea(torch.full((), 0x9E3779B9, dtype=torch.int64, device=device), total_subframe))
    index = torch.clamp((u * (tsx * tsy)).to(torch.int64), max=tsx * tsy - 1)
    tpx = (lin % ntx) * tsx + index % tsx
    tpy = (lin // ntx) * tsy + index // tsx
    if row_offset:
        tpy = tpy + row_offset
    seeds = R.tea(tpy * cfg.width + tpx + 0x7F4A7C15, total_subframe)
    seeds, u_unbiased = R.rng(seeds)
    seeds, jitter = R.rng2(seeds)
    org, dirn = generate_primary_rays(
        torch.stack([tpx, tpy], dim=-1).to(torch.float32), jitter, (cfg.width, cfg.height),
        camera.p, camera.u, camera.v, camera.w, lens=cfg.lens_shader,
    )
    return org, dirn, seeds, u_unbiased < train_unbiased_ratio


def query_reflectance(q: torch.Tensor) -> torch.Tensor:
    """Diffuse + specular albedo of a radiance query
    (``RadianceQuery::reflectance``, ``neural_radiance_caching.h:117``)."""
    return q[..., 9:12] + q[..., 12:15]


def _safe_div(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a / (b + 1e-6)  # DENOMINATOR_EPSILON, config.h:55


def propagate_radiance(rec_target, rec_ltp, rec_count, end_radiance, end_mask):
    """Self-training radiance propagation (``propagate_train_radiance``,
    ``nrc_helpers.cu:131-224``): per training ray, walk the record slots from
    deep to shallow,

        target[i] += localThroughput[i] * L;  L = target[i]

    starting with L = cache(end_query) * end_mask. A ray's records are
    consecutive slots, so the reference's linked-list walk is a reverse scan
    over the D slots, parallel over the rays."""
    d = rec_target.shape[1]
    L = end_radiance * end_mask[:, None]
    slots = []
    for slot in range(d - 1, -1, -1):
        valid = (slot < rec_count)[:, None]
        new_t = rec_target[:, slot] + rec_ltp[:, slot] * L
        slots.append(torch.where(valid, new_t, rec_target[:, slot]))
        L = torch.where(valid, new_t, L)
    return torch.stack(slots[::-1], dim=1)


def assemble_training_batches(total_subframe: int, rec_query, rec_target, rec_count):
    """Compact the valid records and draw the frame's training batches.

    Replaces curand + cub radix sort + ``permute_train_data``
    (``NRCUtil.cu:7-35``, ``nrc_helpers.cu:226-249``). The compaction is the
    JAX package's: a prefix sum gives each valid record its row, a scatter
    drops the invalid ones. The shuffle takes NUM_BATCHES x BATCH_SIZE
    indices of a permutation modulo max(num_records, 1), so each record
    appears floor(65536/n) or ceil(65536/n) times.

    The permutation is the port's replacement for ``jax.random.permutation``,
    whose bits PyTorch cannot reproduce: a stable argsort of the bit-exact
    TEA keys ``tea(i, total_subframe ^ 0x5EED)``, i < 65536. It is the same
    on the card and on the CPU, so both draw the same batches, and it is
    made on the device, so nothing is copied from the host per frame.

    Returns (batch_q [NB, BS, 15], batch_t [NB, BS, 3], num_records i64).
    """
    t, d, qd = rec_query.shape
    cap = t * d
    dev = rec_query.device
    valid = (torch.arange(d, device=dev)[None, :] < rec_count[:, None]).reshape(cap)
    dest = torch.where(valid, torch.cumsum(valid.to(torch.int64), 0) - 1, cap)
    num_records = valid.sum()
    comp_q = torch.zeros((cap + 1, qd), dtype=rec_query.dtype, device=dev)
    comp_t = torch.zeros((cap + 1, 3), dtype=rec_target.dtype, device=dev)
    comp_q[dest] = rec_query.reshape(cap, qd)   # row cap takes the dropped records
    comp_t[dest] = rec_target.reshape(cap, 3)

    total = NUM_BATCHES * BATCH_SIZE
    keys = R.tea(torch.arange(total, dtype=torch.int64, device=dev), total_subframe ^ 0x5EED)
    perm = torch.sort(keys, stable=True).indices
    sel = perm % torch.clamp(num_records, min=1)
    return (comp_q[:cap][sel].view(NUM_BATCHES, BATCH_SIZE, qd),
            comp_t[:cap][sel].view(NUM_BATCHES, BATCH_SIZE, 3), num_records)


def accumulation_weight(iteration_index):
    """1 / (i + 1) in float32, the incremental mean's weight: a Python float
    for an int, a 0-d float32 tensor on the device for a tensor. The
    division is correctly rounded on both sides, so the two are bit-equal."""
    if isinstance(iteration_index, torch.Tensor):
        return 1.0 / (iteration_index.to(torch.float32) + 1.0)
    return float(np.float32(1.0) / (np.float32(iteration_index) + np.float32(1.0)))


class SampledFrame(NamedTuple):
    image: torch.Tensor        # [S, 3] the sampled pixels after the frame
    contrib: torch.Tensor      # [S, 3] the frame's own radiance at them
    weight: float              # the accumulation weight 1 / (iteration + 1)
    losses: torch.Tensor       # [NB] the training steps' losses
    num_records: torch.Tensor  # i64 scalar


@torch.no_grad()
def sampled_frame(
    scene: DeviceScene,
    net_state: N.NetworkState,
    image: torch.Tensor,       # [S, 3] the sampled pixels before the frame
    pixels: torch.Tensor,      # [S] i64 linear pixel indices (y * W + x)
    camera: CameraArrays,
    iteration_index: int,
    total_subframe: int,
    cfg: FrameConfig,
    net_cfg: NetworkConfig,
    learning_rate: float,
) -> SampledFrame:
    """``frame_step`` in FULL mode with training, for the pixels
    ``pixels``: their render wavefront, the whole training wavefront, one
    cache inference over both, the accumulation, then radiance propagation,
    the batches and the four steps, which train ``net_state`` in place."""
    if cfg.render_mode != RenderMode.FULL or not cfg.train:
        raise NotImplementedError("the sampled frame is FULL + train")
    dev = image.device
    n_pixels = pixels.shape[0]
    pix = torch.stack([pixels % cfg.width, pixels // cfg.width], dim=-1).to(torch.float32)
    seeds = R.tea(pixels, total_subframe)
    seeds, jitter = R.rng2(seeds)
    org, dirn = generate_primary_rays(
        pix, jitter, (cfg.width, cfg.height), camera.p, camera.u, camera.v, camera.w,
        lens=cfg.lens_shader,
    )
    out = trace_wavefront(scene, org, dirn, seeds, cfg)
    t_org, t_dir, t_seeds, unbiased = training_rays(cfg, total_subframe, camera, cfg.train_unbiased_ratio, dev)
    train_out = trace_wavefront(scene, t_org, t_dir, t_seeds, cfg, train=True, unbiased=unbiased)
    all_q = torch.cat([out.render_query, train_out.end_query])
    cache = N.infer(net_state, all_q, net_cfg)
    if cfg.reflectance_factoring:
        cache = cache * query_reflectance(all_q)
    contrib = out.radiance + out.last_render_throughput * cache[:n_pixels]
    w_acc = accumulation_weight(iteration_index)
    new_image = image + (contrib - image) * w_acc
    targets = propagate_radiance(
        train_out.rec_target, train_out.rec_ltp, train_out.rec_count, cache[n_pixels:], train_out.end_mask
    )
    if cfg.reflectance_factoring:
        targets = _safe_div(targets, query_reflectance(train_out.rec_query))
    batch_q, batch_t, num_records = assemble_training_batches(
        total_subframe, train_out.rec_query, targets, train_out.rec_count
    )
    lr = torch.tensor(learning_rate, dtype=torch.float32, device=dev)
    losses = N.train_frame(net_state, batch_q, batch_t, num_records, net_cfg, lr)
    return SampledFrame(new_image, contrib, w_acc, losses, num_records)
