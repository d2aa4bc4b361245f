"""The per-frame step: render, infer, accumulate, and train the cache.

Port of ``nrc_tpu/render/frame.py:110-398`` (reference ``Device::render``,
``nrc/src/Device.cpp:2292-2517``): primary rays for every pixel and the
render wavefront; with ``cfg.train`` one training ray per screen tile and the
training wavefront; one cache inference over the render queries and the
training rays' end queries together (``Device::nrcInferRadiance``,
``Device.cpp:1272-1308``); the mode-dependent accumulation
(``accumulate_render_radiance``, ``nrc_helpers.cu:77-129``) with the
incremental mean of ``raygeneration.cu:406-411``; then radiance propagation,
batch assembly and the four Adam + EMA steps (``Device::nrcTrainRadiance``,
``Device.cpp:1473-1513``).

The counters ``iteration_index`` and ``total_subframe`` come as 0-d int64
tensors on the frame's device (``Renderer``) or as Python ints (direct
calls). On the card a frame reads nothing back to the host and copies
nothing to it: the bounce loop runs every bounce (``integrator._all_done``),
the record count, the loss and the training skip on a frame without records
stay on the device (K6 reads the count; the hash encoding's four
``train_step``s are followed by a select of the old state where the count is
0, ``network.train_frame``), and the accumulation weight is computed there. So ``Renderer`` can capture it as one CUDA graph. On the
CPU the bounce loop still stops when no ray is alive, a read per bounce.
The only reads of a frame's results are ``Renderer``'s non-blocking copies
of the loss and the record count, outside the graph.

With ``cfg.reflectance_factoring`` the cache learns radiance over the
query's reflectance (diffuse + specular albedo): every cache output is
scaled by its own query's reflectance, and the training targets are
divided by their record's before the batches are drawn
(``nrc_tpu/render/frame.py:100-107,275-279,345-350``).
``DEBUG_TIME_VIEW`` shows each pixel's surface hits over ``max_depth``
through the cold-to-hot ramp, the running maximum over the accumulation.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import BATCH_SIZE, NUM_BATCHES, FrameConfig, NetworkConfig, RenderMode
from ..models import network as N
from ..scene.camera import generate_primary_rays
from ..utils import rng as R
from ..utils.tonemap import time_view_ramp
from .integrator import check_frame_config, trace_wavefront
from .scene_device import DeviceScene


class FrameStats(NamedTuple):
    loss: torch.Tensor               # f32 scalar: mean of the step losses (0 without training)
    num_train_records: torch.Tensor  # i64 scalar: records written this frame
    # rays actually cast this frame (closest-hit segments of live lanes +
    # shadow rays with a valid light sample, both wavefronts) — the Mrays/s
    # numerator
    traced_rays: torch.Tensor        # i64 scalar


class CameraArrays(NamedTuple):
    p: torch.Tensor
    u: torch.Tensor
    v: torch.Tensor
    w: torch.Tensor


def pixel_grid(cfg: FrameConfig, device: torch.device):
    """Pixel coordinates [H*W, 2] f32 and linear indices [H*W] (the RNG
    stream id of each pixel)."""
    lin = torch.arange(cfg.height * cfg.width, dtype=torch.int64, device=device)
    ys = lin // cfg.width
    xs = lin % cfg.width
    return torch.stack([xs, ys], dim=-1).to(torch.float32), ys * cfg.width + xs


def training_rays(cfg: FrameConfig, total_subframe: int, camera: CameraArrays,
                  train_unbiased_ratio: float, device: torch.device):
    """One training ray per screen tile (``isTrainingRay``,
    ``raygeneration.cu:123-136``): (org, dir, seeds, unbiased). The same
    pixel of every tile traces it, drawn per frame (host ``rand()`` in the
    reference, ``Device.cpp:2423-2428``; a TEA stream here)."""
    tsx, tsy = cfg.tile_size
    ntx, nty = cfg.num_tiles_xy
    lin = torch.arange(ntx * nty, dtype=torch.int64, device=device)
    _, u = R.rng(R.tea(torch.full((), 0x9E3779B9, dtype=torch.int64, device=device), total_subframe))
    index = torch.clamp((u * (tsx * tsy)).to(torch.int64), max=tsx * tsy - 1)
    tpx = (lin % ntx) * tsx + index % tsx
    tpy = (lin // ntx) * tsy + index // tsx
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


def frame_step(
    scene: DeviceScene,
    net_state: N.NetworkState,
    image: torch.Tensor,          # [H*W, 3] accumulated HDR
    camera: CameraArrays,
    iteration_index,              # accumulation index (resets on camera move): int or i64 0-d tensor
    total_subframe,               # ever-increasing (RNG stream): int or i64 0-d tensor
    cfg: FrameConfig,
    net_cfg: NetworkConfig,
    learning_rate: Optional[torch.Tensor] = None,  # f32 scalar on the device
) -> tuple[torch.Tensor, FrameStats]:
    """One frame (1 spp). Returns (image', stats); with ``cfg.train`` the
    network state is trained in place."""
    check_frame_config(cfg)
    mode = cfg.render_mode
    dev = image.device
    n_pixels = cfg.num_pixels

    pix, pidx = pixel_grid(cfg, dev)
    seeds = R.tea(pidx, total_subframe)
    seeds, jitter = R.rng2(seeds)
    org, dirn = generate_primary_rays(
        pix, jitter, (cfg.width, cfg.height), camera.p, camera.u, camera.v, camera.w,
        lens=cfg.lens_shader,
    )
    out = trace_wavefront(scene, org, dirn, seeds, cfg)
    traced_rays = out.traced_count.sum()
    train_out = None
    if cfg.train:
        t_org, t_dir, t_seeds, unbiased = training_rays(
            cfg, total_subframe, camera, cfg.train_unbiased_ratio, dev
        )
        train_out = trace_wavefront(scene, t_org, t_dir, t_seeds, cfg, train=True, unbiased=unbiased)
        traced_rays = traced_rays + train_out.traced_count.sum()

    # ---- one cache inference over [render ; training ends ; cache-vis] ------
    render_cache = mode in (RenderMode.FULL, RenderMode.CACHE_ONLY,
                            RenderMode.DEBUG_CACHE_NO_THROUGHPUT_MODULATION)
    queries = []
    if render_cache:
        queries.append(out.render_query)
    if cfg.train:
        queries.append(train_out.end_query)
    if mode == RenderMode.CACHE_FIRST_VERTEX:
        queries.append(out.cache_vis_query)
    cache = None
    if queries:
        all_q = torch.cat(queries) if len(queries) > 1 else queries[0]
        cache = N.infer(net_state, all_q, net_cfg)
        if cfg.reflectance_factoring:
            # the cache predicts radiance / reflectance: every consumption
            # (render end, suffix end, cache-vis) takes its own query's
            # reflectance back (nrc_helpers.cu:68-69,95-96,156-159)
            cache = cache * query_reflectance(all_q)
    ofs = n_pixels if render_cache else 0
    if cfg.train:
        cache_end = cache[ofs:ofs + cfg.num_tiles]
        ofs += cfg.num_tiles

    # ---- accumulate into the image ---------------------------------------
    w_acc = accumulation_weight(iteration_index)
    if mode == RenderMode.FULL:
        contrib = out.radiance + out.last_render_throughput * cache[:n_pixels]
        image = image + (contrib - image) * w_acc
    elif mode == RenderMode.NO_CACHE:
        image = image + (out.radiance - image) * w_acc
    elif mode == RenderMode.CACHE_ONLY:
        image = out.last_render_throughput * cache[:n_pixels]
    elif mode == RenderMode.CACHE_FIRST_VERTEX:
        image = cache[ofs:ofs + n_pixels]
    elif mode == RenderMode.DEBUG_CACHE_NO_THROUGHPUT_MODULATION:
        image = cache[:n_pixels]
    elif mode == RenderMode.DEBUG_THROUGHPUT_ONLY:
        image = out.last_render_throughput
    elif mode == RenderMode.DEBUG_TIME_VIEW:
        # each pixel's work events through the cold-to-hot ramp (the analog
        # of USE_TIME_VIEW's clock view, raygeneration.cu:392-404), latched
        # as a running maximum over the accumulation
        heat = time_view_ramp(out.bounce_count.to(torch.float32) / float(cfg.max_depth))
        image = torch.maximum(image, heat)

    # ---- training ----------------------------------------------------------
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    if not cfg.train:
        return image, FrameStats(zero.float(), zero, traced_rays)
    targets = propagate_radiance(
        train_out.rec_target, train_out.rec_ltp, train_out.rec_count, cache_end, train_out.end_mask
    )
    if cfg.reflectance_factoring:
        # propagation ran in radiance; the network trains on radiance over
        # each record's reflectance (nrc_helpers.cu:187-207)
        targets = _safe_div(targets, query_reflectance(train_out.rec_query))
    batch_q, batch_t, num_records = assemble_training_batches(
        total_subframe, train_out.rec_query, targets, train_out.rec_count
    )
    if learning_rate is None:
        learning_rate = torch.tensor(net_cfg.learning_rate, dtype=torch.float32, device=dev)
    losses = N.train_frame(net_state, batch_q, batch_t, num_records, net_cfg, learning_rate)
    return image, FrameStats(losses.mean(), num_records, traced_rays)
