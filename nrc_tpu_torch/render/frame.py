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

With ``spans`` (a ``utils/spans.py::SpanRecorder`` whose frame is open) the
step stamps the start of each phase on the device: ``frame.primary`` (the
camera rays and the primary raster), ``frame.render_wavefront``,
``frame.train_wavefront`` (the training rays and their wavefront),
``frame.inference`` (the queries' concatenation and the cache),
``frame.accumulate`` and ``frame.train`` (propagation, batches and the
steps); ``trace_wavefront`` stamps each bounce. The stamps change no result.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import BATCH_SIZE, NUM_BATCHES, FrameConfig, NetworkConfig, RenderMode
from ..models import network as N
from ..ops.intersect import hit_from_t_prim
from ..ops.raster_primary import RasterData, RasterMeta, raster_closest_hit
from ..scene.camera import LENS_PINHOLE, generate_primary_rays
from ..utils import rng as R
from ..utils.tonemap import time_view_ramp
from .integrator import trace_wavefront
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


def pixel_grid(cfg: FrameConfig, device: torch.device, rows: Optional[int] = None, row_offset: int = 0):
    """Pixel coordinates [rows*W, 2] f32 and linear indices [rows*W] (the RNG
    stream id of each pixel) of ``rows`` image rows from ``row_offset`` (the
    whole image by default). A band of the frame takes the rays the whole
    frame gives its pixels: the offset enters the global pixel index that
    seeds their streams (``nrc_tpu/render/frame.py:70-86``)."""
    rows = cfg.height if rows is None else rows
    lin = torch.arange(rows * cfg.width, dtype=torch.int64, device=device)
    ys = lin // cfg.width
    if row_offset:
        ys = ys + row_offset
    xs = lin % cfg.width
    return torch.stack([xs, ys], dim=-1).to(torch.float32), ys * cfg.width + xs


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
    grad_reduce=None,
    count_reduce=None,
    grid_grad_reduce=None,
    shard_rows: Optional[int] = None,
    row_offset: int = 0,
    raster_meta: Optional[RasterMeta] = None,
    raster_data: Optional[RasterData] = None,
    spans=None,
) -> tuple[torch.Tensor, FrameStats]:
    """One frame (1 spp). Returns (image', stats); with ``cfg.train`` the
    network state is trained in place.

    With ``shard_rows`` and ``row_offset`` the step renders the horizontal
    band of ``shard_rows`` rows from ``row_offset`` (``image`` is then the
    band's [shard_rows*W, 3]) and trains on the band's records: the body of
    one rank of ``parallel/shard.py::sharded_frame_step``
    (``nrc_tpu/render/frame.py:165-190``). ``grad_reduce`` (the weights'
    gradients), ``grid_grad_reduce`` (the hash table's, ``grad_reduce`` by
    default) and ``count_reduce`` (the record count) reduce across the
    ranks: each step's gradient is taken with the loss scaled by whether
    the band has records, reduced, then applied; the steps run on every
    rank and their result is kept where the reduced count is above 0, a
    select on the device, so that the ranks stay in step.

    With ``raster_meta`` and ``raster_data`` (the bins of the current camera,
    ``Renderer``) the render wavefront's first hits come from the primary
    raster instead of the walk (``nrc_tpu/render/frame.py:213-224``): for
    the whole frame and a pinhole lens only; a band, and the training
    wavefront, walk."""
    mode = cfg.render_mode
    dev = image.device
    rows = cfg.height if shard_rows is None else shard_rows
    n_pixels = cfg.width * rows
    tile_rows = None if shard_rows is None else shard_rows // cfg.tile_size[1]
    n_tiles = cfg.num_tiles if shard_rows is None else cfg.num_tiles_xy[0] * tile_rows

    if spans is not None:
        spans.stamp("frame.primary")
    pix, pidx = pixel_grid(cfg, dev, shard_rows, row_offset)
    seeds = R.tea(pidx, total_subframe)
    seeds, jitter = R.rng2(seeds)
    org, dirn = generate_primary_rays(
        pix, jitter, (cfg.width, cfg.height), camera.p, camera.u, camera.v, camera.w,
        lens=cfg.lens_shader,
    )
    primary_hit = None
    if raster_meta is not None and shard_rows is None and cfg.lens_shader == LENS_PINHOLE:
        t0, prim0 = raster_closest_hit(raster_meta, raster_data, org, dirn)
        primary_hit = hit_from_t_prim(org, dirn, scene.tris, t0, prim0)
    if spans is not None:
        spans.stamp("frame.render_wavefront")
    out = trace_wavefront(scene, org, dirn, seeds, cfg, primary_hit=primary_hit, spans=spans)
    traced_rays = out.traced_count.sum()
    train_out = None
    if cfg.train:
        if spans is not None:
            spans.stamp("frame.train_wavefront")
        t_org, t_dir, t_seeds, unbiased = training_rays(
            cfg, total_subframe, camera, cfg.train_unbiased_ratio, dev, tile_rows, row_offset
        )
        train_out = trace_wavefront(scene, t_org, t_dir, t_seeds, cfg, train=True, unbiased=unbiased,
                                    spans=spans)
        traced_rays = traced_rays + train_out.traced_count.sum()

    # ---- one cache inference over [render ; training ends ; cache-vis] ------
    if spans is not None:
        spans.stamp("frame.inference")
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
        cache_end = cache[ofs:ofs + n_tiles]
        ofs += n_tiles

    # ---- accumulate into the image ---------------------------------------
    if spans is not None:
        spans.stamp("frame.accumulate")
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
    if spans is not None:
        spans.stamp("frame.train")
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
    if grad_reduce is None:
        losses = N.train_frame(net_state, batch_q, batch_t, num_records, net_cfg, learning_rate)
    else:
        # the train branch decides on the reduced count, on the device
        total = num_records if count_reduce is None else count_reduce(num_records)
        losses = N.train_frame(net_state, batch_q, batch_t, total, net_cfg,
                               learning_rate, grad_reduce=grad_reduce, grid_grad_reduce=grid_grad_reduce,
                               loss_scale=(num_records > 0).to(torch.float32))
    return image, FrameStats(losses.mean(), num_records, traced_rays)
