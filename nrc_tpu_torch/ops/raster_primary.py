"""Tiled primary visibility: the camera rays' first hit without the BVH walk.

Port of ``nrc_tpu/ops/raster_primary.py``. Camera rays share one origin and
their directions are a known function of the pixel grid, so at camera-set
time the host bins every triangle to the screen tiles its projection
(near-clipped, padded by ``PAD_PX`` for the subpixel jitter) overlaps, and
each frame resolves every tile's pixel rays against the tile's candidate
rows by dense Möller-Trumbore, the nearest valid triangle winning. The
candidate sets are conservative supersets and the per-pair test is the
walk's leaf test (``intersect_wide._leaf_tri_t``), so a pixel's t is the
walk's and its winner too, but between triangles at the same t.

``build_raster_bins`` is a copy of the JAX host code in numpy: the same
``meta``, ``pids``, ``perm`` and ``inv_perm`` (the JAX package's
``NRC_RASTER_TILE`` override is not kept). Tiles are sorted by candidate
count and padded in groups of power-of-two K, tile-major, each tile's
candidates in ascending triangle id. It also gives each slot the pixels of
its triangle's padded box inside the tile (``boxes``): a pixel's rays fall
in [x, x + 1), so a pixel outside the box is at least half a pixel from the
projection and is not tested, by the same margin that bins a triangle to a
tile. ``upload_raster`` makes the device side: the binned triangle rows
gathered from ``tris.packed`` on the device (K7), the slot ids and boxes,
and a small table of blocks, one row per chunk of ``CHUNK`` slots of a tile
(first slot, the chunk's real candidates, the tile's screen origin). Pad
slots (id -1) never hit and are never read.

On a CUDA tensor ``raster_closest_hit`` launches R1 (``ops/raster_cuda.py``,
``csrc/raster_primary.cu``) or raises; on a CPU tensor it runs
``raster_closest_hit_plain``, the port of ``_mt_tiles`` and
``raster_closest_hit`` with the JAX package's tile chunking and its pixel
permutation (here derived from the block table), pairs outside a slot's box
left out.

Scope, as in the JAX package: a pinhole lens, triangles, bins rebuilt when
the camera moves (``Renderer``), depth 0 of the render wavefront only.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .gather_cuda import gather_rows
from .intersect import RT_MAX
from .intersect_wide import _leaf_tri_t

# tile edges in pixels, the first that divides both dimensions wins (the JAX
# package's list, less its 32: a side that 32 divides 16 divides first)
TILES = (16, 24, 20, 12, 8)
PAD_PX = 1.5       # conservative projection pad (subpixel jitter + rounding)
NEAR_EPS = 1e-5
CHUNK = 128        # candidate slots a block of R1 takes: csrc/raster_primary.cu::kChunk


class RasterMeta(NamedTuple):
    """The bins' shape: part of the frame's graph key, so that a camera move
    that changes the group layout captures another graph."""

    group_k: Tuple[int, ...]      # K (padded candidate slots a tile) of each group
    group_tiles: Tuple[int, ...]  # tiles in each group
    width: int
    height: int
    tile: int                     # tile edge in pixels


class RasterData(NamedTuple):
    """The binned scene on the device, tile-major in the order of the groups."""

    rows: torch.Tensor    # [S, 9] f32 triangle rows p0 | e1 | e2 (rows of pad slots: triangle 0 or zeros)
    pids: torch.Tensor    # [S] i32 triangle ids, -1 in pad slots
    boxes: torch.Tensor   # [S] i32 the box's pixels in the tile: x0 | x1 << 8 | y0 << 16 | y1 << 24
    blocks: torch.Tensor  # [B, 4] i32: first slot, real candidates in the chunk, tile x0, y0

    def key(self) -> tuple:
        """What a captured frame depends on: the rows held (``room``)."""
        return self.pids.shape[0], self.blocks.shape[0]


def build_raster_bins(p0, p1, p2, cam_p, cam_u, cam_v, cam_w, width: int, height: int):
    """Host-side conservative binning (numpy). Returns (meta, pids, perm,
    inv_perm, boxes): the padded tile-major triangle ids [S] i32, the
    pixel-linear -> tile-major lane permutation and its inverse [W*H] i32,
    and each slot's box in its tile [S] i32 (``RasterData.boxes``; 0 in pad
    slots). None when no edge of ``TILES`` divides both dimensions, the
    camera basis is singular, or no triangle lands on the screen."""
    tile = next((t for t in TILES if width % t == 0 and height % t == 0), None)
    if tile is None:
        return None
    ntx, nty = width // tile, height // tile
    n_tiles = ntx * nty

    p0 = np.asarray(p0, np.float32)
    p1 = np.asarray(p1, np.float32)
    p2 = np.asarray(p2, np.float32)
    # ray(x, y) = normalize(sx*U + sy*V + W), sx = 2*(px+jx)/W - 1 (the
    # pinhole of scene/camera.py); a point Q projects through c = M^-1 (Q - P),
    # M = [U V W] as columns: sx = c0/c2, sy = c1/c2, in front when c2 > 0
    M = np.stack([np.asarray(cam_u), np.asarray(cam_v), np.asarray(cam_w)], axis=1).astype(np.float64)
    try:
        Minv = np.linalg.inv(M)
    except np.linalg.LinAlgError:
        return None

    def project(v):  # [T, 3] -> (sx, sy, cz)
        c = (v - np.asarray(cam_p)[None, :]) @ Minv.T
        return c[:, 0], c[:, 1], c[:, 2]

    sxs, sys_, czs = zip(*(project(v) for v in (p0, p1, p2)))
    sxs = np.stack(sxs, 1)    # [T, 3]
    sys_ = np.stack(sys_, 1)
    czs = np.stack(czs, 1)

    behind = czs <= NEAR_EPS
    # droppable only when at or behind the camera plane (cz <= 0 for all
    # vertices): a vertex in the (0, NEAR_EPS] slab still projects (to huge
    # clamped bounds), and the walk with tmin = 0 can hit it
    all_behind = (czs <= 0.0).all(axis=1)
    any_behind = behind.any(axis=1) & ~all_behind

    with np.errstate(divide="ignore", invalid="ignore"):
        px = (sxs / czs + 1.0) * 0.5 * width
        py = (sys_ / czs + 1.0) * 0.5 * height
    lo_x = px.min(axis=1) - PAD_PX
    hi_x = px.max(axis=1) + PAD_PX
    lo_y = py.min(axis=1) - PAD_PX
    hi_y = py.max(axis=1) + PAD_PX
    # conservative near clip: a straddling triangle's visible part projects
    # along its front vertices' directions, so each edge crossing the near
    # plane is clipped there and the clipped point extends the box
    if any_behind.any():
        idx = np.nonzero(any_behind)[0]
        for a in range(3):
            b = (a + 1) % 3
            za, zb = czs[idx, a], czs[idx, b]
            cross = (za <= NEAR_EPS) != (zb <= NEAR_EPS)
            if not cross.any():
                continue
            j = idx[cross]
            t = (NEAR_EPS - czs[j, a]) / (czs[j, b] - czs[j, a])
            cx = sxs[j, a] + t * (sxs[j, b] - sxs[j, a])
            cy = sys_[j, a] + t * (sys_[j, b] - sys_[j, a])
            qx = (cx / NEAR_EPS + 1.0) * 0.5 * width
            qy = (cy / NEAR_EPS + 1.0) * 0.5 * height
            # a point at the near plane projects far out: clamped to the screen
            lo_x[j] = np.minimum(lo_x[j], np.clip(qx, -1.0, width))
            hi_x[j] = np.maximum(hi_x[j], np.clip(qx, 0.0, width + 1.0))
            lo_y[j] = np.minimum(lo_y[j], np.clip(qy, -1.0, height))
            hi_y[j] = np.maximum(hi_y[j], np.clip(qy, 0.0, height + 1.0))
        # the front vertices' own projections, the behind ones masked out
        bx = np.where(behind, np.inf, px)
        by = np.where(behind, np.inf, py)
        lo_x[idx] = np.minimum(lo_x[idx], bx[idx].min(axis=1) - PAD_PX)
        lo_y[idx] = np.minimum(lo_y[idx], by[idx].min(axis=1) - PAD_PX)
        bx = np.where(behind, -np.inf, px)
        by = np.where(behind, -np.inf, py)
        hi_x[idx] = np.maximum(hi_x[idx], bx[idx].max(axis=1) + PAD_PX)
        hi_y[idx] = np.maximum(hi_y[idx], by[idx].max(axis=1) + PAD_PX)

    # a NaN bound (a vertex at the camera origin projects 0/0) would fail
    # every comparison and drop a hittable triangle: the whole screen instead
    bad = ~(np.isfinite(lo_x) & np.isfinite(hi_x) & np.isfinite(lo_y) & np.isfinite(hi_y))
    lo_x = np.where(bad, -1.0, lo_x)
    hi_x = np.where(bad, width + 1.0, hi_x)
    lo_y = np.where(bad, -1.0, lo_y)
    hi_y = np.where(bad, height + 1.0, hi_y)

    keep = ~all_behind
    tids = np.nonzero(keep)[0].astype(np.int64)
    lo_x, hi_x, lo_y, hi_y = (a[keep] for a in (lo_x, hi_x, lo_y, hi_y))
    tx0 = np.clip(np.floor(lo_x / tile), 0, ntx - 1).astype(np.int64)
    tx1 = np.clip(np.floor(hi_x / tile), 0, ntx - 1).astype(np.int64)
    ty0 = np.clip(np.floor(lo_y / tile), 0, nty - 1).astype(np.int64)
    ty1 = np.clip(np.floor(hi_y / tile), 0, nty - 1).astype(np.int64)
    on = (hi_x >= 0) & (lo_x <= width) & (hi_y >= 0) & (lo_y <= height)
    tids, tx0, tx1, ty0, ty1, lo_x, hi_x, lo_y, hi_y = (
        a[on] for a in (tids, tx0, tx1, ty0, ty1, lo_x, hi_x, lo_y, hi_y))
    # the pixels of the padded box (a pixel's rays fall in [x, x + 1))
    px0 = np.clip(np.floor(lo_x), 0, width - 1).astype(np.int64)
    px1 = np.clip(np.floor(hi_x), 0, width - 1).astype(np.int64)
    py0 = np.clip(np.floor(lo_y), 0, height - 1).astype(np.int64)
    py1 = np.clip(np.floor(hi_y), 0, height - 1).astype(np.int64)

    spans_x = tx1 - tx0 + 1
    spans_y = ty1 - ty0 + 1
    counts = spans_x * spans_y
    total = int(counts.sum())
    if total == 0:
        return None
    # the (triangle, tile) pairs
    rep = np.repeat(np.arange(tids.size), counts)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    ordinal = np.arange(total) - starts[rep]
    dx = ordinal % spans_x[rep]
    dy = ordinal // spans_x[rep]
    pair_tx = tx0[rep] + dx
    pair_ty = ty0[rep] + dy
    pair_tile = pair_ty * ntx + pair_tx
    pair_tri = tids[rep]
    # the box's pixels in the tile, one byte an edge
    edges = [np.clip(v[rep] - o * tile, 0, tile - 1) for v, o in
             ((px0, pair_tx), (px1, pair_tx), (py0, pair_ty), (py1, pair_ty))]
    pair_box = edges[0] | (edges[1] << 8) | (edges[2] << 16) | (edges[3] << 24)

    order = np.argsort(pair_tile, kind="stable")
    pair_tile = pair_tile[order]
    pair_tri = pair_tri[order]
    pair_box = pair_box[order]
    tile_counts = np.bincount(pair_tile, minlength=n_tiles)

    # tiles by candidate count into power-of-two K groups
    tile_order = np.argsort(tile_counts, kind="stable")
    ks = np.maximum(8, 2 ** np.ceil(np.log2(np.maximum(tile_counts[tile_order], 1))).astype(np.int64))
    group_k, group_tiles = [], []
    gstart = 0
    for i in range(1, n_tiles + 1):
        if i == n_tiles or ks[i] != ks[gstart]:
            group_k.append(int(ks[gstart]))
            group_tiles.append(i - gstart)
            gstart = i

    # the padded tile-major id array
    tile_starts = np.concatenate([[0], np.cumsum(tile_counts)[:-1]])
    S = int(np.sum(np.array(group_k) * np.array(group_tiles, dtype=np.int64)))
    pids = np.full((S,), -1, np.int32)
    boxes = np.zeros((S,), np.int32)
    out = 0
    ti = 0
    for k, gt in zip(group_k, group_tiles):
        for _ in range(gt):
            tl = int(tile_order[ti])
            c = int(tile_counts[tl])
            st = int(tile_starts[tl])
            pids[out:out + c] = pair_tri[st:st + c]
            boxes[out:out + c] = pair_box[st:st + c]
            out += k
            ti += 1

    # pixel-linear -> tile-major (tile_order's first tile first, row-major
    # within each tile)
    yy, xx = np.meshgrid(np.arange(height), np.arange(width), indexing="ij")
    pix_tile = (yy // tile) * ntx + (xx // tile)
    pix_lane = (yy % tile) * tile + (xx % tile)
    tile_rank = np.empty((n_tiles,), np.int64)
    tile_rank[tile_order] = np.arange(n_tiles)
    tm_index = tile_rank[pix_tile] * (tile * tile) + pix_lane
    perm = np.empty((width * height,), np.int64)
    perm[tm_index.reshape(-1)] = np.arange(width * height)
    inv_perm = tm_index.reshape(-1)

    meta = RasterMeta(group_k=tuple(group_k), group_tiles=tuple(group_tiles), width=width, height=height,
                      tile=tile)
    return meta, pids, perm.astype(np.int32), inv_perm.astype(np.int32), boxes


def _tile_k(meta: RasterMeta) -> np.ndarray:
    """K of every tile, in slot order."""
    return np.repeat(np.asarray(meta.group_k, np.int64), meta.group_tiles)


def _first_blocks(meta: RasterMeta) -> np.ndarray:
    """The index of every tile's first row in the block table."""
    per_tile = -(-_tile_k(meta) // CHUNK)
    return np.concatenate([[0], np.cumsum(per_tile)[:-1]])


def block_table(meta: RasterMeta, pids: np.ndarray, perm: np.ndarray) -> np.ndarray:
    """One row per chunk of ``CHUNK`` slots of each tile, tile by tile in
    slot order -> [B, 4] i32: first slot, the chunk's real candidates (0 for
    a chunk of pad slots alone), the tile's screen origin x0, y0."""
    ks = _tile_k(meta)
    slot0 = np.concatenate([[0], np.cumsum(ks)[:-1]])
    # a tile's real candidates fill the front of its slots
    real = np.add.reduceat((np.asarray(pids) >= 0).astype(np.int64), slot0)
    first_pixel = np.asarray(perm, np.int64)[np.arange(ks.size) * meta.tile * meta.tile]
    per_tile = -(-ks // CHUNK)
    tile_of = np.repeat(np.arange(ks.size), per_tile)
    chunk = np.arange(tile_of.size) - _first_blocks(meta)[tile_of]
    return np.stack([
        slot0[tile_of] + chunk * CHUNK,
        np.clip(real[tile_of] - chunk * CHUNK, 0, CHUNK),
        first_pixel[tile_of] % meta.width,
        first_pixel[tile_of] // meta.width,
    ], axis=1).astype(np.int32)


def raster_perm(meta: RasterMeta, blocks: torch.Tensor) -> torch.Tensor:
    """The pixel-linear index of every tile-major lane [W*H] i64 (the
    ``perm`` of ``build_raster_bins``), from the tiles' origins in the block
    table."""
    first = torch.as_tensor(_first_blocks(meta), device=blocks.device)
    origin = blocks[first, 2:4].to(torch.int64)
    lane = torch.arange(meta.tile * meta.tile, device=blocks.device)
    ly, lx = lane // meta.tile, lane % meta.tile
    return ((origin[:, 1:2] + ly) * meta.width + origin[:, 0:1] + lx).reshape(-1)


def room(n: int) -> int:
    """The rows held for ``n``: n and an eighth more, rounded up to m * 2^e
    with 8 <= m < 16, so that the bins of a moving camera, whose counts
    drift by a few percent, fit the tensors a captured frame reads."""
    need = n + n // 8 + 1
    step = 1 << max(0, need.bit_length() - 4)
    return -(-need // step) * step


def upload_raster(meta: RasterMeta, pids: np.ndarray, perm: np.ndarray, boxes: np.ndarray, packed: torch.Tensor,
                  held: Optional[RasterData] = None) -> RasterData:
    """The device side of the bins: the triangle rows gathered from the
    scene's resident ``tris.packed`` (one row gather a build, K7 on the card;
    the host sends ids, not duplicated geometry), the ids, boxes and the
    block table, each in tensors of ``room`` rows (pad slots: id -1; pad
    blocks: no candidates). Where ``held`` has the room, the bins are copied
    into its tensors and it is returned, so that a captured frame reads
    them; else new tensors are made."""
    dev = packed.device
    table = block_table(meta, pids, perm)
    slots, blocks = len(pids), len(table)
    if held is None or held.pids.shape[0] < slots or held.blocks.shape[0] < blocks:
        cap, bcap = room(slots), room(blocks)
        held = RasterData(
            rows=torch.zeros((cap, 9), dtype=torch.float32, device=dev),
            pids=torch.full((cap,), -1, dtype=torch.int32, device=dev),
            boxes=torch.zeros((cap,), dtype=torch.int32, device=dev),
            blocks=torch.zeros((bcap, 4), dtype=torch.int32, device=dev),
        )
    ids = torch.from_numpy(np.ascontiguousarray(pids, np.int32)).to(dev)
    held.rows[:slots].copy_(gather_rows(packed, torch.clamp(ids, min=0).to(torch.int64)))
    held.pids[:slots].copy_(ids)
    held.pids[slots:].fill_(-1)
    held.boxes[:slots].copy_(torch.from_numpy(np.ascontiguousarray(boxes, np.int32)))
    held.blocks[:blocks].copy_(torch.from_numpy(table))
    held.blocks[blocks:].zero_()
    return held


def _mt_tiles(rows, pids, boxes, org, direction, tile):
    """Dense Möller-Trumbore in (0, RT_MAX): rows [G, K, 9], pids and boxes
    [G, K], org/direction [G, L, 3] (L = tile², row-major) -> (t, prim)
    [G, L]. The walk's leaf test on [G, L, K], a pair tested only where the
    lane's pixel is in the slot's box; the first slot wins a tie in t
    (``argmin``), so the lowest triangle id, as a tile's candidates ascend."""
    lane = torch.arange(tile * tile, device=org.device)
    lx, ly = (lane % tile)[None, :, None], (lane // tile)[None, :, None]
    b = boxes[:, None, :]
    inside = (lx >= (b & 255)) & (lx <= ((b >> 8) & 255)) & (ly >= ((b >> 16) & 255)) & (ly <= (b >> 24))
    c = [rows[:, None, :, k] for k in range(9)]
    tmin = torch.zeros((1, 1), dtype=torch.float32, device=org.device)
    t = _leaf_tri_t(c, torch.where(inside, pids[:, None, :], -1), org, direction, tmin,
                    torch.full_like(tmin, RT_MAX))
    k_best = torch.argmin(t, dim=-1)
    t_best = t.gather(-1, k_best[..., None])[..., 0]
    hit = t_best < RT_MAX
    prim = pids.gather(1, k_best).to(torch.int64)
    return torch.where(hit, t_best, RT_MAX), torch.where(hit, prim, -1)


def raster_closest_hit_plain(meta: RasterMeta, rd: RasterData, org, direction):
    """The plain raster over the whole pixel grid: org/direction [W*H, 3]
    pixel-linear (the render wavefront's lanes) -> (t [W*H] f32, prim [W*H]
    i64; RT_MAX / -1 on a miss), hits in (0, RT_MAX), the range the frame
    asks of it. Groups and the chunking of their tiles (at most 2^24 pairs
    at a time) as ``nrc_tpu/ops/raster_primary.py::raster_closest_hit``."""
    n = meta.width * meta.height
    lanes = meta.tile * meta.tile
    perm = raster_perm(meta, rd.blocks)
    o = org[perm].view(-1, lanes, 3)
    d = direction[perm].view(-1, lanes, 3)
    t_parts, p_parts = [], []
    tile0 = slot0 = 0
    for k, gt in zip(meta.group_k, meta.group_tiles):
        rows = rd.rows[slot0:slot0 + gt * k].view(gt, k, 9)
        pids = rd.pids[slot0:slot0 + gt * k].view(gt, k)
        boxes = rd.boxes[slot0:slot0 + gt * k].view(gt, k)
        budget = max(1, (1 << 24) // (lanes * k))
        for a in range(0, gt, budget):
            g = slice(a, min(gt, a + budget))
            tiles = slice(tile0 + g.start, tile0 + g.stop)
            t, prim = _mt_tiles(rows[g], pids[g], boxes[g], o[tiles], d[tiles], meta.tile)
            t_parts.append(t)
            p_parts.append(prim)
        tile0 += gt
        slot0 += gt * k
    t_out = torch.empty((n,), dtype=torch.float32, device=org.device)
    prim_out = torch.empty((n,), dtype=torch.int64, device=org.device)
    t_out[perm] = torch.cat(t_parts).reshape(-1)
    prim_out[perm] = torch.cat(p_parts).reshape(-1)
    return t_out, prim_out


def raster_closest_hit(meta: RasterMeta, rd: RasterData, org, direction):
    """Every pixel's first hit in (0, RT_MAX), pixel-linear -> (t [W*H] f32,
    prim [W*H] i64): R1 on a CUDA tensor, the plain raster on a CPU one."""
    if org.device.type == "cuda":
        from .raster_cuda import raster_closest_cuda

        return raster_closest_cuda(meta, rd, org, direction)
    if org.device.type != "cpu":
        raise ValueError(f"unsupported device {org.device}")
    return raster_closest_hit_plain(meta, rd, org, direction)
