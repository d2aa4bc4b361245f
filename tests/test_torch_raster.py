"""Port parity: the tiled primary raster (``ops/raster_primary.py``) against
the JAX package's ``nrc_tpu/ops/raster_primary.py``, against the port's own
walk, a model of R1's work split, and whole frames of a scene above
16,384 triangles with the raster on and off.

The JAX side of the bins and of the raster runs in a child process
(``tests/test_torch_jax_child.py::run_jax_side``), one call for the four
triangle soups: the three cases of ``tests/test_raster.py:66-100`` (a soup
in front of the camera, the camera inside a soup past the near plane, a
40x24 screen that takes 8-pixel tiles) and a soup with two vertices at the
camera's origin (their projection is 0/0: ``build_raster_bins`` bins them
over the whole screen). The child also makes the camera rays, so both sides
test the same rays.

Bounds. The bins are integer arrays: equal. The plain raster and JAX's
``raster_closest_hit`` take the same triangle test in the same operation
order; XLA:CPU may contract its multiply-adds into FMAs, so the bound is the
one ``tests/test_torch_intersect.py`` gives the plain K1 against the JAX
kernel: the same winners, t within 1e-6 relative and absolute (both read
bit for bit on these soups). Against the port's own walk
(``wide_traverse_plain``, the same leaf test): t bit for bit on every ray,
and the winners equal but where two triangles give the same t; each such
ray is counted with its witness: the raster's winner has the lower id (it
keeps the first of equal t) and the walk's triangle gives the same t.

The frames: ``cornell_objects`` with its two objects tessellated 64 x 64
(17,584 triangles, above the JAX renderer's threshold of 16,384, so both
packages build the 16-wide BVH and walk; 32x32 takes 16-pixel tiles),
FULL + train with 8x8 tiles, two frames, raster on and raster off on both
sides, the port trained on the JAX frame's batches from the JAX weights, as
``tests/test_torch_wide_slice.py`` does, under
``test_torch_train_slice.SLICE_LIMITS``. The depth-0 raster calls are
logged on both sides as closest-hit calls, so a ray whose first triangle
flips counts as flipped. The JAX frame runs no Pallas kernel (the walk and
the raster are XLA code), so it runs in this process, as the wide slice's.
"""

import contextlib
import dataclasses
import re
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

import nrc_tpu.ops.raster_primary as jax_raster
import nrc_tpu.render.frame as jax_frame
import nrc_tpu.render.integrator as jax_integrator
import nrc_tpu_torch.render.frame as port_frame
import nrc_tpu_torch.render.integrator as port_integrator
import nrc_tpu_torch.scene.scene_builder as SB
from nrc_tpu.render.renderer import Renderer as JRenderer
from nrc_tpu.scene.camera import Camera as JCamera
from nrc_tpu.scene.materials import Material as JMaterial
from nrc_tpu.scene.materials import MaterialTable as JMaterialTable
from nrc_tpu.scene.scene_builder import Scene as JScene
from nrc_tpu.scene.scene_builder import _build_lights as jax_build_lights
from nrc_tpu_torch.config import RenderMode
from nrc_tpu_torch.models import network as N
from nrc_tpu_torch.ops import raster_cuda as RC
from nrc_tpu_torch.ops import raster_primary as RP
from nrc_tpu_torch.ops.bvh_wide import build_wide_bvh
from nrc_tpu_torch.ops.intersect import RT_MAX, TriSoA
from nrc_tpu_torch.ops.intersect_wide import _leaf_tri_t, upload_wide_bvh, wide_traverse_plain
from nrc_tpu_torch.parallel.shard import ParallelRenderer, init_data_group
from nrc_tpu_torch.render.renderer import Renderer, frame_key
from nrc_tpu_torch.scene.camera import generate_primary_rays
from nrc_tpu_torch.scene.scene_builder import cornell_box
from test_torch_bvh import align_builders
from test_torch_compact import checked_at_full_width
from test_torch_intersect import one_torch_thread  # noqa: F401 (an autouse fixture)
from test_torch_jax_child import run_jax_side
from test_torch_slice import _LOG, _jax_log, _recording_port_intersectors
from test_torch_train_slice import (
    SLICE_LIMITS,
    _port_assemble_with_jax_batches,
    _recording_jax_assemble,
    train_frame_readings,
)
from test_torch_wide_slice import _walking_jax_intersectors

SOURCE = (Path(__file__).resolve().parents[1] / "nrc_tpu_torch" / "csrc" / "raster_primary.cu").read_text()


def _soup(T, seed, spread=0.3, lo=-2.0, hi=2.0):
    rng = np.random.default_rng(seed)
    p0 = rng.uniform(lo, hi, (T, 3)).astype(np.float32)
    p1 = p0 + rng.uniform(-spread, spread, (T, 3)).astype(np.float32)
    p2 = p0 + rng.uniform(-spread, spread, (T, 3)).astype(np.float32)
    return p0, p1, p2


def _f32(*v):
    return np.array(v, np.float32)


def _case(name):
    """(triangles, camera P U V W, width, height, jitter seed) of a case."""
    front = (_f32(0, 0, 6), _f32(1.2, 0, 0), _f32(0, 0.9, 0.1), _f32(0, 0, -1))
    if name == "front":
        return _soup(4000, 3), front, 64, 48, 4
    if name == "inside":
        cam = (_f32(0.1, -0.2, 0.05), _f32(1.3, 0.1, 0), _f32(0, 1, 0), _f32(0.2, 0, -1))
        return _soup(6000, 7, spread=0.8, lo=-3.0, hi=3.0), cam, 80, 64, 8
    if name == "tile8":
        return _soup(2000, 11), (front[0], front[1], _f32(0, 0.9, 0), front[3]), 40, 24, 12
    assert name == "origin_vertex"
    p0, p1, p2 = _soup(3000, 21)
    p0[0] = front[0]  # a vertex at the camera's origin
    p2[7] = front[0]
    return (p0, p1, p2), front, 64, 48, 22


CASES = ("front", "inside", "tile8", "origin_vertex")


def _jax_raster_cases(**unused):
    """The child's side: JAX's bins, camera rays and raster for every case."""
    import jax.numpy as jnp

    from nrc_tpu.ops.intersect import TriSoA as JTriSoA
    from nrc_tpu.scene.camera import generate_primary_rays

    out = {}
    for name in CASES:
        (p0, p1, p2), cam, w, h, seed = _case(name)
        meta, pids, perm, inv_perm = jax_raster.build_raster_bins(p0, p1, p2, *cam, w, h)
        lin = np.arange(w * h)
        pix = np.stack([lin % w, lin // w], -1).astype(np.float32)
        jitter = np.random.default_rng(seed).uniform(0, 1, (w * h, 2)).astype(np.float32)
        org, d = generate_primary_rays(jnp.asarray(pix), jnp.asarray(jitter), (w, h), *map(jnp.asarray, cam))
        tris = JTriSoA.build(p0, p1, p2)
        ids = jnp.asarray(pids)
        rd = jax_raster.RasterData(rows=tris.packed[jnp.maximum(ids, 0)], pids=ids, perm=jnp.asarray(perm),
                                   inv_perm=jnp.asarray(inv_perm))
        t, prim = jax_raster.raster_closest_hit(meta, rd, org, d, jnp.zeros(w * h), jnp.full((w * h,), RT_MAX))
        for key, value in dict(group_k=meta.group_k, group_tiles=meta.group_tiles, tile=meta.tile, pids=pids,
                               perm=perm, inv_perm=inv_perm, org=org, dir=d, t=t, prim=prim).items():
            out[f"{name}.{key}"] = np.asarray(value)
    return out


@pytest.fixture(scope="module")
def jax_cases(tmp_path_factory):
    return run_jax_side("test_torch_raster:_jax_raster_cases", tmp_path_factory.mktemp("raster"))


@pytest.fixture(scope="module")
def port_cases(jax_cases):
    """name -> (meta, host arrays, RasterData, rays) of the port on the JAX rays."""
    out = {}
    for name in CASES:
        (p0, p1, p2), cam, w, h, _ = _case(name)
        built = RP.build_raster_bins(p0, p1, p2, *cam, w, h)
        assert built is not None
        meta, pids, perm, inv_perm, boxes = built
        rd = RP.upload_raster(meta, pids, perm, boxes, TriSoA.build(p0, p1, p2).packed)
        rays = tuple(torch.from_numpy(jax_cases[f"{name}.{k}"].copy()) for k in ("org", "dir"))
        out[name] = meta, (pids, perm, inv_perm, boxes), rd, rays
    return out


def _limits(n):
    return torch.zeros(n), torch.full((n,), RT_MAX)


@pytest.mark.parametrize("name", CASES)
def test_bins_equal_jax(jax_cases, port_cases, name):
    meta, arrays, rd, _ = port_cases[name]
    assert meta.group_k == tuple(jax_cases[f"{name}.group_k"].tolist())
    assert meta.group_tiles == tuple(jax_cases[f"{name}.group_tiles"].tolist())
    assert meta.tile == int(jax_cases[f"{name}.tile"]) == (8 if name == "tile8" else 16)
    for key, got in zip(("pids", "perm", "inv_perm"), arrays[:3]):
        want = jax_cases[f"{name}.{key}"]
        assert got.dtype == want.dtype and np.array_equal(got, want), key
    # the block table's origins give the same permutation
    assert torch.equal(RP.raster_perm(meta, rd.blocks), torch.from_numpy(arrays[1].astype(np.int64)))
    # a box in every real slot, inside its tile; none in a pad slot
    pids, boxes = arrays[0], arrays[3].astype(np.int64)
    edges = [(boxes >> s) & 255 for s in (0, 8, 16, 24)]
    assert not boxes[pids < 0].any() and all(int(e.max()) < meta.tile for e in edges)
    assert ((edges[0] <= edges[1]) & (edges[2] <= edges[3]))[pids >= 0].all()
    if name == "origin_vertex":
        # the triangles through the camera's origin are binned to every tile
        for tri in (0, 7):
            assert sum(int((rd.pids[s:s + k] == tri).any()) for s, k in _tile_slots(meta)) == len(_tile_slots(meta))


def _tile_slots(meta):
    """(first slot, K) of every tile in slot order."""
    out, slot = [], 0
    for k, gt in zip(meta.group_k, meta.group_tiles):
        for _ in range(gt):
            out.append((slot, k))
            slot += k
    return out


@pytest.mark.parametrize("name", CASES)
def test_plain_raster_matches_jax(jax_cases, port_cases, name):
    meta, _, rd, (org, d) = port_cases[name]
    t, prim = RP.raster_closest_hit_plain(meta, rd, org, d)
    t_j, prim_j = jax_cases[f"{name}.t"], jax_cases[f"{name}.prim"]
    assert prim.dtype == torch.int64 and (prim_j >= 0).mean() > 0.05
    np.testing.assert_array_equal(prim.numpy(), prim_j)
    np.testing.assert_allclose(t.numpy(), t_j, rtol=1e-6, atol=1e-6)
    assert bool((t[prim < 0] == RT_MAX).all())
    # the dispatcher's CPU path is the plain raster
    t2, prim2 = RP.raster_closest_hit(meta, rd, org, d)
    assert torch.equal(prim2, prim) and torch.equal(t2, t)


@pytest.mark.parametrize("name", CASES)
def test_plain_raster_matches_own_walk(port_cases, name):
    """t bit for bit, winners equal but at equal-t ties, each with its witness."""
    (p0, p1, p2), *_ = _case(name)
    meta, _, rd, (org, d) = port_cases[name]
    n = org.shape[0]
    t, prim = RP.raster_closest_hit_plain(meta, rd, org, d)
    bvh = upload_wide_bvh(build_wide_bvh(p0, p1, p2, branch=16, leaf_size=16), "cpu")
    t_w, prim_w, _ = wide_traverse_plain(org, d, bvh, *_limits(n), any_hit=False)
    assert torch.equal(t, t_w) and torch.equal(prim >= 0, prim_w >= 0)
    ties = torch.nonzero(prim != prim_w)[:, 0]
    assert ties.numel() <= 0.01 * n, ties.numel()
    if ties.numel():
        assert bool((prim[ties] < prim_w[ties]).all())  # the raster keeps the lower id
        rows = TriSoA.build(p0, p1, p2).packed[prim_w[ties]]
        witness = _leaf_tri_t([rows[:, k:k + 1] for k in range(9)], prim_w[ties][:, None], org[ties], d[ties],
                              *_limits(ties.numel()))[:, 0]
        assert torch.equal(witness, t[ties])


def _source_const(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE).group(1))


def test_kernel_constants():
    """The wrapper's and the block table's constants are the kernel's, and
    the largest tile the bins take is the kernel's largest."""
    assert RP.CHUNK == _source_const("kChunk")
    assert RC.MAX_TILE == _source_const("kMaxTile") == max(RP.TILES)
    assert RC.MAX_TILE ** 2 == _source_const("kMaxThreads")


def block_threads(tile):
    """R1's threads a block: a thread a pixel of the tile for the staging,
    rounded up to whole warps (``block_threads`` of the source)."""
    return -(-tile * tile // 32) * 32


def test_kernel_threads_and_lines():
    """For every tile edge the bins take, a whole number of warps of at most
    the kernel's threads; the lines the model copies are the source's."""
    for tile in RP.TILES:
        assert block_threads(tile) % 32 == 0 and tile * tile <= block_threads(tile) <= _source_const("kMaxThreads")
    flat = " ".join(SOURCE.split())
    for line in ("return (tile * tile + 31) / 32 * 32;",
                 "area[e] = i < n ? box_area(s_box[i]) : 0;",
                 "if (s_off[mid] <= p) { lo = mid; } else { hi = mid - 1; }",
                 "const int q = p - s_off[k];",
                 "const int l = (static_cast<int>((box >> 16) & 255u) + q / w) * tile + x0 + q % w;",
                 "const int pix = (b.w + tid / tile) * width + b.z + tid % tile;",
                 "if (tid < pixels && s_best[tid] != kEmpty) atomicMin(best + pix, s_best[tid]);"):
        assert line in flat, line


def _box_holds(box, x, y):
    """Whether the pixel (x, y) of the tile is in the box (``RasterData.boxes``)."""
    return (x >= (box & 255)) & (x <= ((box >> 8) & 255)) & (y >= ((box >> 16) & 255)) & (y <= (box >> 24))


def r1_model(meta, rd, org, d):
    """R1 as its source computes it, block by block of the table: the
    block's pairs numbered candidate by candidate over the pixels of each
    box (the exclusive scan of the areas), each pair's candidate found by
    the last offset at or before it and its pixel decoded from the box,
    every pair tested once, a pixel's hits met by a min over (bits of t)
    << 32 | id (in the block, then over the blocks), then the finishing
    pass."""
    n = meta.width * meta.height
    tile = meta.tile
    empty = torch.iinfo(torch.int64).max  # ~0 as an unsigned key: above every key, whose t > 0 keeps it below 2^63
    best = torch.full((n,), empty, dtype=torch.int64)
    for first, count, x0, y0 in rd.blocks.tolist():
        if count <= 0:
            continue
        assert count <= RP.CHUNK
        rows, ids = rd.rows[first:first + count], rd.pids[first:first + count]
        box = rd.boxes[first:first + count].to(torch.int64)
        assert bool((ids >= 0).all())  # only real candidates are read
        bx0, bx1, by0, by1 = (box & 255), ((box >> 8) & 255), ((box >> 16) & 255), (box >> 24)
        area = (bx1 - bx0 + 1) * (by1 - by0 + 1)
        off = torch.cumsum(area, 0) - area
        p = torch.arange(int(area.sum()))
        k = torch.searchsorted(off, p, right=True) - 1  # the binary search's answer
        q = p - off[k]
        w = bx1[k] - bx0[k] + 1
        lx, ly = bx0[k] + q % w, by0[k] + q // w
        assert bool(_box_holds(box[k], lx, ly).all())
        # every pixel of every box once: as many distinct pairs as the areas hold
        assert (k * tile * tile + ly * tile + lx).unique().numel() == p.numel()
        pix = (y0 + ly) * meta.width + x0 + lx
        t = _leaf_tri_t([rows[k, c:c + 1] for c in range(9)], ids[k][:, None], org[pix], d[pix],
                        torch.zeros(p.numel()), torch.full((p.numel(),), RT_MAX))[:, 0]
        hit = t < RT_MAX
        key = (t.view(torch.int32).to(torch.int64) << 32) | ids[k].to(torch.int64)
        best.scatter_reduce_(0, pix[hit], key[hit], "amin")
    hit = best != empty
    t = torch.where(hit, (best >> 32).to(torch.int32).view(torch.float32), RT_MAX)
    prim = torch.where(hit, (best & 0xFFFFFFFF).to(torch.int32).to(torch.int64), -1)
    return t, prim


@pytest.mark.parametrize("chunk", [RP.CHUNK, 8, 24])
@pytest.mark.parametrize("name", ["front", "inside"])
def test_r1_model_equals_plain(port_cases, monkeypatch, name, chunk):
    """The model of R1 on the block table, at the kernel's chunk and at
    chunks small enough to split the soups' tiles, equals the plain raster
    bit for bit; the table's row count follows the bins' shape alone, every
    real candidate is in one chunk, and the permutation is the one
    ``build_raster_bins`` returns."""
    monkeypatch.setattr(RP, "CHUNK", chunk)
    meta, (pids, perm, _, _), rd, (org, d) = port_cases[name]
    blocks = torch.from_numpy(RP.block_table(meta, pids, perm))
    assert blocks.shape[0] == sum(-(-k // chunk) * g for k, g in zip(meta.group_k, meta.group_tiles))
    assert int(blocks[:, 1].sum()) == int((rd.pids >= 0).sum())
    rd = rd._replace(blocks=blocks)
    assert torch.equal(RP.raster_perm(meta, blocks), torch.from_numpy(perm.astype(np.int64)))
    t, prim = r1_model(meta, rd, org, d)
    t_p, prim_p = RP.raster_closest_hit_plain(meta, rd, org, d)
    assert torch.equal(prim, prim_p) and torch.equal(t, t_p)


@pytest.mark.parametrize("res", [(72, 48), (60, 40), (36, 36)], ids=["tile24", "tile20", "tile12"])
def test_r1_model_other_tiles(res):
    """The model of R1 at the tile edges the soups above do not reach (24,
    20 and 12 pixels; at 20 and 12 a block's last warp has threads without
    a pixel) equals the plain raster bit for bit, and the plain raster
    hits."""
    (p0, p1, p2), cam, _, _, seed = _case("front")
    w, h = res
    meta, pids, perm, _, boxes = RP.build_raster_bins(p0, p1, p2, *cam, w, h)
    assert meta.tile == {72: 24, 60: 20, 36: 12}[w]
    rd = RP.upload_raster(meta, pids, perm, boxes, TriSoA.build(p0, p1, p2).packed)
    lin = torch.arange(w * h)
    jitter = torch.from_numpy(np.random.default_rng(seed).uniform(0, 1, (w * h, 2)).astype(np.float32))
    org, d = generate_primary_rays(torch.stack([lin % w, lin // w], -1).float(), jitter, (w, h),
                                   *(torch.from_numpy(c) for c in cam))
    t, prim = r1_model(meta, rd, org, d)
    t_p, prim_p = RP.raster_closest_hit_plain(meta, rd, org, d)
    assert torch.equal(prim, prim_p) and torch.equal(t, t_p) and 0.05 < (prim >= 0).float().mean().item() < 0.95


# ---------------------------------------------------------------------------
# frames above 16,384 triangles
# ---------------------------------------------------------------------------

RES = (32, 32)
TILE = (8, 8)


@pytest.fixture(scope="module")
def big():
    """``cornell_objects`` with 64 x 64 objects: 17,584 triangles."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(SB, "OBJECT_TESSELLATION", (64, 64))
        scene, system = SB.cornell_objects(RES)
    assert scene.num_triangles == 17584
    return scene, dataclasses.replace(system, tile_size=TILE)


def jax_scene(scene) -> JScene:
    """The JAX package's ``Scene`` of the port's arrays, its material table
    and mesh lights built by the JAX package's host code."""
    rows = [JMaterial(**dataclasses.asdict(m)) for m in scene.material_rows]
    keys = ("p0", "p1", "p2", "n0", "n1", "n2", "uv0", "uv1", "uv2")
    a = {k: getattr(scene, k) for k in keys}
    lights, light_id = jax_build_lights(types.SimpleNamespace(lights=[]), (), rows, *a.values(),
                                        scene.material_id)
    assert np.array_equal(light_id, scene.light_id)
    return JScene(**a, material_id=scene.material_id, light_id=light_id, materials=JMaterialTable.build(rows),
                  material_rows=rows, lights=lights, camera=JCamera(**dataclasses.asdict(scene.camera)))


def _logging_jax_raster(fn):
    def logged(meta, rd, o, d, tn, tf):
        t, prim = fn(meta, rd, o, d, tn, tf)
        jax.debug.callback(_jax_log("closest"), tf, d, t, prim, ordered=True)
        return t, prim
    return logged


def _logging_port_raster(fn):
    def logged(meta, rd, o, d):
        t, prim = fn(meta, rd, o, d)
        tf = torch.full_like(t, RT_MAX)
        _LOG["port"].append(("closest", [x.numpy().copy() for x in (tf, d, t, prim)]))
        return t, prim
    return logged


@contextlib.contextmanager
def big_training_pair(big, raster: bool):
    """A JAX and a port FULL + train renderer on the big scene with the
    same weights, the raster on or off on both, every closest-hit, raster
    and shadow call logged, the port trained on the JAX frame's batches."""
    scene, system = big
    prev = jax.config.jax_enable_compilation_cache
    jax.config.update("jax_enable_compilation_cache", False)  # see test_torch_mlp.py
    try:
        with pytest.MonkeyPatch.context() as mp:
            align_builders(mp)
            mp.setenv("NRC_RASTER_PRIMARY", "1" if raster else "0")
            mp.setattr(jax_integrator, "make_intersectors", _walking_jax_intersectors)
            mp.setattr(jax_raster, "raster_closest_hit", _logging_jax_raster(jax_raster.raster_closest_hit))
            mp.setattr(port_integrator, "make_intersectors",
                       _recording_port_intersectors(port_integrator.make_intersectors))
            mp.setattr(port_frame, "trace_wavefront", checked_at_full_width(port_frame.trace_wavefront, _LOG["port"]))
            mp.setattr(port_frame, "raster_closest_hit", _logging_port_raster(port_frame.raster_closest_hit))
            mp.setattr(jax_frame, "assemble_training_batches",
                       _recording_jax_assemble(jax_frame.assemble_training_batches))
            mp.setattr(port_frame, "assemble_training_batches",
                       _port_assemble_with_jax_batches(port_frame.assemble_training_batches))
            jr = JRenderer(jax_scene(scene), system, render_mode=RenderMode.FULL, train=True, adaptive_tiles=False)
            pr = Renderer(scene, system, render_mode=RenderMode.FULL, adaptive_tiles=False, device="cpu",
                          raster_primary=raster)
            pr.net_state = N.state_from_numpy(jax.tree.map(np.asarray, jr.net_state))
            assert jr._raster_enabled == pr.raster_enabled == raster
            yield jr, pr
    finally:
        jax.config.update("jax_enable_compilation_cache", prev)


@pytest.mark.parametrize("raster", [True, False], ids=["raster", "walk"])
def test_big_scene_frames_match_jax(big, raster):
    with big_training_pair(big, raster) as (jr, pr):
        for subframe in range(2):
            got = train_frame_readings(jr, pr, subframe)
            over = {k: (v, SLICE_LIMITS[k]) for k, v in got.items() if not v <= SLICE_LIMITS[k]}
            assert not over, f"frame {subframe}: readings over their limits: {over}"
            # depth 0 went through the raster on both sides, or through neither
            assert (jr._raster_meta is not None) == (pr._raster_meta is not None) == pr._raster_frame == raster
            assert pr._raster_meta == jr._raster_meta


def test_raster_frame_equals_walk_frame(big):
    """The port's FULL + train frame with the raster and with the walk from
    the same state: the depth-0 winners equal but at ties, and every pixel
    whose winner is equal bit for bit (here all of them)."""
    scene, system = big
    frames = {}
    for raster in (True, False):
        r = Renderer(scene, system, render_mode=RenderMode.FULL, adaptive_tiles=False, device="cpu",
                     raster_primary=raster)
        stats = r.render_frame()
        frames[raster] = r.image.clone(), int(stats.num_train_records), int(stats.traced_rays)
        assert (r._raster_meta is not None) == raster
        if raster:
            meta, data = r._raster_meta, r._raster_data
    (img_r, rec_r, traced_r), (img_w, rec_w, traced_w) = frames[True], frames[False]
    assert torch.equal(img_r, img_w) and rec_r == rec_w and traced_r == traced_w
    assert meta.tile == 16 and len(data.blocks) == RP.room(sum(-(-k // RP.CHUNK) * g for k, g in
                                                               zip(meta.group_k, meta.group_tiles)))


def test_raster_switch_and_graph_key(big, monkeypatch):
    """When the raster engages (the JAX renderer's conditions); that a frame
    whose camera moved walks and bins nothing, and the next frame of the
    same camera bins and rasters; that bins which fit the rows held keep
    the graph key and are copied into the same tensors, whether their
    shape changed or not, and bins that outgrow them change the key."""
    import nrc_tpu_torch.render.renderer as port_renderer

    scene, system = big
    small, small_sys = cornell_box(RES)
    assert not Renderer(small, small_sys, device="cpu").raster_enabled  # 1224 triangles
    assert not Renderer(scene, system, device="cpu", raster_primary=False).raster_enabled
    assert not Renderer(scene, dataclasses.replace(system, resolution=(36, 32)), device="cpu").raster_enabled
    fisheye = dataclasses.replace(scene, lens_shader=1)
    assert not Renderer(fisheye, system, device="cpu").raster_enabled

    builds = []
    monkeypatch.setattr(port_renderer, "build_raster_bins",
                        lambda *a: builds.append(1) or RP.build_raster_bins(*a))
    r = _turned_renderer(big)
    assert r.raster_enabled
    r.render_frame()
    assert r._raster_frame and len(builds) == 1
    meta, data = r._raster_meta, r._raster_data
    key = frame_key(r.cfg, data)
    ptrs = [t.data_ptr() for t in data]

    def bins():
        s = r.scene
        return RP.build_raster_bins(s.p0, s.p1, s.p2, *s.camera.frustum(), *RES)

    # moves that keep the shape and one that changes it, each within the room
    for dphi, same_shape in ((2e-3, True), (-0.012, False)):
        built = len(builds)
        r.scene.camera.orbit(dphi, 0.0)
        r.restart_accumulation()
        for _ in range(2):  # a dragged camera: its frames walk
            r.render_frame()
            assert not r._raster_frame and len(builds) == built and r._raster_meta == meta
            r.scene.camera.orbit(1e-7, 0.0)
        r.scene.camera.orbit(-2e-7, 0.0)
        r.render_frame()  # moved once more: walks
        r.render_frame()  # held still: binned, rasters
        assert r._raster_frame and len(builds) == built + 1
        assert (r._raster_meta == meta) == same_shape
        assert r._raster_data is data and frame_key(r.cfg, r._raster_data) == key
        assert [t.data_ptr() for t in data] == ptrs
        m, pids, perm, _, boxes = bins()
        fresh = RP.upload_raster(m, pids, perm, boxes, r.device_scene.tris.packed)
        slots, blocks = len(pids), len(RP.block_table(m, pids, perm))
        assert torch.equal(data.rows[:slots], fresh.rows[:slots]) and bool((data.pids[slots:] == -1).all())
        assert torch.equal(data.pids[:slots], fresh.pids[:slots]) and torch.equal(data.boxes[:slots], fresh.boxes[:slots])
        assert torch.equal(data.blocks[:blocks], fresh.blocks[:blocks]) and not bool(data.blocks[blocks:].any())
        meta = r._raster_meta
    # back to the scene's own view, whose tiles are more crowded than the room
    r.scene.camera.orbit(-0.04, 0.0)
    r.restart_accumulation()
    r.render_frame()
    r.render_frame()
    assert r._raster_frame and r._raster_data is not data and frame_key(r.cfg, r._raster_data) != key
    assert r._raster_data.pids.shape[0] > data.pids.shape[0] or r._raster_data.blocks.shape[0] > data.blocks.shape[0]
    # a new device scene drops the bins; the next frame bins again
    r.device_scene = r.device_scene
    assert r._raster_meta is None and r._raster_data is None
    r.render_frame()
    assert r._raster_frame and r._raster_meta is not None


def _turned_renderer(big):
    """A NO_CACHE renderer of the big scene, its camera (a copy) turned by
    0.05 from the scene's: there the bins are smaller than at the scene's
    own view, whose bins outgrow their room."""
    scene, system = big
    camera = dataclasses.replace(scene.camera)
    camera.orbit(0.05, 0.0)
    return Renderer(dataclasses.replace(scene, camera=camera), system, render_mode=RenderMode.NO_CACHE, train=False,
                    device="cpu")


def test_outgrown_bins_drop_their_graphs(big):
    """Graphs that read bins which a move outgrew go with them (fake graphs:
    the keys are what is held)."""
    r = _turned_renderer(big)
    r.render_frame()
    old = frame_key(r.cfg, r._raster_data)
    r.graphs[old] = r.graphs[old[:-1] + (None,)] = "a graph"
    r.scene.camera.orbit(-0.05, 0.0)
    for _ in range(2):  # the frame of the move, then the one that holds still
        r._bin_primaries()
    assert r._raster_frame and list(r.graphs) == [old[:-1] + (None,)]


def test_parallel_renderer_never_bins(big, monkeypatch):
    """The bands walk their primaries (the JAX package's rule): a
    ``ParallelRenderer`` on the big scene never builds bins."""
    import nrc_tpu_torch.render.renderer as port_renderer

    calls = []
    monkeypatch.setattr(port_renderer, "build_raster_bins", lambda *a, **k: calls.append(a))
    scene, system = big
    owned = not dist.is_initialized()
    if owned:
        init_data_group("cpu", 0, 1, _free_port())
    try:
        r = ParallelRenderer(scene, system, render_mode=RenderMode.NO_CACHE, train=False, device="cpu")
        assert not r.raster_enabled
        r.render_frame()
        assert not calls and r._raster_meta is None and np.isfinite(r.image.numpy()).all()
    finally:
        if owned:
            dist.destroy_process_group()


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]
