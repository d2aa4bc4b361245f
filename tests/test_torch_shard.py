"""The port's multi-GPU layer (``nrc_tpu_torch/parallel/shard.py``) on the
CPU, with gloo ranks.

- The level-sharded hash grid (``encodings.sharded_hash_grid_lookup``) on 2
  and 4 spawned ranks: each rank's features bit for bit those of the
  unsharded lookup of its queries, its block of the table gradient bit for
  bit that block of the unsharded gradient of every rank's queries (the
  shipped grid and a small one of dense and hashed levels), and on the small
  grid the blocks against JAX's ``sharded_hash_grid_lookup`` under
  ``shard_map`` on as many CPU devices, within float32 sums in another
  order.
- Bands on 2 spawned ranks at 32x32 (8x8 tiles, 16-row bands): NO_CACHE
  with training, two frames, the gathered image bit for bit the unsharded
  frame's and the summed records and traced rays equal; then FULL + train
  against the JAX package's ``ParallelRenderer`` on a 2-device mesh, two
  frames, each from the JAX state before it, the port training on the JAX
  bands' batches (``jax.random.permutation`` cannot be reproduced). JAX's
  calls to its intersectors are logged per band (unordered callbacks with
  the band's index: ordered ones are refused on more than one device) and
  held against each rank's calls by ``test_torch_slice.ray_flips``; the
  readings are held to ``test_torch_train_slice.SLICE_LIMITS``, the box's
  image bounds of ``test_torch_slice.py`` and the state bounds of
  ``test_torch_train.py`` after four Adam steps with JAX's bf16 gradients.
- One rank (an in-process gloo group of world size 1): ``ParallelRenderer``
  equals ``Renderer`` bit for bit, image, stats and state, for the
  frequency encoding (K5 and the plain update against K6's plain version),
  the hash grid and the level-sharded hash grid.

The JAX sides run in a child process (``test_torch_jax_child.run_jax_side``).
"""

import dataclasses
import socket

import numpy as np
import pytest
import torch
import torch.distributed as dist

import nrc_tpu_torch.render.frame as port_frame
import nrc_tpu_torch.render.integrator as port_integrator
from nrc_tpu_torch.config import InputEncoding, NetworkConfig, RenderMode
from nrc_tpu_torch.models import network as N
from nrc_tpu_torch.ops import encodings as E
from nrc_tpu_torch.ops.hash_cuda import HashGridLookup
from nrc_tpu_torch.parallel import shard as S
from nrc_tpu_torch.render.renderer import Renderer
from nrc_tpu_torch.scene.scene_builder import cornell_box
from test_torch_compact import checked_at_full_width
from test_torch_intersect import one_torch_thread  # noqa: F401 (an autouse fixture)
from test_torch_jax_child import run_jax_side
from torch_ranks import run_ranks

RES = (32, 32)
TILE = (8, 8)
BAND_FRAMES = 2
# the small grid of the JAX comparison: levels 0-1 dense, 2-3 hashed
SMALL_GRID = dict(hash_n_levels=4, hash_log2_size=10, hash_base_resolution=4, hash_per_level_scale=2.0)
LOOKUP_QUERIES = 96  # a rank's
# float32 sums of the same terms in another order (JAX's scatter-add against
# the port's index_add_ in query order): a few ulp of the largest entry
JAX_GRAD_ATOL = 1e-6
JAX_GRAD_RTOL = 1e-5


def _system():
    scene, system = cornell_box(RES)
    return scene, dataclasses.replace(system, tile_size=TILE)


def _hash_cfg(**kw):
    return NetworkConfig(encoding=InputEncoding.HASH, hash_shard_axis="data", **kw)


# ---------------------------------------------------------------------------
# the level-sharded lookup
# ---------------------------------------------------------------------------

def _grids():
    return {"shipped": _hash_cfg(), "small": _hash_cfg(**SMALL_GRID)}


def _table(cfg):
    return E.init_hash_grid(torch.Generator().manual_seed(7), cfg).table * 1e3


def lookup_rank(rank, world, pos, g):
    """This rank's features and block gradient of the sharded lookup, on
    each grid; ``pos`` and ``g`` hold every rank's queries."""
    out = {}
    rows = slice(rank * LOOKUP_QUERIES, (rank + 1) * LOOKUP_QUERIES)
    for name, cfg in _grids().items():
        block = _table(cfg)[E.level_block(cfg, rank, world)].clone().requires_grad_(True)
        feats = E.sharded_hash_grid_lookup(torch.from_numpy(pos[rows]), E.HashGridParams(block), cfg)
        (feats * torch.from_numpy(g[name][rows])).sum().backward()
        out[f"{name}.features"] = feats.detach().numpy()
        out[f"{name}.grad"] = block.grad.numpy()
    return out


def jax_sharded_lookup(pos, g, table, world):
    """JAX's ``sharded_hash_grid_lookup`` under ``shard_map`` on ``world`` CPU
    devices: the features and the table gradient of sum(features * g)."""
    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import Mesh, PartitionSpec as P

    from nrc_tpu.config import InputEncoding as JEnc, NetworkConfig as JCfg
    from nrc_tpu.ops import encodings as JE

    cfg = JCfg(encoding=JEnc.HASH, hash_shard_axis="data", **SMALL_GRID)
    mesh = Mesh(np.asarray(jax.devices()[:int(world)]), ("data",))
    lookup = shard_map(lambda p, t: JE.sharded_hash_grid_lookup(p, JE.HashGridParams(t), cfg, "data"),
                       mesh=mesh, in_specs=(P("data"), P("data", None, None)), out_specs=P("data"),
                       check_vma=False)
    t = jnp.asarray(table)
    feats = jax.jit(lookup)(pos, t)
    grad = jax.jit(jax.grad(lambda u: jnp.sum(lookup(pos, u) * g)))(t)
    return {"features": np.asarray(feats), "grad": np.asarray(grad)}


@pytest.mark.parametrize("world", [2, 4])
def test_level_sharded_lookup(world, tmp_path):
    rs = np.random.default_rng(world)
    pos = rs.uniform(-0.1, 1.1, (world * LOOKUP_QUERIES, 3)).astype(np.float32)
    cfgs = _grids()
    g = {name: rs.normal(size=(world * LOOKUP_QUERIES, cfg.hash_n_levels * cfg.hash_n_features_per_level))
         .astype(np.float32) for name, cfg in cfgs.items()}
    ranks = run_ranks("test_torch_shard:lookup_rank", world, tmp_path, pos=pos, g=g)
    for name, cfg in cfgs.items():
        table = _table(cfg).requires_grad_(True)
        feats = HashGridLookup.apply(torch.from_numpy(pos), table, E.grid_spec(cfg))
        (feats * torch.from_numpy(g[name])).sum().backward()
        got = np.concatenate([r[f"{name}.features"] for r in ranks])
        assert np.array_equal(got, feats.detach().numpy()), f"{name}: features differ from the unsharded lookup's"
        grad = np.concatenate([r[f"{name}.grad"] for r in ranks])
        assert np.array_equal(grad, table.grad.numpy()), f"{name}: the table gradient differs from the unsharded one"
    ref = run_jax_side("test_torch_shard:jax_sharded_lookup", tmp_path, pos=pos, g=g["small"],
                       table=_table(cfgs["small"]).numpy(), world=np.int32(world))
    got = np.concatenate([r["small.features"] for r in ranks])
    np.testing.assert_allclose(got, ref["features"], rtol=1e-6, atol=1e-6)
    grad = np.concatenate([r["small.grad"] for r in ranks])
    np.testing.assert_allclose(grad, ref["grad"], rtol=JAX_GRAD_RTOL, atol=JAX_GRAD_ATOL * np.abs(ref["grad"]).max())
    assert np.abs(ref["grad"]).max() > 0.0


# ---------------------------------------------------------------------------
# bands on 2 ranks: against the unsharded port, and against JAX
# ---------------------------------------------------------------------------

_STATE_KEYS = [f"{p}.{w}" for p in ("params", "ema", "opt.mu", "opt.nu") for w in ("w_in", "w_hidden", "w_out")]


def _recording_intersectors(log):
    make = port_integrator.make_intersectors

    def make_recording(tris, planes, bvh=None):
        closest, occluded = make(tris, planes, bvh)

        def closest_rec(o, d, tn, tf):
            hit = closest(o, d, tn, tf)
            log.append(("closest", [x.numpy().copy() for x in (tf, d, hit.t, hit.prim)]))
            return hit

        def occluded_rec(o, d, tn, tf):
            occ = occluded(o, d, tn, tf)
            log.append(("shadow", [x.numpy().copy() for x in (tf, occ)]))
            return occ

        return closest_rec, occluded_rec

    return make_recording


def _log_entries(log, prefix):
    """Logged calls as npz entries, by (tag, rays) in call order."""
    out, seen = {}, {}
    for tag, arrays in log:
        key = (tag, arrays[0].shape[0])
        i = seen[key] = seen.get(key, -1) + 1
        for j, a in enumerate(arrays):
            out[f"{prefix}.{tag}.{key[1]}.{i}.{j}"] = a
    return out


def calls(entries, prefix, tag, n):
    """``_log_entries``' calls of one (tag, rays), in call order."""
    found = {}
    head = f"{prefix}.{tag}.{n}."
    for key, a in entries.items():
        if key.startswith(head):
            i, j = map(int, key[len(head):].split("."))
            found.setdefault(i, {})[j] = a
    return [[found[i][j] for j in sorted(found[i])] for i in sorted(found)]


def bands_rank(rank, world, **jax_side):
    """NO_CACHE with training, then FULL + train from the JAX states on the
    JAX bands' batches, on this rank's band."""
    out = {}
    scene, system = _system()
    r = S.ParallelRenderer(scene, system, render_mode=RenderMode.NO_CACHE, adaptive_tiles=False, device="cpu")
    for f in range(BAND_FRAMES):
        stats = r.render_frame()
        out[f"no_cache.{f}.image"] = r.image.numpy().copy()
        out[f"no_cache.{f}.records"] = int(stats.num_train_records)
        out[f"no_cache.{f}.traced"] = int(stats.traced_rays)
    r = S.ParallelRenderer(scene, system, render_mode=RenderMode.FULL, adaptive_tiles=False, device="cpu")
    log, frame = [], {}
    assemble = port_frame.assemble_training_batches

    def assemble_jax_batches(*args):
        _, _, n = assemble(*args)
        f = frame["index"]
        return (torch.from_numpy(jax_side[f"batch.{f}.{rank}.q"].copy()),
                torch.from_numpy(jax_side[f"batch.{f}.{rank}.t"].copy()), n)

    port_frame.assemble_training_batches = assemble_jax_batches
    port_integrator.make_intersectors = _recording_intersectors(log)
    port_frame.trace_wavefront = checked_at_full_width(port_frame.trace_wavefront, log)
    for f in range(BAND_FRAMES):
        frame["index"] = f
        state = {k: jax_side[f"state.{f}.{k}"] for k in _STATE_KEYS + ["opt.step"]}
        r.net_state = S.rank_state(state, r.net_cfg, rank, world)
        r.restart_accumulation()
        r.total_subframe = f
        log.clear()
        stats = r.render_frame()
        out[f"full.{f}.image"] = r.image.numpy().copy()
        out[f"full.{f}.loss"] = float(stats.loss)
        out[f"full.{f}.records"] = int(stats.num_train_records)
        out.update({f"full.{f}.{k}": v for k, v in N.state_to_numpy(r.net_state).items()})
        out.update(_log_entries(log, f"log.{f}"))
    return out


def jax_band_intersectors(logs):
    """JAX's ``make_intersectors`` with the TPU plane kernels in interpret
    mode, each band's rays logged into ``logs[(band, tag, rays)]`` in call
    order (unordered callbacks with the band's index: ordered ones are
    refused on more than one device)."""
    import jax

    from nrc_tpu.ops import intersect_pallas as JP

    def keep(tag):
        def cb(band, *arrays):
            logs.setdefault((int(band), tag, arrays[0].shape[0]), []).append([np.asarray(a).copy() for a in arrays])
        return cb

    def make(tris, bvh=None):
        planes = JP.build_plane_table(tris)

        def closest(o, d, tn, tf):
            hit = JP.intersect_planes(o, d, planes, tris, tn, tf, interpret=True)
            jax.debug.callback(keep("closest"), jax.lax.axis_index("data"), tf, d, hit.t, hit.prim)
            return hit

        def occluded(o, d, tn, tf):
            occ = JP.occluded_planes(o, d, planes, tn, tf, interpret=True)
            jax.debug.callback(keep("shadow"), jax.lax.axis_index("data"), tf, occ)
            return occ

        return closest, occluded

    return make


def jax_band_batches(batches):
    """JAX's ``assemble_training_batches`` with each band's batches kept in
    ``batches[band]``."""
    import jax

    import nrc_tpu.render.frame as jax_frame

    assemble = jax_frame.assemble_training_batches

    def recording_assemble(*args):
        out = assemble(*args)
        jax.debug.callback(lambda band, *a: batches.__setitem__(int(band), [np.asarray(x).copy() for x in a]),
                           jax.lax.axis_index("data"), *out)
        return out

    return recording_assemble


def jax_band_entries(logs, prefix):
    """``jax_band_intersectors``' logs as npz entries,
    ``<prefix><band>.<tag>.<rays>.<call>.<array>``."""
    return {f"{prefix}{band}.{tag}.{n}.{i}.{j}": a for (band, tag, n), entries in logs.items()
            for i, arrays in enumerate(entries) for j, a in enumerate(arrays)}


def jax_sharded_frames():
    """The JAX ``ParallelRenderer`` on a 2-device mesh, FULL + train, frames
    from a restarted accumulation; its intersectors are the TPU plane
    kernels in interpret mode, logged per band, and its bands' batches kept."""
    import jax

    import nrc_tpu.render.frame as jax_frame
    import nrc_tpu.render.integrator as jax_integrator
    from nrc_tpu.parallel.shard import ParallelRenderer as JParallel, make_mesh
    from nrc_tpu.render.renderer import Renderer as JRenderer
    from test_torch_scene import jax_cornell_scene

    logs, batches = {}, {}
    jax_integrator.make_intersectors = jax_band_intersectors(logs)
    jax_frame.assemble_training_batches = jax_band_batches(batches)
    _, system = _system()
    jr = JRenderer(jax_cornell_scene(RES), system, render_mode=RenderMode.FULL, train=True, adaptive_tiles=False)
    jp = JParallel(jr, make_mesh(2))
    out = {}
    for f in range(BAND_FRAMES):
        state = jr.net_state
        for prefix, mlp in (("params", state.params), ("ema", state.ema), ("opt.mu", state.opt.mu),
                            ("opt.nu", state.opt.nu)):
            for w in ("w_in", "w_hidden", "w_out"):
                out[f"state.{f}.{prefix}.{w}"] = np.asarray(getattr(mlp, w))
        out[f"state.{f}.opt.step"] = np.int32(state.opt.step)
        jr.restart_accumulation()
        logs.clear()
        batches.clear()
        stats = jp.render_frame()
        out[f"image.{f}"] = np.asarray(jr.image)
        jax.effects_barrier()
        out[f"loss.{f}"] = np.float32(stats.loss)
        out[f"records.{f}"] = np.int32(stats.num_train_records)
        after = jax.tree.map(np.asarray, jr.net_state)
        for w in ("w_in", "w_hidden", "w_out"):
            out[f"after.{f}.params.{w}"] = getattr(after.params, w)
            out[f"after.{f}.ema.{w}"] = getattr(after.ema, w)
        for band, (bq, bt, _) in batches.items():
            out[f"batch.{f}.{band}.q"], out[f"batch.{f}.{band}.t"] = bq, bt
        out.update(jax_band_entries(logs, f"log.{f}."))
    return out


def test_bands_against_the_whole_frame_and_jax(tmp_path):
    from test_torch_train_slice import SLICE_LIMITS

    jax_side = run_jax_side("test_torch_shard:jax_sharded_frames", tmp_path)
    ranks = run_ranks("test_torch_shard:bands_rank", 2, tmp_path,
                      **{k: v for k, v in jax_side.items() if k.startswith(("state.", "batch."))})
    scene, system = _system()
    whole = Renderer(scene, system, render_mode=RenderMode.NO_CACHE, adaptive_tiles=False, device="cpu")
    for f in range(BAND_FRAMES):
        stats = whole.render_frame()
        for r in ranks:
            assert np.array_equal(r[f"no_cache.{f}.image"], whole.image.numpy()), f"NO_CACHE frame {f}"
            assert int(r[f"no_cache.{f}.records"]) == int(stats.num_train_records) > 0
            assert int(r[f"no_cache.{f}.traced"]) == int(stats.traced_rays)
    for f in range(BAND_FRAMES):
        got = band_frame_readings(_prefixed(jax_side, f"image.{f}", f"loss.{f}", f"records.{f}", f"after.{f}.",
                                            f"log.{f}."),
                                  [_prefixed(r, f"full.{f}.", f"log.{f}.") for r in ranks])
        over = {k: (v, SLICE_LIMITS[k]) for k, v in got.items() if not v <= SLICE_LIMITS[k]}
        assert not over, f"frame {f}: readings over their limits: {over}"


def _prefixed(arrays, *prefixes):
    """The entries under each prefix, with the prefix taken off; an entry
    named whole by its prefix keeps the prefix's last word (``image.0`` ->
    ``image``); ``log.`` prefixes keep ``log.``."""
    out = {}
    for p in prefixes:
        for k, v in arrays.items():
            if k == p:
                out[p.split(".")[0]] = v
            elif k.startswith(p):
                out[("log." if p.startswith("log.") else "") + k[len(p):]] = v
    return out


def band_image_readings(jax_frame, rank_frames) -> dict:
    """The ranks' image against the JAX ``ParallelRenderer``'s, as
    ``SLICE_LIMITS`` reads it: ``jax_frame`` holds the ``image`` and the
    rays logged per band (``log.<band>.<tag>.<rays>.<call>.<array>``), each
    of ``rank_frames`` its ``image`` and its rays (``log.<tag>...``). Every
    rank must hold the same image."""
    from test_torch_slice import ray_flips

    ref, out = jax_frame["image"], rank_frames[0]["image"]
    world = len(rank_frames)
    band = ref.shape[0] // world
    assert all(np.array_equal(out, r["image"]) for r in rank_frames[1:])
    assert np.isfinite(out).all() and out.std() > 0.0
    flipped = np.zeros(ref.shape[0], bool)
    for k, r in enumerate(rank_frames):
        for tag in ("closest", "shadow"):
            j_calls = calls(jax_frame, f"log.{k}", tag, band)
            p_calls = calls(r, "log", tag, band)
            assert len(j_calls) == len(p_calls) > 0, f"band {k}: {len(j_calls)} and {len(p_calls)} {tag} calls"
            for j, p in zip(j_calls, p_calls):
                flipped[k * band:(k + 1) * band] |= ray_flips(tag, j, p)
    keep = ~flipped
    return {
        "flipped_share": flipped.mean(),
        "image_kept_abs": np.abs(out - ref)[keep].max(),
        "image_kept_mean_rel": abs(out[keep].mean() / ref[keep].mean() - 1.0),
        "image_mean_rel": abs(out.mean() / ref.mean() - 1.0),
    }


def band_frame_readings(jax_frame, rank_frames) -> dict:
    """One FULL + train frame of the ranks against the JAX
    ``ParallelRenderer``'s, as ``SLICE_LIMITS`` reads them: the image
    (``band_image_readings``), and from ``loss``, ``records`` and the
    weights and EMA after the frame (``params.w_in``, ``ema.w_in``, ...) on
    both sides, the training. Every rank must hold the same weights."""
    got = band_image_readings(jax_frame, rank_frames)
    got.update({
        "loss_rel": abs(float(rank_frames[0]["loss"]) / float(jax_frame["loss"]) - 1.0),
        "records_gap": abs(int(rank_frames[0]["records"]) - int(jax_frame["records"])),
        "ema_abs": 0.0, "ema_mean_abs": 0.0, "params_abs": 0.0,
    })
    assert int(jax_frame["records"]) > 0
    for w in ("w_in", "w_hidden", "w_out"):
        for r in rank_frames[1:]:
            assert np.array_equal(r[f"params.{w}"], rank_frames[0][f"params.{w}"])
        d = np.abs(rank_frames[0][f"ema.{w}"] - jax_frame[f"ema.{w}"])
        got["ema_abs"] = max(got["ema_abs"], d.max())
        got["ema_mean_abs"] = max(got["ema_mean_abs"], d.mean())
        d = np.abs(rank_frames[0][f"params.{w}"] - jax_frame[f"params.{w}"])
        got["params_abs"] = max(got["params_abs"], d.max())
    return got


# ---------------------------------------------------------------------------
# one rank, in this process
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def one_rank():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    S.init_data_group("cpu", 0, 1, port)
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("net_cfg", [NetworkConfig(), NetworkConfig(encoding=InputEncoding.HASH), _hash_cfg()],
                         ids=["frequency", "hash", "hash level-sharded"])
def test_one_rank_equals_the_renderer(one_rank, net_cfg):
    """FULL + train, two frames: image, stats and state bit for bit."""
    scene, system = _system()
    whole = Renderer(scene, system, net_cfg=net_cfg, device="cpu")
    par = S.ParallelRenderer(scene, system, net_cfg=net_cfg, device="cpu")
    for _ in range(2):
        a, b = whole.render_frame(), par.render_frame()
        assert torch.equal(whole.image, par.image)
        assert torch.equal(a.loss, b.loss) and int(a.num_train_records) == int(b.num_train_records) > 0
        assert int(a.traced_rays) == int(b.traced_rays)
        assert all(torch.equal(x, y) for x, y in zip(N.state_tensors(whole.net_state), N.state_tensors(par.net_state)))
        assert int(whole.net_state.opt.step) == int(par.net_state.opt.step)
    assert np.array_equal(whole.image_hdr(), par.image_hdr())


def test_the_group_suits_the_device_and_the_tiles_the_band(one_rank):
    scene, system = _system()
    with pytest.raises(ValueError, match="takes nccl"):
        S.make_group(torch.device("cuda"))
    par = S.ParallelRenderer(scene, system, device="cpu")
    # many records grow the tiles to 64 rows; the 32-row band takes 32
    assert par._next_tile_size(10 ** 7) == (64, 32)
    with pytest.raises(ValueError, match="tile height 64"):
        S.ParallelRenderer(scene, dataclasses.replace(system, tile_size=(8, 64)), device="cpu")


def test_rank_state_takes_each_ranks_block():
    """A whole state as numpy carried to each of 4 ranks: the replicated
    tensors whole, the table, its EMA and moments by blocks of levels."""
    cfg = _hash_cfg()
    whole = N.state_to_numpy(N.init_network(torch.Generator().manual_seed(3), cfg))
    for rank in range(4):
        st = N.state_to_numpy(S.rank_state(whole, cfg, rank, 4))
        for key, v in whole.items():
            want = v[rank * 4:(rank + 1) * 4] if S.level_sharded(key, cfg) else v
            assert np.array_equal(st[key], want), key
    assert S.level_sharded("grid.table", cfg) and not S.level_sharded("grid.table", NetworkConfig())
    with pytest.raises(ValueError, match="divide hash_n_levels"):
        S.rank_state(whole, cfg, 0, 3)
