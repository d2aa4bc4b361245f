"""Render states of a level-sharded ``ParallelRenderer`` (``parallel/shard.py``,
``models/checkpoint.py``) on gloo ranks, against the JAX package's files.

A level-sharded rank holds one block of the hash table's levels; its files
hold the whole table all the same, as the JAX package's do (``np.asarray``
of a sharded global array gathers every level).

- At 2 and 4 ranks on ``test_torch_shard.SMALL_GRID`` (4 levels, dense and
  hashed): after a FULL + train frame, the render state saved by every rank
  (rank 0 writes) holds the table, its EMA and its moments as every rank's
  block in level order, bit for bit, and every other tensor as rank 0 holds
  it; a file of one rank's block (as ranks wrote before) is refused by
  ``load_render_state`` and ``load_checkpoint``; ``load_checkpoint`` cuts a
  whole network checkpoint (the render state's network) to each rank's
  block.
- The JAX package's level-sharded ``ParallelRenderer`` on 2 and 4 CPU
  devices (in a child process, ``test_torch_jax_child.run_jax_side``)
  renders two FULL + train frames and writes its render state; the ranks
  load it and save it back with no frame between, which must give the JAX
  file key for key and bit for bit; then both render the next frame, the
  ranks on the JAX bands' batches (``jax.random.permutation`` cannot be
  reproduced), held as ``test_torch_shard.py``'s bands are
  (``band_frame_readings`` under ``test_torch_train_slice.SLICE_LIMITS``).
"""

import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

import nrc_tpu_torch.render.frame as port_frame
import nrc_tpu_torch.render.integrator as port_integrator
from nrc_tpu_torch.config import RenderMode
from nrc_tpu_torch.models import network as N
from nrc_tpu_torch.models.checkpoint import (
    load_checkpoint,
    load_render_state,
    save_checkpoint,
    save_render_state,
)
from nrc_tpu_torch.ops.encodings import level_block
from nrc_tpu_torch.parallel import shard as S
from test_torch_compact import checked_at_full_width
from test_torch_intersect import one_torch_thread  # noqa: F401 (an autouse fixture)
from test_torch_jax_child import run_jax_side
from test_torch_shard import (
    RES,
    SMALL_GRID,
    _hash_cfg,
    _log_entries,
    _prefixed,
    _recording_intersectors,
    _system,
    band_frame_readings,
    jax_band_batches,
    jax_band_entries,
    jax_band_intersectors,
)
from torch_ranks import run_ranks

WORLDS = [2, 4]
# FULL + train frames of the JAX renderer before it writes its state
JAX_FRAMES = 2


def _renderer():
    scene, system = _system()
    return S.ParallelRenderer(scene, system, net_cfg=_hash_cfg(**SMALL_GRID), render_mode=RenderMode.FULL,
                              adaptive_tiles=False, device="cpu")


# ---------------------------------------------------------------------------
# the ranks' own files
# ---------------------------------------------------------------------------

def save_load_rank(rank, world, out):
    """A frame, the render state saved by every rank, a file of this rank's
    block refused, a whole network checkpoint cut to the block."""
    out = str(out)
    r = _renderer()
    r.render_frame()
    held = N.state_to_numpy(r.net_state)
    result = {f"held.{k}": v for k, v in held.items()}
    result["image"] = r.image.numpy().copy()
    path = save_render_state(os.path.join(out, "whole"), r)  # a collective: every rank gathers
    assert path == os.path.join(out, "whole.npz")
    # one rank's block and nothing to say which: the files ranks wrote before
    part = os.path.join(out, f"part{rank}.npz")
    np.savez(part, **{f"net.{k}": v for k, v in held.items()}, **{
        "render.image": result["image"], "render.iteration": np.int64(r.iteration),
        "render.total_subframe": np.int64(r.total_subframe),
        "render.tile_size": np.asarray(r.cfg.tile_size, np.int32)})
    np.savez(os.path.join(out, f"netpart{rank}.npz"), **held)
    dist.barrier()  # rank 0 has written
    if rank == 0:  # the network of the whole render state as a checkpoint
        with np.load(path) as z:
            save_checkpoint(os.path.join(out, "net"),
                            N.state_from_numpy({k[len("net."):]: z[k] for k in z.files if k.startswith("net.")}))
    dist.barrier()
    for name, load in (("render_state", lambda p: load_render_state(p, r)),
                       ("checkpoint", lambda p: load_checkpoint(p, r.net_cfg, r.device, level_block=r.state_block))):
        with pytest.raises(ValueError, match=f"holds {4 // world} of the 4 levels"):
            load(os.path.join(out, f"{'part' if name == 'render_state' else 'netpart'}{(rank + 1) % world}.npz"))
        result[f"refused.{name}"] = np.int32(1)
    cut = load_checkpoint(os.path.join(out, "net"), r.net_cfg, r.device, level_block=r.state_block)
    result.update({f"cut.{k}": v for k, v in N.state_to_numpy(cut).items()})
    # the whole state loads back into the ranks' tensors in place
    table = r.net_state.grid.table
    load_render_state(path, r)
    assert r.net_state.grid.table is table
    result.update({f"reloaded.{k}": v for k, v in N.state_to_numpy(r.net_state).items()})
    return result


@pytest.mark.parametrize("world", WORLDS)
def test_level_sharded_files_hold_whole_tables(world, tmp_path):
    ranks = run_ranks("test_torch_shard_state:save_load_rank", world, tmp_path, out=str(tmp_path))
    cfg = _hash_cfg(**SMALL_GRID)
    with np.load(tmp_path / "whole.npz") as f:
        whole = {k: f[k] for k in f.files}
    with np.load(tmp_path / "net.npz") as f:
        net = {k: f[k] for k in f.files}
    keys = [k[len("held."):] for k in ranks[0] if k.startswith("held.")]
    assert set(net) == set(keys) and set(whole) == {f"net.{k}" for k in keys} | {
        "render.image", "render.iteration", "render.total_subframe", "render.tile_size"}
    for key in keys:
        if key in N.GRID_KEYS:
            want = np.concatenate([r[f"held.{key}"] for r in ranks])
            assert want.shape[0] == cfg.hash_n_levels
        else:
            want = ranks[0][f"held.{key}"]
        for name, arrays in (("render state", whole[f"net.{key}"]), ("checkpoint", net[key])):
            assert arrays.dtype == want.dtype and np.array_equal(arrays, want), f"{name}: {key}"
        for rank, r in enumerate(ranks):
            block = want[level_block(cfg, rank, world)] if key in N.GRID_KEYS else want
            assert np.array_equal(r[f"cut.{key}"], block), f"load_checkpoint on rank {rank}: {key}"
            assert np.array_equal(r[f"reloaded.{key}"], r[f"held.{key}"]), f"reloaded on rank {rank}: {key}"
    assert np.array_equal(whole["render.image"], ranks[0]["image"]) and whole["render.image"].std() > 0.0
    assert all(int(r["refused.render_state"]) == int(r["refused.checkpoint"]) == 1 for r in ranks)


# ---------------------------------------------------------------------------
# the JAX package's files
# ---------------------------------------------------------------------------

def jax_level_sharded_state(world, path):
    """The JAX ``ParallelRenderer`` on ``world`` CPU devices with the table
    level-sharded: ``JAX_FRAMES`` FULL + train frames, its render state
    written to ``path``, then one more frame with its rays logged per band
    (unordered callbacks with the band's index) and its bands' batches kept."""
    import jax

    import nrc_tpu.render.frame as jax_frame
    import nrc_tpu.render.integrator as jax_integrator
    from nrc_tpu.config import InputEncoding as JEnc, NetworkConfig as JCfg
    from nrc_tpu.models.checkpoint import save_render_state as jax_save_render_state
    from nrc_tpu.parallel.shard import ParallelRenderer as JParallel, make_mesh
    from nrc_tpu.render.renderer import Renderer as JRenderer
    from test_torch_scene import jax_cornell_scene

    logs, batches = {}, {}
    jax_integrator.make_intersectors = jax_band_intersectors(logs)
    jax_frame.assemble_training_batches = jax_band_batches(batches)
    _, system = _system()
    cfg = JCfg(encoding=JEnc.HASH, hash_shard_axis="data", **SMALL_GRID)
    jr = JRenderer(jax_cornell_scene(RES), system, net_cfg=cfg, render_mode=RenderMode.FULL, train=True,
                   adaptive_tiles=False)
    jp = JParallel(jr, make_mesh(int(world)))
    for _ in range(JAX_FRAMES):
        jp.render_frame()
    jax.effects_barrier()
    jax_save_render_state(str(path), jr)
    logs.clear()
    batches.clear()
    stats = jp.render_frame()
    out = {"image": np.asarray(jr.image)}
    jax.effects_barrier()
    out["loss"] = np.float32(stats.loss)
    out["records"] = np.int32(stats.num_train_records)
    after = jax.tree.map(np.asarray, jr.net_state)
    for w in ("w_in", "w_hidden", "w_out"):
        out[f"after.params.{w}"] = getattr(after.params, w)
        out[f"after.ema.{w}"] = getattr(after.ema, w)
    for band, (bq, bt, _) in batches.items():
        out[f"batch.{band}.q"], out[f"batch.{band}.t"] = bq, bt
    out.update(jax_band_entries(logs, "log."))
    return out


def resume_rank(rank, world, jax_file, out, **batch):
    """The JAX render state loaded into this rank and saved back (every
    rank; rank 0 writes ``out``), then the next frame on the JAX band's
    batches with this rank's rays logged."""
    r = _renderer()
    load_render_state(str(jax_file), r)
    save_render_state(str(out), r)
    log = []
    assemble = port_frame.assemble_training_batches

    def assemble_jax_batches(*args):
        _, _, n = assemble(*args)
        return torch.from_numpy(batch[f"batch.{rank}.q"].copy()), torch.from_numpy(batch[f"batch.{rank}.t"].copy()), n

    port_frame.assemble_training_batches = assemble_jax_batches
    port_integrator.make_intersectors = _recording_intersectors(log)
    port_frame.trace_wavefront = checked_at_full_width(port_frame.trace_wavefront, log)
    stats = r.render_frame()
    result = {"image": r.image.numpy().copy(), "loss": float(stats.loss), "records": int(stats.num_train_records)}
    result.update(N.state_to_numpy(r.net_state))
    result.update(_log_entries(log, "log"))
    return result


@pytest.mark.parametrize("world", WORLDS)
def test_jax_level_sharded_state_resumes_on_the_ranks(world, tmp_path):
    from test_torch_train_slice import SLICE_LIMITS

    jax_file, port_file = tmp_path / "jax_state.npz", tmp_path / "port_state.npz"
    jax_side = run_jax_side("test_torch_shard_state:jax_level_sharded_state", tmp_path, world=np.int32(world),
                            path=np.asarray(str(jax_file)))
    ranks = run_ranks("test_torch_shard_state:resume_rank", world, tmp_path, jax_file=str(jax_file),
                      out=str(port_file), **{k: v for k, v in jax_side.items() if k.startswith("batch.")})
    with np.load(jax_file) as f:
        ref = {k: f[k] for k in f.files}
    with np.load(port_file) as f:
        got = {k: f[k] for k in f.files}
    assert set(got) == set(ref)
    for key, want in ref.items():
        assert got[key].dtype == want.dtype and got[key].shape == want.shape, key
        assert got[key].tobytes() == want.tobytes(), key
    assert ref["net.grid.table"].shape[0] == SMALL_GRID["hash_n_levels"] and int(ref["render.iteration"]) == JAX_FRAMES
    readings = band_frame_readings(_prefixed(jax_side, "image", "loss", "records", "after.", "log."), ranks)
    print(f"{world} ranks, the frame after the JAX state: {readings}")
    over = {k: (v, SLICE_LIMITS[k]) for k, v in readings.items() if not v <= SLICE_LIMITS[k]}
    assert not over, f"the next frame's readings over their limits: {over}"
