"""Port parity for training with the hash encoding: ``train_step`` (the table
trained through the lookup's adjoint, Adam without the L2 term, its own EMA),
a frame without records, one 32x32 FULL + train frame, ``set_encoding`` and
npz checkpoints read across the packages, against the JAX package on the CPU.

The JAX side's MLP is the fused kernels' ``fused_apply`` in interpret mode,
installed with ``set_mlp_impl`` (``make_mlp_impl``): its dX is summed in f32,
as K4's is, where the XLA chain's autodiff would round it to bf16 before it
reaches the table. That side runs in a child process with synchronous
dispatch (``run_jax_side``; ``test_torch_jax_child.py`` says why: in the
test process an eager ``train_step``'s backward pass could deadlock against
interpret mode's callbacks). Weights and tables cross over with
``state_from_numpy``.
Each tolerance is stated next to its test with its reason and the largest
reading seen.

Why the state is held by means and shares: the hash encoding's Adam eps is
1e-15, so any nonzero gradient, a rounding residue included, moves its entry
by about lr = 1e-2 in the first steps; an entry whose tiny gradient differs
in sign between two sums of the same terms lands up to 2 lr a step apart.
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nrc_tpu.render.frame as jax_frame
import nrc_tpu.render.integrator as jax_integrator
import nrc_tpu_torch.render.frame as port_frame
import nrc_tpu_torch.render.integrator as port_integrator
from nrc_tpu.config import InputEncoding as JInputEncoding
from nrc_tpu.config import NetworkConfig as JNetworkConfig
from nrc_tpu.models import checkpoint as JCK
from nrc_tpu.models import network as JN
from nrc_tpu.models.checkpoint import _flatten
from nrc_tpu.ops import mlp_pallas as JMP
from nrc_tpu.render.renderer import Renderer as JRenderer
from nrc_tpu_torch.config import InputEncoding, NetworkConfig, RenderMode
from nrc_tpu_torch.models import checkpoint as CK
from nrc_tpu_torch.models import network as N
from nrc_tpu_torch.render.renderer import Renderer
from nrc_tpu_torch.scene.scene_builder import cornell_box
from test_torch_compact import checked_at_full_width
from test_torch_intersect import one_torch_thread  # noqa: F401 (an autouse fixture)
from test_torch_jax_child import flatten_log, run_jax_side, unflatten_log
from test_torch_scene import jax_cornell_scene
from test_torch_slice import _LOG, _interpret_plane_intersectors, _recording_port_intersectors
from test_torch_train_slice import _BATCHES, _flipped, _port_assemble_with_jax_batches, _recording_jax_assemble

RES = (32, 32)
TILE = (8, 8)
_GRID_KEYS = ("grid.table", "ema_grid.table", "opt.mu_grid", "opt.nu_grid")


@pytest.fixture(autouse=True, scope="module")
def fresh_xla_programs():
    """Compile the JAX side here, not from the persistent compilation cache
    (see test_torch_mlp.py)."""
    prev = jax.config.jax_enable_compilation_cache
    jax.config.update("jax_enable_compilation_cache", False)
    yield
    jax.config.update("jax_enable_compilation_cache", prev)


@contextlib.contextmanager
def fused_jax_mlp():
    """The JAX network's MLP through the TPU kernels in interpret mode (in
    the child process); reset after."""
    from jax.experimental.pallas import tpu as pltpu

    JN.set_mlp_impl(JMP.make_mlp_impl())
    try:
        with pltpu.force_tpu_interpret_mode():
            yield
    finally:
        JN.set_mlp_impl(None)


def _cfgs():
    return JNetworkConfig(encoding=JInputEncoding.HASH), NetworkConfig(encoding=InputEncoding.HASH)


def _queries(seed, *shape):
    rs = np.random.default_rng(seed)
    q = rs.random((*shape, 15), np.float32)
    q[..., :3] = (q[..., :3] - 0.5) * 0.1   # the frames' scaled positions
    t = (rs.random((*shape, 3)) * 2.0).astype(np.float32)
    return q, t


def _gaps(got: dict, ref: dict, keys) -> dict:
    """Per key: (mean |diff|, share of entries beyond 1e-3, largest |diff|)."""
    out = {}
    for k in keys:
        d = np.abs(np.asarray(got[k], np.float64) - np.asarray(ref[k], np.float64))
        out[k] = (d.mean(), (d > 1e-3).mean(), d.max())
    return out


# Four hash train_steps at B = 1024 from the same state, JAX's fused_apply in
# interpret mode. Readings, per tensor: losses 5.3e-5 relative at most (the
# fourth step; 1.5e-7 the first); the MLP's
# weights, EMA and moments mean |diff| 1.2e-5 at most, share beyond 1e-3
# 8.5e-4 (largest 4.5e-3: sign flips, see the module's docstring); the
# table, its EMA and moments mean 7.9e-6, share 7.0e-4 (largest 0.036).
STEP_LIMITS = {"loss_rel": 1e-3, "mlp_mean": 1e-4, "mlp_far": 1e-2, "grid_mean": 1e-4, "grid_far": 1e-2}


def _jax_hash_steps(q4, t4, lr):
    """Four JAX hash ``train_step``s from ``init_network(PRNGKey(0))``, the
    MLP through the TPU kernels in interpret mode (in the child process):
    the losses and the state's checkpoint keys."""
    jcfg, _ = _cfgs()
    js = JN.init_network(jax.random.PRNGKey(0), jcfg)
    losses = []
    with fused_jax_mlp():
        for k in range(4):
            js, jl = JN.train_step(js, jnp.asarray(q4[k]), jnp.asarray(t4[k]), jcfg, learning_rate=jnp.float32(lr))
            losses.append(np.asarray(jl))
    return {"losses": np.stack(losses), **{k: np.asarray(v) for k, v in _flatten(js).items()}}


def test_hash_train_step_matches_jax(tmp_path):
    jcfg, cfg = _cfgs()
    js0 = JN.init_network(jax.random.PRNGKey(0), jcfg)
    ps = N.state_from_numpy(jax.tree.map(np.asarray, js0))
    q4, t4 = _queries(1, 4, 1024)
    lr = np.float32(jcfg.learning_rate)
    ref = run_jax_side("test_torch_hash_train:_jax_hash_steps", tmp_path, q4=q4, t4=t4, lr=lr)
    jls = ref.pop("losses")
    for k in range(4):
        ps, pl = N.train_step(ps, torch.from_numpy(q4[k]), torch.from_numpy(t4[k]), cfg,
                              learning_rate=torch.tensor(lr))
        assert abs(float(pl) / float(jls[k]) - 1.0) <= STEP_LIMITS["loss_rel"], k
    got = N.state_to_numpy(ps)
    assert got.keys() == ref.keys() and int(got["opt.step"]) == 4
    over = {}
    for k, (mean, far, largest) in _gaps(got, ref, [k for k in ref if k != "opt.step"]).items():
        group = "grid" if k in _GRID_KEYS else "mlp"
        if not (mean <= STEP_LIMITS[f"{group}_mean"] and far <= STEP_LIMITS[f"{group}_far"]):
            over[k] = (mean, far, largest)
    assert not over, over
    # the table moved: Adam's first step moves every entry with a gradient by about lr
    moved = np.abs(got["grid.table"] - np.asarray(js0.grid.table))
    assert moved.max() > 0.5 * lr


def test_hash_train_step_without_l2_on_the_table():
    """The table's update has no L2 term and the MLP's has: one step from a
    state whose table and weights are large, with a zero gradient
    (loss_scale 0), moves the weights by Adam's normalised L2 step and leaves
    the table where it was."""
    _, cfg = _cfgs()
    st = N.init_network(torch.Generator().manual_seed(2), cfg)
    with torch.no_grad():
        st.grid.table.fill_(5.0)
    q, t = _queries(3, 64)
    new, _ = N.train_step(st, torch.from_numpy(q), torch.from_numpy(t), cfg, loss_scale=torch.tensor(0.0))
    assert torch.equal(new.grid.table, st.grid.table)
    assert not torch.equal(new.params.w_hidden, st.params.w_hidden)
    # the table's EMA follows the table: 0.99 e + 0.01 p
    assert torch.allclose(new.ema_grid.table, 0.99 * st.ema_grid.table + 0.01 * st.grid.table)


def test_hash_frame_without_records_changes_nothing():
    """``train_frame`` with zero records leaves every tensor of the hash
    state bit for bit, the step count too, and returns zero losses (the JAX
    package's ``lax.cond`` skip, here a select on the device)."""
    _, cfg = _cfgs()
    st = N.init_network(torch.Generator().manual_seed(5), cfg)
    q4, t4 = _queries(6, 4, 256)
    N.train_frame(st, torch.from_numpy(q4), torch.from_numpy(t4), torch.tensor(7), cfg, torch.tensor(1e-2))
    before = N.state_to_numpy(st)
    losses = N.train_frame(st, torch.from_numpy(q4), torch.from_numpy(t4), torch.tensor(0), cfg,
                           torch.tensor(1e-2))
    assert torch.equal(losses, torch.zeros(4))
    after = N.state_to_numpy(st)
    assert int(after["opt.step"]) == 4
    for k, v in before.items():
        assert np.asarray(after[k]).tobytes() == np.asarray(v).tobytes(), k


def test_hash_frame_updates_the_state_in_place():
    _, cfg = _cfgs()
    st = N.init_network(torch.Generator().manual_seed(8), cfg)
    ptrs = [t.data_ptr() for t in N.state_tensors(st)]
    q4, t4 = _queries(9, 4, 256)
    losses = N.train_frame(st, torch.from_numpy(q4), torch.from_numpy(t4), torch.tensor(3), cfg,
                           torch.tensor(1e-2))
    assert [t.data_ptr() for t in N.state_tensors(st)] == ptrs
    assert int(st.opt.step) == 4 and bool(torch.all(losses > 0))
    assert st.grid.table.requires_grad and st.opt.mu_grid.abs().max() > 0


def test_dropped_train_step_reads_above_the_replay_limits():
    """The planted fault of ``chip_smoke.py``'s replay check
    (``bench_hash.dropped_train_step``) on a 32x32 hash FULL + train frame
    on the CPU: two renderers from the same start read equal, within
    ``bench_hash.replay_within_limits``, and one whose frame drops a
    ``train_step`` reads above the state limits, one step short."""
    from nrc_tpu_torch.tools import bench_hash as BH

    _, cfg = _cfgs()
    scene, system = cornell_box(RES)
    system = dataclasses.replace(system, tile_size=TILE)
    ref, same, faulty = (Renderer(scene, system, net_cfg=cfg, render_mode=RenderMode.FULL, adaptive_tiles=False,
                                  device="cpu") for _ in range(3))
    ref.render_frame()
    same.render_frame()
    with BH.dropped_train_step():
        faulty.render_frame()
    assert int(ref.last_stats.num_train_records) > 0
    gap = BH.frame_gap(same, ref)
    assert BH.replay_within_limits(gap) and gap["loss"] == gap["mean"] == gap["far"] == 0.0, gap
    bad = BH.frame_gap(faulty, ref)
    assert BH.replay_state_above_limits(bad) and not BH.replay_within_limits(bad), bad
    assert bad["image_equal"] and bad["counts_equal"] and not bad["step_equal"]
    assert int(faulty.net_state.opt.step) == 3 and N._train_frame_steps.__name__ == "_train_frame_steps"


# ---------------------------------------------------------------------------
# one FULL + train frame against the JAX package
# ---------------------------------------------------------------------------

# Limits of one 32x32 FULL + train hash frame from the JAX state, the port
# training on the JAX frame's batches, both MLPs through the fused kernels'
# arithmetic. Readings: render rays flipped 0.0020 (test_torch_slice.py's
# bound); image where neither side flipped 3.5e-4 largest, 4.8e-7 mean
# relative; records equal; loss 8.9e-8 relative; weights mean 3.5e-7, share
# beyond 1e-3 0, EMA mean 1.3e-8; table and its EMA mean 3.2e-6, share 1.2e-4.
FRAME_LIMITS = {
    "flipped_share": 0.02,
    "image_kept_abs": 2e-2,
    "image_kept_mean_rel": 1e-4,
    "records_gap": 8,
    "loss_rel": 1e-4,
    "params_mean": 1e-5, "params_far": 1e-2,
    "ema_mean": 1e-6,
    "grid_mean": 1e-4, "grid_far": 5e-3,
}


def _jax_hash_frame():
    """One 32x32 FULL + train hash frame of the JAX renderer (in the child
    process): the plane kernels through the HLO interpreter with both kinds
    of ray logged, the MLP through the TPU kernels in interpret mode, the
    assembled batches recorded. Returns the image, the frame's stats, the
    state before (``init.``) and after (``state.``), the rays logged and the
    batches."""
    jcfg, _ = _cfgs()
    _, system = cornell_box(RES)
    system = dataclasses.replace(system, tile_size=TILE)
    jax_integrator.make_intersectors = _interpret_plane_intersectors
    jax_frame.assemble_training_batches = _recording_jax_assemble(jax_frame.assemble_training_batches)
    with fused_jax_mlp():
        jr = JRenderer(jax_cornell_scene(RES), system, net_cfg=jcfg, render_mode=RenderMode.FULL,
                       train=True, adaptive_tiles=False)
        init = {f"init.{k}": np.asarray(v) for k, v in _flatten(jr.net_state).items()}
        _LOG["jax"].clear()
        jstats = jr.render_frame()
        image = np.asarray(jr.image)
        jax.effects_barrier()
    return {"image": image, "num_train_records": np.asarray(jstats.num_train_records),
            "loss": np.asarray(jstats.loss), **init,
            **{f"state.{k}": np.asarray(v) for k, v in _flatten(jr.net_state).items()},
            **flatten_log(_LOG["jax"]), **{f"batch.{i}": np.asarray(b) for i, b in enumerate(_BATCHES["jax"])}}


def test_hash_full_train_frame_matches_jax(tmp_path):
    jcfg, cfg = _cfgs()
    res = run_jax_side("test_torch_hash_train:_jax_hash_frame", tmp_path)
    scene, system = cornell_box(RES)
    system = dataclasses.replace(system, tile_size=TILE)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_integrator, "make_intersectors",
                   _recording_port_intersectors(port_integrator.make_intersectors))
        mp.setattr(port_frame, "trace_wavefront", checked_at_full_width(port_frame.trace_wavefront, _LOG["port"]))
        mp.setattr(port_frame, "assemble_training_batches",
                   _port_assemble_with_jax_batches(port_frame.assemble_training_batches))
        mp.setitem(_BATCHES, "jax", [res[f"batch.{i}"] for i in range(3)])
        pr = Renderer(scene, system, net_cfg=cfg, render_mode=RenderMode.FULL, adaptive_tiles=False,
                      device="cpu")
        pr.net_state = N.state_from_numpy({k[5:]: v for k, v in res.items() if k.startswith("init.")})
        _LOG["jax"][:] = unflatten_log(res)
        _LOG["port"].clear()
        pstats = pr.render_frame()
    ref = res["image"]
    jax_state = {k[6:]: v for k, v in res.items() if k.startswith("state.")}
    out = pr.image.numpy()
    assert np.isfinite(out).all() and out.std() > 0.0
    assert int(pr.net_state.opt.step) == int(jax_state["opt.step"]) == 4
    assert int(res["num_train_records"]) > 0
    keep = ~_flipped(_LOG["jax"], _LOG["port"], RES[0] * RES[1])
    got = {
        "flipped_share": 1.0 - keep.mean(),
        "image_kept_abs": np.abs(out - ref)[keep].max(),
        "image_kept_mean_rel": abs(out[keep].mean() / ref[keep].mean() - 1.0),
        "records_gap": abs(int(pstats.num_train_records) - int(res["num_train_records"])),
        "loss_rel": abs(float(pstats.loss) / float(res["loss"]) - 1.0),
    }
    port_state = N.state_to_numpy(pr.net_state)
    gaps = _gaps(port_state, jax_state, [k for k in jax_state if k != "opt.step"])
    got["params_mean"] = max(gaps[f"params.{w}"][0] for w in ("w_in", "w_hidden", "w_out"))
    got["params_far"] = max(gaps[f"params.{w}"][1] for w in ("w_in", "w_hidden", "w_out"))
    got["ema_mean"] = max(gaps[f"ema.{w}"][0] for w in ("w_in", "w_hidden", "w_out"))
    got["grid_mean"] = max(gaps[k][0] for k in ("grid.table", "ema_grid.table"))
    got["grid_far"] = max(gaps[k][1] for k in ("grid.table", "ema_grid.table"))
    over = {k: (v, FRAME_LIMITS[k]) for k, v in got.items() if not v <= FRAME_LIMITS[k]}
    assert not over, f"readings over their limits: {over}"


# ---------------------------------------------------------------------------
# set_encoding and checkpoints
# ---------------------------------------------------------------------------

def test_set_encoding_resolves_like_jax():
    """lr, EMA decay and Adam eps re-resolve per encoding as the JAX
    renderer's ``set_encoding`` does; the graphs are dropped, the state is
    bound anew (another shape), accumulation restarts."""
    scene, system = cornell_box(RES)
    jr = JRenderer(jax_cornell_scene(RES), system, adaptive_tiles=False)
    pr = Renderer(scene, system, adaptive_tiles=False, device="cpu")
    pr.render_frame()
    pr.graphs[("stale",)] = None
    old_state = pr.net_state
    for enc, name in ((InputEncoding.HASH, "HASH"), ("frequency", "FREQUENCY"), ("hash", "HASH")):
        jr.set_encoding(enc if isinstance(enc, str) else JInputEncoding[name])
        pr.set_encoding(enc)
        assert pr.net_cfg.encoding == InputEncoding[name]
        for key in ("learning_rate", "ema_decay", "adam_eps"):
            assert getattr(pr.net_cfg, key) == getattr(jr.net_cfg, key), (name, key)
        assert pr.hyper.learning_rate == jr.hyper.learning_rate
        assert float(pr.learning_rate) == np.float32(jr.hyper.learning_rate)
        assert not pr.graphs and pr.iteration == 0 and not pr.image.any()
        assert (pr.net_state.grid is not None) == (name == "HASH")
        assert pr.net_state is not old_state
        old_state = pr.net_state
    assert (pr.net_cfg.ema_decay, pr.net_cfg.adam_eps, pr.net_cfg.learning_rate) == (0.99, 1e-15, 1e-2)
    same = pr.net_state
    pr.set_encoding(InputEncoding.HASH)  # no change: nothing happens
    assert pr.net_state is same
    # a hash state of the same shapes is copied in; the frequency state is refused
    pr.net_state = N.init_network(torch.Generator().manual_seed(9), pr.net_cfg)
    assert pr.net_state is same
    with pytest.raises(ValueError):
        pr.net_state = N.init_network(torch.Generator(), NetworkConfig())
    pr.reset_cache(seed=3)
    want = N.state_to_numpy(N.init_network(torch.Generator().manual_seed(3), pr.net_cfg))
    assert all(np.array_equal(v, want[k]) for k, v in N.state_to_numpy(pr.net_state).items())
    pr.render_frame()
    assert int(pr.net_state.opt.step) == 4


@pytest.mark.parametrize("encoding", ["hash", "frequency"])
def test_npz_checkpoints_read_across_packages(encoding, tmp_path):
    jcfg = JNetworkConfig(encoding=JInputEncoding[encoding.upper()])
    cfg = NetworkConfig(encoding=InputEncoding[encoding.upper()])
    js = JN.init_network(jax.random.PRNGKey(4), jcfg)
    # JAX writes, the port reads
    path = JCK.save_checkpoint(str(tmp_path / "jax"), js)
    ps = CK.load_checkpoint(path, cfg)
    ref = {k: np.asarray(v) for k, v in _flatten(js).items()}
    got = N.state_to_numpy(ps)
    assert got.keys() == ref.keys()
    assert (_GRID_KEYS[0] in got) == (encoding == "hash")
    for k, v in ref.items():
        assert np.array_equal(got[k], v), k
    # the port writes (after a training step), JAX reads
    q, t = _queries(10, 128)
    ps, _ = N.train_step(ps, torch.from_numpy(q), torch.from_numpy(t), cfg)
    path = CK.save_checkpoint(str(tmp_path / "port"), ps)
    back = {k: np.asarray(v) for k, v in _flatten(JCK.load_checkpoint(path, jcfg)).items()}
    for k, v in N.state_to_numpy(ps).items():
        assert np.array_equal(back[k], v) and back[k].dtype == v.dtype, k
    assert int(back["opt.step"]) == 1
    other = NetworkConfig(encoding=InputEncoding.FREQUENCY if encoding == "hash" else InputEncoding.HASH)
    with pytest.raises(ValueError, match="encoding"):
        CK.load_checkpoint(path, other)
