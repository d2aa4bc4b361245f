"""Port parity for the training half: the plain versions of kernels K4-K6,
``train_step``, propagation, batch assembly, the record-slot helpers and the
tonemapper, against the JAX package on the CPU; and the renderer's training
state (lagged stats, adaptive tiles, hyper-parameters, cache reset).

The JAX kernels run in interpret mode (``force_tpu_interpret_mode``, as
``tests/test_mlp_pallas.py`` runs them), in a child process with synchronous
dispatch (``test_torch_jax_child.py`` says why); inputs are made with numpy from a
seed and weights cross over with ``state_from_numpy``. Each tolerance is
stated next to its test with its reason and the largest reading seen.
"""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nrc_tpu.config import NetworkConfig as JNetworkConfig
from nrc_tpu.config import TonemapperConfig as JTonemapperConfig
from nrc_tpu.models import network as JN
from nrc_tpu.models.checkpoint import _flatten
from nrc_tpu.ops import mlp_pallas as JMP
from nrc_tpu.render import frame as JF
from nrc_tpu.utils import math as JM
from nrc_tpu.utils.tonemap import tonemap as jax_tonemap
from nrc_tpu_torch.config import (
    BATCH_SIZE,
    NUM_BATCHES,
    NetworkConfig,
    RenderMode,
    TonemapperConfig,
)
from nrc_tpu_torch.models import network as N
from nrc_tpu_torch.ops import mlp_cuda as MC
from nrc_tpu_torch.render import frame as F
from nrc_tpu_torch.render.renderer import Renderer
from nrc_tpu_torch.scene.scene_builder import cornell_box
from nrc_tpu_torch.utils import math as M
from nrc_tpu_torch.utils.tonemap import tonemap
from test_torch_intersect import one_torch_thread  # noqa: F401 (an autouse fixture)
from test_torch_jax_child import run_jax_side

# An activation whose f32 sum lands next to a bf16 rounding boundary rounds
# one bf16 ulp (2^-8 relative) apart when the sum is taken in another order,
# and moves the gradients of everything it feeds. Largest reading, gradients
# relative to the largest entry: 4.6e-4 (K4), 0 (K5).
GRAD_TOL = 2e-3


@pytest.fixture(autouse=True, scope="module")
def fresh_xla_programs():
    """Compile the JAX side here, not from the persistent compilation cache
    (see test_torch_mlp.py)."""
    prev = jax.config.jax_enable_compilation_cache
    jax.config.update("jax_enable_compilation_cache", False)
    yield
    jax.config.update("jax_enable_compilation_cache", prev)


@pytest.fixture(scope="module")
def jax_state():
    return JN.init_network(jax.random.PRNGKey(0), JNetworkConfig())


def _weights(mlp):
    return [np.asarray(a) for a in (mlp.w_in, mlp.w_hidden, mlp.w_out)]


def _rel(got, ref) -> float:
    """Largest difference relative to the reference's largest entry."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


def _queries(rs, *shape):
    return rs.random((*shape, 15), np.float32)


def _listed(out: dict) -> list:
    """A child's results r0, r1, ... in order."""
    return [out[f"r{i}"] for i in range(len(out))]


def _numbered(results) -> dict:
    return {f"r{i}": a for i, a in enumerate(results)}


def _weight_arrays(prefix, w):
    return {f"{prefix}{i}": a for i, a in enumerate(w)}


def _triple(arrays, prefix):
    return [arrays[f"{prefix}{i}"] for i in range(3)]


# the JAX sides of the kernel comparisons, run in the child process
# (run_jax_side) under TPU interpret mode

def _jax_k4(x, g, **w):
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        return _numbered(JMP.fused_backward(*_triple(w, "w"), x, g))


def _jax_fused_apply_vjp(x, g, output_relu, **w):
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        out, vjp = jax.vjp(lambda *a: JMP.fused_apply(*a, bool(output_relu)), *_triple(w, "w"), x)
        return {"out": out, **_numbered(vjp(jnp.asarray(g)))}  # dw_in, dw_h, dw_out, dx


def _jax_k5(x, t, **w):
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        return _numbered(JMP.fused_train_grad(*_triple(w, "w"), x, t))


def _jax_k6(x4, t4, lr, step, **w):
    from jax.experimental.pallas import tpu as pltpu

    # B = 1024 in two grid steps of the TPU kernel, as test_mlp_pallas.py cuts it
    JMP.HALF = 128
    JMP.TILE_T4 = JMP.STREAMS * 2 * 128
    with pltpu.force_tpu_interpret_mode():
        losses, *states = JMP.fused_train4(*_triple(w, "w"), _triple(w, "mu"), _triple(w, "nu"), _triple(w, "ema"),
                                           x4, t4, lr, step)
    return {"losses": losses, **{f"{k}{i}": a for k, triple in zip(("w", "mu", "nu", "ema"), states)
                                 for i, a in enumerate(triple)}}


# ---------------------------------------------------------------------------
# record-slot helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("trailing", [(), (3,)], ids=["2d", "3d"])
def test_slot_helpers_match_jax(trailing):
    rs = np.random.default_rng(0)
    n, k = 64, 8
    x = rs.normal(size=(n, k, *trailing)).astype(np.float32)
    x[0] = -0.0
    v = rs.normal(size=(n, *trailing)).astype(np.float32)
    idx = rs.integers(0, k, n)
    mask = rs.random(n) < 0.5
    tx, tv, ti, tm = (torch.from_numpy(a) for a in (x, v, idx, mask))
    np.testing.assert_array_equal(M.pick1(tx, ti).numpy(), np.asarray(JM.pick1(x, idx)))
    put = M.put1(tx, ti, tv, tm).numpy()
    np.testing.assert_array_equal(put, np.asarray(JM.put1(x, idx, v, mask)))
    add = M.add1(tx, ti, tv, tm).numpy()
    np.testing.assert_array_equal(add, np.asarray(JM.add1(x, idx, v, mask)))  # -0.0 == 0.0
    # every slot but the selected one of a masked-in lane keeps its bits
    touched = (np.arange(k)[None, :] == idx[:, None]) & mask[:, None]
    for out in (put, add):
        assert np.array_equal(out[~touched].view(np.int32), x[~touched].view(np.int32))


# ---------------------------------------------------------------------------
# K4, K5, K6 plain versions against the TPU kernels
# ---------------------------------------------------------------------------

def test_plain_k4_matches_tpu_kernel(jax_state, tmp_path):
    rs = np.random.default_rng(1)
    x = rs.normal(size=(1000, MC.LANE)).astype(np.float32)
    g = rs.normal(size=(1000, MC.OUT_PAD)).astype(np.float32)
    w = _weights(jax_state.params)
    ref = _listed(run_jax_side("test_torch_train:_jax_k4", tmp_path, x=x, g=g, **_weight_arrays("w", w)))
    got = MC.fused_backward_plain(*(torch.from_numpy(a) for a in w), torch.from_numpy(x),
                                  torch.from_numpy(g))
    for name, a, b in zip(("dx", "dw_in", "dw_h", "dw_out"), got, ref):
        assert a.shape == b.shape and a.dtype == torch.float32
        assert _rel(a.numpy(), b) <= GRAD_TOL, name


@pytest.mark.parametrize("output_relu", [True, False])
def test_fused_mlp_autograd_matches_fused_apply(jax_state, output_relu, tmp_path):
    """``FusedMLP`` (K3 forward, output-ReLU mask, K4 backward) against the
    VJP of JAX's ``fused_apply``."""
    rs = np.random.default_rng(2)
    x = rs.normal(size=(1000, MC.LANE)).astype(np.float32)
    g = rs.normal(size=(1000, MC.OUT_PAD)).astype(np.float32)
    w = _weights(jax_state.params)
    res = run_jax_side("test_torch_train:_jax_fused_apply_vjp", tmp_path, x=x, g=g,
                       output_relu=np.bool_(output_relu), **_weight_arrays("w", w))
    out_ref = res.pop("out")
    ref = _listed(res)  # dw_in, dw_h, dw_out, dx
    leaves = [torch.tensor(a, requires_grad=True) for a in (*w, x)]
    out = MC.FusedMLP.apply(*leaves, output_relu)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_ref), atol=1e-2, rtol=1e-2)
    out.backward(torch.from_numpy(g))
    for name, a, b in zip(("dw_in", "dw_h", "dw_out", "dx"), leaves, ref):
        assert _rel(a.grad.numpy(), b) <= GRAD_TOL, name


def test_plain_k5_matches_tpu_kernel(jax_state, tmp_path):
    rs = np.random.default_rng(3)
    x = np.asarray(JN.encode(_queries(rs, 512), JNetworkConfig(), None))
    t = rs.random((512, 3), np.float32)
    w = _weights(jax_state.params)
    ref = _listed(run_jax_side("test_torch_train:_jax_k5", tmp_path, x=x, t=t, **_weight_arrays("w", w)))
    got = MC.fused_train_grad_plain(*(torch.from_numpy(a) for a in w), torch.from_numpy(x),
                                    torch.from_numpy(t))
    # the loss is one f32 sum over 1536 terms: 1e-7 relative seen
    np.testing.assert_allclose(float(got[0]), float(ref[0]), rtol=1e-5)
    for name, a, b in zip(("dw_in", "dw_h", "dw_out"), got[1:], ref[1:]):
        assert _rel(a.numpy(), b) <= GRAD_TOL, name


def _train4_inputs(seed, b):
    rs = np.random.default_rng(seed)
    q4 = _queries(rs, 4, b)
    t4 = (rs.random((4, b, 3)) * 2.0).astype(np.float32)
    x4 = np.stack([np.asarray(JN.encode(q, JNetworkConfig(), None)) for q in q4])
    return q4, t4, x4


def _port_train4(state, x4, t4, num_records):
    cfg = NetworkConfig()
    lr = torch.tensor(cfg.learning_rate, dtype=torch.float32)
    with torch.no_grad():
        return MC.fused_train4(
            state.params.tensors(), state.opt.mu.tensors(), state.opt.nu.tensors(),
            state.ema.tensors(), state.opt.step, torch.from_numpy(x4), torch.from_numpy(t4),
            lr, torch.tensor(num_records), N.adam_hyper(cfg),
        )


def test_plain_k6_matches_tpu_kernel(jax_state, tmp_path):
    # B = 1024 in two grid steps of the TPU kernel (_jax_k6 cuts it as test_mlp_pallas.py does)
    _, t4, x4 = _train4_inputs(4, 1024)
    s = jax_state
    tri = _weights
    res = run_jax_side(
        "test_torch_train:_jax_k6", tmp_path, x4=x4, t4=t4, lr=np.float32(JNetworkConfig().learning_rate),
        step=np.asarray(s.opt.step), **_weight_arrays("w", tri(s.params)), **_weight_arrays("mu", tri(s.opt.mu)),
        **_weight_arrays("nu", tri(s.opt.nu)), **_weight_arrays("ema", tri(s.ema)),
    )
    losses = res["losses"]
    w, mu, nu, ema = (_triple(res, k) for k in ("w", "mu", "nu", "ema"))
    state = N.state_from_numpy(jax.tree.map(np.asarray, s))
    got = _port_train4(state, x4, t4, 900)
    # 4 sequential steps: 7e-7 relative seen on the losses, 5.4e-5 on the state
    np.testing.assert_allclose(got.numpy(), np.asarray(losses), rtol=1e-4)
    for name, port, ref in (("w", state.params, w), ("mu", state.opt.mu, mu),
                            ("nu", state.opt.nu, nu), ("ema", state.ema, ema)):
        for a, b in zip(port.tensors(), ref):
            assert _rel(a.detach().numpy(), b) <= 1e-3, name
    assert int(state.opt.step) == 4


def test_k6_without_records_changes_nothing(jax_state):
    _, t4, x4 = _train4_inputs(5, 256)
    state = N.state_from_numpy(jax.tree.map(np.asarray, jax_state))
    before = N.state_to_numpy(state)
    losses = _port_train4(state, x4, t4, 0)
    assert torch.equal(losses, torch.zeros(4))
    after = N.state_to_numpy(state)
    for k, v in before.items():
        assert np.array_equal(after[k], v), k


def test_cpu_tensors_take_the_plain_versions(jax_state):
    _, t4, x4 = _train4_inputs(6, 128)
    state = N.state_from_numpy(jax.tree.map(np.asarray, jax_state))
    _port_train4(state, x4, t4, 3)
    w = state.params.tensors()
    MC.fused_train_grad(*w, torch.from_numpy(x4[0]), torch.from_numpy(t4[0]))
    MC.fused_backward(*w, torch.from_numpy(x4[0]), torch.zeros(128, MC.OUT_PAD))
    for k in (MC.BACKWARD_KERNEL, MC.TRAIN_GRAD_KERNEL, MC.TRAIN4_KERNEL):
        assert k.launches == 0 and k._fn is None  # nothing was built


# ---------------------------------------------------------------------------
# loss, train_step, state exchange
# ---------------------------------------------------------------------------

def test_relative_l2_luminance_matches_jax():
    rs = np.random.default_rng(7)
    p = rs.normal(size=(300, 3)).astype(np.float32)
    t = rs.random((300, 3), np.float32)
    ref, ref_g = jax.value_and_grad(JN.relative_l2_luminance)(p, t)
    tp = torch.tensor(p, requires_grad=True)
    loss = N.relative_l2_luminance(tp, torch.from_numpy(t))
    loss.backward()
    np.testing.assert_allclose(float(loss), float(ref), rtol=1e-6)
    # the denominator is held constant: the gradient is 2 (p - t) / denom / n
    np.testing.assert_allclose(tp.grad.numpy(), np.asarray(ref_g), rtol=1e-5, atol=1e-9)


def test_train_step_matches_jax(jax_state):
    """Four ``train_step``s from the same state. JAX's autodiff of its XLA
    chain returns every weight gradient rounded to bf16 (the cotangent of a
    bf16 operand); the port's K4 sums them in f32, as the TPU kernels do.
    Adam's first steps move each weight by about lr = 3e-3 whatever the
    gradient's size, so a weight whose tiny gradient differs in sign moves
    up to 2 lr per step apart, so the largest differences say little and
    the means carry the check. Readings: losses 1e-3 relative; weights
    1.1e-2 at most (8 lr = 2.4e-2), 2.3e-5 on the mean; EMA 1.2e-3 at most,
    2.2e-6 on the mean; moments 6e-3 relative. A port whose last step skips
    its EMA update reads 7.5e-5 to 4.0e-4 on the EMA's means; one that skips
    its last Adam update reads 2.9e-4 to 1.7e-3 on the weights' means and
    0.11 on the first moment."""
    q4, t4, _ = _train4_inputs(8, 1024)
    jcfg, cfg = JNetworkConfig(), NetworkConfig()
    lr = np.float32(jcfg.learning_rate)
    js = jax_state
    ps = N.state_from_numpy(jax.tree.map(np.asarray, js))
    for k in range(4):
        js, jl = JN.train_step(js, jnp.asarray(q4[k]), jnp.asarray(t4[k]), jcfg,
                               learning_rate=jnp.float32(lr))
        ps, pl = N.train_step(ps, torch.from_numpy(q4[k]), torch.from_numpy(t4[k]), cfg,
                              learning_rate=torch.tensor(lr))
        np.testing.assert_allclose(float(pl), float(jl), rtol=5e-3)
    ref = {k: np.asarray(v) for k, v in _flatten(js).items()}
    got = N.state_to_numpy(ps)
    assert got.keys() == ref.keys() and int(got["opt.step"]) == 4
    for key, a in got.items():
        d = np.abs(a - ref[key])
        if key.startswith("params."):
            assert d.max() <= 8 * lr and d.mean() <= 1e-4, (key, d.max(), d.mean())
        elif key.startswith("ema."):
            assert d.max() <= 5e-3 and d.mean() <= 1e-5, (key, d.max(), d.mean())
        elif key.startswith("opt.m") or key.startswith("opt.n"):
            assert _rel(a, ref[key]) <= 2e-2, key


def test_state_to_numpy_round_trips(jax_state):
    flat = {k: np.asarray(v) for k, v in _flatten(jax_state).items()}
    state = N.state_from_numpy(flat)
    back = N.state_to_numpy(state)
    assert back.keys() == flat.keys()
    for k, v in flat.items():
        assert np.array_equal(back[k], v) and back[k].dtype == v.dtype, k
    assert all(p.requires_grad for p in state.params.parameters())
    assert not any(p.requires_grad for p in state.ema.parameters())


# ---------------------------------------------------------------------------
# propagation and batch assembly
# ---------------------------------------------------------------------------

def test_propagate_radiance_matches_jax():
    rs = np.random.default_rng(9)
    t, d = 50, 8
    target = rs.random((t, d, 3), np.float32)
    ltp = rs.random((t, d, 3), np.float32)
    count = rs.integers(0, d + 1, t)
    count[:5] = 0                      # tiles without records
    end = rs.random((t, 3), np.float32) * 4.0
    mask = (rs.random(t) < 0.7).astype(np.float32)
    mask[5:10] = 0.0                   # unbiased ends
    ref = np.asarray(JF.propagate_radiance(
        *(jnp.asarray(a) for a in (target, ltp, count.astype(np.int32), end, mask))
    ))
    got = F.propagate_radiance(*(torch.from_numpy(a) for a in (target, ltp, count, end, mask))).numpy()
    # the same multiply-adds in the same order: f32 rounding only
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)
    np.testing.assert_array_equal(got[:5], target[:5])
    untouched = np.arange(d)[None, :] >= count[:, None]
    np.testing.assert_array_equal(got[untouched], target[untouched])


def _records(seed, t=300, d=8):
    rs = np.random.default_rng(seed)
    q = rs.random((t, d, 15), np.float32)
    tg = rs.random((t, d, 3), np.float32)
    count = rs.integers(0, d + 1, t)
    return q, tg, count


@pytest.mark.parametrize("seed,tiles", [(10, 300), (11, 7), (12, 20000)])
def test_assemble_training_batches(seed, tiles):
    q, tg, count = _records(seed, tiles)
    _, _, ref_n = JF.assemble_training_batches(jax.random.PRNGKey(0), q, tg, count.astype(np.int32))
    args = (torch.from_numpy(q), torch.from_numpy(tg), torch.from_numpy(count))
    bq, bt, n = F.assemble_training_batches(3, *args)
    assert int(n) == int(ref_n) == count.sum()
    assert bq.shape == (NUM_BATCHES, BATCH_SIZE, 15) and bt.shape == (NUM_BATCHES, BATCH_SIZE, 3)
    valid = np.arange(q.shape[1])[None, :] < count[:, None]
    rows = np.concatenate([q[valid], tg[valid]], axis=-1)
    drawn = np.concatenate([bq.reshape(-1, 15).numpy(), bt.reshape(-1, 3).numpy()], axis=-1)
    index = {r.tobytes(): i for i, r in enumerate(rows)}
    assert len(index) == len(rows)
    hits = collections.Counter(index[r.tobytes()] for r in drawn)  # KeyError: not a record
    total = NUM_BATCHES * BATCH_SIZE
    lo, hi = total // len(rows), -(-total // len(rows))
    assert set(hits.values()) <= {lo, hi} and sum(hits.values()) == total
    assert len(hits) == min(len(rows), total)
    again = F.assemble_training_batches(3, *args)
    assert torch.equal(again[0], bq) and torch.equal(again[1], bt)
    other = F.assemble_training_batches(4, *args)
    assert not torch.equal(other[0], bq)


def test_assemble_without_records():
    q, tg, count = _records(13, 10)
    bq, bt, n = F.assemble_training_batches(0, *(torch.from_numpy(a) for a in (q, tg, 0 * count)))
    assert int(n) == 0 and not bq.any() and not bt.any()


def test_tonemap_matches_jax():
    rs = np.random.default_rng(14)
    hdr = (rs.random((64, 64, 3)) ** 3 * 8.0).astype(np.float32)
    hdr[0, :8] = 0.0
    ref = np.asarray(jax_tonemap(jnp.asarray(hdr), JTonemapperConfig()))
    got = tonemap(torch.from_numpy(hdr), TonemapperConfig()).numpy()
    # pow/sqrt in another library: a few f32 ulp
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    assert got.min() >= 0.0 and got.max() <= 1.0


def test_renderer_training_state():
    """Lagged stats, adaptive tiles, hyper-parameter edits and cache reset."""
    scene, system = cornell_box((32, 32))  # 16x16 tiles: 4 training rays
    r = Renderer(scene, system, render_mode=RenderMode.FULL, device="cpu")
    assert r.cfg.train and r.adaptive_tiles and r.cfg.tile_size == (16, 16)
    init = N.state_to_numpy(r.net_state)
    stats = [r.render_frame() for _ in range(4)]
    assert all(isinstance(s.loss, torch.Tensor) and s.num_train_records.dtype == torch.int64
               for s in stats)
    # frame t's count is read after frame t + 2: two reads so far, both of
    # a handful of records, so the tiles shrink to 2x2 (Device.cpp:818-828)
    assert len(r.loss_history) == 2 and r.cfg.tile_size == (2, 2)
    r.flush_stats()
    assert list(r.loss_history) == [float(s.loss) for s in stats]
    assert int(r.net_state.opt.step) == 16
    r.set_hyper_params(learning_rate=5e-3, train_unbiased_ratio=0.5, area_spread_factor=0.04)
    assert float(r.learning_rate) == np.float32(5e-3) and r.cfg.train_unbiased_ratio == 0.5
    assert abs(r.cfg.area_spread_sqrt - 0.2) < 1e-9
    r.render_frame()
    r.reset_cache()
    for k, v in N.state_to_numpy(r.net_state).items():
        assert np.array_equal(v, init[k]), k
    res = r.benchmark(2)
    assert res["mrays_per_s"] > 0 and res["loss"] > 0.0
