"""What the card's checks of the tensor-core MLP kernels K3-K6 rest on.

No card is needed. The kernels sum every product in steps of 16 along its
depth (one ``mma.sync m16n8k16`` per step, f32 sums); the weight gradients
sum 16 batch rows per step, eight steps per 128-row CTA, and the CTAs'
partial sums in CTA order. ``tiled_*`` below compute K3's and K5's functions
in that order in float32, and are held against the plain versions
(``fused_forward_plain``, ``fused_train_grad_plain``) under the limits that
``chip_smoke.py`` and ``tests/test_torch_cuda.py`` put on the kernels
(``tools/bench_mlp.py::CARD_LIMITS``): another order of summation alone stays
inside them. Seeded faults (a layer's ReLU mask dropped, the last EMA update
skipped, one Adam step skipped; for K6's persistent kernel a step on stale
weights and one CTA's rows dropped from a step's sum) read above them. The
plain versions
themselves are held against the JAX package in ``tests/test_torch_mlp.py``
and ``tests/test_torch_train.py``.

The shared-memory layout of the kernels (padded bf16 rows) is known to the
sources alone (``csrc/mma_tiles.cuh``, ``mlp_grad.cuh::smem_bytes``); its
mirror below, built from the sources' own constants, holds it to the card's
limit per CTA and ``MAX_HIDDEN`` / ``MAX_HIDDEN_GRAD`` of the wrappers to it.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from nrc_tpu_torch.config import NetworkConfig
from nrc_tpu_torch.models import network as N
from nrc_tpu_torch.ops import mlp_cuda as MC
from nrc_tpu_torch.tools import bench_mlp as BM
from test_torch_intersect import one_torch_thread  # noqa: F401 (an autouse fixture)

LIM = BM.CARD_LIMITS
CSRC = Path(MC.__file__).resolve().parents[1] / "csrc"


def _mm16(a, w):
    """a [B, K] @ w [K, N], the depth summed 16 at a time into a running
    float32 sum: the order of a chain of m16n8k16 steps."""
    acc = torch.zeros((a.shape[0], w.shape[1]))
    for k in range(0, a.shape[1], 16):
        acc = acc + a[:, k:k + 16] @ w[k:k + 16]
    return acc


def _at_g_tiled(a, g):
    """a^T g over the batch as the gradient kernels sum it: 16 rows per step,
    eight steps per 128-row CTA, then the CTAs' partial sums in order."""
    pad = -a.shape[0] % MC.GRAD_ROWS
    a = torch.cat([a, a.new_zeros((pad, a.shape[1]))]).view(-1, 8, 16, a.shape[1])
    g = torch.cat([g, g.new_zeros((pad, g.shape[1]))]).view(-1, 8, 16, g.shape[1])
    steps = torch.einsum("cqrk,cqrj->cqkj", a, g)
    total = torch.zeros(steps.shape[2:])
    for cta in steps:
        part = torch.zeros_like(total)
        for step in cta:
            part = part + step
        total = total + part
    return total


def tiled_forward(w_in, w_h, w_out, x, output_relu):
    a = MC._bf16(x)
    for w in [w_in, *w_h]:
        a = MC._bf16(torch.relu(_mm16(a, MC._bf16(w))))
    out = _mm16(a, MC._bf16(w_out))
    return torch.relu(out) if output_relu else out


def tiled_train_grad(w_in, w_h, w_out, x, target, drop_mask=None):
    """K5's function in the kernels' order of summation. ``drop_mask`` names a
    layer whose ReLU mask the backward pass leaves out (a seeded fault)."""
    a0 = MC._bf16(x)
    acts, a = [], a0
    for w in [w_in, *w_h]:
        a = MC._bf16(torch.relu(_mm16(a, MC._bf16(w))))
        acts.append(a)
    pred = _mm16(a, MC._bf16(w_out))[:, :3]
    inv_count = 1.0 / float(x.shape[0] * 3)
    lum = 0.299 * pred[:, 0:1] + 0.587 * pred[:, 1:2] + 0.114 * pred[:, 2:3]
    denom = lum * lum + 0.01
    diff = pred - target
    loss = (diff * diff / denom).sum() * inv_count
    g = torch.zeros((x.shape[0], MC.OUT_PAD))
    g[:, :3] = MC._bf16((2.0 * inv_count) * diff / denom)
    grads = []
    for i, w in reversed(list(enumerate([*w_h, w_out]))):
        grads.append(_at_g_tiled(acts[i], g))
        back = _mm16(g, MC._bf16(w).T)
        g = MC._bf16(back if drop_mask == i else torch.where(acts[i] > 0.0, back, 0.0))
    dw_out, *dw_h = grads
    dw_h = torch.stack(dw_h[::-1]) if dw_h else torch.zeros_like(w_h)
    return loss, _at_g_tiled(a0, g), dw_h, dw_out


def _inputs(seed, b):
    cfg = NetworkConfig()
    rs = np.random.default_rng(seed)
    st = N.init_network(torch.Generator().manual_seed(seed), cfg)
    q = torch.from_numpy(rs.random((4, b, 15), np.float32))
    x4 = N.encode(q.view(-1, 15), cfg).view(4, b, MC.LANE)
    t4 = torch.from_numpy(rs.random((4, b, 3), np.float32) * 2.0)
    return st, x4, t4


@pytest.mark.parametrize("output_relu", [True, False])
def test_k3_in_the_mma_order_stays_inside_the_cards_limit(output_relu):
    st, x4, _ = _inputs(0, 4096)
    w = [t.detach() for t in st.params.tensors()]
    out = tiled_forward(*w, x4[0], output_relu)
    ref = MC.fused_forward_plain(*w, x4[0], output_relu)
    assert float(ref.abs().max()) > 0.1
    torch.testing.assert_close(out, ref, atol=LIM["k3_atol"], rtol=LIM["k3_rtol"])


@pytest.mark.parametrize("b", [4096, 1000])
def test_k5_in_the_mma_order_stays_inside_the_cards_limits(b):
    st, x4, t4 = _inputs(1, b)
    w = [t.detach() for t in st.params.tensors()]
    got = tiled_train_grad(*w, x4[0], t4[0])
    ref = MC.fused_train_grad_plain(*w, x4[0], t4[0])
    print(BM.check_train_grad(got, ref))


@pytest.mark.parametrize("layer", [0, 2, 4])
def test_a_dropped_relu_mask_reads_above_the_limits(layer):
    """The backward pass without one layer's mask: every gradient below that
    layer is wrong, far beyond the limits of K5 and of K4."""
    st, x4, t4 = _inputs(2, 2048)
    w = [t.detach() for t in st.params.tensors()]
    got = tiled_train_grad(*w, x4[0], t4[0], drop_mask=layer)
    ref = MC.fused_train_grad_plain(*w, x4[0], t4[0])
    mean, largest, _ = BM.gap(got[1], ref[1], 0.0)  # dW_in lies below every layer
    assert mean > 10 * max(LIM["k5_mean"], LIM["k4_dw_mean"]), mean
    assert largest > 2 * max(LIM["k5_max"], LIM["k4_dw_max"]), largest
    with pytest.raises(AssertionError, match="K5 disagrees"):
        BM.check_train_grad(got, ref)


def _backward_with_flips(w, x, g, n_flips, first_row=0):
    """K4's plain version with one ReLU mask bit flipped in each of
    ``n_flips`` rows from ``first_row`` on: the bit whose pre-activation lies
    nearest zero. Returns (results, the rows)."""
    a0, acts, zs = MC._forward_acts(w[0], w[1], x)
    masks = [z > 0.0 for z in zs]
    near = torch.stack([z.abs().amin(dim=1) for z in zs])        # [layers, B]
    rows = [r for r in range(first_row, x.shape[0]) if float(near[:, r].min()) < LIM["k4_flip_z"] / 10][:n_flips]
    assert len(rows) == n_flips
    for r in rows:
        layer = int(near[:, r].argmin())
        unit = int(zs[layer][r].abs().argmin())
        masks[layer][r, unit] = ~masks[layer][r, unit]
    return MC._backward_chain(a0, acts, masks, MC._bf16(g), *w, with_dx=True), rows


def test_k4_check_admits_flipped_rows_and_no_more():
    """One flipped ReLU mask changes one row of dX in full: the check admits
    such rows up to 0.1 % of the batch, each only if a few mask bits near zero
    explain it, and none among the last 16 rows of a ragged batch. It
    refuses a row that is off for another reason, more rows than the share,
    every row being slightly off, and a wrong dW."""
    st, x4, _ = _inputs(4, 2048)
    w = [t.detach() for t in st.params.tensors()]
    g = torch.from_numpy(np.random.default_rng(4).standard_normal((2048, MC.OUT_PAD)).astype(np.float32))
    x = x4[0]
    ref = MC.fused_backward_plain(*w, x, g)
    BM.check_backward(ref, ref, w, x, g)
    flipped, rows = _backward_with_flips(w, x, g, 2)
    off = BM.rows_off(flipped[0], ref[0], LIM["k4_dx_off_at"])
    assert off.nonzero().flatten().tolist() == rows       # a flipped bit does put its row far off
    text = BM.check_backward((flipped[0], *ref[1:]), ref, w, x, g)
    assert "2 of 2048 rows" in text and "NOT explained" not in text
    with pytest.raises(AssertionError, match="K4 disagrees"):   # three rows of 2048 are beyond 0.1 %
        BM.check_backward((_backward_with_flips(w, x, g, 3)[0][0], *ref[1:]), ref, w, x, g)
    negated = ref[0].clone()
    negated[700] *= -1.0
    with pytest.raises(AssertionError, match=r"NOT explained: rows \[700\]"):        # far off, and no mask bit explains it
        BM.check_backward((negated, *ref[1:]), ref, w, x, g)
    # the row with the largest entry half a percent apart (a gradient entry a
    # bf16 ulp apart does that) is admitted with no bit flipped; 3 % is not
    big = int(ref[0].abs().amax(dim=1).argmax())
    for factor, fine in ((1.005, True), (1.03, False)):
        scaled = ref[0].clone()
        scaled[big] *= factor
        if fine:
            assert f"{big} (; left" in BM.check_backward((scaled, *ref[1:]), ref, w, x, g)
        else:
            with pytest.raises(AssertionError, match=rf"NOT explained: rows \[{big}\]"):
                BM.check_backward((scaled, *ref[1:]), ref, w, x, g)
    with pytest.raises(AssertionError, match="K4 disagrees"):
        BM.check_backward((ref[0] * (1.0 + 5e-4), *ref[1:]), ref, w, x, g)
    with pytest.raises(AssertionError, match="K4 disagrees"):
        BM.check_backward((ref[0], ref[1] * 1.02, *ref[2:]), ref, w, x, g)


@pytest.mark.parametrize("b", [1, 15, 16, 129, 1000])
def test_k4_check_holds_every_row_of_a_ragged_end(b):
    """At the ragged batch sizes the card's tests use, one row left unwritten
    or a legitimately flipped row among the last 16 fails the check; below
    1000 rows no row at all may be off."""
    st, x4, _ = _inputs(5, 1000)
    w = [t.detach() for t in st.params.tensors()]
    g = torch.from_numpy(np.random.default_rng(5).standard_normal((1000, MC.OUT_PAD)).astype(np.float32))[:b]
    x = x4[0][:b].clone()
    ref = MC.fused_backward_plain(*w, x, g)
    BM.check_backward(ref, ref, w, x, g)
    unwritten = ref[0].clone()
    unwritten[-1] = 0.0
    with pytest.raises(AssertionError, match="K4 disagrees"):
        BM.check_backward((unwritten, *ref[1:]), ref, w, x, g)
    if b == 1000:
        early, rows = _backward_with_flips(w, x, g, 1)
        assert rows[0] < b - BM.TAIL_ROWS
        assert "1 of 1000 rows" in BM.check_backward((early[0], *ref[1:]), ref, w, x, g)
        late, rows = _backward_with_flips(w, x, g, 1, first_row=b - BM.TAIL_ROWS)
        with pytest.raises(AssertionError, match="ragged batch is off"):
            BM.check_backward((late[0], *ref[1:]), ref, w, x, g)


def _train4_with_fault(st, x4, t4, lr, hyper, skip_adam_step=None, skip_last_ema=False, stale_step=None,
                       drop_cta=None):
    """Four steps of K6's arithmetic from the plain K5 and ``adam_ema``, with
    one step's Adam update or the last step's EMA update left out; or, the
    faults of a persistent kernel: step ``stale_step`` takes its gradient on
    the weights of the step before (a missing grid barrier between an update
    and the next step's staging), or step ``drop_cta[0]`` leaves the 128 rows
    of CTA ``drop_cta[1]`` out of the sum (a race in the reduction). Returns
    (losses [4], w, mu, nu, ema)."""
    w, mu, nu, ema = ([t.detach() for t in m.tensors()] for m in (st.params, st.opt.mu, st.opt.nu, st.ema))
    before, losses = list(w), []
    for k in range(4):
        wk = before if k == stale_step else w
        loss, *grads = MC.fused_train_grad_plain(*wk, x4[k], t4[k])
        if drop_cta is not None and drop_cta[0] == k:
            rows = slice(MC.GRAD_ROWS * drop_cta[1], MC.GRAD_ROWS * (drop_cta[1] + 1))
            sub_loss, *sub = MC.fused_train_grad_plain(*wk, x4[k][rows], t4[k][rows])
            share = MC.GRAD_ROWS / x4.shape[1]  # the sub-batch's own mean, back to the batch's
            loss = loss - share * sub_loss
            grads = [g - share * h for g, h in zip(grads, sub)]
        losses.append(loss)
        before = list(w)
        if k == skip_adam_step:
            continue
        t = torch.tensor(float(k + 1))
        for i, g in enumerate(grads):
            p, m, v, e = MC.adam_ema(w[i], g, mu[i], nu[i], ema[i], t, lr, hyper)
            w[i], mu[i], nu[i] = p, m, v
            if not (skip_last_ema and k == 3):
                ema[i] = e
    return torch.stack(losses), w, mu, nu, ema


def _state_gap(got, ref):
    """Largest (mean, far share) over the tensors of two K6 states."""
    gaps = [BM.gap(a, r, LIM["k6_far_at"], 1.0) for a, r in zip(got, ref)]
    return max(g[0] for g in gaps), max(g[2] for g in gaps)


@pytest.mark.parametrize("fault", [dict(), dict(skip_last_ema=True), dict(skip_adam_step=0),
                                   dict(skip_adam_step=3), dict(stale_step=2), dict(drop_cta=(1, 5)),
                                   dict(drop_cta=(3, 15))], ids=str)
def test_k6_faults_read_above_the_limits(fault):
    """Without a fault the hand-rolled loop is the plain K6 (inside the
    limits, by far); a skipped last EMA update or a skipped Adam step reads
    above both limits on K6's state. The persistent kernel's own faults read
    10x above a limit on the state or on the losses: stale weights in a step
    (a missing grid barrier) above all three; one CTA's rows dropped from a
    step's sum (a race in the reduction) above the loss limit by 100x, and in
    the last step only 1.5x the state's mean limit: there the losses are the
    check that catches it (``chip_smoke.py`` and ``tests/test_torch_cuda.py``
    hold both)."""
    cfg = NetworkConfig()
    lr, hyper = torch.tensor(cfg.learning_rate), N.adam_hyper(cfg)
    st, x4, t4 = _inputs(3, 2048)
    losses, *got = _train4_with_fault(st, x4, t4, lr, hyper, **fault)
    ref_st = _inputs(3, 2048)[0]
    ref = [m.tensors() for m in (ref_st.params, ref_st.opt.mu, ref_st.opt.nu, ref_st.ema)]
    with torch.no_grad():
        ref_losses = MC.fused_train4_plain(*ref, ref_st.opt.step, x4, t4, lr, torch.tensor(2048), hyper)
    got, ref = [t for m in got for t in m], [t for m in ref for t in m]
    mean, far = _state_gap(got, ref)
    loss_rel = ((losses - ref_losses).abs() / ref_losses.abs()).max().item()
    if not fault:
        assert mean <= LIM["k6_mean"] / 10 and far == 0.0 and loss_rel <= LIM["loss"] / 10, (mean, far, loss_rel)
        BM.check_train_state(got, ref)
    elif "skip_adam_step" in fault or "skip_last_ema" in fault:
        assert mean > 10 * LIM["k6_mean"] and far > 10 * LIM["k6_far"], (mean, far)
        with pytest.raises(AssertionError, match="K6's state disagrees"):
            BM.check_train_state(got, ref)
    else:
        assert loss_rel > 10 * LIM["loss"], loss_rel
        if "stale_step" in fault or fault["drop_cta"][0] < 3:
            assert far > 10 * LIM["k6_far"], far
            with pytest.raises(AssertionError, match="K6's state disagrees"):
                BM.check_train_state(got, ref)


@pytest.mark.parametrize("b", [129, 1000])
def test_k6_composed_from_k5_is_the_plain_k6_on_the_cpu(b):
    """``bench_mlp.train4_from_k5``, the reference the card holds K6 to on
    small batches, is the plain K6 bit for bit where K5 is its plain version,
    and leaves its arguments as they were."""
    cfg = NetworkConfig()
    lr, hyper = torch.tensor(cfg.learning_rate), N.adam_hyper(cfg)
    st, x4, t4 = _inputs(4, b)
    groups = [m.tensors() for m in (st.params, st.opt.mu, st.opt.nu, st.ema)]
    before = [t.clone() for g in groups for t in g]
    losses, got = BM.train4_from_k5(*groups, st.opt.step, x4, t4, lr, hyper)
    assert all(torch.equal(a, c) for a, c in zip(before, [t for g in groups for t in g]))
    ref_losses = MC.fused_train4_plain(*groups, st.opt.step, x4, t4, lr, torch.tensor(b), hyper)
    assert torch.equal(losses, ref_losses)
    assert all(torch.equal(a, c) for a, c in zip(got, [t for g in groups for t in g]))


def _tiled_acts(w_in, w_h, x):
    """The forward's bf16 activations of every layer in the kernels' order
    of summation."""
    acts, a = [], MC._bf16(x)
    for w in [w_in, *w_h]:
        a = MC._bf16(torch.relu(_mm16(a, MC._bf16(w))))
        acts.append(a)
    return acts


def test_another_order_rounds_apart_only_at_rounding_boundaries():
    """``bench_mlp.rounding_decisions`` on the forward in the kernels' order:
    each activation it rounds apart from the plain forward lies within the
    decision limit of its rounding interval (reads 0 to a few 1e-8). A value
    two bf16 steps off, and a ReLU that passed a negative sum on, read far
    beyond it."""
    st, x4, _ = _inputs(5, 4096)
    w_in, w_h, _ = [t.detach() for t in st.params.tensors()]
    x = x4[0]
    acts = _tiled_acts(w_in, w_h, x)
    decisions = BM.rounding_decisions(w_in, w_h, x, acts)
    reach = BM.DECISION_LIMITS["decision_reach"]
    assert decisions and max(d[5] for d in decisions) <= reach / 10, decisions
    _, _, zs = MC._forward_acts(w_in, w_h, x)
    up = [a.clone() for a in acts]
    row, unit = (acts[2] > 0.1).nonzero()[0].tolist()
    up[2][row, unit] = (up[2][row, unit].view(torch.int32) + 0x20000).view(torch.float32)
    negative = [a.clone() for a in acts]
    row_n, unit_n = (zs[1] < -0.1).nonzero()[0].tolist()
    negative[1][row_n, unit_n] = MC._bf16(-zs[1][row_n, unit_n])
    for faulty, at in ((up, (2, row, unit)), (negative, (1, row_n, unit_n))):
        found = {d[:3]: d[5] for d in BM.rounding_decisions(w_in, w_h, x, faulty)}
        assert found[at] > 100 * reach, found[at]


@pytest.mark.parametrize("b", [129, 1000])
def test_the_step_fed_the_plain_forward_is_the_plain_k6_step(b):
    """``bench_mlp.train_step_from_acts``, the step the card's K6 is held to
    where the two round apart, is one step of the plain K6 bit for bit when
    fed the plain forward's activations, and leaves its arguments as they
    were."""
    cfg = NetworkConfig()
    lr, hyper = torch.tensor(cfg.learning_rate), N.adam_hyper(cfg)
    st, x4, t4 = _inputs(6, b)
    groups = [[t.detach() for t in m.tensors()] for m in (st.params, st.opt.mu, st.opt.nu, st.ema)]
    before = [t.clone() for g in groups for t in g]
    _, acts, _ = MC._forward_acts(*groups[0][:2], x4[0])
    loss, got = BM.train_step_from_acts(*groups, st.opt.step, x4[0], t4[0], lr, hyper, acts)
    assert all(torch.equal(a, c) for a, c in zip(before, [t for g in groups for t in g]))
    ref = [[t.clone() for t in g] for g in groups]
    ref_loss = MC.fused_train4_plain(*ref, st.opt.step.clone(), x4[:1], t4[:1], lr, torch.tensor(b), hyper)
    assert torch.equal(loss, ref_loss[0])
    assert all(torch.equal(a, c) for a, c in zip(got, [t for g in ref for t in g]))


@pytest.mark.parametrize("b,sms,grid", [(16384, 132, 128), (2000, 8, 8), (129, 132, 2), (1, 132, 1)])
def test_k6_is_one_launch_on_a_grid_of_one_cta_an_sm(b, sms, grid, monkeypatch):
    """K6's persistent kernel runs one CTA an SM and no more CTAs than
    128-row tiles (a CTA with several tiles adds them in tile order); its
    scratch is one partial row of P + 1 floats a CTA; the wrapper makes one
    launch of it a call and none of K5's. A stand-in for the built library
    takes the launch, so this runs without a card."""

    class Props:
        multi_processor_count = sms

    class StandIn:
        launches = 0
        calls = []

        def launch(self, *args):
            self.calls.append(args)
            self.launches += 1

    kernel = StandIn()
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda dev: Props)
    monkeypatch.setattr(MC, "current_stream", lambda dev: None)
    monkeypatch.setattr(MC, "TRAIN4_KERNEL", kernel)
    n_hidden = NetworkConfig().n_hidden_layers - 1
    assert MC.train4_grid(b, sms) == grid
    assert MC.train4_scratch(b, n_hidden, "cpu").shape == (grid, MC.num_params(n_hidden) + 1)
    st = N.init_network(torch.Generator().manual_seed(0), NetworkConfig())
    n5 = MC.TRAIN_GRAD_KERNEL.launches
    losses = MC.fused_train4_cuda(st.params.tensors(), st.opt.mu.tensors(), st.opt.nu.tensors(), st.ema.tensors(),
                                  st.opt.step, torch.zeros((4, b, MC.LANE)), torch.zeros((4, b, 3)),
                                  torch.tensor(1e-3), torch.tensor(b), N.adam_hyper(NetworkConfig()))
    assert kernel.launches == 1 and MC.TRAIN_GRAD_KERNEL.launches == n5 and losses.shape == (4,)
    args = kernel.calls[0]
    assert args[2:5] == (4, b, n_hidden) and args[30] == grid and len(args) == 34


def test_the_limits_lie_between_noise_and_faults():
    """The order of the limits themselves: a gradient limit admits a few
    flipped masks in 16,384 rows and no more; K6's mean limit lies below the
    2.5e-4 that a skipped EMA update reads."""
    assert 0 < LIM["k4_dx_share_off"] <= 1e-3 and 0 < LIM["k6_far"] <= 1e-2 and LIM["loss"] <= 1e-3
    assert int(LIM["k4_dx_share_off"] * 999) == 0 and LIM["k4_flip_z"] <= 5e-2
    assert LIM["k5_mean"] <= LIM["k4_dw_mean"] <= 1e-3 and LIM["k5_max"] <= LIM["k4_dw_max"] <= 1e-1
    assert LIM["k6_mean"] < 2.5e-4 / 10


def _c_constant(name, text):
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


TILES = (CSRC / "mma_tiles.cuh").read_text()
STRIDE, OUT_STRIDE, X_STRIDE, SMEM_LIMIT = (_c_constant(name, TILES)
                                            for name in ("kStride", "kOutStride", "kXStride", "kSmemLimit"))


def forward_smem_bytes(n_hidden):
    """Mirror of K3's shared memory: the weights staged as bf16
    (``mma_tiles.cuh::staged_weight_halves``)."""
    return 2 * (MC.LANE * STRIDE + n_hidden * MC.WIDTH * STRIDE + MC.WIDTH * OUT_STRIDE)


def grad_smem_bytes(n_hidden):
    """Mirror of ``mlp_grad.cuh::smem_bytes``: 32 bytes of loss sums, the
    staged weights, the input rows, the activations of ``n_hidden + 1``
    layers and the gradient rows."""
    return (32 + forward_smem_bytes(n_hidden)
            + 2 * (MC.GRAD_ROWS * X_STRIDE + (n_hidden + 2) * MC.GRAD_ROWS * STRIDE))


def test_the_layout_mirror_matches_the_sources():
    grad = (CSRC / "mlp_grad.cuh").read_text()
    assert (STRIDE, OUT_STRIDE, X_STRIDE, SMEM_LIMIT) == (72, 24, 136, 232448)
    assert _c_constant("kMaxHidden", grad) == MC.MAX_HIDDEN_GRAD
    # the formulas the mirror repeats, as the sources spell them
    assert "kIn * kStride + n_hidden * kWidth * kStride + kWidth * kOutStride" in " ".join(TILES.split())
    assert ("staged_weight_halves(n_hidden) + kRows * kXStride + (n_hidden + 2) * kRows * kStride"
            in " ".join(grad.split())) and "return 32 + 2 * halves;" in grad
    # ldmatrix wants every 8-element row of a block at a 16-byte address, and
    # eight rows of a block in different banks: a row stride of 16 bytes times an odd number
    for stride in (STRIDE, OUT_STRIDE, X_STRIDE):
        assert (2 * stride) % 16 == 0 and (2 * stride // 16) % 2 == 1


def test_shared_memory_budget_and_the_deepest_networks():
    n_hidden = NetworkConfig().n_hidden_layers - 1  # the 64 -> 64 products of the shipped network
    assert forward_smem_bytes(n_hidden) == 58368
    assert grad_smem_bytes(n_hidden) == 203808 <= SMEM_LIMIT
    assert forward_smem_bytes(MC.MAX_HIDDEN) <= SMEM_LIMIT < forward_smem_bytes(MC.MAX_HIDDEN + 1)
    assert grad_smem_bytes(MC.MAX_HIDDEN_GRAD) <= SMEM_LIMIT < grad_smem_bytes(MC.MAX_HIDDEN_GRAD + 1)
    assert 2 * (forward_smem_bytes(n_hidden) + 1024) <= SMEM_LIMIT  # two K3 CTAs an SM


@pytest.mark.parametrize("kernel,rows,nbytes,ops,scratch", [
    ("K3", 102400, 59084800, 5242880000, 0),
    ("K4", 16384, 18030592, 2516582400, 26215424),
    ("K5", 16384, 8790020, 2248146944, 26215424),
    ("K6", 16384, 35160080, 8992587776, 104861696),
])
def test_the_bounds_count_the_functions_bytes_and_not_the_scratch(kernel, rows, nbytes, ops, scratch):
    """``bound_ms`` is taken on what the function must move and do, each
    input read and each output written once; the per-CTA partial sums are the
    implementation's traffic and stand apart."""
    n_hidden = NetworkConfig().n_hidden_layers - 1
    work = BM.mlp_work(kernel, rows, n_hidden)
    assert work == dict(nbytes=nbytes, ops=ops, scratch_bytes=scratch)
    bound = BM.mlp_bound(kernel, rows, n_hidden)
    assert bound["bound_by"] == "bytes"
    assert bound["bound_ms"] == pytest.approx(1e3 * nbytes / 3.35e12)
    assert bound["scratch_bound_ms"] == pytest.approx(1e3 * scratch / 3.35e12)


@pytest.mark.parametrize("wrapper", ["forward", "backward", "train_grad", "train4"])
def test_the_wrappers_refuse_one_layer_more(wrapper):
    """The refusal comes before any launch, so it shows without a card."""
    deep = MC.MAX_HIDDEN + 1 if wrapper == "forward" else MC.MAX_HIDDEN_GRAD + 1
    w = (torch.zeros((MC.LANE, MC.WIDTH)), torch.zeros((deep, MC.WIDTH, MC.WIDTH)),
         torch.zeros((MC.WIDTH, MC.OUT_PAD)))
    x = torch.zeros((8, MC.LANE))
    with pytest.raises(ValueError, match="hidden layers"):
        if wrapper == "forward":
            MC.fused_forward_cuda(*w, x, True)
        elif wrapper == "backward":
            MC.fused_backward_cuda(*w, x, torch.zeros((8, MC.OUT_PAD)))
        elif wrapper == "train_grad":
            MC.fused_train_grad_cuda(*w, x, torch.zeros((8, 3)))
        else:
            MC.fused_train4_cuda(w, w, w, w, torch.tensor(0), x[None].repeat(4, 1, 1), torch.zeros((4, 8, 3)),
                                 torch.tensor(1e-3), torch.tensor(8), N.adam_hyper(NetworkConfig()))
