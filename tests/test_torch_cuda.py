"""The hand-written CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA card and ``nvcc``. They carry the ``cuda`` marker
and skip without a card (the ``cuda`` fixture decides at run time, not at
import). Run them on the card with
``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``
(``tests/conftest.py`` imports JAX, which the card's machine need not have).
``chip_smoke.py`` runs the same comparisons at the full shapes of the
320x320 Cornell frame.

Tolerances: the kernels and the plain versions sum in other orders, and the
tensor cores' sums differ from f32 sums in the last bits. K3-K6 are held to
``tools/bench_mlp.py::CARD_LIMITS`` through its ``check_backward``,
``check_train_grad`` and ``check_train_state``: the mean difference of each
gradient or state tensor and the share of entries far apart, which read
10-1000 times below a dropped ReLU mask, a skipped Adam step or a skipped EMA
update (``tests/test_torch_mlp_tiles.py`` seeds those faults). The largest
difference is not a limit of K4's dX or of K6's state: an activation next to
a bf16 rounding boundary rounds one ulp apart, a layer later a pre-activation
near zero changes sign, and that one flipped mask bit changes a row's
gradient in full. K4's dX is therefore held row by row: a row far off must be
explained by one such bit, such rows may be 0.1 % of a batch (none below
1000 rows), and none may lie among the last 16 rows of a ragged batch.

K6 is one persistent kernel a call: it launches nothing of K5's, and its
grid barriers and its reduction in CTA order leave the same bits from run to
run, replayed from a CUDA graph or not.

The hash grid's lookup H1 computes its plain version's operations in their
order (``_rn`` intrinsics, ``-fmad=false``): equal bit for bit. Its adjoint
H2 adds with atomics: held to ``tools/bench_hash.py::CARD_LIMITS``, with the
seeded faults above them. A hash frame runs H1 five times (inference and
four steps), H2 and K4 four times, K6 never.

The row gathers K7-K9 move bits: equal to the plain version bit for bit,
NaN patterns included. The walk kernels W1/W2 compute the plain walk's
arithmetic in its order (built with ``-fmad=false``): the closest t is equal
bit for bit, the winner may differ only between triangles at the same t,
and occlusion is equal.
"""

import dataclasses

import numpy as np
import pytest
import torch

from nrc_tpu_torch.config import InputEncoding, NetworkConfig, RenderMode
from nrc_tpu_torch.models import network as N
from nrc_tpu_torch.ops import encodings as E
from nrc_tpu_torch.ops import gather_cuda as GC
from nrc_tpu_torch.ops import hash_cuda as HC
from nrc_tpu_torch.ops import intersect_cuda as IC
from nrc_tpu_torch.ops import intersect_wide as IW
from nrc_tpu_torch.ops import intersect_wide_cuda as WC
from nrc_tpu_torch.ops import mlp_cuda as MC
from nrc_tpu_torch.ops.bvh_wide import build_wide_bvh
from nrc_tpu_torch.ops.intersect import RT_MAX, TriSoA, make_intersectors
from nrc_tpu_torch.render.renderer import Renderer
from nrc_tpu_torch.render.scene_device import upload_scene
from nrc_tpu_torch.scene.scene_builder import cornell_box
from nrc_tpu_torch.tools import bench_hash as BH
from nrc_tpu_torch.tools import bench_mlp as BM

pytestmark = pytest.mark.cuda
LIM = BM.CARD_LIMITS


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _soup(device, num_tris=1000, num_rays=3000, live_share=None, twin=None):
    """1000 triangles (a ragged last group of 32), ray count not a multiple
    of the block, one degenerate triangle, some inactive lanes: every fifth,
    or with ``live_share`` all but that share, scattered. ``twin=(a, b)``
    makes triangle b a copy of triangle a."""
    rs = np.random.default_rng(0)
    p0 = rs.uniform(-2, 2, (num_tris, 3)).astype(np.float32)
    p1 = (p0 + rs.normal(size=p0.shape) * 0.5).astype(np.float32)
    p2 = (p0 + rs.normal(size=p0.shape) * 0.5).astype(np.float32)
    if num_tris > 7:
        p1[7] = p0[7]
    if twin is not None:
        for p in (p0, p1, p2):
            p[twin[1]] = p[twin[0]]
    tris = TriSoA.build(p0, p1, p2, device=device)
    org = torch.tensor(rs.uniform(-3, 3, (num_rays, 3)), dtype=torch.float32, device=device)
    d = torch.tensor(rs.normal(size=(num_rays, 3)), dtype=torch.float32, device=device)
    d = d / d.norm(dim=-1, keepdim=True)
    tmin = torch.zeros(num_rays, device=device)
    tmax = torch.full((num_rays,), RT_MAX, device=device)
    if live_share is None:
        tmax[::5] = 0.0
    else:
        tmax[torch.tensor(rs.random(num_rays) >= live_share, device=device)] = 0.0
    return tris, IC.build_plane_table(tris), org, d, tmin, tmax


def test_k1_k2_match_plain(cuda):
    tris, planes, org, d, tmin, tmax = _soup(cuda)
    n1, n2 = IC.CLOSEST_KERNEL.launches, IC.ANYHIT_KERNEL.launches
    hit = IC.intersect_planes(org, d, planes, tris, tmin, tmax)
    t_ref, prim_ref = IC.closest_plain(org, d, planes, tmin, tmax)
    occ = IC.occluded_planes(org, d, planes, tmin, tmax * 0.5)
    occ_ref = IC.occluded_plain(org, d, planes, tmin, tmax * 0.5)
    torch.cuda.synchronize()
    assert IC.CLOSEST_KERNEL.launches == n1 + 1 and IC.ANYHIT_KERNEL.launches == n2 + 1
    assert torch.equal(hit.prim, prim_ref)
    assert torch.equal(hit.t, t_ref)  # same operations in the same order
    assert torch.equal(occ, occ_ref)
    assert 0.1 < (prim_ref >= 0).float().mean().item() < 0.9


@pytest.mark.parametrize("kwargs", [
    dict(live_share=0.16), dict(live_share=0.0), dict(num_rays=1, live_share=1.0),
    dict(num_rays=1025), dict(num_tris=1), dict(num_tris=257), dict(num_tris=33, num_rays=100, live_share=0.5),
], ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_k1_k2_sparse_and_ragged_sets_match_plain(cuda, kwargs):
    """Scattered dead lanes, blocks with one live ray or none, a ray count one
    past a multiple of every block size, one triangle, and one triangle past
    a multiple of the 32 a warp holds: equal to the plain version bit for bit
    (the same operations in the same order); dead lanes read RT_MAX, -1 and
    False."""
    tris, planes, org, d, tmin, tmax = _soup(cuda, **kwargs)
    org = torch.where((tmax > tmin)[:, None], org, torch.full_like(org, float("nan")))
    t, prim = IC.closest_cuda(org, d, planes, tmin, tmax)
    t_ref, prim_ref = IC.closest_plain(org, d, planes, tmin, tmax)
    occ = IC.occluded_cuda(org, d, planes, tmin, tmax * 0.5)
    occ_ref = IC.occluded_plain(org, d, planes, tmin, tmax * 0.5)
    torch.cuda.synchronize()
    assert prim.dtype == torch.int64 and occ.dtype == torch.bool
    assert torch.equal(prim, prim_ref) and torch.equal(t, t_ref) and torch.equal(occ, occ_ref)
    dead = ~(tmax > tmin)
    assert bool((prim[dead] == -1).all()) and bool((t[dead] == RT_MAX).all()) and not bool(occ[dead].any())


@pytest.mark.parametrize("twin", [(3, 900), (40, 41), (100, 5)])
def test_k1_ties_go_to_the_lowest_triangle(cuda, twin):
    """Two coplanar copies of one triangle, in different groups of 32 (held
    by different warps), side by side in one group, and the copy first: every
    ray that hits the pair reports the lower index, as the plain version."""
    tris, planes, org, d, tmin, tmax = _soup(cuda, twin=twin, live_share=1.0)
    # aim a fifth of the rays at the twin's centroid
    centre = (tris.p0[twin[0]] + (tris.e1[twin[0]] + tris.e2[twin[0]]) / 3.0)
    d[::5] = centre - org[::5]
    d = d / d.norm(dim=-1, keepdim=True)
    t, prim = IC.closest_cuda(org, d, planes, tmin, tmax)
    t_ref, prim_ref = IC.closest_plain(org, d, planes, tmin, tmax)
    torch.cuda.synchronize()
    assert torch.equal(prim, prim_ref) and torch.equal(t, t_ref)
    assert int((prim == min(twin)).sum()) > 10 and not bool((prim == max(twin)).any())


@pytest.mark.parametrize("n_hidden", [0, 1, 4])
@pytest.mark.parametrize("b", [1, 15, 16, 129, 1000])
def test_k3_matches_plain(cuda, b, n_hidden):
    """One row, one short of and exactly a warp's 16 rows, one past a CTA's
    128-row tile, and 1000 (a multiple of neither); no, one and the shipped
    four 64 -> 64 layers."""
    st = N.init_network(torch.Generator().manual_seed(0), NetworkConfig(), cuda)
    w = (st.ema.w_in, st.ema.w_hidden[:n_hidden], st.ema.w_out)
    x = torch.rand((b, MC.LANE), generator=torch.Generator(device=cuda).manual_seed(b), device=cuda)
    for relu in (True, False):
        n = MC.FORWARD_KERNEL.launches
        out = MC.fused_forward(*w, x, relu)
        ref = MC.fused_forward_plain(*w, x, relu)
        torch.cuda.synchronize()
        assert MC.FORWARD_KERNEL.launches == n + 1
        assert out.shape == (b, MC.OUT_PAD)
        torch.testing.assert_close(out, ref, atol=LIM["k3_atol"], rtol=LIM["k3_rtol"])  # bf16 operands


def _one_hot_net(device, n_hidden):
    """Weights that route one input column to one output column, with small
    integer values (exact in bf16): w_in sends column k to k % 64 with weight
    1 or 2, hidden layer l shifts the columns by l + 1, w_out sends column j
    to j % 16 with weight 1 + j // 16."""
    k, j = torch.arange(MC.LANE), torch.arange(MC.WIDTH)
    w_in = torch.zeros((MC.LANE, MC.WIDTH))
    w_in[k, k % MC.WIDTH] = 1.0 + (k // MC.WIDTH)
    w_h = torch.zeros((n_hidden, MC.WIDTH, MC.WIDTH))
    for layer in range(n_hidden):
        w_h[layer, j, (j + layer + 1) % MC.WIDTH] = 1.0
    w_out = torch.zeros((MC.WIDTH, MC.OUT_PAD))
    w_out[j, j % MC.OUT_PAD] = 1.0 + (j // MC.OUT_PAD)
    return tuple(t.to(device) for t in (w_in, w_h, w_out))


def _moved(got, ref, limit=6):
    """[(index, expected, got)] of the first entries that differ."""
    bad = (got != ref).nonzero()[:limit]
    return [(tuple(i.tolist()), ref[tuple(i)].item(), got[tuple(i)].item()) for i in bad]


@pytest.mark.parametrize("n_hidden", [0, 1, 4])
def test_k3_one_hot_names_the_column(cuda, n_hidden):
    """x = e_i through routing weights: every sum has one term, so the kernel
    equals the plain version exactly, and a wrong fragment map (a row or a
    column of an mma tile in the wrong place) shows as the entry that moved."""
    w = _one_hot_net(cuda, n_hidden)
    eye = torch.eye(MC.LANE, device=cuda)
    x = torch.cat([eye, 3.0 * eye.flip(0)])  # row order and column order apart
    out = MC.fused_forward(*w, x, False)
    ref = MC.fused_forward_plain(*w, x, False)
    torch.cuda.synchronize()
    assert int((ref != 0).sum()) == x.shape[0]
    assert torch.equal(out, ref), f"(row, column), expected, got: {_moved(out, ref)}"


@pytest.mark.parametrize("n_hidden", [0, 1, 4])
def test_k4_k5_one_hot_name_the_entry(cuda, n_hidden):
    """The same routing weights through the gradient kernels: one-hot inputs
    and output gradients of small integer values, of which w_out's rows pick
    one each, so K4 equals its
    plain version exactly in dX and every dW; K5's output gradient is a
    quotient rounded to bf16, its sums have a few terms (1e-6)."""
    w = _one_hot_net(cuda, n_hidden)
    eye = torch.eye(MC.LANE, device=cuda)
    x = torch.cat([eye, 3.0 * eye.flip(0)])
    r = torch.arange(x.shape[0], device=cuda)
    g = 1.0 + ((r[:, None] + torch.arange(MC.OUT_PAD, device=cuda)) % 3).float()  # w_out picks one column
    got4 = MC.fused_backward(*w, x, g)
    ref4 = MC.fused_backward_plain(*w, x, g)
    target = torch.zeros((x.shape[0], 3), device=cuda)
    got5 = MC.fused_train_grad(*w, x, target)
    ref5 = MC.fused_train_grad_plain(*w, x, target)
    torch.cuda.synchronize()
    for name, a, p in zip(("dx", "dw_in", "dw_hidden", "dw_out"), got4, ref4):
        assert torch.equal(a, p), f"K4 {name}: index, expected, got: {_moved(a, p)}"
    assert int((ref4[0] != 0).sum()) > 0 and int((ref5[1] != 0).sum()) > 0
    for name, a, p in zip(("loss", "dw_in", "dw_hidden", "dw_out"), got5, ref5):
        close = torch.isclose(a, p, rtol=1e-6, atol=1e-9)
        assert bool(close.all()), f"K5 {name}: index, expected, got: {_moved(torch.where(close, p, a), p)}"


def _grad_inputs(cuda, b):
    st = N.init_network(torch.Generator().manual_seed(0), NetworkConfig(), cuda)
    gen = torch.Generator(device=cuda).manual_seed(1)
    q = torch.rand((4, b, 15), generator=gen, device=cuda)
    x4 = N.encode(q.view(-1, 15), NetworkConfig()).view(4, b, MC.LANE)
    t4 = torch.rand((4, b, 3), generator=gen, device=cuda) * 2.0
    return st, x4, t4


@pytest.mark.parametrize("n_hidden", [0, 1, 4])
@pytest.mark.parametrize("b", [1, 15, 16, 129, 1000])
def test_k4_k5_match_plain(cuda, b, n_hidden):
    """Batches that end inside a warp's 16 rows and inside a CTA's 128: the
    rows past the batch add nothing to dW or the loss."""
    st, x4, t4 = _grad_inputs(cuda, b)
    w_in, w_h, w_out = st.params.tensors()
    w = (w_in, w_h[:n_hidden], w_out)
    g = torch.randn((b, MC.OUT_PAD), generator=torch.Generator(device=cuda).manual_seed(2), device=cuda)
    n4, n5 = MC.BACKWARD_KERNEL.launches, MC.TRAIN_GRAD_KERNEL.launches
    x, target = x4[1].clone(), t4[1].clone()  # a slice of an odd batch is not 16-byte aligned
    got4 = MC.fused_backward(*w, x4[0], g)
    ref4 = MC.fused_backward_plain(*w, x4[0], g)
    got5 = MC.fused_train_grad(*w, x, target)
    ref5 = MC.fused_train_grad_plain(*w, x, target)
    torch.cuda.synchronize()
    assert MC.BACKWARD_KERNEL.launches == n4 + 1 and MC.TRAIN_GRAD_KERNEL.launches == n5 + 1
    assert got4[0].shape == (b, MC.LANE) and got4[2].shape == (n_hidden, MC.WIDTH, MC.WIDTH)
    BM.check_backward(got4, ref4, w, x4[0], g)
    BM.check_train_grad(got5, ref5)


def test_k6_is_the_same_from_run_to_run(cuda):
    """No atomics, partial sums added in CTA order: two runs on the same
    inputs leave bit-equal weights, moments, EMA and losses."""
    cfg = NetworkConfig()
    lr = torch.tensor(cfg.learning_rate, device=cuda)
    runs = []
    for _ in range(2):
        st, x4, t4 = _grad_inputs(cuda, 16384)
        losses = MC.fused_train4(st.params.tensors(), st.opt.mu.tensors(), st.opt.nu.tensors(),
                                 st.ema.tensors(), st.opt.step, x4, t4, lr,
                                 torch.tensor(16384, device=cuda), N.adam_hyper(cfg))
        torch.cuda.synchronize()
        runs.append((losses.cpu().numpy(), N.state_to_numpy(st)))
    (la, sa), (lb, sb) = runs
    assert np.array_equal(la, lb)
    for key in sa:
        assert np.array_equal(sa[key], sb[key]), key


def test_k6_matches_plain(cuda):
    cfg = NetworkConfig()
    lr = torch.tensor(cfg.learning_rate, device=cuda)
    out = []
    for num_records in (5, 0):
        states = []
        for fn in (MC.fused_train4, MC.fused_train4_plain):
            st, x4, t4 = _grad_inputs(cuda, 2048)
            n5, n6 = MC.TRAIN_GRAD_KERNEL.launches, MC.TRAIN4_KERNEL.launches
            losses = fn(st.params.tensors(), st.opt.mu.tensors(), st.opt.nu.tensors(),
                        st.ema.tensors(), st.opt.step, x4, t4, lr,
                        torch.tensor(num_records, device=cuda), N.adam_hyper(cfg))
            # one persistent kernel a call, records or not, and nothing of K5's
            assert MC.TRAIN_GRAD_KERNEL.launches == n5
            assert MC.TRAIN4_KERNEL.launches == n6 + (1 if fn is MC.fused_train4 else 0)
            states.append((losses, N.state_to_numpy(st)))
        out.append(states)
    (lk, sk), (lp, sp) = out[0]
    torch.testing.assert_close(lk, lp, rtol=LIM["loss"], atol=0)
    assert int(sk["opt.step"]) == int(sp["opt.step"]) == 4
    keys = [key for key in sk if key.startswith(("params.", "ema.", "opt.mu.", "opt.nu."))]
    assert len(keys) == 12
    BM.check_train_state([torch.from_numpy(sk[key]) for key in keys], [torch.from_numpy(sp[key]) for key in keys])
    (lk, sk), (lp, sp) = out[1]
    assert not lk.any() and not lp.any() and int(sk["opt.step"]) == 0
    fresh = N.state_to_numpy(_grad_inputs(cuda, 8)[0])
    for key in sk:
        assert np.array_equal(sk[key], fresh[key]), key


def _train4_state(st):
    return [t.clone() for m in (st.params, st.opt.mu, st.opt.nu, st.ema) for t in m.tensors()] + [st.opt.step.clone()]


@pytest.mark.parametrize("b", [16384, 40000])
def test_k6_is_one_kernel_launch_a_call(cuda, b):
    """At the frame's batch (one 128-row tile a CTA) and at a batch larger
    than 128 rows x the SMs (a CTA adds several tiles to its partial row in
    tile order): one launch of K6 and none of K5, the plain version's
    results to the card's limits, two runs bit-equal, and a replay of the
    call captured in a CUDA graph bit-equal to an eager call."""
    cfg = NetworkConfig()
    lr = torch.tensor(cfg.learning_rate, device=cuda)
    records = torch.tensor(b, device=cuda)
    runs = []
    for kind in ("eager", "eager", "replayed", "plain"):
        st, x4, t4 = _grad_inputs(cuda, b)
        args = (st.params.tensors(), st.opt.mu.tensors(), st.opt.nu.tensors(), st.ema.tensors(), st.opt.step,
                x4, t4, lr, records, N.adam_hyper(cfg))
        n5, n6 = MC.TRAIN_GRAD_KERNEL.launches, MC.TRAIN4_KERNEL.launches
        if kind == "plain":
            losses = MC.fused_train4_plain(*args)
        elif kind == "eager":
            losses = MC.fused_train4(*args)
            torch.cuda.synchronize()
            assert (MC.TRAIN4_KERNEL.launches, MC.TRAIN_GRAD_KERNEL.launches) == (n6 + 1, n5)
        else:
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                losses = MC.fused_train4(*args)
            graph.replay()
        torch.cuda.synchronize()
        runs.append((losses.clone(), _train4_state(st)))
    (la, sa), (lb, sb), (lg, sg), (lp, sp) = runs
    assert torch.equal(la, lb) and torch.equal(la, lg)
    assert all(torch.equal(a, c) for a, c in zip(sa, sb)) and all(torch.equal(a, c) for a, c in zip(sa, sg))
    assert int(sa[-1]) == int(sp[-1]) == 4
    torch.testing.assert_close(la, lp, rtol=LIM["loss"], atol=0)
    BM.check_train_state(sa[:-1], sp[:-1])


@pytest.mark.parametrize("b", [1000, 129])
def test_k6_on_small_batches_is_k5_and_the_plain_update(cuda, b):
    """8 and 2 CTAs of one 128-row tile each: K6 sums a step's gradient in
    K5's order, so it is held to the card's limits against K5's kernel and the
    plain ``adam_ema`` composed step by step (``bench_mlp.train4_from_k5``),
    in one launch. Against the plain K6 a 1000-row batch can read above the
    state limits set at 16,384 rows, and the composition reads the same
    (PERF.md §7): that gap is K5's, through four Adam steps."""
    cfg = NetworkConfig()
    lr = torch.tensor(cfg.learning_rate, device=cuda)
    st, x4, t4 = _grad_inputs(cuda, b)
    ref_losses, ref = BM.train4_from_k5(st.params.tensors(), st.opt.mu.tensors(), st.opt.nu.tensors(),
                                        st.ema.tensors(), st.opt.step, x4, t4, lr, N.adam_hyper(cfg))
    n6 = MC.TRAIN4_KERNEL.launches
    losses = MC.fused_train4(st.params.tensors(), st.opt.mu.tensors(), st.opt.nu.tensors(), st.ema.tensors(),
                             st.opt.step, x4, t4, lr, torch.tensor(b, device=cuda), N.adam_hyper(cfg))
    torch.cuda.synchronize()
    assert MC.TRAIN4_KERNEL.launches == n6 + 1 and int(st.opt.step) == 4
    torch.testing.assert_close(losses, ref_losses, rtol=LIM["loss"], atol=0)
    BM.check_train_state(_train4_state(st)[:-1], ref)


def test_train_step_goes_through_k4(cuda):
    st, x4, t4 = _grad_inputs(cuda, 512)
    q = torch.rand((512, 15), device=cuda)
    n3, n4 = MC.FORWARD_KERNEL.launches, MC.BACKWARD_KERNEL.launches
    new, loss = N.train_step(st, q, t4[0], NetworkConfig())
    torch.cuda.synchronize()
    assert MC.FORWARD_KERNEL.launches > n3 and MC.BACKWARD_KERNEL.launches == n4 + 1
    assert torch.isfinite(loss) and int(new.opt.step) == 1


def test_wrappers_refuse_bad_inputs(cuda):
    tris, planes, org, d, tmin, tmax = _soup(cuda, num_rays=64)
    with pytest.raises(TypeError):
        IC.closest_cuda(org.double(), d, planes, tmin, tmax)
    with pytest.raises(ValueError):
        IC.closest_cuda(org, d, planes[:, :12], tmin, tmax)
    with pytest.raises(ValueError):
        MC.fused_forward_cuda(planes, planes, planes, org, True)
    st = N.init_network(torch.Generator().manual_seed(0), NetworkConfig(), cuda)
    with pytest.raises(ValueError):  # weights must be updated in place: no copies
        MC.fused_train4_cuda(
            (st.params.w_in, st.params.w_hidden.transpose(1, 2), st.params.w_out), st.opt.mu.tensors(),
            st.opt.nu.tensors(), st.ema.tensors(), st.opt.step, torch.zeros((4, 8, 128), device=cuda),
            torch.zeros((4, 8, 3), device=cuda), torch.tensor(1e-3, device=cuda),
            torch.tensor(1, device=cuda), N.adam_hyper(NetworkConfig()))


@pytest.mark.parametrize("train", [False, True])
def test_renderer_goes_through_the_kernels(cuda, train):
    scene, system = cornell_box((64, 64))
    r = Renderer(scene, system, render_mode=RenderMode.FULL, train=train, device=cuda)
    kernels = (IC.CLOSEST_KERNEL, IC.ANYHIT_KERNEL, MC.FORWARD_KERNEL, MC.TRAIN4_KERNEL,
               MC.TRAIN_GRAD_KERNEL)
    before = [k.launches for k in kernels]
    r.render(3)
    after = [k.launches for k in kernels]
    assert all(a > b for a, b in zip(after[:3], before[:3]))
    assert after[3] - before[3] == (3 if train else 0)
    assert after[4] == before[4]  # K6 is one kernel: nothing of K5's
    img = r.image_hdr()
    assert np.isfinite(img).all() and img.std() > 0
    if train:
        r.flush_stats()
        assert len(r.loss_history) == 3 and int(r.net_state.opt.step) == 12


@pytest.mark.parametrize("variant", sorted(GC.VARIANTS))
@pytest.mark.parametrize("rows,width,n", [(5000, 160, 3001), (300, 160, 64), (1224, 26, 1000),
                                          (5, 93, 777), (40000, 9, 4097), (5, 1, 777), (5, 9, 4097),
                                          (5, 31, 129), (5, 33, 1000), (5, 128, 25600), (1, 26, 131),
                                          (1, 160, 3)])
def test_gathers_match_plain_bit_for_bit(cuda, variant, rows, width, n):
    """Widths with and without 16-byte rows, a table smaller than the
    resident variant's stage and one larger, int32 and int64 indices; the
    table holds every kind of bit pattern (NaNs, infinities, denormals).
    K7's shapes: 1, 9, 31 and 33 columns (output-major chunks), 128 on a
    5-row table and 160 (a warp per row), and 1-row tables."""
    gen = torch.Generator(device=cuda).manual_seed(rows + n)
    bits = torch.randint(-2**31, 2**31 - 1, (rows, width), generator=gen, device=cuda, dtype=torch.int64)
    table = bits.to(torch.int32).view(torch.float32)
    idx = torch.randint(0, rows, (n,), generator=gen, device=cuda)
    idx[:3] = torch.tensor([0, rows - 1, 0], device=cuda)
    kernel = GC.VARIANTS[variant]
    before = kernel.launches
    out = GC.gather_rows_cuda(kernel, table, idx)
    out32 = GC.gather_rows_cuda(kernel, table, idx.to(torch.int32))
    torch.cuda.synchronize()
    assert kernel.launches == before + 2
    ref = GC.gather_rows_plain(table, idx)
    assert torch.equal(out.view(torch.int32), ref.view(torch.int32))
    assert torch.equal(out32.view(torch.int32), ref.view(torch.int32))


@pytest.mark.parametrize("shape,n", [((131072, 160), 2048), ((131072, 160), 102400), ((8192, 160), 2048),
                                     ((8192, 160), 102400), ("tri_shade", 102400), ("mat_row", 102400),
                                     ("tris.packed", 102400)])
def test_k8_bit_for_bit_at_the_bench_shapes(cuda, shape, n):
    """K8 on the walk's table, the TPU resident kernel's own and the path's
    tables of the 320x320 Cornell box (``tools/bench_gather.py``), filled
    with every kind of bit pattern."""
    from nrc_tpu_torch.tools import bench_gather as BG

    gen = torch.Generator(device=cuda).manual_seed(n)
    rows, width = BG.path_tables(cuda)[shape].shape if isinstance(shape, str) else shape
    bits = torch.randint(-2**31, 2**31 - 1, (rows, width), generator=gen, device=cuda, dtype=torch.int64)
    table = bits.to(torch.int32).view(torch.float32)
    idx = torch.randint(0, rows, (n,), generator=gen, device=cuda)
    idx[:2] = torch.tensor([rows - 1, 0], device=cuda)
    before = GC.RESIDENT_KERNEL.launches
    out = GC.gather_rows_cuda(GC.RESIDENT_KERNEL, table, idx)
    torch.cuda.synchronize()
    assert GC.RESIDENT_KERNEL.launches == before + 1
    assert torch.equal(out.view(torch.int32), table[idx].view(torch.int32))


def test_k7_bit_for_bit_on_the_edge_grid(cuda):
    """K7 on every table width, index count and table size of
    ``bench_gather``'s edge grid, where its work split changes shape (the
    split itself is modelled on the CPU, ``tests/test_torch_gather_split.py``)."""
    from nrc_tpu_torch.tools import bench_gather as BG

    before = GC.GATHER_KERNEL.launches
    launches = BG.check_edges(GC.GATHER_KERNEL, cuda, torch.Generator(device=cuda).manual_seed(8))
    assert launches == 2 * len(BG.EDGE_ROWS) * len(BG.EDGE_WIDTHS) * len(BG.EDGE_NS)
    assert GC.GATHER_KERNEL.launches == before + launches


def test_gather_wrapper_dispatch_and_refusals(cuda):
    table = torch.rand((64, 24), device=cuda)
    idx = torch.arange(10, device=cuda)
    before = GC.PATH_KERNEL.launches
    assert torch.equal(GC.gather_rows(table, idx), table[:10])
    assert GC.PATH_KERNEL.launches == before + 1
    assert GC.gather_rows(table, idx[:0]).shape == (0, 24)
    with pytest.raises(TypeError):
        GC.gather_rows(table.double(), idx)
    with pytest.raises(ValueError):
        GC.gather_rows(table.t(), idx)  # not contiguous
    with pytest.raises(ValueError):
        GC.gather_rows(table, idx.cpu())


def _wide_soup(device, branch, leaf, num_tris=6000, num_rays=5000):
    rs = np.random.default_rng(branch + leaf)
    c = rs.random((num_tris, 3)).astype(np.float32) * 10
    p0, p1, p2 = (c + rs.normal(size=(num_tris, 3)).astype(np.float32) * 0.3 for _ in range(3))
    p1[11] = p0[11]  # a degenerate triangle
    bvh = IW.upload_wide_bvh(build_wide_bvh(p0, p1, p2, leaf_size=leaf, branch=branch), device)
    tris = TriSoA.build(p0, p1, p2, device=device)
    org = torch.tensor(rs.random((num_rays, 3)) * 10, dtype=torch.float32, device=device)
    d = torch.tensor(rs.normal(size=(num_rays, 3)), dtype=torch.float32, device=device)
    d = d / d.norm(dim=-1, keepdim=True)
    d[:40] = torch.tensor([0.0, 1.0, 0.0], device=device)  # axis-parallel: inv_d = 3e38
    tmin = torch.zeros(num_rays, device=device)
    tmin[::7] = 0.5
    tmax = torch.full((num_rays,), RT_MAX, device=device)
    tmax[1::5] = torch.tensor(rs.random(len(range(1, num_rays, 5))) * 8.0, dtype=torch.float32, device=device)
    tmax[::13] = 0.0  # dead lanes
    return bvh, tris, org, d, tmin, tmax


@pytest.mark.parametrize("branch,leaf", [(8, 8), (16, 16), (16, 8)])
def test_w1_w2_match_plain_walk(cuda, branch, leaf):
    bvh, tris, org, d, tmin, tmax = _wide_soup(cuda, branch, leaf)
    n1, n2 = WC.CLOSEST_KERNEL.launches, WC.ANYHIT_KERNEL.launches
    tk, pk = WC.wide_traverse_cuda(org, d, bvh, tmin, tmax, any_hit=False)
    _, ok = WC.wide_traverse_cuda(org, d, bvh, tmin, tmax, any_hit=True)
    tp, pp, fetched = IW.wide_traverse_plain(org, d, bvh, tmin, tmax, any_hit=False)
    _, op, _ = IW.wide_traverse_plain(org, d, bvh, tmin, tmax, any_hit=True)
    torch.cuda.synchronize()
    assert WC.CLOSEST_KERNEL.launches == n1 + 1 and WC.ANYHIT_KERNEL.launches == n2 + 1
    assert torch.equal(tk, tp)  # the closest t does not depend on the order of the walk
    assert torch.equal(pk >= 0, pp >= 0) and not (pk[::13] >= 0).any()
    # another winner only at the same t, which the line above already holds
    assert (pk == pp).float().mean().item() >= 0.9999
    assert torch.equal(ok >= 0, op >= 0)
    assert 0.2 < (pp >= 0).float().mean().item() < 0.9 and fetched > org.shape[0]
    # and against the brute force K1/K2, which computes t in the plane form:
    # its numerator cancels, so its error is absolute and grows for grazing rays
    hit = make_intersectors(tris)[0](org, d, tmin, tmax)
    same = hit.prim == pk
    assert same.float().mean().item() > 0.999
    torch.testing.assert_close(tk[same], hit.t[same], rtol=1e-4, atol=1e-4)
    occ = make_intersectors(tris)[1](org, d, tmin, tmax)
    assert ((ok >= 0) == occ).float().mean().item() > 0.999


def test_walk_wrapper_refuses_what_the_kernel_was_not_built_for(cuda):
    bvh, tris, org, d, tmin, tmax = _wide_soup(cuda, 8, 8, num_tris=200, num_rays=64)
    with pytest.raises(ValueError, match="stack"):
        WC.wide_traverse_cuda(org, d, bvh._replace(depth=64), tmin, tmax, False)
    with pytest.raises(ValueError, match="branch"):
        WC.wide_traverse_cuda(org, d, bvh._replace(branch=4), tmin, tmax, False)
    with pytest.raises(TypeError):
        WC.wide_traverse_cuda(org.double(), d, bvh, tmin, tmax, False)


def test_c1_c2_match_plain_cone_walk(cuda):
    """The curve walks on ``cornell_hair``'s fur (a few hundred strands)
    against the plain walk with the cone leaf: C1's t bit for bit (the round
    cone uses + - * / and sqrt alone, correctly rounded on both), the
    winners equal but at equal-t ties, C2's occlusion exact; dead lanes
    report no hit."""
    from nrc_tpu_torch.ops.curve_intersect import build_wide_curve_bvh
    from nrc_tpu_torch.scene.scene_builder import cornell_hair

    scene, _ = cornell_hair((64, 64), strands=400)
    bvh = IW.upload_wide_bvh(build_wide_curve_bvh(scene.curves), cuda, kind="cone")
    rs = np.random.default_rng(15)
    n = 5000
    lo, hi = scene.curves.pa.min(0), scene.curves.pa.max(0)
    org = torch.tensor(lo + rs.random((n, 3)) * (hi - lo), dtype=torch.float32, device=cuda)
    d = torch.tensor(rs.normal(size=(n, 3)), dtype=torch.float32, device=cuda)
    d = d / d.norm(dim=-1, keepdim=True)
    tmin = torch.full((n,), 1e-4, device=cuda)
    tmax = torch.full((n,), RT_MAX, device=cuda)
    tmax[::13] = 0.0  # dead lanes
    n1, n2 = WC.CURVE_CLOSEST_KERNEL.launches, WC.CURVE_ANYHIT_KERNEL.launches
    tk, pk = WC.wide_traverse_cuda(org, d, bvh, tmin, tmax, False, leaf="cone")
    _, ok = WC.wide_traverse_cuda(org, d, bvh, tmin, tmax, True, leaf="cone")
    tp, pp, _ = IW.wide_traverse_plain(org, d, bvh, tmin, tmax, False, leaf="cone")
    _, op, _ = IW.wide_traverse_plain(org, d, bvh, tmin, tmax, True, leaf="cone")
    torch.cuda.synchronize()
    assert WC.CURVE_CLOSEST_KERNEL.launches == n1 + 1 and WC.CURVE_ANYHIT_KERNEL.launches == n2 + 1
    assert torch.equal(tk, tp) and torch.equal(pk >= 0, pp >= 0) and not (pk[::13] >= 0).any()
    assert torch.equal(ok >= 0, op >= 0) and 0.05 < (pp >= 0).float().mean().item()
    with pytest.raises(ValueError, match="cone leaf rows handed to the triangle walk"):
        WC.wide_traverse_cuda(org, d, bvh, tmin, tmax, False)


def test_renderer_with_a_bvh_goes_through_the_walk(cuda):
    """The small Cornell box with the BVH attached: W1, W2 and the path's
    gather are launched, K1 and K2 are not."""
    scene, system = cornell_box((64, 64))
    r = Renderer(scene, system, render_mode=RenderMode.FULL, device=cuda)
    r.device_scene = upload_scene(scene, cuda, use_bvh=True)
    assert r.device_scene.planes is None
    kernels = (WC.CLOSEST_KERNEL, WC.ANYHIT_KERNEL, GC.PATH_KERNEL, IC.CLOSEST_KERNEL, IC.ANYHIT_KERNEL)
    before = [k.launches for k in kernels]
    r.render(2)
    after = [k.launches for k in kernels]
    assert all(a > b for a, b in zip(after[:3], before[:3])) and after[3:] == before[3:]
    img = r.image_hdr()
    assert np.isfinite(img).all() and img.std() > 0


# ---- the frame as a CUDA graph -----------------------------------------------

def _frame_bits(r):
    st = r.net_state
    s = r.last_stats
    return ([t.detach().view(torch.int32) for m in (st.params, st.ema, st.opt.mu, st.opt.nu) for t in m.tensors()]
            + [st.opt.step, r.image.view(torch.int32), s.loss.view(torch.int32), s.num_train_records,
               s.traced_rays])


def _graph_pair(cuda, res=(64, 64), tiles=(8, 8)):
    import dataclasses

    scene, system = cornell_box(res)
    system = dataclasses.replace(system, tile_size=tiles)
    return [Renderer(scene, system, render_mode=RenderMode.FULL, adaptive_tiles=False, device=cuda, capture=c)
            for c in (False, True)]


def test_replayed_frames_equal_eager_frames(cuda):
    """FULL + train frames, eager and replayed from the same start, through a
    tile-size change, a restart, a reset of the cache and a new learning
    rate: bit for bit equal after every frame."""
    import dataclasses

    pair = _graph_pair(cuda)
    steps = {2: lambda r: setattr(r, "cfg", dataclasses.replace(r.cfg, tile_size=(16, 16))),
             4: lambda r: setattr(r, "cfg", dataclasses.replace(r.cfg, tile_size=(8, 8))),
             5: lambda r: r.restart_accumulation(),
             6: lambda r: r.reset_cache(),
             7: lambda r: r.set_hyper_params(learning_rate=5e-3)}
    for f in range(9):
        for r in pair:
            if f in steps:
                steps[f](r)
            r.render_frame()
        torch.cuda.synchronize()
        same = [torch.equal(a, b) for a, b in zip(_frame_bits(pair[0]), _frame_bits(pair[1]))]
        assert all(same), f"frame {f}: {same}"
    assert pair[1].replays == 7 and len(pair[1].graphs) == 2 and pair[0].replays == 0
    assert all(g.nbytes > 0 for g in pair[1].graphs.values())


def test_replay_counts_the_launches_it_recorded(cuda):
    eager, replayed = _graph_pair(cuda)
    kernels = (IC.CLOSEST_KERNEL, IC.ANYHIT_KERNEL, MC.FORWARD_KERNEL, MC.TRAIN4_KERNEL, GC.PATH_KERNEL,
               MC.TRAIN_GRAD_KERNEL)
    for r in (eager, replayed):
        r.render_frame()
    counts = []
    for r in (eager, replayed):
        before = [k.launches for k in kernels]
        r.render(3)
        counts.append([k.launches - b for k, b in zip(kernels, before)])
    assert replayed.replays == 3
    assert counts[0] == counts[1] and all(c > 0 for c in counts[1][:5]), counts
    assert counts[1][3] == 3 and counts[1][5] == 0  # K6 once a frame, K5 never


def test_benchmark_traced_rays_under_replay(cuda):
    """Every replay writes the same stats buffers: the timed run's traced
    rays are summed on the device, not read from them afterwards."""
    eager, replayed = _graph_pair(cuda)
    res = replayed.benchmark(4)
    eager.render_frame()
    eager.restart_accumulation()
    counts = [int(eager.render_frame().traced_rays) for _ in range(4)]
    assert replayed.replays >= 4 and res["traced_rays_per_frame"] * 4 == sum(counts)
    assert len(set(counts)) > 1


def test_failed_capture_raises(cuda, monkeypatch):
    """A frame that reads the device cannot be captured: the renderer raises
    and does not fall back to eager frames."""
    from nrc_tpu_torch.render import integrator

    monkeypatch.setattr(integrator, "_all_done", lambda alive: not bool(alive.any()))
    _, replayed = _graph_pair(cuda)
    with pytest.raises(RuntimeError, match="capturing the frame"):
        replayed.render_frame()
    assert not replayed.graphs


def test_failed_capture_releases_the_default_generator(cuda, monkeypatch):
    """After a failed capture, PyTorch's default CUDA generator draws again,
    on the stream the frame was called on, and a renderer that can be
    captured captures and replays."""
    from nrc_tpu_torch.render import integrator

    stream = torch.cuda.current_stream(cuda)
    with monkeypatch.context() as mp:
        mp.setattr(integrator, "_all_done", lambda alive: not bool(alive.any()))
        _, replayed = _graph_pair(cuda)
        with pytest.raises(RuntimeError, match="capturing the frame"):
            replayed.render_frame()
    assert torch.cuda.current_stream(cuda) == stream
    x = torch.randn(1000, device=cuda)
    torch.cuda.synchronize(cuda)
    assert bool(torch.isfinite(x).all()) and 0.5 < x.std().item() < 1.5
    eager, replayed = _graph_pair(cuda)
    for _ in range(3):
        eager.render_frame()
        replayed.render_frame()
    torch.cuda.synchronize(cuda)
    assert replayed.replays >= 1 and torch.equal(eager.image, replayed.image)


# ---------------------------------------------------------------------------
# the hash grid: H1, H2
# ---------------------------------------------------------------------------

HASH_GRIDS = {
    "full": {},
    "edge": dict(hash_log2_size=10, hash_base_resolution=4),
    "f1": dict(hash_n_levels=6, hash_log2_size=12, hash_base_resolution=8, hash_n_features_per_level=1),
    "f4": dict(hash_n_levels=8, hash_log2_size=12, hash_base_resolution=2, hash_n_features_per_level=4),
    "f8": dict(hash_n_levels=4, hash_log2_size=9, hash_base_resolution=3, hash_n_features_per_level=8),
}


def _hash_spec(name):
    return E.grid_spec(NetworkConfig(encoding=InputEncoding.HASH, **HASH_GRIDS[name]))


@pytest.mark.parametrize("grid", sorted(HASH_GRIDS))
@pytest.mark.parametrize("n", [1, 31, 1001])
def test_h1_h2_match_plain(cuda, grid, n):
    """H1 bit for bit, H2 within CARD_LIMITS (its g through a [B, 128] row
    stride), the seeded faults above them; B = 1 and not a multiple of 32."""
    spec = _hash_spec(grid)
    gen = torch.Generator(device=cuda).manual_seed(n)
    BH.check(spec, n, n, gen, cuda, grid)


def test_h1_h2_at_the_frame_shapes(cuda):
    gen = torch.Generator(device=cuda).manual_seed(0)
    out = BH.check(BH.full_spec(), BH.INFER_ROWS, BH.STEP_ROWS, gen, cuda, "full")
    assert out["h2_bits_equal_run_to_run"] and out["h2_bits_equal_fixed_point_model"]  # the fixed point
    assert out["h1"]["max_abs"] == 0.0
    assert BH.check_lookup(BH.full_spec(), BH.STEP_ROWS, gen, cuda)["differing"] == 0


def test_h2_by_levels_adds_up(cuda):
    """H2 on the grid cut to the dense levels and to the hashed ones (its
    time by level) gives the whole grid's rows of those levels."""
    spec = BH.full_spec()
    gen = torch.Generator(device=cuda).manual_seed(1)
    pos, _, g = BH.inputs(spec, 5000, gen, cuda)
    whole = HC.hash_grid_adjoint_cuda(pos, g, spec)
    n_dense, F = sum(spec.dense), spec.features
    parts = [HC.hash_grid_adjoint_cuda(pos, g[:, lo * F:hi * F], BH.sliced(spec, lo, hi))
             for lo, hi in ((0, n_dense), (n_dense, spec.levels))]
    # the scale is a level's own, so the levels' sums are the same bits
    assert torch.equal(torch.cat(parts), whole)


def test_hash_wrappers_refuse_bad_inputs(cuda):
    spec = BH.full_spec()
    pos = torch.rand((64, 3), generator=torch.Generator(device=cuda).manual_seed(2), device=cuda)
    table = torch.zeros(spec.table_shape, device=cuda)
    with pytest.raises(ValueError):
        HC.hash_grid_lookup_cuda(pos, table[:, :100], spec)
    with pytest.raises(TypeError):
        HC.hash_grid_lookup_cuda(pos.double(), table, spec)
    with pytest.raises(ValueError):
        HC.hash_grid_adjoint_cuda(pos, torch.zeros((64, 31), device=cuda), spec)
    with pytest.raises(TypeError):
        HC.hash_grid_adjoint_cuda(pos, torch.zeros((64, 32), device=cuda, dtype=torch.float64), spec)
    with pytest.raises(ValueError):
        HC.hash_grid_lookup_cuda(pos, table, spec._replace(features=3))


def test_hash_train_step_goes_through_h1_k4_h2(cuda):
    cfg = NetworkConfig(encoding=InputEncoding.HASH)
    st = N.init_network(torch.Generator().manual_seed(0), cfg, cuda)
    gen = torch.Generator(device=cuda).manual_seed(3)
    q = torch.rand((512, 15), generator=gen, device=cuda)
    q[:, :3] = (q[:, :3] - 0.5) * 0.1
    t = torch.rand((512, 3), generator=gen, device=cuda)
    kernels = (HC.LOOKUP_KERNEL, MC.FORWARD_KERNEL, MC.BACKWARD_KERNEL, HC.ADJOINT_KERNEL)
    before = [k.launches for k in kernels]
    new, loss = N.train_step(st, q, t, cfg)
    torch.cuda.synchronize()
    assert [k.launches - b for k, b in zip(kernels, before)] == [1, 1, 1, 1]
    assert torch.isfinite(loss) and int(new.opt.step) == 1
    assert not torch.equal(new.grid.table, st.grid.table)


def test_hash_frame_replays_count_h1_h2_k4(cuda):
    """A replayed hash FULL + train frame: H1 5, H2 4, K4 4, K6 0 launches;
    the state stays in place and nothing falls back to the CPU."""
    scene, system = cornell_box((64, 64))
    system = dataclasses.replace(system, tile_size=(8, 8))
    r = Renderer(scene, system, render_mode=RenderMode.FULL, adaptive_tiles=False, device=cuda)
    r.set_encoding(InputEncoding.HASH)
    table = r.net_state.grid.table
    r.render(2)
    kernels = (HC.LOOKUP_KERNEL, HC.ADJOINT_KERNEL, MC.BACKWARD_KERNEL, MC.TRAIN4_KERNEL)
    before = [k.launches for k in kernels]
    r.render(3)
    assert r.replays >= 3
    assert [k.launches - b for k, b in zip(kernels, before)] == [15, 12, 12, 0]
    assert r.net_state.grid.table is table and table.is_cuda
    r.flush_stats()
    assert int(r.net_state.opt.step) == 20 and np.isfinite(r.image_hdr()).all()
