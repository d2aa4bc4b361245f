"""The hand-written CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA card and ``nvcc``. They carry the ``cuda`` marker
and skip without a card (the ``cuda`` fixture decides at run time, not at
import). Run them on the card with
``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``
(``tests/conftest.py`` imports JAX, which the card's machine need not have).
``chip_smoke.py`` runs the same comparisons at the full shapes of the
320x320 Cornell frame.

Tolerances: the kernels and the plain versions sum in other orders. In K4
an activation next to a bf16 rounding boundary can round one bf16 ulp apart
and move the gradients it feeds (relative to the largest entry, GRAD_TOL;
chip_smoke.py reads 9.6e-4 at B = 16384). K5 and K6 are held to what
chip_smoke.py reads at B = 16384 with some room: K5's gradients 9.1e-7 of
the largest entry (K5_TOL), K6's losses 1.8e-7 relative and its state
5.4e-7 apart at most and 3.4e-9 on the mean after four steps (K6_MAX,
K6_MEAN). A skipped EMA update of the last step reads 5.6e-4 / 2.5e-4 there,
a skipped Adam step 3.0e-3 / 1.4e-3 on the weights (PERF.md).
"""

import numpy as np
import pytest
import torch

from nrc_tpu_torch.config import NetworkConfig, RenderMode
from nrc_tpu_torch.models import network as N
from nrc_tpu_torch.ops import intersect_cuda as IC
from nrc_tpu_torch.ops import mlp_cuda as MC
from nrc_tpu_torch.ops.intersect import RT_MAX, TriSoA
from nrc_tpu_torch.render.renderer import Renderer
from nrc_tpu_torch.scene.scene_builder import cornell_box

pytestmark = pytest.mark.cuda
GRAD_TOL = 2e-3
K5_TOL = 1e-5
K6_MAX, K6_MEAN = 1e-5, 1e-7


def _rel(got, ref) -> float:
    return ((got - ref).abs().max() / ref.abs().max().clamp(min=1e-30)).item()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _soup(device, num_tris=1000, num_rays=3000):
    """1000 triangles (a ragged last shared-memory chunk), ray count not a
    multiple of the block, one degenerate triangle, some inactive lanes."""
    rs = np.random.default_rng(0)
    p0 = rs.uniform(-2, 2, (num_tris, 3)).astype(np.float32)
    p1 = (p0 + rs.normal(size=p0.shape) * 0.5).astype(np.float32)
    p2 = (p0 + rs.normal(size=p0.shape) * 0.5).astype(np.float32)
    p1[7] = p0[7]
    tris = TriSoA.build(p0, p1, p2, device=device)
    org = torch.tensor(rs.uniform(-3, 3, (num_rays, 3)), dtype=torch.float32, device=device)
    d = torch.tensor(rs.normal(size=(num_rays, 3)), dtype=torch.float32, device=device)
    d = d / d.norm(dim=-1, keepdim=True)
    tmin = torch.zeros(num_rays, device=device)
    tmax = torch.full((num_rays,), RT_MAX, device=device)
    tmax[::5] = 0.0
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


def test_k3_matches_plain(cuda):
    st = N.init_network(torch.Generator().manual_seed(0), NetworkConfig(), cuda)
    w = (st.ema.w_in, st.ema.w_hidden, st.ema.w_out)
    x = torch.rand((1000, MC.LANE), device=cuda)  # not a multiple of the CTA
    for relu in (True, False):
        n = MC.FORWARD_KERNEL.launches
        out = MC.fused_forward(*w, x, relu)
        ref = MC.fused_forward_plain(*w, x, relu)
        torch.cuda.synchronize()
        assert MC.FORWARD_KERNEL.launches == n + 1
        torch.testing.assert_close(out, ref, atol=1e-2, rtol=1e-2)  # bf16 operands


def _grad_inputs(cuda, b):
    st = N.init_network(torch.Generator().manual_seed(0), NetworkConfig(), cuda)
    gen = torch.Generator(device=cuda).manual_seed(1)
    q = torch.rand((4, b, 15), generator=gen, device=cuda)
    x4 = N.encode(q.view(-1, 15), NetworkConfig()).view(4, b, MC.LANE)
    t4 = torch.rand((4, b, 3), generator=gen, device=cuda) * 2.0
    return st, x4, t4


def test_k4_k5_match_plain(cuda):
    b = 1000  # not a multiple of the 128-row CTA
    st, x4, t4 = _grad_inputs(cuda, b)
    w = st.params.tensors()
    g = torch.randn((b, MC.OUT_PAD), generator=torch.Generator(device=cuda).manual_seed(2), device=cuda)
    n4, n5 = MC.BACKWARD_KERNEL.launches, MC.TRAIN_GRAD_KERNEL.launches
    got4 = MC.fused_backward(*w, x4[0], g)
    ref4 = MC.fused_backward_plain(*w, x4[0], g)
    got5 = MC.fused_train_grad(*w, x4[1], t4[1])
    ref5 = MC.fused_train_grad_plain(*w, x4[1], t4[1])
    torch.cuda.synchronize()
    assert MC.BACKWARD_KERNEL.launches == n4 + 1 and MC.TRAIN_GRAD_KERNEL.launches == n5 + 1
    for a, r in zip(got4, ref4):
        assert _rel(a, r) <= GRAD_TOL
    torch.testing.assert_close(got5[0], ref5[0], rtol=K5_TOL, atol=0)
    for a, r in zip(got5[1:], ref5[1:]):
        assert _rel(a, r) <= K5_TOL, _rel(a, r)


def test_k6_matches_plain(cuda):
    cfg = NetworkConfig()
    lr = torch.tensor(cfg.learning_rate, device=cuda)
    out = []
    for num_records in (5, 0):
        states = []
        for fn in (MC.fused_train4, MC.fused_train4_plain):
            st, x4, t4 = _grad_inputs(cuda, 2048)
            n5 = MC.TRAIN_GRAD_KERNEL.launches
            losses = fn(st.params.tensors(), st.opt.mu.tensors(), st.opt.nu.tensors(),
                        st.ema.tensors(), st.opt.step, x4, t4, lr,
                        torch.tensor(num_records, device=cuda), N.adam_hyper(cfg))
            # K6 launches K5's gradient kernel once per step, records or not
            assert MC.TRAIN_GRAD_KERNEL.launches == n5 + (4 if fn is MC.fused_train4 else 0)
            states.append((losses, N.state_to_numpy(st)))
        out.append(states)
    (lk, sk), (lp, sp) = out[0]
    torch.testing.assert_close(lk, lp, rtol=K5_TOL, atol=0)
    assert int(sk["opt.step"]) == int(sp["opt.step"]) == 4
    for key in sk:
        d = np.abs(sk[key] - sp[key])
        if key.startswith(("params.", "ema.", "opt.mu.", "opt.nu.")):
            assert d.max() <= K6_MAX and d.mean() <= K6_MEAN, (key, d.max(), d.mean())
    (lk, sk), (lp, sp) = out[1]
    assert not lk.any() and not lp.any() and int(sk["opt.step"]) == 0
    fresh = N.state_to_numpy(_grad_inputs(cuda, 8)[0])
    for key in sk:
        assert np.array_equal(sk[key], fresh[key]), key


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
    assert after[4] - before[4] == 4 * (after[3] - before[3])  # K5 inside K6
    img = r.image_hdr()
    assert np.isfinite(img).all() and img.std() > 0
    if train:
        r.flush_stats()
        assert len(r.loss_history) == 3 and int(r.net_state.opt.step) == 12
