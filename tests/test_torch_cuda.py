"""The hand-written CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA card and ``nvcc``. They carry the ``cuda`` marker
and skip without a card (the ``cuda`` fixture decides at run time, not at
import). Run them on the card with
``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``
(``tests/conftest.py`` imports JAX, which the card's machine need not have).
``chip_smoke.py`` runs the same comparisons at the full shapes of the
320x320 Cornell frame.
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


def test_wrappers_refuse_bad_inputs(cuda):
    tris, planes, org, d, tmin, tmax = _soup(cuda, num_rays=64)
    with pytest.raises(TypeError):
        IC.closest_cuda(org.double(), d, planes, tmin, tmax)
    with pytest.raises(ValueError):
        IC.closest_cuda(org, d, planes[:, :12], tmin, tmax)
    with pytest.raises(ValueError):
        MC.fused_forward_cuda(planes, planes, planes, org, True)


def test_renderer_goes_through_the_kernels(cuda):
    scene, system = cornell_box((64, 64))
    r = Renderer(scene, system, render_mode=RenderMode.FULL, device=cuda)
    before = [k.launches for k in (IC.CLOSEST_KERNEL, IC.ANYHIT_KERNEL, MC.FORWARD_KERNEL)]
    r.render(2)
    after = [k.launches for k in (IC.CLOSEST_KERNEL, IC.ANYHIT_KERNEL, MC.FORWARD_KERNEL)]
    assert all(a > b for a, b in zip(after, before))
    img = r.image_hdr()
    assert np.isfinite(img).all() and img.std() > 0
