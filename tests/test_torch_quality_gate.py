"""The port's quality gate: its metrics and tone curve against the JAX
package's, the committed ground truth, and (on the card) the gate itself.

``nrc_tpu_torch/tools/quality_gate.py`` renders FULL + train at 128x128 for
both encodings and NO_CACHE at 64 spp, and scores them against
``tests/data/torch_cornell_box_gt_128.npz`` (4096 spp, rendered on the card
by ``tools/make_ground_truth.py``). 128 training frames at 128x128 take
minutes on the CPU, so the gate itself runs on the card only (marker
``cuda``; ``chip_smoke.py`` runs it too); here the pieces it is made of are
held to the JAX package and the ground truth is checked for what it claims.
JAX is imported inside the two tests that compare with it, so that on the
card ``python -m pytest --noconftest -m cuda tests/test_torch_quality_gate.py``
runs without it.
"""

import numpy as np
import pytest
import torch

from nrc_tpu_torch.config import RenderMode, TonemapperConfig
from nrc_tpu_torch.render.renderer import Renderer
from nrc_tpu_torch.scene.scene_builder import cornell_box
from nrc_tpu_torch.tools import make_ground_truth as MG
from nrc_tpu_torch.tools import quality_gate as QG
from nrc_tpu_torch.utils import metrics as M
from nrc_tpu_torch.utils.tonemap import tonemap_to_u8


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread, as test_torch_intersect.py's fixture of the same
    name (not imported: this file imports no JAX, so that its card test runs
    where JAX is not installed)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _image_pair(seed, shape):
    rs = np.random.default_rng(seed)
    a = rs.random(shape)
    b = np.clip(a + rs.normal(scale=0.05, size=shape), 0.0, 1.0)
    return a.astype(np.float32), b.astype(np.float32)


@pytest.mark.parametrize("shape", [(40, 30, 3), (16, 16), (8, 9, 1)])
def test_psnr_ssim_match_jax(shape):
    """The same numpy code in float64: equal to the last bit."""
    from nrc_tpu.utils import metrics as JM

    a, b = _image_pair(len(shape), shape)
    assert M.psnr(a, b) == JM.psnr(a, b)
    assert M.ssim(a, b) == JM.ssim(a, b)
    assert M.psnr(a, a) == float("inf") and abs(M.ssim(a, a) - 1.0) < 1e-12
    assert M.psnr(a, b, peak=2.0) == JM.psnr(a, b, peak=2.0)


@pytest.mark.parametrize("config", [{}, dict(gamma=1.8, white_point=2.0, burn_highlights=0.5, crush_blacks=0.2,
                                             saturation=1.2, brightness=1.5)], ids=["default", "edited"])
def test_tonemap_to_u8_matches_jax(config):
    """pow and sqrt in another library round a few f32 ulp apart (see
    test_torch_train.py::test_tonemap_matches_jax); truncated to 8 bits a
    value next to a step could land one step apart: at most 1, on under
    0.1 % of the channels (none seen on these 196,608)."""
    import jax.numpy as jnp

    from nrc_tpu.config import TonemapperConfig as JTonemapperConfig
    from nrc_tpu.utils.tonemap import tonemap_to_u8 as jax_tonemap_to_u8

    rs = np.random.default_rng(4)
    hdr = (rs.random((256, 256, 3)) ** 3 * 8.0).astype(np.float32)
    hdr[0, :8] = 0.0
    ref = np.asarray(jax_tonemap_to_u8(jnp.asarray(hdr), JTonemapperConfig(**config)))
    got = tonemap_to_u8(torch.from_numpy(hdr), TonemapperConfig(**config))
    assert got.dtype == torch.uint8 and ref.dtype == np.uint8
    d = np.abs(got.numpy().astype(np.int32) - ref.astype(np.int32))
    assert d.max() <= 1 and (d > 0).mean() < 1e-3


def test_ground_truth_file():
    with np.load(QG.GT_PATH) as z:
        hdr = z["hdr"]
        assert hdr.shape == (QG.RES, QG.RES, 3) and hdr.dtype == np.float32
        assert int(z["spp"]) == QG.GT_SPP == 4096 and int(z["seed"]) == QG.GT_SEED
        assert int(z["res"]) == QG.RES and str(z["scene"]) == "cornell_box"
        assert "H100" in str(z["device"]) and float(z["seconds"]) > 0.0
    assert np.isfinite(hdr).all() and hdr.min() >= 0.0
    # the lit box, not a flat or black image: every channel carries light, the
    # walls' red and green tint their halves (row 0 at the top)
    mean = hdr.mean(axis=(0, 1))
    assert (mean > 0.1).all() and hdr.std() > 0.1
    left, right = hdr[:, :QG.RES // 4].mean(axis=(0, 1)), hdr[:, -QG.RES // 4:].mean(axis=(0, 1))
    assert left[0] > left[1] and right[1] > right[0]
    assert QG.score(hdr, hdr, TonemapperConfig())[0] == float("inf")


def test_gate_configuration_and_limits():
    """The reference's gate setup (test_quality_gate.py:36-57), and limits
    below the readings they were set from."""
    assert (QG.RES, QG.TILE, QG.FRAMES, QG.FLOOR_SPP) == (128, (4, 4), 128, 64)
    assert set(QG.LIMITS) == {"hash", "frequency", "no_cache_64spp"}
    for min_psnr, min_ssim in QG.LIMITS.values():
        assert 20.0 < min_psnr < 40.0 and 0.8 < min_ssim < 1.0


def test_ground_truth_render_starts_at_its_seed():
    """``render_ground_truth`` is the NO_CACHE mean of frames from subframe
    ``seed``: equal to a renderer driven by hand, and another seed draws
    other samples."""
    hdr = MG.render_ground_truth(2, 16, 7, "cpu")
    scene, system = cornell_box((16, 16))
    r = Renderer(scene, system, render_mode=RenderMode.NO_CACHE, train=False, adaptive_tiles=False,
                 device="cpu")
    r.total_subframe = 7
    r.render(2)
    np.testing.assert_array_equal(hdr, r.image_hdr())
    assert not np.array_equal(hdr, MG.render_ground_truth(2, 16, 8, "cpu"))


def test_score_ranks_a_noisier_image_lower():
    gt = QG.load_ground_truth()
    rs = np.random.default_rng(5)
    small = gt * rs.normal(1.0, 0.05, gt.shape).astype(np.float32)
    large = gt * rs.normal(1.0, 0.5, gt.shape).clip(0.0).astype(np.float32)
    (p1, s1), (p2, s2) = (QG.score(x, gt, TonemapperConfig()) for x in (small, large))
    assert p1 > p2 and s1 > s2


@pytest.mark.cuda
def test_quality_gate_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    rows = QG.run(torch.device("cuda", 0))
    QG.check(rows)
    assert set(rows) == set(QG.LIMITS)


def test_gate_rows_render_their_configuration(monkeypatch):
    """Each row's renderer at a tiny size: FULL + train for the encodings,
    NO_CACHE without training for the noise floor."""
    monkeypatch.setattr(QG, "RES", 16)
    monkeypatch.setattr(QG, "FRAMES", 1)
    monkeypatch.setattr(QG, "FLOOR_SPP", 1)
    seen = []
    real = QG.Renderer

    def spy(scene, system, **kw):
        r = real(scene, system, **kw)
        seen.append((kw.get("net_cfg"), r.cfg.render_mode, r.cfg.train, r.cfg.tile_size, r.adaptive_tiles))
        return r

    monkeypatch.setattr(QG, "Renderer", spy)
    for row in QG.LIMITS:
        hdr, tm = QG.render_row(row, "cpu")
        assert hdr.shape == (16, 16, 3) and np.isfinite(hdr).all() and tm == TonemapperConfig()
    (h_cfg, h_mode, h_train, h_tile, h_ad), (f_cfg, f_mode, *_), (n_cfg, n_mode, n_train, *_) = seen
    assert h_cfg.encoding.name == "HASH" and f_cfg.encoding.name == "FREQUENCY"
    assert h_mode == f_mode == RenderMode.FULL and h_train and h_tile == (4, 4) and not h_ad
    assert n_cfg is None and n_mode == RenderMode.NO_CACHE and not n_train
