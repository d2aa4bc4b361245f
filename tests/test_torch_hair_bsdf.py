"""Port parity for the Chiang hair BSDF (``ops/hair_bsdf.py``) against the
JAX package, and the port's own copies of ``tests/test_hair_bsdf.py``'s
checks (finite and positive, the pdf integrates to one, a white fibre's
furnace, absorption tints, sampling matches evaluation).

Tolerances and their reasons (readings on these seeded inputs):

- ``EVAL_RTOL`` 2e-4 on f and pdf of ``hair_eval`` (reads 4.9e-5): the two
  packages' ``exp``, ``log``, ``sinh``, ``atan2`` and ``asin`` round a few
  ulp apart, and the longitudinal term exp(log I0(a) - b - 1/v ...) turns
  an ulp of its argument into a relative error of the same size times the
  argument's magnitude (up to 1/v = 1e2 here). The integer powers of the
  roughness mappings are XLA's multiplication chains on both sides
  (``_ipow``) and agree bit for bit;
- ``SAMPLE_DIR_ATOL`` 1e-5 on the sampled direction (reads 1.5e-6) and
  ``EVAL_RTOL`` on its weight and pdf, away from the lobe pick's decisions:
  a ray whose uniform lies within ``DECISION`` (1e-5) of a step of the
  lobe cdf may take another lobe on the other side, and is counted, not
  compared. The diffuse pick (xi >= 1 - w) rounds the same on both sides.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nrc_tpu.ops import hair_bsdf as JH
from nrc_tpu_torch.ops import hair_bsdf as PH
from test_torch_intersect import one_torch_thread  # noqa: F401 (an autouse fixture)

EVAL_RTOL = 2e-4
SAMPLE_DIR_ATOL = 1e-5
DECISION = 1e-5
N = 4096


def unit(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


def random_inputs(seed):
    """Seeded directions, offsets, uniforms and per-ray parameters."""
    rng = np.random.default_rng(seed)
    arrays = dict(
        sigma_a=rng.uniform(0, 2, (N, 3)), ior=rng.uniform(1.3, 1.8, N), beta_m=rng.uniform(0.05, 0.9, (N, 3)),
        beta_n=rng.uniform(0.05, 0.9, (N, 3)), cuticle_angle=rng.uniform(0.0, 0.1, N),
        diffuse_weight=rng.uniform(0.0, 0.5, N), diffuse_tint=rng.uniform(0.0, 1.0, (N, 3)))
    params = {k: np.asarray(v, np.float32) for k, v in arrays.items()}
    return dict(params=params, wo=unit(rng.normal(size=(N, 3))), wi=unit(rng.normal(size=(N, 3))),
                h=rng.uniform(-0.99, 0.99, N).astype(np.float32),
                xi=rng.uniform(0.0, 1.0, (N, 4)).astype(np.float32))


def both_params(params):
    return (PH.HairParams(**{k: torch.tensor(v) for k, v in params.items()}),
            JH.HairParams(**{k: jnp.asarray(v) for k, v in params.items()}))


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b) / np.maximum(np.abs(b), 1e-6)


@pytest.mark.parametrize("seed", [0, 1])
def test_hair_eval_equals_jax(seed):
    x = random_inputs(seed)
    pp, jp = both_params(x["params"])
    f, pdf = PH.hair_eval(pp, torch.tensor(x["wo"]), torch.tensor(x["wi"]), torch.tensor(x["h"]))
    fj, pdfj = JH.hair_eval(jp, jnp.asarray(x["wo"]), jnp.asarray(x["wi"]), jnp.asarray(x["h"]))
    assert rel(f, fj).max() <= EVAL_RTOL and rel(pdf, pdfj).max() <= EVAL_RTOL


def test_roughness_mappings_equal_jax_bit_for_bit():
    beta = torch.linspace(0.0, 1.0, 1001)
    for name in ("_beta_to_v", "_beta_to_s"):
        got = getattr(PH, name)(beta).numpy()
        assert np.array_equal(got, np.asarray(getattr(JH, name)(jnp.asarray(beta.numpy())))), name
    # JAX's integer_pow: repeated squaring, the set bits' powers from the lowest
    b2 = beta * beta
    b4 = b2 * b2
    b16 = (b4 * b4) * (b4 * b4)
    for n, want in ((1, beta), (2, b2), (3, beta * b2), (20, b4 * b16), (22, (b2 * b4) * b16)):
        assert torch.equal(PH._ipow(beta, n), want), n


@pytest.mark.parametrize("seed", [0, 1])
def test_hair_sample_equals_jax(seed):
    x = random_inputs(seed)
    pp, jp = both_params(x["params"])
    wo, h, xi = torch.tensor(x["wo"]), torch.tensor(x["h"]), torch.tensor(x["xi"])
    wi, w, pdf = PH.hair_sample(pp, wo, h, xi)
    wij, wj, pdfj = JH.hair_sample(jp, jnp.asarray(x["wo"]), jnp.asarray(x["h"]), jnp.asarray(x["xi"]))
    # the lobe pick's decisions: u0 within DECISION of one of the first three
    # steps of either side's cdf (the last is 1), on rays that do not take
    # the diffuse lobe, whose direction does not depend on the pick
    ap_j = np.asarray(JH._attenuations(JH._geometry(jnp.asarray(x["wo"]), jnp.asarray(x["h"]), jp))).mean(-1)
    cdfs = [PH._lobe_cdf(PH._lobe_pdf(PH._attenuations(PH._geometry(wo, h, pp)))).numpy(),
            np.cumsum(ap_j / np.maximum(ap_j.sum(-1, keepdims=True), 1e-9), axis=-1)]
    w_mix = x["params"]["diffuse_weight"]
    u0 = np.clip(x["xi"][:, 0] / np.maximum(1.0 - w_mix, 1e-6), 0.0, 1.0)
    take_diff = x["xi"][:, 0] >= 1.0 - w_mix
    decision = np.zeros(N, bool)
    for cdf in cdfs:
        decision |= ~take_diff & (np.abs(u0[:, None] - cdf[:, :3]) <= DECISION).any(-1)
    keep = ~decision
    assert decision.sum() <= 4, decision.sum()
    assert np.abs(wi.numpy() - np.asarray(wij))[keep].max() <= SAMPLE_DIR_ATOL
    assert rel(w, wj)[keep].max() <= EVAL_RTOL and rel(pdf, pdfj)[keep].max() <= EVAL_RTOL
    # the events the bounce takes from it: absorbed where pdf is 0
    assert np.array_equal((pdf.numpy() > 0.0)[keep], (np.asarray(pdfj) > 0.0)[keep])


# ---- the port's copies of tests/test_hair_bsdf.py ----------------------------


def make_params(n, sigma_a=(0.0, 0.0, 0.0), beta_m=0.3, beta_n=0.3, alpha=0.0, ior=1.55, dweight=0.0):
    return PH.HairParams(
        sigma_a=torch.tensor([sigma_a], dtype=torch.float32).expand(n, 3),
        ior=torch.full((n,), ior),
        beta_m=torch.full((n, 3), beta_m),
        beta_n=torch.full((n, 3), beta_n),
        cuticle_angle=torch.full((n,), alpha),
        diffuse_weight=torch.full((n,), dweight),
        diffuse_tint=torch.ones((n, 3)),
    )


def rand_dirs(seed, n):
    return torch.tensor(unit(np.random.default_rng(seed).normal(size=(n, 3))))


def fixed_dir(v, n):
    return torch.tensor(unit(np.asarray([v], np.float32))).expand(n, 3)


def test_eval_finite_positive():
    n = 512
    h = torch.tensor(np.random.default_rng(2).uniform(-0.99, 0.99, n), dtype=torch.float32)
    f, pdf = PH.hair_eval(make_params(n), rand_dirs(0, n), rand_dirs(1, n), h)
    assert bool(torch.isfinite(f).all()) and bool((f >= 0).all())
    assert bool(torch.isfinite(pdf).all()) and bool((pdf >= 0).all())


def test_pdf_integrates_to_one():
    n = 200_000
    _, pdf = PH.hair_eval(make_params(n, beta_m=0.4, beta_n=0.4), fixed_dir([0.3, 0.8, 0.52], n), rand_dirs(3, n),
                          torch.full((n,), 0.4))
    integral = pdf.mean().item() * 4.0 * math.pi
    assert abs(integral - 1.0) < 0.05, integral


def test_white_furnace():
    n = 200_000
    f, _ = PH.hair_eval(make_params(n, beta_m=0.5, beta_n=0.5), fixed_dir([0.1, 0.9, 0.42], n), rand_dirs(4, n),
                        torch.full((n,), -0.3))
    e = f.mean(-1).mean().item() * 4.0 * math.pi
    assert 0.85 < e < 1.1, e


def test_absorption_tints():
    n = 4096
    wo, wi, h = rand_dirs(5, n), rand_dirs(6, n), torch.zeros(n)
    f_w, _ = PH.hair_eval(make_params(n), wo, wi, h)
    f_a, _ = PH.hair_eval(make_params(n, sigma_a=(0.2, 1.0, 3.0)), wo, wi, h)
    ratio = (f_a.sum(0) / torch.clamp(f_w.sum(0), min=1e-9)).tolist()
    assert ratio[0] > ratio[1] > ratio[2], ratio


def test_sample_matches_eval():
    n = 4096
    rng = np.random.default_rng(8)
    wo = rand_dirs(7, n)
    h = torch.tensor(rng.uniform(-0.9, 0.9, n), dtype=torch.float32)
    xi = torch.tensor(rng.uniform(0.0, 1.0, (n, 4)), dtype=torch.float32)
    params = make_params(n, beta_m=0.4, beta_n=0.4)
    wi, w_over, pdf = PH.hair_sample(params, wo, h, xi)
    f, pdf_e = PH.hair_eval(params, wo, wi, h)
    ok = pdf > 1e-6
    np.testing.assert_allclose(pdf[ok].numpy(), pdf_e[ok].numpy(), rtol=1e-4)
    np.testing.assert_allclose(w_over[ok].numpy(), (f / torch.clamp(pdf_e, min=1e-9)[:, None])[ok].numpy(),
                               rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(torch.linalg.vector_norm(wi, dim=-1).numpy(), 1.0, atol=1e-4)


def test_sampled_furnace():
    n = 200_000
    xi = torch.tensor(np.random.default_rng(10).uniform(0.0, 1.0, (n, 4)), dtype=torch.float32)
    _, w_over, _ = PH.hair_sample(make_params(n, beta_m=0.4, beta_n=0.4), fixed_dir([0.2, 0.7, 0.686], n),
                                  torch.full((n,), 0.25), xi)
    e = w_over.mean(-1).mean().item()
    assert 0.8 < e < 1.15, e
