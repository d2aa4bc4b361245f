"""Port parity: the procedural noise fields, tint and bump.

``nrc_tpu/ops/noise.py`` and ``nrc_tpu_torch/ops/noise.py`` on the same
numpy inputs from a seed. The lattice hash is integer arithmetic: bit for
bit, over random int32 lattice coordinates (negative and near +-2^31
included) and the edges of the u32 wrap. Perlin and fBm are float32 sums
of products of the same exact values in the same order, and read 0 apart;
Worley's distance rounds its contracted squares a last ulp apart (6e-8 on
0.6 % of the points); the marble sine and the threshold window's divide
carry that on. The bump divides field differences by its step 0.01, so an
ulp of the field is 50 ulps of the normal. Each bound stands beside its
largest reading over the seeds below.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nrc_tpu.ops import noise as JN
from nrc_tpu_torch.ops import noise as PN
from test_torch_intersect import one_torch_thread  # noqa: F401 (an autouse fixture)

N = 4096


def _points(seed, spread=20.0):
    rs = np.random.default_rng(seed)
    return ((rs.random((N, 3)) - 0.5) * spread).astype(np.float32)


def _lanes(seed):
    """Per-lane noise parameters over every mode and option."""
    rs = np.random.default_rng(50 + seed)
    lo = rs.uniform(0.0, 0.4, N).astype(np.float32)
    return dict(
        mode=np.resize(np.asarray([0, 1, 2, 3], np.int32), N),
        pos=_points(seed),
        ns=_unit(rs),
        color1=rs.random((N, 3), dtype=np.float32),
        color2=rs.random((N, 3), dtype=np.float32),
        scale=rs.uniform(0.2, 2.0, (N, 3)).astype(np.float32),
        absolute=(rs.random(N) < 0.5).astype(np.int32),
        thr_low=lo,
        thr_high=(lo + rs.uniform(0.2, 0.6, N)).astype(np.float32),
        marble=(rs.random(N) < 0.3).astype(np.int32),
        factor=np.where(rs.random(N) < 0.2, 0.0, rs.uniform(0.05, 1.0, N)).astype(np.float32),
    )


def _unit(rs):
    v = rs.normal(size=(N, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def test_hash_is_bit_exact():
    rs = np.random.default_rng(0)
    coords = [rs.integers(-2 ** 31, 2 ** 31, N, dtype=np.int64).astype(np.int32) for _ in range(3)]
    edges = np.asarray([0, 1, -1, 2 ** 31 - 1, -2 ** 31, 12345, -54321, 65535, -65536], np.int32)
    coords = [np.concatenate([c, np.roll(edges, k)]) for k, c in enumerate(coords)]
    want = np.asarray(JN._hash3(*(jnp.asarray(c) for c in coords))).astype(np.int64)
    got = PN._hash3(*(torch.from_numpy(c.astype(np.int64)) for c in coords)).numpy()
    assert np.array_equal(got, want) and got.min() >= 0 and got.max() < 2 ** 32
    # the lattice neighbours of a cell at the int32 edge wrap as u32 does
    ix = np.asarray([2 ** 31 - 1], np.int32)
    nxt_j = np.asarray(JN._hash3(jnp.asarray(ix) + 1, jnp.asarray(ix), jnp.asarray(ix)))
    nxt_p = PN._hash3(torch.tensor([2 ** 31]), torch.tensor([2 ** 31 - 1]), torch.tensor([2 ** 31 - 1])).numpy()
    assert np.array_equal(nxt_j.astype(np.int64), nxt_p)


@pytest.mark.parametrize("seed", [0, 1])
def test_perlin_and_fbm_match_jax(seed):
    p = _points(seed)
    pj, pt = jnp.asarray(p), torch.from_numpy(p)
    # reading 0 (seeds 0, 1; every octave count below too): the same exact
    # products summed in the same order
    assert np.abs(PN.perlin3(pt).numpy() - np.asarray(JN.perlin3(pj))).max() <= 1e-6
    for levels in (1, 3, 5):
        for absolute in (False, True):
            got = PN.fbm3(pt, levels, absolute).numpy()
            want = np.asarray(JN.fbm3(pj, levels, absolute))
            assert np.abs(got - want).max() <= 1e-6, (levels, absolute)
    assert np.abs(PN.fbm3(pt, 3, False, phase=0.7).numpy() - np.asarray(JN.fbm3(pj, 3, False, 0.7))).max() <= 1e-6


@pytest.mark.parametrize("seed", [0, 1])
def test_worley_matches_jax(seed):
    p = _points(seed)
    got = PN.worley3(torch.from_numpy(p)).numpy()
    want = np.asarray(JN.worley3(jnp.asarray(p)))
    # reading 6.0e-8 on 0.6 % of the points: the contracted squares' last ulp
    assert np.abs(got - want).max() <= 5e-7 and (got != want).mean() < 0.02
    assert 0.0 <= got.min() and got.max() <= 1.0 and got.std() > 0.05


def _scalar(mod, a, q, levels, tensor):
    return mod.noise_scalar(tensor(a["mode"]), tensor(q), levels, tensor(a["absolute"]), tensor(a["thr_low"]),
                            tensor(a["thr_high"]), tensor(a["marble"]))


@pytest.mark.parametrize("seed", [0, 1])
def test_noise_scalar_and_tint_match_jax(seed):
    """Every mode (none, Perlin, flow, Worley), absolute or not, marble or
    not, random threshold windows."""
    a = _lanes(seed)
    q = a["pos"] * a["scale"]
    for levels in (1, 3):
        got = _scalar(PN, a, q, levels, torch.from_numpy).numpy()
        want = np.asarray(_scalar(JN, a, q, levels, jnp.asarray))
        # reading 1.8e-7 (seeds 0, 1): Worley's ulp through the marble sine
        # and the window's divide (a window 0.2 wide scales it by 5)
        assert np.abs(got - want).max() <= 2e-6, levels
        assert 0.0 <= got.min() and got.max() <= 1.0
    # the port's tint takes the field (the bounce's noise_scalar at pos * scale)
    args = ("mode", "pos", "color1", "color2", "scale")
    tail = ("absolute", "thr_low", "thr_high", "marble")
    value = _scalar(PN, a, q, 3, torch.from_numpy)
    got = PN.noise_tint(torch.from_numpy(a["color1"]), torch.from_numpy(a["color2"]), value).numpy()
    want = np.asarray(JN.noise_tint(*(jnp.asarray(a[k]) for k in args), 3, *(jnp.asarray(a[k]) for k in tail)))
    assert np.abs(got - want).max() <= 2e-6


@pytest.mark.parametrize("seed", [0, 1])
def test_bump_normal_matches_jax(seed):
    """The bumped normal from the port's ``bump_fields`` (the bounce's four
    fields): unit, unchanged where the factor is 0, and the JAX normal
    within the bound."""
    a = _lanes(seed)
    args = ("mode", "pos", "ns", "scale")
    tail = ("absolute", "thr_low", "thr_high", "marble", "factor")
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    fields = PN.bump_fields(t["mode"], t["pos"], t["scale"], 3, *(t[k] for k in tail[:-1]))
    got = PN.noise_bump_normal(t["ns"], t["scale"], t["factor"], fields).numpy()
    want = np.asarray(JN.noise_bump_normal(*(jnp.asarray(a[k]) for k in args), 3,
                                           *(jnp.asarray(a[k]) for k in tail)))
    # reading 7.0e-6 (seed 1): a field's ulp over the step 0.01, times a
    # scale up to 2 and a factor up to 1
    assert np.abs(got - want).max() <= 5e-5
    assert np.allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-6)
    flat = a["factor"] == 0.0
    assert np.array_equal(got[flat], a["ns"][flat])
