"""Port parity: the two-lobe layered BSDF, every blend and modifier mode.

``nrc_tpu/ops/layered.py`` and ``nrc_tpu_torch/ops/layered.py`` on the same
numpy inputs from a seed: ``test_torch_bsdf.py``'s 8192 lanes of
archetypes 0-8 as lobe 1, a second lobe of archetypes 0-8 in another
order, and a blend descriptor whose mode cycles through the four blend
modes (none, fixed, Fresnel, curve) and, on a coprime cycle, the five
modifier modes (none, directional, conductor Fresnel, thin film, curve), so
every pair of modes meets: random colour weights, blend IORs, 16-point
curves, normal and grazing tints or conductor n and k or a film IOR, and
exponents or film thicknesses (100-1000 nm).

Tolerance, and its witness. Both sides compute the same expressions in
float32 and round arccos, pow, cos and the contracted products apart by a
few ulp. A lane's event is a decision: the lobe pick xi4 < p1 and each
lobe's own edges (``test_torch_bsdf._edge_lanes``), so events are held
exactly on the lanes away from those edges (within 1e-4 of a threshold);
the floats of the lanes whose events agree are held to ``LIMITS``, each
bound about ten times its largest reading over seeds 0-2. The thin film's
phase reaches 57 radians, so its cosine carries the phase's rounding:
the modifier's bound is the loosest.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nrc_tpu.ops import layered as JL
from nrc_tpu_torch.ops import bsdf as PB
from nrc_tpu_torch.ops import layered as PL
from nrc_tpu_torch.scene.materials import CURVE_RES
from test_torch_bsdf import ARCHETYPES, N, _edge_lanes, _inputs, _params, _rel, _unit
from test_torch_intersect import one_torch_thread  # noqa: F401 (an autouse fixture)

BLEND_MODES = (PL.BLEND_NONE, PL.BLEND_FIXED, PL.BLEND_FRESNEL, PL.BLEND_CURVE)
MOD_MODES = (PL.MOD_NONE, PL.MOD_DIRECTIONAL, PL.MOD_FRESNEL_COND, PL.MOD_THIN_FILM, PL.MOD_CURVE)


def _layered_inputs(seed, blend_mode=None, mod_mode=None):
    """The lanes' inputs; ``blend_mode`` / ``mod_mode`` put one mode on every
    lane instead of the cycles. A modifier's parameters are drawn as its
    mode declares them: tints in [0, 1] and exponents 0.5-5 (directional),
    n 0.1-3 and k 0-5 (conductor), a film IOR 1.2-2 and 100-1000 nm (thin
    film; a film of IOR below 1 a few nm thick makes the reference's
    formula 0/0, whose value is whichever way cos(dphi) rounds)."""
    a = _inputs(seed)
    rs = np.random.default_rng(100 + seed)
    a["archetype2"] = np.resize(np.asarray(ARCHETYPES[::-1], np.int32), N + 3)[3:]
    a["albedo2"] = rs.uniform(0.05, 1.0, (N, 3)).astype(np.float32)
    a["roughness2"] = rs.uniform(0.02, 1.0, (N, 2)).astype(np.float32)
    a["xi"] = rs.random((N, 5), dtype=np.float32)
    a["wi"] = _unit(rs, N)
    modes = np.resize(np.asarray(MOD_MODES, np.int32), N) if mod_mode is None else np.full(N, mod_mode, np.int32)
    film = (modes == PL.MOD_THIN_FILM)[:, None]
    conductor = (modes == PL.MOD_FRESNEL_COND)[:, None]
    a.update(
        blend_mode=(np.resize(np.asarray(BLEND_MODES, np.int32), N) if blend_mode is None
                    else np.full(N, blend_mode, np.int32)),
        w1=rs.uniform(0.0, 1.0, (N, 3)).astype(np.float32),
        w2=rs.uniform(0.0, 1.0, (N, 3)).astype(np.float32),
        blend_ior=rs.uniform(1.1, 2.5, N).astype(np.float32),
        curve=rs.uniform(0.0, 1.0, (N, CURVE_RES, 3)).astype(np.float32),
        mod_mode=modes,
        mod_a=np.where(film, rs.uniform(1.2, 2.0, (N, 1)),
                       np.where(conductor, rs.uniform(0.1, 3.0, (N, 3)), rs.uniform(0.0, 1.0, (N, 3)))
                       ).astype(np.float32),
        mod_b=np.where(conductor, rs.uniform(0.0, 5.0, (N, 3)), rs.uniform(0.0, 1.0, (N, 3))).astype(np.float32),
        mod_exp=np.where(film[:, 0], rs.uniform(100.0, 1000.0, N), rs.uniform(0.5, 5.0, N)).astype(np.float32),
    )
    return a


def _blend(mod, a, tensor):
    as_int = (lambda x: x.astype(np.int64)) if mod is PL else (lambda x: x)
    return mod.BlendParams(
        blend_mode=tensor(as_int(a["blend_mode"])), w1=tensor(a["w1"]), w2=tensor(a["w2"]),
        blend_ior=tensor(a["blend_ior"]), curve=tensor(a["curve"]), mod_mode=tensor(as_int(a["mod_mode"])),
        mod_a=tensor(a["mod_a"]), mod_b=tensor(a["mod_b"]), mod_exp=tensor(a["mod_exp"]),
    )


def _lobe2(a):
    return dict(a, archetype=a["archetype2"], albedo=a["albedo2"], roughness=a["roughness2"])


def _np(x):
    return {k: (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)) for k, v in x._asdict().items()}


def _both(a):
    """(JAX, port) blend weights, modifier, sample, eval and aux as numpy."""
    j = {k: jnp.asarray(v) for k, v in a.items()}
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    j1, j2 = _params(JL.B, a, jnp.asarray), _params(JL.B, _lobe2(a), jnp.asarray)
    p1, p2 = _params(PB, a, torch.from_numpy), _params(PB, _lobe2(a), torch.from_numpy)
    jb, pb = _blend(JL, a, jnp.asarray), _blend(PL, a, torch.from_numpy)
    vw = PL.view_weights(pb, t["wo"], t["ns"])  # the bounce's: once for sample, eval and aux
    sgn = np.where((a["wo"] * a["ns"]).sum(-1) >= 0.0, 1.0, -1.0).astype(np.float32)
    cos_o = (a["wo"] * a["ns"] * sgn[:, None]).sum(-1).astype(np.float32)
    out = {
        "weights": ([np.asarray(x) for x in JL.blend_weights(jb, jnp.asarray(cos_o))],
                    [x.numpy() for x in PL.blend_weights(pb, torch.from_numpy(cos_o))]),
        "modifier": (np.asarray(JL.modifier_factor(jb, jnp.asarray(cos_o))),
                     PL.modifier_factor(pb, torch.from_numpy(cos_o)).numpy()),
        "sample": (_np(JL.layered_sample(j1, j2, jb, j["wo"], j["ns"], j["ng"], j["xi"], j["eta_i"], j["eta_t"])),
                   _np(PL.layered_sample(p1, p2, pb, vw, t["wo"], t["ns"], t["ng"], t["xi"], t["eta_i"],
                                         t["eta_t"]))),
        "eval": (_np(JL.layered_eval(j1, j2, jb, j["wo"], j["wi"], j["ns"], j["eta_i"], j["eta_t"])),
                 _np(PL.layered_eval(p1, p2, pb, vw, t["wo"], t["wi"], t["ns"], t["eta_i"], t["eta_t"]))),
        "aux": (_np(JL.layered_aux(j1, j2, jb, j["wo"], j["ns"])), _np(PL.layered_aux(p1, p2, pb, vw))),
    }
    return out


def _edges(a, p1):
    """Lanes within 1e-4 of a threshold their event decides on: the lobe pick
    xi4 < p1 (the port's p1) and either lobe's own edges."""
    return (np.abs(a["xi"][:, 4] - p1) < 1e-4) | _edge_lanes(a) | _edge_lanes(_lobe2(a))


# each bound about ten times the largest reading over seeds 0-2 and the
# 20 single-mode sets (seed 3); no event flipped
LIMITS = {
    "weights_rel": 2e-5,          # w1, w2, p1: 1.53e-6
    "modifier_rel": 2e-4,         # 1.84e-5 (the thin film's cosine)
    "event_flips_off_edge": 0,    # 0
    "flipped_share": 0.003,       # 0
    "wi_abs": 2e-5,               # 1.49e-6
    "weight_rel": 5e-5,           # 4.92e-6 (units of max(|w|, 1))
    "pdf_rel": 3e-4,              # 2.55e-5 (units of max(pdf, 1))
    "eval_f_rel": 2e-5,           # 1.65e-6
    "eval_pdf_rel": 1e-4,         # 8.08e-6
    "aux_rel": 2e-4,              # 1.28e-5
}


def readings(a) -> dict:
    got = _both(a)
    (jw, pw), (jmf, pmf) = got["weights"], got["modifier"]
    (js, ps), (je, pe), (ja, pa) = got["sample"], got["eval"], got["aux"]
    same = js["event"] == ps["event"]
    edge = _edges(a, pw[2])
    return {
        "weights_rel": float(max(_rel(p, j).max() for j, p in zip(jw, pw))),
        "modifier_rel": float(_rel(pmf, jmf).max()),
        "event_flips_off_edge": int((~same & ~edge).sum()),
        "flipped_share": float((~same).mean()),
        "wi_abs": float(np.abs(ps["wi"] - js["wi"])[same & (ps["event"] != 0)].max()),
        "weight_rel": float(_rel(ps["bsdf_over_pdf"], js["bsdf_over_pdf"])[same].max()),
        "pdf_rel": float(_rel(ps["pdf"], js["pdf"])[same].max()),
        "eval_f_rel": float(_rel(pe["bsdf"], je["bsdf"]).max()),
        "eval_pdf_rel": float(_rel(pe["pdf"], je["pdf"]).max()),
        "aux_rel": float(max(_rel(pa[k], ja[k]).max() for k in ja)),
    }


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_layered_matches_jax(seed):
    got = readings(_layered_inputs(seed))
    over = {k: (v, LIMITS[k]) for k, v in got.items() if not v <= LIMITS[k]}
    assert not over, f"readings over their limits: {over}"


@pytest.mark.parametrize("blend_mode", BLEND_MODES)
@pytest.mark.parametrize("mod_mode", MOD_MODES)
def test_each_blend_and_modifier_mode_matches_jax(blend_mode, mod_mode):
    """One blend mode and one modifier mode on every lane, under the same
    limits; the modes act (a single lobe weighs (1, 0) and picks lobe 1; a
    modifier other than none moves the factor off 1)."""
    a = _layered_inputs(3, blend_mode, mod_mode)
    got = readings(a)
    over = {k: (v, LIMITS[k]) for k, v in got.items() if not v <= LIMITS[k]}
    assert not over, f"readings over their limits: {over}"
    pb = _blend(PL, a, torch.from_numpy)
    cos_o = torch.from_numpy(np.abs((a["wo"] * a["ns"]).sum(-1)).astype(np.float32))
    w1, w2, p1 = PL.blend_weights(pb, cos_o)
    if blend_mode == PL.BLEND_NONE:
        assert (w1 == 1.0).all() and (w2 == 0.0).all() and (p1 == 1.0).all()
    elif blend_mode in (PL.BLEND_FRESNEL, PL.BLEND_CURVE):
        assert torch.equal(w2, 1.0 - w1)
    mf = PL.modifier_factor(pb, cos_o)
    assert (mf == 1.0).all() if mod_mode == PL.MOD_NONE else (mf != 1.0).any()


def test_conductor_and_thin_film_match_jax():
    """The conductor Fresnel and the thin-film factor on their own, over the
    whole angular range (gold-like and random n, k; 0-1000 nm films)."""
    rs = np.random.default_rng(6)
    cos = rs.uniform(0.0, 1.0, N).astype(np.float32)
    n = rs.uniform(0.1, 3.0, (N, 3)).astype(np.float32)
    k = rs.uniform(0.0, 5.0, (N, 3)).astype(np.float32)
    c_j = np.asarray(JL.fresnel_conductor(jnp.asarray(cos), jnp.asarray(n), jnp.asarray(k)))
    c_p = PL.fresnel_conductor(torch.from_numpy(cos), torch.from_numpy(n), torch.from_numpy(k)).numpy()
    # reading 4.8e-7 (seed 6)
    assert np.abs(c_p - c_j).max() <= 5e-6 and (c_p >= 0.0).all() and (c_p <= 1.0).all()
    film_ior = rs.uniform(1.0, 2.0, N).astype(np.float32)
    d = rs.uniform(0.0, 1000.0, N).astype(np.float32)
    f_j = np.asarray(JL._thin_film_factor(jnp.asarray(cos), jnp.asarray(film_ior), jnp.asarray(d)))
    f_p = PL._thin_film_factor(torch.from_numpy(cos), torch.from_numpy(film_ior), torch.from_numpy(d)).numpy()
    # reading 1.5e-5 (seed 6): the phase's rounding through the cosine, at
    # its largest where a film near IOR 1 and 0 nm makes a ratio of small terms
    assert np.abs(f_p - f_j).max() <= 1e-4
