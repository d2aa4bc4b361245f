"""Port parity: the BSDF lobes of archetypes 0-8, sample, evaluate and aux.

``nrc_tpu/ops/bsdf.py`` and ``nrc_tpu_torch/ops/bsdf.py`` on the same numpy
inputs from a seed: 8192 lanes of every archetype 0-8 (random tint,
roughness, IORs, thin walls, unit ``wo``, a shading normal within about 25
degrees of the geometric one, either side), the incident and transmitted
IORs drawn as the IOR stack gives them.

Tolerance, and its witness. Both sides compute the same expressions in
float32; XLA and PyTorch round sin, cos, sqrt and the contracted products
apart by a few ulp. A lane's event bitmask is a decision on such values
(the Fresnel lobe choice xi0 < F, total internal reflection sin^2 t >= 1,
and the validity tests of the sampled directions against 1e-6), so it is
held exactly on the lanes away from those edges (``_edge_lanes``: within
1e-4 of a threshold, 0.04-0.09 % of the lanes) and a lane that flips must
be such an edge lane (none did over these seeds).
The floats of the lanes whose events agree are held to ``LIMITS``, each
bound beside its largest reading over the seeds: the GGX weight divides by
cos_o * cos_hn and grows at grazing angles, so the weights are held
relatively. ``bsdf_aux`` is selects only: bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nrc_tpu.ops import bsdf as JB
from nrc_tpu_torch.ops import bsdf as PB
from nrc_tpu_torch.scene.materials import Archetype
from test_torch_intersect import one_torch_thread  # noqa: F401 (an autouse fixture)

N = 8192
ARCHETYPES = list(range(int(Archetype.NULL_BSDF) + 1))


def _unit(rs, n):
    v = rs.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _inputs(seed):
    rs = np.random.default_rng(seed)
    ng = _unit(rs, N)
    ns = ng + 0.4 * _unit(rs, N)
    ns = (ns / np.linalg.norm(ns, axis=-1, keepdims=True)).astype(np.float32)
    ior = rs.uniform(1.2, 2.0, N).astype(np.float32)
    outer = np.where(rs.random(N) < 0.7, 1.0, rs.uniform(1.0, 1.6, N)).astype(np.float32)
    front = rs.random(N) < 0.5
    return dict(
        archetype=np.resize(np.asarray(ARCHETYPES, np.int32), N),
        albedo=rs.uniform(0.05, 1.0, (N, 3)).astype(np.float32),
        roughness=rs.uniform(0.02, 1.0, (N, 2)).astype(np.float32),
        ior=ior,
        thin_walled=(rs.random(N) < 0.3).astype(np.int32),
        wo=_unit(rs, N), ns=ns, ng=ng,
        wi=_unit(rs, N),
        xi=rs.random((N, 4), dtype=np.float32),
        # entering: from the outer medium into the material; leaving: back
        eta_i=np.where(front, outer, ior).astype(np.float32),
        eta_t=np.where(front, ior, outer).astype(np.float32),
    )


def _params(mod, a, tensor):
    return mod.MaterialParams(
        archetype=tensor(a["archetype"].astype(np.int64) if mod is PB else a["archetype"]),
        albedo=tensor(a["albedo"]), roughness=tensor(a["roughness"]), ior=tensor(a["ior"]),
        thin_walled=tensor(a["thin_walled"].astype(np.float32) if mod is PB else a["thin_walled"]),
    )


def _both(a, families=None):
    """(JAX, port) sample, eval and aux as numpy."""
    j = {k: jnp.asarray(v) for k, v in a.items()}
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    jp, pp = _params(JB, a, jnp.asarray), _params(PB, a, torch.from_numpy)
    js = JB.bsdf_sample(jp, j["wo"], j["ns"], j["ng"], j["xi"], j["eta_i"], j["eta_t"], families=families)
    ps = PB.bsdf_sample(pp, t["wo"], t["ns"], t["ng"], t["xi"], t["eta_i"], t["eta_t"], families=families)
    je = JB.bsdf_eval(jp, j["wo"], j["wi"], j["ns"], j["eta_i"], j["eta_t"], families=families)
    pe = PB.bsdf_eval(pp, t["wo"], t["wi"], t["ns"], t["eta_i"], t["eta_t"], families=families)
    ja, pa = JB.bsdf_aux(jp), PB.bsdf_aux(pp)

    def np_(x):
        return {k: (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)) for k, v in x._asdict().items()}

    return [np_(x) for x in (js, ps, je, pe, ja, pa)]


def _edge_lanes(a):
    """Lanes within 1e-4 of a threshold their event decides on: the Fresnel
    choice xi0 < F, total internal reflection and the direction tests, for
    the specular lobes about the oriented normal and the GGX ones about the
    sampled half vector (float64 from the port's float32 inputs)."""
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    wo, ns = t["wo"], t["ns"]
    nf = ns * torch.where((wo * ns).sum(-1) >= 0.0, 1.0, -1.0)[:, None]
    eta = torch.clamp(t["eta_t"], min=1e-6) / torch.clamp(t["eta_i"], min=1e-6)
    h = PB._sample_ggx_h(nf, PB._ggx_alpha(t["roughness"]), t["xi"][:, 2:4])
    edge = torch.zeros(wo.shape[0], dtype=torch.bool)
    for n in (nf, h):
        cos = (wo * n).sum(-1).double()
        e = eta.double()
        sin2 = (1.0 - cos * cos) / (e * e)
        f = PB.fresnel_dielectric((wo * n).sum(-1), eta).double()
        wt, tir = PB.refract_dir(wo, n, eta)
        wr = 2.0 * (wo * n).sum(-1, keepdim=True) * n - wo
        edge |= ((sin2 - 1.0).abs() < 1e-4) | ((t["xi"][:, 0].double() - f).abs() < 1e-4)
        edge |= (cos - 1e-6).abs() < 1e-4
        # the refracted direction is tested only where it exists
        for d, exists in ((wt, ~tir), (wr, torch.ones_like(tir))):
            edge |= exists & (((d * nf).sum(-1).double().abs() - 1e-6).abs() < 1e-4)
    return edge.numpy()


def _rel(a, b, floor=1.0):
    return np.abs(a - b) / np.maximum(np.abs(b), floor)


# each bound about ten times the largest reading over seeds 0-2, every
# archetype together (0.04-0.06 % of the lanes are edge lanes; none flipped)
LIMITS = {
    "event_flips_off_edge": 0,    # 0
    "flipped_share": 0.002,       # 0
    "wi_abs": 1e-5,               # 1.31e-6
    "weight_rel": 1e-5,           # 1.61e-6 (units of max(|w|, 1))
    "pdf_rel": 1e-4,              # 1.17e-5 (units of max(pdf, 1))
    "eval_f_rel": 2e-6,           # 2.09e-7
    "eval_pdf_rel": 4e-6,         # 4.26e-7
}


def readings(a, families=None) -> dict:
    js, ps, je, pe, ja, pa = _both(a, families)
    same = js["event"] == ps["event"]
    edge = _edge_lanes(a)
    for k in ja:
        assert np.array_equal(ja[k], pa[k]), k
    return {
        "event_flips_off_edge": int((~same & ~edge).sum()),
        "flipped_share": float((~same).mean()),
        # an absorbed lane's direction is read by nothing (the JAX function
        # leaves the last family's there, the port zeros)
        "wi_abs": float(np.abs(ps["wi"] - js["wi"])[same & (ps["event"] != 0)].max()),
        "weight_rel": float(_rel(ps["bsdf_over_pdf"], js["bsdf_over_pdf"])[same].max()),
        "pdf_rel": float(_rel(ps["pdf"], js["pdf"])[same].max()),
        "eval_f_rel": float(_rel(pe["bsdf"], je["bsdf"]).max()),
        "eval_pdf_rel": float(_rel(pe["pdf"], je["pdf"]).max()),
    }


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bsdf_matches_jax(seed):
    got = readings(_inputs(seed))
    over = {k: (v, LIMITS[k]) for k, v in got.items() if not v <= LIMITS[k]}
    assert not over, f"readings over their limits: {over}"


@pytest.mark.parametrize("archetype", ARCHETYPES, ids=lambda a: Archetype(a).name)
def test_each_archetype_samples_its_events(archetype):
    """Each archetype's lanes take its own lobes: the events it may give,
    some lanes absorbed or not as the archetype allows, the same events as
    JAX on the lanes away from the edges."""
    a = _inputs(3)
    a["archetype"] = np.full(N, archetype, np.int32)
    js, ps, _, pe, _, _ = _both(a)
    edge = _edge_lanes(a)
    assert np.array_equal(js["event"][~edge], ps["event"][~edge].astype(np.int32))
    allowed = {
        Archetype.DIFFUSE_REFLECTION: {PB.BSDF_EVENT_DIFFUSE_REFLECTION},
        Archetype.GGX_REFLECT: {PB.BSDF_EVENT_GLOSSY_REFLECTION, 0},
        Archetype.GGX_TRANSMIT: {PB.BSDF_EVENT_GLOSSY_TRANSMISSION, 0},
        Archetype.GGX_REFLECT_TRANSMIT: {PB.BSDF_EVENT_GLOSSY_REFLECTION, PB.BSDF_EVENT_GLOSSY_TRANSMISSION, 0},
        Archetype.SPECULAR_REFLECT: {PB.BSDF_EVENT_SPECULAR_REFLECTION},
        Archetype.SPECULAR_TRANSMIT: {PB.BSDF_EVENT_SPECULAR_TRANSMISSION, 0},
        Archetype.SPECULAR_REFLECT_TRANSMIT: {PB.BSDF_EVENT_SPECULAR_REFLECTION,
                                              PB.BSDF_EVENT_SPECULAR_TRANSMISSION},
        Archetype.DIFFUSE_TRANSMISSION: {PB.BSDF_EVENT_DIFFUSE_TRANSMISSION},
        Archetype.NULL_BSDF: {0},
    }[Archetype(archetype)]
    events = set(np.unique(ps["event"]).tolist())
    assert events <= allowed and (events == allowed or 0 in allowed)
    dirac = (ps["event"] & PB.BSDF_EVENT_SPECULAR) != 0
    assert (ps["pdf"][dirac] == 0.0).all()
    if archetype in (Archetype.SPECULAR_REFLECT, Archetype.SPECULAR_TRANSMIT,
                     Archetype.SPECULAR_REFLECT_TRANSMIT, Archetype.GGX_TRANSMIT, Archetype.NULL_BSDF):
        assert (pe["bsdf"] == 0.0).all() and (pe["pdf"] == 0.0).all()  # nothing to light-sample


@pytest.mark.parametrize("families", [
    frozenset({0, 1, 8}), frozenset({3, 6, 7}), frozenset({2, 5}), frozenset(ARCHETYPES),
], ids=["cornell_box", "cornell_glass", "transmit_only", "all"])
def test_family_pruning_keeps_each_lanes_result(families):
    """The static archetype set leaves lobe families out; the lanes of its
    archetypes get the same bits as with every family computed (the
    direction of an absorbed lane, which no later step reads, aside), and
    the JAX function given the same set the same events."""
    a = _inputs(4)
    keep = np.isin(a["archetype"], sorted(families))
    a = {k: v[keep] if v.shape[:1] == (N,) else v for k, v in a.items()}
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    pp = _params(PB, a, torch.from_numpy)
    full = PB.bsdf_sample(pp, t["wo"], t["ns"], t["ng"], t["xi"], t["eta_i"], t["eta_t"])
    pruned = PB.bsdf_sample(pp, t["wo"], t["ns"], t["ng"], t["xi"], t["eta_i"], t["eta_t"], families=families)
    live = full.event != PB.BSDF_EVENT_ABSORB
    assert torch.equal(full.wi[live], pruned.wi[live])
    for x, y in zip(full[1:], pruned[1:]):
        assert torch.equal(x, y)
    fe = PB.bsdf_eval(pp, t["wo"], t["wi"], t["ns"], t["eta_i"], t["eta_t"])
    pe = PB.bsdf_eval(pp, t["wo"], t["wi"], t["ns"], t["eta_i"], t["eta_t"], families=families)
    for x, y in zip(fe, pe):
        assert torch.equal(x, y)
    js, ps, _, _, _, _ = _both(a, families)
    edge = _edge_lanes(a)
    assert np.array_equal(js["event"][~edge], ps["event"][~edge].astype(np.int32))


def test_fresnel_and_refraction_match_jax():
    """The dielectric Fresnel term and the refracted direction, total
    internal reflection included (eta < 1 at grazing angles)."""
    rs = np.random.default_rng(5)
    cos = rs.uniform(-0.1, 1.0, N).astype(np.float32)
    eta = rs.uniform(0.5, 2.0, N).astype(np.float32)
    f_j = np.asarray(JB.fresnel_dielectric(jnp.asarray(cos), jnp.asarray(eta)))
    f_p = PB.fresnel_dielectric(torch.from_numpy(cos), torch.from_numpy(eta)).numpy()
    # readings 7.5e-8 and 1.2e-7 (seed 5)
    assert np.abs(f_p - f_j).max() <= 1e-6 and (f_p[(1 - cos.clip(0, 1) ** 2) / eta ** 2 >= 1.0001] == 1.0).all()
    wo, n = _unit(rs, N), _unit(rs, N)
    n = np.where(((wo * n).sum(-1) < 0)[:, None], -n, n).astype(np.float32)
    wt_j, tir_j = (np.asarray(x) for x in JB.refract_dir(jnp.asarray(wo), jnp.asarray(n), jnp.asarray(eta)))
    wt_p, tir_p = (x.numpy() for x in PB.refract_dir(torch.from_numpy(wo), torch.from_numpy(n),
                                                     torch.from_numpy(eta)))
    cos_i = (wo * n).sum(-1)
    near = np.abs((1 - cos_i ** 2) / eta ** 2 - 1) < 1e-4
    assert np.array_equal(tir_j[~near], tir_p[~near]) and tir_p.any() and not tir_p.all()
    assert np.abs(wt_p - wt_j)[~tir_p & ~near].max() <= 1e-5
