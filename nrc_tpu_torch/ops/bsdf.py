"""BSDF sample / evaluate / auxiliary data over the ray wavefront.

Port of ``nrc_tpu/ops/bsdf.py``: the lobe families the archetypes 0-8 use,
diffuse (reflection and transmission), GGX microfacet (reflect, transmit,
both by Fresnel choice) and ideal specular (the same three), and
``NULL_BSDF`` (emission-only; it absorbs). ``HAIR`` and ``MEASURED`` are
not ported: ``render/scene_device.upload_scene`` refuses scenes with them,
and here they absorb.

Conventions (the reference's MDL usage): ``wo`` points toward the observer,
``ns``/``ng`` are the shading/geometric normals as stored; ``eta_i`` and
``eta_t`` are the IORs of the incident medium (the ray's IOR stack top) and
of the transmitted side. Sample returns ``bsdf_over_pdf``, the solid-angle
``pdf`` (0 for dirac events) and an MDL event bitmask; eval returns
bsdf x |cos| and the sample pdf for MIS (dirac lobes evaluate to zero).

``families`` is the scene's static archetype set
(``FrameConfig.archetype_set``; None = all): lobe families no archetype of
the set uses are not computed, as the JAX package leaves them out of its
compiled program (``_family_flags``), and neither is the GGX transmission
half where no archetype of the set transmits through GGX, which XLA drops
from the JAX program as dead code. Every lane's result is the same either
way.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..scene.materials import Archetype
from ..utils.math import align_vector, build_onb, dot, normalize, reflect, safe_div, to_world

M_PI = math.pi

# MDL event bitmask (mi::neuraylib::Bsdf_event_type)
BSDF_EVENT_ABSORB = 0
BSDF_EVENT_DIFFUSE = 1
BSDF_EVENT_GLOSSY = 2
BSDF_EVENT_SPECULAR = 4
BSDF_EVENT_REFLECTION = 8
BSDF_EVENT_TRANSMISSION = 16
BSDF_EVENT_DIFFUSE_REFLECTION = BSDF_EVENT_DIFFUSE | BSDF_EVENT_REFLECTION
BSDF_EVENT_DIFFUSE_TRANSMISSION = BSDF_EVENT_DIFFUSE | BSDF_EVENT_TRANSMISSION
BSDF_EVENT_GLOSSY_REFLECTION = BSDF_EVENT_GLOSSY | BSDF_EVENT_REFLECTION
BSDF_EVENT_GLOSSY_TRANSMISSION = BSDF_EVENT_GLOSSY | BSDF_EVENT_TRANSMISSION
BSDF_EVENT_SPECULAR_REFLECTION = BSDF_EVENT_SPECULAR | BSDF_EVENT_REFLECTION
BSDF_EVENT_SPECULAR_TRANSMISSION = BSDF_EVENT_SPECULAR | BSDF_EVENT_TRANSMISSION
BSDF_EVENT_NON_DIRAC = BSDF_EVENT_DIFFUSE | BSDF_EVENT_GLOSSY

# archetypes 0-8: every one but HAIR and MEASURED
SUPPORTED_ARCHETYPES = frozenset(range(int(Archetype.NULL_BSDF) + 1))


class MaterialParams(NamedTuple):
    """Per-ray material parameters (rows of the material table)."""

    archetype: torch.Tensor  # [N] i64
    albedo: torch.Tensor     # [N, 3]
    roughness: torch.Tensor  # [N, 2]
    ior: torch.Tensor        # [N]
    thin_walled: torch.Tensor  # [N] 0 or 1 (the material row's f32 column)


class BSDFSample(NamedTuple):
    wi: torch.Tensor             # [N, 3]
    bsdf_over_pdf: torch.Tensor  # [N, 3]
    pdf: torch.Tensor            # [N] (0 for dirac)
    event: torch.Tensor          # [N] i64 bitmask


class BSDFEval(NamedTuple):
    bsdf: torch.Tensor  # [N, 3] f*|cos|
    pdf: torch.Tensor   # [N]


class BSDFAux(NamedTuple):
    albedo_diffuse: torch.Tensor  # [N, 3]
    albedo_glossy: torch.Tensor   # [N, 3]
    roughness: torch.Tensor       # [N, 2] ((1,1) for diffuse — hit.cu:480-483)


def _is(arch: torch.Tensor, *types, families=None):
    """The lanes of any of ``types``; the types outside the static set
    ``families`` are left out, and None stands for no lane at all."""
    types = [int(t) for t in types if families is None or int(t) in {int(f) for f in families}]
    if not types:
        return None
    m = arch == types[0]
    for t in types[1:]:
        m = m | (arch == t)
    return m


def _family_flags(families):
    """Static per-family presence flags from a scene's archetype set
    (``nrc_tpu/ops/bsdf.py:92``): diffuse reflection, diffuse transmission,
    GGX, specular, GGX reflect-transmit, specular transmit."""
    if families is None:
        return True, True, True, True, True, True
    fams = {int(f) for f in families}
    has_dr = int(Archetype.DIFFUSE_REFLECTION) in fams
    has_dt = int(Archetype.DIFFUSE_TRANSMISSION) in fams
    has_grt = int(Archetype.GGX_REFLECT_TRANSMIT) in fams
    has_ggx = has_grt or bool(fams & {int(Archetype.GGX_REFLECT), int(Archetype.GGX_TRANSMIT)})
    has_st = int(Archetype.SPECULAR_TRANSMIT) in fams
    has_spec = has_st or bool(
        fams & {int(Archetype.SPECULAR_REFLECT), int(Archetype.SPECULAR_REFLECT_TRANSMIT)}
    )
    return has_dr, has_dt, has_ggx, has_spec, has_grt, has_st


def transmits(families, *types) -> bool:
    """Whether the static archetype set may hold one of ``types``."""
    return families is None or bool({int(f) for f in families} & {int(t) for t in types})


def fresnel_dielectric(cos_i: torch.Tensor, eta: torch.Tensor) -> torch.Tensor:
    """Unpolarized dielectric Fresnel; ``eta`` = n_transmitted / n_incident,
    ``cos_i`` against the oriented normal. Reflectance in [0, 1]; 1 on total
    internal reflection."""
    cos_i = torch.clamp(cos_i, 0.0, 1.0)
    sin2_t = (1.0 - cos_i * cos_i) / torch.clamp(eta * eta, min=1e-12)
    tir = sin2_t >= 1.0
    cos_t = torch.sqrt(torch.clamp(1.0 - sin2_t, min=0.0))
    rs = safe_div(cos_i - eta * cos_t, cos_i + eta * cos_t)
    rp = safe_div(eta * cos_i - cos_t, eta * cos_i + cos_t)
    f = 0.5 * (rs * rs + rp * rp)
    return torch.where(tir, 1.0, torch.clamp(f, 0.0, 1.0))


def refract_dir(wo: torch.Tensor, n: torch.Tensor, eta: torch.Tensor):
    """Refract -wo through the oriented normal n (dot(wo, n) >= 0); eta =
    n_t / n_i. Returns (wt, tir_mask)."""
    inv_eta = 1.0 / torch.clamp(eta, min=1e-12)
    cos_i = dot(wo, n)
    sin2_t = inv_eta * inv_eta * torch.clamp(1.0 - cos_i * cos_i, min=0.0)
    tir = sin2_t >= 1.0
    cos_t = torch.sqrt(torch.clamp(1.0 - sin2_t, min=0.0))
    wt = -inv_eta[..., None] * wo + (inv_eta * cos_i - cos_t)[..., None] * n
    return normalize(wt), tir


def _ggx_alpha(roughness: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.sqrt(roughness[..., 0] * roughness[..., 1]), 1e-3, 1.0)


def ggx_d(cos_h: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    a2 = alpha * alpha
    d = cos_h * cos_h * (a2 - 1.0) + 1.0
    return torch.where(
        cos_h > 0.0, a2 / torch.clamp(M_PI * d * d, min=1e-12), torch.zeros_like(d)
    )


def ggx_g1(cos_v: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    a2 = alpha * alpha
    c = torch.abs(cos_v)
    return 2.0 * c / torch.clamp(c + torch.sqrt(a2 + (1.0 - a2) * c * c), min=1e-12)


def _sample_ggx_h(n: torch.Tensor, alpha: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    """Sample a GGX half-vector about unit normal n (NDF sampling)."""
    a2 = alpha * alpha
    cos_h = torch.sqrt(
        torch.clamp((1.0 - xi[..., 0]) / (1.0 + (a2 - 1.0) * xi[..., 0]), 0.0, 1.0)
    )
    sin_h = torch.sqrt(torch.clamp(1.0 - cos_h * cos_h, min=0.0))
    phi = 2.0 * M_PI * xi[..., 1]
    local = torch.stack([sin_h * torch.cos(phi), sin_h * torch.sin(phi), cos_h], dim=-1)
    t, b = build_onb(n)
    return to_world(t, b, n, local)


def _event(mask: torch.Tensor, if_true: int, if_false: int) -> torch.Tensor:
    return torch.where(mask, if_true, if_false)


def bsdf_sample(params: MaterialParams, wo, ns, ng, xi, eta_i, eta_t, families=None) -> BSDFSample:
    """Importance-sample the per-ray archetype BSDF (``hit.cu:306-337``);
    ``xi`` [N, 4], ``eta_i``/``eta_t`` [N]. Each present lobe family
    selects its lanes' results over the absorbing default: a lane whose
    archetype no family takes (NULL_BSDF, HAIR, MEASURED) absorbs, as does
    a failed sample (hit.cu:871-875)."""
    arch = params.archetype
    tint = params.albedo
    has_dr, has_dt, has_ggx, has_spec, has_grt, has_st = _family_flags(families)
    # normal oriented to the wo side for sampling
    sgn = torch.where(dot(wo, ns) >= 0.0, 1.0, -1.0)
    nf = ns * sgn[..., None]
    if has_spec or transmits(families, Archetype.GGX_TRANSMIT, Archetype.GGX_REFLECT_TRANSMIT):
        eta = torch.clamp(eta_t, min=1e-6) / torch.clamp(eta_i, min=1e-6)
    lobes = []  # (lanes, wi, weight, pdf, event, ok) of each present family

    # --- diffuse family -------------------------------------------------
    if has_dr or has_dt:
        phi_d = 2.0 * M_PI * xi[..., 0]
        r = torch.sqrt(torch.clamp(xi[..., 1], 0.0, 1.0))
        local = torch.stack(
            [
                r * torch.cos(phi_d),
                r * torch.sin(phi_d),
                torch.sqrt(torch.clamp(1.0 - r * r, min=0.0)),
            ],
            dim=-1,
        )
        pdf_diffuse = torch.clamp(local[..., 2], min=0.0) / M_PI
        ok_diffuse = pdf_diffuse > 0.0
        if has_dr:
            lobes.append((_is(arch, Archetype.DIFFUSE_REFLECTION), align_vector(nf, local), tint, pdf_diffuse,
                          BSDF_EVENT_DIFFUSE_REFLECTION, ok_diffuse))
        if has_dt:
            lobes.append((_is(arch, Archetype.DIFFUSE_TRANSMISSION), align_vector(-nf, local), tint, pdf_diffuse,
                          BSDF_EVENT_DIFFUSE_TRANSMISSION, ok_diffuse))

    # --- GGX family -----------------------------------------------------
    if has_ggx:
        alpha = _ggx_alpha(params.roughness)
        h = _sample_ggx_h(nf, alpha, xi[..., 2:4])
        woh = dot(wo, h)
        h_ok = woh > 1e-6
        wi_gr = normalize(2.0 * woh[..., None] * h - wo)
        cos_hn = dot(h, nf)
        d_term = ggx_d(cos_hn, alpha)
        pdf_gr = safe_div(d_term * torch.clamp(cos_hn, min=0.0), 4.0 * torch.clamp(woh, min=1e-12))
        cos_o = torch.abs(dot(wo, nf))
        cos_i_gr = dot(wi_gr, nf)
        g_gr = ggx_g1(cos_o, alpha) * ggx_g1(cos_i_gr, alpha)
        # weight = f*cos/pdf = G * woh / (cos_o * cos_hn)
        w_gr = safe_div(g_gr * woh, cos_o * torch.clamp(cos_hn, min=1e-12))
        gr_ok = h_ok & (cos_i_gr > 1e-6)
        is_ggx = _is(arch, Archetype.GGX_REFLECT, Archetype.GGX_TRANSMIT, Archetype.GGX_REFLECT_TRANSMIT,
                     families=families)
        if transmits(families, Archetype.GGX_TRANSMIT, Archetype.GGX_REFLECT_TRANSMIT):
            is_gr = _is(arch, Archetype.GGX_REFLECT)
            is_grt = _is(arch, Archetype.GGX_REFLECT_TRANSMIT)
            # GGX transmission through h
            wi_gt, tir_g = refract_dir(wo, h, eta)
            cos_i_gt = dot(wi_gt, nf)
            gt_ok = h_ok & (cos_i_gt < -1e-6) & ~tir_g
            g_gt = ggx_g1(cos_o, alpha) * ggx_g1(cos_i_gt, alpha)
            w_gt = safe_div(g_gt * woh, cos_o * torch.clamp(cos_hn, min=1e-12))
            # the transmission pdf approximated by the half-vector pdf
            pdf_gt = pdf_gr
            # Fresnel lobe choice of the reflect-transmit mode; xi0 is
            # independent of the half-vector sample
            f_g = fresnel_dielectric(woh, eta) if has_grt else torch.zeros_like(woh)
            choose_reflect_g = xi[..., 0] < f_g
            ggx_reflect = is_gr | (is_grt & choose_reflect_g) | (is_grt & tir_g)
            wi_ggx = torch.where(ggx_reflect[..., None], wi_gr, wi_gt)
            ok_ggx = torch.where(ggx_reflect, gr_ok, gt_ok)
            w_ggx = torch.where(ggx_reflect, w_gr, w_gt)
            pdf_ggx = torch.where(ggx_reflect, pdf_gr, pdf_gt)
            # the lobe choice's probability folds out of the weight
            pdf_ggx = torch.where(is_grt, pdf_ggx * torch.where(ggx_reflect, f_g, 1.0 - f_g), pdf_ggx)
            ev_ggx = _event(ggx_reflect, BSDF_EVENT_GLOSSY_REFLECTION, BSDF_EVENT_GLOSSY_TRANSMISSION)
        else:  # only GGX_REFLECT lanes: the reflect half is all they take
            wi_ggx, ok_ggx, w_ggx, pdf_ggx, ev_ggx = wi_gr, gr_ok, w_gr, pdf_gr, BSDF_EVENT_GLOSSY_REFLECTION
        lobes.append((is_ggx, wi_ggx, tint * w_ggx[..., None], pdf_ggx, ev_ggx, ok_ggx))

    # --- specular family ------------------------------------------------
    if has_spec:
        is_sr = _is(arch, Archetype.SPECULAR_REFLECT)
        is_st = _is(arch, Archetype.SPECULAR_TRANSMIT)
        is_srt = _is(arch, Archetype.SPECULAR_REFLECT_TRANSMIT)
        wi_sr = reflect(-wo, nf)
        wi_st, tir_s = refract_dir(wo, nf, eta)
        f_s = fresnel_dielectric(dot(wo, nf), eta)
        choose_reflect_s = xi[..., 0] < f_s
        spec_reflect = is_sr | (is_srt & (choose_reflect_s | tir_s))
        wi_spec = torch.where(spec_reflect[..., None], wi_sr, wi_st)
        # ideal dirac: the reflect-transmit weight is the tint (Fresnel
        # cancels against the lobe choice's probability); pure transmission
        # loses the Fresnel-reflected fraction (1 - F) and absorbs on TIR
        w_spec = torch.where(is_st, 1.0 - f_s, torch.ones_like(f_s)) if has_st else torch.ones_like(f_s)
        ev_spec = _event(spec_reflect, BSDF_EVENT_SPECULAR_REFLECTION, BSDF_EVENT_SPECULAR_TRANSMISSION)
        lobes.append((is_sr | is_st | is_srt, wi_spec, tint * w_spec[..., None], torch.zeros_like(f_s), ev_spec,
                      ~(is_st & tir_s)))

    # --- combine: each family's lanes take its results (the first family's
    # stand everywhere else, where ok is false) --------------------------
    lobes = [lobe for lobe in lobes if lobe[0] is not None]
    if not lobes:  # emission-only scenes
        z = torch.zeros_like(wo)
        return BSDFSample(wi=z, bsdf_over_pdf=z, pdf=z[..., 0], event=torch.full_like(arch, BSDF_EVENT_ABSORB))
    lanes, wi, weight, pdf, event, ok = lobes[0]
    ok = lanes & ok
    for lanes, l_wi, l_weight, l_pdf, l_event, l_ok in lobes[1:]:
        wi = torch.where(lanes[..., None], l_wi, wi)
        weight = torch.where(lanes[..., None], l_weight, weight)
        pdf = torch.where(lanes, l_pdf, pdf)
        event = torch.where(lanes, l_event, event)
        ok = torch.where(lanes, l_ok, ok)
    event = torch.where(ok, event, BSDF_EVENT_ABSORB)
    weight = torch.where(ok[..., None], weight, 0.0)
    pdf = torch.where(ok, pdf, 0.0)
    return BSDFSample(wi=wi, bsdf_over_pdf=weight, pdf=pdf, event=event)


def bsdf_eval(params: MaterialParams, wo, wi, ns, eta_i, eta_t, families=None) -> BSDFEval:
    """BSDF x |cos| and the sampling pdf toward ``wi`` (NEE / MIS); the
    dirac lobes and GGX_TRANSMIT (no reflection lobe) evaluate to zero."""
    arch = params.archetype
    tint = params.albedo
    sgn = torch.where(dot(wo, ns) >= 0.0, 1.0, -1.0)
    nf = ns * sgn[..., None]
    cos_i = dot(wi, nf)
    f = torch.zeros_like(wo)
    pdf = torch.zeros_like(cos_i)

    # diffuse reflection, and transmission into the opposite hemisphere
    for archetype, cos in ((Archetype.DIFFUSE_REFLECTION, cos_i), (Archetype.DIFFUSE_TRANSMISSION, -cos_i)):
        lanes = _is(arch, archetype, families=families)
        if lanes is not None:
            f = torch.where(lanes[..., None], tint / M_PI * torch.clamp(cos, min=0.0)[..., None], f)
            pdf = torch.where(lanes, torch.clamp(cos, min=0.0) / M_PI, pdf)

    # the GGX reflection lobe, Fresnel-weighted in the reflect-transmit mode
    lanes = _is(arch, Archetype.GGX_REFLECT, Archetype.GGX_REFLECT_TRANSMIT, families=families)
    if lanes is not None:
        alpha = _ggx_alpha(params.roughness)
        h = normalize(wo + wi)
        cos_hn = dot(h, nf)
        woh = torch.clamp(dot(wo, h), min=1e-12)
        d_term = ggx_d(cos_hn, alpha)
        cos_o = torch.abs(dot(wo, nf))
        g = ggx_g1(cos_o, alpha) * ggx_g1(cos_i, alpha)
        refl_ok = (cos_i > 1e-6) & (cos_o > 1e-6)
        # f * cos_i already folded: D*G/(4 cosO cosI) * cosI
        f_ggx_scalar = torch.where(refl_ok, safe_div(d_term * g, 4.0 * cos_o), 0.0)
        pdf_ggx = torch.where(refl_ok, safe_div(d_term * torch.clamp(cos_hn, min=0.0), 4.0 * woh), 0.0)
        is_grt = _is(arch, Archetype.GGX_REFLECT_TRANSMIT, families=families)
        if is_grt is not None:
            eta = torch.clamp(eta_t, min=1e-6) / torch.clamp(eta_i, min=1e-6)
            f_grt = fresnel_dielectric(woh, eta)
            f_ggx_scalar = torch.where(is_grt, f_ggx_scalar * f_grt, f_ggx_scalar)
            pdf_ggx = torch.where(is_grt, pdf_ggx * f_grt, pdf_ggx)
        f = torch.where(lanes[..., None], tint * f_ggx_scalar[..., None], f)
        pdf = torch.where(lanes, pdf_ggx, pdf)
    return BSDFEval(bsdf=f, pdf=pdf)


def bsdf_aux(params: MaterialParams, families=None) -> BSDFAux:
    """Albedos and roughness for radiance queries (``hit.cu:888-898``)."""
    arch = params.archetype
    tint = params.albedo
    is_diffuse = _is(arch, Archetype.DIFFUSE_REFLECTION, Archetype.DIFFUSE_TRANSMISSION, families=families)
    is_spec = _is(arch, Archetype.SPECULAR_REFLECT, Archetype.SPECULAR_TRANSMIT,
                  Archetype.SPECULAR_REFLECT_TRANSMIT, families=families)
    is_glossy = _is(arch, Archetype.GGX_REFLECT, Archetype.GGX_TRANSMIT, Archetype.GGX_REFLECT_TRANSMIT,
                    Archetype.SPECULAR_REFLECT, Archetype.SPECULAR_TRANSMIT, Archetype.SPECULAR_REFLECT_TRANSMIT,
                    families=families)
    zero = torch.zeros_like(tint)

    def where(lanes, a, b):
        return b if lanes is None else torch.where(lanes[..., None], a, b)

    # diffuse events report roughness (1,1) — hit.cu:480-483; the specular
    # lobes (0,0)
    roughness = where(is_spec, torch.zeros_like(params.roughness), params.roughness)
    return BSDFAux(
        albedo_diffuse=where(is_diffuse, tint, zero),
        albedo_glossy=where(is_glossy, tint, zero),
        roughness=where(is_diffuse, torch.ones_like(params.roughness), roughness),
    )
