"""Two-lobe layered, mixed and modified BSDFs over the ray wavefront.

Port of ``nrc_tpu/ops/layered.py:56-293``, the batched replacement for
MDL's BSDF combinators (``df::weighted_layer``, ``fresnel_layer``,
``measured_curve_layer``, the mixes and the modifiers ``directional_factor``,
``fresnel_factor``, ``thin_film``, ``measured_curve_factor``; the
reference's ``layer_*``, ``mixer_*`` and ``modifier_*`` sample materials).
A material is at most two archetype lobes, a blend descriptor (how the
lobes are weighted as a function of the view angle) and a modifier
descriptor (an angular colour factor on the result), all masked vector
code over the wavefront.

Mixture sampling: pick lobe 1 with probability p1 (luminance-weighted),
sample it, then
- a non-dirac event weighs (w1 f1 + w2 f2) / (p1 pdf1 + (1 - p1) pdf2),
  both lobes evaluated at the sampled direction;
- a dirac event weighs w f / pdf of the chosen lobe over its pick
  probability.

The blend weights and the modifier depend only on the view angle, so the
bounce computes them once (``view_weights``) and hands them to
``layered_sample``, ``layered_eval`` and ``layered_aux`` (XLA merges the JAX
package's three identical computations the same way). ``families`` is the static archetype set of
both lobes, passed on to ``ops/bsdf.py``'s pruning.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..utils.math import dot, pick1, safe_div
from . import bsdf as B

M_PI = math.pi

# blend modes (how lobe weights depend on the view angle)
BLEND_NONE = 0      # single lobe (lobe 1 only)
BLEND_FIXED = 1     # constant color weights (weighted_layer / mixes)
BLEND_FRESNEL = 2   # w1 = weight * F_dielectric(ior, cos)  (fresnel_layer)
BLEND_CURVE = 3     # w1 = weight * curve(theta)  (measured_curve_layer)

# modifier modes (angular color factor on the combined BSDF)
MOD_NONE = 0
MOD_DIRECTIONAL = 1   # normal_tint + (grazing - normal) * (1-cos)^exponent
MOD_FRESNEL_COND = 2  # per-channel conductor Fresnel (ior + extinction)
MOD_THIN_FILM = 3     # Airy interference factor (thickness nm, film ior)
MOD_CURVE = 4         # measured_curve_factor: curve(theta) color


class BlendParams(NamedTuple):
    """Per-ray blend and modifier descriptor rows."""

    blend_mode: torch.Tensor  # [N] i64
    w1: torch.Tensor          # [N, 3] layer weight (colour)
    w2: torch.Tensor          # [N, 3] base weight (colour)
    blend_ior: torch.Tensor   # [N] fresnel_layer ior
    curve: torch.Tensor       # [N, CURVE_RES, 3] measured curve
    mod_mode: torch.Tensor    # [N] i64
    mod_a: torch.Tensor       # [N, 3] normal_tint | conductor ior | film ior
    mod_b: torch.Tensor       # [N, 3] grazing_tint | extinction | unused
    mod_exp: torch.Tensor     # [N] exponent | unused | thickness (nm)


class ViewWeights(NamedTuple):
    """What depends on the view angle only: cos_o against the normal turned
    to wo, the lobe weights, lobe 1's pick probability and the modifier."""

    cos_o: torch.Tensor  # [N]
    w1: torch.Tensor     # [N, 3]
    w2: torch.Tensor     # [N, 3]
    p1: torch.Tensor     # [N]
    mf: torch.Tensor     # [N, 3]


def _luminance(c: torch.Tensor) -> torch.Tensor:
    return 0.212671 * c[..., 0] + 0.715160 * c[..., 1] + 0.072169 * c[..., 2]


def _curve_lookup(curve: torch.Tensor, cos_t: torch.Tensor) -> torch.Tensor:
    """curve [N, K, 3] indexed by incidence angle theta in [0, pi/2]."""
    k = curve.shape[-2]
    theta = torch.arccos(torch.clamp(torch.abs(cos_t), 0.0, 1.0))
    x = theta / (0.5 * M_PI) * (k - 1)
    i0 = torch.clamp(torch.floor(x).to(torch.int64), 0, k - 1)
    i1 = torch.clamp(i0 + 1, max=k - 1)
    f = (x - i0.to(torch.float32))[..., None]
    return pick1(curve, i0) * (1.0 - f) + pick1(curve, i1) * f


def fresnel_conductor(cos_i: torch.Tensor, n: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Per-channel unpolarized conductor Fresnel (exact, PBRT form); cos_i
    [N] >= 0, n and k [N, 3] -> [N, 3]."""
    c = torch.clamp(cos_i, 0.0, 1.0)[..., None]
    c2 = c * c
    sin2 = 1.0 - c2
    eta2 = n * n
    etak2 = k * k
    t0 = eta2 - etak2 - sin2
    a2b2 = torch.sqrt(torch.clamp(t0 * t0 + 4.0 * eta2 * etak2, min=0.0))
    t1 = a2b2 + c2
    a = torch.sqrt(torch.clamp(0.5 * (a2b2 + t0), min=0.0))
    t2 = 2.0 * a * c
    rs = safe_div(t1 - t2, t1 + t2)
    t3 = c2 * a2b2 + sin2 * sin2
    t4 = t2 * sin2
    rp = rs * safe_div(t3 - t4, t3 + t4)
    return torch.clamp(0.5 * (rs + rp), 0.0, 1.0)


def _thin_film_factor(cos_i: torch.Tensor, film_ior: torch.Tensor, thickness_nm: torch.Tensor) -> torch.Tensor:
    """Airy reflectance of one dielectric film (the equal-interface
    approximation of MDL ``df::thin_film``): R = 2F(1 - cos dphi) / (1 + F^2 -
    2F cos dphi), dphi = 4 pi n d cos_t / lambda at RGB wavelengths."""
    n = torch.clamp(film_ior, min=1.0)[..., None]
    c = torch.clamp(cos_i, 0.0, 1.0)[..., None]
    sin2_t = (1.0 - c * c) / (n * n)
    cos_t = torch.sqrt(torch.clamp(1.0 - sin2_t, min=0.0))
    # over each channel's wavelength (650, 510, 440 nm) as a scalar: a frame
    # makes no tensor of host data
    path = 4.0 * M_PI * n * thickness_nm[..., None] * cos_t
    dphi = torch.cat([path / 650.0, path / 510.0, path / 440.0], dim=-1)
    f = B.fresnel_dielectric(cos_i, film_ior)[..., None]
    num = 2.0 * f * (1.0 - torch.cos(dphi))
    den = 1.0 + f * f - 2.0 * f * torch.cos(dphi)
    return torch.clamp(safe_div(num, den), 0.0, 1.0)


def blend_weights(bp: BlendParams, cos_o: torch.Tensor):
    """Angular lobe weights (w1, w2 colour) and lobe 1's pick probability p1."""
    mode = bp.blend_mode
    # fresnel_layer: w1 = weight * F(ior, cos), the base keeps 1 - w1
    f = B.fresnel_dielectric(cos_o, torch.clamp(bp.blend_ior, min=1e-3))
    w1_f = bp.w1 * f[..., None]
    # measured_curve_layer: w1 = weight * curve(theta)
    w1_c = bp.w1 * _curve_lookup(bp.curve, cos_o)
    is_f = (mode == BLEND_FRESNEL)[..., None]
    is_c = (mode == BLEND_CURVE)[..., None]
    w1 = torch.where(is_f, w1_f, torch.where(is_c, w1_c, bp.w1))
    w2 = torch.where(is_f | is_c, 1.0 - w1, bp.w2)
    single = mode == BLEND_NONE
    w1 = torch.where(single[..., None], 1.0, w1)
    w2 = torch.where(single[..., None], 0.0, w2)

    l1 = _luminance(w1)
    l2 = _luminance(w2)
    p1 = safe_div(l1, l1 + l2)
    # keep both lobes reachable when both carry weight (defensive MIS)
    both = (l1 > 0.0) & (l2 > 0.0)
    p1 = torch.where(both, torch.clamp(p1, 0.05, 0.95), p1)
    p1 = torch.where(single, 1.0, p1)
    return w1, w2, p1


def modifier_factor(bp: BlendParams, cos_o: torch.Tensor) -> torch.Tensor:
    """Angular colour factor of the modifier node (1 under MOD_NONE)."""
    mode = bp.mod_mode
    out = torch.ones_like(bp.mod_a)
    c = torch.clamp(torch.abs(cos_o), 0.0, 1.0)
    # directional_factor
    g = (1.0 - c)[..., None] ** torch.clamp(bp.mod_exp, min=1e-3)[..., None]
    dir_f = bp.mod_a + (bp.mod_b - bp.mod_a) * g
    out = torch.where((mode == MOD_DIRECTIONAL)[..., None], dir_f, out)
    # fresnel_factor (conductor)
    cond = fresnel_conductor(c, bp.mod_a, bp.mod_b)
    out = torch.where((mode == MOD_FRESNEL_COND)[..., None], cond, out)
    # thin_film
    film = _thin_film_factor(c, bp.mod_a[..., 0], bp.mod_exp)
    out = torch.where((mode == MOD_THIN_FILM)[..., None], film, out)
    # measured_curve_factor
    crv = _curve_lookup(bp.curve, c)
    return torch.where((mode == MOD_CURVE)[..., None], crv, out)


def view_weights(bp: BlendParams, wo: torch.Tensor, ns: torch.Tensor) -> ViewWeights:
    """cos_o against the shading normal turned to wo, the blend weights and
    the modifier factor there."""
    sgn = torch.where(dot(wo, ns) >= 0.0, 1.0, -1.0)
    cos_o = dot(wo, ns * sgn[..., None])
    w1, w2, p1 = blend_weights(bp, cos_o)
    return ViewWeights(cos_o, w1, w2, p1, modifier_factor(bp, cos_o))


def _select_params(sel: torch.Tensor, a: B.MaterialParams, b: B.MaterialParams) -> B.MaterialParams:
    s1 = sel[..., None]
    return B.MaterialParams(
        archetype=torch.where(sel, a.archetype, b.archetype),
        albedo=torch.where(s1, a.albedo, b.albedo),
        roughness=torch.where(s1, a.roughness, b.roughness),
        ior=torch.where(sel, a.ior, b.ior),
        thin_walled=torch.where(sel, a.thin_walled, b.thin_walled),
    )


def layered_sample(p1: B.MaterialParams, p2: B.MaterialParams, bp: BlendParams, vw: ViewWeights, wo, ns, ng,
                   xi: torch.Tensor, eta_i, eta_t, families=None) -> B.BSDFSample:
    """Sample the two-lobe mixture; ``xi`` [N, 5], xi[..., 4] picks the lobe."""
    w1, w2, p_1 = vw.w1, vw.w2, vw.p1
    pick1_ = xi[..., 4] < p_1
    sel = _select_params(pick1_, p1, p2)
    smp = B.bsdf_sample(sel, wo, ns, ng, xi[..., :4], eta_i, eta_t, families=families)

    single = bp.blend_mode == BLEND_NONE
    dirac = (smp.event & B.BSDF_EVENT_SPECULAR) != 0
    ok = smp.event != B.BSDF_EVENT_ABSORB

    # dirac: the chosen lobe scaled by its colour weight over its pick probability
    w_pick = torch.where(pick1_[..., None], w1, w2)
    p_pick = torch.where(pick1_, p_1, 1.0 - p_1)
    w_dirac = smp.bsdf_over_pdf * safe_div(w_pick, p_pick[..., None])

    # non-dirac: the full mixture f over the mixture pdf at the sampled direction
    e1 = B.bsdf_eval(p1, wo, smp.wi, ns, eta_i, eta_t, families=families)
    e2 = B.bsdf_eval(p2, wo, smp.wi, ns, eta_i, eta_t, families=families)
    f_mix = w1 * e1.bsdf + w2 * e2.bsdf
    pdf_mix = p_1 * e1.pdf + (1.0 - p_1) * e2.pdf
    # bsdf_eval covers no transmission lobe (reflection-only NEE eval): those
    # events keep the single-lobe estimate
    transmit = (smp.event & B.BSDF_EVENT_TRANSMISSION) != 0
    use_mix = ok & ~dirac & ~transmit & ~single
    w_mixture = safe_div(f_mix, pdf_mix[..., None])
    weight = torch.where(use_mix[..., None], w_mixture,
                         torch.where(single[..., None], smp.bsdf_over_pdf, w_dirac))
    pdf = torch.where(use_mix, pdf_mix, smp.pdf)

    # the modifier factor on the final weight (angular in wo)
    weight = weight * vw.mf

    failed = ok & use_mix & (pdf_mix <= 0.0)
    event = torch.where(failed, B.BSDF_EVENT_ABSORB, smp.event)
    weight = torch.where(failed[..., None], 0.0, weight)
    pdf = torch.where(failed, 0.0, pdf)
    return B.BSDFSample(wi=smp.wi, bsdf_over_pdf=weight, pdf=pdf, event=event)


def layered_eval(p1: B.MaterialParams, p2: B.MaterialParams, bp: BlendParams, vw: ViewWeights, wo, wi, ns,
                 eta_i, eta_t, families=None) -> B.BSDFEval:
    """The mixture's f x |cos| and pdf toward ``wi`` (NEE / MIS)."""
    e1 = B.bsdf_eval(p1, wo, wi, ns, eta_i, eta_t, families=families)
    single = bp.blend_mode == BLEND_NONE
    e2 = B.bsdf_eval(p2, wo, wi, ns, eta_i, eta_t, families=families)
    f = torch.where(single[..., None], e1.bsdf, vw.w1 * e1.bsdf + vw.w2 * e2.bsdf) * vw.mf
    pdf = torch.where(single, e1.pdf, vw.p1 * e1.pdf + (1.0 - vw.p1) * e2.pdf)
    return B.BSDFEval(bsdf=f, pdf=pdf)


def layered_aux(p1: B.MaterialParams, p2: B.MaterialParams, bp: BlendParams, vw: ViewWeights,
                families=None) -> B.BSDFAux:
    """Blended auxiliary outputs for the radiance-query features."""
    w1, w2 = vw.w1, vw.w2
    a1 = B.bsdf_aux(p1, families=families)
    a2 = B.bsdf_aux(p2, families=families)
    single = (bp.blend_mode == BLEND_NONE)[..., None]
    diff = torch.where(single, a1.albedo_diffuse, w1 * a1.albedo_diffuse + w2 * a2.albedo_diffuse) * vw.mf
    glos = torch.where(single, a1.albedo_glossy, w1 * a1.albedo_glossy + w2 * a2.albedo_glossy) * vw.mf
    l1 = _luminance(w1)[..., None]
    l2 = _luminance(w2)[..., None]
    rough = torch.where(single, a1.roughness, safe_div(l1 * a1.roughness + l2 * a2.roughness, l1 + l2))
    return B.BSDFAux(albedo_diffuse=diff, albedo_glossy=glos, roughness=rough)
