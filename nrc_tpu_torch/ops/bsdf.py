"""BSDF sample / evaluate / auxiliary data over the ray wavefront.

Port of ``nrc_tpu/ops/bsdf.py`` for the archetypes the serving path
supports: ``DIFFUSE_REFLECTION``, ``GGX_REFLECT`` and ``NULL_BSDF``
(emission-only; it absorbs). ``render/scene_device.upload_scene`` refuses
scenes with any other archetype; here any other archetype absorbs.

These three lobes never transmit, so the JAX functions' incident and
transmitted IORs (``eta_i``/``eta_t``) do not enter: they only feed the
transmission and Fresnel-choice lobes, which are not ported.

Conventions (the reference's MDL usage): ``wo`` points toward the observer,
``ns``/``ng`` are the shading/geometric normals as stored; sample returns
``bsdf_over_pdf``, the solid-angle ``pdf`` and an MDL event bitmask; eval
returns bsdf x |cos| and the sample pdf for MIS.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..scene.materials import Archetype
from ..utils.math import align_vector, build_onb, dot, normalize, safe_div, to_world

M_PI = math.pi

# MDL event bitmask (mi::neuraylib::Bsdf_event_type)
BSDF_EVENT_ABSORB = 0
BSDF_EVENT_DIFFUSE = 1
BSDF_EVENT_GLOSSY = 2
BSDF_EVENT_SPECULAR = 4
BSDF_EVENT_REFLECTION = 8
BSDF_EVENT_TRANSMISSION = 16
BSDF_EVENT_DIFFUSE_REFLECTION = BSDF_EVENT_DIFFUSE | BSDF_EVENT_REFLECTION
BSDF_EVENT_GLOSSY_REFLECTION = BSDF_EVENT_GLOSSY | BSDF_EVENT_REFLECTION
BSDF_EVENT_NON_DIRAC = BSDF_EVENT_DIFFUSE | BSDF_EVENT_GLOSSY

SUPPORTED_ARCHETYPES = frozenset(
    {int(Archetype.DIFFUSE_REFLECTION), int(Archetype.GGX_REFLECT), int(Archetype.NULL_BSDF)}
)


class MaterialParams(NamedTuple):
    """Per-ray material parameters (rows of the material table)."""

    archetype: torch.Tensor  # [N] i64
    albedo: torch.Tensor     # [N, 3]
    roughness: torch.Tensor  # [N, 2]


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


def bsdf_sample(params: MaterialParams, wo, ns, ng, xi) -> BSDFSample:
    """Importance-sample the per-ray archetype BSDF (``hit.cu:306-337``);
    ``xi`` [N, 4]."""
    arch = params.archetype
    tint = params.albedo
    sgn = torch.where(dot(wo, ns) >= 0.0, 1.0, -1.0)
    nf = ns * sgn[..., None]
    is_dr = arch == int(Archetype.DIFFUSE_REFLECTION)
    is_gr = arch == int(Archetype.GGX_REFLECT)

    # --- diffuse reflection ---------------------------------------------
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
    wi_dr = align_vector(nf, local)
    pdf_diffuse = torch.clamp(local[..., 2], min=0.0) / M_PI

    # --- GGX reflection -------------------------------------------------
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

    # --- combine --------------------------------------------------------
    zero3 = torch.zeros_like(wo)
    wi = torch.where(is_dr[..., None], wi_dr, torch.where(is_gr[..., None], wi_gr, zero3))
    weight = torch.where(
        is_dr[..., None], tint, torch.where(is_gr[..., None], tint * w_gr[..., None], zero3)
    )
    zero = torch.zeros_like(pdf_gr)
    pdf = torch.where(is_dr, pdf_diffuse, torch.where(is_gr, pdf_gr, zero))
    event = torch.where(
        is_dr,
        BSDF_EVENT_DIFFUSE_REFLECTION,
        torch.where(is_gr, BSDF_EVENT_GLOSSY_REFLECTION, BSDF_EVENT_ABSORB),
    )
    # NULL_BSDF (and anything unported) or a failed sample -> absorb
    # (hit.cu:871-875)
    ok = torch.where(is_dr, pdf_diffuse > 0.0, is_gr & gr_ok)
    event = torch.where(ok, event, BSDF_EVENT_ABSORB)
    weight = torch.where(ok[..., None], weight, zero3)
    pdf = torch.where(ok, pdf, zero)
    return BSDFSample(wi=wi, bsdf_over_pdf=weight, pdf=pdf, event=event)


def bsdf_eval(params: MaterialParams, wo, wi, ns) -> BSDFEval:
    """BSDF x |cos| and the sampling pdf toward ``wi`` (NEE / MIS)."""
    arch = params.archetype
    tint = params.albedo
    sgn = torch.where(dot(wo, ns) >= 0.0, 1.0, -1.0)
    nf = ns * sgn[..., None]
    cos_i = dot(wi, nf)

    # diffuse reflection
    f_dr = tint / M_PI * torch.clamp(cos_i, min=0.0)[..., None]
    pdf_dr = torch.clamp(cos_i, min=0.0) / M_PI

    # GGX reflection lobe
    alpha = _ggx_alpha(params.roughness)
    h = normalize(wo + wi)
    cos_hn = dot(h, nf)
    woh = torch.clamp(dot(wo, h), min=1e-12)
    d_term = ggx_d(cos_hn, alpha)
    cos_o = torch.abs(dot(wo, nf))
    g = ggx_g1(cos_o, alpha) * ggx_g1(cos_i, alpha)
    refl_ok = (cos_i > 1e-6) & (cos_o > 1e-6)
    zero = torch.zeros_like(cos_i)
    # f * cos_i already folded: D*G/(4 cosO cosI) * cosI
    f_ggx_scalar = torch.where(refl_ok, safe_div(d_term * g, 4.0 * cos_o), zero)
    pdf_ggx = torch.where(
        refl_ok, safe_div(d_term * torch.clamp(cos_hn, min=0.0), 4.0 * woh), zero
    )
    f_ggx = tint * f_ggx_scalar[..., None]

    is_dr = arch == int(Archetype.DIFFUSE_REFLECTION)
    is_gr = arch == int(Archetype.GGX_REFLECT)
    f = torch.where(
        is_dr[..., None], f_dr, torch.where(is_gr[..., None], f_ggx, torch.zeros_like(f_ggx))
    )
    pdf = torch.where(is_dr, pdf_dr, torch.where(is_gr, pdf_ggx, zero))
    return BSDFEval(bsdf=f, pdf=pdf)


def bsdf_aux(params: MaterialParams) -> BSDFAux:
    """Albedos and roughness for radiance queries (``hit.cu:888-898``)."""
    arch = params.archetype
    tint = params.albedo
    is_diffuse = arch == int(Archetype.DIFFUSE_REFLECTION)
    is_glossy = arch == int(Archetype.GGX_REFLECT)
    zero = torch.zeros_like(tint)
    return BSDFAux(
        albedo_diffuse=torch.where(is_diffuse[..., None], tint, zero),
        albedo_glossy=torch.where(is_glossy[..., None], tint, zero),
        # diffuse events report roughness (1,1) — hit.cu:480-483
        roughness=torch.where(
            is_diffuse[..., None], torch.ones_like(params.roughness), params.roughness
        ),
    )
