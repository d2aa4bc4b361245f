"""Chiang hair BSDF (R / TT / TRT + residual) over the ray wavefront.

Port of ``nrc_tpu/ops/hair_bsdf.py:30-319``, the counterpart of MDL's
``df::chiang_hair_bsdf`` in the reference's hair materials
(``data/mdl/bsdf_hair.mdl``; fibre state built in ``__closesthit__curves``,
``hit.cu:1665-2046``), after "A Practical and Controllable Hair and Fur
Model for Production Path Tracing" (Chiang et al. 2016): longitudinal
scattering with a variance per lobe, trimmed-logistic azimuthal scattering,
dielectric Fresnel at the cuticle with its tilt, and Beer-Lambert
absorption along the internal paths; a diffuse lobe over the sphere is
mixed in by ``diffuse_weight``.

Conventions: directions are given in the fibre frame (x along the tangent,
(y, z) the normal plane); ``h`` in [-1, 1] is the azimuthal offset of the
incoming ray across the fibre. Plain PyTorch, as every BSDF of the port.

The integer powers (``beta**2``, ``beta**20``, ``beta**22``, ``x**2``) are
the multiplication chains XLA makes of them (``_ipow``, JAX's
``integer_pow`` by repeated squaring), not ``torch.pow``.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..utils.math import safe_div

M_PI = math.pi
P_MAX = 3  # R, TT, TRT + residual lobe
SQRT_PI_OVER_8 = math.sqrt(math.pi / 8.0)


class HairParams(NamedTuple):
    """Per-ray hair material parameters (material row columns)."""

    sigma_a: torch.Tensor         # [N, 3] fibre interior absorption
    ior: torch.Tensor             # [N]
    beta_m: torch.Tensor          # [N, 3] longitudinal roughness per lobe R/TT/TRT
    beta_n: torch.Tensor          # [N, 3] azimuthal roughness per lobe
    cuticle_angle: torch.Tensor   # [N] radians (alpha)
    diffuse_weight: torch.Tensor  # [N]
    diffuse_tint: torch.Tensor    # [N, 3]


def _ipow(x, n: int):
    """x ** n for an integer n >= 1 as JAX's ``integer_pow`` multiplies it:
    repeated squaring, the set bits' powers multiplied from the lowest up."""
    acc = None
    while n > 0:
        if n & 1:
            acc = x if acc is None else acc * x
        n >>= 1
        if n > 0:
            x = x * x
    return acc


def _i0(x):
    """Modified Bessel I0 by its series (moderate |x|)."""
    val = torch.ones_like(x)
    x2 = x * x
    term = torch.ones_like(x)
    for i in range(1, 10):
        term = term * x2 / (4.0 * i * i)
        val = val + term
    return val


def _log_i0(x):
    """log I0(x), asymptotic for large |x| (PBRT's robust form)."""
    ax = torch.abs(x)
    large = ax > 12.0
    big = ax + 0.5 * (-math.log(2.0 * M_PI) + torch.log(1.0 / torch.clamp(ax, min=1e-9))
                      + 1.0 / torch.clamp(8.0 * ax, min=1e-9))
    small = torch.log(_i0(torch.where(large, 0.0, x)))
    return torch.where(large, big, small)


def _mp(cos_ti, cos_to, sin_ti, sin_to, v):
    """Longitudinal scattering Mp (Chiang Eq. 7, numerically robust)."""
    v = torch.clamp(v, min=1e-5)
    a = cos_ti * cos_to / v
    b = sin_ti * sin_to / v
    mp_small = torch.exp(_log_i0(a) - b - 1.0 / v + 0.6931 + torch.log(1.0 / (2.0 * v)))
    mp_big = safe_div(torch.exp(-b) * _i0(a), 2.0 * v * torch.sinh(1.0 / v))
    return torch.where(v <= 0.1, mp_small, mp_big)


def _logistic(x, s):
    x = torch.abs(x)
    e = torch.exp(-x / s)
    return e / (s * _ipow(1.0 + e, 2))


def _logistic_cdf(x, s):
    return 1.0 / (1.0 + torch.exp(-x / s))


def _trimmed_logistic(x, s, a, b):
    return _logistic(x, s) / torch.clamp(_logistic_cdf(b, s) - _logistic_cdf(a, s), min=1e-9)


def _sample_trimmed_logistic(u, s, a, b):
    k = _logistic_cdf(b, s) - _logistic_cdf(a, s)
    x = -s * torch.log(1.0 / torch.clamp(u * k + _logistic_cdf(a, s), min=1e-9) - 1.0)
    return torch.clamp(x, a, b)


def _phi(p, gamma_o, gamma_t):
    return 2.0 * p * gamma_t - 2.0 * gamma_o + p * M_PI


def _wrap_phi(phi):
    """Wrap to [-pi, pi]."""
    return torch.atan2(torch.sin(phi), torch.cos(phi))


def _beta_to_v(beta_m):
    """Longitudinal roughness -> variance."""
    t = 0.726 * beta_m + 0.812 * _ipow(beta_m, 2) + 3.7 * _ipow(beta_m, 20)
    return t * t


def _beta_to_s(beta_n):
    """Azimuthal roughness -> logistic scale."""
    return SQRT_PI_OVER_8 * (0.265 * beta_n + 1.194 * _ipow(beta_n, 2) + 5.372 * _ipow(beta_n, 22))


class _Geom(NamedTuple):
    sin_to: torch.Tensor
    cos_to: torch.Tensor
    phi_o: torch.Tensor
    gamma_o: torch.Tensor
    sin_tt: torch.Tensor         # refracted longitudinal
    cos_tt: torch.Tensor
    gamma_t: torch.Tensor
    transmittance: torch.Tensor  # [N, 3] one full internal path
    f0: torch.Tensor             # Fresnel at entry


def _fresnel(cos_i, eta):
    cos_i = torch.clamp(cos_i, 0.0, 1.0)
    sin2_t = (1.0 - cos_i * cos_i) / torch.clamp(eta * eta, min=1e-9)
    cos_t = torch.sqrt(torch.clamp(1.0 - sin2_t, min=0.0))
    rs = safe_div(cos_i - eta * cos_t, cos_i + eta * cos_t)
    rp = safe_div(eta * cos_i - cos_t, eta * cos_i + cos_t)
    f = 0.5 * (rs * rs + rp * rp)
    return torch.where(sin2_t >= 1.0, 1.0, torch.clamp(f, 0.0, 1.0))


def _geometry(wo_l, h, params: HairParams) -> _Geom:
    """Shared longitudinal / azimuthal geometry of ``wo_l`` [N, 3] (fibre frame)."""
    sin_to = torch.clamp(wo_l[..., 0], -1.0, 1.0)
    cos_to = torch.sqrt(torch.clamp(1.0 - sin_to * sin_to, min=0.0))
    phi_o = torch.atan2(wo_l[..., 2], wo_l[..., 1])
    gamma_o = torch.asin(torch.clamp(h, -1.0, 1.0))

    eta = params.ior
    # refraction into the fibre (longitudinal)
    sin_tt = sin_to / eta
    cos_tt = torch.sqrt(torch.clamp(1.0 - sin_tt * sin_tt, min=0.0))
    # modified azimuthal refraction (Chiang Eq. 6)
    etap = torch.sqrt(torch.clamp(eta * eta - sin_to * sin_to, min=0.0)) / torch.clamp(cos_to, min=1e-9)
    sin_gt = torch.clamp(h / torch.clamp(etap, min=1e-9), -1.0, 1.0)
    cos_gt = torch.sqrt(torch.clamp(1.0 - sin_gt * sin_gt, min=0.0))
    gamma_t = torch.asin(sin_gt)

    # absorption along one internal crossing (Chiang Eq. 5)
    l_path = safe_div(2.0 * cos_gt, torch.clamp(cos_tt, min=1e-5))
    transmittance = torch.exp(-params.sigma_a * l_path[..., None])

    f0 = _fresnel(cos_to * torch.sqrt(torch.clamp(1.0 - h * h, min=0.0)), eta)
    return _Geom(sin_to, cos_to, phi_o, gamma_o, sin_tt, cos_tt, gamma_t, transmittance, f0)


def _attenuations(g: _Geom):
    """Ap for p = 0..P_MAX (R, TT, TRT, residual) -> [N, P_MAX + 1, 3]."""
    f = g.f0[..., None]
    t = g.transmittance
    a0 = f.expand(t.shape)
    a1 = _ipow(1.0 - f, 2) * t
    a2 = _ipow(1.0 - f, 2) * f * t * t
    # residual: the geometric series' remainder a2 (f t)^k summed
    ft = f * t
    a3 = safe_div(a2 * ft, torch.clamp(1.0 - ft, min=1e-5))
    return torch.stack([a0, a1, a2, a3], dim=1)


def _lobe_angles(g: _Geom, params: HairParams):
    """Cuticle-tilted (sin, cos) of theta_o per lobe [N, 4]; the residual untilted."""
    alpha = params.cuticle_angle
    sin_a, cos_a = torch.sin(alpha), torch.cos(alpha)
    # tilts: R by -2a, TT by a, TRT by 4a (PBRT / Chiang)
    sin2a = 2.0 * sin_a * cos_a
    cos2a = cos_a * cos_a - sin_a * sin_a
    sin4a = 2.0 * sin2a * cos2a
    cos4a = cos2a * cos2a - sin2a * sin2a

    def rot(sin_to, cos_to, s, c):
        return sin_to * c + cos_to * s, cos_to * c - sin_to * s

    s0, c0 = rot(g.sin_to, g.cos_to, -sin2a, cos2a)  # R
    s1, c1 = rot(g.sin_to, g.cos_to, sin_a, cos_a)   # TT
    s2, c2 = rot(g.sin_to, g.cos_to, sin4a, cos4a)   # TRT
    sin_top = torch.stack([s0, s1, s2, g.sin_to], dim=-1)
    cos_top = torch.abs(torch.stack([c0, c1, c2, g.cos_to], dim=-1))
    return sin_top, cos_top


def _variances(params: HairParams):
    v = _beta_to_v(params.beta_m)                     # [N, 3]
    v = torch.cat([v, v[..., 2:3]], dim=-1)           # the residual takes TRT's
    s = _beta_to_s(params.beta_n)
    s = torch.cat([s, s[..., 2:3]], dim=-1)
    return v, s


def _lobe_pdf(ap):
    """The lobe-selection pdf by attenuation luminance [N, 4]."""
    ap_lum = ap.mean(dim=-1)
    return safe_div(ap_lum, torch.clamp(ap_lum.sum(dim=-1, keepdim=True), min=1e-9))


def _lobe_cdf(pdf):
    """The pdf's running sums over its 4 lobes, added left to right: three
    elementwise adds (a scan kernel over an axis of 4 took 4-5 ms of a
    320x320 frame on the card)."""
    c0 = pdf[..., 0]
    c1 = c0 + pdf[..., 1]
    c2 = c1 + pdf[..., 2]
    return torch.stack([c0, c1, c2, c2 + pdf[..., 3]], dim=-1)


def hair_eval(params: HairParams, wo_l, wi_l, h):
    """(f * |cos wi| [N, 3], pdf [N]) for MIS; directions in the fibre frame."""
    g = _geometry(wo_l, h, params)
    sin_ti = torch.clamp(wi_l[..., 0], -1.0, 1.0)
    cos_ti = torch.sqrt(torch.clamp(1.0 - sin_ti * sin_ti, min=0.0))
    phi_i = torch.atan2(wi_l[..., 2], wi_l[..., 1])
    phi = phi_i - g.phi_o

    ap = _attenuations(g)                             # [N, 4, 3]
    sin_top, cos_top = _lobe_angles(g, params)        # [N, 4]
    v, s = _variances(params)                         # [N, 4]

    mp = _mp(cos_ti[..., None], cos_top, sin_ti[..., None], sin_top, v)  # [N, 4]
    p_idx = torch.arange(P_MAX, dtype=torch.float32, device=wo_l.device)
    dphi = _wrap_phi(phi[..., None] - _phi(p_idx, g.gamma_o[..., None], g.gamma_t[..., None]))
    np_az = _trimmed_logistic(dphi, s[..., :P_MAX], -M_PI, M_PI)        # [N, 3]
    np_all = torch.cat([np_az, torch.full_like(np_az[..., :1], 1.0 / (2.0 * M_PI))], dim=-1)

    f_spec = (mp[..., None] * ap * np_all[..., None]).sum(dim=1)         # [N, 3]
    pdf_spec = (mp * np_all * _lobe_pdf(ap)).sum(dim=-1)

    # the diffuse lobe over the whole sphere, tinted (the MDL mix)
    w = params.diffuse_weight[..., None]
    f_diff = params.diffuse_tint / (4.0 * M_PI)
    f = (1.0 - w) * f_spec + w * f_diff
    pdf = (1.0 - params.diffuse_weight) * pdf_spec + params.diffuse_weight * (1.0 / (4.0 * M_PI))
    return f, pdf


def hair_sample(params: HairParams, wo_l, h, xi):
    """Importance-sample the hair BSDF with ``xi`` [N, 4] uniforms ->
    (wi_l [N, 3] in the fibre frame, bsdf_over_pdf [N, 3], pdf [N])."""
    g = _geometry(wo_l, h, params)
    ap = _attenuations(g)
    cdf = _lobe_cdf(_lobe_pdf(ap))

    # xi[0]'s tail [1 - w, 1] picks the diffuse lobe; the rest, rescaled,
    # picks a specular lobe
    w_mix = params.diffuse_weight
    take_diff = xi[:, 0] >= (1.0 - w_mix)
    u0 = torch.clamp(safe_div(xi[:, 0], torch.clamp(1.0 - w_mix, min=1e-6)), 0.0, 1.0)
    p = torch.clamp((u0[..., None] > cdf).sum(dim=-1), 0, P_MAX)

    sin_top, cos_top = _lobe_angles(g, params)
    v_all, s_all = _variances(params)
    pick = p[:, None]
    v = v_all.gather(1, pick)[:, 0]
    s = s_all.gather(1, pick)[:, 0]
    sin_tp = sin_top.gather(1, pick)[:, 0]
    cos_tp = cos_top.gather(1, pick)[:, 0]

    # longitudinal sampling (Chiang / PBRT inversion)
    u1 = torch.clamp(xi[:, 1], min=1e-5)
    cos_theta = 1.0 + v * torch.log(u1 + (1.0 - u1) * torch.exp(-2.0 / v))
    sin_theta = torch.sqrt(torch.clamp(1.0 - _ipow(cos_theta, 2), min=0.0))
    cos_phi_l = torch.cos(2.0 * M_PI * xi[:, 2])
    sin_ti = -cos_theta * sin_tp + sin_theta * cos_phi_l * cos_tp
    cos_ti = torch.sqrt(torch.clamp(1.0 - sin_ti * sin_ti, min=0.0))

    # azimuthal sampling
    dphi_spec = _phi(p.to(torch.float32), g.gamma_o, g.gamma_t) + _sample_trimmed_logistic(
        xi[:, 3], s, -M_PI, M_PI)
    dphi = torch.where(p >= P_MAX, 2.0 * M_PI * xi[:, 3], dphi_spec)
    phi_i = g.phi_o + dphi
    wi_l = torch.stack([sin_ti, cos_ti * torch.cos(phi_i), cos_ti * torch.sin(phi_i)], dim=-1)

    # the diffuse direction: uniform over the sphere from xi[1], xi[2]
    z = 1.0 - 2.0 * xi[:, 1]
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    ph = 2.0 * M_PI * xi[:, 2]
    wi_diff = torch.stack([z, r * torch.cos(ph), r * torch.sin(ph)], dim=-1)
    wi_l = torch.where(take_diff[..., None], wi_diff, wi_l)
    f, pdf = hair_eval(params, wo_l, wi_l, h)

    ok = pdf > 1e-9
    bsdf_over_pdf = safe_div(f, torch.clamp(pdf, min=1e-9)[..., None])
    return wi_l, torch.where(ok[..., None], bsdf_over_pdf, 0.0), torch.where(ok, pdf, 0.0)
