"""Measured-BSDF evaluation, sampling and pdf over the ray wavefront.

Port of ``nrc_tpu/ops/mbsdf.py:33-370``, the reference's MBSDF device
runtime (``df_bsdf_measurement_evaluate/sample/pdf/albedos``,
``nrc/shaders/texture_lookup.h:887-1253``): the CUDA 3D texture with
normalized coordinates and linear filtering becomes an explicit trilinear
lerp, the per-thread binary CDF searches a compare-and-count over a row.

Every per-ray read of the measurement tables is a row fetch through
``gather_rows`` (K7 on the card), as the texture atlas's bilinear fetch is
(``ops/texture.py``). The host stacks (``scene/mbsdf.py::MBSDFTableHost``,
[M, 2, ...]) are laid out as four row tables (``row_tables``):

- ``eval_rows`` [M*2*R*R*P, 25]: per texel (m, part, theta_in, theta_out,
  phi) the 8 corners of its trilinear cell (theta_in, theta_out and phi
  each at i and min(i + 1, size - 1), the clamped neighbour; RGB each)
  and the part's ``has_part``: one fetch a lookup, where the JAX package
  gathers 8 texels;
- ``cdf_theta_rows`` [M*2*R, R + 1]: the theta_out CDF of (m, part,
  theta_in), then ``has_part``;
- ``cdf_phi_rows`` [M*2*R*R, P]: the phi CDF of (m, part, theta_in,
  theta_out);
- ``albedo_rows`` [M*R, 6]: per (m, theta) the reflection and transmission
  albedos, their maxima and ``has_part``.

Angles (the reference's): (theta, phi) in the local shading frame, theta in
[0, pi/2] from the normal of the part's hemisphere, phi in [-pi, pi];
isotropy folds ``phi_out - phi_in`` into [0, pi] (``bsdf_compute_uvw``,
texture_lookup.h:925-944).

``measured_sample``, ``measured_aux`` and ``measured_eval`` share the
outgoing direction's frame, angles and albedo row; the bounce computes them
once (``measured_frame``) and hands them to each.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..utils.math import build_onb, dot, normalize
from .gather_cuda import gather_rows

M_PI = math.pi

PART_REFLECTION = 0
PART_TRANSMISSION = 1

EVAL_ROW = 25  # 8 corners x RGB + has_part


class MBSDFTables(NamedTuple):
    """The stacked measurement tables of a scene as row tables on a device."""

    eval_rows: torch.Tensor       # [M*2*R*R*P, 25]
    cdf_theta_rows: torch.Tensor  # [M*2*R, R + 1]
    cdf_phi_rows: torch.Tensor    # [M*2*R*R, P]
    albedo_rows: torch.Tensor     # [M*R, 6]
    res_theta: int                # R
    res_phi: int                  # P


def row_tables(host) -> dict:
    """``MBSDFTableHost`` -> the four row tables as float32 numpy arrays
    (module docstring)."""
    ev = np.asarray(host.eval, np.float32)               # [M, 2, R, R, P, 3]
    m, _, r, _, p, _ = ev.shape
    has = np.asarray(host.has_part, np.float32)          # [M, 2]
    i_r = np.arange(r)
    i_p = np.arange(p)
    nxt_r = np.minimum(i_r + 1, r - 1)
    nxt_p = np.minimum(i_p + 1, p - 1)
    corners = []
    for w in (i_r, nxt_r):          # theta_in
        for v in (i_r, nxt_r):      # theta_out
            for u in (i_p, nxt_p):  # phi
                corners.append(ev[:, :, w][:, :, :, v][:, :, :, :, u])
    cells = np.stack(corners, axis=-2).reshape(m, 2, r, r, p, 24)
    has_col = np.broadcast_to(has[:, :, None, None, None, None], (m, 2, r, r, p, 1))
    eval_rows = np.concatenate([cells, has_col], axis=-1).reshape(-1, EVAL_ROW)
    cdf_t = np.asarray(host.cdf_theta, np.float32)       # [M, 2, R, R]
    cdf_theta_rows = np.concatenate(
        [cdf_t, np.broadcast_to(has[:, :, None, None], (m, 2, r, 1))], axis=-1).reshape(-1, r + 1)
    cdf_phi_rows = np.asarray(host.cdf_phi, np.float32).reshape(-1, p)
    alb = np.asarray(host.albedo, np.float32)            # [M, 2, R]
    mx = np.asarray(host.max_albedo, np.float32)         # [M, 2]
    albedo_rows = np.stack(
        [alb[:, 0], alb[:, 1], np.broadcast_to(mx[:, 0:1], (m, r)), np.broadcast_to(mx[:, 1:2], (m, r)),
         np.broadcast_to(has[:, 0:1], (m, r)), np.broadcast_to(has[:, 1:2], (m, r))], axis=-1).reshape(-1, 6)
    return dict(eval_rows=np.ascontiguousarray(eval_rows, np.float32),
                cdf_theta_rows=np.ascontiguousarray(cdf_theta_rows, np.float32),
                cdf_phi_rows=np.ascontiguousarray(cdf_phi_rows, np.float32),
                albedo_rows=np.ascontiguousarray(albedo_rows, np.float32),
                res_theta=int(r), res_phi=int(p))


def to_device(rows: dict, device) -> MBSDFTables:
    """``row_tables``'s arrays as ``MBSDFTables`` on ``device``."""
    return MBSDFTables(**{k: torch.from_numpy(v).to(device) if isinstance(v, np.ndarray) else v
                          for k, v in rows.items()})


def _fold_phi_delta(phi_out: torch.Tensor, phi_in: torch.Tensor) -> torch.Tensor:
    """phi_out - phi_in folded into [0, pi] -> u in [0, 1]
    (``bsdf_compute_uvw``, texture_lookup.h:925-944)."""
    u = phi_out - phi_in
    u = torch.where(u < 0.0, u + 2.0 * M_PI, u)
    u = torch.where(u > M_PI, 2.0 * M_PI - u, u)
    return u / M_PI


def _axis_lerp(c: torch.Tensor, size: int):
    """CUDA normalized-coordinate linear filtering: texel centres at
    (i + 0.5) / size, clamp addressing -> (i0, f); the upper texel is
    min(i0 + 1, size - 1), stored beside i0 in the eval row."""
    x = c * size - 0.5
    i0 = torch.floor(x)
    f = x - i0
    return torch.clamp(i0.to(torch.int64), 0, size - 1), f


def _part_row(idx: torch.Tensor, part: torch.Tensor) -> torch.Tensor:
    return idx * 2 + part


def mbsdf_evaluate(tables: MBSDFTables, idx, part, theta_phi_in, theta_phi_out) -> torch.Tensor:
    """Trilinear lookup of the symmetrized eval volume -> [N, 3]
    (``df_bsdf_measurement_evaluate``, texture_lookup.h:959-995): one row
    fetch of the cell's 8 corners."""
    r, p = tables.res_theta, tables.res_phi
    u = _fold_phi_delta(theta_phi_out[..., 1], theta_phi_in[..., 1])
    v = theta_phi_out[..., 0] * (2.0 / M_PI)
    w = theta_phi_in[..., 0] * (2.0 / M_PI)
    ui0, uf = _axis_lerp(u, p)
    vi0, vf = _axis_lerp(v, r)
    wi0, wf = _axis_lerp(w, r)
    row = gather_rows(tables.eval_rows, ((_part_row(idx, part) * r + wi0) * r + vi0) * p + ui0)
    uf, vf, wf = uf[..., None], vf[..., None], wf[..., None]

    def tex(k):
        return row[:, 3 * k:3 * k + 3]

    c00 = tex(0) * (1 - uf) + tex(1) * uf
    c01 = tex(2) * (1 - uf) + tex(3) * uf
    c10 = tex(4) * (1 - uf) + tex(5) * uf
    c11 = tex(6) * (1 - uf) + tex(7) * uf
    c0 = c00 * (1 - vf) + c01 * vf
    c1 = c10 * (1 - vf) + c11 * vf
    out = c0 * (1 - wf) + c1 * wf
    return torch.where((row[:, 24] > 0.0)[..., None], out, 0.0)


def _sample_cdf(rows: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    """Vectorized ``sample_cdf`` (texture_lookup.h:634-658): the smallest m
    with xi < cdf[m], the count of entries <= xi, clamped."""
    n = rows.shape[-1]
    return torch.clamp((rows <= xi[..., None]).sum(dim=-1), 0, n - 1)


def _bin_probability(rows: torch.Tensor, i: torch.Tensor):
    """(cdf[i], cdf[i - 1] or 0 at i = 0) of each row."""
    above = torch.gather(rows, 1, i[:, None])[:, 0]
    below = torch.where(i > 0, torch.gather(rows, 1, torch.clamp(i - 1, min=0)[:, None])[:, 0], 0.0)
    return above, below


def mbsdf_sample(tables: MBSDFTables, idx, part, theta_phi_out, xi) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Two-stage CDF inversion -> (theta [N], phi [N], pdf [N])
    (``df_bsdf_measurement_sample``, texture_lookup.h:998-1106). A negative
    theta means absorption (missing part)."""
    r, p = tables.res_theta, tables.res_phi
    inv_r, inv_p = 1.0 / r, 1.0 / p
    s_theta = (M_PI / 2) * inv_r
    s_phi = M_PI * inv_p

    # theta_in's bin from the outgoing direction (BSDF symmetry)
    i_tin = torch.clamp((theta_phi_out[..., 0] * (2.0 / M_PI) * r).to(torch.int64), 0, r - 1)

    # stage 1: theta_out
    xi0 = xi[..., 0]
    row_t = gather_rows(tables.cdf_theta_rows, _part_row(idx, part) * r + i_tin)  # [N, R + 1]
    cdf_t = row_t[:, :r]
    i_tout = _sample_cdf(cdf_t, xi0)
    above, below = _bin_probability(cdf_t, i_tout)
    prob_theta = above - below
    xi0 = (xi0 - below) / torch.clamp(prob_theta, min=1e-12)

    # stage 2: phi (half circle, mirrored with probability 0.5)
    xi1 = xi[..., 1]
    flip = xi1 > 0.5
    xi1 = torch.where(flip, 1.0 - xi1, xi1) * 2.0
    cdf_p = gather_rows(tables.cdf_phi_rows, (_part_row(idx, part) * r + i_tin) * r + i_tout)  # [N, P]
    i_phi = _sample_cdf(cdf_p, xi1)
    above_p, below_p = _bin_probability(cdf_p, i_phi)
    prob_phi = above_p - below_p
    xi1 = (xi1 - below_p) / torch.clamp(prob_phi, min=1e-12)

    # continuous positions: cos-interpolated theta within its bin, the
    # rescaled leftovers cross-reused as the reference does
    # (texture_lookup.h:1077-1086)
    cos0 = torch.cos(i_tout.to(torch.float32) * s_theta)
    cos1 = torch.cos((i_tout + 1).to(torch.float32) * s_theta)
    cos_theta = cos0 * (1.0 - xi1) + cos1 * xi1
    theta = torch.arccos(torch.clamp(cos_theta, -1.0, 1.0))
    phi = (i_phi.to(torch.float32) + xi0) * s_phi
    phi = torch.where(flip, 2.0 * M_PI - phi, phi)

    # aligned to the outgoing phi (texture_lookup.h:1092-1101)
    phi_out = theta_phi_out[..., 1]
    phi = phi + torch.where(phi_out > 0.0, phi_out, 2.0 * M_PI + phi_out)
    phi = torch.where(phi > 2.0 * M_PI, phi - 2.0 * M_PI, phi)
    phi = torch.where(phi > M_PI, phi - 2.0 * M_PI, phi)  # -> [-pi, pi]

    pdf = prob_theta * prob_phi * 0.5 / torch.clamp(s_phi * (cos0 - cos1), min=1e-12)
    ok = row_t[:, r] > 0.0
    return torch.where(ok, theta, -1.0), torch.where(ok, phi, -1.0), torch.where(ok, pdf, 0.0)


def mbsdf_pdf(tables: MBSDFTables, idx, part, theta_phi_in, theta_phi_out) -> torch.Tensor:
    """The sampling pdf of ``theta_phi_in`` (the sampled direction) given
    ``theta_phi_out`` (the known one), the quantity ``mbsdf_sample``
    reports (``df_bsdf_measurement_pdf``, texture_lookup.h:1109-1177)."""
    r, p = tables.res_theta, tables.res_phi
    s_theta = (M_PI / 2) / r
    s_phi = M_PI / p
    u = _fold_phi_delta(theta_phi_out[..., 1], theta_phi_in[..., 1])
    i_tin = torch.clamp((theta_phi_in[..., 0] * (2.0 / M_PI) * r).to(torch.int64), 0, r - 1)
    i_tout = torch.clamp((theta_phi_out[..., 0] * (2.0 / M_PI) * r).to(torch.int64), 0, r - 1)
    i_phi = torch.clamp((u * p).to(torch.int64), 0, p - 1)

    row_t = gather_rows(tables.cdf_theta_rows, _part_row(idx, part) * r + i_tout)  # conditioned on the out dir
    above, below = _bin_probability(row_t[:, :r], i_tin)
    prob_theta = above - below

    cdf_p = gather_rows(tables.cdf_phi_rows, (_part_row(idx, part) * r + i_tout) * r + i_tin)
    above_p, below_p = _bin_probability(cdf_p, i_phi)
    prob_phi = above_p - below_p

    cos0 = torch.cos(i_tin.to(torch.float32) * s_theta)
    cos1 = torch.cos((i_tin + 1).to(torch.float32) * s_theta)
    pdf = prob_theta * prob_phi * 0.5 / torch.clamp(s_phi * (cos0 - cos1), min=1e-12)
    return torch.where(row_t[:, r] > 0.0, pdf, 0.0)


def mbsdf_albedos(tables: MBSDFTables, idx, theta_phi) -> torch.Tensor:
    """[N, 4]: (albedo_refl(theta), max_refl, albedo_trans(theta), max_trans)
    (``df_bsdf_measurement_albedos``, texture_lookup.h:1211-1253)."""
    r = tables.res_theta
    i_t = torch.clamp((theta_phi[..., 0] * (2.0 / M_PI) * r).to(torch.int64), 0, r - 1)
    row = gather_rows(tables.albedo_rows, idx * r + i_t)  # a_r, a_t, max_r, max_t, has_r, has_t
    return torch.stack([row[:, 0] * row[:, 4], row[:, 2] * row[:, 4], row[:, 1] * row[:, 5],
                        row[:, 3] * row[:, 5]], dim=-1)


# ---------------------------------------------------------------------------
# Archetype-level wrappers (MDL libbsdf's measured_bsdf in the generated
# sample / evaluate callables)
# ---------------------------------------------------------------------------


class MeasuredFrame(NamedTuple):
    """The outgoing side of a measured lookup: the (t, b) frame about the
    oriented normal, wo's (theta, phi) in it and its albedo row."""

    t: torch.Tensor
    b: torch.Tensor
    tpo: torch.Tensor  # [N, 2]
    alb: torch.Tensor  # [N, 4]


def _local_angles(w: torch.Tensor, t, b, n) -> torch.Tensor:
    """World direction -> (theta from |n|, phi) in the (t, b, n) frame, theta
    folded to [0, pi/2] (the parts live on separate hemispheres)."""
    z = dot(w, n)
    x = dot(w, t)
    y = dot(w, b)
    theta = torch.arccos(torch.clamp(torch.abs(z), 0.0, 1.0))
    phi = torch.atan2(y, x)
    return torch.stack([theta, phi], dim=-1)


def measured_frame(tables: MBSDFTables, idx, wo, nf) -> MeasuredFrame:
    t, b = build_onb(nf)
    tpo = _local_angles(wo, t, b, nf)
    return MeasuredFrame(t, b, tpo, mbsdf_albedos(tables, idx, tpo))


def _reflect_probability(alb: torch.Tensor):
    a_r, a_t = alb[..., 0], alb[..., 2]
    total = a_r + a_t
    return torch.where(total > 0.0, a_r / torch.clamp(total, min=1e-30), 1.0), total


def measured_sample(tables: MBSDFTables, idx, multiplier, fr: MeasuredFrame, nf, xi):
    """Sample the measured BSDF: the part by directional albedo, the
    two-stage CDF inverted, the volume evaluated -> (wi, bsdf_over_pdf,
    pdf, is_transmission, ok). ``nf`` is the normal turned to wo, ``xi``
    [N, 3]."""
    t, b, tpo = fr.t, fr.b, fr.tpo
    p_refl, total = _reflect_probability(fr.alb)
    choose_trans = xi[..., 2] >= p_refl
    part = choose_trans.to(torch.int64)  # PART_TRANSMISSION where chosen
    p_part = torch.where(choose_trans, 1.0 - p_refl, p_refl)

    theta, phi, pdf = mbsdf_sample(tables, idx, part, tpo, xi[..., :2])
    ok = (theta >= 0.0) & (pdf > 0.0) & (total > 0.0)
    pdf = pdf * p_part

    st = torch.sin(theta)
    z = torch.cos(theta)
    local = torch.stack([st * torch.cos(phi), st * torch.sin(phi), z], dim=-1)
    hemi = torch.where(choose_trans, -1.0, 1.0)
    wi = normalize(local[..., 0:1] * t + local[..., 1:2] * b + (local[..., 2:3] * hemi[..., None]) * nf)

    tpi = torch.stack([theta, phi], dim=-1)
    f = mbsdf_evaluate(tables, idx, part, tpi, tpo) * multiplier[..., None]
    cos_i = torch.clamp(z, 0.0, 1.0)
    w = f * (cos_i / torch.clamp(pdf, min=1e-12))[..., None]
    w = torch.where(ok[..., None], w, 0.0)
    pdf = torch.where(ok, pdf, 0.0)
    return wi, w, pdf, choose_trans, ok


def measured_aux(multiplier, fr: MeasuredFrame):
    """Approximate directional albedo [N, 3] for the radiance-query
    features: the sampling albedo table sums f(i,o) + f(o,i) over the
    hemisphere, so half of it estimates the max-channel albedo."""
    a = 0.5 * (fr.alb[..., 0] + fr.alb[..., 2]) * multiplier
    return torch.clamp(a, 0.0, 1.0)[..., None].expand(-1, 3)


def measured_eval(tables: MBSDFTables, idx, multiplier, fr: MeasuredFrame, wi, nf):
    """f x |cos_i| and the sample pdf for NEE / MIS; the part by wi's
    hemisphere against the oriented normal."""
    tpi = _local_angles(wi, fr.t, fr.b, nf)
    cos_i = dot(wi, nf)
    is_trans = cos_i < 0.0
    part = is_trans.to(torch.int64)

    f = mbsdf_evaluate(tables, idx, part, tpi, fr.tpo) * multiplier[..., None]
    pdf = mbsdf_pdf(tables, idx, part, tpi, fr.tpo)

    p_refl, total = _reflect_probability(fr.alb)
    pdf = pdf * torch.where(is_trans, 1.0 - p_refl, p_refl)

    fcos = f * torch.abs(cos_i)[..., None]
    ok = total > 0.0
    return torch.where(ok[..., None], fcos, 0.0), torch.where(ok, pdf, 0.0)
