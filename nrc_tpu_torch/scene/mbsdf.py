"""Measured BSDFs: loading, sampling-data construction, host tables (NumPy).

A copy of ``nrc_tpu/scene/mbsdf.py:49-324`` (numpy only, so that the port
never imports the JAX package), the reference's MBSDF pipeline
(``Device::prepareMBSDF`` / ``prepare_mbsdfs_part``,
``nrc/src/Device.cpp:3347-3663``). An isotropic measured BSDF is a grid
``[theta_in, theta_out, phi_delta]`` of scalar or RGB values per part
(reflection / transmission). From it, with the reference's construction:

- a symmetrized evaluation volume ``0.5 * (f(i,o,p) + f(o,i,p))``
  (Device.cpp:3499-3521), filtered trilinearly at lookup time
  (``ops/mbsdf.py``);
- two-stage sampling CDFs: per theta_in a CDF over theta_out and per
  (theta_in, theta_out) a CDF over phi_delta, weighted by the max colour
  channel times the spherical patch area (Device.cpp:3409-3477);
- albedo tables: unnormalized row sums per theta_in and their maximum
  (Device.cpp:3465-3487), which choose reflection or transmission.

Containers: ``.npz`` with arrays ``reflection`` / ``transmission`` of shape
[R, R, P] or [R, R, P, 3]; MERL ``.binary`` (Matusik et al. 2003),
resampled onto the isotropic grid; and the analytic bakers ``bake_lambert``
and ``bake_ggx``. The tables are the JAX package's bit for bit
(``tests/test_torch_mbsdf.py``).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

M_PI = float(np.pi)


# ---------------------------------------------------------------------------
# Measurement container
# ---------------------------------------------------------------------------

@dataclass
class Measurement:
    """One isotropic measured BSDF: per-part [R, R, P, 3] grids (or None)."""

    reflection: Optional[np.ndarray] = None
    transmission: Optional[np.ndarray] = None

    @property
    def resolution(self) -> Tuple[int, int]:
        part = self.reflection if self.reflection is not None else self.transmission
        return (part.shape[0], part.shape[2])


def _to_rgb(grid: np.ndarray) -> np.ndarray:
    grid = np.asarray(grid, np.float32)
    if grid.ndim == 3:
        grid = np.repeat(grid[..., None], 3, axis=-1)
    assert grid.ndim == 4 and grid.shape[-1] == 3 and grid.shape[0] == grid.shape[1]
    return grid


# ---------------------------------------------------------------------------
# Loaders
# ---------------------------------------------------------------------------

def load_npz(path: str) -> Measurement:
    with np.load(path) as z:
        refl = _to_rgb(z["reflection"]) if "reflection" in z else None
        trans = _to_rgb(z["transmission"]) if "transmission" in z else None
    assert refl is not None or trans is not None, f"{path}: no parts"
    return Measurement(reflection=refl, transmission=trans)


# MERL channel scale factors (readBRDF reference code, Matusik et al. 2003)
_MERL_SCALE = (1.0 / 1500.0, 1.15 / 1500.0, 1.66 / 1500.0)
_MERL_TH, _MERL_TD, _MERL_PD = 90, 90, 180


def _merl_index(wi: np.ndarray, wo: np.ndarray) -> np.ndarray:
    """Half/diff-angle MERL indices for unit vectors in the z-up frame.

    wi/wo: [..., 3] with z >= 0. Returns flat indices into one channel
    block. Follows the published readBRDF lookup: theta_half uses the
    sqrt mapping, phi_diff is folded into [0, pi] by reciprocity.
    """
    h = wi + wo
    h = h / np.maximum(np.linalg.norm(h, axis=-1, keepdims=True), 1e-12)
    theta_h = np.arccos(np.clip(h[..., 2], -1.0, 1.0))
    phi_h = np.arctan2(h[..., 1], h[..., 0])

    # rotate wi by -phi_h about z then -theta_h about y -> diff vector
    cp, sp = np.cos(-phi_h), np.sin(-phi_h)
    x1 = cp * wi[..., 0] - sp * wi[..., 1]
    y1 = sp * wi[..., 0] + cp * wi[..., 1]
    z1 = wi[..., 2]
    ct, st = np.cos(-theta_h), np.sin(-theta_h)
    xd = ct * x1 + st * z1
    zd = -st * x1 + ct * z1
    theta_d = np.arccos(np.clip(zd, -1.0, 1.0))
    phi_d = np.arctan2(y1, xd)
    phi_d = np.where(phi_d < 0.0, phi_d + M_PI, phi_d)  # reciprocity fold

    i_th = np.sqrt(np.clip(theta_h / (M_PI / 2), 0.0, 1.0)) * _MERL_TH
    i_th = np.clip(i_th.astype(np.int64), 0, _MERL_TH - 1)
    i_td = np.clip(
        (theta_d / (M_PI / 2) * _MERL_TD).astype(np.int64), 0, _MERL_TD - 1
    )
    i_pd = np.clip(
        (phi_d / M_PI * _MERL_PD).astype(np.int64), 0, _MERL_PD - 1
    )
    return i_pd + _MERL_PD * (i_td + _MERL_TD * i_th)


def load_merl(path: str, res_theta: int = 45, res_phi: int = 90) -> Measurement:
    """Load a MERL .binary BRDF and resample onto the isotropic grid."""
    with open(path, "rb") as f:
        dims = struct.unpack("<3i", f.read(12))
        assert dims == (_MERL_TH, _MERL_TD, _MERL_PD), f"bad MERL dims {dims}"
        n = dims[0] * dims[1] * dims[2]
        raw = np.frombuffer(f.read(n * 3 * 8), np.float64, n * 3)
    chans = raw.reshape(3, n)

    s_t = (M_PI / 2) / res_theta
    s_p = M_PI / res_phi
    t_in = (np.arange(res_theta) + 0.5) * s_t
    t_out = (np.arange(res_theta) + 0.5) * s_t
    p_d = (np.arange(res_phi) + 0.5) * s_p
    ti, to, pd = np.meshgrid(t_in, t_out, p_d, indexing="ij")
    # isotropic: put wi at phi=0, wo at phi_delta
    wi = np.stack([np.sin(ti), np.zeros_like(ti), np.cos(ti)], -1)
    wo = np.stack(
        [np.sin(to) * np.cos(pd), np.sin(to) * np.sin(pd), np.cos(to)], -1
    )
    idx = _merl_index(wi, wo)
    rgb = np.stack(
        [np.maximum(chans[c][idx] * _MERL_SCALE[c], 0.0) for c in range(3)],
        axis=-1,
    ).astype(np.float32)
    return Measurement(reflection=rgb)


def load_measurement(path: str) -> Measurement:
    if path.endswith(".npz"):
        return load_npz(path)
    if path.endswith(".binary"):
        return load_merl(path)
    raise ValueError(
        f"unsupported measured-BSDF container: {path} (.npz or MERL .binary)"
    )


# ---------------------------------------------------------------------------
# Analytic bakers (tests + synthesis)
# ---------------------------------------------------------------------------

def _angle_grids(res_theta: int, res_phi: int):
    s_t = (M_PI / 2) / res_theta
    s_p = M_PI / res_phi
    t_in = (np.arange(res_theta) + 0.5) * s_t
    t_out = (np.arange(res_theta) + 0.5) * s_t
    p_d = (np.arange(res_phi) + 0.5) * s_p
    return np.meshgrid(t_in, t_out, p_d, indexing="ij")


def bake_lambert(albedo=(0.8, 0.8, 0.8), res_theta: int = 16,
                 res_phi: int = 32) -> Measurement:
    """Constant f = albedo/pi over the grid."""
    ti, to, pd = _angle_grids(res_theta, res_phi)
    a = np.asarray(albedo, np.float32) / M_PI
    grid = np.broadcast_to(a, (*ti.shape, 3)).astype(np.float32).copy()
    return Measurement(reflection=grid)


def bake_ggx(tint=(1.0, 1.0, 1.0), alpha: float = 0.3, res_theta: int = 32,
             res_phi: int = 64) -> Measurement:
    """Unshadowed GGX NDF lobe f = D(h) / (4 cos_i cos_o) * tint."""
    ti, to, pd = _angle_grids(res_theta, res_phi)
    wi = np.stack([np.sin(ti), np.zeros_like(ti), np.cos(ti)], -1)
    wo = np.stack(
        [np.sin(to) * np.cos(pd), np.sin(to) * np.sin(pd), np.cos(to)], -1
    )
    h = wi + wo
    h = h / np.maximum(np.linalg.norm(h, axis=-1, keepdims=True), 1e-12)
    a2 = alpha * alpha
    d = h[..., 2] ** 2 * (a2 - 1.0) + 1.0
    ndf = a2 / np.maximum(M_PI * d * d, 1e-12)
    f = ndf / np.maximum(4.0 * wi[..., 2] * wo[..., 2], 1e-4)
    grid = (f[..., None] * np.asarray(tint, np.float32)).astype(np.float32)
    return Measurement(reflection=grid)


# ---------------------------------------------------------------------------
# Sampling-data construction (prepare_mbsdfs_part, Device.cpp:3385-3521)
# ---------------------------------------------------------------------------

@dataclass
class PartData:
    """Eval volume + sampling data of one part (host numpy)."""

    eval: np.ndarray       # [R, R, P, 3] symmetrized
    cdf_theta: np.ndarray  # [R, R]     normalized, per theta_in
    cdf_phi: np.ndarray    # [R, R, P]  normalized, per (theta_in, theta_out)
    albedo: np.ndarray     # [R]        unnormalized row sums
    max_albedo: float


def build_part(data: np.ndarray) -> PartData:
    """The reference's CDF construction, vectorized (Device.cpp:3409-3521)."""
    data = _to_rgb(data)
    r, p = data.shape[0], data.shape[2]
    s_theta = (M_PI / 2) / r
    s_phi = M_PI / p

    # probability density proxy: sum of max channels of both symmetric
    # lookups (Device.cpp:3437-3446)
    vmax = np.maximum(data.max(-1), 0.0)              # [R, R, P]
    prob = vmax + vmax.transpose(1, 0, 2)             # f(i,o) + f(o,i)

    # patch area per theta_out row (Device.cpp:3414-3423)
    sin1 = np.sin((np.arange(r) + 1) * s_theta) ** 2
    sin0 = np.concatenate([[0.0], sin1[:-1]])
    mu = (sin1 - sin0) * s_phi * 0.5                  # [R] over theta_out

    weighted = prob * mu[None, :, None]               # [R(in), R(out), P]
    cdf_phi = np.cumsum(weighted, axis=2)
    sum_phi = cdf_phi[..., -1:]                       # [R, R, 1]
    # zero rows: fall back to a uniform CDF (never selected — zero mass)
    uniform_p = np.broadcast_to(
        (np.arange(p, dtype=np.float64) + 1.0) / p, cdf_phi.shape
    )
    cdf_phi = np.where(sum_phi > 0.0, cdf_phi / np.maximum(sum_phi, 1e-30),
                       uniform_p)

    cdf_theta = np.cumsum(sum_phi[..., 0], axis=1)    # [R(in), R(out)]
    albedo = cdf_theta[:, -1].copy()                  # [R]
    uniform_t = np.broadcast_to(
        (np.arange(r, dtype=np.float64) + 1.0) / r, cdf_theta.shape
    )
    cdf_theta = np.where(albedo[:, None] > 0.0,
                         cdf_theta / np.maximum(albedo[:, None], 1e-30),
                         uniform_t)

    eval_sym = 0.5 * (data + data.transpose(1, 0, 2, 3))
    return PartData(
        eval=eval_sym.astype(np.float32),
        cdf_theta=cdf_theta.astype(np.float32),
        cdf_phi=cdf_phi.astype(np.float32),
        albedo=albedo.astype(np.float32),
        max_albedo=float(albedo.max(initial=0.0)),
    )


# ---------------------------------------------------------------------------
# Scene-level stacked tables
# ---------------------------------------------------------------------------

@dataclass
class MBSDFTableHost:
    """All measurements of a scene, stacked [M, 2(part), ...] for device
    upload (part 0 = reflection, 1 = transmission; missing parts zeroed,
    masked by ``has_part`` — mirrors ``Mbsdf.has_data``,
    texture_handler.h)."""

    eval: np.ndarray       # [M, 2, R, R, P, 3]
    cdf_theta: np.ndarray  # [M, 2, R, R]
    cdf_phi: np.ndarray    # [M, 2, R, R, P]
    albedo: np.ndarray     # [M, 2, R]
    max_albedo: np.ndarray  # [M, 2]
    has_part: np.ndarray   # [M, 2] f32 0/1

    @property
    def num(self) -> int:
        return self.eval.shape[0]

    @staticmethod
    def empty() -> "MBSDFTableHost":
        return MBSDFTableHost(
            eval=np.zeros((1, 2, 1, 1, 1, 3), np.float32),
            cdf_theta=np.ones((1, 2, 1, 1), np.float32),
            cdf_phi=np.ones((1, 2, 1, 1, 1), np.float32),
            albedo=np.zeros((1, 2, 1), np.float32),
            max_albedo=np.zeros((1, 2), np.float32),
            has_part=np.zeros((1, 2), np.float32),
        )

    @staticmethod
    def build(measurements: List[Measurement]) -> "MBSDFTableHost":
        if not measurements:
            return MBSDFTableHost.empty()
        res = measurements[0].resolution
        for m in measurements:
            assert m.resolution == res, (
                f"all measured BSDFs in a scene must share one resolution: "
                f"{m.resolution} != {res}"
            )
        r, p = res
        n = len(measurements)
        out = MBSDFTableHost(
            eval=np.zeros((n, 2, r, r, p, 3), np.float32),
            cdf_theta=np.ones((n, 2, r, r), np.float32),
            cdf_phi=np.ones((n, 2, r, r, p), np.float32),
            albedo=np.zeros((n, 2, r), np.float32),
            max_albedo=np.zeros((n, 2), np.float32),
            has_part=np.zeros((n, 2), np.float32),
        )
        for i, m in enumerate(measurements):
            for part, grid in enumerate((m.reflection, m.transmission)):
                if grid is None:
                    continue
                pd = build_part(grid)
                out.eval[i, part] = pd.eval
                out.cdf_theta[i, part] = pd.cdf_theta
                out.cdf_phi[i, part] = pd.cdf_phi
                out.albedo[i, part] = pd.albedo
                out.max_albedo[i, part] = pd.max_albedo
                out.has_part[i, part] = 1.0
        return out
