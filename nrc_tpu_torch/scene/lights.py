"""Light definitions and host-side table builders (NumPy).

Port of ``nrc_tpu/scene/lights.py``: the ``TypeLight`` ids (reference
``function_indices.h:50-59``), the SoA ``LightTable``, per-mesh-light area
CDFs, the lat-long environment's CDFs (``Texture::calculateSphericalCDF``,
``Texture.cpp:1456-1602``), the cube environment's importance weights over
its face texels, and Walker alias tables (built by the native library's
``alias_table_build`` where it is available, bit-identical to the Python
loop).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

TYPE_LIGHT_ENV_CONST = 0
TYPE_LIGHT_ENV_SPHERE = 1
TYPE_LIGHT_MESH = 2
TYPE_LIGHT_POINT = 3
TYPE_LIGHT_FIRST_SINGULAR = 3
TYPE_LIGHT_SPOT = 4
TYPE_LIGHT_IES = 5


@dataclasses.dataclass
class LightTable:
    """SoA light table; mesh-light triangle data lives in shared flat arrays."""

    type: np.ndarray          # [L] int32
    matrix: np.ndarray        # [L, 4, 4] f32 object-to-world
    matrix_inv: np.ndarray    # [L, 4, 4] f32
    emission: np.ndarray      # [L, 3] f32 (multiplier pre-applied)
    area: np.ndarray          # [L] f32 world-space area (mesh lights)
    inv_integral: np.ndarray  # [L] f32 env map integral^-1
    spot_angle_half: np.ndarray  # [L] f32 radians
    spot_exponent: np.ndarray    # [L] f32
    material_id: np.ndarray   # [L] int32 (mesh lights)
    tri_start: np.ndarray     # [L] int32
    tri_count: np.ndarray     # [L] int32
    mesh_p0: np.ndarray       # [T, 3] f32 world-space triangle vertices
    mesh_p1: np.ndarray       # [T, 3]
    mesh_p2: np.ndarray       # [T, 3]
    mesh_n0: np.ndarray       # [T, 3] f32 world-space shading normals
    mesh_n1: np.ndarray       # [T, 3]
    mesh_n2: np.ndarray       # [T, 3]
    mesh_cdf: np.ndarray      # [T] f32 per-light area CDF (upper edges, norm to 1)
    mesh_uv0: np.ndarray = None  # [T, 2] f32 texcoords
    mesh_uv1: np.ndarray = None
    mesh_uv2: np.ndarray = None
    # environment texture + CDFs (at most one env light, always light 0 --
    # reference Device.cpp:1544 asserts the env light is first)
    env_texture: Optional[np.ndarray] = None  # [H, W, 3] f32
    env_cdf_u: Optional[np.ndarray] = None    # [H, W+1] f32
    env_cdf_v: Optional[np.ndarray] = None    # [H+1] f32
    # cube environment: the six faces; env_texture then holds an equirect
    # proxy for display only
    env_cube: Optional[np.ndarray] = None     # [6, He, We, 3] f32
    # IES candela textures stacked [NI, H, W]; per light an index into the
    # stack (-1: no profile)
    ies_texture: Optional[np.ndarray] = None
    ies_index: Optional[np.ndarray] = None

    @property
    def num_lights(self) -> int:
        return int(self.type.shape[0])


def gaussian_filter_3x3(img: np.ndarray) -> np.ndarray:
    """3x3 Gaussian blur with wrap in x, clamp in y (``Texture.cpp:1456-1508``)."""
    k = np.array([1.0, 2.0, 1.0]) / 4.0
    out = k[0] * np.roll(img, 1, axis=1) + k[1] * img + k[2] * np.roll(img, -1, axis=1)
    up = np.vstack([out[:1], out[:-1]])
    dn = np.vstack([out[1:], out[-1:]])
    return k[0] * up + k[1] * out + k[2] * dn


def build_env_cdf(texture: np.ndarray) -> tuple[np.ndarray, np.ndarray, float]:
    """(cdf_u [H, W+1], cdf_v [H+1], integral) of a lat-long env map
    (``Texture::calculateSphericalCDF``, ``Texture.cpp:1510-1602``): texel
    weight = Gaussian-filtered intensity ((r+g+b)/3) x sin(theta); the MIS
    integral uses the unfiltered intensity (``Texture.cpp:1529-1536``)."""
    h, w, _ = texture.shape
    intensity = texture.mean(axis=-1)
    filtered = gaussian_filter_3x3(intensity)
    theta = (np.arange(h) + 0.5) / h * np.pi  # row 0 is the south pole
    sin_t = np.sin(theta)[:, None]
    weighted = filtered * sin_t

    cdf_u = np.zeros((h, w + 1), dtype=np.float64)
    cdf_u[:, 1:] = np.cumsum(weighted, axis=1)
    row_sums = cdf_u[:, -1].copy()
    cdf_u /= np.maximum(row_sums, 1e-20)[:, None]

    cdf_v = np.zeros(h + 1, dtype=np.float64)
    cdf_v[1:] = np.cumsum(row_sums)
    integral = float(np.sum(intensity * sin_t)) * 2.0 * np.pi * np.pi / (w * h)
    cdf_v /= max(cdf_v[-1], 1e-20)
    return cdf_u.astype(np.float32), cdf_v.astype(np.float32), float(max(integral, 1e-20))


def cube_texel_solid_angles(h: int, w: int) -> np.ndarray:
    """Exact solid angles [h, w] of one cube face's texels: over face
    coordinates a, b in [-1, 1], the rectangle [a0,a1]x[b0,b1] subtends the
    corner sum of atan2(a*b, sqrt(1+a^2+b^2)) with alternating signs."""
    a = np.linspace(-1.0, 1.0, w + 1)
    b = np.linspace(-1.0, 1.0, h + 1)
    aa, bb = np.meshgrid(a, b)  # [h+1, w+1]
    phi = np.arctan2(aa * bb, np.sqrt(1.0 + aa * aa + bb * bb))
    return (phi[1:, 1:] - phi[:-1, 1:] - phi[1:, :-1] + phi[:-1, :-1]).astype(np.float64)


def build_cube_env_weights(cube: np.ndarray) -> tuple[np.ndarray, float]:
    """Importance weights [6, H, W] and integral of a [6, H, W, 3] cube env
    map from its face texels: weight = intensity x texel solid angle, and
    the integral their sum (the ``invIntegral`` of the MIS pdf, pdf =
    intensity * invIntegral, ``miss.cu:195-198``)."""
    intensity = cube.mean(axis=-1).astype(np.float64)
    omega = cube_texel_solid_angles(cube.shape[1], cube.shape[2])
    weights = intensity * omega[None]
    return weights, max(float(weights.sum()), 1e-20)


def build_alias_table(weights: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Walker alias table -> (prob [N] f32, alias [N] i32).

    The same Vose pairing with the same LIFO stack order as the JAX
    package's ``build_alias_table``: ``i = floor(u*N); take alias[i] if frac >= prob[i]``.
    The native ``alias_table_build`` runs the same loop in C (a 524,288-texel
    env map takes seconds in Python); the Python loop is the fallback
    without a C compiler, and both give the same bits.
    """
    w = np.asarray(weights, np.float64).ravel()
    n = w.size
    if n == 0:
        return np.zeros(0, np.float32), np.zeros(0, np.int32)
    total = w.sum()
    if total <= 0:
        return np.full(n, 1.0, np.float32), np.arange(n, dtype=np.int32)
    p = np.ascontiguousarray(w * (n / total))
    from ..native import get_lib

    lib = get_lib()
    if lib is not None:
        prob32 = np.empty(n, np.float32)
        alias32 = np.empty(n, np.int32)
        if lib.alias_table_build(p.ctypes.data, n, prob32.ctypes.data, alias32.ctypes.data) == 0:
            return prob32, alias32
    return build_alias_table_loop(p)


def build_alias_table_loop(p: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The Python Vose loop over scaled weights ``p`` (mean 1)."""
    p = np.array(p, np.float64)
    n = p.size
    prob = np.ones(n, np.float64)
    alias = np.arange(n, dtype=np.int32)
    small = [i for i in range(n) if p[i] < 1.0]
    large = [i for i in range(n) if p[i] >= 1.0]
    while small and large:
        s = small.pop()
        l = large.pop()
        prob[s] = p[s]
        alias[s] = l
        p[l] = p[l] - (1.0 - p[s])
        (small if p[l] < 1.0 else large).append(l)
    return prob.astype(np.float32), alias


def build_mesh_light(
    p0: np.ndarray, p1: np.ndarray, p2: np.ndarray
) -> tuple[np.ndarray, float]:
    """Per-triangle area CDF + total area for already-world-space triangles."""
    areas = 0.5 * np.linalg.norm(np.cross(p1 - p0, p2 - p0), axis=-1)
    total = float(np.sum(areas))
    cdf = np.cumsum(areas) / max(total, 1e-20)
    return cdf.astype(np.float32), total


def empty_light_table() -> LightTable:
    z3 = np.zeros((0, 3), np.float32)
    return LightTable(
        type=np.zeros((0,), np.int32),
        matrix=np.zeros((0, 4, 4), np.float32),
        matrix_inv=np.zeros((0, 4, 4), np.float32),
        emission=z3,
        area=np.zeros((0,), np.float32),
        inv_integral=np.zeros((0,), np.float32),
        spot_angle_half=np.zeros((0,), np.float32),
        spot_exponent=np.zeros((0,), np.float32),
        material_id=np.zeros((0,), np.int32),
        tri_start=np.zeros((0,), np.int32),
        tri_count=np.zeros((0,), np.int32),
        mesh_p0=z3, mesh_p1=z3, mesh_p2=z3,
        mesh_n0=z3, mesh_n1=z3, mesh_n2=z3,
        mesh_cdf=np.zeros((0,), np.float32),
        mesh_uv0=np.zeros((0, 2), np.float32),
        mesh_uv1=np.zeros((0, 2), np.float32),
        mesh_uv2=np.zeros((0, 2), np.float32),
    )
