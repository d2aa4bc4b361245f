"""Light definitions and host-side table builders (NumPy).

Port of ``nrc_tpu/scene/lights.py``: the ``TypeLight`` ids (reference
``function_indices.h:50-59``), the SoA ``LightTable``, per-mesh-light area
CDFs and Walker alias tables. The benchmark's scenes light by their
emissive triangles alone: the port's environment and IES tables are not
copied.
"""

from __future__ import annotations

import dataclasses
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

    @property
    def num_lights(self) -> int:
        return int(self.type.shape[0])


def build_alias_table(weights: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Walker alias table -> (prob [N] f32, alias [N] i32).

    The same Vose pairing with the same LIFO stack order as the JAX
    package's ``build_alias_table``: ``i = floor(u*N); take alias[i] if frac >= prob[i]``.
    The benchmark's reference runs the Python loop alone (the port's native
    ``alias_table_build`` gives the same bits).
    """
    w = np.asarray(weights, np.float64).ravel()
    n = w.size
    if n == 0:
        return np.zeros(0, np.float32), np.zeros(0, np.int32)
    total = w.sum()
    if total <= 0:
        return np.full(n, 1.0, np.float32), np.arange(n, dtype=np.int32)
    p = np.ascontiguousarray(w * (n / total))
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
