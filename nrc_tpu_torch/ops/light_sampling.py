"""Device light tables and light sampling over the ray wavefront.

Port of the mesh-light part of ``nrc_tpu/ops/light_sampling.py`` (reference
``__direct_callable__light_mesh``, ``hit.cu:1473-1662``): one light is
picked uniformly, one of its triangles through a Walker alias table over
triangle areas, and a uniform point on that triangle. Env, point, spot and
IES lights are not ported yet: ``upload_lights`` raises on them, and
``env_radiance`` reports no environment.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..scene.lights import TYPE_LIGHT_MESH, TYPE_LIGHT_POINT, LightTable, build_alias_table
from ..utils.math import cross, dot, normalize, safe_div

DENOM_EPS = 1.0e-6

# merged per-light row layout (``light_sampling.py:44-55``): every field the
# sampler needs rides ONE row gather by the chosen light index; ints stored
# as f32 (values << 2^24, exact round trip). ori/ori_inv are row-major 3x3.
_LIGHT_ROW = [
    ("type", 1), ("position", 3), ("emission", 3), ("ori", 9),
    ("ori_inv", 9), ("spot_cos_half", 1), ("spot_angle_half", 1),
    ("spot_exponent", 1), ("area", 1), ("emission_radiance", 3),
    ("ies_index", 1), ("tri_count", 1), ("tri_start", 1),
]
LIGHT_ROW_COLS = {}
_o = 0
for _nm, _w in _LIGHT_ROW:
    LIGHT_ROW_COLS[_nm] = (_o, _o + _w)
    _o += _w
LIGHT_ROW_W = _o
del _nm, _w, _o


@dataclasses.dataclass(frozen=True)
class DeviceLights:
    """Device-resident mesh-light table. ``types_static`` mirrors ``type``
    on the host so the sampler knows which light types are present."""

    area: torch.Tensor               # [L]
    light_row: torch.Tensor          # [L, LIGHT_ROW_W] merged per-light row
    mesh_row: torch.Tensor           # [T, 15] p0|p1|p2|uv0|uv1|uv2 of the pool
    mesh_prob: torch.Tensor          # [L, Tmax] alias probabilities
    mesh_alias: torch.Tensor         # [L, Tmax] i64 alias indices
    types_static: Tuple[int, ...] = ()

    @property
    def num(self) -> int:
        return len(self.types_static)


def upload_lights(lt: LightTable, emission_radiance: Optional[np.ndarray],
                  device: torch.device) -> DeviceLights:
    """Host LightTable -> DeviceLights (``light_sampling.py:139-328``).

    ``emission_radiance``: [L, 3] radiance of each mesh light's diffuse EDF.
    Reads ``lt`` by field name, so the JAX package's table works too.
    """
    n = lt.num_lights
    types = tuple(int(t) for t in lt.type)
    if any(t != TYPE_LIGHT_MESH for t in types):
        raise NotImplementedError(f"light types {sorted(set(types))}: only mesh lights are ported")
    if emission_radiance is None:
        emission_radiance = np.zeros((max(n, 1), 3), np.float32)

    tmax = max(int(lt.tri_count.max()) if n else 0, 1)
    mesh_prob = np.ones((max(n, 1), tmax), np.float32)
    mesh_alias = np.zeros((max(n, 1), tmax), np.int32)
    for i in range(n):
        c = int(lt.tri_count[i])
        if c > 0:
            s = int(lt.tri_start[i])
            areas = 0.5 * np.linalg.norm(
                np.cross(
                    lt.mesh_p1[s : s + c] - lt.mesh_p0[s : s + c],
                    lt.mesh_p2[s : s + c] - lt.mesh_p0[s : s + c],
                ),
                axis=-1,
            )
            prob, alias = build_alias_table(areas)
            mesh_prob[i, :c] = prob
            mesh_alias[i, :c] = alias

    def f32(x):
        return np.ascontiguousarray(np.asarray(x, np.float32))

    def pad1(x):
        x = np.zeros((0, 2), np.float32) if x is None else x
        return x if x.shape[0] > 0 else np.zeros((1,) + x.shape[1:], x.dtype)

    if n:
        ies = lt.ies_index if lt.ies_index is not None else np.full(n, -1)
        light_row = np.concatenate(
            [
                f32(lt.type).reshape(n, 1),
                f32(lt.matrix[:, :3, 3]),
                f32(lt.emission),
                f32(lt.matrix[:, :3, :3]).reshape(n, 9),
                f32(lt.matrix_inv[:, :3, :3]).reshape(n, 9),
                f32(np.cos(lt.spot_angle_half)).reshape(n, 1),
                f32(lt.spot_angle_half).reshape(n, 1),
                f32(lt.spot_exponent).reshape(n, 1),
                f32(lt.area).reshape(n, 1),
                f32(emission_radiance),
                f32(ies).reshape(n, 1),
                f32(np.maximum(lt.tri_count, 1)).reshape(n, 1),
                f32(lt.tri_start).reshape(n, 1),
            ],
            axis=-1,
        )
        area = f32(lt.area)
    else:
        light_row = np.zeros((1, LIGHT_ROW_W), np.float32)
        area = np.zeros((0,), np.float32)
    mesh_row = np.concatenate(
        [f32(pad1(lt.mesh_p0)), f32(pad1(lt.mesh_p1)), f32(pad1(lt.mesh_p2)),
         f32(pad1(lt.mesh_uv0)), f32(pad1(lt.mesh_uv1)), f32(pad1(lt.mesh_uv2))],
        axis=-1,
    )

    def dev(x, dtype=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype, device=device)

    return DeviceLights(
        area=dev(area),
        light_row=dev(light_row),
        mesh_row=dev(mesh_row),
        mesh_prob=dev(mesh_prob),
        mesh_alias=dev(mesh_alias, torch.int64),
        types_static=types,
    )


class LightSample(NamedTuple):
    direction: torch.Tensor          # [N, 3] surface -> light
    distance: torch.Tensor           # [N]
    radiance_over_pdf: torch.Tensor  # [N, 3]
    pdf: torch.Tensor                # [N] solid-angle (1 for singular), 0 invalid
    is_singular: torch.Tensor        # [N] bool (skip MIS)


def sample_lights(lights: DeviceLights, pos: torch.Tensor, xi: torch.Tensor) -> LightSample:
    """Pick one of L lights uniformly and sample it (``hit.cu:350-362``).

    The caller compensates the 1/L pick probability by multiplying by L
    (``hit.cu:424-426``). ``xi`` [N, 4]: light pick, two for the point on
    the triangle, one for the triangle pick.
    """
    n = pos.shape[0]
    num = lights.num
    zero = torch.zeros((n,), dtype=torch.float32, device=pos.device)
    if num == 0:
        z3 = torch.zeros((n, 3), dtype=torch.float32, device=pos.device)
        return LightSample(z3, zero, z3, zero, zero > 1)

    idx = torch.clamp((xi[:, 0] * num).to(torch.int64), max=num - 1)
    lrow = lights.light_row[idx]                  # ONE merged light-row gather

    def pf(name):
        a, b = LIGHT_ROW_COLS[name]
        return lrow[:, a] if b == a + 1 else lrow[:, a:b]

    ltype = pf("type").to(torch.int64)
    count = pf("tri_count").to(torch.int64)
    k = torch.minimum(
        (xi[:, 3] * count.to(torch.float32)).to(torch.int64), count - 1
    )
    frac = xi[:, 3] * count.to(torch.float32) - k.to(torch.float32)
    prob = lights.mesh_prob[idx, k]
    alias = lights.mesh_alias[idx, k]
    tri = torch.where(frac < prob, k, alias)
    flat = pf("tri_start").to(torch.int64) + tri

    # uniform point on the triangle (hit.cu:1488-1492)
    su = torch.sqrt(torch.clamp(xi[:, 1], 0.0, 1.0))
    a = 1.0 - su
    b = xi[:, 2] * su
    g = 1.0 - a - b
    mr = lights.mesh_row[flat]                    # ONE pool-row gather
    mp0, mp1, mp2 = mr[:, 0:3], mr[:, 3:6], mr[:, 6:9]
    p = a[:, None] * mp0 + b[:, None] * mp1 + g[:, None] * mp2
    d = p - pos
    dist = torch.sqrt(torch.clamp(dot(d, d), min=1e-20))
    dirn = d / dist[:, None]
    ng = normalize(cross(mp1 - mp0, mp2 - mp0))
    cos_l = dot(-dirn, ng)  # EDF cos: outgoing dir at the light = -dirn
    area = pf("area")
    # pdf = d^2 / (area * cos), solid angle (hit.cu:1652-1655)
    denom = torch.clamp(area * cos_l, min=DENOM_EPS)
    pdf_m = dist * dist / denom
    radiance = pf("emission_radiance")            # diffuse EDF, front face only
    valid = (cos_l > DENOM_EPS) & (dist > DENOM_EPS) & (pdf_m > DENOM_EPS)
    rop = safe_div(radiance, pdf_m[:, None])

    sel = (ltype == TYPE_LIGHT_MESH) & valid
    z3 = torch.zeros_like(dirn)
    return LightSample(
        direction=torch.where(sel[:, None], dirn, z3),
        distance=torch.where(sel, dist, zero),
        radiance_over_pdf=torch.where(sel[:, None], rop, z3),
        pdf=torch.where(sel, pdf_m, zero),
        is_singular=ltype >= TYPE_LIGHT_POINT,
    )


def env_radiance(lights: DeviceLights, direction: torch.Tensor):
    """Env emission + MIS pdf for escaping rays -> (emission [N,3], pdf [N],
    has_env). Env lights are not ported, so there is never an environment
    (``upload_lights`` refuses them)."""
    n = direction.shape[0]
    z = torch.zeros((n,), dtype=torch.float32, device=direction.device)
    return torch.zeros((n, 3), dtype=torch.float32, device=direction.device), z, False
