"""Device light tables and light sampling over the ray wavefront.

Port of ``nrc_tpu/ops/light_sampling.py`` (reference ``light_sample.cu`` and
``__direct_callable__light_mesh``, ``hit.cu:1473-1662``): constant and
textured (equirect or cube) environments, mesh lights, point, spot and IES
lights. One light is picked uniformly; the reference's function-pointer
dispatch becomes masked selects over the picked light's type, and each
type's branch is computed only when ``types_static`` holds that type, so a
scene pays for the types it has. Discrete choices (a mesh light's triangle,
an environment texel) use Walker alias tables. ``env_radiance`` evaluates
the environment for escaping rays with its MIS pdf (``__miss__env_constant``
/ ``__miss__env_sphere``, ``miss.cu:114-230``).

Every per-ray row fetch of a table goes through ``gather_rows`` (K7 on the
card): the merged light row (35 floats), the sampled triangle's pool row
(15), the env alias row (2: probability | alias index as raw int32 bits,
which K7 copies as bits; a value cast would break indices >= 2^24) and the
equirect eval row (4: rgb | pdf).
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..scene.lights import (
    TYPE_LIGHT_ENV_CONST,
    TYPE_LIGHT_ENV_SPHERE,
    TYPE_LIGHT_IES,
    TYPE_LIGHT_MESH,
    TYPE_LIGHT_POINT,
    TYPE_LIGHT_SPOT,
    LightTable,
    build_alias_table,
    build_cube_env_weights,
)
from ..utils.math import cross, dot, normalize, safe_div
from .gather_cuda import gather_rows
from .texture import apply_uv_transform, cube_dir_from_face_uv, cube_face_uv, sample_bilinear, sample_cube_env

DENOM_EPS = 1.0e-6
RT_MAX = 3.0e38  # an environment sample's distance

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
    """Device-resident light table. ``types_static`` mirrors ``type`` on the
    host so that the sampler computes only the branches of the types
    present; ``env_is_cube`` and ``env_shape`` ((H, W) of the equirect map
    or of a cube face) are host facts of the environment too. Tables of an
    absent feature are 1-entry dummies."""

    area: torch.Tensor               # [L]
    light_row: torch.Tensor          # [L, LIGHT_ROW_W] merged per-light row
    mesh_row: torch.Tensor           # [T, 15] p0|p1|p2|uv0|uv1|uv2 of the pool
    mesh_prob: torch.Tensor          # [L, Tmax] alias probabilities
    mesh_alias: torch.Tensor         # [L, Tmax] i64 alias indices
    env_alias_pack: torch.Tensor     # [NT, 2] prob | alias (raw i32 bits)
    env_eval_pack: torch.Tensor      # [H*W, 4] rgb | pdf (equirect)
    env_pdf: torch.Tensor            # [6*Hc*Wc] texel pdf (cube)
    env_cube: torch.Tensor           # [6, Hc, Wc, 3] faces (cube)
    ies_texture: torch.Tensor        # [NI, H, W] candela
    types_static: Tuple[int, ...] = ()
    env_is_cube: bool = False
    env_shape: Tuple[int, int] = (1, 1)

    @property
    def num(self) -> int:
        return len(self.types_static)

    @property
    def has_env(self) -> bool:
        """An environment light, always light 0 (``Device.cpp:1544``)."""
        return bool(self.types_static) and self.types_static[0] in (TYPE_LIGHT_ENV_CONST, TYPE_LIGHT_ENV_SPHERE)


def light_tables(lt: LightTable, emission_radiance: Optional[np.ndarray]) -> dict:
    """Host LightTable -> the host arrays of ``DeviceLights`` by field name,
    the JAX package's tables (``light_sampling.py:139-328``). Reads ``lt``
    by field name, so the JAX package's table works too.
    ``emission_radiance``: [L, 3] radiance of each mesh light's diffuse EDF."""
    n = lt.num_lights
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

    env_cube = getattr(lt, "env_cube", None)
    env_is_cube = env_cube is not None
    env_pdf = np.zeros((1,), np.float32)
    env_eval_pack = np.zeros((1, 4), np.float32)
    env_shape = (1, 1)
    if env_is_cube:
        # importance over the cube's own face texels: intensity x texel solid angle
        env_idx = int(np.argmax(lt.type == TYPE_LIGHT_ENV_SPHERE))
        weights, _ = build_cube_env_weights(env_cube)
        env_prob, env_alias = build_alias_table(weights)
        env_pdf = (env_cube.mean(axis=-1) * float(lt.inv_integral[env_idx])).astype(np.float32).ravel()
        env_shape = tuple(env_cube.shape[1:3])
    elif lt.env_texture is not None:
        h, w, _ = lt.env_texture.shape
        intensity = lt.env_texture.mean(axis=-1)
        theta = (np.arange(h) + 0.5) / h * np.pi
        env_prob, env_alias = build_alias_table(intensity * np.sin(theta)[:, None])
        # the MIS pdf of a texel: the reference's intensity * invIntegral
        # (miss.cu:195-198) of the unfiltered map
        env_idx = int(np.argmax(lt.type == TYPE_LIGHT_ENV_SPHERE))
        env_pdf_hw = intensity * float(lt.inv_integral[env_idx])
        env_eval_pack = np.concatenate(
            [np.asarray(lt.env_texture, np.float32), np.asarray(env_pdf_hw, np.float32)[..., None]], axis=-1
        ).reshape(h * w, 4)
        env_shape = (h, w)
    else:
        env_prob = np.ones((1,), np.float32)
        env_alias = np.zeros((1,), np.int32)
    env_alias_pack = np.stack(
        [env_prob.ravel().astype(np.float32),
         np.ascontiguousarray(env_alias.ravel().astype(np.int32)).view(np.float32)],
        axis=-1,
    )
    ies_texture = lt.ies_texture if lt.ies_texture is not None else np.ones((1, 1, 1), np.float32)

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
    return dict(
        area=area, light_row=light_row, mesh_row=mesh_row, mesh_prob=mesh_prob, mesh_alias=mesh_alias,
        env_alias_pack=f32(env_alias_pack), env_eval_pack=f32(env_eval_pack), env_pdf=f32(env_pdf),
        env_cube=f32(env_cube if env_is_cube else np.zeros((1, 1, 1, 3), np.float32)),
        ies_texture=f32(ies_texture),
        types_static=tuple(int(t) for t in lt.type), env_is_cube=env_is_cube, env_shape=env_shape,
    )


def upload_lights(lt: LightTable, emission_radiance: Optional[np.ndarray],
                  device: torch.device) -> DeviceLights:
    """Host LightTable -> DeviceLights on ``device`` (``light_tables``)."""
    tables = light_tables(lt, emission_radiance)

    def dev(x):
        # from_numpy keeps the bits of the alias column
        t = torch.from_numpy(np.ascontiguousarray(x))
        return t.to(device, torch.int64 if x.dtype == np.int32 else t.dtype)

    return DeviceLights(**{k: dev(v) if isinstance(v, np.ndarray) else v for k, v in tables.items()})


class LightSample(NamedTuple):
    direction: torch.Tensor          # [N, 3] surface -> light
    distance: torch.Tensor           # [N]
    radiance_over_pdf: torch.Tensor  # [N, 3]
    pdf: torch.Tensor                # [N] solid-angle (1 for singular), 0 invalid
    is_singular: torch.Tensor        # [N] bool (skip MIS)


def _rotate(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """m [N, 3, 3] (or [3, 3]) applied to v [N, 3]."""
    return (m * v[:, None, :]).sum(dim=-1)


def _alias_pick(pack: torch.Tensor, xi: torch.Tensor, count: int) -> torch.Tensor:
    """A texel of an alias table of ``count`` entries from one uniform: ONE
    row gather of (prob | alias bits)."""
    k = torch.clamp((xi * count).to(torch.int64), max=count - 1)
    frac = xi * count - k.to(torch.float32)
    ap = gather_rows(pack, k)
    return torch.where(frac < ap[:, 0], k, ap.view(torch.int32)[:, 1].to(torch.int64))


def sample_lights(lights: DeviceLights, pos: torch.Tensor, xi: torch.Tensor,
                  tex_ctx=None) -> LightSample:
    """Pick one of L lights uniformly and sample it (``hit.cu:350-362``).

    The caller compensates the 1/L pick probability by multiplying by L
    (``hit.cu:424-426``). ``xi`` [N, 4]: the light pick, then the sample's
    three uniforms. ``tex_ctx`` = (atlas, [L, 7] rows: emission texture id,
    uv transform) makes mesh lights' EDFs textured: the sampled point's
    texcoord modulates the radiance (``hit.cu:1545-1651``).
    """
    n = pos.shape[0]
    num = lights.num
    zero = torch.zeros((n,), dtype=torch.float32, device=pos.device)
    if num == 0:
        z3 = torch.zeros((n, 3), dtype=torch.float32, device=pos.device)
        return LightSample(z3, zero, z3, zero, zero > 1)

    idx = torch.clamp((xi[:, 0] * num).to(torch.int64), max=num - 1)
    lrow = gather_rows(lights.light_row, idx)      # ONE merged light-row gather

    def pf(name):
        a, b = LIGHT_ROW_COLS[name]
        v = lrow[:, a] if b == a + 1 else lrow[:, a:b]
        return v.reshape(n, 3, 3) if b - a == 9 else v

    ltype = pf("type").to(torch.int64)
    emission = pf("emission")
    present = set(lights.types_static)
    z3 = torch.zeros((n, 3), dtype=torch.float32, device=pos.device)
    out = [z3, zero, z3, zero]  # direction, distance, radiance / pdf, pdf

    def select(sel, *values):
        for i, v in enumerate(values):
            out[i] = torch.where(sel[:, None] if v.dim() == 2 else sel, v, out[i])

    # ---- singular lights: point, spot, IES (light_sample.cu:140-210) ----
    if present & {TYPE_LIGHT_POINT, TYPE_LIGHT_SPOT, TYPE_LIGHT_IES}:
        d = pf("position") - pos
        d2 = dot(d, d)
        valid = d2 > DENOM_EPS
        dist = torch.sqrt(torch.clamp(d2, min=1e-20))
        dirn = d / dist[:, None]
        emis = emission * safe_div(torch.ones_like(d2), d2)[:, None]
        if TYPE_LIGHT_SPOT in present:
            # cone falloff (light_sample.cu:188-210): the angle between the
            # light -> surface direction and the light's local +z
            z_axis = normalize(pf("ori")[:, :, 2])
            cos_theta = dot(-dirn, z_axis)
            inside = cos_theta >= pf("spot_cos_half")
            ang_half = torch.clamp(pf("spot_angle_half"), min=1e-6)
            cos_hemi = torch.cos((math.pi / 2.0) * torch.arccos(torch.clamp(cos_theta, -1.0, 1.0)) / ang_half)
            falloff = torch.pow(torch.clamp(cos_hemi, min=0.0), pf("spot_exponent"))
            is_spot = ltype == TYPE_LIGHT_SPOT
            emis = torch.where(is_spot[:, None], emis * falloff[:, None], emis)
            valid = valid & (inside | ~is_spot)
        if TYPE_LIGHT_IES in present:
            # the candela texture in the light's frame (light_sample.cu:186-199):
            # u the azimuth with wrap, v the polar angle from the nadir; bilinear
            rl = _rotate(pf("ori_inv"), -dirn)
            u = (torch.atan2(-rl[:, 0], rl[:, 2]) + math.pi) * 0.5 / math.pi
            v = torch.arccos(torch.clamp(-rl[:, 1], -1.0, 1.0)) / math.pi
            _, th, tw = lights.ies_texture.shape
            ies_index = pf("ies_index").to(torch.int64)
            prof = torch.clamp(ies_index, min=0)
            fx = u * tw - 0.5
            fy = v * th - 0.5
            x0 = torch.floor(fx).to(torch.int64)
            y0 = torch.floor(fy).to(torch.int64)
            wx = fx - x0.to(torch.float32)
            wy = fy - y0.to(torch.float32)
            x0w, x1w = torch.remainder(x0, tw), torch.remainder(x0 + 1, tw)
            y0c, y1c = torch.clamp(y0, 0, th - 1), torch.clamp(y0 + 1, 0, th - 1)
            tex = lights.ies_texture
            candela = (
                (1 - wy) * ((1 - wx) * tex[prof, y0c, x0w] + wx * tex[prof, y0c, x1w])
                + wy * ((1 - wx) * tex[prof, y1c, x0w] + wx * tex[prof, y1c, x1w])
            )
            has_prof = (ltype == TYPE_LIGHT_IES) & (ies_index >= 0)
            emis = torch.where(has_prof[:, None], emis * candela[:, None], emis)
        is_sing = (ltype == TYPE_LIGHT_POINT) | (ltype == TYPE_LIGHT_SPOT) | (ltype == TYPE_LIGHT_IES)
        select(is_sing & valid, dirn, dist, emis, torch.ones_like(dist))

    # ---- mesh lights (hit.cu:1473-1662) ----------------------------------
    if TYPE_LIGHT_MESH in present:
        count = pf("tri_count").to(torch.int64)
        k = torch.minimum((xi[:, 3] * count.to(torch.float32)).to(torch.int64), count - 1)
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
        mr = gather_rows(lights.mesh_row, flat)   # ONE pool-row gather
        mp0, mp1, mp2 = mr[:, 0:3], mr[:, 3:6], mr[:, 6:9]
        p = a[:, None] * mp0 + b[:, None] * mp1 + g[:, None] * mp2
        d = p - pos
        dist = torch.sqrt(torch.clamp(dot(d, d), min=1e-20))
        dirn = d / dist[:, None]
        ng = normalize(cross(mp1 - mp0, mp2 - mp0))
        cos_l = dot(-dirn, ng)  # EDF cos: outgoing dir at the light = -dirn
        # pdf = d^2 / (area * cos), solid angle (hit.cu:1652-1655)
        denom = torch.clamp(pf("area") * cos_l, min=DENOM_EPS)
        pdf_m = dist * dist / denom
        radiance = pf("emission_radiance")            # diffuse EDF, front face only
        if tex_ctx is not None:
            atlas, l_rows = tex_ctx
            lr_tex = gather_rows(l_rows, idx)         # ONE [N, 7] row gather
            uv_s = a[:, None] * mr[:, 9:11] + b[:, None] * mr[:, 11:13] + g[:, None] * mr[:, 13:15]
            uv_s = apply_uv_transform(uv_s, lr_tex[:, 1:7])
            radiance = radiance * sample_bilinear(atlas, lr_tex[:, 0].to(torch.int64), uv_s)[:, :3]
        valid = (cos_l > DENOM_EPS) & (dist > DENOM_EPS) & (pdf_m > DENOM_EPS)
        select((ltype == TYPE_LIGHT_MESH) & valid, dirn, dist, safe_div(radiance, pdf_m[:, None]), pdf_m)

    # ---- constant environment: a uniform sphere direction ----------------
    if TYPE_LIGHT_ENV_CONST in present:
        z = 1.0 - 2.0 * xi[:, 1]
        r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
        phi = xi[:, 2] * 2.0 * math.pi
        dirn = torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)
        pdf_e = torch.full_like(zero, 0.25 / math.pi)
        select(ltype == TYPE_LIGHT_ENV_CONST, dirn, torch.full_like(zero, RT_MAX),
               emission / pdf_e[:, None], pdf_e)

    # ---- textured environment: a texel by its alias table ----------------
    if TYPE_LIGHT_ENV_SPHERE in present:
        h, w = lights.env_shape
        if lights.env_is_cube:
            # the cube's own texels; the texel maps back through the face-uv inverse
            texel = _alias_pick(lights.env_alias_pack, xi[:, 1], 6 * h * w)
            face = texel // (h * w)
            rem = texel - face * (h * w)
            ty = rem // w
            tx = rem - ty * w
            d_obj = cube_dir_from_face_uv(face, (tx.to(torch.float32) + xi[:, 2]) / w,
                                          (ty.to(torch.float32) + xi[:, 3]) / h)
            emis = sample_cube_env(lights.env_cube, d_obj)
            pdf_e = lights.env_pdf[texel]
        else:
            texel = _alias_pick(lights.env_alias_pack, xi[:, 1], h * w)
            ty = texel // w
            tx = texel % w
            # jitter inside the texel; object space: u = 0 seam on -z, v = 0
            # the south pole (light_sample.cu:95-106)
            phi = (tx.to(torch.float32) + xi[:, 2]) / w * 2.0 * math.pi
            theta = (ty.to(torch.float32) + xi[:, 3]) / h * math.pi
            st = torch.sin(theta)
            d_obj = torch.stack([torch.sin(phi) * st, -torch.cos(theta), -torch.cos(phi) * st], dim=-1)
            ev = gather_rows(lights.env_eval_pack, texel)  # ONE row: rgb | pdf
            emis, pdf_e = ev[:, 0:3], ev[:, 3]
        dirn = _rotate(pf("ori"), d_obj)
        select((ltype == TYPE_LIGHT_ENV_SPHERE) & (pdf_e > DENOM_EPS), dirn, torch.full_like(zero, RT_MAX),
               safe_div(emission * emis, pdf_e[:, None]), pdf_e)

    return LightSample(
        direction=out[0],
        distance=out[1],
        radiance_over_pdf=out[2],
        pdf=out[3],
        is_singular=ltype >= TYPE_LIGHT_POINT,
    )


def env_radiance(lights: DeviceLights, direction: torch.Tensor):
    """Env emission + MIS pdf for escaping rays -> (emission [N, 3], pdf [N],
    has_env); has_env is a host fact (``types_static``), and without an
    environment the tensors are zeros nothing reads."""
    n = direction.shape[0]
    if not lights.has_env:
        z = torch.zeros((n,), dtype=torch.float32, device=direction.device)
        return torch.zeros((n, 3), dtype=torch.float32, device=direction.device), z, False
    a, b = LIGHT_ROW_COLS["emission"]
    emission = lights.light_row[0, a:b]
    if lights.types_static[0] == TYPE_LIGHT_ENV_CONST:
        return (emission.expand(n, 3), torch.full((n,), 0.25 / math.pi, device=direction.device), True)
    a, b = LIGHT_ROW_COLS["ori_inv"]
    r = _rotate(lights.light_row[0, a:b].reshape(3, 3), direction)
    h, w = lights.env_shape
    if lights.env_is_cube:
        # the cube lookup for the radiance and the same face-texel grid's
        # pdf that NEE samples from
        face, u, v = cube_face_uv(r)
        tx = torch.clamp((u * w).to(torch.int64), 0, w - 1)
        ty = torch.clamp((v * h).to(torch.int64), 0, h - 1)
        rad = sample_cube_env(lights.env_cube, r)
        pdf = lights.env_pdf[face * (h * w) + ty * w + tx]
    else:
        u = (torch.atan2(-r[:, 0], r[:, 2]) + math.pi) * 0.5 / math.pi
        v = torch.arccos(torch.clamp(-r[:, 1], -1.0, 1.0)) / math.pi
        tx = torch.clamp((u * w).to(torch.int64), 0, w - 1)
        ty = torch.clamp((v * h).to(torch.int64), 0, h - 1)
        ev = gather_rows(lights.env_eval_pack, ty * w + tx)  # ONE row: rgb | pdf
        rad, pdf = ev[:, 0:3], ev[:, 3]  # pdf = intensity * invIntegral (miss.cu:195-198)
    return rad * emission, pdf, True
