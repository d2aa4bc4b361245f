"""Device-resident scene: host Scene -> tensors on one device.

Port of ``nrc_tpu/render/scene_device.py:41-390``. ``upload_scene`` reads
the ``Scene`` by field name, so it takes the JAX package's ``Scene``
unchanged as well as the port's. Above ``BVH_THRESHOLD`` triangles, or when
asked, it builds the 16-wide BVH on the host (``ops/bvh_wide.py``) and
uploads its row table; smaller scenes get the plane table of the
brute-force kernels instead. It refuses scenes that need what is not ported
yet: curves, textures, cutouts, volumes, layered/measured/noise materials,
the hair and measured archetypes, and lights other than mesh lights.
``patch_materials`` re-derives the material tables after a live material
edit, in place where their shapes hold (a captured frame reads them by
address).

The bounce body fetches per-hit data with row gathers
(``ops/gather_cuda.py::gather_rows`` over ``tri_shade`` and ``mat_row``);
the TPU package's one-hot matmul row fetch and its packed-transfer helpers
have no counterpart here.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..ops.bsdf import SUPPORTED_ARCHETYPES
from ..ops.bvh_wide import build_wide_bvh
from ..ops.intersect import BVH_THRESHOLD, TriSoA
from ..ops.intersect_cuda import build_plane_table
from ..ops.intersect_wide import WideBVH, upload_wide_bvh
from ..ops.light_sampling import DeviceLights, upload_lights
from ..scene.materials import EmissionMode


def mat_row_layout(curve_k: int):
    """Column layout of the merged per-material shade row (``mat_row``),
    the JAX package's (``scene_device.py:41-76``). Integer fields are
    stored as f32 (all values << 2^24, exact round trip)."""
    layout = [
        ("albedo", 3), ("roughness", 2), ("ior", 1),
        ("emission_radiance", 3),
        ("archetype", 1), ("thin_walled", 1),
        ("uv_xf", 6),
        ("albedo_tex", 1), ("cutout_tex", 1), ("emission_tex", 1),
        ("cutout_opacity", 1),
        ("sigma_a", 3), ("sigma_s", 3), ("volume_bias", 1),
        ("mbsdf_index", 1), ("mbsdf_multiplier", 1),
        ("archetype2", 1), ("albedo2", 3), ("roughness2", 2),
        ("blend_mode", 1), ("blend_w1", 3), ("blend_w2", 3),
        ("blend_ior", 1),
        ("mod_mode", 1), ("mod_a", 3), ("mod_b", 3), ("mod_exp", 1),
        ("curve", 3 * curve_k),
        ("hair_roughness", 6), ("hair_absorption", 3),
        ("hair_cuticle", 1), ("hair_diffuse_weight", 1),
        ("noise_mode", 1), ("noise_color1", 3), ("noise_color2", 3),
        ("noise_scale", 3), ("noise_levels", 1), ("noise_absolute", 1),
        ("noise_thr", 2), ("noise_marble", 1), ("noise_target", 1),
        ("noise_bump_factor", 1),
    ]
    offs = {}
    o = 0
    for nm, w in layout:
        offs[nm] = (o, o + w)
        o += w
    return offs, o


class DeviceScene(NamedTuple):
    tris: TriSoA
    # [T, 24] packed plane table (ops/intersect_cuda.py); None with a BVH
    planes: Optional[torch.Tensor]
    # [T, 26] f32 = p0|e1|e2 | n0|n1|n2 | uv0|uv1|uv2 | material, light as
    # bit-cast int32 (light -1 = not emissive): all a hit needs in ONE row
    tri_shade: torch.Tensor
    mat_row: torch.Tensor    # [M, mat_row_layout(K)[1]] f32
    mat_curve_k: int         # K, the curve resolution in mat_row
    lights: DeviceLights
    bvh: Optional[WideBVH] = None  # the 16-wide BVH; None = brute force

    @property
    def num_triangles(self) -> int:
        return self.tris.num


def _material_arrays(scene) -> dict:
    """Material-derived arrays (host numpy): the merged material row, each
    material's emitted radiance, and each light's (``scene_device.py:155-273``)."""
    mt = scene.materials

    # Emitted radiance of each material's diffuse EDF: intensity * edf(1/pi)
    # * factor, where factor = 1 for radiant-exitance mode and 1/area for
    # power mode (hit.cu:792-806). Power mode needs the owning light's area.
    m = mt.archetype.shape[0]
    emission_radiance = np.zeros((m, 3), np.float32)
    light_area_by_mat = {}
    for li in range(scene.lights.num_lights):
        mid = int(scene.lights.material_id[li])
        if mid >= 0:
            light_area_by_mat[mid] = float(scene.lights.area[li])
    for i in range(m):
        if mt.emission_mode[i] == int(EmissionMode.RADIANT_EXITANCE):
            emission_radiance[i] = mt.emission_intensity[i] / math.pi
        elif mt.emission_mode[i] == int(EmissionMode.POWER):
            area = light_area_by_mat.get(i, 1.0)
            emission_radiance[i] = mt.emission_intensity[i] / (math.pi * max(area, 1e-9))

    # per-light emitted radiance for NEE sampling of mesh lights
    lr = np.zeros((max(scene.lights.num_lights, 1), 3), np.float32)
    for li in range(scene.lights.num_lights):
        mid = int(scene.lights.material_id[li])
        if mid >= 0:
            lr[li] = emission_radiance[mid]

    k_curve = mt.curve.shape[1]
    _, row_w = mat_row_layout(k_curve)

    def f32(x):
        return np.asarray(x, np.float32).reshape(m, -1)

    mat_row = np.concatenate(
        [
            f32(mt.albedo), f32(mt.roughness), f32(mt.ior),
            f32(emission_radiance),
            f32(mt.archetype), f32(mt.thin_walled),
            f32(mt.uv_xf),
            f32(mt.albedo_tex), f32(mt.cutout_tex), f32(mt.emission_tex),
            f32(mt.cutout_opacity),
            f32(mt.sigma_a), f32(mt.sigma_s), f32(mt.volume_bias),
            f32(mt.mbsdf_index), f32(mt.mbsdf_multiplier),
            f32(mt.archetype2), f32(mt.albedo2), f32(mt.roughness2),
            f32(mt.blend_mode), f32(mt.blend_w1), f32(mt.blend_w2),
            f32(mt.blend_ior),
            f32(mt.mod_mode), f32(mt.mod_a), f32(mt.mod_b), f32(mt.mod_exp),
            f32(mt.curve),
            f32(mt.hair_roughness), f32(mt.hair_absorption),
            f32(mt.hair_cuticle_angle), f32(mt.hair_diffuse_weight),
            f32(mt.noise_mode), f32(mt.noise_color1), f32(mt.noise_color2),
            f32(mt.noise_scale), f32(mt.noise_levels),
            f32(mt.noise_absolute), f32(mt.noise_thr), f32(mt.noise_marble),
            f32(mt.noise_target), f32(mt.noise_bump_factor),
        ],
        axis=-1,
    )
    if mat_row.shape[1] != row_w:
        raise ValueError(f"material row width {mat_row.shape[1]} != layout {row_w}")
    return dict(mat_row=mat_row, emission_radiance=emission_radiance,
                light_radiance=lr, curve_k=k_curve)


def check_supported(scene) -> None:
    """Raise ``NotImplementedError`` naming the first unported feature."""
    mt = scene.materials
    unported = {
        "curves": getattr(scene, "curves", None) is not None,
        "the hair or measured archetype": bool(
            set(np.unique(mt.archetype).tolist()) - SUPPORTED_ARCHETYPES
        ),
        "layered materials": bool(np.any(mt.blend_mode != 0) or np.any(mt.mod_mode != 0)),
        "textures": bool(
            max(np.max(mt.albedo_tex), np.max(mt.cutout_tex), np.max(mt.emission_tex)) >= 0
        ),
        "cutout opacity": bool(np.min(mt.cutout_opacity) < 1.0),
        "volumes": bool(np.max(mt.sigma_a) + np.max(mt.sigma_s) > 0.0),
        "measured BSDFs": bool(np.max(mt.mbsdf_index) >= 0),
        "procedural noise": bool(
            np.max(mt.noise_mode) > 0 or np.max(np.abs(mt.noise_bump_factor)) > 0
        ),
    }
    for feature, present in unported.items():
        if present:
            raise NotImplementedError(f"scene uses {feature}, which is not ported yet")


def scene_archetypes(scene) -> frozenset:
    """The archetypes a scene's materials use, both blend lobes
    (``FrameConfig.archetype_set``, as ``nrc_tpu/render/renderer.py:116``
    sets it)."""
    mt = scene.materials
    return frozenset(np.unique(mt.archetype).tolist() + np.unique(mt.archetype2).tolist())


def patch_materials(dev: DeviceScene, scene) -> DeviceScene:
    """The material-derived tables of ``dev`` re-derived from ``scene``'s
    materials after a live edit (``nrc_tpu/render/scene_device.py:276-283``;
    the reference re-uploads the edited argument block,
    ``Device::updateMaterial``, ``Device.cpp:1700-1722``); geometry and BVH
    are kept. Where every new table has its old shape (an edit changes
    values, not rows) the new values are copied into the old tensors and
    ``dev`` itself is returned, so a captured frame that reads them by
    address reads the new ones; otherwise a new ``DeviceScene``, whose
    caller must drop every graph that read the old one."""
    check_supported(scene)
    mats = _material_arrays(scene)
    device = dev.mat_row.device
    lights = upload_lights(scene.lights, mats["light_radiance"], torch.device("cpu"))
    mat_row = torch.from_numpy(mats["mat_row"])
    old = [dev.mat_row] + [getattr(dev.lights, f.name) for f in dataclasses.fields(lights)
                           if isinstance(getattr(lights, f.name), torch.Tensor)]
    new = [mat_row] + [getattr(lights, f.name) for f in dataclasses.fields(lights)
                       if isinstance(getattr(lights, f.name), torch.Tensor)]
    if lights.types_static == dev.lights.types_static and all(
            a.shape == b.shape and a.dtype == b.dtype for a, b in zip(old, new)):
        for a, b in zip(old, new):
            a.copy_(b)
        return dev
    return dev._replace(
        mat_row=mat_row.to(device),
        lights=upload_lights(scene.lights, mats["light_radiance"], device),
    )


def upload_scene(scene, device: torch.device, use_bvh: Optional[bool] = None) -> DeviceScene:
    """Host ``Scene`` (the port's or the JAX package's) -> ``DeviceScene`` on
    ``device``. ``use_bvh=None`` builds the wide BVH above ``BVH_THRESHOLD``
    triangles (``nrc_tpu/render/scene_device.py:286-310``)."""
    check_supported(scene)
    device = torch.device(device)

    def dev(x, dtype=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype, device=device)

    if use_bvh is None:
        use_bvh = scene.num_triangles > BVH_THRESHOLD
    bvh = None
    if use_bvh and scene.num_triangles > 0:
        # 16-wide nodes and 16-triangle leaves, the JAX package's choice
        bvh = upload_wide_bvh(
            build_wide_bvh(scene.p0, scene.p1, scene.p2, branch=16, leaf_size=16), device
        )

    p0 = np.asarray(scene.p0, np.float32)
    e1 = np.asarray(scene.p1, np.float32) - p0
    e2 = np.asarray(scene.p2, np.float32) - p0
    packed = np.concatenate([p0, e1, e2], axis=-1)
    tris = TriSoA(dev(p0), dev(e1), dev(e2), dev(packed))
    tri_meta = np.stack([scene.material_id, scene.light_id], axis=-1).astype(np.int32)
    tri_shade = np.concatenate(
        [packed, scene.n0, scene.n1, scene.n2, scene.uv0, scene.uv1, scene.uv2,
         tri_meta.view(np.float32)],
        axis=-1, dtype=np.float32,
    )
    mats = _material_arrays(scene)
    return DeviceScene(
        tris=tris,
        planes=None if bvh is not None else build_plane_table(tris),
        # from_numpy keeps the bits of the two meta columns
        tri_shade=torch.from_numpy(np.ascontiguousarray(tri_shade)).to(device),
        mat_row=dev(mats["mat_row"]),
        mat_curve_k=mats["curve_k"],
        lights=upload_lights(scene.lights, mats["light_radiance"], device),
        bvh=bvh,
    )
