"""Device-resident scene: host Scene -> tensors on one device.

The benchmark's reference: a frozen copy of ``nrc_tpu_torch/render/
scene_device.py`` that builds no BVH. Above ``BVH_THRESHOLD`` triangles,
or when asked, the triangles are put in clusters for the brute force of
``ops/brute.py``; smaller scenes get the plane table of ``ops/planes.py``.
The material and light tables are derived as the port derives them, cut to
the columns of the benchmark's scenes (``scene/materials.py``). A scene
with curve segments is refused.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..ops.bsdf import SUPPORTED_ARCHETYPES
from ..ops.intersect import BVH_THRESHOLD, TriSoA
from ..ops.brute import Clusters, build_clusters
from ..ops.planes import build_plane_table
from ..ops.light_sampling import DeviceLights, upload_lights
from ..scene.materials import EmissionMode


def mat_row_layout():
    """Column layout of the merged per-material shade row (``mat_row``),
    the JAX package's first columns (``scene_device.py:41-76``). Integer
    fields are stored as f32 (all values << 2^24, exact round trip)."""
    layout = [
        ("albedo", 3), ("roughness", 2), ("ior", 1),
        ("emission_radiance", 3),
        ("archetype", 1), ("thin_walled", 1),
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
    mat_row: torch.Tensor    # [M, mat_row_layout()[1]] f32
    lights: DeviceLights
    # above BVH_THRESHOLD: the triangles in clusters (ops/brute.py); None = planes
    bvh: Optional[Clusters] = None

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

    _, row_w = mat_row_layout()

    def f32(x):
        return np.asarray(x, np.float32).reshape(m, -1)

    mat_row = np.concatenate(
        [
            f32(mt.albedo), f32(mt.roughness), f32(mt.ior),
            f32(emission_radiance),
            f32(mt.archetype), f32(mt.thin_walled),
        ],
        axis=-1,
    )
    if mat_row.shape[1] != row_w:
        raise ValueError(f"material row width {mat_row.shape[1]} != layout {row_w}")
    return dict(mat_row=mat_row, emission_radiance=emission_radiance, light_radiance=lr)


def check_supported(scene) -> None:
    """Raise ``NotImplementedError`` naming the archetypes that the
    reference has no BSDF for."""
    unknown = set(scene_archetypes(scene)) - SUPPORTED_ARCHETYPES
    if unknown:
        raise NotImplementedError(f"scene uses archetypes {sorted(unknown)}, which have no BSDF in the reference")


def scene_archetypes(scene) -> frozenset:
    """The archetypes a scene's materials use (``FrameConfig.archetype_set``,
    as ``nrc_tpu/render/renderer.py:116`` sets it)."""
    return frozenset(np.unique(scene.materials.archetype).tolist())


def scene_flags(scene) -> dict:
    """The ``FrameConfig`` switches a scene's materials set, as
    ``nrc_tpu/render/renderer.py:88-120`` sets them: the archetype set."""
    return dict(archetype_set=scene_archetypes(scene))


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
    if getattr(scene, "curves", None) is not None and scene.curves.num > 0:
        raise NotImplementedError("the reference has no curve walk")
    bvh = build_clusters(tris) if use_bvh and scene.num_triangles > 0 else None
    mats = _material_arrays(scene)
    return DeviceScene(
        tris=tris,
        planes=None if bvh is not None else build_plane_table(tris),
        # from_numpy keeps the bits of the two meta columns
        tri_shade=torch.from_numpy(np.ascontiguousarray(tri_shade)).to(device),
        mat_row=dev(mats["mat_row"]),
        lights=upload_lights(scene.lights, mats["light_radiance"], device),
        bvh=bvh,
    )
