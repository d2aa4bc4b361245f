"""The reference's host scene from the benchmark's ``SceneData``.

The material rows, the material table and the mesh lights are derived here
as the port derives them (``nrc_tpu_torch/scene/scene_builder.py::_scene``
and the mesh-light part of ``build_lights``), from the same arrays the
program is handed; nothing is taken from the program. Declared lights
(point, spot, IES, environment) are refused: the benchmark's scenes have
mesh lights only.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from .camera import Camera
from .lights import TYPE_LIGHT_MESH, LightTable, build_mesh_light, empty_light_table
from .materials import Archetype, EmissionMode, Material, MaterialTable

TRIANGLE_FIELDS = ("p0", "p1", "p2", "n0", "n1", "n2", "uv0", "uv1", "uv2")


@dataclasses.dataclass
class Scene:
    """The fields of the port's ``Scene`` that ``render/scene_device.py``
    and the frame read."""

    p0: np.ndarray
    p1: np.ndarray
    p2: np.ndarray
    n0: np.ndarray
    n1: np.ndarray
    n2: np.ndarray
    uv0: np.ndarray
    uv1: np.ndarray
    uv2: np.ndarray
    material_id: np.ndarray
    light_id: np.ndarray
    materials: MaterialTable
    material_rows: List[Material]
    lights: LightTable
    camera: Camera
    lens_shader: int = 0
    curves: Optional[object] = None

    @property
    def num_triangles(self) -> int:
        return int(self.p0.shape[0])

    def aabb(self) -> tuple[np.ndarray, np.ndarray]:
        lo = np.minimum(np.minimum(self.p0.min(0), self.p1.min(0)), self.p2.min(0))
        hi = np.maximum(np.maximum(self.p0.max(0), self.p1.max(0)), self.p2.max(0))
        return lo, hi


def material_row(fields: dict) -> Material:
    """A material of the scene data: enum fields by name."""
    f = dict(fields)
    if "archetype" in f:
        f["archetype"] = Archetype[f["archetype"]]
    if "emission_mode" in f:
        f["emission_mode"] = EmissionMode[f["emission_mode"]]
    return Material(**f)


def mesh_lights(rows: List[Material], tri: dict):
    """One mesh light per emissive material's triangle set, in material
    order -> (LightTable, light_id [T])."""
    material_id = tri["material_id"]
    light_id = np.full(material_id.shape[0], -1, np.int32)
    pools, starts, counts, areas, mids = [], [], [], [], []
    start = 0
    for mid, mat in enumerate(rows):
        if not mat.is_emissive:
            continue
        sel = np.nonzero(material_id == mid)[0]
        if sel.size == 0:
            continue
        cdf, area = build_mesh_light(tri["p0"][sel], tri["p1"][sel], tri["p2"][sel])
        pools.append([tri[k][sel] for k in TRIANGLE_FIELDS[:6]] + [cdf] + [tri[k][sel] for k in TRIANGLE_FIELDS[6:]])
        light_id[sel] = len(mids)
        starts.append(start)
        counts.append(sel.shape[0])
        areas.append(area)
        mids.append(mid)
        start += sel.shape[0]
    if not mids:
        return empty_light_table(), light_id
    n = len(mids)
    mats = np.stack([np.eye(4, dtype=np.float32)] * n)

    def cat(k):
        return np.concatenate([pool[k] for pool in pools])

    table = LightTable(
        type=np.full(n, TYPE_LIGHT_MESH, np.int32),
        matrix=mats,
        matrix_inv=np.stack([np.linalg.inv(m) for m in mats]).astype(np.float32),
        emission=np.ones((n, 3), np.float32),
        area=np.asarray(areas, np.float32),
        inv_integral=np.zeros(n, np.float32),
        spot_angle_half=np.full(n, np.radians(45.0 * 0.5), np.float32),
        spot_exponent=np.zeros(n, np.float32),
        material_id=np.asarray(mids, np.int32),
        tri_start=np.asarray(starts, np.int32),
        tri_count=np.asarray(counts, np.int32),
        mesh_p0=cat(0), mesh_p1=cat(1), mesh_p2=cat(2),
        mesh_n0=cat(3), mesh_n1=cat(4), mesh_n2=cat(5),
        mesh_cdf=cat(6),
        mesh_uv0=cat(7), mesh_uv1=cat(8), mesh_uv2=cat(9),
    )
    return table, light_id


def reference_scene(data, camera: Optional[dict] = None) -> Scene:
    """``data`` (``nrc_bench.scenes.SceneData``) -> the reference's Scene;
    ``camera`` replaces the data's camera fields (a moved camera)."""
    rows = [material_row(m) for m in data.materials]
    tri = data.triangles
    lights, light_id = mesh_lights(rows, tri)
    w, h = data.system["resolution"]
    cam = Camera(aspect=w / max(h, 1), **dict(data.camera, **(camera or {})))
    return Scene(**{k: tri[k] for k in TRIANGLE_FIELDS}, material_id=tri["material_id"], light_id=light_id,
                 materials=MaterialTable.build(rows), material_rows=rows, lights=lights, camera=cam)
