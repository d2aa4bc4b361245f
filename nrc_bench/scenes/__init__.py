"""The benchmark's scenes, made from their declarations as plain arrays.

A scene is a module of this package named in a configuration's
``"scene"``: its ``declarations()`` gives (models, materials, camera) and
``build(resolution)`` the ``SceneData`` that the harness hands to the
program (``nrc_bench/system.py``) and to the reference
(``nrc_bench/reference/scene/build.py``) alike. A later scene is a new
module here; nothing else changes.
"""

from __future__ import annotations

import dataclasses
import importlib
import math
from typing import Dict, List, Sequence, Tuple

import numpy as np

from . import geometry as geo

TRIANGLE_FIELDS = ("p0", "p1", "p2", "n0", "n1", "n2", "uv0", "uv1", "uv2")


@dataclasses.dataclass
class Model:
    """One declared model: its kind, object-to-world matrix, material name
    and kind arguments (plane: tess_u, tess_v, up axis; sphere: tess_u,
    tess_v, max_theta / pi; torus: tess_u, tess_v, inner, outer)."""

    kind: str
    matrix: np.ndarray
    material: str
    args: Tuple = ()


@dataclasses.dataclass
class SceneData:
    """A scene as plain data: the triangles (``TRIANGLE_FIELDS`` [T, 3] or
    [T, 2] float32 and ``material_id`` [T] int32), the materials in id
    order (the fields of a material row by name; archetype and emission
    mode by their enum names), the camera (centre, phi, theta, fov,
    distance) and the system settings (resolution, tile size, path
    lengths)."""

    triangles: Dict[str, np.ndarray]
    materials: List[dict]
    camera: dict
    system: dict

    @property
    def num_triangles(self) -> int:
        return int(self.triangles["p0"].shape[0])


def translate(x, y, z) -> np.ndarray:
    m = np.eye(4)
    m[:3, 3] = (x, y, z)
    return m


def scale(x, y=None, z=None) -> np.ndarray:
    return np.diag([x, x if y is None else y, x if z is None else z, 1.0])


def rotate(axis: int, degrees: float) -> np.ndarray:
    c, s = math.cos(math.radians(degrees)), math.sin(math.radians(degrees))
    i, j = [(1, 2), (2, 0), (0, 1)][axis]
    m = np.eye(4)
    m[i, i], m[i, j], m[j, i], m[j, j] = c, -s, s, c
    return m


def make_mesh(model: Model) -> geo.Mesh:
    if model.kind == "plane":
        return geo.create_plane(*model.args)
    if model.kind == "box":
        return geo.create_box()
    if model.kind == "sphere":
        tess_u, tess_v, theta = model.args
        return geo.create_sphere(tess_u, tess_v, 1.0, theta * np.pi)
    if model.kind == "torus":
        return geo.create_torus(*model.args)
    raise ValueError(f"unsupported model kind {model.kind!r}")


def flatten(models: Sequence[Model], materials: Dict[str, dict], camera: dict,
            system: dict) -> SceneData:
    """Declared models -> one world-space triangle soup, each model's
    material the place of its name in ``materials``."""
    index = {name: i for i, name in enumerate(materials)}
    tri = {k: [] for k in TRIANGLE_FIELDS + ("material_id",)}
    for model in models:
        mesh = geo.transform_mesh(make_mesh(model), model.matrix)
        idx = mesh.indices.astype(np.int64)
        for k in range(3):
            tri[f"p{k}"].append(mesh.vertices[idx[:, k]])
            tri[f"n{k}"].append(mesh.normals[idx[:, k]])
            tri[f"uv{k}"].append(mesh.texcoords[idx[:, k]])
        tri["material_id"].append(np.full(idx.shape[0], index[model.material], np.int32))
    arrays = {k: np.concatenate(v) for k, v in tri.items()}
    return SceneData(arrays, [dict(m, name=name) for name, m in materials.items()], dict(camera), dict(system))


def build(name: str, resolution: Tuple[int, int]) -> SceneData:
    """The scene module ``name`` of this package at ``resolution``."""
    module = importlib.import_module(f"{__name__}.{name}")
    models, materials, camera, system = module.declarations()
    return flatten(models, materials, camera, dict(system, resolution=tuple(resolution)))
