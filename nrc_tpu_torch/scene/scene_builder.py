"""Scene assembly: model declarations -> flat world-space SoA arrays (NumPy).

Port of the parts of ``nrc_tpu/scene/scene_builder.py`` the serving path
uses: the ``Scene`` dataclass, the geometry flattening of ``build_scene``
and the implicit mesh-light assembly of ``_build_lights``
(``scene_builder.py:361-425``; reference ``Application::createMeshLights``,
``Application.cpp:2079-2238``). Loading the reference's ``.txt``/``.mdl``
files is not ported yet; ``cornell_box()`` builds the Cornell box in code,
``cornell_objects()`` the same box around a finely tessellated sphere and
torus (about 132 K triangles, the large-scene path), and ``cornell_glass()``
the box with dielectric blocks and a thin-walled translucent panel (the
transmission lobes and the IOR stack).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..config import SystemConfig
from . import geometry as geo
from .camera import Camera
from .lights import TYPE_LIGHT_MESH, LightTable, build_mesh_light, empty_light_table
from .materials import Archetype, EmissionMode, Material, MaterialTable


@dataclasses.dataclass
class Scene:
    """Flat world-space triangle scene + materials + lights + camera."""

    p0: np.ndarray  # [T, 3] f32
    p1: np.ndarray
    p2: np.ndarray
    n0: np.ndarray  # [T, 3] f32 shading normals
    n1: np.ndarray
    n2: np.ndarray
    uv0: np.ndarray  # [T, 2] f32
    uv1: np.ndarray
    uv2: np.ndarray
    material_id: np.ndarray  # [T] int32
    light_id: np.ndarray     # [T] int32, -1 if not emissive

    materials: MaterialTable
    material_rows: List[Material]
    lights: LightTable
    camera: Camera
    lens_shader: int = 0
    curves: object = None  # curve primitives are not ported; always None

    @property
    def num_triangles(self) -> int:
        return int(self.p0.shape[0])

    def aabb(self) -> tuple[np.ndarray, np.ndarray]:
        lo = np.minimum(np.minimum(self.p0.min(0), self.p1.min(0)), self.p2.min(0))
        hi = np.maximum(np.maximum(self.p0.max(0), self.p1.max(0)), self.p2.max(0))
        return lo, hi


@dataclasses.dataclass(frozen=True)
class ModelDecl:
    """One ``model`` line of a scene: a procedural mesh, its object-to-world
    matrix and the name of its material."""

    kind: str                  # "plane", "box", "sphere" or "torus"
    # plane: (tess_u, tess_v, up_axis); sphere: (tess_u, tess_v, max_theta / pi);
    # torus: (tess_u, tess_v, inner_radius, outer_radius)
    args: Tuple[float, ...]
    matrix: np.ndarray         # [4, 4] float64
    material: str


def make_mesh(decl: ModelDecl) -> geo.Mesh:
    if decl.kind == "plane":
        return geo.create_plane(*decl.args)
    if decl.kind == "box":
        return geo.create_box()
    if decl.kind == "sphere":
        tess_u, tess_v, theta = decl.args
        return geo.create_sphere(tess_u, tess_v, 1.0, theta * np.pi)
    if decl.kind == "torus":
        return geo.create_torus(*decl.args)
    raise NotImplementedError(f"model kind {decl.kind!r} is not ported")


def build_lights(
    mat_rows: List[Material], p0, p1, p2, n0, n1, n2, uv0, uv1, uv2,
    material_id: np.ndarray,
) -> tuple[LightTable, np.ndarray]:
    """Implicit mesh lights: one light per emissive material's triangle set
    (``nrc_tpu/scene/scene_builder.py:361-425``). Declared lights (env,
    point, spot, IES) are not ported."""
    light_id = np.full(material_id.shape[0], -1, np.int32)
    areas, mat_ids, tri_start, tri_count, pools = [], [], [], [], []
    start = 0
    for mid, mat in enumerate(mat_rows):
        if not mat.is_emissive:
            continue
        sel = np.nonzero(material_id == mid)[0]
        if sel.size == 0:
            continue
        cdf, area = build_mesh_light(p0[sel], p1[sel], p2[sel])
        pools.append(
            (p0[sel], p1[sel], p2[sel], n0[sel], n1[sel], n2[sel], cdf,
             uv0[sel], uv1[sel], uv2[sel])
        )
        light_id[sel] = len(areas)
        areas.append(area)
        mat_ids.append(mid)
        tri_start.append(start)
        tri_count.append(sel.shape[0])
        start += sel.shape[0]
    if not areas:
        return empty_light_table(), light_id

    n = len(areas)
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
        material_id=np.asarray(mat_ids, np.int32),
        tri_start=np.asarray(tri_start, np.int32),
        tri_count=np.asarray(tri_count, np.int32),
        mesh_p0=cat(0), mesh_p1=cat(1), mesh_p2=cat(2),
        mesh_n0=cat(3), mesh_n1=cat(4), mesh_n2=cat(5),
        mesh_cdf=cat(6),
        mesh_uv0=cat(7), mesh_uv1=cat(8), mesh_uv2=cat(9),
        ies_index=np.full(n, -1, np.int32),
    )
    return table, light_id


def assemble_scene(
    models: Sequence[ModelDecl],
    materials: Dict[str, Material],
    camera: Camera,
) -> Scene:
    """Flatten declared models into one world-space triangle soup, as
    ``nrc_tpu/scene/scene_builder.py::build_scene`` does, and derive the
    mesh lights. ``materials`` keeps its insertion order as material ids."""
    mat_rows = list(materials.values())
    mat_index = {name: i for i, name in enumerate(materials)}
    tri = {k: [] for k in ("p0", "p1", "p2", "n0", "n1", "n2", "uv0", "uv1", "uv2", "mat")}
    for decl in models:
        mesh = geo.transform_mesh(make_mesh(decl), decl.matrix)
        idx = mesh.indices.astype(np.int64)
        for k in range(3):
            tri[f"p{k}"].append(mesh.vertices[idx[:, k]])
            tri[f"n{k}"].append(mesh.normals[idx[:, k]])
            tri[f"uv{k}"].append(mesh.texcoords[idx[:, k]])
        tri["mat"].append(np.full(idx.shape[0], mat_index[decl.material], np.int32))
    arrays = {k: np.concatenate(v) for k, v in tri.items()}
    p0, p1, p2 = arrays["p0"], arrays["p1"], arrays["p2"]
    n0, n1, n2 = arrays["n0"], arrays["n1"], arrays["n2"]
    uv0, uv1, uv2 = arrays["uv0"], arrays["uv1"], arrays["uv2"]
    material_id = arrays["mat"]
    lights, light_id = build_lights(
        mat_rows, p0, p1, p2, n0, n1, n2, uv0, uv1, uv2, material_id
    )
    return Scene(
        p0=p0, p1=p1, p2=p2, n0=n0, n1=n1, n2=n2, uv0=uv0, uv1=uv1, uv2=uv2,
        material_id=material_id,
        light_id=light_id,
        materials=MaterialTable.build(mat_rows),
        material_rows=mat_rows,
        lights=lights,
        camera=camera,
    )


# ---------------------------------------------------------------------------
# The built-in Cornell box
# ---------------------------------------------------------------------------


def _translate(x, y, z) -> np.ndarray:
    m = np.eye(4)
    m[:3, 3] = (x, y, z)
    return m


def _scale(x, y=None, z=None) -> np.ndarray:
    return np.diag([x, x if y is None else y, x if z is None else z, 1.0])


def _rotate(axis: int, degrees: float) -> np.ndarray:
    c, s = math.cos(math.radians(degrees)), math.sin(math.radians(degrees))
    i, j = [(1, 2), (2, 0), (0, 1)][axis]
    m = np.eye(4)
    m[i, i], m[i, j], m[j, i], m[j, j] = c, -s, s, c
    return m


def cornell_box_declarations() -> tuple[
    List[ModelDecl], Dict[str, Material], dict
]:
    """The Cornell box as (models, materials, camera parameters).

    The layout follows the reference scene that ``tests/test_scene.py``
    pins: six 10x10-tessellated planes (200 triangles each) and two boxes
    (12 each), 1224 triangles in all; walls at +-10; an emissive ceiling
    plane of area 16 (the [-1,1]^2 quad scaled by 2, turned to face down)
    at y = 9.9 with radiant exitance 100; camera center (0, 0, 15) with
    (phi, theta, fov, distance) = (0.750781, 0.5, 55, 20).

    Values the JAX tests do not pin, chosen here: wall albedos white
    (0.8, 0.8, 0.8), red (0.8, 0.05, 0.05) on the left and green
    (0.05, 0.8, 0.05) on the right; the emitter is emission-only
    (``NULL_BSDF``); a diffuse tall box (3 x 6 x 3 half-extents, turned
    +20 degrees about y) at (-4, -4, -3) and a GGX-reflect cube (half-extent
    3, roughness 0.1, ior 1.5, albedo 0.9) turned -20 degrees at (4, -7, 3).
    """
    materials = {
        "white": Material(name="white", albedo=(0.8, 0.8, 0.8)),
        "red": Material(name="red", albedo=(0.8, 0.05, 0.05)),
        "green": Material(name="green", albedo=(0.05, 0.8, 0.05)),
        "light": Material(
            name="light",
            archetype=Archetype.NULL_BSDF,
            albedo=(0.0, 0.0, 0.0),
            emission_intensity=(100.0, 100.0, 100.0),
            emission_mode=EmissionMode.RADIANT_EXITANCE,
        ),
        "glossy": Material(
            name="glossy",
            archetype=Archetype.GGX_REFLECT,
            albedo=(0.9, 0.9, 0.9),
            roughness=(0.1, 0.1),
            ior=1.5,
        ),
    }
    wall = _scale(10.0)
    models = [
        ModelDecl("plane", (10, 10, 1), _translate(0, -10, 0) @ wall, "white"),  # floor
        ModelDecl("plane", (10, 10, 1), _translate(0, 10, 0) @ _rotate(2, 180) @ wall,
                  "white"),  # ceiling
        ModelDecl("plane", (10, 10, 1), _translate(0, 9.9, 0) @ _rotate(2, 180) @ _scale(2.0),
                  "light"),
        ModelDecl("plane", (10, 10, 2), _translate(0, 0, -10) @ wall, "white"),  # back
        ModelDecl("plane", (10, 10, 0), _translate(-10, 0, 0) @ wall, "red"),  # left
        ModelDecl("plane", (10, 10, 0), _translate(10, 0, 0) @ _rotate(1, 180) @ wall,
                  "green"),  # right
        ModelDecl("box", (), _translate(-4, -4, -3) @ _rotate(1, 20) @ _scale(3, 6, 3),
                  "white"),
        ModelDecl("box", (), _translate(4, -7, 3) @ _rotate(1, -20) @ _scale(3.0),
                  "glossy"),
    ]
    camera = dict(center=(0.0, 0.0, 15.0), phi=0.750781, theta=0.5, fov=55.0, distance=20.0)
    return models, materials, camera


def _cornell_scene(models, materials, cam, resolution) -> tuple[Scene, SystemConfig]:
    system = SystemConfig(
        resolution=tuple(resolution),
        tile_size=(16, 16),
        samples_sqrt=1,
        path_lengths=(2, 6),
        center=cam["center"],
        camera=(cam["phi"], cam["theta"], cam["fov"], cam["distance"]),
    )
    camera = Camera(aspect=resolution[0] / max(resolution[1], 1), **cam)
    return assemble_scene(models, materials, camera), system


def cornell_box(resolution: Tuple[int, int] = (320, 320)) -> tuple[Scene, SystemConfig]:
    """The 1224-triangle Cornell box and its system settings: the given
    resolution (default 320x320), 16x16 tiles, path lengths 2-6, 1 spp per
    frame."""
    return _cornell_scene(*cornell_box_declarations(), resolution)


OBJECT_TESSELLATION = (256, 128)  # 2 x 256 x 128 = 65,536 triangles per object


def cornell_objects(resolution: Tuple[int, int] = (320, 320)) -> tuple[Scene, SystemConfig]:
    """The Cornell box's walls, light, camera and system settings around two
    finely tessellated objects: a diffuse sphere of radius 4 (256 x 128,
    65,536 triangles) resting on the floor where the tall box stood, and a
    GGX-reflect torus (ring radius 3, tube radius 1, 256 x 128, 65,536
    triangles) lying on the floor where the cube stood. 132,272 triangles in
    all, above ``BVH_THRESHOLD``: the scene of the large-scene path, built
    in code because the reference's data files are not in the repository."""
    models, materials, cam = cornell_box_declarations()
    tu, tv = OBJECT_TESSELLATION
    objects = [
        ModelDecl("sphere", (tu, tv, 1.0), _translate(-4, -6, -3) @ _scale(4.0), "white"),
        ModelDecl("torus", (tu, tv, 1.0, 3.0), _translate(4, -9, 3), "glossy"),
    ]
    return _cornell_scene(models[:6] + objects, materials, cam, resolution)


def cornell_glass_declarations() -> tuple[List[ModelDecl], Dict[str, Material], dict]:
    """The Cornell box's declarations with the transmission lobes in view:
    the tall block glass (``SPECULAR_REFLECT_TRANSMIT``, ior 1.5, albedo
    1), the short block frosted glass (``GGX_REFLECT_TRANSMIT``, roughness
    0.2, ior 1.5, albedo 0.95) and a thin-walled translucent panel
    (``DIFFUSE_TRANSMISSION``, albedo 0.7): a 4x4-tessellated plane of
    half-extents 2.5 x 5 standing at (6, -4.5, -6) behind the short block,
    turned -30 degrees about y. 1256 triangles, brute force."""
    models, materials, cam = cornell_box_declarations()
    materials = dict(
        materials,
        glass=Material(name="glass", archetype=Archetype.SPECULAR_REFLECT_TRANSMIT,
                       albedo=(1.0, 1.0, 1.0), ior=1.5),
        frosted=Material(name="frosted", archetype=Archetype.GGX_REFLECT_TRANSMIT,
                         albedo=(0.95, 0.95, 0.95), roughness=(0.2, 0.2), ior=1.5),
        panel=Material(name="panel", archetype=Archetype.DIFFUSE_TRANSMISSION,
                       albedo=(0.7, 0.7, 0.7), thin_walled=True),
    )
    tall, short = models[6], models[7]
    models = models[:6] + [
        dataclasses.replace(tall, material="glass"),
        dataclasses.replace(short, material="frosted"),
        ModelDecl("plane", (4, 4, 2), _translate(6, -4.5, -6) @ _rotate(1, -30) @ _scale(2.5, 5, 1),
                  "panel"),
    ]
    return models, materials, cam


def cornell_glass(resolution: Tuple[int, int] = (320, 320)) -> tuple[Scene, SystemConfig]:
    """The Cornell box with glass, frosted glass and a translucent panel
    (``cornell_glass_declarations``) and its system settings, as
    ``cornell_box``'s."""
    return _cornell_scene(*cornell_glass_declarations(), resolution)
