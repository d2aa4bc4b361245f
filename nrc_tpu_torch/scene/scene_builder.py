"""Scene assembly: model declarations -> flat world-space SoA arrays (NumPy).

Port of the parts of ``nrc_tpu/scene/scene_builder.py`` the serving path
uses: the ``Scene`` dataclass, the geometry flattening of ``build_scene``
and ``_build_lights`` (``scene_builder.py:277-429``): declared lights (an
environment first, constant or a Radiance ``.hdr`` map; point, spot and IES
lights, an IES profile found on the search paths) and one implicit mesh
light per emissive material (reference ``Application::createMeshLights``,
``Application.cpp:2079-2238``). Loading the reference's ``.txt``/``.mdl``
files is not ported yet; the scenes are built in code: ``cornell_box()``,
``cornell_objects()`` (the same box around a finely tessellated sphere and
torus, about 132 K triangles, the large-scene path), ``cornell_glass()``
(dielectric blocks and a thin-walled translucent panel: the transmission
lobes and the IOR stack), ``cornell_lights()`` (the box's area light with a
point, a spot and an IES light) and ``env_textured()`` (an open scene under
an equirect or constant environment with textured albedo, a cutout panel
and a textured emitter), ``cornell_materials()`` (layered, modified,
measured and procedural-noise surfaces), ``cornell_volume()`` (a
scattering and an absorbing medium) and ``cornell_hair()`` (a patch of
fur on the short block: B-spline strands tessellated into round cones,
``scene/hair.py``, under the Chiang hair BSDF). ``cornell_lights``, ``env_textured``
and ``cornell_materials`` write their files (an LM-63 profile, PNG
textures, an RLE ``.hdr`` map, a baked measurement) into a directory the
caller gives and load them back through the file path every scene takes.
"""

from __future__ import annotations

import dataclasses
import math
import os
import tempfile
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import SystemConfig
from ..utils.hdr_loader import load_radiance_hdr
from ..utils.image_io import write_hdr_rle, write_png
from . import geometry as geo
from .camera import Camera
from .hair import CurveSegments, HairFile, hair_to_segments, transform_segments
from .ies import ies_to_texture, load_ies
from .lights import (
    TYPE_LIGHT_ENV_CONST,
    TYPE_LIGHT_ENV_SPHERE,
    TYPE_LIGHT_IES,
    TYPE_LIGHT_MESH,
    TYPE_LIGHT_POINT,
    TYPE_LIGHT_SPOT,
    LightTable,
    build_cube_env_weights,
    build_env_cdf,
    build_mesh_light,
    empty_light_table,
)
from .materials import Archetype, EmissionMode, Material, MaterialTable
from .mbsdf import bake_ggx


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
    # curve primitives: hair strands as round-cone segments (scene/hair.py)
    curves: Optional[CurveSegments] = None

    @property
    def num_triangles(self) -> int:
        return int(self.p0.shape[0])

    def aabb(self) -> tuple[np.ndarray, np.ndarray]:
        """The triangles' box grown by the segments' start spheres
        (``nrc_tpu/scene/scene_builder.py:82-90``, whose rule it keeps: the
        query positions are scaled by this box's extent)."""
        if self.num_triangles == 0 and self.curves is not None:
            lo = (self.curves.pa - self.curves.ra[:, None]).min(0)
            hi = (self.curves.pa + self.curves.ra[:, None]).max(0)
            return lo.astype(np.float32), hi.astype(np.float32)
        lo = np.minimum(np.minimum(self.p0.min(0), self.p1.min(0)), self.p2.min(0))
        hi = np.maximum(np.maximum(self.p0.max(0), self.p1.max(0)), self.p2.max(0))
        if self.curves is not None and self.curves.num:
            lo = np.minimum(lo, (self.curves.pa - self.curves.ra[:, None]).min(0))
            hi = np.maximum(hi, (self.curves.pa + self.curves.ra[:, None]).max(0))
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


@dataclasses.dataclass
class LightDecl:
    """One declared light of a scene (the fields of the JAX parser's
    ``LightDecl``, ``nrc_tpu/scene/parser.py:164-172``)."""

    light_type: str                         # env | point | spot | ies
    matrix: np.ndarray                      # 4x4 object-to-world
    emission: Tuple[float, float, float]
    multiplier: float
    texture: str = ""                       # env emission texture filename
    profile: str = ""                       # IES profile filename
    spot_angle: float = 45.0                # full cone angle, degrees
    spot_exponent: float = 0.0


def build_lights(
    decls: Sequence[LightDecl], search_paths: Sequence[str],
    mat_rows: List[Material], p0, p1, p2, n0, n1, n2, uv0, uv1, uv2,
    material_id: np.ndarray,
) -> tuple[LightTable, np.ndarray]:
    """Declared lights, then one implicit mesh light per emissive material's
    triangle set (``nrc_tpu/scene/scene_builder.py:277-429``): the
    environment first (``Device.cpp:1544``), each emission times its
    multiplier, a spot's half angle ``radians(min(angle, 180) / 2)``, an IES
    profile searched on ``search_paths``. ``light_id`` of an emissive
    triangle indexes the table, after the declared lights."""
    types: List[int] = []
    matrices: List[np.ndarray] = []
    emissions, areas, inv_integrals, spot_half, spot_exp = [], [], [], [], []
    mat_ids: List[int] = []
    tri_start: List[int] = []
    tri_count: List[int] = []
    ies_index: List[int] = []
    ies_textures: List[np.ndarray] = []
    env_texture = env_cdf_u = env_cdf_v = env_cube = None

    def add(ltype, matrix, emission, area=0.0, inv_integral=0.0, sa=45.0, se=0.0, mid=-1,
            ts=0, tc=0, ies=-1):
        types.append(ltype)
        ies_index.append(ies)
        matrices.append(np.asarray(matrix, np.float32))
        emissions.append(emission)
        areas.append(area)
        inv_integrals.append(inv_integral)
        spot_half.append(np.radians(min(sa, 180.0) * 0.5))
        spot_exp.append(se)
        mat_ids.append(mid)
        tri_start.append(ts)
        tri_count.append(tc)

    for ld in sorted(decls, key=lambda l: 0 if l.light_type == "env" else 1):
        emission = tuple(c * ld.multiplier for c in ld.emission)
        if ld.light_type == "env":
            tex, cube = _load_env_texture(tuple(search_paths), ld.texture) if ld.texture else (None, None)
            if tex is not None:
                env_texture, env_cube = tex, cube
                env_cdf_u, env_cdf_v, integral = build_env_cdf(tex)
                if cube is not None:  # the integral over the cube's own texels
                    _, integral = build_cube_env_weights(cube)
                add(TYPE_LIGHT_ENV_SPHERE, ld.matrix, emission if any(emission) else (1.0, 1.0, 1.0),
                    inv_integral=1.0 / integral)
            else:
                add(TYPE_LIGHT_ENV_CONST, ld.matrix, emission if any(emission) else (1.0, 1.0, 1.0))
        elif ld.light_type == "point":
            add(TYPE_LIGHT_POINT, ld.matrix, emission)
        elif ld.light_type == "spot":
            add(TYPE_LIGHT_SPOT, ld.matrix, emission, sa=ld.spot_angle, se=ld.spot_exponent)
        elif ld.light_type == "ies":
            # emissionProfile -> goniometric candela texture
            # (Application.cpp:2042-2052 LoaderIES -> Picture::createIES)
            prof = -1
            for sp in search_paths if ld.profile else ():
                path = os.path.join(sp, ld.profile) if sp else ld.profile
                if os.path.isfile(path):
                    ies_textures.append(ies_to_texture(load_ies(path)))
                    prof = len(ies_textures) - 1
                    break
            add(TYPE_LIGHT_IES, ld.matrix, emission, ies=prof)

    light_id = np.full(material_id.shape[0], -1, np.int32)
    pools = []
    start = 0
    for mid, mat in enumerate(mat_rows):
        if not mat.is_emissive:
            continue
        sel = np.nonzero(material_id == mid)[0]
        if sel.size == 0:
            continue
        cdf, area = build_mesh_light(p0[sel], p1[sel], p2[sel])
        pools.append((p0[sel], p1[sel], p2[sel], n0[sel], n1[sel], n2[sel], cdf,
                      uv0[sel], uv1[sel], uv2[sel]))
        light_id[sel] = len(types)
        add(TYPE_LIGHT_MESH, np.eye(4), (1.0, 1.0, 1.0), area=area, mid=mid, ts=start, tc=sel.shape[0])
        start += sel.shape[0]
    if not types:
        return empty_light_table(), light_id

    def cat(k, width):
        if not pools:
            return np.zeros((0, width) if width else (0,), np.float32)
        return np.concatenate([pool[k] for pool in pools])

    mats = np.stack(matrices)
    table = LightTable(
        type=np.asarray(types, np.int32),
        matrix=mats,
        matrix_inv=np.stack([np.linalg.inv(m) for m in mats]).astype(np.float32),
        emission=np.asarray(emissions, np.float32),
        area=np.asarray(areas, np.float32),
        inv_integral=np.asarray(inv_integrals, np.float32),
        spot_angle_half=np.asarray(spot_half, np.float32),
        spot_exponent=np.asarray(spot_exp, np.float32),
        material_id=np.asarray(mat_ids, np.int32),
        tri_start=np.asarray(tri_start, np.int32),
        tri_count=np.asarray(tri_count, np.int32),
        mesh_p0=cat(0, 3), mesh_p1=cat(1, 3), mesh_p2=cat(2, 3),
        mesh_n0=cat(3, 3), mesh_n1=cat(4, 3), mesh_n2=cat(5, 3),
        mesh_cdf=cat(6, 0),
        mesh_uv0=cat(7, 2), mesh_uv1=cat(8, 2), mesh_uv2=cat(9, 2),
        env_texture=env_texture, env_cdf_u=env_cdf_u, env_cdf_v=env_cdf_v, env_cube=env_cube,
        ies_texture=np.stack(ies_textures) if ies_textures else None,
        ies_index=np.asarray(ies_index, np.int32),
    )
    return table, light_id


def _load_env_texture(search_paths: Tuple[str, ...], filename: str):
    """An env map file -> (equirect [H, W, 3], cube [6, Hc, Wc, 3] or None),
    the first found on the search paths (``nrc_tpu/scene/scene_builder.py:
    432-460``). A Radiance ``.hdr`` loads as the lat-long map; a file that
    does not load gives (None, None), and the light becomes a constant
    environment. DDS cube maps are not ported yet."""
    for sp in search_paths + ("",):
        path = os.path.join(sp, filename) if sp else filename
        if not os.path.isfile(path):
            continue
        if path.lower().endswith(".dds"):
            raise NotImplementedError(
                f"{path}: DDS environment maps are not ported yet (ROADMAP Queue 1 item 4, dds_loader)"
            )
        try:
            return load_radiance_hdr(path), None
        except (OSError, ValueError):
            return None, None
    return None, None


def _equirect_from_cube(cube: np.ndarray, height: int = 0) -> np.ndarray:
    """A lat-long proxy [h, 2h, 3] of a cube map, bilinear through
    ``ops/texture.py::sample_cube_env`` on the CPU (display only: the
    importance tables and MIS pdfs come from the faces)."""
    from ..ops.texture import sample_cube_env

    h = height or max(2 * cube.shape[1], 8)
    w = 2 * h
    theta = (np.arange(h) + 0.5) / h * np.pi
    phi = (np.arange(w) + 0.5) / w * 2.0 * np.pi
    st = np.sin(theta)[:, None]
    # the env sampler's object-space mapping (light_sample.cu:95-106)
    d = np.stack(
        [np.sin(phi)[None, :] * st, np.broadcast_to(-np.cos(theta)[:, None], (h, w)),
         -np.cos(phi)[None, :] * st],
        axis=-1,
    ).reshape(-1, 3)
    out = sample_cube_env(torch.from_numpy(np.ascontiguousarray(cube, np.float32)),
                          torch.from_numpy(d.astype(np.float32)))
    return out.numpy().reshape(h, w, 3).astype(np.float32)


def assemble_scene(
    models: Sequence[ModelDecl],
    materials: Dict[str, Material],
    camera: Camera,
    lights: Sequence[LightDecl] = (),
    search_paths: Sequence[str] = (),
) -> Scene:
    """Flatten declared models into one world-space triangle soup, as
    ``nrc_tpu/scene/scene_builder.py::build_scene`` does, and build the
    light table: the declared ``lights`` (files found on ``search_paths``)
    and the mesh lights. ``materials`` keeps its insertion order as
    material ids."""
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
    light_table, light_id = build_lights(
        lights, search_paths, mat_rows, p0, p1, p2, n0, n1, n2, uv0, uv1, uv2, material_id
    )
    return Scene(
        p0=p0, p1=p1, p2=p2, n0=n0, n1=n1, n2=n2, uv0=uv0, uv1=uv1, uv2=uv2,
        material_id=material_id,
        light_id=light_id,
        materials=MaterialTable.build(mat_rows),
        material_rows=mat_rows,
        lights=light_table,
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


def _cornell_scene(models, materials, cam, resolution, lights=(), search_paths=()) -> tuple[Scene, SystemConfig]:
    system = SystemConfig(
        resolution=tuple(resolution),
        tile_size=(16, 16),
        samples_sqrt=1,
        path_lengths=(2, 6),
        center=cam["center"],
        camera=(cam["phi"], cam["theta"], cam["fov"], cam["distance"]),
        search_paths=tuple(search_paths),
    )
    camera = Camera(aspect=resolution[0] / max(resolution[1], 1), **cam)
    return assemble_scene(models, materials, camera, lights, search_paths), system


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


# ---------------------------------------------------------------------------
# Declared lights and textures
# ---------------------------------------------------------------------------

IES_PROFILE = "cornell_lights.ies"


def write_ies_profile(path: str) -> None:
    """An LM-63-2002 Type C profile: vertical angles 0-180 degrees in 10
    degree steps, horizontal angles 0, 90 and 180 (bilateral symmetry,
    mirrored to 360 on load); the candela falls from 1 at the nadir as
    cos^1.5 to 0 at the horizon and is 0 above it, 30 % lower across the
    0-180 plane at 90 degrees than along it."""
    v = np.arange(0, 181, 10)
    h = np.asarray([0, 90, 180])
    fall = np.where(v < 90, np.cos(np.radians(np.minimum(v, 90))) ** 1.5, 0.0)
    cd = np.stack([fall * (1.0 - 0.3 * math.sin(math.radians(a))) for a in h])
    lines = [
        "IESNA:LM-63-2002",
        "[TEST] nrc_tpu_torch cornell_lights",
        "[LUMINAIRE] a downlight with a bilateral profile",
        "TILT=NONE",
        f"1 1000 1 {v.size} {h.size} 1 1 0 0 0",
        "1 1 100",
        " ".join(str(int(a)) for a in v),
        " ".join(str(int(a)) for a in h),
    ] + [" ".join(f"{c:.6f}" for c in row) for row in cd]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def cornell_lights_declarations(directory: str) -> tuple[
    List[ModelDecl], Dict[str, Material], dict, List[LightDecl]
]:
    """The Cornell box (its ceiling area light kept) with three declared
    lights, all four in one uniform light pick: a warm point light at
    (-5, 6, 2); a spot light at (5, 8, 0), 60 degree full cone, exponent 2,
    its local +z turned to face down; and an IES light at (0, 6, -5) facing
    down (the profile's nadir is local -y) with ``write_ies_profile``'s
    profile, written into ``directory``. Intensities about a third of the
    area light's on-axis 509 W/sr (radiance 100 / pi over 16 units of
    area), so each type carries a visible share. Mesh lights follow the
    declared ones in the table: light 3 is the ceiling. ``directory`` is
    made if it does not exist."""
    models, materials, cam = cornell_box_declarations()
    os.makedirs(directory, exist_ok=True)
    write_ies_profile(os.path.join(directory, IES_PROFILE))
    lights = [
        LightDecl("point", _translate(-5, 6, 2), (180.0, 160.0, 130.0), 1.0),
        LightDecl("spot", _translate(5, 8, 0) @ _rotate(0, 90), (130.0, 160.0, 190.0), 1.0,
                  spot_angle=60.0, spot_exponent=2.0),
        LightDecl("ies", _translate(0, 6, -5), (170.0, 170.0, 170.0), 1.0, profile=IES_PROFILE),
    ]
    return models, materials, cam, lights


def cornell_lights(resolution: Tuple[int, int] = (320, 320),
                   directory: Optional[str] = None) -> tuple[Scene, SystemConfig]:
    """The Cornell box with a point, a spot and an IES light beside its area
    light (``cornell_lights_declarations``), 1224 triangles, brute force;
    system settings as ``cornell_box``'s. The IES profile is written into
    ``directory``, the scene's search path; when None, into a temporary
    directory that is removed once the scene has read it."""
    if directory is None:
        with tempfile.TemporaryDirectory(prefix="nrc_scene_") as directory:
            return cornell_lights(resolution, directory)
    models, materials, cam, lights = cornell_lights_declarations(directory)
    return _cornell_scene(models, materials, cam, resolution, lights, (directory,))


ENV_SIZE = (1024, 512)  # the equirect map's width and height
SUN_RADIANCE = 20000.0  # the sun disc's radiance, sky radiance about 1
SUN_DIR = (35.0, 120.0)  # elevation and azimuth (degrees) of the sun


def sky_map(width: int, height: int) -> np.ndarray:
    """A lat-long sky [height, width, 3], row 0 the zenith: a gradient from
    a pale horizon to a deeper zenith blue, a dim ground below the horizon,
    and a sun disc 2 degrees across at ``SUN_DIR``, ``SUN_RADIANCE`` bright
    (each texel near it holds the disc's share of 8 x 8 sub-samples, so the
    disc shows at any width)."""
    elev = (0.5 - (np.arange(height) + 0.5) / height) * np.pi  # +pi/2 at row 0
    up = np.clip(np.sin(elev), 0.0, 1.0)[:, None]
    horizon, zenith = np.asarray([1.1, 1.15, 1.2]), np.asarray([0.25, 0.45, 0.9])
    sky = horizon + (zenith - horizon) * up ** 0.6
    sky = np.where((elev < 0.0)[:, None], np.asarray([0.12, 0.1, 0.08]), sky)
    img = np.broadcast_to(sky[:, None, :], (height, width, 3)).copy()

    def direction(el, az):  # the env sampler's object space: u = 0 on -z
        el, az = np.broadcast_arrays(el, az)
        return np.stack([np.cos(el) * np.sin(az), np.sin(el), -np.cos(el) * np.cos(az)], axis=-1)

    el_s, az_s = np.radians(SUN_DIR[0]), np.radians(SUN_DIR[1])
    sun = direction(el_s, az_s)
    radius = np.radians(1.0)
    texel = np.pi / height
    rows = np.nonzero(np.abs(elev - el_s) < radius + 2 * texel)[0]
    span = (radius + 2 * texel) / max(np.cos(el_s), 1e-3)
    az = (np.arange(width) + 0.5) / width * 2.0 * np.pi
    cols = np.nonzero(np.abs((az - az_s + np.pi) % (2 * np.pi) - np.pi) < span)[0]
    sub = (np.arange(8) + 0.5) / 8.0
    for r in rows:
        for c in cols:
            el = (0.5 - (r + sub[:, None]) / height) * np.pi
            a = (c + sub[None, :]) / width * 2.0 * np.pi
            inside = direction(el, a) @ sun >= math.cos(radius)
            img[r, c] += SUN_RADIANCE * inside.mean()
    return img.astype(np.float32)


def _write_textures(directory: str) -> Dict[str, str]:
    """The env_textured scene's PNG textures -> their paths."""
    n = 128
    y, x = np.mgrid[0:n, 0:n]
    checker = np.where(((x // 16) + (y // 16)) % 2 == 0, 200, 60)[..., None] * np.asarray([1.0, 0.95, 0.85])
    panel = np.stack([40 + 160 * x / n, 90 + 0 * x, 200 - 150 * y / n], axis=-1)
    cx, cy = (x % 32) - 15.5, (y % 32) - 15.5
    holes = np.where(cx * cx + cy * cy < 10.0 ** 2, 0, 255)[..., None].repeat(3, axis=-1)
    r = np.hypot(x - n / 2, y - n / 2) / (n / 2)
    emitter = np.stack([255 * np.clip(1.2 - r, 0, 1), 180 + 60 * np.cos(6 * r), 90 + 100 * x / n], axis=-1)
    paths = {}
    for name, img in (("checker", checker), ("panel", panel), ("holes", holes), ("emitter", emitter)):
        paths[name] = os.path.join(directory, f"env_textured_{name}.png")
        write_png(paths[name], np.clip(img, 0, 255).astype(np.uint8))
    return paths


def env_textured_declarations(directory: str, env: str = "equirect",
                              env_size: Tuple[int, int] = ENV_SIZE) -> tuple[
    List[ModelDecl], Dict[str, Material], dict, List[LightDecl]
]:
    """An open scene under an environment, its files written into
    ``directory``:

    - a 40 x 40 floor (8 x 8 tessellated) with a checker albedo texture
      repeated 4 x 4 (uv scale);
    - the Cornell box's two blocks, a diffuse one and a GGX-reflect one;
    - a vertical panel (4 x 4 tessellated, 6 x 10 units) with an albedo
      texture and a cutout texture with round holes (RGB 0 = a hole);
    - a small emissive quad (3 x 3 units, radiant exitance 60) whose
      emission texture makes it a textured mesh-light EDF;
    - ``env="equirect"``: a ``sky_map`` of ``env_size`` (width, height)
      written as an RLE Radiance ``.hdr`` (the sun several thousand times
      brighter than the sky, so the alias table is far from uniform);
      ``env="constant"``: a constant environment of radiance (0.8, 0.9, 1.0).

    The camera looks down at the scene from above the horizon, so most
    paths escape to the environment. ``directory`` is made if it does not
    exist."""
    os.makedirs(directory, exist_ok=True)
    tex = _write_textures(directory)
    materials = {
        "floor": Material(name="floor", albedo=(0.9, 0.9, 0.9), albedo_tex_path=tex["checker"],
                          uv_scale=(4.0, 4.0)),
        "white": Material(name="white", albedo=(0.8, 0.8, 0.8)),
        "glossy": Material(name="glossy", archetype=Archetype.GGX_REFLECT, albedo=(0.9, 0.9, 0.9),
                           roughness=(0.1, 0.1), ior=1.5),
        "panel": Material(name="panel", albedo=(1.0, 1.0, 1.0), albedo_tex_path=tex["panel"],
                          cutout_tex_path=tex["holes"]),
        "lamp": Material(name="lamp", archetype=Archetype.NULL_BSDF, albedo=(0.0, 0.0, 0.0),
                         emission_intensity=(60.0, 60.0, 60.0), emission_mode=EmissionMode.RADIANT_EXITANCE,
                         emission_tex_path=tex["emitter"]),
    }
    models = [
        ModelDecl("plane", (8, 8, 1), _translate(0, -10, 0) @ _scale(20.0), "floor"),
        ModelDecl("box", (), _translate(-4, -4, -3) @ _rotate(1, 20) @ _scale(3, 6, 3), "white"),
        ModelDecl("box", (), _translate(4, -7, 3) @ _rotate(1, -20) @ _scale(3.0), "glossy"),
        ModelDecl("plane", (4, 4, 2), _translate(-9, -5, 5) @ _rotate(1, 30) @ _scale(3, 5, 1), "panel"),
        ModelDecl("plane", (1, 1, 2), _translate(9, -5, -3) @ _rotate(1, -40) @ _scale(1.5), "lamp"),
    ]
    if env == "equirect":
        write_hdr_rle(os.path.join(directory, "env_textured_sky.hdr"), sky_map(*env_size))
        lights = [LightDecl("env", np.eye(4), (1.0, 1.0, 1.0), 1.0, texture="env_textured_sky.hdr")]
    elif env == "constant":
        lights = [LightDecl("env", np.eye(4), (0.8, 0.9, 1.0), 1.0)]
    else:
        raise ValueError(f"env must be 'equirect' or 'constant', not {env!r}")
    camera = dict(center=(0.0, -6.0, 0.0), phi=0.75, theta=0.58, fov=55.0, distance=32.0)
    return models, materials, camera, lights


def env_textured(resolution: Tuple[int, int] = (320, 320), env: str = "equirect",
                 directory: Optional[str] = None,
                 env_size: Tuple[int, int] = ENV_SIZE) -> tuple[Scene, SystemConfig]:
    """The open textured scene (``env_textured_declarations``), brute force;
    system settings as ``cornell_box``'s. Its files go into ``directory``,
    the scene's search path; when None, into a temporary directory that is
    removed once the scene has read them."""
    if directory is None:
        with tempfile.TemporaryDirectory(prefix="nrc_scene_") as directory:
            return env_textured(resolution, env, directory, env_size)
    models, materials, cam, lights = env_textured_declarations(directory, env, env_size)
    return _cornell_scene(models, materials, cam, resolution, lights, (directory,))


# ---------------------------------------------------------------------------
# Layered, measured and noise materials; homogeneous media
# ---------------------------------------------------------------------------

MEASUREMENT = "ggx.npz"  # cornell_materials' baked measurement


def cornell_materials_declarations(directory: str) -> tuple[List[ModelDecl], Dict[str, Material], dict]:
    """The Cornell box (its ceiling area light kept) whose surfaces between
    them carry every blend mode, every modifier mode, a measured BSDF and
    both uses of procedural noise (``ops/layered.py``, ``ops/noise.py``):

    - floor: ``BLEND_FIXED``, a GGX-reflect layer (roughness 0.15, weight
      0.3) over a diffuse base (weight 0.7), ``MOD_DIRECTIONAL`` from white
      at normal incidence to a cool grazing tint, exponent 3;
    - ceiling: ``BLEND_CURVE``, GGX (roughness 0.3) over diffuse, the layer
      weight 0.4 times a 6-point curve from 0.5 at normal incidence to 1 at
      grazing (resampled to ``CURVE_RES``), and ``MOD_CURVE`` on the same
      curve;
    - tall block: ``BLEND_FRESNEL`` (``blend_ior`` 1.5), GGX (roughness
      0.1) over an orange diffuse base, ``MOD_THIN_FILM`` (400 nm, film
      IOR 1.4);
    - back wall: one GGX-reflect lobe (roughness 0.2) under
      ``MOD_FRESNEL_COND`` with gold's n, k at 650, 510 and 440 nm;
    - short block: ``MEASURED``, ``bake_ggx(alpha=0.3)`` (32 x 64) written
      to ``<directory>/ggx.npz``, multiplier 1;
    - left wall: ``NOISE_PERLIN`` tint, 3 octaves, red to orange;
    - right wall: ``NOISE_WORLEY`` tint, dark to light green, with a bump
      of factor 0.3.

    1224 triangles, brute force. ``directory`` is made if it does not exist."""
    models, materials, cam = cornell_box_declarations()
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, MEASUREMENT)
    np.savez(path, reflection=bake_ggx(alpha=0.3).reflection)
    ggx, diffuse = Archetype.GGX_REFLECT, Archetype.DIFFUSE_REFLECTION
    curve = ((0.5, 0.5, 0.55), (0.55, 0.55, 0.6), (0.62, 0.6, 0.66), (0.72, 0.7, 0.75), (0.85, 0.83, 0.88),
             (1.0, 1.0, 1.0))
    mats = {
        "floor": Material(name="floor", archetype=ggx, albedo=(0.9, 0.9, 0.9), roughness=(0.15, 0.15),
                          archetype2=diffuse, albedo2=(0.8, 0.75, 0.7), blend_mode=1, blend_w1=(0.3, 0.3, 0.3),
                          blend_w2=(0.7, 0.7, 0.7), mod_mode=1, mod_a=(1.0, 1.0, 1.0), mod_b=(0.6, 0.7, 0.9),
                          mod_exp=3.0),
        "ceiling": Material(name="ceiling", archetype=ggx, albedo=(0.9, 0.9, 0.9), roughness=(0.3, 0.3),
                            archetype2=diffuse, albedo2=(0.8, 0.8, 0.8), blend_mode=3, blend_w1=(0.4, 0.4, 0.4),
                            curve_values=curve, mod_mode=4),
        "light": materials["light"],
        "back": Material(name="back", archetype=ggx, albedo=(1.0, 1.0, 1.0), roughness=(0.2, 0.2), mod_mode=2,
                         mod_a=(0.143, 0.374, 1.442), mod_b=(3.983, 2.385, 1.603)),
        "left": Material(name="left", albedo=(0.8, 0.05, 0.05), noise_mode=1, noise_color1=(0.8, 0.1, 0.05),
                         noise_color2=(0.9, 0.6, 0.2), noise_scale=(0.4, 0.4, 0.4), noise_levels=3),
        "right": Material(name="right", albedo=(0.05, 0.8, 0.05), noise_mode=3, noise_color1=(0.05, 0.3, 0.05),
                          noise_color2=(0.3, 0.8, 0.3), noise_scale=(0.5, 0.5, 0.5), noise_bump_factor=0.3),
        "tall": Material(name="tall", archetype=ggx, albedo=(1.0, 1.0, 1.0), roughness=(0.1, 0.1),
                         archetype2=diffuse, albedo2=(0.7, 0.45, 0.2), blend_mode=2, blend_ior=1.5,
                         mod_mode=3, mod_a=(1.4, 1.4, 1.4), mod_exp=400.0),
        "short": Material(name="short", archetype=Archetype.MEASURED, albedo=(1.0, 1.0, 1.0), mbsdf_path=path,
                          mbsdf_multiplier=1.0),
    }
    surfaces = ("floor", "ceiling", "light", "back", "left", "right", "tall", "short")
    models = [dataclasses.replace(m, material=name) for m, name in zip(models, surfaces)]
    return models, mats, cam


def cornell_materials(resolution: Tuple[int, int] = (320, 320),
                      directory: Optional[str] = None) -> tuple[Scene, SystemConfig]:
    """The Cornell box of layered, modified, measured and noise materials
    (``cornell_materials_declarations``); system settings as
    ``cornell_box``'s. The measurement is written into ``directory``; when
    None, into a temporary directory that is removed once the scene has
    read it (the table keeps the loaded measurement)."""
    if directory is None:
        with tempfile.TemporaryDirectory(prefix="nrc_scene_") as directory:
            return cornell_materials(resolution, directory)
    return _cornell_scene(*cornell_materials_declarations(directory), resolution, (), (directory,))


def cornell_volume_declarations() -> tuple[List[ModelDecl], Dict[str, Material], dict]:
    """The Cornell box's walls and light with two media in its blocks:

    - the tall block (6 units across) a scattering medium behind a
      dielectric boundary (``SPECULAR_REFLECT_TRANSMIT``, IOR 1.33):
      sigma_s (0.95, 0.8, 0.6), sigma_a (0.02, 0.03, 0.05): mean free paths
      1 / sigma_t of 1.03, 1.20 and 1.54 units (1.22 at the channels' mean
      sigma_t), about a fifth of its width; Henyey-Greenstein g 0.6
      (``volume_bias``), forward scattering: a subsurface-like glow;
    - the short block an absorbing medium only (IOR 1.5): sigma_a (0.03,
      0.12, 0.25), sigma_s 0: coloured glass, Beer-Lambert alone.

    The walk length is ``SystemConfig``'s default. 1224 triangles, brute
    force."""
    models, materials, cam = cornell_box_declarations()
    glass = Archetype.SPECULAR_REFLECT_TRANSMIT
    materials = dict(
        materials,
        fog=Material(name="fog", archetype=glass, albedo=(1.0, 1.0, 1.0), ior=1.33, sigma_a=(0.02, 0.03, 0.05),
                     sigma_s=(0.95, 0.8, 0.6), volume_bias=0.6),
        tinted=Material(name="tinted", archetype=glass, albedo=(1.0, 1.0, 1.0), ior=1.5,
                        sigma_a=(0.03, 0.12, 0.25)),
    )
    models = models[:6] + [dataclasses.replace(models[6], material="fog"),
                           dataclasses.replace(models[7], material="tinted")]
    return models, materials, cam


def cornell_volume(resolution: Tuple[int, int] = (320, 320)) -> tuple[Scene, SystemConfig]:
    """The Cornell box with a scattering and an absorbing medium
    (``cornell_volume_declarations``); system settings as ``cornell_box``'s."""
    return _cornell_scene(*cornell_volume_declarations(), resolution)


# ---------------------------------------------------------------------------
# Curves and hair
# ---------------------------------------------------------------------------

HAIR_SEGMENTS = 8      # control-polygon segments a strand: 9 points
HAIR_SUBSEGMENTS = 2   # round cones a B-spline span


@dataclasses.dataclass
class HairDecl:
    """A ``hair`` model of a scene: strands in object space, their material
    and object-to-world matrix, and the cones a B-spline span becomes."""

    hair: HairFile
    material: str
    matrix: np.ndarray  # [4, 4]
    subsegments: int = HAIR_SUBSEGMENTS


def fur_patch(strands: int, seed: int) -> HairFile:
    """``strands`` wavy strands of ``HAIR_SEGMENTS`` segments, 3.2 long,
    rooted on a jittered grid over [-2.7, 2.7]^2 of the plane y = 0, growing
    along +y, as a ``HairFile`` made in code from ``seed``: each
    strand leans by a random tilt and waves about its axis with a random
    phase and amplitude, plus a small random jitter a point; the thickness
    (a diameter, as in ``.hair`` files) tapers from 0.05 at the root to
    0.015 at the tip, and the colour runs from a dark root to a light tip
    with a per-strand shade, so that a segment's colour is interpolated
    along it."""
    rng = np.random.default_rng(seed)
    half_extent, length = 2.7, 3.2
    side = int(math.ceil(math.sqrt(strands)))
    cell = 2.0 * half_extent / side
    k = np.arange(strands)
    roots = np.stack([(k % side + 0.5) * cell - half_extent, np.zeros(strands),
                      (k // side + 0.5) * cell - half_extent], -1)
    roots[:, [0, 2]] += rng.uniform(-0.4, 0.4, (strands, 2)) * cell
    v = HAIR_SEGMENTS + 1
    s = np.linspace(0.0, 1.0, v)                                    # [V] along the strand
    tilt = rng.normal(0.0, 0.25, (strands, 2))
    phase = rng.uniform(0.0, 2.0 * math.pi, (strands, 2))
    amp = rng.uniform(0.05, 0.2, (strands, 1))
    wave = amp[:, :, None] * np.sin(2.0 * math.pi * 1.5 * s[None, None, :] + phase[:, :, None])  # [S, 2, V]
    pts = np.empty((strands, v, 3))
    pts[..., 1] = length * s[None, :] * (1.0 - 0.15 * np.sum(tilt ** 2, -1, keepdims=True))
    pts[..., 0] = length * s[None, :] * tilt[:, :1] + wave[:, 0] * s[None, :]
    pts[..., 2] = length * s[None, :] * tilt[:, 1:] + wave[:, 1] * s[None, :]
    pts += rng.normal(0.0, 0.01, pts.shape) * s[None, :, None]
    pts += roots[:, None, :]
    thickness = np.broadcast_to(0.05 + (0.015 - 0.05) * s, (strands, v))
    shade = rng.uniform(0.8, 1.2, (strands, 1, 1))
    root_c, tip_c = np.asarray([0.25, 0.13, 0.06]), np.asarray([0.85, 0.62, 0.38])
    color = np.clip(shade * (root_c + (tip_c - root_c) * s[None, :, None]), 0.0, 1.0)
    return HairFile(
        num_strands=strands,
        segments=np.full(strands, HAIR_SEGMENTS, np.uint16),
        points=pts.reshape(-1, 3).astype(np.float32),
        thickness=thickness.reshape(-1).astype(np.float32),
        transparency=np.zeros(strands * v, np.float32),
        color=color.reshape(-1, 3).astype(np.float32),
    )


def cornell_hair_declarations(strands: int = 16384, seed: int = 15) -> tuple[
        List[ModelDecl], Dict[str, Material], dict, HairDecl]:
    """The Cornell box (1224 triangles, brute force) with a patch of fur
    on the top face of its short block, as (models, materials, camera
    parameters, the hair model):

    - ``fur_patch(strands, seed)`` rooted over the block's top face (2.7 of
      its half-extent 3), turned and placed with the block: its matrix is
      the block's translation to the face's centre (4, -4, 3) and its turn
      of -20 degrees about y; ``HAIR_SEGMENTS`` segments a strand, two
      round cones a B-spline span: 16 cones a strand, 262,144 at 16,384
      strands;
    - the material ``Archetype.HAIR`` with a brown absorption (0.42, 0.70,
      1.37) (Chiang et al.'s table for a brown eumelanin concentration),
      a diffuse weight of 0.2, albedo (0.9, 0.8, 0.7) as the diffuse tint
      (times the strands' colour), and the default roughness and cuticle
      angle;
    - the box's camera angles (phi, theta) = (0.750781, 0.5), level with
      the fur through the box's open front: centre (4, -2.4, 3), fov 40,
      distance 14; 30.8 % of a 64 x 64 grid of pixel centres hit a fibre
      first at 16,384 strands."""
    models, materials, _ = cornell_box_declarations()
    materials = dict(materials, hair=Material(
        name="hair", archetype=Archetype.HAIR, albedo=(0.9, 0.8, 0.7),
        hair_absorption=(0.42, 0.70, 1.37), hair_diffuse_weight=0.2))
    matrix = _translate(4, -4, 3) @ _rotate(1, -20)
    hair = HairDecl(fur_patch(strands, seed), "hair", matrix)
    camera = dict(center=(4.0, -2.4, 3.0), phi=0.750781, theta=0.5, fov=40.0, distance=14.0)
    return models, materials, camera, hair


def cornell_hair(resolution: Tuple[int, int] = (320, 320), strands: int = 16384,
                 seed: int = 15) -> tuple[Scene, SystemConfig]:
    """The Cornell box with a fur patch on its short block
    (``cornell_hair_declarations``); system settings as ``cornell_box``'s."""
    models, materials, cam, hair = cornell_hair_declarations(strands, seed)
    scene, system = _cornell_scene(models, materials, cam, resolution)
    # the B-spline tessellation, then the model's transform
    seg = hair_to_segments(hair.hair, material_id=list(materials).index(hair.material), subsegments=hair.subsegments)
    scene.curves = transform_segments(seg, hair.matrix)
    return scene, system


SCENES = {
    "cornell_box": cornell_box,
    "cornell_objects": cornell_objects,
    "cornell_glass": cornell_glass,
    "cornell_lights": cornell_lights,
    "env_textured": env_textured,
    "cornell_materials": cornell_materials,
    "cornell_volume": cornell_volume,
    "cornell_hair": cornell_hair,
}


def named_scene(name: str, resolution: Tuple[int, int], **kwargs) -> tuple[Scene, SystemConfig]:
    """A built-in scene by its name in ``SCENES``."""
    return SCENES[name](resolution, **kwargs)
