"""Port parity: the built-in Cornell box and its device upload.

The port's ``cornell_box()`` declarations are assembled into a ``Scene`` by
both packages (the JAX side with its own geometry builders, material table
and mesh-light assembly); every host table and every uploaded array must be
equal. ``jax_cornell_scene`` is also used by ``test_torch_slice.py``.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

from nrc_tpu.ops.intersect_pallas import build_plane_table as jax_build_plane_table
from nrc_tpu.render.scene_device import upload_scene as jax_upload_scene
from nrc_tpu.scene import geometry as jgeo
from nrc_tpu.scene.camera import Camera as JCamera
from nrc_tpu.scene.materials import Material as JMaterial
from nrc_tpu.scene.materials import MaterialTable as JMaterialTable
from nrc_tpu.scene.parser import LightDecl as JLightDecl
from nrc_tpu.scene.scene_builder import Scene as JScene
from nrc_tpu.scene.scene_builder import _build_lights as jax_build_lights
from nrc_tpu_torch.render.scene_device import mat_row_layout, upload_scene
from nrc_tpu_torch.scene.camera import Camera
from nrc_tpu_torch.scene.materials import Archetype, Material, MaterialTable
from nrc_tpu_torch.scene.scene_builder import (
    LightDecl,
    assemble_scene,
    cornell_box,
    cornell_box_declarations,
)
from test_torch_intersect import planes_from_tpu_layout

CPU = torch.device("cpu")


def jax_cornell_scene(resolution=(32, 32), declarations=cornell_box_declarations, search_paths=()) -> JScene:
    """The JAX package's ``Scene`` for the port's Cornell declarations (or
    another ``declarations()`` of planes and boxes, as ``cornell_glass``'s,
    or one that also returns declared lights, as ``cornell_lights``'s, whose
    files are found on ``search_paths``), built with the JAX package's own
    host code. Material rows and light declarations convert by field name."""
    models, materials, cam, *lights = declarations()
    lights = [JLightDecl(**dataclasses.asdict(ld)) for ld in (lights[0] if lights else [])]
    rows = [JMaterial(**dataclasses.asdict(m)) for m in materials.values()]
    names = list(materials)
    parts = {k: [] for k in ("p0", "p1", "p2", "n0", "n1", "n2", "uv0", "uv1", "uv2", "mat")}
    for decl in models:
        mesh = jgeo.create_plane(*decl.args) if decl.kind == "plane" else jgeo.create_box()
        mesh = jgeo.transform_mesh(mesh, decl.matrix)
        idx = mesh.indices.astype(np.int64)
        for k in range(3):
            parts[f"p{k}"].append(mesh.vertices[idx[:, k]])
            parts[f"n{k}"].append(mesh.normals[idx[:, k]])
            parts[f"uv{k}"].append(mesh.texcoords[idx[:, k]])
        parts["mat"].append(np.full(idx.shape[0], names.index(decl.material), np.int32))
    a = {k: np.concatenate(v) for k, v in parts.items()}
    light_table, light_id = jax_build_lights(
        types.SimpleNamespace(lights=lights), tuple(search_paths), rows,
        a["p0"], a["p1"], a["p2"], a["n0"], a["n1"], a["n2"],
        a["uv0"], a["uv1"], a["uv2"], a["mat"],
    )
    return JScene(
        p0=a["p0"], p1=a["p1"], p2=a["p2"], n0=a["n0"], n1=a["n1"], n2=a["n2"],
        uv0=a["uv0"], uv1=a["uv1"], uv2=a["uv2"],
        material_id=a["mat"], light_id=light_id,
        materials=JMaterialTable.build(rows), material_rows=rows, lights=light_table,
        camera=JCamera(aspect=resolution[0] / resolution[1], **cam),
    )


@pytest.fixture(scope="module")
def scenes():
    scene, system = cornell_box((32, 32))
    return scene, system, jax_cornell_scene((32, 32))


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class TestCornellLayout:
    def test_counts_and_bounds(self, scenes):
        scene, system, _ = scenes
        assert scene.num_triangles == 6 * 200 + 2 * 12
        lo, hi = scene.aabb()
        np.testing.assert_allclose(lo, [-10, -10, -10], atol=1e-4)
        np.testing.assert_allclose(hi, [10, 10, 10], atol=1e-4)
        assert scene.lights.num_lights == 1
        assert scene.lights.area[0] == pytest.approx(16.0, rel=1e-5)
        assert int(np.sum(scene.light_id >= 0)) == 200
        assert system.path_lengths == (2, 6) and system.tile_size == (16, 16)

    def test_emitter_faces_down_at_9_9(self, scenes):
        scene = scenes[0]
        em = scene.light_id >= 0
        np.testing.assert_allclose(scene.p0[em][:, 1], 9.9, atol=1e-5)
        ng = np.cross(scene.p1[em] - scene.p0[em], scene.p2[em] - scene.p0[em])
        assert np.all(ng[:, 1] < 0.0)
        np.testing.assert_allclose(scene.n0[em], [[0.0, -1.0, 0.0]] * 200, atol=1e-6)

    def test_camera(self, scenes):
        scene, _, jscene = scenes
        for a, b in zip(scene.camera.frustum(), jscene.camera.frustum()):
            np.testing.assert_array_equal(a, b)


class TestHostTables:
    def test_geometry_equal(self, scenes):
        scene, _, jscene = scenes
        for f in ("p0", "p1", "p2", "n0", "n1", "n2", "uv0", "uv1", "uv2",
                  "material_id", "light_id"):
            np.testing.assert_array_equal(getattr(scene, f), getattr(jscene, f), err_msg=f)

    def test_material_table_equal(self, scenes):
        scene, _, jscene = scenes
        for f in dataclasses.fields(scene.materials):
            if f.name == "measurements":  # the port's cache of the loaded files
                continue
            a, b = getattr(scene.materials, f.name), getattr(jscene.materials, f.name)
            if f.name in ("atlas", "mbsdf"):  # the texture atlas, the measurement stack: their arrays
                a, b = (a.device_arrays(), b.device_arrays()) if f.name == "atlas" else (vars(a), vars(b))
                assert sorted(a) == sorted(b)
                for k in a:
                    np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            else:
                np.testing.assert_array_equal(a, b, err_msg=f.name)

    def test_light_table_equal(self, scenes):
        scene, _, jscene = scenes
        for f in dataclasses.fields(scene.lights):
            a = getattr(scene.lights, f.name)
            b = getattr(jscene.lights, f.name)
            if a is None:
                assert b is None, f.name
            else:
                np.testing.assert_array_equal(a, b, err_msg=f.name)


class TestUpload:
    def test_arrays_equal_jax_upload(self, scenes):
        scene, _, jscene = scenes
        dev = upload_scene(scene, CPU)
        jdev = jax_upload_scene(jscene)
        np.testing.assert_array_equal(_np(dev.mat_row), _np(jdev.mat_row))
        assert mat_row_layout(dev.mat_curve_k)[1] == jdev.mat_row.shape[1]
        # bit for bit: the last two columns are the bit-cast material and light ids
        np.testing.assert_array_equal(_np(dev.tri_shade).view(np.int32),
                                      _np(jdev.tri_shade).view(np.int32))
        np.testing.assert_array_equal(_np(dev.tri_shade)[:, 24:26].view(np.int32), _np(jdev.tri_meta))
        for f in ("p0", "e1", "e2"):
            np.testing.assert_array_equal(_np(getattr(dev.tris, f)), _np(getattr(jdev.tris, f)))
        jl = jdev.lights
        np.testing.assert_array_equal(_np(dev.lights.light_row), _np(jl.light_row))
        np.testing.assert_array_equal(_np(dev.lights.mesh_row), _np(jl.mesh_row))
        np.testing.assert_array_equal(_np(dev.lights.mesh_prob), _np(jl.mesh_prob))
        np.testing.assert_array_equal(_np(dev.lights.mesh_alias), _np(jl.mesh_alias))
        np.testing.assert_array_equal(_np(dev.lights.area), _np(jl.area))
        assert dev.lights.types_static == jl.types_static

    def test_plane_table_matches_pallas_table(self, scenes):
        scene, _, jscene = scenes
        dev = upload_scene(scene, CPU)
        jplanes = jax_build_plane_table(jax_upload_scene(jscene).tris)
        ref = planes_from_tpu_layout(jplanes)
        # padded columns of the TPU table (Tp = 1536) are all zero
        assert torch.all(ref[scene.num_triangles:] == 0)
        torch.testing.assert_close(dev.planes, ref[: scene.num_triangles], rtol=1e-6, atol=1e-6)

    def test_accepts_the_jax_scene(self, scenes):
        scene, _, jscene = scenes
        a = upload_scene(scene, CPU)
        b = upload_scene(jscene, CPU)
        for f in ("planes", "tri_shade", "mat_row"):
            # as bits: tri_shade's last columns are bit-cast ids (-1 reads as NaN)
            assert torch.equal(getattr(a, f).view(torch.int32), getattr(b, f).view(torch.int32)), f
        assert torch.equal(a.lights.light_row, b.lights.light_row)

    @pytest.mark.parametrize(
        "change",
        [
            dict(archetype=Archetype.HAIR),
            dict(archetype=Archetype.HAIR, archetype2=Archetype.MEASURED),
            dict(archetype2=Archetype.HAIR, blend_mode=1),
            dict(archetype=Archetype.HAIR, sigma_a=(0.1, 0.1, 0.1)),
            dict(archetype2=Archetype.HAIR, mod_mode=2),
            dict(archetype=Archetype.HAIR, noise_mode=1, noise_bump_factor=0.5),
        ],
    )
    def test_unported_materials_raise(self, change):
        """The hair archetype, on either lobe and whatever else the material
        carries, refused before the curves slice, uploads with the JAX
        upload's material row bit for bit; an archetype the port has no BSDF
        for in its place, with the same other fields, is what it refuses."""
        models, materials, cam = cornell_box_declarations()
        materials["white"] = dataclasses.replace(materials["white"], **change)
        scene = assemble_scene(models, materials, Camera(**cam))
        dev = upload_scene(scene, CPU)
        jtable = JMaterialTable.build([JMaterial(**dataclasses.asdict(m)) for m in materials.values()])
        jrow = jax_upload_scene(dataclasses.replace(scene, materials=jtable)).mat_row
        assert torch.equal(dev.mat_row.view(torch.int32), torch.from_numpy(np.asarray(jrow)).view(torch.int32))
        unknown = {k: 42 if v == Archetype.HAIR else v for k, v in change.items()}
        materials["white"] = dataclasses.replace(materials["white"], **unknown)
        scene = assemble_scene(models, materials, Camera(**cam))
        with pytest.raises(NotImplementedError, match=r"archetypes \[42\]"):
            upload_scene(scene, CPU)

    @pytest.mark.parametrize(
        "change",
        [
            dict(archetype=Archetype.MEASURED),
            dict(noise_bump_factor=0.5),
            dict(sigma_a=(0.1, 0.1, 0.1)),
            dict(blend_mode=1),
            dict(noise_mode=1),
        ],
    )
    def test_ported_materials_upload_as_the_jax_package_does(self, change):
        """The materials refused before this slice (a measured archetype,
        noise, a volume, a blend) upload, with the JAX upload's material row
        bit for bit."""
        models, materials, cam = cornell_box_declarations()
        materials["white"] = dataclasses.replace(materials["white"], **change)
        scene = assemble_scene(models, materials, Camera(**cam))
        dev = upload_scene(scene, CPU)
        jtable = JMaterialTable.build([JMaterial(**dataclasses.asdict(m)) for m in materials.values()])
        jrow = jax_upload_scene(dataclasses.replace(scene, materials=jtable)).mat_row
        assert torch.equal(dev.mat_row.view(torch.int32), torch.from_numpy(np.asarray(jrow)).view(torch.int32))

    def test_unported_lights_and_textures_raise(self, tmp_path):
        """What of the lights and textures is not ported: DDS files (an
        environment or a texture; Queue 1 item 4). The constant environment
        and textures, refused before, are ported (tests/test_torch_lights.py,
        test_torch_textures.py), and so are measured BSDFs, whose loader
        refuses a container it does not know as the JAX package's does
        (tests/test_torch_mbsdf.py)."""
        (tmp_path / "sky.dds").write_bytes(b"DDS ")
        models, materials, cam = cornell_box_declarations()
        env = LightDecl("env", np.eye(4), (1.0, 1.0, 1.0), 1.0, texture="sky.dds")
        with pytest.raises(NotImplementedError, match="DDS"):
            assemble_scene(models, materials, Camera(**cam), [env], (str(tmp_path),))
        with pytest.raises(NotImplementedError, match="DDS"):
            MaterialTable.build([Material(albedo_tex_path=str(tmp_path / "sky.dds"))])
        with pytest.raises(ValueError, match="measured"):
            MaterialTable.build([Material(mbsdf_path="paint.mbsdf")])
