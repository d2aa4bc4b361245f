"""Port parity for the textures: the atlas, its lookups and the cube maps.

The atlas is host numpy in both packages and must be the same bits: the
images decoded (PNG through the port's own reader, where the JAX package
uses PIL; Radiance ``.hdr``), the sRGB conversion, the mip chain, the
level descriptors and the 16-wide quad rows, the (path, sRGB) dedup and the
material table's texture ids. The lookups run on numpy-seeded texcoords
through both packages: ``sample_bilinear`` on the quad rows and on a raw
atlas's four corners (id -1 white),
``apply_uv_transform``, ``cube_face_uv`` and its inverse, and
``sample_cube_env``; each bound stands beside its reading.
"""

import dataclasses
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nrc_tpu.ops import texture as JT
from nrc_tpu.scene.materials import Material as JMaterial
from nrc_tpu.scene.materials import MaterialTable as JMaterialTable
from nrc_tpu.scene.texture import TextureAtlas as JAtlas
from nrc_tpu.scene.texture import load_image_rgba as jax_load_image_rgba
from nrc_tpu_torch.ops import texture as PT
from nrc_tpu_torch.scene.materials import Material, MaterialTable
from nrc_tpu_torch.scene.texture import TextureAtlas, load_image_rgba
from nrc_tpu_torch.utils.image_io import write_hdr_rle, write_png
from test_torch_intersect import one_torch_thread  # noqa: F401 (an autouse fixture)

N = 4096


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """PNGs of odd and even sizes (1 x 1 included) and an RLE .hdr."""
    d = tmp_path_factory.mktemp("tex")
    rng = np.random.default_rng(2)
    paths = {}
    for name, shape in (("a", (37, 20)), ("b", (16, 16)), ("c", (1, 1)), ("d", (5, 64))):
        paths[name] = str(d / f"{name}.png")
        write_png(paths[name], rng.integers(0, 256, shape + (3,), dtype=np.uint8))
    paths["h"] = str(d / "h.hdr")
    write_hdr_rle(paths["h"], (rng.random((9, 12, 3)) * 4).astype(np.float32))
    return paths


def _atlases(files):
    atlases = []
    for cls in (TextureAtlas, JAtlas):
        at = cls.empty()
        ids = [at.add(files["a"]), at.add(files["b"], srgb=False), at.add(files["c"]), at.add(files["h"], srgb=False),
               at.add(files["d"]), at.add(files["a"]), at.add(files["a"], srgb=False)]
        atlases.append((at, ids))
    return atlases


def test_atlas_bit_for_bit(files):
    """Decode, sRGB, mips, descriptors and quad rows; a repeated (path,
    sRGB) pair is the same texture, the other gamma another."""
    (pa, pids), (ja, jids) = _atlases(files)
    assert pids == jids == [0, 1, 2, 3, 4, 0, 5]
    got, ref = pa.device_arrays(), ja.device_arrays()
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype and np.array_equal(got[k], ref[k]), k
    assert got["texels_quad"].shape == (got["texels"].shape[0], 16)
    assert pa.tex_num_levels.tolist() == [7, 5, 1, 5, 7, 7]  # 37x20 -> 1x1 in 6 halvings


def test_image_loaders(files, tmp_path):
    rgba = load_image_rgba(files["b"])
    assert rgba.shape == (16, 16, 4) and rgba.dtype == np.float32 and (rgba[..., 3] == 1).all()
    # DDS loads since the scene-file slice (tests/test_torch_dds.py); a file
    # cut after its magic is refused by both packages' decoders alike
    (tmp_path / "x.dds").write_bytes(b"DDS ")
    with pytest.raises(struct.error):
        load_image_rgba(str(tmp_path / "x.dds"))
    with pytest.raises(struct.error):
        jax_load_image_rgba(str(tmp_path / "x.dds"))


def test_material_table_texture_ids(files):
    """The three texture slots resolve into the atlas as the JAX package's
    build does (albedo ids first, then cutout, then emission); a rebuild on
    the same atlas decodes nothing again."""
    rows = [Material(name="m0", albedo_tex_path=files["a"], cutout_tex_path=files["b"]),
            Material(name="m1", emission_tex_path=files["a"], emission_tex_srgb=False, uv_scale=(2.0, 3.0),
                     uv_rotation_z=0.5),
            Material(name="m2", albedo_tex_path=files["c"], cutout_tex_path=files["a"])]
    got = MaterialTable.build(rows)
    ref = JMaterialTable.build([JMaterial(**dataclasses.asdict(m)) for m in rows])
    for f in ("albedo_tex", "cutout_tex", "emission_tex", "uv_xf"):
        assert np.array_equal(getattr(got, f), getattr(ref, f)), f
    assert got.atlas.num_textures == 4
    again = MaterialTable.build(rows, atlas=got.atlas)
    assert again.atlas is got.atlas and again.atlas.num_textures == 4


@pytest.mark.parametrize("quad", [True, False], ids=["quad_rows", "four_corners"])
def test_sample_bilinear_matches_jax(files, quad):
    """Both fetch paths on texcoords outside [0, 1] (wrap) and ids -1 (white):
    at most 2 float32 ulps of the largest texel value apart (read 0: bit for
    bit on this CPU; XLA may fuse the weights' products on another)."""
    (pa, _), _ = _atlases(files)
    arrays = pa.device_arrays()
    if not quad:
        del arrays["texels_quad"]
    rng = np.random.default_rng(4)
    tex_id = rng.integers(-1, pa.num_textures, N).astype(np.int32)
    uv = (rng.random((N, 2)) * 6.0 - 3.0).astype(np.float32)
    port_arrays = {k: torch.from_numpy(v.astype(np.int64) if v.dtype == np.int32 else v) for k, v in arrays.items()}
    got = PT.sample_bilinear(port_arrays, torch.from_numpy(tex_id.astype(np.int64)), torch.from_numpy(uv)).numpy()
    ref = np.asarray(JT.sample_bilinear({k: jnp.asarray(v) for k, v in arrays.items()}, jnp.asarray(tex_id),
                                        jnp.asarray(uv)))
    assert got.shape == (N, 4) and (got[tex_id < 0] == 1.0).all()
    assert np.abs(got - ref).max() <= 2.4e-7 * max(1.0, np.abs(ref).max())
    assert np.ptp(got[tex_id >= 0, 0]) > 0.5


def test_uv_transform_matches_jax():
    rng = np.random.default_rng(6)
    uv = (rng.random((N, 2)) * 4 - 2).astype(np.float32)
    rot = rng.random(N) * 6.3
    xf = np.stack([rng.random(N) * 4, rng.random(N) * 4, rng.random(N) - 0.5, rng.random(N) - 0.5,
                   np.cos(rot), np.sin(rot)], axis=-1).astype(np.float32)
    got = PT.apply_uv_transform(torch.from_numpy(uv), torch.from_numpy(xf)).numpy()
    ref = np.asarray(JT.apply_uv_transform(jnp.asarray(uv), jnp.asarray(xf)))
    assert np.abs(got - ref).max() <= 1e-6  # read 0 (the products may fuse elsewhere)


def test_cube_face_uv_and_inverse_match_jax():
    """Faces bit for bit (axis-aligned and diagonal directions included),
    u and v within an ulp, and the inverse maps back onto the direction."""
    rng = np.random.default_rng(8)
    d = rng.normal(size=(N, 3))
    d[:6] = np.eye(3).repeat(2, axis=0) * np.asarray([1, -1] * 3)[:, None]
    d[6:10] = np.asarray([[1, 1, 0], [-1, 0, -1], [0, 1, -1], [1, 1, 1]])
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    face, u, v = (t.numpy() for t in PT.cube_face_uv(torch.from_numpy(d)))
    jface, ju, jv = (np.asarray(t) for t in JT.cube_face_uv(jnp.asarray(d)))
    assert np.array_equal(face, jface) and set(face.tolist()) == set(range(6))
    assert np.abs(u - ju).max() <= 1.2e-7 and np.abs(v - jv).max() <= 1.2e-7
    back = PT.cube_dir_from_face_uv(torch.from_numpy(face), torch.from_numpy(u), torch.from_numpy(v)).numpy()
    jback = np.asarray(JT.cube_dir_from_face_uv(jnp.asarray(jface), jnp.asarray(ju), jnp.asarray(jv)))
    assert np.abs(back - d).max() <= 1e-6 and np.abs(back - jback).max() <= 2.4e-7


def test_sample_cube_env_matches_jax():
    rng = np.random.default_rng(9)
    cube = rng.random((6, 5, 7, 3)).astype(np.float32)
    d = rng.normal(size=(N, 3)).astype(np.float32)
    got = PT.sample_cube_env(torch.from_numpy(cube), torch.from_numpy(d)).numpy()
    ref = np.asarray(JT.sample_cube_env(jnp.asarray(cube), jnp.asarray(d)))
    assert np.abs(got - ref).max() <= 1e-6  # read 0
