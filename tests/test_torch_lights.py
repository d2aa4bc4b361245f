"""Port parity for the declared lights: host tables, loaders and sampling.

The host side is numpy on both packages and must be the same bits: the
lat-long CDFs and their Gaussian filter, the cube map's texel solid angles
and weights, the alias tables (the port's native builder and its Python
loop), ``upload_lights``' tables, the LM-63 loader with its symmetry
expansion and candela texture, and the Radiance loader on flat and RLE
files in both orientations. The device side, ``sample_lights`` and
``env_radiance``, runs on numpy-seeded positions, directions and uniforms
through both packages: each light type's samples agree to a few float32
ulps, which is what the bounds below admit. The one discontinuous lookup,
``env_radiance``'s nearest texel, can land in the neighbouring texel when
``atan2``/``acos`` round differently (XLA:CPU and PyTorch differ in the
last ulps): those rays are counted and bounded, as
``test_torch_slice.py`` bounds flipped hits, and held to the same bits
everywhere else.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nrc_tpu.ops import light_sampling as JL
from nrc_tpu.scene import ies as JIES
from nrc_tpu.scene import lights as JLT
from nrc_tpu.scene import scene_builder as JSB
from nrc_tpu.utils.hdr_loader import load_radiance_hdr as jax_load_hdr
from nrc_tpu_torch.ops import light_sampling as PL
from nrc_tpu_torch.render.scene_device import upload_scene
from nrc_tpu_torch.scene import ies as PIES
from nrc_tpu_torch.scene import lights as PLT
from nrc_tpu_torch.scene import scene_builder as PSB
from nrc_tpu_torch.utils.hdr_loader import load_radiance_hdr
from nrc_tpu_torch.utils.image_io import write_hdr, write_hdr_rle
from test_torch_intersect import one_torch_thread  # noqa: F401 (an autouse fixture)

CPU = torch.device("cpu")
N = 4096


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and np.array_equal(_bits(a.astype(b.dtype)), _bits(b))


# ---- host tables ---------------------------------------------------------------


def test_env_cdf_and_filter_bit_for_bit():
    img = PSB.sky_map(64, 32)
    assert _same(PLT.gaussian_filter_3x3(img.mean(-1)), JLT.gaussian_filter_3x3(img.mean(-1)))
    got, ref = PLT.build_env_cdf(img), JLT.build_env_cdf(img)
    assert all(_same(a, b) for a, b in zip(got[:2], ref[:2])) and got[2] == ref[2]


@pytest.mark.parametrize("shape", [(8, 8), (5, 7)])
def test_cube_weights_bit_for_bit(shape):
    cube = np.random.default_rng(1).random((6,) + shape + (3,)).astype(np.float32)
    omega = PLT.cube_texel_solid_angles(*shape)
    assert _same(omega, JLT.cube_texel_solid_angles(*shape))
    np.testing.assert_allclose(omega.sum() * 6, 4 * np.pi, rtol=1e-12)
    (w, i), (jw, ji) = PLT.build_cube_env_weights(cube), JLT.build_cube_env_weights(cube)
    assert _same(w, jw) and i == ji


@pytest.mark.parametrize("n", [1, 37, 524288])
def test_alias_tables_bit_for_bit(n):
    """The native builder, the Python loop and the JAX package's builder give
    the same bits; at 524,288 entries (a 1024 x 512 map) a sun-like spike."""
    w = np.random.default_rng(n).random(n) ** 8
    w[: max(n // 1000, 1)] *= 5000.0
    p, a = PLT.build_alias_table(w)
    jp, ja = JLT.build_alias_table(w)
    assert _same(p, jp) and _same(a, ja)
    if n < 1000:  # the loop is slow at a map's size
        lp, la = PLT.build_alias_table_loop(np.asarray(w, np.float64) * (n / w.sum()))
        assert _same(lp, p) and _same(la, a)


def _cube_table(rng, hc=8):
    """An env-sphere light table over a random cube map (the JAX package's
    cube fields; env_texture the equirect proxy)."""
    cube = (rng.random((6, hc, hc, 3)) * 2.0).astype(np.float32)
    cube[2, 3, 4] = 400.0  # a bright texel on +Y
    _, integral = PLT.build_cube_env_weights(cube)
    rot = PSB._rotate(1, 30).astype(np.float32)[None]
    table = PLT.empty_light_table()
    return dataclasses.replace(
        table, type=np.asarray([PLT.TYPE_LIGHT_ENV_SPHERE], np.int32), matrix=rot,
        matrix_inv=np.linalg.inv(rot).astype(np.float32), emission=np.ones((1, 3), np.float32),
        area=np.zeros(1, np.float32), inv_integral=np.asarray([1.0 / integral], np.float32),
        spot_angle_half=np.zeros(1, np.float32), spot_exponent=np.zeros(1, np.float32),
        material_id=np.full(1, -1, np.int32), tri_start=np.zeros(1, np.int32),
        tri_count=np.zeros(1, np.int32), env_texture=PSB._equirect_from_cube(cube), env_cube=cube,
        ies_index=np.full(1, -1, np.int32),
    )


def test_equirect_from_cube_matches_jax():
    cube = np.random.default_rng(3).random((6, 4, 4, 3)).astype(np.float32)
    np.testing.assert_allclose(PSB._equirect_from_cube(cube), JSB._equirect_from_cube(cube), rtol=0, atol=2e-6)


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """The port's two new scenes (equirect map at 64 x 32 and constant) and a
    cube-map table, their files in one directory."""
    d = str(tmp_path_factory.mktemp("lights"))
    rng = np.random.default_rng(0)
    return {
        "cornell_lights": PSB.cornell_lights((32, 32), d)[0],
        "env_equirect": PSB.env_textured((32, 32), "equirect", d, (64, 32))[0],
        "env_constant": PSB.env_textured((32, 32), "constant", d)[0],
        "env_cube": _cube_table(rng),
    }


def _table(scene):
    return scene if isinstance(scene, PLT.LightTable) else scene.lights


def _radiance(scene):
    """[L, 3] emitted radiance per light (the mesh lights' EDFs)."""
    if isinstance(scene, PLT.LightTable):
        return None
    from nrc_tpu_torch.render.scene_device import _material_arrays

    return _material_arrays(scene)["light_radiance"]


@pytest.mark.parametrize("name", ["cornell_lights", "env_equirect", "env_constant", "env_cube"])
def test_upload_lights_tables_bit_for_bit(scenes, name):
    lt = _table(scenes[name])
    lr = _radiance(scenes[name])
    got = PL.light_tables(lt, lr)
    ref = JL.upload_lights(lt, lr)
    assert got["types_static"] == ref.types_static and got["env_is_cube"] == ref.env_is_cube
    for f in ("light_row", "mesh_row", "mesh_prob", "mesh_alias", "area", "env_alias_pack", "ies_texture"):
        assert _same(got[f], getattr(ref, f)), f
    if ref.env_is_cube:
        assert _same(got["env_pdf"], ref.env_pdf.ravel()) and _same(got["env_cube"], ref.env_cube)
    elif lt.env_texture is not None:
        assert _same(got["env_eval_pack"], ref.env_eval_pack.reshape(-1, 4))
        assert got["env_shape"] == lt.env_texture.shape[:2]


def test_light_table_layouts(scenes):
    """What the scenes declare: cornell_lights' point, spot, IES and then the
    ceiling, the IES light with its profile; env_textured's environment
    first and its textured emitter a mesh light, the alias table of the
    sun far from uniform."""
    cl = scenes["cornell_lights"].lights
    assert cl.type.tolist() == [3, 4, 5, 2] and cl.ies_index.tolist() == [-1, -1, 0, -1]
    assert cl.ies_texture.shape == (1, 128, 256)
    np.testing.assert_allclose(cl.spot_angle_half[1], np.radians(30.0), rtol=1e-7)
    assert (scenes["cornell_lights"].light_id[scenes["cornell_lights"].light_id >= 0] == 3).all()
    eq = scenes["env_equirect"]
    assert eq.lights.type.tolist() == [1, 2] and eq.lights.env_texture.shape == (32, 64, 3)
    assert eq.materials.emission_tex[eq.lights.material_id[1]] >= 0
    intensity = eq.lights.env_texture.mean(-1)
    assert intensity.max() > 1000 * np.median(intensity)
    assert scenes["env_constant"].lights.type.tolist() == [0, 2]


def _jax_tex_ctx(scene):
    """The JAX frame's textured-EDF context (nrc_tpu/render/integrator.py:
    242-256) from the scene's atlas (the same bits in both packages,
    test_torch_textures.py)."""
    l_mid = np.maximum(scene.lights.material_id, 0)
    l_tex = np.where(scene.lights.material_id >= 0, scene.materials.emission_tex[l_mid], -1)
    row = np.concatenate([l_tex.astype(np.float32)[:, None], scene.materials.uv_xf[l_mid]], axis=-1)
    return ({k: jnp.asarray(v) for k, v in scene.materials.atlas.device_arrays().items()}, jnp.asarray(row))


# Per-sample bounds, after the largest reading over the four tables (4096
# samples each): XLA and PyTorch round sqrt, sin/cos, atan2, acos and pow
# differently in the last ulps, and the IES and spot terms carry that.
SAMPLE_LIMITS = {
    "direction_abs": 4e-6,   # 4.6e-7
    "distance_rel": 4e-6,    # 1.2e-7
    "rop_rel": 2e-4,         # 5.0e-5 (cornell_lights: the IES light's bilinear candela)
    "pdf_rel": 1e-5,         # 2.1e-6
}


@pytest.mark.parametrize("name", ["cornell_lights", "env_equirect", "env_constant", "env_cube"])
def test_sample_lights_matches_jax(scenes, name):
    scene = scenes[name]
    lt, lr = _table(scene), _radiance(scene)
    rng = np.random.default_rng(7)
    pos = (rng.random((N, 3)) * np.asarray([18.0, 18.0, 18.0]) - 9.0).astype(np.float32)
    xi = rng.random((N, 4)).astype(np.float32)
    port_lights = PL.upload_lights(lt, lr, CPU)
    textured = not isinstance(scene, PLT.LightTable) and scene.materials.atlas.num_textures > 0
    tex_ctx = None
    if textured:
        dev = upload_scene(scene, CPU)
        tex_ctx = (dev.atlas, dev.nee_tex)
    got = PL.sample_lights(port_lights, torch.from_numpy(pos), torch.from_numpy(xi), tex_ctx=tex_ctx)
    ref = JL.sample_lights(JL.upload_lights(lt, lr), jnp.asarray(pos), jnp.asarray(xi),
                           tex_ctx=_jax_tex_ctx(scene) if textured else None)
    got = [t.numpy() for t in got]
    ref = [np.asarray(t) for t in ref]
    assert np.array_equal(got[4], ref[4])                       # is_singular
    valid = ref[3] > 0
    assert np.array_equal(got[3] > 0, valid) and valid.mean() > 0.3
    picked = np.minimum((xi[:, 0] * len(lt.type)).astype(np.int64), len(lt.type) - 1)
    types_sampled = set(lt.type[picked[valid]].tolist())
    assert types_sampled == set(lt.type.tolist()), "a light type drew no valid sample"

    def rel(a, b):
        return (np.abs(a - b) / np.maximum(np.abs(b), 1e-6)).max()

    readings = {
        "direction_abs": np.abs(got[0] - ref[0])[valid].max(),
        "distance_rel": rel(got[1][valid], ref[1][valid]),
        "rop_rel": rel(got[2][valid], ref[2][valid]),
        "pdf_rel": rel(got[3][valid], ref[3][valid]),
    }
    over = {k: (v, SAMPLE_LIMITS[k]) for k, v in readings.items() if not v <= SAMPLE_LIMITS[k]}
    assert not over, f"readings over their limits: {over}"
    if textured:  # the emitter's texture modulates its samples
        mesh = valid & (lt.type[picked] == PLT.TYPE_LIGHT_MESH)
        assert mesh.any() and np.ptp(got[2][mesh] * got[3][mesh, None]) > 1.0


@pytest.mark.parametrize("name", ["env_equirect", "env_constant", "env_cube"])
def test_env_radiance_matches_jax(scenes, name):
    """Escaping rays: the same texel's radiance and pdf, the same bits; a
    ray whose texel moved to a neighbour (an ulp of atan2 or acos across a
    texel border) is counted: at most 2 of 4096 (read 0)."""
    scene = scenes[name]
    lt, lr = _table(scene), _radiance(scene)
    d = np.random.default_rng(11).normal(size=(N, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    em, pdf, has = PL.env_radiance(PL.upload_lights(lt, lr, CPU), torch.from_numpy(d))
    jem, jpdf, jhas = JL.env_radiance(JL.upload_lights(lt, lr), jnp.asarray(d))
    em, pdf, jem, jpdf = em.numpy(), pdf.numpy(), np.asarray(jem), np.asarray(jpdf)
    assert has and jhas and em.shape == (N, 3)
    moved = _bits(pdf) != _bits(jpdf)
    assert moved.sum() <= 2
    if name == "env_cube":  # bilinear within a face: continuous, an ulp's worth apart
        np.testing.assert_allclose(em[~moved], jem[~moved], rtol=2e-5, atol=1e-6)
    else:
        assert np.array_equal(_bits(em[~moved]), _bits(jem[~moved]))
    assert np.ptp(pdf) > 0 or name == "env_constant"


# ---- loaders ----------------------------------------------------------------


def _write_lm63(path, ptype, v, h, cd, tilt="NONE"):
    lines = ["IESNA:LM-63-1995", "[TEST] written by the test", f"TILT={tilt}"]
    if tilt == "INCLUDE":
        lines += ["1", "2", "0 90", "1 0.5"]
    lines += [f"1 1000 2.5 {len(v)} {len(h)} {ptype} 1 0 0 0", "0.9 1 100",
              " ".join(f"{a:g}" for a in v), " ".join(f"{a:g}" for a in h)]
    lines += [" ".join(f"{c:.4f}" for c in row) for row in cd]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


@pytest.mark.parametrize(
    "case",
    ["scene", "type_c_rotational", "type_c_quadrant", "type_c_bilateral", "type_c_90_270",
     "type_c_full", "type_b_bilateral"],
)
def test_ies_profile_bit_for_bit(tmp_path, case):
    """``load_ies`` and ``ies_to_texture`` on LM-63 files written here, every
    symmetry of ``_expand_symmetry``: the same bits as the JAX package."""
    path = str(tmp_path / "p.ies")
    rng = np.random.default_rng(len(case))
    v = np.arange(0, 181, 10.0)
    if case == "scene":
        PSB.write_ies_profile(path)
    else:
        ptype, h, tilt = {
            "type_c_rotational": (1, [0.0], "NONE"),
            "type_c_quadrant": (1, [0.0, 45.0, 90.0], "INCLUDE"),
            "type_c_bilateral": (1, [0.0, 90.0, 180.0], "NONE"),
            "type_c_90_270": (1, [90.0, 180.0, 270.0], "NONE"),
            "type_c_full": (1, [0.0, 120.0, 240.0, 360.0], "NONE"),
            "type_b_bilateral": (2, [0.0, 45.0, 90.0], "NONE"),
        }[case]
        _write_lm63(path, ptype, v, h, rng.random((len(h), v.size)) * 100, tilt)
    got, ref = PIES.load_ies(path), JIES.load_ies(path)
    for f in dataclasses.fields(ref):
        a, b = getattr(got, f.name), getattr(ref, f.name)
        assert _same(a, b) if isinstance(b, np.ndarray) else a == b, f.name
    for a, b in zip(PIES._expand_symmetry(got), JIES._expand_symmetry(ref)):
        assert _same(a, b)
    tex = PIES.ies_to_texture(got)
    assert _same(tex, JIES.ies_to_texture(ref)) and tex.shape == (128, 256) and tex.max() > 0
    if case == "scene":  # dark above the horizon, brightest at the nadir
        assert (tex[64:] == 0).all() and tex[0].max() == tex.max()


@pytest.mark.parametrize("fmt", ["flat", "rle_top_down", "rle_bottom_up"])
def test_radiance_hdr_bit_for_bit(tmp_path, fmt):
    """Flat and adaptive-RLE scanlines, ``-Y`` and ``+Y``: the JAX package's
    loader reads the same floats, and the file holds the image (rows of
    equal bytes make runs, noise makes literals)."""
    rng = np.random.default_rng(5)
    img = (rng.random((19, 40, 3)) * 8).astype(np.float32)
    img[4:9] = np.asarray([0.5, 2.0, 300.0], np.float32)
    img[0, :3] = 0.0
    path = str(tmp_path / f"{fmt}.hdr")
    if fmt == "flat":
        write_hdr(path, img)
    elif fmt == "rle_top_down":
        write_hdr_rle(path, img)
    else:  # the rows written bottom first, the header saying so
        write_hdr_rle(path, img[::-1])
        data = open(path, "rb").read()
        open(path, "wb").write(data.replace(b"-Y 19 +X 40", b"+Y 19 +X 40", 1))
    got = load_radiance_hdr(path)
    assert _same(got, jax_load_hdr(path)) and got.shape == img.shape
    # RGBE keeps 8 bits of mantissa against a pixel's largest component
    assert (np.abs(got[::-1] - img) <= img.max(axis=-1, keepdims=True) / 128).all()
    if fmt != "flat":
        assert os.path.getsize(path) < img.size * 4 / 3  # the runs shrank the file


def test_dds_environment_is_refused(tmp_path):
    (tmp_path / "sky.dds").write_bytes(b"DDS ")
    decl = PSB.LightDecl("env", np.eye(4), (1.0, 1.0, 1.0), 1.0, texture="sky.dds")
    with pytest.raises(NotImplementedError, match="Queue 1 item 4"):
        PSB.build_lights([decl], (str(tmp_path),), [], *([np.zeros((0, 3), np.float32)] * 6),
                         *([np.zeros((0, 2), np.float32)] * 3), np.zeros(0, np.int32))
