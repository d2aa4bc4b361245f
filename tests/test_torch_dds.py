"""Port parity for the DDS loader and the DDS files a scene names.

``nrc_tpu_torch/scene/dds_loader.py`` is the JAX package's numpy decoder,
so every format must decode to the same float32 bits: BC1 in both colour
modes, BC2, BC3, BC4 and BC5 (legacy FourCCs and DX10 headers, UNORM and
SNORM), DX10 RGBA8 / BGRA8 / float formats, the legacy float FourCCs, the
mask formats (BGRA8, BGR8, R5G6B5, luminance, alpha only), sizes that are
not a multiple of 4, and cube maps with mip chains; files the decoder
refuses are refused by both. The blocks are seeded random bytes, written
under ``tmp_path`` with the header writer of ``tests/test_dds.py``.

Through scene files, a DDS texture (an albedo ``texture_2d`` of an
``.mdl``) and a DDS environment (a 2D map, and a cube map) load in both
packages' ``load_scene``: the material table and the light table are
equal bit for bit, but for a cube map's lat-long proxy and the CDFs built
on it. The JAX package resamples the proxy with its JAX cube sampler, the
port with its torch one, so those are held to ``PROXY_RTOL`` of the
proxy's largest texel.
"""

import struct

import numpy as np
import pytest

from nrc_tpu.scene import dds_loader as JDDS
from nrc_tpu.scene import scene_builder as JSB
from nrc_tpu.scene import texture as JTEX
from nrc_tpu_torch.scene import dds_loader as PDDS
from nrc_tpu_torch.scene import scene_builder as PSB
from nrc_tpu_torch.scene import texture as PTEX
from test_dds import _header
from test_torch_mdl import assert_tables_equal

# the two cube samplers' lat-long proxies: f32 bilinear weights in another
# order of operations; 4 ulp of the largest texel
PROXY_RTOL = 4 * 2.0 ** -23

DX10 = {"BC1": 71, "BC2": 74, "BC3": 77, "BC4": 80, "BC4S": 81, "BC5": 83, "BC5S": 84,
        "rgba8": 28, "bgra8": 87, "rgba32f": 2, "rgba16f": 10, "r32f": 41}
BLOCK_BYTES = {"BC1": 8, "BC2": 16, "BC3": 16, "BC4": 8, "BC4S": 8, "BC5": 16, "BC5S": 16}
TEXEL_BYTES = {"rgba8": 4, "bgra8": 4, "rgba32f": 16, "rgba16f": 8, "r32f": 4}


def payload(rng, fmt, w, h, faces=1, mips=1):
    """Seeded bytes for ``faces`` faces of ``mips`` levels of ``fmt``;
    float formats get finite values."""
    out = b""
    for _ in range(faces):
        lw, lh = w, h
        for _ in range(mips):
            if fmt in BLOCK_BYTES:
                out += rng.bytes(((lw + 3) // 4) * ((lh + 3) // 4) * BLOCK_BYTES[fmt])
            elif fmt == "rgba16f":
                out += rng.uniform(0, 8, lw * lh * 4).astype(np.float16).tobytes()
            elif fmt in ("rgba32f", "r32f"):
                out += rng.uniform(-2, 8, lw * lh * TEXEL_BYTES[fmt] // 4).astype(np.float32).tobytes()
            else:
                out += rng.bytes(lw * lh * TEXEL_BYTES[fmt])
            lw, lh = max(1, lw // 2), max(1, lh // 2)
    return out


def dds_file(fmt, w, h, seed=0, cube=False, mips=1, dx10=False):
    """A DDS file of ``fmt`` (a BC kind, a DXGI name, "legacy:<FourCC or
    code>" or "mask:<bpp>:<flags>:<r,g,b,a>")."""
    rng = np.random.default_rng(seed)
    faces = 6 if cube else 1
    if fmt.startswith("mask:"):
        _, bpp, flags, masks = fmt.split(":")
        masks = tuple(int(m, 16) for m in masks.split(","))
        body = rng.bytes(w * h * int(bpp) // 8 * faces)
        return _header(w, h, bpp=int(bpp), masks=masks, pf_flags=int(flags, 16), cube=cube) + body
    if fmt.startswith("legacy:"):
        cc = fmt.split(":")[1]
        inner = {"DXT1": "BC1", "DXT3": "BC2", "DXT5": "BC3", "ATI1": "BC4", "ATI2": "BC5", "BC4U": "BC4",
                 "BC5U": "BC5", "113": "rgba16f", "114": "r32f", "116": "rgba32f"}[cc]
        fourcc = struct.pack("<I", int(cc)) if cc.isdigit() else cc.encode()
        return _header(w, h, fourcc=fourcc, mipmaps=mips, cube=cube) + payload(rng, inner, w, h, faces, mips)
    head = _header(w, h, fourcc=b"DX10", mipmaps=mips, cube=cube)
    return head + struct.pack("<5I", DX10[fmt], 3, 0, 1, 0) + payload(rng, fmt, w, h, faces, mips)


CASES = {
    **{f"dx10_{k}": (k, 8, 8, {}) for k in DX10},
    **{f"legacy_{cc}": (f"legacy:{cc}", 8, 4, {}) for cc in
       ("DXT1", "DXT3", "DXT5", "ATI1", "ATI2", "BC4U", "BC5U", "113", "114", "116")},
    "mask_bgra8": ("mask:32:41:ff0000,ff00,ff,ff000000", 4, 3, {}),
    "mask_bgr8": ("mask:24:40:ff0000,ff00,ff,0", 5, 2, {}),
    "mask_r5g6b5": ("mask:16:40:f800,7e0,1f,0", 3, 3, {}),
    "mask_a1r5g5b5": ("mask:16:41:7c00,3e0,1f,8000", 4, 4, {}),
    "mask_luminance": ("mask:8:20000:ff,0,0,0", 6, 2, {}),
    "mask_luminance_alpha": ("mask:16:20001:ff,0,0,ff00", 2, 5, {}),
    "mask_alpha": ("mask:8:2:0,0,0,ff", 4, 4, {}),
    "bc1_ragged": ("legacy:DXT1", 6, 3, {}),
    "bc3_ragged_mips": ("BC3", 10, 7, dict(mips=3)),
    "cube_bc1_mips": ("legacy:DXT1", 8, 8, dict(cube=True, mips=4)),
    "cube_rgba16f": ("rgba16f", 4, 4, dict(cube=True, mips=2)),
    "cube_mask": ("mask:32:41:ff0000,ff00,ff,ff000000", 2, 2, dict(cube=True)),
}


def same_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("seed", [0, 1])
def test_decode_equals_jax(tmp_path, case, seed):
    fmt, w, h, kw = CASES[case]
    path = tmp_path / "t.dds"
    path.write_bytes(dds_file(fmt, w, h, seed, **kw))
    got, ref = PDDS.load_dds(str(path)), JDDS.load_dds(str(path))
    assert same_bits(got, ref)
    assert got.shape == ((6,) if kw.get("cube") else ()) + (h, w, 4)
    # as an image: a cube's faces stacked, as the JAX loader stacks them
    assert same_bits(PTEX.load_image_rgba(str(path)), JTEX.load_image_rgba(str(path)))


@pytest.mark.parametrize("raw", [
    b"NOPE" + b"\0" * 200,
    _header(4, 4, fourcc=b"ZZZZ"),
    _header(4, 4, fourcc=b"DX10") + struct.pack("<5I", 99, 3, 0, 1, 0),
    _header(4, 4, pf_flags=0x8),
    b"DDS " + struct.pack("<I", 100) + b"\0" * 160,
])
def test_refused_equally(tmp_path, raw):
    path = tmp_path / "bad.dds"
    path.write_bytes(raw)
    with pytest.raises(ValueError) as got:
        PDDS.load_dds(str(path))
    with pytest.raises(ValueError) as ref:
        JDDS.load_dds(str(path))
    assert str(got.value) == str(ref.value)


TEX_MDL = """mdl 1.4;
import ::df::*;
import ::base::*;
export material tex(uniform texture_2d parTex = texture_2d("albedo.dds", tex::gamma_srgb)) = let {
    base::texture_return t = base::file_texture(texture: parTex);
} in material(
  surface: material_surface(
    scattering: df::diffuse_reflection_bsdf(tint: t.tint)
  )
);
"""


def write_scene(tmp_path, env: str):
    """A system and a scene file: a plane with a DDS albedo texture under a
    DDS environment ``env`` (2D or cube), the files on a search path."""
    data = tmp_path / "data"
    data.mkdir(exist_ok=True)
    (data / "tex.mdl").write_text(TEX_MDL)
    (data / "albedo.dds").write_bytes(dds_file("legacy:DXT1", 16, 8, seed=3))
    if env == "cube":
        (data / "sky.dds").write_bytes(dds_file("rgba16f", 8, 8, seed=4, cube=True, mips=2))
    else:
        (data / "sky.dds").write_bytes(dds_file("rgba32f", 16, 8, seed=5))
    (tmp_path / "system.txt").write_text('resolution 16 16\nsearchPath "data"\n')
    (tmp_path / "scene.txt").write_text(
        'mdl floor tex "tex.mdl"\nemission 0.5 0.5 0.5\nemissionTexture "sky.dds"\nlight env\n'
        "push\nscale 4 4 4\nmodel plane 2 2 1 floor\npop\n")
    return str(tmp_path / "system.txt"), str(tmp_path / "scene.txt")


@pytest.mark.parametrize("env", ["2d", "cube"])
def test_scene_files_with_dds_equal_jax(tmp_path, env):
    system, scene_path = write_scene(tmp_path, env)
    scene, _ = PSB.load_scene(system, scene_path)
    jscene, _ = JSB.load_scene(system, scene_path)
    assert scene.material_report == jscene.material_report
    assert scene.material_rows[0].albedo_tex_path.endswith("albedo.dds")
    assert_tables_equal(scene.materials, jscene.materials)
    assert scene.materials.atlas.device_arrays()["texels"].shape[0] > 16 * 8
    lights, jlights = scene.lights, jscene.lights
    proxy = ("env_texture", "env_cdf_u", "env_cdf_v") if env == "cube" else ()
    for name in vars(lights):
        a, b = getattr(lights, name), getattr(jlights, name)
        if a is None or b is None:
            assert a is None and b is None, name
        elif name in proxy:
            a, b = np.asarray(a), np.asarray(b)
            assert a.shape == b.shape and a.dtype == b.dtype, name
            np.testing.assert_allclose(a, b, rtol=0, atol=PROXY_RTOL * float(np.abs(b).max()), err_msg=name)
        else:
            assert same_bits(a, b), name
    assert (lights.env_cube is not None) == (env == "cube")
    assert lights.type[0] == PSB.TYPE_LIGHT_ENV_SPHERE and lights.inv_integral[0] > 0


def test_cube_proxy_gap_is_measured(tmp_path):
    """The lat-long proxy of a DDS cube: the port's torch sampler against
    the JAX sampler on the same faces, printed, and inside ``PROXY_RTOL``
    of the largest texel."""
    rng = np.random.default_rng(7)
    cube = rng.uniform(0.0, 5.0, (6, 8, 8, 3)).astype(np.float32)
    got = PSB._equirect_from_cube(cube)
    ref = np.asarray(JSB._equirect_from_cube(cube))
    gap = float(np.abs(got - ref).max())
    print(f"cube proxy: largest gap {gap:.3e}, {gap / float(np.abs(ref).max()) / 2.0 ** -23:.2f} ulp of the largest texel")
    assert got.shape == ref.shape == (16, 32, 3) and gap <= PROXY_RTOL * float(np.abs(ref).max())
