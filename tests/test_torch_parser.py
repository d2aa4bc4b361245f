"""Port parity for the system- and scene-description parsers.

``nrc_tpu_torch/scene/parser.py`` is pure Python and NumPy on both sides,
so the same file must give the same ``SystemConfig`` and the same
declarations, decl for decl, with every matrix bit for bit (no
tolerance). The files are written under ``tmp_path``: every keyword of
both grammars, the transform stack with its push/pop state, the ``hair``
and ``assimp`` model lines (with and without the trailing material),
unknown keywords and model kinds, comments and quoted strings.
"""

import dataclasses
import math

import numpy as np
import pytest

from nrc_tpu.scene import parser as JP
from nrc_tpu_torch.scene import parser as PP

SYSTEM = """# every keyword of Application::loadSystemDescription
strategy 2
devicesMask 3
arenaSize 0           # clamped to 1
interop 1
present 0
peerToPeer 1
resolution 640 360
tileSize 32 8
samplesSqrt 0         # clamped to 1
samplesSqrt 3
pathLengths 1 7
walkLength 0          # clamped to 1
epsilonFactor 250.5
clockFactor 2e3
lensShader 1
center 0.5 -1 2.25
camera 0.1 0.7 40 12.5
prefixScreenshot "shots/frame one"
searchPath "data"
searchPath "/abs/mdl dir"
gamma 2.4
colorBalance 1 0.9 0.8
whitePoint 1.5
burnHighlights 0.6
crushBlacks 0.1
saturation 1.2
brightness 0.9
notAKeyword
"""

SCENE = """# the transform stack, the lights' state and every model kind
mdl white  bsdf_diffuse "mdl/white.mdl"
mdl glass  glass "mdl/glass.mdl"   # trailing comment
emission 1 2 3
emissionMultiplier 4
light env
push
  rotate 0.3 0.4 0.5 37.5
  scale 2 3 4
  translate 1 -2 3
  emissionTexture "sky.hdr"
  light env
  emissionProfile "a.ies"
  spotAngle 60
  spotExponent 2.5
  light spot
  light ies
  light point
  model plane 4 5 1 white
  push
    rotate 1 0 0 -90
    model box glass
    model sphere 16 8 0.75 white
  pop
  model torus 12 6 0.25 1.5 glass
pop
identity
rotate 0 1 0 180
model hair 0.5 white "fur.hair"
model assimp "meshes/bunny.ply" glass
model assimp "meshes/no material.obj"
translate 0 1 0
model assimp "m.fbx"
model cylinder 3 white
lensShader 2
center 1 2 3
camera 0.2 0.3 35 8
gamma 2.2
colorBalance 0.5 0.6 0.7
whitePoint 2
burnHighlights 0.3
crushBlacks 0.4
saturation 0.8
brightness 1.1
unknownStatement
"""


def same(a, b):
    """Equal values, arrays bit for bit (dtype, shape and bytes)."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()
    if dataclasses.is_dataclass(a):
        return type(a).__name__ == type(b).__name__ and all(
            same(getattr(a, f.name), getattr(b, f.name)) for f in dataclasses.fields(a))
    if isinstance(a, (list, tuple)):
        return type(a) is type(b) and len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    return type(a) is type(b) and a == b


def test_tokenizer_equals_jax():
    text = SCENE + '\n"unterminated string\n  a#b "x # y"\n"x # y" ##\n\t-1.5e-3\r\n'
    assert PP.tokenize(text) == JP.tokenize(text)
    assert PP.tokenize(text)[-4:] == ["unterminated string", "a", "x # y", "-1.5e-3"]


@pytest.mark.parametrize("text", [SYSTEM, "", "resolution 8 4\nresolution 16 9\n"])
def test_system_description_equals_jax(tmp_path, text):
    path = tmp_path / "system.txt"
    path.write_text(text)
    got, ref = PP.parse_system_description(str(path)), JP.parse_system_description(str(path))
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    if text == SYSTEM:
        assert got.arena_size_mib == 1 and got.samples_sqrt == 3 and got.walk_length == 1
        assert got.search_paths == ("data", "/abs/mdl dir") and got.prefix_screenshot == "shots/frame one"


@pytest.mark.parametrize("text", [SCENE, "", "push\nscale 1 2 3\nmodel box a\npop\nmodel box b\n"])
def test_scene_description_equals_jax_decl_for_decl(tmp_path, text):
    path = tmp_path / "scene.txt"
    path.write_text(text)
    got, ref = PP.parse_scene_description(str(path)), JP.parse_scene_description(str(path))
    for field in ("materials", "lights", "models"):
        assert len(getattr(got, field)) == len(getattr(ref, field)), field
        for a, b in zip(getattr(got, field), getattr(ref, field)):
            assert [f.name for f in dataclasses.fields(a)] == [f.name for f in dataclasses.fields(b)]
            assert same(a, b), (field, a, b)
    for field in ("lens_shader", "center", "camera"):
        assert getattr(got, field) == getattr(ref, field), field
    assert (got.tonemapper is None) == (ref.tonemapper is None)
    if got.tonemapper is not None:
        assert dataclasses.asdict(got.tonemapper) == dataclasses.asdict(ref.tonemapper)
    if text == SCENE:
        kinds = [m.kind for m in got.models]
        assert kinds == ["plane", "box", "sphere", "torus", "hair", "assimp", "assimp", "assimp"]
        assert [m.material_ref for m in got.models[-3:]] == ["glass", "", ""]
        assert [m.path for m in got.models[4:]] == ["fur.hair", "meshes/bunny.ply", "meshes/no material.obj", "m.fbx"]
        assert [ld.light_type for ld in got.lights] == ["env", "env", "spot", "ies", "point"]
        assert got.lights[2].spot_angle == 60.0 and got.lights[0].texture == ""
        # the stack: the box carries the inner rotation, the torus does not
        outer = got.models[0].matrix
        assert same(got.models[3].matrix, outer)
        assert same(got.models[1].matrix, PP._rotation_matrix(np.array([1.0, 0.0, 0.0]), -90.0) @ outer)


def test_rotation_matrix_equals_jax():
    rng = np.random.default_rng(16)
    axes = [np.eye(3)[i] for i in range(3)] + list(rng.normal(size=(20, 3))) + [np.zeros(3)]
    for axis in axes:
        for angle in (0.0, 20.0, -20.0, 90.0, 180.0, 37.5, float(rng.uniform(-720, 720))):
            assert same(PP._rotation_matrix(axis, angle), JP._rotation_matrix(axis, angle))


def test_transform_stack_premultiplies(tmp_path):
    """A transform line multiplies on the left of the matrix so far: scale,
    then rotate, then translate places an object as T @ R @ S."""
    text = "scale 2 3 4\nrotate 0 0 1 90\ntranslate 5 6 7\nmodel box m\n"
    ts = PP.TokenStream(PP.tokenize(text))
    assert ts.peek() == "scale" and ts.next() == "scale" and ts.next_float() == 2.0
    assert ts.next_int() == 3 and not ts.eof()
    (tmp_path / "scene.txt").write_text(text)
    m = PP.parse_scene_description(str(tmp_path / "scene.txt")).models[0].matrix
    t = np.eye(4)
    t[:3, 3] = (5, 6, 7)
    expect = t @ PP._rotation_matrix(np.array([0.0, 0.0, 1.0]), 90.0) @ np.diag([2.0, 3.0, 4.0, 1.0])
    np.testing.assert_allclose(m, expect, atol=1e-12)
    assert math.isclose(m[0, 1], -3.0) and math.isclose(m[1, 0], 2.0)


def test_decls_are_the_port_only_declarations():
    """The scene builder declares its models and lights with the parser's
    classes: one ``ModelDecl`` and one ``LightDecl`` in the port, with the
    JAX field names."""
    from nrc_tpu_torch.scene import scene_builder as SB

    assert SB.ModelDecl is PP.ModelDecl and SB.LightDecl is PP.LightDecl
    for cls, jcls in ((PP.ModelDecl, JP.ModelDecl), (PP.LightDecl, JP.LightDecl),
                      (PP.MaterialDecl, JP.MaterialDecl), (PP.SceneDescription, JP.SceneDescription)):
        assert [f.name for f in dataclasses.fields(cls)] == [f.name for f in dataclasses.fields(jcls)]
    models, _, _ = SB.cornell_box_declarations()
    assert all(isinstance(m, PP.ModelDecl) for m in models)
