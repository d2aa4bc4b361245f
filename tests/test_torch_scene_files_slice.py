"""Port parity for the scene-file slice: the Cornell box read from files.

``scene_builder.write_cornell_box_files`` writes ``cornell_box()`` in the
reference's grammar under ``tmp_path``: a system file, a scene file with
the transform stack, five ``.mdl`` files on a search path and the back
wall as an ``assimp`` OBJ. Then:

- the port's ``load_scene`` against the JAX package's, field for field:
  the triangle arrays, the material rows and table, the light table, the
  camera and the load report bit for bit (the two sides' code is the same
  numpy);
- the loaded scene against ``cornell_box()``: the triangle arrays are bit
  for bit the in-code ones (the parser's axis-angle rotations of 20 and
  180 degrees round as the builders' per-axis ones), the materials equal
  but for the emitter's albedo (an ``.mdl`` without ``scattering`` reads as
  ``NULL_BSDF`` with the default albedo 1, the in-code emitter says 0), and
  the frames of both, FULL + train, are bit for bit equal: the albedo of a
  null BSDF enters no frame;
- ``cli.main`` on the files with ``--device cpu``: the PNG is written and
  the render state it saves holds the image of a ``Renderer`` on the
  loaded scene, bit for bit; a render state the JAX package wrote resumes;
- a loaded frame against the JAX frame on the JAX-loaded scene, in FULL and
  NO_CACHE, under ``tests/test_torch_slice.py``'s ``LIMITS`` with its
  recording machinery (the JAX plane kernels with ``interpret=True``, in
  this process, as ``test_torch_slice.py`` runs them);
- the models both loaders drop without a word: an ``assimp`` file that is
  missing or does not parse, an unknown model kind and a ``hair`` model
  whose file is on no search path; a ``hair`` model that is found loads
  the JAX package's segments bit for bit.
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from nrc_tpu.models import checkpoint as JC
from nrc_tpu.render.renderer import Renderer as JRenderer
from nrc_tpu.scene import scene_builder as JSB
from nrc_tpu_torch.app import cli
from nrc_tpu_torch.config import RenderMode
from nrc_tpu_torch.models.checkpoint import load_render_state
from nrc_tpu_torch.models.network import state_from_numpy, state_to_numpy
from nrc_tpu_torch.render.renderer import Renderer
from nrc_tpu_torch.scene import scene_builder as PSB
from test_torch_hair import write_hair
from test_torch_intersect import one_torch_thread  # noqa: F401 (an autouse fixture)
from test_torch_mdl import assert_tables_equal, same_material
from test_torch_slice import LIMITS, RES, _interpret_plane_intersectors, frame_readings, recording_frames

TRIANGLE_FIELDS = PSB.TRIANGLE_FIELDS + ("material_id", "light_id")


def same_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def assert_scenes_equal(scene, jscene):
    """A port ``Scene`` and a JAX ``Scene``, field for field, bit for bit."""
    for f in TRIANGLE_FIELDS:
        assert same_bits(getattr(scene, f), getattr(jscene, f)), f
    assert len(scene.material_rows) == len(jscene.material_rows)
    for a, b in zip(scene.material_rows, jscene.material_rows):
        same_material(a, b)
    assert_tables_equal(scene.materials, jscene.materials)
    for name in vars(scene.lights):
        a, b = getattr(scene.lights, name), getattr(jscene.lights, name)
        assert (a is None) == (b is None) and (a is None or same_bits(a, b)), name
    assert dataclasses.asdict(scene.camera) == dataclasses.asdict(jscene.camera)
    assert scene.lens_shader == jscene.lens_shader
    assert scene.material_report == jscene.material_report
    assert scene.material_load_warnings() == jscene.material_load_warnings()
    assert (scene.curves is None) == (jscene.curves is None)
    if scene.curves is not None:
        for f in dataclasses.fields(scene.curves):
            assert same_bits(getattr(scene.curves, f.name), getattr(jscene.curves, f.name)), f.name


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return PSB.write_cornell_box_files(str(tmp_path_factory.mktemp("cornell")), RES)


def test_load_scene_equals_jax(files):
    scene, system = PSB.load_scene(*files)
    jscene, jsystem = JSB.load_scene(*files)
    assert_scenes_equal(scene, jscene)
    assert dataclasses.asdict(system) == dataclasses.asdict(jsystem)
    assert [e["status"] for e in scene.material_report] == ["ok"] * 5 and not scene.material_load_warnings()


def test_loaded_scene_is_cornell_box(files):
    scene, system = PSB.load_scene(*files)
    box, box_system = PSB.cornell_box(RES)
    for f in TRIANGLE_FIELDS:
        assert same_bits(getattr(scene, f), getattr(box, f)), f
    for a, b in zip(scene.material_rows, box.material_rows):
        if a.name == "light":  # no scattering: NULL_BSDF with the default albedo
            assert (a.albedo, b.albedo) == ((1.0, 1.0, 1.0), (0.0, 0.0, 0.0))
            a = dataclasses.replace(a, albedo=b.albedo)
        same_material(a, b)
    for name in vars(scene.lights):
        a, b = getattr(scene.lights, name), getattr(box.lights, name)
        assert (a is None) == (b is None) and (a is None or same_bits(a, b)), name
    assert scene.camera == box.camera and scene.lens_shader == box.lens_shader
    assert system.search_paths == ("mdl",) and box_system.search_paths == ()
    assert dataclasses.replace(system, search_paths=()) == box_system


def test_loaded_frames_equal_cornell_box_frames(files):
    """Three FULL + train frames on the loaded scene and on ``cornell_box()``
    from the same seed: images, losses and record counts bit for bit."""
    renderers = [Renderer(*PSB.load_scene(*files), device="cpu"), Renderer(*PSB.cornell_box(RES), device="cpu")]
    for _ in range(3):
        stats = [r.render_frame() for r in renderers]
        assert torch.equal(renderers[0].image, renderers[1].image)
        assert torch.equal(stats[0].loss, stats[1].loss)
        assert int(stats[0].num_train_records) == int(stats[1].num_train_records)
    states = [state_to_numpy(r.net_state) for r in renderers]
    assert all(np.array_equal(states[0][k], states[1][k]) for k in states[1])


def test_cli_renders_the_files(files, tmp_path, capsys):
    out = str(tmp_path / "shots" / "cornell")
    os.makedirs(os.path.dirname(out))
    state = str(tmp_path / "state.npz")
    assert cli.main(["-s", files[0], "-d", files[1], "-m", "1", "-w", "32", "-h", "32", "--spp", "2",
                     "--device", "cpu", "--output", out, "--checkpoint", state,
                     "--stats-log", str(tmp_path / "stats.jsonl")]) == 0
    printed = capsys.readouterr().out
    assert "materials: 5/5 resolved" in printed and "2 spp in " in printed and "M cache queries/s" in printed
    assert os.path.getsize(out + "_2spp.png") > 0
    assert len(open(tmp_path / "stats.jsonl").read().splitlines()) == 2
    r = Renderer(*PSB.load_scene(*files), device="cpu")
    r.render(2)
    with np.load(state) as z:
        assert np.array_equal(z["render.image"], r.image.numpy())
        assert int(z["render.iteration"]) == 2


def test_cli_resumes_a_jax_render_state(files, tmp_path, capsys):
    """A render state the JAX package saved (its renderer on the JAX-loaded
    scene) loads through ``--resume``: the network goes on from the JAX
    weights (``--no-train`` keeps them) and the counters from the file's."""
    jscene, jsystem = JSB.load_scene(*files)
    jr = JRenderer(jscene, jsystem, train=False)
    jpath = JC.save_render_state(str(tmp_path / "jax_state"), jr)
    state = str(tmp_path / "port_state.npz")
    cli.main(["-s", files[0], "-d", files[1], "-m", "1", "--spp", "1", "--no-train", "--device", "cpu",
              "--output", str(tmp_path / "resumed"), "--resume", jpath, "--checkpoint", state])
    assert f"resumed render state from {jpath} (iteration 0)" in capsys.readouterr().out
    with np.load(jpath) as z, np.load(state) as s:
        for k in z.files:
            if k.startswith("net."):
                assert np.array_equal(z[k], s[k]), k
        assert int(s["render.iteration"]) == 1
    # a state of another image shape is refused
    r = Renderer(*PSB.cornell_box((16, 16)), device="cpu")
    with pytest.raises(ValueError, match="image"):
        load_render_state(jpath, r)


@pytest.fixture(scope="module")
def loaded_pairs(files):
    """A JAX renderer on the JAX-loaded scene and a port renderer on the
    port-loaded one for each mode, with the same weights."""
    with recording_frames(_interpret_plane_intersectors):
        scene, system = PSB.load_scene(*files)
        jscene, jsystem = JSB.load_scene(*files)
        pairs = {}
        for mode in (RenderMode.FULL, RenderMode.NO_CACHE):
            jr = JRenderer(jscene, jsystem, render_mode=mode, train=False)
            pr = Renderer(scene, system, render_mode=mode, train=False, device="cpu")
            pr.net_state = state_from_numpy(jax.tree.map(np.asarray, jr.net_state))
            pairs[mode] = (jr, pr)
        yield pairs


@pytest.mark.parametrize("subframe", [0, 1])
@pytest.mark.parametrize("mode", [RenderMode.FULL, RenderMode.NO_CACHE], ids=lambda m: m.name)
def test_loaded_frame_matches_jax(loaded_pairs, mode, subframe):
    got = frame_readings(loaded_pairs, mode, subframe)
    over = {k: (v, LIMITS[k]) for k, v in got.items() if not v <= LIMITS[k]}
    assert not over, f"readings over their limits: {over}"


def test_dropped_models_and_hair_equal_jax(files, tmp_path):
    """The Cornell scene file with models both loaders drop (a missing and a
    malformed ``assimp`` file, an unknown kind, a hair file on no search
    path) and one hair model that is found: the port's scene equals the JAX
    package's, and but for the curves the plain Cornell box's."""
    system, scene_path = files
    write_hair(tmp_path / "fur.hair", 31, seed=16)
    (tmp_path / "broken.ply").write_text("ply\nformat ascii 1.0\nelement vertex 3\nend_header\n1 2\n")
    text = open(scene_path).read() + "\n".join([
        f'model assimp "{tmp_path / "missing.obj"}" white',
        f'model assimp "{tmp_path / "broken.ply"}" white',
        "model cylinder 8 white",
        'model hair 1.0 white "nowhere.hair"',
        "push", "rotate 0 1 0 30", "translate 1 2 3",
        f'model hair 0.5 red "{tmp_path / "fur.hair"}"', "pop",
    ]) + "\n"
    path = os.path.join(os.path.dirname(scene_path), "scene_extra.txt")  # beside it: the same search paths
    with open(path, "w") as f:
        f.write(text)
    scene, _ = PSB.load_scene(system, path)
    jscene, _ = JSB.load_scene(system, path)
    assert_scenes_equal(scene, jscene)
    plain, _ = PSB.load_scene(*files)
    assert not scene.material_load_warnings()
    for f in TRIANGLE_FIELDS:
        assert same_bits(getattr(scene, f), getattr(plain, f)), f
    assert scene.curves.num > 0 and set(scene.curves.material_id.tolist()) == {1}
