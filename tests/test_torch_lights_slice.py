"""Port parity for the declared lights and textures slice: ``cornell_lights``
(point, spot and IES lights beside the area light) and ``env_textured`` (an
equirect sky with a sun, a checker-textured floor, a cutout panel and a
textured emitter), 32x32 frames against the JAX package: FULL and NO_CACHE
serving, FULL + train, and a live colour edit of a textured material.

The JAX scene is built from the same declarations by the JAX package's own
host code (``_build_lights`` on JAX ``LightDecl``s, ``MaterialTable.build``
decoding the same files), with a 64 x 32 sky. Both sides log every
closest-hit and shadow ray as ``test_torch_slice.py`` does (the JAX frame
on the TPU plane kernels under ``interpret=True``, the port on the plain
K1/K2); the cutout panel's shadow rays are closest-hit hops, logged too.
One more decision is logged: an escaping ray's environment texel. It is a
nearest-texel lookup by ``atan2``/``acos`` of the direction, which XLA:CPU
and PyTorch round differently in the last ulps, so a ray near a texel
border can read the neighbouring texel (with the sun in the map, a large
difference). Such a ray counts as flipped, as a ray whose hit flipped does,
and is left out of the per-ray comparisons. So does a ray whose texture
lookup (``sample_bilinear``: albedo, cutout, emission, the textured EDF) the
two sides' uv move apart by more than the box's query bound
(``test_torch_slice._texture_moved``): a direction that differs in its
last ulps (41 ulp after a glossy bounce) carries a hit point 16 units on
to a point 6.6e-5 units away, and where a checker edge passes under the bilinear fetch (0.53
of albedo over a texel of 1/12.8 unit) that moves the albedo by 4.1e-4.
The port's sampler at the JAX uv must give the JAX value (reads 6e-8), so
the move is the uv's and not the sampler's; 2 to 8 of 1024 rays move so.
The limits are the box frames' own (``test_torch_slice.LIMITS``,
``test_torch_train_slice.SLICE_LIMITS``).
"""

import contextlib
import dataclasses
import functools

import jax
import numpy as np
import pytest

import nrc_tpu.ops.texture as jax_texture
import nrc_tpu.render.frame as jax_frame
import nrc_tpu.render.integrator as jax_integrator
import nrc_tpu_torch.ops.light_sampling as port_light_sampling
import nrc_tpu_torch.render.frame as port_frame
import nrc_tpu_torch.render.integrator as port_integrator
from nrc_tpu.render.renderer import Renderer as JRenderer
from nrc_tpu_torch.config import RenderMode
from nrc_tpu_torch.models import network as N
from nrc_tpu_torch.ops.intersect import make_intersectors
from nrc_tpu_torch.render.renderer import Renderer
from nrc_tpu_torch.scene.scene_builder import (
    cornell_lights,
    cornell_lights_declarations,
    env_textured,
    env_textured_declarations,
)
from test_torch_intersect import one_torch_thread  # noqa: F401 (an autouse fixture)
from test_torch_scene import jax_cornell_scene
from test_torch_slice import (
    LIMITS,
    _LOG,
    _interpret_plane_intersectors,
    _recording_port_intersectors,
    frame_readings,
    recording_frames,
)
from test_torch_train_slice import (
    SLICE_LIMITS,
    _port_assemble_with_jax_batches,
    _recording_jax_assemble,
    train_frame_readings,
)

RES = (32, 32)
TILE = (8, 8)
ENV_SIZE = (64, 32)
SCENES = ("cornell_lights", "env_textured")


def _scene(name, directory, tiles=None):
    """(port scene, system, JAX scene) from the same declarations and files."""
    if name == "cornell_lights":
        scene, system = cornell_lights(RES, directory)
        decls = functools.partial(cornell_lights_declarations, directory)
    else:
        scene, system = env_textured(RES, "equirect", directory, ENV_SIZE)
        decls = functools.partial(env_textured_declarations, directory, "equirect", ENV_SIZE)
    if tiles:
        system = dataclasses.replace(system, tile_size=tiles)
    return scene, system, jax_cornell_scene(RES, decls, (directory,))


def _last_miss(log, n):
    """1 where the last n-ray closest-hit call's ray was cast and missed."""
    j = next(a for tag, a in reversed(log) if tag == "closest" and a[0].shape[0] == n)
    return ((j[0] > 0.0) & (j[3] < 0)).astype(np.float32)


def _env_logging(side, fn):
    """``env_radiance`` that logs ("env", [missed, pdf]) after the bounce's
    closest-hit call: a different pdf is a different texel."""
    if side == "port":
        def port_env(lights, d):
            em, pdf, has = fn(lights, d)
            if has:
                _LOG["port"].append(("env", [_last_miss(_LOG["port"], d.shape[0]), pdf.numpy().copy()]))
            return em, pdf, has
        return port_env

    def jax_env(lights, d):
        em, pdf, has = fn(lights, d)
        if has:
            jax.debug.callback(
                lambda p: _LOG["jax"].append(("env", [_last_miss(_LOG["jax"], p.shape[0]), np.asarray(p)])),
                pdf, ordered=True)
        return em, pdf, has
    return jax_env


def _texture_logging(side, fn):
    """``sample_bilinear`` that logs ("tex", [tex ids, uv, rgba]) (the port
    adds its atlas)."""
    if side == "port":
        def port_sample(atlas, tex_id, uv):
            out = fn(atlas, tex_id, uv)
            _LOG["port"].append(("tex", [tex_id.numpy().copy(), uv.numpy().copy(), out.numpy().copy(), atlas]))
            return out
        return port_sample

    def jax_sample(atlas, tex_id, uv):
        out = fn(atlas, tex_id, uv)
        jax.debug.callback(
            lambda t, u, o: _LOG["jax"].append(("tex", [np.asarray(t), np.asarray(u), np.asarray(o)])),
            tex_id, uv, out, ordered=True)
        return out
    return jax_sample


@contextlib.contextmanager
def _texture_lookups_logged():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_texture, "sample_bilinear", _texture_logging("jax", jax_texture.sample_bilinear))
        for module in (port_integrator, port_light_sampling):
            mp.setattr(module, "sample_bilinear", _texture_logging("port", module.sample_bilinear))
        yield


@contextlib.contextmanager
def _env_texels_logged():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_integrator, "env_radiance", _env_logging("jax", jax_integrator.env_radiance))
        mp.setattr(port_integrator, "env_radiance", _env_logging("port", port_integrator.env_radiance))
        yield


@pytest.fixture(scope="module")
def serving(tmp_path_factory):
    """Per scene and mode a JAX and a port renderer, the same weights."""
    directory = str(tmp_path_factory.mktemp("lights_slice"))
    with recording_frames(_interpret_plane_intersectors), _env_texels_logged(), _texture_lookups_logged():
        pairs = {}
        for name in SCENES:
            scene, system, jscene = _scene(name, directory)
            for mode in (RenderMode.FULL, RenderMode.NO_CACHE):
                jr = JRenderer(jscene, system, render_mode=mode, train=False)
                pr = Renderer(scene, system, render_mode=mode, train=False, device="cpu")
                pr.net_state = N.state_from_numpy(jax.tree.map(np.asarray, jr.net_state))
                pairs[name, mode] = (jr, pr)
        yield pairs


def test_scenes_declare_their_features(serving):
    """What each frame exercises: cornell_lights' four light types in one
    pick, below BVH_THRESHOLD; env_textured's sky, textures and cutout
    switched on on both sides."""
    jr, pr = serving["cornell_lights", RenderMode.FULL]
    assert pr.device_scene.lights.types_static == jr.device_scene.lights.types_static == (3, 4, 5, 2)
    assert pr.scene.num_triangles < 16384 and not pr.cfg.has_textures
    jr, pr = serving["env_textured", RenderMode.FULL]
    assert pr.device_scene.lights.types_static == (1, 2) and not pr.device_scene.lights.env_is_cube
    assert pr.cfg.has_textures and pr.cfg.has_cutout and jr.cfg.has_textures and jr.cfg.has_cutout


@pytest.mark.parametrize("subframe", [0, 1])
@pytest.mark.parametrize("mode", [RenderMode.FULL, RenderMode.NO_CACHE], ids=lambda m: m.name)
@pytest.mark.parametrize("name", SCENES)
def test_lights_frame_matches_jax(serving, name, mode, subframe):
    """FULL and NO_CACHE frames ray by ray, under the box frames' limits;
    rays whose env texel or texture lookup moved count as flipped."""
    pairs = {mode: serving[name, mode]}
    got = frame_readings(pairs, mode, subframe)
    over = {k: (v, LIMITS[k]) for k, v in got.items() if not v <= LIMITS[k]}
    assert not over, f"readings over their limits: {over}"


def test_live_edit_of_a_textured_material_matches_jax(serving):
    """The floor's colour (its texture's tint) edited through
    ``update_material`` on both sides: the port copies the new tables into
    the tensors it had (the atlas not decoded again, the same tensors), and
    the next frame agrees with the JAX package's edited frame under the
    same limits."""
    jr, pr = serving["env_textured", RenderMode.NO_CACHE]
    floor = [m.name for m in pr.scene.material_rows].index("floor")
    dev, atlas = pr.device_scene, pr.scene.materials.atlas
    quad = dev.atlas["texels_quad"].data_ptr()
    try:
        for r in (jr, pr):
            r.update_material(floor, albedo=(0.3, 0.6, 0.9))
        assert pr.device_scene is dev and pr.scene.materials.atlas is atlas
        assert dev.atlas["texels_quad"].data_ptr() == quad
        got = frame_readings({RenderMode.NO_CACHE: (jr, pr)}, RenderMode.NO_CACHE, 5)
        over = {k: (v, LIMITS[k]) for k, v in got.items() if not v <= LIMITS[k]}
        assert not over, f"readings over their limits: {over}"
    finally:
        for r in (jr, pr):
            r.update_material(floor, albedo=(0.9, 0.9, 0.9))


@contextlib.contextmanager
def _training_pair(name, directory):
    prev = jax.config.jax_enable_compilation_cache
    jax.config.update("jax_enable_compilation_cache", False)  # see test_torch_mlp.py
    try:
        with pytest.MonkeyPatch.context() as mp, _env_texels_logged(), _texture_lookups_logged():
            mp.setattr(jax_integrator, "make_intersectors", _interpret_plane_intersectors)
            mp.setattr(port_integrator, "make_intersectors", _recording_port_intersectors(make_intersectors))
            mp.setattr(jax_frame, "assemble_training_batches",
                       _recording_jax_assemble(jax_frame.assemble_training_batches))
            mp.setattr(port_frame, "assemble_training_batches",
                       _port_assemble_with_jax_batches(port_frame.assemble_training_batches))
            scene, system, jscene = _scene(name, directory, TILE)
            jr = JRenderer(jscene, system, render_mode=RenderMode.FULL, train=True, adaptive_tiles=False)
            pr = Renderer(scene, system, render_mode=RenderMode.FULL, adaptive_tiles=False, device="cpu")
            pr.net_state = N.state_from_numpy(jax.tree.map(np.asarray, jr.net_state))
            yield jr, pr
    finally:
        jax.config.update("jax_enable_compilation_cache", prev)


@pytest.mark.parametrize("name", SCENES)
def test_lights_training_frames_match_jax(tmp_path, name):
    """Two FULL + train frames, each from the JAX state, the port on the JAX
    frame's batches, under the box's training limits."""
    with _training_pair(name, str(tmp_path)) as (jr, pr):
        for subframe in range(2):
            got = train_frame_readings(jr, pr, subframe)
            over = {k: (v, SLICE_LIMITS[k]) for k, v in got.items() if not v <= SLICE_LIMITS[k]}
            assert not over, f"frame {subframe}: readings over their limits: {over}"
