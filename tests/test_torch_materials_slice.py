"""Port parity for the materials and media slice: ``cornell_materials``
(every blend and modifier mode of the two-lobe layered BSDF, a measured
BSDF, a Perlin noise tint and a Worley tint with a bump) and
``cornell_volume`` (a scattering medium behind a dielectric boundary and an
absorbing one), 32x32 frames against the JAX package: FULL and NO_CACHE
serving, FULL + train, and live edits of a layered colour and of a
scattering coefficient.

The JAX scene is built from the same declarations by the JAX package's own
host code (``MaterialTable.build`` reading the same baked measurement).
Both sides log every closest-hit and shadow ray as ``test_torch_slice.py``
does (the JAX frame on the TPU plane kernels under ``interpret=True``, the
port on the plain K1/K2). One more decision counts a ray as flipped
(``test_torch_slice.ray_flips``): a noise bump that the two sides' hit
points moved apart by more than the box's query bound (``_bump_moved``):
near a Worley cell border the field's gradient jumps, and the forward
differences (step 0.01 in the scaled domain) turn a hit point 1.8e-5 apart
into normals 1.2e-4 apart (a ray of the NO_CACHE frame at subframe 1,
reflected off the bumped wall four times); 0 to 7 such lookups a serving
frame, the largest 2.0e-4 apart. The port's bump at the JAX inputs gives
the JAX frame's normal within ``test_torch_slice.BUMP_ATOL``.

A free flight in the scattering medium caps its bounce's closest-hit tmax;
the flight is no decision of its own: a flight that found another triangle
is a closest-hit flip like any other (40-109 flights a bounce, their tmax
at most 1.6e-7 relative apart). Every other ray is held to the box frames'
limits (``test_torch_slice.LIMITS``, ``test_torch_train_slice.SLICE_LIMITS``).
"""

import contextlib
import dataclasses
import functools

import jax
import numpy as np
import pytest

import nrc_tpu.ops.noise as jax_noise
import nrc_tpu.render.frame as jax_frame
import nrc_tpu.render.integrator as jax_integrator
import nrc_tpu_torch.ops.noise as port_noise
import nrc_tpu_torch.render.frame as port_frame
import nrc_tpu_torch.render.integrator as port_integrator
from nrc_tpu.render.renderer import Renderer as JRenderer
from nrc_tpu_torch.config import RenderMode
from nrc_tpu_torch.models import network as N
from nrc_tpu_torch.ops import layered as LY
from nrc_tpu_torch.ops.intersect import BVH_THRESHOLD, make_intersectors
from nrc_tpu_torch.render.renderer import Renderer
from nrc_tpu_torch.scene.materials import Archetype
from nrc_tpu_torch.scene.scene_builder import (
    cornell_materials,
    cornell_materials_declarations,
    cornell_volume,
    cornell_volume_declarations,
)
from test_torch_graph import _HostOps, _wavefront_inputs, assert_same_bits
from test_torch_compact import checked_at_full_width
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
SCENES = ("cornell_materials", "cornell_volume")
FLAGS = ("has_volumes", "has_layered", "has_measured", "has_noise", "has_noise_bump", "noise_levels_static")


def _scene(name, directory, tiles=None):
    """(port scene, system, JAX scene) from the same declarations and files."""
    if name == "cornell_materials":
        scene, system = cornell_materials(RES, directory)
        jscene = jax_cornell_scene(RES, functools.partial(cornell_materials_declarations, directory), (directory,))
    else:
        scene, system = cornell_volume(RES)
        jscene = jax_cornell_scene(RES, cornell_volume_declarations)
    if tiles:
        system = dataclasses.replace(system, tile_size=tiles)
    return scene, system, jscene


def _last_hit(log, n):
    """True where the last n-ray closest-hit call's ray was cast and hit."""
    j = next(a for tag, a in reversed(log) if tag == "closest" and a[0].shape[0] == n)
    return (j[0] > 0.0) & (j[3] >= 0)


def _bump_logging(side, fn):
    """``noise_bump_normal`` that logs ("bump", [hit, inputs..., normal]) (the
    JAX side its inputs, for ``test_torch_slice._bump_moved``)."""
    if side == "port":
        def port_bump(ns, *rest, **kwargs):
            out = fn(ns, *rest, **kwargs)
            _LOG["port"].append(("bump", [_last_hit(_LOG["port"], ns.shape[0]), out.numpy().copy()]))
            return out
        return port_bump

    def jax_bump(mode, pos, ns, scale, levels, *rest, **kwargs):
        out = fn(mode, pos, ns, scale, levels, *rest, **kwargs)

        def log(*arrays):
            arrays = [np.asarray(a) for a in arrays]
            hit = _last_hit(_LOG["jax"], arrays[0].shape[0])
            _LOG["jax"].append(("bump", [hit] + arrays[:4] + [levels] + arrays[4:]))

        jax.debug.callback(log, mode, pos, ns, scale, *rest, out, ordered=True)
        return out
    return jax_bump


@contextlib.contextmanager
def _bumps_logged():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_noise, "noise_bump_normal", _bump_logging("jax", jax_noise.noise_bump_normal))
        mp.setattr(port_noise, "noise_bump_normal", _bump_logging("port", port_noise.noise_bump_normal))
        yield


@pytest.fixture(scope="module")
def serving(tmp_path_factory):
    """Per scene and mode a JAX and a port renderer, the same weights."""
    directory = str(tmp_path_factory.mktemp("materials_slice"))
    with recording_frames(_interpret_plane_intersectors), _bumps_logged():
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
    """What each frame exercises, the same switches on both sides:
    cornell_materials every blend mode (none, fixed, Fresnel, curve), every
    modifier (none, directional, conductor, thin film, curve), a measured
    BSDF and both noise uses; cornell_volume a scattering and an absorbing
    medium; both below BVH_THRESHOLD."""
    for name in SCENES:
        jr, pr = serving[name, RenderMode.FULL]
        assert {f: getattr(pr.cfg, f) for f in FLAGS} == {f: getattr(jr.cfg, f) for f in FLAGS}
        assert pr.scene.num_triangles < BVH_THRESHOLD and pr.device_scene.planes is not None
    mt = serving["cornell_materials", RenderMode.FULL][1].scene.materials
    assert set(mt.blend_mode.tolist()) == {LY.BLEND_NONE, LY.BLEND_FIXED, LY.BLEND_FRESNEL, LY.BLEND_CURVE}
    assert set(mt.mod_mode.tolist()) == {LY.MOD_NONE, LY.MOD_DIRECTIONAL, LY.MOD_FRESNEL_COND, LY.MOD_THIN_FILM,
                                         LY.MOD_CURVE}
    assert int(Archetype.MEASURED) in mt.archetype.tolist() and mt.mbsdf_index.max() == 0
    assert set(mt.noise_mode.tolist()) == {0, 1, 3} and mt.noise_bump_factor.max() > 0.0
    pr = serving["cornell_volume", RenderMode.FULL][1]
    mt = pr.scene.materials
    assert pr.cfg.has_volumes and not (pr.cfg.has_layered or pr.cfg.has_measured or pr.cfg.has_noise)
    scattering = mt.sigma_s.max(axis=-1) > 0.0
    absorbing = (mt.sigma_a.max(axis=-1) > 0.0) & ~scattering
    assert scattering.sum() == 1 and absorbing.sum() == 1


@pytest.mark.parametrize("subframe", [0, 1])
@pytest.mark.parametrize("mode", [RenderMode.FULL, RenderMode.NO_CACHE], ids=lambda m: m.name)
@pytest.mark.parametrize("name", SCENES)
def test_materials_frame_matches_jax(serving, name, mode, subframe):
    """FULL and NO_CACHE frames ray by ray, under the box frames' limits;
    rays whose bump moved count as flipped."""
    got = frame_readings({mode: serving[name, mode]}, mode, subframe)
    over = {k: (v, LIMITS[k]) for k, v in got.items() if not v <= LIMITS[k]}
    assert not over, f"readings over their limits: {over}"


@pytest.mark.parametrize("name, material, change", [
    ("cornell_materials", "floor", dict(albedo2=(0.2, 0.5, 0.8))),
    ("cornell_volume", "fog", dict(sigma_s=(0.4, 0.9, 1.3))),
], ids=("layered_colour", "sigma_s"))
def test_live_edit_matches_jax(serving, name, material, change):
    """A colour of a layered material's base lobe and a scattering
    coefficient edited through ``update_material`` on both sides: the port
    copies the new tables into the tensors it had (the same measurement
    rows, the same switches), and the next frame agrees with the JAX
    package's edited frame under the same limits."""
    jr, pr = serving[name, RenderMode.NO_CACHE]
    index = [m.name for m in pr.scene.material_rows].index(material)
    before = dict((k, getattr(pr.scene.material_rows[index], k)) for k in change)
    dev, cfg = pr.device_scene, pr.cfg
    rows = dev.mbsdf.eval_rows.data_ptr()
    try:
        for r in (jr, pr):
            r.update_material(index, **change)
        assert pr.device_scene is dev and dev.mbsdf.eval_rows.data_ptr() == rows and pr.cfg == cfg
        got = frame_readings({RenderMode.NO_CACHE: (jr, pr)}, RenderMode.NO_CACHE, 5)
        over = {k: (v, LIMITS[k]) for k, v in got.items() if not v <= LIMITS[k]}
        assert not over, f"readings over their limits: {over}"
    finally:
        for r in (jr, pr):
            r.update_material(index, **before)


@contextlib.contextmanager
def _training_pair(name, directory):
    prev = jax.config.jax_enable_compilation_cache
    jax.config.update("jax_enable_compilation_cache", False)  # see test_torch_mlp.py
    try:
        with pytest.MonkeyPatch.context() as mp, _bumps_logged():
            mp.setattr(jax_integrator, "make_intersectors", _interpret_plane_intersectors)
            mp.setattr(port_integrator, "make_intersectors", _recording_port_intersectors(make_intersectors))
            mp.setattr(port_frame, "trace_wavefront", checked_at_full_width(port_frame.trace_wavefront, _LOG["port"]))
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
def test_materials_training_frames_match_jax(tmp_path, name):
    """Two FULL + train frames, each from the JAX state, the port on the JAX
    frame's batches, under the box's training limits."""
    with _training_pair(name, str(tmp_path)) as (jr, pr):
        for subframe in range(2):
            got = train_frame_readings(jr, pr, subframe)
            over = {k: (v, SLICE_LIMITS[k]) for k, v in got.items() if not v <= SLICE_LIMITS[k]}
            assert not over, f"frame {subframe}: readings over their limits: {over}"


def _port_renderer(name, directory, mode=RenderMode.FULL, train=True):
    scene, system, _ = _scene(name, directory, TILE)
    return Renderer(scene, system, render_mode=mode, train=train, adaptive_tiles=False, device="cpu")


@pytest.mark.parametrize("mode,train", [(RenderMode.FULL, True), (RenderMode.NO_CACHE, False)],
                         ids=["FULL+train", "NO_CACHE"])
@pytest.mark.parametrize("name", SCENES)
def test_warm_frame_makes_no_host_tensor_and_reads_nothing(tmp_path, monkeypatch, name, mode, train):
    """What a captured frame rests on, for the new branches too: the frame
    as the graph captures it (the card's fixed-depth bounce loop), after one
    warm-up frame, makes no tensor of host data and reads nothing back
    (``test_torch_graph.py``'s check)."""
    monkeypatch.setattr(port_integrator, "_all_done", lambda alive: False)
    r = _port_renderer(name, str(tmp_path), mode, train)
    r._frame()
    with _HostOps() as rec:
        r._frame()
    assert rec.ops > 1000 and rec.seen == [], f"host data or reads in a warm frame: {rec.seen}"


@pytest.mark.parametrize("train", [False, True], ids=["render", "training"])
@pytest.mark.parametrize("name", SCENES)
def test_fixed_depth_loop_matches_early_exit(tmp_path, monkeypatch, name, train):
    """The card's loop (every bounce, dead lanes carried along: their
    free flights, scatter steps, lobe picks and noise are masked off)
    against the CPU's early exit: every output of the wavefront bit for bit."""
    r = _port_renderer(name, str(tmp_path))
    cfg = dataclasses.replace(r.cfg, max_depth=12)
    for subframe in range(2):
        org, d, seeds, unbiased = _wavefront_inputs(r, train, subframe)
        ref = port_integrator.trace_wavefront(r.device_scene, org, d, seeds, cfg, train=train, unbiased=unbiased)
        with monkeypatch.context() as mp:
            mp.setattr(port_integrator, "_all_done", lambda alive: False)
            got = port_integrator.trace_wavefront(r.device_scene, org, d, seeds, cfg, train=train,
                                                  unbiased=unbiased)
        for field, a, b in zip(got._fields, got, ref):
            assert (a is None) == (b is None), field
            if a is not None:
                assert_same_bits(a, b, f"{name} subframe {subframe} {field}")


def test_an_edit_that_turns_a_feature_on_rederives_the_switches(tmp_path):
    """``update_material`` re-derives the frame's switches: a volume, a blend
    and a measurement given to the box's materials turn theirs on (another
    graph on the card), the new measurement's tables replace the empty
    stack (the graphs dropped), and the frame renders; undoing the edits
    turns them off again."""
    from nrc_tpu_torch.scene.mbsdf import bake_lambert
    from nrc_tpu_torch.scene.scene_builder import cornell_box

    path = str(tmp_path / "lambert.npz")
    np.savez(path, reflection=bake_lambert((0.5, 0.5, 0.5), 8, 16).reflection)
    scene, system = cornell_box(RES)
    r = Renderer(scene, dataclasses.replace(system, tile_size=TILE), device="cpu")
    before = {f: getattr(r.cfg, f) for f in FLAGS}
    assert not any(before[f] for f in FLAGS[:-1])
    dev = r.device_scene
    r.update_material(0, sigma_s=(0.5, 0.5, 0.5), blend_mode=LY.BLEND_FIXED)
    r.update_material(1, archetype=Archetype.MEASURED, mbsdf_path=path)
    assert r.cfg.has_volumes and r.cfg.has_layered and r.cfg.has_measured and not r.cfg.has_noise
    assert r.device_scene is not dev and r.device_scene.mbsdf.res_theta == 8
    r.render_frame()
    assert np.isfinite(r.image.numpy()).all()
    r.update_material(0, sigma_s=(0.0, 0.0, 0.0), blend_mode=LY.BLEND_NONE)
    r.update_material(1, archetype=Archetype.DIFFUSE_REFLECTION, mbsdf_path="")
    assert {f: getattr(r.cfg, f) for f in FLAGS} == before
