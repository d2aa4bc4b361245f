"""Port parity for the curves and hair slice: the strand patch of
``tests/test_hair_render.py:24-81`` through both packages' ``trace_wavefront``
ray by ray (render and training), and 32x32 ``cornell_hair`` frames (a few
hundred strands) against the JAX package: FULL and NO_CACHE serving, FULL +
train, and a live edit of ``hair_absorption``.

The JAX scene is the JAX package's ``Scene`` of the same declarations with
the same strands tessellated by its own ``hair_to_segments``; it walks them
with its binary skip-link walk (at most 16,384 segments), the port with the
wide walk. Both sides log every closest-hit and shadow ray as
``test_torch_slice.py`` does, and every curve call, hair sample and hair
evaluation besides.

Why the port takes the JAX frame's curve hits. The round-cone test solves
a quadratic whose two roots lie a fibre's chord apart, about 1e-3 of the
distance t for a fibre seen from the camera: its discriminant keeps about
1e-6 of its terms (``h / (k1^2 + |k0 k2|)``), so two correct float32
evaluations (XLA:CPU's contracted FMAs, PyTorch's separate products) give t
up to 5e-4 apart relative, a hit point a few 1e-4 units apart, and a fibre
normal 1e-2 apart. So at each curve call the port's own hit is held to the
JAX hit (``hair_decisions.curve_call``: the port's cone test at the JAX inputs within
``T_COND`` ulp over the root of the relative discriminant; where the walks
name different segments, each the closest on its own ray, and an equal-t
tie or a ray that grazes a winner, shown by its logged h or y), and then
the JAX hit is handed to the port's bounce, as the training tests hand over
JAX's batches. Every ray after that is held to the box frames' limits
(``test_torch_slice.LIMITS``, ``test_torch_train_slice.SLICE_LIMITS``),
with two changes for this scene, each stated where ``HAIR_LIMITS`` is set.

Three more decisions count a ray as flipped (``test_torch_slice.ray_flips``):
a fibre normal, a hair sample or a hair evaluation that the two sides'
inputs moved apart (``normal_moved``, ``hair_moved``). A round cone's
normal turns by the hit point's move over the fibre's radius (down to
0.006), so a hit point a few ulp apart turns it by 1e-4; the longitudinal
and azimuthal terms take arcsines and logarithms of h, ill-conditioned
where a ray grazes the fibre (|h| near 1); and the lobe pick compares a
uniform with the lobe cdf. The witness: the port's function at the JAX
inputs gives the JAX output (within ``FRAME_ATOL`` and ``HAIR_ATOL``,
except where the lobe pick is a decision). So on ``cornell_hair`` a ray
that meets a fibre is mostly held through these witnesses, the strand
patch's rays (whose fibres face them along z) mostly ray by ray. The query
vectors' direction and normal are read as the unit vectors they encode
(``query_gap_unit``): their azimuth near the pole (+-z, where these rays
run) turns by the vector's move over its distance from the pole.

The decisions, their thresholds and their witnesses are the port's
``nrc_tpu_torch/tools/hair_decisions.py``, which the card's smoke test
(``chip_smoke.py`` phase 6h) counts the card's frames with too.
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nrc_tpu.ops.curve_intersect as jax_curves
import nrc_tpu.ops.hair_bsdf as jax_hair
import nrc_tpu.render.frame as jax_frame
import nrc_tpu.render.integrator as jax_integrator
import nrc_tpu_torch.ops.curve_intersect as port_curves
import nrc_tpu_torch.ops.hair_bsdf as port_hair
import nrc_tpu_torch.render.frame as port_frame
import nrc_tpu_torch.render.integrator as port_integrator
import test_torch_slice
from nrc_tpu.render.renderer import Renderer as JRenderer
from nrc_tpu.render.scene_device import upload_scene as jax_upload_scene
from nrc_tpu.scene import hair as JH
from nrc_tpu.utils import rng as JR
from nrc_tpu_torch.config import FrameConfig, RenderMode
from nrc_tpu_torch.models import network as N
from nrc_tpu_torch.ops.intersect import make_intersectors
from nrc_tpu_torch.render.renderer import Renderer
from nrc_tpu_torch.render.scene_device import upload_scene
from nrc_tpu_torch.scene.materials import Archetype
from nrc_tpu_torch.scene.scene_builder import HAIR_SEGMENTS, HAIR_SUBSEGMENTS, cornell_hair, cornell_hair_declarations
from nrc_tpu_torch.tools import hair_decisions as HD
from test_hair_render import build_scene as strand_patch_scene
from test_torch_compact import full_width
from test_torch_graph import _HostOps, _wavefront_inputs, assert_same_bits
from test_torch_intersect import one_torch_thread  # noqa: F401 (an autouse fixture)
from test_torch_scene import jax_cornell_scene
from test_torch_slice import LIMITS, _LOG, _interpret_plane_intersectors, _jax_log, frame_readings
from test_torch_train_slice import (
    SLICE_LIMITS,
    _flipped,
    _port_assemble_with_jax_batches,
    _recording_jax_assemble,
    train_frame_readings,
)

RES = (32, 32)
TILE = (8, 8)
STRANDS = 300
# the box's limits but two, each stated where hair_decisions sets it
HAIR_LIMITS = dict(LIMITS, **HD.HAIR_LIMIT_CHANGES)
HAIR_SLICE_LIMITS = dict(SLICE_LIMITS, flipped_share=HD.HAIR_LIMIT_CHANGES["flipped_share"])
# curve decisions seen by the checks of one test (for its reporting)
_DECISIONS = {"curve": 0, "curve_ties": 0}


# ---- the scenes ---------------------------------------------------------------


def hair_scenes(strands=STRANDS, tiles=None):
    """(port scene, system, JAX scene) of ``cornell_hair`` with ``strands``
    strands: the JAX scene's strands tessellated by the JAX package."""
    models, materials, cam, hair = cornell_hair_declarations(strands)
    scene, system = cornell_hair(RES, strands=strands)
    jscene = jax_cornell_scene(RES, lambda: (models, materials, cam))
    hf = hair.hair
    jhf = JH.HairFile(hf.num_strands, hf.segments, hf.points, hf.thickness, hf.transparency, hf.color)
    jscene.curves = JH.transform_segments(
        JH.hair_to_segments(jhf, material_id=list(materials).index(hair.material), subsegments=hair.subsegments),
        hair.matrix)
    if tiles:
        system = dataclasses.replace(system, tile_size=tiles)
    return scene, system, jscene


def test_scene_is_the_declared_fur():
    """``cornell_hair``: the box's 1224 triangles by brute force, 16 round
    cones a strand, the hair material on every segment, and the box grown by
    the fibres as the JAX package's ``aabb`` grows it."""
    scene, system, jscene = hair_scenes()
    assert scene.num_triangles == 1224 and scene.curves.num == STRANDS * HAIR_SEGMENTS * HAIR_SUBSEGMENTS
    hair = [m.name for m in scene.material_rows].index("hair")
    assert scene.material_rows[hair].archetype == Archetype.HAIR
    assert scene.material_rows[hair].hair_diffuse_weight > 0.0
    assert set(scene.curves.material_id.tolist()) == {hair}
    for a, b in zip(scene.aabb(), jscene.aabb()):
        assert np.array_equal(a, b)
    assert scene.aabb()[1][1] > -4.0 + 2.0  # the fur rises above the block
    for f in ("pa", "pb", "ra", "rb", "u_a", "u_b", "reference", "color_a", "color_b", "material_id"):
        assert np.asarray(getattr(scene.curves, f)).tobytes() == np.asarray(getattr(jscene.curves, f)).tobytes()
    r = Renderer(scene, system, device="cpu")
    assert r.device_scene.curves.shape == (scene.curves.num, 21) and r.device_scene.curve_bvh.kind == "cone"
    assert r.cfg.position_scale == JRenderer(jscene, system).cfg.position_scale


def test_the_decisions_read_the_box_bounds():
    """``hair_decisions`` (the card's count of 6h's decisions) reads the
    box frames' query bound and changes the box's limits as this file's
    ``HAIR_LIMITS`` does."""
    assert HD.QUERY_ABS == LIMITS["query_abs"]
    assert {k: v for k, v in HAIR_LIMITS.items() if LIMITS[k] != v} == HD.HAIR_LIMIT_CHANGES


# ---- logging both sides' curve calls and hair lobes --------------------------------


def _jax_curve_logging(fn):
    def closest(o, d, bvh, curves, tn, tf):
        hit = fn(o, d, bvh, curves, tn, tf)
        jax.debug.callback(_jax_log("curve"), tf, tn, o, d, hit.t, hit.prim, ordered=True)
        return hit
    return closest


def _jax_occlusion_logging(fn):
    def occluded(o, d, bvh, curves, tn, tf):
        occ = fn(o, d, bvh, curves, tn, tf)
        jax.debug.callback(_jax_log("curve_shadow"), tf, occ, ordered=True)
        return occ
    return occluded


def _port_curve_taking_jax_hits(fn):
    """The port's curve call, logged, returning the JAX frame's hit of the
    same call (the JAX frame runs first)."""
    def closest(o, d, bvh, tn, tf):
        hit = fn(o, d, bvh, tn, tf)
        _LOG["port"].append(("curve", [x.numpy().copy() for x in (tf, tn, o, d, hit.t, hit.prim)]))
        k = sum(tag == "curve" for tag, _ in _LOG["port"]) - 1
        j = [a for tag, a in _LOG["jax"] if tag == "curve"][k]
        return port_curves.CurveHit(torch.from_numpy(j[4].copy()), torch.from_numpy(j[5].astype(np.int64)))
    return closest


def _port_occlusion_logging(fn):
    def occluded(o, d, bvh, tn, tf):
        occ = fn(o, d, bvh, tn, tf)
        _LOG["port"].append(("curve_shadow", [tf.numpy().copy(), occ.numpy().copy()]))
        return occ
    return occluded


def _hair_logging(side, name, fn):
    """``hair_sample`` / ``hair_eval`` logging (name, [used lanes, params...,
    inputs..., outputs...])."""
    if side == "port":
        def port_fn(params, *args):
            out = fn(params, *args)
            used = HD.curve_won(_LOG["port"], args[0].shape[0])
            _LOG["port"].append((name, [used] + [np.asarray(t).copy() for t in (*params, *args, *out)]))
            return out
        return port_fn

    def jax_fn(params, *args):
        out = fn(params, *args)

        def log(*arrays):
            arrays = [np.asarray(a) for a in arrays]
            _LOG["jax"].append((name, [HD.curve_won(_LOG["jax"], arrays[-1].shape[0])] + arrays))

        jax.debug.callback(log, *params, *args, *out, ordered=True)
        return out
    return jax_fn


def _frame_logging(side, fn):
    """``curve_shading_frame`` logging ("cframe", [used lanes, prim, hit
    point, normal])."""
    if side == "port":
        def port_frame(table, prim, x):
            out = fn(table, prim, x)
            used = HD.curve_won(_LOG["port"], x.shape[0])
            _LOG["port"].append(("cframe", [used, prim.numpy().copy(), x.numpy().copy(), out.normal.numpy().copy()]))
            return out
        return port_frame

    def jax_frame_fn(curves, prim, x):
        out = fn(curves, prim, x)

        def log(*arrays):
            arrays = [np.asarray(a) for a in arrays]
            _LOG["jax"].append(("cframe", [HD.curve_won(_LOG["jax"], arrays[0].shape[0])] + arrays))

        jax.debug.callback(log, prim, x, out.normal, ordered=True)
        return out
    return jax_frame_fn


@contextlib.contextmanager
def hair_logged(seg_of):
    """Both sides' curve calls, fibre frames and hair lobes logged, the
    port's bounce on the JAX curve hits; ``seg_of()`` gives the scene's
    ``CurveSoA`` of tensors for the checks."""
    handlers = {"curve": lambda j, p: HD.curve_call(seg_of(), _DECISIONS)(j, p),
                "hair": HD.hair_moved("hair"),
                "hair_eval": HD.hair_moved("hair_eval"),
                "cframe": lambda j, p: HD.normal_moved(torch.from_numpy(port_curves.curve_row_table(seg_of())))(j, p)}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(test_torch_slice, "MOVED", dict(test_torch_slice.MOVED, **handlers))
        mp.setattr(test_torch_slice, "QUERY_GAP", HD.query_gap_unit)
        # the port's curve calls take the JAX calls' hits ray by ray, so its
        # bounces run at the JAX frame's full width
        mp.setattr(port_integrator, "compact_capacity", full_width)
        mp.setattr(jax_curves, "intersect_curves_bvh", _jax_curve_logging(jax_curves.intersect_curves_bvh))
        mp.setattr(jax_curves, "occluded_curves_bvh", _jax_occlusion_logging(jax_curves.occluded_curves_bvh))
        mp.setattr(port_curves, "intersect_curves_bvh", _port_curve_taking_jax_hits(port_curves.intersect_curves_bvh))
        mp.setattr(port_curves, "occluded_curves_bvh", _port_occlusion_logging(port_curves.occluded_curves_bvh))
        mp.setattr(jax_curves, "curve_shading_frame", _frame_logging("jax", jax_curves.curve_shading_frame))
        mp.setattr(port_curves, "curve_shading_frame", _frame_logging("port", port_curves.curve_shading_frame))
        for name, fn in (("hair", "hair_sample"), ("hair_eval", "hair_eval")):
            mp.setattr(jax_hair, fn, _hair_logging("jax", name, getattr(jax_hair, fn)))
            mp.setattr(port_hair, fn, _hair_logging("port", name, getattr(port_hair, fn)))
        yield


def _segments(scene):
    return port_curves.CurveSoA.build(scene.curves).to("cpu")


# ---- the strand patch through both wavefronts -----------------------------------


# every ray of the patch meets the hair two to four times; reads 0.047 (3 of
# 64 training rays: two hair samples moved near |h| = 1, one shadow ray
# leaving a fibre) and 0.023 (6 of 256 render rays)
PATCH_FLIPPED_SHARE = 0.1
PATCH_RAYS = {
    # tests/test_hair_render.py:52-70 and :72-81: rays along -z at the strand
    # columns' x, at heights through the fibres
    False: (256, np.linspace(-0.5, 0.1, 256 // 8), 9),
    True: (64, np.linspace(-0.6, 0.0, 8), 3),
}


@pytest.mark.parametrize("train", [False, True], ids=["render", "training"])
def test_strand_patch_wavefront_matches_jax(train):
    """The JAX test's strand patch (64 vertical round cones over a plane,
    the hair material, a constant environment) through both packages'
    ``trace_wavefront``: NO_CACHE rendering or the training wavefront, ray
    by ray under the box's limits (flipped rays left out)."""
    jscene = strand_patch_scene()
    n, heights, seed = PATCH_RAYS[train]
    kw = dict(width=8, height=8, max_depth=4, train=train)
    grid_x = np.linspace(-0.8, 0.8, 8)
    org = np.stack([np.tile(grid_x, n // 8), np.repeat(heights, 8), np.full(n, 3.0)], -1).astype(np.float32)
    d = np.tile(np.float32([[0.0, 0.0, -1.0]]), (n, 1))
    seeds = np.asarray(JR.tea(jnp.arange(n, dtype=jnp.uint32), jnp.uint32(seed)))
    unbiased = np.arange(n) % 2 == 0
    pdev = upload_scene(jscene, "cpu")
    _LOG["jax"].clear()
    _LOG["port"].clear()
    prev = jax.config.jax_enable_compilation_cache
    jax.config.update("jax_enable_compilation_cache", False)  # see test_torch_mlp.py
    try:
        with pytest.MonkeyPatch.context() as mp, hair_logged(lambda: _segments(jscene)):
            mp.setattr(jax_integrator, "make_intersectors", _interpret_plane_intersectors)
            mp.setattr(port_integrator, "make_intersectors",
                       test_torch_slice._recording_port_intersectors(make_intersectors))
            from nrc_tpu.config import FrameConfig as JFrameConfig
            from nrc_tpu.config import RenderMode as JRenderMode

            jcfg = JFrameConfig(render_mode=JRenderMode.FULL if train else JRenderMode.NO_CACHE, **kw)
            pcfg = FrameConfig(render_mode=RenderMode.FULL if train else RenderMode.NO_CACHE, **kw)
            jdev = jax_upload_scene(jscene)
            jout = jax.jit(lambda o, dd, s, u: jax_integrator.trace_wavefront(
                jdev, o, dd, s, jcfg, train=train, unbiased=u if train else None))(org, d, seeds, unbiased)
            ref = {k: np.asarray(v) for k, v in jout._asdict().items() if v is not None}
            jax.effects_barrier()
            got = port_integrator.trace_wavefront(
                pdev, torch.from_numpy(org), torch.from_numpy(d), torch.from_numpy(seeds.astype(np.int64)), pcfg,
                train=train, unbiased=torch.from_numpy(unbiased) if train else None)
            got = {k: v.numpy() for k, v in got._asdict().items() if v is not None}
            keep = ~_flipped(_LOG["jax"], _LOG["port"], n)
    finally:
        jax.config.update("jax_enable_compilation_cache", prev)
    hair_hits = HD.curve_won(_LOG["port"], n)  # the last bounce's; the first call's below
    first = next(a for tag, a in _LOG["port"] if tag == "curve")
    assert (first[5] >= 0).mean() > 0.3, "the rays do not hit the strands"
    print(f"strand patch, {'training' if train else 'render'}: {int((~keep).sum())} of {n} rays flipped")
    assert 1.0 - keep.mean() <= PATCH_FLIPPED_SHARE and hair_hits.shape == (n,)
    for key in ("bounce_count", "traced_count") + (("rec_count", "end_mask") if train else ()):
        assert np.array_equal(got[key][keep], ref[key][keep].astype(got[key].dtype)), key
    rel = lambda a, b: (np.abs(a - b) / np.maximum(np.abs(b), 1e-3)).reshape(a.shape[0], -1).max(-1)
    assert rel(got["radiance"], ref["radiance"])[keep].max() <= LIMITS["radiance_rel"]
    if train:
        slots = (np.arange(pcfg.max_train_records_per_ray)[None] < got["rec_count"][:, None]) & keep[:, None]
        assert slots.any() and int(got["rec_count"].sum()) > 0
        assert HD.query_gap_unit(got["rec_query"], ref["rec_query"])[slots].max() <= LIMITS["query_abs"]
        assert (np.abs(got["rec_target"] - ref["rec_target"]) / np.maximum(np.abs(ref["rec_target"]), 1e-3))[
            slots].max() <= LIMITS["radiance_rel"]
    else:
        # the JAX test's own reading: the hair's absorption tints the bounce light red
        tot = got["radiance"].sum(0)
        assert got["radiance"].mean() > 0.01 and tot[0] > tot[2]


# ---- 32x32 cornell_hair frames -------------------------------------------------------


@pytest.fixture(scope="module")
def serving():
    """Per mode a JAX and a port renderer, the same weights; each test
    renders under ``hair_logged`` (the JAX frame compiles at its first)."""
    scene, system, jscene = hair_scenes()
    with test_torch_slice.recording_frames(_interpret_plane_intersectors):
        pairs = {}
        for mode in (RenderMode.FULL, RenderMode.NO_CACHE):
            jr = JRenderer(jscene, system, render_mode=mode, train=False)
            pr = Renderer(scene, system, render_mode=mode, train=False, device="cpu")
            pr.net_state = N.state_from_numpy(jax.tree.map(np.asarray, jr.net_state))
            pairs[mode] = (jr, pr)
        yield pairs


@pytest.mark.parametrize("subframe", [0, 1])
@pytest.mark.parametrize("mode", [RenderMode.FULL, RenderMode.NO_CACHE], ids=lambda m: m.name)
def test_hair_frame_matches_jax(serving, mode, subframe):
    """FULL and NO_CACHE frames ray by ray under the box's limits; the port
    on the JAX curve hits, each held to the port's own."""
    _DECISIONS.update(curve=0, curve_ties=0)
    scene = serving[mode][1].scene
    with hair_logged(lambda: _segments(scene)):
        got = frame_readings({mode: serving[mode]}, mode, subframe)
    print(f"cornell_hair {mode.name} subframe {subframe}: {got}; curve calls {_DECISIONS}")
    over = {k: (v, HAIR_LIMITS[k]) for k, v in got.items() if not v <= HAIR_LIMITS[k]}
    assert not over, f"readings over their limits: {over}"
    first = next(a for tag, a in _LOG["port"] if tag == "curve")
    assert (first[5] >= 0).mean() > 0.1, "under a tenth of the camera rays hit a fibre"


def test_live_edit_matches_jax(serving):
    """``hair_absorption`` edited through ``update_material`` on both sides:
    the port copies the new row into the tensors it had, and the next frame
    agrees with the JAX package's edited frame under the same limits."""
    jr, pr = serving[RenderMode.NO_CACHE]
    index = [m.name for m in pr.scene.material_rows].index("hair")
    before = pr.scene.material_rows[index].hair_absorption
    dev, cfg, mat_row = pr.device_scene, pr.cfg, pr.device_scene.mat_row.data_ptr()
    try:
        for r in (jr, pr):
            r.update_material(index, hair_absorption=(1.5, 0.4, 0.1))
        assert pr.device_scene is dev and dev.mat_row.data_ptr() == mat_row and pr.cfg == cfg
        with hair_logged(lambda: _segments(pr.scene)):
            got = frame_readings({RenderMode.NO_CACHE: (jr, pr)}, RenderMode.NO_CACHE, 5)
        over = {k: (v, HAIR_LIMITS[k]) for k, v in got.items() if not v <= HAIR_LIMITS[k]}
        assert not over, f"readings over their limits: {over}"
    finally:
        for r in (jr, pr):
            r.update_material(index, hair_absorption=before)


def test_hair_training_frames_match_jax():
    """Two FULL + train frames, each from the JAX state, the port on the JAX
    frame's batches and curve hits, under the box's training limits."""
    scene, system, jscene = hair_scenes(tiles=TILE)
    prev = jax.config.jax_enable_compilation_cache
    jax.config.update("jax_enable_compilation_cache", False)  # see test_torch_mlp.py
    try:
        with pytest.MonkeyPatch.context() as mp, hair_logged(lambda: _segments(scene)):
            mp.setattr(jax_integrator, "make_intersectors", _interpret_plane_intersectors)
            mp.setattr(port_integrator, "make_intersectors",
                       test_torch_slice._recording_port_intersectors(make_intersectors))
            mp.setattr(jax_frame, "assemble_training_batches",
                       _recording_jax_assemble(jax_frame.assemble_training_batches))
            mp.setattr(port_frame, "assemble_training_batches",
                       _port_assemble_with_jax_batches(port_frame.assemble_training_batches))
            jr = JRenderer(jscene, system, render_mode=RenderMode.FULL, train=True, adaptive_tiles=False)
            pr = Renderer(scene, system, render_mode=RenderMode.FULL, adaptive_tiles=False, device="cpu")
            pr.net_state = N.state_from_numpy(jax.tree.map(np.asarray, jr.net_state))
            for subframe in range(2):
                got = train_frame_readings(jr, pr, subframe)
                print(f"cornell_hair FULL + train frame {subframe}: {got}")
                over = {k: (v, HAIR_SLICE_LIMITS[k]) for k, v in got.items() if not v <= HAIR_SLICE_LIMITS[k]}
                assert not over, f"frame {subframe}: readings over their limits: {over}"
    finally:
        jax.config.update("jax_enable_compilation_cache", prev)


# ---- what the card's captured frame rests on ---------------------------------------


def _port_renderer(mode=RenderMode.FULL, train=True, strands=STRANDS):
    scene, system, _ = hair_scenes(strands, tiles=TILE)
    return Renderer(scene, system, render_mode=mode, train=train, adaptive_tiles=False, device="cpu")


@pytest.mark.parametrize("mode,train", [(RenderMode.FULL, True), (RenderMode.NO_CACHE, False)],
                         ids=["FULL+train", "NO_CACHE"])
def test_warm_frame_makes_no_host_tensor_and_reads_nothing(monkeypatch, mode, train):
    """The frame as the graph captures it, after one warm-up frame, makes no
    tensor of host data and reads nothing back, the curve stream, its frame
    and the hair lobe included. The plain walk reads a flag each step (on
    the card C1/C2 run instead), so the curve calls take the brute force
    here, which reads nothing (on 24 strands: 384 segments)."""
    monkeypatch.setattr(port_integrator, "_all_done", lambda alive: False)
    r = _port_renderer(mode, train, strands=24)
    seg = port_curves.CurveSoA.build(r.scene.curves).to("cpu")
    monkeypatch.setattr(port_curves, "intersect_curves_bvh",
                        lambda o, d, bvh, tn, tf: port_curves.intersect_curves_bruteforce(o, d, seg, tn, tf))
    monkeypatch.setattr(port_curves, "occluded_curves_bvh",
                        lambda o, d, bvh, tn, tf: port_curves.intersect_curves_bruteforce(o, d, seg, tn, tf).valid)
    r._frame()
    with _HostOps() as rec:
        r._frame()
    assert rec.ops > 1000 and rec.seen == [], f"host data or reads in a warm frame: {rec.seen}"


@pytest.mark.parametrize("train", [False, True], ids=["render", "training"])
def test_fixed_depth_loop_matches_early_exit(monkeypatch, train):
    """The card's loop (every bounce, dead lanes carried along through the
    curve stream and the hair lobe) against the CPU's early exit: every
    output of the wavefront bit for bit."""
    r = _port_renderer()
    cfg = dataclasses.replace(r.cfg, max_depth=10)
    org, d, seeds, unbiased = _wavefront_inputs(r, train, 1)
    ref = port_integrator.trace_wavefront(r.device_scene, org, d, seeds, cfg, train=train, unbiased=unbiased)
    monkeypatch.setattr(port_integrator, "_all_done", lambda alive: False)
    got = port_integrator.trace_wavefront(r.device_scene, org, d, seeds, cfg, train=train, unbiased=unbiased)
    for field, a, b in zip(got._fields, got, ref):
        assert (a is None) == (b is None), field
        if a is not None:
            assert_same_bits(a, b, f"cornell_hair {field}")


def test_curve_directions_are_unit():
    """The round-cone test needs unit directions: every ray the bounce hands
    to the curve walks, on both wavefronts and the shadow rays, is of unit
    length to float32 rounding."""
    r = _port_renderer()
    lengths = []

    def note(fn):
        def wrapped(o, d, bvh, tn, tf):
            live = tf > tn
            if bool(live.any()):
                lengths.append((torch.linalg.vector_norm(d, dim=-1)[live] - 1.0).abs().max().item())
            return fn(o, d, bvh, tn, tf)
        return wrapped

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_curves, "intersect_curves_bvh", note(port_curves.intersect_curves_bvh))
        mp.setattr(port_curves, "occluded_curves_bvh", note(port_curves.occluded_curves_bvh))
        r.render_frame()
    assert len(lengths) > 4 and max(lengths) <= 1e-6, lengths
