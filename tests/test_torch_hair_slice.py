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
JAX hit (``_curve_call``: the port's cone test at the JAX inputs within
``T_COND`` ulp over the root of the relative discriminant; where the walks
name different segments, each the closest on its own ray, and an equal-t
tie or a ray that grazes a winner, shown by its logged h or y), and then
the JAX hit is handed to the port's bounce, as the training tests hand over
JAX's batches. Every ray after that is held to the box frames' limits
(``test_torch_slice.LIMITS``, ``test_torch_train_slice.SLICE_LIMITS``),
with two changes for this scene, each stated where ``HAIR_LIMITS`` is set.

Three more decisions count a ray as flipped (``test_torch_slice.ray_flips``):
a fibre normal, a hair sample or a hair evaluation that the two sides'
inputs moved apart (``_normal_moved``, ``_hair_moved``). A round cone's
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
from test_hair_render import build_scene as strand_patch_scene
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
# the round cone's t, the port's own against the JAX hit, in float32 ulp
# over the square root of the root's relative discriminant (its chord over
# t): a camera ray's fibre hit reads 1e-6 of its terms in h, so 5e-4
# relative in t is 8 ulp / 1e-3
T_COND = 64
# two segments of a strand at the same t (the sphere at their joint),
# relative to the root's scale (reads 1.5e-4)
TIE_RTOL = 1e-3
# the port's cone test may miss a JAX hit at a graze: its smallest root's
# discriminant within H_DECISION of 0, relative to its terms (a camera ray's
# hits read 1.6e-7 to 2.5e-6, the grazes 0 to 1.8e-7: its terms k1^2 and
# k0 k2 each carry the cancellation of d2 m5 against m1^2), or at the body / cap
# border: y within Y_DECISION of 0 or d2, relative to d2
H_DECISION = 5e-7
Y_DECISION = 1e-3
# the port's hair sample / evaluation at the JAX inputs against the JAX
# output: directions and the values relative to their size
HAIR_ATOL = 2e-4
HAIR_DECISION = 1e-5
# a fibre normal moved apart: half the query bound, so that the query's
# encoding of the normal (elevation, azimuth) stays under it (2.07e-5 read
# for a normal 1.9e-5 apart)
NORMAL_APART = 1e-5
# the port's fibre normal at the JAX hit point against the JAX normal (reads
# 3.0e-5): the body normal d2 (x - pa) - ba y subtracts two terms of size
# |ba|^2 |x - pa| to leave d2 r, r down to 0.006 at a tip, and XLA contracts
# the product into an FMA
FRAME_ATOL = 1e-4
# the box's limits but two. The first hits' t: the block's top face is seen
# at a grazing angle (n.d ~ 0.1) under this camera, where the plane form's
# t = -(n.o + d0) / (n.d) reads 5 ulp apart (4 on the box). The flipped
# share: the rays that meet a fibre part at its normal or its lobe's
# conditioning (reads 0.167 NO_CACHE, 0.120 FULL, 0.120 FULL + train; 15 %
# of the camera rays hit a fibre first)
HAIR_LIMITS = dict(LIMITS, first_t_ulp=6, flipped_share=0.2)
HAIR_SLICE_LIMITS = dict(SLICE_LIMITS, flipped_share=0.2)
# curve decisions seen by the checks of one test (for its reporting)
_DECISIONS = {"curve": 0, "curve_ties": 0}
# set while a check calls the port's hair functions: the wrappers log nothing
_QUIET = []
_PORT_FRAME = port_curves.curve_shading_frame  # unwrapped, for the checks


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


HAIR_FIELDS = port_hair.HairParams._fields


def _curve_won(log, n):
    """The lanes whose last n-ray curve call won over the triangles: where
    the hair lobe's result is used."""
    tri = next(a for tag, a in reversed(log) if tag == "closest" and a[0].shape[0] == n)
    cur = next(a for tag, a in reversed(log) if tag == "curve" and a[0].shape[0] == n)
    tri_t = np.where(tri[-1] >= 0, tri[2], 3.0e38)
    return (cur[5] >= 0) & (cur[4] < tri_t) & (cur[0] > 0.0)


def _hair_logging(side, name, fn):
    """``hair_sample`` / ``hair_eval`` logging (name, [used lanes, params...,
    inputs..., outputs...])."""
    if side == "port":
        def port_fn(params, *args):
            out = fn(params, *args)
            if _QUIET:
                return out
            used = _curve_won(_LOG["port"], args[0].shape[0])
            _LOG["port"].append((name, [used] + [np.asarray(t).copy() for t in (*params, *args, *out)]))
            return out
        return port_fn

    def jax_fn(params, *args):
        out = fn(params, *args)

        def log(*arrays):
            arrays = [np.asarray(a) for a in arrays]
            _LOG["jax"].append((name, [_curve_won(_LOG["jax"], arrays[-1].shape[0])] + arrays))

        jax.debug.callback(log, *params, *args, *out, ordered=True)
        return out
    return jax_fn


def _frame_logging(side, fn):
    """``curve_shading_frame`` logging ("cframe", [used lanes, prim, hit
    point, normal])."""
    if side == "port":
        def port_frame(table, prim, x):
            out = fn(table, prim, x)
            used = _curve_won(_LOG["port"], x.shape[0])
            _LOG["port"].append(("cframe", [used, prim.numpy().copy(), x.numpy().copy(), out.normal.numpy().copy()]))
            return out
        return port_frame

    def jax_frame_fn(curves, prim, x):
        out = fn(curves, prim, x)

        def log(*arrays):
            arrays = [np.asarray(a) for a in arrays]
            _LOG["jax"].append(("cframe", [_curve_won(_LOG["jax"], arrays[0].shape[0])] + arrays))

        jax.debug.callback(log, prim, x, out.normal, ordered=True)
        return out
    return jax_frame_fn


def _normal_moved(table):
    """The rays whose fibre normal the two sides' hit points moved apart by
    more than ``NORMAL_APART``, among the lanes whose curve hit won: a round
    cone's normal turns by the hit point's move over the fibre's radius
    (0.006 at a tip), so a move of a few ulp turns it by 1e-4. The port's
    frame at the JAX inputs must give the JAX normal within ``FRAME_ATOL``."""
    def moved(j, p):
        (used_j, prim_j, x_j, n_j), (used_p, _, _, n_p) = j, p
        apart = (used_j | used_p) & (np.abs(n_j - n_p).max(-1) > NORMAL_APART)
        at_jax = _PORT_FRAME(table, torch.from_numpy(prim_j.astype(np.int64)),
                             torch.from_numpy(x_j.copy())).normal.numpy()
        off = np.abs(at_jax - n_j)[used_j].max(initial=0.0)
        assert off <= FRAME_ATOL, f"the port's fibre normal at the JAX inputs is {off} off the JAX normal"
        return apart
    return moved


def _unit(q):
    """A query's (elevation, azimuth) pair as the unit vector it encodes."""
    th, ph = q[..., 0], q[..., 1]
    return np.stack([np.sin(th) * np.cos(ph), np.sin(th) * np.sin(ph), np.cos(th)], -1)


def query_gap_unit(a, b):
    """The gap between two sets of queries with the direction and normal
    read as the unit vectors they encode: the azimuth of a direction near
    the query's pole (+-z) turns by its move over its distance from the
    pole, so a fibre normal that faces a ray along z (the strand patch, the
    camera of ``cornell_hair``) reads its azimuth 1e-4 apart for normals
    1e-6 apart."""
    gap = np.abs(a - b)
    for c in (3, 5):
        gap[..., c:c + 2] = np.abs(_unit(a[..., c:c + 2]) - _unit(b[..., c:c + 2])).max(-1, keepdims=True)
    return gap


def _cone_terms(o, d, seg, prim):
    """The round-cone test's terms for segment ``prim`` (clamped at 0) of
    ``seg`` (``CurveSoA`` of tensors) and the rays (o, d), in
    ``_roundcone_t``'s operations: each root's discriminant relative to its
    terms (``h``: the body's h / (k1^2 + |k0 k2|); ``h1``, ``h2``: the end
    spheres'), the smallest of the three in size (``graze``), and the
    body's y at its root relative to d2 (its distance from the body/cap
    border, ``y``)."""
    p = torch.clamp(torch.from_numpy(np.asarray(prim, np.int64)), min=0)
    o, d = torch.from_numpy(o.copy()), torch.from_numpy(d.copy())
    pa, ba, ra, rb, m0 = seg.pa[p], seg.ba[p], seg.ra[p], seg.rb[p], seg.m0[p]
    s3 = port_curves._sum3
    oa = o - pa
    ob = oa - ba
    rr = ra - rb
    m1, m2, m3, m5, m6, m7 = s3(ba, oa), s3(ba, d), s3(d, oa), s3(oa, oa), s3(ob, d), s3(ob, ob)
    d2 = m0 - rr * rr
    k2 = d2 - m2 * m2
    k1 = d2 * m3 - m1 * m2 + m2 * rr * ra
    k0 = d2 * m5 - m1 * m1 + m1 * rr * ra * 2.0 - m0 * ra * ra
    h = k1 * k1 - k0 * k2
    t_body = (-torch.sqrt(torch.clamp(h, min=0.0)) - k1) / torch.where(k2.abs() > 1e-20, k2, 1.0)
    y = m1 - ra * rr + t_body * m2
    h1, h2 = m3 * m3 - m5 + ra * ra, m6 * m6 - m7 + rb * rb
    rel = dict(h=h / (k1 * k1 + (k0 * k2).abs()), h1=h1 / (m3 * m3 + m5 + ra * ra), h2=h2 / (m6 * m6 + m7 + rb * rb),
               y=torch.minimum(y.abs(), (d2 - y).abs()) / d2.abs().clamp(min=1e-20))
    # the worst conditioned of the three roots: the one whose discriminant
    # keeps the least of its terms
    rel["graze"] = torch.minimum(rel["h"].abs(), torch.minimum(rel["h1"].abs(), rel["h2"].abs()))
    return {k: v.numpy() for k, v in rel.items()}


def _curve_call(seg):
    """The check of one curve call (``ray_flips`` handler), the port's own
    hit against the JAX hit, on the rays that have not parted at an earlier
    decision (origin and direction within the query bound):

    - the port's cone test at the JAX ray and segment gives the JAX t within
      T_COND ulp of the root's scale (t, or the origin's distance from the
      segment where that is larger: a ray leaving a fibre) over the square
      root of the root's relative discriminant; it may miss it only at a
      decision: a graze (a relative discriminant within ``H_DECISION`` of 0),
      the body/cap border (y within ``Y_DECISION`` of 0 or d2) or the t
      range's start (a ray leaving a fibre meets it again at tmin);
    - where the walks name different segments, each is the closest on its
      own ray: the port's cone test on the port's ray puts the JAX segment
      no nearer than the port's winner (else the walk missed it), and the
      two t are an equal-t tie (``TIE_RTOL`` of the scale: two segments of a
      strand share the sphere at their joint), or one side's segment is
      missed on the other side's ray (the rays' last bits decide) or grazes
      there (the two arithmetics decide).

    No ray flips: the port's bounce takes the JAX hit."""
    def cone_t(o, d, k, tn, tf):
        k = np.maximum(k, 0)
        return port_curves._roundcone_t(*(torch.from_numpy(np.array(a)) for a in (
            o, d, seg.pa[k].numpy(), seg.ba[k].numpy(), seg.ra[k].numpy(), seg.rb[k].numpy(), seg.m0[k].numpy(),
            tn, tf))).numpy()

    def check(j, p):
        (tf_j, tn_j, o_j, d_j, t_j, prim_j), (tf_p, tn_p, o_p, d_p, t_p, prim_p) = j, p
        same_ray = (np.abs(o_j - o_p).max(-1) <= LIMITS["query_abs"]) & (
            np.abs(d_j - d_p).max(-1) <= LIMITS["query_abs"]) & (tf_j > 0.0) & (tf_p > 0.0)
        hit_j = same_ray & (prim_j >= 0)
        k = np.maximum(prim_j, 0)
        scale = np.maximum(np.abs(t_j), np.linalg.norm(o_j - seg.pa[k].numpy(), axis=-1))
        t_at = cone_t(o_j, d_j, prim_j, tn_j, tf_j)
        terms = _cone_terms(o_j, d_j, seg, prim_j)
        bound = T_COND * np.finfo(np.float32).eps / np.sqrt(np.maximum(terms["graze"], 1e-30))
        missed = hit_j & (t_at >= port_curves.RT_MAX)
        decided = (terms["graze"] <= H_DECISION) | (terms["y"] <= Y_DECISION) | (
            np.abs(t_j - tn_j) <= bound * scale)
        assert not (missed & ~decided).any(), "the port's cone test misses a JAX hit off a decision"
        held = hit_j & ~missed
        worst = (np.abs(t_at - t_j)[held] / scale[held] / bound[held]).max(initial=0.0)
        _DECISIONS["worst_t_ratio"] = max(_DECISIONS.get("worst_t_ratio", 0.0), float(worst))
        assert worst <= 1.0, f"the port's cone test at the JAX inputs is {worst} of its bound off the JAX t"

        flip = same_ray & (prim_j != prim_p)
        # the JAX winner on the port's ray must be no nearer than the port's
        t_pj = cone_t(o_p, d_p, prim_j, tn_p, tf_p)
        t_win = np.where(prim_p >= 0, t_p, port_curves.RT_MAX)
        walk_missed = flip & (prim_j >= 0) & (t_pj < t_win)
        assert not walk_missed.any(), (
            f"the port's walk missed a nearer segment on its own ray: {prim_j[walk_missed]} at "
            f"{t_pj[walk_missed]}, took {prim_p[walk_missed]} at {t_p[walk_missed]}")
        tie = flip & (prim_j >= 0) & (prim_p >= 0) & (np.abs(t_p - t_j) <= TIE_RTOL * scale)
        t_jp = cone_t(o_j, d_j, prim_p, tn_j, tf_j)
        apart = flip & ((t_pj >= port_curves.RT_MAX) | (t_jp >= port_curves.RT_MAX))
        # or one winner grazes on the other ray, where the two arithmetics
        # (FMA or not) decide the hit apart
        for o, d, prim in ((o_j, d_j, prim_p), (o_p, d_p, prim_j)):
            rel = _cone_terms(o, d, seg, prim)
            apart |= flip & (prim >= 0) & ((rel["graze"] <= H_DECISION) | (rel["y"] <= Y_DECISION))
        unexplained = flip & ~tie & ~apart
        assert not unexplained.any(), (
            f"{unexplained.sum()} curve hits flipped without a tie or a decision: jax {prim_j[unexplained]} "
            f"t {t_j[unexplained]}, port {prim_p[unexplained]} t {t_p[unexplained]}")
        _DECISIONS["curve"] += int(flip.sum())
        _DECISIONS["curve_ties"] += int(tie.sum())
        return np.zeros(t_j.shape[0], bool)
    return check


def _hair_moved(name):
    """The rays whose hair sample (or evaluation) the two sides' inputs
    moved apart by more than the query bound, among the lanes that use it;
    the port's function at the JAX inputs must give the JAX outputs within
    ``HAIR_ATOL`` (relative for the values) except at the lobe pick's
    decisions."""
    n_params = len(HAIR_FIELDS)
    n_in = 3  # (wo, h, xi) of a sample, (wo, wi, h) of an evaluation

    def moved(j, p):
        used = j[0] | p[0]  # the port's bounce takes the JAX hit: either side's lanes
        params_j, ins_j, outs_j = j[1:1 + n_params], j[1 + n_params:1 + n_params + n_in], j[1 + n_params + n_in:]
        outs_p = p[1 + n_params + n_in:]
        apart = np.zeros(used.shape[0], bool)
        for a, b in zip(outs_j, outs_p):
            diff = np.abs(a - b) / np.maximum(np.abs(a), 1.0)
            apart |= (diff.reshape(diff.shape[0], -1) > LIMITS["query_abs"]).any(-1)
        apart &= used
        params = port_hair.HairParams(*(torch.from_numpy(a.copy()) for a in params_j))
        ins = [torch.from_numpy(a.copy()) for a in ins_j]
        _QUIET.append(True)
        try:
            at_jax = [t.numpy() for t in getattr(port_hair, "hair_sample" if name == "hair" else "hair_eval")(
                params, *ins)]
        finally:
            _QUIET.pop()
        decision = np.zeros_like(apart)
        if name == "hair":
            wo, h, _ = ins
            cdf = port_hair._lobe_cdf(port_hair._lobe_pdf(port_hair._attenuations(
                port_hair._geometry(wo, h, params)))).numpy()
            w = params_j[HAIR_FIELDS.index("diffuse_weight")]
            u0 = np.clip(ins_j[2][:, 0] / np.maximum(1.0 - w, 1e-6), 0.0, 1.0)
            decision = (ins_j[2][:, 0] < 1.0 - w) & (np.abs(u0[:, None] - cdf[:, :3]) <= HAIR_DECISION).any(-1)
        for a, b in zip(at_jax, outs_j):
            off = (np.abs(a - b) / np.maximum(np.abs(b), 1.0)).reshape(a.shape[0], -1).max(-1)
            worst = off[apart & ~decision].max(initial=0.0)
            assert worst <= HAIR_ATOL, f"the port's {name} at the JAX inputs is {worst} off the JAX output"
        return apart
    return moved


@contextlib.contextmanager
def hair_logged(seg_of):
    """Both sides' curve calls, fibre frames and hair lobes logged, the
    port's bounce on the JAX curve hits; ``seg_of()`` gives the scene's
    ``CurveSoA`` of tensors for the checks."""
    handlers = {"curve": lambda j, p: _curve_call(seg_of())(j, p), "hair": _hair_moved("hair"),
                "hair_eval": _hair_moved("hair_eval"),
                "cframe": lambda j, p: _normal_moved(torch.from_numpy(port_curves.curve_row_table(seg_of())))(j, p)}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(test_torch_slice, "MOVED", dict(test_torch_slice.MOVED, **handlers))
        mp.setattr(test_torch_slice, "QUERY_GAP", query_gap_unit)
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
    hair_hits = _curve_won(_LOG["port"], n)  # the last bounce's; the first call's below
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
        assert query_gap_unit(got["rec_query"], ref["rec_query"])[slots].max() <= LIMITS["query_abs"]
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
