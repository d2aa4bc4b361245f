"""Where two correct float32 evaluations of a hair frame part a ray, and the
witness of each.

A frame of ``cornell_hair`` on two sides that round apart (the JAX package
and the port on the CPU, ``tests/test_torch_hair_slice.py``; the card and
the CPU, ``chip_smoke.py`` phase 6h) parts the rays that meet a fibre at
a few decisions, which the logged calls of both sides show ray by ray
(``reference`` and ``other`` below: each a list of arrays in the order the
logging wrappers record them):

- a curve hit (``curve_call``): the round cone's t is ill-conditioned (its
  two roots lie a fibre's chord apart, about 1e-3 of t, and its
  discriminant keeps about 1e-6 of its terms), so the two sides' t of one
  segment lie up to ``T_COND`` ulp of t over the root of the relative
  discriminant apart; the walks may name different segments at an equal-t
  tie, at a graze (a relative discriminant within ``H_DECISION`` of 0) or
  at the body / cap border (y within ``Y_DECISION`` of 0 or d2);
- a fibre normal (``normal_moved``): it turns by the hit point's move over
  the fibre's radius (down to 0.006), so a move of a few ulp turns it by
  1e-4;
- a hair sample or evaluation (``hair_moved``): the longitudinal and
  azimuthal terms take arcsines and logarithms of h, ill-conditioned at a
  graze (|h| near 1), and the lobe pick compares a uniform with the lobe
  cdf (a decision within ``HAIR_DECISION``);
- a triangle hit or occlusion (``hit_flips``), as on the box.

Each check holds its witness: the function of the ``other`` side at the
``reference`` side's inputs gives the reference output within its bound
(``T_COND``, ``FRAME_ATOL``, ``HAIR_ATOL``), so that what parts the rays is
the inputs' last bits and not the functions. The queries' direction and
normal are read as the unit vectors they encode (``query_gap_unit``).

No JAX here: the module is the port's, and both the CPU tests and the card's
smoke test read it.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import curve_intersect as C
from ..ops import hair_bsdf as H

# the round cone's t, the other side's cone test at the reference inputs
# against the reference t, in float32 ulp over the square root of the
# root's relative discriminant (its chord over t): a camera ray's fibre hit
# reads 1e-6 of its terms in h, so 5e-4 relative in t is 8 ulp / 1e-3
T_COND = 64
# two segments of a strand at the same t (the sphere at their joint),
# relative to the root's scale (reads 1.5e-4)
TIE_RTOL = 1e-3
# a cone test may miss the other side's hit at a graze: its smallest root's
# discriminant within H_DECISION of 0, relative to its terms (a camera ray's
# hits read 1.6e-7 to 2.5e-6, the grazes 0 to 1.8e-7: its terms k1^2 and
# k0 k2 each carry the cancellation of d2 m5 against m1^2), or at the body /
# cap border: y within Y_DECISION of 0 or d2, relative to d2
H_DECISION = 5e-7
Y_DECISION = 1e-3
# the other side's hair sample / evaluation at the reference inputs against
# the reference output: directions and the values relative to their size
HAIR_ATOL = 2e-4
HAIR_DECISION = 1e-5
# a fibre normal moved apart: half the query bound, so that the query's
# encoding of the normal (elevation, azimuth) stays under it (2.07e-5 read
# for a normal 1.9e-5 apart)
NORMAL_APART = 1e-5
# the other side's fibre normal at the reference hit point against the
# reference normal (reads 3.0e-5 between the packages): the body normal
# d2 (x - pa) - ba y subtracts two terms of size |ba|^2 |x - pa| to leave
# d2 r, r down to 0.006 at a tip, and XLA contracts the product into an FMA
FRAME_ATOL = 1e-4
# the box frames' query bound (tests/test_torch_slice.py, LIMITS["query_abs"]):
# an origin, a direction or a query entry this far apart is the same ray's
QUERY_ABS = 2e-5
# the box frames' limits that a hair frame reads otherwise. The first hits'
# t: the block's top face is seen at a grazing angle (n.d ~ 0.1) under this
# camera, where the plane form's t = -(n.o + d0) / (n.d) reads 5 ulp apart
# (4 on the box). The flipped share: the rays that meet a fibre part at its
# normal or its lobe's conditioning (reads 0.167 NO_CACHE, 0.120 FULL, 0.120
# FULL + train against the JAX package; 15 % of the camera rays hit a fibre
# first)
HAIR_LIMIT_CHANGES = {"first_t_ulp": 6, "flipped_share": 0.2}

# the port's functions as imported: a logging wrapper installed later
# (monkeypatched in) is not what the witnesses call
_SHADING_FRAME = C.curve_shading_frame
_HAIR = {"hair": H.hair_sample, "hair_eval": H.hair_eval}
HAIR_FIELDS = H.HairParams._fields


def hit_flips(reference, other):
    """The rays of one logged triangle call that both sides cast and that
    found another triangle (closest: tmax, direction, t, prim) or another
    occlusion (shadow: tmax, occluded)."""
    return (reference[0] > 0.0) & (other[0] > 0.0) & (reference[-1] != other[-1])


def curve_won(log, n):
    """The lanes whose last n-ray curve call won over the triangles, in a
    log of (tag, arrays) entries: where the hair lobe's result is used."""
    tri = next(a for tag, a in reversed(log) if tag == "closest" and a[0].shape[0] == n)
    cur = next(a for tag, a in reversed(log) if tag == "curve" and a[0].shape[0] == n)
    tri_t = np.where(tri[-1] >= 0, tri[2], 3.0e38)
    return (cur[5] >= 0) & (cur[4] < tri_t) & (cur[0] > 0.0)


def unit(q):
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
        gap[..., c:c + 2] = np.abs(unit(a[..., c:c + 2]) - unit(b[..., c:c + 2])).max(-1, keepdims=True)
    return gap


def cone_terms(o, d, seg, prim):
    """The round-cone test's terms for segment ``prim`` (clamped at 0) of
    ``seg`` (``CurveSoA`` of tensors) and the rays (o, d), in
    ``_roundcone_t``'s operations: each root's discriminant relative to its
    terms (``h``: the body's h / (k1^2 + |k0 k2|); ``h1``, ``h2``: the end
    spheres'), the smallest of the three in size (``graze``), and the
    body's y at its root relative to d2 (its distance from the body/cap
    border, ``y``)."""
    p = torch.clamp(torch.from_numpy(np.asarray(prim, np.int64)), min=0)
    o, d = torch.from_numpy(np.array(o, np.float32)), torch.from_numpy(np.array(d, np.float32))
    pa, ba, ra, rb, m0 = seg.pa[p], seg.ba[p], seg.ra[p], seg.rb[p], seg.m0[p]
    s3 = C._sum3
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


class DecisionError(AssertionError):
    """A ray that parts off every decision and its witness."""


def _require(cond, what):
    if not cond:
        raise DecisionError(what)


def curve_call(seg, counts, takes_reference_hit=True):
    """The check of one logged curve call (tmax, tmin, origin, direction, t,
    prim) of both sides, on the rays that have not parted at an earlier
    decision (origin and direction within ``QUERY_ABS``):

    - the other side's cone test at the reference ray and segment gives the
      reference t within T_COND ulp of the root's scale (t, or the origin's
      distance from the segment where that is larger: a ray leaving a
      fibre) over the square root of the root's relative discriminant; it
      may miss it only at a decision: a graze (a relative discriminant
      within ``H_DECISION`` of 0), the body/cap border (y within
      ``Y_DECISION`` of 0 or d2) or the t range's start (a ray leaving a
      fibre meets it again at tmin);
    - where the walks name different segments, each is the closest on its
      own ray: the other side's cone test on its own ray puts the reference
      segment no nearer than its winner (else the walk missed it), and the
      two t are an equal-t tie (``TIE_RTOL`` of the scale: two segments of
      a strand share the sphere at their joint), or one side's segment is
      missed on the other side's ray (the rays' last bits decide) or grazes
      there (the two arithmetics decide).

    With ``takes_reference_hit`` (the other side's bounce goes on from the
    reference hit) no ray parts here. Without it a ray parts where the two
    segments differ, and where one segment's two hit points lie more than
    ``QUERY_ABS`` apart (t's conditioning): its gap must be within the
    conditioning's reach of the two rays' own gap, T_COND (eps scale + the
    rays' gap) over the root of the relative discriminant. ``counts`` gathers
    the decisions by kind."""
    def cone_t(o, d, k, tn, tf):
        k = np.maximum(k, 0)
        return C._roundcone_t(*(torch.from_numpy(np.array(a)) for a in (
            o, d, seg.pa[k].numpy(), seg.ba[k].numpy(), seg.ra[k].numpy(), seg.rb[k].numpy(), seg.m0[k].numpy(),
            tn, tf))).numpy()

    def check(j, p):
        (tf_j, tn_j, o_j, d_j, t_j, prim_j), (tf_p, tn_p, o_p, d_p, t_p, prim_p) = j, p
        same_ray = (np.abs(o_j - o_p).max(-1) <= QUERY_ABS) & (
            np.abs(d_j - d_p).max(-1) <= QUERY_ABS) & (tf_j > 0.0) & (tf_p > 0.0)
        hit_j = same_ray & (prim_j >= 0)
        k = np.maximum(prim_j, 0)
        scale = np.maximum(np.abs(t_j), np.linalg.norm(o_j - seg.pa[k].numpy(), axis=-1))
        t_at = cone_t(o_j, d_j, prim_j, tn_j, tf_j)
        terms = cone_terms(o_j, d_j, seg, prim_j)
        root = np.sqrt(np.maximum(terms["graze"], 1e-30))
        bound = T_COND * np.finfo(np.float32).eps / root
        missed = hit_j & (t_at >= C.RT_MAX)
        decided = (terms["graze"] <= H_DECISION) | (terms["y"] <= Y_DECISION) | (
            np.abs(t_j - tn_j) <= bound * scale)
        _require(not (missed & ~decided).any(), "a cone test misses the reference hit off a decision")
        held = hit_j & ~missed
        worst = (np.abs(t_at - t_j)[held] / scale[held] / bound[held]).max(initial=0.0)
        counts["worst_t_ratio"] = max(counts.get("worst_t_ratio", 0.0), float(worst))
        _require(worst <= 1.0, f"a cone test at the reference inputs is {worst} of its bound off the reference t")

        flip = same_ray & (prim_j != prim_p)
        # the reference winner on the other ray must be no nearer than its own
        t_pj = cone_t(o_p, d_p, prim_j, tn_p, tf_p)
        t_win = np.where(prim_p >= 0, t_p, C.RT_MAX)
        walk_missed = flip & (prim_j >= 0) & (t_pj < t_win)
        _require(not walk_missed.any(), (
            f"a walk missed a nearer segment on its own ray: {prim_j[walk_missed]} at "
            f"{t_pj[walk_missed]}, took {prim_p[walk_missed]} at {t_p[walk_missed]}"))
        tie = flip & (prim_j >= 0) & (prim_p >= 0) & (np.abs(t_p - t_j) <= TIE_RTOL * scale)
        t_jp = cone_t(o_j, d_j, prim_p, tn_j, tf_j)
        apart = flip & ((t_pj >= C.RT_MAX) | (t_jp >= C.RT_MAX))
        # or one winner grazes on the other ray, where the two arithmetics
        # (FMA or not) decide the hit apart
        for o, d, prim in ((o_j, d_j, prim_p), (o_p, d_p, prim_j)):
            rel = cone_terms(o, d, seg, prim)
            apart |= flip & (prim >= 0) & ((rel["graze"] <= H_DECISION) | (rel["y"] <= Y_DECISION))
        unexplained = flip & ~tie & ~apart
        _require(not unexplained.any(), (
            f"{unexplained.sum()} curve hits flipped without a tie or a decision: reference {prim_j[unexplained]} "
            f"t {t_j[unexplained]}, other {prim_p[unexplained]} t {t_p[unexplained]}"))
        counts["curve"] = counts.get("curve", 0) + int(flip.sum())
        counts["curve_ties"] = counts.get("curve_ties", 0) + int(tie.sum())
        if takes_reference_hit:
            return np.zeros(t_j.shape[0], bool)
        # one segment hit on both rays (a miss's t is RT_MAX: only these lanes)
        i = np.nonzero(same_ray & ~flip & (prim_j >= 0) & ~missed)[0]
        tj, tp = t_j[i].astype(np.float64), t_p[i].astype(np.float64)
        moved = np.abs((o_j[i] + tj[:, None] * d_j[i]) - (o_p[i] + tp[:, None] * d_p[i])).max(-1) > QUERY_ABS
        rays_gap = np.maximum(np.abs(o_j[i] - o_p[i]).max(-1), np.abs(d_j[i] - d_p[i]).max(-1) * scale[i])
        reach = T_COND * (np.finfo(np.float32).eps * scale[i] + rays_gap) / root[i]
        beyond = moved & (np.abs(tj - tp) > reach)
        _require(not beyond.any(), (
            f"{beyond.sum()} fibre hits apart beyond t's conditioning: t {tj[beyond]} and {tp[beyond]}, "
            f"reach {reach[beyond]}"))
        counts["t_conditioning"] = counts.get("t_conditioning", 0) + int(moved.sum())
        parted = flip.copy()
        parted[i[moved]] = True
        return parted
    return check


def normal_moved(table, counts=None):
    """The check of one logged fibre frame (used lanes, prim, hit point,
    normal) of both sides: the rays whose fibre normal the two sides' hit
    points moved apart by more than ``NORMAL_APART``, among the lanes whose
    curve hit won. The other side's frame at the reference inputs must give
    the reference normal within ``FRAME_ATOL``."""
    def moved(j, p):
        (used_j, prim_j, x_j, n_j), (used_p, _, _, n_p) = j, p
        apart = (used_j | used_p) & (np.abs(n_j - n_p).max(-1) > NORMAL_APART)
        at_ref = _SHADING_FRAME(table, torch.from_numpy(prim_j.astype(np.int64)),
                                torch.from_numpy(x_j.copy())).normal.numpy()
        off = np.abs(at_ref - n_j)[used_j].max(initial=0.0)
        _require(off <= FRAME_ATOL, f"a fibre normal at the reference inputs is {off} off the reference normal")
        if counts is not None:
            counts["normal"] = counts.get("normal", 0) + int(apart.sum())
        return apart
    return moved


def hair_moved(name, counts=None):
    """The check of one logged hair sample (``name`` "hair") or evaluation
    ("hair_eval") of both sides (used lanes, params..., inputs...,
    outputs...): the rays whose result the two sides' inputs moved apart by
    more than ``QUERY_ABS``, among the lanes that use it. The other side's
    function at the reference inputs must give the reference outputs within
    ``HAIR_ATOL`` (relative for the values) except at the lobe pick's
    decisions."""
    n_params = len(HAIR_FIELDS)
    n_in = 3  # (wo, h, xi) of a sample, (wo, wi, h) of an evaluation

    def moved(j, p):
        used = j[0] | p[0]
        params_j, ins_j, outs_j = j[1:1 + n_params], j[1 + n_params:1 + n_params + n_in], j[1 + n_params + n_in:]
        outs_p = p[1 + n_params + n_in:]
        apart = np.zeros(used.shape[0], bool)
        for a, b in zip(outs_j, outs_p):
            diff = np.abs(a - b) / np.maximum(np.abs(a), 1.0)
            apart |= (diff.reshape(diff.shape[0], -1) > QUERY_ABS).any(-1)
        apart &= used
        params = H.HairParams(*(torch.from_numpy(a.copy()) for a in params_j))
        ins = [torch.from_numpy(a.copy()) for a in ins_j]
        at_ref = [t.numpy() for t in _HAIR[name](params, *ins)]
        decision = np.zeros_like(apart)
        if name == "hair":
            wo, h, _ = ins
            cdf = H._lobe_cdf(H._lobe_pdf(H._attenuations(H._geometry(wo, h, params)))).numpy()
            w = params_j[HAIR_FIELDS.index("diffuse_weight")]
            u0 = np.clip(ins_j[2][:, 0] / np.maximum(1.0 - w, 1e-6), 0.0, 1.0)
            decision = (ins_j[2][:, 0] < 1.0 - w) & (np.abs(u0[:, None] - cdf[:, :3]) <= HAIR_DECISION).any(-1)
        for a, b in zip(at_ref, outs_j):
            off = (np.abs(a - b) / np.maximum(np.abs(b), 1.0)).reshape(a.shape[0], -1).max(-1)
            worst = off[apart & ~decision].max(initial=0.0)
            _require(worst <= HAIR_ATOL, f"{name} at the reference inputs is {worst} off the reference output")
        if counts is not None:
            counts[name] = counts.get(name, 0) + int(apart.sum())
            counts["lobe_pick"] = counts.get("lobe_pick", 0) + int((apart & decision).sum())
        return apart
    return moved
