"""Ray / round-cone intersection for hair and curve primitives.

Port of ``nrc_tpu/ops/curve_intersect.py:25-130, 158-179, 300-372`` (the
counterpart of OptiX's built-in cubic B-spline curve intersector and
``__closesthit__curves``, reference ``Device.cpp:857-863``,
``hit.cu:1665-2046``). Strands are tessellated on the host into round cones,
linear segments swept by a sphere whose radius varies linearly
(``scene/hair.py``), which have a closed-form quadratic intersection.

- ``_roundcone_t``: the test of one ray against one segment (lateral
  surface and two end spheres), shape-polymorphic over a batch;
- ``CurveSoA.build``: the host arrays a scene uploads (``ba = pb - pa``,
  ``m0 = |ba|^2`` precomputed), and ``curve_row_table``: the same per
  segment as one packed row of ``CURVE_ROW_WORDS`` words (pa, ba, ra, rb, m0,
  u_a, u_b, reference, color_a, color_b, material_id as bits), which the
  bounce fetches with one K7 row gather a bounce (``ops/gather_cuda.py``);
- ``build_wide_curve_bvh``: the binned SAH over the segments' boxes and the
  wide collapse of ``ops/bvh_wide.py`` with 9-float payload rows pa | ba |
  ra, rb, m0, at the JAX package's defaults (branch 8, leaf 8, max_leaf 4);
- ``intersect_curves_bvh`` / ``occluded_curves_bvh``: the wide walk with
  the cone leaf (``ops/intersect_wide.py``; C1/C2 on the card) at every
  segment count;
- ``intersect_curves_bruteforce``: every ray against every segment, the
  tests' independent oracle;
- ``curve_shading_frame``: the normal, tangent, azimuthal frame, fibre
  coordinates and colour at a hit, from the hit's packed row.

Not ported: ``build_curve_bvh`` and the binary skip-link walk
(``_skip_traverse_curves``, ``_chunked_traverse_curves``), which the JAX
package takes at or below 16,384 segments; the port walks every BVH it has
with the wide walk, as it does for triangles. The two walks find the same
closest hit, apart from the winner between segments at equal t.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..utils.math import cross, dot
from .bvh import build_bvh
from .bvh_wide import flatten_wide_rows
from .gather_cuda import gather_rows

DENOM = 1e-20
RT_MAX = 3.0e38

# the packed per-segment row of the shading fetch: column ranges by field
CURVE_ROW = {
    "pa": (0, 3), "ba": (3, 6), "ra": (6, 7), "rb": (7, 8), "m0": (8, 9), "u_a": (9, 10),
    "u_b": (10, 11), "reference": (11, 14), "color_a": (14, 17), "color_b": (17, 20),
    "material_id": (20, 21),
}
CURVE_ROW_WORDS = 21


class CurveHit(NamedTuple):
    t: torch.Tensor     # [N]
    prim: torch.Tensor  # [N] i64 segment id (-1 = miss)

    @property
    def valid(self) -> torch.Tensor:
        return self.prim >= 0


def segment_aabb_corners(pa, pb, ra, rb):
    """Conservative per-segment AABB corner points for the BVH builder (fed
    as degenerate "triangles" to the binned SAH)."""
    lo = np.minimum(pa - ra[:, None], pb - rb[:, None]).astype(np.float32)
    hi = np.maximum(pa + ra[:, None], pb + rb[:, None]).astype(np.float32)
    return lo, hi, lo.copy()


def _sum3(a, b):
    """Dot product over the trailing axis of 3, summed left to right."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _roundcone_t(o, d, pa, ba, ra, rb, m0, tmin, tmax):
    """Round-cone intersection: the smallest t in (tmin, tmax), or RT_MAX.

    The lateral surface by the quadratic in (k2, k1, k0), the end spheres at
    pa (radius ra) and pa + ba (rb). ``d`` must be of unit length. Points and
    vectors [..., 3], the rest [...], broadcast together."""
    oa = o - pa
    ob = oa - ba
    rr = ra - rb
    m1 = _sum3(ba, oa)
    m2 = _sum3(ba, d)
    m3 = _sum3(d, oa)
    m5 = _sum3(oa, oa)
    m6 = _sum3(ob, d)
    m7 = _sum3(ob, ob)

    d2 = m0 - rr * rr
    k2 = d2 - m2 * m2
    k1 = d2 * m3 - m1 * m2 + m2 * rr * ra
    k0 = d2 * m5 - m1 * m1 + m1 * rr * ra * 2.0 - m0 * ra * ra

    h = k1 * k1 - k0 * k2
    ok2 = torch.abs(k2) > DENOM
    t_body = (-torch.sqrt(torch.clamp(h, min=0.0)) - k1) / torch.where(ok2, k2, 1.0)
    y = m1 - ra * rr + t_body * m2
    body_ok = (h >= 0.0) & ok2 & (y > 0.0) & (y < d2) & (t_body > tmin) & (t_body < tmax)
    t_body = torch.where(body_ok, t_body, RT_MAX)

    h1 = m3 * m3 - m5 + ra * ra
    t_ca = -m3 - torch.sqrt(torch.clamp(h1, min=0.0))
    t_ca = torch.where((h1 >= 0.0) & (t_ca > tmin) & (t_ca < tmax), t_ca, RT_MAX)

    h2 = m6 * m6 - m7 + rb * rb
    t_cb = -m6 - torch.sqrt(torch.clamp(h2, min=0.0))
    t_cb = torch.where((h2 >= 0.0) & (t_cb > tmin) & (t_cb < tmax), t_cb, RT_MAX)
    return torch.minimum(t_body, torch.minimum(t_ca, t_cb))


class CurveSoA(NamedTuple):
    """Per-segment arrays (``ba``, ``m0`` precomputed), numpy on the host or
    tensors after ``to``."""

    pa: object         # [K, 3]
    ba: object         # [K, 3] pb - pa
    ra: object         # [K]
    rb: object         # [K]
    m0: object         # [K] dot(ba, ba)
    u_a: object        # [K]
    u_b: object        # [K]
    reference: object  # [K, 3]
    color_a: object    # [K, 3]
    color_b: object    # [K, 3]
    material_id: object  # [K] i32

    @property
    def num(self) -> int:
        return int(self.pa.shape[0])

    @staticmethod
    def build(seg) -> "CurveSoA":
        """From a host ``scene.hair.CurveSegments`` (numpy, as the JAX package's)."""
        def f(x):
            return np.ascontiguousarray(np.asarray(x, np.float32))

        ba = (seg.pb - seg.pa).astype(np.float32)
        return CurveSoA(
            pa=f(seg.pa), ba=f(ba), ra=f(seg.ra), rb=f(seg.rb), m0=f(np.sum(ba * ba, axis=-1)),
            u_a=f(seg.u_a), u_b=f(seg.u_b), reference=f(seg.reference),
            color_a=f(seg.color_a), color_b=f(seg.color_b),
            material_id=np.ascontiguousarray(np.asarray(seg.material_id, np.int32)),
        )

    def to(self, device) -> "CurveSoA":
        """The arrays as tensors on ``device`` (float32; material ids int64)."""
        return CurveSoA(*(torch.as_tensor(np.asarray(a), device=device,
                                          dtype=torch.int64 if f == "material_id" else torch.float32)
                          for f, a in zip(self._fields, self)))


def curve_row_table(soa: CurveSoA) -> np.ndarray:
    """[K, CURVE_ROW_WORDS] f32: each segment's shading inputs as one row
    (``CURVE_ROW``); the material id is stored as its int32 bits."""
    k = soa.num
    cols = [np.asarray(getattr(soa, f), np.float32).reshape(k, -1) for f in CURVE_ROW if f != "material_id"]
    mid = np.asarray(soa.material_id, np.int32).reshape(k, 1).view(np.float32)
    table = np.concatenate(cols + [mid], axis=1)
    assert table.shape[1] == CURVE_ROW_WORDS
    return np.ascontiguousarray(table)


def build_wide_curve_bvh(seg, leaf_size: int = 8, max_leaf: int = 4):
    """Wide BVH over the segments' boxes, payload rows pa | ba | ra, rb, m0
    consumed by ``intersect_wide._leaf_cone_t`` (the JAX package's
    ``build_wide_curve_bvh``)."""
    lo, hi, lo2 = segment_aabb_corners(seg.pa, seg.pb, seg.ra, seg.rb)
    b = build_bvh(lo, hi, lo2, max_leaf=max_leaf)
    ba = (seg.pb - seg.pa).astype(np.float32)
    rows = np.concatenate(
        [
            seg.pa.astype(np.float32),
            ba,
            seg.ra.astype(np.float32)[:, None],
            seg.rb.astype(np.float32)[:, None],
            np.sum(ba * ba, axis=-1, dtype=np.float32)[:, None],
        ],
        axis=-1,
    )
    return flatten_wide_rows(b, rows, leaf_size=leaf_size)


def intersect_curves_bvh(org, direction, bvh, tmin, tmax) -> CurveHit:
    """Closest curve hit through the wide walk (C1 on the card)."""
    from .intersect_wide import intersect_curves_wbvh

    t, prim = intersect_curves_wbvh(org, direction, bvh, tmin, tmax)
    return CurveHit(t=t, prim=prim)


def occluded_curves_bvh(org, direction, bvh, tmin, tmax) -> torch.Tensor:
    """Any curve hit in (tmin, tmax) through the wide walk (C2 on the card)."""
    from .intersect_wide import occluded_curves_wbvh

    return occluded_curves_wbvh(org, direction, bvh, tmin, tmax)


def intersect_curves_bruteforce(org, direction, curves: CurveSoA, tmin, tmax, chunk: int = 256) -> CurveHit:
    """Every ray against every segment ([chunk, K] at a time): the closest
    t and the first segment that gives it. ``curves`` holds tensors."""
    ts, prims = [], []
    for s in range(0, org.shape[0], chunk):
        e = s + chunk
        t = _roundcone_t(org[s:e, None], direction[s:e, None], curves.pa[None], curves.ba[None],
                         curves.ra[None], curves.rb[None], curves.m0[None], tmin[s:e, None], tmax[s:e, None])
        best_t, best = torch.min(t, dim=1)
        ts.append(best_t)
        prims.append(torch.where(best_t < RT_MAX, best, -1))
    return CurveHit(t=torch.cat(ts), prim=torch.cat(prims))


class CurveFrame(NamedTuple):
    normal: torch.Tensor    # [N, 3] round-cone surface normal
    tangent: torch.Tensor   # [N, 3] fibre tangent (longitudinal axis)
    b1: torch.Tensor        # [N, 3] azimuthal frame (from the strand reference)
    b2: torch.Tensor        # [N, 3]
    u_fiber: torch.Tensor   # [N]
    v_fiber: torch.Tensor   # [N]
    color: torch.Tensor     # [N, 3] interpolated strand colour
    material_id: torch.Tensor  # [N] i64


def _normalized(v):
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True), min=DENOM)


def curve_shading_frame(table: torch.Tensor, prim, x) -> CurveFrame:
    """Shading attributes at hit point ``x`` on segment ``prim`` (clamped at
    0), from one row gather of ``table`` (``curve_row_table``): the round
    cone's surface normal, the fibre tangent, a per-strand azimuthal frame,
    the fibre coordinates uFiber / vFiber of the reference
    (``hit.cu:1769-1816``), the interpolated strand colour and the material
    id (``nrc_tpu/ops/curve_intersect.py:324-372``)."""
    row = gather_rows(table, torch.clamp(prim, min=0))

    def col(name):
        a, b = CURVE_ROW[name]
        return row[:, a] if b == a + 1 else row[:, a:b]

    pa, ba, ra, rb = col("pa"), col("ba"), col("ra"), col("rb")
    m0 = torch.clamp(col("m0"), min=DENOM)

    y = dot(x - pa, ba)
    rr = ra - rb
    d2 = m0 - rr * rr
    on_body = (y > 0.0) & (y < d2)
    # body normal d2 (x - pa) - ba y; cap normals from the sphere centres
    n_body = d2[:, None] * (x - pa) - ba * y[:, None]
    n_cap = torch.where((y <= 0.0)[:, None], x - pa, x - (pa + ba))
    n = _normalized(torch.where(on_body[:, None], n_body, n_cap))

    tangent = ba / torch.clamp(torch.sqrt(m0)[:, None], min=DENOM)

    s = torch.clamp(y / m0, 0.0, 1.0)
    u_a, c_a = col("u_a"), col("color_a")
    u_fiber = u_a + s * (col("u_b") - u_a)
    color = c_a + s[:, None] * (col("color_b") - c_a)

    # vFiber: the normal's azimuth about the fibre against the strand's
    # reference bitangent (Curves.cpp:186-234), in [0, 1)
    ref = col("reference")
    b1 = _normalized(ref - tangent * dot(ref, tangent)[:, None])
    b2 = cross(tangent, b1)
    ang = torch.atan2(dot(n, b2), dot(n, b1))
    v_fiber = torch.remainder(ang / (2.0 * math.pi), 1.0)
    mid = row[:, CURVE_ROW["material_id"][0]].contiguous().view(torch.int32).to(torch.int64)
    return CurveFrame(n, tangent, b1, b2, u_fiber, v_fiber, color, mid)
