"""Cem Yuksel ``.hair`` files and the strand -> round-cone tessellation (NumPy).

Port of ``nrc_tpu/scene/hair.py:28-273``, host code only: the
``HAIR_HAS_*`` flags, ``HairFile`` and ``load_hair`` (the reference's
``Hair`` class, ``nrc/inc/Hair.h:64-137``), ``CurveSegments``,
``_bspline_eval``, ``hair_to_segments`` and ``transform_segments`` (the
reference's ``sg::Curves::createHair``, ``nrc/src/Curves.cpp:104-315``).
The reference hands cubic B-splines with phantom endpoints to OptiX's curve
primitive; here, as in the JAX package, the same uniform cubic B-spline is
evaluated on the host and each span flattened into ``subsegments`` round
cones (linear swept spheres) that ``ops/curve_intersect.py`` intersects in
closed form. The operations are the JAX package's, in its order, so the
arrays agree with it bit for bit.

Per-strand fibre coordinates follow the reference: uFiber is the
normalised length along the tessellated strand, vFiber is measured against
a per-strand reference bitangent, the control polygon's "face normal"
(``Curves.cpp:180-234``).
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np

HAIR_HAS_SEGMENTS = 1 << 0
HAIR_HAS_POINTS = 1 << 1
HAIR_HAS_THICKNESS = 1 << 2
HAIR_HAS_TRANSPARENCY = 1 << 3
HAIR_HAS_COLOR = 1 << 4


@dataclasses.dataclass
class HairFile:
    """Parsed .hair file: ragged strands flattened into point arrays."""

    num_strands: int
    segments: np.ndarray       # [S] u16 per-strand segment count
    points: np.ndarray         # [P, 3] f32
    thickness: np.ndarray      # [P] f32
    transparency: np.ndarray   # [P] f32
    color: np.ndarray          # [P, 3] f32

    @property
    def strand_offsets(self) -> np.ndarray:
        """[S+1] start index of each strand's points (segments+1 points each)."""
        counts = self.segments.astype(np.int64) + 1
        return np.concatenate([[0], np.cumsum(counts)])


def load_hair(path: str) -> HairFile:
    """Parse the 128-byte header + flagged arrays (``Hair.h:64-86``)."""
    with open(path, "rb") as f:
        raw = f.read()
    if raw[:4] != b"HAIR":
        raise ValueError(f"{path}: missing HAIR signature")
    (num_strands, num_points, bits, d_segments, d_thickness, d_transparency,
     cr, cg, cb) = struct.unpack_from("<IIIIfffff", raw, 4)
    off = 128

    def arr(dtype, count):
        nonlocal off
        a = np.frombuffer(raw, dtype=dtype, count=count, offset=off)
        off += a.nbytes
        return a

    if bits & HAIR_HAS_SEGMENTS:
        segments = arr(np.uint16, num_strands).copy()
    else:
        segments = np.full(num_strands, d_segments, np.uint16)
    if not (bits & HAIR_HAS_POINTS):
        raise ValueError(f"{path}: points array required (bits={bits:#x})")
    points = arr(np.float32, num_points * 3).reshape(num_points, 3).copy()
    if bits & HAIR_HAS_THICKNESS:
        thickness = arr(np.float32, num_points).copy()
    else:
        thickness = np.full(num_points, d_thickness, np.float32)
    if bits & HAIR_HAS_TRANSPARENCY:
        transparency = arr(np.float32, num_points).copy()
    else:
        transparency = np.full(num_points, d_transparency, np.float32)
    if bits & HAIR_HAS_COLOR:
        color = arr(np.float32, num_points * 3).reshape(num_points, 3).copy()
    else:
        color = np.tile(np.asarray([cr, cg, cb], np.float32), (num_points, 1))
    return HairFile(
        num_strands=num_strands,
        segments=segments,
        points=points,
        thickness=thickness,
        transparency=transparency,
        color=color,
    )


@dataclasses.dataclass
class CurveSegments:
    """SoA rounded-cone segment soup for the batched intersector."""

    pa: np.ndarray         # [K, 3] f32 segment start
    pb: np.ndarray         # [K, 3]
    ra: np.ndarray         # [K] f32 start radius
    rb: np.ndarray         # [K]
    u_a: np.ndarray        # [K] uFiber at start (normalized strand length)
    u_b: np.ndarray        # [K]
    reference: np.ndarray  # [K, 3] per-strand bitangent reference (vFiber)
    color_a: np.ndarray    # [K, 3] strand color at start
    color_b: np.ndarray    # [K, 3]
    strand: np.ndarray     # [K] i32 strand id
    material_id: np.ndarray  # [K] i32

    @property
    def num(self) -> int:
        return int(self.pa.shape[0])


def _bspline_eval(cp: np.ndarray, rad: np.ndarray, t: np.ndarray):
    """Uniform cubic B-spline over 4 control points, vectorized.

    cp: [M, 4, 3], rad: [M, 4], t: [T] in [0, 1] -> ([M, T, 3], [M, T]).
    Matches OptiX's CUBIC_BSPLINE basis used by the reference pipeline
    (``Device.cpp:857-863`` builtin IS module).
    """
    t = t[None, :, None]
    b0 = (1 - t) ** 3 / 6.0
    b1 = (3 * t**3 - 6 * t**2 + 4) / 6.0
    b2 = (-3 * t**3 + 3 * t**2 + 3 * t + 1) / 6.0
    b3 = t**3 / 6.0
    pts = (
        b0 * cp[:, None, 0] + b1 * cp[:, None, 1]
        + b2 * cp[:, None, 2] + b3 * cp[:, None, 3]
    )
    b = np.concatenate([b0, b1, b2, b3], axis=-1)  # [M, T, 4]
    r = np.einsum("mtk,mk->mt", b, rad)
    return pts, r


def hair_to_segments(
    hf: HairFile,
    material_id: int = 0,
    thickness_scale: float = 1.0,
    subsegments: int = 2,
) -> CurveSegments:
    """Strands -> rounded-cone soup through the reference's B-spline path.

    Control points get phantom endpoints (first/last point repeated, like
    ``Curves.cpp:262-301``) so the spline interpolates the root and the tip;
    each of the strand's spline spans is then flattened into ``subsegments``
    rounded cones.
    """
    offs = hf.strand_offsets
    pa, pb, ra, rb = [], [], [], []
    ua, ub, refs, ca, cb_, sid = [], [], [], [], [], []

    t_local = np.linspace(0.0, 1.0, subsegments + 1)
    all_segments = hf.segments.astype(np.int64)

    # vectorize over groups of strands with equal segment count (hair files
    # are usually uniform, so this is one group)
    for n_seg in np.unique(all_segments):
        n_seg = int(n_seg)
        if n_seg == 0:
            continue
        strands = np.nonzero(all_segments == n_seg)[0]
        g = strands.shape[0]
        base = offs[strands]                                     # [g]
        vidx = base[:, None] + np.arange(n_seg + 1)[None, :]     # [g, V]
        p = hf.points[vidx]                                      # [g, V, 3]
        r = hf.thickness[vidx] * (0.5 * thickness_scale)         # [g, V]
        col = hf.color[vidx]                                     # [g, V, 3]

        # per-strand reference bitangent: "face normal" of the control
        # polygon (Curves.cpp:190-234)
        q = np.concatenate([p, p[:, :1]], axis=1)                # closed
        q0, q1 = q[:, :-1], q[:, 1:]
        ref = np.stack([
            np.sum((q0[..., 1] - q1[..., 1]) * (q0[..., 2] + q1[..., 2]), -1),
            np.sum((q0[..., 2] - q1[..., 2]) * (q0[..., 0] + q1[..., 0]), -1),
            np.sum((q0[..., 0] - q1[..., 0]) * (q0[..., 1] + q1[..., 1]), -1),
        ], axis=-1)                                              # [g, 3]
        degen = ~np.any(ref != 0.0, axis=-1)
        if np.any(degen):
            tang = p[degen, -1] - p[degen, 0]
            alt = np.where(
                (np.abs(tang[:, 2]) < np.abs(tang[:, 0]))[:, None],
                np.stack([tang[:, 2], np.zeros(tang.shape[0]), -tang[:, 0]], -1),
                np.stack([np.zeros(tang.shape[0]), tang[:, 2], -tang[:, 1]], -1),
            )
            ref[degen] = alt
        nrm = np.linalg.norm(ref, axis=-1, keepdims=True)
        ref = np.where(nrm > 0, ref / np.maximum(nrm, 1e-20), [0.0, 1.0, 0.0])

        # phantom endpoints -> n_seg B-spline spans per strand
        pe = np.concatenate([p[:, :1], p, p[:, -1:]], axis=1)    # [g, V+2, 3]
        re = np.concatenate([r[:, :1], r, r[:, -1:]], axis=1)
        ce = np.concatenate([col[:, :1], col, col[:, -1:]], axis=1)
        m = n_seg
        win = np.stack([pe[:, i : i + m] for i in range(4)], axis=2)   # [g,m,4,3]
        rwin = np.stack([re[:, i : i + m] for i in range(4)], axis=2)  # [g,m,4]
        cwin = np.stack([ce[:, i : i + m] for i in range(4)], axis=2)  # [g,m,4,3]

        t = t_local[None, None, :, None]
        b = np.concatenate([
            (1 - t) ** 3 / 6.0,
            (3 * t**3 - 6 * t**2 + 4) / 6.0,
            (-3 * t**3 + 3 * t**2 + 3 * t + 1) / 6.0,
            t**3 / 6.0,
        ], axis=-1)                                              # [1,1,T,4]
        pts = np.einsum("gmtk,gmkc->gmtc", np.broadcast_to(b, (g, m) + b.shape[2:]), win)
        rads = np.einsum("gmtk,gmk->gmt", np.broadcast_to(b, (g, m) + b.shape[2:]), rwin)
        cols = np.einsum("gmtk,gmkc->gmtc", np.broadcast_to(b, (g, m) + b.shape[2:]), cwin)

        # uFiber: normalized arclength along the tessellated strand
        # (Curves.cpp:184; spans share endpoints so seam diffs are zero)
        flat_p = pts.reshape(g, -1, 3)
        dl = np.linalg.norm(np.diff(flat_p, axis=1), axis=-1)    # [g, m*(T)-1]
        u_vtx = np.concatenate(
            [np.zeros((g, 1)), np.cumsum(dl, axis=1)], axis=1
        )
        u_vtx /= np.maximum(u_vtx[:, -1:], 1e-12)
        u_vtx = u_vtx.reshape(g, m, subsegments + 1)

        k = m * subsegments
        pa.append(pts[:, :, :-1].reshape(-1, 3))
        pb.append(pts[:, :, 1:].reshape(-1, 3))
        ra.append(rads[:, :, :-1].reshape(-1))
        rb.append(rads[:, :, 1:].reshape(-1))
        ua.append(u_vtx[:, :, :-1].reshape(-1))
        ub.append(u_vtx[:, :, 1:].reshape(-1))
        refs.append(np.repeat(ref, k, axis=0))
        ca.append(cols[:, :, :-1].reshape(-1, 3))
        cb_.append(cols[:, :, 1:].reshape(-1, 3))
        sid.append(np.repeat(strands.astype(np.int32), k))

    if not pa:
        z3 = np.zeros((0, 3), np.float32)
        z1 = np.zeros((0,), np.float32)
        zi = np.zeros((0,), np.int32)
        return CurveSegments(z3, z3, z1, z1, z1, z1, z3, z3, z3, zi, zi)

    return CurveSegments(
        pa=np.concatenate(pa).astype(np.float32),
        pb=np.concatenate(pb).astype(np.float32),
        ra=np.concatenate(ra).astype(np.float32),
        rb=np.concatenate(rb).astype(np.float32),
        u_a=np.concatenate(ua).astype(np.float32),
        u_b=np.concatenate(ub).astype(np.float32),
        reference=np.concatenate(refs).astype(np.float32),
        color_a=np.concatenate(ca).astype(np.float32),
        color_b=np.concatenate(cb_).astype(np.float32),
        strand=np.concatenate(sid),
        material_id=np.full(sum(x.shape[0] for x in sid), material_id, np.int32),
    )


def transform_segments(seg: CurveSegments, matrix: np.ndarray) -> CurveSegments:
    """Apply a scene-graph transform; radii scale by the mean axis scale."""
    m = np.asarray(matrix, np.float32)
    rot, t = m[:3, :3], m[:3, 3]
    scale = float(np.mean(np.linalg.norm(rot, axis=0)))
    ref = seg.reference @ rot.T
    nrm = np.linalg.norm(ref, axis=-1, keepdims=True)
    ref = ref / np.maximum(nrm, 1e-12)
    return dataclasses.replace(
        seg,
        pa=(seg.pa @ rot.T + t).astype(np.float32),
        pb=(seg.pb @ rot.T + t).astype(np.float32),
        ra=(seg.ra * scale).astype(np.float32),
        rb=(seg.rb * scale).astype(np.float32),
        reference=ref.astype(np.float32),
    )
