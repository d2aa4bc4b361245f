"""Port parity for the host strand path: ``.hair`` loading, the B-spline
tessellation into round cones, the scene transform and the per-segment
arrays, against the JAX package bit for bit.

``nrc_tpu_torch/scene/hair.py`` and ``CurveSoA.build`` are numpy on both
sides, with the JAX package's operations in its order, so every array must
have the same bits (no tolerance). The ``.hair`` files are written under
``tmp_path`` in Cem Yuksel's layout (a 128-byte header, then the arrays its
flags name), one for each combination of the ``HAIR_HAS_*`` flags; a file
without points is refused by both loaders.
"""

import itertools
import struct

import numpy as np
import pytest

from nrc_tpu.ops import curve_intersect as JCI
from nrc_tpu.scene import hair as JH
from nrc_tpu_torch.ops import curve_intersect as PCI
from nrc_tpu_torch.scene import hair as PH
from nrc_tpu_torch.scene.scene_builder import HAIR_SEGMENTS, cornell_hair_declarations, fur_patch

FLAGS = ("HAIR_HAS_SEGMENTS", "HAIR_HAS_POINTS", "HAIR_HAS_THICKNESS", "HAIR_HAS_TRANSPARENCY", "HAIR_HAS_COLOR")
SEGMENT_FIELDS = ("pa", "pb", "ra", "rb", "u_a", "u_b", "reference", "color_a", "color_b", "strand", "material_id")


def same_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def write_hair(path, bits, seed=0):
    """A ``.hair`` file with the arrays ``bits`` names and seeded contents:
    7 strands of 1 to 4 segments (the defaults' 3 where the file has no
    segment array), defaults for the rest."""
    rng = np.random.default_rng(seed)
    strands = 7
    segments = rng.integers(1, 5, strands).astype(np.uint16) if bits & PH.HAIR_HAS_SEGMENTS else None
    d_segments = 3
    points = int((segments.astype(np.int64) + 1).sum()) if segments is not None else strands * (d_segments + 1)
    header = b"HAIR" + struct.pack("<IIIIfffff", strands, points, bits, d_segments, 0.07, 0.25, 0.3, 0.2, 0.1)
    header += b"test file".ljust(128 - len(header), b"\0")
    body = b""
    if segments is not None:
        body += segments.tobytes()
    for flag, width in ((PH.HAIR_HAS_POINTS, 3), (PH.HAIR_HAS_THICKNESS, 1), (PH.HAIR_HAS_TRANSPARENCY, 1),
                        (PH.HAIR_HAS_COLOR, 3)):
        if bits & flag:
            body += rng.uniform(-1.0, 1.0, points * width).astype(np.float32).tobytes()
    path.write_bytes(header + body)
    return str(path)


def test_flags_equal_jax():
    for name in FLAGS:
        assert getattr(PH, name) == getattr(JH, name)


@pytest.mark.parametrize("bits", range(32))
def test_load_hair_equals_jax(tmp_path, bits):
    path = write_hair(tmp_path / f"flags{bits}.hair", bits, seed=bits)
    if not bits & PH.HAIR_HAS_POINTS:
        for loader in (PH.load_hair, JH.load_hair):
            with pytest.raises(ValueError, match="points"):
                loader(path)
        return
    got, ref = PH.load_hair(path), JH.load_hair(path)
    assert got.num_strands == ref.num_strands == 7
    for field in ("segments", "points", "thickness", "transparency", "color", "strand_offsets"):
        assert same_bits(getattr(got, field), getattr(ref, field)), field


def test_load_hair_refuses_a_bad_signature(tmp_path):
    path = tmp_path / "bad.hair"
    path.write_bytes(b"HAIX" + bytes(124))
    with pytest.raises(ValueError, match="signature"):
        PH.load_hair(str(path))


def mixed_strands(seed=3):
    """Strands of 0, 1, 2, 3 and 5 segments, with degenerate control
    polygons among them: a straight strand along z (no "face normal"), one
    along x, and one whose points all coincide."""
    rng = np.random.default_rng(seed)
    segments = np.asarray([2, 0, 1, 5, 3, 3, 3, 2, 5, 1], np.uint16)
    points = rng.normal(size=(int((segments.astype(np.int64) + 1).sum()), 3)).astype(np.float32)
    offs = np.concatenate([[0], np.cumsum(segments.astype(np.int64) + 1)])
    straight = np.linspace(0.0, 1.0, 4, dtype=np.float32)
    points[offs[4]:offs[5]] = np.stack([np.zeros(4), np.zeros(4), straight], -1)       # along z
    points[offs[5]:offs[6]] = np.stack([straight, np.zeros(4), np.zeros(4)], -1) + 0.5  # along x
    points[offs[6]:offs[7]] = 0.25                                                      # one point
    n = points.shape[0]
    return PH.HairFile(
        num_strands=segments.shape[0], segments=segments, points=points,
        thickness=rng.uniform(0.01, 0.1, n).astype(np.float32),
        transparency=np.zeros(n, np.float32),
        color=rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32),
    )


def to_jax_hair(hf):
    return JH.HairFile(hf.num_strands, hf.segments, hf.points, hf.thickness, hf.transparency, hf.color)


def segments_equal(got, ref):
    for field in SEGMENT_FIELDS:
        assert same_bits(getattr(got, field), getattr(ref, field)), field


@pytest.mark.parametrize("subsegments", [1, 2, 3])
def test_hair_to_segments_equals_jax(subsegments):
    hf = mixed_strands()
    got = PH.hair_to_segments(hf, material_id=4, thickness_scale=1.5, subsegments=subsegments)
    ref = JH.hair_to_segments(to_jax_hair(hf), material_id=4, thickness_scale=1.5, subsegments=subsegments)
    segments_equal(got, ref)
    # the strand of 0 segments makes none; the others seg * subsegments each
    assert got.num == int(hf.segments.astype(np.int64).sum()) * subsegments


@pytest.mark.parametrize("subsegments", [1, 2, 3])
def test_fur_patch_tessellation_equals_jax(subsegments):
    """``cornell_hair``'s own strands (9 points each, uniform counts)."""
    hf = fur_patch(200, seed=5)
    assert hf.points.shape == (200 * (HAIR_SEGMENTS + 1), 3)
    got = PH.hair_to_segments(hf, material_id=5, subsegments=subsegments)
    segments_equal(got, JH.hair_to_segments(to_jax_hair(hf), material_id=5, subsegments=subsegments))
    # spans share their ends: a strand's tessellation is continuous
    same = got.strand[:-1] == got.strand[1:]
    assert np.array_equal(got.pb[:-1][same], got.pa[1:][same])


def test_bspline_eval_equals_jax():
    rng = np.random.default_rng(11)
    cp = rng.normal(size=(9, 4, 3)).astype(np.float32)
    rad = rng.uniform(0.0, 0.1, (9, 4)).astype(np.float32)
    t = np.linspace(0.0, 1.0, 7)
    for a, b in zip(PH._bspline_eval(cp, rad, t), JH._bspline_eval(cp, rad, t)):
        assert same_bits(a, b)


def test_transform_segments_and_soa_equal_jax():
    models, materials, cam, hair = cornell_hair_declarations(strands=64)
    seg = PH.hair_to_segments(hair.hair, material_id=5)
    jseg = JH.hair_to_segments(to_jax_hair(hair.hair), material_id=5)
    rng = np.random.default_rng(2)
    for matrix in (hair.matrix, np.diag([2.0, 3.0, 0.5, 1.0]) @ hair.matrix,
                   np.vstack([rng.normal(size=(3, 4)), [0, 0, 0, 1]])):
        got, ref = PH.transform_segments(seg, matrix), JH.transform_segments(jseg, matrix)
        segments_equal(got, ref)
        soa, jsoa = PCI.CurveSoA.build(got), JCI.CurveSoA.build(ref)
        for field in PCI.CurveSoA._fields:
            assert same_bits(getattr(soa, field), getattr(jsoa, field)), field


def test_curve_row_table_layout():
    """The packed shading row holds each field's bits where ``CURVE_ROW`` says."""
    hf = mixed_strands()
    soa = PCI.CurveSoA.build(PH.hair_to_segments(hf, material_id=3))
    table = PCI.curve_row_table(soa)
    assert table.shape == (soa.num, PCI.CURVE_ROW_WORDS) and table.dtype == np.float32
    for field, (a, b) in PCI.CURVE_ROW.items():
        want = np.asarray(getattr(soa, field)).reshape(soa.num, -1)
        got = table[:, a:b].view(np.int32) if field == "material_id" else table[:, a:b]
        assert same_bits(np.ascontiguousarray(got), want.astype(got.dtype)), field


def test_segment_aabb_corners_equal_jax():
    rng = np.random.default_rng(4)
    pa, pb = rng.normal(size=(2, 50, 3)).astype(np.float32)
    ra, rb = rng.uniform(0.0, 0.1, (2, 50)).astype(np.float32)
    for a, b in itertools.zip_longest(PCI.segment_aabb_corners(pa, pb, ra, rb),
                                      JCI.segment_aabb_corners(pa, pb, ra, rb)):
        assert same_bits(a, b)
