"""Port parity for curve intersection: the round-cone test, the wide curve
BVH and its walk, occlusion and the shading frame, against the JAX package.

Tolerances and their reasons:

- the round cone's t against the JAX package: rtol ``T_RTOL`` (2e-4, the
  JAX tests' own bound between its batched and its walked test, and
  ``tests/test_curves.py``'s). XLA:CPU contracts the quadratic's products
  into FMAs and PyTorch does not; the discriminant k1^2 - k0 k2 cancels
  badly near a silhouette, so t there moves by far more than an ulp;
- the wide build's rows: bit for bit (the same native SAH and collapse);
- the port's plain cone walk against the port's brute force: t bit for bit
  where the winners agree, since both take the same sums in the same order
  (``intersect_wide._leaf_cone_t`` and ``curve_intersect._roundcone_t``);
  the winners may differ only between segments at the same t;
- the shading frame: atol ``FRAME_ATOL`` (1e-5) on unit vectors and fibre
  coordinates, from the two packages' rounding of normalisations.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nrc_tpu.ops import curve_intersect as JCI
from nrc_tpu.ops import intersect_wide as JIW
from nrc_tpu.scene.hair import CurveSegments as JCurveSegments
from nrc_tpu_torch.ops import curve_intersect as PCI
from nrc_tpu_torch.ops import intersect_wide as IW
from nrc_tpu_torch.ops import intersect_wide_cuda as WC
from nrc_tpu_torch.ops.bvh_wide import build_wide_bvh
from nrc_tpu_torch.scene.hair import CurveSegments
from test_torch_intersect import one_torch_thread  # noqa: F401 (an autouse fixture)

T_RTOL = 2e-4
FRAME_ATOL = 1e-5


def make_segments(pa, pb, ra, rb, cls=CurveSegments):
    """``tests/test_curves.py::make_segments`` for either package."""
    pa = np.asarray(pa, np.float32).reshape(-1, 3)
    pb = np.asarray(pb, np.float32).reshape(-1, 3)
    ra = np.asarray(ra, np.float32).reshape(-1)
    rb = np.asarray(rb, np.float32).reshape(-1)
    k = pa.shape[0]
    return cls(
        pa=pa, pb=pb, ra=ra, rb=rb,
        u_a=np.zeros(k, np.float32), u_b=np.ones(k, np.float32),
        reference=np.tile([[0.0, 0.0, 1.0]], (k, 1)).astype(np.float32),
        color_a=np.ones((k, 3), np.float32), color_b=np.ones((k, 3), np.float32),
        strand=np.arange(k, dtype=np.int32), material_id=np.zeros(k, np.int32),
    )


def both_soa(*args):
    """(port CurveSoA as tensors, JAX CurveSoA) of the same segments."""
    return (PCI.CurveSoA.build(make_segments(*args)).to("cpu"),
            JCI.CurveSoA.build(make_segments(*args, cls=JCurveSegments)))


def both_brute(args, org, d, tmin, tmax):
    soa, jsoa = both_soa(*args)
    got = PCI.intersect_curves_bruteforce(torch.tensor(org), torch.tensor(d), soa, torch.tensor(tmin),
                                          torch.tensor(tmax))
    ref = JCI.intersect_curves_bruteforce(jnp.asarray(org), jnp.asarray(d), jsoa, jnp.asarray(tmin),
                                          jnp.asarray(tmax))
    return got, ref


# tests/test_curves.py:37-82: (segment, rays, tmax, the expected hits and t)
CASES = {
    "sphere_degenerate": (([0, 0, 0], [0, 0, 1e-6], 0.5, 0.5), [[0.0, 0.0, -3.0]], [[0.0, 0.0, 1.0]], 1e9,
                          [True], [2.5]),
    "cylinder_side": (([-1, 0, 0], [1, 0, 0], 0.25, 0.25), [[0.5, 0.0, 3.0]], [[0.0, 0.0, -1.0]], 1e9,
                      [True], [2.75]),
    "cone_taper": (([0, 0, 0], [2, 0, 0], 0.5, 0.0), [[1.9, 0.4, 3.0], [0.1, 0.4, 3.0]],
                   [[0.0, 0.0, -1.0], [0.0, 0.0, -1.0]], 1e9, [False, True], [None, None]),
    "miss_range": (([0, 0, 0], [1, 0, 0], 0.1, 0.1), [[0.5, 0.0, 3.0]], [[0.0, 0.0, -1.0]], 2.0, [False], [None]),
}


@pytest.mark.parametrize("case", list(CASES))
def test_roundcone_cases_equal_jax(case):
    seg, org, d, tmax, valid, t_want = CASES[case]
    org, d = np.asarray(org, np.float32), np.asarray(d, np.float32)
    n = org.shape[0]
    got, ref = both_brute(seg, org, d, np.zeros(n, np.float32), np.full(n, tmax, np.float32))
    assert got.valid.tolist() == valid == np.asarray(ref.valid).tolist()
    np.testing.assert_allclose(got.t.numpy(), np.asarray(ref.t), rtol=T_RTOL)
    for t, want in zip(got.t.tolist(), t_want):
        if want is not None:
            assert abs(t - want) <= 1e-3


def random_segments(k, seed):
    """``tests/test_curves.py:113-148``'s random segments and rays."""
    rng = np.random.default_rng(seed)
    pa = rng.uniform(-1, 1, (k, 3)).astype(np.float32)
    pb = pa + rng.uniform(-0.2, 0.2, (k, 3)).astype(np.float32)
    ra = rng.uniform(0.01, 0.05, k).astype(np.float32)
    rb = rng.uniform(0.01, 0.05, k).astype(np.float32)
    n = 256
    org = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return (pa, pb, ra, rb), org, d


@pytest.fixture(scope="module")
def seven_hundred():
    """700 segments and 256 rays; the port's and the JAX package's wide
    builds, the port's uploaded as cones."""
    args, org, d = random_segments(700, seed=7)
    seg = make_segments(*args)
    wb = PCI.build_wide_curve_bvh(seg)
    jwb = JCI.build_wide_curve_bvh(make_segments(*args, cls=JCurveSegments))
    return dict(args=args, org=org, d=d, seg=seg, wb=wb, jwb=jwb, bvh=IW.upload_wide_bvh(wb, "cpu", kind="cone"))


def test_wide_curve_build_equals_jax(seven_hundred):
    wb, jwb = seven_hundred["wb"], seven_hundred["jwb"]
    assert sorted(wb) == sorted(jwb)
    for key in wb:
        a, b = np.asarray(wb[key]), np.asarray(jwb[key])
        assert a.shape == b.shape and a.tobytes() == b.tobytes(), key
    dims = IW.wide_dims(wb)
    assert (dims.branch, dims.leaf_size, dims.prim_row_w) == (8, 8, 9)


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
def test_plain_cone_walk_equals_jax_and_brute_force(seven_hundred, any_hit):
    c = seven_hundred
    n = c["org"].shape[0]
    org, d = torch.tensor(c["org"]), torch.tensor(c["d"])
    tmin, tmax = torch.zeros(n), torch.full((n,), 1e9)
    soa = PCI.CurveSoA.build(c["seg"]).to("cpu")
    brute = PCI.intersect_curves_bruteforce(org, d, soa, tmin, tmax)
    jwb = {k: jnp.asarray(v) for k, v in c["jwb"].items()}
    if any_hit:
        occ = PCI.occluded_curves_bvh(org, d, c["bvh"], tmin, tmax)
        jocc = JIW.occluded_curves_wbvh(jnp.asarray(c["org"]), jnp.asarray(c["d"]), jwb, jnp.zeros(n),
                                        jnp.full((n,), 1e9))
        assert torch.equal(occ, brute.valid) and occ.numpy().tolist() == np.asarray(jocc).tolist()
        return
    hit = PCI.intersect_curves_bvh(org, d, c["bvh"], tmin, tmax)
    jt, jprim = JIW.intersect_curves_wbvh(jnp.asarray(c["org"]), jnp.asarray(c["d"]), jwb, jnp.zeros(n),
                                          jnp.full((n,), 1e9))
    assert 0.1 < hit.valid.float().mean().item() < 1.0  # 39 of 256 rays hit
    # against the port's brute force: the same sums in the same order
    same = hit.prim == brute.prim
    assert torch.equal(hit.t[same], brute.t[same])
    assert torch.equal(hit.t[~same], brute.t[~same]) and bool((hit.prim[~same] >= 0).all())
    # against the JAX walk: the winners, and t within the FMA's reach
    assert hit.prim.numpy().tolist() == np.asarray(jprim).tolist()
    np.testing.assert_allclose(hit.t.numpy(), np.asarray(jt), rtol=T_RTOL)


def test_leaf_cone_test_equals_roundcone(seven_hundred):
    """``_leaf_cone_t`` over component-major columns equals ``_roundcone_t``
    on the same segments, bit for bit, and misses padded slots."""
    c = seven_hundred
    soa = PCI.CurveSoA.build(c["seg"]).to("cpu")
    org, d = torch.tensor(c["org"][:64]), torch.tensor(c["d"][:64])
    ls = 8
    cols = [soa.pa[:ls, 0], soa.pa[:ls, 1], soa.pa[:ls, 2], soa.ba[:ls, 0], soa.ba[:ls, 1], soa.ba[:ls, 2],
            soa.ra[:ls], soa.rb[:ls], soa.m0[:ls]]
    cols = [x[None].expand(64, ls) for x in cols]
    pid = torch.tensor([0, 1, 2, 3, 4, 5, 6, -1])[None].expand(64, ls)
    tmin, cap = torch.zeros(64), torch.full((64,), 1e9)
    got = IW._leaf_cone_t(cols, pid, org, d, tmin, cap)
    ref = PCI._roundcone_t(org[:, None], d[:, None], soa.pa[None, :ls], soa.ba[None, :ls], soa.ra[None, :ls],
                           soa.rb[None, :ls], soa.m0[None, :ls], tmin[:, None], cap[:, None])
    assert torch.equal(got[:, :7], ref[:, :7]) and bool((got[:, 7] == IW.RT_MAX).all())


def test_shading_frame_equals_jax(seven_hundred):
    c = seven_hundred
    n = c["org"].shape[0]
    soa = PCI.CurveSoA.build(c["seg"])
    jsoa = JCI.CurveSoA.build(make_segments(*c["args"], cls=JCurveSegments))
    soa = soa._replace(u_a=np.linspace(0, 0.5, soa.num, dtype=np.float32),
                       color_b=np.linspace(0, 1, 3 * soa.num, dtype=np.float32).reshape(-1, 3))
    jsoa = jsoa._replace(u_a=soa.u_a, color_b=soa.color_b)
    table = torch.from_numpy(PCI.curve_row_table(soa))
    org, d = torch.tensor(c["org"]), torch.tensor(c["d"])
    hit = PCI.intersect_curves_bvh(org, d, c["bvh"], torch.zeros(n), torch.full((n,), 1e9))
    x = org + hit.t[:, None] * d
    ok = hit.valid.numpy()
    fr = PCI.curve_shading_frame(table, hit.prim, x)
    jfr = JCI.curve_shading_frame(jsoa, jnp.asarray(np.maximum(hit.prim.numpy(), 0)), jnp.asarray(x.numpy()))
    for field in ("normal", "tangent", "b1", "b2", "u_fiber", "color"):
        np.testing.assert_allclose(getattr(fr, field).numpy()[ok], np.asarray(getattr(jfr, field))[ok],
                                   atol=FRAME_ATOL, err_msg=field)
    # vFiber wraps at 1: compare on the circle
    dv = np.abs(fr.v_fiber.numpy() - np.asarray(jfr.v_fiber))[ok]
    assert np.minimum(dv, 1.0 - dv).max() <= FRAME_ATOL
    assert fr.material_id.tolist() == soa.material_id[np.maximum(hit.prim.numpy(), 0)].tolist()


def test_the_walks_refuse_the_other_kind():
    """A table of cones handed to a triangle walk, or of triangles to a cone
    walk, raises, on the CPU and before any launch on the card."""
    args, org, d = random_segments(100, seed=1)
    cones = IW.upload_wide_bvh(PCI.build_wide_curve_bvh(make_segments(*args)), "cpu", kind="cone")
    rng = np.random.default_rng(0)
    p = rng.normal(size=(3, 100, 3)).astype(np.float32)
    tris = IW.upload_wide_bvh(build_wide_bvh(*p), "cpu")
    assert (cones.kind, tris.kind) == ("cone", "triangle")
    o, dd = torch.tensor(org[:4]), torch.tensor(d[:4])
    tn, tf = torch.zeros(4), torch.full((4,), 1e9)
    with pytest.raises(ValueError, match="cone leaf rows handed to the triangle walk"):
        IW.occluded_wbvh(o, dd, cones, tn, tf)
    with pytest.raises(ValueError, match="cone leaf rows handed to the triangle walk"):
        IW.wide_traverse_plain(o, dd, cones, tn, tf, False)
    with pytest.raises(ValueError, match="cone leaf rows handed to the triangle walk"):
        WC.wide_traverse_cuda(o, dd, cones, tn, tf, False)
    for fn in (PCI.intersect_curves_bvh, PCI.occluded_curves_bvh):
        with pytest.raises(ValueError, match="triangle leaf rows handed to the cone walk"):
            fn(o, dd, tris, tn, tf)
    with pytest.raises(ValueError, match="triangle leaf rows handed to the cone walk"):
        WC.wide_traverse_cuda(o, dd, tris, tn, tf, True, leaf="cone")
    with pytest.raises(ValueError, match="primitive kind"):
        IW.upload_wide_bvh(PCI.build_wide_curve_bvh(make_segments(*args)), "cpu", kind="sphere")
    # the card's four entry points, one per (kind, any hit): W1/W2 in one
    # source, C1/C2 in their own
    assert {(k.source, k.symbol) for k in WC.WALK_KERNELS.values()} == {
        ("intersect_wide.cu", "nrc_wbvh_closest"), ("intersect_wide.cu", "nrc_wbvh_any"),
        ("intersect_curves.cu", "nrc_wbvh_curves_closest"), ("intersect_curves.cu", "nrc_wbvh_curves_any")}
