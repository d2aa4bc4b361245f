"""Port parity for the wide-BVH walk and the row gather, on the CPU.

The plain lockstep walk of ``nrc_tpu_torch/ops/intersect_wide.py`` against
``intersect_wbvh``/``occluded_wbvh`` of the JAX package on the same numpy
soups, rays and (bit-identical) BVH: the cases of
``tests/test_intersect_wide.py`` with dead lanes, ``tmin`` offsets, finite
``tmax`` and near-axis directions.

Tolerances. Both walks visit the same rows in the same order (the same
sorting network on the same keys, up to the last bits of a key), so hit or
miss, the winner and the occlusion must agree; a different winner is
allowed only between triangles at the same ``t`` (``_assert_same_hits``,
as the JAX tests allow against their brute force). ``t`` is compared to
rtol 1e-5: XLA:CPU contracts Möller-Trumbore's multiply-adds into FMAs and
PyTorch does not. ``sort8_by_key`` and the row gather move values without
arithmetic: exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nrc_tpu.ops import intersect_wide as JIW
from nrc_tpu.ops.intersect import TriSoA as JTriSoA
from nrc_tpu_torch.ops import gather_cuda as GC
from nrc_tpu_torch.ops import intersect_wide as IW
from nrc_tpu_torch.ops import intersect_wide_cuda as WC
from nrc_tpu_torch.ops.bvh_wide import build_wide_bvh
from nrc_tpu_torch.ops.intersect import RT_MAX, TriSoA, make_intersectors
from test_torch_bvh import soup
from test_torch_intersect import one_torch_thread  # noqa: F401 (an autouse fixture)


def rays(n, seed=2):
    rng = np.random.default_rng(seed)
    org = (rng.random((n, 3)) * 10).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    return org, d / np.linalg.norm(d, axis=-1, keepdims=True)


def near_axis_rays(n, seed=10):
    """Directions a hair off an axis: the slabs of the other two axes
    overflow, which is why empty slots are masked by meta."""
    rng = np.random.default_rng(seed)
    org = (rng.random((n, 3)) * 10).astype(np.float32)
    d = np.zeros((n, 3), np.float32)
    d[np.arange(n), rng.integers(0, 3, n)] = np.where(rng.random(n) < 0.5, 1.0, -1.0)
    d[: n // 2] += rng.normal(size=(n // 2, 3)).astype(np.float32) * 1e-9  # the rest stay exact
    return org, d / np.linalg.norm(d, axis=-1, keepdims=True)


def _assert_same_hits(prim_a, t_a, prim_b, t_b, rtol=1e-5, atol=0.0):
    """``tests/test_intersect_wide.py::_assert_same_hits``."""
    mism = np.nonzero(prim_a != prim_b)[0]
    real = [i for i in mism if abs(t_a[i] - t_b[i]) > rtol * max(1.0, abs(t_b[i]))]
    assert not real, (len(real), real[:5])
    same = (prim_a >= 0) & (prim_a == prim_b)
    np.testing.assert_allclose(t_a[same], t_b[same], rtol=rtol, atol=atol)


def _case(name):
    """-> (triangles, branch, leaf, org, d, tmin, tmax)."""
    if name in ("soup500", "soup5000"):
        num_tris, n = (500, 777) if name == "soup500" else (5000, 4100)
        org, d = rays(n)
        tmin, tmax = np.zeros(n, np.float32), np.full(n, RT_MAX, np.float32)
        tmax[::13] = 0.0  # dead lanes
        tmin[::7] = 0.5   # epsilon offsets
        return soup(num_tris), 8, 8, org, d, tmin, tmax
    if name == "finite_tmax":
        org, d = rays(513, seed=6)
        tmax = (np.random.default_rng(7).random(513) * 8.0).astype(np.float32)
        return soup(1500, seed=5), 8, 8, org, d, np.full(513, 1e-4, np.float32), tmax
    if name == "near_axis":
        org, d = near_axis_rays(384)
        return soup(800, seed=9), 8, 8, org, d, np.zeros(384, np.float32), np.full(384, RT_MAX, np.float32)
    if name == "tiny":  # three triangles, one leaf; half the rays aimed at a triangle
        tri = soup(3)
        org, d = rays(64)
        aim = (tri[0] + tri[1] + tri[2])[np.arange(32) % 3] / 3.0 - org[:32]
        d[:32] = aim / np.linalg.norm(aim, axis=-1, keepdims=True)
        return tri, 8, 8, org, d, np.zeros(64, np.float32), np.full(64, RT_MAX, np.float32)
    branch, leaf = {"branch16_leaf8": (16, 8), "branch16_leaf16": (16, 16)}[name]
    org, d = rays(2000, seed=22)
    return soup(5000, seed=21), branch, leaf, org, d, np.full(2000, 1e-3, np.float32), np.full(2000, RT_MAX, np.float32)


CASES = ["soup500", "soup5000", "finite_tmax", "near_axis", "tiny", "branch16_leaf8", "branch16_leaf16"]


@pytest.fixture(scope="module", params=CASES)
def case(request):
    (p0, p1, p2), branch, leaf, org, d, tmin, tmax = _case(request.param)
    wb = build_wide_bvh(p0, p1, p2, leaf_size=leaf, branch=branch)
    t = torch.from_numpy
    return dict(
        jwb=jax.tree.map(jnp.asarray, wb), jtris=JTriSoA.build(p0, p1, p2),
        bvh=IW.upload_wide_bvh(wb, "cpu"), tris=TriSoA.build(p0, p1, p2),
        np_rays=(org, d, tmin, tmax), rays=(t(org), t(d), t(tmin), t(tmax)),
    )


def test_closest_hit_matches_jax_walk(case):
    c = case
    org, d, tmin, tmax = c["np_rays"]
    ref = JIW.intersect_wbvh(org, d, c["jwb"], c["jtris"], tmin, tmax)
    out = IW.intersect_wbvh(*c["rays"][:2], c["bvh"], c["tris"], *c["rays"][2:])
    ref_prim, ref_t = np.asarray(ref.prim), np.asarray(ref.t)
    _assert_same_hits(out.prim.numpy(), out.t.numpy(), ref_prim, ref_t)
    assert np.array_equal(out.prim.numpy() >= 0, ref_prim >= 0)
    assert (ref_prim >= 0).any()
    dead = tmax <= tmin
    assert not (out.prim.numpy()[dead] >= 0).any() and (out.t.numpy()[dead] == np.float32(RT_MAX)).all()
    same = out.prim.numpy() == ref_prim
    np.testing.assert_allclose(out.u.numpy()[same], np.asarray(ref.u)[same], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(out.v.numpy()[same], np.asarray(ref.v)[same], rtol=1e-4, atol=1e-5)


def test_anyhit_matches_jax_walk(case):
    c = case
    org, d, tmin, tmax = c["np_rays"]
    ref = JIW.occluded_wbvh(org, d, c["jwb"], c["jtris"], tmin, tmax)
    out = IW.occluded_wbvh(*c["rays"][:2], c["bvh"], *c["rays"][2:])
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_walk_matches_own_plane_brute_force(case):
    """The port's two paths against each other: Möller-Trumbore in the walk,
    the plane form in the brute force. The plane form's t = -(n.o + d0)/(n.d)
    cancels in its numerator, so its error is absolute and grows as 1/(n.d)
    for a grazing ray (2.8e-5 seen at t = 0.6, 5e-7 at t = 3e-3): rtol and
    atol 1e-4, ten times the walk-against-walk bound."""
    c = case
    closest, occluded = make_intersectors(c["tris"])
    a = IW.intersect_wbvh(*c["rays"][:2], c["bvh"], c["tris"], *c["rays"][2:])
    b = closest(*c["rays"])
    _assert_same_hits(a.prim.numpy(), a.t.numpy(), b.prim.numpy(), b.t.numpy(), rtol=1e-4, atol=1e-4)
    occ = IW.occluded_wbvh(*c["rays"][:2], c["bvh"], *c["rays"][2:])
    assert (occ == occluded(*c["rays"])).float().mean() >= 0.999


def test_rows_fetched_and_order_independence(case):
    """The count of fetched rows (the walk kernels' byte bound) is at least
    one per live ray; an any-hit walk stops at its first hit, so it finds a
    hit on the same rays and never fetches more rows than the closest-hit
    walk."""
    c = case
    org, d, tmin, tmax = c["rays"]
    t, prim, fetched = IW.wide_traverse_plain(org, d, c["bvh"], tmin, tmax, any_hit=False)
    _, prim_any, fetched_any = IW.wide_traverse_plain(org, d, c["bvh"], tmin, tmax, any_hit=True)
    live = int((tmax > tmin).sum())
    assert fetched >= live and live <= fetched_any <= fetched
    assert torch.equal(prim >= 0, prim_any >= 0)
    assert prim.dtype == torch.int64 and t.dtype == torch.float32


@pytest.mark.parametrize("any_hit", [False, True])
def test_rows_seen_are_the_distinct_rows_fetched(case, monkeypatch, any_hit):
    """``rows_seen`` (the walk kernels' byte bound when the table stays in
    the cache) marks exactly the rows the walk gathers: every gathered row
    but the clamped index 0 of a ray with nothing pending, which is the
    root every live ray fetches first. The walk's result does not change."""
    c = case
    org, d, tmin, tmax = c["rays"]
    gathered = []

    def recording_gather(table, idx):
        gathered.append(idx.clone())
        return GC.gather_rows(table, idx)

    t_ref, p_ref, fetched_ref = IW.wide_traverse_plain(org, d, c["bvh"], tmin, tmax, any_hit)
    monkeypatch.setattr(IW, "gather_rows", recording_gather)
    seen = torch.zeros(c["bvh"].rows.shape[0], dtype=torch.bool)
    t, prim, fetched = IW.wide_traverse_plain(org, d, c["bvh"], tmin, tmax, any_hit, rows_seen=seen)
    assert torch.equal(t, t_ref) and torch.equal(prim, p_ref) and fetched == fetched_ref
    expected = torch.zeros_like(seen)
    expected[torch.cat(gathered)] = True
    assert torch.equal(seen, expected)
    assert 1 <= int(seen.sum()) <= min(fetched, seen.numel())


@pytest.mark.parametrize("any_hit", [False, True])
def test_ray_fetches_add_up_to_the_rows_fetched(case, any_hit):
    """``ray_fetches`` (each ray's chain of dependent row fetches, printed per
    launch by ``chip_smoke.py`` 7b and ``tools/bench_walk.py``) adds up to
    the walk's count of fetched rows: none for a dead ray, at least the root
    for a live one. The walk's result does not change."""
    c = case
    org, d, tmin, tmax = c["rays"]
    t_ref, p_ref, fetched_ref = IW.wide_traverse_plain(org, d, c["bvh"], tmin, tmax, any_hit)
    per_ray = torch.zeros(org.shape[0], dtype=torch.int64)
    t, prim, fetched = IW.wide_traverse_plain(org, d, c["bvh"], tmin, tmax, any_hit, ray_fetches=per_ray)
    assert torch.equal(t, t_ref) and torch.equal(prim, p_ref) and fetched == fetched_ref
    assert int(per_ray.sum()) == fetched
    live = tmax > tmin
    assert bool((per_ray[~live] == 0).all()) and bool((per_ray[live] >= 1).all())


@pytest.mark.parametrize("width", [8, 16])
def test_sort8_by_key_matches_jax(width):
    rng = np.random.default_rng(3)
    key = rng.random((257, width)).astype(np.float32)
    key[rng.random((257, width)) < 0.3] = np.inf  # missed and empty slots
    key[:, 1] = key[:, 0]                         # ties: the network decides, on both sides alike
    val = rng.integers(-100, 100, (257, width)).astype(np.int32)
    ref = np.asarray(JIW.sort8_by_key(jnp.asarray(key), jnp.asarray(val)))
    out = IW.sort8_by_key(torch.from_numpy(key), torch.from_numpy(val))
    np.testing.assert_array_equal(out.numpy(), ref)
    assert IW._batcher_network(width) == JIW._batcher_network(width)
    assert len(IW._batcher_network(8)) == 19 and len(IW._batcher_network(16)) == 63


def test_gather_rows_plain_matches_jax_and_keeps_nan_patterns():
    rng = np.random.default_rng(5)
    bits = rng.integers(-2**31, 2**31 - 1, (300, 160), dtype=np.int64).astype(np.int32)
    bits[7, 96:112] = np.int32(-2147483648)          # empty-slot metas
    bits[7, 112:128] = ~np.arange(16, dtype=np.int32)  # leaf metas: negative, NaN patterns
    bits[9, 144:160] = -1                            # padding ids: all ones, a NaN
    table = bits.view(np.float32)
    assert np.isnan(table[7, 112:128]).all() and np.isnan(table[9, 144:160]).all()
    idx = rng.integers(0, 300, 1000)
    idx[:2] = (7, 9)
    ref = np.asarray(jnp.asarray(table)[jnp.asarray(idx)])
    out = GC.gather_rows(torch.from_numpy(table), torch.from_numpy(idx))
    np.testing.assert_array_equal(out.numpy().view(np.int32), ref.view(np.int32))
    np.testing.assert_array_equal(out.numpy().view(np.int32), bits[idx])
    out32 = GC.gather_rows(torch.from_numpy(table), torch.from_numpy(idx.astype(np.int32)))
    assert torch.equal(out32.view(torch.int32), out.view(torch.int32))


@pytest.mark.parametrize("rows,n", [(5, 1000), (1224, 1000), (131072, 2048)])
def test_the_gather_bound_reads_each_distinct_row_once(rows, n):
    """``bench_gather.bound_ms`` (the gathers' bound in ``chip_smoke.py`` and
    the frame-weighted one): the distinct rows the indices name read once,
    every gathered row written once, every int64 index read once. A 5-row
    table is read once however many rows are gathered from it."""
    from nrc_tpu_torch.tools import bench_gather as BG

    rng = np.random.default_rng(rows)
    idx = torch.from_numpy(rng.integers(0, rows, n))
    unique = len(set(idx.tolist()))
    assert BG.unique_rows(idx) == unique <= min(rows, n)
    cols = 26
    assert BG.bound_ms(BG.unique_rows(idx), n, cols) == pytest.approx(
        1e3 * ((unique + n) * cols * 4 + n * 8) / 3.35e12)


def test_cpu_tensors_take_the_plain_versions():
    p0, p1, p2 = soup(200)
    bvh = IW.upload_wide_bvh(build_wide_bvh(p0, p1, p2), "cpu")
    org, d = rays(32)
    t = torch.from_numpy
    kernels = (WC.CLOSEST_KERNEL, WC.ANYHIT_KERNEL, *GC.VARIANTS.values())
    IW.intersect_wbvh(t(org), t(d), bvh, TriSoA.build(p0, p1, p2), torch.zeros(32), torch.full((32,), RT_MAX))
    IW.occluded_wbvh(t(org), t(d), bvh, torch.zeros(32), torch.full((32,), RT_MAX))
    assert all(k.launches == 0 and k._fn is None for k in kernels)  # nothing built, nothing launched
    assert GC.PATH_KERNEL in GC.VARIANTS.values()


def test_walk_kernel_limits_are_checked_on_the_host():
    """What the walk kernel was not compiled for is refused by the wrapper
    before any launch: the check is plain Python."""
    p0, p1, p2 = soup(2000)
    bvh = IW.upload_wide_bvh(build_wide_bvh(p0, p1, p2, leaf_size=16, branch=16), "cpu")
    WC.check_walkable(bvh)
    assert (bvh.branch - 1) * bvh.depth + 1 <= WC.MAX_STACK
    with pytest.raises(ValueError, match="stack"):
        WC.check_walkable(bvh._replace(depth=18))
    # a group's stack row holds MAX_STACK entries (csrc/intersect_wide.cu's
    # kStack); a tree of D levels needs (B - 1) * D + 1 of them
    for tree in (bvh, IW.upload_wide_bvh(build_wide_bvh(p0, p1, p2, leaf_size=8, branch=8), "cpu")):
        deepest = (WC.MAX_STACK - 1) // (tree.branch - 1)
        WC.check_walkable(tree._replace(depth=deepest))
        with pytest.raises(ValueError, match="stack"):
            WC.check_walkable(tree._replace(depth=deepest + 1))
    with pytest.raises(ValueError, match="branch"):
        WC.check_walkable(bvh._replace(branch=32))
    with pytest.raises(ValueError, match="leaf_size"):
        WC.check_walkable(bvh._replace(leaf_size=6))
    with pytest.raises(ValueError, match="row width"):
        WC.check_walkable(bvh._replace(rows=bvh.rows[:, :100]))
