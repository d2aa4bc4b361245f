"""Port parity for the host side of the large-scene path: the wide-BVH build,
the sphere and torus builders and the ``cornell_objects`` scene.

The port's ``build_wide_bvh`` runs its own copy of the native SAH builder
and collapse, compiled with the JAX loader's flags, so on one machine it
must return the JAX package's dictionary array by array, bit for bit (rows
are compared as int32: metas and ids are NaN patterns). The numpy and Python
fall-backs (no C compiler) build other trees; they are held to the build's
invariants and to the brute force's hits.
"""

import numpy as np
import pytest
import torch

from nrc_tpu.ops import bvh_wide as JW
from nrc_tpu.scene import geometry as jgeo
from nrc_tpu_torch.ops import bvh as PB
from nrc_tpu_torch.ops import bvh_wide as PW
from nrc_tpu_torch.ops.intersect import BVH_THRESHOLD, RT_MAX, TriSoA, make_intersectors
from nrc_tpu_torch.ops.intersect_wide import intersect_wbvh, upload_wide_bvh
from nrc_tpu_torch.render.scene_device import upload_scene
from nrc_tpu_torch.scene import geometry as pgeo
from nrc_tpu_torch.scene.scene_builder import cornell_objects
from test_torch_intersect import one_torch_thread  # noqa: F401 (an autouse fixture)


def soup(num_tris, seed=1, spread=0.3):
    """The random soup of ``tests/test_intersect_wide.py``."""
    rng = np.random.default_rng(seed)
    c = rng.random((num_tris, 3)).astype(np.float32) * 10
    return tuple(c + rng.normal(size=(num_tris, 3)).astype(np.float32) * spread for _ in range(3))


def align_builders(mp):
    """Both packages must build with the same code for an array-by-array
    comparison: each has a native library, compiled at first use, and a
    Python fall-back that builds another (valid) tree. Where only one of the
    two libraries is available in this process (no compiler, or a build
    that failed), put the other package on its fall-back as well."""
    import nrc_tpu.native as jax_native

    if (jax_native.get_lib() is None) != (PW.get_lib() is None):
        for module in (PB, PW):
            mp.setattr(module, "get_lib", lambda: None)
        mp.setattr(jax_native, "get_lib", lambda: None)


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def check_invariants(wb, num_tris):
    """The invariants of ``tests/test_intersect_wide.py:55-73``, for any
    branch: inner children point at node rows, leaf children at leaf rows
    that exist, and every primitive sits in exactly one leaf."""
    dims = PW.wide_dims(wb)
    rows, width = wb["rows"].shape
    num_leaves = rows - dims.num_nodes
    assert width >= 7 * dims.branch and width >= (dims.prim_row_w + 1) * dims.leaf_size
    metas = wb["rows"][: dims.num_nodes, 6 * dims.branch: 7 * dims.branch].view(np.int32)
    inner = (metas >= 0) & (metas != PW.NONE)
    assert metas[inner].max(initial=0) < dims.num_nodes
    leaves = np.where((metas < 0) & (metas != PW.NONE), ~metas, -1)
    assert leaves.max() < num_leaves
    referenced = np.sort(leaves[leaves >= 0])
    np.testing.assert_array_equal(referenced, np.arange(referenced.size))  # each leaf once
    ids = wb["leaf_ids"]
    np.testing.assert_array_equal(np.sort(ids[ids >= 0]), np.arange(num_tris))
    # the leaf rows carry the same ids, bit-cast, after the 9 triangle columns
    row_ids = wb["rows"][dims.num_nodes:, 9 * dims.leaf_size: 10 * dims.leaf_size].view(np.int32)
    np.testing.assert_array_equal(row_ids[: ids.shape[0]], ids)


@pytest.mark.parametrize("branch,leaf", [(8, 8), (16, 16)])
@pytest.mark.parametrize("num_tris", [3, 2000, 5000])
def test_wide_build_equals_jax_build(monkeypatch, num_tris, branch, leaf):
    align_builders(monkeypatch)
    p0, p1, p2 = soup(num_tris)
    got = PW.build_wide_bvh(p0, p1, p2, leaf_size=leaf, branch=branch)
    ref = JW.build_wide_bvh(p0, p1, p2, leaf_size=leaf, branch=branch)
    assert sorted(got) == sorted(ref)
    for key in ref:
        assert got[key].shape == ref[key].shape and got[key].dtype == ref[key].dtype, key
        np.testing.assert_array_equal(_bits(got[key]), _bits(ref[key]), err_msg=key)
    check_invariants(got, num_tris)
    dims = PW.wide_dims(got)
    assert (dims.branch, dims.leaf_size, dims.prim_row_w) == (branch, leaf, 9)


def test_binary_build_equals_jax_build(monkeypatch):
    from nrc_tpu.ops.bvh import build_bvh as jax_build_bvh

    align_builders(monkeypatch)
    p0, p1, p2 = soup(3000, seed=4)
    got, ref = PB.build_bvh(p0, p1, p2), jax_build_bvh(p0, p1, p2)
    for key in ref:
        np.testing.assert_array_equal(_bits(got[key]), _bits(ref[key]), err_msg=key)
    empty = PB.build_bvh(*(np.zeros((0, 3), np.float32),) * 3)
    assert empty["left"].tolist() == [-1] and empty["order"].size == 0


def _hits_match_brute_force(wb, p0, p1, p2):
    tris = TriSoA.build(p0, p1, p2)
    rng = np.random.default_rng(2)
    n = 300
    org = torch.from_numpy((rng.random((n, 3)) * 10).astype(np.float32))
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d = torch.from_numpy(d / np.linalg.norm(d, axis=-1, keepdims=True))
    tmin, tmax = torch.zeros(n), torch.full((n,), RT_MAX)
    a = intersect_wbvh(org, d, upload_wide_bvh(wb, "cpu"), tris, tmin, tmax)
    b = make_intersectors(tris)[0](org, d, tmin, tmax)
    assert torch.equal(a.prim, b.prim) and (b.prim >= 0).float().mean() > 0.3
    torch.testing.assert_close(a.t, b.t, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("which", ["no native library", "native build, Python collapse"])
def test_fallback_builds_give_a_valid_tree(monkeypatch, which):
    """Without a C compiler the build is a numpy median split and a Python
    collapse: another tree than the native one, held to the invariants and
    to the brute force's hits."""
    p0, p1, p2 = soup(1500, seed=3)
    monkeypatch.setattr(PW, "get_lib", lambda: None)
    if which == "no native library":
        monkeypatch.setattr(PB, "get_lib", lambda: None)
    wb = PW.build_wide_bvh(p0, p1, p2, leaf_size=8, branch=8)
    check_invariants(wb, 1500)
    _hits_match_brute_force(wb, p0, p1, p2)
    import nrc_tpu.native as jax_native

    if jax_native.get_lib() is not None:  # really another path than the native one
        native = JW.build_wide_bvh(p0, p1, p2, leaf_size=8, branch=8)
        assert wb["rows"].shape != native["rows"].shape or not np.array_equal(
            _bits(wb["rows"]), _bits(native["rows"]))


def test_upload_keeps_bits_and_sizes():
    p0, p1, p2 = soup(2000)
    wb = PW.build_wide_bvh(p0, p1, p2, leaf_size=16, branch=16)
    dev = upload_wide_bvh(wb, "cpu")
    assert torch.equal(dev.rows.view(torch.int32), torch.from_numpy(wb["rows"]).view(torch.int32))
    dims = PW.wide_dims(wb)
    assert (dev.num_nodes, dev.depth, dev.branch, dev.leaf_size) == (
        dims.num_nodes, dims.depth, 16, 16)
    lo = np.minimum(np.minimum(p0, p1), p2).min(0)
    hi = np.maximum(np.maximum(p0, p1), p2).max(0)
    np.testing.assert_array_equal(np.asarray(dev.root, np.float32), np.stack([lo, hi]))
    curves = dict(wb, leaf_row_w=np.zeros((1, 5), np.int32))
    with pytest.raises(ValueError, match="triangle leaf rows"):
        upload_wide_bvh(curves, "cpu")


@pytest.mark.parametrize("kind", ["sphere", "torus"])
def test_sphere_and_torus_equal_jax(kind):
    if kind == "sphere":
        got, ref = pgeo.create_sphere(16, 8, 2.0, 0.75 * np.pi), jgeo.create_sphere(16, 8, 2.0, 0.75 * np.pi)
    else:
        got, ref = pgeo.create_torus(12, 6, 0.5, 2.0), jgeo.create_torus(12, 6, 0.5, 2.0)
    for f in ("vertices", "normals", "tangents", "texcoords", "indices"):
        np.testing.assert_array_equal(getattr(got, f), getattr(ref, f), err_msg=f)
    assert got.num_triangles == ref.num_triangles > 0


def test_cornell_objects_scene_and_its_bvh():
    scene, system = cornell_objects((32, 32))
    assert scene.num_triangles == 6 * 200 + 2 * 65536 > BVH_THRESHOLD
    assert system.resolution == (32, 32) and scene.lights.num_lights == 1
    # the sphere's first ring is its pole: triangles of zero area, kept in the scene
    area = np.linalg.norm(np.cross(scene.p1 - scene.p0, scene.p2 - scene.p0), axis=-1)
    assert (area == 0.0).sum() >= 256
    lo, hi = scene.aabb()
    np.testing.assert_array_equal(np.stack([lo, hi]), [[-10.0] * 3, [10.0] * 3])
    ds = upload_scene(scene, "cpu")
    assert ds.planes is None and (ds.bvh.branch, ds.bvh.leaf_size) == (16, 16)
    assert ds.bvh.rows.shape[1] == 160 and ds.bvh.root == ((-10.0,) * 3, (10.0,) * 3)
    assert ds.tri_shade.shape == (scene.num_triangles, 26)
    meta = ds.tri_shade[:, 24:26].view(torch.int32).numpy()
    np.testing.assert_array_equal(meta[:, 0], scene.material_id)
    np.testing.assert_array_equal(meta[:, 1], scene.light_id)
    # a small scene takes the BVH only when asked
    forced = upload_scene(cornell_objects((32, 32))[0], "cpu", use_bvh=False)
    assert forced.bvh is None and forced.planes.shape == (scene.num_triangles, 24)
