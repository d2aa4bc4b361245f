"""Port parity: the plain versions of kernels K1/K2 against the TPU kernels.

The JAX kernels ``intersect_planes``/``occluded_planes`` run in interpret
mode on the CPU, as ``tests/test_intersect_pallas.py`` runs them. Both sides
get the same rays and the same plane table (the JAX one, converted to the
port's packed layout), so hit/miss, winner and occlusion must be identical
and t agree to float32 rounding (the interpret-mode dot products may sum in
another order).
"""

import numpy as np
import pytest
import torch

from nrc_tpu.ops import intersect_pallas as JP
from nrc_tpu.ops.intersect import TriSoA as JTriSoA
from nrc_tpu_torch.ops import intersect_cuda as PC
from nrc_tpu_torch.ops.intersect import (
    BVH_THRESHOLD,
    RT_MAX,
    TriSoA,
    hit_from_t_prim,
    make_intersectors,
)
from nrc_tpu_torch.render.frame import pixel_grid
from nrc_tpu_torch.render.renderer import Renderer
from nrc_tpu_torch.scene.scene_builder import cornell_box
from nrc_tpu_torch.utils import rng as PR


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the port (the other port test files import
    this fixture): the test shapes are too small to share out, and test
    processes running side by side would fight over the cores (a 32x32
    frame then takes ten times as long)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def planes_from_tpu_layout(w) -> torch.Tensor:
    """The TPU kernel's [6, 8, Tp] plane table -> the port's packed [Tp, 24]:
    per triangle the planes An, Bn, Au, Bu, Av, Bv, four coefficients each
    (even rows hold theirs in sublanes 0-3, odd rows in 4-7)."""
    w = torch.from_numpy(np.array(w))
    rows = [w[k, 0:4] if k % 2 == 0 else w[k, 4:8] for k in range(6)]  # [4, Tp] each
    return torch.stack(rows, dim=0).permute(2, 0, 1).reshape(w.shape[2], PC.PLANE_FLOATS).contiguous()


def _random_soup(seed, num_tris=700, num_rays=512):
    """700 triangles (not a multiple of the TPU kernel's 512-wide tiles),
    two of them degenerate (a repeated vertex, three collinear vertices)."""
    rs = np.random.default_rng(seed)
    p0 = rs.uniform(-2.0, 2.0, (num_tris, 3)).astype(np.float32)
    p1 = (p0 + rs.normal(size=(num_tris, 3)) * 0.5).astype(np.float32)
    p2 = (p0 + rs.normal(size=(num_tris, 3)) * 0.5).astype(np.float32)
    p1[3] = p0[3]
    p2[5] = 2.0 * p1[5] - p0[5]
    org = rs.uniform(-3.0, 3.0, (num_rays, 3)).astype(np.float32)
    d = rs.normal(size=(num_rays, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tmin = np.zeros(num_rays, np.float32)
    tmax = np.full(num_rays, RT_MAX, np.float32)
    tmax[::7] = 0.0  # inactive lanes
    return (p0, p1, p2), org, d, tmin, tmax


def _cornell_rays():
    """The 32x32 camera rays of the Cornell box, then from their hits one
    secondary ray each in a uniform random direction (tmin = epsilon)."""
    scene, system = cornell_box((32, 32))
    r = Renderer(scene, system, device="cpu")
    pix, pidx = pixel_grid(r.cfg, torch.device("cpu"))
    seeds, jitter = PR.rng2(PR.tea(pidx, 0))
    cam = r._camera_arrays()
    from nrc_tpu_torch.scene.camera import generate_primary_rays

    org, d = generate_primary_rays(pix, jitter, (32, 32), *cam)
    n = org.shape[0]
    hit = make_intersectors(r.device_scene.tris, r.device_scene.planes)[0](
        org, d, torch.zeros(n), torch.full((n,), RT_MAX)
    )
    rs = np.random.default_rng(3)
    d2 = rs.normal(size=(n, 3)).astype(np.float32)
    d2 /= np.linalg.norm(d2, axis=-1, keepdims=True)
    p = (org + hit.t[:, None] * d).numpy()
    org_all = np.concatenate([org.numpy(), p])
    d_all = np.concatenate([d.numpy(), d2])
    tmin = np.concatenate([np.zeros(n), np.full(n, 5e-5)]).astype(np.float32)
    tmax = np.concatenate([np.full(n, RT_MAX), rs.uniform(0.0, 25.0, n)]).astype(np.float32)
    return (scene.p0, scene.p1, scene.p2), org_all, d_all, tmin, tmax


CASES = {"cornell": _cornell_rays, "soup0": lambda: _random_soup(0), "soup1": lambda: _random_soup(1)}


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    (p0, p1, p2), org, d, tmin, tmax = CASES[request.param]()
    jtris = JTriSoA.build(p0, p1, p2)
    jplanes = JP.build_plane_table(jtris)
    tris = TriSoA.build(p0, p1, p2)
    planes = planes_from_tpu_layout(jplanes)
    t = torch.from_numpy
    return dict(jtris=jtris, jplanes=jplanes, tris=tris, planes=planes,
                org=org, d=d, tmin=tmin, tmax=tmax,
                torg=t(org), td=t(d), ttmin=t(tmin), ttmax=t(tmax))


def test_closest_hit_matches_tpu_kernel(case):
    c = case
    ref = JP.intersect_planes(c["org"], c["d"], c["jplanes"], c["jtris"], c["tmin"], c["tmax"],
                              interpret=True)
    out = PC.intersect_planes(c["torg"], c["td"], c["planes"], c["tris"], c["ttmin"], c["ttmax"])
    ref_prim = np.asarray(ref.prim)
    np.testing.assert_array_equal(out.prim.numpy(), ref_prim)
    assert (ref_prim >= 0).mean() > 0.2
    # t = -An/Bn cancels in An when the origin is near the plane, so the
    # error of a sum taken in another order is absolute, at one float32 ulp
    # of the plane offsets (|n.o| ~ 3 here): atol 1e-6 next to rtol 1e-6
    np.testing.assert_allclose(out.t.numpy(), np.asarray(ref.t), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(out.u.numpy(), np.asarray(ref.u), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out.v.numpy(), np.asarray(ref.v), rtol=1e-5, atol=1e-5)


def test_anyhit_matches_tpu_kernel(case):
    c = case
    ref = JP.occluded_planes(c["org"], c["d"], c["jplanes"], c["tmin"], c["tmax"], interpret=True)
    out = PC.occluded_planes(c["torg"], c["td"], c["planes"], c["ttmin"], c["ttmax"])
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert 0.05 < np.asarray(ref).mean() < 0.95


def test_own_plane_table_gives_same_winners(case):
    """The port's table (built in torch) against the converted JAX table."""
    c = case
    own = PC.build_plane_table(c["tris"])
    a = PC.intersect_planes(c["torg"], c["td"], own, c["tris"], c["ttmin"], c["ttmax"])
    b = PC.intersect_planes(c["torg"], c["td"], c["planes"], c["tris"], c["ttmin"], c["ttmax"])
    assert (a.prim == b.prim).float().mean() > 0.999


def test_plain_chunks_agree_with_one_pass(case, monkeypatch):
    c = case
    whole = PC.closest_plain(c["torg"], c["td"], c["planes"], c["ttmin"], c["ttmax"])
    monkeypatch.setattr(PC, "_PLAIN_CHUNK_ELEMS", 7 * c["planes"].shape[0])
    chunked = PC.closest_plain(c["torg"], c["td"], c["planes"], c["ttmin"], c["ttmax"])
    assert torch.equal(whole[0], chunked[0]) and torch.equal(whole[1], chunked[1])


def test_degenerate_inactive_and_padded():
    p0 = np.asarray([[0.0, 0.0, 1.0], [1.0, 1.0, 1.0]], np.float32)
    tris = TriSoA.build(p0, p0 + [[1, 0, 0], [0, 0, 0]], p0 + [[0, 1, 0], [0, 0, 0]])
    d = torch.tensor([[0.2, 0.2, 1.0], [0.2, 0.2, 1.0]])
    d = d / d.norm(dim=-1, keepdim=True)
    org = torch.zeros(2, 3)
    tmin = torch.zeros(2)
    tmax = torch.tensor([RT_MAX, 0.0])  # ray 1 inactive
    planes = PC.build_plane_table(tris)
    assert torch.all(planes[1] == 0)  # degenerate triangle: all-zero planes
    hit = PC.intersect_planes(org, d, planes, tris, tmin, tmax)
    assert hit.prim.tolist() == [0, -1]
    assert PC.occluded_planes(org, d, planes, tmin, tmax).tolist() == [True, False]
    # a winner beyond the real triangles (a padded column) is no hit
    padded = torch.cat([torch.zeros(1, 24), planes[:1]])
    one = TriSoA(tris.p0[:1], tris.e1[:1], tris.e2[:1])
    assert PC.intersect_planes(org, d, padded, one, tmin, tmax).prim.tolist() == [-1, -1]


def test_hit_epilogue_barycentrics():
    tris = TriSoA.build([[0.0, 0.0, 1.0]], [[1.0, 0.0, 1.0]], [[0.0, 1.0, 1.0]])
    org = torch.tensor([[0.25, 0.5, 0.0]])
    d = torch.tensor([[0.0, 0.0, 1.0]])
    h = hit_from_t_prim(org, d, tris, torch.tensor([1.0]), torch.tensor([0]))
    torch.testing.assert_close(h.u, torch.tensor([0.25]))
    torch.testing.assert_close(h.v, torch.tensor([0.5]))


def test_cpu_tensors_take_the_plain_version():
    (p0, p1, p2), org, d, tmin, tmax = _random_soup(2, num_tris=64, num_rays=32)
    tris = TriSoA.build(p0, p1, p2)
    planes = PC.build_plane_table(tris)
    before = (PC.CLOSEST_KERNEL.launches, PC.ANYHIT_KERNEL.launches)
    t = torch.from_numpy
    PC.intersect_planes(t(org), t(d), planes, tris, t(tmin), t(tmax))
    PC.occluded_planes(t(org), t(d), planes, t(tmin), t(tmax))
    assert (PC.CLOSEST_KERNEL.launches, PC.ANYHIT_KERNEL.launches) == before == (0, 0)
    assert PC.CLOSEST_KERNEL._fn is None  # nothing was built


def test_large_scenes_refuse_brute_force(monkeypatch):
    """Above BVH_THRESHOLD triangles ``upload_scene`` builds the wide BVH and
    no plane table, and the intersectors made from it never touch the plane
    form; the small Cornell box stays on brute force."""
    from nrc_tpu_torch.render.scene_device import upload_scene
    from nrc_tpu_torch.scene.scene_builder import cornell_objects

    scene, _ = cornell_objects((16, 16))
    assert scene.num_triangles > BVH_THRESHOLD
    ds = upload_scene(scene, "cpu")
    assert ds.bvh is not None and ds.planes is None

    def refuse(*args):
        raise AssertionError("the plane form was used on a scene with a BVH")

    for name in ("build_plane_table", "intersect_planes", "occluded_planes"):
        monkeypatch.setattr(PC, name, refuse)
    closest, occluded = make_intersectors(ds.tris, ds.planes, ds.bvh)
    org = torch.tensor([[0.0, 0.0, 30.0], [0.0, 0.0, 30.0]])
    d = torch.tensor([[0.0, 0.0, -1.0], [0.0, 1.0, 0.0]])
    tmin, tmax = torch.zeros(2), torch.full((2,), RT_MAX)
    hit = closest(org, d, tmin, tmax)
    assert hit.prim[0] >= 0 and hit.prim[1] == -1 and abs(float(hit.t[0]) - 40.0) < 1e-4  # the back wall
    assert occluded(org, d, tmin, tmax).tolist() == [True, False]
    small = upload_scene(cornell_box((16, 16))[0], "cpu")
    assert small.bvh is None and small.planes is not None


# ---- scattered dead lanes: what the card's kernels compact away ---------------

SPARSE_RAYS = 1300  # neither a multiple of 1024 nor of any block of rays
SPARSE_CASES = {"all_live": 1.0, "live_16_percent": 0.16, "one_live": None, "none_live": 0.0}


@pytest.fixture(scope="module", params=sorted(SPARSE_CASES))
def sparse_case(request):
    """The soup's rays with only a scattered share of lanes alive. A dead lane
    has an empty t range (tmax = 0, as the integrator marks it) and carries
    an origin of NaN or +-infinity, which must not leak into its result or
    into a neighbour's."""
    (p0, p1, p2), org, d, tmin, tmax = _random_soup(4, num_rays=SPARSE_RAYS)
    rs = np.random.default_rng(5)
    share = SPARSE_CASES[request.param]
    if share is None:
        planes = PC.build_plane_table(TriSoA.build(p0, p1, p2))
        hits = PC.closest_plain(*(torch.from_numpy(x) for x in (org, d)), planes,
                                torch.zeros(SPARSE_RAYS), torch.full((SPARSE_RAYS,), RT_MAX))[1] >= 0
        live = np.zeros(SPARSE_RAYS, bool)
        live[1025 + int(np.argmax(hits.numpy()[1025:]))] = True  # a ray that hits, past the first 1024 lanes
    else:
        live = rs.random(SPARSE_RAYS) < share
    tmin = np.where(rs.random(SPARSE_RAYS) < 0.5, 0.0, 5e-5).astype(np.float32)
    tmax = np.where(live, RT_MAX, 0.0).astype(np.float32)
    poison = np.asarray([np.nan, np.inf, -np.inf], np.float32)[rs.integers(0, 3, SPARSE_RAYS)]
    org = np.where(live[:, None], org, poison[:, None]).astype(np.float32)
    jtris = JTriSoA.build(p0, p1, p2)
    jplanes = JP.build_plane_table(jtris)
    t = torch.from_numpy
    return dict(name=request.param, live=live, jtris=jtris, jplanes=jplanes, tris=TriSoA.build(p0, p1, p2),
                planes=planes_from_tpu_layout(jplanes), org=org, d=d, tmin=tmin, tmax=tmax,
                torg=t(org), td=t(d), ttmin=t(tmin), ttmax=t(tmax))


def test_closest_hit_with_dead_lanes_matches_tpu_kernel(sparse_case):
    c = sparse_case
    ref = JP.intersect_planes(c["org"], c["d"], c["jplanes"], c["jtris"], c["tmin"], c["tmax"],
                              interpret=True)
    out = PC.intersect_planes(c["torg"], c["td"], c["planes"], c["tris"], c["ttmin"], c["ttmax"])
    dead = ~c["live"]
    for prim, t in ((np.asarray(ref.prim), np.asarray(ref.t)), (out.prim.numpy(), out.t.numpy())):
        assert (prim[dead] == -1).all() and (t[dead] == np.float32(RT_MAX)).all()
        assert np.isfinite(t).all()
    np.testing.assert_array_equal(out.prim.numpy(), np.asarray(ref.prim))
    if c["live"].any():
        hit_share = (out.prim.numpy()[c["live"]] >= 0).mean()
        assert hit_share == 1.0 if c["name"] == "one_live" else hit_share > 0.2
    # tolerances as in test_closest_hit_matches_tpu_kernel, for its reasons
    np.testing.assert_allclose(out.t.numpy(), np.asarray(ref.t), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(out.u.numpy(), np.asarray(ref.u), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out.v.numpy(), np.asarray(ref.v), rtol=1e-5, atol=1e-5)


def test_anyhit_with_dead_lanes_matches_tpu_kernel(sparse_case):
    c = sparse_case
    tmax = np.where(c["live"], 2.0, 0.0).astype(np.float32)  # segments, so that some rays stay free
    ref = np.asarray(JP.occluded_planes(c["org"], c["d"], c["jplanes"], c["tmin"], tmax, interpret=True))
    out = PC.occluded_planes(c["torg"], c["td"], c["planes"], c["ttmin"], torch.from_numpy(tmax)).numpy()
    np.testing.assert_array_equal(out, ref)
    assert not out[~c["live"]].any() and not ref[~c["live"]].any()
    if c["name"] in ("all_live", "live_16_percent"):
        assert 0.05 < out[c["live"]].mean() < 0.95


@pytest.mark.parametrize("num_rays", [0, 1, 33])
def test_result_types_on_the_cpu(num_rays):
    """int64 winners and torch.bool occlusion, from the plain versions and
    from the dispatching entry points alike (the card's kernels write the
    same types)."""
    (p0, p1, p2), org, d, tmin, tmax = _random_soup(6, num_tris=40, num_rays=max(num_rays, 1))
    t = torch.from_numpy
    rays = tuple(t(x[:num_rays]) for x in (org, d))
    rng = tuple(t(x[:num_rays]) for x in (tmin, tmax))
    tris = TriSoA.build(p0, p1, p2)
    planes = PC.build_plane_table(tris)
    t_plain, prim_plain = PC.closest_plain(*rays, planes, *rng)
    hit = PC.intersect_planes(*rays, planes, tris, *rng)
    for prim, tt in ((prim_plain, t_plain), (hit.prim, hit.t)):
        assert prim.dtype == torch.int64 and tt.dtype == torch.float32
        assert prim.shape == tt.shape == (num_rays,)
    for occ in (PC.occluded_plain(*rays, planes, *rng), PC.occluded_planes(*rays, planes, *rng)):
        assert occ.dtype == torch.bool and occ.shape == (num_rays,)
