"""The render wavefront's lanes compacted once after bounce 1, on the CPU.

``render/integrator.py::trace_wavefront`` runs the render wavefront's
bounces 2.. on its live lanes gathered into ``compact_capacity(N)`` lanes
where they fit, and on every lane where they do not; off the card it reads
which (``_all_done`` on the 0-d flag of an overflow, the one read the
compaction adds). The tests hold the index on its own, the wavefront's
outputs in both bodies against the full-width loop on every built-in scene
(textures and cutouts, media, curves, layered and measured materials,
declared lights, glass), with the primary raster's first hits and on a
band, and a FULL + train frame with the compaction on and off. The card's
side (the IF nodes of a captured frame) is in ``tests/test_torch_cuda.py``.
The JAX-parity tests run their frames through ``checked_at_full_width``,
which holds the default path to the full-width loop on their own scenes.

Every comparison is exact: the bits of each float tensor, integers equal.
"""

import dataclasses

import pytest
import torch

import nrc_tpu_torch.render.integrator as port_integrator
from nrc_tpu_torch.config import RenderMode
from nrc_tpu_torch.models import network as N
from nrc_tpu_torch.ops.intersect import hit_from_t_prim
from nrc_tpu_torch.ops.raster_primary import raster_closest_hit
from nrc_tpu_torch.render.frame import pixel_grid, training_rays
from nrc_tpu_torch.render.renderer import Renderer
from nrc_tpu_torch.scene.camera import generate_primary_rays
from nrc_tpu_torch.scene.scene_builder import named_scene
from nrc_tpu_torch.utils import rng as R
from test_torch_intersect import one_torch_thread  # noqa: F401 (an autouse fixture)

RES = (32, 32)
# every built-in scene at a size its CPU frame takes a second or so: (size,
# arguments, the capacity of the compacted body, None for the wavefront's
# own, and one under the live count after bounce 1, 3-121 lanes here)
SCENES = {
    "cornell_box": (RES, {}, None, 8),
    "cornell_objects": ((16, 16), {}, 64, 2),
    "cornell_glass": (RES, {}, None, 8),
    "cornell_lights": (RES, {}, None, 8),
    "env_textured": (RES, {}, None, 8),
    "cornell_materials": (RES, {}, None, 8),
    "cornell_volume": (RES, {}, None, 8),
    "cornell_hair": (RES, {"strands": 300}, None, 8),
}


def full_width(n: int) -> int:
    """``integrator.compact_capacity`` that leaves no lane out: every bounce
    runs at the wavefront's full width, as the JAX package's do."""
    return n


_CHECKING = []  # set while a ``checked_at_full_width`` call runs


def checked_at_full_width(trace, log: list):
    """``trace_wavefront`` as a frame runs it, at the default capacity (the
    render wavefront's bounces 2.. compacted), called again with every
    bounce at the full width, as the JAX frame runs them: the two calls'
    outputs must be equal bit for bit, and only the second's logged calls
    stay in ``log``, to compare with JAX's ray by ray. The frame goes on
    with the first call's outputs, so that its image, stats and network
    state, which the JAX-parity tests compare with JAX's, are the default
    path's. Where one check wraps another, the inner one calls through, and
    so does a check where every bounce runs at the full width already."""

    def wrapped(*args, **kwargs):
        if _CHECKING or port_integrator.compact_capacity is full_width:
            return trace(*args, **kwargs)
        _CHECKING.append(True)
        try:
            mark = len(log)
            out = trace(*args, **kwargs)
            del log[mark:]
            capacity = port_integrator.compact_capacity
            port_integrator.compact_capacity = full_width
            try:
                wide = trace(*args, **kwargs)
            finally:
                port_integrator.compact_capacity = capacity
        finally:
            _CHECKING.pop()
        _assert_same(out, wide, "the default capacity against the full width:")
        return out

    return wrapped


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _assert_same(got, ref, what):
    for name, a, b in zip(got._fields, got, ref):
        assert (a is None) == (b is None), f"{what} {name}"
        if a is not None:
            assert a.dtype == b.dtype and a.shape == b.shape, f"{what} {name}"
            assert torch.equal(_bits(a), _bits(b)), f"{what} {name}: differs"


def _renderer(name, mode=RenderMode.FULL, train=True) -> Renderer:
    res, kw, _, _ = SCENES[name]
    scene, system = named_scene(name, res, **kw)
    system = dataclasses.replace(system, tile_size=(8, 8))
    return Renderer(scene, system, render_mode=mode, train=train, adaptive_tiles=False, device="cpu")


def _render_rays(r: Renderer, subframe: int, rows=None, row_offset=0):
    """The render wavefront's rays of the frame, or of a band of ``rows``."""
    pix, pidx = pixel_grid(r.cfg, r.device, rows, row_offset)
    seeds, jitter = R.rng2(R.tea(pidx, subframe))
    org, d = generate_primary_rays(pix, jitter, (r.cfg.width, r.cfg.height), *r._camera_arrays(),
                                   lens=r.cfg.lens_shader)
    return org, d, seeds


def _trace(r: Renderer, org, d, seeds, capacity=None, **kw):
    """``trace_wavefront`` on ``r``'s scene, with ``compact_capacity`` giving
    ``capacity`` lanes where one is given (every lane: no compaction)."""
    with pytest.MonkeyPatch.context() as mp:
        if capacity is not None:
            mp.setattr(port_integrator, "compact_capacity", lambda n: capacity)
        return port_integrator.trace_wavefront(r.device_scene, org, d, seeds, r.cfg, **kw)


def _fits_reads(monkeypatch):
    """The compaction's reads, recorded: each 0-d flag ``_all_done`` sees is
    an overflow, and its answer whether the live lanes fit."""
    seen = []
    early_exit = port_integrator._all_done

    def recording(x):
        done = early_exit(x)
        if x.dim() == 0:
            seen.append(done)
        return done

    monkeypatch.setattr(port_integrator, "_all_done", recording)
    return seen


# ---- the index ------------------------------------------------------------------

@pytest.mark.parametrize("n,cap,live", [
    (1000, 256, [3, 4, 17, 500, 998]),   # a few lanes, scattered
    (1000, 256, []),                     # none alive
    (1000, 256, list(range(0, 1000, 4))),  # exactly the capacity: no padding
    (1000, 256, list(range(1, 1000, 3))),  # 333: more than the capacity
    (300, 256, list(range(299))),        # one dead lane pads the rest
])
def test_compact_index_is_stable_pads_with_a_dead_lane_and_counts(n, cap, live):
    alive = torch.zeros(n, dtype=torch.bool)
    alive[live] = True
    index, count = port_integrator.compact_index(alive, cap)
    assert index.shape == (cap,) and index.dtype == torch.int64
    assert count.dim() == 0 and int(count) == len(live)
    k = min(len(live), cap)
    assert index[:k].tolist() == live[:k]  # the live lanes in their order
    if len(live) <= cap:
        pad = index[k:]
        assert not bool(alive[pad].any()) and len(set(pad.tolist())) <= 1  # one dead lane
    assert bool(((index >= 0) & (index < n)).all())


def test_capacity_is_a_32nd_of_the_lanes_in_multiples_of_256():
    cap = port_integrator.compact_capacity
    assert cap(1920 * 1080) == 65_024 and cap(32 * 32) == 256 and cap(8192) == 256 and cap(8193) == 512
    assert all(cap(n) % 256 == 0 and cap(n) * 32 >= n for n in (1, 255, 257, 10_000, 518_400))


# ---- the render wavefront, both bodies against the full-width loop --------------

@pytest.mark.parametrize("body", ["compacted", "full-width"])
@pytest.mark.parametrize("name", list(SCENES))
def test_render_wavefront_equals_the_full_width_loop(monkeypatch, name, body):
    """Two subframes of each scene's render wavefront: with the live lanes
    compacted (the capacity the wavefront takes), and with a capacity under
    the count, where it falls back to every lane, against the loop without
    compaction (a capacity of every lane): equal bit for bit."""
    r = _renderer(name)
    n = r.cfg.num_pixels
    capacity = SCENES[name][2 if body == "compacted" else 3]
    for subframe in range(2):
        org, d, seeds = _render_rays(r, subframe)
        ref = _trace(r, org, d, seeds, n)
        reads = _fits_reads(monkeypatch)
        got = _trace(r, org, d, seeds, capacity)
        monkeypatch.undo()
        assert reads == [body == "compacted"], f"subframe {subframe}: the reads {reads}"
        _assert_same(got, ref, f"{name} subframe {subframe}")
        assert int(ref.bounce_count.max()) > 2  # paths go past the compaction


@pytest.fixture(scope="module")
def raster_rays():
    """``cornell_objects``' renderer, its render rays and their first hits
    from the primary raster, as ``frame_step`` takes them (the plain raster
    takes about 15 s here, so once for the module)."""
    r = _renderer("cornell_objects")
    r._bin_primaries()
    assert r._raster_frame
    org, d, seeds = _render_rays(r, 0)
    t0, prim0 = raster_closest_hit(r._raster_meta, r._raster_data, org, d)
    return r, org, d, seeds, hit_from_t_prim(org, d, r.device_scene.tris, t0, prim0)


@pytest.mark.parametrize("capacity", [64, 2], ids=["compacted", "full-width"])
def test_raster_first_hits_then_compaction(monkeypatch, raster_rays, capacity):
    """``cornell_objects``' render wavefront with depth 0 from the primary
    raster: both bodies equal the loop without compaction."""
    r, org, d, seeds, hit = raster_rays
    ref = _trace(r, org, d, seeds, r.cfg.num_pixels, primary_hit=hit)
    reads = _fits_reads(monkeypatch)
    got = _trace(r, org, d, seeds, capacity, primary_hit=hit)
    assert reads == [capacity == 64]
    _assert_same(got, ref, "raster")


@pytest.mark.parametrize("capacity,fits", [(64, True), (2, False)], ids=["compacted", "full-width"])
def test_a_band_compacts_its_own_lanes(monkeypatch, capacity, fits):
    """A band of 8 rows (256 lanes, ``compact_capacity`` 256: no compaction
    by itself; 4 live after bounce 1) with a capacity forced under it: both
    bodies equal the band's loop without compaction, and the band's rays are
    the frame's."""
    r = _renderer("cornell_box")
    rows, offset = 8, 8
    band = slice(offset * r.cfg.width, (offset + rows) * r.cfg.width)
    org, d, seeds = _render_rays(r, 1, rows, offset)
    frame_org, _, frame_seeds = _render_rays(r, 1)
    assert torch.equal(org, frame_org[band]) and torch.equal(seeds, frame_seeds[band])
    reads = _fits_reads(monkeypatch)
    plain = _trace(r, org, d, seeds)
    assert reads == []  # the band's capacity is all its lanes
    ref = _trace(r, org, d, seeds, org.shape[0])
    got = _trace(r, org, d, seeds, capacity)
    assert reads == [fits]
    _assert_same(plain, ref, "band, no compaction")
    _assert_same(got, ref, "band")


def test_training_and_no_cache_wavefronts_are_not_compacted(monkeypatch):
    """The training wavefront and NO_CACHE's render wavefront run every
    bounce on every lane: the compaction reads nothing there, whatever the
    capacity."""
    reads = _fits_reads(monkeypatch)
    r = _renderer("cornell_box", RenderMode.NO_CACHE, train=False)
    org, d, seeds = _render_rays(r, 0)
    _trace(r, org, d, seeds, 8)
    r = _renderer("cornell_box")
    t_org, t_dir, t_seeds, unbiased = training_rays(r.cfg, 0, r._camera_arrays(), 0.5, r.device)
    _trace(r, t_org, t_dir, t_seeds, 8, train=True, unbiased=unbiased)
    assert reads == []


# ---- a frame -----------------------------------------------------------------------

def test_frame_with_and_without_the_compaction(monkeypatch):
    """Two FULL + train frames of the box with the compaction on and off (a
    capacity of every lane): image, stats and the whole network state equal
    bit for bit."""
    sides = []
    for on in (True, False):
        with monkeypatch.context() as mp:
            reads = _fits_reads(mp)
            if not on:  # a capacity of every lane
                mp.setattr(port_integrator, "compact_capacity", lambda n: n)
            r = _renderer("cornell_box")
            stats = [[t.clone() for t in r.render_frame()] for _ in range(2)]
            r.flush_stats()
        assert reads == ([True, True] if on else [])
        sides.append((r, stats))
    (a, sa), (b, sb) = sides
    assert torch.equal(_bits(a.image), _bits(b.image))
    for x, y in zip(sa, sb):
        for u, v in zip(x, y):
            assert torch.equal(_bits(u), _bits(v))
    for (k, u), (_, v) in zip(sorted(N.state_to_numpy(a.net_state).items()),
                              sorted(N.state_to_numpy(b.net_state).items())):
        assert u.dtype == v.dtype and u.tobytes() == v.tobytes(), k
    assert int(sa[-1][1]) > 0
