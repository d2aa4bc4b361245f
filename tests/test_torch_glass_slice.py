"""Port parity for the glass slice: the transmission lobes, the IOR stack,
reflectance factoring, shadow-ray Russian roulette and the time view, on
the port's ``cornell_glass()`` at 32x32 against the JAX package.

Both sides use the same hit algorithm and log every closest-hit and shadow
ray, as ``test_torch_slice.py`` and ``test_torch_train_slice.py`` do (the
JAX frame patched to the TPU plane kernels under ``interpret=True``, the
HLO interpreter, which needs no child process; the port runs the plain
K1/K2). Rays whose hit or occlusion decision flipped between the sides are
left out of the per-ray comparisons; ``test_torch_slice.py`` says why a few
rays flip. A path through glass carries a direction's few-ulp difference
through every refraction, so a glass frame flips a few more rays than the
box's; the limits are the box frames' own (``test_torch_slice.LIMITS``,
``test_torch_train_slice.SLICE_LIMITS``) where the readings stay inside
them, and each bound that differs stands beside its reading.
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nrc_tpu.render.frame as jax_frame
import nrc_tpu.render.integrator as jax_integrator
import nrc_tpu_torch.render.frame as port_frame
import nrc_tpu_torch.render.integrator as port_integrator
from nrc_tpu.render.renderer import Renderer as JRenderer
from nrc_tpu.utils.tonemap import time_view_ramp as jax_time_view_ramp
from nrc_tpu_torch.config import RenderMode
from nrc_tpu_torch.models import network as N
from nrc_tpu_torch.ops.intersect import make_intersectors
from nrc_tpu_torch.render.renderer import Renderer
from nrc_tpu_torch.scene.scene_builder import cornell_glass, cornell_glass_declarations
from nrc_tpu_torch.utils.tonemap import time_view_ramp
from test_torch_intersect import one_torch_thread  # noqa: F401 (an autouse fixture)
from test_torch_scene import jax_cornell_scene
from test_torch_slice import (
    LIMITS,
    _LOG,
    _interpret_plane_intersectors,
    _recording_port_intersectors,
    frame_readings,
    recording_frames,
)
from test_torch_train_slice import (
    SLICE_LIMITS,
    _flipped,
    _port_assemble_with_jax_batches,
    _recording_jax_assemble,
    train_frame_readings,
)

RES = (32, 32)
TILE = (8, 8)
TAU = 0.5  # shadow-ray Russian roulette's threshold in these frames


def _glass(tiles=None):
    scene, system = cornell_glass(RES)
    if tiles:
        system = dataclasses.replace(system, tile_size=tiles)
    return scene, system, jax_cornell_scene(RES, cornell_glass_declarations)


def test_cornell_glass_uses_the_transmission_lobes():
    scene, _, jscene = _glass()
    arch = set(np.unique(scene.materials.archetype[scene.material_id]).tolist())
    assert arch == {0, 3, 6, 7, 8} and scene.num_triangles == 1256 < 16384
    assert scene.materials.thin_walled[scene.material_id].any()
    assert np.array_equal(scene.p0, jscene.p0) and np.array_equal(scene.materials.archetype,
                                                                  jscene.materials.archetype)


def test_time_view_ramp_matches_jax():
    """The ramp's five stops and the segments between them, out-of-range
    values clamped: bit for bit."""
    x = np.concatenate([np.linspace(-0.5, 1.5, 4001, dtype=np.float32),
                        np.asarray([0.0, 0.25, 0.5, 0.75, 1.0], np.float32)])
    got = time_view_ramp(torch.from_numpy(x)).numpy()
    ref = np.asarray(jax_time_view_ramp(jnp.asarray(x)))
    assert got.shape == (x.size, 3) and np.array_equal(got, ref)


@pytest.fixture(scope="module")
def serving():
    """JAX and port renderers on cornell_glass per mode, same weights."""
    with recording_frames(_interpret_plane_intersectors):
        scene, system, jscene = _glass()
        pairs = {}
        for mode in (RenderMode.FULL, RenderMode.NO_CACHE):
            jr = JRenderer(jscene, system, render_mode=mode, train=False)
            pr = Renderer(scene, system, render_mode=mode, train=False, device="cpu")
            pr.net_state = N.state_from_numpy(jax.tree.map(np.asarray, jr.net_state))
            pairs[mode] = (jr, pr)
        yield pairs


@pytest.mark.parametrize("subframe", [0, 1])
@pytest.mark.parametrize("mode", [RenderMode.FULL, RenderMode.NO_CACHE], ids=lambda m: m.name)
def test_glass_frame_matches_jax(serving, mode, subframe):
    """FULL and NO_CACHE glass frames ray by ray, under the box frames' limits."""
    got = frame_readings(serving, mode, subframe)
    over = {k: (v, LIMITS[k]) for k, v in got.items() if not v <= LIMITS[k]}
    assert not over, f"readings over their limits: {over}"


def test_time_view_frame_matches_jax(serving):
    """Two DEBUG_TIME_VIEW frames (the running maximum of the ramp of each
    pixel's surface hits) on every pixel whose rays did not flip: within
    1e-6, a rounding of hits / max_depth (XLA:CPU multiplies by the
    constant's reciprocal, 5 x (1/6) is 0.83333337 where 5 / 6 is
    0.8333333; the ramp itself is bit for bit, above)."""
    jr, pr = serving[RenderMode.NO_CACHE]
    for r in (jr, pr):
        r.set_render_mode(RenderMode.DEBUG_TIME_VIEW)
    try:
        kept = np.ones(RES[0] * RES[1], bool)
        for _ in range(2):
            _LOG["jax"].clear()
            _LOG["port"].clear()
            jr.render_frame()
            jax.effects_barrier()
            pr.render_frame()
            kept &= ~_flipped(_LOG["jax"], _LOG["port"], RES[0] * RES[1])
        ref, out = np.asarray(jr.image), pr.image.numpy()
        assert kept.mean() > 0.98 and np.abs(out[kept] - ref[kept]).max() <= 1e-6
        assert out.max() <= 1.0 and len(np.unique(out, axis=0)) > 3
    finally:
        for r in (jr, pr):
            r.set_render_mode(RenderMode.NO_CACHE)


@contextlib.contextmanager
def glass_training_pair(tau):
    """A JAX and a port FULL + train renderer on cornell_glass with
    reflectance factoring and shadow-ray Russian roulette at ``tau``, the
    same weights; the port trains on the JAX frame's batches."""
    prev = jax.config.jax_enable_compilation_cache
    jax.config.update("jax_enable_compilation_cache", False)  # see test_torch_mlp.py
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax_integrator, "make_intersectors", _interpret_plane_intersectors)
            # the package's own intersectors: the module's serving fixture
            # may hold a recording wrapper of them already
            mp.setattr(port_integrator, "make_intersectors", _recording_port_intersectors(make_intersectors))
            mp.setattr(jax_frame, "assemble_training_batches",
                       _recording_jax_assemble(jax_frame.assemble_training_batches))
            mp.setattr(port_frame, "assemble_training_batches",
                       _port_assemble_with_jax_batches(port_frame.assemble_training_batches))
            scene, system, jscene = _glass(TILE)
            jr = JRenderer(jscene, system, render_mode=RenderMode.FULL, train=True, adaptive_tiles=False,
                           reflectance_factoring=True)
            pr = Renderer(scene, system, render_mode=RenderMode.FULL, adaptive_tiles=False, device="cpu",
                          reflectance_factoring=True)
            for r in (jr, pr):
                r.cfg = dataclasses.replace(r.cfg, nee_rr_tau=tau)
            pr.net_state = N.state_from_numpy(jax.tree.map(np.asarray, jr.net_state))
            yield jr, pr
    finally:
        jax.config.update("jax_enable_compilation_cache", prev)


# Shadow-ray Russian roulette scales a surviving sample by 1 / p, up to 20:
# the targets of a glass frame with it spread wider, and the loss of four
# steps reads the two sides' gradient rounding more (JAX rounds each weight
# gradient to bf16, test_torch_train.py). Largest loss reading over three
# frames 5.9e-3 with tau = 0.5 (frame 0; 1.7e-3 and 2.1e-5 after), 9.2e-4
# with factoring alone; every other reading within the box's limits.
GLASS_LIMITS = dict(SLICE_LIMITS, loss_rel=2e-2)


def _cast_mismatches(n):
    """Lanes of the n-ray wavefront, flipped ones aside, where one side cast
    a shadow ray and the other did not (the roulette's decisions differ)."""
    calls = [[c for c in _LOG[side] if c[0] == "shadow" and c[1][0].shape[0] == n] for side in ("jax", "port")]
    keep = ~_flipped(_LOG["jax"], _LOG["port"], n)
    return sum(int((((j[0] > 0) != (p[0] > 0)) & keep).sum()) for (_, j), (_, p) in zip(*calls))


def test_glass_training_frames_match_jax():
    """Three FULL + train glass frames with reflectance factoring and
    shadow-ray Russian roulette, each from the JAX state, the port on the
    JAX frame's batches: the same shadow rays cast on both sides, and the
    readings under ``GLASS_LIMITS``."""
    with glass_training_pair(TAU) as (jr, pr):
        assert jr.cfg.archetype_set == pr.cfg.archetype_set
        for subframe in range(3):
            got = train_frame_readings(jr, pr, subframe)
            assert _cast_mismatches(RES[0] * RES[1]) == 0
            over = {k: (v, GLASS_LIMITS[k]) for k, v in got.items() if not v <= GLASS_LIMITS[k]}
            assert not over, f"frame {subframe}: readings over their limits: {over}"


def test_factoring_scales_the_cache_and_divides_the_targets():
    """With factoring, the suffix ends' cache radiance that propagation
    starts from is the network's output times the end query's reflectance,
    and the batches are drawn from the propagated targets over their
    records' reflectance + 1e-6, bit for bit."""
    scene, system, _ = _glass(TILE)
    seen = {}

    def keep(name, fn):
        def wrapped(*args):
            out = fn(*args)
            seen[name] = ([a.clone() if isinstance(a, torch.Tensor) else a for a in args], out)
            return out
        return wrapped

    with pytest.MonkeyPatch.context() as mp:
        for mod, name in ((port_frame.N, "infer"), (port_frame, "propagate_radiance"),
                          (port_frame, "assemble_training_batches")):
            mp.setattr(mod, name, keep(name, getattr(mod, name)))
        r = Renderer(scene, system, adaptive_tiles=False, device="cpu", reflectance_factoring=True)
        r.render_frame()
    (_, all_q, _), cache = seen["infer"]
    (_, _, _, end_radiance, _), targets = seen["propagate_radiance"]
    (_, rec_query, batch_targets, _), _ = seen["assemble_training_batches"]
    n_pix, n_tiles = r.cfg.num_pixels, r.cfg.num_tiles
    ends = slice(n_pix, n_pix + n_tiles)
    assert torch.equal(end_radiance, cache[ends] * port_frame.query_reflectance(all_q[ends]))
    assert torch.equal(batch_targets, targets / (port_frame.query_reflectance(rec_query) + 1e-6))
    assert (port_frame.query_reflectance(all_q) != 1.0).any()


def test_shadow_roulette_keeps_the_main_stream():
    """The roulette's uniform comes from a side stream: with tau > 0 every
    output of the main path (queries, throughputs, hits, records, their
    local throughputs, the suffix ends) is the same bits as with tau = 0,
    on both wavefronts; only the radiance and the record targets move, and
    fewer shadow rays are traced."""
    scene, system, _ = _glass(TILE)
    r = Renderer(scene, system, adaptive_tiles=False, device="cpu")
    cam = r._camera_arrays()
    cfg0 = r.cfg
    pix, pidx = port_frame.pixel_grid(cfg0, r.device)
    from nrc_tpu_torch.scene.camera import generate_primary_rays
    from nrc_tpu_torch.utils import rng as R

    seeds, jitter = R.rng2(R.tea(pidx, 3))
    org, d = generate_primary_rays(pix, jitter, (cfg0.width, cfg0.height), *cam)
    t_org, t_dir, t_seeds, unbiased = port_frame.training_rays(cfg0, 3, cam, 0.5, r.device)
    main = ("bounce_count", "render_query", "last_render_throughput", "cache_vis_query",
            "rec_query", "rec_ltp", "rec_count", "end_query", "end_mask")
    for train, args in ((False, (org, d, seeds)), (True, (t_org, t_dir, t_seeds))):
        kw = dict(train=True, unbiased=unbiased) if train else {}
        outs = [port_integrator.trace_wavefront(r.device_scene, *args, dataclasses.replace(cfg0, nee_rr_tau=tau),
                                                **kw) for tau in (0.0, TAU)]
        for k in main:
            a, b = getattr(outs[0], k), getattr(outs[1], k)
            assert (a is None and b is None) or torch.equal(a, b), (train, k)
        assert int(outs[1].traced_count.sum()) < int(outs[0].traced_count.sum())
        moved = outs[1].rec_target if train else outs[1].radiance
        assert not torch.equal(moved, outs[0].rec_target if train else outs[0].radiance)
