"""Port parity for the whole serving slice: one Cornell frame, render + infer.

JAX ``Renderer.render_frame`` (``train=False``) and the port's, at 32x32 on
the port's ``cornell_box()``, with the same weights (``state_from_numpy``),
for subframes 0, 1 and 2 in FULL and NO_CACHE. Both sides use the same hit
algorithm: the test patches ``nrc_tpu.render.integrator.make_intersectors``
to return the TPU plane kernels in interpret mode (a patch in the test, not
in the package); the port runs the plain versions of K1/K2.

Tolerance, and its witness. Both sides' intersectors, wavefront outputs and
cache inference are wrapped, so the test sees every closest-hit and shadow
ray of the frame and the per-ray terms of the image.

- The RNG streams are bit-identical. The first quantities to differ are the
  primary directions and the first hit distances, by at most 3 float32 ulp:
  XLA and PyTorch round the same expressions differently. XLA:CPU contracts
  multiply-adds into FMAs, but that is not the whole cause: with XLA held to
  AVX (``--xla_cpu_max_isa=AVX``, no FMA instructions) 4 to 14 of 1024
  pixels still differ, against 3 to 19 with FMAs.
- A hit point p = o + t d lies ~35 units from the camera, so its distance
  from its own triangle's plane is known only to a few 1e-6. A shadow ray
  clears that plane by scene_epsilon * cos = 5e-5 * cos at its tmin, so for
  a grazing ray (cos below ~0.1) the two sides can disagree on whether it
  hits its own triangle. That flip, and the rarer flip of a continuation
  ray's closest triangle or of a shadow ray at a seam, moves the pixel by up
  to its whole direct light. Over these six frames 2 to 11 of 1024 rays flip
  a decision; every other ray's path radiance agrees to 4e-5 relative.
- FULL adds the cache term lrt * cache. The queries of rays without a flip
  differ by at most 1.9e-6, and the MLP rounds its inputs and activations to
  bf16, so such a difference can move the cache by up to 0.009. Given the
  same query, the port's cache agrees with JAX's to 0.15 of K3's own
  tolerance (atol + rtol 1e-2, ``test_torch_mlp.py``).

``LIMITS`` gives each reading's bound next to its largest reading over the
six frames. The bounds also fail a broken port: shadow rays without the
scene epsilon (13% of rays flip), NEE or emission without MIS, the area
spread 10% wider, the query position 1% off, and light samples not uniform
over the triangle each exceed at least one bound by 5x or more.
"""

import contextlib
import dataclasses

import jax
import numpy as np
import pytest
import torch

import nrc_tpu.models.network as jax_network
import nrc_tpu.render.frame as jax_frame
import nrc_tpu.render.integrator as jax_integrator
import nrc_tpu_torch.models.network as port_network
import nrc_tpu_torch.ops.texture as port_texture
import nrc_tpu_torch.render.frame as port_frame
import nrc_tpu_torch.render.integrator as port_integrator
from nrc_tpu.ops import intersect_pallas as JP
from nrc_tpu.render.renderer import Renderer as JRenderer
from nrc_tpu_torch.config import RenderMode
from nrc_tpu_torch.models.network import state_from_numpy
from nrc_tpu_torch.ops.noise import bump_fields, noise_bump_normal
from nrc_tpu_torch.render.renderer import Renderer
from nrc_tpu_torch.scene.scene_builder import cornell_box
from test_torch_compact import checked_at_full_width
from test_torch_intersect import one_torch_thread  # noqa: F401 (an autouse fixture)
from test_torch_scene import jax_cornell_scene

RES = (32, 32)
# what each side's intersectors, wavefront and cache gave during the last frame
_LOG = {"jax": [], "port": [], "jax_out": {}, "port_out": {}}


def _jax_log(tag):
    def cb(*arrays):
        _LOG["jax"].append((tag, [np.asarray(a) for a in arrays]))
    return cb


def _jax_keep(key):
    def cb(*arrays):
        _LOG["jax_out"][key] = [np.asarray(a) for a in arrays]
    return cb


def _recording_jax_wavefront(fn):
    def wrapped(*args, **kwargs):
        out = fn(*args, **kwargs)
        jax.debug.callback(_jax_keep("wavefront"), out.radiance, out.last_render_throughput,
                           out.render_query, ordered=True)
        return out
    return wrapped


def _recording_jax_infer(fn):
    def wrapped(*args):
        out = fn(*args)
        jax.debug.callback(_jax_keep("cache"), out, ordered=True)
        return out
    return wrapped


def _logging_jax_intersectors(closest, occluded):
    """Log every closest-hit and shadow ray of the JAX frame."""
    def closest_rec(o, d, tn, tf):
        hit = closest(o, d, tn, tf)
        jax.debug.callback(_jax_log("closest"), tf, d, hit.t, hit.prim, ordered=True)
        return hit

    def occluded_rec(o, d, tn, tf):
        occ = occluded(o, d, tn, tf)
        jax.debug.callback(_jax_log("shadow"), tf, occ, ordered=True)
        return occ

    return closest_rec, occluded_rec


def _interpret_plane_intersectors(tris, bvh=None):
    planes = JP.build_plane_table(tris)
    return _logging_jax_intersectors(
        lambda o, d, tn, tf: JP.intersect_planes(o, d, planes, tris, tn, tf, interpret=True),
        lambda o, d, tn, tf: JP.occluded_planes(o, d, planes, tn, tf, interpret=True),
    )


def _recording_port_intersectors(make):
    def make_recording(tris, planes, bvh=None):
        closest, occluded = make(tris, planes, bvh)

        def closest_rec(o, d, tn, tf):
            hit = closest(o, d, tn, tf)
            _LOG["port"].append(("closest", [x.numpy().copy() for x in (tf, d, hit.t, hit.prim)]))
            return hit

        def occluded_rec(o, d, tn, tf):
            occ = occluded(o, d, tn, tf)
            _LOG["port"].append(("shadow", [x.numpy().copy() for x in (tf, occ)]))
            return occ

        return closest_rec, occluded_rec

    return make_recording


def _recording(fn, key):
    def wrapped(*args, **kwargs):
        out = fn(*args, **kwargs)
        _LOG["port_out"][key] = out
        return out
    return wrapped


@contextlib.contextmanager
def recording_frames(jax_make_intersectors):
    """Both packages' frames with their intersectors, wavefront outputs and
    cache inference recorded; the JAX frame takes ``jax_make_intersectors``."""
    prev = jax.config.jax_enable_compilation_cache
    jax.config.update("jax_enable_compilation_cache", False)  # see test_torch_mlp.py
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax_integrator, "make_intersectors", jax_make_intersectors)
            mp.setattr(jax_frame, "trace_wavefront_chunked",
                       _recording_jax_wavefront(jax_frame.trace_wavefront_chunked))
            mp.setattr(jax_network, "infer", _recording_jax_infer(jax_network.infer))
            mp.setattr(port_integrator, "make_intersectors",
                       _recording_port_intersectors(port_integrator.make_intersectors))
            mp.setattr(port_frame, "trace_wavefront",
                       _recording(checked_at_full_width(port_frame.trace_wavefront, _LOG["port"]), "wavefront"))
            mp.setattr(port_network, "infer", _recording(port_network.infer, "cache"))
            yield mp
    finally:
        jax.config.update("jax_enable_compilation_cache", prev)


@pytest.fixture(scope="module")
def setup():
    with recording_frames(_interpret_plane_intersectors):
        scene, system = cornell_box(RES)
        yield scene, system, jax_cornell_scene(RES)


def _pair(setup, mode, attach=None):
    """One JAX and one port renderer with the same weights; ``attach(jr, pr)``
    may replace their device scenes before the first frame."""
    scene, system, jscene = setup
    jr = JRenderer(jscene, system, render_mode=mode, train=False)
    pr = Renderer(scene, system, render_mode=mode, train=False, device="cpu")
    pr.net_state = state_from_numpy(jax.tree.map(np.asarray, jr.net_state))
    if attach is not None:
        attach(jr, pr)
    return jr, pr


@pytest.fixture(scope="module")
def pairs(setup):
    """One renderer pair per mode: the JAX frame compiles once per mode."""
    return {mode: _pair(setup, mode) for mode in (RenderMode.FULL, RenderMode.NO_CACHE)}


def _ulps(a, b):
    ia = a.astype(np.float32).view(np.int32).astype(np.int64)
    ib = b.astype(np.float32).view(np.int32).astype(np.int64)
    return np.abs(ia - ib)


# the port's bilinear fetch at the JAX uv against the JAX value, where a
# texture lookup moved: float32 rounding of the same sums (reads 6e-8)
SAMPLER_ATOL = 1e-6


def _texture_moved(j, p):
    """The rays whose texture lookup the two sides' uv moved apart by more
    than the query bound, or that looked up different textures (a ray whose
    hit flipped to another material). j = (tex ids, uv, rgba) of the JAX
    lookup, p the port's and its atlas; where the texture is the same, the
    port's sampler at the JAX uv must give the JAX value within
    ``SAMPLER_ATOL``."""
    (tex_j, uv_j, rgba_j), (tex_p, _, rgba_p, atlas) = j, p
    same = tex_j == tex_p
    moved = same & (np.abs(rgba_j - rgba_p).max(axis=-1) > LIMITS["query_abs"])
    at_jax_uv = port_texture.sample_bilinear(atlas, torch.tensor(tex_j, dtype=torch.int64),
                                             torch.tensor(uv_j)).numpy()
    off = np.abs(at_jax_uv - rgba_j)[moved].max(initial=0.0)
    assert off <= SAMPLER_ATOL, f"the port's sampler at the JAX uv is {off} off the JAX value"
    return moved | ~same


# the port's noise bump at the JAX inputs against the JAX frame's normal:
# reads 1.3e-5 (cornell_materials, subframe 0), where the port equals the
# JAX function called alone on those inputs to 9e-7; the JAX frame's fused
# program rounds the field otherwise, and the bump's forward differences
# (step 0.01) scale a field's ulp by 50
BUMP_ATOL = 2e-5


def _bump_moved(j, p):
    """The rays whose bumped shading normal (``noise_bump_normal``) the two
    sides' hit points moved apart by more than the query bound, among the
    rays that hit on both sides. j = (hit, the JAX call's inputs, normal),
    p = (hit, normal); the port's bump at the JAX inputs must give the JAX
    normal within ``BUMP_ATOL``, so that the move is the hit point's and
    not the function's. Near a Worley cell border the field's gradient
    jumps, and the forward differences (step 0.01) turn a hit point's
    1e-5 into a normal's 1e-4."""
    (hit_j, *args, out_j), (hit_p, out_p) = j, p
    moved = hit_j & hit_p & (np.abs(out_j - out_p).max(axis=-1) > LIMITS["query_abs"])
    levels = args.pop(4)  # (mode, pos, ns, scale, levels, absolute, thresholds, marble, factor)
    mode, pos, ns, scale, *field, factor = (torch.tensor(a) for a in args)
    at_jax = noise_bump_normal(ns, scale, factor, bump_fields(mode, pos, scale, levels, *field)).numpy()
    off = np.abs(at_jax - out_j)[moved].max(initial=0.0)
    assert off <= BUMP_ATOL, f"the port's bump at the JAX inputs is {off} off the JAX normal"
    return moved


# the decisions other than a hit's, by the tag of the logged call; a test
# of another slice adds its own (test_torch_hair_slice.py)
MOVED = {"tex": lambda j, p: _texture_moved(j, p), "bump": lambda j, p: _bump_moved(j, p)}


def ray_flips(tag, j, p):
    """The rays that one logged call of the JAX side (j) and the port (p)
    flips: a closest-hit or shadow ray that both sides cast but that found
    another triangle or occlusion (closest: tmax, direction, t, prim;
    shadow: tmax, occluded), an escaping ray's env texel read apart (env:
    missed, pdf), a texture lookup moved apart (tex: ``_texture_moved``) or
    a noise bump moved apart (bump: ``_bump_moved``), or what a handler of
    ``MOVED`` finds for its tag. A ray that one side cast and the other did
    not is no flip: the decision to cast it must agree."""
    if tag in MOVED:
        return MOVED[tag](j, p)
    return (j[0] > 0.0) & (p[0] > 0.0) & (j[-1] != p[-1])


def _flipped_rays(jax_calls, port_calls):
    """The rays of a frame that any logged call flips (``ray_flips``)."""
    tags = ([tag for tag, _ in jax_calls], [tag for tag, _ in port_calls])
    assert tags[0] == tags[1], f"the two sides traced different bounces: {tags}"
    flipped = np.zeros(RES[0] * RES[1], bool)
    for (tag, j), (_, p) in zip(jax_calls, port_calls):
        flipped |= ray_flips(tag, j, p)
    return flipped


def _rel(a, b):
    return (np.abs(a - b) / np.maximum(np.abs(b), 1e-3)).max(axis=-1)


def query_gap(a, b):
    """Entrywise gap between two sets of queries; a test of another slice
    may read the directions otherwise (``QUERY_GAP``)."""
    return np.abs(a - b)


QUERY_GAP = query_gap


# Each reading's limit, after the largest reading over the six frames.
LIMITS = {
    "first_dir_ulp": 4,          # 3
    "first_t_ulp": 4,            # 3
    "flipped_share": 0.02,       # 0.0107 (11 of 1024 rays)
    "radiance_rel": 2e-4,        # 3.98e-05, rays without a flip
    "throughput_rel": 2e-4,      # 1.38e-05, rays without a flip
    "query_abs": 2e-5,           # 1.91e-06
    "cache_same_query_k3": 1.0,  # 0.154 of K3's atol + rtol 1e-2, the JAX query on both
    "cache_abs": 2e-2,           # 0.00901, each side's own query
    "mean_kept_rel": 1e-4,       # 7.99e-06
    "mean_rel": 2e-3,            # 4.58e-04
    "traced_rel": 0.01,          # 0.0015
}


def frame_readings(pairs, mode, subframe) -> dict:
    """Render one frame on both sides and measure how far they are apart."""
    jr, pr = pairs[mode]
    for r in (jr, pr):
        r.restart_accumulation()
        r.total_subframe = subframe
    _LOG["jax"].clear()
    _LOG["port"].clear()
    jstats = jr.render_frame()
    pstats = pr.render_frame()
    ref = np.asarray(jr.image)
    jax.effects_barrier()
    out = pr.image.numpy()
    assert out.shape == ref.shape == (RES[0] * RES[1], 3)
    assert np.isfinite(out).all() and out.std() > 0.0
    assert np.array_equal(pr.image_hdr(), out.reshape(RES[1], RES[0], 3)[::-1])

    (_, j0), (_, p0) = _LOG["jax"][0], _LOG["port"][0]
    hit = j0[3] >= 0
    assert hit.any() and np.array_equal(j0[3], p0[3])  # same first triangles
    kept = ~_flipped_rays(_LOG["jax"], _LOG["port"])
    rad_j, lrt_j, query_j = _LOG["jax_out"]["wavefront"]
    port_wave = _LOG["port_out"]["wavefront"]
    rad_p = port_wave.radiance.numpy()
    lrt_p = port_wave.last_render_throughput.numpy()
    traced_ref, traced_out = int(jstats.traced_rays), int(pstats.traced_rays)
    assert traced_ref > RES[0] * RES[1]
    got = {
        "first_dir_ulp": _ulps(j0[1], p0[1]).max(),
        "first_t_ulp": _ulps(j0[2][hit], p0[2][hit]).max(),
        "flipped_share": 1.0 - kept.mean(),
        "radiance_rel": _rel(rad_p, rad_j)[kept].max(),
        "throughput_rel": _rel(lrt_p, lrt_j)[kept].max(),
        "mean_kept_rel": abs(out[kept].mean() / ref[kept].mean() - 1.0),
        "mean_rel": abs(out.mean() / ref.mean() - 1.0),
        "traced_rel": abs(traced_out - traced_ref) / traced_ref,
    }
    if mode == RenderMode.FULL:
        cache_j = _LOG["jax_out"]["cache"][0]
        cache_p = _LOG["port_out"]["cache"].numpy()
        used = kept & (lrt_j.max(axis=-1) > 0.0)
        same = port_network.infer(pr.net_state, torch.tensor(query_j), pr.net_cfg).numpy()
        query_p = port_wave.render_query.numpy()
        got["query_abs"] = QUERY_GAP(query_p, query_j)[used].max()
        got["cache_same_query_k3"] = (np.abs(same - cache_j) / (1e-2 + 1e-2 * np.abs(cache_j)))[used].max()
        got["cache_abs"] = np.abs(cache_p - cache_j)[used].max()
        assert np.array_equal(out, rad_p + lrt_p * cache_p)
    else:
        assert np.array_equal(out, rad_p)
    return got


@pytest.mark.parametrize("subframe", [0, 1, 2])
@pytest.mark.parametrize("mode", [RenderMode.FULL, RenderMode.NO_CACHE], ids=lambda m: m.name)
def test_frame_matches_jax(pairs, mode, subframe):
    got = frame_readings(pairs, mode, subframe)
    over = {k: (v, LIMITS[k]) for k, v in got.items() if not v <= LIMITS[k]}
    assert not over, f"readings over their limits: {over}"


@pytest.mark.parametrize(
    "mode",
    [RenderMode.CACHE_ONLY, RenderMode.CACHE_FIRST_VERTEX,
     RenderMode.DEBUG_CACHE_NO_THROUGHPUT_MODULATION, RenderMode.DEBUG_THROUGHPUT_ONLY],
    ids=lambda m: m.name,
)
def test_other_modes_render(setup, mode):
    scene, system, _ = setup
    r = Renderer(scene, system, render_mode=mode, device="cpu")
    r.render(1)
    img = r.image_hdr()
    assert img.shape == (RES[1], RES[0], 3)
    assert np.isfinite(img).all() and img.std() > 0.0 and img.min() >= 0.0


def test_accumulation_and_benchmark(setup):
    scene, system, _ = setup
    r = Renderer(scene, system, render_mode=RenderMode.NO_CACHE, device="cpu")
    one = r.render(1)
    first = r.image.clone()
    r.render(1)
    # incremental mean: frame 2 has weight 1/2
    assert not torch.equal(first, r.image) and r.iteration == 2
    res = r.benchmark(2)
    assert res["spp"] == 2 and res["mrays_per_s"] > 0 and res["traced_rays_per_frame"] > 0
    assert r.iteration == 2 and r.total_subframe == 5
    assert int(one.traced_rays) > 0


def test_unported_paths_raise(setup):
    """What the port refuses at the upload: an archetype it has no BSDF for,
    on either lobe. Curves and the hair archetype, refused before, are
    ported (``test_torch_hair_slice.py``): a hair material on a triangle
    absorbs, as in the JAX package, and renders; so are volumes and
    layered, measured and noise materials (``test_torch_materials_slice.py``),
    textures, cutouts and environment lights (``test_torch_lights_slice.py``),
    DEBUG_TIME_VIEW and shadow-ray Russian roulette
    (``test_torch_glass_slice.py``)."""
    scene, system, _ = setup
    unknown = dataclasses.replace(scene)
    unknown.materials = dataclasses.replace(scene.materials, archetype2=np.full_like(scene.materials.archetype2, 42))
    with pytest.raises(NotImplementedError, match=r"archetypes \[42\]"):
        Renderer(unknown, system, device="cpu")
    hair = dataclasses.replace(scene)
    hair.materials = dataclasses.replace(scene.materials, archetype=np.full_like(scene.materials.archetype, 9))
    r = Renderer(hair, system, render_mode=RenderMode.NO_CACHE, train=False, device="cpu")
    r.render(1)
    assert r.device_scene.curves is None and np.isfinite(r.image.numpy()).all()
