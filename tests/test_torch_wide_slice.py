"""Port parity for the large-scene slice: whole frames through the wide BVH.

The 32x32 Cornell frames of ``test_torch_slice.py`` and
``test_torch_train_slice.py`` once more, with the 16-wide BVH attached to
the device scene on both sides, so that every closest-hit and shadow ray of
both packages walks the same (bit-identical) row table. The JAX package
takes its walk only above ``BVH_THRESHOLD`` triangles, so the test sets that
module global to 0 before the first frame is traced (nothing in the package
is edited) and counts the calls of ``intersect_wbvh`` to make sure the JAX
frame really walked. The primary raster and the compact-once layout stay
off at this size (1224 triangles, 1024 lanes), as the port has neither.

Bounds. The readings are those of ``test_torch_slice.py`` (``LIMITS``) and
``test_torch_train_slice.py`` (``SLICE_LIMITS``), and they are held to the
same bounds, whose reasons those files give. Möller-Trumbore in the walk
reads no worse than the plane form of the brute force: over the six serving
frames the first hit's t differs by at most 4 ulp (bound 4; XLA contracts
the cross products' multiply-adds into FMAs, PyTorch does not), the first
triangles are equal, at most 6 of 1024 rays flip a hit or an occlusion
(0.0059; bound 0.02), radiance and throughput of the others agree to 1.9e-5
(bound 2e-4); the two training frames read 0.0029 flipped rays, the loss
1.5e-3 apart (bound 5e-3) and the EMA weights 1.2e-3 (bound 5e-3).

The port's BVH frame is also held against its own brute-force frame: the
same paths but for the rays whose hit or occlusion flips on the last bits
of t (plane form against Möller-Trumbore).
"""

import jax.numpy as jnp
import numpy as np
import pytest

import nrc_tpu.ops.intersect as jax_intersect
import nrc_tpu.ops.intersect_wide as jax_intersect_wide
from nrc_tpu.ops.bvh_wide import build_wide_bvh as jax_build_wide_bvh
from nrc_tpu_torch.config import RenderMode
from nrc_tpu_torch.render.renderer import Renderer
from nrc_tpu_torch.render.scene_device import upload_scene
from nrc_tpu_torch.scene.scene_builder import cornell_box
from test_torch_bvh import align_builders
from test_torch_intersect import one_torch_thread  # noqa: F401 (an autouse fixture)
from test_torch_scene import jax_cornell_scene
from test_torch_slice import LIMITS, RES, _logging_jax_intersectors, _pair, frame_readings, recording_frames
from test_torch_train_slice import SLICE_LIMITS, train_frame_readings, training_pair

_WALKS = {"closest": 0}
_WALKED = set()  # the configurations whose JAX frame traced the wide walk


def _walking_jax_intersectors(tris, bvh=None):
    """The JAX package's own dispatcher, which must choose the wide walk,
    with its decisions logged."""
    assert bvh is not None and "rows" in bvh
    return _logging_jax_intersectors(*jax_intersect.make_intersectors(tris, bvh))


def _counting(fn):
    def wrapped(*args, **kwargs):
        _WALKS["closest"] += 1  # counts traces: the frame is jitted
        return fn(*args, **kwargs)
    return wrapped


def _attach_bvh(jr, pr):
    """The 16-wide BVH on both sides (``tests/test_parallel.py:258-264``)."""
    scene = jr.scene
    wide = jax_build_wide_bvh(scene.p0, scene.p1, scene.p2, branch=16, leaf_size=16)
    jr.device_scene = jr.device_scene._replace(bvh={k: jnp.asarray(v) for k, v in wide.items()})
    pr.device_scene = upload_scene(pr.scene, "cpu", use_bvh=True)
    assert pr.device_scene.planes is None
    # the two builds are the same table, bit for bit
    assert np.array_equal(pr.device_scene.bvh.rows.numpy().view(np.int32), wide["rows"].view(np.int32))


@pytest.fixture(scope="module")
def walking():
    """The JAX dispatcher walks any scene with a BVH, and its walks are counted."""
    with pytest.MonkeyPatch.context() as mp:
        align_builders(mp)
        mp.setattr(jax_intersect, "BVH_THRESHOLD", 0)
        mp.setattr(jax_intersect_wide, "intersect_wbvh", _counting(jax_intersect_wide.intersect_wbvh))
        yield


class TestServingFrames:
    """FULL and NO_CACHE, ``train=False`` (class-scoped fixtures: the
    recording patches of the two classes must not be active together)."""

    @pytest.fixture(scope="class")
    def pairs(self, walking):
        with recording_frames(_walking_jax_intersectors):
            scene, system = cornell_box(RES)
            setup = (scene, system, jax_cornell_scene(RES))
            yield {mode: _pair(setup, mode, attach=_attach_bvh)
                   for mode in (RenderMode.FULL, RenderMode.NO_CACHE)}

    @pytest.mark.parametrize("subframe", [0, 1, 2])
    @pytest.mark.parametrize("mode", [RenderMode.FULL, RenderMode.NO_CACHE], ids=lambda m: m.name)
    def test_bvh_frame_matches_jax(self, pairs, mode, subframe):
        walks = _WALKS["closest"]
        got = frame_readings(pairs, mode, subframe)
        if _WALKS["closest"] > walks:  # the frame is traced once per renderer
            _WALKED.add(mode)
        assert mode in _WALKED, "the JAX frame did not take the wide walk"
        over = {k: (v, LIMITS[k]) for k, v in got.items() if not v <= LIMITS[k]}
        assert not over, f"readings over their limits: {over}"


class TestTrainingFrames:
    @pytest.fixture(scope="class")
    def train_pair(self, walking):
        with training_pair(_walking_jax_intersectors, attach=_attach_bvh) as pair:
            yield pair

    def test_bvh_full_train_frames_match_jax(self, train_pair):
        jr, pr = train_pair
        walks = _WALKS["closest"]
        for subframe in range(2):
            got = train_frame_readings(jr, pr, subframe)
            over = {k: (v, SLICE_LIMITS[k]) for k, v in got.items() if not v <= SLICE_LIMITS[k]}
            assert not over, f"frame {subframe}: readings over their limits: {over}"
        assert _WALKS["closest"] >= walks + 2, "the JAX frame did not take the wide walk in both wavefronts"


@pytest.mark.parametrize("mode,train", [(RenderMode.NO_CACHE, False), (RenderMode.FULL, True)],
                         ids=["NO_CACHE", "FULL+train"])
def test_bvh_frame_matches_own_brute_force(mode, train):
    """The same frame by the walk (Möller-Trumbore) and by brute force (plane
    form): t differs in its last bits, so a few rays flip a hit or an
    occlusion and move their pixel; the others agree to 1e-3 relative
    (16 of 1024 pixels differ at most in the frames seen; bound 3 %), and
    the image means to 1 %."""
    scene, system = cornell_box(RES)
    brute = Renderer(scene, system, render_mode=mode, train=train, device="cpu")
    walk = Renderer(scene, system, render_mode=mode, train=train, device="cpu")
    walk.device_scene = upload_scene(scene, "cpu", use_bvh=True)
    sb, sw = brute.render(1), walk.render(1)
    a, b = walk.image.numpy(), brute.image.numpy()
    rel = (np.abs(a - b) / np.maximum(np.abs(b), 1e-3)).max(axis=-1)
    assert (rel > 1e-3).mean() <= 0.03, (rel > 1e-3).mean()
    assert abs(a.mean() / b.mean() - 1.0) < 1e-2
    assert abs(int(sw.traced_rays) - int(sb.traced_rays)) <= 0.01 * int(sb.traced_rays)
    if train:
        assert abs(int(sw.num_train_records) - int(sb.num_train_records)) <= 8
