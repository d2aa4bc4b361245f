"""Port parity for the training half of a frame: the training rays, the
training wavefront ray by ray, and three FULL + train frames of the renderer,
against the JAX package on the port's ``cornell_box()`` at 32x32 with 8x8
tiles (16 training rays per frame).

Both sides use the same hit algorithm: the test patches
``nrc_tpu.render.integrator.make_intersectors`` to return the TPU plane
kernels in interpret mode and logs both sides' intersector decisions, as
``test_torch_slice.py`` does (a patch in the test, not in the package).
Rays whose hit or occlusion decision flipped between the two sides are the
only ones left out of the per-ray comparisons; ``test_torch_slice.py``
explains why a few rays flip (grazing shadow rays that hit their own
triangle on one side only).
"""

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
from nrc_tpu.scene.camera import generate_primary_rays as jax_primary_rays
from nrc_tpu.utils import rng as JR
from nrc_tpu_torch.config import RenderMode
from nrc_tpu_torch.models import network as N
from nrc_tpu_torch.render.renderer import Renderer
from nrc_tpu_torch.scene.scene_builder import cornell_box
from test_torch_scene import jax_cornell_scene
from test_torch_intersect import one_torch_thread  # noqa: F401 (an autouse fixture)
from test_torch_slice import (
    _LOG,
    _interpret_plane_intersectors,
    _recording_port_intersectors,
    _ulps,
)

RES = (32, 32)
TILE = (8, 8)
# what the JAX frame assembled, recorded by a debug callback
_BATCHES = {}


def _system():
    scene, system = cornell_box(RES)
    return scene, dataclasses.replace(system, tile_size=TILE)


def _recording_jax_assemble(fn):
    def wrapped(*args):
        out = fn(*args)
        jax.debug.callback(lambda *a: _BATCHES.update(jax=[np.asarray(x) for x in a]), *out,
                           ordered=True)
        return out
    return wrapped


def _port_assemble_with_jax_batches(fn):
    """The port's own assembly (its record count is checked), but training
    on the JAX frame's batches: ``jax.random.permutation`` cannot be
    reproduced, so the batches are handed over."""
    def wrapped(*args):
        _, _, n = fn(*args)
        bq, bt, _ = _BATCHES["jax"]
        return torch.from_numpy(bq.copy()), torch.from_numpy(bt.copy()), n
    return wrapped


@pytest.fixture(scope="module")
def setup():
    prev = jax.config.jax_enable_compilation_cache
    jax.config.update("jax_enable_compilation_cache", False)  # see test_torch_mlp.py
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_integrator, "make_intersectors", _interpret_plane_intersectors)
        mp.setattr(port_integrator, "make_intersectors",
                   _recording_port_intersectors(port_integrator.make_intersectors))
        mp.setattr(jax_frame, "assemble_training_batches",
                   _recording_jax_assemble(jax_frame.assemble_training_batches))
        mp.setattr(port_frame, "assemble_training_batches",
                   _port_assemble_with_jax_batches(port_frame.assemble_training_batches))
        scene, system = _system()
        jscene = jax_cornell_scene(RES)
        jr = JRenderer(jscene, system, render_mode=RenderMode.FULL, train=True, adaptive_tiles=False)
        pr = Renderer(scene, system, render_mode=RenderMode.FULL, adaptive_tiles=False, device="cpu")
        pr.net_state = N.state_from_numpy(jax.tree.map(np.asarray, jr.net_state))
        yield jr, pr
    jax.config.update("jax_enable_compilation_cache", prev)


def _flipped(calls_jax, calls_port, n):
    """Rays of an n-ray wavefront that both sides cast but that found another
    triangle or another occlusion (the calls of other wavefronts are skipped)."""
    calls_jax = [c for c in calls_jax if c[1][0].shape[0] == n]
    calls_port = [c for c in calls_port if c[1][0].shape[0] == n]
    assert [t for t, _ in calls_jax] == [t for t, _ in calls_port], "different bounces traced"
    flipped = np.zeros(n, bool)
    for (_, j), (_, p) in zip(calls_jax, calls_port):
        flipped |= (j[0] > 0.0) & (p[0] > 0.0) & (j[-1] != p[-1])
    return flipped


def _jax_training_rays(jr, subframe, ratio):
    """The JAX frame's training rays (``nrc_tpu/render/frame.py:197-246``)."""
    cfg = jr.cfg
    tsx, tsy = cfg.tile_size
    _, u_tt = JR.rng(JR.tea(np.uint32(0x9E3779B9), np.uint32(subframe)))
    index = jnp.minimum((u_tt * (tsx * tsy)).astype(jnp.int32), tsx * tsy - 1)
    x0, y0 = jax_frame._tile_origins(cfg)
    tpx, tpy = x0 + index % tsx, y0 + index // tsx
    seeds = JR.tea((tpy * cfg.width + tpx).astype(jnp.uint32) + np.uint32(0x7F4A7C15),
                   np.uint32(subframe))
    seeds, u_unb = JR.rng(seeds)
    seeds, jitter = JR.rng2(seeds)
    cam = jr._camera_arrays()
    org, d = jax_primary_rays(jnp.stack([tpx, tpy], -1).astype(jnp.float32), jitter,
                              (cfg.width, cfg.height), cam.p, cam.u, cam.v, cam.w)
    return [np.asarray(a) for a in (org, d, seeds, u_unb < ratio)]


@pytest.mark.parametrize("subframe", range(4))
def test_training_rays_match_jax(setup, subframe):
    jr, pr = setup
    ref = _jax_training_rays(jr, subframe, 0.5)
    got = port_frame.training_rays(pr.cfg, subframe, pr._camera_arrays(), 0.5, pr.device)
    org, d, seeds, unbiased = (t.numpy() for t in got)
    assert np.array_equal(seeds, ref[2].astype(np.int64)) and np.array_equal(unbiased, ref[3])
    # XLA and PyTorch round the camera products differently: 3 ulp seen
    assert _ulps(org, ref[0]).max() <= 4 and _ulps(d, ref[1]).max() <= 4


# Per-ray limits of the training wavefront, after the largest reading over
# 8 subframes x 2 record depths (128 rays each), flipped rays left out.
WAVEFRONT_LIMITS = {
    "flipped_share": 0.05,   # 0.0234 (3 of 128 rays)
    "query_abs": 2e-5,       # 7.2e-7; the render queries' bound
    "ltp_rel": 1e-5,         # 3.1e-7
    "target_rel": 2e-4,      # 7.6e-6; the render radiance's bound
}


def _rel(a, b):
    return np.abs(a - b) / np.maximum(np.abs(b), 1e-3)


@pytest.mark.parametrize("d_rec", [8, 3])
def test_training_wavefront_matches_jax(setup, d_rec):
    """8 subframes, half the rays unbiased; with 3 record slots the records
    overflow (a forced self-training end)."""
    jr, pr = setup
    jcfg = dataclasses.replace(jr.cfg, max_train_records_per_ray=d_rec, train_unbiased_ratio=0.5)
    pcfg = dataclasses.replace(pr.cfg, max_train_records_per_ray=d_rec, train_unbiased_ratio=0.5)
    jax_trace = jax.jit(lambda o, d, s, u: jax_integrator.trace_wavefront(
        jr.device_scene, o, d, s, jcfg, train=True, unbiased=u))
    worst = dict.fromkeys(WAVEFRONT_LIMITS, 0.0)
    counts = []
    flips = rays = 0
    for subframe in range(8):
        org, d, seeds, unbiased = _jax_training_rays(jr, subframe, 0.5)
        _LOG["jax"].clear()
        _LOG["port"].clear()
        ref = {k: np.asarray(v) for k, v in jax_trace(org, d, seeds, unbiased)._asdict().items()}
        jax.effects_barrier()
        got = port_integrator.trace_wavefront(
            pr.device_scene, torch.from_numpy(org), torch.from_numpy(d),
            torch.from_numpy(seeds.astype(np.int64)), pcfg, train=True,
            unbiased=torch.from_numpy(unbiased))
        got = {k: v.numpy() for k, v in got._asdict().items()}
        n = org.shape[0]
        keep = ~_flipped(_LOG["jax"], _LOG["port"], n)
        flips += int((~keep).sum())
        rays += n
        for key in ("rec_count", "traced_count", "end_mask"):
            assert np.array_equal(got[key][keep], ref[key][keep].astype(got[key].dtype)), key
        counts.append(got["rec_count"])
        slots = (np.arange(d_rec)[None, :] < got["rec_count"][:, None]) & keep[:, None]
        if slots.any():
            worst["query_abs"] = max(worst["query_abs"],
                                     np.abs(got["rec_query"] - ref["rec_query"])[slots].max())
            worst["ltp_rel"] = max(worst["ltp_rel"], _rel(got["rec_ltp"], ref["rec_ltp"])[slots].max())
            worst["target_rel"] = max(worst["target_rel"],
                                      _rel(got["rec_target"], ref["rec_target"])[slots].max())
        ends = keep & (got["end_mask"] > 0)
        if ends.any():
            worst["query_abs"] = max(worst["query_abs"],
                                     np.abs(got["end_query"] - ref["end_query"])[ends].max())
    worst["flipped_share"] = flips / rays
    over = {k: (v, WAVEFRONT_LIMITS[k]) for k, v in worst.items() if not v <= WAVEFRONT_LIMITS[k]}
    assert not over, f"readings over their limits: {over}"
    counts = np.concatenate(counts)
    assert counts.max() == d_rec or d_rec == 8, "the overflow case was not reached"
    assert (counts > 0).mean() > 0.4  # 0.56: the other rays leave the box or hit the light


# Per-frame limits of the three FULL + train frames, after the largest
# reading. Each frame starts from the JAX state, and the port trains on the
# JAX frame's batches. JAX's train_step rounds each weight gradient to bf16
# where K6 sums in f32 (see test_torch_train.py), so after the frame's four
# Adam steps a weight with a tiny gradient can sit up to 8 lr = 2.4e-2 apart.
SLICE_LIMITS = {
    "flipped_share": 0.02,         # 0.0078; render rays, test_torch_slice.py's bound
    "image_kept_abs": 2e-2,        # 0.0072; its cache bound (lrt x cache, bf16 inputs)
    "image_kept_mean_rel": 1e-4,   # 2.3e-5
    "image_mean_rel": 2e-3,        # 4.6e-4
    "loss_rel": 5e-3,              # 1.5e-3
    "records_gap": 8,              # 0; one flipped training ray moves up to 8 records
    "params_abs": 2.4e-2,          # 0.0118
    "ema_abs": 5e-3,               # 0.0012
    "ema_mean_abs": 1e-4,          # 1.2e-5
}


def test_full_train_frames_match_jax(setup):
    jr, pr = setup
    for subframe in range(3):
        _LOG["jax"].clear()
        _LOG["port"].clear()
        for r in (jr, pr):
            r.restart_accumulation()
            assert r.total_subframe == subframe
        # each frame starts from the JAX state: the comparison is one frame's
        # worth of training, not the drift of the frames before
        pr.net_state = N.state_from_numpy(jax.tree.map(np.asarray, jr.net_state))
        jstats = jr.render_frame()
        ref = np.asarray(jr.image)
        jax.effects_barrier()
        pstats = pr.render_frame()
        out = pr.image.numpy()
        assert np.isfinite(out).all() and out.std() > 0.0
        assert int(pr.net_state.opt.step) == int(jr.net_state.opt.step) == 4 * (subframe + 1)
        keep = ~_flipped(_LOG["jax"], _LOG["port"], RES[0] * RES[1])
        got = {
            "flipped_share": 1.0 - keep.mean(),
            "image_kept_abs": np.abs(out - ref)[keep].max(),
            "image_kept_mean_rel": abs(out[keep].mean() / ref[keep].mean() - 1.0),
            "loss_rel": abs(float(pstats.loss) / float(jstats.loss) - 1.0),
            "records_gap": abs(int(pstats.num_train_records) - int(jstats.num_train_records)),
            "image_mean_rel": abs(out.mean() / ref.mean() - 1.0),
            "ema_abs": 0.0,
            "ema_mean_abs": 0.0,
            "params_abs": 0.0,
        }
        assert int(jstats.num_train_records) > 0
        port_state = N.state_to_numpy(pr.net_state)
        for name in ("w_in", "w_hidden", "w_out"):
            d = np.abs(port_state[f"ema.{name}"] - np.asarray(getattr(jr.net_state.ema, name)))
            got["ema_abs"] = max(got["ema_abs"], d.max())
            got["ema_mean_abs"] = max(got["ema_mean_abs"], d.mean())
            d = np.abs(port_state[f"params.{name}"] - np.asarray(getattr(jr.net_state.params, name)))
            got["params_abs"] = max(got["params_abs"], d.max())
        over = {k: (v, SLICE_LIMITS[k]) for k, v in got.items() if not v <= SLICE_LIMITS[k]}
        assert not over, f"frame {subframe}: readings over their limits: {over}"
