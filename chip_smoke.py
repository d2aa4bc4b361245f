#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``nrc_tpu_torch/``) on one NVIDIA card.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA card, ``nvcc`` (``$CUDA_HOME/bin`` or on ``PATH``) and no network.

Phases, each of which raises on failure (non-zero exit):
1. device: the card's name and power limit as ``nvidia-smi`` reports them;
2. build: compile every kernel (K1-K9, W1, W2, H1, H2) from ``csrc/``, one
   ``nvcc`` per source file, all started together, and the native host
   library; the ``nvcc`` release is printed;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the shapes the 320x320 frames give it (B = 16384 training rows,
   [4, 16384] for K6), with times (CUDA events), the least time the card
   could take for the same work (``bound_ms``) and, for the gathers, the
   time of ``torch.index_select``. K3-K6 (bf16 ``mma.sync`` tiles) are held
   to ``tools/bench_mlp.py::CARD_LIMITS``, their machine code must hold HMMA
   opcodes, K6 must be one kernel launch per call and two runs of it must leave the same bits, and at
   1000 and 129 rows it must equal K5 + the plain update composed step by step. The row
   gathers K7-K9 bit for bit on the walk's [131072, 160] table, on the TPU resident kernel's own
   [8192, 160] and on the path's other tables, and timed on them beside ``index_select``; K7
   bit for bit on ``bench_gather``'s edge grid (widths, index counts, table sizes); the walk
   kernels W1/W2 on the 132 K-triangle ``cornell_objects`` scene against the
   plain walk, and W1 against the brute-force K1; the hash grid's lookup H1
   bit for bit and its adjoint H2 under ``tools/bench_hash.py::CARD_LIMITS``
   (with its seeded faults above them), two launches of H2 bit-equal and
   equal to ``bench_hash.fixed_point_adjoint`` (its arithmetic in plain
   PyTorch), the table rows zero in one and not in the other printed, at the
   shipped grid (H1 at B = 128,000, the frame's inference, and at 16,384, a
   step's; H2 at 16,384) and at an edge grid (2^10 rows, base resolution 4:
   dense and hashed levels; B not a multiple of 32; positions outside
   [0, 1]), timed beside their bounds, H2 on the dense and on the hashed
   levels alone, and the table's Adam + EMA;
4. train_step: four ``train_step``s on the card, K3 forward + K4 backward
   through autograd; four hash ``train_step``s (H1, K3, K4 with dX, H2, the
   table's Adam + EMA) against the same steps on the CPU, under
   ``bench_hash.HASH_LIMITS``;
5. serving slice: ``Renderer`` on the 1224-triangle Cornell box at 320x320,
   FULL then NO_CACHE, ``train=False``, frequency encoding 64x5 from a seeded
   init, 8 timed frames each, each frame one CUDA graph replay;
6. training slice: FULL + train at 320x320 (the main path), replayed: frames
   until the adaptive tile size settles, then 8 timed frames, then 4 frames
   whose launches per replayed frame the kernels line reports (the counts
   each graph recorded at its capture, added at each replay): K6 once, K5
   never (K6 is one persistent kernel); the same
   renderer eagerly and replayed under the profiler (ms/frame, device busy,
   idle share, kernels and syncs per frame) and the bytes its graphs hold;
   then one more frame, run eagerly, with the inputs of every K1 and K2
   launch recorded (lanes and live lanes of each are printed), K1 and K2
   held against their plain versions on each recorded set, dead lanes
   included, and timed on it: the sum over the frame's launches is the
   frame-weighted time, beside the bound of its live rays; and the row
   gathers of one eager frame recorded, held bit for bit and timed: K7's
   frame-weighted time beside ``index_select``'s and its byte bound, in
   all and by table width, with whether K7 is under ``index_select`` there;
6c. graph replay against eager frames: two renderers from the same start,
   one replaying graphs and one eager, through FULL + train frames with a
   forced tile-size change, ``restart_accumulation``, ``reset_cache`` and
   ``set_hyper_params``; after every frame the image, weights, moments,
   EMA, step and stats must be equal bit for bit. On the Cornell box (12
   frames) and on ``cornell_objects`` (8 frames);
6d. the hash encoding: FULL + train at 320x320 through ``set_encoding``,
   replayed, until the tile size settles, then 8 timed frames and 4 counted:
   H1 five launches a replayed frame (inference and four steps), H2 and K4
   four, K6 none; eagerly and replayed under the profiler; then renderers
   from one start (eager, replayed, eager again, and replayed with one
   ``train_step`` dropped from its captured frame, a planted fault): two
   frequency frames bit for bit, ``set_encoding(HASH)``, one hash frame,
   every state set to the eager one's, then one replayed hash frame against
   the eager one: image, records and step bit for bit, loss and state within
   ``bench_hash.HASH_LIMITS``, the planted fault above them; then four more
   hash frames after each of which the replayed renderer and a second eager
   one equal the eager one bit for bit (H2's fixed-point sums); and every H1
   and H2 launch of one more eager hash frame recorded
   (``bench_hash.record_frame``: the inference in pixel order, four
   shuffled training batches), H1 held bit for bit and H2 within
   ``CARD_LIMITS`` on each and timed by ``bench_hash.measure``: the
   frame-weighted times (the kernels line's ``frame_ms``) beside the frame
   bound (``frame_bound_ms``);
6e. the glass slice: ``cornell_glass`` (glass, frosted glass and a
   thin-walled translucent panel) FULL + train at 320x320 with reflectance
   factoring and shadow-ray Russian roulette (tau 0.5), replayed: K1, K2,
   K3, K6 and K7 launched, a finite image, the loss curve; replayed against
   eager frames bit for bit (as 6c, 6 frames); live edits under captured
   graphs: an albedo edit replays the same graph reading the patched
   tables, an archetype edit captures another, eager and replayed frames
   bit for bit after each; a screenshot (PNG, HDR) and a render state
   written and read back, the state loaded under a captured graph;
7. large scene: FULL + train at 320x320 on ``cornell_objects`` (the wide
   BVH path), replayed: frames until the tile size settles, then 8 timed
   frames and 4 more counted; W1, W2 and the path's gather must run, K1 and
   K2 must not; then every W1 and W2 launch of one eager frame recorded,
   held against the plain walk and timed by ``bench_walk.measure`` (the
   measurement ``tools/bench_walk.py`` makes), each launch printed with its live
   rays and the mean, 99th percentile and largest count of rows a live ray
   fetches in the plain walk (a launch lasts as long as its longest chains):
   their frame-weighted times beside the frame bound (the all-live bound
   over each launch's live rays);
8. convergence: the JAX package's online-training oracle
   (``tests/test_frame.py:92-139``) on the port's Cornell box at 64x64 with
   8x8 tiles, for both encodings: the loss falls over 40 frames, and after a
   restart 48 FULL + train frames come within 18 dB (tonemapped PSNR) of
   48-spp NO_CACHE;
9. reference: 32x32 frames (8x8 tiles) on the card against the same frames
   on the CPU, where the port runs the plain versions the CPU tests check
   against JAX; after the training frame, the weights, moments and EMA too.
   Once by brute force and once with the wide BVH attached; the
   ``cornell_glass`` FULL + train (factoring, roulette) and NO_CACHE frames
   under the same bounds; then one hash FULL + train frame, held by
   ``HASH_LIMITS``;
10. quality gate: FULL + train at 128x128, 4x4 tiles, 128 frames, for both
   encodings, and NO_CACHE at 64 spp (the noise floor), tonemapped PSNR and
   SSIM against the committed 4096-spp ground truth
   ``tests/data/torch_cornell_box_gt_128.npz``, held to
   ``tools/quality_gate.py::LIMITS``.

Every path that runs a kernel is driven with the launch counts set to 0 just
before it and read just after; each kernel must have been launched there. A
graph replay runs no Python: the renderer adds the launches each graph
recorded at its capture, once per replay.
The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.
"""

import concurrent.futures
import ctypes
import dataclasses
import functools
import itertools
import json
import math
import os
import re
import subprocess
import sys
import time
from pathlib import Path


def _time_ms(fn, iters=20, warmup=3):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _check(cond, what):
    if not cond:
        raise AssertionError(what)


def _image_agreement(out, ref):
    """(share of pixels within 1e-3 relative, relative gap of the means)."""
    rel = (out - ref).abs() / ref.abs().clamp(min=1e-3)
    return (rel.amax(dim=-1) < 1e-3).float().mean().item(), abs(out.mean().item() / ref.mean().item() - 1.0)


# NVIDIA's data sheet for the H100 SXM: the rates the bounds are taken against
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12     # float32 outside the tensor cores, a fused multiply-add counted as two
F32_UNFUSED_OPS_PER_S = 33.5e12  # the same lanes issuing separate multiplies and adds


def _bound(nbytes, ops, ops_per_s):
    """The least time the card could take: each input byte read once and each
    output byte written once, or the operations at the peak rate of their
    type, whichever is larger."""
    by_bytes, by_ops = 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * ops / ops_per_s
    return dict(bound_ms=max(by_bytes, by_ops), bound_by="bytes" if by_bytes >= by_ops else "operations")


def _plain_walk(o, d, bvh, tmin, tmax, any_hit):
    """The plain walk -> (t, prim, rows fetched, distinct rows fetched)."""
    import torch

    from nrc_tpu_torch.ops import intersect_wide as IW

    seen = torch.zeros(bvh.rows.shape[0], dtype=torch.bool, device=o.device)
    t, prim, fetched = IW.wide_traverse_plain(o, d, bvh, tmin, tmax, any_hit, rows_seen=seen)
    return t, prim, fetched, int(seen.sum())


def _walk_bound(fetched, distinct, row_bytes, n_rays):
    """A walk launch's bound: each distinct table row it fetches read once
    (the walk's table stays in the L2 for a launch), 32 bytes of ray read
    and 8 of result written a ray; or about 45 float32 operations per
    triangle or child box of every row it fetches."""
    return _bound(distinct * row_bytes + n_rays * (32 + 8), fetched * 16 * 45, F32_OPS_PER_S)


def _counted(kernels, names, fn):
    """Run fn with the named kernels' counts set to 0; return (result, counts)."""
    for name in names:
        kernels[name][0].launches = 0
    out = fn()
    return out, {name: kernels[name][0].launches for name in names}


def _ptxas(log):
    """Per entry function of a ``-Xptxas -v`` log: its registers, shared
    memory and spills, on one line."""
    out, name, spills = [], "?", ""
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            short = re.search(r"(mlp_\w*?kernel|gather_\w*?kernel|\w*planes_kernel|\w*wbvh_kernel|reduce_partials)",
                              m.group(1))
            name = short.group(1) if short else m.group(1)
            if "gather_warp_kernel" in name:  # <word, resident>
                name = "gather_warp_kernel" + ("<uint4" if "I5uint4" in m.group(1) else "<u32") + (", resident>" if "Lb1EE" in m.group(1)
                                                                              else ">")
            else:
                for code, arg in (("ILb1E", "<true>"), ("ILb0E", "<false>"), ("I5uint4", "<uint4>"), ("IjE", "<u32>")):
                    if code in m.group(1):
                        name += arg
        elif "spill stores" in ln:
            spills = ln.strip()
        elif "Used" in ln and "registers" in ln:
            out.append(f"{name}: {ln.split(':', 1)[1].strip()}, {spills}")
    return out


def _with_tiles(system, tiles):
    return dataclasses.replace(system, tile_size=tiles)


def _replayed_launches(r, kernels, frames=4):
    """Launches per frame of each kernel over ``frames`` more frames, every
    one of them a graph replay."""
    replays = r.replays
    _, counts = _counted(kernels, kernels, lambda: r.render(frames))
    _check(r.replays - replays == frames, "a frame of the counted run was not a graph replay")
    _check(all(n % frames == 0 for n in counts.values()), f"launches differ from frame to frame: {counts}")
    return {name: n // frames for name, n in counts.items()}


def _print_eager_and_replayed(PF, r, label):
    """The same renderer's frames eagerly and replayed, under the profiler."""
    rows = {}
    for capture in (False, True):
        r.capture = capture
        rows["replayed" if capture else "eager"] = PF.profile_mode(r, 4, 10, stacks=False)
    r.capture = True
    for kind, row in rows.items():
        print(f"{label} {kind}: {row['ms_per_frame_median']:.3f} ms/frame median of 10 "
              f"({row['ms_per_frame_min']:.3f}-{row['ms_per_frame_max']:.3f}), device busy "
              f"{row['device_busy_ms_per_frame']:.3f} ms/frame, idle {100 * row['device_idle_share']:.1f} %, "
              f"{row['kernel_launches_per_frame']:.0f} kernels and {row['host_syncs_and_copies_per_frame']:.1f} "
              f"syncs and copies per frame; by group {row['device_ms_per_frame_by_group']}"
              + (f"; the hash table's Adam + EMA {row['hash_table_update_device_ms_per_frame']:.4f} ms/frame"
                 if row["hash_table_update_device_ms_per_frame"] else ""))
    print(f"{label} graphs: " + ", ".join(f"tile {k[2][0]}x{k[2][1]} {g.nbytes} bytes" for k, g in r.graphs.items()))


def _replay_matches_eager(scene, system, dev, frames, label, **renderer_kw):
    """Eager and replayed FULL + train frames from the same start, with a
    tile-size change, a restart, a reset of the cache and new
    hyper-parameters on the way; equal bit for bit after every frame.
    ``renderer_kw``: Renderer arguments, and ``nee_rr_tau`` for the cfg."""
    import torch

    from nrc_tpu_torch.config import RenderMode
    from nrc_tpu_torch.render.renderer import Renderer

    def bits(r):
        st = r.net_state
        out = [t.detach().view(torch.int32) for m in (st.params, st.ema, st.opt.mu, st.opt.nu)
               for t in m.tensors()]
        s = r.last_stats
        return out + [st.opt.step, r.image.view(torch.int32), s.loss.view(torch.int32), s.num_train_records,
                      s.traced_rays]

    tau = renderer_kw.pop("nee_rr_tau", 0.0)
    pair = [Renderer(scene, system, render_mode=RenderMode.FULL, adaptive_tiles=False, device=dev, capture=c,
                     **renderer_kw) for c in (False, True)]
    for r in pair:
        r.cfg = dataclasses.replace(r.cfg, nee_rr_tau=tau)
    t0 = system.tile_size
    events = {2: ("tile size", lambda r: setattr(r, "cfg", _with_tiles(r.cfg, (2 * t0[0], 2 * t0[1])))),
              4: ("tile size back", lambda r: setattr(r, "cfg", _with_tiles(r.cfg, t0))),
              5: ("restart_accumulation", lambda r: r.restart_accumulation()),
              6: ("reset_cache", lambda r: r.reset_cache()),
              7: ("set_hyper_params(learning_rate=5e-3)", lambda r: r.set_hyper_params(learning_rate=5e-3)),
              9: ("set_hyper_params(train_unbiased_ratio=0.25)",
                  lambda r: r.set_hyper_params(train_unbiased_ratio=0.25))}
    done = []
    for f in range(frames):
        if f in events:
            name, act = events[f]
            for r in pair:
                act(r)
            done.append(name)
        for r in pair:
            r.render_frame()
        torch.cuda.synchronize()
        same = [torch.equal(a, b) for a, b in zip(bits(pair[0]), bits(pair[1]))]
        _check(all(same), f"{label} frame {f}: replayed and eager frames differ ({same})")
    for r in pair:
        r.flush_stats()
    replayed = pair[1]
    print(f"{label}: {frames} FULL + train frames replayed ({replayed.replays} replays, {len(replayed.graphs)} graphs, "
          f"{sum(g.nbytes for g in replayed.graphs.values())} bytes) and eager, bit for bit equal after every frame "
          f"(image, weights, EMA, moments, step, loss, records, traced rays), across {done}; "
          f"loss {replayed.loss_history[-1]:.4f}")
    _check(replayed.replays >= frames // 2, f"{label}: only {replayed.replays} of {frames} frames were replays")


def _held(reading, limit, above=False):
    return reading >= limit if above else reading <= limit


def _hash_kernels(report, gen, dev):
    """H1 and H2 against their plain versions at the full and the edge grid,
    the seeded faults and two runs' spread; their times beside their bounds."""
    from nrc_tpu_torch.tools import bench_hash as BH

    full = None
    for label, spec, n1, n2 in (("full", BH.full_spec(), BH.INFER_ROWS, BH.STEP_ROWS),
                                ("edge", BH.edge_spec(), 1001, 999)):
        res = BH.check(spec, n1, n2, gen, dev, label)
        full = full or res
        h1 = [res["h1"]] + ([BH.check_lookup(spec, n2, gen, dev)] if label == "full" else [])
        _check(all(c["differing"] == 0 for c in h1), f"H1 {label}: words differ from the plain version: {h1}")
        print(f"H1 {label} grid ({spec.levels} levels, 2^{spec.log2_size} rows, {spec.features} features, "
              f"dense levels {sum(spec.dense)}; positions in [-0.1, 1.1]^3): "
              + "; ".join(f"B = {c['n']}: {c['differing']} of {c['words']} words differ from the plain version, "
                          f"largest |diff| {c['max_abs']:.3g}" for c in h1))
        print(f"H2 {label} grid, B = {n2}, g read through a [B, 128] row stride: {res['h2']} (limits "
              f"{BH.CARD_LIMITS}), largest |diff| {res['h2_max_abs']:.3g}, table rows zero in one and not in the "
              f"other {res['h2_zero_mismatch_rows']}; two runs on the same inputs bit-equal: "
              f"{res['h2_bits_equal_run_to_run']}, equal to the fixed-point model: "
              f"{res['h2_bits_equal_fixed_point_model']} (BH.check raises otherwise); seeded faults {res['faults']}")
    t = BH.times(BH.full_spec(), BH.INFER_ROWS, BH.STEP_ROWS, gen, dev)
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    # H1's row: the frame's inference launch (B = INFER_ROWS)
    report["hash_grid_lookup"] = dict(max_abs_err=full["h1"]["max_abs"], **{k: t["H1"][k] for k in keys})
    report["hash_grid_adjoint"] = dict(max_abs_err=full["h2_max_abs"], scratch_bound_ms=t["H2"]["scratch_bound_ms"],
                                       **{k: t["H2"][k] for k in keys})
    print(f"H1 at B = {t['H1']['n']}: {t['H1']['ms']:.4f} ms (plain {t['H1']['plain_ms']:.4f}), bound "
          f"{t['H1']['bound_ms']:.4f} ms by {t['H1']['bound_by']}; H1 at B = {t['H1_steps']['n']}: "
          f"{t['H1_steps']['ms']:.4f} ms (plain {t['H1_steps']['plain_ms']:.4f}), bound "
          f"{t['H1_steps']['bound_ms']:.4f} ms; H2 at B = {t['H2']['n']}: {t['H2']['ms']:.4f} ms "
          f"(plain {t['H2']['plain_ms']:.4f}), bound {t['H2']['bound_ms']:.4f} ms by {t['H2']['bound_by']} (its "
          f"64-bit sums {t['H2']['scratch_bound_ms']:.4f} ms more), on the "
          f"grid cut to its levels {t['H2']['by_level_ms']}; index_add_ of the 8 x L x B precomputed weighted rows "
          f"(not the same function: no indices or weights computed) {t['H2']['index_add_ms_precomputed_rows']:.4f} "
          f"ms; the table's Adam + EMA (plain PyTorch) {t['table_update_ms']:.4f} ms a step, four a frame")


def _hash_train_steps(kernels, gen, dev, hash_cfg):
    """Four hash train_steps on the card (H1 -> K3 -> K4 with dX -> H2 ->
    Adam + EMA) against the same steps on the CPU."""
    import torch

    from nrc_tpu_torch.models import network as N
    from nrc_tpu_torch.tools import bench_hash as BH

    b = 16384
    q4 = torch.rand((4, b, 15), generator=gen, device=dev)
    q4[..., :3] = (q4[..., :3] - 0.5) * 0.1  # positions as the frames scale them
    t4 = torch.rand((4, b, 3), generator=gen, device=dev) * 2.0

    def steps(device):
        st = N.init_network(torch.Generator().manual_seed(4), hash_cfg, device)
        lr = torch.tensor(hash_cfg.learning_rate, device=device)
        losses = []
        for k in range(4):
            st, loss = N.train_step(st, q4[k].to(device), t4[k].to(device), hash_cfg, learning_rate=lr)
            losses.append(loss)
        return st, torch.stack(losses)

    (st, lk), counts = _counted(kernels, kernels, lambda: steps(dev))
    torch.cuda.synchronize()
    sc, lc = steps(torch.device("cpu"))
    lim = BH.HASH_LIMITS
    loss_rel = ((lk.cpu() - lc).abs() / lc.abs()).max().item()
    gap = BH.state_gap(st, sc)
    print(f"hash train_step x4 (B = {b}) on the card: losses {lk.tolist()}, launches "
          f"{ {k: v for k, v in counts.items() if v} }; against the CPU: losses {loss_rel:.3g} relative (limit "
          f"{lim['steps_loss']}), state {gap} (limits mean {lim['steps_mean']}, share beyond {BH.FAR_AT:g} "
          f"{lim['steps_far']})")
    _check(counts["hash_grid_lookup"] == 4 and counts["hash_grid_adjoint"] == 4 and counts["fused_backward"] == 4,
           f"the hash train_steps did not go through H1, H2 and K4 four times each: {counts}")
    _check(bool(torch.isfinite(lk).all()) and int(st.opt.step) == 4, "hash train_step failed")
    _check(_held(loss_rel, lim["steps_loss"]) and _held(gap["mean"], lim["steps_mean"])
           and _held(gap["far"], lim["steps_far"]), "the hash train_steps on the card disagree with the CPU")


def _hash_frame(scene, system, kernels, dev, PF, BI):
    """Hash FULL + train at 320x320 through set_encoding, replayed: H1 five
    times a frame, H2 and K4 four times, K6 never. Returns the launches per
    replayed frame."""
    import torch

    from nrc_tpu_torch.config import InputEncoding, RenderMode
    from nrc_tpu_torch.render.renderer import Renderer

    rh = Renderer(scene, system, render_mode=RenderMode.FULL, device=dev)
    rh.set_encoding(InputEncoding.HASH)
    sizes = BI.settle_tiles(rh)
    trained, counts = _counted(kernels, kernels, lambda: rh.benchmark(8))
    rh.flush_stats()
    _check(bool(torch.isfinite(rh.image).all()) and rh.image.std().item() > 0.0, "hash FULL + train image bad")
    _check(math.isfinite(trained["loss"]), "hash FULL + train loss not finite")
    per_frame = _replayed_launches(rh, kernels)
    print(f"hash FULL + train 320x320 (set_encoding: lr {float(rh.learning_rate):g}, EMA {rh.net_cfg.ema_decay}, "
          f"eps {rh.net_cfg.adam_eps:g}): tile sizes {sizes}, {trained['ms_per_frame']:.3f} ms/frame, "
          f"{trained['mrays_per_s']:.2f} traced Mrays/s, {int(rh.last_stats.num_train_records)} records in the last "
          f"frame, loss {trained['loss']:.4f}, image mean {rh.image.mean().item():.4f}; launches per replayed frame "
          f"{ {k: v for k, v in per_frame.items() if v} }")
    print(f"hash FULL + train loss curve (per frame): {[round(v, 4) for v in rh.loss_history]}")
    _check(per_frame["hash_grid_lookup"] == 5 and per_frame["hash_grid_adjoint"] == 4
           and per_frame["fused_backward"] == 4 and per_frame["fused_train4"] == 0,
           f"a replayed hash FULL + train frame launches H1 {per_frame['hash_grid_lookup']}, H2 "
           f"{per_frame['hash_grid_adjoint']}, K4 {per_frame['fused_backward']} and K6 {per_frame['fused_train4']} "
           f"times (5, 4, 4 and 0 expected)")
    _print_eager_and_replayed(PF, rh, "hash FULL + train")
    return per_frame, _hash_frame_launches(rh)


def _hash_frame_launches(rh):
    """Every H1 and H2 launch of one more eager hash frame recorded
    (``bench_hash.record_frame``), H1 held bit for bit and H2 within
    ``CARD_LIMITS`` on each, each timed by ``bench_hash.measure`` (the
    measurement ``bench_hash --frame`` makes): the frame-weighted times beside
    the frame bound."""
    from nrc_tpu_torch.tools import bench_hash as BH

    builds = BH.hash_builds()
    recorded = BH.record_frame(rh)
    kinds = [kind for kind, _ in recorded]
    _check(kinds.count("H1") == 5 and kinds.count("H2") == 4,
           f"an eager hash FULL + train frame launched H1 and H2 {kinds}, not five and four times")
    rows = BH.measure_launches([(f"launch {i}", kind, a) for i, (kind, a) in enumerate(recorded)], builds)
    frame = BH.frame_totals(rows, builds)
    _check(all(row["builds"]["shipped"]["ok"] for row in rows),
           "H1 or H2 disagrees with its plain version on a recorded hash frame's launch")
    return frame


def _hash_replay_vs_eager(scene, system, dev, frames, label):
    """Renderers from the same start: one eager, one replaying graphs, a
    second eager one and a replaying one whose captured frame drops one
    train_step (a planted fault). Two frequency frames bit for bit;
    set_encoding(HASH) and one hash frame, where the replaying renderers
    capture; every state set to the eager one's; one more hash frame, a
    replay, held by ``bench_hash.frame_gap``: image, records, traced rays
    and step bit for bit, the loss and the state within ``HASH_LIMITS``;
    the planted fault must read above the state limits. Then ``frames`` - 4
    more hash frames (at least 4), after each of which the replayed and the
    second eager renderer must equal the eager one bit for bit: image,
    weights, EMA, moments, the hash table and its EMA and moments, step,
    loss, records and traced rays (H2 sums in fixed point, the same bits on
    every launch)."""
    import torch

    from nrc_tpu_torch.config import InputEncoding, RenderMode
    from nrc_tpu_torch.models import network as N
    from nrc_tpu_torch.render.renderer import Renderer
    from nrc_tpu_torch.tools import bench_hash as BH

    _check(frames - 4 >= 4, f"{label}: fewer than 4 hash frames held bit for bit")
    eager, replayed, eager2, faulty = (
        Renderer(scene, system, render_mode=RenderMode.FULL, adaptive_tiles=False, device=dev, capture=c)
        for c in (False, True, False, True))
    every = (eager, replayed, eager2, faulty)
    for f in range(2):
        for r in every:
            r.render_frame()
        torch.cuda.synchronize()
        _check(all(torch.equal(r.image, eager.image) for r in every),
               f"{label} frame {f}: replayed and eager frequency frames differ")
    for r in every:
        r.set_encoding(InputEncoding.HASH)
    with BH.dropped_train_step():
        faulty.render_frame()  # its graph is captured here, with the fault
    for r in (eager, replayed, eager2):
        r.render_frame()
    torch.cuda.synchronize()
    _check(all(torch.equal(r.image, eager.image) for r in every),
           f"{label}: the first hash frames' images differ (the same state went in)")
    for r in (replayed, eager2, faulty):
        r.net_state = eager.net_state  # copied into the tensors the graphs read
    replays = (replayed.replays, faulty.replays)
    for r in every:
        r.render_frame()
    torch.cuda.synchronize()
    _check((replayed.replays, faulty.replays) == (replays[0] + 1, replays[1] + 1),
           f"{label}: the compared hash frame was not a graph replay")
    gaps = {name: BH.frame_gap(r, eager) for name, r in
            (("replayed", replayed), ("eager again", eager2), ("replayed, one train_step dropped", faulty))}
    lim = {k: v for k, v in BH.HASH_LIMITS.items() if k.startswith("replay_")}
    print(f"{label}: 2 frequency frames replayed and eager bit for bit; set_encoding(HASH), one hash frame, every "
          f"state set to the eager one's, then one hash FULL + train frame, a replay, against the eager frame: "
          f"{gaps} (limits {lim}, share beyond {BH.FAR_AT:g})")
    _check(BH.replay_within_limits(gaps["replayed"]), f"{label}: a replayed hash frame disagrees with an eager one")
    _check(BH.replay_state_above_limits(gaps["replayed, one train_step dropped"]),
           f"{label}: a replayed frame with one train_step dropped reads within the limits")
    del faulty, every

    def bits(r):
        st, stats = r.net_state, r.last_stats
        return ([t.detach().view(torch.int32) for t in N.state_tensors(st)]
                + [st.opt.step, r.image.view(torch.int32), stats.loss.view(torch.int32), stats.num_train_records,
                   stats.traced_rays])

    for f in range(frames - 4):
        for r in (eager, replayed, eager2):
            r.render_frame()
        torch.cuda.synchronize()
        for name, r in (("replayed", replayed), ("eager again", eager2)):
            same = [torch.equal(a, b) for a, b in zip(bits(r), bits(eager))]
            _check(all(same), f"{label} hash frame {f}: the {name} renderer differs from the eager one ({same})")
    for r in (eager, replayed, eager2):
        r.flush_stats()
    print(f"{label}: {frames - 4} more hash FULL + train frames, replayed and eager (twice), bit for bit equal "
          f"after every frame (image, weights, EMA, moments, hash table, its EMA and moments, step, loss, records, "
          f"traced rays); {replayed.replays} replays; loss {replayed.loss_history[-1]:.4f}")
    _check(replayed.replays >= frames - 3, f"{label}: too few replays ({replayed.replays})")


GLASS_TAU = 0.5  # the glass slice's shadow-ray Russian roulette threshold


def _glass_slice(kernels, dev, BI, path_gather):
    """cornell_glass FULL + train at 320x320 with reflectance factoring and
    shadow-ray Russian roulette, replayed: until the tile size settles, 8
    timed frames (K1, K2, K3, K6 and K7 launched, a finite image, the loss
    curve), 4 counted; returns the launches per replayed frame."""
    import torch

    from nrc_tpu_torch.config import RenderMode
    from nrc_tpu_torch.render.renderer import Renderer
    from nrc_tpu_torch.scene.scene_builder import cornell_glass

    glass, glass_sys = cornell_glass((320, 320))
    rg = Renderer(glass, glass_sys, render_mode=RenderMode.FULL, device=dev, reflectance_factoring=True)
    rg.cfg = dataclasses.replace(rg.cfg, nee_rr_tau=GLASS_TAU)
    sizes = BI.settle_tiles(rg)
    trained, counts = _counted(kernels, kernels, lambda: rg.benchmark(8))
    rg.flush_stats()
    for name in ("intersect_planes", "occluded_planes", "fused_forward", "fused_train4", path_gather):
        _check(counts[name] > 0, f"{name} was not launched by the cornell_glass FULL + train run")
    _check(bool(torch.isfinite(rg.image).all()) and rg.image.std().item() > 0.0, "cornell_glass image bad")
    _check(math.isfinite(trained["loss"]) and int(rg.last_stats.num_train_records) > 0, "cornell_glass training bad")
    per_frame = _replayed_launches(rg, kernels)
    _check(per_frame["fused_train4"] == 1, f"a replayed cornell_glass frame launched K6 {per_frame['fused_train4']} times")
    print(f"cornell_glass FULL + train 320x320 ({glass.num_triangles} triangles; archetypes "
          f"{sorted(rg.cfg.archetype_set)}; reflectance factoring, shadow-ray roulette tau {GLASS_TAU}): tile sizes "
          f"{sizes}, {trained['ms_per_frame']:.3f} ms/frame, {trained['mrays_per_s']:.2f} traced Mrays/s, "
          f"{trained['traced_rays_per_frame']:.0f} rays/frame, {int(rg.last_stats.num_train_records)} records in the "
          f"last frame, loss {trained['loss']:.4f}, image mean {rg.image.mean().item():.4f}; launches per replayed "
          f"frame { {k: v for k, v in per_frame.items() if v} }")
    print(f"cornell_glass loss curve (per frame): {[round(v, 4) for v in rg.loss_history]}")
    return per_frame


def _live_edits(dev):
    """A material edit and a render state under captured graphs: a replaying
    and an eager renderer (cornell_glass 64x64, 8x8 tiles) from one start;
    an albedo edit, whose tables the patch copies into the tensors the
    graph reads (the next frames replay the same graph), then an archetype
    edit (another archetype set: a new graph); equal bit for bit after
    every frame. A screenshot (PNG and HDR) and a render state written and
    read back; the state loaded into a third renderer that has captured a
    frame, and its next frame, a replay, equal to the replaying one's."""
    import tempfile

    import torch

    from nrc_tpu_torch.config import RenderMode
    from nrc_tpu_torch.models import checkpoint as PC
    from nrc_tpu_torch.models import network as N
    from nrc_tpu_torch.render.renderer import Renderer
    from nrc_tpu_torch.scene.materials import Archetype
    from nrc_tpu_torch.scene.scene_builder import cornell_glass
    from nrc_tpu_torch.utils import image_io
    from nrc_tpu_torch.utils.tonemap import tonemap_to_u8

    def make(capture):
        scene, system = cornell_glass((64, 64))
        return Renderer(scene, _with_tiles(system, (8, 8)), render_mode=RenderMode.FULL, adaptive_tiles=False,
                        device=dev, capture=capture)

    def bits(r):
        st = r.net_state
        return [t.detach().view(torch.int32) for t in N.state_tensors(st)] + [st.opt.step, r.image.view(torch.int32)]

    def frames(pair, n, what):
        for f in range(n):
            for r in pair:
                r.render_frame()
            torch.cuda.synchronize()
            _check(all(torch.equal(a, b) for a, b in zip(*(bits(r) for r in pair))),
                   f"live edits: {what}, frame {f}: replayed and eager frames differ")

    eager, replayed = make(False), make(True)
    pair = (eager, replayed)
    frames(pair, 2, "before the edits")
    graphs, replays = len(replayed.graphs), replayed.replays
    tables = replayed.device_scene.mat_row.data_ptr()
    for r in pair:
        r.update_material(0, albedo=(0.3, 0.5, 0.7))
    frames(pair, 2, "albedo edit")
    _check(replayed.device_scene.mat_row.data_ptr() == tables and len(replayed.graphs) == graphs
           and replayed.replays == replays + 2, "the albedo edit did not replay the captured graph")
    for r in pair:
        r.update_material(0, archetype=Archetype.SPECULAR_REFLECT)
    frames(pair, 2, "archetype edit")
    _check(len(replayed.graphs) == graphs + 1, "the archetype edit did not capture a graph of its own")
    with tempfile.TemporaryDirectory() as tmp:
        png = image_io.read_png(replayed.screenshot(f"{tmp}/shot"))
        want = tonemap_to_u8(torch.from_numpy(replayed.image_hdr().copy()), replayed.system.tonemapper).numpy()
        hdr = image_io.read_hdr(replayed.screenshot(f"{tmp}/shot", tonemap=False))
        _check((png == want).all() and png.std() > 0
               and abs(hdr - replayed.image_hdr()).max() <= replayed.image_hdr().max() / 128,
               "a screenshot read back is not the image")
        path = PC.save_render_state(f"{tmp}/state", replayed)
        third = make(True)
        for r in (third,):
            r.update_material(0, albedo=(0.3, 0.5, 0.7))
            r.update_material(0, archetype=Archetype.SPECULAR_REFLECT)
            r.render_frame()  # captures its graph
        PC.load_render_state(path, third)
        _check(PC.is_render_state(path) and all(torch.equal(a, b) for a, b in zip(bits(third), bits(replayed)))
               and (third.iteration, third.total_subframe) == (replayed.iteration, replayed.total_subframe),
               "a render state read back differs from the renderer that wrote it")
    replays = third.replays
    frames((replayed, third), 1, "after loading a render state")
    _check(third.replays == replays + 1, "the frame after loading a render state was not a replay")
    print(f"live edits (cornell_glass 64x64): an albedo edit replayed its captured graph ({replayed.replays} replays, "
          f"{len(replayed.graphs)} graphs), an archetype edit captured another; eager and replayed bit for bit "
          f"after every frame; a screenshot (PNG, HDR) and a render state written and read back, the state loaded "
          f"under a captured graph and its next frame bit for bit")


def _convergence(dev, net_cfg, label):
    """The JAX package's online-training oracle (tests/test_frame.py:92-139)
    on the port's Cornell box at 64x64, 8x8 tiles."""
    import torch

    from nrc_tpu_torch.config import RenderMode
    from nrc_tpu_torch.render.renderer import Renderer
    from nrc_tpu_torch.scene.scene_builder import cornell_box
    from nrc_tpu_torch.utils.tonemap import tonemap

    small, small_sys = cornell_box((64, 64))
    small_sys.tile_size = (8, 8)
    rc = Renderer(small, small_sys, net_cfg=net_cfg, render_mode=RenderMode.FULL, adaptive_tiles=False, device=dev)
    rc.render(40)
    rc.flush_stats()
    losses = list(rc.loss_history)
    early, late = sum(losses[:2]) / 2, sum(losses[-10:]) / 10
    rc.restart_accumulation()
    rc.render(48)
    gt = Renderer(small, small_sys, render_mode=RenderMode.NO_CACHE, train=False, device=dev)
    gt.render(48)
    a = tonemap(torch.from_numpy(rc.image_hdr().copy()), small_sys.tonemapper)
    g = tonemap(torch.from_numpy(gt.image_hdr().copy()), small_sys.tonemapper)
    psnr = 10.0 * torch.log10(1.0 / ((a - g) ** 2).mean()).item()
    print(f"convergence 64x64, {label}: loss {early:.4f} (first 2) -> {late:.4f} (last 10 of 40), limit "
          f"{0.9 * early:.4f}; FULL + train vs 48-spp NO_CACHE: {psnr:.2f} dB tonemapped (limit 18)")
    print(f"convergence loss curve, {label}: {[round(v, 4) for v in losses]}")
    _check(late < 0.9 * early, f"{label}: the loss did not fall")
    _check(psnr > 18.0, f"{label}: FULL + train is too far from the NO_CACHE oracle")


def _small_card_vs_cpu(rg, rcpu, label, train):
    """One 32x32 frame of a card renderer against the same frame of a CPU
    one: the image (and after a training frame the records, the loss and
    the weights, moments and EMA) under the bounds of phase 9."""
    import torch

    sg, sc = rg.render(1), rcpu.render(1)
    close, mean_gap = _image_agreement(rg.image.cpu(), rcpu.image)
    print(f"32x32 {label} card vs CPU: {close:.4f} of pixels within 1e-3, means {mean_gap:.2e} apart")
    _check(close >= 0.98 and mean_gap < 1e-3, f"{label}: the card disagrees with the CPU path")
    if not train:
        return
    n_rec = (int(sg.num_train_records), int(sc.num_train_records))
    loss_gap = abs(float(sg.loss) / float(sc.loss) - 1.0)

    def state(rr):
        st = rr.net_state
        return [t.detach().cpu() for m in (st.params, st.opt.mu, st.opt.nu, st.ema) for t in m.tensors()]

    diffs = [(a - c).abs() for a, c in zip(state(rg), state(rcpu))]
    dmax, dmean = max(d.max().item() for d in diffs), max(d.mean().item() for d in diffs)
    print(f"32x32 {label} card vs CPU: records {n_rec[0]} vs {n_rec[1]} (must be equal), "
          f"loss {loss_gap:.2e} relative (limit 1e-5); weights, moments and EMA after the "
          f"frame: largest |diff| {dmax:.3g} (limit 1e-5), largest mean |diff| {dmean:.3g} "
          f"(limit 1e-7)")
    _check(n_rec[0] == n_rec[1] > 0 and loss_gap <= 1e-5 and dmax <= 1e-5 and dmean <= 1e-7,
           f"{label}: the card's training disagrees with the CPU path")


def _hash_card_vs_cpu(dev, hash_cfg):
    """One 32x32 hash FULL + train frame (8x8 tiles) on the card against the
    same frame on the CPU: the image, the records, the loss and the state."""
    from nrc_tpu_torch.config import RenderMode
    from nrc_tpu_torch.render.renderer import Renderer
    from nrc_tpu_torch.scene.scene_builder import cornell_box
    from nrc_tpu_torch.tools import bench_hash as BH

    small, small_sys = cornell_box((32, 32))
    small_sys.tile_size = (8, 8)
    rg, rcpu = (Renderer(small, small_sys, net_cfg=hash_cfg, render_mode=RenderMode.FULL, device=d)
                for d in (dev, "cpu"))
    sg, sc = rg.render(1), rcpu.render(1)
    close, mean_gap = _image_agreement(rg.image.cpu(), rcpu.image)
    n_rec = (int(sg.num_train_records), int(sc.num_train_records))
    loss_gap = abs(float(sg.loss) / float(sc.loss) - 1.0)
    gap = BH.state_gap(rg.net_state, rcpu.net_state)
    lim = BH.HASH_LIMITS
    print(f"32x32 hash FULL + train card vs CPU: {close:.4f} of pixels within 1e-3 (limit {lim['frame_close']}), "
          f"means {mean_gap:.2e} apart ({lim['frame_mean_gap']}); records {n_rec[0]} vs {n_rec[1]} (must be equal), "
          f"loss {loss_gap:.2e} relative ({lim['frame_loss']}); state after the frame {gap} (limits mean "
          f"{lim['frame_mean']}, share beyond {BH.FAR_AT:g} {lim['frame_far']})")
    _check(n_rec[0] == n_rec[1] > 0 and _held(close, lim["frame_close"], above=True)
           and _held(mean_gap, lim["frame_mean_gap"]) and _held(loss_gap, lim["frame_loss"])
           and _held(gap["mean"], lim["frame_mean"]) and _held(gap["far"], lim["frame_far"]),
           "hash FULL + train: the card disagrees with the CPU path")


def _quality_gate(dev):
    """FULL + train against the 4096-spp ground truth, both encodings, and
    the NO_CACHE 64-spp noise floor; limits from tools/quality_gate.py."""
    from nrc_tpu_torch.tools import quality_gate as QG

    t0 = time.perf_counter()
    rows = QG.run(dev)
    for name, row in rows.items():
        print(f"quality gate {name} ({QG.RES}x{QG.RES}, "
              f"{QG.FLOOR_SPP if name.startswith('no_cache') else QG.FRAMES} frames) vs the {QG.GT_SPP}-spp ground "
              f"truth: PSNR {row['psnr']:.3f} dB (limit {row['min_psnr']}), SSIM {row['ssim']:.4f} "
              f"(limit {row['min_ssim']})")
    print(f"quality gate: {time.perf_counter() - t0:.1f} s")
    QG.check(rows)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    # the port must be importable from here (run from the checkout's root)
    from nrc_tpu_torch.config import InputEncoding, NetworkConfig, RenderMode
    from nrc_tpu_torch.models import network as N
    from nrc_tpu_torch.native import get_lib
    from nrc_tpu_torch.ops import cuda_build as CB
    from nrc_tpu_torch.ops import gather_cuda as GC
    from nrc_tpu_torch.ops import hash_cuda as HC
    from nrc_tpu_torch.ops import intersect_cuda as IC
    from nrc_tpu_torch.ops import intersect_wide as IW
    from nrc_tpu_torch.ops import intersect_wide_cuda as WC
    from nrc_tpu_torch.ops import mlp_cuda as MC
    from nrc_tpu_torch.ops.bvh_wide import build_wide_bvh
    from nrc_tpu_torch.ops.intersect import RT_MAX
    from nrc_tpu_torch.render.renderer import Renderer
    from nrc_tpu_torch.render.scene_device import upload_scene
    from nrc_tpu_torch.scene.scene_builder import cornell_box, cornell_glass, cornell_objects
    from nrc_tpu_torch.tools import bench_gather
    from nrc_tpu_torch.tools import bench_intersect as BI
    from nrc_tpu_torch.tools import bench_mlp as BM
    from nrc_tpu_torch.tools import bench_walk as BW
    from nrc_tpu_torch.tools import profile_frame as PF

    # plain references in full float32 (PyTorch's defaults, stated here)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    net_cfg = NetworkConfig()
    hash_cfg = NetworkConfig(encoding=InputEncoding.HASH)

    # ---- 1. device ---------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"device: {torch.cuda.get_device_name(0)} | torch {torch.__version__} cuda {torch.version.cuda}")
    print(smi)

    # ---- 2. build: one nvcc per source, all together -------------------------
    kernels = {
        "intersect_planes": (IC.CLOSEST_KERNEL, "nrc_tpu/ops/intersect_pallas.py:185"),
        "occluded_planes": (IC.ANYHIT_KERNEL, "nrc_tpu/ops/intersect_pallas.py:240"),
        "fused_forward": (MC.FORWARD_KERNEL, "nrc_tpu/ops/mlp_pallas.py:81"),
        "fused_backward": (MC.BACKWARD_KERNEL, "nrc_tpu/ops/mlp_pallas.py:155"),
        "fused_train_grad": (MC.TRAIN_GRAD_KERNEL, "nrc_tpu/ops/mlp_pallas.py:311"),
        "fused_train4": (MC.TRAIN4_KERNEL, "nrc_tpu/ops/mlp_pallas.py:626"),
        "gather_rows": (GC.GATHER_KERNEL, "tools/bench_gather_pallas.py:144"),
        "gather_rows_resident": (GC.RESIDENT_KERNEL, "tools/bench_gather_pallas.py:211"),
        "gather_rows_block": (GC.BLOCK_KERNEL, "tools/bench_gather_pallas.py:251"),
        "wbvh_closest": (WC.CLOSEST_KERNEL,
                         "nrc_tpu/ops/intersect_wide.py:518 (intersect_wbvh; no Pallas kernel stood there)"),
        "wbvh_any": (WC.ANYHIT_KERNEL,
                     "nrc_tpu/ops/intersect_wide.py:528 (occluded_wbvh; no Pallas kernel stood there)"),
        "hash_grid_lookup": (HC.LOOKUP_KERNEL,
                             "nrc_tpu/ops/encodings.py:320 (hash_grid_lookup: XLA gathers; no Pallas kernel stood "
                             "there)"),
        "hash_grid_adjoint": (HC.ADJOINT_KERNEL,
                              "nrc_tpu/ops/encodings.py:320 (the adjoint of hash_grid_lookup: XLA's scatter-add, "
                              "or the one-hot products of _grid_gather_bwd at :283 on a TPU; no Pallas kernel "
                              "stood there)"),
    }
    path_gather = next(name for name, (k, _) in kernels.items() if k is GC.PATH_KERNEL)
    first_of_source = {}
    for name, (k, _) in kernels.items():
        first_of_source.setdefault((k.source, k.extra_flags), name)

    def build(name):
        t0 = time.perf_counter()
        log = kernels[name][0].build()
        return f"build {kernels[name][0].source} in {time.perf_counter() - t0:.1f} s; " + " | ".join(_ptxas(log))

    def build_native(_):
        t0 = time.perf_counter()
        _check(get_lib() is not None, "the native host library did not build")
        return f"build native/nrc_native.c in {time.perf_counter() - t0:.1f} s"

    nvcc = subprocess.run([CB._nvcc(), "--version"], capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()
    print(f"nvcc: {nvcc[-2].strip()} ({nvcc[-1].strip()})")
    t_build = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(first_of_source) + 1) as pool:
        native = pool.submit(build_native, None)
        for line in pool.map(build, first_of_source.values()):
            print(line)
        print(native.result())
    for k, _ in kernels.values():
        k.build()  # the other entry points of the built libraries
    print(f"build: all kernels in {time.perf_counter() - t_build:.1f} s")
    # K3-K6 run their products on the tensor cores: the machine code of each
    # of their libraries must hold the bf16 mma opcode (HMMA in SASS)
    cuobjdump = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "cuobjdump"
    n_hidden = net_cfg.n_hidden_layers - 1
    for k in (MC.FORWARD_KERNEL, MC.BACKWARD_KERNEL, MC.TRAIN_GRAD_KERNEL):
        sass = subprocess.run([str(cuobjdump), "-sass", k.library_path], capture_output=True, text=True,
                              check=True, timeout=300).stdout
        hmma = sum("HMMA.16816.F32.BF16" in line for line in sass.splitlines())
        print(f"{k.source}: {hmma} HMMA.16816.F32.BF16 in its SASS")
        _check(hmma > 0, f"{k.source} holds no bf16 tensor-core opcode")
    # the sources' own reckoning of a CTA's dynamic shared memory
    smem_fwd = ctypes.CDLL(MC.FORWARD_KERNEL.library_path).nrc_mlp_forward_smem_bytes(n_hidden)
    smem_grad = ctypes.CDLL(MC.TRAIN_GRAD_KERNEL.library_path).nrc_mlp_grad_smem_bytes(n_hidden)
    print(f"dynamic shared memory a CTA ({n_hidden} hidden 64 -> 64 layers): mlp_forward_kernel "
          f"{smem_fwd} bytes, mlp_grad_kernel {smem_grad} bytes of 232448")
    _check(0 < 2 * smem_fwd <= 232448 and 0 < smem_grad <= 232448, "a CTA's shared memory does not fit")

    # ---- 3. kernels against their plain versions, at main-path shapes --------
    scene, system = cornell_box((320, 320))
    r = Renderer(scene, system, render_mode=RenderMode.FULL, train=False, device=dev)
    ds = r.device_scene
    n = r.cfg.num_pixels
    gen = torch.Generator(device=dev).manual_seed(1)
    sets = BI.ray_sets(r, lambda o, dd, tn, tf: IC.closest_plain(o, dd, ds.planes, tn, tf)[0], gen)
    report = {}
    prim_agree, t_err, occ_agree = [], 0.0, []
    for o, dd, tn, tf in sets["closest"]:
        tk, pk = IC.closest_cuda(o, dd, ds.planes, tn, tf)
        tp, pp = IC.closest_plain(o, dd, ds.planes, tn, tf)
        torch.cuda.synchronize()
        prim_agree.append((pk == pp).float().mean().item())
        both = (pk == pp) & (pk >= 0)
        t_err = max(t_err, (tk - tp)[both].abs().max().item())
        rel = ((tk - tp).abs() / tp.abs())[both].max().item()
        _check(rel <= 1e-5, f"K1 t rel err {rel} > 1e-5")
    for o, dd, tn, tf in sets["any"]:
        ok = IC.occluded_cuda(o, dd, ds.planes, tn, tf)
        op = IC.occluded_plain(o, dd, ds.planes, tn, tf)
        torch.cuda.synchronize()
        occ_agree.append((ok == op).float().mean().item())
    print(f"K1 prim agreement {prim_agree} (need >= 0.9999), max |dt| {t_err:.3g}; "
          f"K2 occlusion agreement {occ_agree} (need >= 0.9999)")
    _check(min(prim_agree) >= 0.9999, "K1 winners disagree with the plain version")
    _check(min(occ_agree) >= 0.9999, "K2 occlusion disagrees with the plain version")
    # Bounds of K1/K2. Bytes: each ray (org, dir, tmin, tmax: 32 bytes) and
    # the plane table read once, the result written once. Operations: 39
    # float32 operations per ray-triangle pair (three 4-term and three 3-term
    # dot products, one division, u, v and u + v), over the float32 rate. K1
    # tests every triangle for every live ray; K2 stops at a ray's first hit,
    # so its pairs are counted from this run's rays, in table order.
    pair_ops = 39
    num_tris = ds.planes.shape[0]
    table_bytes = ds.planes.numel() * 4
    o, dd, tn, tf = sets["closest"][1]
    report["intersect_planes"] = dict(
        max_abs_err=t_err,
        ms=_time_ms(lambda: IC.closest_cuda(o, dd, ds.planes, tn, tf)),
        plain_ms=_time_ms(lambda: IC.closest_plain(o, dd, ds.planes, tn, tf), iters=5),
        **_bound(n * (32 + 12) + table_bytes, int((tf > tn).sum()) * num_tris * pair_ops, F32_OPS_PER_S),
        library_ms=None,
    )
    o, dd, tn, tf = sets["any"][0]
    occ_k = IC.occluded_cuda(o, dd, ds.planes, tn, tf)
    occ_p = IC.occluded_plain(o, dd, ds.planes, tn, tf)
    pairs = BI.pairs_to_first_hit((o, dd, tn, tf), ds.planes)
    report["occluded_planes"] = dict(
        max_abs_err=(occ_k.float() - occ_p.float()).abs().max().item(),
        ms=_time_ms(lambda: IC.occluded_cuda(o, dd, ds.planes, tn, tf)),
        plain_ms=_time_ms(lambda: IC.occluded_plain(o, dd, ds.planes, tn, tf), iters=5),
        **_bound(n * (32 + 1) + table_bytes, pairs * pair_ops, F32_OPS_PER_S),
        library_ms=None,
    )
    print(f"K2 bound: {pairs} ray-triangle pairs up to each ray's first hit, of {n * num_tris}")
    # The kernels keep the plain version's operation order, so they may not fuse
    # a multiply with its add: at that rate the same operations take twice as long.
    for name in ("intersect_planes", "occluded_planes"):
        fused = report[name]["bound_ms"]
        print(f"{name} on the all-live set: {report[name]['ms']:.4f} ms; bound {fused:.4f} ms at the fused "
              f"multiply-add rate ({F32_OPS_PER_S / 1e12:g} TFLOP/s), {fused * F32_OPS_PER_S / F32_UNFUSED_OPS_PER_S:.4f} "
              f"ms at the separate multiply and add rate ({F32_UNFUSED_OPS_PER_S / 1e12:g} T operations/s)")

    ema = r.net_state.ema
    w = (ema.w_in, ema.w_hidden, ema.w_out)
    x = torch.rand((n, MC.LANE), generator=gen, device=dev)
    x[:, 66] = 1.0  # the ones channel after the 66 encoded features
    x[:, 67:] = 0.0
    lim = BM.CARD_LIMITS
    yk = MC.fused_forward_cuda(*w, x, True)
    yp = MC.fused_forward_plain(*w, x, True)
    torch.cuda.synchronize()
    torch.testing.assert_close(yk, yp, atol=lim["k3_atol"], rtol=lim["k3_rtol"])  # bf16 operands
    print(f"K3 max |err| {(yk - yp).abs().max().item():.3g} (atol {lim['k3_atol']:g}, rtol {lim['k3_rtol']:g})")
    # Times of K3-K6 are device times (ten calls captured in a CUDA graph and
    # replayed): the kernels take tens of microseconds, less than a wrapper's
    # host cost, which a loop of eager launches would time instead.
    # Bounds of K3-K6 (bench_mlp.mlp_bound says what is counted): the
    # function's own bytes and operations. The per-CTA partial sums of dW that
    # K4-K6 write and read back are this implementation's traffic, the price
    # of a sum in a fixed order: they stand beside the bound as
    # scratch_bound_ms and are no part of it.
    report["fused_forward"] = dict(
        max_abs_err=(yk - yp).abs().max().item(),
        ms=BI.device_ms(lambda: MC.fused_forward_cuda(*w, x, True)),
        plain_ms=BI.device_ms(lambda: MC.fused_forward_plain(*w, x, True), iters=5),
        **BM.mlp_bound("K3", n, n_hidden),
        library_ms=None,
    )

    # K4-K6 at the training batch of a frame: 4 x 16384 encoded queries,
    # held to bench_mlp.CARD_LIMITS, which says what each limit admits and why the
    # largest difference is not among them: the mean difference of each
    # gradient in units of its largest entry, the rows of dX with an entry
    # far off, K6's state by the mean difference and the share of entries far
    # apart per tensor. A dropped ReLU mask reads 5e-2 on the mean and 1.0 on
    # the largest entry, a skipped EMA update of the last step 2.5e-4 on the
    # mean and 0.72 on the share, a skipped Adam step 1.4e-3 and 0.97
    # (tests/test_torch_mlp_tiles.py seeds these faults).
    b = 16384
    q4 = torch.rand((4, b, 15), generator=gen, device=dev)
    x4 = N.encode(q4.view(-1, 15), net_cfg).view(4, b, MC.LANE)
    t4 = torch.rand((4, b, 3), generator=gen, device=dev) * 2.0
    g_out = torch.randn((b, MC.OUT_PAD), generator=gen, device=dev)
    wp = [t.detach() for t in r.net_state.params.tensors()]
    got4 = MC.fused_backward_cuda(*wp, x4[0], g_out)
    ref4 = MC.fused_backward_plain(*wp, x4[0], g_out)
    # no path of the port launches K5 since K6 became one kernel: this check is
    # its one launch (the kernels line shows it as check_launches)
    got5, k5_counts = _counted(kernels, ("fused_train_grad",), lambda: MC.fused_train_grad_cuda(*wp, x4[1], t4[1]))
    check_launches = dict(k5_counts)
    ref5 = MC.fused_train_grad_plain(*wp, x4[1], t4[1])
    torch.cuda.synchronize()
    print(f"K4: {BM.check_backward(got4, ref4, wp, x4[0], g_out)}")
    print(f"K5: {BM.check_train_grad(got5, ref5)}")
    work5 = BM.mlp_work("K5", b, n_hidden)
    print(f"K4-K6: {work5['scratch_bytes']} bytes of partial sums per gradient (written and read back "
          f"once; K6's persistent kernel per step, [{MC.train4_grid(b, torch.cuda.get_device_properties(0).multi_processor_count)}, "
          f"P + 1] float32) beside the {work5['nbytes']} bytes K5's function must move")
    report["fused_backward"] = dict(
        max_abs_err=max((a - p).abs().max().item() for a, p in zip(got4, ref4)),
        ms=BI.device_ms(lambda: MC.fused_backward_cuda(*wp, x4[0], g_out)),
        plain_ms=BI.device_ms(lambda: MC.fused_backward_plain(*wp, x4[0], g_out), iters=5),
        **BM.mlp_bound("K4", b, n_hidden),
        library_ms=None,
    )
    report["fused_train_grad"] = dict(
        max_abs_err=max((a - p).abs().max().item() for a, p in zip(got5, ref5)),
        ms=BI.device_ms(lambda: MC.fused_train_grad_cuda(*wp, x4[1], t4[1])),
        plain_ms=BI.device_ms(lambda: MC.fused_train_grad_plain(*wp, x4[1], t4[1]), iters=5),
        **BM.mlp_bound("K5", b, n_hidden),
        library_ms=None,
    )
    lr = torch.tensor(net_cfg.learning_rate, device=dev)
    records = torch.tensor(b, device=dev)
    hyper = N.adam_hyper(net_cfg)

    def fresh_state():
        st = N.init_network(torch.Generator().manual_seed(3), net_cfg, dev)
        return (st.params.tensors(), st.opt.mu.tensors(), st.opt.nu.tensors(), st.ema.tensors(),
                st.opt.step)

    def flat(state):
        return [t for group in state[:4] for t in group]

    sk, sk2, sp = fresh_state(), fresh_state(), fresh_state()
    lk, k6_counts = _counted(kernels, ("fused_train4", "fused_train_grad"),
                             lambda: MC.fused_train4_cuda(*sk, x4, t4, lr, records, hyper))
    lk2 = MC.fused_train4_cuda(*sk2, x4, t4, lr, records, hyper)
    lp = MC.fused_train4_plain(*sp, x4, t4, lr, records, hyper)
    torch.cuda.synchronize()
    _check(k6_counts == {"fused_train4": 1, "fused_train_grad": 0}, f"K6 is not one kernel launch: {k6_counts}")
    loss_rel6 = ((lk - lp).abs() / lp.abs()).max().item()
    print(f"K6 losses {lk.tolist()} vs plain {lp.tolist()} ({loss_rel6:.3g} relative, limit {lim['loss']:g}); "
          f"state after 4 steps: {BM.check_train_state(flat(sk), flat(sp))}; step {int(sk[4])}")
    _check(loss_rel6 <= lim["loss"] and int(sk[4]) == int(sp[4]) == 4, "K6 disagrees with its plain version")
    print(f"K6: one kernel launch per call ({k6_counts})")
    # no atomics, partial sums added in CTA order: the same bits from run to run
    _check(torch.equal(lk, lk2) and all(torch.equal(a, c) for a, c in zip(flat(sk), flat(sk2))),
           "two runs of K6 on the same inputs differ")
    print("K6: two runs on the same inputs leave bit-equal losses, weights, moments and EMA")
    report["fused_train4"] = dict(
        max_abs_err=max((a - p).abs().max().item() for a, p in zip(flat(sk), flat(sp))),
        ms=BI.device_ms(lambda: MC.fused_train4_cuda(*sk, x4, t4, lr, records, hyper)),
        plain_ms=BI.device_ms(lambda: MC.fused_train4_plain(*sp, x4, t4, lr, records, hyper), iters=2),
        **BM.mlp_bound("K6", b, n_hidden, steps=x4.shape[0]),
        library_ms=None,
    )
    # K6 on small batches, 8 and 2 CTAs of one 128-row tile each: there K6
    # sums a step's gradient in K5's order, so it is held to CARD_LIMITS against
    # K5's kernel and the plain update composed step by step
    # (bench_mlp.train4_from_k5). Against the plain K6 the readings are printed,
    # not held: at 1000 rows K5's tensor-core sums, through four Adam steps, can
    # read above the state limits, which were set at 16,384 rows (PERF.md §7).
    for bs in (1000, 129):
        gen_b = torch.Generator(device=dev).manual_seed(bs)
        q4b = torch.rand((4, bs, 15), generator=gen_b, device=dev)
        x4b = N.encode(q4b.view(-1, 15), net_cfg).view(4, bs, MC.LANE)
        t4b = torch.rand((4, bs, 3), generator=gen_b, device=dev) * 2.0
        rec_b = torch.tensor(bs, device=dev)
        s_k, s_c, s_p = fresh_state(), fresh_state(), fresh_state()
        l_k = MC.fused_train4_cuda(*s_k, x4b, t4b, lr, rec_b, hyper)
        l_c, flat_c = BM.train4_from_k5(*s_c, x4b, t4b, lr, hyper)
        l_p = MC.fused_train4_plain(*s_p, x4b, t4b, lr, rec_b, hyper)
        torch.cuda.synchronize()

        def loss_rel(a, ref):
            return ((a - ref).abs() / ref.abs()).max().item()

        equal = torch.equal(l_k, l_c) and all(torch.equal(a, c) for a, c in zip(flat(s_k), flat_c))
        print(f"K6 at B = {bs} ({MC.train4_grid(bs, torch.cuda.get_device_properties(0).multi_processor_count)} "
              f"CTAs): against K5 + the plain update step by step: bit for bit {equal}, losses "
              f"{loss_rel(l_k, l_c):.3g} relative, {BM.check_train_state(flat(s_k), flat_c)}")
        _check(loss_rel(l_k, l_c) <= lim["loss"], f"K6 at B = {bs} disagrees with K5 + the plain update")
        for label, (ls, st) in (("K6", (l_k, flat(s_k))), ("K5 + the plain update", (l_c, flat_c))):
            mean_b, largest_b, far_b = BM.train_state_gap(st, flat(s_p))
            print(f"  {label} against the plain K6 at B = {bs} (reading, not held): losses {loss_rel(ls, l_p):.3g} "
                  f"relative (limit at 16,384 rows {lim['loss']:g}), largest mean |diff| of a tensor {mean_b:.3g} "
                  f"({lim['k6_mean']:g}), largest share beyond {lim['k6_far_at']:g}: {far_b:.3g} ({lim['k6_far']:g}), "
                  f"largest |diff| {largest_b:.3g}")

    # ---- 3b. the row gathers K7-K9: bit for bit, then timed through the tool ----
    big_scene, big_system = cornell_objects((320, 320))
    t0 = time.perf_counter()
    wide = build_wide_bvh(big_scene.p0, big_scene.p1, big_scene.p2, branch=16, leaf_size=16)
    bvh_build_s = time.perf_counter() - t0
    rb = Renderer(big_scene, big_system, render_mode=RenderMode.FULL, device=dev)
    dsb = rb.device_scene
    _check(dsb.bvh is not None and dsb.planes is None, "cornell_objects was uploaded without a BVH")
    _check(torch.equal(dsb.bvh.rows.view(torch.int32).cpu(), torch.from_numpy(wide["rows"]).view(torch.int32)),
           "the uploaded row table is not the built one, bit for bit")
    walk_table = torch.randn((131072, 160), generator=gen, device=dev)
    tables = {"walk table [131072, 160]": walk_table, "resident table [8192, 160]": walk_table[:8192].clone(),
              "BVH rows": dsb.bvh.rows, "tri_shade": dsb.tri_shade, "mat_row": dsb.mat_row,
              "tris.packed": dsb.tris.packed, "Cornell tri_shade": ds.tri_shade, "Cornell mat_row": ds.mat_row,
              "Cornell tris.packed": ds.tris.packed}
    mismatched = 0
    for label, table in tables.items():
        for count in (2048, n):
            idx = torch.randint(0, table.shape[0], (count,), generator=gen, device=dev)
            ref = GC.gather_rows_plain(table, idx).view(torch.int32)
            for variant, k in GC.VARIANTS.items():
                got = GC.gather_rows_cuda(k, table, idx).view(torch.int32)
                torch.cuda.synchronize()
                bad = int((got != ref).sum())
                _check(bad == 0, f"gather {variant} on {label} {tuple(table.shape)}, N = {count}: {bad} words differ")
                mismatched += bad
    print(f"K7-K9: bit for bit equal to the plain version on {[tuple(t.shape) for t in tables.values()]} "
          f"at N = 2048 and {n}")
    # K7's edge grid: every width, index count and table size where its work
    # split changes shape, int64 and int32 indices
    edge_launches = bench_gather.check_edges(GC.GATHER_KERNEL, dev, gen)
    print(f"K7: bit for bit equal to the plain version on the edge grid ({edge_launches} launches: widths "
          f"{bench_gather.EDGE_WIDTHS}, N {bench_gather.EDGE_NS}, table rows {bench_gather.EDGE_ROWS}, int64 and "
          f"int32 indices)")
    # the timing tool is the path that runs all three variants: counts read around it
    gather_names = ("gather_rows", "gather_rows_resident", "gather_rows_block")
    bench, bench_counts = _counted(kernels, gather_names,
                                   lambda: bench_gather.run(bench_gather.TABLES, (2048, n), iters=20))
    at_n = {res["variant"]: res for res in bench["results"] if res["n"] == n and res["table"] == "[131072, 160]"}
    for (label, width), rows in itertools.groupby(
            [r for r in bench["results"] if r["n"] == n], key=lambda r: (r["table"], r["cols"])):
        ms = {r["variant"]: r["ms"] for r in rows}
        print(f"gathers at N = {n} on {label} ({width} columns): K7 {ms['warp']:.4f}, K8 {ms['resident']:.4f}, "
              f"K9 {ms['block']:.4f}, index_select {ms['index_select']:.4f} ms"
              + ("; K7 LOSES to index_select" if ms["warp"] > ms["index_select"] else ""))
    for name, variant in zip(gather_names, ("warp", "resident", "block")):
        _check(bench_counts[name] > 0, f"{name} was not launched by bench_gather")
        # bound: bench_gather.bound_ms, the distinct rows of each index set read once
        report[name] = dict(
            max_abs_err=float(mismatched), ms=at_n[variant]["ms"], plain_ms=at_n["plain"]["ms"],
            bound_ms=at_n[variant]["bound_ms"], bound_by="bytes", library_ms=at_n["index_select"]["ms"],
        )
    fastest = min(("warp", "resident", "block"), key=lambda v: at_n[v]["ms"])
    print(f"gather variants at N = {n}: fastest {fastest}; the path launches "
          f"{next(v for v, k in GC.VARIANTS.items() if k is GC.PATH_KERNEL)}")

    # ---- 3c. the walk kernels W1/W2 on cornell_objects -------------------------
    # Against the plain walk on the card: the closest t does not depend on the
    # order of the walk, so it is equal bit for bit wherever the winners agree;
    # winners may differ only between triangles at the same t (shared edges).
    # Against K1 (every ray x every triangle, plane form), an independent
    # check: on at least 99.9 % of the rays the same winner with t within
    # 1e-4 of max(|t|, 1), as the JAX package's own walk tests compare. The
    # plane form's t = -(n.o + d0) / (n.d) cancels in its numerator, so its
    # error is absolute and grows as 1 / (n.d): a grazing ray on one of the
    # tessellated objects' small triangles reads a few 1e-4 off.
    bvh = dsb.bvh
    big_sets = BI.ray_sets(rb, lambda o, dd, tn, tf: WC.wide_traverse_cuda(o, dd, bvh, tn, tf, False)[0], gen)
    big_planes = IC.build_plane_table(dsb.tris)
    row_bytes = bvh.rows.shape[1] * 4
    w_err, w_fetched, w_plain_ms = 0.0, [], []
    for o, dd, tn, tf in big_sets["closest"]:
        tk, pk = WC.wide_traverse_cuda(o, dd, bvh, tn, tf, False)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tp, pp, fetched, distinct = _plain_walk(o, dd, bvh, tn, tf, False)
        torch.cuda.synchronize()
        w_plain_ms.append(1e3 * (time.perf_counter() - t0))
        w_fetched.append((fetched, distinct))
        same = pk == pp
        w_err = max(w_err, (tk - tp)[same].abs().max().item())
        ties = bool((tk == tp)[~same].all()) and bool(((pk >= 0) & (pp >= 0))[~same].all())
        t1, p1 = IC.closest_cuda(o, dd, big_planes, tn, tf)
        rel = (tk - t1).abs() / t1.abs().clamp(min=1.0)
        k1_agree = ((p1 == pk) & (rel <= 1e-4)).float().mean().item()
        print(f"W1 vs plain walk: winners equal on {same.float().mean().item():.6f} of rays (need >= 0.9999, the "
              f"others ties in t: {ties}), max |dt| where equal {w_err:.3g} (need 0), hit share "
              f"{(pk >= 0).float().mean().item():.4f}, {fetched} rows fetched ({distinct} distinct); vs K1: winners equal on "
              f"{(p1 == pk).float().mean().item():.6f}, and with t within 1e-4 of max(|t|, 1) on {k1_agree:.6f} "
              f"(need >= 0.999; largest {rel[p1 == pk].max().item():.3g})")
        _check(w_err == 0.0 and same.float().mean().item() >= 0.9999 and ties,
               "W1 disagrees with the plain walk")
        _check(k1_agree >= 0.999, "W1 disagrees with K1")
    a_fetched, a_plain_ms, occ_err = [], [], 0.0
    for o, dd, tn, tf in big_sets["any"]:
        _, pk = WC.wide_traverse_cuda(o, dd, bvh, tn, tf, True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, pp, fetched, distinct = _plain_walk(o, dd, bvh, tn, tf, True)
        torch.cuda.synchronize()
        a_plain_ms.append(1e3 * (time.perf_counter() - t0))
        a_fetched.append((fetched, distinct))
        agree = ((pk >= 0) == (pp >= 0)).float().mean().item()
        occ_err = max(occ_err, 1.0 - agree)
        occ1 = IC.occluded_cuda(o, dd, big_planes, tn, tf)
        print(f"W2 vs plain walk: occlusion equal on {agree:.6f} of rays (need >= 0.9999), occluded share "
              f"{(pk >= 0).float().mean().item():.4f}, {fetched} rows fetched ({distinct} distinct); vs K2: "
              f"{((pk >= 0) == occ1).float().mean().item():.6f} (need >= 0.99)")
        _check(agree >= 0.9999, "W2 disagrees with the plain walk")
        # A shadow ray starts on a surface and clears it by scene_epsilon; whether
        # it hits its own or a neighbouring small triangle again just past tmin
        # is decided by the last bits of t, where the plane form and
        # Moller-Trumbore differ (under 1 % of the rays).
        _check(((pk >= 0) == occ1).float().mean().item() >= 0.99, "W2 disagrees with K2")
    # Bound (_walk_bound): each distinct row the plain walk fetched for these
    # rays read once (the 9.4 MB table stays in the L2), the rays read and
    # the results written once; or about 45 float32 operations per triangle
    # or child box of every row fetched, whichever is larger. ``ms`` is a
    # loop of eager launches, as K1's beside it and the earlier readings;
    # ``device_ms`` the device time by CUDA-graph replay, where a walk that
    # takes less than its wrapper's host cost shows what the kernel takes.
    for name, any_hit, (o, dd, tn, tf), err, plain_ms, fetched in (
            ("wbvh_closest", False, big_sets["closest"][1], w_err, w_plain_ms[1], w_fetched[1]),
            ("wbvh_any", True, big_sets["any"][0], occ_err, a_plain_ms[0], a_fetched[0])):
        walk = functools.partial(WC.wide_traverse_cuda, o, dd, bvh, tn, tf, any_hit)
        report[name] = dict(
            max_abs_err=err, ms=_time_ms(walk), device_ms=BI.device_ms(walk), plain_ms=plain_ms,
            **_walk_bound(*fetched, row_bytes, n), library_ms=None,
        )
    k1_big_ms = _time_ms(lambda: IC.closest_cuda(*big_sets["closest"][1][:2], big_planes, *big_sets["closest"][1][2:]), iters=3, warmup=1)
    w1, w2 = report["wbvh_closest"], report["wbvh_any"]
    print(f"on {big_scene.num_triangles} triangles, {n} rays from the hit points, eager launches: W1 {w1['ms']:.3f} ms "
          f"(device time {w1['device_ms']:.4f}; plain walk {w_plain_ms[1]:.0f} ms, K1 brute force {k1_big_ms:.3f} ms); "
          f"W2 on shadow rays {w2['ms']:.3f} ms (device time {w2['device_ms']:.4f}; plain walk {a_plain_ms[0]:.0f} ms)")
    del big_planes

    # ---- 3d. the hash-grid kernels H1/H2 against their plain versions ------------
    _hash_kernels(report, gen, dev)

    # ---- 4. train_step: K3 forward + K4 backward through autograd -------------
    def train_steps():
        st = N.init_network(torch.Generator().manual_seed(4), net_cfg, dev)
        losses = []
        for k in range(4):
            st, loss = N.train_step(st, q4[k], t4[k], net_cfg, learning_rate=lr)
            losses.append(loss)
        return st, torch.stack(losses)

    (st, step_losses), path_counts = _counted(kernels, kernels, train_steps)
    torch.cuda.synchronize()
    print(f"train_step x4 (B = {b}): losses {step_losses.tolist()}, launches {path_counts}")
    _check(bool(torch.isfinite(step_losses).all()) and int(st.opt.step) == 4, "train_step failed")
    _check(path_counts["fused_forward"] > 0 and path_counts["fused_backward"] == 4,
           "train_step did not go through K3 and K4")
    launches = {}

    # ---- 4b. four hash train_steps: H1 -> K3 -> K4 (dX) -> H2 -> Adam + EMA ------
    _hash_train_steps(kernels, gen, dev, hash_cfg)

    # ---- 5. serving slice --------------------------------------------------------
    r.render_frame()
    serving = ("intersect_planes", "occluded_planes", "fused_forward", path_gather)
    full, counts = _counted(kernels, kernels, lambda: r.benchmark(8))
    img = r.image
    _check(img.shape == (n, 3) and bool(torch.isfinite(img).all()), "FULL image not finite")
    _check(img.std().item() > 0.0, "FULL image is flat")
    for name in serving:
        _check(counts[name] > 0, f"{name} was not launched by the FULL run")
    print(f"FULL 320x320 (train=False): {full['ms_per_frame']:.3f} ms/frame, {full['mrays_per_s']:.2f} "
          f"traced Mrays/s, {full['traced_rays_per_frame']:.0f} rays/frame, image mean "
          f"{img.mean().item():.4f}, launches {counts}")
    r.set_render_mode(RenderMode.NO_CACHE)
    nocache = r.benchmark(8)
    _check(bool(torch.isfinite(r.image).all()) and r.image.std().item() > 0.0, "NO_CACHE image bad")
    print(f"NO_CACHE 320x320: {nocache['ms_per_frame']:.3f} ms/frame, {nocache['mrays_per_s']:.2f} traced Mrays/s, "
          f"{nocache['traced_rays_per_frame']:.0f} rays/frame, image mean {r.image.mean().item():.4f}")

    # ---- 6. training slice: FULL + train, the main path ------------------------
    rt = Renderer(scene, system, render_mode=RenderMode.FULL, device=dev)
    sizes = BI.settle_tiles(rt)
    trained, counts = _counted(kernels, kernels, lambda: rt.benchmark(8))
    rt.flush_stats()
    for name in ("intersect_planes", "occluded_planes", "fused_forward", "fused_train4"):
        _check(counts[name] > 0, f"{name} was not launched by the FULL + train run")
    _check(counts[path_gather] > 0, f"{path_gather} was not launched by the FULL + train run")
    # K6 is one persistent kernel: it launches nothing of K5's
    _check(counts["fused_train_grad"] == 0, "the FULL + train run launched K5")
    _check(bool(torch.isfinite(rt.image).all()) and rt.image.std().item() > 0.0, "FULL + train image bad")
    records = int(rt.last_stats.num_train_records)
    print(f"FULL + train 320x320: tile sizes {sizes}, {trained['ms_per_frame']:.3f} ms/frame, "
          f"{trained['mrays_per_s']:.2f} traced Mrays/s, {trained['traced_rays_per_frame']:.0f} rays/frame, "
          f"{records} records in the last frame, loss {trained['loss']:.4f}, image mean "
          f"{rt.image.mean().item():.4f}, launches {counts}")
    print(f"FULL + train loss curve (per frame): {[round(v, 4) for v in rt.loss_history]}")
    per_frame = _replayed_launches(rt, kernels)
    _check(per_frame["fused_train4"] == 1 and per_frame["fused_train_grad"] == 0,
           f"a replayed FULL + train frame launches K6 {per_frame['fused_train4']} times and K5 "
           f"{per_frame['fused_train_grad']} times (1 and 0 expected)")
    for name, count in per_frame.items():
        if name != "fused_backward":
            launches.setdefault(name, count)
    _print_eager_and_replayed(PF, rt, "FULL + train")

    # ---- 6b. the sparse ray sets of that frame: every K1 and K2 launch recorded ----
    # The integrator launches over all lanes at every bounce and marks a dead
    # lane with an empty t range; the kernels compact the live ones. Each
    # recorded set is held against the plain version under the limits of the
    # all-live sets, and a dead lane must read RT_MAX, -1 or False.
    recorded = BI.record_frame_launches(rt)
    torch.cuda.synchronize()
    _check({kind for kind, _ in recorded} == {"K1", "K2"}, "the recorded frame did not launch K1 and K2")
    frame = {kind: dict(launches=0, lanes=0, live=0, ms=0.0, fused=0.0, unfused=0.0) for kind in ("K1", "K2")}
    for i, (kind, rays) in enumerate(recorded):
        o, dd, tn, tf = rays
        live = tf > tn
        lanes, n_live = o.shape[0], int(live.sum())
        if kind == "K1":
            tk, pk = IC.closest_cuda(o, dd, ds.planes, tn, tf)
            tp, pp = IC.closest_plain(o, dd, ds.planes, tn, tf)
            agree = (pk == pp).float().mean().item()
            both = (pk == pp) & (pk >= 0)
            rel = ((tk - tp).abs() / tp.abs())[both].max().item() if bool(both.any()) else 0.0
            dead_ok = bool((pk[~live] == -1).all()) and bool((tk[~live] == RT_MAX).all())
            _check(rel <= 1e-5, f"launch {i}: K1 t rel err {rel} > 1e-5")
            pairs = n_live * num_tris
            ms = BI.device_ms(lambda: IC.closest_cuda(o, dd, ds.planes, tn, tf))
        else:
            ok = IC.occluded_cuda(o, dd, ds.planes, tn, tf)
            op = IC.occluded_plain(o, dd, ds.planes, tn, tf)
            agree = (ok == op).float().mean().item()
            dead_ok = not bool(ok[~live].any())
            pairs = BI.pairs_to_first_hit(rays, ds.planes)
            ms = BI.device_ms(lambda: IC.occluded_cuda(o, dd, ds.planes, tn, tf))
        _check(agree >= 0.9999, f"launch {i}: {kind} disagrees with the plain version ({agree})")
        _check(dead_ok, f"launch {i}: a dead lane of {kind} does not read as a miss")
        nbytes = lanes * (32 + (12 if kind == "K1" else 1)) + table_bytes  # t f32 + prim i64, or one byte
        fused = _bound(nbytes, pairs * pair_ops, F32_OPS_PER_S)["bound_ms"]
        unfused = _bound(nbytes, pairs * pair_ops, F32_UNFUSED_OPS_PER_S)["bound_ms"]
        print(f"launch {i:2d} {kind}: {lanes} lanes, {n_live} live ({n_live / lanes:.4f}), agreement {agree:.6f}, "
              f"{ms:.4f} ms, bound {fused:.4f} ms")
        tot = frame[kind]
        tot["launches"] += 1
        tot["lanes"] += lanes
        tot["live"] += n_live
        tot["ms"] += ms
        tot["fused"] += fused
        tot["unfused"] += unfused
    for kind, tot in frame.items():
        print(f"{kind} over the frame: {tot['launches']} launches, {tot['lanes']} lanes, {tot['live']} live "
              f"({tot['live'] / tot['lanes']:.4f}); frame-weighted {tot['ms']:.4f} ms; bound of its live rays "
              f"{tot['fused']:.4f} ms at the fused multiply-add rate, {tot['unfused']:.4f} ms at the separate "
              f"multiply and add rate")
    del recorded
    # the row gathers of one eager frame: each held bit for bit, then K7's
    # frame-weighted time beside index_select's and the byte bound (each
    # distinct row a launch names read once, each gathered row written once,
    # each index read once)
    bench_gather.frame_report(rt)

    # ---- 6c. graph replay against eager frames, bit for bit -----------------------
    _replay_matches_eager(scene, _with_tiles(system, (4, 4)), dev, 12, "Cornell box")

    # ---- 6d. the hash encoding: FULL + train replayed, then against eager frames ----
    hash_frame, hash_launches = _hash_frame(scene, system, kernels, dev, PF, BI)
    launches.update({name: hash_frame[name] for name in ("hash_grid_lookup", "hash_grid_adjoint", "fused_backward")})
    for name, kind in (("hash_grid_lookup", "H1"), ("hash_grid_adjoint", "H2")):
        report[name].update(frame_ms=hash_launches[kind]["ms"]["shipped"],
                            frame_bound_ms=hash_launches[kind]["bound_ms"])
    _hash_replay_vs_eager(scene, _with_tiles(system, (4, 4)), dev, 8, "Cornell box, hash")

    # ---- 6e. the glass slice: transmission lobes, IOR stack, factoring, roulette ----
    _glass_slice(kernels, dev, BI, path_gather)
    glass_scene, glass_system = cornell_glass((320, 320))
    _replay_matches_eager(glass_scene, _with_tiles(glass_system, (4, 4)), dev, 6, "cornell_glass",
                          reflectance_factoring=True, nee_rr_tau=GLASS_TAU)
    _live_edits(dev)

    # ---- 7. the large scene: FULL + train through the wide BVH -------------------
    sizes = BI.settle_tiles(rb)
    big, counts = _counted(kernels, kernels, lambda: rb.benchmark(8))
    rb.flush_stats()
    for name in ("wbvh_closest", "wbvh_any", path_gather, "fused_forward", "fused_train4"):
        _check(counts[name] > 0, f"{name} was not launched by the large-scene run")
    for name in ("intersect_planes", "occluded_planes"):
        _check(counts[name] == 0, f"{name} was launched by the large-scene run")
    big_frame = _replayed_launches(rb, kernels)
    launches.update({name: big_frame[name] for name in ("wbvh_closest", "wbvh_any")})
    # K8 and K9 are on no path of the renderer: bench_gather's launches are their check's
    check_launches.update({name: bench_counts[name] for name in gather_names if name != path_gather})
    _check(rb.image.shape == (n, 3) and bool(torch.isfinite(rb.image).all()) and rb.image.std().item() > 0.0,
           "large-scene image bad")
    _check(math.isfinite(big["loss"]), "large-scene loss not finite")
    print(f"cornell_objects FULL + train 320x320 ({big_scene.num_triangles} triangles; BVH built on the host in "
          f"{bvh_build_s:.3f} s: W = {bvh.num_nodes} node rows, L = {bvh.rows.shape[0] - bvh.num_nodes} leaf rows, "
          f"D = {bvh.depth}, table {bvh.rows.numel() * 4} bytes): tile sizes {sizes}, "
          f"{big['ms_per_frame']:.3f} ms/frame, {big['mrays_per_s']:.2f} traced Mrays/s, "
          f"{big['traced_rays_per_frame']:.0f} rays/frame, {int(rb.last_stats.num_train_records)} records in the "
          f"last frame, loss {big['loss']:.4f}, image mean {rb.image.mean().item():.4f}, launches {counts}")
    print(f"cornell_objects loss curve (per frame): {[round(v, 4) for v in rb.loss_history]}")
    _print_eager_and_replayed(PF, rb, "cornell_objects FULL + train")

    # ---- 7b. W1/W2 over one cornell_objects frame: frame-weighted time and bound ----
    # Every W1 and W2 launch of one eager FULL + train frame recorded and
    # measured by bench_walk.measure, the measurement bench_walk makes: held
    # against the plain walk as the all-live sets are (t bit for bit), and
    # timed by CUDA-graph replay; each launch's bound is the all-live one
    # (_walk_bound) over its live rays. The frame's time and bound are sums.
    walks = {"K1": "W1", "K2": "W2"}
    wframe = {w: dict(launches=0, lanes=0, live=0, fetched=0, distinct=0, ms=0.0, bound=0.0)
              for w in walks.values()}
    shipped = {"shipped": (WC.CLOSEST_KERNEL, WC.ANYHIT_KERNEL)}
    for i, (kind, rays) in enumerate(BI.record_frame_launches(rb)):
        row = BW.measure(walks[kind], rays, bvh, shipped)
        got = row["builds"]["shipped"]
        _check(got["ok"], f"a frame's {walks[kind]} launch disagrees with the plain walk: {got}")
        tot = wframe[walks[kind]]
        tot["launches"] += 1
        for key in ("lanes", "live", "fetched", "distinct"):
            tot[key] += row[key]
        tot["ms"] += got["ms"]
        tot["bound"] += _walk_bound(row["fetched"], row["distinct"], row_bytes, row["live"])["bound_ms"]
        # a launch lasts as long as its longest chains of dependent row fetches
        f = row["fetches"]
        print(f"{walks[kind]} launch {i}: {row['lanes']} lanes, {row['live']} live rays, rows fetched a live ray by "
              f"the plain walk: mean {f['mean']:.2f}, p99 {f['p99']:.0f}, max {f['max']}; {got['ms']:.4f} ms")
    for w, tot in wframe.items():
        _check(tot["launches"] > 0, f"the recorded cornell_objects frame launched no {w}")
        print(f"{w} over one cornell_objects FULL + train frame: {tot['launches']} launches, {tot['lanes']} lanes, "
              f"{tot['live']} live, {tot['fetched']} rows fetched by the plain walk, {tot['distinct']} distinct in "
              f"their launches; frame-weighted "
              f"{tot['ms']:.4f} ms, bound {tot['bound']:.4f} ms ({100 * tot['bound'] / tot['ms']:.1f} % of it)")
    del rb
    _replay_matches_eager(big_scene, _with_tiles(big_system, (4, 4)), dev, 8, "cornell_objects")

    # ---- 8. convergence: the JAX package's Cornell oracle, both encodings ------
    _convergence(dev, net_cfg, "frequency")
    _convergence(dev, hash_cfg, "hash")

    # ---- 9. reference: the card against the CPU path on a small frame ------------
    # 8x8 tiles: 16 training rays, so the training frame has records to fit.
    # After the frame's four steps the card's weights, moments and EMA are
    # held near what they read (6e-8); a skipped EMA update of the last step
    # reads 5.6e-4 / 3.4e-4 (largest / mean), a skipped Adam step 3.0e-3 /
    # 1.8e-3 on the weights (plain version on the CPU, the same frame). The
    # frames run twice: by brute force (K1/K2), then with the wide BVH
    # attached to both sides (W1/W2 on the card, the plain walk on the CPU).
    small, small_sys = cornell_box((32, 32))
    small_sys.tile_size = (8, 8)
    configs = ((RenderMode.FULL, False), (RenderMode.NO_CACHE, False), (RenderMode.FULL, True))
    for use_bvh, (mode, train) in itertools.product((False, True), configs):
        # the same seed gives the same weights: init draws on the CPU
        rg = Renderer(small, small_sys, render_mode=mode, train=train, device=dev)
        rcpu = Renderer(small, small_sys, render_mode=mode, train=train, device="cpu")
        if use_bvh:
            rg.device_scene = upload_scene(small, dev, use_bvh=True)
            rcpu.device_scene = upload_scene(small, "cpu", use_bvh=True)
        label = f"{mode.name}{' + train' if train else ''}{', wide BVH' if use_bvh else ''}"
        _small_card_vs_cpu(rg, rcpu, label, train)
    # the glass slice's frames, by brute force: the transmission lobes, the
    # IOR stack, reflectance factoring and shadow-ray roulette, under the
    # same bounds
    glass_small, glass_small_sys = cornell_glass((32, 32))
    glass_small_sys.tile_size = (8, 8)
    for mode, train in ((RenderMode.FULL, True), (RenderMode.NO_CACHE, False)):
        label = f"cornell_glass {mode.name}{' + train' if train else ''}"
        rg, rcpu = (Renderer(glass_small, glass_small_sys, render_mode=mode, train=train, device=d,
                             reflectance_factoring=True) for d in (dev, "cpu"))
        for rr in (rg, rcpu):
            rr.cfg = dataclasses.replace(rr.cfg, nee_rr_tau=GLASS_TAU)
        _small_card_vs_cpu(rg, rcpu, label, train)
    _hash_card_vs_cpu(dev, hash_cfg)

    # ---- 10. the quality gate: FULL + train against the 4096-spp ground truth ---
    _quality_gate(dev)

    print(smi)
    # launches: per replayed FULL + train frame (W1/W2: per replayed cornell_objects
    # frame; H1, H2 and K4: per replayed hash FULL + train frame); check_launches: a
    # kernel that no path launches, its launches in its own check
    print(json.dumps({"kernels": [
        dict(name=name, route="cuda", source=f"nrc_tpu_torch/csrc/{k.source}", replaces=replaces,
             launches=launches[name], **report[name],
             **({"check_launches": check_launches[name]} if name in check_launches else {}))
        for name, (k, replaces) in kernels.items()
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
