#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``nrc_tpu_torch/``) on one NVIDIA card.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA card, ``nvcc`` (``$CUDA_HOME/bin`` or on ``PATH``) and no network.

Phases, each of which raises on failure (non-zero exit):
1. device: the card's name and power limit as ``nvidia-smi`` reports them;
2. build: compile every kernel (K1-K9, W1, W2) from ``csrc/``, one ``nvcc``
   per source file, all started together, and the native host library;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the shapes the 320x320 frames give it (B = 16384 training rows,
   [4, 16384] for K6), with times (CUDA events), the least time the card
   could take for the same work (``bound_ms``) and, for the gathers, the
   time of ``torch.index_select``. The row gathers K7-K9 bit for bit on the
   walk's [131072, 160] table and on the path's other widths; the walk
   kernels W1/W2 on the 132 K-triangle ``cornell_objects`` scene against the
   plain walk, and W1 against the brute-force K1;
4. train_step: four ``train_step``s on the card, K3 forward + K4 backward
   through autograd;
5. serving slice: ``Renderer`` on the 1224-triangle Cornell box at 320x320,
   FULL then NO_CACHE, ``train=False``, frequency encoding 64x5 from a seeded
   init, 8 timed frames each;
6. training slice: FULL + train at 320x320 (the main path): frames until the
   adaptive tile size settles, then 8 timed frames; then one more frame with
   the inputs of every K1 and K2 launch recorded (lanes and live lanes of each
   are printed), K1 and K2 held against their plain versions on each recorded
   set, dead lanes included, and timed on it: the sum over the frame's
   launches is the frame-weighted time, beside the bound of its live rays;
7. large scene: FULL + train at 320x320 on ``cornell_objects`` (the wide
   BVH path): frames until the tile size settles, then 8 timed frames; W1,
   W2 and the path's gather must run, K1 and K2 must not;
8. convergence: the JAX package's online-training oracle
   (``tests/test_frame.py:92-139``) on the port's Cornell box at 64x64 with
   8x8 tiles: the loss falls over 40 frames, and after a restart 48 FULL +
   train frames come within 18 dB (tonemapped PSNR) of 48-spp NO_CACHE;
9. reference: 32x32 frames (8x8 tiles) on the card against the same frames
   on the CPU, where the port runs the plain versions the CPU tests check
   against JAX; after the training frame, the weights, moments and EMA too.
   Once by brute force and once with the wide BVH attached.

Every path that runs a kernel is driven with the launch counts set to 0 just
before it and read just after; each kernel must have been launched there.
The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.
"""

import concurrent.futures
import itertools
import json
import math
import subprocess
import sys
import time


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


def _rel(got, ref) -> float:
    """Largest difference relative to the reference's largest entry."""
    return ((got - ref).abs().max() / ref.abs().max().clamp(min=1e-30)).item()


# NVIDIA's data sheet for the H100 SXM: the rates the bounds are taken against
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12     # float32 outside the tensor cores, a fused multiply-add counted as two
F32_UNFUSED_OPS_PER_S = 33.5e12  # the same lanes issuing separate multiplies and adds
BF16_OPS_PER_S = 989e12   # dense bf16 on the tensor cores


def _bound(nbytes, ops, ops_per_s):
    """The least time the card could take: each input byte read once and each
    output byte written once, or the operations at the peak rate of their
    type, whichever is larger."""
    by_bytes, by_ops = 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * ops / ops_per_s
    return dict(bound_ms=max(by_bytes, by_ops), bound_by="bytes" if by_bytes >= by_ops else "operations")


def _counted(kernels, names, fn):
    """Run fn with the named kernels' counts set to 0; return (result, counts)."""
    for name in names:
        kernels[name][0].launches = 0
    out = fn()
    return out, {name: kernels[name][0].launches for name in names}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    # the port must be importable from here (run from the checkout's root)
    from nrc_tpu_torch.config import NetworkConfig, RenderMode
    from nrc_tpu_torch.models import network as N
    from nrc_tpu_torch.native import get_lib
    from nrc_tpu_torch.ops import gather_cuda as GC
    from nrc_tpu_torch.ops import intersect_cuda as IC
    from nrc_tpu_torch.ops import intersect_wide as IW
    from nrc_tpu_torch.ops import intersect_wide_cuda as WC
    from nrc_tpu_torch.ops import mlp_cuda as MC
    from nrc_tpu_torch.ops.bvh_wide import build_wide_bvh
    from nrc_tpu_torch.ops.intersect import RT_MAX
    from nrc_tpu_torch.render.renderer import Renderer
    from nrc_tpu_torch.render.scene_device import upload_scene
    from nrc_tpu_torch.scene.scene_builder import cornell_box, cornell_objects
    from nrc_tpu_torch.tools import bench_gather
    from nrc_tpu_torch.tools import bench_intersect as BI
    from nrc_tpu_torch.utils.tonemap import tonemap

    # plain references in full float32 (PyTorch's defaults, stated here)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    net_cfg = NetworkConfig()

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
    }
    path_gather = next(name for name, (k, _) in kernels.items() if k is GC.PATH_KERNEL)
    first_of_source = {}
    for name, (k, _) in kernels.items():
        first_of_source.setdefault((k.source, k.extra_flags), name)

    def build(name):
        t0 = time.perf_counter()
        log = kernels[name][0].build()
        info = [ln.strip() for ln in log.splitlines() if "ptxas info" in ln and ("Used" in ln or "spill" in ln)]
        return f"build {kernels[name][0].source} in {time.perf_counter() - t0:.1f} s; " + " | ".join(info)

    def build_native(_):
        t0 = time.perf_counter()
        _check(get_lib() is not None, "the native host library did not build")
        return f"build native/nrc_native.c in {time.perf_counter() - t0:.1f} s"

    t_build = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(first_of_source) + 1) as pool:
        native = pool.submit(build_native, None)
        for line in pool.map(build, first_of_source.values()):
            print(line)
        print(native.result())
    for k, _ in kernels.values():
        k.build()  # the other entry points of the built libraries
    print(f"build: all kernels in {time.perf_counter() - t_build:.1f} s")

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
    yk = MC.fused_forward_cuda(*w, x, True)
    yp = MC.fused_forward_plain(*w, x, True)
    torch.cuda.synchronize()
    torch.testing.assert_close(yk, yp, atol=1e-2, rtol=1e-2)  # bf16 operands
    print(f"K3 max |err| {(yk - yp).abs().max().item():.3g} (atol 1e-2, rtol 1e-2)")
    # Bounds of K3-K6. One multiply-add per weight and row in a forward pass
    # (bf16 operands: the tensor cores' bf16 rate), as many again for the
    # gradient of the activations and for that of the weights. Bytes: the
    # rows read (x, and g or the targets), the rows written (y or dX), and the
    # weights, gradients and optimizer state once each.
    macs = sum(t.numel() for t in w)
    w_bytes = 4 * macs
    report["fused_forward"] = dict(
        max_abs_err=(yk - yp).abs().max().item(),
        ms=_time_ms(lambda: MC.fused_forward_cuda(*w, x, True)),
        plain_ms=_time_ms(lambda: MC.fused_forward_plain(*w, x, True)),
        **_bound(4 * (x.numel() + yk.numel()) + w_bytes, 2 * macs * n, BF16_OPS_PER_S),
        library_ms=None,
    )

    # K4-K6 at the training batch of a frame: 4 x 16384 encoded queries.
    # Gradients are compared relative to their largest entry. In K4 an
    # activation next to a bf16 rounding boundary rounds one bf16 ulp apart
    # when the sums run in another order (reads 9.6e-4; limit 2e-3). K5 and
    # K6 are held near what they read (K5 9.1e-7, K6's state 5.4e-7 at most
    # and 3.4e-9 on the mean after four steps): a skipped EMA update of the
    # last step reads 5.6e-4 / 2.5e-4 there, a skipped Adam step 3.0e-3 /
    # 1.4e-3 on the weights.
    b = 16384
    q4 = torch.rand((4, b, 15), generator=gen, device=dev)
    x4 = N.encode(q4.view(-1, 15), net_cfg).view(4, b, MC.LANE)
    t4 = torch.rand((4, b, 3), generator=gen, device=dev) * 2.0
    g_out = torch.randn((b, MC.OUT_PAD), generator=gen, device=dev)
    wp = [t.detach() for t in r.net_state.params.tensors()]
    got4 = MC.fused_backward_cuda(*wp, x4[0], g_out)
    ref4 = MC.fused_backward_plain(*wp, x4[0], g_out)
    got5 = MC.fused_train_grad_cuda(*wp, x4[1], t4[1])
    ref5 = MC.fused_train_grad_plain(*wp, x4[1], t4[1])
    torch.cuda.synchronize()
    rel4 = max(_rel(a, p) for a, p in zip(got4, ref4))
    rel5 = max(_rel(a, p) for a, p in zip(got5[1:], ref5[1:]))
    loss_rel5 = abs(got5[0].item() / ref5[0].item() - 1.0)
    print(f"K4 largest gradient error {rel4:.3g} of the largest entry (limit 2e-3); "
          f"K5 {rel5:.3g} (limit 1e-5), loss {loss_rel5:.3g} relative (limit 1e-5)")
    _check(rel4 <= 2e-3, "K4 disagrees with its plain version")
    _check(rel5 <= 1e-5 and loss_rel5 <= 1e-5, "K5 disagrees with its plain version")
    # K4: forward again, dX down to the input, dW. K5: forward, dX of every
    # layer but the first (nothing consumes it), dW. K6: four times K5, and
    # the weights, both moments and the EMA read and written once.
    macs_first = wp[0].numel()
    k5_ops = 2 * (3 * macs - macs_first) * b
    k5_bytes = 4 * (x4[1].numel() + t4[1].numel() + 1) + 2 * w_bytes
    report["fused_backward"] = dict(
        max_abs_err=max((a - p).abs().max().item() for a, p in zip(got4, ref4)),
        ms=_time_ms(lambda: MC.fused_backward_cuda(*wp, x4[0], g_out)),
        plain_ms=_time_ms(lambda: MC.fused_backward_plain(*wp, x4[0], g_out)),
        **_bound(4 * (2 * x4[0].numel() + g_out.numel()) + 2 * w_bytes, 2 * 3 * macs * b, BF16_OPS_PER_S),
        library_ms=None,
    )
    report["fused_train_grad"] = dict(
        max_abs_err=max((a - p).abs().max().item() for a, p in zip(got5, ref5)),
        ms=_time_ms(lambda: MC.fused_train_grad_cuda(*wp, x4[1], t4[1])),
        plain_ms=_time_ms(lambda: MC.fused_train_grad_plain(*wp, x4[1], t4[1])),
        **_bound(k5_bytes, k5_ops, BF16_OPS_PER_S),
        library_ms=None,
    )
    lr = torch.tensor(net_cfg.learning_rate, device=dev)
    records = torch.tensor(b, device=dev)
    hyper = N.adam_hyper(net_cfg)

    def fresh_state():
        st = N.init_network(torch.Generator().manual_seed(3), net_cfg, dev)
        return (st.params.tensors(), st.opt.mu.tensors(), st.opt.nu.tensors(), st.ema.tensors(),
                st.opt.step)

    sk, sp = fresh_state(), fresh_state()
    lk = MC.fused_train4_cuda(*sk, x4, t4, lr, records, hyper)
    lp = MC.fused_train4_plain(*sp, x4, t4, lr, records, hyper)
    torch.cuda.synchronize()
    loss_rel6 = ((lk - lp).abs() / lp.abs()).max().item()
    dmax = max((a - p).abs().max().item() for ga, gp in zip(sk[:4], sp[:4]) for a, p in zip(ga, gp))
    dmean = max((a - p).abs().mean().item() for ga, gp in zip(sk[:4], sp[:4]) for a, p in zip(ga, gp))
    print(f"K6 losses {lk.tolist()} vs plain {lp.tolist()} ({loss_rel6:.3g} relative, limit 1e-5); "
          f"state after 4 steps: largest |diff| {dmax:.3g} (limit 1e-5), "
          f"largest mean |diff| {dmean:.3g} (limit 1e-7); step {int(sk[4])}")
    _check(loss_rel6 <= 1e-5 and dmax <= 1e-5 and dmean <= 1e-7
           and int(sk[4]) == int(sp[4]) == 4, "K6 disagrees with its plain version")
    report["fused_train4"] = dict(
        max_abs_err=dmax,
        ms=_time_ms(lambda: MC.fused_train4_cuda(*sk, x4, t4, lr, records, hyper), iters=10),
        plain_ms=_time_ms(lambda: MC.fused_train4_plain(*sp, x4, t4, lr, records, hyper), iters=5),
        **_bound(4 * (x4.numel() + t4.numel() + 4) + 8 * w_bytes, 4 * k5_ops, BF16_OPS_PER_S),
        library_ms=None,
    )


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
    tables = {"walk table [131072, 160]": walk_table, "BVH rows": dsb.bvh.rows, "tri_shade": dsb.tri_shade,
              "mat_row": dsb.mat_row, "tris.packed": dsb.tris.packed}
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
    # the timing tool is the path that runs all three variants: counts read around it
    gather_names = ("gather_rows", "gather_rows_resident", "gather_rows_block")
    bench, bench_counts = _counted(kernels, gather_names, lambda: bench_gather.run(131072, 160, (2048, n), iters=20))
    at_n = {res["variant"]: res for res in bench["results"] if res["n"] == n}
    for name, variant in zip(gather_names, ("warp", "resident", "block")):
        _check(bench_counts[name] > 0, f"{name} was not launched by bench_gather")
        report[name] = dict(
            max_abs_err=float(mismatched), ms=at_n[variant]["ms"], plain_ms=at_n["plain"]["ms"],
            **_bound(2 * n * 160 * 4 + n * 8, 0, F32_OPS_PER_S), library_ms=at_n["index_select"]["ms"],
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
        tp, pp, fetched = IW.wide_traverse_plain(o, dd, bvh, tn, tf, False)
        torch.cuda.synchronize()
        w_plain_ms.append(1e3 * (time.perf_counter() - t0))
        w_fetched.append(fetched)
        same = pk == pp
        w_err = max(w_err, (tk - tp)[same].abs().max().item())
        ties = bool((tk == tp)[~same].all()) and bool(((pk >= 0) & (pp >= 0))[~same].all())
        t1, p1 = IC.closest_cuda(o, dd, big_planes, tn, tf)
        rel = (tk - t1).abs() / t1.abs().clamp(min=1.0)
        k1_agree = ((p1 == pk) & (rel <= 1e-4)).float().mean().item()
        print(f"W1 vs plain walk: winners equal on {same.float().mean().item():.6f} of rays (need >= 0.9999, the "
              f"others ties in t: {ties}), max |dt| where equal {w_err:.3g} (need 0), hit share "
              f"{(pk >= 0).float().mean().item():.4f}, {fetched} rows fetched; vs K1: winners equal on "
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
        _, pp, fetched = IW.wide_traverse_plain(o, dd, bvh, tn, tf, True)
        torch.cuda.synchronize()
        a_plain_ms.append(1e3 * (time.perf_counter() - t0))
        a_fetched.append(fetched)
        agree = ((pk >= 0) == (pp >= 0)).float().mean().item()
        occ_err = max(occ_err, 1.0 - agree)
        occ1 = IC.occluded_cuda(o, dd, big_planes, tn, tf)
        print(f"W2 vs plain walk: occlusion equal on {agree:.6f} of rays (need >= 0.9999), occluded share "
              f"{(pk >= 0).float().mean().item():.4f}, {fetched} rows fetched; vs K2: "
              f"{((pk >= 0) == occ1).float().mean().item():.6f} (need >= 0.99)")
        _check(agree >= 0.9999, "W2 disagrees with the plain walk")
        # A shadow ray starts on a surface and clears it by scene_epsilon; whether
        # it hits its own or a neighbouring small triangle again just past tmin
        # is decided by the last bits of t, where the plane form and
        # Moller-Trumbore differ (under 1 % of the rays).
        _check(((pk >= 0) == occ1).float().mean().item() >= 0.99, "W2 disagrees with K2")
    # Bound: the rows the plain walk fetched for these rays (the table's 10 MB
    # stay in the L2, so this bound is loose), the rays read and the results
    # written once; about 45 float32 operations per triangle or child box of
    # a fetched row, which stays far below the bytes.
    o, dd, tn, tf = big_sets["closest"][1]
    report["wbvh_closest"] = dict(
        max_abs_err=w_err, ms=_time_ms(lambda: WC.wide_traverse_cuda(o, dd, bvh, tn, tf, False)),
        plain_ms=w_plain_ms[1],
        **_bound(w_fetched[1] * row_bytes + n * (32 + 8), w_fetched[1] * 16 * 45, F32_OPS_PER_S), library_ms=None,
    )
    o, dd, tn, tf = big_sets["any"][0]
    report["wbvh_any"] = dict(
        max_abs_err=occ_err, ms=_time_ms(lambda: WC.wide_traverse_cuda(o, dd, bvh, tn, tf, True)),
        plain_ms=a_plain_ms[0],
        **_bound(a_fetched[0] * row_bytes + n * (32 + 8), a_fetched[0] * 16 * 45, F32_OPS_PER_S), library_ms=None,
    )
    k1_big_ms = _time_ms(lambda: IC.closest_cuda(*big_sets["closest"][1][:2], big_planes, *big_sets["closest"][1][2:]), iters=3, warmup=1)
    print(f"on {big_scene.num_triangles} triangles, {n} rays from the hit points: W1 {report['wbvh_closest']['ms']:.3f} ms "
          f"(plain walk {w_plain_ms[1]:.0f} ms, K1 brute force {k1_big_ms:.3f} ms); W2 on shadow rays "
          f"{report['wbvh_any']['ms']:.3f} ms (plain walk {a_plain_ms[0]:.0f} ms)")
    del big_planes

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
    launches = {"fused_backward": path_counts["fused_backward"]}

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
    for name in ("intersect_planes", "occluded_planes", "fused_forward", "fused_train_grad", "fused_train4"):
        _check(counts[name] > 0, f"{name} was not launched by the FULL + train run")
        launches[name] = counts[name]
    _check(counts[path_gather] > 0, f"{path_gather} was not launched by the FULL + train run")
    # K5's gradient kernel runs inside K6, once per step, counted where K6 launches it
    _check(counts["fused_train_grad"] == 4 * counts["fused_train4"], "K6 did not launch K5 four times")
    _check(bool(torch.isfinite(rt.image).all()) and rt.image.std().item() > 0.0, "FULL + train image bad")
    records = int(rt.last_stats.num_train_records)
    print(f"FULL + train 320x320: tile sizes {sizes}, {trained['ms_per_frame']:.3f} ms/frame, "
          f"{trained['mrays_per_s']:.2f} traced Mrays/s, {trained['traced_rays_per_frame']:.0f} rays/frame, "
          f"{records} records in the last frame, loss {trained['loss']:.4f}, image mean "
          f"{rt.image.mean().item():.4f}, launches {counts}")
    print(f"FULL + train loss curve (per frame): {[round(v, 4) for v in rt.loss_history]}")

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

    # ---- 7. the large scene: FULL + train through the wide BVH -------------------
    sizes = BI.settle_tiles(rb)
    big, counts = _counted(kernels, kernels, lambda: rb.benchmark(8))
    rb.flush_stats()
    for name in ("wbvh_closest", "wbvh_any", path_gather, "fused_forward", "fused_train_grad", "fused_train4"):
        _check(counts[name] > 0, f"{name} was not launched by the large-scene run")
    for name in ("intersect_planes", "occluded_planes"):
        _check(counts[name] == 0, f"{name} was launched by the large-scene run")
    launches.update({name: counts[name] for name in ("wbvh_closest", "wbvh_any", path_gather)})
    launches.update({name: bench_counts[name] for name in gather_names if name != path_gather})
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

    # ---- 8. convergence: the JAX package's Cornell oracle ----------------------
    small, small_sys = cornell_box((64, 64))
    small_sys.tile_size = (8, 8)
    rc = Renderer(small, small_sys, render_mode=RenderMode.FULL, adaptive_tiles=False, device=dev)
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
    print(f"convergence 64x64: loss {early:.4f} (first 2) -> {late:.4f} (last 10 of 40), limit "
          f"{0.9 * early:.4f}; FULL + train vs 48-spp NO_CACHE: {psnr:.2f} dB tonemapped (limit 18)")
    print(f"convergence loss curve: {[round(v, 4) for v in losses]}")
    _check(late < 0.9 * early, "the loss did not fall")
    _check(psnr > 18.0, "FULL + train is too far from the NO_CACHE oracle")

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
        sg, sc = rg.render(1), rcpu.render(1)
        close, mean_gap = _image_agreement(rg.image.cpu(), rcpu.image)
        label = f"{mode.name}{' + train' if train else ''}{', wide BVH' if use_bvh else ''}"
        print(f"32x32 {label} card vs CPU: {close:.4f} of pixels within 1e-3, means {mean_gap:.2e} apart")
        _check(close >= 0.98 and mean_gap < 1e-3, f"{label}: the card disagrees with the CPU path")
        if train:
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
                   "FULL + train: the card's training disagrees with the CPU path")

    print(smi)
    print(json.dumps({"kernels": [
        dict(name=name, route="cuda", source=f"nrc_tpu_torch/csrc/{k.source}", replaces=replaces,
             launches=launches[name], **report[name])
        for name, (k, replaces) in kernels.items()
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
