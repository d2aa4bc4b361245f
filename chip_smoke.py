#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``nrc_tpu_torch/``) on one NVIDIA card.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA card, ``nvcc`` (``$CUDA_HOME/bin`` or on ``PATH``) and no network.

Phases, each of which raises on failure (non-zero exit):
1. device: the card's name and power limit as ``nvidia-smi`` reports them;
2. build: compile every kernel of the serving path from ``csrc/``;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the shapes the 320x320 Cornell frame gives it, with times (CUDA events);
4. slice: ``Renderer`` on the 1224-triangle Cornell box at 320x320, FULL
   then NO_CACHE, ``train=False``, frequency encoding 64x5 from a seeded
   init, 8 timed frames each; every kernel must have been launched by the
   FULL run;
5. reference: a 32x32 frame on the card against the same frame on the CPU,
   where the port runs the plain versions the CPU tests check against JAX.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.
"""

import json
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    # the port must be importable from here (run from the checkout's root)
    from nrc_tpu_torch.config import RenderMode
    from nrc_tpu_torch.ops import intersect_cuda as IC
    from nrc_tpu_torch.ops import mlp_cuda as MC
    from nrc_tpu_torch.ops.intersect import RT_MAX
    from nrc_tpu_torch.render.frame import pixel_grid
    from nrc_tpu_torch.render.renderer import Renderer
    from nrc_tpu_torch.scene.camera import generate_primary_rays
    from nrc_tpu_torch.scene.scene_builder import cornell_box
    from nrc_tpu_torch.utils import rng as R

    # plain references in full float32 (PyTorch's defaults, stated here)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    # ---- 1. device ---------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"device: {torch.cuda.get_device_name(0)} | torch {torch.__version__} cuda {torch.version.cuda}")
    print(smi)

    # ---- 2. build ------------------------------------------------------------
    kernels = {
        "intersect_planes": (IC.CLOSEST_KERNEL, "nrc_tpu/ops/intersect_pallas.py:185"),
        "occluded_planes": (IC.ANYHIT_KERNEL, "nrc_tpu/ops/intersect_pallas.py:240"),
        "fused_forward": (MC.FORWARD_KERNEL, "nrc_tpu/ops/mlp_pallas.py:81"),
    }
    for name, (k, _) in kernels.items():
        t0 = time.perf_counter()
        log = k.build()
        info = [ln.strip() for ln in log.splitlines() if "ptxas info" in ln and ("Used" in ln or "spill" in ln)]
        print(f"build {name}: {k.source} in {time.perf_counter() - t0:.1f} s; " + " | ".join(info))

    # ---- 3. kernels against their plain versions, at main-path shapes --------
    scene, system = cornell_box((320, 320))
    r = Renderer(scene, system, render_mode=RenderMode.FULL, device=dev)
    ds = r.device_scene
    n = r.cfg.num_pixels
    pix, pidx = pixel_grid(r.cfg, dev)
    _, jitter = R.rng2(R.tea(pidx, 0))
    org, d = generate_primary_rays(pix, jitter, (320, 320), *r._camera_arrays())
    zeros = torch.zeros(n, device=dev)
    far = torch.full((n,), RT_MAX, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    t_cam, _ = IC.closest_plain(org, d, ds.planes, zeros, far)
    p_hit = (org + t_cam[:, None] * d).contiguous()
    d2 = torch.randn((n, 3), generator=gen, device=dev)
    d2 = (d2 / d2.norm(dim=-1, keepdim=True)).contiguous()
    eps = torch.full((n,), r.cfg.scene_epsilon, device=dev)
    # shadow rays to random points on the ceiling light, and random segments
    pool = ds.lights.mesh_row
    light = pool[torch.randint(0, pool.shape[0], (n,), generator=gen, device=dev)]
    uv = torch.rand((n, 2), generator=gen, device=dev)
    su = uv[:, :1].sqrt()
    target = (1 - su) * light[:, 0:3] + uv[:, 1:] * su * light[:, 3:6] + (su - uv[:, 1:] * su) * light[:, 6:9]
    to_light = target - p_hit
    dist = to_light.norm(dim=-1)
    sets = {
        "closest": [(org, d, zeros, far), (p_hit, d2, eps, far)],
        "any": [(p_hit, (to_light / dist[:, None]).contiguous(), eps, (dist - r.cfg.scene_epsilon).contiguous()),
                (p_hit, d2, eps, torch.rand((n,), generator=gen, device=dev) * 25.0)],
    }
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
    o, dd, tn, tf = sets["closest"][1]
    report["intersect_planes"] = dict(
        max_abs_err=t_err,
        ms=_time_ms(lambda: IC.closest_cuda(o, dd, ds.planes, tn, tf)),
        plain_ms=_time_ms(lambda: IC.closest_plain(o, dd, ds.planes, tn, tf), iters=5),
    )
    o, dd, tn, tf = sets["any"][0]
    occ_k = IC.occluded_cuda(o, dd, ds.planes, tn, tf)
    occ_p = IC.occluded_plain(o, dd, ds.planes, tn, tf)
    report["occluded_planes"] = dict(
        max_abs_err=(occ_k.float() - occ_p.float()).abs().max().item(),
        ms=_time_ms(lambda: IC.occluded_cuda(o, dd, ds.planes, tn, tf)),
        plain_ms=_time_ms(lambda: IC.occluded_plain(o, dd, ds.planes, tn, tf), iters=5),
    )

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
    report["fused_forward"] = dict(
        max_abs_err=(yk - yp).abs().max().item(),
        ms=_time_ms(lambda: MC.fused_forward_cuda(*w, x, True)),
        plain_ms=_time_ms(lambda: MC.fused_forward_plain(*w, x, True)),
    )

    # ---- 4. the slice ----------------------------------------------------------
    r.render_frame()
    for k, _ in kernels.values():
        k.launches = 0
    full = r.benchmark(8)
    launches = {name: k.launches for name, (k, _) in kernels.items()}
    img = r.image
    _check(img.shape == (n, 3) and bool(torch.isfinite(img).all()), "FULL image not finite")
    _check(img.std().item() > 0.0, "FULL image is flat")
    for name, count in launches.items():
        _check(count > 0, f"{name} was not launched by the FULL run")
    print(f"FULL 320x320: {full['ms_per_frame']:.3f} ms/frame, {full['mrays_per_s']:.2f} traced Mrays/s, "
          f"{full['traced_rays_per_frame']:.0f} rays/frame, image mean {img.mean().item():.4f}, "
          f"launches {launches}")
    r.set_render_mode(RenderMode.NO_CACHE)
    nocache = r.benchmark(8)
    _check(bool(torch.isfinite(r.image).all()) and r.image.std().item() > 0.0, "NO_CACHE image bad")
    print(f"NO_CACHE 320x320: {nocache['ms_per_frame']:.3f} ms/frame, {nocache['mrays_per_s']:.2f} traced Mrays/s, "
          f"{nocache['traced_rays_per_frame']:.0f} rays/frame, image mean {r.image.mean().item():.4f}")

    # ---- 5. reference: the card against the CPU path on a small frame ------------
    small, small_sys = cornell_box((32, 32))
    for mode in (RenderMode.FULL, RenderMode.NO_CACHE):
        # the same seed gives the same weights: init draws on the CPU
        rg = Renderer(small, small_sys, render_mode=mode, device=dev)
        rc = Renderer(small, small_sys, render_mode=mode, device="cpu")
        rg.render(1)
        rc.render(1)
        close, mean_gap = _image_agreement(rg.image.cpu(), rc.image)
        print(f"32x32 {mode.name} card vs CPU: {close:.4f} of pixels within 1e-3, means {mean_gap:.2e} apart")
        _check(close >= 0.98 and mean_gap < 1e-3, f"{mode.name}: the card disagrees with the CPU path")

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
