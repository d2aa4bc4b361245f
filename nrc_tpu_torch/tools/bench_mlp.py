"""Device times of the cache MLP's kernels K3-K6 on the card, what the card
could do at best, and the limits their checks hold them to.

Run from the root of a checkout on a machine with one CUDA card:

    python3 -m nrc_tpu_torch.tools.bench_mlp

Times the fused forward K3 at 102,400 rows (a 320x320 frame's render
queries) and on the joint batch that a settled Cornell FULL + train frame
really hands it (render queries and the training rays' ends, recorded from
one frame through ``ops.mlp_cuda.fused_forward``), the backward K4 and the
training gradient K5 at 16,384 rows, and the four-step trainer K6 at
[4, 16,384], each beside its plain PyTorch version and beside the least time
the card could take (``mlp_bound``: the function's own bytes over 3.35 TB/s
or its operations over 989 TFLOP/s, whichever is larger; the per-CTA partial
sums that the gradient kernels write and read back are this implementation's
traffic, not the function's, and are printed apart as ``scratch_bound_ms``).
Times are device times: ten calls captured in a CUDA graph and replayed
(``bench_intersect.device_ms``), so the wrappers' host cost and the launch
pace are left out; the wrapper's allocations are inside. The tool uses
nothing but the wrappers' signatures and the plain versions' helpers, so the
same file times an older tree's kernels when it is run from that tree.

Then the noise survey, from which ``CARD_LIMITS`` below were set: for ten
seeds, K4 and K5 at 16,384, 1000, 129, 16 and 15 rows and K6 at [4, 16,384]
against their plain versions: mean and largest difference of every gradient
in units of its largest entry, the rows of K4's dX with an entry far off and
the flipped ReLU mask bits that explain each of them (``explain_off_rows``),
and K6's state by tensor. The survey reports and asserts nothing;
``check_backward``, ``check_train_grad`` and ``check_train_state`` are what
``chip_smoke.py`` and ``tests/test_torch_cuda.py`` assert with. The last
line is one JSON object with the card's name and power limit.
"""

from __future__ import annotations

import json
import subprocess

import torch

from ..config import NetworkConfig, RenderMode
from ..models import network as N
from ..ops import mlp_cuda as MC
from ..render.renderer import Renderer
from ..scene.scene_builder import cornell_box
from .bench_intersect import device_ms, settle_tiles

RES = 320
TRAIN_ROWS = 16384
# NVIDIA's data sheet for the H100 SXM
HBM_BYTES_PER_S = 3.35e12
BF16_OPS_PER_S = 989e12   # dense bf16 on the tensor cores


# ---------------------------------------------------------------------------
# the least the card could take
# ---------------------------------------------------------------------------

def mlp_work(kernel: str, rows: int, n_hidden: int, steps: int = 4) -> dict:
    """What the function of ``kernel`` ("K3" .. "K6") needs on ``rows`` rows
    (K6: ``steps`` batches of ``rows``): ``nbytes``, every input read once and
    every output written once; ``ops``, one multiply-add (two operations) per
    weight and row in a forward pass, as many again for the gradient of the
    activations and for that of the weights; and ``scratch_bytes``, the
    partial sums of dW that this implementation moves on top (the price of a
    sum in a fixed order, no part of the function).

    K3: x in, y out, the weights. K4: x and g in, dX out, the weights in and
    their gradients out. K5: x and the targets in, the loss, the weights in
    and their gradients out; no dX of the first layer (nothing consumes it).
    K6: ``steps`` times K5's rows and operations, and the weights, both
    moments and the EMA read and written once."""
    macs = MC.num_params(n_hidden)
    w_bytes = 4 * macs
    k5_ops = 2 * (3 * macs - MC.LANE * MC.WIDTH) * rows
    # per-CTA partial sums [CTAs, P + 1] float32, written by a gradient
    # kernel and read back by its reduction
    scratch = 2 * 4 * (-(-rows // MC.GRAD_ROWS)) * (macs + 1)
    if kernel == "K3":
        return dict(nbytes=4 * rows * (MC.LANE + MC.OUT_PAD) + w_bytes, ops=2 * macs * rows, scratch_bytes=0)
    if kernel == "K4":
        return dict(nbytes=4 * rows * (2 * MC.LANE + MC.OUT_PAD) + 2 * w_bytes, ops=2 * 3 * macs * rows,
                    scratch_bytes=scratch)
    if kernel == "K5":
        return dict(nbytes=4 * (rows * (MC.LANE + 3) + 1) + 2 * w_bytes, ops=k5_ops, scratch_bytes=scratch)
    if kernel == "K6":
        return dict(nbytes=4 * steps * (rows * (MC.LANE + 3) + 1) + 8 * w_bytes, ops=steps * k5_ops,
                    scratch_bytes=steps * scratch)
    raise ValueError(f"unknown kernel {kernel}")


def mlp_bound(kernel: str, rows: int, n_hidden: int, steps: int = 4) -> dict:
    """``bound_ms`` and ``bound_by`` of ``mlp_work``'s bytes and operations,
    and ``scratch_bound_ms``: the time the scratch traffic alone would take
    from device memory (it fits the 50 MB L2, so it may take less)."""
    work = mlp_work(kernel, rows, n_hidden, steps)
    by_bytes, by_ops = 1e3 * work["nbytes"] / HBM_BYTES_PER_S, 1e3 * work["ops"] / BF16_OPS_PER_S
    return dict(bound_ms=max(by_bytes, by_ops), bound_by="bytes" if by_bytes >= by_ops else "operations",
                scratch_bound_ms=1e3 * work["scratch_bytes"] / HBM_BYTES_PER_S)


# ---------------------------------------------------------------------------
# the limits of the card's checks
# ---------------------------------------------------------------------------

# What chip_smoke.py and tests/test_torch_cuda.py hold the kernels to against
# their plain versions on the card, and tests/test_torch_mlp_tiles.py holds
# against seeded faults. Gradients are read in units of the reference's
# largest entry, K6's state in absolute units. The largest difference is a
# limit only where it measures the kernel: the tensor cores sum in another
# order than the plain version's products, and two things follow. An
# activation next to a bf16 rounding boundary rounds one ulp apart and, a
# layer later, a pre-activation near zero changes sign: that flips a ReLU mask
# bit in 1-4 of 16,384 rows, changes that row's gradient in full (K4's dX
# reads up to 1e-1 of the largest entry there) and every dW entry the row
# feeds. And a gradient entry next to a rounding boundary rounds one ulp apart
# itself: about ten rows of 16,384 then differ by up to 2^-7 of their own
# largest entry. Through Adam's normalised step a gradient entry near zero
# turns into a step of +-lr (K6's weights read up to 5.2e-3 apart in under
# 0.15 % of the entries). So K4's dX is held row by row: a row far off must be
# explained (the plain version with a few mask bits near zero flipped gives
# the kernel's row to within a bf16 ulp of the row's largest entry), such rows
# may be a small share of the batch, and none may lie among the last 16 rows
# of a batch that ends inside a CTA's tile. The mean difference and the share
# of entries far apart measure the rest: they read 10-1000 times below what a
# dropped mask, a skipped Adam step or a skipped EMA update reads. "Reads":
# the survey below, ten seeds at each of 16,384, 1000, 129, 16 and 15 rows,
# NVIDIA H100 80GB HBM3, 700 W; PERF.md has it in full.
CARD_LIMITS = dict(
    k3_atol=1e-2, k3_rtol=1e-2,     # bf16 operands
    # K4's dX by rows. A row is off when an entry lies beyond 1e-3 of the
    # largest entry; at most 0.1 % of the rows may be, so none below 1000 rows
    # (reads 4 of 16,384, 1 of 1000, 0 of 129, 16 and 15). Each must be
    # explained: flipping at most 4 mask bits (reads 2) whose plain
    # pre-activation lies within 2e-2 of zero (reads 5.3e-3) leaves it within
    # 1e-3 of the largest entry or within 1e-2 of the row's own largest entry
    # (reads 1e-7 after a flip, 5.7e-3 where a gradient entry rounded apart).
    k4_dx_off_at=1e-3, k4_dx_share_off=1e-3, k4_flip_z=2e-2, k4_flip_bits=4, k4_row_rtol=1e-2,
    # the mean over the rows not off: reads 5.9e-7 at most in the survey and
    # 1.95e-6 on 15 rows with no 64 -> 64 layer (tests/test_torch_cuda.py)
    k4_dx_mean=1e-5,
    k4_dw_mean=1e-3, k4_dw_max=5e-2,    # reads 1.76e-4 and 8.8e-3 at most
    k5_mean=2e-5, k5_max=1e-3,      # reads 5.6e-6 and 1.6e-4 at most
    # relative, K5 and each of K6's four steps: one row with a small
    # denominator can hold a large share of a small batch's loss; reads 3.6e-6
    # (K5) and 5.1e-5 (K6) at most in the survey, 9.3e-5 once among the 15
    # batch sizes and depths of tests/test_torch_cuda.py (1000 rows)
    loss=5e-4,
    k6_mean=2e-5,                   # absolute, per state tensor; reads 3.68e-6 at most
    k6_far_at=1e-4, k6_far=1e-2,    # share of a tensor's entries beyond 1e-4: reads 1.46e-3 at most
)
TAIL_ROWS = 16  # a warp's rows: the ragged end of a batch is held with no row off


def gap(got: torch.Tensor, ref: torch.Tensor, far: float, scale=None):
    """How far ``got`` lies from ``ref``: (mean |got - ref|, largest
    |got - ref|, share of entries with |got - ref| > far), all in units of
    ``scale`` (default: the largest |ref|)."""
    if scale is None:
        scale = ref.abs().max().clamp(min=1e-30)
    d = (got - ref).abs() / scale
    return d.mean().item(), d.max().item(), (d > far).float().mean().item()


def rows_off(got: torch.Tensor, ref: torch.Tensor, off_at: float) -> torch.Tensor:
    """Mask of the rows of ``got`` with an entry further than ``off_at`` (in
    units of the largest |ref|) from ``ref``."""
    return ((got - ref).abs().amax(dim=1) / ref.abs().max().clamp(min=1e-30)) > off_at


def explain_off_rows(w, x, g_out, got_dx, ref_dx, off: torch.Tensor) -> list:
    """For each row of K4's dX that ``off`` marks: (row, bits, rest,
    rest_of_row). ``bits`` are ReLU mask bits, as (layer, unit, z) with the
    plain pre-activation z within ``k4_flip_z`` of zero, whose flip brings the
    plain version's row nearest the kernel's: found one at a time, each the
    bit that brings it nearest, at most ``k4_flip_bits`` of them. ``rest`` is
    the largest entry then left between the two rows in units of the largest
    |ref_dx|, ``rest_of_row`` the same in units of the row's own largest
    entry."""
    lim = CARD_LIMITS
    w_in, w_h, w_out = w
    scale = ref_dx.abs().max().clamp(min=1e-30)
    out = []
    if not bool(off.any()):
        return out
    # the forward pass on the whole batch, as the plain version ran it: a
    # product of other extents may sum in another order and flip a sign itself
    a0, acts, zs = MC._forward_acts(w_in, w_h, x)
    for row in off.nonzero().flatten().tolist():
        z_row = torch.stack([z[row] for z in zs])                  # [layers, 64]
        cand = [tuple(c) for c in (z_row.abs() < lim["k4_flip_z"]).nonzero().tolist()]  # (layer, unit)
        bits, rest = [], ((ref_dx[row] - got_dx[row]).abs().max() / scale).item()
        while cand and len(bits) < lim["k4_flip_bits"] and rest > 1e-2 * lim["k4_dx_off_at"]:
            # one copy of the row per candidate: the bits found so far and that one flipped
            n = len(cand)
            masks = [(z[row:row + 1] > 0.0).repeat(n, 1) for z in zs]
            for i, c in enumerate(cand):
                for layer, unit in (*bits, c):
                    masks[layer][i, unit] = ~masks[layer][i, unit]
            dx = MC._backward_chain(a0[row:row + 1].repeat(n, 1), [a[row:row + 1].repeat(n, 1) for a in acts], masks,
                                    MC._bf16(g_out[row:row + 1]).repeat(n, 1), w_in, w_h, w_out, with_dx=True)[0]
            left = (dx - got_dx[row]).abs().amax(dim=1) / scale
            i = int(left.argmin())
            if left[i].item() >= rest:
                break
            rest = left[i].item()
            bits.append(cand.pop(i))
        row_scale = (got_dx[row].abs().max() / scale).clamp(min=1e-30).item()
        out.append((row, [(layer, unit, z_row[layer, unit].item()) for layer, unit in bits], rest, rest / row_scale))
    return out


def _explained(flip) -> bool:
    """What the flipped bits leave of a row is as small as a row that is not
    off, or within ``k4_row_rtol`` of the row's own largest entry."""
    _, _, rest, rest_of_row = flip
    return rest <= CARD_LIMITS["k4_dx_off_at"] or rest_of_row <= CARD_LIMITS["k4_row_rtol"]


def _flips_text(flips) -> str:
    return ", ".join(f"{row} (" + " and ".join(f"layer {layer} unit {unit} z {z:.3g}" for layer, unit, z in bits)
                     + f"; left {rest:.3g}, {rest_of_row:.3g} of the row)" for row, bits, rest, rest_of_row in flips)


def check_backward(got, ref, w, x, g_out) -> str:
    """Hold K4's (dx, dw_in, dw_h, dw_out) on weights ``w``, rows ``x`` and
    output gradient ``g_out`` to ``CARD_LIMITS``; returns the readings as
    text, raises AssertionError beyond a limit."""
    lim = CARD_LIMITS
    b = x.shape[0]
    off = rows_off(got[0], ref[0], lim["k4_dx_off_at"])
    n_off, allowed = int(off.sum()), int(lim["k4_dx_share_off"] * b)
    scale = ref[0].abs().max().clamp(min=1e-30)
    mean = gap(got[0][~off], ref[0][~off], 0.0, scale)[0] if n_off < b else float("inf")
    largest = gap(got[0], ref[0], 0.0)[1]
    text = f"dX {n_off} of {b} rows beyond {lim['k4_dx_off_at']:g} (limit {allowed}), mean of the " \
           f"others {mean:.3g} (limit {lim['k4_dx_mean']:g}), largest {largest:.3g}"
    ok = n_off <= allowed and mean <= lim["k4_dx_mean"]
    if ok and n_off:
        flips = explain_off_rows(w, x, g_out, got[0], ref[0], off)
        unexplained = [flip[0] for flip in flips if not _explained(flip)]
        text += f"; flipped mask bits, row by row: {_flips_text(flips)}"
        if unexplained:
            text += f"; NOT explained: rows {unexplained}"
            ok = False
    if b % MC.GRAD_ROWS and bool(off[-TAIL_ROWS:].any()):
        text += f"; a row among the last {min(TAIL_ROWS, b)} of a ragged batch is off"
        ok = False
    for name, a, r in zip(("dW_in", "dW_hidden", "dW_out"), got[1:], ref[1:]):
        if r.numel():
            mean, largest, _ = gap(a, r, 0.0)
            text += f"; {name} mean {mean:.3g} (limit {lim['k4_dw_mean']:g}), largest {largest:.3g} " \
                    f"(limit {lim['k4_dw_max']:g})"
            ok = ok and mean <= lim["k4_dw_mean"] and largest <= lim["k4_dw_max"]
    if not ok:
        raise AssertionError(f"K4 disagrees with its plain version: {text}")
    return text


def check_train_grad(got, ref) -> str:
    """Hold K5's (loss, dw_in, dw_h, dw_out) to ``CARD_LIMITS``."""
    lim = CARD_LIMITS
    loss_rel = abs(got[0].detach().item() / ref[0].detach().item() - 1.0)
    text = f"loss {loss_rel:.3g} relative (limit {lim['loss']:g})"
    ok = loss_rel <= lim["loss"]
    for name, a, r in zip(("dW_in", "dW_hidden", "dW_out"), got[1:], ref[1:]):
        if r.numel():
            mean, largest, _ = gap(a, r, 0.0)
            text += f"; {name} mean {mean:.3g} (limit {lim['k5_mean']:g}), largest {largest:.3g} " \
                    f"(limit {lim['k5_max']:g})"
            ok = ok and mean <= lim["k5_mean"] and largest <= lim["k5_max"]
    if not ok:
        raise AssertionError(f"K5 disagrees with its plain version: {text}")
    return text


def train_state_gap(got, ref):
    """Over the tensors of two K6 states: (largest mean |diff|, largest
    |diff|, largest share of a tensor's entries beyond ``k6_far_at``)."""
    gaps = [gap(a, r, CARD_LIMITS["k6_far_at"], 1.0) for a, r in zip(got, ref)]
    return tuple(max(g[i] for g in gaps) for i in range(3))


def train4_from_k5(w, mu, nu, ema, step, x4, t4, lr, hyper):
    """K6's steps composed from K5 (its kernel on CUDA tensors) and the
    plain ``adam_ema``, without touching the arguments: returns (losses, the new
    weights, moments and EMA as one flat list). Where each CTA of K6 holds one
    128-row tile, K6 sums a step's gradient in K5's order, so the two differ
    only in how the update runs; against the plain K6 this reads what K5's
    tensor-core sums leave after the steps' Adam updates."""
    cur = [[t.detach().clone() for t in group] for group in (w, mu, nu, ema)]
    losses = []
    for k in range(x4.shape[0]):
        # a step's slice of an odd batch is not 16-byte aligned: copies are
        loss, *grads = MC.fused_train_grad(*cur[0], x4[k].clone(), t4[k].clone())
        losses.append(loss)
        t = step.to(torch.float32) + float(k + 1)
        for i, g in enumerate(grads):
            for group, new in zip(cur, MC.adam_ema(cur[0][i], g, cur[1][i], cur[2][i], cur[3][i], t, lr, hyper)):
                group[i] = new
    return torch.stack(losses), [t for group in cur for t in group]


def check_train_state(got, ref) -> str:
    """Hold two K6 states (sequences of weight, moment and EMA tensors in the
    same order) to ``CARD_LIMITS``: the largest mean difference of a tensor
    and the largest share of a tensor's entries far apart."""
    lim = CARD_LIMITS
    mean, largest, far = train_state_gap(got, ref)
    text = f"largest mean |diff| of a tensor {mean:.3g} (limit {lim['k6_mean']:g}), largest share of a " \
           f"tensor's entries beyond {lim['k6_far_at']:g}: {far:.3g} (limit {lim['k6_far']:g}), largest " \
           f"|diff| {largest:.3g}"
    if not (mean <= lim["k6_mean"] and far <= lim["k6_far"]):
        raise AssertionError(f"K6's state disagrees with its plain version: {text}")
    return text


# ---------------------------------------------------------------------------
# the runs on the card
# ---------------------------------------------------------------------------

def record_forward_batch(renderer: Renderer) -> torch.Tensor:
    """Render one frame and return the input of its (one) K3 launch."""
    seen = []
    original = MC.fused_forward

    def recording(w_in, w_h, w_out, x, output_relu=True):
        seen.append(x.detach().clone())
        return original(w_in, w_h, w_out, x, output_relu)

    MC.fused_forward = recording
    try:
        renderer.render_frame()
    finally:
        MC.fused_forward = original
    if len(seen) != 1:
        raise RuntimeError(f"a frame launched K3 {len(seen)} times, expected once")
    return seen[0]


def survey(dev, seeds=tuple(range(1, 11)), batches=(TRAIN_ROWS, 1000, 129, 16, 15)) -> list:
    """Readings of K4-K6 against their plain versions; one dict per (rows, seed)."""
    cfg = NetworkConfig()
    lim = CARD_LIMITS
    out = []
    for b in batches:
        for seed in seeds:
            gen = torch.Generator(device=dev).manual_seed(seed)
            w = [t.detach() for t in N.init_network(torch.Generator().manual_seed(seed - 1), cfg, dev).params.tensors()]
            q4 = torch.rand((4, b, 15), generator=gen, device=dev)
            x4 = N.encode(q4.view(-1, 15), cfg).view(4, b, MC.LANE)
            t4 = torch.rand((4, b, 3), generator=gen, device=dev) * 2.0
            g_out = torch.randn((b, MC.OUT_PAD), generator=gen, device=dev)
            x, t = x4[0].clone(), t4[0].clone()  # a slice of an odd batch is not 16-byte aligned
            got4, ref4 = MC.fused_backward_cuda(*w, x, g_out), MC.fused_backward_plain(*w, x, g_out)
            got5, ref5 = MC.fused_train_grad_cuda(*w, x, t), MC.fused_train_grad_plain(*w, x, t)
            row = dict(rows=b, seed=seed)
            off = rows_off(got4[0], ref4[0], lim["k4_dx_off_at"])
            scale = ref4[0].abs().max()
            row["k4_dx_mean"] = gap(got4[0][~off], ref4[0][~off], 0.0, scale)[0]  # of the rows not off
            row["k4_dx_max"] = gap(got4[0], ref4[0], 0.0)[1]
            gaps4 = [gap(a, r, 0.0) for a, r in zip(got4[1:], ref4[1:])]
            gaps5 = [gap(a, r, 0.0) for a, r in zip(got5[1:], ref5[1:])]
            row["k4_dw_mean"], row["k4_dw_max"] = max(g[0] for g in gaps4), max(g[1] for g in gaps4)
            row["k5_mean"], row["k5_max"] = max(g[0] for g in gaps5), max(g[1] for g in gaps5)
            row["k5_loss"] = abs(got5[0].item() / ref5[0].item() - 1.0)
            # the rows whose dX is far off, and the mask bits that explain each
            flips = explain_off_rows(w, x, g_out, got4[0], ref4[0], off)
            row["k4_rows_off"] = int(off.sum())
            row["k4_rows_unexplained"] = sum(not _explained(flip) for flip in flips)
            row["k4_flipped_bits"] = max((len(flip[1]) for flip in flips), default=0)
            row["k4_flipped_z"] = max((abs(z) for flip in flips for _, _, z in flip[1]), default=0.0)
            row["k4_rest_of_row"] = max((flip[3] for flip in flips), default=0.0)
            per_row = (got4[0] - ref4[0]).abs().amax(dim=1) / scale
            row["k4_rows_beyond_1e-5"], row["k4_rows_beyond_1e-4"] = int((per_row > 1e-5).sum()), int((per_row > 1e-4).sum())
            row["k4_flips"] = _flips_text(flips)
            row["k4_tail_off"] = int(off[-TAIL_ROWS:].sum())
            if b == TRAIN_ROWS:
                lr, records = torch.tensor(cfg.learning_rate, device=dev), torch.tensor(b, device=dev)
                states = []
                for fn in (MC.fused_train4_cuda, MC.fused_train4_plain):
                    st = N.init_network(torch.Generator().manual_seed(seed + 2), cfg, dev)
                    groups = (st.params.tensors(), st.opt.mu.tensors(), st.opt.nu.tensors(), st.ema.tensors())
                    losses = fn(*groups, st.opt.step, x4, t4, lr, records, N.adam_hyper(cfg))
                    states.append((losses, [t for group in groups for t in group]))
                (lk, sk), (lp, sp) = states
                gaps6 = [gap(a, r, lim["k6_far_at"], 1.0) for a, r in zip(sk, sp)]
                row["k6_loss"] = ((lk - lp).abs() / lp.abs()).max().item()
                row["k6_mean"], row["k6_max"], row["k6_far"] = (max(g[i] for g in gaps6) for i in range(3))
            out.append(row)
            print("survey " + ", ".join(f"{k} {v:.3g}" if isinstance(v, float) else f"{k} {v}" for k, v in row.items()))
        worst = {k: max(r[k] for r in out if r["rows"] == b and k in r)
                 for k in out[-1] if k.startswith("k") and k != "k4_flips"}
        print(f"survey, largest readings at {b} rows over {len(seeds)} seeds: "
              + ", ".join(f"{k} {v:.3g}" for k, v in worst.items()))
    return out


def run() -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("bench_mlp: no CUDA device is available")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cfg = NetworkConfig()
    for k in (MC.FORWARD_KERNEL, MC.BACKWARD_KERNEL, MC.TRAIN_GRAD_KERNEL, MC.TRAIN4_KERNEL):
        for line in k.build().splitlines():
            if "ptxas info" in line and ("Used" in line or "spill" in line or "Function properties" in line):
                print(f"{k.source}: {line.strip()}")
    gen = torch.Generator(device=dev).manual_seed(1)

    def fresh_state():
        st = N.init_network(torch.Generator().manual_seed(3), cfg, dev)
        return (st.params.tensors(), st.opt.mu.tensors(), st.opt.nu.tensors(), st.ema.tensors(), st.opt.step)

    w = [t.detach() for t in fresh_state()[0]]
    n_hidden = w[1].shape[0]
    rows = []

    def add(name, shape, n_rows, fn, plain, iters_plain=5):
        row = dict(kernel=name, shape=shape, ms=device_ms(fn), plain_ms=device_ms(plain, iters=iters_plain),
                   **mlp_bound(name, n_rows, n_hidden))
        rows.append(row)
        print(f"{name:4s} {shape:>22s}: {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
              f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}), its scratch {row['scratch_bound_ms']:.4f} ms")

    # K3: the render queries of a 320x320 frame, then what a frame really sends
    n = RES * RES
    x = torch.rand((n, MC.LANE), generator=gen, device=dev)
    x[:, 66] = 1.0  # the ones channel after the 66 encoded features
    x[:, 67:] = 0.0
    scene, system = cornell_box((RES, RES))
    r = Renderer(scene, system, render_mode=RenderMode.FULL, device=dev)
    sizes = settle_tiles(r)
    x_frame = record_forward_batch(r)
    for label, xs in ((f"[{n}, 128]", x), (f"frame [{x_frame.shape[0]}, 128]", x_frame)):
        add("K3", label, xs.shape[0], lambda xs=xs: MC.fused_forward_cuda(*w, xs, True),
            lambda xs=xs: MC.fused_forward_plain(*w, xs, True))

    # K4-K6 at the training batch of a frame
    b = TRAIN_ROWS
    q4 = torch.rand((4, b, 15), generator=gen, device=dev)
    x4 = N.encode(q4.view(-1, 15), cfg).view(4, b, MC.LANE)
    t4 = torch.rand((4, b, 3), generator=gen, device=dev) * 2.0
    g_out = torch.randn((b, MC.OUT_PAD), generator=gen, device=dev)
    add("K4", f"[{b}, 128]", b, lambda: MC.fused_backward_cuda(*w, x4[0], g_out),
        lambda: MC.fused_backward_plain(*w, x4[0], g_out))
    add("K5", f"[{b}, 128]", b, lambda: MC.fused_train_grad_cuda(*w, x4[1], t4[1]),
        lambda: MC.fused_train_grad_plain(*w, x4[1], t4[1]))
    lr = torch.tensor(cfg.learning_rate, device=dev)
    records = torch.tensor(b, device=dev)
    hyper = N.adam_hyper(cfg)
    sk, sp = fresh_state(), fresh_state()
    add("K6", f"[4, {b}, 128]", b, lambda: MC.fused_train4_cuda(*sk, x4, t4, lr, records, hyper),
        lambda: MC.fused_train4_plain(*sp, x4, t4, lr, records, hyper), iters_plain=2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    return {"device": smi, "tile_sizes": [list(s) for s in sizes], "rows": rows, "survey": survey(dev)}


def main() -> int:
    result = run()
    print(result["device"])
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
