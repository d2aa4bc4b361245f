"""The fully-fused MLP and its training in plain PyTorch, on any device.

A frozen copy of the plain versions in ``nrc_tpu_torch/ops/mlp_cuda.py``
(the forward, the backward chain, the RelativeL2Luminance gradient, L2 +
Adam + EMA and the four steps of a frame), without the kernels K3-K6. Every
product rounds both operands by ``rnd`` and sums in float32: ``round_bf16``
is the precision the network is configured with (bf16 operands, f32 sums);
``round_fp8`` (e4m3 with one scale a tensor) is the precision below it,
the benchmark's control. The reference switches TF32 off, so a product of
rounded operands is exact and only the sums round.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

LANE = 128
WIDTH = 64
OUT_PAD = 16
FP8_MAX = 448.0  # the largest finite float8_e4m3fn


class AdamHyper(NamedTuple):
    beta1: float
    beta2: float
    eps: float
    l2: float
    decay: float


def round_bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def round_fp8(t: torch.Tensor) -> torch.Tensor:
    """e4m3 with the tensor's own scale (its largest magnitude at 448)."""
    amax = t.detach().abs().amax()
    scale = torch.where(amax > 0, amax / FP8_MAX, torch.ones_like(amax))
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


ROUNDING = {"bf16": round_bf16, "fp8": round_fp8}


def _mm(a, w, rnd):
    return rnd(a) @ rnd(w)


def forward(w_in, w_h, w_out, x, output_relu: bool = True, rnd=round_bf16) -> torch.Tensor:
    """[B, 128] -> [B, 16] float32 (K3's function)."""
    z = torch.relu(_mm(x, w_in, rnd))
    for i in range(w_h.shape[0]):
        z = torch.relu(_mm(z, w_h[i], rnd))
    out = _mm(z, w_out, rnd)
    return torch.relu(out) if output_relu else out


def _forward_acts(w_in, w_h, x, rnd):
    a0 = rnd(x)
    acts, zs = [], []
    a = a0
    for w in [w_in, *w_h]:
        z = a @ rnd(w)
        a = rnd(torch.relu(z))
        zs.append(z)
        acts.append(a)
    return a0, acts, zs


def _backward_chain(a0, acts, masks, g, w_in, w_h, w_out, with_dx: bool, rnd):
    n_hidden = w_h.shape[0]
    dw_out = acts[-1].T @ g
    g = rnd(torch.where(masks[-1], g @ rnd(w_out).T, 0.0))
    dw_h = [None] * n_hidden
    for i in range(n_hidden - 1, -1, -1):
        dw_h[i] = acts[i].T @ g
        g = rnd(torch.where(masks[i], g @ rnd(w_h[i]).T, 0.0))
    dw_in = a0.T @ g
    dw_h = torch.stack(dw_h) if n_hidden else torch.zeros_like(w_h)
    dx = g @ rnd(w_in).T if with_dx else None
    return dx, dw_in, dw_h, dw_out


def backward(w_in, w_h, w_out, x, g_out, rnd=round_bf16):
    """(dx [B, 128], dw_in, dw_h, dw_out) (K4's function)."""
    a0, acts, zs = _forward_acts(w_in, w_h, x, rnd)
    masks = [z > 0.0 for z in zs]
    return _backward_chain(a0, acts, masks, rnd(g_out), w_in, w_h, w_out, True, rnd)


def train_grad(w_in, w_h, w_out, x, target, rnd=round_bf16):
    """(loss, dw_in, dw_h, dw_out) of the RelativeL2Luminance loss over the
    linear output's columns 0-2 (K5's function)."""
    a0, acts, _ = _forward_acts(w_in, w_h, x, rnd)
    pred = acts[-1] @ rnd(w_out)
    inv_count = 1.0 / float(a0.shape[0] * 3)
    p = pred[:, :3]
    lum = 0.299 * p[:, 0:1] + 0.587 * p[:, 1:2] + 0.114 * p[:, 2:3]
    denom = lum * lum + 0.01
    diff = p - target
    loss = (diff * diff / denom).sum() * inv_count
    g = torch.zeros_like(pred)
    g[:, :3] = rnd((2.0 * inv_count) * diff / denom)
    masks = [a > 0.0 for a in acts]
    _, dw_in, dw_h, dw_out = _backward_chain(a0, acts, masks, g, w_in, w_h, w_out, False, rnd)
    return loss, dw_in, dw_h, dw_out


def adam_ema(p, g, m, v, e, t, lr, hyper: AdamHyper):
    """One L2 + bias-corrected Adam + EMA update; returns (p, m, v, e)."""
    b1, b2, eps, l2, decay = hyper
    g = g + l2 * p
    m = b1 * m + (1.0 - b1) * g
    v = b2 * v + (1.0 - b2) * g * g
    upd = (m / (1.0 - b1 ** t)) / (torch.sqrt(v / (1.0 - b2 ** t)) + eps)
    p = p - lr * upd
    return p, m, v, decay * e + (1.0 - decay) * p


@torch.no_grad()
def train4(w, mu, nu, ema, step, x4, t4, lr, num_records, hyper: AdamHyper, rnd=round_bf16):
    """K6's function: four steps on (in, hidden, out) triples, in place
    (unchanged when ``num_records`` is 0); returns the losses [4]."""
    keep = num_records > 0
    cur = [list(w), list(mu), list(nu), list(ema)]
    losses = []
    for k in range(x4.shape[0]):
        loss, *grads = train_grad(*cur[0], x4[k], t4[k], rnd)
        losses.append(loss)
        t = step.to(torch.float32) + float(k + 1)
        for i, g in enumerate(grads):
            new = adam_ema(cur[0][i], g, cur[1][i], cur[2][i], cur[3][i], t, lr, hyper)
            cur[0][i], cur[1][i], cur[2][i], cur[3][i] = new
    for old, new in zip((*w, *mu, *nu, *ema), [t for group in cur for t in group]):
        old.copy_(torch.where(keep, new, old))
    step.add_(keep.to(step.dtype) * x4.shape[0])
    return torch.where(keep, torch.stack(losses), 0.0)


class FusedMLP(torch.autograd.Function):
    """Differentiable MLP: ``forward`` and ``backward`` above. With
    ``output_relu`` the output gradient is masked by out > 0 first.
    ``apply(w_in, w_h, w_out, x, output_relu, rnd)``."""

    @staticmethod
    def forward(ctx, w_in, w_h, w_out, x, output_relu: bool, rnd):
        out = forward(w_in, w_h, w_out, x, output_relu, rnd)
        ctx.output_relu, ctx.rnd = output_relu, rnd
        ctx.save_for_backward(w_in, w_h, w_out, x, out)
        return out

    @staticmethod
    def backward(ctx, g):
        w_in, w_h, w_out, x, out = ctx.saved_tensors
        if ctx.output_relu:
            g = torch.where(out > 0.0, g, 0.0)
        dx, dw_in, dw_h, dw_out = backward(w_in, w_h, w_out, x, g.contiguous(), ctx.rnd)
        return dw_in, dw_h, dw_out, dx, None, None
