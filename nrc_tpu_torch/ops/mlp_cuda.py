"""Fully-fused 64-wide MLP: kernels K3-K6 and their plain versions.

Counterpart of ``nrc_tpu/ops/mlp_pallas.py``. x [B, 128] runs through the
bias-free chain 128 -> 64 -> (64 -> 64) x H -> 16 with ReLU between layers;
every product rounds both operands to bf16 and sums in f32. Weights keep the
JAX layout: w_in [128, 64], w_hidden [H, 64, 64], w_out [64, 16]. On the card
every product of K3-K6 is a bf16 ``mma.sync`` tile on the tensor cores
(``csrc/mma_tiles.cuh``): a warp owns 16 rows and the activations pass from
layer to layer in registers.

- K3 ``fused_forward`` (``csrc/mlp_forward.cu``): the forward, optionally
  with a ReLU on the output.
- K4 ``fused_backward`` (``csrc/mlp_backward.cu``): recompute the forward,
  mask with the f32 pre-activations, backprop an output gradient; dX and
  the weight gradients summed over the batch. ``FusedMLP`` is the
  ``torch.autograd.Function`` over K3 + K4 (``fused_apply`` there).
- K5 ``fused_train_grad`` (``csrc/mlp_train.cu``): forward with bf16-stored
  activations, the RelativeL2Luminance loss and its gradient, backward with
  masks from the bf16 activations; loss and weight gradients, no dX.
- K6 ``fused_train4`` (same file): four K5 steps, each followed by L2 +
  bias-corrected Adam + EMA, updating weights, moments, EMA and the step
  count in place; nothing changes when ``num_records`` is 0. One
  cooperative launch of a persistent kernel for all four steps: a CTA per
  SM (``train4_grid``), grid barriers between a step's gradient, its
  reduction + update and the next step. It launches nothing of K5's.

Device rule: on CUDA tensors each wrapper launches its kernel or raises; on
CPU tensors it runs the plain version, which computes the TPU kernel's
function with the same bf16 rounding points in float32 PyTorch. The plain
versions multiply bf16-rounded operands in float32:
``a.bfloat16().float() @ w.bfloat16().float()`` (a bf16 @ bf16 product would
return bf16 and round the sums). On the card this needs
``torch.backends.cuda.matmul.allow_tf32 = False`` (PyTorch's default), or the
float32 product would drop to TF32.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Sequence

import torch

from .cuda_build import CudaKernel, check_cuda_tensor, current_stream, ptr

LANE = 128
WIDTH = 64
OUT_PAD = 16
GRAD_ROWS = 128       # rows per CTA of the gradient kernels (mlp_grad.cuh kRows)
# The deepest networks whose shared memory fits a CTA of an H100 (232,448
# bytes). The layout is the sources' own (csrc/mma_tiles.cuh,
# mlp_grad.cuh::smem_bytes); tests/test_torch_mlp_tiles.py holds these two
# numbers to it.
MAX_HIDDEN = 22       # K3: the weights staged as bf16
MAX_HIDDEN_GRAD = 5   # K4-K6: weights + a 128-row block's input, activations, gradient

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
FORWARD_KERNEL = CudaKernel(
    "mlp_forward.cu", "nrc_mlp_forward", [_P, _P, _P, _P, _I, _I, _I, _P, _P]
)
BACKWARD_KERNEL = CudaKernel(
    "mlp_backward.cu", "nrc_mlp_backward", [_P] * 5 + [_I, _I] + [_P] * 4
)
TRAIN_GRAD_KERNEL = CudaKernel(
    "mlp_train.cu", "nrc_mlp_train_grad", [_P] * 5 + [_I, _I, _F, _F] + [_P] * 4
)
TRAIN4_KERNEL = CudaKernel(
    "mlp_train.cu", "nrc_mlp_train4",
    [_P, _P, _I, _I, _I] + [_P] * 12 + [_P, _P, _P] + [_F] * 10 + [_I, _P, _P, _P],
)


class AdamHyper(NamedTuple):
    """L2 + Adam + EMA constants (``NetworkConfig``)."""

    beta1: float
    beta2: float
    eps: float
    l2: float
    decay: float


def num_params(n_hidden: int) -> int:
    return LANE * WIDTH + n_hidden * WIDTH * WIDTH + WIDTH * OUT_PAD


def split_params(flat: torch.Tensor, n_hidden: int):
    """A flat [w_in | w_hidden | w_out] gradient -> (dw_in, dw_h, dw_out) views."""
    a = LANE * WIDTH
    b = a + n_hidden * WIDTH * WIDTH
    return (flat[:a].view(LANE, WIDTH), flat[a:b].view(n_hidden, WIDTH, WIDTH),
            flat[b:b + WIDTH * OUT_PAD].view(WIDTH, OUT_PAD))


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def _mm_bf16(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return _bf16(a) @ _bf16(w)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def fused_forward_plain(w_in, w_h, w_out, x, output_relu: bool = True) -> torch.Tensor:
    """Plain PyTorch version of K3: [B, 128] -> [B, 16] float32."""
    z = torch.relu(_mm_bf16(x, w_in))
    for i in range(w_h.shape[0]):
        z = torch.relu(_mm_bf16(z, w_h[i]))
    out = _mm_bf16(z, w_out)
    return torch.relu(out) if output_relu else out


def _forward_acts(w_in, w_h, x):
    """(bf16 input, bf16 activations [H + 1], f32 pre-activations [H + 1])."""
    a0 = _bf16(x)
    acts, zs = [], []
    a = a0
    for w in [w_in, *w_h]:
        z = a @ _bf16(w)
        a = _bf16(torch.relu(z))
        zs.append(z)
        acts.append(a)
    return a0, acts, zs


def _backward_chain(a0, acts, masks, g, w_in, w_h, w_out, with_dx: bool):
    """Walk the chain backward from a bf16-valued output gradient g [B, 16]:
    every gradient is rounded to bf16 before it enters a product, as the TPU
    kernels' _mm / _mm_tn round their operands."""
    n_hidden = w_h.shape[0]
    dw_out = acts[-1].T @ g
    g = _bf16(torch.where(masks[-1], g @ _bf16(w_out).T, 0.0))
    dw_h = [None] * n_hidden
    for i in range(n_hidden - 1, -1, -1):
        dw_h[i] = acts[i].T @ g
        g = _bf16(torch.where(masks[i], g @ _bf16(w_h[i]).T, 0.0))
    dw_in = a0.T @ g
    dw_h = torch.stack(dw_h) if n_hidden else torch.zeros_like(w_h)
    dx = g @ _bf16(w_in).T if with_dx else None
    return dx, dw_in, dw_h, dw_out


def fused_backward_plain(w_in, w_h, w_out, x, g_out):
    """Plain PyTorch version of K4: (dx [B, 128], dw_in, dw_h, dw_out)."""
    a0, acts, zs = _forward_acts(w_in, w_h, x)
    masks = [z > 0.0 for z in zs]
    return _backward_chain(a0, acts, masks, _bf16(g_out), w_in, w_h, w_out, with_dx=True)


def fused_train_grad_plain(w_in, w_h, w_out, x, target):
    """Plain PyTorch version of K5: (loss, dw_in, dw_h, dw_out) of the
    RelativeL2Luminance loss over the linear output's columns 0-2."""
    a0, acts, _ = _forward_acts(w_in, w_h, x)
    pred = acts[-1] @ _bf16(w_out)
    inv_count = 1.0 / float(x.shape[0] * 3)
    p = pred[:, :3]
    lum = 0.299 * p[:, 0:1] + 0.587 * p[:, 1:2] + 0.114 * p[:, 2:3]
    denom = lum * lum + 0.01
    diff = p - target
    loss = (diff * diff / denom).sum() * inv_count
    g = torch.zeros_like(pred)
    g[:, :3] = _bf16((2.0 * inv_count) * diff / denom)
    masks = [a > 0.0 for a in acts]
    _, dw_in, dw_h, dw_out = _backward_chain(a0, acts, masks, g, w_in, w_h, w_out, with_dx=False)
    return loss, dw_in, dw_h, dw_out


def adam_ema(p, g, m, v, e, t, lr, hyper: AdamHyper):
    """One L2 + bias-corrected Adam + EMA update of a weight tensor ``p``
    with gradient ``g``, moments ``m``, ``v`` and EMA ``e`` at step count
    ``t`` (float32 tensor, counted from 1), in ``csrc/mlp_train.cu::adam_ema``'s
    operation order. Returns the new (p, m, v, e)."""
    b1, b2, eps, l2, decay = hyper
    g = g + l2 * p
    m = b1 * m + (1.0 - b1) * g
    v = b2 * v + (1.0 - b2) * g * g
    upd = (m / (1.0 - b1 ** t)) / (torch.sqrt(v / (1.0 - b2 ** t)) + eps)
    p = p - lr * upd
    return p, m, v, decay * e + (1.0 - decay) * p


@torch.no_grad()
def fused_train4_plain(w, mu, nu, ema, step, x4, t4, lr, num_records, hyper: AdamHyper):
    """Plain PyTorch version of K6. ``w``, ``mu``, ``nu``, ``ema`` are
    (in, hidden, out) tensor triples, ``step`` an int64 scalar tensor, ``lr``
    a float32 scalar tensor, ``num_records`` an integer scalar tensor. Updates
    them in place (unchanged when ``num_records`` is 0) and returns the
    losses [4]."""
    keep = num_records > 0
    cur = [list(w), list(mu), list(nu), list(ema)]
    losses = []
    for k in range(x4.shape[0]):
        loss, *grads = fused_train_grad_plain(*cur[0], x4[k], t4[k])
        losses.append(loss)
        t = step.to(torch.float32) + float(k + 1)
        for i, g in enumerate(grads):
            new = adam_ema(cur[0][i], g, cur[1][i], cur[2][i], cur[3][i], t, lr, hyper)
            cur[0][i], cur[1][i], cur[2][i], cur[3][i] = new
    for old, new in zip((*w, *mu, *nu, *ema), [t for group in cur for t in group]):
        old.copy_(torch.where(keep, new, old))
    step.add_(keep.to(step.dtype) * x4.shape[0])
    return torch.where(keep, torch.stack(losses), 0.0)


# ---------------------------------------------------------------------------
# kernels on the card
# ---------------------------------------------------------------------------

def fused_forward_cuda(w_in, w_h, w_out, x, output_relu: bool = True) -> torch.Tensor:
    """K3 on the card: [B, 128] -> [B, 16] float32."""
    dev = x.device
    x, w_in, w_h, w_out = (t.contiguous() for t in (x, w_in, w_h, w_out))
    b = x.shape[0]
    n_hidden = w_h.shape[0]
    if n_hidden > MAX_HIDDEN:
        raise ValueError(f"{n_hidden} hidden layers > {MAX_HIDDEN}")
    _check_weights(w_in, w_h, w_out, dev)
    check_cuda_tensor("x", x, torch.float32, (b, LANE), dev)
    out = torch.empty((b, OUT_PAD), dtype=torch.float32, device=dev)
    if b:
        FORWARD_KERNEL.launch(
            ptr(x), ptr(w_in), ptr(w_h), ptr(w_out), b, n_hidden, int(output_relu),
            ptr(out), current_stream(dev),
        )
    return out


def _check_weights(w_in, w_h, w_out, dev) -> None:
    check_cuda_tensor("w_in", w_in, torch.float32, (LANE, WIDTH), dev)
    check_cuda_tensor("w_hidden", w_h, torch.float32, (w_h.shape[0], WIDTH, WIDTH), dev)
    check_cuda_tensor("w_out", w_out, torch.float32, (WIDTH, OUT_PAD), dev)


def _grad_scratch(b: int, n_hidden: int, dev):
    """(partial sums [CTAs, P + 1], flat result [P + 1]) of the gradient kernels."""
    if n_hidden > MAX_HIDDEN_GRAD:
        raise ValueError(f"{n_hidden} hidden layers > {MAX_HIDDEN_GRAD}")
    p = num_params(n_hidden)
    blocks = -(-b // GRAD_ROWS)
    return (torch.empty((blocks, p + 1), dtype=torch.float32, device=dev),
            torch.zeros(p + 1, dtype=torch.float32, device=dev))


def fused_backward_cuda(w_in, w_h, w_out, x, g_out):
    """K4 on the card: (dx [B, 128], dw_in, dw_h, dw_out), float32."""
    dev = x.device
    x, g_out, w_in, w_h, w_out = (t.contiguous() for t in (x, g_out, w_in, w_h, w_out))
    b, n_hidden = x.shape[0], w_h.shape[0]
    _check_weights(w_in, w_h, w_out, dev)
    check_cuda_tensor("x", x, torch.float32, (b, LANE), dev)
    check_cuda_tensor("g_out", g_out, torch.float32, (b, OUT_PAD), dev)
    partial, flat = _grad_scratch(b, n_hidden, dev)
    dx = torch.empty((b, LANE), dtype=torch.float32, device=dev)
    if b:
        BACKWARD_KERNEL.launch(
            ptr(x), ptr(g_out), ptr(w_in), ptr(w_h), ptr(w_out), b, n_hidden,
            ptr(dx), ptr(partial), ptr(flat), current_stream(dev),
        )
    return (dx, *split_params(flat, n_hidden))


def fused_train_grad_cuda(w_in, w_h, w_out, x, target):
    """K5 on the card: (loss, dw_in, dw_h, dw_out), float32."""
    dev = x.device
    x, target, w_in, w_h, w_out = (t.contiguous() for t in (x, target, w_in, w_h, w_out))
    b, n_hidden = x.shape[0], w_h.shape[0]
    _check_weights(w_in, w_h, w_out, dev)
    check_cuda_tensor("x", x, torch.float32, (b, LANE), dev)
    check_cuda_tensor("target", target, torch.float32, (b, 3), dev)
    partial, flat = _grad_scratch(b, n_hidden, dev)
    if b:
        inv_count = 1.0 / float(b * 3)
        TRAIN_GRAD_KERNEL.launch(
            ptr(x), ptr(target), ptr(w_in), ptr(w_h), ptr(w_out), b, n_hidden,
            2.0 * inv_count, inv_count, ptr(partial), ptr(flat), ptr(flat[-1:]),
            current_stream(dev),
        )
    return (flat[-1], *split_params(flat, n_hidden))


def train4_grid(b: int, sms: int) -> int:
    """CTAs of K6's persistent kernel for a batch of ``b`` rows on a card of
    ``sms`` SMs: one per SM, and no more than there are 128-row tiles (a CTA
    with more than one tile adds them to its partial row in tile order). The
    one place the grid is chosen: the launch takes it as the scratch's rows
    and checks only that the CTAs can be co-resident."""
    return min(-(-b // GRAD_ROWS), sms)


def train4_scratch(b: int, n_hidden: int, dev) -> torch.Tensor:
    """K6's partial sums on card ``dev``: a row of P + 1 floats (dW_in |
    dW_hidden | dW_out | loss) per CTA, [train4_grid(b, SMs), P + 1]."""
    if n_hidden > MAX_HIDDEN_GRAD:
        raise ValueError(f"{n_hidden} hidden layers > {MAX_HIDDEN_GRAD}")
    grid = train4_grid(b, torch.cuda.get_device_properties(dev).multi_processor_count)
    return torch.empty((grid, num_params(n_hidden) + 1), dtype=torch.float32, device=dev)


def fused_train4_cuda(w, mu, nu, ema, step, x4, t4, lr, num_records, hyper: AdamHyper):
    """K6 on the card; arguments and in-place semantics as ``fused_train4_plain``.
    One kernel launch per call."""
    dev = x4.device
    x4, t4 = x4.contiguous(), t4.contiguous()
    nb, b = x4.shape[0], x4.shape[1]
    if b == 0:
        raise ValueError("fused_train4: empty batches")
    n_hidden = w[1].shape[0]
    for name, group in (("w", w), ("mu", mu), ("nu", nu), ("ema", ema)):
        try:
            _check_weights(*group, dev)
        except (TypeError, ValueError) as e:
            raise type(e)(f"{name}: {e}") from None
    check_cuda_tensor("x4", x4, torch.float32, (nb, b, LANE), dev)
    check_cuda_tensor("t4", t4, torch.float32, (nb, b, 3), dev)
    check_cuda_tensor("step", step, torch.int64, (), dev)
    check_cuda_tensor("lr", lr, torch.float32, (), dev)
    check_cuda_tensor("num_records", num_records, torch.int64, (), dev)
    partial = train4_scratch(b, n_hidden, dev)
    losses = torch.empty(nb, dtype=torch.float32, device=dev)  # the kernel writes every entry
    inv_count = 1.0 / float(b * 3)
    b1, b2, eps, l2, decay = hyper
    TRAIN4_KERNEL.launch(
        ptr(x4), ptr(t4), nb, b, n_hidden,
        *(ptr(t) for t in (*w, *mu, *nu, *ema)),
        ptr(step), ptr(lr), ptr(num_records),
        b1, 1.0 - b1, b2, 1.0 - b2, eps, l2, decay, 1.0 - decay, 2.0 * inv_count, inv_count,
        partial.shape[0], ptr(partial), ptr(losses), current_stream(dev),
    )
    return losses


# ---------------------------------------------------------------------------
# dispatch by device
# ---------------------------------------------------------------------------

def _by_device(x: torch.Tensor, cuda_fn, plain_fn, *args):
    if x.device.type == "cuda":
        return cuda_fn(*args)
    if x.device.type == "cpu":
        return plain_fn(*args)
    raise ValueError(f"unsupported device {x.device}")


def fused_forward(w_in, w_h, w_out, x, output_relu: bool = True) -> torch.Tensor:
    """x [B, 128] -> [B, 16]: K3 on a CUDA tensor, the plain version on a CPU one."""
    return _by_device(x, fused_forward_cuda, fused_forward_plain, w_in, w_h, w_out, x, output_relu)


def fused_backward(w_in, w_h, w_out, x, g_out):
    """(dx, dw_in, dw_h, dw_out): K4 on a CUDA tensor, the plain version on a CPU one."""
    return _by_device(x, fused_backward_cuda, fused_backward_plain, w_in, w_h, w_out, x, g_out)


def fused_train_grad(w_in, w_h, w_out, x, target):
    """(loss, dw_in, dw_h, dw_out): K5 on a CUDA tensor, the plain version on a CPU one."""
    return _by_device(x, fused_train_grad_cuda, fused_train_grad_plain, w_in, w_h, w_out, x, target)


def fused_train4(w: Sequence[torch.Tensor], mu, nu, ema, step, x4, t4, lr, num_records,
                 hyper: AdamHyper) -> torch.Tensor:
    """Four Adam + EMA steps in place; returns the losses [4]. K6 on CUDA
    tensors, the plain version on CPU ones."""
    return _by_device(x4, fused_train4_cuda, fused_train4_plain,
                      w, mu, nu, ema, step, x4, t4, lr, num_records, hyper)


class FusedMLP(torch.autograd.Function):
    """Differentiable fused MLP (``fused_apply`` and its custom VJP,
    ``mlp_pallas.py:189-207``): K3 forward, K4 backward. With
    ``output_relu`` the output gradient is masked by out > 0 first."""

    @staticmethod
    def forward(ctx, w_in, w_h, w_out, x, output_relu: bool):
        out = fused_forward(w_in, w_h, w_out, x, output_relu)
        ctx.output_relu = output_relu
        ctx.save_for_backward(w_in, w_h, w_out, x, out)
        return out

    @staticmethod
    def backward(ctx, g):
        w_in, w_h, w_out, x, out = ctx.saved_tensors
        if ctx.output_relu:
            g = torch.where(out > 0.0, g, 0.0)
        dx, dw_in, dw_h, dw_out = fused_backward(w_in, w_h, w_out, x, g.contiguous())
        return dw_in, dw_h, dw_out, dx, None
