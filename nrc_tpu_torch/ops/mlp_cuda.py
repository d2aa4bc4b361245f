"""Fully-fused 64-wide MLP forward: kernel K3 and its plain version.

Counterpart of ``nrc_tpu/ops/mlp_pallas.py::fused_forward``: x [B, 128]
through the bias-free chain 128 -> 64 -> (64 -> 64) x H -> 16, ReLU between
layers and optionally on the output; bf16 operands, f32 sums. Weights keep
the JAX layout: w_in [128, 64], w_hidden [H, 64, 64], w_out [64, 16].

Device rule: on CUDA tensors ``fused_forward`` launches
``csrc/mlp_forward.cu`` or raises; on CPU tensors it runs ``fused_forward_plain``.

The plain version rounds operands to bf16 and multiplies in float32:
``a.bfloat16().float() @ w.bfloat16().float()``. A bf16 @ bf16 product
would return bf16 and round the sums. On the card this needs
``torch.backends.cuda.matmul.allow_tf32 = False`` (PyTorch's default), or
the float32 product would drop to TF32.
"""

from __future__ import annotations

import ctypes

import torch

from .cuda_build import CudaKernel, check_cuda_tensor, current_stream, ptr

LANE = 128
WIDTH = 64
OUT_PAD = 16
MAX_HIDDEN = 16  # shared-memory budget of one CTA (227 KB) holds up to 26

_P = ctypes.c_void_p
_I = ctypes.c_int
FORWARD_KERNEL = CudaKernel(
    "mlp_forward.cu", "nrc_mlp_forward", [_P, _P, _P, _P, _I, _I, _I, _P, _P]
)


def _mm_bf16(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return a.to(torch.bfloat16).float() @ w.to(torch.bfloat16).float()


def fused_forward_plain(w_in, w_h, w_out, x, output_relu: bool = True) -> torch.Tensor:
    """Plain PyTorch version of K3: [B, 128] -> [B, 16] float32."""
    z = torch.relu(_mm_bf16(x, w_in))
    for i in range(w_h.shape[0]):
        z = torch.relu(_mm_bf16(z, w_h[i]))
    out = _mm_bf16(z, w_out)
    return torch.relu(out) if output_relu else out


def fused_forward_cuda(w_in, w_h, w_out, x, output_relu: bool = True) -> torch.Tensor:
    """K3 on the card: [B, 128] -> [B, 16] float32."""
    dev = x.device
    x, w_in, w_h, w_out = (t.contiguous() for t in (x, w_in, w_h, w_out))
    b = x.shape[0]
    n_hidden = w_h.shape[0]
    if n_hidden > MAX_HIDDEN:
        raise ValueError(f"{n_hidden} hidden layers > {MAX_HIDDEN}")
    check_cuda_tensor("x", x, torch.float32, (b, LANE), dev)
    check_cuda_tensor("w_in", w_in, torch.float32, (LANE, WIDTH), dev)
    check_cuda_tensor("w_hidden", w_h, torch.float32, (n_hidden, WIDTH, WIDTH), dev)
    check_cuda_tensor("w_out", w_out, torch.float32, (WIDTH, OUT_PAD), dev)
    out = torch.empty((b, OUT_PAD), dtype=torch.float32, device=dev)
    if b:
        FORWARD_KERNEL.launch(
            ptr(x), ptr(w_in), ptr(w_h), ptr(w_out), b, n_hidden, int(output_relu),
            ptr(out), current_stream(dev),
        )
    return out


def fused_forward(w_in, w_h, w_out, x, output_relu: bool = True) -> torch.Tensor:
    """x [B, 128] -> [B, 16]: K3 on a CUDA tensor, the plain version on a CPU one."""
    if x.device.type == "cuda":
        return fused_forward_cuda(w_in, w_h, w_out, x, output_relu)
    if x.device.type == "cpu":
        return fused_forward_plain(w_in, w_h, w_out, x, output_relu)
    raise ValueError(f"unsupported device {x.device}")
