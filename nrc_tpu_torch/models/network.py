"""The NRC network: encoding + 64-wide fully-fused MLP, RelativeL2Luminance
loss, Adam + EMA training.

Port of ``nrc_tpu/models/network.py`` for the frequency encoding (reference
``nrc/src/NRCNetwork.cu:41-128`` / ``nrc/inc/NRCNetworkConfigs.h``):
FullyFusedMLP(ReLU, 64 neurons, 5 hidden layers), bias-free, input padded to
128 with one ones channel (a bias) and zeros. Inference uses the EMA weights
and clamps the output with a ReLU; training runs on the linear output
(``network.py:156-166``) and updates the raw weights with L2 1e-6,
bias-corrected Adam and then the EMA, tcnn's EMA-optimizer semantics.

The MLP runs through ``ops/mlp_cuda``: ``FusedMLP`` (K3 forward, K4
backward) for inference and ``train_step``, and ``fused_train4`` (K6) for the
four steps of a frame. On CPU tensors they take their plain versions.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Mapping, Optional

import numpy as np
import torch
from torch import nn

from ..config import InputEncoding, NetworkConfig
from ..ops import encodings as E
from ..ops.mlp_cuda import LANE, OUT_PAD, AdamHyper, FusedMLP, adam_ema, fused_train4


class MLPParams(nn.Module):
    """The MLP weights in the JAX layout: w_in [128, 64], w_hidden [H-1, 64, 64],
    w_out [64, 16]. In a ``NetworkState`` only ``params`` require grad."""

    def __init__(self, w_in: torch.Tensor, w_hidden: torch.Tensor, w_out: torch.Tensor):
        super().__init__()
        self.w_in = nn.Parameter(w_in, requires_grad=False)
        self.w_hidden = nn.Parameter(w_hidden, requires_grad=False)
        self.w_out = nn.Parameter(w_out, requires_grad=False)

    def tensors(self) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        return self.w_in, self.w_hidden, self.w_out


@dataclasses.dataclass
class AdamState:
    mu: MLPParams
    nu: MLPParams
    step: torch.Tensor


@dataclasses.dataclass
class NetworkState:
    """Trainable state: raw weights (trained), EMA weights (used for
    inference) and the Adam moments."""

    params: MLPParams
    ema: MLPParams
    opt: AdamState


_WEIGHTS = ("w_in", "w_hidden", "w_out")


def _check_encoding(cfg: NetworkConfig) -> None:
    if cfg.encoding != InputEncoding.FREQUENCY:
        raise NotImplementedError("only the frequency encoding is ported")
    if cfg.n_neurons != 64:
        raise ValueError("the fully-fused path is specialized to 64-wide")


def _state(params: MLPParams, ema: MLPParams, mu: MLPParams, nu: MLPParams,
           step: torch.Tensor) -> NetworkState:
    for p in params.parameters():
        p.requires_grad_(True)
    return NetworkState(params=params, ema=ema, opt=AdamState(mu=mu, nu=nu, step=step))


def init_network(generator: torch.Generator, cfg: NetworkConfig,
                 device: Optional[torch.device] = None) -> NetworkState:
    """He-uniform init as the JAX package draws it (zero outside the encoded
    inputs + ones channel, zero outside the 3 output columns), from a
    ``torch.Generator`` (CPU), then moved to ``device`` (default CPU)."""
    _check_encoding(cfg)
    device = torch.device("cpu") if device is None else device
    n = cfg.n_neurons
    d_in = E.frequency_encoded_dims(cfg)
    assert d_in < LANE

    def uniform(shape, fan_in):
        scale = math.sqrt(6.0 / fan_in)
        return (torch.rand(shape, generator=generator, dtype=torch.float32) * 2.0 - 1.0) * scale

    w_in = torch.zeros((LANE, n), dtype=torch.float32)
    # +1 accounts for the ones-padding channel acting as a bias
    w_in[: d_in + 1] = uniform((d_in + 1, n), d_in + 1)
    w_hidden = uniform((cfg.n_hidden_layers - 1, n, n), n)
    w_out = torch.zeros((n, OUT_PAD), dtype=torch.float32)
    w_out[:, :3] = uniform((n, 3), n)
    weights = [t.to(device) for t in (w_in, w_hidden, w_out)]

    def like(fill):
        return MLPParams(*(fill(t) for t in weights))

    return _state(like(torch.clone), like(torch.clone), like(torch.zeros_like),
                  like(torch.zeros_like), torch.zeros((), dtype=torch.int64, device=device))


def state_from_numpy(tree, device: Optional[torch.device] = None) -> NetworkState:
    """The JAX ``NetworkState`` as numpy -> the port's state, so both
    packages compute with the same weights.

    ``tree`` is either ``jax.tree.map(np.asarray, state)`` (attributes
    ``params``, ``ema``, ``opt``) or a mapping with the keys of
    ``nrc_tpu/models/checkpoint.py:27-40`` (``"params.w_in"``, ...).
    """
    device = torch.device("cpu") if device is None else device
    if isinstance(tree, Mapping):
        get = tree.__getitem__
    else:
        def get(key):
            return functools.reduce(getattr, key.split("."), tree)

    def mlp(prefix):
        return MLPParams(
            *(torch.tensor(np.asarray(get(f"{prefix}.{w}"), np.float32), device=device)
              for w in _WEIGHTS)
        )

    step = torch.tensor(int(np.asarray(get("opt.step"))), dtype=torch.int64, device=device)
    return _state(mlp("params"), mlp("ema"), mlp("opt.mu"), mlp("opt.nu"), step)


def state_to_numpy(state: NetworkState) -> dict:
    """The inverse of ``state_from_numpy``: numpy arrays under the keys of
    ``nrc_tpu/models/checkpoint.py:27-40``, ``"opt.step"`` as int32."""
    out = {}
    for prefix, mlp in (("params", state.params), ("ema", state.ema),
                        ("opt.mu", state.opt.mu), ("opt.nu", state.opt.nu)):
        for w in _WEIGHTS:
            out[f"{prefix}.{w}"] = getattr(mlp, w).detach().cpu().numpy().copy()
    out["opt.step"] = np.int32(int(state.opt.step))
    return out


@torch.no_grad()
def copy_state(dst: NetworkState, src: NetworkState) -> None:
    """Copy ``src``'s weights, EMA, moments and step into ``dst``'s tensors
    (of the same shapes, on any device)."""
    for a, b in ((dst.params, src.params), (dst.ema, src.ema),
                 (dst.opt.mu, src.opt.mu), (dst.opt.nu, src.opt.nu)):
        for t, u in zip(a.tensors(), b.tensors()):
            if t.shape != u.shape:
                raise ValueError(f"network state shape {tuple(u.shape)}, expected {tuple(t.shape)}")
            t.copy_(u)
    dst.opt.step.copy_(src.opt.step)


def _pad_input(x: torch.Tensor, d_in: int) -> torch.Tensor:
    """Pad encoded features to 128 with a single ones channel, then zeros."""
    b = x.shape[0]
    ones = torch.ones((b, 1), dtype=x.dtype, device=x.device)
    pad = torch.zeros((b, LANE - d_in - 1), dtype=x.dtype, device=x.device)
    return torch.cat([x, ones, pad], dim=-1)


def mlp_forward(params: MLPParams, x_padded: torch.Tensor, output_relu: bool = True) -> torch.Tensor:
    """[B, 128] -> [B, 3]; bf16 operands, f32 sums (K3 forward, K4 backward
    on the card). Differentiable in the weights and in x."""
    out = FusedMLP.apply(params.w_in, params.w_hidden, params.w_out, x_padded, output_relu)
    return out[:, :3]


def encode(query: torch.Tensor, cfg: NetworkConfig) -> torch.Tensor:
    _check_encoding(cfg)
    enc = E.encode_frequency(query, cfg)
    return _pad_input(enc, enc.shape[-1])


def infer(state: NetworkState, query: torch.Tensor, cfg: NetworkConfig) -> torch.Tensor:
    """Cache inference with the EMA weights (``Network::infer``, NRCNetwork.cu:61-79)."""
    return mlp_forward(state.ema, encode(query, cfg))


# ---------------------------------------------------------------------------
# Loss + training
# ---------------------------------------------------------------------------

def relative_l2_luminance(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """tcnn RelativeL2Luminance: mean((p - t)^2 / (lum(p)^2 + 0.01)), the
    denominator held constant (``network.py:210-216``)."""
    lum = 0.299 * pred[..., 0] + 0.587 * pred[..., 1] + 0.114 * pred[..., 2]
    denom = (lum * lum).detach() + 0.01
    return torch.mean((pred - target) ** 2 / denom[..., None])


def adam_hyper(cfg: NetworkConfig) -> AdamHyper:
    return AdamHyper(cfg.adam_beta1, cfg.adam_beta2, cfg.adam_eps, cfg.adam_l2_reg, cfg.ema_decay)


def train_step(
    state: NetworkState,
    query: torch.Tensor,   # [B, 15]
    target: torch.Tensor,  # [B, 3]
    cfg: NetworkConfig,
    learning_rate=None,
    loss_scale: Optional[torch.Tensor] = None,
) -> tuple[NetworkState, torch.Tensor]:
    """One SGD step (= one ``trainer->training_step``, NRCNetwork.cu:41-59):
    the loss through ``torch.autograd`` over ``mlp_forward`` (K3 + K4 on the
    card), then L2 1e-6 w, bias-corrected Adam with the step count and the
    EMA. ``loss_scale`` multiplies the loss (0 drops the gradient). Returns
    (new_state, loss); ``state`` is left as it was."""
    lr = cfg.learning_rate if learning_rate is None else learning_rate
    weights = state.params.tensors()
    with torch.enable_grad():
        pred = mlp_forward(state.params, encode(query, cfg), output_relu=False)
        loss = relative_l2_luminance(pred, target)
        if loss_scale is not None:
            loss = loss * loss_scale
        grads = torch.autograd.grad(loss, weights)

    step = state.opt.step + 1
    with torch.no_grad():
        p, m, v, e = zip(*(
            adam_ema(*args, step.to(torch.float32), lr, adam_hyper(cfg))
            for args in zip(weights, grads, state.opt.mu.tensors(), state.opt.nu.tensors(),
                            state.ema.tensors())
        ))
    return _state(MLPParams(*p), MLPParams(*e), MLPParams(*m), MLPParams(*v), step), loss.detach()


def train_frame(
    state: NetworkState,
    batch_q: torch.Tensor,       # [NB, B, 15]
    batch_t: torch.Tensor,       # [NB, B, 3]
    num_records: torch.Tensor,   # int scalar on the state's device
    cfg: NetworkConfig,
    learning_rate: torch.Tensor,  # f32 scalar on the state's device
) -> torch.Tensor:
    """A frame's NB sequential steps (``Device::nrcTrainRadiance``,
    Device.cpp:1473-1513) through K6, updating ``state`` in place; with
    ``num_records`` 0 nothing changes. Returns the losses [NB]."""
    nb, b, qd = batch_q.shape
    x4 = encode(batch_q.reshape(nb * b, qd), cfg).view(nb, b, LANE)
    with torch.no_grad():
        return fused_train4(
            state.params.tensors(), state.opt.mu.tensors(), state.opt.nu.tensors(),
            state.ema.tensors(), state.opt.step, x4, batch_t, learning_rate,
            num_records.to(torch.int64), adam_hyper(cfg),
        )
