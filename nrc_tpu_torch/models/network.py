"""The NRC network for cache inference: encoding + 64-wide fully-fused MLP.

Port of the inference side of ``nrc_tpu/models/network.py`` (reference
``nrc/src/NRCNetwork.cu:41-128`` / ``nrc/inc/NRCNetworkConfigs.h``):
FullyFusedMLP(ReLU, output ReLU, 64 neurons, 5 hidden layers), bias-free,
input padded to 128 with one ones channel (a bias) and zeros. Inference uses
the EMA weights and clamps the output with a ReLU (``network.py:156-204``).

The MLP runs through ``ops/mlp_cuda.fused_forward``: kernel K3 on the card,
its plain version on the CPU. Training (Adam + EMA steps, kernels K4-K6) is
not ported yet; the Adam moments are carried so a JAX state round-trips.
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
from ..ops.mlp_cuda import LANE, OUT_PAD, fused_forward


class MLPParams(nn.Module):
    """The MLP weights in the JAX layout: w_in [128, 64], w_hidden [H-1, 64, 64],
    w_out [64, 16]."""

    def __init__(self, w_in: torch.Tensor, w_hidden: torch.Tensor, w_out: torch.Tensor):
        super().__init__()
        self.w_in = nn.Parameter(w_in, requires_grad=False)
        self.w_hidden = nn.Parameter(w_hidden, requires_grad=False)
        self.w_out = nn.Parameter(w_out, requires_grad=False)


@dataclasses.dataclass
class AdamState:
    mu: MLPParams
    nu: MLPParams
    step: torch.Tensor


@dataclasses.dataclass
class NetworkState:
    """Trainable state: raw weights, EMA weights (used for inference) and
    the Adam moments."""

    params: MLPParams
    ema: MLPParams
    opt: AdamState


_WEIGHTS = ("w_in", "w_hidden", "w_out")


def _check_encoding(cfg: NetworkConfig) -> None:
    if cfg.encoding != InputEncoding.FREQUENCY:
        raise NotImplementedError("only the frequency encoding is ported")
    if cfg.n_neurons != 64:
        raise ValueError("the fully-fused path is specialized to 64-wide")


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
    params = MLPParams(w_in, w_hidden, w_out).to(device)

    def like(fill):
        return MLPParams(*(fill(getattr(params, w)) for w in _WEIGHTS))

    return NetworkState(
        params=params,
        ema=like(torch.clone),
        opt=AdamState(
            mu=like(torch.zeros_like),
            nu=like(torch.zeros_like),
            step=torch.zeros((), dtype=torch.int64, device=device),
        ),
    )


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
            *(torch.tensor(np.asarray(get(f"{prefix}.{w}"), np.float32)) for w in _WEIGHTS)
        ).to(device)

    return NetworkState(
        params=mlp("params"),
        ema=mlp("ema"),
        opt=AdamState(
            mu=mlp("opt.mu"),
            nu=mlp("opt.nu"),
            step=torch.tensor(int(np.asarray(get("opt.step"))), dtype=torch.int64, device=device),
        ),
    )


def _pad_input(x: torch.Tensor, d_in: int) -> torch.Tensor:
    """Pad encoded features to 128 with a single ones channel, then zeros."""
    b = x.shape[0]
    ones = torch.ones((b, 1), dtype=x.dtype, device=x.device)
    pad = torch.zeros((b, LANE - d_in - 1), dtype=x.dtype, device=x.device)
    return torch.cat([x, ones, pad], dim=-1)


def mlp_forward(params: MLPParams, x_padded: torch.Tensor, output_relu: bool = True) -> torch.Tensor:
    """[B, 128] -> [B, 3]; bf16 operands, f32 sums (K3 on the card)."""
    out = fused_forward(params.w_in, params.w_hidden, params.w_out, x_padded, output_relu)
    return out[:, :3]


def encode(query: torch.Tensor, cfg: NetworkConfig) -> torch.Tensor:
    _check_encoding(cfg)
    enc = E.encode_frequency(query, cfg)
    return _pad_input(enc, enc.shape[-1])


def infer(state: NetworkState, query: torch.Tensor, cfg: NetworkConfig) -> torch.Tensor:
    """Cache inference with the EMA weights (``Network::infer``, NRCNetwork.cu:61-79)."""
    return mlp_forward(state.ema, encode(query, cfg))
