"""The NRC network: encoding + 64-wide fully-fused MLP, RelativeL2Luminance
loss, Adam + EMA training.

Port of ``nrc_tpu/models/network.py`` (reference
``nrc/src/NRCNetwork.cu:41-128`` / ``nrc/inc/NRCNetworkConfigs.h``):
FullyFusedMLP(ReLU, 64 neurons, 5 hidden layers), bias-free, input padded to
128 with one ones channel (a bias) and zeros. Inference uses the EMA weights
and clamps the output with a ReLU; training runs on the linear output
(``network.py:156-166``) and updates the raw weights with L2 1e-6,
bias-corrected Adam and then the EMA, tcnn's EMA-optimizer semantics. With
the hash encoding the table trains too: Adam without the L2 term, then its
own EMA, which inference reads (``network.py:369-380``).

The MLP runs through ``ops/mlp_cuda``: ``FusedMLP`` (K3 forward, K4
backward) for inference and ``train_step``, and ``fused_train4`` (K6) for the
four steps of a frequency frame. A hash frame runs four ``train_step``s
instead, since its encoded input depends on the table: each is H1 -> K3 ->
K4 (with dX) -> H2 -> Adam + EMA. On CPU tensors the kernels take their
plain versions.

Data-parallel training (``parallel/shard.py``) reduces each step's
gradients across the ranks between the gradient and the update
(``grad_reduce``, ``grid_grad_reduce``; ``nrc_tpu/models/network.py:239-340``).
K6 runs a frame's four steps in one launch and cannot reduce between them,
so a frequency frame with a ``grad_reduce`` takes each step as K5 (loss and
gradients), the reduction, then the plain Adam + EMA. With
``NetworkConfig.hash_shard_axis`` set, a rank's state holds its block of the
table's levels (``state_from_numpy``'s ``level_block``) and the lookup is
``encodings.sharded_hash_grid_lookup``.
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
from ..ops.mlp_cuda import LANE, OUT_PAD, AdamHyper, FusedMLP, adam_ema, fused_train4, fused_train_grad
from ..utils.spans import TABLE_UPDATE_RANGE, profiler_range


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
    # the hash table's moments when the hash encoding is active
    mu_grid: Optional[torch.Tensor] = None
    nu_grid: Optional[torch.Tensor] = None


@dataclasses.dataclass
class NetworkState:
    """Trainable state: raw weights (trained), EMA weights (used for
    inference) and the Adam moments; with the hash encoding the table and
    its EMA too."""

    params: MLPParams
    ema: MLPParams
    opt: AdamState
    grid: Optional[E.HashGridParams] = None
    ema_grid: Optional[E.HashGridParams] = None


_WEIGHTS = ("w_in", "w_hidden", "w_out")
# the hash state's checkpoint keys (nrc_tpu/models/checkpoint.py:41-45)
GRID_KEYS = ("grid.table", "ema_grid.table", "opt.mu_grid", "opt.nu_grid")


def _check_encoding(cfg: NetworkConfig) -> None:
    if cfg.encoding not in (InputEncoding.FREQUENCY, InputEncoding.HASH):
        raise ValueError(f"unknown encoding {cfg.encoding}")
    if cfg.n_neurons != 64:
        raise ValueError("the fully-fused path is specialized to 64-wide")


def _state(params: MLPParams, ema: MLPParams, mu: MLPParams, nu: MLPParams,
           step: torch.Tensor, grid=None) -> NetworkState:
    """``grid``: None, or (table, ema table, mu, nu) tensors of the hash grid."""
    for p in params.parameters():
        p.requires_grad_(True)
    opt = AdamState(mu=mu, nu=nu, step=step)
    if grid is None:
        return NetworkState(params=params, ema=ema, opt=opt)
    table, ema_table, opt.mu_grid, opt.nu_grid = grid
    table.requires_grad_(True)
    return NetworkState(params=params, ema=ema, opt=opt, grid=E.HashGridParams(table),
                        ema_grid=E.HashGridParams(ema_table))


def _encoded_dims(cfg: NetworkConfig) -> int:
    if cfg.encoding == InputEncoding.FREQUENCY:
        return E.frequency_encoded_dims(cfg)
    return E.hash_encoded_dims(cfg)


def init_network(generator: torch.Generator, cfg: NetworkConfig,
                 device: Optional[torch.device] = None) -> NetworkState:
    """He-uniform init as the JAX package draws it (zero outside the encoded
    inputs + ones channel, zero outside the 3 output columns), from a
    ``torch.Generator`` (CPU), then moved to ``device`` (default CPU). With
    the hash encoding the table is drawn after the weights, U(-1e-4, 1e-4);
    its EMA starts equal to it and its moments at zero."""
    _check_encoding(cfg)
    device = torch.device("cpu") if device is None else device
    n = cfg.n_neurons
    d_in = _encoded_dims(cfg)
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

    grid = None
    if cfg.encoding == InputEncoding.HASH:
        table = E.init_hash_grid(generator, cfg).table.to(device)
        grid = (table, table.clone(), torch.zeros_like(table), torch.zeros_like(table))
    return _state(like(torch.clone), like(torch.clone), like(torch.zeros_like),
                  like(torch.zeros_like), torch.zeros((), dtype=torch.int64, device=device), grid)


def state_from_numpy(tree, device: Optional[torch.device] = None,
                     level_block: Optional[slice] = None) -> NetworkState:
    """The JAX ``NetworkState`` as numpy -> the port's state, so both
    packages compute with the same weights.

    ``tree`` is either ``jax.tree.map(np.asarray, state)`` (attributes
    ``params``, ``ema``, ``opt``, and ``grid``, ``ema_grid`` with the hash
    encoding) or a mapping with the keys of
    ``nrc_tpu/models/checkpoint.py:27-45`` (``"params.w_in"``, ...,
    ``"grid.table"``, ...). ``level_block`` takes those levels of the hash
    table, its EMA and its moments: one rank's block of a level-sharded
    table (``parallel/shard.py::rank_state``).
    """
    device = torch.device("cpu") if device is None else device
    if isinstance(tree, Mapping):
        get = tree.__getitem__
        has_grid = "grid.table" in tree
    else:
        def get(key):
            return functools.reduce(getattr, key.split("."), tree)

        has_grid = getattr(tree, "grid", None) is not None

    def mlp(prefix):
        return MLPParams(
            *(torch.tensor(np.asarray(get(f"{prefix}.{w}"), np.float32), device=device)
              for w in _WEIGHTS)
        )

    step = torch.tensor(int(np.asarray(get("opt.step"))), dtype=torch.int64, device=device)
    grid = None
    if has_grid:
        block = slice(None) if level_block is None else level_block
        grid = tuple(torch.tensor(np.asarray(get(k), np.float32)[block], device=device) for k in GRID_KEYS)
    return _state(mlp("params"), mlp("ema"), mlp("opt.mu"), mlp("opt.nu"), step, grid)


def _grid_tensors(state: NetworkState) -> tuple:
    """(table, ema table, mu, nu) of the hash grid, or () without one."""
    if state.grid is None:
        return ()
    return (state.grid.table, state.ema_grid.table, state.opt.mu_grid, state.opt.nu_grid)


def state_tensors(state: NetworkState) -> list:
    """Every float tensor of the state, in a fixed order."""
    return [t for m in (state.params, state.ema, state.opt.mu, state.opt.nu)
            for t in m.tensors()] + list(_grid_tensors(state))


def state_to_numpy(state: NetworkState) -> dict:
    """The inverse of ``state_from_numpy``: numpy arrays under the keys of
    ``nrc_tpu/models/checkpoint.py:27-45``, ``"opt.step"`` as int32."""
    out = {}
    for prefix, mlp in (("params", state.params), ("ema", state.ema),
                        ("opt.mu", state.opt.mu), ("opt.nu", state.opt.nu)):
        for w in _WEIGHTS:
            out[f"{prefix}.{w}"] = getattr(mlp, w).detach().cpu().numpy().copy()
    out["opt.step"] = np.int32(int(state.opt.step))
    for key, t in zip(GRID_KEYS, _grid_tensors(state)):
        out[key] = t.detach().cpu().numpy().copy()
    return out


@torch.no_grad()
def copy_state(dst: NetworkState, src: NetworkState) -> None:
    """Copy ``src``'s weights, EMA, moments, step and hash grid into
    ``dst``'s tensors (of the same shapes and encoding, on any device)."""
    if (dst.grid is None) != (src.grid is None):
        raise ValueError("network state of another encoding")
    for t, u in zip(state_tensors(dst), state_tensors(src)):
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


def encode(query: torch.Tensor, cfg: NetworkConfig,
           grid: Optional[E.HashGridParams] = None) -> torch.Tensor:
    """[B, 15] -> [B, 128]: the encoding, one ones channel, zeros. The hash
    encoding reads ``grid``."""
    _check_encoding(cfg)
    if cfg.encoding == InputEncoding.FREQUENCY:
        enc = E.encode_frequency(query, cfg)
    else:
        enc = E.encode_hash(query, grid, cfg)
    return _pad_input(enc, enc.shape[-1])


def infer(state: NetworkState, query: torch.Tensor, cfg: NetworkConfig) -> torch.Tensor:
    """Cache inference with the EMA weights and the EMA table
    (``Network::infer``, NRCNetwork.cu:61-79)."""
    return mlp_forward(state.ema, encode(query, cfg, state.ema_grid))


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
    grad_reduce=None,
    grid_grad_reduce=None,
) -> tuple[NetworkState, torch.Tensor]:
    """One SGD step (= one ``trainer->training_step``, NRCNetwork.cu:41-59):
    the loss through ``torch.autograd`` over ``mlp_forward`` (K3 + K4 on the
    card) and, with the hash encoding, over the table's lookup (H1 + H2),
    then L2 1e-6 w, bias-corrected Adam with the step count and the EMA; the
    table takes Adam without the L2 term and its own EMA
    (``nrc_tpu/models/network.py:369-380``). ``loss_scale`` multiplies the
    loss (0 drops the gradient). Returns (new_state, loss); ``state`` is left
    as it was.

    ``grad_reduce`` maps a list of gradients to their reductions across the
    ranks: the weights' and the table's, or with ``grid_grad_reduce`` (a
    function of the table's gradient) the weights' alone; both apply before
    the L2 term and Adam
    (``nrc_tpu/models/network.py:318-323``). A frequency step with a
    ``grad_reduce`` takes its loss and gradients from K5
    (``fused_train_grad``), not from autograd over K3 + K4."""
    lr = cfg.learning_rate if learning_rate is None else learning_rate
    weights = state.params.tensors()
    leaves = weights if state.grid is None else (*weights, state.grid.table)
    if grad_reduce is not None and state.grid is None:
        with torch.no_grad():
            x = encode(query, cfg)
            loss, *grads = fused_train_grad(*weights, x, target)
            if loss_scale is not None:
                loss = loss * loss_scale
                grads = [g * loss_scale for g in grads]
    else:
        with torch.enable_grad():
            x = encode(query, cfg, state.grid)
            pred = mlp_forward(state.params, x, output_relu=False)
            loss = relative_l2_luminance(pred, target)
            if loss_scale is not None:
                loss = loss * loss_scale
            grads = torch.autograd.grad(loss, leaves)
    if grad_reduce is not None and grid_grad_reduce is None:
        grads = grad_reduce(list(grads))
    elif grad_reduce is not None:
        grads = [*grad_reduce(list(grads[:3])), grid_grad_reduce(grads[3])]

    step = state.opt.step + 1
    t = step.to(torch.float32)
    hyper = adam_hyper(cfg)
    with torch.no_grad():
        p, m, v, e = zip(*(
            adam_ema(*args, t, lr, hyper)
            for args in zip(weights, grads, state.opt.mu.tensors(), state.opt.nu.tensors(),
                            state.ema.tensors())
        ))
        grid = None
        if state.grid is not None:
            with profiler_range(TABLE_UPDATE_RANGE):
                gp, gm, gv, ge = adam_ema(state.grid.table, grads[-1], state.opt.mu_grid, state.opt.nu_grid,
                                          state.ema_grid.table, t, lr, hyper._replace(l2=0.0))
            grid = (gp, ge, gm, gv)
    return (_state(MLPParams(*p), MLPParams(*e), MLPParams(*m), MLPParams(*v), step, grid),
            loss.detach())


def train_frame(
    state: NetworkState,
    batch_q: torch.Tensor,       # [NB, B, 15]
    batch_t: torch.Tensor,       # [NB, B, 3]
    num_records: torch.Tensor,   # int scalar on the state's device
    cfg: NetworkConfig,
    learning_rate: torch.Tensor,  # f32 scalar on the state's device
    grad_reduce=None,
    grid_grad_reduce=None,
    loss_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """A frame's NB sequential steps (``Device::nrcTrainRadiance``,
    Device.cpp:1473-1513), updating ``state`` in place; with ``num_records``
    0 nothing changes. Returns the losses [NB]. The frequency encoding runs
    them through K6; the hash encoding, and any frame whose gradients are
    reduced across ranks (``grad_reduce``, ``grid_grad_reduce``, each step's
    loss times ``loss_scale``; ``num_records`` is then the reduced count), as
    NB ``train_step``s (``_train_frame_steps``)."""
    if cfg.encoding == InputEncoding.HASH or grad_reduce is not None:
        return _train_frame_steps(state, batch_q, batch_t, num_records, cfg, learning_rate,
                                  dict(grad_reduce=grad_reduce, grid_grad_reduce=grid_grad_reduce,
                                       loss_scale=loss_scale))
    nb, b, qd = batch_q.shape
    x4 = encode(batch_q.reshape(nb * b, qd), cfg).view(nb, b, LANE)
    with torch.no_grad():
        return fused_train4(
            state.params.tensors(), state.opt.mu.tensors(), state.opt.nu.tensors(),
            state.ema.tensors(), state.opt.step, x4, batch_t, learning_rate,
            num_records.to(torch.int64), adam_hyper(cfg),
        )


@torch.no_grad()
def _train_frame_steps(state, batch_q, batch_t, num_records, cfg, learning_rate,
                       step_kw=None) -> torch.Tensor:
    """``train_frame`` as NB ``train_step``s (the JAX package's scan,
    ``nrc_tpu/render/frame.py:364-390``), each given ``step_kw``. The JAX
    package skips the whole update when the frame has no records
    (``lax.cond``); here the steps run and every tensor of the state, the
    step count too, keeps its old value where ``num_records`` is 0, selected
    on the device without a read, so that the frame stays one CUDA graph."""
    new, losses = state, []
    for k in range(batch_q.shape[0]):
        new, loss = train_step(new, batch_q[k], batch_t[k], cfg, learning_rate=learning_rate,
                               **(step_kw or {}))
        losses.append(loss)
    keep = num_records > 0
    for old, t in zip(state_tensors(state), state_tensors(new)):
        old.copy_(torch.where(keep, t, old))
    state.opt.step.copy_(torch.where(keep, new.opt.step, state.opt.step))
    return torch.where(keep, torch.stack(losses), 0.0)
