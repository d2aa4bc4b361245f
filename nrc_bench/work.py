"""The least time the card could take for the cache's kernels, and the
frame's model operations, counted from the launch shapes.

The peaks are NVIDIA's data sheet for the H100 SXM (dense rates, at the
700 W limit). ``mlp_work`` follows ``nrc_tpu_torch/tools/bench_mlp.py::
mlp_work`` and ``hash_work`` is a frozen copy of ``nrc_tpu_torch/tools/
bench_hash.py::work``: each input read once and each output written once.
The MLP is counted at the network's own widths, as the function needs them:
the encoded inputs and a ones channel (the bias), the hidden layers, three
outputs. The kernels' padding (128 input lanes, 16 output lanes), the
per-CTA partial sums and H2's 64-bit sums, which the designs move on top,
are not counted.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

HBM_BYTES_PER_S = 3.35e12
BF16_OPS_PER_S = 989e12   # dense bf16 on the tensor cores
F32_OPS_PER_S = 67e12     # float32 outside the tensor cores

OUTPUTS = 3  # the cache's radiance


def encoded_dims(net: dict) -> int:
    """The encoding's output width (``ops/encodings.py``)."""
    tail = 6 * net["oneblob_n_bins"] + 6
    if net["encoding"] == "frequency":
        return 3 * net["freq_n_frequencies"] + tail
    return net["hash_n_levels"] * net["hash_n_features_per_level"] + tail


def num_params(net: dict) -> int:
    """The MLP's weights: the encoded inputs and the ones channel into the
    first hidden layer, the hidden layers, three outputs."""
    width = net["n_neurons"]
    return (encoded_dims(net) + 1) * width + (net["n_hidden_layers"] - 1) * width * width + width * OUTPUTS


def mlp_work(kernel: str, rows: int, net: dict, steps: int = 4) -> dict:
    """Bytes and operations of K3-K6's functions on ``rows`` rows (K6:
    ``steps`` batches of ``rows``): K3 reads the inputs and writes the
    outputs; K4 reads the inputs and the outputs' gradient and writes the
    inputs' gradient; K5 reads the inputs, the targets and writes the loss;
    each reads the weights once and K4/K5 write their gradient; K6 moves the
    weights, their gradient and Adam's and the EMA's state once a step."""
    d_in = encoded_dims(net)
    macs = num_params(net)
    w_bytes = 4 * macs
    k5_ops = 2 * (3 * macs - (d_in + 1) * net["n_neurons"]) * rows  # no gradient of the inputs
    if kernel == "K3":
        return dict(nbytes=4 * rows * (d_in + OUTPUTS) + w_bytes, ops=2 * macs * rows)
    if kernel == "K4":
        return dict(nbytes=4 * rows * (2 * d_in + OUTPUTS) + 2 * w_bytes, ops=2 * 3 * macs * rows)
    if kernel == "K5":
        return dict(nbytes=4 * (rows * (d_in + OUTPUTS) + 1) + 2 * w_bytes, ops=k5_ops)
    if kernel == "K6":
        return dict(nbytes=4 * steps * (rows * (d_in + OUTPUTS) + 1) + 8 * w_bytes, ops=steps * k5_ops)
    raise ValueError(f"unknown kernel {kernel}")


def hash_work(n: int, levels: int, log2_size: int, features: int) -> dict:
    """Bytes and float32 operations of H1 or H2 for ``n`` queries."""
    table_bytes = levels * (1 << log2_size) * features * 4
    feat_bytes = n * levels * features * 4
    ops = n * levels * (9 + 3 + 8 * (2 + 2 * features))
    return dict(nbytes=n * 12 + feat_bytes + table_bytes, ops=ops)


def least_ms(work: dict, ops_per_s: float) -> float:
    return 1e3 * max(work["nbytes"] / HBM_BYTES_PER_S, work["ops"] / ops_per_s)


def cache_launches(encoding: str, queries: int, batch: int, batches: int, net: dict) -> List[Tuple[str, float]]:
    """(group, least ms) of every launch of the cache's kernels in one FULL
    + train frame: ``queries`` inference rows (pixels and training ends).
    Frequency: one K3 and one K6. Hash: K3 and H1 for the inference and for
    each step, K4 and H2 for each step."""
    if encoding == "frequency":
        return [("K3 nrc_mlp_forward", least_ms(mlp_work("K3", queries, net), BF16_OPS_PER_S)),
                ("K6 nrc_mlp_train4", least_ms(mlp_work("K6", batch, net, batches), BF16_OPS_PER_S))]
    grid = (net["hash_n_levels"], net["hash_log2_size"], net["hash_n_features_per_level"])
    out = [("K3 nrc_mlp_forward", least_ms(mlp_work("K3", queries, net), BF16_OPS_PER_S)),
           ("H1 nrc_hash_lookup", least_ms(hash_work(queries, *grid), F32_OPS_PER_S))]
    for _ in range(batches):
        out += [("K3 nrc_mlp_forward", least_ms(mlp_work("K3", batch, net), BF16_OPS_PER_S)),
                ("H1 nrc_hash_lookup", least_ms(hash_work(batch, *grid), F32_OPS_PER_S)),
                ("K4 nrc_mlp_backward", least_ms(mlp_work("K4", batch, net), BF16_OPS_PER_S)),
                ("H2 nrc_hash_adjoint", least_ms(hash_work(batch, *grid), F32_OPS_PER_S))]
    return out


def frame_model_flops(queries: int, batch: int, batches: int, net: dict) -> float:
    """The MLP's operations in one FULL + train frame (``num_params``): a
    forward on every query, and each training step's batch as forward +
    backward = 3 forwards."""
    return 2.0 * num_params(net) * (queries + 3 * batch * batches)


def groups_of(launches: List[Tuple[str, float]]) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for g, _ in launches:
        out[g] = out.get(g, 0) + 1
    return out
