"""The hash-grid kernels H1 (lookup) and H2 (adjoint) on the card: checks, limits and times.

Run from the root of a checkout on a machine with one CUDA card:

    python3 -m nrc_tpu_torch.tools.bench_hash

H1 must equal its plain version bit for bit. H2 adds with atomics, so the
order of each table row's sum changes from run to run; it is held to its
plain version by ``CARD_LIMITS``: the mean difference over the table in
units of the mean magnitude of the plain gradient, and the largest
difference in units of the plain gradient's largest entry. Seeded faults
(``FAULTS``: one corner's terms dropped, every level's terms added into the
next level's rows) must read above both limits; ``tests/test_torch_hash.py``
holds that on the CPU, where a summation in another order (the queries
shuffled) stands in for the atomics.

Times are device times of ten calls captured in a CUDA graph and replayed
(``bench_intersect.device_ms``), at the shapes of a 320x320 FULL + train
frame: H1 at B = 128,000 queries (``INFER_ROWS``: the frame's one inference,
over the 102,400 pixels and the 25,600 training rays of its settled 2x2
tiles) and at 16,384 (``STEP_ROWS``: a training step's batch), H2 at
16,384. H2's time by level comes from H2 on the grid cut to those levels
(``sliced``), which does the same work a level. The bound is the larger of
the bytes the function must move over 3.35 TB/s (positions and output
gradient read once, the output or the table gradient written once, the
table read once: at 4.19 MB it stays in the L2) and its float32 operations
over 67 TFLOP/s. No single PyTorch call
computes either; beside H2, ``index_add_`` of the 8 * L * B precomputed
weighted rows is timed as a reading, which is not the same function (its
indices and weights are given, not computed). The last line is one JSON
object.
"""

from __future__ import annotations

import contextlib
import json
import subprocess

import torch

from ..config import InputEncoding, NetworkConfig
from ..models import network as N
from ..ops import encodings as E
from ..ops import hash_cuda as HC
from ..ops.hash_cuda import GridSpec

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

# H2 against its plain version, each limit about 100x above the largest
# reading of a summation in another order (the queries shuffled, on the CPU:
# up to 2.9e-8 on the mean and 4.4e-7 on the largest, full and edge
# configs, positions in the unit cube or in the box [0.25, 0.75]^3 where a
# Cornell frame's lie; tests/test_torch_hash.py) and far below a seeded
# fault (a dropped corner reads 0.18 or more on both, a shifted level
# offset 1.0 or more)
CARD_LIMITS = {
    "h2_mean": 3e-6,      # mean |diff| / mean |plain|
    "h2_largest": 3e-5,   # largest |diff| / largest |plain|
}


# the rows of H1's launches in a 320x320 FULL + train frame with 2x2 tiles
INFER_ROWS = 320 * 320 + (320 // 2) * (320 // 2)   # 128,000: one a frame
STEP_ROWS = 16384                                 # a training batch: four a frame


def full_spec() -> GridSpec:
    """The shipped grid: 16 levels, 2^15 rows, 2 features, base 16, scale 2."""
    return E.grid_spec(NetworkConfig(encoding=InputEncoding.HASH))


def edge_spec() -> GridSpec:
    """A small table (2^10 rows) with base resolution 4: two dense levels,
    then hashed ones."""
    return E.grid_spec(NetworkConfig(encoding=InputEncoding.HASH, hash_log2_size=10, hash_base_resolution=4))


def sliced(spec: GridSpec, begin: int, end: int) -> GridSpec:
    """The grid cut to levels ``begin`` .. ``end - 1``: its lookup and
    adjoint are those levels' columns and rows of the whole grid's."""
    return spec._replace(res=spec.res[begin:end], dense=spec.dense[begin:end])


def adjoint_gap(got: torch.Tensor, ref: torch.Tensor) -> dict:
    """The readings ``CARD_LIMITS`` holds: mean and largest difference, each
    in units of the plain gradient's mean and largest magnitude."""
    d = (got - ref).abs()
    return {"h2_mean": (d.mean() / ref.abs().mean().clamp(min=1e-30)).item(),
            "h2_largest": (d.max() / ref.abs().max().clamp(min=1e-30)).item()}


def within_limits(gap: dict) -> bool:
    return all(gap[k] <= CARD_LIMITS[k] for k in CARD_LIMITS)


def above_limits(gap: dict) -> bool:
    return all(gap[k] > CARD_LIMITS[k] for k in CARD_LIMITS)


def _dropped_corner(pos, g, spec):
    """The adjoint with corner 7's terms left out."""
    n = pos.shape[0]
    L, S, F = spec.table_shape
    ofs = torch.arange(L, device=pos.device) * S
    g3 = g.reshape(n, L, F)
    dflat = torch.zeros((L * S, F), dtype=torch.float32, device=pos.device)
    for corner in range(7):
        idx, w = HC.corner_index_weight(pos, corner, spec)
        dflat.index_add_(0, (idx + ofs).reshape(-1), (w[..., None] * g3).reshape(-1, F))
    return dflat.view(L, S, F)


def _shifted_levels(pos, g, spec):
    """The adjoint with level l's terms added into level l + 1's rows (mod L)."""
    return torch.roll(HC.hash_grid_adjoint_plain(pos, g, spec), 1, dims=0)


FAULTS = {"dropped corner": _dropped_corner, "shifted level offset": _shifted_levels}

# Hash training on the card against the CPU path, and a replayed frame
# against an eager one. H2's atomics change the last bits of the table's
# gradient from run to run, and K4's tensor-core sums differ from the plain
# version's (tools/bench_mlp.py::CARD_LIMITS). With the hash encoding's Adam
# eps of 1e-15 any gradient above 1e-15, a rounding residue included, moves
# its entry by about lr = 1e-2 in the first steps, so an entry whose tiny
# gradient changes sign or leaves zero lands up to 2 lr a step apart. So the
# state is held by the mean difference of each tensor and the share of a
# tensor's entries beyond FAR_AT, not by the largest difference, which is
# printed. Readings on an NVIDIA H100 80GB HBM3 at 700 W, in chip_smoke.py's
# phases:
FAR_AT = 1e-3
HASH_LIMITS = {
    # four train_steps at B = 16,384 of distinct random queries, the card
    # against the CPU, three calls: losses 1.0e-5 to 1.14e-4 relative, state
    # mean 2.3e-6 to 1.30e-5, share beyond FAR_AT 1.0e-4 to 1.05e-3 (largest
    # |diff| 0.052-0.059)
    "steps_loss": 2e-3, "steps_mean": 1e-4, "steps_far": 1e-2,
    # one replayed FULL + train hash frame at 320x320 (4x4 tiles) against an
    # eager one from the same state, the second hash frame after
    # set_encoding (its image, records and step must be equal bit for bit):
    # the frame's loss and the state after its four steps. Readings in
    # seven runs (four processes): the replayed frame and a second eager one
    # alike, loss 0, state mean 4.3e-11 to 5.3e-11, share beyond FAR_AT 0
    # (largest |diff| 1.5e-8 to 6.0e-8); the frame replayed with one
    # train_step dropped (dropped_train_step) loss 0.131, mean 6.1e-3, share
    # 0.90. The limits let one entry of the smallest tensor (w_out, 1024
    # entries) land 2 lr apart, a gradient residue's sign flip under Adam's
    # eps of 1e-15 (2e-5 on the mean, 1e-3 on the share), and sit 60x and
    # more under the planted fault
    "replay_loss": 1e-3, "replay_mean": 1e-4, "replay_far": 2e-3,
    # one 32x32 FULL + train frame (8x8 tiles, 18 records), the card against
    # the CPU: pixels within 1e-3 0.9980, means 4.7e-6 apart, loss 5.4e-3
    # relative, state mean 7.2e-4, share 0.132 (a batch of 18 distinct
    # records leaves most of w_in's gradient at rounding level)
    "frame_close": 0.98, "frame_mean_gap": 1e-4, "frame_loss": 5e-2, "frame_mean": 5e-3, "frame_far": 0.4,
}


@contextlib.contextmanager
def dropped_train_step():
    """A planted fault for the replay check: while it is active, a hash
    frame's training runs one ``train_step`` fewer (a graph captured then
    keeps the fault at every replay)."""
    steps = N._train_frame_steps

    def fewer(state, batch_q, batch_t, num_records, cfg, learning_rate):
        return steps(state, batch_q[:-1], batch_t[:-1], num_records, cfg, learning_rate)

    N._train_frame_steps = fewer
    try:
        yield
    finally:
        N._train_frame_steps = steps


def frame_gap(r, ref) -> dict:
    """Renderer ``r``'s last frame against ``ref``'s, both run from the same
    state: whether the image, the records, the traced rays and the step
    count are equal bit for bit; the loss's relative difference; the state's
    ``state_gap``."""
    a, b = r.last_stats, ref.last_stats
    return {"image_equal": bool(torch.equal(r.image, ref.image)),
            "counts_equal": bool(torch.equal(a.num_train_records, b.num_train_records)
                                 and torch.equal(a.traced_rays, b.traced_rays)),
            "step_equal": int(r.net_state.opt.step) == int(ref.net_state.opt.step),
            "loss": abs(float(a.loss) / float(b.loss) - 1.0),
            **state_gap(r.net_state, ref.net_state)}


def replay_within_limits(gap: dict) -> bool:
    """``frame_gap`` of a replayed frame within ``HASH_LIMITS``."""
    lim = HASH_LIMITS
    return (gap["image_equal"] and gap["counts_equal"] and gap["step_equal"] and gap["loss"] <= lim["replay_loss"]
            and gap["mean"] <= lim["replay_mean"] and gap["far"] <= lim["replay_far"])


def replay_state_above_limits(gap: dict) -> bool:
    """A planted fault's state reads above both state limits."""
    return gap["mean"] > HASH_LIMITS["replay_mean"] and gap["far"] > HASH_LIMITS["replay_far"]


def state_gap(a, b, far_at: float = FAR_AT) -> dict:
    """Over the float tensors of two network states (weights, EMA, moments
    and the hash grid's four tables): the largest mean |diff| of a tensor,
    the largest |diff| and the largest share of a tensor's entries beyond
    ``far_at``."""
    means, largest, far = [], [], []
    for x, y in zip(N.state_tensors(a), N.state_tensors(b)):
        d = (x.detach().cpu() - y.detach().cpu()).abs()
        means.append(d.mean().item())
        largest.append(d.max().item())
        far.append((d > far_at).float().mean().item())
    return {"mean": max(means), "largest": max(largest), "far": max(far)}


def inputs(spec: GridSpec, n: int, gen: torch.Generator, device, lo=-0.1, hi=1.1):
    """Positions uniform in [lo, hi]^3 (some outside the unit cube), a table
    U(-1, 1) and an output gradient N(0, 1), from ``gen``."""
    pos = torch.rand((n, 3), generator=gen, device=device) * (hi - lo) + lo
    table = torch.rand(spec.table_shape, generator=gen, device=device) * 2.0 - 1.0
    g = torch.randn((n, spec.levels * spec.features), generator=gen, device=device)
    return pos, table, g


def work(n: int, spec: GridSpec) -> dict:
    """Bytes and float32 operations H1 or H2 must do for ``n`` queries."""
    L, S, F = spec.table_shape
    table_bytes = L * S * F * 4
    feat_bytes = n * L * F * 4
    # per (query, level): 3 x (multiply, floor, subtract) for the cell, the
    # 3 complements, 2 multiplies per corner weight, and per corner F
    # multiply-adds (H1) or F multiplies (H2, the adds are the atomics')
    ops = n * L * (9 + 3 + 8 * (2 + 2 * F))
    nbytes = n * 12 + feat_bytes + table_bytes
    return {"nbytes": nbytes, "ops": ops}


def bound(n: int, spec: GridSpec) -> dict:
    w = work(n, spec)
    by_bytes = 1e3 * w["nbytes"] / HBM_BYTES_PER_S
    by_ops = 1e3 * w["ops"] / F32_OPS_PER_S
    return {"bound_ms": max(by_bytes, by_ops), "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def check_lookup(spec: GridSpec, n: int, gen: torch.Generator, device) -> dict:
    """H1 against its plain version at ``n`` queries: the words that differ
    and the largest |difference| (both must be 0)."""
    pos, table, _ = inputs(spec, n, gen, device)
    got = HC.hash_grid_lookup_cuda(pos, table, spec)
    ref = HC.hash_grid_lookup_plain(pos, table, spec)
    torch.cuda.synchronize(device)
    return {"n": n, "words": got.numel(), "differing": int((got.view(torch.int32) != ref.view(torch.int32)).sum()),
            "max_abs": (got - ref).abs().max().item() if n else 0.0}


def check(spec: GridSpec, n_lookup: int, n_adjoint: int, gen: torch.Generator, device, label: str) -> dict:
    """H1 bit for bit and H2 within ``CARD_LIMITS`` at ``spec``; two H2 runs'
    spread; the seeded faults above the limits. Raises on a failure and
    returns the readings."""
    h1 = check_lookup(spec, n_lookup, gen, device)
    if h1["differing"]:
        raise AssertionError(f"H1 {label}: {h1['differing']} of {h1['words']} words differ from the plain version")
    pos, _, g = inputs(spec, n_adjoint, gen, device)
    # the hash columns of a [B, 128] dX, read through its row stride
    dx = torch.zeros((n_adjoint, 128), device=device)
    dx[:, :g.shape[1]] = g
    g_view = dx[:, :g.shape[1]]
    a = HC.hash_grid_adjoint_cuda(pos, g_view, spec)
    b = HC.hash_grid_adjoint_cuda(pos, g_view, spec)
    ref = HC.hash_grid_adjoint_plain(pos, g, spec)
    torch.cuda.synchronize(device)
    gap = adjoint_gap(a, ref)
    spread = adjoint_gap(a, b)
    faults = {name: adjoint_gap(fault(pos, g, spec), ref) for name, fault in FAULTS.items()}
    out = {"h1": h1, "h2": gap, "h2_max_abs": (a - ref).abs().max().item(), "h2_run_to_run": spread,
           "h2_bits_equal_run_to_run": bool(torch.equal(a, b)), "faults": faults}
    if not within_limits(gap):
        raise AssertionError(f"H2 {label}: {gap} outside {CARD_LIMITS}")
    for name, reading in faults.items():
        if not above_limits(reading):
            raise AssertionError(f"H2 {label}: the seeded fault '{name}' reads {reading}, not above {CARD_LIMITS}")
    return out


def times(spec: GridSpec, n_lookup: int, n_adjoint: int, gen: torch.Generator, device) -> dict:
    """Device times of H1 (at ``n_lookup`` and at ``n_adjoint`` queries) and
    H2, their plain versions, bounds, H2's time on the dense levels and on
    the hashed ones (H2 on the grid cut to them) and the ``index_add_``
    reading beside H2."""
    from . import bench_intersect as BI

    def lookup(n):
        pos, table, _ = inputs(spec, n, gen, device, 0.0, 1.0)
        return {"n": n,
                "ms": BI.device_ms(lambda: HC.hash_grid_lookup_cuda(pos, table, spec)),
                "plain_ms": BI.device_ms(lambda: HC.hash_grid_lookup_plain(pos, table, spec), iters=5),
                **bound(n, spec), "library_ms": None}

    h1, h1_steps = lookup(n_lookup), lookup(n_adjoint)
    pos2, _, g = inputs(spec, n_adjoint, gen, device, 0.0, 1.0)
    h2 = {"n": n_adjoint,
          "ms": BI.device_ms(lambda: HC.hash_grid_adjoint_cuda(pos2, g, spec)),
          "plain_ms": BI.device_ms(lambda: HC.hash_grid_adjoint_plain(pos2, g, spec), iters=5),
          **bound(n_adjoint, spec), "library_ms": None}
    n_dense = sum(spec.dense)
    split = {}
    if 0 < n_dense < spec.levels:
        F = spec.features
        for name, (lo, hi) in ((f"dense levels 0-{n_dense - 1}", (0, n_dense)),
                               (f"hashed levels {n_dense}-{spec.levels - 1}", (n_dense, spec.levels))):
            part, g_part = sliced(spec, lo, hi), g[:, lo * F:hi * F]
            split[name] = BI.device_ms(lambda: HC.hash_grid_adjoint_cuda(pos2, g_part, part))
    h2["by_level_ms"] = split
    # index_add_ of the precomputed weighted rows: a reading, not the same function
    L, S, F = spec.table_shape
    ofs = torch.arange(L, device=device) * S
    rows, vals = [], []
    for corner in range(8):
        idx, w = HC.corner_index_weight(pos2, corner, spec)
        rows.append((idx + ofs).reshape(-1))
        vals.append((w[..., None] * g.view(n_adjoint, L, F)).reshape(-1, F))
    rows, vals = torch.cat(rows), torch.cat(vals)
    h2["index_add_ms_precomputed_rows"] = BI.device_ms(
        lambda: torch.zeros((L * S, F), device=device).index_add_(0, rows, vals))
    return {"H1": h1, "H1_steps": h1_steps, "H2": h2, "table_update_ms": table_update_ms(spec, device)}


def table_update_ms(spec: GridSpec, device) -> float:
    """Device time of one step's Adam + EMA over the table (``adam_ema``
    without the L2 term, plain PyTorch: a training frame runs four)."""
    from ..ops import mlp_cuda as MC
    from . import bench_intersect as BI

    cfg = NetworkConfig(encoding=InputEncoding.HASH)
    p, g, m, v, e = (torch.rand(spec.table_shape, device=device) for _ in range(5))
    t = torch.tensor(3.0, device=device)
    lr = torch.tensor(cfg.learning_rate, device=device)
    hyper = N.adam_hyper(cfg)._replace(l2=0.0)
    return BI.device_ms(lambda: MC.adam_ema(p, g, m, v, e, t, lr, hyper))


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("bench_hash: no CUDA device is available")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    HC.LOOKUP_KERNEL.build()
    HC.ADJOINT_KERNEL.build()
    result = {"checks": {"full": check(full_spec(), INFER_ROWS, STEP_ROWS, gen, dev, "full"),
                         "full, H1 at a step's rows": check_lookup(full_spec(), STEP_ROWS, gen, dev),
                         "edge": check(edge_spec(), 1001, 999, gen, dev, "edge")},
              "times": times(full_spec(), INFER_ROWS, STEP_ROWS, gen, dev)}
    if result["checks"]["full, H1 at a step's rows"]["differing"]:
        raise AssertionError("H1 at a step's rows differs from the plain version")
    result["device"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
