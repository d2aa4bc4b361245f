"""The hash-grid kernels H1 (lookup) and H2 (adjoint) on the card: checks, limits and times.

Run from the root of a checkout on a machine with one CUDA card:

    python3 -m nrc_tpu_torch.tools.bench_hash [--frame [--parent DIR]]

H1 must equal its plain version bit for bit. H2 sums each table row's
terms as 64-bit fixed-point numbers (``csrc/hash_grid.cu``'s header), so it
gives the same bits on every launch and equals ``fixed_point_adjoint``, its
arithmetic in plain PyTorch, bit for bit; against the f32 plain version,
which rounds each add, it is held by ``CARD_LIMITS``: the mean difference
over the table in units of the mean magnitude of the plain gradient, and
the largest difference in units of the plain gradient's largest entry.
Beside them ``zero_mismatch_rows`` counts the table rows that are zero in
one and not in the other (Adam's eps of 1e-15 turns such a row into a full
step). Seeded faults (``FAULTS``: one corner's terms dropped, every level's
terms added into the next level's rows) must read above both limits;
``tests/test_torch_hash.py`` holds that on the CPU.

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
over 67 TFLOP/s. H2's pre-sums and both kernels' tiles stay in shared
memory; H2's 64-bit sums in device memory (8 bytes a table float, zeroed,
added into and read once) are its design's own traffic, printed beside H2
as ``scratch_bound_ms`` and no part of the bound. No single PyTorch call
computes either; beside H2, ``index_add_`` of the 8 * L * B precomputed weighted rows is timed as a
reading, which is not the same function (its indices and weights are
given, not computed). The last line is one JSON object.

``--frame`` times the kernels where a frame runs them, since uniform random
positions are not a frame's: it renders the 320x320 Cornell box, hash
FULL + train, until the adaptive tile size has settled, records the inputs
of one eager frame's five H1 launches (the inference in pixel order, four
training batches shuffled by ``assemble_training_batches``) and four H2
launches (positions and g through K4's dX row stride; ``record_frame``),
and ``measure``s each launch and the all-random sets: every build held to
the plain version (H1 bit for bit; H2 within ``CARD_LIMITS``, with whether
two runs, and the fixed-point model, agree bit for bit), its
device time in turns (shipped, parent, parent, shipped; averaged), H2's on
the grid cut to the dense and to the hashed levels, and how many rows a
launch's terms land on (``row_load``: H2's contention). The frame-weighted
time of a build is the sum over the frame's launches. ``--parent DIR``
builds ``DIR/hash_grid.cu``, another tree's source with the same entry
points (``git archive <commit> nrc_tpu_torch/csrc | tar -x -C
build/parent``; a tree whose H2 has no scratch argument, as before the
fixed point, is called without it), and times it beside the shipped build.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import re
import subprocess
from pathlib import Path

import torch

from ..config import InputEncoding, NetworkConfig, RenderMode
from ..models import network as N
from ..ops import encodings as E
from ..ops import hash_cuda as HC
from ..ops.cuda_build import CudaKernel
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


def zero_mismatch_rows(got: torch.Tensor, ref: torch.Tensor) -> int:
    """Table rows [L, S] that are all zero in one gradient and not in the other."""
    return int(((got == 0).all(dim=-1) != (ref == 0).all(dim=-1)).sum())


def level_shifts(g: torch.Tensor, spec: GridSpec) -> list:
    """H2's fixed-point scale 2^s a level (``csrc/hash_grid.cu::level_shift``):
    the level's largest |g| below 2^e, a row's at most 8 B terms below 2^62,
    s = 62 - ceil(log2(8 B)) - e; 0 for a level whose g is all zero."""
    n = g.shape[0]
    headroom = (8 * n - 1).bit_length()
    gmax = g.reshape(n, spec.levels, spec.features).abs().amax(dim=(0, 2)).tolist()
    return [62 - headroom - math.frexp(m)[1] if m > 0.0 else 0 for m in gmax]


def fixed_point_adjoint(pos: torch.Tensor, g: torch.Tensor, spec: GridSpec) -> torch.Tensor:
    """H2's arithmetic in plain PyTorch: each term w * g (f32) times its
    level's 2^s, rounded to the nearest int64 (ties to even), summed as
    integers (in any order: the same bits), times 2^-s rounded to f32 once.
    Equal to the kernel bit for bit."""
    n = pos.shape[0]
    L, S, F = spec.table_shape
    g3 = g.reshape(n, L, F)
    scale = torch.tensor([2.0 ** sh for sh in level_shifts(g, spec)], dtype=torch.float64, device=pos.device)
    ofs = torch.arange(L, device=pos.device) * S
    acc = torch.zeros((L * S, F), dtype=torch.int64, device=pos.device)
    for corner in range(8):
        idx, w = HC.corner_index_weight(pos, corner, spec)
        q = torch.round((w[..., None] * g3).double() * scale[:, None]).to(torch.int64)
        acc.index_add_(0, (idx + ofs).reshape(-1), q.reshape(-1, F))
    return (acc.view(L, S, F).double() * (1.0 / scale)[:, None, None]).float()


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
# against an eager one. H2's fixed-point sums differ from the CPU's f32
# scatter-add in the last bits (and, before the fixed point, its f32
# atomics changed them from run to run), and K4's tensor-core sums differ from the plain
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


def scratch_bound_ms(spec: GridSpec) -> float:
    """H2's 64-bit sums over the memory rate: written once (zeroed) and read
    once (the conversion to f32); the atomics' adds stay in the L2."""
    L, S, F = spec.table_shape
    return 1e3 * 2 * 8 * (HC.SCRATCH_HEADER + L * S * F) / HBM_BYTES_PER_S


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
    model = fixed_point_adjoint(pos, g, spec)
    torch.cuda.synchronize(device)
    gap = adjoint_gap(a, ref)
    faults = {name: adjoint_gap(fault(pos, g, spec), ref) for name, fault in FAULTS.items()}
    out = {"h1": h1, "h2": gap, "h2_max_abs": (a - ref).abs().max().item(),
           "h2_zero_mismatch_rows": zero_mismatch_rows(a, ref), "h2_run_to_run": adjoint_gap(a, b),
           "h2_bits_equal_run_to_run": bool(torch.equal(a, b)),
           "h2_bits_equal_fixed_point_model": bool(torch.equal(a, model)), "faults": faults}
    if not within_limits(gap):
        raise AssertionError(f"H2 {label}: {gap} outside {CARD_LIMITS}")
    if not (out["h2_bits_equal_run_to_run"] and out["h2_bits_equal_fixed_point_model"]):
        raise AssertionError(f"H2 {label}: two launches or the fixed-point model disagree bit for bit: {out}")
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
          **bound(n_adjoint, spec), "library_ms": None, "scratch_bound_ms": scratch_bound_ms(spec)}
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


def hash_builds(parent: str | None = None) -> dict:
    """name -> (H1 entry point, H2 entry point): the shipped build and, with
    ``parent``, ``parent/hash_grid.cu``, another tree's source with the same
    entry points."""
    builds = {"shipped": (HC.LOOKUP_KERNEL, HC.ADJOINT_KERNEL)}
    if parent:
        path = (Path(parent) / "hash_grid.cu").resolve()
        # H2 before the fixed point took no scratch argument
        adjoint_args = HC.ADJOINT_ARGTYPES
        if not re.search(r"float\* dtable, void\* scratch, void\* stream", path.read_text()):
            adjoint_args = adjoint_args[:-1]
        builds["parent"] = tuple(CudaKernel(str(path), k.symbol, args, extra_flags=k.extra_flags)
                                 for k, args in ((HC.LOOKUP_KERNEL, HC.LOOKUP_KERNEL.argtypes),
                                                 (HC.ADJOINT_KERNEL, adjoint_args)))
    return builds


def strided_clone(g: torch.Tensor) -> torch.Tensor:
    """A copy of ``g`` with the same row stride (H2 reads K4's dX through it)."""
    base = torch.empty((g.shape[0], g.stride(0)), dtype=g.dtype, device=g.device)
    base[:, :g.shape[1]] = g
    return base[:, :g.shape[1]]


def record_frame(renderer) -> list:
    """Render one frame eagerly (a graph replay calls no Python) with H1's
    and H2's wrappers wrapped; returns [(kind, (pos, table or g, spec))] in
    launch order, kind "H1" or "H2"."""
    recorded = []
    lookup, adjoint = HC.hash_grid_lookup_cuda, HC.hash_grid_adjoint_cuda

    def rec_lookup(pos, table, spec):
        recorded.append(("H1", (pos.detach().clone().contiguous(), table.detach().clone(), spec)))
        return lookup(pos, table, spec)

    def rec_adjoint(pos, g, spec):
        recorded.append(("H2", (pos.detach().clone().contiguous(), strided_clone(g.detach()), spec)))
        return adjoint(pos, g, spec)

    HC.hash_grid_lookup_cuda, HC.hash_grid_adjoint_cuda = rec_lookup, rec_adjoint
    capture, renderer.capture = renderer.capture, False
    try:
        renderer.render_frame()
    finally:
        HC.hash_grid_lookup_cuda, HC.hash_grid_adjoint_cuda = lookup, adjoint
        renderer.capture = capture
    return recorded


def row_load(pos: torch.Tensor, spec: GridSpec) -> dict:
    """Over the 8 * L * B (query, level, corner) terms of a launch: the
    distinct table rows they name and the most terms on one row, on the
    dense levels and on the hashed ones (the atomics' contention in H2)."""
    L, S, _ = spec.table_shape
    ofs = torch.arange(L, device=pos.device) * S
    rows = torch.cat([(HC.corner_index_weight(pos, k, spec)[0] + ofs).reshape(-1) for k in range(8)])
    counts = torch.bincount(rows, minlength=L * S).view(L, S)
    dense = torch.tensor(spec.dense, device=pos.device)
    out = {}
    for name, sel in (("dense", dense), ("hashed", ~dense)):
        c = counts[sel]
        out[name] = {"rows": int((c > 0).sum()), "max_terms": int(c.max()) if c.numel() else 0}
    return out


def measure(kind: str, args, builds: dict) -> dict:
    """One launch's reading: per build its agreement with the plain version
    (H1 bit for bit; H2 within ``CARD_LIMITS``, and whether two runs, and
    the plain version run on the CPU copy of the inputs, give the same bits)
    and its device time, builds timed in turns (each build, then the same
    in reverse) and the two readings averaged; H2's time on the grid cut to
    the dense and to the hashed levels."""
    from . import bench_intersect as BI

    pos, x, spec = args
    n = pos.shape[0]
    h2 = kind == "H2"
    if h2:
        ref = HC.hash_grid_adjoint_plain(pos, x, spec)
        model = fixed_point_adjoint(pos, x, spec)

        def run(k):
            return HC.launch_adjoint(k, pos, x, spec)
    else:
        ref = HC.hash_grid_lookup_plain(pos, x, spec)

        def run(k):
            return HC.launch_lookup(k, pos, x, spec)
    row = dict(kind=kind, n=n, **bound(n, spec), builds={})
    if h2:
        row["row_load"] = row_load(pos, spec)
    for name, kernels in builds.items():
        got = run(kernels[h2])
        if h2:
            gap = adjoint_gap(got, ref)
            res = dict(ok=within_limits(gap), gap=gap, zero_mismatch_rows=zero_mismatch_rows(got, ref),
                       bits_equal_run_to_run=bool(torch.equal(got, run(kernels[h2]))),
                       bits_equal_fixed_point_model=bool(torch.equal(got, model)))
        else:
            res = dict(ok=bool(torch.equal(got.view(torch.int32), ref.view(torch.int32))))
        row["builds"][name] = dict(res, ms=0.0)
    for name in list(builds) + list(reversed(builds)):
        k = builds[name][h2]
        row["builds"][name]["ms"] += BI.device_ms(lambda: run(k)) / 2
    n_dense = sum(spec.dense)
    if h2 and 0 < n_dense < spec.levels:
        F = spec.features
        for name, kernels in builds.items():
            row["builds"][name]["by_level_ms"] = {
                part: BI.device_ms(lambda: HC.launch_adjoint(kernels[1], pos, x[:, lo * F:hi * F],
                                                             sliced(spec, lo, hi)))
                for part, (lo, hi) in (("dense", (0, n_dense)), ("hashed", (n_dense, spec.levels)))}
    return row


def frame_run(parent: str | None = None) -> dict:
    """H1's and H2's launches of one settled 320x320 hash FULL + train frame
    on the Cornell box, and the all-random sets, timed for each build."""
    from ..render.renderer import Renderer
    from ..scene.scene_builder import cornell_box
    from . import bench_intersect as BI

    dev = torch.device("cuda", 0)
    builds = hash_builds(parent)
    for name, kernels in builds.items():
        for k in kernels:
            for line in k.build().splitlines():
                if "Used" in line or "spill" in line:
                    print(f"{name} {k.symbol}: {line.strip()}")
    scene, system = cornell_box((320, 320))
    r = Renderer(scene, system, render_mode=RenderMode.FULL, device=dev)
    r.set_encoding(InputEncoding.HASH)
    sizes = BI.settle_tiles(r)
    recorded = record_frame(r)
    gen = torch.Generator(device=dev).manual_seed(0)
    spec = full_spec()
    rnd = []
    for kind, n in (("H1", INFER_ROWS), ("H1", STEP_ROWS), ("H2", STEP_ROWS)):
        pos, table, g = inputs(spec, n, gen, dev, 0.0, 1.0)
        rnd.append((f"random B = {n}", kind, (pos, g if kind == "H2" else table, spec)))
    rows = measure_launches(rnd + [(f"launch {i}", kind, a) for i, (kind, a) in enumerate(recorded)], builds)
    frame = frame_totals(rows, builds)
    zero_ms = BI.device_ms(lambda: torch.zeros(spec.table_shape, device=dev))
    print(f"torch.zeros of the table gradient ({4 * spec.levels * spec.size * spec.features} bytes): {zero_ms:.4f} ms")
    agree = all(x["ok"] for row in rows for x in row["builds"].values())
    return {"tile_sizes": [list(t) for t in sizes], "all_agree": agree, "sets": rows, "frame": frame,
            "zeros_ms": zero_ms}


def measure_launches(cases, builds: dict) -> list:
    """``measure`` of each (label, kind, args), printed."""
    rows = []
    for label, kind, a in cases:
        row = dict(set=label, **measure(kind, a, builds))
        rows.append(row)
        print(f"{label:16s} {kind} B = {row['n']:6d}: bound {row['bound_ms']:.4f} ms; "
              + (f"rows {row['row_load']}; " if "row_load" in row else "")
              + "; ".join(f"{b}: {x['ms']:.4f} ms{'' if x['ok'] else ' DISAGREES'}"
                          + (f" (bit-equal run to run: {x['bits_equal_run_to_run']}, to the fixed-point model: "
                             f"{x['bits_equal_fixed_point_model']}; rows zero in one only: "
                             f"{x['zero_mismatch_rows']}; by level {x.get('by_level_ms')})"
                             if kind == "H2" else "")
                          for b, x in row["builds"].items()))
    return rows


def frame_totals(rows: list, builds: dict) -> dict:
    """H1's and H2's sums over a recorded frame's launch readings (the rows
    labelled "launch ..."), printed."""
    frame = {}
    for kind in ("H1", "H2"):
        mine = [x for x in rows if x["set"].startswith("launch") and x["kind"] == kind]
        frame[kind] = dict(launches=len(mine), bound_ms=sum(x["bound_ms"] for x in mine),
                           ms={b: sum(x["builds"][b]["ms"] for x in mine) for b in builds})
        print(f"{kind} over the frame: {len(mine)} launches (B = {[x['n'] for x in mine]}), bound "
              f"{frame[kind]['bound_ms']:.4f} ms; frame-weighted "
              + "; ".join(f"{b}: {v:.4f} ms" for b, v in frame[kind]["ms"].items()))
    return frame


def _smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="H1 and H2 on one card: checks, limits and times")
    ap.add_argument("--frame", action="store_true",
                    help="time the H1 and H2 launches of a recorded hash FULL + train frame")
    ap.add_argument("--parent", help="with --frame: a directory holding another tree's hash_grid.cu, timed beside")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_hash: no CUDA device is available")
    if args.frame:
        result = frame_run(args.parent)
        result["device"] = _smi()
        print(result["device"])
        print(json.dumps(result))
        return 0 if result["all_agree"] else 1
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
    result["device"] = _smi()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
