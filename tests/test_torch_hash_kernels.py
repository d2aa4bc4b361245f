"""A plain-torch model of how H1 and H2 (``csrc/hash_grid.cu``) read and add
the table's rows, on the CPU.

The kernels run only on the card; what they compute there rests on a few
rules, which this file models and holds to the plain versions
(``hash_grid_lookup_plain``, ``hash_grid_adjoint_plain``):

- the x-corner pair: the rows of corners 2j and 2j + 1 (x0 and x0 + 1 at
  the same y, z) are an aligned pair, idx1 == idx0 ^ 1, for every even x0
  of a hashed level (PRIMES[0] = 1; negative cells wrap as uint32 and keep
  it) and for a dense level's unclamped even idx0. H1 reads the pair that
  holds idx0 in one load and takes idx1's row from it when the rule holds,
  else reads idx1's row; H2 adds both terms as 2F consecutive 64-bit words
  then;
- H1 sums the corners in order 0..7 whatever the reads, so the model is
  equal to the plain lookup bit for bit;
- H1's tile: a block's 32 queries, a warp a level, the features through
  shared memory rows padded to an odd number of store words (no two lanes
  of a phase on one bank), stored as 16-byte words of the contiguous
  [32, L * F] output;
- H2's fixed point: each term w * g times its level's 2^s (from the
  batch's largest |g| and the headroom of 8 B terms a row), rounded to an
  int64 and added as an integer, so the sum has the same bits in any order:
  the pairs, the dense pre-sum (the dense levels that fit kSharedBytes of
  64-bit rows, summed per block of at most kDenseQueries queries, each
  touched row added once) and a shuffle of the queries all give
  ``bench_hash.fixed_point_adjoint``'s bits, which stay within
  ``bench_hash.CARD_LIMITS`` of the f32 plain version.

The constants come from the source's text (as
``tests/test_torch_walk_groups.py`` reads ``intersect_wide.cu``), and a few
lines of the kernels' text are held so that an edit of a rule there fails
here until the model follows. Seeded faults (the pair's halves swapped, a
pair taken without the rule, a pre-summed row dropped, a swapped vector
atomic, i.e. the pair's halves added into each other's rows) read as
wrong. The card holds the kernels themselves to the plain
versions (``chip_smoke.py`` 3d and 6d, ``tools/bench_hash.py``). No JAX
function is used here.
"""

import math
import re
from pathlib import Path

import pytest
import torch

from nrc_tpu_torch.config import InputEncoding, NetworkConfig
from nrc_tpu_torch.ops import encodings as E
from nrc_tpu_torch.ops import hash_cuda as HC
from nrc_tpu_torch.tools import bench_hash as BH
from test_torch_intersect import one_torch_thread  # noqa: F401 (an autouse fixture)

SOURCE = (Path(__file__).resolve().parents[1] / "nrc_tpu_torch" / "csrc" / "hash_grid.cu").read_text()


def _c_constant(name):
    """``constexpr int name = <integers and products>;`` of the source."""
    expr = re.search(rf"constexpr int {name} = ([^;]+);", SOURCE).group(1)
    assert re.fullmatch(r"[\d\s*]+", expr), expr
    return math.prod(int(x) for x in expr.split("*"))


THREADS, TILE, MAX_LEVELS, DENSE_QUERIES, SHARED_BYTES = (
    _c_constant(name) for name in ("kThreads", "kTile", "kMaxLevels", "kDenseQueries", "kSharedBytes"))
WARPS = THREADS // 32
SHARED_BYTES_AN_SM = 232448
THREADS_AN_SM = 2048

GRIDS = {
    "full": {},
    "edge": dict(hash_log2_size=10, hash_base_resolution=4),
    "f1": dict(hash_n_levels=6, hash_log2_size=12, hash_base_resolution=8, hash_n_features_per_level=1),
    "f4": dict(hash_n_levels=8, hash_log2_size=12, hash_base_resolution=2, hash_per_level_scale=1.5,
               hash_n_features_per_level=4),
    "f8": dict(hash_n_levels=4, hash_log2_size=9, hash_base_resolution=3, hash_n_features_per_level=8),
}


def _spec(name):
    return E.grid_spec(NetworkConfig(encoding=InputEncoding.HASH, **GRIDS[name]))


def _inputs(spec, n, seed, lo=-0.3, hi=1.3):
    gen = torch.Generator().manual_seed(seed)
    pos = torch.rand((n, 3), generator=gen) * (hi - lo) + lo
    table = torch.rand(spec.table_shape, generator=gen) * 2.0 - 1.0
    g = torch.randn((n, spec.levels * spec.features), generator=gen)
    return pos, table, g


def _corners(pos, spec):
    """(idx [B, L], w [B, L]) of the 8 corners, from the plain version."""
    return [HC.corner_index_weight(pos, k, spec) for k in range(8)]


def _level_offsets(spec):
    return torch.arange(spec.levels, dtype=torch.int64) * spec.size


# ---------------------------------------------------------------------------
# the constants and the layouts
# ---------------------------------------------------------------------------

def test_the_kernel_constants_are_the_wrappers():
    assert MAX_LEVELS == HC.MAX_LEVELS
    assert THREADS % 32 == 0 and TILE == 32
    # warp w takes levels w, w + WARPS, ...: at most two levels a warp
    assert 2 * WARPS >= HC.MAX_LEVELS
    # H2's pre-sum opts in above the 48 KB default, within the 227 KB a
    # block may have
    assert 48 * 1024 < SHARED_BYTES <= 227 * 1024 and DENSE_QUERIES >= 1


def _tile_stride(levels, features):
    """``tile_stride``: an odd number of a lane's store words (F floats, at
    most 4) a row."""
    word = min(features, 4)
    return word * ((levels * features // word) | 1)


@pytest.mark.parametrize("features", HC.FEATURES)
@pytest.mark.parametrize("levels", [1, 2, 15, 16, 31, 32])
def test_the_tile_fits_and_a_phase_of_lanes_meets_no_bank_twice(levels, features):
    """A lane writes F floats of its query's row at lane * stride + l * F.
    Shared memory serves 128 bytes a phase: 32 lanes of 4-byte words, 16 of
    8-byte, 8 of 16-byte ones (F = 8: two 16-byte words, each 8 lanes). No
    two lanes of a phase meet one bank; the tile fits a block."""
    stride = _tile_stride(levels, features)
    assert 4 * TILE * stride <= SHARED_BYTES
    word = min(features, 4)              # floats in one access
    lanes_a_phase = 32 // word
    for level in range(levels):
        for part in range(max(features // 4, 1)):
            for phase in range(32 // lanes_a_phase):
                lanes = range(phase * lanes_a_phase, (phase + 1) * lanes_a_phase)
                banks = [(lane * stride + level * features + part * word + k) % 32
                         for lane in lanes for k in range(word)]
                assert len(set(banks)) == len(banks), (levels, features, level, phase)


@pytest.mark.parametrize("rows", [1, 7, 31, 32])
@pytest.mark.parametrize("grid", ["full", "f1", "f8"])
def test_the_tile_store_writes_each_output_float_once(rows, grid):
    """The store loop of ``hash_lookup_kernel``: thread t takes floats
    4t, 4t + 4 * kThreads, ... of the tile's rows * width floats, a 16-byte
    store (the tile starts at a multiple of 128 bytes) or, at the ragged
    end, single floats; each reads its float from the padded shared row."""
    spec = _spec(grid)
    width, stride = spec.levels * spec.features, _tile_stride(spec.levels, spec.features)
    total = rows * width
    written = torch.zeros(total, dtype=torch.int64)
    read_from = torch.full((total,), -1, dtype=torch.int64)
    for t in range(THREADS):
        for i in range(4 * t, total, 4 * THREADS):
            assert (TILE * width * 4) % 128 == 0 and i % 4 == 0
            r, col = divmod(i, width)
            for k in range(min(4, total - i)):
                written[i + k] += 1
                read_from[i + k] = r * stride + col
                col += 1
                if col == width:
                    col, r = 0, r + 1
    assert torch.equal(written, torch.ones(total, dtype=torch.int64))
    want = torch.tensor([(p // width) * stride + p % width for p in range(total)])
    assert torch.equal(read_from, want)


def _presum_levels(spec):
    """``choose_presum``: the dense levels from the coarsest while their rows
    of 64-bit sums fit kSharedBytes; their word offsets."""
    words, chosen = 0, {}
    for level, (dense, res) in enumerate(zip(spec.dense, spec.res)):
        if not dense:
            continue
        rows = (res + 1) ** 3
        if words + rows * spec.features > SHARED_BYTES // 8:
            break
        chosen[level] = words
        words += rows * spec.features
    return chosen, words


def test_the_shipped_dense_level_is_pre_summed_and_fits():
    spec = BH.full_spec()
    chosen, words = _presum_levels(spec)
    assert list(chosen) == [0] and words == 17 ** 3 * 2 and 8 * words == 78608 <= SHARED_BYTES
    # every block of the launch gets as much shared memory: two of 512
    # threads an SM (the tile needs 4.3 KB)
    assert 8 * words >= 4 * TILE * _tile_stride(16, 2)
    assert SHARED_BYTES_AN_SM // (8 * words) == 2 and 2 * THREADS <= THREADS_AN_SM


# ---------------------------------------------------------------------------
# the x-corner pair
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_x_corner_pairs_of_even_cells_are_aligned(grid):
    """For every even x0, negative ones too, a hashed level's corners 2j and
    2j + 1 are rows h and h ^ 1; a dense level's are when idx0 is even and
    x0 + 1 is not clamped. Where idx1 == idx0 ^ 1 the pair starts at
    idx0 & ~1, inside the level."""
    spec = _spec(grid)
    pos, _, _ = _inputs(spec, 2000, 1, -2.5, 3.5)
    corners = _corners(pos, spec)
    p = pos[:, None, :] * torch.tensor(spec.res, dtype=torch.float32)[:, None]
    x0 = torch.floor(p[..., 0]).to(torch.int32).to(torch.int64)
    dense = torch.tensor(spec.dense)
    verts = torch.tensor([r + 1 for r in spec.res])
    assert bool((x0 < 0).any()) and bool(((x0 % 2 == 0) & (x0 < 0) & ~dense).any())
    for j in range(4):
        (i0, _), (i1, _) = corners[2 * j], corners[2 * j + 1]
        paired = i1 == (i0 ^ 1)
        even = x0 % 2 == 0
        assert bool(paired[even & ~dense.expand_as(even)].all()), (grid, j)
        unclamped = (x0 >= 0) & (x0 + 1 <= verts - 1)
        assert torch.equal(paired & dense, (i0 % 2 == 0) & unclamped & dense), (grid, j)
        assert bool(((i0[paired] & ~1) + 1 < spec.size).all())
    # for half the cells of a hashed level, six reads instead of eight
    hashed_even = (x0 % 2 == 0)[:, ~dense].float().mean().item()
    assert 0.4 < hashed_even < 0.6


def _reads(i0, i1):
    """The kernels' reads (or atomics) for one corner pair: the pair at
    idx0 & ~1, and idx1's row unless idx1 == idx0 ^ 1."""
    return 1 + (i1 != (i0 ^ 1)).long()


# ---------------------------------------------------------------------------
# H1
# ---------------------------------------------------------------------------

def lookup_model(pos, table, spec, fault=None):
    """H1 as the kernel reads: for each corner pair the aligned pair of rows
    that holds idx0, idx1's row from it when idx1 == idx0 ^ 1 (else a read
    of its own), the corners summed in order 0..7 from 0. Returns the
    features [B, L * F] and the reads a (query, level) made."""
    n = pos.shape[0]
    L, S, F = spec.table_shape
    flat = table.reshape(L * S, F)
    ofs = _level_offsets(spec)
    corners = _corners(pos, spec)
    acc = torch.zeros((n, L, F))
    reads = torch.zeros((n, L), dtype=torch.int64)
    for j in range(4):
        (i0, w0), (i1, w1) = corners[2 * j], corners[2 * j + 1]
        base = (i0 & ~1) + ofs
        low, high = flat[base], flat[base + 1]
        odd = (i0 & 1).bool()[..., None]
        if fault == "halves swapped":
            odd = ~odd
        r0 = torch.where(odd, high, low)
        pair = (i1 == (i0 ^ 1))[..., None]
        if fault == "pair without the rule":
            pair = torch.ones_like(pair)
        r1 = torch.where(pair, torch.where(odd, low, high), flat[i1 + ofs])
        acc = acc + w0[..., None] * r0
        acc = acc + w1[..., None] * r1
        reads += _reads(i0, i1)
    return acc.reshape(n, L * F), reads


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_lookup_model_equals_the_plain_lookup_bit_for_bit(grid):
    spec = _spec(grid)
    pos, table, _ = _inputs(spec, 1001, 2)
    got, reads = lookup_model(pos, table, spec)
    ref = HC.hash_grid_lookup_plain(pos, table, spec)
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))
    assert int(reads.min()) >= 4 and int(reads.max()) <= 8
    dense = torch.tensor(spec.dense)
    if (~dense).any():
        mean_hashed = reads[:, ~dense].float().mean().item()
        assert 5.5 < mean_hashed < 6.5   # even cells 4 reads, odd ones 8


@pytest.mark.parametrize("fault", ["halves swapped", "pair without the rule"])
def test_lookup_model_catches_seeded_faults(fault):
    spec = _spec("full")
    pos, table, _ = _inputs(spec, 1001, 3)
    got, _ = lookup_model(pos, table, spec, fault=fault)
    ref = HC.hash_grid_lookup_plain(pos, table, spec)
    assert (got - ref).abs().max().item() > 1e-2


def test_lookup_model_on_a_frames_positions():
    """Positions where a Cornell frame's lie ([0.25, 0.75]^3), many of them
    in one coarse cell: bit for bit still."""
    spec = _spec("full")
    pos, table, _ = _inputs(spec, 2048, 4, 0.25, 0.75)
    got, _ = lookup_model(pos, table, spec)
    assert torch.equal(got, HC.hash_grid_lookup_plain(pos, table, spec))


# ---------------------------------------------------------------------------
# H2
# ---------------------------------------------------------------------------

def _quantised(pos, g, spec):
    """Each corner's terms [B, L, F] as the kernel adds them: w * g (f32)
    times the level's 2^s, rounded to the nearest int64; and 2^-s a level."""
    n = pos.shape[0]
    L, _, F = spec.table_shape
    shifts = BH.level_shifts(g, spec)
    scale = torch.tensor([2.0 ** sh for sh in shifts], dtype=torch.float64)
    g3 = g.reshape(n, L, F)
    terms = [torch.round((w[..., None] * g3).double() * scale[:, None]).to(torch.int64)
             for _, w in _corners(pos, spec)]
    return terms, 1.0 / scale


def adjoint_model(pos, g, spec, fault=None, block_queries=DENSE_QUERIES):
    """H2 as the kernel adds: the quantised terms of the pre-summed dense
    levels per block of queries (each touched row added once, a row whose
    terms summed to zero not at all), the other levels tile by tile, an
    aligned x-corner pair as 2F words at idx0 & ~1, else row by row; the
    integer sums times 2^-s rounded to f32 once."""
    n = pos.shape[0]
    L, S, F = spec.table_shape
    ofs = _level_offsets(spec)
    corners = _corners(pos, spec)
    terms, inv = _quantised(pos, g, spec)
    chosen, _ = _presum_levels(spec)
    pre = torch.tensor([level in chosen for level in range(L)])
    acc = torch.zeros((L * S, F), dtype=torch.int64)
    blocks = -(-n // block_queries) if chosen else 0
    per = -(-n // blocks) if blocks else 0
    for blk in range(blocks):
        q = slice(blk * per, min(n, (blk + 1) * per))
        for level in chosen:
            sums = torch.zeros((S, F), dtype=torch.int64)
            for k in range(8):
                sums.index_add_(0, corners[k][0][q, level], terms[k][q, level])
            touched = (sums != 0).any(dim=1)
            if fault == "pre-summed row dropped":
                touched[touched.nonzero()[0]] = False
            rows = touched.nonzero()[:, 0]
            acc.index_add_(0, rows + ofs[level], sums[rows])
    rest = ~pre
    for j in range(4):
        (i0, _), (i1, _) = corners[2 * j], corners[2 * j + 1]
        u0, u1 = terms[2 * j], terms[2 * j + 1]
        pair = (i1 == (i0 ^ 1)) & rest
        odd = (i0 & 1).bool()
        if fault == "vector atomic swapped":
            odd = ~odd
        two = torch.where(odd[..., None, None], torch.stack([u1, u0], -2), torch.stack([u0, u1], -2))
        base = (i0 & ~1) + ofs
        acc.view(L * S // 2, 2 * F).index_add_(0, (base[pair] // 2), two[pair].reshape(-1, 2 * F))
        single = ~(i1 == (i0 ^ 1)) & rest
        acc.index_add_(0, (i0 + ofs)[single], u0[single])
        acc.index_add_(0, (i1 + ofs)[single], u1[single])
    return (acc.view(L, S, F).double() * inv[:, None, None]).float()


@pytest.mark.parametrize("box", [(-0.3, 1.3), (0.25, 0.75)], ids=["wide", "frame"])
@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_adjoint_model_within_card_limits(grid, box):
    """The kernel's adds give ``fixed_point_adjoint``'s bits (the integer
    sum's order does not matter), within the limits of the f32 plain sum."""
    spec = _spec(grid)
    pos, _, g = _inputs(spec, 999, 5, *box)
    ref = HC.hash_grid_adjoint_plain(pos, g, spec)
    got = adjoint_model(pos, g, spec)
    assert torch.equal(got, BH.fixed_point_adjoint(pos, g, spec))
    assert BH.within_limits(BH.adjoint_gap(got, ref)), BH.adjoint_gap(got, ref)


def test_adjoint_model_pre_sums_in_blocks_of_the_sources_size():
    """The shipped grid at a training batch's shape: its dense level in
    ceil(B / kDenseQueries) blocks of the queries, or in blocks of one query
    (no pre-sum at all), or the queries shuffled: the same bits each way,
    within the limits of the plain version."""
    spec = BH.full_spec()
    pos, _, g = _inputs(spec, 4096, 6, 0.25, 0.75)
    ref = HC.hash_grid_adjoint_plain(pos, g, spec)
    got = adjoint_model(pos, g, spec)
    assert BH.within_limits(BH.adjoint_gap(got, ref))
    perm = torch.randperm(4096, generator=torch.Generator().manual_seed(6))
    for other in (adjoint_model(pos, g, spec, block_queries=1), adjoint_model(pos[perm], g[perm], spec),
                  BH.fixed_point_adjoint(pos[perm], g[perm], spec)):
        assert torch.equal(other, got)


@pytest.mark.parametrize("fault", ["pre-summed row dropped", "vector atomic swapped"])
def test_adjoint_model_catches_seeded_faults(fault):
    """A row of the pre-sum dropped (on the edge grid, whose two dense
    levels are pre-summed) or an x-corner pair's halves added into each
    other's rows (the shipped grid)."""
    spec = _spec("edge") if fault == "pre-summed row dropped" else BH.full_spec()
    pos, _, g = _inputs(spec, 999, 7, 0.25, 0.75)
    ref = HC.hash_grid_adjoint_plain(pos, g, spec)
    gap = BH.adjoint_gap(adjoint_model(pos, g, spec, fault=fault), ref)
    assert not BH.within_limits(gap), gap


@pytest.mark.parametrize("n", [1, 999, 16384])
def test_fixed_point_headroom_holds_a_rows_worst_sum(n):
    """The scale leaves room for 8 B terms of the level's largest |g| on one
    row (every corner of every query there): their sum stays below 2^62,
    while the largest term keeps 62 - ceil(log2(8 B)) - 1 bits or more."""
    spec = BH.full_spec()
    g = torch.randn((n, spec.levels * spec.features), generator=torch.Generator().manual_seed(n))
    g[:, :spec.features] = 0.0  # a level with no gradient adds only zeros
    shifts = BH.level_shifts(g, spec)
    gmax = g.reshape(n, spec.levels, spec.features).abs().amax(dim=(0, 2))
    assert shifts[0] == 0
    for level in range(1, spec.levels):
        top = round(float(gmax[level]) * 2.0 ** shifts[level])
        assert 8 * n * top < 2 ** 62
        assert top >= 2 ** (62 - (8 * n - 1).bit_length() - 1)


def test_fixed_point_rows_of_tiny_terms():
    """A term below half a quantum adds nothing: a row that only such terms
    reach stays zero, where the plain f32 sum is not (the reading
    ``zero_mismatch_rows`` prints beside CARD_LIMITS). At the frame's
    shapes a quantum is 2^-46 or so of the level's largest |g|."""
    spec = _spec("edge")
    pos, _, g = _inputs(spec, 64, 9, 0.25, 0.75)
    g[1:] *= 1e-20  # one query carries the level's largest |g|
    ref = HC.hash_grid_adjoint_plain(pos, g, spec)
    got = BH.fixed_point_adjoint(pos, g, spec)
    assert BH.zero_mismatch_rows(got, ref) > 0
    assert BH.zero_mismatch_rows(got, got) == 0


# ---------------------------------------------------------------------------
# the frame measurement's helpers (bench_hash --frame)
# ---------------------------------------------------------------------------

def test_strided_clone_keeps_the_row_stride():
    dx = torch.randn(37, 128)
    g = dx[:, :32]
    c = BH.strided_clone(g)
    assert c.stride() == g.stride() and torch.equal(c, g) and c.data_ptr() != g.data_ptr()


def test_row_load_counts_each_term_once():
    spec = _spec("edge")
    pos, _, _ = _inputs(spec, 300, 8, 0.25, 0.75)
    load = BH.row_load(pos, spec)
    ofs = _level_offsets(spec)
    rows = torch.cat([(idx + ofs).reshape(-1) for idx, _ in _corners(pos, spec)])
    counts = torch.bincount(rows, minlength=spec.levels * spec.size).view(spec.levels, spec.size)
    dense = torch.tensor(spec.dense)
    assert int(counts.sum()) == 8 * spec.levels * 300
    assert load["dense"] == {"rows": int((counts[dense] > 0).sum()), "max_terms": int(counts[dense].max())}
    assert load["hashed"]["rows"] == int((counts[~dense] > 0).sum())


def test_frame_totals_sum_the_frames_launches_only():
    rows = [dict(set="random B = 5", kind="H1", n=5, bound_ms=9.0, builds={"shipped": dict(ms=9.0)}),
            dict(set="launch 0", kind="H1", n=7, bound_ms=0.5, builds={"shipped": dict(ms=2.0)}),
            dict(set="launch 1", kind="H2", n=3, bound_ms=0.25, builds={"shipped": dict(ms=1.0)}),
            dict(set="launch 2", kind="H1", n=3, bound_ms=0.25, builds={"shipped": dict(ms=1.5)})]
    frame = BH.frame_totals(rows, {"shipped": None})
    assert frame["H1"] == dict(launches=2, bound_ms=0.75, ms={"shipped": 3.5})
    assert frame["H2"] == dict(launches=1, bound_ms=0.25, ms={"shipped": 1.0})


# ---------------------------------------------------------------------------
# the source's text the model follows
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("line", [
    # the pair rule, in both kernels
    r"if \(q\.idx1 != \(q\.idx0 \^ 1\)\) load_floats<F>\(level_rows \+ static_cast<int64_t>\(q\.idx1\) \* F, r1\);",
    r"if \(q\.idx1 == \(q\.idx0 \^ 1\)\) \{",
    # the aligned pair holds idx0
    r"load_floats<2 \* F>\(level_rows \+ static_cast<int64_t>\(q\.idx0 & ~1\) \* F, two\);",
    r"atomic_add_fixed<2 \* F>\(level_rows \+ static_cast<int64_t>\(q\.idx0 & ~1\) \* F, two\);",
    # the halves by idx0's parity
    r"r0\[f\] = odd \? two\[F \+ f\] : two\[f\];",
    r"r1\[f\] = odd \? two\[f\] : two\[F \+ f\];",
    r"two\[f\] = odd \? u1\[f\] : u0\[f\];",
    r"two\[F \+ f\] = odd \? u0\[f\] : u1\[f\];",
    # corners 2j, 2j + 1 summed in that order
    r"acc\[f\] = __fadd_rn\(acc\[f\], __fmul_rn\(q\.w0, r0\[f\]\)\);\s*#pragma unroll\s*"
    r"for \(int f = 0; f < F; \+\+f\) acc\[f\] = __fadd_rn\(acc\[f\], __fmul_rn\(q\.w1, r1\[f\]\)\);",
    # one block an SM at least, for both kernels
    r"__global__ void __launch_bounds__\(kThreads, 1\)\s*hash_lookup_kernel",
    r"__global__ void __launch_bounds__\(kThreads, 1\)\s*hash_adjoint_kernel",
    # the tile's padded rows, a lane's features stored and read as whole words
    r"store_shared<F>\(tile \+ lane \* stride \+ l \* F, acc\);",
    r"load_shared<F>\(gtile \+ lane \* stride \+ l \* F, gl\);",
    r"const int word = features < 4 \? features : 4;\s*return word \* \(\(levels \* features / word\) \| 1\);",
    # a pre-summed row that summed to zero is not added
    r"if \(any\) atomic_add_fixed<F>",
    # the fixed point: the scale a level, the term rounded once, the sum
    # turned to f32 once
    r"return 62 - headroom - e;",
    r"while \(\(int64_t\{1\} << bits\) < int64_t\{8\} \* n\) \+\+bits;",
    r"__double2ll_rn\(__dmul_rn\(static_cast<double>\(t\), scale\)\)",
    r"u0\[f\] = quantise\(__fmul_rn\(q\.w0, gl\[f\]\), scale\);",
    r"__double2float_rn\(__dmul_rn\(__ll2double_rn\(static_cast<long long>\(acc\[i\]\)\), inv\)\)",
])
def test_the_kernels_text_holds_the_models_rules(line):
    assert re.search(line, SOURCE), line
