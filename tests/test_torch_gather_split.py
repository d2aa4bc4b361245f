"""A numpy model of how K7 (``csrc/gather_rows.cu::nrc_gather_rows``) splits
its work, on the CPU.

The kernel runs only on the card; what it computes there rests on its work
split: which of its two shapes a table takes (output-major chunks for narrow
rows, a warp per wide row), how the flat output is cut into 16-byte chunks
and handed to the threads of a grid of at most one wave, how a thread steps
its (row, column) from chunk to chunk without a division and reads a row's
index only for the rows its chunk touches, and the ragged end. The model is
built from the constants the source declares (read from it, as
``tests/test_torch_mlp_tiles.py`` reads ``mma_tiles.cuh``) and follows the
kernel's loops step by step, on ``bench_gather``'s edge grid of widths and
index counts, for a 1-row table, a tiny one and the Cornell box's triangle
count, on an H100's wave (132 SMs, 8 blocks each) and on a grid of two
blocks. It asserts that every output word is written exactly once, that
every chunk stored as a vector is 16-byte aligned, that every read lies
inside the table and the indices (indices outside the table are clamped)
and that the model's gather equals ``table[idx]`` bit for bit. The card
holds the kernel itself to the plain version on the same grid
(``tests/test_torch_cuda.py::test_k7_bit_for_bit_on_the_edge_grid``,
``chip_smoke.py`` phase 3b).
"""

import re
from pathlib import Path

import numpy as np
import pytest

from nrc_tpu_torch.tools import bench_gather as BG

SOURCE = (Path(__file__).resolve().parents[1] / "nrc_tpu_torch" / "csrc" / "gather_rows.cu").read_text()


def _c_constant(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE).group(1))


WARP_THREADS, ROWS_PER_WARP, NARROW, CHUNK_THREADS, CHUNK = (
    _c_constant(name) for name in ("kWarpThreads", "kRowsPerWarp", "kNarrowWords", "kChunkThreads",
                                   "kChunkWords"))
GRIDS = ((132, 8), (2, 1))  # (SMs, blocks an SM): an H100's wave, and two blocks


def route(p):
    """Mirror of ``nrc_gather_rows``'s choice (the wrapper hands it a 16-byte
    aligned table and output)."""
    return "warp" if p % 4 == 0 and p >= NARROW else "chunks"


def chunk_blocks(n, p, grid):
    """Mirror of the entry's grid for the chunk kernel: a block per
    kChunkThreads chunks, at most one wave of resident blocks, one block at
    least (fewer than 4 words: the ragged end alone)."""
    sms, per_sm = grid
    units = -(-(n * p // CHUNK) // CHUNK_THREADS)
    return max(1, min(units, sms * per_sm))


class Trace:
    """What a modelled launch did: which output words it wrote and how many
    writes it made (so each word exactly once when the two agree with the
    output's size), the words it wrote, and a check on every table read."""

    def __init__(self, table, n):
        self.table = table.ravel()
        self.out = np.zeros(n * table.shape[1], dtype=np.int32)
        self.hit = np.zeros(self.out.size, dtype=bool)
        self.writes = 0

    def read(self, off):
        assert off.size == 0 or (off.min() >= 0 and off.max() < self.table.size), "a read outside the table"
        return self.table[off]

    def write(self, word, value):
        self.hit[word] = True
        self.writes += word.size
        self.out[word] = value


def model_chunks(trace, idx, rows, p, blocks):
    """``gather_chunk_kernel``: thread g = block * kChunkThreads + t takes
    chunks g, g + stride, ... (stride = blocks * kChunkThreads), chunk c
    being out's words [4c, 4c + 4); it steps its (row, col) by 4 stride words
    at a time, reads the index of the next row only when a word of the chunk
    lies there, and block 0's first threads write the last (n p) % 4 words."""
    n = idx.shape[0]
    chunks = n * p // CHUNK
    stride = blocks * CHUNK_THREADS

    def base_of(r):
        assert r.size == 0 or r.max() < n, "an index read past the end"
        return np.clip(idx[r], 0, rows - 1).astype(np.int64) * p

    first = np.arange(stride, dtype=np.int64)
    row, col = CHUNK * first // p, CHUNK * first % p
    step_rows, step_cols = CHUNK * stride // p, CHUNK * stride % p
    c = first
    while True:
        live = c < chunks
        if not live.any():
            break
        start, r, k = CHUNK * c[live], row[live].copy(), col[live].copy()
        assert np.all((start * 4) % 16 == 0), "a vector store off 16-byte alignment"
        base = base_of(r)
        for j in range(CHUNK):
            trace.write(start + j, trace.read(base + k))
            k = k + 1
            cross = (k == p) & (j + 1 < CHUNK)
            k[cross] = 0
            r[cross] += 1
            base[cross] = base_of(r[cross])
        c = c + stride
        row += step_rows
        col += step_cols
        wrap = col >= p
        col[wrap] -= p
        row[wrap] += 1
    w = np.arange(CHUNK * chunks, n * p)
    assert w.size < CHUNK <= CHUNK_THREADS
    r = w // p
    trace.write(w, trace.read(base_of(r) + (w - r * p)))


def model_warps(trace, idx, rows, p, blocks):
    """``gather_warp_kernel<uint4, false>``: warp w takes
    rows w * kRows + k, then kRows * (number of warps) further on; lane l
    copies the row's 16-byte words l, l + 32, ...; rows past the end are
    loaded as the last row and not stored."""
    n = idx.shape[0]
    warps = blocks * WARP_THREADS // 32
    assert blocks == -(-n // (WARP_THREADS // 32 * ROWS_PER_WARP))  # warp_blocks: every warp one pass
    groups = -(-n // ROWS_PER_WARP)
    bases = (np.arange(warps)[:, None] + warps * np.arange(-(-groups // warps))[None, :]) * ROWS_PER_WARP
    bases = bases[bases < n]
    i = (bases[:, None] + np.arange(ROWS_PER_WARP)[None, :]).ravel()
    src = np.clip(idx[np.minimum(i, n - 1)], 0, rows - 1).astype(np.int64)
    stored = i < n
    vec_words = p // 4
    for lane0 in range(0, vec_words, 32):
        wv = lane0 + np.arange(min(32, vec_words - lane0))
        start = (i[stored, None] * p + 4 * wv[None, :]).ravel()
        off = (src[stored, None] * p + 4 * wv[None, :]).ravel()
        assert np.all(start % 4 == 0) and np.all(off % 4 == 0)
        for j in range(4):
            trace.write(start + j, trace.read(off + j))


def run_model(rows, p, n, grid, rng):
    table = rng.integers(-2**31, 2**31 - 1, (rows, p), dtype=np.int64).astype(np.int32)
    idx = rng.integers(0, rows, n)
    idx[: min(n, 3)] = (rows - 1, -3, rows + 2)[: min(n, 3)]  # the last row and two to clamp
    kernel = route(p)
    trace = Trace(table, n)
    if kernel == "chunks":
        model_chunks(trace, idx, rows, p, chunk_blocks(n, p, grid))
    else:
        model_warps(trace, idx, rows, p, -(-n // (WARP_THREADS // 32 * ROWS_PER_WARP)))
    return kernel, trace, table[np.clip(idx, 0, rows - 1)]


@pytest.mark.parametrize("n", BG.EDGE_NS)
@pytest.mark.parametrize("p", BG.EDGE_WIDTHS)
def test_k7_split_writes_each_word_once_and_gathers_the_rows(p, n):
    rng = np.random.default_rng(1000 * p + n)
    for rows in BG.EDGE_ROWS:
        for grid in GRIDS if n <= 4097 else GRIDS[:1]:
            kernel, trace, ref = run_model(rows, p, n, grid, rng)
            where = f"[{rows}, {p}] N = {n} grid {grid} ({kernel})"
            assert trace.hit.all() and trace.writes == n * p, f"{where}: {trace.writes} writes, {trace.hit.sum()} words"
            np.testing.assert_array_equal(trace.out.reshape(n, p), ref, err_msg=where)


def test_the_path_tables_take_the_shapes_the_design_names():
    """tris.packed [1224, 9] and tri_shade [1224, 26] take the chunk kernel,
    mat_row [5, 128] and the walk's [131072, 160] a warp per row; a chunk
    kernel launch is at most one wave, and a warp-per-row launch has every
    warp make one pass."""
    assert route(9) == route(26) == "chunks"
    assert route(128) == route(160) == "warp"
    assert chunk_blocks(102400, 26, (132, 8)) == 132 * 8
    assert chunk_blocks(25600, 9, (132, 8)) == 225
    assert chunk_blocks(1, 3, (132, 8)) == 1
