"""How fast the card gathers rows: the three gather kernels and ``index_select``.

Counterpart of ``tools/bench_gather_pallas.py`` for the port. Run from the
root of a checkout on a machine with one CUDA card:

    python3 -m nrc_tpu_torch.tools.bench_gather [--tables 131072x160,8192x160] [--n 2048,102400]

Tables: the wide walk's unified node + leaf table at the TPU bench's
``--rows`` ([131072, 160] float32, 640 bytes a row, 84 MB: more than the
card's 50 MB L2) and at its ``--vmem-rows``, the resident kernel's own table
([8192, 160], 5.2 MB: it fits the L2), each at every ``n``; then the tables
the port's path gathers from on the 320x320 Cornell box (``tri_shade``,
``mat_row``, ``tris.packed``, shapes from ``upload_scene``) at the frame's
N = 102,400. For each it gathers random rows with each variant of
``ops/gather_cuda.py`` (``warp`` = K7, ``resident`` = K8, ``block`` = K9),
with the plain version ``table[idx]`` and with ``torch.index_select``, the
one library call that computes the same function (the port never calls it
on the card). Every launch takes a fresh index set, precomputed, so that no
launch finds its rows in the L1. Times are device times: ``--iters``
launches captured in a CUDA graph and replayed (``time_ms``); each variant
is first compared with the plain version bit for bit. Reported: ns per gathered row, and the share of the
byte bound (``bound_ms``: each distinct row the indices name read once, each
gathered row written once and each index read once, over 3.35 TB/s; a
launch gathers up to N rows of the table's R, so a small table is read once
however many rows are gathered from it). The card's name and power limit
head the output; the last line is one JSON object with them and every row.

``record_frame_gathers`` and ``frame_weighted`` read the gathers of one
frame (every launch's table and indices) and sum their times and bounds:
``chip_smoke.py`` reports K7's frame-weighted time and bound from them
through ``frame_report``. The ``EDGE_*`` grid (table widths, index counts, table rows) is where K7's work
split changes shape: ``chip_smoke.py`` and ``tests/test_torch_cuda.py``
hold K7 to the plain version on it, ``tests/test_torch_gather_split.py``
models its split on it.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import torch

from ..ops import gather_cuda as GC
from ..render.renderer import Renderer
from ..render.scene_device import upload_scene
from ..scene.scene_builder import cornell_box
from .bench_intersect import device_ms

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
TABLES = ((131072, 160), (8192, 160))  # the TPU bench's --rows and --vmem-rows, 160 columns
NS = (2048, 102400)
PATH_N = 102400  # the rays of a 320x320 frame
# K7's edge grid: widths around its chunk of 4 words and its narrow limit of
# 32, the path's 9, 26 and 128 and the walk's 160; index counts around a
# chunk and a warp's rows, a ragged 4097, the training and render
# wavefronts; a 1-row table, a tiny one and the Cornell box's triangle count
EDGE_WIDTHS = (1, 2, 3, 4, 5, 8, 9, 26, 31, 32, 33, 128, 160)
EDGE_NS = (1, 3, 4, 5, 127, 128, 129, 4097, 25600, 102400)
EDGE_ROWS = (1, 5, 1224)


def time_ms(fn, index_sets) -> float:
    """Device time of one launch: a launch per index set captured in one
    CUDA graph, replayed twice after a warm-up replay (a gather of a few
    microseconds takes less than its wrapper's host cost, which a loop of
    eager launches would time instead)."""
    fn(index_sets[0])
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for idx in index_sets:
            fn(idx)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (2 * len(index_sets))


def unique_rows(idx: torch.Tensor) -> int:
    """The distinct table rows ``idx`` names."""
    return int(torch.unique(idx).numel())


def bound_ms(unique: float, n: int, cols: int) -> float:
    """The ``unique`` distinct rows read once, the ``n`` gathered rows written
    once and the ``n`` int64 indices read once."""
    return 1e3 * ((unique + n) * cols * 4 + n * 8) / HBM_BYTES_PER_S


def path_tables(dev) -> dict:
    """The tables the path gathers from on the 320x320 Cornell box."""
    ds = upload_scene(cornell_box((320, 320))[0], dev)
    return {"tri_shade": ds.tri_shade, "mat_row": ds.mat_row, "tris.packed": ds.tris.packed}


def time_table(label: str, table: torch.Tensor, ns, iters: int, gen) -> list:
    """Every variant, the plain version and ``index_select`` on ``table`` at
    every n in ``ns``; one dict per (n, variant)."""
    rows, cols = table.shape
    variants = {name: (lambda idx, k=k: GC.gather_rows_cuda(k, table, idx)) for name, k in GC.VARIANTS.items()}
    variants["plain"] = lambda idx: GC.gather_rows_plain(table, idx)
    variants["index_select"] = lambda idx: torch.index_select(table, 0, idx)
    out = []
    for n in ns:
        index_sets = [torch.randint(0, rows, (n,), generator=gen, device=table.device) for _ in range(iters)]
        ref = GC.gather_rows_plain(table, index_sets[0]).view(torch.int32)
        unique = sum(unique_rows(idx) for idx in index_sets) / len(index_sets)
        for name, fn in variants.items():
            if not torch.equal(fn(index_sets[0]).view(torch.int32), ref):
                raise AssertionError(f"{name} disagrees with the plain version on {label} at n = {n}")
            ms = time_ms(fn, index_sets)
            b = bound_ms(unique, n, cols)
            out.append(dict(table=label, variant=name, n=n, rows=rows, cols=cols, unique_rows=unique, ms=ms,
                            ns_per_row=1e6 * ms / n, bound_ms=b, bound_share=b / ms))
            print(f"{label:16s} [{rows:6d}, {cols:3d}] n = {n:6d}  {name:13s} {ms:9.4f} ms  "
                  f"{1e6 * ms / n:8.3f} ns/row  {100 * b / ms:5.1f} % of the byte bound")
    return out


def run(shapes=TABLES, ns=NS, iters: int = 50, path: bool = True) -> dict:
    """Time every variant on every table; returns {"device", "results"}."""
    if not torch.cuda.is_available():
        raise RuntimeError("bench_gather: no CUDA device is available")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(smi)
    results = []
    for rows, cols in shapes:
        table = torch.randn((rows, cols), generator=gen, device=dev)
        results += time_table(f"[{rows}, {cols}]", table, ns, iters, gen)
        del table
    if path:
        for label, table in path_tables(dev).items():
            results += time_table(label, table, (PATH_N,), iters, gen)
    return {"device": smi, "results": results}


def record_frame_gathers(renderer: Renderer) -> list:
    """Render one frame eagerly (a replay calls no Python) with the wrapper
    the path launches wrapped; returns [(table, idx)] in launch order."""
    recorded = []
    original = GC.gather_rows_cuda

    def recording(kernel, table, idx):
        recorded.append((table, idx.detach().clone()))
        return original(kernel, table, idx)

    GC.gather_rows_cuda = recording
    capture, renderer.capture = renderer.capture, False
    try:
        renderer.render_frame()
    finally:
        GC.gather_rows_cuda = original
        renderer.capture = capture
    return recorded


def frame_weighted(recorded, kernel) -> dict:
    """Sums over a frame's recorded gathers: ``kernel``'s device time, that of
    ``index_select`` on the same launches, and the byte bound (``bound_ms``
    of each launch's distinct rows); launches and rows gathered, by table
    width."""
    out = dict(launches=len(recorded), rows=0, ms=0.0, index_select_ms=0.0, bound_ms=0.0, by_width={})
    for table, idx in recorded:
        ms = device_ms(lambda: GC.gather_rows_cuda(kernel, table, idx))
        lib = device_ms(lambda: torch.index_select(table, 0, idx))
        b = bound_ms(unique_rows(idx), idx.shape[0], table.shape[1])
        out["rows"] += idx.shape[0]
        out["ms"] += ms
        out["index_select_ms"] += lib
        out["bound_ms"] += b
        w = out["by_width"].setdefault(table.shape[1], dict(launches=0, rows=0, ms=0.0, index_select_ms=0.0,
                                                             bound_ms=0.0))
        w["launches"] += 1
        w["rows"] += idx.shape[0]
        w["ms"] += ms
        w["index_select_ms"] += lib
        w["bound_ms"] += b
    return out


def check_edges(kernel, dev, gen) -> int:
    """``kernel`` bit for bit against the plain version on the ``EDGE_*``
    grid, with int64 and int32 indices, on tables of random bit patterns
    (NaNs, infinities, denormals) and indices that include the last row;
    raises at the first disagreement, returns the launches made."""
    launches = 0
    for rows, cols in ((r, c) for r in EDGE_ROWS for c in EDGE_WIDTHS):
        bits = torch.randint(-2**31, 2**31 - 1, (rows, cols), generator=gen, device=dev, dtype=torch.int64)
        table = bits.to(torch.int32).view(torch.float32)
        for n in EDGE_NS:
            idx = torch.randint(0, rows, (n,), generator=gen, device=dev)
            idx[0] = rows - 1
            ref = GC.gather_rows_plain(table, idx).view(torch.int32)
            for ix in (idx, idx.to(torch.int32)):
                got = GC.gather_rows_cuda(kernel, table, ix).view(torch.int32)
                launches += 1
                if not torch.equal(got, ref):
                    raise AssertionError(f"{kernel.symbol} on [{rows}, {cols}] at N = {n} ({ix.dtype}): "
                                         f"{int((got != ref).sum())} words differ from the plain version")
    return launches


def describe_frame(fw: dict) -> str:
    """``frame_weighted``'s sums on one line, and by width whether K7 is
    under ``index_select`` there."""
    return (f"K7 over one FULL + train frame: {fw['launches']} launches, {fw['rows']} rows, frame-weighted "
            f"{fw['ms']:.4f} ms, index_select {fw['index_select_ms']:.4f} ms, bound {fw['bound_ms']:.4f} ms "
            f"({100 * fw['bound_ms'] / fw['ms']:.1f} % of it); by width:\n"
            + "\n".join(f"  {w} columns: {v['launches']} launches, {v['rows']} rows, K7 {v['ms']:.4f} ms, index_select "
                        f"{v['index_select_ms']:.4f}, bound {v['bound_ms']:.4f} ({100 * v['bound_ms'] / v['ms']:.1f} %); "
                        f"K7 {'under' if v['ms'] < v['index_select_ms'] else 'NOT under'} index_select"
                        for w, v in sorted(fw["by_width"].items())))


def frame_report(renderer: Renderer) -> dict:
    """The path's gathers over one more frame of ``renderer``: each held bit
    for bit against the plain version, then ``frame_weighted`` for the path's
    kernel, printed by ``describe_frame``."""
    gathered = record_frame_gathers(renderer)
    for table, idx in gathered:
        if not torch.equal(GC.gather_rows(table, idx).view(torch.int32), table[idx].view(torch.int32)):
            raise AssertionError(f"a gather of the frame on {tuple(table.shape)} disagrees with the plain version")
    fw = frame_weighted(gathered, GC.PATH_KERNEL)
    print(describe_frame(fw))
    return fw


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tables", type=str, default=",".join(f"{r}x{c}" for r, c in TABLES),
                    help="table shapes ROWSxCOLS, comma separated")
    ap.add_argument("--n", type=str, default=",".join(str(n) for n in NS),
                    help="indices per launch, comma separated")
    ap.add_argument("--iters", type=int, default=50, help="timed launches per variant")
    ap.add_argument("--no-path", action="store_true", help="leave out the path's tables")
    args = ap.parse_args()
    shapes = tuple(tuple(int(v) for v in s.split("x")) for s in args.tables.split(","))
    out = run(shapes, tuple(int(v) for v in args.n.split(",")), args.iters, not args.no_path)
    print(out["device"])
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
