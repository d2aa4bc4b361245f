"""How fast the card gathers rows: the three gather kernels and ``index_select``.

Counterpart of ``tools/bench_gather_pallas.py`` for the port. Run from the
root of a checkout on a machine with one CUDA card:

    python3 -m nrc_tpu_torch.tools.bench_gather [--rows 131072] [--cols 160] [--n 2048,102400]

For each ``n`` it gathers ``n`` random rows of a ``[rows, cols]`` float32
table (the wide walk's unified node + leaf table has 160 columns, 640 bytes
a row) with each variant of ``ops/gather_cuda.py`` (``warp`` = K7,
``resident`` = K8, ``block`` = K9), with the plain version ``table[idx]``
and with ``torch.index_select``, the one library call that computes the
same function (the port never calls it on the card). Every launch takes a
fresh index set, precomputed, so that no launch finds its rows in the L1;
the table (84 MB at the default size) does not fit the card's 50 MB L2.
Times are CUDA events around ``--iters`` launches after a warm-up; each
variant is first compared with the plain version bit for bit. Reported: ns
per gathered row, and the share of the byte bound (each row read and
written once plus the index, over 3.35 TB/s). The last line is one JSON
object with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import torch

from ..ops import gather_cuda as GC

HBM_BYTES_PER_S = 3.35e12  # H100 SXM


def time_ms(fn, index_sets, warmup: int = 3) -> float:
    for k in range(warmup):
        fn(index_sets[k % len(index_sets)])
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for idx in index_sets:
        fn(idx)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / len(index_sets)


def bound_ms(n: int, cols: int) -> float:
    """Each gathered row read once and written once, plus its int64 index."""
    return 1e3 * (2 * n * cols * 4 + n * 8) / HBM_BYTES_PER_S


def run(rows: int = 131072, cols: int = 160, ns=(2048, 102400), iters: int = 50) -> dict:
    """Time every variant at every ``n``; returns {"device", "results"}."""
    if not torch.cuda.is_available():
        raise RuntimeError("bench_gather: no CUDA device is available")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    table = torch.randn((rows, cols), generator=gen, device=dev)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    variants = {name: (lambda idx, k=k: GC.gather_rows_cuda(k, table, idx)) for name, k in GC.VARIANTS.items()}
    variants["plain"] = lambda idx: GC.gather_rows_plain(table, idx)
    variants["index_select"] = lambda idx: torch.index_select(table, 0, idx)
    results = []
    for n in ns:
        index_sets = [torch.randint(0, rows, (n,), generator=gen, device=dev) for _ in range(iters)]
        ref = GC.gather_rows_plain(table, index_sets[0])
        for name, fn in variants.items():
            if not torch.equal(fn(index_sets[0]).view(torch.int32), ref.view(torch.int32)):
                raise AssertionError(f"{name} disagrees with the plain version at n = {n}")
            ms = time_ms(fn, index_sets)
            results.append(dict(variant=name, n=n, rows=rows, cols=cols, ms=ms,
                                ns_per_row=1e6 * ms / n, bound_ms=bound_ms(n, cols),
                                bound_share=bound_ms(n, cols) / ms))
            print(f"n = {n:7d}  {name:13s} {ms:9.4f} ms  {1e6 * ms / n:8.3f} ns/row  "
                  f"{100 * bound_ms(n, cols) / ms:5.1f} % of the byte bound")
    return {"device": smi, "results": results}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=131072, help="table rows")
    ap.add_argument("--cols", type=int, default=160, help="row width in float32")
    ap.add_argument("--n", type=str, default="2048,102400", help="indices per launch, comma separated")
    ap.add_argument("--iters", type=int, default=50, help="timed launches per variant")
    args = ap.parse_args()
    out = run(args.rows, args.cols, tuple(int(v) for v in args.n.split(",")), args.iters)
    print(out["device"])
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
