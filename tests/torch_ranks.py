"""Spawned gloo ranks for the port's multi-GPU tests, on the CPU.

``run_ranks("module:function", world, tmp_path, **arrays)`` starts ``world``
processes with the ``spawn`` method; each joins a gloo group at
``tcp://127.0.0.1:<free port>`` as its rank, holds PyTorch to one thread,
calls ``function(rank, world, **arrays)`` from ``tests/<module>.py`` and
saves the dict of numpy arrays it returns. Every join has a timeout: a rank
that hangs (a collective its peers never reach) is terminated and fails the
test instead of stalling the run. No JAX here: a rank imports only what its
function's module imports.
"""

import importlib
import multiprocessing
import os
import socket
import time

import numpy as np

RANK_TIMEOUT_S = 300


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(target: str, rank: int, world: int, port: int, out: str, kwargs: dict) -> None:
    import torch

    from nrc_tpu_torch.parallel.shard import init_data_group

    torch.set_num_threads(1)
    init_data_group("cpu", rank, world, port)
    try:
        module, name = target.split(":")
        result = getattr(importlib.import_module(module), name)(rank, world, **kwargs)
        np.savez(os.path.join(out, f"rank{rank}.npz"), **{k: np.asarray(v) for k, v in result.items()})
    finally:
        import torch.distributed as dist

        dist.destroy_process_group()


def run_ranks(target: str, world: int, tmp_path, timeout: float = RANK_TIMEOUT_S, **kwargs) -> list:
    """Each rank's dict of arrays, in rank order."""
    ctx = multiprocessing.get_context("spawn")
    port, out = free_port(), str(tmp_path)
    procs = [ctx.Process(target=_rank_main, args=(target, rank, world, port, out, kwargs)) for rank in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.join(max(deadline - time.monotonic(), 0.0))
    finally:
        hung = [rank for rank, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(10)
    assert not hung, f"ranks {hung} of {target} did not finish within {timeout} s"
    codes = [p.exitcode for p in procs]
    assert codes == [0] * world, f"{target}: exit codes {codes}"
    results = []
    for rank in range(world):
        with np.load(os.path.join(out, f"rank{rank}.npz")) as f:
            results.append({k: f[k] for k in f.files})
    return results
