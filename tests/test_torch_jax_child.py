"""The JAX side of a port parity test in a fresh process, and why.

JAX's Pallas TPU interpret mode (``pltpu.force_tpu_interpret_mode``) runs a
kernel as a CPU program that calls back into Python: its ordered
io_callbacks (``_update_clocks_for_device_barrier`` and the memory
accesses) run on XLA's callback thread, and the clock update multiplies the
device id, a ``jax.Array``, so the callback dispatches a JAX operation of
its own. The CPU client dispatches asynchronously: while the kernel's
program runs, the test's thread goes on enqueueing the next eager
operations (the backward pass of an eager ``train_step``, the slicing after
a kernel call), which wait on the program's outputs. When the callback's
operation is enqueued behind them, it waits on them, they wait on the
program, and the program waits on its callback: every thread idles on a
futex. Whole runs of the test suite under xdist hung so in
``test_torch_hash_train.py::test_hash_train_step_matches_jax`` (main thread
in ``apply_primitive`` of the backward pass's ``add``, callback thread in
``shared_memory.update_clocks_for_device_barrier``'s multiply); a file alone
mostly passes, since the race needs the callback to come late.

The test process cannot turn that off: its CPU client is made before any
test module is imported (``tests/conftest.py`` asks for the devices), and
``jax_cpu_enable_async_dispatch`` is read when the client is made. A child
process makes its own client with it off, so each computation runs to its
end before the caller dispatches the next, and nothing queues behind a
running kernel. ``run_jax_side`` runs the JAX side of a comparison there:
the inputs go in as an npz, ``function(**arrays)`` from ``tests/<module>.py``
runs, and the dict of numpy arrays it returns comes back as an npz. The
numbers are those of the same functions run in the test process: the same
XLA programs, one after another.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np

TESTS_DIR = Path(__file__).resolve().parent

CHILD = """
import os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_cpu_enable_async_dispatch", False)
jax.config.update("jax_enable_compilation_cache", False)
tests, root, target, src, dst = sys.argv[1:6]
sys.path[:0] = [tests, root]
import importlib
import numpy as np
module, name = target.split(":")
fn = getattr(importlib.import_module(module), name)
with np.load(src) as f:
    arrays = {k: f[k] for k in f.files}
out = fn(**arrays)
np.savez(dst, **{k: np.asarray(v) for k, v in out.items()})
"""


def run_jax_side(target: str, tmp_path, **arrays) -> dict:
    """``target`` ("module:function" of ``tests/``) called with ``arrays`` in
    a child process with synchronous CPU dispatch; its dict of arrays."""
    name = target.replace(":", ".")
    src, dst = Path(tmp_path) / f"{name}.in.npz", Path(tmp_path) / f"{name}.out.npz"
    np.savez(src, **arrays)
    proc = subprocess.run(
        [sys.executable, "-c", CHILD, str(TESTS_DIR), str(TESTS_DIR.parent), target, str(src), str(dst)],
        capture_output=True, text=True, env=dict(os.environ),
    )
    assert proc.returncode == 0, f"the JAX side {target} failed:\n{proc.stderr[-4000:]}"
    with np.load(dst) as f:
        return {k: f[k] for k in f.files}


def flatten_log(log: list) -> dict:
    """A list of (tag, [arrays]) as npz entries, in order."""
    out = {}
    for i, (tag, arrays) in enumerate(log):
        for j, a in enumerate(arrays):
            out[f"log.{i:05d}.{tag}.{j}"] = np.asarray(a)
    return out


def unflatten_log(flat: dict) -> list:
    """``flatten_log``'s inverse."""
    entries = {}
    for key in sorted(k for k in flat if k.startswith("log.")):
        _, i, tag, j = key.split(".")
        entries.setdefault(int(i), (tag, []))[1].append(flat[key])
    return [entries[i] for i in sorted(entries)]


# ---------------------------------------------------------------------------
# the mechanism's own checks (the child's side is below)
# ---------------------------------------------------------------------------

def _child_config(probe):
    import jax
    from jax._src import xla_bridge

    return {"async_dispatch": np.bool_(xla_bridge._CPU_ENABLE_ASYNC_DISPATCH.value),
            "platform": np.array(jax.devices()[0].platform), "probe": probe * 2}


def test_child_runs_with_synchronous_dispatch(tmp_path):
    """The child's CPU client dispatches synchronously, on the CPU, and the
    arrays cross both ways bit for bit."""
    probe = np.random.default_rng(0).normal(size=(7, 5)).astype(np.float32)
    out = run_jax_side("test_torch_jax_child:_child_config", tmp_path, probe=probe)
    assert not out["async_dispatch"] and str(out["platform"]) == "cpu"
    assert out["probe"].dtype == np.float32 and np.array_equal(out["probe"], probe * 2)


def _child_interpret_kernel(x, w_in, w_hidden, w_out):
    """A TPU kernel in interpret mode, then an eager operation on its output
    (what hung with asynchronous dispatch)."""
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from nrc_tpu.ops import mlp_pallas as JMP

    with pltpu.force_tpu_interpret_mode():
        out = JMP.fused_forward(w_in, w_hidden, w_out, x, output_relu=False)
        total = jnp.sum(out[:, :3])
    return {"out": np.asarray(out), "sum": np.asarray(total)}


def test_child_runs_a_tpu_kernel_in_interpret_mode(tmp_path):
    """K3's TPU kernel in interpret mode in the child, against the port's
    plain K3 (``test_torch_mlp.py``'s tolerance), and the eager sum after
    it equal to the sum of what came back within f32 rounding."""
    import torch

    from nrc_tpu_torch.ops import mlp_cuda as MC

    rs = np.random.default_rng(1)
    x = rs.normal(size=(256, MC.LANE)).astype(np.float32)
    w = [(rs.normal(size=s) * 0.1).astype(np.float32)
         for s in ((MC.LANE, MC.WIDTH), (4, MC.WIDTH, MC.WIDTH), (MC.WIDTH, MC.OUT_PAD))]
    ref = run_jax_side("test_torch_jax_child:_child_interpret_kernel", tmp_path, x=x,
                       w_in=w[0], w_hidden=w[1], w_out=w[2])
    got = MC.fused_forward_plain(*(torch.from_numpy(a) for a in w), torch.from_numpy(x), False)
    np.testing.assert_allclose(got.numpy(), ref["out"], atol=1e-2, rtol=1e-2)
    assert np.isclose(ref["sum"], ref["out"][:, :3].sum(dtype=np.float64), rtol=1e-5)
