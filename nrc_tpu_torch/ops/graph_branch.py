"""Two-way branches on a device flag inside a captured frame.

A frame on the card is one CUDA graph replay, which reads nothing back. Where
the frame's work depends on a flag it computes on the device, the graph
holds two bodies under CUDA conditional IF nodes (``csrc/graph_branch.cu``),
one run where the flag is set and one where it is clear; a replay runs one
of them. The PyTorch build on the card has no call for such nodes, so the
node is made through the CUDA runtime, and the body's work is captured on a
stream of its own into the node's body graph. PyTorch hands out its streams
from fixed pools, round and round, so a stream of the default priority may
be the one being captured; the body's stream is drawn from the high
priority pool, which no capture here uses.

A body allocates its temporaries from a private pool of the caching
allocator, to which the capturing thread's allocations are routed while the
body is captured: the graph's own pool takes only the work of the stream
being captured, and a body is captured on another. A body's temporaries do
not outlive it, so the bodies of every graph a ``Branches`` captures share
its pool (their replays run one after another on one stream). The pool is
held while the ``Branches`` lives and then released by a decrement of its
count, which is safe at any time. (A ``torch.cuda.MemPool`` would free its
blocks in its destructor, which synchronizes and so aborts the process when
it runs inside a capture or after a failed one.) A body writes its results
into tensors allocated before the node, which both bodies write and the
work after the node reads.

The hand kernels a body launches are counted apart (``captured``): a
replay counts the launches of the body that ran (``cuda_build.
defer_launches``).
"""

from __future__ import annotations

import contextlib
import ctypes
import weakref

import torch

from .cuda_build import CudaKernel, build_library, current_stream, launch_counts, ptr

SOURCE = "graph_branch.cu"
_P, _I = ctypes.c_void_p, ctypes.c_int
IF_KERNEL = CudaKernel(SOURCE, "nrc_if_begin", [_P, _P, _I, _P])  # the condition's one-thread kernel


def _end_capture(stream: torch.cuda.Stream) -> int:
    """End the capture of a body on ``stream``; returns the CUDA error."""
    lib, _ = build_library(SOURCE)
    fn = lib.nrc_if_end
    fn.argtypes, fn.restype = [_P], ctypes.c_int
    return fn(ctypes.c_void_p(stream.cuda_stream))


def _route_to_pool(device: int, pool) -> None:
    """Route the calling thread's allocations on ``device`` to ``pool``, one
    more use of it, until ``_stop_routing`` (``torch.cuda.use_mem_pool``'s
    calls: the newer name where the build has it)."""
    begin = getattr(torch._C, "_cuda_beginAllocateCurrentThreadToPool", None)
    (begin or torch._C._cuda_beginAllocateToPool)(device, pool)


def _stop_routing(device: int, pool) -> None:
    torch._C._cuda_endAllocateToPool(device, pool)


class Branches:
    """The stream and memory pool that IF-node bodies are captured with, on
    ``device``; one a renderer, kept as long as its graphs."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self._index = self.device.index if self.device.index is not None else torch.cuda.current_device()
        self.stream = torch.cuda.Stream(self.device, priority=-1)
        self.pool = torch.cuda.graph_pool_handle()
        # the use of the pool held while this lives
        _route_to_pool(self._index, self.pool)
        _stop_routing(self._index, self.pool)
        weakref.finalize(self, torch._C._cuda_releasePool, self._index, self.pool)
        IF_KERNEL.build()  # nvcc now, not inside a capture
        # the bodies captured since the capture began (``Renderer._capture``
        # empties it): (flag, the value that runs the body, its launches)
        self.captured: list = []
        # set while an eager frame warms the ops of both bodies before a capture
        self.warming = False

    @contextlib.contextmanager
    def body(self, flag: torch.Tensor, taken: bool):
        """Capture the block as the body of an IF node that runs where the
        0-d bool ``flag`` on the device is ``taken``. Only inside a capture,
        on the stream being captured."""
        if not torch.cuda.is_current_stream_capturing():
            raise RuntimeError("an IF node is captured only inside a CUDA graph capture")
        IF_KERNEL.launch(current_stream(self.device), ptr(flag), int(not taken), ctypes.c_void_p(self.stream.cuda_stream))
        before = launch_counts()
        try:
            _route_to_pool(self._index, self.pool)
            try:
                with torch.cuda.stream(self.stream):
                    yield
            finally:
                _stop_routing(self._index, self.pool)
                torch._C._cuda_releasePool(self._index, self.pool)
        except BaseException:
            _end_capture(self.stream)  # the body's own error goes on, whatever this one's
            raise
        rc = _end_capture(self.stream)
        if rc != 0:
            raise RuntimeError(f"nrc_if_end: CUDA error {rc}")
        self.captured.append((flag, taken, {k: n - before[k] for k, n in launch_counts().items() if n != before[k]}))
