"""Build and bind the hand-written CUDA kernels under ``csrc/``.

Each ``.cu`` file exposes a plain C interface (pointers, sizes and the
stream as ``void*``). It is compiled with ``nvcc`` for ``sm_90a`` into a
shared library under ``build/nrc_tpu_torch/`` at the root of the checkout
(listed in ``.gitignore``), at first use, and loaded with ``ctypes``. No
PyTorch headers are involved, so a build takes seconds. The library name
carries a hash of the source and flags, so an edited source rebuilds.

``CudaKernel`` is the launch handle a wrapper holds: it builds lazily, runs
the C entry point on PyTorch's current stream, raises when the entry point
returns a CUDA error, and counts its launches.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Sequence, Tuple

import torch

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "nrc_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# (source, extra flags) -> (loaded library, compiler log)
_LIBRARIES: Dict[Tuple[str, Tuple[str, ...]], Tuple[ctypes.CDLL, str]] = {}


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def build_library(source: str, extra_flags: Sequence[str] = ()) -> Tuple[ctypes.CDLL, str]:
    """Compile ``csrc/<source>`` (once per process and source hash) and load
    it. Returns (library, compiler log; empty when the library was cached)."""
    key = (source, tuple(extra_flags))
    if key in _LIBRARIES:
        return _LIBRARIES[key]
    src = CSRC_DIR / source
    flags = list(NVCC_FLAGS) + list(extra_flags)
    # the shared headers count too: an edited header rebuilds its includers
    headers = b"".join(h.read_bytes() for h in sorted(CSRC_DIR.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers + " ".join(flags).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"lib{src.stem}-{digest}.so"
    log = ""
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            proc = subprocess.run(
                [_nvcc(), *flags, "-o", tmp, str(src)],
                capture_output=True, text=True, check=False,
            )
            log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {src}:\n{log}")
            os.replace(tmp, out)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    _LIBRARIES[key] = (ctypes.CDLL(str(out)), log)
    return _LIBRARIES[key]


def current_stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


class CudaKernel:
    """One C entry point of a ``csrc`` library, with a count of launches.

    ``argtypes`` are the ctypes of the entry point's arguments; every
    entry point returns ``cudaGetLastError()`` as an int.
    """

    def __init__(self, source: str, symbol: str, argtypes: Sequence,
                 extra_flags: Sequence[str] = ()):
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.extra_flags = tuple(extra_flags)
        self.launches = 0
        self.library_path = None  # the built shared library, once build() has run
        self._fn = None

    def build(self) -> str:
        """Build and bind the entry point; returns the compiler log."""
        lib, log = build_library(self.source, self.extra_flags)
        self.library_path = lib._name
        if self._fn is None:
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        return log

    def launch(self, *args) -> None:
        if self._fn is None:
            self.build()
        rc = self._fn(*args)
        if rc != 0:
            raise RuntimeError(f"{self.symbol}: CUDA error {rc} at launch")
        self.launches += 1


def check_cuda_tensor(name: str, t: torch.Tensor, dtype: torch.dtype,
                      shape: Tuple, device: torch.device) -> None:
    """Raise unless ``t`` is a contiguous, 16-byte aligned ``dtype`` tensor
    of ``shape`` (None = any extent) on ``device``."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if t.dim() != len(shape) or any(
        s is not None and s != d for s, d in zip(shape, t.shape)
    ):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: not 16-byte aligned")
