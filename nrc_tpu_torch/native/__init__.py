"""ctypes loader for the port's native host helpers (``nrc_native.c``).

The library is compiled with the host C compiler at first use into
``build/nrc_tpu_torch/`` at the root of the checkout (never beside the
source), named by a hash of the source and flags so that an edited source
rebuilds. The flags are those of ``nrc_tpu/native/__init__.py``, so both
packages build the same BVH on one machine. Without a C compiler
``get_lib()`` returns None and the callers (``ops/bvh.py``,
``ops/bvh_wide.py``, ``scene/lights.py``) take their numpy/Python builds:
slower, and another (valid) tree; the alias tables are the same bits.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

SOURCE = Path(__file__).resolve().parent / "nrc_native.c"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "nrc_tpu_torch"
CFLAGS = ("-O3", "-march=native", "-fPIC", "-shared")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_failed = False


def _compile(out: Path) -> bool:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(
            [os.environ.get("CC", "cc"), *CFLAGS, "-o", tmp, str(SOURCE), "-lm"],
            check=True, capture_output=True, timeout=120,
        )
        os.replace(tmp, out)
        return True
    except (OSError, subprocess.CalledProcessError, subprocess.TimeoutExpired):
        return False
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def get_lib() -> Optional[ctypes.CDLL]:
    """Load (compiling if needed) the native library; None if unavailable."""
    global _lib, _failed
    with _lock:
        if _lib is not None or _failed:
            return _lib
        digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(CFLAGS).encode()).hexdigest()[:16]
        out = BUILD_DIR / f"libnrc_native-{digest}.so"
        if not out.exists() and not _compile(out):
            _failed = True
            return None
        try:
            lib = ctypes.CDLL(str(out))
        except OSError:
            _failed = True
            return None
        p, i32 = ctypes.c_void_p, ctypes.c_int32
        lib.bvh_build_binned_sah.restype = i32
        lib.bvh_build_binned_sah.argtypes = [
            p, p, p,                 # p0, p1, p2
            i32, i32,                # num, max_leaf
            p, p, p, p, p, p, p,     # order, lo, hi, left, right, start, count
        ]
        lib.bvh_collapse_wide.restype = i32
        lib.bvh_collapse_wide.argtypes = [
            p, p,                    # left, right
            p, p, p,                 # start, count, order
            p, p,                    # lo, hi
            i32, i32, i32,           # n, leaf_size, branch
            p, p, p,                 # meta, box, leaf_ids
            p,                       # out_counts[3]
        ]
        lib.alias_table_build.restype = i32
        lib.alias_table_build.argtypes = [p, ctypes.c_int64, p, p]  # p, n, prob, alias
        _lib = lib
        return _lib
