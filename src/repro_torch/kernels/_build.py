"""Build and bind the hand-written CUDA kernels (``csrc/*.cu``).

``nvcc`` compiles ``csrc/range_join.cu`` for ``sm_90a`` into a shared
library with a plain C interface, which :func:`load` opens with ``ctypes``.
The build happens at first use, never at import (the CPU test machine has
no ``nvcc``), into ``build/repro_torch/`` at the repository root, a
directory ``.gitignore`` lists.  The library's file name carries a hash of
the source and the flags, so an edited source rebuilds and an unchanged one
is reused within a checkout.  ``nvcc``'s output (``-Xptxas -v``: registers,
shared memory, spills per kernel) is kept beside the library as ``.log``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

__all__ = ["build", "load", "check_launch", "BUILD_DIR", "SOURCE"]

SOURCE = Path(__file__).with_name("csrc") / "range_join.cu"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(
            f"nvcc not found at {path}; the CUDA kernels are built from "
            f"{SOURCE.name} on a machine with the CUDA toolkit (set CUDA_HOME)"
        )
    return str(path)


def build() -> Path:
    """Compile the kernel library if this source has not been built yet."""
    src = SOURCE.read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    lib = BUILD_DIR / f"librange_join_{tag}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile to a temporary name and rename: a concurrent or interrupted
    # build never leaves a half-written library under the final name
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)],
            capture_output=True,
            text=True,
        )
        lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}) on {SOURCE.name}:\n"
                f"{proc.stderr[-4000:]}"
            )
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return lib


def load() -> ctypes.CDLL:
    """The built kernel library, bound once per process."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            lib.rj_range_join_mask.argtypes = [p, p, p, i64, i64, i, p]
            lib.rj_range_join_mask.restype = i
            lib.rj_range_join_tile_masks.argtypes = [p, p, p, p, p, i64, i, i, i, p]
            lib.rj_range_join_tile_masks.restype = i
            lib.rj_error_string.argtypes = [i]
            lib.rj_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check_launch(err: int, kernel: str) -> None:
    """Raise when a launcher reported a CUDA error (refused or failed)."""
    if err != 0:
        msg = load().rj_error_string(err).decode()
        raise RuntimeError(f"{kernel} launch failed: CUDA error {err} ({msg})")
