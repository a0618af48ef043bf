"""Build and bind the hand-written CUDA kernels (``csrc/*.cu``).

``nvcc`` compiles every ``csrc/*.cu`` for ``sm_90a`` (one process per
source, all started together) and links the objects into one shared library
with a plain C interface, which :func:`load` opens with ``ctypes``.  The
build happens at first use, never at import (the CPU test machine has no
``nvcc``), into ``build/repro_torch/`` at the repository root, a directory
``.gitignore`` lists.  The library's file name carries a hash of every
source (name and bytes) and the flags, so an edited source rebuilds and an
unchanged set is reused within a checkout.  ``nvcc``'s output (``-Xptxas
-v``: registers, shared memory, spills per kernel) is kept beside the
library as ``.log``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

__all__ = ["build", "load", "check_launch", "BUILD_DIR", "SOURCES"]

CSRC = Path(__file__).with_name("csrc")
SOURCES = tuple(sorted(CSRC.glob("*.cu")))
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (
    *ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(
            f"nvcc not found at {path}; the CUDA kernels are built from "
            f"{CSRC} on a machine with the CUDA toolkit (set CUDA_HOME)"
        )
    return str(path)


def _tag() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES:
        h.update(src.name.encode() + b"\0" + src.read_bytes())
    return h.hexdigest()[:12]


def build() -> Path:
    """Compile the kernel library if this set of sources has not been built."""
    lib = BUILD_DIR / f"libreprotorch_{_tag()}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    # objects and the library go to a temporary directory first and the
    # library is renamed into place: a concurrent or interrupted build never
    # leaves a half-written library under the final name
    tmp = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    try:
        objs = [tmp / f"{src.stem}.o" for src in SOURCES]
        procs = [
            subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            )
            for src, obj in zip(SOURCES, objs)
        ]
        logs, failed = [], []
        for src, proc in zip(SOURCES, procs):
            out, err = proc.communicate()
            logs.append(f"== {src.name}\n{out}{err}")
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}) on {src.name}:\n{err[-4000:]}")
        if not failed:
            proc = subprocess.run(
                [nvcc, *ARCH, "-shared", "-o", str(tmp / lib.name), *map(str, objs)],
                capture_output=True, text=True,
            )
            logs.append(f"== link\n{proc.stdout}{proc.stderr}")
            if proc.returncode != 0:
                failed.append(f"nvcc link failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
        lib.with_suffix(".log").write_text("\n".join(logs))
        if failed:
            raise RuntimeError("\n".join(failed))
        os.replace(tmp / lib.name, lib)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
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
            lib.rb_run_boundaries.argtypes = [p, p, i64, i, i, p]
            lib.rb_run_boundaries.restype = i
            lib.rj_error_string.argtypes = [i]
            lib.rj_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check_launch(err: int, kernel: str) -> None:
    """Raise when a launcher reported a CUDA error (refused or failed)."""
    if err != 0:
        msg = load().rj_error_string(err).decode()
        raise RuntimeError(f"{kernel} launch failed: CUDA error {err} ({msg})")
