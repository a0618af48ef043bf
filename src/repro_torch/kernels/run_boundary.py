"""Fused multi-column run-boundary detection: a CUDA kernel for Hopper.

The O(N) pass of a ProvRC range-encoding step (paper §IV.A): given rows
*already sorted* by their group key, flag ``1`` where a run starts — where
any group-key column changes, or the merge column stops being contiguous
(``lo[t] > hi[t-1] + 1``).  Row 0 always starts one.

This is the port of ``repro.kernels.run_boundary``.  Its Pallas TPU kernel
becomes the hand-written CUDA kernel of ``csrc/run_boundary.cu`` (built by
:mod:`._build`).  The operand keeps the reference layout: packed
``[N, 128]`` int32, ``packed[:, :n_keys]`` the group-key columns,
``packed[:, n_keys]`` the merge ``lo`` and ``packed[:, n_keys + 1]`` the
merge ``hi``.  The flags are ``uint8`` 0/1 (the reference returns int32).
A CUDA tensor goes to the kernel and a CPU tensor to the plain version
:func:`.ref.run_boundaries_ref`; there is no fallback from one to the
other.  The wrapper counts its launches in
``run_boundaries_packed.launches``.
"""

from __future__ import annotations

import threading

import torch

from . import _build
from .ref import LANES, run_boundaries_ref

__all__ = ["LANES", "run_boundaries_packed"]

# parallel callers may launch from several threads; the counter's
# read-modify-write must not lose a launch
_count_lock = threading.Lock()


def run_boundaries_packed(
    packed: torch.Tensor, *, n_keys: int, block_rows: int = 1024
) -> torch.Tensor:
    """Boundary flags for a packed ``[N, 128]`` int32 sorted table: ``[N]``
    uint8.

    Any row count: the kernel bounds-checks the last block instead of
    padding.  ``n_keys + 2`` lanes must fit the 128.  ``block_rows`` is the number of rows one CUDA block takes (the
    TPU kernel's tile); it changes the launch grid, never a flag.
    """
    if not 0 <= n_keys <= LANES - 2:
        raise ValueError(f"{n_keys} group columns do not fit one {LANES}-lane tile")
    if packed.dim() != 2 or packed.shape[1] != LANES:
        raise ValueError(f"the table must be packed to {LANES} lanes")
    if packed.dtype != torch.int32:
        raise ValueError(f"the packed table must be int32, got {packed.dtype}")
    if not packed.is_contiguous():
        raise ValueError("the packed table must be contiguous")
    if block_rows <= 0:
        raise ValueError(f"block_rows must be positive, got {block_rows}")
    device = packed.device
    if device.type == "cpu":
        return run_boundaries_ref(packed, n_keys)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    n = packed.shape[0]
    out = torch.empty(n, dtype=torch.uint8, device=device)
    if n:
        lib = _build.load()
        with torch.cuda.device(device):
            err = lib.rb_run_boundaries(
                packed.data_ptr(), out.data_ptr(), n, n_keys, block_rows,
                torch.cuda.current_stream(device).cuda_stream,
            )
        _build.check_launch(err, "run_boundaries_packed")
        with _count_lock:
            run_boundaries_packed.launches += 1
    return out


run_boundaries_packed.launches = 0
