"""Launch-geometry autotuner for the batched numpy twin.

The port of ``repro.kernels.autotune``.  The blocked-numpy twin takes a
mask-block budget (cells per row block) whose best value depends on the
*shape* of the frontier being joined.  :class:`GeometryTuner` measures
candidate budgets the first time a (backend, frontier-shape bucket)
combination is seen — Triton-style: each candidate runs the real workload
once, the winner's result is kept so the measuring dispatch does the real
work — and caches the winner in a small table.

The segmented CUDA kernels are not tuned: they launch at
:data:`DEFAULT_GEOMETRY`.  The tile kernel evaluates 32 q rows x 128 r rows
per thread block whatever the tile, so ``(block_q, block_r)`` changes only
the padding and the tile count, and ``chip_smoke.py`` (phase 6) times the
alternatives on the card's main-path frontiers.

Backends are opaque strings and workloads run through caller-supplied
runners, so ``repro_torch.core`` imports this without touching the kernel
stack.  Entries are keyed by backend, so a table tuned elsewhere never
answers here.
"""

from __future__ import annotations

import math
import time
from typing import Callable, Iterable, Sequence

__all__ = [
    "GeometryTuner",
    "shape_bucket",
    "DEFAULT_GEOMETRY",
    "DEFAULT_TWIN_CELLS",
    "CANDIDATE_TWIN_CELLS",
]

# kernel-launch geometry: the (block_q, block_r) tile of the block-diagonal
# schedule, a multiple of the tile kernel's 32 x 128 thread block
DEFAULT_GEOMETRY = (256, 256)

# numpy-twin geometry: mask cells evaluated per row block (the twin's only
# launch knob — trades scratch-buffer locality against ufunc call overhead)
DEFAULT_TWIN_CELLS = (4_194_304,)
CANDIDATE_TWIN_CELLS = ((1_048_576,), (4_194_304,), (16_777_216,))

_TABLE_VERSION = 1


def _log2_bucket(n: int) -> int:
    """Coarse pow-2 bucket of a count (0 stays 0)."""
    return 0 if n <= 0 else int(math.log2(n)) + 1


def shape_bucket(shapes: "Sequence[tuple[int, int, int]]") -> str:
    """Bucket key for a frontier's segment shapes.

    ``shapes`` is ``[(n_query_rows, n_table_rows, n_attrs), ...]``.  Buckets
    are deliberately coarse — pow-2 segment count, pow-2 *median* row counts,
    exact max width — so a handful of tuning runs covers a workload's whole
    steady state without ever re-measuring near-identical frontiers.
    """
    if not shapes:
        return "empty"
    k = _log2_bucket(len(shapes))
    med_q = _log2_bucket(int(sorted(s[0] for s in shapes)[len(shapes) // 2]))
    med_r = _log2_bucket(int(sorted(s[1] for s in shapes)[len(shapes) // 2]))
    width = max(s[2] for s in shapes)
    return f"k{k}q{med_q}r{med_r}w{width}"


class GeometryTuner:
    """Per-(backend, shape-bucket) launch-geometry table with measurement.

    ``pick`` is the one-stop API: cached winner when known, otherwise (if a
    ``runner`` is supplied) measure every candidate on the real workload and
    cache the winner.  Geometries are opaque int tuples (``(block_cells,)``
    for the numpy twin).
    """

    def __init__(self) -> None:
        # parallel query workers race pick/lookup/to_manifest on one
        # tuner; the lock (rank 75, a leaf) guards only the table —
        # candidate measurement runs outside it, because runners execute
        # real workloads that take stats locks and fire metrics.  Imported
        # here: repro_torch.core imports this module.
        from repro_torch.core import _locks

        self._lock = _locks.new_lock("autotune._lock")
        self._table: dict[str, dict] = {}
        self.dirty = False

    # ------------------------------------------------------------------ #
    @staticmethod
    def _key(backend: str, bucket: str) -> str:
        return f"{backend}|{bucket}"

    def __len__(self) -> int:
        with self._lock:
            return len(self._table)

    def lookup(self, backend: str, bucket: str) -> "tuple[int, ...] | None":
        """The cached winning geometry, or None when this (backend, bucket)
        has never been measured — including after a backend change: entries
        are keyed by backend, so a table tuned elsewhere never answers."""
        with self._lock:
            rec = self._table.get(self._key(backend, bucket))
        if rec is None or rec.get("backend") != backend:
            return None
        try:
            return tuple(int(x) for x in rec["geometry"])
        except (KeyError, TypeError, ValueError):
            return None

    def pick(
        self,
        backend: str,
        bucket: str,
        runner: "Callable[[tuple[int, ...]], object] | None" = None,
        candidates: "Iterable[tuple[int, ...]]" = CANDIDATE_TWIN_CELLS,
        default: "tuple[int, ...]" = DEFAULT_TWIN_CELLS,
    ) -> "tuple[tuple[int, ...], object | None]":
        """Winning geometry for (backend, bucket), measuring on a miss.

        Returns ``(geometry, result)``: ``result`` is the winner's workload
        output when this call measured (so the tuning dispatch does the real
        work — no wasted evaluation), else ``None`` (cache hit, or no
        ``runner`` to measure with → ``default``).  Each candidate runs
        once: the runners are pure numpy, with nothing to compile first.
        """
        cached = self.lookup(backend, bucket)
        if cached is not None:
            return cached, None
        if runner is None:
            return tuple(default), None
        best: "tuple[int, ...] | None" = None
        best_s = math.inf
        best_result: object = None
        measured: dict[str, float] = {}
        for geom in candidates:
            geom = tuple(int(x) for x in geom)
            t0 = time.perf_counter()
            result = runner(geom)
            dt = time.perf_counter() - t0
            measured["x".join(str(x) for x in geom)] = round(dt * 1e6, 1)
            if dt < best_s:
                best, best_s, best_result = geom, dt, result
        assert best is not None, "no candidate geometries supplied"
        # concurrent measurers of the same key race benignly: last writer
        # wins and both winners came from real measurements
        with self._lock:
            self._table[self._key(backend, bucket)] = {
                "backend": backend,
                "bucket": bucket,
                "geometry": list(best),
                "us": round(best_s * 1e6, 1),
                "measured": measured,
            }
            self.dirty = True
        return best, best_result

    # ------------------------------------------------------------------ #
    # persistence (catalog sidecar)
    # ------------------------------------------------------------------ #
    def to_manifest(self) -> dict:
        with self._lock:
            return {"version": _TABLE_VERSION, "entries": dict(self._table)}

    def load_manifest(self, chunk: "dict | None") -> None:
        """Restore a persisted table, dropping anything malformed.

        Tolerant by design (the sidecar may be torn or from a future
        version): a bad chunk loads as a cold table, and entries whose
        recorded backend disagrees with their key are discarded — they
        could only mislead a lookup.
        """
        self._table.clear()
        self.dirty = False
        if not isinstance(chunk, dict):
            return
        entries = chunk.get("entries")
        if not isinstance(entries, dict):
            return
        for key, rec in entries.items():
            if not isinstance(rec, dict) or not isinstance(key, str):
                continue
            backend = rec.get("backend")
            if not isinstance(backend, str) or not key.startswith(backend + "|"):
                continue
            geom = rec.get("geometry")
            if not (
                isinstance(geom, list)
                and geom
                and all(isinstance(x, int) and x > 0 for x in geom)
            ):
                continue
            self._table[key] = rec
