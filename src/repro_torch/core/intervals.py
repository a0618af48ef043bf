"""Integer-interval primitives shared by the ProvRC encoder and the query engine.

All lineage data in DSLog is expressed over *closed* integer intervals
``[lo, hi]`` (inclusive on both ends, 0-based).  A width-0 interval
(``lo == hi``) is a single cell index.  The helpers here are pure numpy and
fully vectorized host code, as in ``repro.core.intervals``.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "lexsort_rows",
    "segment_starts",
    "segment_ids_from_starts",
    "segment_reduce_min",
    "segment_reduce_max",
    "segment_reduce_first",
    "segment_all",
    "cummax_with_reset",
    "coalesce_1d",
    "interval_overlap",
    "interval_intersect",
]


def lexsort_rows(cols: list[np.ndarray]) -> np.ndarray:
    """Return the permutation sorting rows by ``cols[0]`` (primary) onward.

    ``np.lexsort`` takes the *last* key as primary, hence the reversal.
    """
    if not cols:
        raise ValueError("need at least one sort column")
    return np.lexsort(tuple(reversed(cols)))


def segment_starts(boundary: np.ndarray) -> np.ndarray:
    """Indices where a new segment starts.  ``boundary[0]`` is forced True."""
    b = boundary.copy()
    if b.size:
        b[0] = True
    return np.flatnonzero(b)


def segment_ids_from_starts(starts: np.ndarray, n: int) -> np.ndarray:
    seg = np.zeros(n, dtype=np.int64)
    if starts.size:
        seg[starts[1:]] = 1
    return np.cumsum(seg)


def segment_reduce_min(x: np.ndarray, starts: np.ndarray) -> np.ndarray:
    return np.minimum.reduceat(x, starts) if x.size else x[:0]


def segment_reduce_max(x: np.ndarray, starts: np.ndarray) -> np.ndarray:
    return np.maximum.reduceat(x, starts) if x.size else x[:0]


def segment_reduce_first(x: np.ndarray, starts: np.ndarray) -> np.ndarray:
    return x[starts] if x.size else x[:0]


def segment_all(flags: np.ndarray, starts: np.ndarray) -> np.ndarray:
    """Per-segment logical AND of a boolean vector."""
    if flags.size == 0:
        return flags[:0]
    return np.minimum.reduceat(flags.astype(np.int8), starts) > 0


def cummax_with_reset(x: np.ndarray, group_ids: np.ndarray) -> np.ndarray:
    """Cumulative max of ``x`` that resets at each change of ``group_ids``.

    Implemented with the monotone-offset trick so it stays fully vectorized:
    within a group the added offset is constant, and offsets grow with the
    group id, so ``np.maximum.accumulate`` can never carry a maximum backward
    across a group boundary.
    """
    if x.size == 0:
        return x.copy()
    x = x.astype(np.int64)
    span = int(x.max()) - int(x.min()) + 2
    off = group_ids.astype(np.int64) * span
    return np.maximum.accumulate(x + off) - off


def coalesce_1d(
    group_ids: np.ndarray, lo: np.ndarray, hi: np.ndarray
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Union adjacent/overlapping intervals sharing a group id.

    Rows must already be sorted by ``(group_ids, lo)``.  Returns
    ``(starts, out_lo, out_hi)`` where ``starts`` indexes the first source row
    of each output interval (useful to gather untouched columns).
    Two intervals merge when ``next.lo <= running_max(hi) + 1``.
    """
    n = lo.size
    if n == 0:
        return np.zeros(0, np.int64), lo.copy(), hi.copy()
    cm = cummax_with_reset(hi, group_ids)
    boundary = np.ones(n, dtype=bool)
    boundary[1:] = (group_ids[1:] != group_ids[:-1]) | (lo[1:] > cm[:-1] + 1)
    starts = np.flatnonzero(boundary)
    out_lo = lo[starts]
    out_hi = segment_reduce_max(hi, starts)
    return starts, out_lo, out_hi


def interval_overlap(
    alo: np.ndarray, ahi: np.ndarray, blo: np.ndarray, bhi: np.ndarray
) -> np.ndarray:
    """Elementwise (broadcasting) test ``[alo,ahi] ∩ [blo,bhi] != ∅``."""
    return np.logical_and(alo <= bhi, blo <= ahi)


def interval_intersect(
    alo: np.ndarray, ahi: np.ndarray, blo: np.ndarray, bhi: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    return np.maximum(alo, blo), np.minimum(ahi, bhi)
