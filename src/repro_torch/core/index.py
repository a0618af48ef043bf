"""Interval index: sorted candidate pruning for the θ-join (paper §V at scale).

The range join of §V.B.1 asks, for every query box and table row, whether the
key intervals overlap on all attributes.  The dense formulation materializes
an ``nq × nr`` pair matrix — fine for small tables, hopeless at catalog scale.
This module provides the indexed alternative:

For each attribute ``j`` the rows are sorted by ``lo[:, j]`` and we keep the
*running maximum* of ``hi`` in that order.  A probe interval ``[qlo, qhi]``
then locates its candidate window with two binary searches:

* ``end   = searchsorted(sorted_lo, qhi, 'right')`` — rows past ``end`` start
  after the probe ends, so they cannot overlap;
* ``start = searchsorted(run_max_hi, qlo, 'left')`` — ``run_max_hi`` is
  non-decreasing, and every row before ``start`` has ``hi < qlo`` (its prefix
  maximum is below ``qlo``), so none of them can overlap either.

Everything in ``order[start:end]`` is a candidate; the exact conjunction over
*all* attributes is then verified on the (small) candidate set only.  Per
query row we probe every attribute, take the window sizes as a selectivity
estimate, and enumerate only the most selective attribute's window — a
one-attribute cost model that needs no statistics beyond the index itself.

The index is pure numpy, serializable (only the sort permutations are stored;
the gathered/sorted copies are rebuilt in O(n) on attach), and is cached on
:class:`~repro_torch.core.table.CompressedTable` / persisted by the catalog.
"""

from __future__ import annotations

import io
import json

import numpy as np

from repro_torch.obs import trace as obs_trace

__all__ = ["IntervalIndex", "interval_stats", "ragged_ranges"]

_IDX_MAGIC = b"PRVCIDX1\n"


def ragged_ranges(
    starts: np.ndarray, ends: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Enumerate ``[starts[i], ends[i])`` for every i, fully vectorized.

    Returns ``(owner, pos)`` where ``pos`` concatenates the ranges and
    ``owner[k]`` is the ``i`` that range element ``pos[k]`` came from.
    """
    counts = np.maximum(ends - starts, 0).astype(np.int64)
    total = int(counts.sum())
    if total == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    owner = np.repeat(np.arange(counts.size, dtype=np.int64), counts)
    base = np.cumsum(counts) - counts  # offset of each range in the output
    pos = np.arange(total, dtype=np.int64) - base[owner] + starts.astype(np.int64)[owner]
    return owner, pos


def interval_stats(
    lo: np.ndarray, hi: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Per-attribute ``(mean interval length, covered span)`` of a column set.

    The planner's cost model turns these two numbers into an overlap
    probability per attribute (``(Lq + Lr) / span``, clamped to 1): the
    chance that a random query interval of mean length ``Lq`` meets a random
    stored interval of mean length ``Lr`` inside the covered span.  Exact
    per-frontier estimates come from :meth:`IntervalIndex.estimate_candidates`;
    these closed-form stats are for hops whose frontier does not exist yet at
    planning time.
    """
    lo = np.asarray(lo, np.int64)
    hi = np.asarray(hi, np.int64)
    if lo.ndim != 2 or lo.shape != hi.shape:
        raise ValueError(f"bad interval columns: {lo.shape} vs {hi.shape}")
    if lo.shape[0] == 0:
        n_attrs = lo.shape[1]
        return np.ones(n_attrs), np.ones(n_attrs)
    mean_len = (hi - lo + 1).mean(axis=0)
    span = np.maximum(hi.max(axis=0) - lo.min(axis=0) + 1, 1)
    return mean_len.astype(float), span.astype(float)


class IntervalIndex:
    """Per-attribute sorted interval index over ``[lo, hi]`` columns.

    Parameters
    ----------
    lo, hi : ``[n_rows, n_attrs]`` int64 closed interval bounds.
    order  : optional precomputed ``[n_attrs, n_rows]`` sort permutations
             (used when attaching a persisted index; skips the O(n log n)
             argsorts and only pays the O(n) gathers).
    """

    def __init__(
        self, lo: np.ndarray, hi: np.ndarray, order: np.ndarray | None = None
    ):
        lo = np.asarray(lo, np.int64)
        hi = np.asarray(hi, np.int64)
        if lo.ndim != 2 or lo.shape != hi.shape:
            raise ValueError(f"bad interval columns: {lo.shape} vs {hi.shape}")
        self.lo, self.hi = lo, hi
        self.n_rows, self.n_attrs = lo.shape
        supplied = order is not None
        if order is None:
            order = np.stack(
                [np.argsort(lo[:, j], kind="stable") for j in range(self.n_attrs)]
            ) if self.n_attrs else np.zeros((0, self.n_rows), np.int64)
        self.order = np.asarray(order, np.int64).reshape(self.n_attrs, self.n_rows)
        if supplied:
            self._validate_order()
        # gathered copies in sort order + prefix running max of hi
        self.sorted_lo = [lo[self.order[j], j] for j in range(self.n_attrs)]
        self.run_max_hi = [
            np.maximum.accumulate(hi[self.order[j], j]) for j in range(self.n_attrs)
        ]

    def _validate_order(self) -> None:
        """Reject a supplied permutation that does not fit these bounds.

        A persisted sidecar can be stale (written for a previous version of
        the table) or corrupt; attaching it unchecked would silently drop
        overlap candidates.  Raising ``ValueError`` here triggers the
        caller's lazy-rebuild fallback instead.
        """
        o = self.order
        if o.size and ((o < 0).any() or (o >= self.n_rows).any()):
            raise ValueError("index permutation out of range for table")
        for j in range(self.n_attrs):
            if np.bincount(o[j], minlength=self.n_rows).max(initial=0) > 1:
                raise ValueError("index order is not a permutation")
            if (np.diff(self.lo[o[j], j]) < 0).any():
                raise ValueError("index order does not sort the table's lo bounds")

    # ------------------------------------------------------------------ #
    # probing
    # ------------------------------------------------------------------ #
    def probe_windows(
        self, q_lo: np.ndarray, q_hi: np.ndarray
    ) -> tuple[np.ndarray, np.ndarray]:
        """Candidate window ``[start, end)`` per (query row, attribute).

        Both are ``[nq, n_attrs]``; the window over ``order[j]`` is a superset
        of the rows whose attribute-``j`` interval overlaps the probe.
        """
        nq = q_lo.shape[0]
        starts = np.empty((nq, self.n_attrs), np.int64)
        ends = np.empty((nq, self.n_attrs), np.int64)
        for j in range(self.n_attrs):
            ends[:, j] = np.searchsorted(self.sorted_lo[j], q_hi[:, j], "right")
            starts[:, j] = np.searchsorted(self.run_max_hi[j], q_lo[:, j], "left")
        np.minimum(starts, ends, out=starts)
        return starts, ends

    def estimate_candidates(
        self,
        q_lo: np.ndarray,
        q_hi: np.ndarray,
        windows: tuple[np.ndarray, np.ndarray] | None = None,
    ) -> int:
        """Upper bound on candidate pairs if each row probes its best attr."""
        if q_lo.shape[0] == 0 or self.n_rows == 0:
            return 0
        if self.n_attrs == 0:
            return q_lo.shape[0] * self.n_rows
        starts, ends = windows if windows is not None else self.probe_windows(q_lo, q_hi)
        return int((ends - starts).min(axis=1).sum())

    @obs_trace.spanned("query.index", "query")
    def candidate_pairs(
        self,
        q_lo: np.ndarray,
        q_hi: np.ndarray,
        windows: tuple[np.ndarray, np.ndarray] | None = None,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Exact overlap pairs ``(qi, ri)`` (all attributes), lexsorted.

        Equivalent to ``np.nonzero`` of the dense overlap matrix, but the
        work is proportional to the most selective attribute's candidate
        window per query row, not ``nq × nr``.  Pass ``windows`` (from
        :meth:`probe_windows`) to reuse a probe pass already paid for.
        """
        nq = q_lo.shape[0]
        if nq == 0 or self.n_rows == 0:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        if self.n_attrs == 0:  # 0-d keys: every (q, r) pair matches
            qi = np.repeat(np.arange(nq, dtype=np.int64), self.n_rows)
            ri = np.tile(np.arange(self.n_rows, dtype=np.int64), nq)
            return qi, ri
        starts, ends = windows if windows is not None else self.probe_windows(q_lo, q_hi)
        best = np.argmin(ends - starts, axis=1)  # most selective attr per row
        qi_parts, ri_parts = [], []
        for j in range(self.n_attrs):
            rows = np.flatnonzero(best == j)
            if rows.size == 0:
                continue
            owner, pos = ragged_ranges(starts[rows, j], ends[rows, j])
            qi = rows[owner]
            ri = self.order[j][pos]
            ok = np.ones(qi.size, bool)
            for k in range(self.n_attrs):
                ok &= (q_lo[qi, k] <= self.hi[ri, k]) & (
                    self.lo[ri, k] <= q_hi[qi, k]
                )
            qi_parts.append(qi[ok])
            ri_parts.append(ri[ok])
        if not qi_parts:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        qi = np.concatenate(qi_parts)
        ri = np.concatenate(ri_parts)
        # match the dense path's np.nonzero ordering (row-major)
        perm = np.lexsort((ri, qi))
        return qi[perm], ri[perm]

    # ------------------------------------------------------------------ #
    # serialization (catalog sidecar files)
    # ------------------------------------------------------------------ #
    def to_bytes(self) -> bytes:
        """Persist only the permutations; bounds live with the table."""
        order = self.order
        packed = (
            order.astype(np.int32) if self.n_rows <= np.iinfo(np.int32).max else order
        )
        header = json.dumps(
            {
                "n_rows": self.n_rows,
                "n_attrs": self.n_attrs,
                "dtype": packed.dtype.str,
            }
        ).encode()
        buf = io.BytesIO()
        buf.write(_IDX_MAGIC)
        buf.write(len(header).to_bytes(4, "little"))
        buf.write(header)
        buf.write(np.ascontiguousarray(packed).tobytes())
        return buf.getvalue()

    @staticmethod
    def from_bytes(data: bytes, lo: np.ndarray, hi: np.ndarray) -> "IntervalIndex":
        """Attach a persisted index to its table's interval columns.

        Raises ``ValueError`` on magic/shape mismatch so callers can fall
        back to rebuilding from scratch.
        """
        if data[: len(_IDX_MAGIC)] != _IDX_MAGIC:
            raise ValueError("not a ProvRC index blob")
        off = len(_IDX_MAGIC)
        hlen = int.from_bytes(data[off : off + 4], "little")
        off += 4
        header = json.loads(data[off : off + hlen])
        off += hlen
        n_rows, n_attrs = header["n_rows"], header["n_attrs"]
        if (n_rows, n_attrs) != tuple(np.asarray(lo).shape):
            raise ValueError(
                f"index shape {(n_rows, n_attrs)} does not match table "
                f"{np.asarray(lo).shape}"
            )
        dt = np.dtype(header["dtype"])
        order = np.frombuffer(
            data, dtype=dt, count=n_rows * n_attrs, offset=off
        ).reshape(n_attrs, n_rows)
        return IntervalIndex(lo, hi, order=order.astype(np.int64))
