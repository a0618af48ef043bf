"""ProvRC — the paper's lossless lineage-compression algorithm (§IV).

Two passes over the relation:

* **Step 1 — multi-attribute range encoding over value attributes**: for each
  value attribute (last to first), merge runs of rows that agree on every
  other attribute and are contiguous on this one, replacing them with a
  single interval row.

* **Step 2 — relative value transformation + range encoding over key
  attributes**: value attributes may be re-expressed as deltas against the
  key attribute currently being merged (``val − key_j``), which turns
  element-wise / convolution / matmul-style lineage into constant columns and
  unlocks the same range encoding over the key side.

Two implementations are provided:

* ``method="paper"`` — the paper's sequential greedy scan (one global sort,
  per-run representation-subset tracking).  Exact transliteration; O(N·m)
  Python loop, used for small tables and as a fidelity reference.
* ``method="vector"`` — a fully vectorized formulation: per key attribute we
  run one all-absolute pass plus one single-attr-delta pass per value attr,
  each to fixpoint.  Each pass is a lexsort + boundary detection + segment
  reduce (host numpy, as in ``repro.core.provrc``).  This path is strictly
  stronger than the paper's greedy (the greedy's single sort order can hide
  delta-mergeable runs) and is the production default (``method="auto"``).

Both encoders maintain the *delta-uniqueness invariant* — at most one value
attribute per row may be relative to any given key attribute — which is
what makes the θ-join's independent de-relativization exact (see
``_rep_combos``).  Both are lossless (property-tested against
decompression) and in-situ-query-exact (tested against the
uncompressed-row oracle).
"""

from __future__ import annotations

import itertools

import numpy as np

from .intervals import coalesce_1d, lexsort_rows
from .relation import LineageRelation
from .table import CompressedTable

__all__ = ["compress", "compress_both", "CompressStats"]


class CompressStats(dict):
    """Small diagnostics bag: rows in/out, passes run."""


# --------------------------------------------------------------------------- #
# Entry points
# --------------------------------------------------------------------------- #
def compress(
    rel: LineageRelation,
    direction: str = "backward",
    method: str = "auto",
    exact_threshold: int = 4096,
    stats: CompressStats | None = None,
) -> CompressedTable:
    """Compress an uncompressed relation into a :class:`CompressedTable`."""
    rel = rel.canonical()
    if direction == "backward":
        keys, vals = rel.out_idx, rel.in_idx
        key_shape, val_shape = rel.out_shape, rel.in_shape
    elif direction == "forward":
        keys, vals = rel.in_idx, rel.out_idx
        key_shape, val_shape = rel.in_shape, rel.out_shape
    else:
        raise ValueError(direction)

    if method == "auto":
        # the vectorized formulation dominates the paper greedy in both
        # compression quality (multi-combo sort orders expose delta runs the
        # greedy's single sort hides — e.g. np.cross) and throughput, so it
        # is the production path at every size; "paper" remains available as
        # the fidelity reference.
        method = "vector"

    n, l = keys.shape
    m = vals.shape[1]
    key_lo, key_hi = keys.copy(), keys.copy()
    val_lo, val_hi = vals.copy(), vals.copy()
    val_ref = np.full((n, m), -1, np.int8)

    if stats is not None:
        stats["rows_in"] = n

    # ---- Step 1: range encoding over value attributes ------------------- #
    for i in range(m - 1, -1, -1):
        key_lo, key_hi, val_lo, val_hi, val_ref = _step1_pass(
            key_lo, key_hi, val_lo, val_hi, val_ref, i
        )

    # ---- Step 2: relative transform + range encoding over keys ---------- #
    if method == "paper":
        key_lo, key_hi, val_lo, val_hi, val_ref = _step2_paper(
            key_lo, key_hi, val_lo, val_hi, val_ref
        )
    elif method == "vector":
        key_lo, key_hi, val_lo, val_hi, val_ref = _step2_vector(
            key_lo, key_hi, val_lo, val_hi, val_ref
        )
    else:
        raise ValueError(method)

    if stats is not None:
        stats["rows_out"] = key_lo.shape[0]
        stats["method"] = method

    return CompressedTable(
        key_shape, val_shape, key_lo, key_hi, val_lo, val_hi, val_ref, direction
    )


def compress_both(
    rel: LineageRelation, method: str = "auto"
) -> tuple[CompressedTable, CompressedTable]:
    """Backward + forward materializations (paper §IV.C)."""
    return (
        compress(rel, "backward", method),
        compress(rel, "forward", method),
    )


# --------------------------------------------------------------------------- #
# Step 1
# --------------------------------------------------------------------------- #
def _step1_rows(key_lo, val_lo, val_hi, i):
    """The rows one step-1 pass merges, sorted: ``(order, cols, lo, hi)``,
    where ``cols`` are every other column (the group key) and ``lo``/``hi``
    value attribute ``i``, all in sorted order."""
    others = [key_lo[:, j] for j in range(key_lo.shape[1])]
    for k in range(val_lo.shape[1]):
        if k == i:
            continue
        others += [val_lo[:, k], val_hi[:, k]]
    order = lexsort_rows(others + [val_lo[:, i]])
    return order, [c[order] for c in others], val_lo[order, i], val_hi[order, i]


def _step1_pass(key_lo, key_hi, val_lo, val_hi, val_ref, i):
    """Range-encode value attribute ``i``; all other columns must match."""
    n = val_lo.shape[0]
    if n == 0:
        return key_lo, key_hi, val_lo, val_hi, val_ref
    order, cols, lo, hi = _step1_rows(key_lo, val_lo, val_hi, i)
    starts, lo, hi = coalesce_1d(_group_ids(cols, n), lo, hi)
    sel = order[starts]
    key_lo, key_hi = key_lo[sel], key_hi[sel]
    val_lo, val_hi, val_ref = val_lo[sel].copy(), val_hi[sel].copy(), val_ref[sel]
    val_lo[:, i], val_hi[:, i] = lo, hi
    return key_lo, key_hi, val_lo, val_hi, val_ref


def _group_ids(cols: list[np.ndarray], n: int | None = None) -> np.ndarray:
    """Dense group ids for rows *already sorted* by ``cols``."""
    if not cols:
        return np.zeros(0 if n is None else n, np.int64)
    n = cols[0].size
    if n == 0:
        return np.zeros(0, np.int64)
    change = np.zeros(n, dtype=bool)
    for c in cols:
        change[1:] |= c[1:] != c[:-1]
    return np.cumsum(change)


# --------------------------------------------------------------------------- #
# Step 2 — vectorized combo passes
# --------------------------------------------------------------------------- #
def _step2_vector(key_lo, key_hi, val_lo, val_hi, val_ref):
    l = key_lo.shape[1]
    m = val_lo.shape[1]
    for j in range(l - 1, -1, -1):
        for combo in _rep_combos(m):
            prev = -1
            # iterate this combo to fixpoint (merges can cascade)
            while key_lo.shape[0] != prev:
                prev = key_lo.shape[0]
                key_lo, key_hi, val_lo, val_hi, val_ref = _step2_pass(
                    key_lo, key_hi, val_lo, val_hi, val_ref, j, combo
                )
    return key_lo, key_hi, val_lo, val_hi, val_ref


def _rep_combos(m: int) -> list[tuple[bool, ...]]:
    """Representation combos: ``True`` ⇒ try delta for that value attr.

    INVARIANT (correctness of in-situ queries): at most one value attr may
    convert to a delta per merge pass, so no row ever carries two attrs
    relative to the same key attr.  Two same-key deltas encode a *line*
    (e.g. a diagonal run inside a sort permutation) that decompresses
    correctly but that the θ-join's independent de-relativization would
    over-approximate to its bounding box — the paper's Fig 5 reversal
    implicitly assumes this invariant, and our
    ``tests/test_query.py::test_diagonal_relation_not_overcounted`` pins it.
    """
    if m == 0:
        return [()]
    combos = [tuple([False] * m)]
    for i in range(m):
        c = [False] * m
        c[i] = True
        combos.append(tuple(c))
    return combos


def _step2_pass(key_lo, key_hi, val_lo, val_hi, val_ref, j, combo):
    """One merge pass on key attribute ``j`` under a fixed rep combo.

    ``combo[i] == True`` means value attr ``i`` is grouped by its delta
    against key ``j`` (only rows still absolute can convert); ``False`` means
    grouped by its stored (ref, lo, hi) triple.
    """
    n, l = key_lo.shape
    m = val_lo.shape[1]
    if n <= 1:
        return key_lo, key_hi, val_lo, val_hi, val_ref
    kj = key_lo[:, j]  # width-0 until merged in its own pass… may be interval
    kj_hi = key_hi[:, j]

    group_cols: list[np.ndarray] = []
    for k in range(l):
        if k == j:
            continue
        group_cols += [key_lo[:, k], key_hi[:, k]]
    # Only rows whose key-j interval is still width 0 may convert to a delta
    # rep: against an already-widened key the delta is not a single value.
    # A row may also never gain a SECOND attr relative to this key (the
    # ≤1-delta-per-key invariant; see _rep_combos).
    narrow_key = kj == kj_hi
    already_ref_j = (val_ref == j).any(axis=1)
    use_delta = np.zeros((n, m), dtype=bool)
    for i in range(m):
        if combo[i]:
            can = (val_ref[:, i] == -1) & narrow_key & ~already_ref_j
            use_delta[:, i] = can
            # marker separates delta-grouped rows from triple-grouped ones
            marker = np.where(can, l, val_ref[:, i]).astype(np.int64)
            glo = np.where(can, val_lo[:, i] - kj, val_lo[:, i])
            ghi = np.where(can, val_hi[:, i] - kj, val_hi[:, i])
        else:
            marker = val_ref[:, i].astype(np.int64)
            glo, ghi = val_lo[:, i], val_hi[:, i]
        group_cols += [marker, glo, ghi]

    order = lexsort_rows(group_cols + [kj])
    group = _group_ids([c[order] for c in group_cols], n)
    starts, lo, hi = coalesce_1d(group, kj[order], kj_hi[order])
    if starts.size == n:  # nothing merged
        return key_lo, key_hi, val_lo, val_hi, val_ref

    sel = order[starts]
    seg_len = np.diff(np.append(starts, n))
    merged = seg_len > 1

    new_key_lo, new_key_hi = key_lo[sel].copy(), key_hi[sel].copy()
    new_key_lo[:, j], new_key_hi[:, j] = lo, hi
    new_val_lo, new_val_hi = val_lo[sel].copy(), val_hi[sel].copy()
    new_val_ref = val_ref[sel].copy()
    # Rows that actually merged under a delta rep must store the delta.
    for i in range(m):
        if not combo[i]:
            continue
        conv = merged & use_delta[order, i][starts]
        if not conv.any():
            continue
        base = kj[sel]
        new_val_lo[conv, i] = val_lo[sel][conv, i] - base[conv]
        new_val_hi[conv, i] = val_hi[sel][conv, i] - base[conv]
        new_val_ref[conv, i] = j
    return new_key_lo, new_key_hi, new_val_lo, new_val_hi, new_val_ref


# --------------------------------------------------------------------------- #
# Step 2 — the paper's sequential greedy (fidelity reference)
# --------------------------------------------------------------------------- #
def _step2_paper(key_lo, key_hi, val_lo, val_hi, val_ref):
    l = key_lo.shape[1]
    for j in range(l - 1, -1, -1):
        key_lo, key_hi, val_lo, val_hi, val_ref = _step2_paper_attr(
            key_lo, key_hi, val_lo, val_hi, val_ref, j
        )
    return key_lo, key_hi, val_lo, val_hi, val_ref


def _step2_paper_attr(key_lo, key_hi, val_lo, val_hi, val_ref, j):
    n, l = key_lo.shape
    m = val_lo.shape[1]
    if n <= 1:
        return key_lo, key_hi, val_lo, val_hi, val_ref
    sort_cols = []
    for k in range(l):
        if k != j:
            sort_cols += [key_lo[:, k], key_hi[:, k]]
    sort_cols.append(key_lo[:, j])
    order = lexsort_rows(sort_cols)
    kl, kh = key_lo[order], key_hi[order]
    vl, vh, vr = val_lo[order], val_hi[order], val_ref[order]

    out_rows: list[tuple] = []
    run_start = 0

    def flush(s: int, e: int, cand_sets) -> None:
        """Emit run [s, e) as one row."""
        row_kl, row_kh = kl[s].copy(), kh[s].copy()
        row_kh[j] = kh[e - 1][j]
        row_vl, row_vh, row_vr = vl[s].copy(), vh[s].copy(), vr[s].copy()
        if e - s > 1:
            for i in range(m):
                if "abs" in cand_sets[i]:
                    continue  # absolute representation preserved
                # delta rep against key j
                row_vl[i] = vl[s][i] - kl[s][j]
                row_vh[i] = vh[s][i] - kl[s][j]
                row_vr[i] = j
        out_rows.append((row_kl, row_kh, row_vl, row_vh, row_vr))

    cand = _init_cand_sets(vr[0], m)
    for t in range(1, n):
        same_others = all(
            kl[t][k] == kl[t - 1][k] and kh[t][k] == kh[t - 1][k]
            for k in range(l)
            if k != j
        )
        contiguous = kl[t][j] == kh[t - 1][j] + 1
        new_cand = None
        if same_others and contiguous:
            new_cand = []
            ok = True
            for i in range(m):
                s = set()
                if "abs" in cand[i] and (
                    vr[t][i] == vr[t - 1][i]
                    and vl[t][i] == vl[t - 1][i]
                    and vh[t][i] == vh[t - 1][i]
                ):
                    s.add("abs")
                if (
                    "delta" in cand[i]
                    and vr[t][i] == -1
                    and vr[t - 1][i] == -1
                    and vl[t][i] - kl[t][j] == vl[run_start][i] - kl[run_start][j]
                    and vh[t][i] - kl[t][j] == vh[run_start][i] - kl[run_start][j]
                ):
                    s.add("delta")
                if not s:
                    ok = False
                    break
                new_cand.append(s)
            if ok:
                # ≤1-delta-per-key invariant (see _rep_combos): a run that
                # would force two same-key delta conversions must flush
                delta_only = sum(1 for s in new_cand if s == {"delta"})
                if delta_only > 1:
                    ok = False
            if not ok:
                new_cand = None
        if new_cand is None:
            flush(run_start, t, cand)
            run_start = t
            cand = _init_cand_sets(vr[t], m)
        else:
            cand = new_cand
    flush(run_start, n, cand)

    kl2 = np.stack([r[0] for r in out_rows])
    kh2 = np.stack([r[1] for r in out_rows])
    vl2 = np.stack([r[2] for r in out_rows]) if m else np.zeros((len(out_rows), 0), np.int64)
    vh2 = np.stack([r[3] for r in out_rows]) if m else np.zeros((len(out_rows), 0), np.int64)
    vr2 = (
        np.stack([r[4] for r in out_rows]).astype(np.int8)
        if m
        else np.zeros((len(out_rows), 0), np.int8)
    )
    return kl2, kh2, vl2, vh2, vr2


def _init_cand_sets(ref_row: np.ndarray, m: int) -> list[set]:
    return [
        {"abs", "delta"} if ref_row[i] == -1 else {"abs"} for i in range(m)
    ]
