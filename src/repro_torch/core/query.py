"""In-situ query processing over compressed lineage tables (paper §V).

The port of ``repro.core.query``: the same host engine (numpy), with the
dense range join handed to the hand-written CUDA kernels of
:mod:`repro_torch.kernels` on the device the caller names.

Queries never decompress.  A query is a :class:`QueryBox` — a union of
multidimensional closed intervals over one array's axes — and each hop of a
lineage path is a θ-join against a compressed table:

1. **Range join** (§V.B.1): keep (query row, table row) pairs whose key
   intervals overlap on *every* key attribute; the result keys are the
   intersections (the all-to-all insight makes this lossless for the queried
   cells).
2. **De-relativize** (§V.B.2): convert relative value attributes back to
   absolute intervals.  With our ``delta = val − key`` convention,
   ``rel_back`` is interval addition:  ``[ilo + dlo, ihi + dhi]`` where
   ``[ilo, ihi]`` is the key intersection — exact because the union of
   ``k + [dlo, dhi]`` over a contiguous ``k`` interval is itself contiguous.

Between hops the planner applies the paper's two optimizations (§V.B.3):
projection onto the next hop's attributes and adjacent-interval row merging
(``merge=False`` reproduces the DSLog-NoMerge ablation).

``theta_join_inverse`` additionally answers a query against a table
materialized in the *opposite* direction (the paper's ``rel_for``), so a
deployment that stores only backward tables can still serve forward queries.

Join execution (``path`` parameter, default ``"auto"``)
-------------------------------------------------------
* ``"index"`` — sorted candidate pruning via the per-table
  :class:`~repro_torch.core.index.IntervalIndex` (lazily built, cached on the
  table, persisted by the catalog).  Work is proportional to the most
  selective attribute's candidate window, not ``nq × nr``.
* ``"dense"`` — the all-pairs overlap matrix, evaluated in blocks (numpy),
  or on the GPU by the CUDA ``range_join_mask`` kernel.  Right for small
  tables and unselective queries, where index probes buy nothing.
* ``"auto"`` — dense for tables under ``INDEX_MIN_ROWS`` rows; otherwise
  probe the index for a candidate estimate and fall back to dense when the
  estimated candidate fraction exceeds ``DENSE_FRACTION`` (the probe work
  is two binary searches per query row per attribute — negligible).

``theta_join_batch`` answers many :class:`QueryBox`es against one table in a
single pass: the union of all query rows is deduplicated, each distinct box
probes the index exactly once, and the per-pair outputs are scattered back to
their owning queries.

Device rule: every function that can reach a kernel takes ``device``
(default ``"cuda"``, which raises when CUDA is not available).  On
``"cuda"`` a dense join the kernel can express runs on it; ``"cpu"`` maps
to the reference's interpret mode — the per-hop path stays on blocked
numpy, and the batched executor runs its numpy twin, or, with
``engine="kernel"``, the kernels' plain PyTorch versions.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Sequence

import numpy as np

from repro_torch.kernels import ops
from repro_torch.kernels.autotune import (
    DEFAULT_GEOMETRY,
    DEFAULT_TWIN_CELLS,
    GeometryTuner,
    shape_bucket,
)
from repro_torch.kernels.range_join import fits_lanes
from repro_torch.obs import trace as obs_trace

from .index import IntervalIndex, ragged_ranges
from .intervals import coalesce_1d, lexsort_rows, segment_all
from .provrc import _group_ids
from .table import CompressedTable

__all__ = [
    "QueryBox",
    "JoinRequest",
    "BatchedJoinExecutor",
    "theta_join",
    "theta_join_inverse",
    "theta_join_batch",
    "theta_join_inverse_batch",
    "query_path",
    "merge_boxes",
    "canonical_boxes",
    "dense_backend",
    "INDEX_MIN_ROWS",
    "DENSE_FRACTION",
]

# Routing thresholds for path="auto"; the cost-based planner
# (core/planner.py) shares them when picking a route per hop.
INDEX_MIN_ROWS = 1024
DENSE_FRACTION = 0.25
# Per-hop dense joins this big go to the CUDA kernel (on device="cuda"):
# below it the launch and transfers cost more than blocked numpy.
_KERNEL_MIN_PAIRS = 1 << 20

# The batched executor's index-to-kernel rule on a CUDA device
# (index_to_kernel), in seconds: the host index's cost per probed
# candidate (IntervalIndex.candidate_pairs), against a packed
# range_join_mask launch's fixed cost, its cost per query row (pack and
# upload), per mask cell (kernel and nonzero scan) and per pair (copy back
# and split).  Least-squares fits of chip_route_costs.py on an NVIDIA H100
# 80GB HBM3 at 700 W and its host, over 33 joins of 1-10,000 boxes against
# 10,000-160,000-row tables, each timed after 64 MB of host writes
# (PERF.md §6).
INDEX_S_PER_CANDIDATE = 5.1e-8
KERNEL_S_PER_LAUNCH = 1.0e-3
KERNEL_S_PER_QUERY_ROW = 3.1e-7
KERNEL_S_PER_CELL = 3.5e-12
KERNEL_S_PER_PAIR = 6.7e-9
# The rerouted masks of one frontier take at most this share of the
# device's free memory (_device_free_bytes, read when the frontier's first
# join is rerouted); a join past it keeps the index.  The rest is left to
# the pairs' nonzero scan and the query packs.
KERNEL_MASK_MEMORY_SHARE = 0.5


@dataclass
class QueryBox:
    """Union of boxes over one array's axes: ``lo/hi`` are ``[N, ndim]``."""

    shape: tuple[int, ...]
    lo: np.ndarray = field(repr=False)
    hi: np.ndarray = field(repr=False)

    def __post_init__(self) -> None:
        nd = len(self.shape)
        self.lo = np.asarray(self.lo, np.int64).reshape(-1, nd)
        self.hi = np.asarray(self.hi, np.int64).reshape(-1, nd)

    # ------------------------------------------------------------------ #
    @property
    def n_rows(self) -> int:
        return int(self.lo.shape[0])

    @staticmethod
    def from_cells(shape: tuple[int, ...], cells: np.ndarray) -> "QueryBox":
        cells = np.asarray(cells, np.int64).reshape(-1, len(shape))
        return QueryBox(shape, cells.copy(), cells.copy())

    @staticmethod
    def from_range(
        shape: tuple[int, ...], lo: tuple[int, ...], hi: tuple[int, ...]
    ) -> "QueryBox":
        return QueryBox(shape, np.array([lo]), np.array([hi]))

    @staticmethod
    def full(shape: tuple[int, ...]) -> "QueryBox":
        nd = len(shape)
        return QueryBox(
            shape,
            np.zeros((1, nd), np.int64),
            np.array([[d - 1 for d in shape]], np.int64),
        )

    def cells(self) -> np.ndarray:
        """Expand to explicit cell indices (testing only)."""
        out = []
        for r in range(self.n_rows):
            ranges = [
                np.arange(self.lo[r, d], self.hi[r, d] + 1)
                for d in range(len(self.shape))
            ]
            grid = np.meshgrid(*ranges, indexing="ij") if ranges else []
            out.append(
                np.stack([g.ravel() for g in grid], axis=1)
                if grid
                else np.zeros((1, 0), np.int64)
            )
        if not out:
            return np.zeros((0, len(self.shape)), np.int64)
        return np.unique(np.concatenate(out, axis=0), axis=0)

    def cell_set(self) -> set[tuple[int, ...]]:
        return {tuple(int(v) for v in c) for c in self.cells()}

    def n_cells(self) -> int:
        """Number of distinct cells covered (exact despite overlaps)."""
        return int(self.cells().shape[0]) if self.n_rows else 0

    def volume_upper(self) -> int:
        """Sum of box volumes (upper bound; fast, no expansion)."""
        if not self.n_rows:
            return 0
        return int(np.prod(self.hi - self.lo + 1, axis=1).sum())


# --------------------------------------------------------------------------- #
# Range-join pair enumeration (indexed / dense routing)
# --------------------------------------------------------------------------- #
def _dense_pairs(
    q_lo: np.ndarray,
    q_hi: np.ndarray,
    r_lo: np.ndarray,
    r_hi: np.ndarray,
) -> tuple[np.ndarray, np.ndarray]:
    """All-pairs overlap join in numpy, blocked to bound the pair matrix."""
    nq, l = q_lo.shape
    nr = r_lo.shape[0]
    qi_list, ri_list = [], []
    block = max(1, int(4_000_000 // max(nr, 1)))
    for s in range(0, nq, block):
        e = min(nq, s + block)
        ov = np.ones((e - s, nr), dtype=bool)
        for j in range(l):
            ov &= (q_lo[s:e, j : j + 1] <= r_hi[None, :, j]) & (
                r_lo[None, :, j] <= q_hi[s:e, j : j + 1]
            )
        qi, ri = np.nonzero(ov)
        qi_list.append(qi + s)
        ri_list.append(ri)
    qi = np.concatenate(qi_list) if qi_list else np.zeros(0, np.int64)
    ri = np.concatenate(ri_list) if ri_list else np.zeros(0, np.int64)
    return qi, ri


def _kernel_pairs(q_lo, q_hi, r_lo, r_hi, device):
    """CUDA ``range_join_mask`` dense route — only on a CUDA device.

    Returns ``None`` when the join is not the kernel's to run (``device``
    is the CPU, as the reference's interpret mode; too many attributes for
    one tile; coordinates outside the int32 pack range — they would
    silently wrap), so the caller takes blocked numpy.  Kernel build and
    launch failures propagate — silently degrading to numpy would hide
    them.
    """
    if device.type != "cuda" or not fits_lanes(q_lo.shape[1]):
        return None
    if not ops.fits_int32(q_lo, q_hi, r_lo, r_hi):
        return None
    return ops.range_join_pairs(q_lo, q_hi, r_lo, r_hi, device=device)


def dense_backend(
    n_attrs: int,
    int32_ok: bool = True,
    segmented: bool = True,
    device="cuda",
) -> str:
    """Which engine a dense join of ``n_attrs`` attributes would run on.

    ``"cuda"`` when the CUDA kernel applies (the reference's ``"tpu"``),
    else a ``"np:*"`` reason (``np:cpu`` on the CPU device, ``np:wide``
    lane capacity — for ``segmented`` joins the batched pack's segment lane
    counts too, ``np:i64`` int32 overflow).  Rendered into
    ``plan.describe()`` so dense-route fallbacks are visible instead of
    silent.
    """
    if not fits_lanes(n_attrs, segmented):
        return "np:wide"
    if not int32_ok:
        return "np:i64"
    if ops.resolve_device(device).type == "cpu":
        return "np:cpu"
    return "cuda"


def _route_decision(
    q_lo: np.ndarray,
    q_hi: np.ndarray,
    r_lo: np.ndarray,
    r_hi: np.ndarray,
    index_get,
    path: str,
):
    """Shared indexed-vs-dense routing: ``("dense", None)`` or
    ``("index", windows)``.

    ``path="batched"`` is the planner's batched-dense route: the same dense
    decision, executed through the packed :class:`BatchedJoinExecutor`
    engine when one is driving the joins.  ``index_get`` is a zero-arg
    callable returning the (cached) :class:`IntervalIndex` — deferred so
    the dense route never builds one.
    """
    if path not in ("auto", "index", "dense", "batched"):
        raise ValueError(f"unknown join path {path!r}")
    nq, nr = q_lo.shape[0], r_lo.shape[0]
    if path in ("dense", "batched"):
        return "dense", None
    if path == "auto" and nr < INDEX_MIN_ROWS:
        return "dense", None
    with obs_trace.span("query.index", "query"):
        index: IntervalIndex = index_get()
        windows = None
        if path == "auto" and index.n_attrs:
            windows = index.probe_windows(q_lo, q_hi)  # one probe pass, reused below
            est = index.estimate_candidates(q_lo, q_hi, windows)
            if est > DENSE_FRACTION * nq * nr:
                return "dense", None
    return "index", windows


def index_to_kernel(
    candidates: int, nq: int, nr: int, windows: tuple[np.ndarray, np.ndarray]
) -> bool:
    """Whether an index-routed join costs the host's
    :meth:`IntervalIndex.candidate_pairs` more than the same join costs as
    a segment of a packed ``range_join_mask`` launch on a CUDA device.

    ``candidates`` is the exact count the index would scan
    (:meth:`IntervalIndex.estimate_candidates`) over its probed
    ``windows``, ``nq`` × ``nr`` the mask.  A join whose candidates cost
    less than the launch alone stays, before the pairs are estimated
    (:func:`_pairs_estimate`): most joins stop there.
    """
    host = INDEX_S_PER_CANDIDATE * candidates
    if host <= KERNEL_S_PER_LAUNCH:
        return False
    card = (
        KERNEL_S_PER_LAUNCH
        + KERNEL_S_PER_QUERY_ROW * nq
        + KERNEL_S_PER_CELL * nq * nr
        + KERNEL_S_PER_PAIR * _pairs_estimate(windows, nr)
    )
    return card < host


def _pairs_estimate(windows: tuple[np.ndarray, np.ndarray], nr: int) -> float:
    """Expected overlap pairs from the index's candidate windows: each
    attribute keeps ``window / nr`` of the rows, independently of the
    others (at most the smallest window a row)."""
    starts, ends = windows
    return float((nr * np.prod((ends - starts) / nr, axis=1)).sum())


def _mask_bytes(nq: int, nr: int) -> int:
    """Device bytes a kernel segment's mask may take: its rows padded to
    the launch's blocks (the block-diagonal layout's tiles; a dense mask of
    the same segments is never larger)."""
    bq, br = DEFAULT_GEOMETRY
    return -(-nq // bq) * bq * (-(-nr // br) * br)


def _device_free_bytes(device) -> int:
    """The driver's free memory on ``device``.  It leaves out the blocks
    the caching allocator holds unused, so it is a lower bound of what a
    launch can take; it costs one driver call (57 µs on an H100, where the
    allocator's own statistics cost 114-280 µs)."""
    import torch

    return int(torch.cuda.mem_get_info(device)[0])


def _no_stats(key: str, n: int = 1) -> None:
    pass


def _route_pairs(
    q_lo: np.ndarray,
    q_hi: np.ndarray,
    r_lo: np.ndarray,
    r_hi: np.ndarray,
    index_get,
    path: str,
    device,
    stats=None,
) -> tuple[np.ndarray, np.ndarray]:
    """Pick indexed vs dense execution for one range join.

    ``stats`` (an ``io_stats`` bump callable) counts the join under the
    route it took: ``joins_index``, ``joins_dense_kernel`` (one
    ``range_join_mask`` launch) or ``joins_dense_twin`` (blocked numpy).
    """
    nq, nr = q_lo.shape[0], r_lo.shape[0]
    if nq == 0 or nr == 0:
        if path not in ("auto", "index", "dense", "batched"):
            raise ValueError(f"unknown join path {path!r}")
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    stats = stats if stats is not None else _no_stats
    route, windows = _route_decision(q_lo, q_hi, r_lo, r_hi, index_get, path)
    if route == "index":
        stats("joins_index")
        return index_get().candidate_pairs(q_lo, q_hi, windows)
    if nq * nr >= _KERNEL_MIN_PAIRS:
        pairs = _kernel_pairs(q_lo, q_hi, r_lo, r_hi, device)
        if pairs is not None:
            stats("joins_dense_kernel")
            return pairs
    stats("joins_dense_twin")
    return _dense_pairs(q_lo, q_hi, r_lo, r_hi)


def _derelativize(
    table: CompressedTable,
    qi: np.ndarray,
    ri: np.ndarray,
    inter_lo: np.ndarray,
    inter_hi: np.ndarray,
) -> tuple[np.ndarray, np.ndarray]:
    """Step 2 of the θ-join (§V.B.2) over an explicit pair list."""
    out_lo = table.val_lo[ri].copy()  # [P, m]
    out_hi = table.val_hi[ri].copy()
    ref = table.val_ref[ri]
    for j in range(table.n_key):
        sel = ref == j  # [P, m] mask of attrs relative to key j
        if sel.any():
            out_lo[sel] += np.broadcast_to(inter_lo[:, j : j + 1], sel.shape)[sel]
            out_hi[sel] += np.broadcast_to(inter_hi[:, j : j + 1], sel.shape)[sel]
    return out_lo, out_hi


# --------------------------------------------------------------------------- #
# θ-join
# --------------------------------------------------------------------------- #
def theta_join(
    q: QueryBox,
    table: CompressedTable,
    merge: bool = True,
    max_rows: int | None = None,
    path: str = "auto",
    device="cuda",
) -> QueryBox:
    """One hop: query over the table's *key* side, returning value-side boxes."""
    device = ops.resolve_device(device)
    if q.shape != table.key_shape:
        raise ValueError(
            f"query shape {q.shape} does not match table key shape {table.key_shape}"
        )
    if table.is_symbolic:
        raise ValueError("instantiate symbolic table before querying")
    m = table.n_val
    nq, nr = q.n_rows, table.n_rows
    if nq == 0 or nr == 0:
        return QueryBox(table.val_shape, np.zeros((0, m)), np.zeros((0, m)))

    # ---- Step 1: range join --------------------------------------------- #
    qi, ri = _route_pairs(
        q.lo, q.hi, table.key_lo, table.key_hi, table.key_index, path, device
    )
    if max_rows is not None and qi.size > max_rows:
        raise RuntimeError(f"θ-join intermediate exceeded max_rows={max_rows}")
    if qi.size == 0:
        return QueryBox(table.val_shape, np.zeros((0, m)), np.zeros((0, m)))

    inter_lo = np.maximum(q.lo[qi], table.key_lo[ri])  # [P, l]
    inter_hi = np.minimum(q.hi[qi], table.key_hi[ri])

    # ---- Step 2: de-relativize ------------------------------------------ #
    out_lo, out_hi = _derelativize(table, qi, ri, inter_lo, inter_hi)
    res = QueryBox(table.val_shape, out_lo, out_hi)
    return merge_boxes(res) if merge else res


def _inverse_key_boxes(
    q: QueryBox, table: CompressedTable, qi: np.ndarray, ri: np.ndarray
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-pair key intervals for the inverse join, plus the validity mask.

    The per-attribute overlap that produced the candidate pairs is necessary
    but not sufficient: two value attrs referencing the *same* key attribute
    constrain it jointly, so the intersection must be re-checked per pair.
    """
    l, m = table.n_key, table.n_val
    key_lo = table.key_lo[ri].astype(np.int64)  # [P, l]
    key_hi = table.key_hi[ri].astype(np.int64)
    for i in range(m):
        refs = table.val_ref[ri, i]  # [P]
        for j in range(l):
            jm = refs == j
            if not jm.any():
                continue
            cand_lo = q.lo[qi[jm], i] - table.val_hi[ri[jm], i]
            cand_hi = q.hi[qi[jm], i] - table.val_lo[ri[jm], i]
            key_lo[jm, j] = np.maximum(key_lo[jm, j], cand_lo)
            key_hi[jm, j] = np.minimum(key_hi[jm, j], cand_hi)
    valid = np.all(key_lo <= key_hi, axis=1)
    return key_lo, key_hi, valid


def theta_join_inverse(
    q: QueryBox,
    table: CompressedTable,
    merge: bool = True,
    path: str = "auto",
    device="cuda",
) -> QueryBox:
    """Query over the table's *value* side, returning key-side boxes.

    This is the paper's ``rel_for`` path: for a value attr relative to key
    ``j`` the constraint ``val = key_j + δ, δ ∈ [dlo, dhi]`` inverts to
    ``key_j ∈ [q_lo − dhi, q_hi − dlo]``, clamped by the stored key interval
    (the ``r.x`` term in the paper's formula).

    Candidate pruning runs over the table's *achievable value bounds*
    (``[key_lo_j + dlo, key_hi_j + dhi]`` for relative attrs, the stored
    interval for absolute ones): a row can contribute iff the query box
    overlaps those bounds on every value attribute, which is exactly the
    range-join predicate — so the same index machinery applies.
    """
    device = ops.resolve_device(device)
    if q.shape != table.val_shape:
        raise ValueError(
            f"query shape {q.shape} does not match table val shape {table.val_shape}"
        )
    if table.is_symbolic:
        raise ValueError("instantiate symbolic table before querying")
    l = table.n_key
    nq, nr = q.n_rows, table.n_rows
    if nq == 0 or nr == 0:
        return QueryBox(table.key_shape, np.zeros((0, l)), np.zeros((0, l)))

    vb_lo, vb_hi = table.value_bounds()
    qi, ri = _route_pairs(
        q.lo, q.hi, vb_lo, vb_hi, table.val_index, path, device
    )
    if qi.size == 0:
        return QueryBox(table.key_shape, np.zeros((0, l)), np.zeros((0, l)))
    key_lo, key_hi, valid = _inverse_key_boxes(q, table, qi, ri)
    res = QueryBox(table.key_shape, key_lo[valid], key_hi[valid])
    return merge_boxes(res) if merge else res


# --------------------------------------------------------------------------- #
# Batched multi-query θ-join
# --------------------------------------------------------------------------- #
def _unique_rows(
    a: np.ndarray, return_inverse: bool = False
) -> "np.ndarray | tuple[np.ndarray, np.ndarray]":
    """``np.unique(a, axis=0[, return_inverse])`` for 2-D integer arrays.

    Bit-identical output (same lexicographic row order, same inverse), but
    via ``lexsort`` over the integer columns — ``np.unique(axis=0)`` pays
    ~4x more for its void-dtype view sort, and these row dedups run on
    every hop of every query.
    """
    n = a.shape[0]
    if n == 0:
        return (a, np.zeros(0, np.int64)) if return_inverse else a
    order = np.lexsort(a.T[::-1])  # first column most significant
    s = a[order]
    flag = np.empty(n, bool)
    flag[0] = True
    np.any(s[1:] != s[:-1], axis=1, out=flag[1:])
    uniq = s[flag]
    if not return_inverse:
        return uniq
    inv = np.empty(n, np.int64)
    inv[order] = np.cumsum(flag) - 1
    return uniq, inv


def _pool_boxes(
    queries: Sequence[QueryBox],
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Dedup the union of all query rows: ``(u_lo, u_hi, inv)`` where ``inv``
    maps each original row (queries concatenated) to its distinct box."""
    all_lo = np.concatenate([q.lo for q in queries], axis=0)
    all_hi = np.concatenate([q.hi for q in queries], axis=0)
    uniq, inv = _unique_rows(
        np.concatenate([all_lo, all_hi], axis=1), return_inverse=True
    )
    nd = all_lo.shape[1]
    return uniq[:, :nd], uniq[:, nd:], inv


def _scatter_to_owners(
    queries: Sequence[QueryBox],
    inv: np.ndarray,
    ui: np.ndarray,
    n_uniq: int,
    out_lo: np.ndarray,
    out_hi: np.ndarray,
    shape: tuple[int, ...],
    merge: bool,
) -> list[QueryBox]:
    """Group per-pair outputs by distinct query row, scatter to owners."""
    perm = np.argsort(ui, kind="stable")
    pair_counts = np.bincount(ui, minlength=n_uniq).astype(np.int64)
    pair_offsets = np.cumsum(pair_counts) - pair_counts
    results: list[QueryBox] = []
    row_off = 0
    for q in queries:
        ids = inv[row_off : row_off + q.n_rows]
        row_off += q.n_rows
        _, pos = ragged_ranges(pair_offsets[ids], pair_offsets[ids] + pair_counts[ids])
        sel = perm[pos]
        res = QueryBox(shape, out_lo[sel], out_hi[sel])
        results.append(merge_boxes(res) if merge else res)
    return results


@obs_trace.spanned("query.prepare", "query")
def _prepare_batch(
    queries: Sequence[QueryBox], table: CompressedTable, inverse: bool
):
    """Validate + pool one batched join; shared with the batched executor.

    Returns ``("done", results)`` for trivially-empty joins, else
    ``("join", u_lo, u_hi, inv, r_lo, r_hi, index_get)`` where the ``r``
    side is the table's key intervals (natural join) or its achievable
    value bounds (inverse join).
    """
    if table.is_symbolic:
        raise ValueError("instantiate symbolic table before querying")
    q_side = table.val_shape if inverse else table.key_shape
    side_name = "val" if inverse else "key"
    for q in queries:
        if q.shape != q_side:
            raise ValueError(
                f"query shape {q.shape} does not match table {side_name} "
                f"shape {q_side}"
            )
    n_out = table.n_key if inverse else table.n_val
    out_shape = table.key_shape if inverse else table.val_shape
    empty = lambda: QueryBox(
        out_shape, np.zeros((0, n_out)), np.zeros((0, n_out))
    )
    if not queries:
        return ("done", [])
    if sum(q.n_rows for q in queries) == 0 or table.n_rows == 0:
        return ("done", [empty() for _ in queries])
    u_lo, u_hi, inv = _pool_boxes(queries)
    if inverse:
        r_lo, r_hi = table.value_bounds()
        index_get = table.val_index
    else:
        r_lo, r_hi = table.key_lo, table.key_hi
        index_get = table.key_index
    return ("join", u_lo, u_hi, inv, r_lo, r_hi, index_get)


@obs_trace.spanned("query.finalize", "query")
def _finalize_batch(
    queries: Sequence[QueryBox],
    table: CompressedTable,
    inverse: bool,
    u_lo: np.ndarray,
    u_hi: np.ndarray,
    inv: np.ndarray,
    ui: np.ndarray,
    ri: np.ndarray,
    merge: bool,
) -> list[QueryBox]:
    """Steps 2+ of a batched join over an enumerated pair list."""
    if inverse:
        pooled = QueryBox(table.val_shape, u_lo, u_hi)
        key_lo, key_hi, valid = _inverse_key_boxes(pooled, table, ui, ri)
        return _scatter_to_owners(
            queries,
            inv,
            ui[valid],
            u_lo.shape[0],
            key_lo[valid],
            key_hi[valid],
            table.key_shape,
            merge,
        )
    inter_lo = np.maximum(u_lo[ui], table.key_lo[ri])
    inter_hi = np.minimum(u_hi[ui], table.key_hi[ri])
    out_lo, out_hi = _derelativize(table, ui, ri, inter_lo, inter_hi)
    return _scatter_to_owners(
        queries, inv, ui, u_lo.shape[0], out_lo, out_hi, table.val_shape, merge
    )


def theta_join_batch(
    queries: Sequence[QueryBox],
    table: CompressedTable,
    merge: bool = True,
    path: str = "auto",
    device="cuda",
    stats=None,
) -> list[QueryBox]:
    """Answer many queries against one table in a single pass.

    All query rows are pooled and deduplicated, so a box shared by several
    queries probes the index (or the dense matrix) exactly once; the pair
    outputs are computed once per *distinct* (box, table row) pair and then
    scattered back to the owning queries.  ``stats`` counts the join by
    route (:func:`_route_pairs`).
    """
    device = ops.resolve_device(device)
    pre = _prepare_batch(queries, table, inverse=False)
    if pre[0] == "done":
        return pre[1]
    _, u_lo, u_hi, inv, r_lo, r_hi, index_get = pre
    ui, ri = _route_pairs(u_lo, u_hi, r_lo, r_hi, index_get, path, device, stats)
    return _finalize_batch(queries, table, False, u_lo, u_hi, inv, ui, ri, merge)


def theta_join_inverse_batch(
    queries: Sequence[QueryBox],
    table: CompressedTable,
    merge: bool = True,
    path: str = "auto",
    device="cuda",
    stats=None,
) -> list[QueryBox]:
    """Batched :func:`theta_join_inverse`: many value-side queries, one pass.

    Same pooling/dedup/scatter machinery as :func:`theta_join_batch`, with
    the candidate pruning running over the table's achievable value bounds
    and the per-pair key-interval inversion (plus its joint-validity check)
    done once per *distinct* (box, row) pair.
    """
    device = ops.resolve_device(device)
    pre = _prepare_batch(queries, table, inverse=True)
    if pre[0] == "done":
        return pre[1]
    _, u_lo, u_hi, inv, r_lo, r_hi, index_get = pre
    ui, ri = _route_pairs(u_lo, u_hi, r_lo, r_hi, index_get, path, device, stats)
    return _finalize_batch(queries, table, True, u_lo, u_hi, inv, ui, ri, merge)


# --------------------------------------------------------------------------- #
# Batched accelerator execution of plan steps
# --------------------------------------------------------------------------- #
@dataclass
class JoinRequest:
    """One batched θ-join a plan step wants executed.

    ``path`` follows :func:`_route_decision` (``"batched"`` is the
    planner's batched-dense route).  Requests are what the planner hands a
    :class:`BatchedJoinExecutor` — one per (step, lineage entry) pair in a
    ready plan frontier.
    """

    queries: Sequence[QueryBox]
    table: CompressedTable
    inverse: bool = False
    merge: bool = True
    path: str = "auto"


# twin autotuning threshold: segments below it run the default mask-block
# budget — measuring candidates costs extra dispatches, which only amortize
# when the workload itself is big enough to show a budget's effect.  The
# kernel path is not tuned (see DEFAULT_GEOMETRY).
_TWIN_TUNE_MIN_CELLS = 1 << 22  # mask cells of the largest segment


def _twin_pairs(
    q_lo: np.ndarray,
    q_hi: np.ndarray,
    rl: np.ndarray,
    rh: np.ndarray,
    scratch: dict | None = None,
    block_cells: int = DEFAULT_TWIN_CELLS[0],
) -> tuple[np.ndarray, np.ndarray]:
    """Blocked dense overlap pairs over packed table columns.

    The GIL-releasing numpy twin of the segmented kernel: ``rl``/``rh`` are
    the table's cached contiguous ``[l, N]`` columns (int32 when safe —
    see :meth:`CompressedTable.dense_join_cols`), the query side is packed
    per call, and the conjunction is evaluated with reusable buffers
    (``scratch``, shared across one packed dispatch's segments) and
    in-place ufuncs.  Pair extraction runs on the raveled mask
    (``flatnonzero`` + divmod — numpy's 2-D nonzero pays an order of
    magnitude more on sparse masks).  All heavy work happens inside numpy
    inner loops, which drop the GIL — this is what lets thread-pool plan
    execution actually overlap on CPU.  Pair order is row-major, identical
    to :func:`_dense_pairs`.
    """
    nq, l = q_lo.shape
    nr = rl.shape[1]
    if rl.dtype == np.int32:
        i32 = np.iinfo(np.int32)
        small = (
            q_lo.min() >= i32.min and q_hi.max() <= i32.max
            if q_lo.size
            else True
        )
        qdt = np.int32 if small else np.int64
    else:
        qdt = np.int64
    qlt = np.ascontiguousarray(q_lo.T, dtype=qdt)  # [l, nq]
    qht = np.ascontiguousarray(q_hi.T, dtype=qdt)
    # block_cells is the twin's launch geometry (mask cells per row block);
    # the executor's GeometryTuner picks it per frontier-shape bucket
    block = max(1, int(block_cells // max(nr, 1)))
    rows = min(block, nq)
    if scratch is None:
        scratch = {}
    cells = rows * nr
    if scratch.get("n", 0) < cells:
        scratch["ov"] = np.empty(cells, np.bool_)
        scratch["tmp"] = np.empty(cells, np.bool_)
        scratch["n"] = cells
    qi_list, ri_list = [], []
    for s in range(0, nq, block):
        e = min(nq, s + block)
        o = scratch["ov"][: (e - s) * nr].reshape(e - s, nr)
        t = scratch["tmp"][: (e - s) * nr].reshape(e - s, nr)
        np.less_equal(qlt[0, s:e, None], rh[0][None, :], out=o)
        np.less_equal(rl[0][None, :], qht[0, s:e, None], out=t)
        np.logical_and(o, t, out=o)
        for j in range(1, l):
            np.less_equal(qlt[j, s:e, None], rh[j][None, :], out=t)
            np.logical_and(o, t, out=o)
            np.less_equal(rl[j][None, :], qht[j, s:e, None], out=t)
            np.logical_and(o, t, out=o)
        flat = np.flatnonzero(o.ravel())
        qi, ri = np.divmod(flat, nr)
        qi_list.append(qi + s)
        ri_list.append(ri)
    if len(qi_list) == 1:
        return (
            qi_list[0].astype(np.int64, copy=False),
            ri_list[0].astype(np.int64, copy=False),
        )
    return (
        np.concatenate(qi_list).astype(np.int64, copy=False),
        np.concatenate(ri_list).astype(np.int64, copy=False),
    )


class BatchedJoinExecutor:
    """Pack a plan frontier's dense θ-joins into one blocked evaluation.

    The planner hands every :class:`JoinRequest` ready in a frontier —
    across plan branches and, on sharded stores, across exchange-free
    sub-plans — to :meth:`run`.  Index-routed requests execute through the
    per-table :class:`IntervalIndex` as before, save on a CUDA executor the
    ones :func:`index_to_kernel` finds cheaper as a kernel segment and
    whose masks fit ``KERNEL_MASK_MEMORY_SHARE`` of the device's free
    memory: those share one packed launch of their own
    (``joins_index_to_kernel``).  Every dense-routed request becomes one
    *segment* of a single packed ``[NQ, 128] × [NR, 128]`` evaluation:

    * on ``device="cuda"``, one
      :func:`repro_torch.kernels.ops.segmented_range_join_pairs` launch of
      a CUDA kernel (block-diagonal tiles, or segment ids in spare lanes of
      one masked launch) — the whole frontier costs one kernel dispatch
      instead of one per hop;
    * on ``device="cpu"``, the GIL-releasing blocked-numpy twin
      (:func:`_twin_pairs`) over the tables' cached contiguous int32
      columns — same pair lists bit-for-bit, and thread-pool workers in
      ``planner._execute_parallel`` finally overlap because the hot loops
      run outside the GIL.

    Segments the kernel cannot express faithfully (lane capacity, int32
    overflow — see the ``np:*`` notes in ``plan.describe()``) route to the
    twin automatically.  The lane test is the kernels' one rule
    (:func:`~repro_torch.kernels.range_join.fits_lanes`), which the
    planner's ``np:wide`` notes and the per-hop route ask too; here it
    counts the segment lane whenever a frontier holds more than one dense
    segment.  Results are bit-identical to the serial per-hop loop;
    ``stats`` (an ``io_stats`` bump callable) meters launches, batch
    occupancy, the tile schedule (``batch_tiles_visited`` vs the
    cross-product tiles the block-diagonal layout ``batch_tiles_skipped``),
    and every join by the route it took (``joins_index``,
    ``joins_dense_kernel``, ``joins_dense_twin``).  A kernel segment's
    table side is the table's resident pack
    (:meth:`~repro_torch.core.table.CompressedTable.kernel_pack`): a launch
    packs and uploads only the query side, and ``table_packs_resident`` /
    ``table_packs_built`` count the segments that found the pack and those
    that built it.

    The kernel path launches at the fixed ``DEFAULT_GEOMETRY`` tiles.  The
    twin's mask-block cell budget comes from a :class:`~repro_torch.kernels.
    autotune.GeometryTuner` (``tuner``; the store's table when the planner
    creates the executor): on the first big segment of a new shape bucket
    the candidates are measured in place and the winner cached.
    ``engine`` pins the dense engine for tests/benchmarks: ``"kernel"``
    forces the segmented kernel path (the kernels' plain PyTorch versions
    on ``device="cpu"``), ``"twin"`` the numpy path, ``None`` picks by
    device.  ``device`` defaults to ``"cuda"`` and raises when CUDA is not
    available.
    """

    def __init__(
        self,
        stats=None,
        device="cuda",
        tuner: "GeometryTuner | None" = None,
        engine: str | None = None,
        metrics=None,
    ):
        if engine not in (None, "kernel", "twin"):
            raise ValueError(f"unknown dense engine {engine!r}")
        self._stats = stats if stats is not None else (lambda key, n=1: None)
        self._device = ops.resolve_device(device)
        self._tuner = tuner if tuner is not None else GeometryTuner()
        self._engine = engine
        # optional registry (labeled autotune-decision counters)
        self._metrics = metrics
        self._pool = None  # lazy worker pool for twin-segment fan-out
        self._pool_width = 0
        # measured tile occupancy: EMA of (scheduled tile cells / useful
        # pair cells) over dense dispatches — the planner's batched-route
        # discount scales by this instead of assuming perfect packing
        self._tile_waste = 1.0
        # the twin's most recent mask-block budget, for plan notes
        self._twin_geometry: tuple[int, ...] = DEFAULT_TWIN_CELLS

    @property
    def measured_waste(self) -> float:
        """EMA of scheduled-tile cells over useful pair cells (≥ 1)."""
        return self._tile_waste

    def _observe_occupancy(self, tile_cells: float, useful_cells: float) -> None:
        if useful_cells <= 0:
            return
        waste = max(1.0, tile_cells / useful_cells)
        self._tile_waste = 0.8 * self._tile_waste + 0.2 * waste

    def geometry_label(self, backend: str) -> str:
        """Launch-geometry annotation for ``plan.describe()`` hop notes.

        ``256x256``-style tile shapes for the kernel path (``backend ==
        "cuda"``), the twin's mask-block budget (``4m`` cells) otherwise —
        the most recently used budget, or the default before any dispatch.
        """
        if backend == "cuda":
            bq, br = DEFAULT_GEOMETRY
            return f"{bq}x{br}"
        (cells,) = self._twin_geometry
        return f"{cells >> 20}m" if cells >= 1 << 20 else f"{cells >> 10}k"

    def _workers(self, width: int):
        """A reusable thread pool for splitting twin segments (CPU mode)."""
        import concurrent.futures as cf

        if self._pool is None or self._pool_width < width:
            if self._pool is not None:
                self._pool.shutdown(wait=False)
            self._pool = cf.ThreadPoolExecutor(
                max_workers=width, thread_name_prefix="dslog-join"
            )
            self._pool_width = width
        return self._pool

    # ------------------------------------------------------------------ #
    def run(
        self, requests: Sequence[JoinRequest], workers: int | None = None
    ) -> list[list[QueryBox]]:
        """Execute one frontier's requests; returns per-request results.

        ``workers=N`` splits the packed dense segments across an N-thread
        pool — each worker's share is almost entirely GIL-releasing numpy
        (the twin's blocked mask passes), so the segments genuinely
        overlap on CPU while preparation, index probes, and result
        assembly stay on the calling thread.  Results are bit-identical
        for any worker count.
        """
        results: list[list[QueryBox] | None] = [None] * len(requests)
        dense: list[tuple] = []
        heavy: list[tuple] = []
        room: int | None = None  # mask bytes the rerouted joins may still take
        for i, req in enumerate(requests):
            pre = _prepare_batch(req.queries, req.table, req.inverse)
            if pre[0] == "done":
                results[i] = pre[1]
                continue
            _, u_lo, u_hi, inv, r_lo, r_hi, index_get = pre
            route, windows = _route_decision(
                u_lo, u_hi, r_lo, r_hi, index_get, req.path
            )
            if route == "index":
                route, windows = self._index_route(
                    req, u_lo, u_hi, r_lo, index_get, windows
                )
            if route == "kernel":
                need = _mask_bytes(u_lo.shape[0], r_lo.shape[0])
                if room is None:
                    room = int(
                        KERNEL_MASK_MEMORY_SHARE * _device_free_bytes(self._device)
                    )
                if need <= room:
                    room -= need
                else:
                    route = "index"
            item = (i, req, u_lo, u_hi, inv, r_lo, r_hi)
            if route == "index":
                self._stats("joins_index")
                ui, ri = index_get().candidate_pairs(u_lo, u_hi, windows)
                results[i] = _finalize_batch(
                    req.queries, req.table, req.inverse,
                    u_lo, u_hi, inv, ui, ri, req.merge,
                )
            elif route == "kernel":
                self._stats("joins_index_to_kernel")
                heavy.append(item)
            else:
                dense.append(item)
        if dense:
            self._run_dense(dense, results, workers)
        if heavy:
            # a launch of their own, kept out of the occupancy feedback the
            # planner prices its batched route by: its routes stay its own
            self._run_dense(heavy, results, observe=False)
        return results  # type: ignore[return-value]

    def _index_route(self, req, u_lo, u_hi, r_lo, index_get, windows):
        """An index-routed join's route on this executor, and the index's
        windows, probed once: ``"kernel"`` where :func:`index_to_kernel`
        finds the packed kernel launch cheaper, else ``"index"``.

        Only a CUDA executor that runs the kernel asks, and only for joins
        the kernel takes (the lane rule with a segment lane, both sides'
        int32 range); everywhere else the route is the planner's.
        """
        l = u_lo.shape[1]
        if (
            self._device.type != "cuda"
            or self._engine == "twin"
            or not l
            or not fits_lanes(l, segmented=True)
            or not req.table.int32_safe("value" if req.inverse else "key")
            or not ops.fits_int32(u_lo, u_hi)
        ):
            return "index", windows
        with obs_trace.span("query.index", "query"):
            index: IntervalIndex = index_get()
            if windows is None:
                windows = index.probe_windows(u_lo, u_hi)
            candidates = index.estimate_candidates(u_lo, u_hi, windows)
            heavy = index_to_kernel(candidates, u_lo.shape[0], r_lo.shape[0], windows)
        return ("kernel" if heavy else "index"), windows

    # ------------------------------------------------------------------ #
    def _run_dense(
        self,
        items: list[tuple],
        results: list,
        workers: int | None = None,
        observe: bool = True,
    ) -> None:
        """Evaluate and finalize every dense segment, one packed dispatch;
        ``observe`` feeds the kernel launch's tile occupancy to
        :attr:`measured_waste`."""
        kernel_idx: list[int] = []
        device = self._device
        use_kernel = self._engine == "kernel" or (
            self._engine is None and device.type == "cuda"
        )
        if use_kernel:
            # eligibility is per segment: one over-wide or int64 join must
            # not demote the rest of the frontier off the kernel path (and
            # over-wide segments never inflate the shared pack width).  With
            # several segments the lane test counts the segment lane, which
            # keeps the dense layout (one spare lane on the segment id)
            # expressible for any eligible subset.  The table side's int32
            # verdict is the table's cached one: only the query side is
            # scanned here.
            segmented = len(items) > 1
            with obs_trace.span("query.route", "query"):
                kernel_idx = [
                    k
                    for k, it in enumerate(items)
                    if fits_lanes(it[3].shape[1], segmented)
                    and it[1].table.int32_safe("value" if it[1].inverse else "key")
                    and ops.fits_int32(it[2], it[3])
                ]

        def finalize(k: int, ui: np.ndarray, ri: np.ndarray) -> None:
            i, req, u_lo, u_hi, inv, _r_lo, _r_hi = items[k]
            results[i] = _finalize_batch(
                req.queries, req.table, req.inverse,
                u_lo, u_hi, inv, ui, ri, req.merge,
            )

        def resident_pack(req: JoinRequest):
            """The getter of a segment's table side, resident on the device
            (``CompressedTable.kernel_pack``), counting hits and builds."""

            def get():
                pack, built = req.table.kernel_pack(
                    "value" if req.inverse else "key", device
                )
                self._stats("table_packs_built" if built else "table_packs_resident")
                return pack

            return get

        if kernel_idx:
            segs = [
                (items[k][2], items[k][3], items[k][5], items[k][6])
                for k in kernel_idx
            ]
            shapes = [(s[0].shape[0], s[2].shape[0], s[0].shape[1]) for s in segs]
            backend = device.type  # "cuda" kernels or "cpu" plain versions
            geom = DEFAULT_GEOMETRY
            with obs_trace.span("kernel_launch", "kernel") as sp:
                seg_pairs, info = ops.segmented_range_join_pairs(
                    segs,
                    block_q=geom[0],
                    block_r=geom[1],
                    device=device,
                    r_packs=[resident_pack(items[k][1]) for k in kernel_idx],
                )
            sp.attrs.update(
                backend=backend,
                segments=len(kernel_idx),
                geometry=f"{geom[0]}x{geom[1]}",
                launches=info["launches"],
                rows=info["rows"],
            )
            for k, (ui, ri) in zip(kernel_idx, seg_pairs):
                finalize(k, ui, ri)
            self._stats("kernel_launches", info["launches"])
            self._stats("joins_packed", len(kernel_idx))
            self._stats("joins_dense_kernel", len(kernel_idx))
            self._stats("batch_rows", info["rows"])
            self._stats("batch_rows_padded", info["rows_padded"])
            self._stats("batch_tiles_visited", info["tiles_visited"])
            self._stats("batch_tiles_skipped", info["tiles_skipped"])
            if observe:
                self._observe_occupancy(
                    float(info["tiles_visited"]) * geom[0] * geom[1],
                    float(sum(nq * nr for nq, nr, _ in shapes)),
                )
        done = set(kernel_idx)
        rest = [k for k in range(len(items)) if k not in done]
        if not rest:
            return
        rows = sum(items[k][2].shape[0] + items[k][5].shape[0] for k in rest)
        pairs: dict[int, tuple[np.ndarray, np.ndarray]] = {}

        # The twin evaluates each segment independently — exactly the
        # block-diagonal schedule — so meter its tile bill (in units of the
        # default kernel geometry, for comparability) against the
        # cross-product launch it avoids.
        bq, br = DEFAULT_GEOMETRY
        seg_qb = [-(-items[k][2].shape[0] // bq) for k in rest]
        seg_rb = [-(-items[k][5].shape[0] // br) for k in rest]
        visited = sum(q * r for q, r in zip(seg_qb, seg_rb))
        skipped = max(0, sum(seg_qb) * sum(seg_rb) - visited)

        with obs_trace.span("twin", "kernel") as sp:
            # twin launch geometry (mask cells per row block): cached per
            # frontier-shape bucket; an unseen bucket with a big enough lead
            # segment measures the candidates on that segment and keeps the
            # winner's pairs
            block_cells = DEFAULT_TWIN_CELLS[0]
            twin_shapes = [
                (items[k][2].shape[0], items[k][5].shape[0], items[k][2].shape[1])
                for k in rest
            ]
            twin_bucket = shape_bucket(twin_shapes)
            twin_geom = self._tuner.lookup("np", twin_bucket)
            if twin_geom is None:
                k_big = max(
                    rest, key=lambda k: items[k][2].shape[0] * items[k][5].shape[0]
                )
                big_cells = items[k_big][2].shape[0] * items[k_big][5].shape[0]
                if big_cells >= _TWIN_TUNE_MIN_CELLS:
                    _i, req, u_lo, u_hi, _inv, _r_lo, _r_hi = items[k_big]
                    rl_b, rh_b = req.table.dense_join_cols(
                        "value" if req.inverse else "key"
                    )
                    twin_geom, res = self._tuner.pick(
                        "np",
                        twin_bucket,
                        runner=lambda g: _twin_pairs(
                            u_lo, u_hi, rl_b, rh_b, None, block_cells=g[0]
                        ),
                    )
                    if self._metrics is not None:
                        self._metrics.inc(
                            "autotune_decisions",
                            backend="np",
                            bucket=str(twin_bucket),
                        )
                    if res is not None:
                        pairs[k_big] = res
                else:
                    twin_geom = DEFAULT_TWIN_CELLS
            block_cells = twin_geom[0]
            self._twin_geometry = tuple(twin_geom)
            todo = [k for k in rest if k not in pairs]

            def eval_segments(chunk: list[int]) -> None:
                scratch: dict = {}  # mask buffers shared within the chunk
                for k in chunk:
                    _i, req, u_lo, u_hi, _inv, _r_lo, _r_hi = items[k]
                    rl, rh = req.table.dense_join_cols(
                        "value" if req.inverse else "key"
                    )
                    pairs[k] = _twin_pairs(
                        u_lo, u_hi, rl, rh, scratch, block_cells=block_cells
                    )

            # clamp fan-out to real cores: the chunks only overlap while they
            # hold no GIL, and oversubscribing 2 cores with 4 GIL-trading
            # threads costs more in hand-offs than it buys
            width = min(workers or 1, len(todo), os.cpu_count() or 1)
            if width > 1:
                # fan only the *mask evaluations* out — the twin's blocked
                # passes are almost pure released-GIL numpy, so they overlap on
                # real cores, while finalize (intersect/de-relativize/scatter:
                # many small Python-held steps that would thrash the GIL across
                # threads) stays on the calling thread.  Chunks are balanced by
                # mask size, largest-first onto the lightest chunk; the calling
                # thread chews chunk 0 instead of idling.  Each pair list lands
                # in its own slot, so any worker count is bit-identical.
                chunks: list[list[int]] = [[] for _ in range(width)]
                loads = [0] * width
                for k in sorted(
                    todo,
                    key=lambda k: -items[k][2].shape[0] * items[k][5].shape[0],
                ):
                    w = loads.index(min(loads))
                    chunks[w].append(k)
                    loads[w] += items[k][2].shape[0] * items[k][5].shape[0]
                futs = [
                    self._workers(width - 1).submit(eval_segments, c)
                    for c in chunks[1:]
                ]
                eval_segments(chunks[0])
                for f in futs:
                    f.result()
            else:
                eval_segments(todo)
        sp.attrs.update(
            backend="np",
            segments=len(rest),
            rows=rows,
            block_cells=block_cells,
            workers=width,
        )
        for k in rest:
            finalize(k, *pairs[k])
        # the twin is one fused dispatch per frontier: count it like a
        # launch so CPU runs meter batching the same way GPU runs do
        self._stats("kernel_launches", 1)
        self._stats("joins_packed", len(rest))
        self._stats("joins_dense_twin", len(rest))
        self._stats("batch_rows", rows)
        self._stats("batch_rows_padded", rows)
        self._stats("batch_tiles_visited", visited)
        self._stats("batch_tiles_skipped", skipped)
        # per-segment evaluation has no tile padding: cells-exact occupancy
        useful = float(sum(nq * nr for nq, nr, _ in twin_shapes))
        self._observe_occupancy(useful, useful)


# --------------------------------------------------------------------------- #
# Row reduction between hops (paper §V.B.3)
# --------------------------------------------------------------------------- #
def merge_boxes(q: QueryBox) -> QueryBox:
    """Dedup + merge boxes that are adjacent/overlapping on one axis.

    Same machinery as one multi-attribute range-encoding pass per axis,
    iterated to fixpoint.
    """
    lo, hi = q.lo, q.hi
    if lo.shape[0] <= 1:
        return q
    # exact duplicate removal first
    both = np.concatenate([lo, hi], axis=1)
    both = _unique_rows(both)
    nd = len(q.shape)
    lo, hi = both[:, :nd], both[:, nd:]
    changed = True
    while changed and lo.shape[0] > 1:
        changed = False
        for d in range(nd):
            others = []
            for k in range(nd):
                if k != d:
                    others += [lo[:, k], hi[:, k]]
            order = lexsort_rows(others + [lo[:, d]])
            group = _group_ids([c[order] for c in others], lo.shape[0])
            starts, mlo, mhi = coalesce_1d(group, lo[order, d], hi[order, d])
            if starts.size != lo.shape[0]:
                sel = order[starts]
                lo, hi = lo[sel].copy(), hi[sel].copy()
                lo[:, d], hi[:, d] = mlo, mhi
                changed = True
    return QueryBox(q.shape, lo, hi)


def canonical_boxes(q: QueryBox) -> QueryBox:
    """Canonical decomposition: a function of the *cell set* alone.

    ``merge_boxes`` reaches a fixpoint but the fixpoint depends on the
    input decomposition, so two plans covering the same cells (per-hop
    chain vs a composed view, unsharded vs sharded) can return different —
    equally valid — box lists.  This computes the axis-ordered slab
    decomposition instead: cut axis 0 wherever the canonical
    (d-1)-dimensional cross-section changes, recurse, then merge adjacent
    slabs with identical cross-sections.  Boundaries survive only where
    the cross-section actually changes, which is intrinsic to the cell
    set, so every decomposition of the same cells maps to identical
    bytes.  Used as the final normal form on merged query answers.

    The cut is one segmented sweep per axis (:func:`_canonical_cut`): every
    slab of every level is cut at once, so the host's cost grows with the
    rows the slabs hold, not with a Python step per slab or per box.
    """
    if q.lo.shape[0] <= 1:
        return q
    nd = len(q.shape)
    if nd == 0:
        return QueryBox(q.shape, q.lo[:1], q.hi[:1])
    lo = np.asarray(q.lo, np.int64)
    hi = np.asarray(q.hi, np.int64)
    lo, hi, _ = _canonical_cut(lo, hi, np.zeros(lo.shape[0], np.int64))
    return QueryBox(q.shape, lo, hi)


def _canonical_cut(
    lo: np.ndarray, hi: np.ndarray, group: np.ndarray
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Canonical decomposition of every group of boxes at once.

    ``lo``/``hi`` are int64 ``(n, d)`` boxes and ``group`` their int64 group
    ids, in any order.  Returns the groups' canonical boxes and their group
    ids, sorted by group; within a group, slabs of axis 0 ascend and each
    slab's rows follow its cross-section's own canonical order.
    """
    n = lo.shape[0]
    if n == 1:
        return lo, hi, group
    # one int64 key per (group, axis-0 value): group * span + (value - vmin)
    vmin = int(lo[:, 0].min())
    span = int(hi[:, 0].max()) - vmin + 2
    if (int(group.max()) + 1) * span >= 1 << 62:
        # keys would overflow: cut on axis 0's ranks among its lo and
        # hi + 1, which keep every overlap, adjacency and gap
        values, rank = np.unique(np.concatenate([lo[:, 0], hi[:, 0] + 1]), return_inverse=True)
        lo, hi = lo.copy(), hi.copy()
        lo[:, 0], hi[:, 0] = rank[:n], rank[n:] - 1
        out_lo, out_hi, out_group = _canonical_cut(lo, hi, group)
        out_lo[:, 0], out_hi[:, 0] = values[out_lo[:, 0]], values[out_hi[:, 0] + 1] - 1
        return out_lo, out_hi, out_group
    if lo.shape[1] == 1:
        # the last axis: each group's union of intervals, sorted by lo
        l, h = lo[:, 0] - vmin, hi[:, 0] - vmin
        order = np.argsort(group * span + l)
        g = group[order]
        starts, out_lo, out_hi = coalesce_1d(g, l[order], h[order])
        return out_lo[:, None] + vmin, out_hi[:, None] + vmin, g[starts]

    # A group's cuts are its boxes' lo and hi + 1 on axis 0; sorted keys make
    # slab i = [cut i, cut i + 1) within a group.
    key = group * span
    start, end = key + (lo[:, 0] - vmin), key + (hi[:, 0] + 1 - vmin)
    cuts, at = np.unique(np.concatenate([start, end]), return_inverse=True)
    # each box becomes one row per slab it covers; the slab is its group
    owner, slab = ragged_ranges(at[:n], at[n:])
    sub_lo, sub_hi, sub_slab = _canonical_cut(lo[owner, 1:], hi[owner, 1:], slab)

    # the present slabs, each a run of rows in the sorted sub-result
    m = sub_slab.size
    first = np.ones(m, bool)
    first[1:] = sub_slab[1:] != sub_slab[:-1]
    row_start = np.flatnonzero(first)
    present = sub_slab[row_start]
    rows = np.diff(row_start, append=m)
    # slab k + 1 joins slab k when no gap slab lies between them (then both
    # lie in one group) and their cross-sections are equal, row for row
    join = (present[1:] == present[:-1] + 1) & (rows[1:] == rows[:-1])
    pair = np.flatnonzero(join)
    if pair.size:
        which, r = ragged_ranges(row_start[pair], row_start[pair + 1])
        s = r + rows[pair][which]
        same = (sub_lo[r] == sub_lo[s]).all(axis=1) & (sub_hi[r] == sub_hi[s]).all(axis=1)
        join[pair] = segment_all(same, np.cumsum(rows[pair]) - rows[pair])

    # each run of joined slabs keeps its first slab's rows behind
    # [first slab's cut, last slab's end - 1] on axis 0
    run_first = np.ones(present.size, bool)
    run_first[1:] = ~join
    head = present[run_first]
    tail = np.append(present[:-1][~join], present[-1])
    keep = np.repeat(run_first, rows)
    run = np.repeat(np.arange(head.size), rows[run_first])
    cut_value = cuts % span + vmin
    out_lo = np.concatenate([cut_value[head][run][:, None], sub_lo[keep]], axis=1)
    out_hi = np.concatenate([cut_value[tail + 1][run][:, None] - 1, sub_hi[keep]], axis=1)
    return out_lo, out_hi, (cuts[head] // span)[run]


# --------------------------------------------------------------------------- #
# Multi-hop planner
# --------------------------------------------------------------------------- #
def query_path(
    q: QueryBox,
    hops: list[tuple[CompressedTable, bool]],
    merge: bool = True,
    path: str = "auto",
    device="cuda",
) -> QueryBox:
    """Left-to-right plan over ``(table, inverse)`` hops (paper §V.B.3).

    ``inverse=False`` means the query side matches the table's keys
    (the natural direction for that materialization); ``inverse=True``
    uses ``theta_join_inverse``.

    Each hop's interval index is cached on its table, so a multi-hop plan
    (and any later plan revisiting the same tables) pays the index build at
    most once per table, not once per hop execution.
    """
    # Q' is encoded in the same compressed format as the tables (§V.B):
    # merging the query cells into boxes up front is what keeps the first
    # range join proportional to |boxes|, not |cells|.
    cur = merge_boxes(q) if merge else q
    for table, inverse in hops:
        cur = (
            theta_join_inverse(cur, table, merge=merge, path=path, device=device)
            if inverse
            else theta_join(cur, table, merge=merge, path=path, device=device)
        )
    return cur
