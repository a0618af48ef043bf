"""Materialized lineage views and the cell-level answer cache.

The port of ``repro.core.views``: the same admission, invalidation and
manifest/answer-cache bytes.  Composition's range joins run on the store's
device (``DSLog.device``), so on ``"cuda"`` a large dense composition join
launches the CUDA ``range_join_mask`` kernel.

Hot ``src -> dst`` routes get their multi-hop ProvRC relations *composed*
into a single stored :class:`~repro_torch.core.table.CompressedTable` — a
shortcut edge the planner costs like any other hop — and exact repeated
queries are answered from a bounded cell-level cache before planning at
all.  Both are invalidated precisely through the same events the WAL
records (``entry`` / ``drop`` / ``dirty``): a mutation kills only the
views and cached answers whose route touches the mutated array.

Composition is *operationally exact*: querying the composed table emits
the same cell set as running the per-hop chain, for every query (results
become byte-identical after the planner's canonical final normal form,
:func:`~repro_torch.core.query.canonical_boxes`).  Routes whose rows cannot be
composed exactly under the engine's per-attribute box semantics raise
:class:`CompositionError` and are remembered as uncomposable — the answer
cache still serves their repeats.

Admission is heat-driven: an EMA-aged per-route counter fed by the query
stream (and by the planner's ``record_hop`` feedback on view hops) admits
a route once it crosses a threshold, under a global row budget with
LRU-style demotion of the coldest views.
"""

from __future__ import annotations

import numpy as np

from repro_torch.kernels.ops import resolve_device

from . import _locks
from .query import QueryBox, _route_pairs, _unique_rows, merge_boxes
from .table import CompressedTable, TableHandle

__all__ = [
    "CompositionError",
    "MaterializedView",
    "ViewManager",
    "compose_tables",
    "compose_route",
    "is_view_id",
    "view_pseudo_id",
    "view_id_of",
]

# View hops ride through the planner as pseudo lineage ids below zero, so
# they can never collide with real entries: view k <-> lineage id -(k+1).
def view_pseudo_id(view_id: int) -> int:
    return -int(view_id) - 1


def view_id_of(pseudo_id: int) -> int:
    return -int(pseudo_id) - 1


def is_view_id(lineage_id: int) -> bool:
    return lineage_id < 0


class CompositionError(ValueError):
    """The route's relations cannot be composed exactly in ProvRC form."""


# --------------------------------------------------------------------------- #
# Exact relation composition (A: K -> Y joined with B: Y -> Z)
# --------------------------------------------------------------------------- #
def _empty_table(
    key_shape, val_shape, n_key: int, n_val: int, direction: str
) -> CompressedTable:
    z = np.zeros((0, max(n_key, 1)), np.int64)[:, :n_key]
    v = np.zeros((0, max(n_val, 1)), np.int64)[:, :n_val]
    return CompressedTable(
        key_shape, val_shape, z, z.copy(), v, v.copy(), v.copy(),
        direction=direction,
    )


def compose_tables(
    A: CompressedTable,
    B: CompressedTable,
    max_rows: int | None = None,
    direction: str = "backward",
    device="cuda",
) -> CompressedTable:
    """Compose two ProvRC tables: ``A`` maps K -> Y, ``B`` maps Y -> Z.

    The result maps K -> Z and is operationally exact: for every query
    box, joining it against the composed table emits the same cell set as
    joining through ``A`` and then ``B``.  Rows that cannot be composed
    exactly under per-attribute box semantics raise
    :class:`CompositionError` (symbolic tables, relative deltas whose key
    image is not containable in ``B``'s key box, value attributes sharing
    a key reference).  The candidate pairs come from a range join on
    ``device`` (``"cuda"`` raises without CUDA).
    """
    device = resolve_device(device)
    if A.val_shape != B.key_shape:
        raise CompositionError(
            f"shape mismatch: A values {A.val_shape} vs B keys {B.key_shape}"
        )
    if A.is_symbolic or B.is_symbolic:
        raise CompositionError("symbolic tables do not compose")
    l, mid, m2 = A.n_key, A.n_val, B.n_val
    if A.n_rows == 0 or B.n_rows == 0:
        return _empty_table(A.key_shape, B.val_shape, l, m2, direction)
    a_ref_full = np.asarray(A.val_ref, np.int64)
    # Two relative value attrs referencing the same key attr couple those
    # outputs through the key; the chain's per-attribute product semantics
    # lose that coupling, so no single composed row can reproduce it.
    for r in range(l):
        if np.any(np.count_nonzero(a_ref_full == r, axis=1) > 1):
            raise CompositionError(
                "rows with duplicate key references are not composable"
            )
    vb_lo, vb_hi = A.value_bounds()
    ai, bi = _route_pairs(
        vb_lo, vb_hi, B.key_lo, B.key_hi, B.key_index, "auto", device
    )
    n_pairs = int(ai.size)
    if max_rows is not None and n_pairs > max_rows:
        raise CompositionError(
            f"composition explodes: {n_pairs} candidate pairs > {max_rows}"
        )
    if n_pairs == 0:
        return _empty_table(A.key_shape, B.val_shape, l, m2, direction)
    kl = A.key_lo[ai].astype(np.int64, copy=True)
    kh = A.key_hi[ai].astype(np.int64, copy=True)
    a_ref = a_ref_full[ai]
    a_vlo = np.asarray(A.val_lo, np.int64)[ai]
    a_vhi = np.asarray(A.val_hi, np.int64)[ai]
    b_klo = np.asarray(B.key_lo, np.int64)[bi]
    b_khi = np.asarray(B.key_hi, np.int64)[bi]
    abs_a = a_ref < 0

    # Y pass.  Absolute A attrs intersect with B's key box (both static, so
    # the chain's intermediate interval is query-independent and exact);
    # relative attrs tighten the composed key instead:  k_r + d hits
    # [b_lo, b_hi] for some d in [d_lo, d_hi] iff k_r in
    # [b_lo - d_hi, b_hi - d_lo] — the same overlap test the chain applies.
    y_lo = np.where(abs_a, np.maximum(a_vlo, b_klo), np.int64(0))
    y_hi = np.where(abs_a, np.minimum(a_vhi, b_khi), np.int64(0))
    valid = ~np.any(abs_a & (y_lo > y_hi), axis=1)
    for j in range(mid):
        rows = np.nonzero(~abs_a[:, j])[0]
        if rows.size == 0:
            continue
        r = a_ref[rows, j]
        kl[rows, r] = np.maximum(kl[rows, r], b_klo[rows, j] - a_vhi[rows, j])
        kh[rows, r] = np.minimum(kh[rows, r], b_khi[rows, j] - a_vlo[rows, j])
    valid &= np.all(kl <= kh, axis=1)

    # Z pass.  Copy absolute B attrs; re-root B attrs referencing an
    # absolute Y onto the (exact) intermediate interval; chain deltas for
    # B attrs referencing a relative Y.
    b_ref = np.asarray(B.val_ref, np.int64)[bi]
    out_lo = np.asarray(B.val_lo, np.int64)[bi].copy()
    out_hi = np.asarray(B.val_hi, np.int64)[bi].copy()
    out_ref = np.full((n_pairs, m2), -1, np.int64)
    for i in range(m2):
        refs = b_ref[:, i]
        for j in range(mid):
            jm = refs == j
            if not jm.any():
                continue
            aj = jm & abs_a[:, j]
            out_lo[aj, i] += y_lo[aj, j]
            out_hi[aj, i] += y_hi[aj, j]
            rj = np.nonzero(jm & ~abs_a[:, j])[0]
            if rj.size == 0:
                continue
            r = a_ref[rj, j]
            out_ref[rj, i] = r
            out_lo[rj, i] += a_vlo[rj, j]
            out_hi[rj, i] += a_vhi[rj, j]
            # A non-point delta composes exactly only when the tightened
            # key's whole image lands inside B's key box — otherwise the
            # chain's clamp cuts cells the composed row would keep.
            spread = np.nonzero(
                (a_vlo[rj, j] != a_vhi[rj, j]) & valid[rj]
            )[0]
            if spread.size:
                rs, rr = rj[spread], r[spread]
                img_lo = kl[rs, rr] + a_vlo[rs, j]
                img_hi = kh[rs, rr] + a_vhi[rs, j]
                if np.any(img_lo < b_klo[rs, j]) or np.any(
                    img_hi > b_khi[rs, j]
                ):
                    raise CompositionError(
                        "relative interval delta escapes the next hop's "
                        "key box; route is not exactly composable"
                    )
    if not valid.any():
        return _empty_table(A.key_shape, B.val_shape, l, m2, direction)
    packed = np.concatenate(
        [kl[valid], kh[valid], out_lo[valid], out_hi[valid], out_ref[valid]],
        axis=1,
    )
    packed = _unique_rows(packed)
    if max_rows is not None and packed.shape[0] > max_rows:
        raise CompositionError(
            f"composed relation has {packed.shape[0]} rows > budget {max_rows}"
        )
    kl, kh = packed[:, :l], packed[:, l : 2 * l]
    off = 2 * l
    return CompressedTable(
        A.key_shape,
        B.val_shape,
        kl,
        kh,
        packed[:, off : off + m2],
        packed[:, off + m2 : off + 2 * m2],
        packed[:, off + 2 * m2 :],
        direction=direction,
    )


def compose_route(
    tables: list[CompressedTable],
    max_rows: int | None = None,
    direction: str = "backward",
    device="cuda",
) -> CompressedTable:
    """Fold a chain of hop tables (in composition order) into one."""
    if not tables:
        raise CompositionError("empty route")
    out = tables[0]
    for nxt in tables[1:]:
        out = compose_tables(out, nxt, max_rows, direction, device)
    return out


def _concat_tables(tables: list[CompressedTable]) -> CompressedTable:
    """Row-concatenate same-schema tables (parallel entries on one hop,
    or per-path composed relations over one route)."""
    if len(tables) == 1:
        return tables[0]
    first = tables[0]
    for t in tables[1:]:
        if t.key_shape != first.key_shape or t.val_shape != first.val_shape:
            raise CompositionError("hop tables disagree on shapes")
        if t.is_symbolic:
            raise CompositionError("symbolic tables do not compose")
    return CompressedTable(
        first.key_shape,
        first.val_shape,
        np.concatenate([t.key_lo for t in tables]),
        np.concatenate([t.key_hi for t in tables]),
        np.concatenate([t.val_lo for t in tables]),
        np.concatenate([t.val_hi for t in tables]),
        np.concatenate([np.asarray(t.val_ref, np.int64) for t in tables]),
        direction=first.direction,
    )


def _dedup_table(t: CompressedTable) -> CompressedTable:
    if t.n_rows <= 1:
        return t
    packed = _unique_rows(
        np.concatenate(
            [t.key_lo, t.key_hi, t.val_lo, t.val_hi,
             np.asarray(t.val_ref, np.int64)],
            axis=1,
        )
    )
    l, m = t.n_key, t.n_val
    return CompressedTable(
        t.key_shape,
        t.val_shape,
        packed[:, :l],
        packed[:, l : 2 * l],
        packed[:, 2 * l : 2 * l + m],
        packed[:, 2 * l + m : 2 * l + 2 * m],
        packed[:, 2 * l + 2 * m :],
        direction=t.direction,
    )


# --------------------------------------------------------------------------- #
# Materialized views
# --------------------------------------------------------------------------- #
class MaterializedView:
    """One composed route relation, stored like a lineage entry.

    ``src``/``dst`` are in dataflow order (``src`` upstream).  The
    backward table maps dst cells to src cells; ``fwd`` (when every hop
    had a forward table) maps src to dst.  ``lids``/``arrays`` are the
    route's closure, consulted by precise invalidation; ``lsns`` snapshots
    every WAL's end LSN at composition time, so ``fsck`` can prove a
    manifest-listed view predates no surviving invalidation record.
    """

    __slots__ = (
        "view_id", "src", "dst", "lids", "arrays",
        "_bwd", "_fwd", "lsns", "last_use", "_entry", "_rec",
    )

    def __init__(self, view_id, src, dst, lids, arrays, bwd, fwd, lsns):
        self.view_id = int(view_id)
        self.src = src
        self.dst = dst
        self.lids = frozenset(int(x) for x in lids)
        self.arrays = frozenset(arrays)
        self._bwd = bwd
        self._fwd = fwd
        self.lsns = dict(lsns)
        self.last_use = 0
        self._entry = None
        self._rec = None  # cached manifest record once the blobs are on disk

    @property
    def backward(self) -> CompressedTable:
        if isinstance(self._bwd, TableHandle):
            return self._bwd.get()
        return self._bwd

    @property
    def forward(self) -> CompressedTable | None:
        if isinstance(self._fwd, TableHandle):
            return self._fwd.get()
        return self._fwd

    @property
    def backward_rows(self) -> int:
        if isinstance(self._bwd, TableHandle):
            return self._bwd.rows
        return self._bwd.n_rows

    @property
    def forward_rows(self) -> int | None:
        if self._fwd is None:
            return None
        if isinstance(self._fwd, TableHandle):
            return self._fwd.rows
        return self._fwd.n_rows

    @property
    def total_rows(self) -> int:
        return self.backward_rows + (self.forward_rows or 0)

    def __repr__(self) -> str:
        return (
            f"MaterializedView(id={self.view_id}, {self.src!r}->{self.dst!r}, "
            f"rows={self.backward_rows}, lids={sorted(self.lids)})"
        )


class ViewManager:
    """Views + answer cache + heat tracking + precise invalidation.

    One per store; all state lives behind ``views._lock`` (rank 15 in the
    reference's ``tools/lockorder.py`` — below the table and stats locks
    it takes while composing).
    """

    def __init__(
        self,
        log: "DSLog",
        *,
        enabled: bool = True,
        admit_after: float = 3.0,
        heat_decay: float = 0.85,
        budget_rows: int = 250_000,
        max_view_rows: int = 100_000,
        max_paths: int = 8,
        cache_capacity: int = 256,
        persist_cache: int = 64,
    ):
        self.log = log
        self.enabled = enabled
        self.admit_after = float(admit_after)
        self.heat_decay = float(heat_decay)
        self.budget_rows = int(budget_rows)
        self.max_view_rows = int(max_view_rows)
        self.max_paths = int(max_paths)
        self.cache_capacity = int(cache_capacity)
        self.persist_cache = int(persist_cache)
        self._lock = _locks.new_rlock("views._lock")
        self.views: dict[int, MaterializedView] = _locks.guard_mapping(
            {}, self._lock, "ViewManager.views"
        )
        self._by_route: dict[tuple[str, str], int] = _locks.guard_mapping(
            {}, self._lock, "ViewManager._by_route"
        )
        self._heat: dict[tuple[str, str], float] = _locks.guard_mapping(
            {}, self._lock, "ViewManager._heat"
        )
        # routes proven non-composable (or over budget): don't retry until
        # the topology changes
        self._uncomposable: dict[tuple[str, str], bool] = _locks.guard_mapping(
            {}, self._lock, "ViewManager._uncomposable"
        )
        # answer cache: insertion-ordered dict doubling as the LRU list
        self._cache: dict[tuple, dict] = _locks.guard_mapping(
            {}, self._lock, "ViewManager._cache"
        )
        # route-plan memo: plans are cell-independent, so a hot route's
        # winning plan (view shortcut or not) is reused verbatim until any
        # invalidation, admission, or demotion changes the race
        self._plans: dict[tuple, tuple] = _locks.guard_mapping(
            {}, self._lock, "ViewManager._plans"
        )
        # EMA'd selectivity feedback for view hops (pseudo ids never reach
        # the store's hop_stats, whose keys shard by owning entry)
        self._hops: dict[tuple, list[float]] = _locks.guard_mapping(
            {}, self._lock, "ViewManager._hops"
        )
        self._next_id = 0
        self._tick = 0
        self._dirty = False  # view set / invalidation state changed
        # bumped by every invalidation event; a composition that started
        # under an older epoch is discarded instead of admitted
        self._epoch = 0

    # ------------------------------------------------------------------ #
    @property
    def dirty(self) -> bool:
        """View set (or an invalidation that purged cached answers)
        changed since the last manifest chunk was taken."""
        return self._dirty

    def _bump(self, key: str, n: int = 1) -> None:
        self.log._bump(key, n)

    def _lsns(self) -> dict[str, int]:
        fn = getattr(self.log, "_view_lsns", None)
        return fn() if fn is not None else {}

    # ------------------------------------------------------------------ #
    # Planner surface
    # ------------------------------------------------------------------ #
    def shortcut_for(self, src: str, dst: str) -> int | None:
        """Pseudo lineage id of a live view covering src->dst (either
        orientation), or None."""
        if not self.enabled:
            return None
        with self._lock:
            vid = self._by_route.get((src, dst))
            if vid is None:
                vid = self._by_route.get((dst, src))
            if vid is None:
                return None
            self._tick += 1
            self.views[vid].last_use = self._tick
            return view_pseudo_id(vid)

    def entry_for(self, pseudo_id: int):
        """A real :class:`~repro_torch.core.catalog.LineageEntry` over the view's
        tables, so every planner/executor path works unchanged."""
        from .catalog import LineageEntry  # deferred: catalog imports us

        with self._lock:
            view = self.views[view_id_of(pseudo_id)]
            if view._entry is None:
                view._entry = LineageEntry(
                    pseudo_id,
                    view.src,
                    view.dst,
                    view._bwd,
                    view._fwd,
                    op_name=f"view#{view.view_id}",
                )
            return view._entry

    def record_hop(self, lineage_id, stored, frontier_on, pairs, qrows):
        decay = getattr(self.log, "hop_decay", 0.9)
        with self._lock:
            st = self._hops.setdefault(
                (lineage_id, stored, frontier_on), [0.0, 0.0]
            )
            st[0] = st[0] * decay + float(pairs)
            st[1] = st[1] * decay + float(qrows)

    def hop_measurement(self, lineage_id, stored, frontier_on):
        with self._lock:
            st = self._hops.get((lineage_id, stored, frontier_on))
        if not st or st[1] <= 0:
            return None
        return st[0] / st[1]

    # ------------------------------------------------------------------ #
    # Route-plan memo
    # ------------------------------------------------------------------ #
    _PLAN_MEMO_CAP = 64

    def plan_get(self, src: str, targets: list[str], batched):
        """A memoized plan for this route, or None.  Replays the view-race
        stat the original planning pass recorded and touches the view's
        LRU slot, so memo hits age views exactly like planned hits."""
        if not self.enabled:
            return None
        key = (src, tuple(targets), batched)
        with self._lock:
            hit = self._plans.get(key)
            if hit is None:
                return None
            self._plans.pop(key)
            self._plans[key] = hit  # LRU touch
        plan, stat, route = hit
        if stat is not None:
            self._bump(stat)
        if route is not None:
            self.shortcut_for(*route)  # keeps the view warm for eviction
        return plan

    def plan_put(self, src: str, targets: list[str], batched, plan) -> None:
        if not self.enabled:
            return
        uses_view = any(
            is_view_id(c.lineage_id)
            for steps in plan.steps.values()
            for s in steps
            for c in s.choices
        )
        stat = route = None
        if uses_view:
            stat, route = "view_hits", (src, targets[0])
        elif len(targets) == 1 and self.shortcut_for(src, targets[0]):
            stat = "view_misses"
        key = (src, tuple(targets), batched)
        with self._lock:
            self._plans[key] = (plan, stat, route)
            while len(self._plans) > self._PLAN_MEMO_CAP:
                self._plans.pop(next(iter(self._plans)))

    # ------------------------------------------------------------------ #
    # Heat-driven admission
    # ------------------------------------------------------------------ #
    def _normalize_route(self, a: str, b: str) -> tuple[str, str] | None:
        g = self.log.graph
        if g.has_path(a, b):
            return (a, b)
        if g.has_path(b, a):
            return (b, a)
        return None

    def note_route(self, src: str, targets: list[str]) -> None:
        """Feed one query's route into the heat tracker; materialize when
        a route crosses the admission threshold."""
        if not self.enabled or len(targets) != 1 or targets[0] == src:
            return
        route = self._normalize_route(src, targets[0])
        if route is None:
            return
        with self._lock:
            heat = self._heat.get(route, 0.0) * self.heat_decay + 1.0
            self._heat[route] = heat
            if (
                heat < self.admit_after
                or route in self._by_route
                or route in self._uncomposable
            ):
                return
        self._materialize(route)

    def _materialize(self, route: tuple[str, str]) -> MaterializedView | None:
        """Compose one route and admit the result.

        Composition runs *outside* ``views._lock``: resolving entries may
        lazily load table blobs (which take their own,
        lower-ranked locks).  LSNs and an invalidation epoch are captured
        first; if any invalidation lands while composing, the stale result
        is discarded instead of admitted.
        """
        src, dst = route
        g = self.log.graph
        with self._lock:
            epoch = self._epoch
        lsns = self._lsns()
        paths = g.simple_paths([src], [dst], max_paths=self.max_paths + 1)
        if not paths or len(paths) > self.max_paths:
            with self._lock:
                self._uncomposable[route] = True
            return None
        if all(len(p) == 2 for p in paths):
            return None  # direct edges only: a view would not shorten it
        lids: set[int] = set()
        arrays: set[str] = set()
        bwd_parts: list[CompressedTable] = []
        fwd_parts: list[CompressedTable] = []
        all_forward = True
        try:
            for path in paths:
                arrays.update(path)
                hop_entries = []
                for u, v in zip(path, path[1:]):
                    ids = g.edge_ids(u, v)
                    entries = [self.log.lineage[lid] for lid in ids]
                    lids.update(ids)
                    hop_entries.append(entries)
                btabs = [
                    _concat_tables([e.backward for e in entries])
                    for entries in reversed(hop_entries)
                ]
                bwd_parts.append(
                    compose_route(
                        btabs, self.max_view_rows, "backward", self.log.device
                    )
                )
                if all_forward and all(
                    e.has_forward for es in hop_entries for e in es
                ):
                    ftabs = [
                        _concat_tables([e.forward for e in entries])
                        for entries in hop_entries
                    ]
                    fwd_parts.append(
                        compose_route(
                            ftabs, self.max_view_rows, "forward", self.log.device
                        )
                    )
                else:
                    all_forward = False
            bwd = _dedup_table(_concat_tables(bwd_parts))
            fwd = (
                _dedup_table(_concat_tables(fwd_parts)) if all_forward else None
            )
        except (CompositionError, KeyError):
            # KeyError: an entry on the route was dropped mid-compose
            with self._lock:
                self._uncomposable[route] = True
            return None
        total = bwd.n_rows + (fwd.n_rows if fwd is not None else 0)
        if total > self.max_view_rows:
            with self._lock:
                self._uncomposable[route] = True
            return None
        with self._lock:
            if self._epoch != epoch or route in self._by_route:
                return None  # invalidation (or a racing admit) won
            self._evict_for(total)
            vid = self._next_id
            self._next_id += 1
            view = MaterializedView(vid, src, dst, lids, arrays, bwd, fwd, lsns)
            self._tick += 1
            view.last_use = self._tick
            self.views[vid] = view
            self._by_route[route] = vid
            self.log.graph.add_shortcut(src, dst, view_pseudo_id(vid))
            self._plans.clear()  # the race has a new contender
            self._dirty = True
        self._bump("views_materialized")
        return view

    def _evict_for(self, incoming_rows: int) -> None:
        """LRU-demote the coldest views until the budget fits (lock held)."""
        total = sum(v.total_rows for v in self.views.values())
        while self.views and total + incoming_rows > self.budget_rows:
            vid = min(self.views, key=lambda k: self.views[k].last_use)
            total -= self.views[vid].total_rows
            self._remove_view(vid, count=False)
            self._bump("views_demoted")

    def _remove_view(self, vid: int, count: bool = True) -> None:
        view = self.views.pop(vid)
        self._by_route.pop((view.src, view.dst), None)
        self.log.graph.remove_shortcut(view.src, view.dst)
        stale = [k for k in self._hops if k[0] == view_pseudo_id(vid)]
        for k in stale:
            del self._hops[k]
        self._plans.clear()  # memoized plans may reference the dead view
        self._dirty = True
        if count:
            self._bump("views_invalidated")

    # ------------------------------------------------------------------ #
    # Answer cache
    # ------------------------------------------------------------------ #
    def cache_key(self, src, targets, boxes, merge) -> tuple | None:
        """Stable key for one batch: canonical-ish cell boxes per query.

        Only merged (canonical-form) answers are cached; ``merge=False``
        callers get raw per-hop boxes the cache does not model."""
        if not self.enabled or not merge:
            return None
        parts = []
        for q in boxes:
            mb = merge_boxes(q)
            parts.append((mb.shape, mb.lo.tobytes(), mb.hi.tobytes()))
        return (src, tuple(targets), tuple(parts))

    def cache_get(self, key: tuple):
        with self._lock:
            hit = self._cache.get(key)
            if hit is None:
                self._bump("cache_misses")
                return None
            # LRU touch: re-insert at the ordered dict's tail
            del self._cache[key]
            self._cache[key] = hit
            self._bump("cache_hits")
            return {
                name: [QueryBox(b.shape, b.lo.copy(), b.hi.copy()) for b in bl]
                for name, bl in hit["answer"].items()
            }

    def cache_put(self, key: tuple, out: dict, src, targets, plan) -> None:
        if not self.enabled:
            return
        lids: set[int] = set()
        for step_list in plan.steps.values():
            for step in step_list:
                for choice in step.choices:
                    lid = choice.lineage_id
                    if is_view_id(lid):
                        with self._lock:
                            view = self.views.get(view_id_of(lid))
                        lids.update(view.lids if view is not None else ())
                    else:
                        lids.add(lid)
        entry = {
            "answer": {
                name: [QueryBox(b.shape, b.lo.copy(), b.hi.copy()) for b in bl]
                for name, bl in out.items()
            },
            "lids": lids,
            "src": src,
            "targets": tuple(targets),
            "arrays": set(plan.node_array.values()),
        }
        with self._lock:
            self._cache.pop(key, None)
            self._cache[key] = entry
            while len(self._cache) > self.cache_capacity:
                del self._cache[next(iter(self._cache))]

    # ------------------------------------------------------------------ #
    # WAL-precise invalidation
    # ------------------------------------------------------------------ #
    def on_mutation(self, lineage_id: int) -> None:
        """A ``dirty`` or ``drop`` event on one entry: kill exactly the
        views and cached answers whose route includes it."""
        with self._lock:
            self._epoch += 1
            # memoized plans may route through the mutated entry
            self._plans.clear()
            dead = [
                vid for vid, v in self.views.items() if lineage_id in v.lids
            ]
            for vid in dead:
                self._remove_view(vid)
            stale = [
                k for k, e in self._cache.items() if lineage_id in e["lids"]
            ]
            for k in stale:
                del self._cache[k]
            if stale:
                self._dirty = True
            self._uncomposable.clear()  # the topology/blobs changed

    def on_new_edge(self, src: str, dst: str) -> None:
        """A new ``entry`` event: kill views and answers whose route the
        new edge lands on (an endpoint upstream of ``src`` and one
        downstream of ``dst``)."""
        g = self.log.graph
        with self._lock:
            self._epoch += 1
            # a new edge can open routes a memoized plan never traverses,
            # so the memo dies even when no views or answers are live
            self._plans.clear()
            if not self.views and not self._cache:
                self._uncomposable.clear()
                return
            up = g.reachable([src], "backward")
            down = g.reachable([dst], "forward")
            dead = [
                vid
                for vid, v in self.views.items()
                if v.src in up and v.dst in down
            ]
            for vid in dead:
                self._remove_view(vid)
            stale = [
                k
                for k, e in self._cache.items()
                if any(
                    (e["src"] in up and t in down)
                    or (t in up and e["src"] in down)
                    for t in e["targets"]
                )
            ]
            for k in stale:
                del self._cache[k]
            if stale:
                self._dirty = True
            self._uncomposable.clear()

    def invalidate_all(self) -> None:
        with self._lock:
            self._epoch += 1
            self._plans.clear()
            for vid in list(self.views):
                self._remove_view(vid)
            if self._cache:
                self._dirty = True
            self._cache.clear()
            self._uncomposable.clear()

    # ------------------------------------------------------------------ #
    # Persistence (blobs through the owning store's durable writers)
    # ------------------------------------------------------------------ #
    def manifest_chunk(self, write_blob) -> dict:
        """Manifest record of every live view; ``write_blob(fn, table)``
        persists a blob durably.  Marks the manager clean."""
        # Snapshot which views still need blobs, then compose and write
        # them *outside* the lock: ``write_blob`` fsyncs and
        # ``view.backward`` may decode a table blob from disk, and every
        # reader would serialise behind that latency if it ran under
        # ``views._lock``.  Views are immutable once composed and each
        # blob is written exactly once, so no lock is needed while
        # writing; a view removed concurrently just leaves an
        # unreferenced blob for ``compact()`` to vacuum.
        with self._lock:
            pending = [
                (vid, self.views[vid])
                for vid in sorted(self.views)
                if self.views[vid]._rec is None
            ]
        written: dict[int, dict] = {}
        for vid, view in pending:
            fn = f"view_{vid}.prvc"
            write_blob(fn, view.backward)
            rec = {
                "id": vid,
                "src": view.src,
                "dst": view.dst,
                "lids": sorted(view.lids),
                "arrays": sorted(view.arrays),
                "file": fn,
                "rows": view.backward_rows,
                "fwd": None,
                "fwd_rows": None,
                "lsns": dict(view.lsns),
            }
            if view._fwd is not None:
                fwd_fn = f"view_{vid}_fwd.prvc"
                write_blob(fwd_fn, view.forward)
                rec["fwd"] = fwd_fn
                rec["fwd_rows"] = view.forward_rows
            written[vid] = rec
        with self._lock:
            recs = []
            clean = True
            for vid in sorted(self.views):
                view = self.views[vid]
                if view._rec is None:
                    rec = written.get(vid)
                    if rec is None:
                        # admitted after the snapshot: its blob is not on
                        # disk yet, so it stays out of this manifest and
                        # the manager stays dirty for the next save
                        clean = False
                        continue
                    view._rec = rec
                recs.append(view._rec)
            self._dirty = not clean
            return {"next_id": self._next_id, "views": recs}

    def load_chunk(self, chunk: dict, make_handle) -> None:
        """Restore views from a manifest chunk; ``make_handle(fn, rows)``
        returns a lazy :class:`~repro_torch.core.table.TableHandle`."""
        if not chunk:
            return
        with self._lock:
            self._next_id = int(chunk.get("next_id", 0))
            for rec in chunk.get("views", []):
                vid = int(rec["id"])
                bwd = make_handle(rec["file"], rec.get("rows"))
                fwd = (
                    make_handle(rec["fwd"], rec.get("fwd_rows"))
                    if rec.get("fwd")
                    else None
                )
                view = MaterializedView(
                    vid,
                    rec["src"],
                    rec["dst"],
                    rec["lids"],
                    rec["arrays"],
                    bwd,
                    fwd,
                    {k: int(v) for k, v in rec.get("lsns", {}).items()},
                )
                view._rec = dict(rec)
                self.views[vid] = view
                self._by_route[(view.src, view.dst)] = vid
                self.log.graph.add_shortcut(
                    view.src, view.dst, view_pseudo_id(vid)
                )
            self._dirty = False

    def blob_files(self) -> set[str]:
        with self._lock:
            out = set()
            for vid, view in self.views.items():
                out.add(f"view_{vid}.prvc")
                if view._fwd is not None:
                    out.add(f"view_{vid}_fwd.prvc")
            return out

    def cache_chunk(self) -> dict:
        """JSON-able sidecar of the most recent cached answers."""
        with self._lock:
            keys = list(self._cache)[-self.persist_cache :]
            entries = []
            for key in keys:
                e = self._cache[key]
                src, targets, parts = key
                entries.append(
                    {
                        "src": src,
                        "targets": list(targets),
                        "queries": [
                            {
                                "shape": list(shape),
                                "lo": np.frombuffer(lo, np.int64)
                                .reshape(-1, len(shape))
                                .tolist(),
                                "hi": np.frombuffer(hi, np.int64)
                                .reshape(-1, len(shape))
                                .tolist(),
                            }
                            for shape, lo, hi in parts
                        ],
                        "answer": {
                            name: [
                                {
                                    "shape": list(b.shape),
                                    "lo": b.lo.tolist(),
                                    "hi": b.hi.tolist(),
                                }
                                for b in bl
                            ]
                            for name, bl in e["answer"].items()
                        },
                        "lids": sorted(e["lids"]),
                        "arrays": sorted(e["arrays"]),
                    }
                )
            return {"entries": entries}

    def load_cache_chunk(self, chunk: dict) -> None:
        if not chunk:
            return

        def box(rec) -> QueryBox:
            shape = tuple(rec["shape"])
            lo = np.asarray(rec["lo"], np.int64).reshape(-1, len(shape))
            hi = np.asarray(rec["hi"], np.int64).reshape(-1, len(shape))
            return QueryBox(shape, lo, hi)

        with self._lock:
            for e in chunk.get("entries", []):
                key = (
                    e["src"],
                    tuple(e["targets"]),
                    tuple(
                        (
                            tuple(q["shape"]),
                            np.asarray(q["lo"], np.int64).tobytes(),
                            np.asarray(q["hi"], np.int64).tobytes(),
                        )
                        for q in e["queries"]
                    ),
                )
                self._cache[key] = {
                    "answer": {
                        name: [box(r) for r in bl]
                        for name, bl in e["answer"].items()
                    },
                    "lids": set(int(x) for x in e["lids"]),
                    "src": e["src"],
                    "targets": tuple(e["targets"]),
                    "arrays": set(e["arrays"]),
                }
            while len(self._cache) > self.cache_capacity:
                del self._cache[next(iter(self._cache))]

    # ------------------------------------------------------------------ #
    def stats(self) -> dict:
        with self._lock:
            return {
                "views": len(self.views),
                "view_rows": sum(v.total_rows for v in self.views.values()),
                "cached_answers": len(self._cache),
                "hot_routes": sum(
                    1 for h in self._heat.values() if h >= self.admit_after
                ),
            }
