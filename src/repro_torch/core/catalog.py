"""DSLog — the lineage storage manager (paper §III, §V), in memory.

The port of ``repro.core.catalog``.  This slice keeps the paper's loop of
ingest and query:

* named, shape-declared **Arrays** (§III.A ``Array``) and ``acc@k``
  versioned names for in-place ops;
* **lineage entries** — ProvRC-compressed backward (+ optionally forward)
  tables between array pairs (§III.A ``Lineage``), ingested through
  :meth:`DSLog.add_lineage` or :meth:`DSLog.register_operation`;
* the **lineage DAG** (:class:`~repro_torch.core.graph.LineageGraph`), with
  cycle rejection;
* multi-hop ``prov_query`` (§V) in both call forms — the paper's explicit
  array path and the graph form — served by the cost-based
  :class:`~repro_torch.core.planner.QueryPlanner`, whose dense joins run
  on the store's ``device``.

What the reference store also does is still to be ported, and raises
:class:`NotImplementedError` naming its ``ROADMAP.md`` item rather than
behaving differently: persistence (``open`` / ``load`` / ``save``, the
write-ahead log, ``commit`` / ``checkpoint`` / ``mark_dirty`` /
``compact``), materialized views and the answer cache (``views`` is
``None``), and automatic reuse (``register_operation`` takes
``reuse=False`` only).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Sequence

import numpy as np

from repro_torch.kernels.autotune import GeometryTuner
from repro_torch.kernels.ops import resolve_device
from repro_torch.obs.metrics import IoStatsView, MetricsRegistry
from repro_torch.obs.trace import QueryTrace, maybe_span

from . import _locks
from .graph import CycleError, LineageGraph
from .planner import QueryPlanner
from .provrc import compress
from .query import QueryBox
from .relation import LineageRelation
from .table import CompressedTable

__all__ = ["DSLog", "ArrayDef", "LineageEntry"]

# Counters pre-seeded at zero in every store registry so reads and `in`
# checks on the io_stats view behave like a dict.
SEED_COUNTERS = (
    # batched plan-step execution: packed dense dispatches (device kernel
    # launches, or their CPU-twin equivalents), how many joins rode each,
    # and pack occupancy (rows used vs padded)
    "kernel_launches",
    "joins_packed",
    "batch_rows",
    "batch_rows_padded",
    # tile schedule of those dispatches: tiles actually evaluated vs the
    # cross-product tiles the block-diagonal layout skipped
    "batch_tiles_visited",
    "batch_tiles_skipped",
    # the planner races a view plan per single-source/single-target query;
    # without views every race is a miss
    "view_misses",
)

# Cost-feedback aging: every new hop measurement decays the accumulated
# (pairs, qrows) mass by this factor before adding its own, so the measured
# selectivity is an exponential moving average — replanning stays honest
# after the workload shifts instead of being pinned to ancient traffic.
_DEFAULT_HOP_DECAY = 0.9
# ...and the accumulated qrows mass is capped, bounding how much history a
# shifted workload has to out-shout (the "sample cap" of the EMA).
_HOP_SAMPLE_CAP = 1e6

# the ROADMAP.md queue item that ports persistence, views and reuse
_ROADMAP_ITEM = (
    "ROADMAP.md §1 'Still to port' item 2: views, reuse, WAL and commit, "
    "save/load"
)


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet ({_ROADMAP_ITEM})"
    )


@dataclass
class ArrayDef:
    name: str
    shape: tuple[int, ...]


class LineageEntry:
    """Compressed lineage between an op input (src) and op output (dst)."""

    def __init__(
        self,
        lineage_id: int,
        src: str,
        dst: str,
        backward: CompressedTable,
        forward: CompressedTable | None = None,
        op_name: str | None = None,
    ):
        self.lineage_id = lineage_id
        self.src = src  # input array name
        self.dst = dst  # output array name
        self.op_name = op_name
        self.backward = backward  # keys = dst axes
        self.forward = forward  # keys = src axes, or None

    @property
    def has_forward(self) -> bool:
        return self.forward is not None

    @property
    def backward_rows(self) -> int:
        return self.backward.n_rows

    @property
    def forward_rows(self) -> int | None:
        return None if self.forward is None else self.forward.n_rows

    def peek_table(self, stored: str) -> CompressedTable | None:
        """The table of one materialization (always resident in memory)."""
        return self.backward if stored == "backward" else self.forward

    def __repr__(self) -> str:
        return (
            f"LineageEntry(id={self.lineage_id}, {self.src!r}->{self.dst!r}, "
            f"op={self.op_name!r})"
        )


@dataclass
class _OpRecord:
    op_name: str
    in_arrs: tuple[str, ...]
    out_arrs: tuple[str, ...]
    op_args: Any
    lineage_ids: list[int] = field(default_factory=list)


class DSLog:
    """The lineage index service, in memory, on one device.

    ``device`` is where dense θ-joins run: ``"cuda"`` (the default) launches
    the CUDA range-join kernels and raises at construction when CUDA is
    not available; ``"cpu"`` is the reference's interpret mode (the numpy
    twin, or the kernels' plain PyTorch versions under
    ``planner.executor``'s ``engine="kernel"``).
    """

    views = None  # materialized views: not ported yet (see the module doc)

    def __init__(
        self,
        store_forward: bool = True,
        compress_method: str = "auto",
        hop_decay: float = _DEFAULT_HOP_DECAY,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.store_forward = store_forward
        self.compress_method = compress_method
        self.hop_decay = float(hop_decay)
        self.arrays: dict[str, ArrayDef] = {}
        self.lineage: dict[int, LineageEntry] = {}
        self.by_pair: dict[tuple[str, str], list[int]] = {}
        self.graph = LineageGraph()
        self.ops: list[_OpRecord] = []
        self.planner = QueryPlanner(self)
        # measured launch geometries for the batched join engines,
        # consulted by planner.executor
        self.autotune = GeometryTuner()
        self._next_id = 0
        self._stats_lock = _locks.new_rlock("catalog._stats_lock")
        # measured per-hop selectivities: "lid:stored:side" -> [pairs, qrows]
        self.hop_stats: dict[str, list[float]] = _locks.guard_mapping(
            {}, self._stats_lock, "DSLog.hop_stats"
        )
        # versioned-name counters for in-place ops: base name -> latest k
        self._versions: dict[str, int] = {}
        # telemetry: all meters live in the registry; io_stats is a live
        # read-only dict view over its unlabeled counters.
        self.metrics = MetricsRegistry("dslog")
        self.metrics.seed_counters(SEED_COUNTERS)
        self.metrics.register_collector(self._collect_gauges)
        self.io_stats = IoStatsView(self.metrics)
        # per-query structured tracing (prov_query(..., trace=True));
        # None = off, the only cost on untraced hot paths.
        self._active_trace: QueryTrace | None = None

    def _bump(self, key: str, n: int = 1) -> None:
        self.metrics.inc(key, n)

    def _collect_gauges(self):
        """Snapshot-time gauges: hop-stat EMAs (top 32 by pair mass)."""
        with self._stats_lock:
            hops = {k: tuple(v) for k, v in self.hop_stats.items()}
        top = sorted(hops.items(), key=lambda kv: -kv[1][0])[:32]
        for key, (pairs, qrows) in top:
            yield ("hop_pairs_ema", {"hop": key}, pairs)
            yield ("hop_qrows_ema", {"hop": key}, qrows)

    def metrics_snapshot(self) -> dict:
        """Structured dump of every instrument (see ``repro_torch.obs``)."""
        return self.metrics.snapshot()

    # ------------------------------------------------------------------ #
    # Not ported yet: each raises, naming its ROADMAP item
    # ------------------------------------------------------------------ #
    @classmethod
    def open(cls, root: str, **kw) -> "DSLog":
        raise _not_ported("DSLog.open (WAL, group commit, leases)")

    @staticmethod
    def load(root: str) -> "DSLog":
        raise _not_ported("DSLog.load")

    def save(self, checkpoint_wal: bool = True) -> None:
        raise _not_ported("DSLog.save")

    def commit(self) -> None:
        raise _not_ported("DSLog.commit (write-ahead log)")

    def checkpoint(self) -> None:
        raise _not_ported("DSLog.checkpoint")

    def mark_dirty(self, lineage_id: int) -> None:
        raise _not_ported("DSLog.mark_dirty (WAL invalidation)")

    def compact(self, save: bool = True) -> dict[str, int]:
        raise _not_ported("DSLog.compact")

    # ------------------------------------------------------------------ #
    # Array / lineage definition (paper §III.A)
    # ------------------------------------------------------------------ #
    def define_array(self, name: str, shape: tuple[int, ...]) -> ArrayDef:
        arr = ArrayDef(name, tuple(int(d) for d in shape))
        self.arrays[name] = arr
        return arr

    def version(self, name: str, shape: tuple[int, ...] | None = None) -> str:
        """Mint (and define) the next versioned name for ``name``.

        The lineage DAG rejects self-lineage (``acc → acc``), so in-place /
        accumulator-style updates are logged under fresh names ``base@k``,
        ``k`` increasing from 1; the new array is defined with ``shape`` (or
        the latest version's shape when omitted).
        """
        base = name.split("@", 1)[0]
        if shape is None:
            prev = self.latest_version(base)
            if prev in self.arrays:
                shape = self.arrays[prev].shape
        k = self._versions.get(base, 0) + 1
        self._versions[base] = k
        new = f"{base}@{k}"
        if shape is not None:
            self.define_array(new, shape)
        return new

    def latest_version(self, name: str) -> str:
        """Current name of ``name``: ``base@k`` after k ``version()`` calls,
        the base name itself before the first."""
        base = name.split("@", 1)[0]
        k = self._versions.get(base, 0)
        return base if k == 0 else f"{base}@{k}"

    def add_lineage(
        self,
        src: str,
        dst: str,
        relation: LineageRelation,
        op_name: str | None = None,
        tables: tuple[CompressedTable, CompressedTable | None] | None = None,
    ) -> LineageEntry:
        """Ingest one captured relation (src = op input, dst = op output).

        Raises :class:`~repro_torch.core.graph.CycleError` (leaving the
        catalog untouched) when the new edge would make the lineage DAG
        cyclic.
        """
        self._check_shapes(src, dst, relation)
        if tables is not None:
            bwd, fwd = tables
        else:
            bwd = compress(relation, "backward", self.compress_method)
            fwd = (
                compress(relation, "forward", self.compress_method)
                if self.store_forward
                else None
            )
        return self._insert_entry(src, dst, bwd, fwd, op_name)

    def _insert_entry(
        self,
        src: str,
        dst: str,
        bwd: CompressedTable,
        fwd: CompressedTable | None,
        op_name: str | None,
    ) -> LineageEntry:
        # cycle check first: a rejected edge must not leave a half-inserted
        # entry (graph.add_edge mutates nothing when it raises)
        self.graph.add_edge(src, dst, self._next_id)
        entry = LineageEntry(self._next_id, src, dst, bwd, fwd, op_name)
        self._next_id += 1
        self.lineage[entry.lineage_id] = entry
        self.by_pair.setdefault((src, dst), []).append(entry.lineage_id)
        return entry

    def _remove_entry(self, lineage_id: int) -> None:
        """Undo one :meth:`_insert_entry` (multi-entry rollback)."""
        e = self.lineage.pop(lineage_id)
        ids = self.by_pair[(e.src, e.dst)]
        ids.remove(lineage_id)
        if not ids:
            del self.by_pair[(e.src, e.dst)]
        self.graph.remove_edge(e.src, e.dst, lineage_id)

    # ------------------------------------------------------------------ #
    # Planner cost-model feedback (measured per-hop selectivities)
    # ------------------------------------------------------------------ #
    @staticmethod
    def _hop_key(lineage_id: int, stored: str, frontier_on: str) -> str:
        return f"{lineage_id}:{stored}:{frontier_on}"

    def record_hop(
        self,
        lineage_id: int,
        stored: str,
        frontier_on: str,
        pairs: int,
        qrows: int,
    ) -> None:
        """Fold the true pair count one executed hop produced into the
        measured selectivity — an exponential moving average with a sample
        cap.  Thread-safe (parallel execution calls this from workers)."""
        with self._stats_lock:
            st = self.hop_stats.setdefault(
                self._hop_key(lineage_id, stored, frontier_on), [0.0, 0.0]
            )
            st[0] = st[0] * self.hop_decay + float(pairs)
            st[1] = st[1] * self.hop_decay + float(qrows)
            if st[1] > _HOP_SAMPLE_CAP:
                scale = _HOP_SAMPLE_CAP / st[1]
                st[0] *= scale
                st[1] *= scale

    def hop_measurement(
        self, lineage_id: int, stored: str, frontier_on: str
    ) -> float | None:
        """Measured pairs-per-query-box for one hop, or None if never run."""
        st = self.hop_stats.get(self._hop_key(lineage_id, stored, frontier_on))
        if not st or st[1] <= 0:
            return None
        return st[0] / st[1]

    def _check_shapes(self, src: str, dst: str, rel: LineageRelation) -> None:
        if src in self.arrays and self.arrays[src].shape != rel.in_shape:
            raise ValueError(
                f"array {src} declared {self.arrays[src].shape}, lineage says {rel.in_shape}"
            )
        if dst in self.arrays and self.arrays[dst].shape != rel.out_shape:
            raise ValueError(
                f"array {dst} declared {self.arrays[dst].shape}, lineage says {rel.out_shape}"
            )
        self.arrays.setdefault(src, ArrayDef(src, rel.in_shape))
        self.arrays.setdefault(dst, ArrayDef(dst, rel.out_shape))

    # ------------------------------------------------------------------ #
    # Operation registration (§III.A)
    # ------------------------------------------------------------------ #
    def register_operation(
        self,
        op_name: str,
        in_arrs: list[str],
        out_arrs: list[str],
        capture: Callable[[], dict[tuple[int, int], LineageRelation]] | None = None,
        op_args: Any = None,
        reuse: bool | None = None,
    ) -> _OpRecord:
        """Register one executed operation and its lineage.

        ``capture()`` returns ``{(out_pos, in_pos): relation}``.  Automatic
        reuse (the reference's default, ``reuse=None``/``True``) is not
        ported yet, so the port takes ``reuse=False`` only and raises
        otherwise; registration is atomic (a mid-op ``CycleError`` rolls
        back the op's earlier entries).
        """
        if reuse is not False:
            raise _not_ported(
                "automatic reuse (register_operation without reuse=False)"
            )
        if capture is None:
            raise ValueError(
                f"no confirmed reuse mapping for {op_name} and no capture given"
            )
        rec = _OpRecord(op_name, tuple(in_arrs), tuple(out_arrs), op_args)
        rels = capture()
        try:
            for (oi, ii), rel in rels.items():
                entry = self.add_lineage(
                    rec.in_arrs[ii], rec.out_arrs[oi], rel, op_name=op_name
                )
                rec.lineage_ids.append(entry.lineage_id)
        except CycleError:
            for lid in reversed(rec.lineage_ids):
                self._remove_entry(lid)
            raise
        self.ops.append(rec)
        return rec

    # ------------------------------------------------------------------ #
    # Multi-hop queries (§V) — both forms served by the planner
    # ------------------------------------------------------------------ #
    def prov_query(
        self,
        *args,
        merge: bool = True,
        parallel: int | None = None,
        batched: bool | None = None,
        trace: bool = False,
    ) -> "QueryBox | dict | tuple":
        """Lineage between cells of two arrays.

        Two call forms::

            prov_query(path, cells)        # explicit array path (paper §V)
            prov_query(src, dst, cells)    # planner routes over the DAG

        In graph form the planner infers direction (forward when ``dst`` is
        downstream of ``src``), merges converging branches at fan-in arrays,
        and picks the cheapest stored materialization per hop.  ``dst`` may
        be a sequence of array names — the result is then a dict
        ``{name: QueryBox}``.  ``parallel=N`` executes independent plan
        branches on an N-thread pool.  ``batched`` picks the join engine
        (default ``planner.batched``): packed frontier execution through the
        :class:`~repro_torch.core.query.BatchedJoinExecutor` vs the per-hop
        join loop — results are bit-identical either way.

        ``trace=True`` returns ``(result, QueryTrace)`` instead.  Tracing
        never changes the answer.
        """
        form = self._parse_query_args(args)
        if form[0] == "path":
            _, path, cells, m_override = form
            if m_override is not None:
                merge = m_override
            res = self.prov_query_batch(
                path,
                [cells],
                merge=merge,
                parallel=parallel,
                batched=batched,
                trace=trace,
            )
            if trace:
                res, tr = res
                return res[0], tr
            return res[0]
        _, src, dst, cells = form
        res = self.prov_query_batch(
            src,
            dst,
            [cells],
            merge=merge,
            parallel=parallel,
            batched=batched,
            trace=trace,
        )
        tr = None
        if trace:
            res, tr = res
        if isinstance(res, dict):
            res = {name: boxes[0] for name, boxes in res.items()}
        else:
            res = res[0]
        return (res, tr) if trace else res

    def prov_query_batch(
        self,
        *args,
        merge: bool = True,
        parallel: int | None = None,
        batched: bool | None = None,
        trace: bool = False,
    ) -> "list[QueryBox] | dict[str, list[QueryBox]] | tuple":
        """Answer many independent queries in one pass (both call forms).

        The plan is computed once; each hop runs through the batched θ-join
        (shared index probes, deduplicated boxes across in-flight queries).
        ``trace=True`` returns ``(result, QueryTrace)``.
        """
        tr = QueryTrace(registry=self.metrics) if trace else None
        workers = parallel if parallel is not None else 0
        use_batched = self.planner.batched if batched is None else batched
        engine = (
            "parallel"
            if workers and workers > 1
            else ("batched" if use_batched else "serial")
        )
        prev = self._active_trace
        if tr is not None:
            self._active_trace = tr
        t0 = time.perf_counter()
        try:
            out, path_label = self._query_batch_impl(
                args, merge, parallel, batched, tr, engine
            )
        finally:
            if tr is not None:
                self._active_trace = prev
                tr.finish()
        self.metrics.observe(
            "query_seconds", time.perf_counter() - t0, path=path_label, engine=engine
        )
        self.metrics.inc("queries", path=path_label)
        return (out, tr) if trace else out

    def _query_batch_impl(
        self, args, merge, parallel, batched, tr, engine
    ) -> tuple:
        """Body of :meth:`prov_query_batch`; returns ``(result, path)``
        where ``path`` labels the query form (``"planned"`` graph form,
        explicit-``"path"`` form)."""
        form = self._parse_query_args(args)
        if form[0] == "path":
            _, path, queries, m_override = form
            if m_override is not None:
                merge = m_override
            if len(path) < 2:
                raise ValueError("path needs at least two arrays")
            if not queries:
                return [], "path"
            boxes = self._as_boxes(path[0], queries)
            with maybe_span(tr, "plan", kind="plan", form="path") as sp:
                plan = self.planner.plan_path(path, frontier=boxes, batched=batched)
                sp.attrs["est_cost"] = round(plan.est_cost, 3)
            with maybe_span(tr, "execute", kind="execute", engine=engine):
                out = self.planner.execute(
                    plan, boxes, merge=merge, parallel=parallel, batched=batched
                )[path[-1]]
            return out, "path"
        _, src, dst, queries = form
        multi = not isinstance(dst, str)
        targets = list(dst) if multi else [dst]
        if not queries:
            return ({t: [] for t in targets} if multi else []), "planned"
        boxes = self._as_boxes(src, queries)
        with maybe_span(tr, "plan", kind="plan", form="graph") as sp:
            plan = self.planner.plan(src, targets, frontier=boxes, batched=batched)
            sp.attrs["est_cost"] = round(plan.est_cost, 3)
        with maybe_span(tr, "execute", kind="execute", engine=engine):
            out = self.planner.execute(
                plan, boxes, merge=merge, parallel=parallel, batched=batched
            )
        return (out if multi else out[dst]), "planned"

    def _as_boxes(
        self, name: str, queries: Sequence["np.ndarray | QueryBox"]
    ) -> list[QueryBox]:
        shape = self.arrays[name].shape
        return [
            q if isinstance(q, QueryBox) else QueryBox.from_cells(shape, q)
            for q in queries
        ]

    @staticmethod
    def _parse_query_args(args: tuple) -> tuple:
        """Dispatch ``(path, q)`` vs ``(src, dst, q)`` positional forms.

        The path form also takes ``merge`` as a trailing positional
        argument, ``(path, q, merge)``, as the reference does.
        """
        if len(args) == 2:
            path, q = args
            if isinstance(path, str):
                raise TypeError(
                    "prov_query(src, dst, cells) needs a dst argument; "
                    "the two-argument form takes a path list"
                )
            return ("path", list(path), q, None)
        if len(args) == 3:
            src, dst, q = args
            if not isinstance(src, str):
                if isinstance(q, (bool, np.bool_)):
                    return ("path", list(src), dst, bool(q))
                raise TypeError(
                    "graph-form prov_query takes a source array name; "
                    "for the path form pass merge as a keyword"
                )
            if not isinstance(dst, (str, list, tuple, set, frozenset)):
                raise TypeError("dst must be an array name or a sequence of names")
            return ("graph", src, dst, q)
        raise TypeError(
            f"prov_query takes (path, cells) or (src, dst, cells); got "
            f"{len(args)} positional arguments"
        )

    # ------------------------------------------------------------------ #
    def storage_bytes(self) -> int:
        """Packed size of every stored table."""
        total = 0
        for e in self.lineage.values():
            total += e.backward.nbytes()
            if e.forward is not None:
                total += e.forward.nbytes()
        return total
