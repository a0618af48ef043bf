"""Sharded lineage store: partitioned DAG, per-shard manifests, cross-shard
query planning.

The port of ``repro.core.shard``: the same placement (``zlib.crc32`` of the
base name), plans, exchanges and root/shard manifest bytes, so either
package opens a sharded root the other wrote.  Every shard is a
:class:`~repro_torch.core.catalog.DSLog` on the facade's ``device``; all
shards of one store share that one device, as the reference keeps its
shards in one process on one device.

One :class:`~repro_torch.core.catalog.DSLog` stops scaling when the catalog must
serve production traffic: every save rewrites one manifest, every query
plans over one graph, and one process owns all blobs.
:class:`ShardedDSLog` splits the store into ``N`` independent shards while
keeping the single-store surface:

* **graph layer** — :class:`ShardedLineageGraph` assigns every array to a
  shard through a pluggable :class:`ShardPolicy` (stable hashing by default,
  explicit :class:`AffinityShardPolicy` pinning when the workload knows
  better).  Each shard keeps its own
  :class:`~repro_torch.core.graph.LineageGraph`; lineage whose endpoints live on
  different shards is tracked in an explicit **boundary-edge table** (the
  entry itself is stored with its *output* array's shard, so backward
  queries start local — the SMOKE argument for tight per-partition
  indexes).

* **planner layer** — :class:`ShardedQueryPlanner` routes over the global
  DAG exactly like the single-store planner, then decomposes the plan into
  per-shard sub-plans stitched by :class:`ExchangeStep`s.  A frontier
  crossing a shard boundary is first coalesced with
  :func:`~repro_torch.core.query.merge_boxes` so only merged cell boxes ship
  (predicate-pushdown style: prune before crossing), and the cost model
  adds a per-box exchange term (``_EXCHANGE_WEIGHT``) on top of the
  single-shard per-hop costs.  In a traced query each crossing's work (the
  shipped frontier's ``merge_boxes`` and the metering) is a
  ``shard.exchange`` span holding the ``exchange`` event.

* **persistence layer** — the v2 manifest splits into a **root manifest**
  (``catalog.json`` with a ``"sharded"`` marker: policy, array→shard map,
  edge topology, boundary table, ops, predictor state, version counters)
  plus one ordinary DSLog manifest per shard under ``shard_XX/``.  Each
  shard dirty-tracks independently: ``save()`` rewrites only the manifests
  and blobs of shards that actually changed, and a reloaded store resolves
  a shard's manifest lazily, the first time a plan touches it.

* **facade layer** — ``ShardedDSLog`` reuses ``DSLog``'s method objects
  (``add_lineage``, ``register_operation``, ``prov_query`` …) over sharded
  storage, so ``N=1`` is the single-store special case with byte-identical
  query results, and existing ``prov_query(src, dst, cells)`` calls work
  unchanged on any ``N``.
"""

from __future__ import annotations

import glob
import json
import os
import uuid
import zlib
from collections.abc import Mapping
from dataclasses import dataclass, field

from repro_torch.kernels.autotune import GeometryTuner
from repro_torch.kernels.ops import resolve_device
from repro_torch.obs.export import telemetry_snapshot
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs import trace as obs_trace

from . import _locks
from .catalog import (
    ArrayDef,
    DSLog,
    SEED_COUNTERS,
    _apply_open_overrides,
    _atomic_write,
    _DEFAULT_HOP_DECAY,
    _json_safe,
    _OpRecord,
    _vacuum_dir,
    manifest_referenced_files,
)
from .commit import CommitPipeline, LeaseHeldError, WriterLease
from .graph import CycleError, LineageGraph
from .planner import _MERGE_SHRINK, _fmt_lid, EdgeStep, QueryPlan, QueryPlanner
from .query import merge_boxes
from .reuse import ReusePredictor
from .table import CompressedTable, TableHandle
from .views import ViewManager
from .wal import WAL_FILENAME, WriteAheadLog

__all__ = [
    "ShardPolicy",
    "HashShardPolicy",
    "AffinityShardPolicy",
    "ShardedLineageGraph",
    "ShardedDSLog",
    "ShardedQueryPlan",
    "ShardedQueryPlanner",
    "ExchangeStep",
]

_ROOT_MANIFEST_VERSION = 3

# Cost-model weight per frontier box shipped across a shard boundary
# (serialization + transfer, in the planner's unitless per-pair scale).
_EXCHANGE_WEIGHT = 4.0


def _base_name(name: str) -> str:
    """Strip a ``@k`` version suffix: versions of an array co-locate."""
    return name.split("@", 1)[0]


# --------------------------------------------------------------------------- #
# Shard assignment policies
# --------------------------------------------------------------------------- #
class ShardPolicy:
    """Maps array names to shard ids.  Must be deterministic: the same name
    resolves to the same shard across processes and reloads."""

    def __init__(self, n_shards: int):
        if n_shards < 1:
            raise ValueError("need at least one shard")
        self.n_shards = int(n_shards)

    def shard_of(self, name: str) -> int:
        raise NotImplementedError

    def to_manifest(self) -> dict:
        raise NotImplementedError

    @staticmethod
    def from_manifest(rec: dict) -> "ShardPolicy":
        kind = rec.get("kind", "hash")
        if kind == "hash":
            return HashShardPolicy(int(rec["n_shards"]))
        if kind == "affinity":
            return AffinityShardPolicy(
                int(rec["n_shards"]),
                {k: int(v) for k, v in rec.get("assign", {}).items()},
            )
        raise ValueError(f"unknown shard policy {kind!r}")


class HashShardPolicy(ShardPolicy):
    """Stable crc32 hash of the array's *base* name (``acc@3`` → ``acc``),
    so in-place version chains never cross a shard boundary."""

    def shard_of(self, name: str) -> int:
        return zlib.crc32(_base_name(name).encode()) % self.n_shards

    def to_manifest(self) -> dict:
        return {"kind": "hash", "n_shards": self.n_shards}


class AffinityShardPolicy(ShardPolicy):
    """Explicit name→shard pins with hash fallback for unpinned names.

    Lets a pipeline keep hot co-queried arrays on one shard (affinity)
    while everything else spreads by hash.
    """

    def __init__(self, n_shards: int, assign: dict[str, int] | None = None):
        super().__init__(n_shards)
        self.assign: dict[str, int] = {}
        for name, shard in (assign or {}).items():
            self.pin(name, shard)

    def pin(self, name: str, shard: int) -> None:
        if not 0 <= shard < self.n_shards:
            raise ValueError(f"shard {shard} out of range 0..{self.n_shards - 1}")
        self.assign[_base_name(name)] = int(shard)

    def shard_of(self, name: str) -> int:
        base = _base_name(name)
        if base in self.assign:
            return self.assign[base]
        return zlib.crc32(base.encode()) % self.n_shards

    def to_manifest(self) -> dict:
        return {
            "kind": "affinity",
            "n_shards": self.n_shards,
            "assign": dict(self.assign),
        }


# --------------------------------------------------------------------------- #
# Partitioned lineage DAG
# --------------------------------------------------------------------------- #
class ShardedLineageGraph:
    """Lineage DAG partitioned across shards.

    Keeps the global :class:`LineageGraph` (cycle checks and routing need
    whole-DAG reachability), one per-shard graph holding the edges each
    shard stores, and an explicit boundary table for edges whose src and
    dst arrays live on different shards.  Entries are owned by their *dst*
    array's shard.
    """

    def __init__(self, n_shards: int):
        self.n_shards = int(n_shards)
        self.global_graph = LineageGraph()
        self.shard_graphs = [LineageGraph() for _ in range(self.n_shards)]
        # lineage_id -> (src, dst, src_shard, dst_shard), cross-shard only
        self.boundary: dict[int, tuple[str, str, int, int]] = {}

    def add_edge(
        self, src: str, dst: str, lineage_id: int, src_shard: int, dst_shard: int
    ) -> None:
        """Record one entry; raises :class:`CycleError` (mutating nothing)
        when the edge would close a cycle anywhere in the global DAG."""
        self.global_graph.add_edge(src, dst, lineage_id)
        self.shard_graphs[dst_shard].add_edge(src, dst, lineage_id)
        if src_shard != dst_shard:
            self.boundary[lineage_id] = (src, dst, src_shard, dst_shard)

    def remove_edge(
        self, src: str, dst: str, lineage_id: int, src_shard: int, dst_shard: int
    ) -> None:
        self.global_graph.remove_edge(src, dst, lineage_id)
        self.shard_graphs[dst_shard].remove_edge(src, dst, lineage_id)
        self.boundary.pop(lineage_id, None)

    def shard_graph(self, shard: int) -> LineageGraph:
        return self.shard_graphs[shard]

    def is_boundary(self, lineage_id: int) -> bool:
        return lineage_id in self.boundary

    def boundary_edges(self) -> list[tuple[int, str, str, int, int]]:
        """Explicit boundary-edge table, ordered by lineage id."""
        return [
            (lid, src, dst, s, d)
            for lid, (src, dst, s, d) in sorted(self.boundary.items())
        ]

    def n_edges(self) -> int:
        return self.global_graph.n_edges()


# --------------------------------------------------------------------------- #
# Cross-shard query plans
# --------------------------------------------------------------------------- #
@dataclass
class ExchangeStep:
    """One frontier shipment across a shard boundary.

    ``side`` is "input" when a step's frontier array lives on a different
    shard than the entry executing the hop, "output" when the produced
    array does.  ``est_boxes``/``est_cost`` come from the planner;
    ``shipped_boxes`` is filled during execution.
    """

    array: str
    u: str  # plan-node key the consuming step reads from
    v: str  # plan-node key the step produces
    side: str  # "input" | "output"
    from_shard: int
    to_shard: int
    est_boxes: float = 1.0
    est_cost: float = 0.0
    shipped_boxes: int = 0


@dataclass
class ShardedQueryPlan(QueryPlan):
    """A :class:`QueryPlan` decomposed across shards.

    Every edge step carries an owning shard (``step_shard``); boundary
    crossings become explicit :class:`ExchangeStep`s whose cost is part of
    ``est_cost``.  :meth:`sub_plans` gives the per-shard view — the steps
    each shard executes locally, stitched back together by the exchanges.
    """

    node_shard: dict[str, int] = field(default_factory=dict)
    step_shard: dict[tuple[str, str], int] = field(default_factory=dict)
    exchanges: list[ExchangeStep] = field(default_factory=list)

    def __post_init__(self) -> None:
        self._ex_index: dict[tuple[str, str, str], ExchangeStep] = {}

    def add_exchange(self, ex: ExchangeStep) -> None:
        self.exchanges.append(ex)
        self._ex_index[(ex.u, ex.v, ex.side)] = ex
        self.est_cost += ex.est_cost

    def exchange_for(self, u: str, v: str, side: str) -> ExchangeStep | None:
        return self._ex_index.get((u, v, side))

    def shards_touched(self) -> list[int]:
        touched = set(self.step_shard.values())
        touched.update(self.node_shard[k] for k in self.starts)
        return sorted(touched)

    def sub_plans(self) -> dict[int, QueryPlan]:
        """Per-shard sub-plan views (local steps in global plan order)."""
        out: dict[int, QueryPlan] = {}
        for shard in self.shards_touched():
            steps: dict[str, list[EdgeStep]] = {}
            nodes: set[str] = set()
            for key, step_list in self.steps.items():
                local = [
                    s for s in step_list if self.step_shard[(s.u, s.v)] == shard
                ]
                if local:
                    steps[key] = local
                    nodes.add(key)
                    nodes.update(s.u for s in local)
            nodes.update(k for k in self.starts if self.node_shard[k] == shard)
            order = [k for k in self.order if k in nodes]
            cost = sum(
                c.est_cost for sl in steps.values() for s in sl for c in s.choices
            )
            out[shard] = QueryPlan(
                direction=self.direction,
                starts=tuple(k for k in self.starts if k in nodes),
                target_keys={
                    n: k for n, k in self.target_keys.items() if k in nodes
                },
                order=order,
                node_array={k: self.node_array[k] for k in order},
                steps=steps,
                est_cost=cost,
                est_boxes={k: self.est_boxes.get(k, 1.0) for k in order},
            )
        return out

    def describe(self, analyze: bool = False) -> str:
        """EXPLAIN output: per-hop lines tagged with shards, then exchanges.

        ``analyze=True`` adds the measured side per hop choice (see
        :meth:`QueryPlan.describe`) and measured shipped box counts per
        exchange.
        """
        header = (
            f"sharded {self.direction} plan, {len(self.order)} nodes, "
            f"shards={self.shards_touched()}, est_cost={self.est_cost:.0f}"
        )
        if analyze:
            exec_ms = self.measured.get("__exec_ms__")
            if exec_ms is not None:
                header += (
                    f", measured exec={exec_ms[0]:.3f}ms"
                    f" over {exec_ms[1]} dispatches"
                )
        lines = [header]
        for key in self.order:
            for step in self.steps.get(key, []):
                opts = ", ".join(
                    f"{_fmt_lid(c.lineage_id)}:{c.stored}/"
                    f"{'nat' if c.frontier_on == 'key' else 'inv'}/"
                    f"{c.describe_route()}"
                    for c in step.choices
                )
                shard = self.step_shard[(step.u, step.v)]
                lines.append(
                    f"  [s{shard}] {self.node_array[step.u]} -> "
                    f"{self.node_array[step.v]}  [{opts}]"
                )
                if analyze:
                    for c in step.choices:
                        lines.append(self._analyze_line(step, c))
        for ex in self.exchanges:
            line = (
                f"  exchange {ex.array!r} ({ex.side}) s{ex.from_shard} -> "
                f"s{ex.to_shard}  est_boxes={ex.est_boxes:.0f}"
            )
            if analyze:
                line += f" | measured shipped={ex.shipped_boxes}"
            lines.append(line)
        return "\n".join(lines)


class ShardedQueryPlanner(QueryPlanner):
    """Plan over the global DAG, execute per shard with boundary exchanges.

    Routing, materialization choice, and per-hop costing are inherited from
    :class:`QueryPlanner` (run against the facade's global graph and lazy
    entry view); this subclass decomposes the result by owning shard, adds
    the cross-shard exchange cost term, and meters the frontiers that
    actually cross boundaries at execution time.
    """

    def plan(
        self, sources, targets, frontier=None, batched=None
    ) -> ShardedQueryPlan:
        return self._shardify(
            QueryPlanner.plan(self, sources, targets, frontier, batched)
        )

    def plan_path(self, path, frontier=None, batched=None) -> ShardedQueryPlan:
        return self._shardify(
            QueryPlanner.plan_path(self, path, frontier, batched)
        )

    # ------------------------------------------------------------------ #
    def _shardify(self, base: QueryPlan) -> ShardedQueryPlan:
        log: "ShardedDSLog" = self.log
        plan = ShardedQueryPlan(
            direction=base.direction,
            starts=base.starts,
            target_keys=base.target_keys,
            order=base.order,
            node_array=base.node_array,
            steps=base.steps,
            est_cost=base.est_cost,
            est_boxes=base.est_boxes,
        )
        for key in plan.order:
            plan.node_shard[key] = log.shard_of_array(plan.node_array[key])
        for key, step_list in plan.steps.items():
            for step in step_list:
                # entries between one array pair share a dst, hence a shard
                if step.choices and step.choices[0].lineage_id < 0:
                    # whole-route view: lives on the root facade; run it on
                    # the frontier node's shard so no exchange is charged
                    owner = plan.node_shard[step.u]
                elif step.choices:
                    owner = log.owner_shard(step.choices[0].lineage_id)
                else:
                    owner = plan.node_shard[key]
                plan.step_shard[(step.u, step.v)] = owner
                if plan.node_shard[step.u] != owner:
                    nb = max(1.0, plan.est_boxes.get(step.u, 1.0))
                    plan.add_exchange(
                        ExchangeStep(
                            plan.node_array[step.u],
                            step.u,
                            step.v,
                            "input",
                            plan.node_shard[step.u],
                            owner,
                            nb,
                            _EXCHANGE_WEIGHT * nb,
                        )
                    )
                if plan.node_shard[step.v] != owner:
                    nb = max(1.0, step.est_pairs * _MERGE_SHRINK)
                    plan.add_exchange(
                        ExchangeStep(
                            plan.node_array[step.v],
                            step.u,
                            step.v,
                            "output",
                            owner,
                            plan.node_shard[step.v],
                            nb,
                            _EXCHANGE_WEIGHT * nb,
                        )
                    )
        return plan

    # ------------------------------------------------------------------ #
    # execution hooks: meter (and compress) boundary-crossing frontiers
    # ------------------------------------------------------------------ #
    def _incoming_frontier(self, plan, step, qs):
        if not isinstance(plan, ShardedQueryPlan):
            return qs
        ex = plan.exchange_for(step.u, step.v, "input")
        if ex is None:
            return qs
        with obs_trace.span("shard.exchange", "shard"):
            shipped = [merge_boxes(q) for q in qs]  # prune before crossing
            n = sum(q.n_rows for q in shipped)
            with self.log._stats_lock:  # parallel sub-plans meter concurrently
                ex.shipped_boxes += n
            self.log._bump("boxes_exchanged", n)
            self._meter_exchange(ex, n)
        return shipped

    def _record_step_output(self, plan, step, res_list):
        if not isinstance(plan, ShardedQueryPlan):
            return
        ex = plan.exchange_for(step.u, step.v, "output")
        if ex is None:
            return
        with obs_trace.span("shard.exchange", "shard"):
            n = sum(r.n_rows for r in res_list)
            with self.log._stats_lock:
                ex.shipped_boxes += n
            self.log._bump("boxes_exchanged", n)
            self._meter_exchange(ex, n)

    def _meter_exchange(self, ex: ExchangeStep, n: int) -> None:
        """Per-shard-pair exchange volume + trace event (outside locks)."""
        self.log.metrics.inc(
            "exchange_boxes",
            n,
            from_shard=str(ex.from_shard),
            to_shard=str(ex.to_shard),
        )
        tr = obs_trace.active()
        if tr is not None:
            tr.event(
                "exchange",
                kind="exchange",
                array=ex.array,
                side=ex.side,
                from_shard=ex.from_shard,
                to_shard=ex.to_shard,
                boxes=n,
            )


# --------------------------------------------------------------------------- #
# The sharded store facade
# --------------------------------------------------------------------------- #
class _ShardedLineageView(Mapping):
    """Read-only ``lineage_id -> LineageEntry`` view across all shards.

    Resolving an id loads its owning shard's manifest (not its blobs) on
    first touch — the mechanism behind lazy shard loading.
    """

    def __init__(self, log: "ShardedDSLog"):
        self._log = log

    def __getitem__(self, lineage_id: int):
        shard = self._log.owner_shard(lineage_id)
        return self._log.shard(shard).lineage[lineage_id]

    def __iter__(self):
        return iter(self._log._lid_shard)

    def __len__(self) -> int:
        return len(self._log._lid_shard)


class ShardedDSLog:
    """N independent DSLog shards behind the single-store interface.

    ``N=1`` is the single-store special case: same planner decisions, same
    query bytes, one shard manifest under the root.  The shard of every
    array comes from ``policy`` (sticky: recorded in the root manifest so a
    later policy change cannot orphan existing data); a lineage entry is
    stored in its dst array's shard.  Lineage ids stay globally unique.

    ``device`` is every shard's (see :class:`DSLog`): ``"cuda"`` (the
    default) raises at construction when CUDA is not available; ``"cpu"``
    runs the plain CPU paths.
    """

    def __init__(
        self,
        n_shards: int = 1,
        root: str | None = None,
        policy: ShardPolicy | None = None,
        store_forward: bool = True,
        compress_method: str = "auto",
        reuse_m: int = 1,
        gzip: bool = True,
        hop_decay: float = _DEFAULT_HOP_DECAY,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.policy = policy if policy is not None else HashShardPolicy(n_shards)
        self.n_shards = self.policy.n_shards
        self.root = root
        self.store_forward = store_forward
        self.compress_method = compress_method
        self.reuse_m = reuse_m
        self.gzip = gzip
        self.hop_decay = float(hop_decay)
        self.arrays: dict[str, ArrayDef] = {}
        self.sgraph = ShardedLineageGraph(self.n_shards)
        self.by_pair: dict[tuple[str, str], list[int]] = {}
        self.ops: list[_OpRecord] = []
        self.predictor = ReusePredictor(m=reuse_m)
        self.planner = ShardedQueryPlanner(self)
        # whole-route views + answer cache live on the root facade (routes
        # cross shard boundaries); shard-level managers stay empty
        self.views = ViewManager(self)
        # facade-level geometry table: the cross-shard planner's executor
        # packs frontiers spanning shards, so tuning lives on the root
        self.autotune = GeometryTuner()
        self.lineage = _ShardedLineageView(self)
        self._next_id = 0
        # per-shard id streams: lineage_id = shard + n_shards * counter, so
        # concurrent writers leasing disjoint shards mint disjoint ids
        self._shard_next: list[int] = [0] * self.n_shards
        self._versions: dict[str, int] = {}
        self._array_shard: dict[str, int] = {}
        self._lid_shard: dict[int, int] = {}
        self._stats_lock = _locks.new_rlock("shard._stats_lock")
        # guards lazy shard loading: parallel plan execution may race two
        # worker threads onto the same cold shard
        self._shard_load_lock = _locks.new_lock("shard._shard_load_lock")
        self._shards: list[DSLog | None] = _locks.guard_sequence(
            [None] * self.n_shards, self._shard_load_lock, "ShardedDSLog._shards"
        )
        self._predictor_chunk: dict | None = None
        self._meta_dirty = False
        # facade-level telemetry: facade-minted counters (exchanges, shard
        # loads, query latency) live here; io_stats / metrics_snapshot()
        # aggregate this registry with every loaded shard's by key union.
        self.metrics = MetricsRegistry("dslog-root")
        self.metrics.seed_counters(SEED_COUNTERS)
        self.metrics.seed_counters(("shards_loaded", "boxes_exchanged"))
        self.metrics.register_collector(self._collect_gauges)
        # durability subsystem (attached by open(); see DSLog for the
        # single-store equivalent).  _exclusive=False is writer mode: this
        # process appends to shard WALs under per-shard leases and never
        # rewrites manifests — the next exclusive open folds the logs in.
        self._wal: WriteAheadLog | None = None  # the root log
        self._pipeline: CommitPipeline | None = None
        self._root_lease: WriterLease | None = None
        self._presence_lease: WriterLease | None = None  # writer-mode marker
        self._shard_leases: dict[int, WriterLease] = {}
        self._exclusive = True
        self._wal_lsn = 0
        self._replaying = False
        self._closed = False
        if root:
            os.makedirs(root, exist_ok=True)

    # -- single-store machinery reused verbatim over sharded storage ----- #
    add_lineage = DSLog.add_lineage
    register_operation = DSLog.register_operation
    _rollback_op = DSLog._rollback_op
    _derive_forward = DSLog._derive_forward
    _serialize = DSLog._serialize
    _check_shapes = DSLog._check_shapes
    prov_query = DSLog.prov_query
    prov_query_batch = DSLog.prov_query_batch
    _query_batch_impl = DSLog._query_batch_impl
    _as_boxes = DSLog._as_boxes
    _parse_query_args = staticmethod(DSLog._parse_query_args)
    version = DSLog.version
    latest_version = DSLog.latest_version
    storage_bytes = DSLog.storage_bytes
    _write_predictor = DSLog._write_predictor
    _wal_emit = DSLog._wal_emit
    _wal_append_root = DSLog._wal_append_root
    _op_wal_meta = staticmethod(DSLog._op_wal_meta)
    __enter__ = DSLog.__enter__
    __exit__ = DSLog.__exit__

    # ------------------------------------------------------------------ #
    @property
    def graph(self) -> LineageGraph:
        """Global DAG view (the planner routes over this)."""
        return self.sgraph.global_graph

    def shard_of_array(self, name: str) -> int:
        """Sticky shard assignment: policy decides once, then it's recorded."""
        shard = self._array_shard.get(name)
        if shard is None:
            shard = self.policy.shard_of(name) % self.n_shards
            self._array_shard[name] = shard
        return shard

    def owner_shard(self, lineage_id: int) -> int:
        return self._lid_shard[lineage_id]

    def _shard_dir(self, shard: int) -> str | None:
        if self.root is None:
            return None
        return os.path.join(self.root, f"shard_{shard:02d}")

    def shard(self, shard: int) -> DSLog:
        """The shard's DSLog, loading its manifest lazily on first touch.

        Loading also replays the shard's WAL tail (``DSLog.load`` handles
        the truncation of torn records) and *absorbs* any replayed entries
        into the facade's topology — the root manifest has not seen them
        yet, only the log has.
        """
        sh = self._shards[shard]
        if sh is not None:
            return sh
        with self._shard_load_lock:  # parallel execution races cold shards
            sh = self._shards[shard]
            if sh is not None:
                return sh
            sub = self._shard_dir(shard)
            has_manifest = sub is not None and os.path.exists(
                os.path.join(sub, "catalog.json")
            )
            has_wal = sub is not None and os.path.exists(
                os.path.join(sub, WAL_FILENAME)
            )
            if has_manifest or has_wal:
                # lazy shard materialisation deliberately does recovery
                # I/O (WAL flock/replay, lease rename) under the load
                # lock: it is a single-fire latch, and publishing a
                # half-recovered shard would be worse.  The shard→shard
                # self-edge is a borrowed-method over-approximation: a
                # sub-log's replay never dispatches back via the facade.
                # dsflow: ignore[lock-fsync,lock-order,wal-lease]
                sh = DSLog.load(sub, device=self.device)
                sh.store_forward = self.store_forward
                sh.compress_method = self.compress_method
                sh.gzip = self.gzip
                sh.hop_decay = self.hop_decay
                self._bump("shards_loaded")
            else:
                sh = DSLog(
                    root=sub,
                    store_forward=self.store_forward,
                    compress_method=self.compress_method,
                    reuse_m=self.reuse_m,
                    gzip=self.gzip,
                    hop_decay=self.hop_decay,
                    device=self.device,
                )
            if self._pipeline is not None and sub is not None:
                if sh._wal is None:
                    # same latch: attaching the WAL acquires the shard
                    # lease (rename) and must finish before publication
                    # dsflow: ignore[lock-fsync,lock-order]
                    sh._attach_wal(self._pipeline)
                else:
                    sh._pipeline = self._pipeline
                    self._pipeline.attach(sh._wal)
            self._absorb_shard_entries(shard, sh)
            self._shards[shard] = sh
        return sh

    def _absorb_shard_entries(self, shard: int, sh: DSLog) -> None:
        """Fold entries the shard knows but the facade does not (WAL-replayed
        tail past the root manifest) into the global topology."""
        fresh = [lid for lid in sh.lineage if lid not in self._lid_shard]
        for lid in sorted(fresh):
            e = sh.lineage[lid]
            self._shard_next[shard] = max(
                self._shard_next[shard], lid // self.n_shards + 1
            )
            self._next_id = max(self._next_id, lid + 1)
            for name in (e.src, e.dst):
                if name not in self.arrays and name in sh.arrays:
                    self.arrays[name] = ArrayDef(name, sh.arrays[name].shape)
            self._array_shard.setdefault(e.dst, shard)
            src_shard = self.shard_of_array(e.src)
            try:
                self.sgraph.add_edge(e.src, e.dst, lid, src_shard, shard)
            except CycleError:
                # concurrent writers each passed their *local* cycle check
                # but jointly closed a cross-shard cycle; recovery must not
                # wedge the store — quarantine the later entry instead
                sh._remove_entry(lid)
                sh._persisted.pop(lid, None)
                self._meta_dirty = True
                continue
            self.by_pair.setdefault((e.src, e.dst), []).append(lid)
            self._lid_shard[lid] = shard
            self._meta_dirty = True
            # a recovered entry is new topology as far as the root knows:
            # views/answers spanning this edge's route are stale
            self.views.on_new_edge(e.src, e.dst)
        # dirty/mutation records replayed inside the shard's own log fired
        # that shard's (inert) ViewManager — mirror the precise
        # invalidation here, where the cross-shard views actually live
        for lid in sorted(sh._dirty):
            self.views.on_mutation(lid)

    def _ensure_shard_lease(self, shard: int) -> None:
        """Writer mode: take the shard's writer lease before the first
        mutation lands there (one concurrent writer per shard)."""
        if self.root is None or shard in self._shard_leases:
            return
        if WriterLease.held(self.root):
            raise LeaseHeldError(
                f"store {self.root!r} is open exclusively; writer-mode "
                "ingest must wait for the exclusive owner to close"
            )
        sub = self._shard_dir(shard)
        assert sub is not None
        self._shard_leases[shard] = WriterLease.acquire(
            sub, what=f"shard {shard} of"
        )
        sh = self._shards[shard]
        if sh is not None and sh._wal is not None:
            sh._wal.repair()  # now the leased owner of this shard's log

    def loaded_shards(self) -> list[int]:
        return [k for k, sh in enumerate(self._shards) if sh is not None]

    def _bump(self, key: str, n: int = 1) -> None:
        self.metrics.inc(key, n)

    def _collect_gauges(self):
        """Facade snapshot-time gauges: view-manager state (the cross-shard
        views live here; per-shard hop gauges ride the shard registries)."""
        try:
            vstats = self.views.stats()
        except Exception:
            return
        for name, val in vstats.items():
            if isinstance(val, (int, float)):
                yield (f"views_{name}", {}, val)

    @property
    def io_stats(self) -> dict[str, int]:
        """Aggregated I/O counters: facade-level plus every loaded shard.

        Aggregation is by *key union* over the facade registry and every
        loaded shard's counters — a counter a shard mints after this
        facade was built (or one only some shards know) still shows up.
        """
        total = self.metrics.counters_flat()
        for sh in self._shards:
            if sh is None:
                continue
            for key, val in sh.io_stats.items():
                total[key] = total.get(key, 0) + val
        return total

    def metrics_snapshot(self) -> dict:
        """Merged telemetry: the facade registry plus every loaded shard's,
        unioned by (instrument, labels) — histograms and labeled series
        aggregate the same way ``io_stats`` unions counters."""
        snaps = [self.metrics.snapshot()]
        snaps.extend(
            sh.metrics.snapshot() for sh in self._shards if sh is not None
        )
        return MetricsRegistry.merge_snapshots(snaps, name="dslog-root")

    def health(self, run_fsck: bool = True) -> dict:
        """Registry red-flags + ``fsck`` findings (``repro_torch.obs.export``)."""
        from repro_torch.obs.export import health as _health

        return _health(self, run_fsck=run_fsck)

    @property
    def dirty(self) -> bool:
        return (
            self._meta_dirty
            or self.predictor.dirty
            or self.views.dirty
            or any(sh is not None and sh.dirty for sh in self._shards)
        )

    # ------------------------------------------------------------------ #
    # Array / lineage definition (routes through the policy)
    # ------------------------------------------------------------------ #
    def define_array(self, name: str, shape: tuple[int, ...]) -> ArrayDef:
        arr = ArrayDef(name, tuple(int(d) for d in shape))
        self.arrays[name] = arr
        self.shard_of_array(name)
        self._meta_dirty = True
        self._wal_append_root("array", {"name": name, "shape": list(arr.shape)})
        return arr

    def _insert_entry(
        self,
        src: str,
        dst: str,
        bwd: CompressedTable,
        fwd: CompressedTable | None,
        op_name: str | None,
        reused_from: str | None = None,
    ):
        src_shard = self.shard_of_array(src)
        dst_shard = self.shard_of_array(dst)
        if not self._exclusive:
            self._ensure_shard_lease(dst_shard)
        # per-shard id stream: with one (leased) writer per shard these
        # never collide, even across concurrent writer processes
        counter = self._shard_next[dst_shard]
        lineage_id = dst_shard + self.n_shards * counter
        # global cycle check first; a rejected edge leaves everything intact
        self.sgraph.add_edge(src, dst, lineage_id, src_shard, dst_shard)
        sh = self.shard(dst_shard)
        for name in (src, dst):
            arr = self.arrays.get(name)
            if arr is not None:
                sh.arrays.setdefault(name, ArrayDef(name, arr.shape))
        sh._next_id = lineage_id  # shards mint from the facade's id space
        try:
            entry = sh._insert_entry(src, dst, bwd, fwd, op_name, reused_from)
        except CycleError:  # pragma: no cover - global check already passed
            self.sgraph.remove_edge(src, dst, lineage_id, src_shard, dst_shard)
            raise
        self._shard_next[dst_shard] = counter + 1
        self._next_id = max(self._next_id, lineage_id + 1)
        self.by_pair.setdefault((src, dst), []).append(lineage_id)
        self._lid_shard[lineage_id] = dst_shard
        self._meta_dirty = True
        self.views.on_new_edge(src, dst)
        return entry

    def _remove_entry(self, lineage_id: int) -> None:
        dst_shard = self._lid_shard.pop(lineage_id)
        sh = self.shard(dst_shard)
        e = sh.lineage[lineage_id]
        sh._remove_entry(lineage_id)
        self.sgraph.remove_edge(
            e.src, e.dst, lineage_id, self.shard_of_array(e.src), dst_shard
        )
        ids = self.by_pair[(e.src, e.dst)]
        ids.remove(lineage_id)
        if not ids:
            del self.by_pair[(e.src, e.dst)]
        self._meta_dirty = True

    def drop_lineage(self, lineage_id: int) -> None:
        """Remove one entry; its blobs are vacuumed by :meth:`compact`."""
        if lineage_id not in self._lid_shard:
            raise KeyError(f"no lineage entry {lineage_id}")
        shard = self._lid_shard[lineage_id]
        self._remove_entry(lineage_id)
        sh = self.shard(shard)
        sh._persisted.pop(lineage_id, None)
        sh._drop_hop_stats(lineage_id)
        self.views.on_mutation(lineage_id)
        for op in self.ops:
            if lineage_id in op.lineage_ids:
                op.lineage_ids.remove(lineage_id)
        self._wal_append_root("drop", {"id": lineage_id})

    def mark_dirty(self, lineage_id: int) -> None:
        """Declare an entry's tables mutated in place (see
        :meth:`DSLog.mark_dirty`); the invalidation record lands in the
        owning shard's WAL."""
        if lineage_id not in self._lid_shard:
            raise KeyError(f"no lineage entry {lineage_id}")
        shard = self.owner_shard(lineage_id)
        if not self._exclusive:
            self._ensure_shard_lease(shard)
        self.shard(shard).mark_dirty(lineage_id)
        # the record lands in the shard WAL, but whole-route views and
        # cached answers live on the root — invalidate across the boundary
        self.views.on_mutation(lineage_id)

    # ------------------------------------------------------------------ #
    # Planner cost-model feedback routes to the owning shard
    # ------------------------------------------------------------------ #
    def record_hop(
        self,
        lineage_id: int,
        stored: str,
        frontier_on: str,
        pairs: int,
        qrows: int,
    ) -> None:
        if lineage_id < 0:  # view hop: owned by the root's ViewManager
            return self.views.record_hop(
                lineage_id, stored, frontier_on, pairs, qrows
            )
        self.shard(self.owner_shard(lineage_id)).record_hop(
            lineage_id, stored, frontier_on, pairs, qrows
        )

    def hop_measurement(
        self, lineage_id: int, stored: str, frontier_on: str
    ) -> float | None:
        if lineage_id < 0:
            return self.views.hop_measurement(lineage_id, stored, frontier_on)
        return self.shard(self.owner_shard(lineage_id)).hop_measurement(
            lineage_id, stored, frontier_on
        )

    # ------------------------------------------------------------------ #
    # Durable concurrent ingest: leases, WALs, recovery (see DSLog.open)
    # ------------------------------------------------------------------ #
    @classmethod
    def open(
        cls,
        root: str,
        n_shards: int = 1,
        *,
        exclusive: bool = True,
        durability: str = "group",
        flush_interval: float = 0.005,
        max_batch: int = 256,
        lease_ttl: float = 300.0,
        policy: ShardPolicy | None = None,
        device="cuda",
        **ctor_kw,
    ) -> "ShardedDSLog":
        """Open a sharded root durably, as one of two kinds of writer.

        **Exclusive** (default): takes the root writer lock — refusing to
        open while any live writer (root or shard) exists — recovers every
        log tail, and may checkpoint (``save()``/``close()`` fold the WALs
        into the manifests).  A store that does not exist yet is created
        and its initial root manifest written immediately.

        **Writer mode** (``exclusive=False``): for concurrent ingest.  The
        process appends to the shared root log and to the WALs of shards it
        acquires leases for (taken lazily, on the first write landing on a
        shard) and *never rewrites a manifest* — two writer processes
        ingesting into disjoint shards therefore never contend on shared
        files at all beyond the flock-serialized root log.  Durability is
        the group-committed WAL; the next exclusive open replays and
        checkpoints everything.  Requires an initialized store.

        ``device`` is the store's (see the class doc); it is resolved
        before any lease is taken.
        """
        device = resolve_device(device)
        presence_lease = None
        if exclusive:
            root_lease = WriterLease.acquire(root, ttl=lease_ttl)
            try:
                blockers = sorted(
                    glob.glob(os.path.join(root, "shard_*"))
                ) + sorted(glob.glob(os.path.join(root, "writers", "*")))
                for sub in blockers:
                    if not os.path.isdir(sub):
                        continue
                    if WriterLease.held(sub, lease_ttl):
                        holder = WriterLease.holder(sub)
                        raise LeaseHeldError(
                            f"{sub!r} has a live writer "
                            f"(pid {holder and holder.get('pid')}); "
                            "exclusive open must wait for writers to close"
                        )
                    if os.path.dirname(sub).endswith("writers"):
                        # crashed writer's presence slot: clean it up
                        try:
                            lock = os.path.join(sub, WriterLease.FILENAME)
                            if os.path.exists(lock):
                                os.remove(lock)
                            os.rmdir(sub)
                        except OSError:
                            pass
            except BaseException:
                root_lease.release()
                raise
        else:
            root_lease = None
            if not os.path.exists(os.path.join(root, "catalog.json")):
                raise FileNotFoundError(
                    f"writer-mode open needs an initialized store at "
                    f"{root!r}; create it with ShardedDSLog.open(root, "
                    "n_shards, exclusive=True) first"
                )
            if WriterLease.held(root, lease_ttl):
                raise LeaseHeldError(
                    f"store {root!r} is open exclusively; writer-mode "
                    "ingest must wait for the exclusive owner to close"
                )
            # register presence *before* touching any file, so a racing
            # exclusive open sees this writer even while it is idle (its
            # shard leases are only taken on the first write)
            presence_lease = WriterLease.acquire(
                os.path.join(root, "writers", uuid.uuid4().hex),
                ttl=lease_ttl,
                what="writer slot of",
            )
            if WriterLease.held(root, lease_ttl):  # exclusive won the race
                presence_lease.release()
                raise LeaseHeldError(
                    f"store {root!r} is open exclusively; writer-mode "
                    "ingest must wait for the exclusive owner to close"
                )
        try:
            pipeline = CommitPipeline(durability, flush_interval, max_batch)
            if os.path.exists(os.path.join(root, "catalog.json")):
                log = cls.load(root, pipeline=pipeline, device=device)
                _apply_open_overrides(log, ctor_kw)
            else:
                log = cls(
                    n_shards=n_shards, root=root, policy=policy, device=device,
                    **ctor_kw,
                )
                log._pipeline = pipeline
            log._exclusive = exclusive
            log._root_lease = root_lease
            log._presence_lease = presence_lease
            # the pipeline predates the store object: retarget its
            # instruments at the facade registry (interim counts carry over)
            pipeline.bind_metrics(log.metrics)
            if log._wal is None:
                log._wal = WriteAheadLog(
                    os.path.join(root, WAL_FILENAME),
                    shared=True,
                    metrics=log.metrics,
                )
            pipeline.attach(log._wal)
            if exclusive:
                # sole owner (root lock held, no live writers): torn tails
                # may be physically cut from every log we recovered
                log._wal.repair()
                for sh in log._shards:
                    if sh is not None and sh._wal is not None:
                        sh._wal.repair()
                if not os.path.exists(os.path.join(root, "catalog.json")):
                    log.save()  # initial manifest: writer mode needs it
            return log
        except BaseException:
            if root_lease is not None:
                root_lease.release()
            if presence_lease is not None:
                presence_lease.release()
            raise

    def close(self, checkpoint: bool = True) -> None:
        """Flush, checkpoint when allowed, release every lease (idempotent).

        An exclusive owner checkpoints (manifests rewritten, logs
        truncated) unless ``checkpoint=False``; a writer-mode process only
        flushes its logs — its work becomes manifest state at the next
        exclusive open.  A store that was merely ``load()``-ed (no root
        lock held) never checkpoints on close: truncating logs without the
        locks could destroy a live writer's records.
        """
        if self._closed:
            return
        self._closed = True
        try:
            if self._pipeline is not None:
                self._pipeline.commit()
            if (
                checkpoint
                and self._exclusive
                and self.root
                and self._root_lease is not None
            ):
                self.save()
        finally:
            if self._pipeline is not None:
                self._pipeline.close()
            if self._wal is not None:
                self._wal.close()
                self._wal = None
            for sh in self._shards:
                if sh is not None and sh._wal is not None:
                    sh._wal.close()
                    sh._wal = None
            for lease in self._shard_leases.values():
                lease.release()
            self._shard_leases.clear()
            if self._presence_lease is not None:
                slot = os.path.dirname(self._presence_lease.path)
                self._presence_lease.release()
                self._presence_lease = None
                try:
                    os.rmdir(slot)
                except OSError:
                    pass
            if self._root_lease is not None:
                self._root_lease.release()
                self._root_lease = None

    def commit(self) -> None:
        """Durability barrier over the root log and every shard log."""
        if self._pipeline is not None:
            self._pipeline.commit()
        else:
            for wal in [self._wal] + [
                sh._wal for sh in self._shards if sh is not None
            ]:
                if wal is not None:
                    wal.flush(sync=True)

    def checkpoint(self) -> None:
        """Exclusive-mode checkpoint: incremental save + log truncation."""
        self.save()

    # ------------------------------------------------------------------ #
    # Persistence: root manifest + independently saved shard manifests
    # ------------------------------------------------------------------ #
    def save(self) -> None:
        """Save dirty shards and (when needed) the root manifest.

        Each shard's DSLog dirty-tracks its own entries, so only shards
        that changed since the last save write anything — manifests
        included.  The root manifest (policy, array→shard map, topology,
        boundary table, ops, predictor) rewrites only when facade-level
        state changed.  When WALs are attached this is the **checkpoint**:
        every saved log is truncated after its manifest records the
        checkpoint LSN.  Writer-mode stores must not call this — their
        manifests belong to the next exclusive owner.
        """
        if not self.root:
            raise ValueError("ShardedDSLog opened without a root directory")
        if not self._exclusive:
            raise RuntimeError(
                "writer-mode store persists through its WALs; manifests are "
                "rewritten by the next exclusive open/close"
            )
        # Phase 1: shard manifests, WAL truncation DEFERRED — a crash
        # before the root manifest lands must leave the shard logs
        # replayable, or the new cross-shard topology would be lost.
        saved_shards: list[DSLog] = []
        for sh in self._shards:
            if sh is not None and (
                sh.dirty or (sh._wal is not None and sh._wal.has_records)
            ):
                sh.save(checkpoint_wal=False)
                saved_shards.append(sh)
        # write-only telemetry sidecar (facade + loaded shards merged);
        # refreshed on every checkpoint, never read back by load()
        _atomic_write(
            os.path.join(self.root, "telemetry.json"),
            json.dumps(telemetry_snapshot(self)),
        )
        manifest = os.path.join(self.root, "catalog.json")
        if not (
            self._meta_dirty
            or self.predictor.dirty
            or self.views.dirty
            or self._predictor_chunk is None
            or (self._wal is not None and self._wal.has_records)
            or not os.path.exists(manifest)
        ):
            # no root rewrite needed (nothing topology-level changed, so
            # the shard logs held no entries the root does not know)
            if self._root_lease is not None:
                self._checkpoint_shard_wals(saved_shards)
            return
        if self._predictor_chunk is None or self.predictor.dirty:
            self._predictor_chunk = self._write_predictor()
        edges = [
            [src, dst, lid, self._lid_shard[lid]]
            for (src, dst), ids in self.by_pair.items()
            for lid in ids
        ]
        meta = {
            "version": _ROOT_MANIFEST_VERSION,
            "sharded": True,
            "n_shards": self.n_shards,
            "policy": self.policy.to_manifest(),
            "arrays": {
                n: {"shape": list(a.shape), "shard": self.shard_of_array(n)}
                for n, a in self.arrays.items()
            },
            "edges": edges,
            "boundary": [list(rec) for rec in self.sgraph.boundary_edges()],
            "next_id": self._next_id,
            "shard_next": list(self._shard_next),
            "versions": dict(self._versions),
            "hop_decay": self.hop_decay,
            "ops": [
                {
                    "op": op.op_name,
                    "in": list(op.in_arrs),
                    "out": list(op.out_arrs),
                    "args": _json_safe(op.op_args),
                    "lineage_ids": list(op.lineage_ids),
                    "reused": op.reused,
                }
                for op in self.ops
            ],
            "predictor": self._predictor_chunk,
        }
        if self._wal is not None:
            self.commit()
            meta["wal_lsn"] = self._wal.end_lsn
        # whole-route views live on the root: their routes cross shard
        # boundaries, so only the facade sees every invalidation source
        meta["views"] = self.views.manifest_chunk(self._write_view_blob)
        _atomic_write(
            os.path.join(self.root, "answers.json"),
            json.dumps(self.views.cache_chunk()),
        )
        _atomic_write(
            os.path.join(self.root, "autotune.json"),
            json.dumps(self.autotune.to_manifest()),
        )
        self.autotune.dirty = False
        payload = json.dumps(meta)
        _atomic_write(manifest, payload)
        self._bump("manifests_written")
        self._bump("bytes_written", len(payload))
        self._meta_dirty = False
        # Phase 2: every manifest is durable — now the logs may truncate,
        # but only as the locked owner (a merely load()-ed store saving
        # must not cut logs a live writer may be appending to; replay
        # skips its records via the wal_lsn values just recorded)
        if self._root_lease is not None:
            self._checkpoint_shard_wals(saved_shards)
            if self._wal is not None:
                self._wal_lsn = self._wal.checkpoint()

    @staticmethod
    def _checkpoint_shard_wals(shards: list[DSLog]) -> None:
        for sh in shards:
            if sh._wal is not None:
                sh._wal_lsn = sh._wal.checkpoint()

    # borrowed writer: view blobs land in the root dir next to sig tables
    _write_view_blob = DSLog._write_view_blob

    def _view_lsns(self) -> dict[str, int]:
        """End LSN of every WAL that could invalidate a view: the root log
        plus each shard's — a view's route may span any subset of shards,
        so all logs count.  Unloaded shards are probed by file (cheap frame
        scan) rather than forcing a manifest load.  An in-memory store has
        no WALs: every horizon is 0."""
        if self.root is None:
            return {"root": 0, **{f"shard_{k:02d}": 0 for k in range(self.n_shards)}}
        lsns = {"root": self._wal.end_lsn if self._wal is not None else 0}
        for k in range(self.n_shards):
            sh = self._shards[k]
            if sh is not None and sh._wal is not None:
                end = sh._wal.end_lsn
            else:
                sub = self._shard_dir(k)
                end = (
                    WriteAheadLog.file_end_lsn(os.path.join(sub, WAL_FILENAME))
                    if sub is not None
                    else 0
                )
            lsns[f"shard_{k:02d}"] = end
        return lsns

    def _make_view_handle(self, fn: str, rows) -> TableHandle:
        assert self.root is not None
        root = self.root

        def load() -> CompressedTable:
            with open(os.path.join(root, fn), "rb") as f:
                return CompressedTable.deserialize(f.read())

        return TableHandle(
            load,
            None if rows is None else int(rows),
            lambda: self._bump("tables_loaded"),
        )

    @staticmethod
    def load(
        root: str,
        eager: bool = False,
        pipeline: "CommitPipeline | None" = None,
        device="cuda",
    ) -> "ShardedDSLog":
        """Reopen a sharded root without touching any *clean* shard.

        The root manifest restores the policy, array→shard map, global
        topology (graph + boundary table), ops, version counters, and
        predictor state; each shard's own manifest (and its blobs) resolves
        lazily the first time a plan or query touches that shard —
        ``io_stats["shards_loaded"]`` counts those resolutions.  Pass
        ``eager=True`` to open every shard up front.

        **Crash recovery**: the root log's tail past the manifest's
        checkpoint LSN is replayed (arrays, ops, versions, predictor
        observations, drops), and every shard whose WAL holds records is
        opened eagerly so its entry tail replays and folds back into the
        global topology.  Recovery cost is proportional to the
        un-checkpointed tails, not to the store.

        ``device`` is the store's (see the class doc).
        """
        with open(os.path.join(root, "catalog.json")) as f:
            meta = json.load(f)
        if not meta.get("sharded"):
            raise ValueError(
                f"{root!r} holds a plain DSLog catalog; use DSLog.load"
            )
        policy = ShardPolicy.from_manifest(meta["policy"])
        log = ShardedDSLog(
            n_shards=policy.n_shards, root=root, policy=policy, device=device
        )
        log._pipeline = pipeline
        for name, rec in meta["arrays"].items():
            log.arrays[name] = ArrayDef(name, tuple(rec["shape"]))
            log._array_shard[name] = int(rec["shard"])
        for src, dst, lid, shard in meta["edges"]:
            lid, shard = int(lid), int(shard)
            log.sgraph.add_edge(src, dst, lid, log.shard_of_array(src), shard)
            log.by_pair.setdefault((src, dst), []).append(lid)
            log._lid_shard[lid] = shard
        log._next_id = int(meta["next_id"])
        if "shard_next" in meta:
            log._shard_next = [int(x) for x in meta["shard_next"]]
        else:  # pre-WAL manifest: ids were minted sequentially — start all
            # per-shard streams past the global max so nothing can collide
            base = (log._next_id + log.n_shards - 1) // log.n_shards
            log._shard_next = [base] * log.n_shards
        log._versions = {k: int(v) for k, v in meta.get("versions", {}).items()}
        log.hop_decay = float(meta.get("hop_decay", log.hop_decay))
        for op in meta.get("ops", []):
            log.ops.append(
                _OpRecord(
                    op["op"],
                    tuple(op["in"]),
                    tuple(op["out"]),
                    op["args"],
                    list(op["lineage_ids"]),
                    op["reused"],
                )
            )
        chunk = meta.get("predictor")
        if chunk is not None:

            def load_table(fn: str) -> CompressedTable:
                with open(os.path.join(root, fn), "rb") as f:
                    return CompressedTable.deserialize(f.read())

            log.predictor = ReusePredictor.from_manifest(chunk, load_table)
            log._predictor_chunk = chunk
        log._meta_dirty = False
        log._wal_lsn = int(meta.get("wal_lsn", 0))
        # views + cached answers restore BEFORE WAL replay (root tail and
        # shard tails alike): replayed entry/drop/dirty records then fire
        # the same precise invalidation they did live
        log.views.load_chunk(meta.get("views"), log._make_view_handle)
        answers = os.path.join(root, "answers.json")
        if os.path.exists(answers):
            try:
                with open(answers) as f:
                    log.views.load_cache_chunk(json.load(f))
            except (ValueError, KeyError):
                pass  # torn/stale sidecar: start with a cold cache
        autotune = os.path.join(root, "autotune.json")
        if os.path.exists(autotune):
            try:
                with open(autotune) as f:
                    log.autotune.load_manifest(json.load(f))
            except ValueError:
                pass  # torn sidecar: start with a cold geometry table
        log._recover_wals()
        if eager:
            for k in range(log.n_shards):
                log.shard(k)
        return log

    def _recover_wals(self) -> None:
        """Replay the root-log tail, then every shard whose WAL holds
        records (their entries fold into the topology via ``shard()``)."""
        assert self.root is not None
        drops: list[int] = []
        if os.path.exists(os.path.join(self.root, WAL_FILENAME)):
            self._wal = WriteAheadLog(
                os.path.join(self.root, WAL_FILENAME), shared=True
            )
            if self._pipeline is not None:
                self._pipeline.attach(self._wal)
            replayed = self._wal.recover(self._wal_lsn)
            for rec in replayed:
                self._replay_root_record(rec, drops)
            if replayed:
                self._bump("wal_replayed", len(replayed))
        for k in range(self.n_shards):
            sub = self._shard_dir(k)
            if sub is None:
                continue
            wal_path = os.path.join(sub, WAL_FILENAME)
            if WriteAheadLog.file_has_records(wal_path):
                self.shard(k)  # DSLog.load replays; shard() absorbs
        for lid in drops:
            if lid in self._lid_shard:
                self._replaying = True
                try:
                    self.drop_lineage(lid)
                finally:
                    self._replaying = False

    # store-level branches (array/version/op/obs) shared with DSLog replay
    _replay_store_record = DSLog._replay_store_record

    def _replay_root_record(self, rec, drops: list[int]) -> None:
        """Apply one recovered root-log record (store-level state only;
        entries live in, and replay from, the shard logs).  Drops are
        deferred so they apply after the shard tails are absorbed."""
        if rec.type == "drop":
            drops.append(int(rec.meta["id"]))
            return
        self._replaying = True
        try:
            self._replay_store_record(rec)
        finally:
            self._replaying = False

    def compact(self) -> dict[str, int]:
        """Vacuum every shard independently, plus root-level sig blobs."""
        if not self.root:
            raise ValueError("ShardedDSLog opened without a root directory")
        self.save()
        stats = {"files_removed": 0, "bytes_reclaimed": 0}
        for k in range(self.n_shards):
            sub = self._shard_dir(k)
            if sub is None or not os.path.isdir(sub):
                continue
            # the facade save() already synced dirty shards
            for key, val in self.shard(k).compact(save=False).items():
                stats[key] += val
        # the root dir owns no lineage blobs, only predictor sig tables
        # and materialized-view blobs
        referenced = manifest_referenced_files((), self._predictor_chunk)
        referenced |= self.views.blob_files()
        for key, val in _vacuum_dir(self.root, referenced).items():
            stats[key] += val
        return stats

    # ------------------------------------------------------------------ #
    def __repr__(self) -> str:
        return (
            f"ShardedDSLog(n_shards={self.n_shards}, arrays={len(self.arrays)}, "
            f"entries={len(self._lid_shard)}, "
            f"boundary={len(self.sgraph.boundary)}, "
            f"loaded={self.loaded_shards()})"
        )
