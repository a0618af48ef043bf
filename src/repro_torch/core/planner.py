"""Cost-based multi-hop query planning over the lineage DAG (paper §V, grown).

The port of ``repro.core.planner``; joins run on the store's device
(``DSLog.device``).

The paper's ``prov_query`` walks a user-supplied *path* of arrays.  This
module replaces the hand-spelled path with a plan over the
:class:`~repro_torch.core.graph.LineageGraph`:

1. **Routing** — given source/target endpoint sets, the planner finds the
   sub-DAG of arrays lying on any dataflow path between them (two BFS
   passes, never an exponential path enumeration) and orders it
   topologically, so converging branches of a diamond are *merged* at their
   fan-in array instead of re-walked once per path.
2. **Materialization choice** — per hop and per stored
   :class:`~repro_torch.core.catalog.LineageEntry`, the planner picks the cheapest
   way to execute the θ-join: the table whose *key* side matches the
   frontier (natural join) or the opposite materialization through the
   inverse join, and the indexed vs dense route — reusing the
   :class:`~repro_torch.core.index.IntervalIndex` machinery: a cached index gives
   an exact candidate estimate for the first hop
   (:meth:`~repro_torch.core.index.IntervalIndex.estimate_candidates`); deeper
   hops use the closed-form per-attribute overlap model of
   :func:`~repro_torch.core.index.interval_stats`.
3. **Frontier dedup** — between hops every array's frontier is the
   concatenation of all incoming contributions, deduplicated and coalesced
   with :func:`~repro_torch.core.query.merge_boxes`, so diamond-shaped DAGs do not
   multiply the box count path by path.

Plans cost and execute against *lazy* catalogs: row counts come from the
manifest (``LineageEntry.backward_rows`` / ``forward_rows``) so planning a
query over a freshly loaded store touches no blobs; only the tables on the
chosen hops deserialize, at execution time.

``plan_path`` keeps the paper's explicit-path form alive on the same
executor (one hop per adjacent pair, every stored entry between the pair
contributing), so ``DSLog.prov_query`` serves both forms from one engine.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Iterable, Sequence

import numpy as np

from repro_torch.obs import trace as obs_trace

from .query import (
    DENSE_FRACTION,
    INDEX_MIN_ROWS,
    BatchedJoinExecutor,
    JoinRequest,
    QueryBox,
    canonical_boxes,
    dense_backend,
    merge_boxes,
    theta_join_batch,
    theta_join_inverse_batch,
)

if TYPE_CHECKING:  # pragma: no cover - typing only
    from .catalog import DSLog, LineageEntry

__all__ = ["HopChoice", "EdgeStep", "QueryPlan", "QueryPlanner"]


def _fmt_lid(lineage_id: int) -> str:
    """EXPLAIN label for a hop id: negative ids are materialized views."""
    if lineage_id < 0:
        return f"view#{-lineage_id - 1}"
    return f"#{lineage_id}"

# Cost-model constants (unitless "per candidate pair" work).
_INVERSE_OVERHEAD = 2.0  # inverse join does strictly more per-pair work
_INDEX_BUILD_WEIGHT = 0.25  # amortized first-build cost of an uncached index
_POINT_ROW_COVER = 4.0  # unloaded-table fallback: rows a point probe hits
_MERGE_SHRINK = 0.5  # expected box-count shrink from merge_boxes
# measured per-pair advantage of the packed batched-dense engine over the
# per-hop blocked loop (contiguous int32 columns + one dispatch per
# frontier); makes "batched" competitive where "dense" would lose to the
# index by less than ~2x.  This is the *prior* at perfect tile occupancy —
# the effective discount scales by the executor's measured tile waste
# (scheduled tile cells / useful pair cells), so frontiers whose shape pads
# badly stop looking artificially cheap to the batched route.
_BATCHED_PAIR_DISCOUNT = 0.5


@dataclass
class HopChoice:
    """One executable option for one lineage entry on one hop."""

    lineage_id: int
    stored: str  # "backward" | "forward": which materialization to read
    frontier_on: str  # "key" (natural join) | "value" (inverse join)
    route: str  # "index" | "dense" | "batched" (packed frontier execution)
    est_pairs: float
    est_cost: float
    # dense-route backend annotation ("cuda", "np:cpu", "np:wide", "np:i64")
    # — why a dense hop will or won't ride the kernel; shown by describe()
    note: str = ""

    def describe_route(self) -> str:
        return f"{self.route}({self.note})" if self.note else self.route


@dataclass
class EdgeStep:
    """Process every lineage entry between one frontier/produced node pair."""

    u: str  # plan-node key the frontier is read from
    v: str  # plan-node key the step produces
    choices: list[HopChoice]

    @property
    def est_pairs(self) -> float:
        return sum(c.est_pairs for c in self.choices)


@dataclass
class QueryPlan:
    """Ordered, costed execution plan between two endpoint sets.

    Plan nodes are opaque keys (equal to array names for graph plans; path
    plans suffix the position so a path may revisit an array).  ``steps``
    maps each produced node to its incoming :class:`EdgeStep`s; ``order``
    lists every node in frontier-propagation order, starts first.
    """

    direction: str  # "forward" | "backward" | "path"
    starts: tuple[str, ...]  # node keys where the query frontier lands
    target_keys: dict[str, str]  # array name -> plan-node key
    order: list[str]
    node_array: dict[str, str]  # plan-node key -> array name
    steps: dict[str, list[EdgeStep]] = field(default_factory=dict)
    est_cost: float = 0.0
    # estimated frontier box count per plan node (filled by the planner;
    # consumed by the sharded planner's boundary-exchange cost term)
    est_boxes: dict[str, float] = field(default_factory=dict)
    # EXPLAIN ANALYZE accumulators, filled as the plan executes (plans are
    # memoized and shared across queries, so these are totals over every
    # execution): (u, v, lineage_id, stored, frontier_on) -> counters,
    # plus "__exec_ms__" for packed-dispatch wall time.  Guarded by the
    # owning store's _stats_lock.
    measured: dict = field(default_factory=dict)

    def _measured_for(self, step: "EdgeStep", choice: "HopChoice"):
        return self.measured.get(
            (step.u, step.v, choice.lineage_id, choice.stored, choice.frontier_on)
        )

    def _analyze_line(self, step: "EdgeStep", choice: "HopChoice") -> str:
        rec = self._measured_for(step, choice)
        est = (
            f"est_pairs={choice.est_pairs:.0f} est_cost={choice.est_cost:.0f}"
        )
        if rec is None:
            return f"      {_fmt_lid(choice.lineage_id)}: {est} | not executed"
        measured = (
            f"measured pairs={rec['pairs']} qrows={rec['qrows']} "
            f"calls={rec['calls']}"
        )
        if rec["timed"]:
            measured += f" time={rec['ms']:.3f}ms"
        return f"      {_fmt_lid(choice.lineage_id)}: {est} | {measured}"

    def describe(self, analyze: bool = False) -> str:
        """Human-readable plan, one line per hop (EXPLAIN-style).

        ``analyze=True`` is EXPLAIN ANALYZE: each hop choice gains a
        sub-line comparing the cost model's estimates against measured
        pair counts (and per-hop wall time where the serial engine timed
        individual joins) accumulated over the plan's executions.
        """
        header = (
            f"{self.direction} plan, {len(self.order)} nodes, "
            f"est_cost={self.est_cost:.0f}"
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
                lines.append(
                    f"  {self.node_array[step.u]} -> "
                    f"{self.node_array[step.v]}  [{opts}]"
                )
                if analyze:
                    for c in step.choices:
                        lines.append(self._analyze_line(step, c))
        return "\n".join(lines)


class QueryPlanner:
    """Plan and execute multi-hop lineage queries for one :class:`DSLog`."""

    def __init__(self, log: "DSLog"):
        self.log = log
        # default thread-pool width for execute(); None/1 = serial
        self.parallel: int | None = None
        # pack each frontier's dense joins into one blocked evaluation
        # (the BatchedJoinExecutor); False = the per-hop join loop
        self.batched: bool = True
        self._executor: BatchedJoinExecutor | None = None

    @property
    def executor(self) -> BatchedJoinExecutor:
        """The (lazily created) batched join engine, metering io_stats.

        Launch geometry comes from the store's persisted autotune table
        (``log.autotune``), so a reopened store starts on its measured
        winners instead of re-tuning.
        """
        if self._executor is None:
            self._executor = BatchedJoinExecutor(
                stats=self.log._bump,
                device=self.log.device,
                tuner=getattr(self.log, "autotune", None),
                metrics=getattr(self.log, "metrics", None),
            )
        return self._executor

    def _batched_discount(self) -> float:
        """Per-pair cost multiplier for the batched-dense route.

        The flat prior sharpened by the executor's measured tile occupancy:
        before any dispatch this is exactly ``_BATCHED_PAIR_DISCOUNT``;
        once frontiers run, padding-heavy shapes raise it toward (and past)
        parity with the per-hop dense cost, capped at 1.0 so measurement
        never makes batched look *worse* than the engine it replaces wholesale.
        """
        return min(1.0, _BATCHED_PAIR_DISCOUNT * self.executor.measured_waste)

    def _entry(self, lineage_id: int) -> "LineageEntry":
        """Resolve a hop id to its entry; negative ids are view shortcuts
        (``repro.core.views``), served by the store's view manager; a store
        without views (``log.views is None``) never plans one."""
        if lineage_id < 0:
            return self.log.views.entry_for(lineage_id)
        return self.log.lineage[lineage_id]

    # ------------------------------------------------------------------ #
    # planning
    # ------------------------------------------------------------------ #
    def plan(
        self,
        sources: str | Iterable[str],
        targets: str | Iterable[str],
        frontier: Sequence[QueryBox] | None = None,
        batched: bool | None = None,
    ) -> QueryPlan:
        """Plan between endpoint sets; query cells live on ``sources``.

        Orientation is inferred from the graph: a *forward* query when the
        targets are downstream of the sources, *backward* when upstream.
        ``frontier`` (the actual initial boxes, when already known) sharpens
        the first hop's cost estimates; the plan is valid without it.
        ``batched`` (default ``planner.batched``) selects the engine the
        cost model targets, so routes always match the engine that will
        execute them.
        """
        batched = self.batched if batched is None else batched
        g = self.log.graph
        src_set = {sources} if isinstance(sources, str) else set(sources)
        dst_set = {targets} if isinstance(targets, str) else set(targets)
        for name in src_set | dst_set:
            if name not in self.log.arrays:
                raise KeyError(f"unknown array {name!r}")
        if src_set & dst_set:
            raise ValueError("source and target sets must be disjoint")

        nodes, edges = g.induced_subdag(src_set, dst_set)
        if nodes:
            direction = "forward"
            up_set, down_set = src_set, dst_set
        else:
            nodes, edges = g.induced_subdag(dst_set, src_set)
            if not nodes:
                raise KeyError(
                    f"no lineage route between {sorted(src_set)} and "
                    f"{sorted(dst_set)}"
                )
            direction = "backward"
            up_set, down_set = dst_set, src_set
        covered_dst = nodes & dst_set
        if covered_dst != dst_set:
            missing = sorted(dst_set - covered_dst)
            raise KeyError(f"no lineage route to target(s) {missing}")

        topo = g.topo_order(nodes)
        order = topo if direction == "forward" else topo[::-1]
        plan = QueryPlan(
            direction=direction,
            starts=tuple(sorted(src_set & nodes)),
            target_keys={n: n for n in sorted(dst_set)},
            order=order,
            node_array={n: n for n in nodes},
        )
        # Estimated frontier box count per node, seeded by the real frontier.
        nq0 = self._frontier_boxes(frontier)
        est_boxes = plan.est_boxes
        est_boxes.update({s: nq0 for s in plan.starts})
        for key in order:
            if key in plan.starts:
                continue
            if direction == "forward":
                frontier_nodes = sorted({u for (u, v) in edges if v == key})
            else:  # frontier flows dataflow-downstream → upstream
                frontier_nodes = sorted({v for (u, v) in edges if u == key})
            for u in frontier_nodes:
                entries = (
                    g.edge_ids(u, key)
                    if direction == "forward"
                    else g.edge_ids(key, u)
                )
                step = self._build_step(
                    u,
                    key,
                    entries,
                    traverse="forward" if direction == "forward" else "backward",
                    nq=max(est_boxes.get(u, 1.0), 1.0),
                    frontier=frontier if u in plan.starts else None,
                    batched=batched,
                )
                plan.steps.setdefault(key, []).append(step)
                plan.est_cost += sum(c.est_cost for c in step.choices)
                est_boxes[key] = est_boxes.get(key, 0.0) + max(
                    1.0, step.est_pairs * _MERGE_SHRINK
                )
        # Materialized-view shortcut: when a composed view covers the whole
        # route, cost a one-hop plan over it and race it against the base
        # plan — the view wins exactly when the cost model says it should.
        if len(src_set) == 1 and len(dst_set) == 1:
            vplan = self._view_plan(
                next(iter(src_set)), next(iter(dst_set)), frontier, nq0, batched
            )
            tr = obs_trace.active()
            if vplan is not None and vplan.est_cost < plan.est_cost:
                self.log._bump("view_hits")
                if tr is not None:
                    tr.event(
                        "view_race",
                        kind="view",
                        winner="view",
                        view_cost=round(vplan.est_cost, 3),
                        base_cost=round(plan.est_cost, 3),
                    )
                return vplan
            self.log._bump("view_misses")
            if tr is not None:
                tr.event(
                    "view_race",
                    kind="view",
                    winner="base",
                    view_cost=(
                        None if vplan is None else round(vplan.est_cost, 3)
                    ),
                    base_cost=round(plan.est_cost, 3),
                )
        return plan

    def _view_plan(
        self,
        src: str,
        dst: str,
        frontier: Sequence[QueryBox] | None,
        nq0: float,
        batched: bool,
    ) -> QueryPlan | None:
        """One-hop plan over a materialized view covering ``src -> dst``
        (either orientation), or None when no live view matches."""
        views = getattr(self.log, "views", None)
        if views is None:
            return None
        pid = views.shortcut_for(src, dst)
        if pid is None:
            return None
        g = self.log.graph
        direction = (
            "forward" if g.shortcut_id(src, dst) == pid else "backward"
        )
        vplan = QueryPlan(
            direction=direction,
            starts=(src,),
            target_keys={dst: dst},
            order=[src, dst],
            node_array={src: src, dst: dst},
        )
        step = self._build_step(
            src, dst, [pid], traverse=direction, nq=nq0,
            frontier=frontier, batched=batched,
        )
        vplan.steps[dst] = [step]
        vplan.est_cost = sum(c.est_cost for c in step.choices)
        vplan.est_boxes.update(
            {src: nq0, dst: max(1.0, step.est_pairs * _MERGE_SHRINK)}
        )
        return vplan

    def plan_path(
        self,
        path: Sequence[str],
        frontier: Sequence[QueryBox] | None = None,
        batched: bool | None = None,
    ) -> QueryPlan:
        """Plan the paper's explicit-path query form on the same executor.

        One hop per adjacent pair; every stored entry between the pair
        contributes, whichever dataflow direction it was registered in.
        Node keys carry the position so a path may legally revisit an array.
        """
        batched = self.batched if batched is None else batched
        if len(path) < 2:
            raise ValueError("path needs at least two arrays")
        keys = [f"{k}:{name}" for k, name in enumerate(path)]
        plan = QueryPlan(
            direction="path",
            starts=(keys[0],),
            target_keys={path[-1]: keys[-1]},
            order=list(keys),
            node_array=dict(zip(keys, path)),
        )
        nq = self._frontier_boxes(frontier)
        plan.est_boxes[keys[0]] = nq
        for k, (a, b) in enumerate(zip(path[:-1], path[1:])):
            # entries stored with dataflow b -> a: frontier sits on their dst
            ids_down = self.log.by_pair.get((b, a), [])
            # entries stored with dataflow a -> b: frontier sits on their src
            ids_up = self.log.by_pair.get((a, b), [])
            if not ids_down and not ids_up:
                raise KeyError(f"no lineage stored between {a!r} and {b!r}")
            choices: list[HopChoice] = []
            hop_frontier = frontier if k == 0 else None
            for lid in ids_down:
                choices.append(
                    self._best_choice(lid, "backward", nq, hop_frontier, batched)
                )
            for lid in ids_up:
                choices.append(
                    self._best_choice(lid, "forward", nq, hop_frontier, batched)
                )
            step = EdgeStep(keys[k], keys[k + 1], choices)
            plan.steps[keys[k + 1]] = [step]
            plan.est_cost += sum(c.est_cost for c in choices)
            nq = max(1.0, step.est_pairs * _MERGE_SHRINK)
            plan.est_boxes[keys[k + 1]] = nq
        return plan

    # ------------------------------------------------------------------ #
    def _build_step(
        self,
        u: str,
        v: str,
        lineage_ids: list[int],
        traverse: str,
        nq: float,
        frontier: Sequence[QueryBox] | None,
        batched: bool = True,
    ) -> EdgeStep:
        choices = [
            self._best_choice(lid, traverse, nq, frontier, batched)
            for lid in lineage_ids
        ]
        return EdgeStep(u, v, choices)

    def _best_choice(
        self,
        lineage_id: int,
        traverse: str,
        nq: float,
        frontier: Sequence[QueryBox] | None,
        batched: bool = True,
    ) -> HopChoice:
        """Cheapest (materialization, route) for one entry on one hop.

        ``traverse`` is relative to the entry's dataflow: "forward" moves the
        frontier src→dst (frontier matches the *forward* table's keys or the
        backward table's values), "backward" the reverse.
        """
        entry = self._entry(lineage_id)
        options: list[HopChoice] = []
        if traverse == "backward":
            options.append(
                self._cost_option(
                    entry, lineage_id, "backward", "key", nq, frontier, batched
                )
            )
            if entry.has_forward:
                options.append(
                    self._cost_option(
                        entry, lineage_id, "forward", "value", nq, frontier,
                        batched,
                    )
                )
        else:
            if entry.has_forward:
                options.append(
                    self._cost_option(
                        entry, lineage_id, "forward", "key", nq, frontier,
                        batched,
                    )
                )
            options.append(
                self._cost_option(
                    entry, lineage_id, "backward", "value", nq, frontier,
                    batched,
                )
            )
        return min(options, key=lambda c: c.est_cost)

    def _cost_option(
        self,
        entry: "LineageEntry",
        lineage_id: int,
        stored: str,
        frontier_on: str,
        nq: float,
        frontier: Sequence[QueryBox] | None,
        batched: bool = True,
    ) -> HopChoice:
        nr = entry.backward_rows if stored == "backward" else entry.forward_rows
        nr = max(int(nr), 1)
        table = entry.peek_table(stored)  # None while the blob is unloaded
        measured = self.log.hop_measurement(lineage_id, stored, frontier_on)
        est_pairs = self._estimate_pairs(
            table, nr, frontier_on, nq, frontier, measured
        )
        dense_cost = nq * nr * (self._batched_discount() if batched else 1.0)
        # route: small tables and unselective frontiers go dense
        if nr < INDEX_MIN_ROWS or est_pairs > DENSE_FRACTION * nq * nr:
            route = "batched" if batched else "dense"
            join_cost = dense_cost
        else:
            route = "index"
            join_cost = est_pairs + nq * math.log2(nr + 1)
            has_index = table is not None and (
                table.cached_key_index() is not None
                if frontier_on == "key"
                else table.cached_val_index() is not None
            )
            if not has_index:
                join_cost += _INDEX_BUILD_WEIGHT * nr * math.log2(nr + 1)
            # the batched-route option: with packed frontier execution the
            # dense engine is cheap enough to beat a selective index on
            # some hops the per-hop model would never route dense
            if batched and dense_cost < join_cost:
                route, join_cost = "batched", dense_cost
        if route != "index":
            choice_note = self._dense_note(
                entry, stored, frontier_on, table, segmented=route == "batched"
            )
        else:
            choice_note = ""
        if frontier_on == "value":
            join_cost *= _INVERSE_OVERHEAD
        return HopChoice(
            lineage_id, stored, frontier_on, route, est_pairs, join_cost,
            note=choice_note,
        )

    def _dense_note(
        self,
        entry: "LineageEntry",
        stored: str,
        frontier_on: str,
        table,
        segmented: bool = True,
    ) -> str:
        """Backend annotation for a dense/batched hop (see ``dense_backend``).

        Attribute width comes from the array shapes (known without loading
        the blob); the int32-overflow check needs the actual bounds, so it
        only sharpens the note once the table is resident — execution
        re-checks exactly either way.
        """
        key_name = entry.dst if stored == "backward" else entry.src
        val_name = entry.src if stored == "backward" else entry.dst
        side = key_name if frontier_on == "key" else val_name
        n_attrs = len(self.log.arrays[side].shape)
        int32_ok = True
        if table is not None:
            int32_ok = table.int32_safe(
                "key" if frontier_on == "key" else "value"
            )
        note = dense_backend(
            n_attrs, int32_ok, segmented=segmented, device=self.log.device
        )
        if segmented:
            # batched hops also show the launch geometry the executor will
            # use, e.g. "batched(cuda:64x256)" / "batched(np:cpu:4m)"
            note = f"{note}:{self.executor.geometry_label(note)}"
        return note

    def _estimate_pairs(
        self,
        table,
        nr: int,
        frontier_on: str,
        nq: float,
        frontier: Sequence[QueryBox] | None,
        measured: float | None = None,
    ) -> float:
        """Expected candidate pairs for one hop.

        Preference order: an already-cached IntervalIndex probed with the
        *real* frontier (exact, first hop only) → the measured per-box pair
        count fed back from earlier executions of this hop
        (:meth:`~repro_torch.core.catalog.DSLog.hop_measurement`) → closed-form
        overlap model from the table's interval stats → row-cover fallback
        when the blob has not been deserialized yet.
        """
        if table is not None and frontier is not None:
            boxes = [q for q in frontier if q.n_rows]
            if boxes:
                q_lo = np.concatenate([q.lo for q in boxes], axis=0)
                q_hi = np.concatenate([q.hi for q in boxes], axis=0)
                idx = (
                    table.cached_key_index()
                    if frontier_on == "key"
                    else table.cached_val_index()
                )
                if idx is not None:
                    total = idx.estimate_candidates(q_lo, q_hi)
                    return max(1.0, total / len(frontier))
                if measured is None:
                    mean_q = (q_hi - q_lo + 1).mean(axis=0)
                    return self._overlap_model(table, frontier_on, nq, mean_q)
        if measured is not None:
            return max(1.0, measured * nq)
        if table is None:
            return nq * min(float(nr), _POINT_ROW_COVER)
        return self._overlap_model(table, frontier_on, nq, None)

    @staticmethod
    def _overlap_model(table, frontier_on, nq, mean_q) -> float:
        mean_r, span = (
            table.key_stats() if frontier_on == "key" else table.val_stats()
        )
        if mean_q is None:
            mean_q = np.ones_like(mean_r)
        p = np.minimum(1.0, (mean_q + mean_r - 1.0) / span)
        return float(nq) * table.n_rows * float(np.prod(p))

    @staticmethod
    def _frontier_boxes(frontier: Sequence[QueryBox] | None) -> float:
        if not frontier:
            return 1.0
        return max(1.0, float(np.mean([q.n_rows for q in frontier])))

    # ------------------------------------------------------------------ #
    # execution
    # ------------------------------------------------------------------ #
    def execute(
        self,
        plan: QueryPlan,
        queries: "Sequence[QueryBox] | dict[str, Sequence[QueryBox]]",
        merge: bool = True,
        collect: str = "targets",
        parallel: int | None = None,
        batched: bool | None = None,
    ) -> dict[str, list[QueryBox]]:
        """Run ``plan`` for a batch of queries rooted at its start node(s).

        Nodes are processed in plan order; each node concatenates the
        contributions of all incoming steps (plus its share of the initial
        frontier, for start nodes) and — with ``merge`` — deduplicates the
        combined frontier via ``merge_boxes``: the diamond fan-in
        optimization.  ``queries`` is the batch for a single-start plan, or
        ``{array name: batch}`` when the plan has several start arrays (all
        batches the same length).  Returns ``{array name: [QueryBox per
        query]}`` for the targets (or every node with ``collect="all"``).

        ``parallel=N`` (or setting ``planner.parallel``) runs *independent*
        plan nodes — parallel branches of the DAG and, on a sharded store,
        per-shard sub-plans with no pending exchange between them — on an
        N-thread pool.  Each node still accumulates its incoming steps in
        plan order, so results are identical to serial execution.

        ``batched`` (default ``planner.batched``) picks the join engine:
        ``True`` packs every dense join ready in a plan frontier — across
        branches and sub-plans — into one blocked evaluation through the
        :class:`~repro_torch.core.query.BatchedJoinExecutor` (in parallel mode,
        one packed evaluation per node, with the GIL-releasing twin letting
        workers overlap); ``False`` is the serial per-hop join loop.  Both
        engines return bit-identical results.
        """
        if isinstance(queries, dict):
            start_by_array = {plan.node_array[k]: k for k in plan.starts}
            unknown = sorted(set(queries) - set(start_by_array))
            if unknown:
                raise KeyError(
                    f"query batches for non-start array(s) {unknown}; "
                    f"plan starts at {sorted(start_by_array)}"
                )
            missing = sorted(set(start_by_array) - set(queries))
            if missing:
                raise ValueError(
                    f"missing query batch for start array(s) {missing}"
                )
            by_start = {
                start_by_array[name]: qs for name, qs in queries.items()
            }
        else:
            if len(plan.starts) != 1:
                raise ValueError(
                    "multi-start plan: pass queries as {array name: batch}"
                )
            by_start = {plan.starts[0]: queries}
        init: dict[str, list[QueryBox]] = {}
        lengths = set()
        for key, qs in by_start.items():
            shape = self.log.arrays[plan.node_array[key]].shape
            boxes = [
                q if isinstance(q, QueryBox) else QueryBox.from_cells(shape, q)
                for q in qs
            ]
            if merge:
                with obs_trace.span("planner.init", "planner"):
                    boxes = [merge_boxes(q) for q in boxes]
            init[key] = boxes
            lengths.add(len(boxes))
        if len(lengths) > 1:
            raise ValueError("per-start query batches must have equal length")
        nB = lengths.pop() if lengths else 0

        workers = parallel if parallel is not None else self.parallel
        use_batched = self.batched if batched is None else batched
        if use_batched and plan.steps:
            frontier = self._execute_waves(plan, init, nB, merge, workers)
        elif workers is not None and workers > 1 and len(plan.order) > 1:
            frontier = self._execute_parallel(plan, init, nB, merge, workers)
        else:
            frontier = {}
            for key in plan.order:
                frontier[key] = self._compute_node(
                    plan, key, init, frontier, nB, merge, use_batched
                )
        if collect == "all":
            return {plan.node_array[k]: v for k, v in frontier.items()}
        out = {
            name: frontier[key] for name, key in plan.target_keys.items()
        }
        if merge:
            # Final normal form: merge_boxes fixpoints depend on the route
            # taken (per-hop chain vs composed view, sharded vs not), so
            # target answers are re-cut into the canonical decomposition —
            # equal cell sets become equal bytes, whatever plan produced
            # them.
            with obs_trace.span("query.canonical", "query") as sp:
                sp.attrs["boxes_in"] = sum(
                    q.lo.shape[0] for boxes in out.values() for q in boxes
                )
                out = {
                    name: [canonical_boxes(q) for q in boxes]
                    for name, boxes in out.items()
                }
                sp.attrs["boxes_out"] = sum(
                    q.lo.shape[0] for boxes in out.values() for q in boxes
                )
        return out

    # ------------------------------------------------------------------ #
    # node execution: gather join requests, run them, assemble frontiers
    # ------------------------------------------------------------------ #
    def _gather_requests(
        self,
        plan: QueryPlan,
        key: str,
        frontier: dict[str, list[QueryBox]],
    ) -> list[tuple[EdgeStep, HopChoice, list[QueryBox]]]:
        """One node's pending joins, in plan order of its incoming steps."""
        gathered: list[tuple[EdgeStep, HopChoice, list[QueryBox]]] = []
        for step in plan.steps.get(key, []):
            qs = self._incoming_frontier(plan, step, frontier[step.u])
            for choice in step.choices:
                gathered.append((step, choice, qs))
        return gathered

    def _requests_for(
        self, gathered: list[tuple[EdgeStep, HopChoice, list[QueryBox]]]
    ) -> list[JoinRequest]:
        reqs = []
        for _step, choice, qs in gathered:
            entry = self._entry(choice.lineage_id)
            table = (
                entry.backward if choice.stored == "backward" else entry.forward
            )
            reqs.append(
                JoinRequest(
                    qs,
                    table,
                    inverse=choice.frontier_on == "value",
                    merge=False,
                    path=choice.route,
                )
            )
        return reqs

    def _assemble_node(
        self,
        plan: QueryPlan,
        key: str,
        init: dict[str, list[QueryBox]],
        gathered: list[tuple[EdgeStep, HopChoice, list[QueryBox]]],
        res_lists: list[list[QueryBox]],
        nB: int,
        merge: bool,
        timings: list[float] | None = None,
    ) -> list[QueryBox]:
        """One node's frontier: its init share plus every step's results."""
        if key in init and not plan.steps.get(key, []):
            return init[key]
        with obs_trace.span("planner.assemble", "planner"):
            shape = self.log.arrays[plan.node_array[key]].shape
            nd = len(shape)
            acc_lo: list[list[np.ndarray]] = [[] for _ in range(nB)]
            acc_hi: list[list[np.ndarray]] = [[] for _ in range(nB)]
            for k, q in enumerate(init.get(key, [])):
                acc_lo[k].append(q.lo)
                acc_hi[k].append(q.hi)
            for i, ((step, choice, qs), res_list) in enumerate(
                zip(gathered, res_lists)
            ):
                self._record_step_output(plan, step, res_list)
                self._record_choice(
                    choice,
                    qs,
                    res_list,
                    plan=plan,
                    step=step,
                    elapsed=None if timings is None else timings[i],
                )
                for k, res in enumerate(res_list):
                    acc_lo[k].append(res.lo)
                    acc_hi[k].append(res.hi)
            boxes = []
            for k in range(nB):
                lo = (
                    np.concatenate(acc_lo[k])
                    if acc_lo[k]
                    else np.zeros((0, nd), np.int64)
                )
                hi = (
                    np.concatenate(acc_hi[k])
                    if acc_hi[k]
                    else np.zeros((0, nd), np.int64)
                )
                res = QueryBox(shape, lo, hi)
                boxes.append(merge_boxes(res) if merge else res)
            return boxes

    def _compute_node(
        self,
        plan: QueryPlan,
        key: str,
        init: dict[str, list[QueryBox]],
        frontier: dict[str, list[QueryBox]],
        nB: int,
        merge: bool,
        use_batched: bool = False,
    ) -> list[QueryBox]:
        """One node's frontier: its init share plus every incoming step.

        With ``use_batched`` the node's joins — every choice of every
        incoming step — run as one packed executor batch; this is the
        per-node granularity parallel mode uses (each worker packs the node
        it owns).  Results are identical either way.
        """
        gathered = self._gather_requests(plan, key, frontier)
        timings: list[float] | None = None
        if use_batched and gathered:
            res_lists = self.executor.run(self._requests_for(gathered))
        else:
            # the per-hop loop is the one engine that can time individual
            # joins — EXPLAIN ANALYZE shows true per-hop wall time here
            res_lists = []
            timings = []
            for _s, choice, qs in gathered:
                t0 = time.perf_counter()
                res_lists.append(self._join_choice(choice, qs))
                timings.append(time.perf_counter() - t0)
        return self._assemble_node(
            plan, key, init, gathered, res_lists, nB, merge, timings=timings
        )

    def _execute_waves(
        self,
        plan: QueryPlan,
        init: dict[str, list[QueryBox]],
        nB: int,
        merge: bool,
        workers: int | None = None,
    ) -> dict[str, list[QueryBox]]:
        """Frontier execution with whole-wave join batching.

        The plan runs as a sequence of *waves*: every node whose
        dependencies are satisfied is ready, and all ready nodes' joins —
        across plan branches and, on sharded plans, across exchange-free
        per-shard sub-plans — are packed into one
        :meth:`BatchedJoinExecutor.run` dispatch.  Per-node assembly then
        proceeds in plan order, so results are bit-identical to the serial
        per-hop loop.

        ``workers=N`` hands each wave's packed dense segments to an
        N-thread pool inside the executor: the segment tasks are almost
        entirely GIL-releasing blocked numpy, which is what makes thread
        parallelism actually pay on CPU (node-granularity threading — the
        non-batched engine's mode — loses its win to GIL hand-offs between
        the small Python-held assembly steps).
        """
        deps = {
            key: {s.u for s in plan.steps.get(key, [])} for key in plan.order
        }
        frontier: dict[str, list[QueryBox]] = {}
        done: set[str] = set()
        pending = list(plan.order)
        while pending:
            wave = [k for k in pending if deps[k] <= done]
            gathered = {
                k: self._gather_requests(plan, k, frontier) for k in wave
            }
            reqs: list[JoinRequest] = []
            for k in wave:
                reqs.extend(self._requests_for(gathered[k]))
            if reqs:
                t0 = time.perf_counter()
                res = self.executor.run(reqs, workers=workers)
                dt_ms = (time.perf_counter() - t0) * 1e3
                with self.log._stats_lock:
                    acc = plan.measured.setdefault("__exec_ms__", [0.0, 0])
                    acc[0] += dt_ms
                    acc[1] += 1
            else:
                res = []
            off = 0
            for k in wave:
                n = len(gathered[k])
                frontier[k] = self._assemble_node(
                    plan, k, init, gathered[k], res[off : off + n], nB, merge
                )
                off += n
                done.add(k)
            pending = [k for k in pending if k not in done]
        return frontier

    def _execute_parallel(
        self,
        plan: QueryPlan,
        init: dict[str, list[QueryBox]],
        nB: int,
        merge: bool,
        workers: int,
    ) -> dict[str, list[QueryBox]]:
        """Dependency-driven node-level execution on a thread pool.

        The non-batched engine's parallel mode: a node is *ready*
        once every node feeding one of its steps has a computed frontier,
        so non-dependent branches — and, through the sharded planner's
        step ownership, exchange-free per-shard sub-plans — run
        concurrently.  Within a node, incoming steps still execute in plan
        order: per-node results are bit-identical to serial execution.
        (With batching enabled, ``execute`` uses wave execution with
        worker-split dense segments instead — see ``_execute_waves``.)
        """
        import concurrent.futures as cf
        import threading

        deps = {
            key: {s.u for s in plan.steps.get(key, [])} for key in plan.order
        }
        frontier: dict[str, list[QueryBox]] = {}
        done: set[str] = set()
        scheduled: set[str] = set()
        errors: list[BaseException] = []
        cond = threading.Condition()
        pool = cf.ThreadPoolExecutor(
            max_workers=workers, thread_name_prefix="dslog-exec"
        )

        def schedule_ready_locked() -> None:
            for key in plan.order:
                if key not in scheduled and deps[key] <= done:
                    scheduled.add(key)
                    fut = pool.submit(
                        self._compute_node, plan, key, init, frontier,
                        nB, merge,
                    )
                    fut.add_done_callback(
                        lambda f, key=key: on_done(key, f)
                    )

        def on_done(key: str, fut: "cf.Future") -> None:
            # runs on the worker that finished the node: successors are
            # submitted here, without a round trip through the main thread
            with cond:
                exc = fut.exception()
                if exc is not None:
                    errors.append(exc)
                else:
                    frontier[key] = fut.result()
                    done.add(key)
                    if not errors:
                        schedule_ready_locked()
                cond.notify_all()

        try:
            with cond:
                schedule_ready_locked()
                while len(done) < len(plan.order) and not errors:
                    cond.wait()
            if errors:
                raise errors[0]
        finally:
            pool.shutdown(wait=True)
        return frontier

    def _incoming_frontier(
        self, plan: QueryPlan, step: EdgeStep, qs: list[QueryBox]
    ) -> list[QueryBox]:
        """Hook: transform a step's input frontier before the joins run.

        The base planner passes it through; the sharded planner overrides
        this to account for (and compress) frontiers crossing a shard
        boundary.
        """
        return qs

    def _record_step_output(
        self, plan: QueryPlan, step: EdgeStep, res_list: list[QueryBox]
    ) -> None:
        """Hook: observe one choice's per-query results (sharded planner
        uses it to meter output-side boundary exchanges)."""

    def _join_choice(
        self, choice: HopChoice, qs: list[QueryBox]
    ) -> list[QueryBox]:
        """The per-hop join loop: one choice, one ``theta_join_batch``."""
        entry = self._entry(choice.lineage_id)
        table = entry.backward if choice.stored == "backward" else entry.forward
        if choice.frontier_on == "key":
            return theta_join_batch(
                qs, table, merge=False, path=choice.route,
                device=self.log.device, stats=self.log._bump,
            )
        return theta_join_inverse_batch(
            qs, table, merge=False, path=choice.route,
            device=self.log.device, stats=self.log._bump,
        )

    def _record_choice(
        self,
        choice: HopChoice,
        qs: list[QueryBox],
        res: list[QueryBox],
        plan: QueryPlan | None = None,
        step: EdgeStep | None = None,
        elapsed: float | None = None,
    ) -> None:
        # cost-model feedback: the true pair counts this hop produced, keyed
        # by (entry, materialization, join side) — replanning the same
        # catalog prefers these measurements over the closed-form model
        qrows = sum(q.n_rows for q in qs)
        pairs = sum(r.n_rows for r in res)
        if qrows:
            self.log.record_hop(
                choice.lineage_id,
                choice.stored,
                choice.frontier_on,
                pairs=pairs,
                qrows=qrows,
            )
        if plan is not None and step is not None:
            # EXPLAIN ANALYZE: accumulate the measured side against the
            # plan's estimates (plans are memoized — totals over runs)
            mkey = (
                step.u,
                step.v,
                choice.lineage_id,
                choice.stored,
                choice.frontier_on,
            )
            with self.log._stats_lock:
                rec = plan.measured.get(mkey)
                if rec is None:
                    rec = plan.measured[mkey] = {
                        "pairs": 0,
                        "qrows": 0,
                        "calls": 0,
                        "ms": 0.0,
                        "timed": 0,
                    }
                rec["pairs"] += pairs
                rec["qrows"] += qrows
                rec["calls"] += 1
                if elapsed is not None:
                    rec["ms"] += elapsed * 1e3
                    rec["timed"] += 1
        tr = obs_trace.active()
        if tr is not None and step is not None:
            tr.event(
                "hop",
                kind="hop",
                u=plan.node_array[step.u] if plan is not None else step.u,
                v=plan.node_array[step.v] if plan is not None else step.v,
                lid=choice.lineage_id,
                stored=choice.stored,
                route=choice.describe_route(),
                qrows=qrows,
                pairs=pairs,
                duration=elapsed,
            )

    def _run_choice(
        self, choice: HopChoice, qs: list[QueryBox]
    ) -> list[QueryBox]:
        """One choice's join plus its cost feedback (per-hop loop form)."""
        res = self._join_choice(choice, qs)
        self._record_choice(choice, qs, res)
        return res
