"""Lineage DAG over arrays (paper §III at pipeline scale).

Real pipelines are DAGs with fan-out and fan-in, not the hand-spelled array
*paths* of the paper's multi-hop ``prov_query`` (§V).  :class:`LineageGraph`
is the structural layer under the catalog: nodes are array names, and every
:class:`~repro_torch.core.catalog.LineageEntry` contributes a directed edge from
its op input (``src``) to its op output (``dst``) labelled by its lineage
id.  Multiple entries between the same pair (repeated ops, reuse links)
share one edge slot and keep registration order.

The graph is built incrementally by ``DSLog.add_lineage`` /
``register_operation`` and rebuilt from the manifest on ``DSLog.load``.  It
answers the questions the planner needs:

* forward/backward adjacency and reachability,
* enumeration of all simple dataflow paths between two endpoint *sets*,
* the sub-DAG induced by those paths plus a topological order over it,
* cycle rejection at insertion time — dataflow over arrays must stay
  acyclic, and catching the violation at ``add_edge`` time (rather than at
  query time, deep inside a non-terminating traversal) keeps the invariant
  local to the write path.
"""

from __future__ import annotations

from collections import deque
from typing import Iterable, Iterator

__all__ = ["CycleError", "LineageGraph"]


class CycleError(ValueError):
    """Adding this edge would create a dataflow cycle."""


class LineageGraph:
    """Directed multigraph of arrays; edges labelled with lineage ids."""

    def __init__(self) -> None:
        # src -> dst -> [lineage ids in registration order]
        self.fwd: dict[str, dict[str, list[int]]] = {}
        # dst -> src -> [lineage ids]
        self.bwd: dict[str, dict[str, list[int]]] = {}
        self._nodes: set[str] = set()
        # (src, dst) -> pseudo lineage id of a materialized view covering
        # the whole route.  An overlay, not part of the dataflow DAG: it
        # never participates in reachability, path enumeration, or cycle
        # checks — the planner consults it separately when costing a
        # single-source/single-target query.
        self.shortcuts: dict[tuple[str, str], int] = {}

    # ------------------------------------------------------------------ #
    # construction
    # ------------------------------------------------------------------ #
    def add_node(self, name: str) -> None:
        self._nodes.add(name)

    def add_edge(self, src: str, dst: str, lineage_id: int) -> None:
        """Record one lineage entry as a ``src → dst`` dataflow edge.

        Raises :class:`CycleError` (and leaves the graph untouched) when the
        edge would close a cycle, including the ``src == dst`` self-loop.
        Parallel entries between an existing pair are always safe.
        """
        if src == dst:
            raise CycleError(
                f"self-lineage {src!r} → {dst!r} is not a DAG edge "
                "(log in-place updates under versioned array names instead)"
            )
        if dst not in self.fwd.get(src, ()) and self.has_path(dst, src):
            raise CycleError(
                f"lineage {src!r} → {dst!r} would close a cycle "
                f"({dst!r} already flows into {src!r})"
            )
        self._nodes.update((src, dst))
        self.fwd.setdefault(src, {}).setdefault(dst, []).append(lineage_id)
        self.bwd.setdefault(dst, {}).setdefault(src, []).append(lineage_id)

    def remove_edge(self, src: str, dst: str, lineage_id: int) -> None:
        """Remove one entry from an edge (multi-entry rollback support).

        Nodes are kept even when their last edge goes — they still name
        declared arrays.
        """
        for adj, a, b in ((self.fwd, src, dst), (self.bwd, dst, src)):
            ids = adj.get(a, {}).get(b)
            if ids is None or lineage_id not in ids:
                return
            ids.remove(lineage_id)
            if not ids:
                del adj[a][b]
                if not adj[a]:
                    del adj[a]

    def add_shortcut(self, src: str, dst: str, pseudo_id: int) -> None:
        """Overlay a materialized-view shortcut on the ``src → dst`` route.

        ``pseudo_id`` is the view's negative pseudo lineage id (see
        ``repro.core.views``; the port's views are still to come).  At most
        one shortcut per route.
        """
        self.shortcuts[(src, dst)] = pseudo_id

    def remove_shortcut(self, src: str, dst: str) -> None:
        self.shortcuts.pop((src, dst), None)

    def shortcut_id(self, src: str, dst: str) -> int | None:
        return self.shortcuts.get((src, dst))

    @staticmethod
    def from_pairs(by_pair: dict[tuple[str, str], list[int]]) -> "LineageGraph":
        """Rebuild from a catalog's ``(src, dst) -> [lineage ids]`` map."""
        g = LineageGraph()
        for (src, dst), ids in by_pair.items():
            for lid in ids:
                g.add_edge(src, dst, lid)
        return g

    # ------------------------------------------------------------------ #
    # adjacency
    # ------------------------------------------------------------------ #
    @property
    def nodes(self) -> set[str]:
        return set(self._nodes)

    def successors(self, name: str) -> list[str]:
        return list(self.fwd.get(name, ()))

    def predecessors(self, name: str) -> list[str]:
        return list(self.bwd.get(name, ()))

    def edge_ids(self, src: str, dst: str) -> list[int]:
        """Lineage ids of all entries on the ``src → dst`` edge."""
        return list(self.fwd.get(src, {}).get(dst, ()))

    def n_edges(self) -> int:
        return sum(len(ids) for dsts in self.fwd.values() for ids in dsts.values())

    # ------------------------------------------------------------------ #
    # reachability
    # ------------------------------------------------------------------ #
    def reachable(
        self, starts: Iterable[str] | str, direction: str = "forward"
    ) -> set[str]:
        """Every node reachable from ``starts`` (the starts themselves
        included) walking dataflow edges ``forward`` or ``backward``."""
        if direction not in ("forward", "backward"):
            raise ValueError(f"bad direction {direction!r}")
        adj = self.fwd if direction == "forward" else self.bwd
        frontier = deque([starts] if isinstance(starts, str) else starts)
        seen = set(frontier)
        while frontier:
            for nxt in adj.get(frontier.popleft(), ()):
                if nxt not in seen:
                    seen.add(nxt)
                    frontier.append(nxt)
        return seen

    def has_path(self, src: str, dst: str) -> bool:
        return dst in self.reachable(src, "forward")

    # ------------------------------------------------------------------ #
    # path / sub-DAG enumeration
    # ------------------------------------------------------------------ #
    def simple_paths(
        self,
        sources: Iterable[str] | str,
        targets: Iterable[str] | str,
        max_paths: int | None = None,
    ) -> list[list[str]]:
        """All simple dataflow paths from any source to any target.

        Endpoints are *sets*: a path starts at one source and ends at the
        first-class target it reaches (it may pass through another target on
        the way — those longer paths are enumerated too).  Since edges are
        acyclic every dataflow path is simple; the explicit visited set only
        guards against source/target overlap.  ``max_paths`` caps the
        enumeration (diamond stacks grow exponentially many paths — the
        planner never needs the explicit list, see :meth:`induced_subdag`).
        """
        src_set = {sources} if isinstance(sources, str) else set(sources)
        dst_set = {targets} if isinstance(targets, str) else set(targets)
        # prune to nodes that can reach a target at all
        alive = self.reachable(dst_set, "backward")
        out: list[list[str]] = []

        def dfs(node: str, path: list[str]) -> bool:
            if node in dst_set:
                out.append(list(path))
                if max_paths is not None and len(out) >= max_paths:
                    return False
            for nxt in self.fwd.get(node, ()):
                if nxt in alive and nxt not in path:
                    path.append(nxt)
                    if not dfs(nxt, path):
                        return False
                    path.pop()
            return True

        for s in sorted(src_set):
            if s in alive and not dfs(s, [s]):
                break
        return out

    def induced_subdag(
        self,
        sources: Iterable[str] | str,
        targets: Iterable[str] | str,
    ) -> tuple[set[str], list[tuple[str, str]]]:
        """Nodes and edges lying on at least one source→target path.

        In a DAG a node is on such a path iff it is reachable from a source
        *and* a target is reachable from it, so this is two BFS passes — no
        exponential path enumeration.
        """
        down = self.reachable(sources, "forward")
        up = self.reachable(targets, "backward")
        nodes = down & up
        edges = [
            (u, v)
            for u in nodes
            for v in self.fwd.get(u, ())
            if v in nodes
        ]
        return nodes, edges

    def topo_order(self, nodes: Iterable[str] | None = None) -> list[str]:
        """Kahn topological order over ``nodes`` (default: whole graph).

        Ties broken by name so plans are deterministic across runs.
        """
        pool = self._nodes if nodes is None else set(nodes)
        indeg = {
            n: sum(1 for p in self.bwd.get(n, ()) if p in pool) for n in pool
        }
        ready = sorted(n for n, d in indeg.items() if d == 0)
        order: list[str] = []
        while ready:
            n = ready.pop(0)
            order.append(n)
            inserted = False
            for s in self.fwd.get(n, ()):
                if s in pool:
                    indeg[s] -= 1
                    if indeg[s] == 0:
                        ready.append(s)
                        inserted = True
            if inserted:
                ready.sort()
        if len(order) != len(pool):
            # unreachable by construction (add_edge rejects cycles); kept as
            # a hard failure rather than a silent truncated order
            raise CycleError("graph contains a cycle")
        return order

    # ------------------------------------------------------------------ #
    def __contains__(self, name: str) -> bool:
        return name in self._nodes

    def __iter__(self) -> Iterator[str]:
        return iter(self._nodes)

    def __len__(self) -> int:
        return len(self._nodes)
