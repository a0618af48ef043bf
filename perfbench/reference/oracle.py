"""The reference answers: hash-join propagation over explicit lineage pairs.

A query's cells travel edge by edge, forward (input cell to the output
cells that depend on it) or backward (output cell to its inputs), as
``benchmarks/fig89_query.py``'s raw-join oracle does; where several edges
reach one array (a fan-in), the sets are united.  The program is judged by
its answers alone, as sets of flat cells.
"""

from __future__ import annotations

import numpy as np

from .lineage import Rel


def _step(rel: Rel, cur: np.ndarray, forward: bool) -> np.ndarray:
    out_f, in_f = rel.flat()
    src, dst = (in_f, out_f) if forward else (out_f, in_f)
    return np.unique(dst[np.isin(src, cur)])


def propagate(edges: list[tuple[str, str, Rel]], src: str, dst: str, cells: np.ndarray,
              shapes: dict) -> np.ndarray:
    """Flat cells of ``dst`` linked to flat ``cells`` of ``src`` over every
    path of ``edges`` (``(from, to, relation)``; a backward query names the
    arrays the other way round)."""
    forward = _reaches(edges, src, dst)
    adj: dict = {}
    for a, b, rel in edges:
        u, v = (a, b) if forward else (b, a)
        adj.setdefault(u, []).append((v, rel))
    order = _topo(adj, src)
    sets = {src: np.unique(cells)}
    for u in order:
        cur = sets.get(u)
        if cur is None or u == dst:
            continue
        for v, rel in adj.get(u, []):
            nxt = _step(rel, cur, forward)
            sets[v] = np.union1d(sets[v], nxt) if v in sets else nxt
    return sets.get(dst, np.zeros(0, np.int64))


def _reaches(edges, src, dst) -> bool:
    seen, todo = {src}, [src]
    adj: dict = {}
    for a, b, _ in edges:
        adj.setdefault(a, []).append(b)
    while todo:
        for v in adj.get(todo.pop(), []):
            if v == dst:
                return True
            if v not in seen:
                seen.add(v)
                todo.append(v)
    return False


def _topo(adj: dict, src: str) -> list:
    order, state = [], {}

    def visit(u):
        state[u] = 1
        for v, _ in adj.get(u, []):
            if v not in state:
                visit(v)
        state[u] = 2
        order.append(u)

    visit(src)
    return order[::-1]


def box_cells(shape, lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """Distinct flat cells covered by boxes ``lo``/``hi`` (``[N, ndim]``,
    inclusive) of an array of ``shape``."""
    n, nd = lo.shape
    if n == 0:
        return np.zeros(0, np.int64)
    owner = np.arange(n, dtype=np.int64)
    cols: list[np.ndarray] = []
    for d in range(nd):
        counts = hi[owner, d] - lo[owner, d] + 1
        rep = np.repeat(np.arange(owner.size), counts)
        offset = np.arange(rep.size) - np.repeat(np.cumsum(counts) - counts, counts)
        cols = [c[rep] for c in cols] + [lo[owner[rep], d] + offset]
        owner = owner[rep]
    return np.unique(np.ravel_multi_index(np.stack(cols), shape))


def bounding_box(shape, cells: np.ndarray) -> np.ndarray:
    """The control's answer: ``cells`` widened to their bounding box, the
    coarse lineage of a block- or array-level system."""
    if cells.size == 0:
        return cells
    idx = np.stack(np.unravel_index(cells, shape), axis=1)
    return box_cells(shape, idx.min(axis=0)[None], idx.max(axis=0)[None])
