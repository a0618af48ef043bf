"""Two-input operations in the port's store, on the CPU: a join logged with
both inputs answers path-form queries through either input, in both
directions and on both join engines, as the explicit pairs and the JAX
package do; and ``io_stats["frontier_boxes"]`` counts the query-side boxes
of every join a query runs."""

import numpy as np
import pytest

import repro.core.capture as jC
import repro.core.catalog as jcat
import repro_torch.core.capture as tC
import repro_torch.core.catalog as tcat
import repro_torch.core.relation as trel

SEED = 20261018


def _rels(C, LineageRelation):
    """``L`` (60 × 3) JOIN ``R`` (40 × 2) on random keys into ``J``, then a
    row permutation of ``J`` into ``S``: ``{(src, dst): relation}``."""
    rng = np.random.default_rng(SEED)
    rel_l, rel_r = C.inner_join_lineage(rng.integers(0, 30, 60), rng.integers(0, 30, 40), 3, 2)
    shape = rel_l.out_shape
    perm = rng.permutation(shape[0])
    out = np.stack(np.unravel_index(np.arange(int(np.prod(shape))), shape), axis=1)
    inn = np.stack([perm[out[:, 0]], out[:, 1]], axis=1)
    return {("L", "J"): rel_l, ("R", "J"): rel_r,
            ("J", "S"): LineageRelation(shape, shape, out, inn)}


def _store(cat, C, LineageRelation, **kw):
    rels = _rels(C, LineageRelation)
    log = cat.DSLog(store_forward=True, **kw)
    for (a, b), rel in rels.items():
        log.define_array(a, rel.in_shape)
        log.define_array(b, rel.out_shape)
    join = log.register_operation(
        "join", ["L", "R"], ["J"],
        capture=lambda: {(0, 0): rels[("L", "J")], (0, 1): rels[("R", "J")]}, reuse=False)
    log.register_operation("order_by", ["J"], ["S"], capture=lambda: {(0, 0): rels[("J", "S")]},
                           reuse=False)
    return log, rels, join


def _oracle(rels, path, cells):
    """Flat cells of ``path[-1]`` linked to flat ``cells`` of ``path[0]``."""
    cur = np.unique(cells)
    for a, b in zip(path[:-1], path[1:]):
        fwd = (a, b) in rels
        rel = rels[(a, b)] if fwd else rels[(b, a)]
        out_f = np.ravel_multi_index(rel.out_idx.T, rel.out_shape)
        in_f = np.ravel_multi_index(rel.in_idx.T, rel.in_shape)
        src, dst = (in_f, out_f) if fwd else (out_f, in_f)
        cur = np.unique(dst[np.isin(src, cur)])
    return cur


def _cells(box):
    if not box.n_rows:
        return np.zeros(0, np.int64)
    return np.unique(np.ravel_multi_index(box.cells().T, box.shape))


def _region(shape, lo, n):
    flat = np.arange(lo, lo + n)
    return np.stack(np.unravel_index(flat, shape), axis=1)


PATHS = [["R", "J", "S"], ["S", "J", "R"], ["L", "J", "S"], ["S", "J", "L"]]


@pytest.mark.parametrize("batched", [True, False], ids=["batched", "per_hop"])
@pytest.mark.parametrize("path", PATHS, ids=["->".join(p) for p in PATHS])
def test_path_through_either_join_input(path, batched):
    tlog, rels, _ = _store(tcat, tC, trel.LineageRelation, device="cpu")
    jlog, _, _ = _store(jcat, jC, jC.LineageRelation)
    shape = tlog.arrays[path[0]].shape
    cells = _region(shape, 7, max(1, int(np.prod(shape)) // 10))
    got = tlog.prov_query(path, cells, merge=True, batched=batched)
    want = _oracle(rels, path, np.ravel_multi_index(cells.T, shape))
    assert want.size > 0
    np.testing.assert_array_equal(_cells(got), want)
    ref = jlog.prov_query(path, cells, merge=True, batched=batched)
    assert got.lo.tobytes() == ref.lo.tobytes() and got.hi.tobytes() == ref.hi.tobytes()


def test_join_logs_an_entry_per_input_and_captures_without_reuse():
    log, rels, join = _store(tcat, tC, trel.LineageRelation, device="cpu")
    assert len(join.lineage_ids) == 2 and join.reused is None
    assert set(log.by_pair) == set(rels)
    # a second join of the same shapes still captures: reuse=False never
    # lets a confirmed signature stand in for value-dependent lineage
    calls = []
    log.define_array("J2", rels[("L", "J")].out_shape)
    rec = log.register_operation(
        "join", ["L", "R"], ["J2"],
        capture=lambda: calls.append(1) or {(0, 0): rels[("L", "J")], (0, 1): rels[("R", "J")]},
        reuse=False)
    assert calls == [1] and rec.reused is None and len(rec.lineage_ids) == 2


@pytest.mark.parametrize("batched", [True, False], ids=["batched", "per_hop"])
@pytest.mark.parametrize("path", PATHS[:2], ids=["->".join(p) for p in PATHS[:2]])
def test_frontier_boxes_count_each_joins_query_side(path, batched):
    log, _, _ = _store(tcat, tC, trel.LineageRelation, device="cpu")
    assert log.io_stats["frontier_boxes"] == 0
    shape = log.arrays[path[0]].shape
    for k, n in enumerate((1, 9, int(np.prod(shape)) // 4)):
        before = log.io_stats["frontier_boxes"]
        _, tr = log.prov_query(path, _region(shape, 3 * k, n), merge=True, batched=batched,
                               trace=True)
        hops = tr.spans("hop")
        assert len(hops) == len(path) - 1
        want = sum(h.attrs["qrows"] for h in hops)
        assert want > 0
        assert log.io_stats["frontier_boxes"] - before == want
