"""The TPC-H lineage configuration ``tpch_lineage`` on the CPU at SF 0.0005:
the program against the plain reference on every chain in both
directions, the control, the chains against the configuration's file, and
the reference's relations against per-row Python loops."""

import copy
import itertools

import numpy as np
import pytest

from perfbench import harness
from perfbench.reference import oracle
from perfbench.reference import tpch
from perfbench.testing import run_tiny

CELL = "tpch_lineage.query_brush"
SEED = 2**34 + 33
TINY_SF = 0.0005


def tiny_cfg() -> dict:
    cfg = copy.deepcopy(harness.load_config("tpch_lineage"))
    cfg["scale_factor"] = TINY_SF
    return cfg


def tiny_cell() -> dict:
    cell = copy.deepcopy(harness.load_cell(CELL))
    cell["params"].update(warmup_requests=20, check_queries=24)
    return cell


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """The tiny store, its chains, and its answers to one cycle of requests
    (every chain in both directions, at 0.05 of the start array, so that a
    tiny result still starts from several cells), then to every chain in
    both directions from its whole start array."""
    from repro_torch import core

    cfg = tiny_cfg()
    store = harness._module("stores", "tpch")
    log, info = store.build(core, cfg, SEED, str(tmp_path_factory.mktemp("tpch") / "store"),
                            "cpu")
    gen = harness._module("traffic", "paths").requests(
        {"selectivity": 0.05, "merge": True}, info, np.random.default_rng([SEED, 2]))
    reqs = list(itertools.islice(gen, 2 * len(info["chains"])))
    for c, chain in enumerate(info["chains"]):
        for path, shape in ((chain["path"], chain["shapes"][0]),
                            (chain["path"][::-1], chain["shapes"][-1])):
            reqs.append({"path": path, "workflow": c, "cells": np.stack(
                np.unravel_index(np.arange(int(np.prod(shape))), shape), axis=1)})
    answers = [log.prov_query(r["path"], r["cells"], merge=True) for r in reqs]
    yield cfg, log, info, reqs, answers
    log.close()


def test_program_matches_reference_on_every_chain_both_ways(built):
    cfg, _, info, reqs, answers = built
    edges, shapes = harness._module("stores", "tpch").reference_edges(cfg, SEED)
    n = 2 * len(info["chains"])
    assert sorted((r["workflow"], r["path"][0] in tpch.BASE_TABLES) for r in reqs[:n]) == \
        sorted((c, fwd) for c in range(len(info["chains"])) for fwd in (True, False))
    empty = set()
    for k, (req, res) in enumerate(zip(reqs, answers)):
        src, dst = req["path"][0], req["path"][-1]
        want = oracle.propagate(edges, src, dst,
                                np.ravel_multi_index(req["cells"].T, shapes[src]), shapes)
        np.testing.assert_array_equal(harness.answer_cells(res), want)
        if k >= n and not want.size:
            empty.add(info["chains"][req["workflow"]]["name"])
    # from a whole start array two chains are empty, both ways: no Q3
    # output column reads a customer cell, no Q10 output column an order's
    assert empty == {"q3_customer", "q10_orders"}


def test_tiny_cell_reads_correct():
    r = run_tiny(CELL, 2**33 + 3, cell=tiny_cell(), cfg=tiny_cfg())
    assert r["correct"] is True and r["attempted"] > 0
    assert r["checks"]["wrong_answers"] == {"value": 0, "limit": 0}
    assert r["checks"]["answers_checked"]["value"] >= 2


def test_control_reads_not_correct():
    """The control (answers widened to their bounding box) fails the cell's
    comparison."""
    r = run_tiny(CELL, 9, cell=tiny_cell(), cfg=tiny_cfg(), control=True)
    assert r["correct"] is True
    assert r["control"]["wrong_answers"] > r["checks"]["wrong_answers"]["limit"]


def test_chains_are_the_configs_workflows(built):
    cfg, _, info, _, _ = built
    full = harness.load_config("tpch_lineage")
    assert [c["name"] for c in info["chains"]] == [w["name"] for w in full["workflows"]]
    assert len(info["chains"]) == 10
    for chain, wf in zip(info["chains"], full["workflows"]):
        assert chain["path"][1:] == [op[1]["out"] for op in wf["ops"]]
        assert len(chain["shapes"]) == len(chain["path"])
        base = chain["path"][0]
        assert wf["input"] == full["tables"][base]["shape"]
        assert chain["shapes"][0][1] == wf["input"][1] == len(tpch.COLUMNS[base])
    # the start tables at the configuration's own scale factor
    tables = tpch.generate(full["scale_factor"], SEED)
    for name, spec in full["tables"].items():
        rows, cols = spec["shape"]
        assert tables[name].shape[1] == cols
        if name == "lineitem":
            assert abs(tables[name].shape[0] - rows) < 0.02 * rows
        else:
            assert tables[name].shape[0] == rows


def test_groups_and_joins(built):
    _, log, _, _, _ = built
    assert log.arrays["q1_out"].shape == (4, 10)
    assert log.arrays["q12_out"].shape == (2, 3)
    joins = [op for op in log.ops if op.op_name == "join"]
    assert len(joins) == 6
    for op in joins:
        assert len(op.in_arrs) == 2 and len(op.lineage_ids) == 2
        assert {(log.lineage[i].src, log.lineage[i].dst) for i in op.lineage_ids} == \
            {(a, op.out_arrs[0]) for a in op.in_arrs}
    assert all(op.reused is None for op in log.ops)


# --------------------------------------------------------------------------- #
# The reference against per-row Python loops
# --------------------------------------------------------------------------- #
def _pairs(rel) -> set:
    return {(tuple(o), tuple(i)) for o, i in zip(rel.out_idx.tolist(), rel.in_idx.tolist())}


def _small(seed=5):
    rng = np.random.default_rng(seed)
    left = tpch.Table("left", ("k", "a", "b"),
                      np.stack([rng.integers(0, 40, 50), rng.integers(0, 9, 50),
                                rng.integers(0, 99, 50)], axis=1))
    right = tpch.Table("right", ("k2", "c"),
                       np.stack([rng.integers(0, 40, 300), rng.integers(0, 5, 300)], axis=1))
    return left, right


def test_filter_pairs_by_loop():
    _, t = _small()
    mask = t.col("c") >= 2
    out, (rel,) = tpch.select(t, mask, "f")
    want, rows = set(), []
    for r in range(t.shape[0]):
        if mask[r]:
            for c in range(t.shape[1]):
                want.add(((len(rows), c), (r, c)))
            rows.append(t.data[r])
    assert _pairs(rel) == want and rel.n_pairs == len(want)
    np.testing.assert_array_equal(out.data, np.array(rows))


@pytest.mark.parametrize("probe", ["right", "left"])
def test_join_pairs_by_loop(probe):
    left, right = _small()
    if probe == "left":  # the larger input is probed
        left, right = (tpch.Table("left", right.columns, right.data),
                       tpch.Table("right", left.columns, left.data))
    lcol, rcol = left.columns[0], right.columns[0]
    out, (rel_l, rel_r) = tpch.join(left, right, lcol, rcol, "j")
    nl = left.shape[1]
    want_l, want_r, rows = set(), set(), []
    big, small = (right, left) if probe == "right" else (left, right)
    for p in range(big.shape[0]):
        for b in range(small.shape[0]):
            lr, rr = (b, p) if probe == "right" else (p, b)
            if left.data[lr, 0] != right.data[rr, 0]:
                continue
            t = len(rows)
            want_l |= {((t, c), (lr, c)) for c in range(nl)}
            want_r |= {((t, nl + c), (rr, c)) for c in range(right.shape[1])}
            rows.append(np.concatenate([left.data[lr], right.data[rr]]))
    assert rows and _pairs(rel_l) == want_l and _pairs(rel_r) == want_r
    np.testing.assert_array_equal(out.data, np.array(rows))
    assert rel_l.out_shape == rel_r.out_shape == out.shape


def test_group_by_pairs_by_loop():
    t, _ = _small()
    select_list = ("a", ("s", "sum", ("b", "k"), lambda x: x.col("b") * x.col("k")),
                   ("m", "avg", ("b",), lambda x: x.col("b")), ("n", "count", (), None))
    out, (rel,) = tpch.group_by(t, ("a",), select_list, "g")
    gid, sums, bsum, counts = {}, [], [], []
    want = set()
    for r in range(t.shape[0]):
        key = int(t.data[r, 1])
        if key not in gid:
            gid[key] = len(gid)
            sums.append(0), bsum.append(0), counts.append(0)
        g = gid[key]
        sums[g] += int(t.data[r, 2] * t.data[r, 0])
        bsum[g] += int(t.data[r, 2])
        counts[g] += 1
        want |= {((g, 0), (r, 1)), ((g, 1), (r, 2)), ((g, 1), (r, 0)), ((g, 2), (r, 2)),
                 ((g, 3), (r, 1))}
    assert _pairs(rel) == want and rel.n_pairs == len(want)
    want_rows = [[k, sums[g], bsum[g] * 100 // counts[g], counts[g]] for k, g in gid.items()]
    np.testing.assert_array_equal(out.data, np.array(want_rows))
    assert out.columns == ("a", "s", "m", "n")


def test_order_by_pairs_by_loop():
    t, _ = _small()
    out, (rel,) = tpch.order_by(t, (("a", True), ("b", False)), "o")
    perm = sorted(range(t.shape[0]), key=lambda r: (-t.data[r, 1], t.data[r, 2], r))
    want = {((i, c), (r, c)) for i, r in enumerate(perm) for c in range(t.shape[1])}
    assert _pairs(rel) == want
    np.testing.assert_array_equal(out.data, t.data[perm])


def test_one_seed_gives_one_store():
    cfg = tiny_cfg()
    (ta, oa), (tb, ob), (tc, _) = (tpch.build(cfg, s) for s in (SEED, SEED, SEED + 1))
    for name in tpch.BASE_TABLES:
        np.testing.assert_array_equal(ta[name].data, tb[name].data)
    assert [(o.op, o.inputs, o.output) for o in oa] == [(o.op, o.inputs, o.output) for o in ob]
    for a, b in zip(oa, ob):
        for ra, rb in zip(a.rels, b.rels):
            np.testing.assert_array_equal(ra.out_idx, rb.out_idx)
            np.testing.assert_array_equal(ra.in_idx, rb.in_idx)
    assert not np.array_equal(ta["lineitem"].data, tc["lineitem"].data)


def test_tables_follow_the_spec():
    t = tpch.generate(0.002, SEED)
    c, o, li = t["customer"], t["orders"], t["lineitem"]
    assert (c.shape, o.shape, t["nation"].shape) == ((300, 8), (3000, 9), (25, 4))
    assert (o.col("o_custkey") % 3 != 0).all()
    assert np.all(np.diff(li.col("l_orderkey")) >= 0)
    per_order = np.bincount(np.searchsorted(o.col("o_orderkey"), li.col("l_orderkey")))
    assert per_order.min() >= 1 and per_order.max() <= 7
    odate = o.col("o_orderdate")[np.searchsorted(o.col("o_orderkey"), li.col("l_orderkey"))]
    ship, commit, receipt = li.col("l_shipdate"), li.col("l_commitdate"), li.col("l_receiptdate")
    assert ((ship - odate >= 1) & (ship - odate <= 121)).all()
    assert ((commit - odate >= 30) & (commit - odate <= 90)).all()
    assert ((receipt - ship >= 1) & (receipt - ship <= 30)).all()
    flag = li.col("l_returnflag")
    late = receipt > tpch.CURRENTDATE
    assert (flag[late] == tpch.RETURNFLAGS.index("N")).all()
    assert set(flag[~late].tolist()) == {tpch.RETURNFLAGS.index("R"), tpch.RETURNFLAGS.index("A")}
    assert (li.col("l_linestatus") == (ship > tpch.CURRENTDATE)).all()
