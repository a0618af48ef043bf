"""The sharded configuration ``fig89_sharded4`` at the test sizes, on the
CPU: its traced cell reads correct and records the exchange, its answers
are the single store's and the reference's as sets of cells, and a cold
load of its closed store answers alike (the durability guarantee)."""

import itertools

import numpy as np
import pytest

from perfbench import harness
from perfbench.reference import oracle
from perfbench.testing import run_tiny, tiny_cell, tiny_config

CELL = "fig89_sharded4.query_wide"
SEED = 2**34 + 29


def test_config_is_fig89_store_sharded():
    cfg, single = harness.load_config("fig89_sharded4"), harness.load_config("fig89_store")
    assert cfg["kind"] == "sharded_workflows" and cfg["workflows"] == single["workflows"]
    assert (cfg["store"]["n_shards"], cfg["store"]["policy"]) == (4, "hash")
    assert {k: v for k, v in cfg["store"].items() if k not in ("open", "n_shards", "policy")} \
        == {k: v for k, v in single["store"].items() if k != "open"}
    assert set(single["guarantees"]) < set(cfg["guarantees"])
    assert cfg["reduced"] == [] and set(single["assumed"]) < set(cfg["assumed"])


def test_cell_reports_the_wide_cells_metrics_and_the_exchange():
    """The sharded cell runs every layer ``fig89.query_wide`` runs, so it
    reports each of that cell's metrics, and the exchange's besides."""
    bench = harness.benchmark()
    names = {(c, trace): [m["name"] for m in harness.cell_metrics(bench, c, trace)]
             for c in (CELL, "fig89.query_wide") for trace in (False, True)}
    assert names[(CELL, False)] == names[("fig89.query_wide", False)]
    assert names[(CELL, True)] == names[("fig89.query_wide", True)] + [
        "shard.exchange_ms_per_query", "shard.boxes_exchanged_per_query"]


def test_traced_tiny_run_records_the_exchange(monkeypatch):
    runs = []

    class Kept(harness.Run):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            runs.append(self)

    monkeypatch.setattr(harness, "Run", Kept)
    r = run_tiny(CELL, 2**33 + 11, trace=True)
    (run,) = runs
    assert r["correct"] is True and run.queries > 0
    assert r["checks"]["wrong_answers"] == {"value": 0, "limit": 0}
    assert run.span_n["shard.exchange"] >= run.queries
    for name in ("shard.exchange_ms_per_query", "shard.boxes_exchanged_per_query"):
        assert r["metrics"][name]["value"] > 0, name
    assert run.timeline["idle_gaps"]["shard.exchange"] > 0


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """Both stores of the tiny configurations from one seed, one cycle of
    the cell's requests (every workflow forward and backward), and each
    store's answers to them; the sharded store is closed after."""
    from repro_torch import core

    cell = tiny_cell(CELL)
    cfgs = {name: tiny_config(name) for name in ("fig89_sharded4", "fig89_store")}
    stores = {}
    for name, cfg in cfgs.items():
        root = str(tmp_path_factory.mktemp(name) / "store")
        log, info = harness._module("stores", cfg["kind"]).build(core, cfg, SEED, root, "cpu")
        stores[name] = (root, log, info)
    info = stores["fig89_sharded4"][2]
    assert info == stores["fig89_store"][2]
    gen = harness._module("traffic", cell["traffic_kind"]).requests(
        cell["params"], info, np.random.default_rng([SEED, 2]))
    reqs = list(itertools.islice(gen, 2 * len(info["chains"])))
    answers = {name: [log.prov_query(r["path"], r["cells"], merge=r["merge"]) for r in reqs]
               for name, (_, log, _) in stores.items()}
    assert stores["fig89_sharded4"][1].io_stats["boxes_exchanged"] > 0
    for _, log, _ in stores.values():
        log.close()
    return cfgs, stores, reqs, answers


def _want(cfg, req):
    edges, shapes = harness._module("stores", cfg["kind"]).reference_edges(cfg, SEED)
    src, dst = req["path"][0], req["path"][-1]
    cells = np.ravel_multi_index(req["cells"].T, shapes[src])
    return oracle.propagate(edges, src, dst, cells, shapes)


def test_answers_are_the_single_stores_and_the_references(built):
    cfgs, _, reqs, answers = built
    for i, req in enumerate(reqs):
        sharded = harness.answer_cells(answers["fig89_sharded4"][i])
        np.testing.assert_array_equal(sharded, harness.answer_cells(answers["fig89_store"][i]))
        np.testing.assert_array_equal(sharded, _want(cfgs["fig89_sharded4"], req))


def test_cold_load_answers_alike(built):
    from repro_torch import core

    _, stores, reqs, answers = built
    cold = core.ShardedDSLog.load(stores["fig89_sharded4"][0], device="cpu")
    assert cold.n_shards == 4 and cold.io_stats["shards_loaded"] == 0
    for i, req in enumerate(reqs):
        got = cold.prov_query(req["path"], req["cells"], merge=req["merge"])
        np.testing.assert_array_equal(harness.answer_cells(got),
                                      harness.answer_cells(answers["fig89_sharded4"][i]))
    assert cold.io_stats["shards_loaded"] == 4
    cold.close()


def test_control_reads_not_correct():
    """The control (answers widened to their bounding box) fails the
    sharded cell's comparison too."""
    r = run_tiny(CELL, 9, control=True)
    assert r["correct"] is True
    assert r["control"]["wrong_answers"] > r["checks"]["wrong_answers"]["limit"]
