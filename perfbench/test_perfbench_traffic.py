"""The traffic generators: one seed gives one request stream, and every
seed asks for the same work in another order."""

import itertools

import numpy as np
import pytest

from perfbench import harness
from perfbench.testing import tiny_config


def _info(cell):
    cfg = harness.load_config(cell["config"])
    if cell["traffic_kind"] == "paths":
        from perfbench.stores.workflows import array_names
        chains = []
        for spec in cfg["workflows"]:
            names = array_names(spec["name"], len(spec["ops"]))
            chains.append({"name": spec["name"], "path": names,
                           "shapes": [tuple(spec["input"])] * len(names)})
        return {"chains": chains}
    raise ValueError(f"no test stream for traffic kind {cell['traffic_kind']!r}")


def _stream(cell, seed, n):
    gen = harness._module("traffic", cell["traffic_kind"]).requests(
        cell["params"], _info(cell), np.random.default_rng([seed, 2]))
    return list(itertools.islice(gen, n))


def _key(req):
    out = []
    for k in sorted(req):
        v = req[k]
        if isinstance(v, np.ndarray):
            v = v.tobytes()
        elif isinstance(v, np.random.Generator):
            v = v.integers(0, 2**62)
        elif isinstance(v, list):
            v = tuple(v)
        out.append((k, v))
    return tuple(out)


# cells whose traffic kind has its generator (a cell kept as data for a later
# harness, such as fig89.ingest, has none yet)
GENERATED = [w for w in harness.listing()["workloads"]
             if harness.load_cell(w)["traffic_kind"] in harness.listing()["traffic"]]


@pytest.mark.parametrize("cell", GENERATED)
def test_generator_repeats_for_a_seed(cell):
    c = harness.load_cell(cell)
    a = [_key(r) for r in _stream(c, 2**33 + 7, 30)]
    b = [_key(r) for r in _stream(c, 2**33 + 7, 30)]
    other = [_key(r) for r in _stream(c, 5, 30)]
    assert a == b
    assert a != other


@pytest.mark.parametrize("cell", ["fig89.query_wide", "fig89.query_point"])
def test_every_seed_asks_for_the_same_work(cell):
    c = harness.load_cell(cell)
    n = 2 * len(harness.load_config(c["config"])["workflows"])
    want = sorted((w, fwd) for w in range(n // 2) for fwd in (True, False))
    for seed in (1, 2**40 + 3):
        reqs = _stream(c, seed, 2 * n)
        for cycle in (reqs[:n], reqs[n:]):
            assert sorted((r["workflow"], r["path"][0].endswith("_a0")) for r in cycle) == want


def test_tiny_configs_keep_the_workflows():
    cfg, tiny = harness.load_config("fig89_store"), tiny_config("fig89_store")
    assert [w["name"] for w in cfg["workflows"]] == [w["name"] for w in tiny["workflows"]]
    assert [[o[0] for o in w["ops"]] for w in cfg["workflows"]] == \
        [[o[0] for o in w["ops"]] for w in tiny["workflows"]]


def test_tiny_config_shrinks_workflows_of_any_store_kind():
    """A later store kind over the same workflows (a sharded one) takes the
    test sizes with no edit to ``testing.py``."""
    from perfbench.testing import shrink

    cfg = harness.load_config("fig89_store")
    cfg["kind"] = "sharded_workflows"
    small = shrink(cfg)
    assert small["kind"] == "sharded_workflows"
    assert small["workflows"] == tiny_config("fig89_store")["workflows"]
    assert small["workflows"] != cfg["workflows"]
    assert all(np.prod(w["input"]) <= 24 * 24 for w in small["workflows"])
