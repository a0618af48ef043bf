"""The sharded planner's ``shard.exchange`` span: one span around the work
of each boundary crossing, holding that crossing's ``exchange`` event, and
nothing else changed by tracing it.

Small hash-sharded stores on the CPU: a chain of 8 x 8 arrays whose hops
cross shards under crc32 placement, and a diamond whose fan-out and fan-in
cross them.
"""

import numpy as np
import pytest

import repro_torch.core.capture as C
from repro_torch.core import DSLog
from repro_torch.core.shard import AffinityShardPolicy, HashShardPolicy, ShardedDSLog

SHAPE = (8, 8)
N_SHARDS = 4
CHAIN = [f"a{k}" for k in range(7)]
CELLS = np.array([[0, 0], [2, 3], [2, 4], [7, 7]])


def _rels():
    return [C.flip_lineage(SHAPE, 0), C.roll_lineage(SHAPE, 2, 0),
            C.transpose_lineage(SHAPE, (1, 0)), C.identity_lineage(SHAPE),
            C.roll_lineage(SHAPE, 3, 1), C.flip_lineage(SHAPE, 1)]


def _chain(log):
    for u, v, rel in zip(CHAIN, CHAIN[1:], _rels()):
        log.add_lineage(u, v, rel)
    return log


def _diamond(log):
    log.add_lineage("x", "p", C.flip_lineage(SHAPE, 0))
    log.add_lineage("x", "q", C.roll_lineage(SHAPE, 2, 1))
    log.add_lineage("p", "z", C.identity_lineage(SHAPE))
    log.add_lineage("q", "z", C.transpose_lineage(SHAPE, (1, 0)))
    return log


def _sharded(build):
    return build(ShardedDSLog(n_shards=N_SHARDS, device="cpu"))


def _query(log, form, direction, merge, trace):
    if form == "chain":
        path = CHAIN if direction == "forward" else CHAIN[::-1]
        return log.prov_query(path, CELLS, merge=merge, trace=trace)
    src, dst = ("x", "z") if direction == "forward" else ("z", "x")
    return log.prov_query(src, dst, CELLS, merge=merge, trace=trace)


BUILD = {"chain": _chain, "diamond": _diamond}
CASES = [(form, direction, merge) for form in BUILD for direction in ("forward", "backward")
         for merge in (True, False)]


def test_the_stores_cross_shards():
    pol = HashShardPolicy(N_SHARDS)
    crossing = [u for u, v in zip(CHAIN, CHAIN[1:]) if pol.shard_of(u) != pol.shard_of(v)]
    assert len(crossing) >= 3
    assert len({pol.shard_of(n) for n in "xpqz"}) >= 2
    assert _sharded(_chain).planner.plan_path(CHAIN).exchanges


@pytest.mark.parametrize("form, direction, merge", CASES)
def test_one_span_a_crossing_holds_its_event(form, direction, merge):
    log = _sharded(BUILD[form])
    _, tr = _query(log, form, direction, merge, trace=True)
    spans = [sp for sp in tr.spans() if sp.name == "shard.exchange"]
    events = tr.spans("exchange")
    assert spans and len(spans) == len(events)
    for sp in spans:
        assert sp.kind == "shard" and sp.duration is not None and sp.duration >= 0
        (ev,) = [c for c in sp.children if c.kind == "exchange"]
        assert ev.attrs["from_shard"] != ev.attrs["to_shard"]
    # every event sits inside a span, and the events' boxes are the counter's
    assert sum(ev.attrs["boxes"] for ev in events) == log.io_stats["boxes_exchanged"]


@pytest.mark.parametrize("form, direction, merge", CASES)
def test_tracing_changes_no_answer_and_no_count(form, direction, merge):
    traced, plain = _sharded(BUILD[form]), _sharded(BUILD[form])
    got, _ = _query(traced, form, direction, merge, trace=True)
    want = _query(plain, form, direction, merge, trace=False)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.lo, want.lo)
    np.testing.assert_array_equal(got.hi, want.hi)
    assert traced.io_stats["boxes_exchanged"] == plain.io_stats["boxes_exchanged"] > 0


@pytest.mark.parametrize("form", list(BUILD))
def test_no_exchange_no_span(form):
    """A single store, and a sharded one holding every array on one shard,
    open no ``shard.exchange`` span."""
    names = CHAIN if form == "chain" else list("xpqz")
    one_shard = ShardedDSLog(n_shards=N_SHARDS, device="cpu",
                             policy=AffinityShardPolicy(N_SHARDS, {n: 1 for n in names}))
    for log in (BUILD[form](DSLog(device="cpu")), BUILD[form](one_shard)):
        _, tr = _query(log, form, "forward", True, trace=True)
        assert not [sp for sp in tr.spans() if sp.name == "shard.exchange"]
        assert not tr.spans("exchange")
        assert tr.spans("query")
    assert one_shard.io_stats["boxes_exchanged"] == 0
