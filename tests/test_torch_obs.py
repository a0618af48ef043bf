"""The port's query tracing (``repro_torch.obs.trace``) on the CPU.

A traced path query on a small store, with the batched executor pinned
to ``engine="kernel"`` so that the ``ops.*`` spans run around the
kernels' plain PyTorch versions: the span tree, the answers with tracing
on and off, the off path's cost in objects, the ``dslog::`` ranges on the
profiler's timeline, and the counters beside the spans (bytes uploaded,
joins by route, the store build's stage timers).
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

import repro_torch.core.capture as C
import repro_torch.core.catalog as cat
import repro_torch.core.query as Q
import repro_torch.obs.trace as obs_trace
from repro_torch.kernels import ops

SHAPE = (80, 80)
# every span the executor opens below ``execute``, and its kind
NEW_SPANS = {
    "planner.init": "planner",
    "query.prepare": "query",
    "query.index": "query",
    "query.route": "query",
    "kernel_launch": "kernel",
    "ops.pack": "ops",
    "ops.upload": "ops",
    "ops.launch": "ops",
    "ops.extract": "ops",
    "query.finalize": "query",
    "planner.assemble": "planner",
    "query.canonical": "query",
}
ROUTES = ("joins_index", "joins_dense_kernel", "joins_dense_twin")


def _store(**kw) -> tuple[cat.DSLog, list[str]]:
    """``a0 -sort-> a1 -transpose-> a2 -reduce-> a3`` on 80 x 80 cells: the
    sort's table (6,255 rows, its index built) takes the interval index for
    a few cells, the other two the dense kernel."""
    log = cat.DSLog(store_forward=True, device="cpu", **kw)
    log.views.enabled = False
    log.planner._executor = Q.BatchedJoinExecutor(
        stats=log._bump, device="cpu", tuner=log.autotune, engine="kernel"
    )
    rels = [
        C.sort_lineage(np.random.default_rng(7).random(SHAPE)),
        C.transpose_lineage(SHAPE, (1, 0)),
        C.reduce_lineage(SHAPE, 1),
    ]
    names = [f"a{k}" for k in range(len(rels) + 1)]
    log.define_array(names[0], rels[0].in_shape)
    for k, rel in enumerate(rels):
        log.define_array(names[k + 1], rel.out_shape)
        log.add_lineage(names[k], names[k + 1], rel, op_name=f"op{k}")
    log.lineage[0].forward.key_index()
    return log, names


CELLS = np.array([[0, 0], [3, 5], [3, 6], [17, 2]])


def _parent_of(trace) -> dict[int, str]:
    parents = {}
    for sp in trace.root.walk():
        for child in sp.children:
            parents[id(child)] = sp.name
    return parents


def test_span_tree_of_a_traced_query():
    log, names = _store()
    _, tr = log.prov_query(names, CELLS, trace=True)
    parents = _parent_of(tr)
    by_name: dict[str, list] = {}
    for sp in tr.root.walk():
        by_name.setdefault(sp.name, []).append(sp)
    assert set(NEW_SPANS) <= set(by_name), sorted(by_name)
    for name, kind in NEW_SPANS.items():
        for sp in by_name[name]:
            assert sp.kind == kind and sp.duration is not None and sp.duration >= 0
            assert sp.delta == {}  # only plan and execute snapshot counters
            want = "kernel_launch" if name.startswith("ops.") else "execute"
            assert parents[id(sp)] == want, (name, parents[id(sp)])
    (plan,), (execute,) = by_name["plan"], by_name["execute"]
    assert plan.kind == "plan" and execute.kind == "execute"
    assert not plan.children  # nothing new opens inside the plan span
    assert execute.delta  # it still records the counters that moved
    assert {s.kind for s in tr.spans()} & {"plan", "execute"} == {"plan", "execute"}
    assert len(tr.spans("plan")) == len(tr.spans("execute")) == 1
    assert len(by_name["kernel_launch"]) == 2  # one a wave of the two dense hops
    for launch in by_name["kernel_launch"]:
        assert set(launch.attrs) == {"backend", "segments", "geometry", "launches", "rows"}
        assert launch.attrs["backend"] == "cpu" and launch.attrs["launches"] == 1
        # the launch span holds no finalize: it ends before its segments'
        for fin in by_name["query.finalize"]:
            assert fin.start >= launch.start + launch.duration or \
                fin.start + fin.duration <= launch.start
    assert "kernel_launch" in tr.render()


def test_answers_equal_with_tracing_on_and_off():
    log, names = _store()
    for form in ((names, CELLS), (names[0], names[-1], CELLS), (names[::-1], CELLS[:, :1])):
        off = log.prov_query(*form)
        on, _ = log.prov_query(*form, trace=True)
        assert on.shape == off.shape
        assert on.lo.tobytes() == off.lo.tobytes() and on.hi.tobytes() == off.hi.tobytes()


def test_canonical_span_records_the_boxes_it_cut():
    log, names = _store()
    rows = []
    for form in ((names, CELLS), (names[::-1], CELLS[:, :1])):
        res, tr = log.prov_query(*form, trace=True)
        (sp,) = [s for s in tr.root.walk() if s.name == "query.canonical"]
        assert set(sp.attrs) == {"boxes_in", "boxes_out"}
        assert sp.attrs["boxes_in"] >= 1
        assert sp.attrs["boxes_out"] == res.n_rows
        rows.append(res.n_rows)
    assert max(rows) > 1


def test_tracing_off_makes_no_span_and_no_profiler_range(monkeypatch):
    log, names = _store()
    log.prov_query(names, CELLS)  # build the index before counting
    made, entered = [], []
    real_span = obs_trace.Span
    real_rf, real_fast = torch.profiler.record_function, torch._C._profiler._RecordFunctionFast

    class CountingSpan(real_span):
        __slots__ = ()

        def __init__(self, *a, **kw):
            made.append(1)
            super().__init__(*a, **kw)

    class CountingRange(real_rf):
        def __enter__(self):
            entered.append(self.name)
            return super().__enter__()

    class CountingFastRange:
        def __init__(self, name, *a):
            self.name, self.inner = name, real_fast(name, *a)

        def __enter__(self):
            entered.append(self.name)
            return self.inner.__enter__()

        def __exit__(self, *exc):
            return self.inner.__exit__(*exc)

    monkeypatch.setattr(obs_trace, "Span", CountingSpan)
    monkeypatch.setattr(torch.profiler, "record_function", CountingRange)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", CountingFastRange)
    log.prov_query(names, CELLS)
    log.prov_query(names[0], names[-1], CELLS, batched=False)
    assert made == [] and entered == []
    # traced but no profiler recording: spans, and still no range
    log.prov_query(names, CELLS, trace=True)
    assert made and entered == []
    assert obs_trace.active() is None
    # traced while the profiler records: a range for every span but the
    # root (the hop events are leaves without a scope)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        _, tr = log.prov_query(names, CELLS, trace=True)
    scoped = [s.name for s in tr.root.walk() if s is not tr.root and s.kind != "hop"]
    assert sorted(entered) == sorted(f"dslog::{n}" for n in scoped)


def test_profiler_timeline_holds_program_ranges(tmp_path):
    log, names = _store()
    log.prov_query(names, CELLS)  # build the index outside the profile
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        log.prov_query(names, CELLS, trace=True)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())
    events = events["traceEvents"] if isinstance(events, dict) else events
    ranges = [e for e in events if e.get("ph") == "X"
              and str(e.get("name", "")).startswith("dslog::")]
    names_seen = {e["name"][len("dslog::"):] for e in ranges}
    assert set(NEW_SPANS) | {"plan", "execute"} <= names_seen
    assert "query" not in names_seen  # the root is not mirrored

    def within(inner, outer):
        return outer["ts"] <= inner["ts"] and \
            inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]

    (execute,) = [e for e in ranges if e["name"] == "dslog::execute"]
    launches = [e for e in ranges if e["name"] == "dslog::kernel_launch"]
    for e in ranges:
        name = e["name"][len("dslog::"):]
        if name in NEW_SPANS:
            assert within(e, execute), name
        if name.startswith("ops."):
            assert any(within(e, k) for k in launches), name


def test_per_hop_entry_point_spans_and_uploaded_bytes():
    rng = np.random.default_rng(3)
    q_lo = rng.integers(0, 50, (37, 3))
    r_lo = rng.integers(0, 50, (29, 3))
    q_hi, r_hi = q_lo + 4, r_lo + 4
    tr = obs_trace.QueryTrace()
    before = ops.h2d_bytes
    with obs_trace.activated(tr):
        qi, ri = ops.range_join_pairs(q_lo, q_hi, r_lo, r_hi, device="cpu")
    assert ops.h2d_bytes - before == (37 + 29) * 128 * 4
    assert [s.name for s in tr.root.children] == [
        "ops.pack", "ops.upload", "ops.launch", "ops.extract"]
    assert obs_trace.active() is None
    # the same join through the segmented entry point, untraced: same bytes
    before = ops.h2d_bytes
    (pairs,), info = ops.segmented_range_join_pairs(
        [(q_lo, q_hi, r_lo, r_hi)], device="cpu", layout="dense")
    assert ops.h2d_bytes - before == (37 + 29) * 128 * 4
    assert np.array_equal(pairs[0], qi) and np.array_equal(pairs[1], ri)


@pytest.mark.parametrize("batched", [True, False])
def test_route_counters_add_up_to_the_plan_joins(batched):
    log, names = _store()
    plan = log.planner.plan_path(names, batched=batched)
    joins = sum(len(step.choices) for steps in plan.steps.values() for step in steps)
    assert joins == 3
    before = {k: log.io_stats[k] for k in ROUTES}
    log.prov_query(names, CELLS, batched=batched)
    moved = {k: log.io_stats[k] - before[k] for k in ROUTES}
    assert sum(moved.values()) == joins
    # the sort's 6,255-row table takes the index for four cells; on the CPU
    # the executor's dense joins run the kernel's plain version, the
    # per-hop loop's numpy
    dense = "joins_dense_kernel" if batched else "joins_dense_twin"
    assert moved == {"joins_index": 1, dense: 2,
                     ({*ROUTES} - {"joins_index", dense}).pop(): 0}


def test_store_build_times_each_stage(tmp_path):
    log = cat.DSLog.open(str(tmp_path / "store"), device="cpu", store_forward=True)
    reused = 0
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for i in range(4):
            log.define_array(f"x{i}", (6, 4))
            log.define_array(f"y{i}", (6, 4))
            rec = log.register_operation(
                "neg", [f"x{i}"], [f"y{i}"],
                capture=lambda: {(0, 0): C.identity_lineage((6, 4))})
            reused += rec.reused is not None
    log.commit()
    # the stage timers are ranges on the profiler's timeline too
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())
    events = events["traceEvents"] if isinstance(events, dict) else events
    seen = {e["name"] for e in events if str(e.get("name", "")).startswith("dslog::")}
    assert {f"dslog::ingest.{s}" for s in
            ("capture", "compress", "derive_forward", "serialize", "wal_append")} <= seen
    assert reused >= 2
    derived = [e for e in log.lineage.values() if e.reused_from is not None]
    assert len(derived) == reused and all(e.forward is not None for e in derived)
    hist = lambda stage: log.metrics.histogram("ingest_seconds", stage=stage)  # noqa: E731
    assert hist("derive_forward").count == reused
    assert hist("capture").count == hist("compress").count == 4 - reused
    assert hist("serialize").count >= 2 * 4 and hist("wal_append").count > 0
    assert hist("derive_forward").total > 0
    log.close()
