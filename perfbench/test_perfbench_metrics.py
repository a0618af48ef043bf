"""The metric readers on a recorded fake run, the trace reduction on a fake
chrome trace, and the roofline arithmetic against a hand computation."""

import numpy as np
import pytest
import torch

from perfbench import harness, hw, roofline, tracing


def _trace_events():
    """A 100 µs window: two plan/execute queries, one ops span holding a
    10 µs kernel and a 5 µs copy, a 20 µs tile kernel outside it."""
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "pb::window", "ts": 1000, "dur": 100},
        {"ph": "X", "cat": "user_annotation", "name": "pb::request", "ts": 1000, "dur": 75},
        {"ph": "X", "cat": "user_annotation", "name": "pb::plan", "ts": 1000, "dur": 10},
        {"ph": "X", "cat": "user_annotation", "name": "pb::execute", "ts": 1010, "dur": 60},
        {"ph": "X", "cat": "user_annotation", "name": "pb::ops", "ts": 1020, "dur": 30},
        {"ph": "X", "cat": "gpu_user_annotation", "name": "pb::ops", "ts": 1020, "dur": 30},
        {"ph": "X", "cat": "kernel", "name": "void range_join_mask_kernel<Geometry<256, 4> >(int const*)",
         "ts": 1025, "dur": 10},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH (Device -> Pageable)", "ts": 1035, "dur": 5},
        {"ph": "X", "cat": "kernel", "name": "void range_join_tile_masks_kernel<G>(int)", "ts": 1075,
         "dur": 20},
        {"ph": "X", "cat": "kernel", "name": "outside", "ts": 2000, "dur": 50},
    ]
    return ev


@pytest.mark.parametrize("raw, base", [
    ("void (anonymous namespace)::range_join_mask_kernel<(anonymous namespace)::Geometry<256, 4> >"
     "(int const*, int const*, unsigned char*, long, long, int, long, long, int)",
     "range_join_mask_kernel"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<int> >(int)",
     "at::native::vectorized_elementwise_kernel"),
    ("Memcpy HtoD (Pageable -> Device)", "Memcpy HtoD"),
])
def test_kernel_base_names(raw, base):
    assert tracing.kernel_base(raw) == base


def test_timeline_reduces_a_trace():
    tl = tracing.timeline(_trace_events())
    assert tl["window_s"] == pytest.approx(100e-6)
    assert tl["busy_s"] == pytest.approx(35e-6)
    assert tl["device_s"]["range_join_mask_kernel"] == pytest.approx(10e-6)
    assert tl["device_s"]["range_join_tile_masks_kernel"] == pytest.approx(20e-6)
    assert tl["ops_s"] == pytest.approx(30e-6)
    assert tl["ops_kernel_s"] == pytest.approx(10e-6)
    # idle time goes to the innermost span at each instant: 1000-1025 is
    # plan 10 µs, execute 10, ops 5; 1040-1075 is ops 10, execute 20,
    # request 5; 1095-1100 is outside every span
    assert tl["idle_gaps"] == pytest.approx(
        {"plan": 10e-6, "execute": 30e-6, "ops": 15e-6, "request": 5e-6, "harness": 5e-6})
    # idle time inside a request but outside its plan and execute reads
    # "request"
    ev = _trace_events() + [
        {"ph": "X", "cat": "user_annotation", "name": "pb::request", "ts": 1095, "dur": 4}]
    gaps = tracing.timeline(ev)["idle_gaps"]
    assert gaps["request"] == pytest.approx(9e-6) and gaps["harness"] == pytest.approx(1e-6)


def test_timeline_names_idle_time_by_the_programs_spans():
    """A ``dslog::`` range of the program inside the harness's ``execute``
    takes the idle time under it; ``ops_s`` reads the harness's ``ops``
    spans alone, whatever program ranges lie inside them."""
    ev = _trace_events() + [
        {"ph": "X", "cat": "cpu_op", "name": "dslog::query.finalize", "ts": 1055, "dur": 10},
        {"ph": "X", "cat": "cpu_op", "name": "dslog::ops.pack", "ts": 1020, "dur": 4},
        {"ph": "X", "cat": "cpu_op", "name": "aten::nonzero", "ts": 1041, "dur": 3},
        # another thread's range is not the window's host
        {"ph": "X", "cat": "cpu_op", "name": "dslog::query.index", "ts": 1000, "dur": 100,
         "tid": 7},
    ]
    tl = tracing.timeline(ev)
    base = tracing.timeline(_trace_events())
    assert tl["idle_gaps"] == pytest.approx(
        {"plan": 10e-6, "execute": 20e-6, "query.finalize": 10e-6, "ops.pack": 4e-6,
         "ops": 11e-6, "request": 5e-6, "harness": 5e-6})
    assert sum(tl["idle_gaps"].values()) == pytest.approx(sum(base["idle_gaps"].values()))
    assert (tl["ops_s"], tl["ops_kernel_s"]) == (base["ops_s"], base["ops_kernel_s"])


def test_timeline_names_the_innermost_span_among_many():
    """Idle time under a span that opened before many finished ones still
    reads that span."""
    ev = [{"ph": "X", "cat": "user_annotation", "name": "pb::window", "ts": 0, "dur": 1000},
          {"ph": "X", "cat": "user_annotation", "name": "pb::execute", "ts": 0, "dur": 1000}]
    ev += [{"ph": "X", "cat": "cpu_op", "name": "dslog::query.route", "ts": 2 * i, "dur": 1}
           for i in range(200)]
    ev += [{"ph": "X", "cat": "kernel", "name": "k", "ts": 500, "dur": 100}]
    gaps = tracing.timeline(ev)["idle_gaps"]
    assert gaps == pytest.approx({"query.route": 200e-6, "execute": 700e-6})


def _fake_run():
    run = harness.Run("fig89.query_wide", 1, 10.0, True, "cuda")
    run.setup_s, run.window_s = 12.5, 2.0
    run.latencies = [0.01 * (i + 1) for i in range(20)]
    run.queries = 20
    run.counters = {"view_hits": 1, "cache_hits": 1, "cache_misses": 19,
                    "launches.range_join_mask": 30, "launches.range_join_tile_masks": 10,
                    "ops.h2d_bytes": 81920, "table_packs_resident": 99, "table_packs_built": 1}
    run.plan_self_s = [0.001, 0.003, 0.002]
    run.execute_s = [0.010, 0.030, 0.020]
    run.span_s = {"plan": 0.04, "execute": 0.4, "query.prepare": 0.005, "query.index": 0.010,
                  "query.route": 0.001, "kernel_launch": 0.016, "ops.pack": 0.004,
                  "ops.upload": 0.002, "ops.launch": 0.003, "ops.extract": 0.006,
                  "query.finalize": 0.008, "planner.assemble": 0.009, "query.canonical": 0.012}
    run.span_n = {name: 20 for name in run.span_s} | {"cache_probe": 20}
    run.stages_s = {"capture": 0.001, "compress": 6.25, "derive_forward": 18.5}
    run.timeline = tracing.timeline(_trace_events())
    run.bound_s = {"range_join_mask": 5e-6, "range_join_tile_masks": 4e-6}
    return run


def case_run(reader):
    """The shared fake run with the fields the reader's ``CASE`` sets (a
    dict field is updated, any other replaced)."""
    run = _fake_run()
    for field, value in reader.CASE.get("sets", {}).items():
        old = getattr(run, field)
        setattr(run, field, {**old, **value} if isinstance(old, dict) else value)
    return run


@pytest.mark.parametrize("name", harness.listing()["metrics"])
def test_reader_on_a_fake_run(name):
    """Each reader declares its own case: the fields it sets on the shared
    fake run, if any (``CASE["sets"]``), and what it reads there
    (``CASE["reads"]``)."""
    reader = harness.metric_reader(name)
    assert reader.read(case_run(reader)) == pytest.approx(reader.CASE["reads"])


@pytest.mark.parametrize("name", harness.listing()["metrics"])
def test_reader_finds_nothing_in_an_empty_run(name):
    run = harness.Run("x", 1, 1.0, True, "cuda")
    assert harness.metric_reader(name).read(run) is None


@pytest.mark.parametrize("cell", ["fig89.query_wide", "fig89.query_point"])
def test_traced_tiny_run_records_program_spans(monkeypatch, cell):
    """A traced run on the CPU records the program's spans below ``execute``
    and the build's stages, and their readers read numbers; the joins take
    the numpy twin there, so no ``ops.*`` span opens."""
    from perfbench.testing import run_tiny

    runs = []

    class Kept(harness.Run):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            runs.append(self)

    monkeypatch.setattr(harness, "Run", Kept)
    r = run_tiny(cell, 2**33 + 5, trace=True)
    (run,) = runs
    assert r["correct"] is True and run.queries > 0
    for span in ("plan", "execute", "query.prepare", "query.finalize", "planner.assemble",
                 "query.canonical"):
        assert run.span_n[span] >= run.queries and run.span_s[span] > 0, span
    assert run.span_n["execute"] == run.queries
    assert not any(name.startswith("ops.") for name in run.span_n)
    assert run.stages_s["derive_forward"] > 0
    got = r["metrics"]
    for name in ("query.finalize_ms_per_query", "planner.assemble_ms_per_query",
                 "query.canonical_ms_per_query", "store.derive_forward_s"):
        assert got[name]["value"] > 0, name
    assert "ops.pack_ms_per_query" not in got
    assert got["store.derive_forward_s"]["value"] == run.stages_s["derive_forward"]


def test_roofline_by_hand():
    # 2 query boxes x 3 table boxes over 2 attributes
    q_lo = np.array([[0, 0], [5, 5]])
    q_hi = np.array([[1, 1], [6, 6]])
    r_lo = np.array([[0, 9], [1, 1], [9, 9]])
    r_hi = np.array([[0, 9], [2, 2], [9, 9]])
    # attribute 0 overlaps for (q0, r0) and (q0, r1) only; attribute 1 then
    # fails for (q0, r0): 6 cells x 2 compares, then 2 cells x 2
    assert roofline.needed_compares(torch, q_lo, q_hi, r_lo, r_hi) == 16
    assert roofline.join_bytes(2, 3, 2) == (2 + 3) * 2 * 2 * 4 + 2 * 3
    want = max(86 / hw.HBM_BYTES_PER_S, 16 / hw.COMPARES_PER_S)
    assert roofline.launch_bound_s(torch, [(q_lo, q_hi, r_lo, r_hi)] * 2) == \
        pytest.approx(max(172 / hw.HBM_BYTES_PER_S, 32 / hw.COMPARES_PER_S))
    assert roofline.bound_s(86, 16) == (pytest.approx(want), "bytes")


def test_needed_compares_in_row_blocks():
    rng = np.random.default_rng(3)
    q_lo = rng.integers(0, 50, (37, 3))
    r_lo = rng.integers(0, 50, (29, 3))
    q_hi, r_hi = q_lo + rng.integers(0, 9, (37, 3)), r_lo + rng.integers(0, 9, (29, 3))
    whole = roofline.needed_compares(torch, q_lo, q_hi, r_lo, r_hi)
    assert roofline.needed_compares(torch, q_lo, q_hi, r_lo, r_hi, rows=5) == whole
    # the same count by a loop over cells
    n = 0
    for i in range(37):
        for j in range(29):
            for a in range(3):
                n += 2
                if not (q_lo[i, a] <= r_hi[j, a] and r_lo[j, a] <= q_hi[i, a]):
                    break
    assert whole == n
