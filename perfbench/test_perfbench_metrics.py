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
    # idle: 1000-1025 (plan 10 µs then execute at the midpoint 1012.5), 1040-1075 in
    # execute (midpoint 1057.5), 1095-1100 outside every span
    assert tl["idle_gaps"] == pytest.approx({"execute": 60e-6, "harness": 5e-6})
    # a gap whose midpoint lies in a request but outside its plan and execute
    # reads "request"
    ev = _trace_events() + [
        {"ph": "X", "cat": "user_annotation", "name": "pb::request", "ts": 1095, "dur": 4}]
    assert tracing.timeline(ev)["idle_gaps"]["request"] == pytest.approx(5e-6)


def _fake_run():
    run = harness.Run("fig89.query_wide", 1, 10.0, True, "cuda")
    run.setup_s, run.window_s = 12.5, 2.0
    run.latencies = [0.01 * (i + 1) for i in range(20)]
    run.queries = 20
    run.counters = {"view_hits": 1, "cache_hits": 1, "cache_misses": 19,
                    "launches.range_join_mask": 30, "launches.range_join_tile_masks": 10}
    run.plan_self_s = [0.001, 0.003, 0.002]
    run.execute_s = [0.010, 0.030, 0.020]
    run.timeline = tracing.timeline(_trace_events())
    run.bound_s = {"range_join_mask": 5e-6, "range_join_tile_masks": 4e-6}
    return run


EXPECTED = {
    "setup_s": 12.5,
    "query_p95_ms": float(np.percentile([0.01 * (i + 1) for i in range(20)], 95)) * 1e3,
    "queries_per_s": 10.0,
    "planner.plan_ms": 2.0,
    "query.execute_ms": 20.0,
    "query.launches_per_query": 2.0,
    "ops.host_ms_per_query": (30e-6 - 10e-6) / 20 * 1e3,
    "range_join_mask_roofline": 50.0,
    "device.idle_share.query": 65.0,
}


@pytest.mark.parametrize("name", harness.listing()["metrics"])
def test_reader_on_a_fake_run(name):
    assert harness.metric_reader(name).read(_fake_run()) == pytest.approx(EXPECTED[name])


@pytest.mark.parametrize("name", harness.listing()["metrics"])
def test_reader_finds_nothing_in_an_empty_run(name):
    run = harness.Run("x", 1, 1.0, True, "cuda")
    assert harness.metric_reader(name).read(run) is None


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
