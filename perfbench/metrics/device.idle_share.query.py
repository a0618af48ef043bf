"""The share of the traced window in which no kernel, copy or set ran on the
card (1 - the union of the profiler's device intervals over the window)."""

NAME, UNIT, BETTER, SOURCE = "device.idle_share.query", "%", "lower", "device_trace"
LAYER, MOVES = "device", "queries_per_s"

# what it reads on the shared fake run of test_perfbench_metrics.py
CASE = {"reads": 65.0}


def read(run):
    tl = run.timeline
    if not tl or not tl.get("busy_s") or not run.queries:
        return None
    return 100.0 * (1.0 - tl["busy_s"] / tl["window_s"])
