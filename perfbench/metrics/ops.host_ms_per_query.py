"""Host time a query spends in ``kernels/ops.py``'s dense entry points
(packing, upload, pair extraction): the harness's own spans around the
calls ``core/query.py`` makes into them, on the host clock and synchronised
at exit, minus the device time of the kernels the profiler saw inside
them, over the window's queries."""

NAME, UNIT, BETTER, SOURCE = "ops.host_ms_per_query", "ms", "lower", "host_clock"
LAYER, MOVES = "kernels/ops.py", "query_p95_ms"

# what it reads on the shared fake run of test_perfbench_metrics.py
CASE = {"reads": (30e-6 - 10e-6) / 20 * 1e3}


def read(run):
    tl = run.timeline
    if not run.queries or not tl or not tl.get("ops_s"):
        return None
    return (tl["ops_s"] - tl["ops_kernel_s"]) / run.queries * 1e3
