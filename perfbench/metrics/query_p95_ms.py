"""The 95th percentile of the latency of every query the window completed,
on the harness's clock: from the call to ``prov_query`` until the answer
is back on the host."""

import numpy as np

NAME, UNIT, BETTER, SOURCE = "query_p95_ms", "ms", "lower", "host_clock"

# what it reads on the shared fake run of test_perfbench_metrics.py
CASE = {"reads": float(np.percentile([0.01 * (i + 1) for i in range(20)], 95)) * 1e3}


def read(run):
    if not run.latencies:
        return None
    return float(np.percentile(run.latencies, 95)) * 1e3
