"""Median self time of the ``plan`` span of ``prov_query(trace=True)``."""

import statistics

NAME, UNIT, BETTER, SOURCE = "planner.plan_ms", "ms", "lower", "program_span"
LAYER, MOVES = "core/planner.py", "query_p95_ms"

# what it reads on the shared fake run of test_perfbench_metrics.py
CASE = {"reads": 2.0}


def read(run):
    return statistics.median(run.plan_self_s) * 1e3 if run.plan_self_s else None
