"""Median duration of the ``execute`` span of ``prov_query(trace=True)``."""

import statistics

NAME, UNIT, BETTER, SOURCE = "query.execute_ms", "ms", "lower", "program_span"
LAYER, MOVES = "core/query.py", "query_p95_ms"

# what it reads on the shared fake run of test_perfbench_metrics.py
CASE = {"reads": 20.0}


def read(run):
    return statistics.median(run.execute_s) * 1e3 if run.execute_s else None
