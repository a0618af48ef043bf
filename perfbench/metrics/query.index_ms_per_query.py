"""Milliseconds a query spends in the program's ``query.index`` span (the interval index: its probe and candidate estimate in the route
decision, and ``IntervalIndex.candidate_pairs``):
the span's wall time from ``prov_query(trace=True)``, summed over the
window's queries and divided by their number.  None where no query opened
it (the CPU path opens no ``ops.*`` span: its joins take the numpy twin)."""

NAME, UNIT, BETTER, SOURCE = "query.index_ms_per_query", "ms", "lower", "program_span"
LAYER, MOVES = "core/index.py", "query_p95_ms"
SPAN = "query.index"

# what it reads on the shared fake run of test_perfbench_metrics.py
CASE = {"reads": 0.010 / 20 * 1e3}


def read(run):
    return run.span_ms_per_query(SPAN)
