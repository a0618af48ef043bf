"""Milliseconds a query spends in the program's ``query.canonical`` span (the targets' canonical cut (``canonical_boxes``, in ``planner.execute``)):
the span's wall time from ``prov_query(trace=True)``, summed over the
window's queries and divided by their number.  None where no query opened
it (the CPU path opens no ``ops.*`` span: its joins take the numpy twin)."""

NAME, UNIT, BETTER, SOURCE = "query.canonical_ms_per_query", "ms", "lower", "program_span"
LAYER, MOVES = "core/query.py", "query_p95_ms"
SPAN = "query.canonical"

# what it reads on the shared fake run of test_perfbench_metrics.py
CASE = {"reads": 0.012 / 20 * 1e3}


def read(run):
    return run.span_ms_per_query(SPAN)
