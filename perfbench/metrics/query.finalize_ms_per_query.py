"""Milliseconds a query spends in the program's ``query.finalize`` span (``_finalize_batch``: de-relativized or inverted key boxes scattered to
their owners):
the span's wall time from ``prov_query(trace=True)``, summed over the
window's queries and divided by their number.  None where no query opened
it (the CPU path opens no ``ops.*`` span: its joins take the numpy twin)."""

NAME, UNIT, BETTER, SOURCE = "query.finalize_ms_per_query", "ms", "lower", "program_span"
LAYER, MOVES = "core/query.py", "query_p95_ms"
SPAN = "query.finalize"

# what it reads on the shared fake run of test_perfbench_metrics.py
CASE = {"reads": 0.008 / 20 * 1e3}


def read(run):
    return run.span_ms_per_query(SPAN)
