"""Milliseconds a query spends in the program's ``planner.assemble`` span (``_assemble_node``: a node's frontier, with the hop feedback and a
``merge_boxes`` per query):
the span's wall time from ``prov_query(trace=True)``, summed over the
window's queries and divided by their number.  None where no query opened
it (the CPU path opens no ``ops.*`` span: its joins take the numpy twin)."""

NAME, UNIT, BETTER, SOURCE = "planner.assemble_ms_per_query", "ms", "lower", "program_span"
LAYER, MOVES = "core/planner.py", "query_p95_ms"
SPAN = "planner.assemble"

# what it reads on the shared fake run of test_perfbench_metrics.py
CASE = {"reads": 0.009 / 20 * 1e3}


def read(run):
    return run.span_ms_per_query(SPAN)
