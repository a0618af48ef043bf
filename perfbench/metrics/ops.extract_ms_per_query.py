"""Milliseconds a query spends in the program's ``ops.extract`` span (``kernels/ops.py``'s pair extraction: ``nonzero``, the wait for the
device, the copy back and the host split of the pairs):
the span's wall time from ``prov_query(trace=True)``, summed over the
window's queries and divided by their number.  None where no query opened
it (the CPU path opens no ``ops.*`` span: its joins take the numpy twin)."""

NAME, UNIT, BETTER, SOURCE = "ops.extract_ms_per_query", "ms", "lower", "program_span"
LAYER, MOVES = "kernels/ops.py", "query_p95_ms"
SPAN = "ops.extract"

# what it reads on the shared fake run of test_perfbench_metrics.py
CASE = {"reads": 0.006 / 20 * 1e3}


def read(run):
    return run.span_ms_per_query(SPAN)
