"""Milliseconds a query spends in the program's ``ops.upload`` span (the host-to-device copies of the packs in ``kernels/ops.py``'s dense
entry points (the query side's alone where the table side is resident)):
the span's wall time from ``prov_query(trace=True)``, summed over the
window's queries and divided by their number.  None where no query opened
it (the CPU path opens no ``ops.*`` span: its joins take the numpy twin)."""

NAME, UNIT, BETTER, SOURCE = "ops.upload_ms_per_query", "ms", "lower", "program_span"
LAYER, MOVES = "kernels/ops.py", "query_p95_ms"
SPAN = "ops.upload"

# what it reads on the shared fake run of test_perfbench_metrics.py
CASE = {"reads": 0.002 / 20 * 1e3}


def read(run):
    return run.span_ms_per_query(SPAN)
