"""Milliseconds a query spends in the program's ``ops.pack`` span (the int32 checks, tile bills and packing of both dense entry points of
``kernels/ops.py`` (the query side's pack, the resident table packs'
getters, and a miss's one-time fill and upload of a table side)):
the span's wall time from ``prov_query(trace=True)``, summed over the
window's queries and divided by their number.  None where no query opened
it (the CPU path opens no ``ops.*`` span: its joins take the numpy twin)."""

NAME, UNIT, BETTER, SOURCE = "ops.pack_ms_per_query", "ms", "lower", "program_span"
LAYER, MOVES = "kernels/ops.py", "query_p95_ms"
SPAN = "ops.pack"

# what it reads on the shared fake run of test_perfbench_metrics.py
CASE = {"reads": 0.004 / 20 * 1e3}


def read(run):
    return run.span_ms_per_query(SPAN)
