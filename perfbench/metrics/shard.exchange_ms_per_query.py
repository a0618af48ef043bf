"""Milliseconds a query spends in the program's ``shard.exchange`` span (a
sharded plan's boundary crossings: the shipped frontier's ``merge_boxes``
and the exchange's metering): the span's wall time from
``prov_query(trace=True)``, summed over the window's queries and divided by
their number.  None where no query opened it (a single store has no
exchange)."""

NAME, UNIT, BETTER, SOURCE = "shard.exchange_ms_per_query", "ms", "lower", "program_span"
LAYER, MOVES = "core/shard.py", "query_p95_ms"
SPAN = "shard.exchange"

# what it reads on the shared fake run of test_perfbench_metrics.py
CASE = {"sets": {"span_s": {SPAN: 0.013}, "span_n": {SPAN: 126}}, "reads": 0.013 / 20 * 1e3}


def read(run):
    return run.span_ms_per_query(SPAN)
