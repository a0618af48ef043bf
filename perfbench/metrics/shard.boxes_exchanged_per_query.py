"""Boxes a query ships across shard boundaries: ``io_stats``'
``boxes_exchanged`` counter (every merged frontier box an exchange ships in
and every result box it ships out) over the window's queries.  None where
it did not move (a single store has no exchange)."""

NAME, UNIT, BETTER, SOURCE = "shard.boxes_exchanged_per_query", "boxes", "lower", \
    "program_counter"
LAYER, MOVES = "core/shard.py", "query_p95_ms"

# what it reads on the shared fake run of test_perfbench_metrics.py
CASE = {"sets": {"counters": {"boxes_exchanged": 97300}}, "reads": 97300 / 20}


def read(run):
    n = run.counters.get("boxes_exchanged", 0)
    if not run.queries or not n:
        return None
    return n / run.queries
