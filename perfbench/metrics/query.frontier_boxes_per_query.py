"""Query-side boxes a query joins: ``io_stats``' ``frontier_boxes`` counter
(the pooled distinct frontier boxes of every join a query runs, by
whichever route and engine) over the window's queries.  0 where the counter
is there and did not move; None where the program has no such counter."""

NAME, UNIT, BETTER, SOURCE = "query.frontier_boxes_per_query", "count", "lower", \
    "program_counter"
LAYER, MOVES = "core/query.py", "query_p95_ms"
COUNTER = "frontier_boxes"

# what it reads on the shared fake run of test_perfbench_metrics.py
CASE = {"sets": {"counters": {COUNTER: 251600}}, "reads": 251600 / 20}


def read(run):
    if not run.queries or COUNTER not in run.counters:
        return None
    return run.counters[COUNTER] / run.queries
