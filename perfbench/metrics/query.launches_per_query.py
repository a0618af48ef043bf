"""Range-join kernel launches a query: the kernel wrappers' own launch
counters (``range_join_mask.launches``, ``range_join_tile_masks.launches``)
over the window's queries."""

NAME, UNIT, BETTER, SOURCE = "query.launches_per_query", "count", "lower", "program_counter"
LAYER, MOVES = "core/query.py", "query_p95_ms"

# what it reads on the shared fake run of test_perfbench_metrics.py
CASE = {"reads": 2.0}


def read(run):
    if not run.queries:
        return None
    n = run.counters.get("launches.range_join_mask", 0) + \
        run.counters.get("launches.range_join_tile_masks", 0)
    return n / run.queries
