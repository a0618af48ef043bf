"""Index-routed joins a query that the executor ran as a kernel segment
instead (``core/query.py``'s index-to-kernel rule on a CUDA store):
``io_stats``' ``joins_index_to_kernel`` counter over the window's queries.
0 where the counter is there and did not move; None where the program has
no such counter (the CPU path never reroutes, but it seeds the counter)."""

NAME, UNIT, BETTER, SOURCE = "query.index_to_kernel_per_query", "joins", "higher", \
    "program_counter"
LAYER, MOVES = "core/query.py", "queries_per_s"
COUNTER = "joins_index_to_kernel"

# what it reads on the shared fake run of test_perfbench_metrics.py
CASE = {"sets": {"counters": {COUNTER: 3}}, "reads": 3 / 20}


def read(run):
    if not run.queries or COUNTER not in run.counters:
        return None
    return run.counters[COUNTER] / run.queries
