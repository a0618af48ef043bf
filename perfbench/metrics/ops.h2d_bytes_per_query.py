"""Bytes ``kernels/ops.py`` hands to the device a query: its ``h2d_bytes``
counter (every pack copied host to device, the resident table packs' one-time
uploads included) over the window's queries.  None where it did not move."""

NAME, UNIT, BETTER, SOURCE = "ops.h2d_bytes_per_query", "bytes", "lower", "program_counter"
LAYER, MOVES = "kernels/ops.py", "query_p95_ms"

# what it reads on the shared fake run of test_perfbench_metrics.py
CASE = {"reads": 81920 / 20}


def read(run):
    n = run.counters.get("ops.h2d_bytes", 0)
    if not run.queries or not n:
        return None
    return n / run.queries
