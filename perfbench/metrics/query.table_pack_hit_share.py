"""The share of the window's dense kernel segments whose table side was
already resident on the device: ``io_stats``' ``table_packs_resident`` over
it and ``table_packs_built`` (a miss, which packs and uploads the table
side).  None where neither moved."""

NAME, UNIT, BETTER, SOURCE = "query.table_pack_hit_share", "%", "higher", "program_counter"
LAYER, MOVES = "core/query.py", "query_p95_ms"

# what it reads on the shared fake run of test_perfbench_metrics.py
CASE = {"reads": 100.0 * 99 / (99 + 1)}


def read(run):
    hit = run.counters.get("table_packs_resident", 0)
    seen = hit + run.counters.get("table_packs_built", 0)
    return 100.0 * hit / seen if seen else None
