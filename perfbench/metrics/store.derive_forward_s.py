"""Seconds the store's build spent deriving forward tables from reused
backward ones (``ingest_seconds{stage=derive_forward}`` of the store's
metrics registry, read once the build returns, before warm-up).  None where
the build never took that stage."""

NAME, UNIT, BETTER, SOURCE = "store.derive_forward_s", "s", "lower", "program_span"
LAYER, MOVES = "core/catalog.py", "setup_s"
STAGE = "derive_forward"

# what it reads on the shared fake run of test_perfbench_metrics.py
CASE = {"reads": 18.5}


def read(run):
    return run.stages_s.get(STAGE)
