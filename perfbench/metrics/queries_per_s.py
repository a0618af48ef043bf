"""Every query the window completed, over the whole window."""

NAME, UNIT, BETTER, SOURCE = "queries_per_s", "queries/s", "higher", "host_clock"

# what it reads on the shared fake run of test_perfbench_metrics.py
CASE = {"reads": 10.0}


def read(run):
    if not run.latencies:
        return None
    return len(run.latencies) / run.window_s
