"""Every query the window completed, over the whole window."""

NAME, UNIT, BETTER, SOURCE = "queries_per_s", "queries/s", "higher", "host_clock"


def read(run):
    if not run.latencies:
        return None
    return len(run.latencies) / run.window_s
