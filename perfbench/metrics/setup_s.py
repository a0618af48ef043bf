"""Set-up: from process start to the window's start (torch and CUDA
initialisation, the kernel library, the store built from the seed, the
warm-up)."""

NAME, UNIT, BETTER, SOURCE = "setup_s", "s", "lower", "host_clock"

# what it reads on the shared fake run of test_perfbench_metrics.py
CASE = {"reads": 12.5}


def read(run):
    return run.setup_s
