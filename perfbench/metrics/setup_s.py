"""Set-up: from process start to the window's start (torch and CUDA
initialisation, the kernel library, the store built from the seed, the
warm-up)."""

NAME, UNIT, BETTER, SOURCE = "setup_s", "s", "lower", "host_clock"


def read(run):
    return run.setup_s
