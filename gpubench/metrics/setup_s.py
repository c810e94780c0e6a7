"""Process start to the window's start: imports, weights, data, warm-up
and, in a checkout's first run, the kernels' build (host clock)."""

UNIT = "s"


def read(run):
    return run.setup_s
