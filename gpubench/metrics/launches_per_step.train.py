"""Kernels on the profiler's timeline over the traced steps, a step."""

UNIT = "launches"


def read(run):
    if run.trace is None or run.driver != "train" or run.trace.units == 0:
        return None
    return run.trace.launches / run.trace.units
