"""Median over the window's steps of the device time between CUDA events
recorded at step boundaries, read once after the window, in ms."""

import statistics

UNIT = "ms"


def read(run):
    if run.driver != "train" or not run.step_ms:
        return None
    return statistics.median(run.step_ms)
