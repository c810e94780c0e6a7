"""Share of the traced steps' window in which no kernel, copy or memset ran
on the card: one less the union of their intervals on the profiler's
timeline over the window, in %."""

UNIT = "%"


def read(run):
    if run.trace is None or run.driver != "train" or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
