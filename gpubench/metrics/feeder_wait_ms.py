"""Mean host wait of the train loop on the device feeder a step in the
window (the loader's rolling prefetch behind it), in ms."""

UNIT = "ms"


def read(run):
    if run.driver != "train" or not run.feeder_wait_s:
        return None
    return 1e3 * sum(run.feeder_wait_s) / len(run.feeder_wait_s)
