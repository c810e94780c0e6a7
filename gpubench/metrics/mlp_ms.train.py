"""Median over the traced steps of a step's device time in every block's FFN
(`layer.mlp`), its forward, recompute and backward summed, in ms: the
program's own CUDA events, read once after the window
(`repro_torch.spans.summary`). Nothing where the program has no such span."""

import statistics

UNIT = "ms"
SPAN = "layer.mlp"


def read(run):
    if run.driver != "train":
        return None
    try:
        from repro_torch.spans import summary
    except ImportError:             # a program without spans
        return None
    ms = summary()
    steps = ms.get("step")
    if not steps or SPAN not in ms:
        return None
    return statistics.median(ms[SPAN].get(k, 0.0) for k in steps)
