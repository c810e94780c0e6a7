"""Model FLOPs of the window's steps (`work.train_step_flops`: 6 x the
multiplied weights a token plus three times the forward mixing, no
recomputation) over the window's span times the card's bf16 peak
(989 TFLOP/s, NVIDIA H100 SXM data sheet), in %."""

from gpubench import work

UNIT = "%"


def read(run):
    if run.driver != "train" or run.steps == 0 or run.span_s <= 0:
        return None
    t = run.traffic
    flops = run.steps * work.train_step_flops(run.config, t["batch"], t["seq_len"])
    return 100.0 * flops / (run.span_s * work.PEAK_BF16_FLOPS_S)
