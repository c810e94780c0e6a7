"""Tokens of every step completed in the window, over the window's span
(host clock, the card synchronised at its end)."""

UNIT = "tokens/s"


def read(run):
    if run.driver != "train" or run.steps == 0 or run.span_s <= 0:
        return None
    return run.tokens / run.span_s
