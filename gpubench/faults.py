"""Faults planted in the program's timed path, for the checks that `correct`
comes out false (the tests, on the CPU) and for the readings the limits are
set against (`calibrate.py`, on the card). Each is a context manager that
patches the program and restores it on exit.
"""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def _patched(owner, name: str, make):
    orig = getattr(owner, name)
    setattr(owner, name, make(orig))
    try:
        yield
    finally:
        setattr(owner, name, orig)


def half_batch():
    """The loss of a training step over half of the batch's rows, its mean
    taken over the rest."""
    from repro_torch.models.api import Model

    def make(orig):
        def loss(self, params, batch, **kw):
            return orig(self, params, {k: v[: v.shape[0] // 2] for k, v in batch.items()}, **kw)
        return loss
    return _patched(Model, "loss", make)


def train_state_unchanged():
    """A training step that computes its metrics and returns its state as it
    got it."""
    import repro_torch.train as train

    def make(orig):
        def build(*args, **kw):
            step = orig(*args, **kw)

            def unchanged(state, batch):
                return state, step(state, batch)[1]
            return unchanged
        return build
    return _patched(train, "build_train_step", make)
