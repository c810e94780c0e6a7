"""Spans inside the train step and the model: where its device time goes,
by phase and by layer.

A span is on exactly while a `torch.profiler` session runs, as the
process-wide flag ``torch.autograd.profiler._is_profiler_enabled`` says
(the thread-local ``torch._C._autograd._profiler_enabled()`` reads False on
autograd's device thread, where a CUDA backward pass runs). Off, `span` and
`layer` read that flag and return a shared null context: no event, no
profiler range, no autograd node, so the step's graph and numbers are
those of a program without spans.

On, a span enters a `torch.profiler.record_function` range of its name
(the profiler's timeline, where the idle gaps are labelled) and marks its
start and end twice: with `mark` (a CUDA event on the current stream once
the process has initialised CUDA, else the host clock) and with the host
clock. It keeps its name, its parent and the index of the ``step`` span it
belongs to; the spans stay in memory, nothing reads them while the step
runs, and `summary` reads them once. The first span opened after the module
last saw the profiler off starts a fresh record, so each profiler session
holds only its own steps.

A layer's span (`layer`) is a ``with`` block in the forward pass, and again
in a period's recompute under remat, which runs inside the backward pass.
Its backward span runs from the gradient reaching the layer's output to
the gradient reaching its input: two identity autograd functions, put on
the output and on the input only while the spans are on, open and close
it. A parent is the innermost span open on the thread; a span opened on a
thread with none open (autograd's device thread) takes the innermost span
of the thread that opened the step. The step's thread waits in
`torch.autograd.grad` while that thread runs the backward pass, so the two
never open or close spans at once.

`StepClock` marks step boundaries by the same `mark`.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass

import torch
from torch.autograd import profiler as _profiler

STEP = "step"


# --------------------------------------------------------------------------- #
# Marks on the timeline
# --------------------------------------------------------------------------- #
def mark(cuda: bool):
    """A point on the timeline: a CUDA event recorded on the current stream,
    or the host clock."""
    if cuda:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev
    return time.perf_counter()


def elapsed_ms(a, b) -> float:
    """Milliseconds from mark `a` to mark `b` (two CUDA events once both
    have run on the card)."""
    if isinstance(a, float):
        return (b - a) * 1e3
    return a.elapsed_time(b)


class StepClock:
    """Step boundaries: marks on `device` read once at the end, so the loop
    never waits for the card."""

    def __init__(self, device: torch.device) -> None:
        self.device = device
        self.marks: list = []

    def mark(self) -> None:
        self.marks.append(mark(self.device.type == "cuda"))

    def step_ms(self) -> list[float]:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return [elapsed_ms(a, b) for a, b in zip(self.marks, self.marks[1:])]


# --------------------------------------------------------------------------- #
# The record
# --------------------------------------------------------------------------- #
@dataclass(eq=False)
class Span:
    name: str
    step: int                      # index of the `step` span it belongs to (-1: none)
    parent: Span | None
    backward: bool                 # opened in the backward pass by a layer's identity
    start: object                  # `mark`s
    host_start: float
    end: object = None
    host_end: float | None = None
    range: object = None           # the profiler range while open


_record: list[Span] = []
_step = -1
_seen_off = True
_stacks: dict[int, list[Span]] = {}     # thread ident -> its open spans
_step_stack: list[Span] = []            # the open spans of the thread that opened the step


def reset() -> None:
    """Forget every recorded span."""
    global _step, _step_stack
    _record.clear()
    _stacks.clear()
    _step, _step_stack = -1, []


def _stack() -> list[Span]:
    return _stacks.setdefault(threading.get_ident(), [])


def _open(name: str, backward: bool = False) -> Span:
    global _seen_off, _step, _step_stack
    if _seen_off:
        reset()
        _seen_off = False
    stack = _stack()
    if name == STEP:
        _step += 1
        _step_stack = stack
    parent = stack[-1] if stack else (_step_stack[-1] if _step_stack else None)
    rf = torch.profiler.record_function(name)
    rf.__enter__()
    span = Span(name, _step, parent, backward, mark(torch.cuda.is_initialized()),
                time.perf_counter(), range=rf)
    stack.append(span)
    _record.append(span)
    return span


def _close(span: Span) -> None:
    span.end = mark(not isinstance(span.start, float))
    span.host_end = time.perf_counter()
    span.range.__exit__(None, None, None)
    span.range = None
    stack = _stack()
    for i in range(len(stack) - 1, -1, -1):
        if stack[i] is span:
            del stack[i:]
            break


def on() -> bool:
    """Whether spans record: a profiler session is running."""
    global _seen_off
    if _profiler._is_profiler_enabled:
        return True
    _seen_off = True
    return False


# --------------------------------------------------------------------------- #
# Spans
# --------------------------------------------------------------------------- #
class _Off:
    """The shared null span and null layer."""

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        return None

    def input(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def output(self, y: torch.Tensor) -> torch.Tensor:
        return y


_OFF = _Off()


class _On:
    def __init__(self, name: str) -> None:
        self.name = name
        self.span: Span | None = None

    def __enter__(self):
        self.span = _open(self.name)
        return self

    def __exit__(self, *exc) -> None:
        _close(self.span)


def span(name: str):
    """A ``with`` block timed as span `name` while a profiler session runs."""
    return _On(name) if on() else _OFF


class _Layer(_On):
    """A layer's span: the ``with`` block in the forward pass, and in the
    backward pass from the gradient reaching `output`'s result to the
    gradient reaching `input`'s."""

    def __init__(self, name: str) -> None:
        super().__init__(name)
        self.closes = False        # `input` put the closing identity in
        self.backward: Span | None = None

    def input(self, x: torch.Tensor) -> torch.Tensor:
        if not (torch.is_grad_enabled() and x.requires_grad):
            return x
        self.closes = True
        return _CloseInBackward.apply(x, self)

    def output(self, y: torch.Tensor) -> torch.Tensor:
        if not (self.closes and y.requires_grad):
            return y
        return _OpenInBackward.apply(y, self)


def layer(name: str, enabled: bool = True):
    """Span `name` around a layer, in the forward and the backward pass:

        with spans.layer("layer.mlp") as s:
            out = s.output(mlp(s.input(h)))

    `input` and `output` are identities (views of their argument); while
    the spans are on and `input`'s tensor needs a gradient, their backward
    passes open and close the layer's backward span. `enabled` False gives
    the null layer."""
    return _Layer(name) if enabled and on() else _OFF


class _OpenInBackward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, lay):
        ctx.lay = lay
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        if on():
            ctx.lay.backward = _open(ctx.lay.name, backward=True)
        return g, None


class _CloseInBackward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, lay):
        ctx.lay = lay
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if ctx.lay.backward is not None:
            _close(ctx.lay.backward)
            ctx.lay.backward = None
        return g, None


# --------------------------------------------------------------------------- #
# Reading
# --------------------------------------------------------------------------- #
def _family(name: str) -> str:
    return name.split(".", 1)[0]


def spans() -> list[Span]:
    """The closed spans of the record, in the order they opened."""
    return [s for s in _record if s.end is not None]


def summary(host: bool = False) -> dict[str, dict[int, float]]:
    """Milliseconds by span name and step index, of the closed spans
    recorded since the current or last profiler session began: device time
    (the host clock where the spans ran on the CPU), or with `host` the host
    clock. Waits for the spans' events; the record stays. A span's time
    leaves out its children of its own family (the name's first part) that
    are not named under it: a ``layer.*`` span opened inside another (a
    recompute inside a layer's backward pass) counts to its own name, so
    each layer's sum holds its forward, recompute and backward once."""
    closed = spans()
    if not host and any(not isinstance(s.start, float) for s in closed):
        torch.cuda.synchronize()
    total = {s: (s.host_end - s.host_start) * 1e3 if host else elapsed_ms(s.start, s.end)
             for s in closed}
    own = dict(total)
    for s in closed:
        p = s.parent
        if p in total and _family(p.name) == _family(s.name) and \
                not s.name.startswith(p.name + "."):
            own[p] -= total[s]
    out: dict[str, dict[int, float]] = {}
    for s in closed:
        by_step = out.setdefault(s.name, {})
        by_step[s.step] = by_step.get(s.step, 0.0) + own[s]
    return out
