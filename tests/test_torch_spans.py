"""The train step's spans (`repro_torch.spans`) on reduced olmo-1b and
mamba2-1.3b, on the CPU's host clock.

Off (no profiler session), the spans open nothing and put no node in the
graph. On (inside `torch.profiler.profile`), with remat on and off: the
step's loss, gradients and new state are bit-equal to the off run's, every
span closes, the spans nest as the step runs them (phases in ``step``,
each block's mixer and FFN forward in ``step.forward`` and again inside
``step.backward`` when recomputed, their backward spans in
``step.backward``), the three phases cover the step, and the names reach
the profiler's trace."""

from __future__ import annotations

import contextlib
import dataclasses
import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import spans, tree
from repro_torch.configs import get_config
from repro_torch.models import make_model
from repro_torch.train import AdamWConfig, StepConfig, build_train_step, init_train_state
from repro_torch.train import train_step as TS

ARCHS = ["olmo-1b", "mamba2-1.3b"]
LAYERS = 2
PHASES = ("step.forward", "step.backward", "step.optimizer")


def _setup(arch: str, remat: bool):
    cfg = dataclasses.replace(get_config(arch).reduced(), num_layers=LAYERS)
    model = make_model(cfg)
    state = init_train_state(model, 0, device="cpu")
    g = torch.Generator().manual_seed(1)
    batch = {k: torch.randint(0, cfg.vocab_size, (2, 32), generator=g)
             for k in ("inputs", "labels")}
    step = build_train_step(model, AdamWConfig(warmup_steps=1),
                            StepConfig(q_chunk=16, loss_chunk=16, remat=remat))
    return cfg, state, batch, step


def _one_step(monkeypatch, arch: str, remat: bool, traced: bool, trace_path=None):
    """One step; returns (new state, metrics, the gradients the optimizer got)."""
    cfg, state, batch, step = _setup(arch, remat)
    seen = {}
    real = TS.apply_updates

    def apply_updates(opt_cfg, params, grads, opt_state):
        seen["grads"] = grads
        return real(opt_cfg, params, grads, opt_state)

    monkeypatch.setattr(TS, "apply_updates", apply_updates)
    prof = profile(activities=[ProfilerActivity.CPU]) if traced else contextlib.nullcontext()
    with prof:
        new_state, metrics = step(state, batch)
    if trace_path is not None:
        prof.export_chrome_trace(str(trace_path))
    return new_state, metrics, seen["grads"]


def _bit_equal(a, b) -> bool:
    la, lb = tree.flatten(a), tree.flatten(b)
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


def _ancestors(s: spans.Span) -> list[str]:
    out = []
    while s.parent is not None:
        s = s.parent
        out.append(s.name)
    return out


def _marker_nodes(loss: torch.Tensor) -> int:
    """Nodes of the spans' identities in `loss`'s graph."""
    seen, todo, found = set(), [loss.grad_fn], 0
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        found += "InBackward" in type(node).__name__
        todo.extend(n for n, _ in node.next_functions)
    return found


@pytest.mark.parametrize("arch", ARCHS)
def test_off_opens_nothing(monkeypatch, arch):
    def refuse(*a, **k):
        raise AssertionError("a span opened with the profiler off")

    monkeypatch.setattr(spans, "_open", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    spans.reset()
    _one_step(monkeypatch, arch, remat=True, traced=False)
    assert spans.spans() == [] and spans.summary() == {}
    cfg, state, batch, _ = _setup(arch, remat=True)
    live = tree.map_leaves(lambda p: p.detach().requires_grad_(True), state.params)
    loss = make_model(cfg).loss(live, batch, q_chunk=16, loss_chunk=16, remat=True)
    assert _marker_nodes(loss) == 0
    monkeypatch.undo()
    with profile(activities=[ProfilerActivity.CPU]):
        live = tree.map_leaves(lambda p: p.detach().requires_grad_(True), state.params)
        loss = make_model(cfg).loss(live, batch, q_chunk=16, loss_chunk=16, remat=True)
        # Mixers, FFNs and the loss head: an opening and a closing identity each.
        assert _marker_nodes(loss) == 2 * (LAYERS * (1 + (arch == "olmo-1b")) + 1)
        torch.autograd.grad(loss, tree.flatten(live))


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no_remat"])
@pytest.mark.parametrize("arch", ARCHS)
def test_on_spans_nest_and_change_nothing(monkeypatch, tmp_path, arch, remat):
    off_state, off_m, off_g = _one_step(monkeypatch, arch, remat, traced=False)
    trace = tmp_path / "trace.json"
    on_state, on_m, on_g = _one_step(monkeypatch, arch, remat, traced=True, trace_path=trace)
    assert _bit_equal(off_state, on_state) and _bit_equal(off_g, on_g)
    assert all(torch.equal(off_m[k], on_m[k]) for k in off_m)

    assert all(s.end is not None for s in spans._record)
    rec = spans.spans()
    assert [s.name for s in rec if s.parent is None] == ["step"]
    assert {s.step for s in rec} == {0}
    for s in rec:
        if s.name in PHASES:
            assert s.parent.name == "step"
    blocks = {"layer.mixer": LAYERS, "layer.mlp": LAYERS if arch == "olmo-1b" else 0,
              "layer.loss_head": 1}
    for name, n in blocks.items():
        mine = [s for s in rec if s.name == name]
        back = [s for s in mine if s.backward]
        fwd = [s for s in mine if not s.backward and "step.backward" not in _ancestors(s)]
        again = [s for s in mine if not s.backward and "step.backward" in _ancestors(s)]
        assert len(back) == n and all("step.backward" in _ancestors(s) for s in back)
        assert len(fwd) == n and all(_ancestors(s)[-2:] == ["step.forward", "step"]
                                     for s in fwd)
        # A period's recompute runs its blocks' forward spans again, inside
        # the backward pass; the loss head is not recomputed.
        assert len(again) == (n if remat and name != "layer.loss_head" else 0)

    host = spans.summary(host=True)
    assert sum(host[p][0] for p in PHASES) >= 0.95 * host["step"][0]
    layers = sum(host[name][0] for name in blocks if name in host)
    assert layers <= host["step.forward"][0] + host["step.backward"][0]
    names = {e["name"] for e in json.loads(trace.read_text())["traceEvents"]
             if e.get("cat") == "user_annotation"}
    assert {"step", *PHASES, *(n for n, k in blocks.items() if k)} <= names


def test_summary_counts_nested_layers_once():
    """A layer span opened inside another (a recompute inside a layer's
    backward pass) counts to its own name only; phases hold their layers."""
    spans.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        with spans.span("step"):
            with spans.span("step.backward"):
                with spans.span("layer.mlp"):
                    with spans.span("layer.mixer"):
                        torch.ones(64, 64) @ torch.ones(64, 64)
                    with spans.span("layer.mlp"):
                        torch.ones(64, 64) @ torch.ones(64, 64)
    by = {s.name + ("/inner" if s.parent.name == "layer.mlp" else ""): s for s in spans.spans()
          if s.parent is not None}
    ms = {k: (s.host_end - s.host_start) * 1e3 for k, s in by.items()}
    got = spans.summary(host=True)
    assert got["layer.mixer"][0] == ms["layer.mixer/inner"]
    assert got["layer.mlp"][0] == pytest.approx(ms["layer.mlp"] - ms["layer.mixer/inner"])
    assert got["step.backward"][0] == ms["step.backward"]


def test_each_profiler_session_starts_a_fresh_record():
    spans.reset()
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU]):
            for _ in range(3):
                with spans.span("step"):
                    pass
        with spans.span("step"):      # off: a step outside the session
            pass
        assert sorted(spans.summary()["step"]) == [0, 1, 2]
    spans.reset()
    assert spans.summary() == {}

