"""CPU test of the span readers (`gpubench/metrics/*_ms.train.py`): the
program's spans record only under the profiler, each traced run reads its own
steps, and mamba2's blocks have no FFN span."""

from __future__ import annotations

import json
import statistics

import pytest

from gpubench import harness
from test_gpubench_harness import MODELS, _run, make_mini

SPAN_METRICS = {"forward_ms.train": "step.forward", "backward_ms.train": "step.backward",
                "optimizer_ms.train": "step.optimizer", "mixer_ms.train": "layer.mixer",
                "mlp_ms.train": "layer.mlp", "loss_head_ms.train": "layer.loss_head"}


@pytest.fixture
def mini(tmp_path, monkeypatch):
    # As in test_gpubench_harness: the test process may hold JAX.
    monkeypatch.setattr(harness, "loaded_forbidden", lambda: [])
    return make_mini(tmp_path)


def test_traced_runs_read_their_own_spans(mini):
    """An untraced run leaves no step, and each of two traced runs in one
    process reads its own traced steps alone; mamba2's blocks have no FFN
    span."""
    from repro_torch import spans

    root, bench, cells = mini
    spans.reset()
    _run(root, bench, cells["olmo-1b"])
    assert "step" not in spans.summary()
    units = json.loads((root / "traffic" / "train_mini.json").read_text())["trace_units"]
    before: list = []           # held, so that no id is reused
    for model in MODELS:
        line = _run(root, bench, cells[model], trace=True)
        rec = spans.spans()
        assert sum(s.name == "step" for s in rec) == units
        assert not {id(s) for s in before} & {id(s) for s in rec}
        before = rec
        ms = spans.summary()
        assert sorted(ms["step"]) == list(range(units))
        for metric, name in SPAN_METRICS.items():
            if name in ms:
                want = statistics.median(ms[name][k] for k in ms["step"])
                assert line["metrics"][metric]["value"] == want
    assert "layer.mlp" not in ms and "mlp_ms.train" not in line["metrics"]
