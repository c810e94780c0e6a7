"""CPU tests of the port's benchmark (`gpubench/`): the training driver end
to end at reduced sizes, files found by name, planted faults and the control
judged incorrect, the yardstick's counts by hand, the references against the
port, and the imports. The numbers that decide a cell on the card are set in PERF.md from
chip runs; the limits here are the reduced models' own."""

from __future__ import annotations

import ast
import dataclasses
import json
import math
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from gpubench import calibrate, faults, harness, traffic, work
from gpubench.reference import lm as ref
from gpubench.reference.train import adamw_steps, leaves
from gpubench.weights import make_params
from repro_torch.configs import get_config

BENCH_DIR = harness.HERE
REPO = BENCH_DIR.parent
SEED = 2**31 + 12345          # larger than 32 signed bits hold
# The reduced cells' limits, set as a cell's are: above the sound readings of
# the reduced models on two seeds (loss 6.3e-4, gradient 4.9e-3, change
# 2.8e-3 at most) and below the fp8 control's loss or gradient readings
# (2.6e-3, 3.3e-2 at least).
TRAIN_LIMITS = {"loss_gap": 1.5e-3, "grad_gap": 0.015, "update_gap": 0.01}


def _mini_config(name: str, layers: int = 2) -> dict:
    c = json.loads((BENCH_DIR / "configs" / f"{name}.json").read_text())
    r = dataclasses.replace(get_config(name).reduced(), num_layers=layers)
    fields = ("num_layers", "d_model", "num_heads", "num_kv_heads", "head_dim", "d_ff",
              "vocab_size", "ssm_state", "ssm_head_dim", "ssm_chunk", "max_seq_len")
    c.update(name=f"{name}-mini", port_overrides={f: getattr(r, f) for f in fields},
             num_hidden_layers=layers, hidden_size=r.d_model, vocab_size=r.vocab_size)
    if c["block"] == "attention":
        c.update(num_attention_heads=r.num_heads, num_key_value_heads=r.num_kv_heads,
                 head_dim=r.head_dim, intermediate_size=r.d_ff)
    else:
        c.update(state_size=r.ssm_state, head_dim=r.ssm_head_dim, chunk_size=r.ssm_chunk)
    return c


def _write(path: Path, obj: dict) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(obj))


@pytest.fixture
def mini(tmp_path, monkeypatch):
    # The test process may hold JAX, which other test files import; the
    # check that a run's process holds none is tested on its own below.
    monkeypatch.setattr(harness, "loaded_forbidden", lambda: [])
    return make_mini(tmp_path)


def make_mini(tmp_path: Path):
    """A benchmark folder of reduced cells beside the real drivers and
    metrics, and its BENCHMARK.json as a dict."""
    for d in ("drivers", "metrics"):
        shutil.copytree(BENCH_DIR / d, tmp_path / d)
    for name in ("olmo-1b", "mamba2-1.3b"):
        _write(tmp_path / "configs" / f"{name}-mini.json", _mini_config(name))
    t = json.loads((BENCH_DIR / "traffic" / "train_stream.json").read_text())
    t.update(batch=2, seq_len=32, shards=2, tokens_per_shard=3000, trace_units=2)
    t["step"].update(q_chunk=16, loss_chunk=16)
    t["optimizer"].update(warmup_steps=2)
    _write(tmp_path / "traffic" / "train_mini.json", t)
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    cells = {}
    for name in ("olmo-1b", "mamba2-1.3b"):
        cell = f"{name}-mini.train_mini"
        _write(tmp_path / "workloads" / f"{cell}.json",
               {"name": cell, "config": f"{name}-mini", "traffic": "train_mini", "chips": 1,
                "why": "a reduced cell for the CPU tests", "limits": TRAIN_LIMITS})
        cells[name] = cell
    # The real cells' metric lists, mapped onto the reduced cells.
    real = {w["name"]: w["config"] for w in bench["workloads"]}
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [cells[real[w]] for w in m["workloads"]]
    return tmp_path, bench, cells


def _run(root, bench, cell, trace=False, seed=SEED, seconds=1.0):
    ctx = harness.Context(cell=harness.load_cell(cell, root), seed=seed, seconds=seconds,
                          trace=trace, device="cpu", t_start=time.perf_counter())
    return harness.execute(ctx, bench, root)


MODELS = ["olmo-1b", "mamba2-1.3b"]


@pytest.mark.parametrize("trace", [False, True], ids=["untraced", "traced"])
@pytest.mark.parametrize("model", MODELS)
def test_driver_runs_end_to_end(mini, model, trace):
    root, bench, cells = mini
    line = _run(root, bench, cells[model], trace)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    want = {m["name"] for m in harness.metrics_for(bench, cells[model], trace)}
    assert set(line["metrics"]) == want
    if trace:
        assert line["device"]["window_s"] > 0 and "breakdown" in line
    else:
        assert "setup_s" in want
    for m in line["metrics"].values():
        assert math.isfinite(m["value"]) and m["unit"]
    json.dumps(line)


def test_new_files_found_by_name(mini):
    """A configuration, a traffic mix, a cell and a metric added as files,
    with entries in BENCHMARK.json, run with no edit to the harness."""
    root, bench, _ = mini
    c = _mini_config("olmo-1b", layers=1)
    c["name"] = "olmo-1b-one-layer"
    _write(root / "configs" / "olmo-1b-one-layer.json", c)
    t = json.loads((root / "traffic" / "train_mini.json").read_text())
    t.update(seq_len=16, trace_units=1)
    _write(root / "traffic" / "train_short.json", t)
    _write(root / "workloads" / "olmo-1b-one-layer.train_short.json",
           {"name": "olmo-1b-one-layer.train_short", "config": "olmo-1b-one-layer",
            "traffic": "train_short", "chips": 1, "why": "added", "limits": TRAIN_LIMITS})
    (root / "metrics" / "steps.train.py").write_text(
        'UNIT = "steps"\n\n\ndef read(run):\n    return float(run.steps)\n')
    bench["end_to_end"][0]["workloads"].append("olmo-1b-one-layer.train_short")
    bench["per_layer"].append({"name": "steps.train", "unit": "steps", "better": "higher",
                               "source": "program_counter", "layer": "train step",
                               "moves": "train_tok_per_s"})
    untraced = _run(root, bench, "olmo-1b-one-layer.train_short")
    assert set(untraced["metrics"]) == {"train_tok_per_s", "setup_s"}
    traced = _run(root, bench, "olmo-1b-one-layer.train_short", trace=True)
    assert traced["metrics"]["steps.train"]["value"] >= 1


def test_refuses_a_process_that_holds_jax(mini, monkeypatch):
    """A run whose process holds JAX or the JAX package prints no result."""
    root, bench, cells = mini
    monkeypatch.undo()
    monkeypatch.setitem(sys.modules, "jax", type(sys)("jax"))
    with pytest.raises(harness.BenchError, match="jax"):
        _run(root, bench, cells["olmo-1b"])
    assert harness.loaded_forbidden()


FAULTS = [faults.train_state_unchanged, faults.half_batch]


@pytest.mark.parametrize("fault", FAULTS, ids=[f.__name__ for f in FAULTS])
@pytest.mark.parametrize("model", MODELS)
def test_fault_makes_run_incorrect(mini, model, fault):
    root, bench, cells = mini
    with fault():
        line = _run(root, bench, cells[model])
    assert line["correct"] is False
    failed = [k for k, v in line["checks"].items() if v["value"] > v["limit"]]
    assert failed, line["checks"]


@pytest.mark.parametrize("model", MODELS)
def test_fp8_control_reads_above_the_program(mini, model):
    """At the reduced size the fp8 reference put in the program's place
    departs from the fp32 reference by more than the bf16 program does."""
    root, _, cells = mini
    ctx = harness.Context(cell=harness.load_cell(cells[model], root), seed=SEED,
                          seconds=1.0, trace=False, device="cpu", t_start=time.perf_counter())
    drv = harness.code_file("drivers", "train", root)
    prog = drv.Program(ctx)
    side = prog.first_steps()
    prog.close()
    ref_side = drv.reference_side(ctx)
    sound = drv.compare(side, ref_side)
    control = drv.compare(drv.reference_side(ctx, ref.FP8), ref_side)
    assert control["grad_gap"] > 3 * sound["grad_gap"]
    assert control["loss_gap"] > 3 * sound["loss_gap"]


@pytest.mark.parametrize("model", MODELS)
def test_calibration_judges_control_and_fault_incorrect(mini, model):
    """The readings the limits are set from go through the checks that decide
    a run's `correct`: the program's sound, the fp8 control and half of the
    batch left out not."""
    root, _, cells = mini
    ctx = harness.Context(cell=harness.load_cell(cells[model], root), seed=SEED,
                          seconds=0.0, trace=False, device="cpu", t_start=time.perf_counter())
    rows = calibrate.readings(ctx, control=True)
    assert [(r["kind"], r["correct"]) for r in rows] == [
        ("program", True), ("control_fp8_reference", False), ("fault_half_batch", False)]


@pytest.mark.parametrize("model", MODELS)
def test_setup_runs_only_the_compared_steps(mini, model):
    root, _, cells = mini
    ctx = harness.Context(cell=harness.load_cell(cells[model], root), seed=SEED,
                          seconds=0.0, trace=False, device="cpu", t_start=time.perf_counter())
    prog = harness.code_file("drivers", "train", root).Program(ctx)
    side = prog.first_steps()
    prog.close()
    assert len(prog.metrics) == len(side["loss"]) == ctx.cell.traffic["checked_steps"]


# --------------------------------------------------------------------------- #
# The yardstick's arithmetic, by hand
# --------------------------------------------------------------------------- #
def test_model_flops_by_hand():
    olmo = json.loads((BENCH_DIR / "configs" / "olmo-1b.json").read_text())
    d, f, v, layers = 2048, 8192, 50304, 16
    per_layer = 4 * d * d + 3 * d * f
    assert work.block_matmul_params(olmo) == per_layer
    # OLMo-1B: about 1.18 B parameters with its embedding.
    assert abs(per_layer * layers + d * v - 1.18e9) < 0.01e9
    s, bsz = 2048, 8
    attn = 4 * 128 * 16 * (s * (s + 1) // 2)
    assert work.train_step_flops(olmo, bsz, s) == \
        6 * (per_layer * layers + d * v) * bsz * s + 3 * layers * attn * bsz
    mamba = json.loads((BENCH_DIR / "configs" / "mamba2-1.3b.json").read_text())
    din = 4096
    assert work.block_matmul_params(mamba) == d * (2 * din + 2 * 128 + 64) + din * d
    # Mamba-2 1.3B: about 1.34 B parameters with its tied embedding.
    total = work.block_matmul_params(mamba) * 48 + d * 50280
    assert abs(total - 1.34e9) < 0.03e9


# --------------------------------------------------------------------------- #
# The references against the port (fp32 activations on both sides)
# --------------------------------------------------------------------------- #
@pytest.fixture
def fp32_port(monkeypatch):
    from repro_torch.models import layers as L

    monkeypatch.setattr(L, "COMPUTE_DTYPE", torch.float32)


@pytest.mark.parametrize("model", MODELS)
def test_reference_forward_matches_port(fp32_port, model):
    from repro_torch.models import lm as LM
    from repro_torch.models import make_model

    c = _mini_config(model)
    cfg = harness.port_config(c)
    params = make_params(make_model(cfg).spec(), SEED, dtype=torch.float32, device="cpu")
    ids = torch.from_numpy(traffic.rng(SEED, 9).integers(0, c["vocab_size"], (2, 70)))
    with torch.no_grad(), ref.fp32_strict():
        want = ref.logits(params, c, ref.hidden(params, c, ids))
        h, _, _ = LM.lm_hidden(params, cfg, ids)
        got = LM.logits_from_hidden(params, cfg, h)[..., : c["vocab_size"]]
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()


@pytest.mark.parametrize("model", MODELS)
def test_reference_train_steps_match_port(fp32_port, model):
    from repro_torch.models import make_model
    from repro_torch.train import AdamWConfig, StepConfig, TrainState, build_train_step
    from repro_torch.train.optimizer import init_state

    c = _mini_config(model)
    cfg = harness.port_config(c)
    opt = json.loads((BENCH_DIR / "traffic" / "train_stream.json").read_text())["optimizer"]
    opt["warmup_steps"] = 2
    model_ = make_model(cfg)
    params0 = make_params(model_.spec(), SEED, dtype=torch.float32, device="cpu")
    stream = np.concatenate(traffic.token_shards(SEED, 1, 500, c["vocab_size"], "uint16"))
    batches = [tuple(torch.from_numpy(a).long() for a in traffic.batch_of(stream, k, 2, 32))
               for k in range(3)]
    step = build_train_step(model_, AdamWConfig(**opt), StepConfig(q_chunk=16, loss_chunk=16))
    state = TrainState(params0, init_state(params0))
    losses = []
    for k, (x, y) in enumerate(batches):
        state, m = step(state, {"inputs": x, "labels": y})
        losses.append(float(m["loss"]))
        if k == 0:
            scale = min(1.0, 1.0 / (float(m["grad_norm"]) + 1e-9))
            grad = torch.tensor([float(t.norm()) for t in leaves(state.opt.m)]) / (0.1 * scale)
    change = torch.tensor([float((p - q).norm()) for p, q in
                           zip(leaves(state.params), leaves(params0))], dtype=torch.float64)
    want = adamw_steps(params0, c, batches, opt, ref.FP32, chunk=16)
    assert np.allclose(losses, want["loss"].numpy(), rtol=1e-5, atol=0)
    assert torch.allclose(grad.double(), want["grad"], rtol=1e-3, atol=1e-7)
    assert torch.allclose(change, want["change"], rtol=1e-3, atol=1e-9)


# --------------------------------------------------------------------------- #
# The frame
# --------------------------------------------------------------------------- #
def test_summarize_trace_by_hand():
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": harness.WINDOW_SPAN, "ts": 0, "dur": 100,
         "tid": 1},
        {"ph": "X", "cat": "user_annotation", "name": "train.step", "ts": 0, "dur": 100, "tid": 1},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0, "dur": 20, "tid": 1},
        {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 50, "dur": 50, "tid": 1},
        {"ph": "X", "cat": "cpu_op", "name": "aten::other_thread", "ts": 0, "dur": 100, "tid": 2},
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 0, "dur": 10, "tid": 7},
        {"ph": "X", "cat": "kernel", "name": "k2", "ts": 5, "dur": 10, "tid": 7},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 30, "dur": 10, "tid": 7},
        {"ph": "X", "cat": "kernel", "name": "late", "ts": 95, "dur": 10, "tid": 7},
    ]
    s = harness.summarize_trace({"traceEvents": ev}, units=2)
    assert s.window_s == pytest.approx(100e-6) and s.busy_s == pytest.approx(30e-6)
    assert s.launches == 3 and s.kernel("k")[0] == 2
    assert s.gaps == pytest.approx({"train.step / python": 15e-6,
                                  "train.step / aten::copy_": 55e-6})


def test_metric_selection():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    names = {m["name"] for m in harness.metrics_for(bench, "olmo-1b.train_stream", False)}
    assert names == {"train_tok_per_s", "setup_s"}
    traced = harness.metrics_for(bench, "mamba2-1.3b.train_stream", True)
    assert "mfu.train" in {m["name"] for m in traced}
    assert all(m["moves"] == "train_tok_per_s" for m in traced)
    for w in bench["workloads"]:
        cell = harness.load_cell(w["name"])
        assert (cell.workload["config"], cell.workload["traffic"], cell.workload["why"]) == \
            (w["config"], w["traffic"], w["why"])
        harness.code_file("drivers", cell.traffic["driver"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert harness.code_file("metrics", m["name"]).UNIT == m["unit"]


def test_config_files_hold_the_program_widths():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        cfg = json.loads((REPO / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"] == [] and cfg["source"] == c["source"]
        harness.port_config(cfg)
        with pytest.raises(harness.BenchError):
            harness.port_config({**cfg, "hidden_size": cfg["hidden_size"] + 1})


def test_weights_repeat_from_the_seed():
    from repro_torch.models import make_model

    spec = make_model(harness.port_config(_mini_config("mamba2-1.3b"))).spec()
    a = leaves(make_params(spec, SEED, dtype=torch.bfloat16, device="cpu"))
    b = leaves(make_params(spec, SEED, dtype=torch.bfloat16, device="cpu"))
    c = leaves(make_params(spec, SEED + 1, dtype=torch.bfloat16, device="cpu"))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not all(torch.equal(x, y) for x, y in zip(a, c))
    assert all(x.dtype == torch.bfloat16 for x in a)


def test_run_refuses_without_a_card(tmp_path):
    """No result and a non-zero exit without CUDA; and in a folder that holds
    only BENCHMARK.json and the benchmark's files (no program beside it)."""
    res = subprocess.run([sys.executable, str(BENCH_DIR / "run.py"), "--workload",
                          "olmo-1b.train_stream", "--seed", "1", "--seconds", "1"],
                         capture_output=True, text=True, cwd=REPO, timeout=300)
    assert res.returncode != 0 and res.stdout.strip() == ""
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH_DIR, tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    res = subprocess.run([sys.executable, "gpubench/run.py", "--workload",
                          "olmo-1b.train_stream", "--seed", "1", "--seconds", "1"],
                         capture_output=True, text=True, cwd=tmp_path, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert res.returncode != 0 and res.stdout.strip() == ""


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".", 1)[0])
    return out


def test_no_jax_or_jax_package_imports():
    files = [p for p in BENCH_DIR.rglob("*.py") if "__pycache__" not in p.parts]
    assert {BENCH_DIR / "run.py", BENCH_DIR / "drivers" / "train.py"} <= set(files)
    for p in files:
        assert not _imports(p) & {"jax", "jaxlib", "flax", "repro"}, p
    for p in (BENCH_DIR / "reference").rglob("*.py"):
        assert "repro_torch" not in _imports(p), p


def test_fp8_rounds_coarser_than_bf16():
    x = torch.randn(4096, generator=torch.Generator().manual_seed(0)) * 0.02
    e8 = (ref.to_fp8(x) - x).norm() / x.norm()
    e16 = (x.bfloat16().float() - x).norm() / x.norm()
    assert 0.01 < e8 < 0.05 and e8 > 8 * e16
