"""The port's examples under examples/torch/ on the CPU: the quickstart is
the JAX package's on the port's imports and runs to its end; the training
example survives its injected crash and finishes every step."""

from __future__ import annotations

import importlib.util
import math
import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "examples")


def _load(name: str):
    path = os.path.join(EXAMPLES, "torch", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"torch_example_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_is_the_references_on_the_ports_imports():
    with open(os.path.join(EXAMPLES, "quickstart.py")) as f:
        want = re.sub(r"\bfrom repro\.", "from repro_torch.", f.read())
    want = want.replace("python examples/quickstart.py", "python examples/torch/quickstart.py")
    with open(os.path.join(EXAMPLES, "torch", "quickstart.py")) as f:
        assert f.read() == want


def test_quickstart_runs():
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src")}
    res = subprocess.run([sys.executable, os.path.join(EXAMPLES, "torch", "quickstart.py")],
                         capture_output=True, text=True, env=env, cwd=REPO, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "sequential:" in res.stdout and "(16000 streamlines)" in res.stdout
    assert "model-predicted speed-up" in res.stdout


def test_training_example_survives_its_crash():
    """Reduced smollm-135m, 40 steps, a crash at step 20: one restart,
    every step finished, finite losses. The restart resumes from the
    step-20 checkpoint if its write-behind save committed in time, else
    from the start, so the run logs 40 or 60 losses."""
    mod = _load("train_lm_e2e")
    result = mod.train(mod.parse_args(["--device", "cpu", "--steps", "40", "--batch", "4",
                                       "--seq-len", "64"]))
    assert result.restarts == 1 and result.final_step == 40
    assert len(result.losses) in (40, 60)
    assert all(math.isfinite(x) for x in result.losses)


def test_serve_batched_example_quantizes_and_drains_its_queue(capsys):
    """The JAX package's serve_batched example on the port: reduced
    smollm-135m restored through rolling prefetch, its 7 weight tensors
    quantized to int8, and 10 requests of 8 or 16 tokens drained through
    the wave-batched engine, every token id in range."""
    results = _load("serve_batched").main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "int8-quantized 7 weight tensors" in out and out.rstrip().endswith("OK")
    assert sorted(r.rid for r in results) == list(range(10))
    from repro_torch.configs import get_config

    vocab = get_config("smollm-135m").reduced().vocab_size
    for r in results:
        assert r.prompt_len in (8, 16) and 4 <= len(r.tokens) <= 9
        assert r.tokens.min() >= 0 and r.tokens.max() < vocab


def _checkpoint_steps(path: str) -> list[tuple]:
    """The example's checkpoint calls in source order, each with its
    constant arguments (the prefix and the step), a restore counted alike
    whether it goes through `restore_checkpoint` or `restore_resharded`."""
    import ast

    names = {"save_checkpoint": "save", "restore_checkpoint": "restore",
             "restore_resharded": "restore", "snapshot_resharded": "snapshot",
             "latest_step": "latest"}
    with open(path) as f:
        tree = ast.parse(f.read())
    calls = [node for node in ast.walk(tree) if isinstance(node, ast.Call)
             and getattr(node.func, "id", None) in names]
    calls.sort(key=lambda node: (node.lineno, node.col_offset))
    return [(names[c.func.id], *(a.value for a in c.args if isinstance(a, ast.Constant)))
            for c in calls]


def _sections(path: str) -> list[str]:
    with open(path) as f:
        heads = [ln.strip() for ln in f if ln.strip().startswith("# --- ")]
    return [re.sub(r"[:\s-]*(\d+ x \d+)?\s*-*$", "", h) for h in heads]


def test_elastic_restore_keeps_the_references_steps():
    """The port's example goes through the JAX package's sections in order,
    and saves, restores, snapshots and reads the latest step of the same
    checkpoint prefix and steps."""
    ref = os.path.join(EXAMPLES, "elastic_restore.py")
    port = os.path.join(EXAMPLES, "torch", "elastic_restore.py")
    assert _sections(port) == _sections(ref) and len(_sections(ref)) == 4
    assert _checkpoint_steps(port) == _checkpoint_steps(ref) == [
        ("save", "elastic", 0), ("restore", "elastic"), ("snapshot", "elastic", 1),
        ("latest", "elastic")]


def test_elastic_restore_runs_on_eight_cpu_ranks():
    """`--device cpu`: 8 gloo ranks, (4, 2) to (2, 4), every rank joined,
    and rank 0's report ending in OK."""
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src")}
    res = subprocess.run([sys.executable, os.path.join(EXAMPLES, "torch", "elastic_restore.py"),
                          "--device", "cpu"], capture_output=True, text=True, env=env, cwd=REPO,
                         timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    lines = res.stdout.strip().splitlines()
    assert lines[0] == "saved on mesh {'data': 4, 'model': 2} (8 cpu ranks)"
    assert lines[1].startswith("restored onto mesh {'data': 2, 'model': 4} by TRAIN_RULES: "
                               "values identical")
    assert lines[-1] == "OK: elastic restore verified; post-reshard snapshot committed"
