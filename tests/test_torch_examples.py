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
