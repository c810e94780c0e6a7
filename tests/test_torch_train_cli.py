"""The port's training driver (`python -m repro_torch.launch.train`) on the
CPU: it trains from the simulated object store, checkpoints, resumes from
its newest checkpoint to the uninterrupted run's losses, and prints the
JAX driver's line format."""

from __future__ import annotations

import json
import math
import os
import re
import shutil
import subprocess
import sys

import pytest
import torch

from repro_torch.ckpt import latest_step
from repro_torch.io import open_store
from repro_torch.launch import train

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--steps", "4", "--batch", "2", "--seq-len", "32", "--ckpt-interval", "2",
         "--log-every", "1"]


def _run(module: str, args: list[str]) -> subprocess.CompletedProcess:
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src"), "JAX_PLATFORMS": "cpu"}
    res = subprocess.run([sys.executable, "-m", module, *args], capture_output=True,
                         text=True, env=env, cwd=REPO, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    return res


def _shape(line: str) -> str:
    return re.sub(r"\d+(\.\d+)?(e[-+]\d+)?", "#", line)


def test_driver_trains_resumes_and_prints_the_reference_format(tmp_path):
    uri = f"local://{tmp_path / 'ckpt'}"
    first = _run("repro_torch.launch.train", ["--device", "cpu", *SMALL, "--ckpt-store", uri])
    lines = first.stdout.splitlines()
    steps = [ln for ln in lines if ln.startswith("step=")]
    assert [ln.split()[0] for ln in steps] == ["step=1", "step=2", "step=3", "step=4"]
    assert any(ln.startswith("loader fs stats: {") for ln in lines)
    assert re.fullmatch(r"done: 4 steps, 256 tokens, \d+\.\ds wall", lines[-1])

    ref = _run("repro.launch.train", [*SMALL, "--ckpt-store", f"local://{tmp_path / 'ref'}"])
    ref_lines = [ln for ln in ref.stdout.splitlines() if not ln.startswith("loader fs stats")]
    assert [_shape(ln) for ln in ref_lines] == \
        [_shape(ln) for ln in lines if not ln.startswith("loader fs stats")]

    again = _run("repro_torch.launch.train",
                 ["--device", "cpu", "--steps", "6", "--batch", "2", "--seq-len", "32",
                  "--ckpt-interval", "2", "--log-every", "1", "--ckpt-store", uri])
    assert "resumed from step 4" in again.stderr
    assert [ln.split()[0] for ln in again.stdout.splitlines() if ln.startswith("step=")] == \
        ["step=5", "step=6"]
    assert again.stdout.splitlines()[-1].startswith("done: 6 steps, 128 tokens,")
    assert latest_step(open_store(uri), "ckpt") == 6


def test_resumed_run_matches_the_uninterrupted_run(tmp_path):
    """A second run from the step-4 checkpoint of an 8-step run (copied
    alone into a store of its own; the schedule depends on --steps, so both
    runs ask for 8): its losses equal steps 5-8 of the first, bit for bit
    (CPU arithmetic repeats), and each checkpoint's cursor counts exactly
    the windows its steps used, though the feeder reads ahead."""
    args = ["--device", "cpu", "--batch", "2", "--seq-len", "32", "--ckpt-interval", "4",
            "--steps", "8"]
    whole = train.main([*args, "--ckpt-store", f"local://{tmp_path / 'a'}"])
    shutil.copytree(tmp_path / "a" / "ckpt" / "step_00000004",
                    tmp_path / "b" / "ckpt" / "step_00000004")
    rest = train.main([*args, "--ckpt-store", f"local://{tmp_path / 'b'}"])
    assert (whole.start_step, rest.start_step) == (0, 4)
    assert rest.restore_s is not None and whole.restore_s is None
    assert len(whole.losses) == 8 and len(rest.losses) == 4
    assert rest.losses == whole.losses[4:]
    assert rest.grad_norms == whole.grad_norms[4:] and rest.lrs == whole.lrs[4:]
    assert len(whole.step_ms) == 8 and len(whole.feeder_wait_s) == 8
    assert whole.tokens == 8 * 2 * 32 and rest.tokens == 4 * 2 * 32
    for step in (4, 8):
        with open(tmp_path / "a" / "ckpt" / f"step_{step:08d}" / "MANIFEST.json") as f:
            manifest = json.load(f)
        assert manifest["extra"]["cursor"] == {"epoch": 0, "windows_emitted": 2 * step}
        # params, opt.step, opt.m, opt.v
        assert len(manifest["leaves"]) == 3 * 11 + 1


def test_driver_with_microbatches_runs(tmp_path, capsys):
    res = train.main(["--device", "cpu", "--steps", "2", "--batch", "4", "--seq-len", "16",
                      "--microbatches", "2", "--log-every", "1",
                      "--ckpt-store", f"local://{tmp_path / 'c'}"])
    assert len(res.losses) == 2 and all(torch.isfinite(torch.tensor(res.losses)))
    assert "step=2 " in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "jamba-1.5-large-398b"])
def test_driver_trains_moe_on_cpu(tmp_path, arch):
    """One step of a reduced MoE config through the driver."""
    res = train.main(["--arch", arch, "--device", "cpu", "--steps", "1",
                      "--batch", "2", "--seq-len", "16", "--log-every", "1",
                      "--ckpt-store", f"local://{tmp_path / 'm'}"])
    assert len(res.losses) == 1 and math.isfinite(res.losses[0])


def test_driver_needs_a_card_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises((RuntimeError, AssertionError)):
        train.main(["--steps", "1", "--batch", "2", "--seq-len", "16",
                    "--ckpt-store", f"local://{tmp_path / 'd'}"])
