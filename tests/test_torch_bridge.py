"""Carrying JAX parameters into the port, and the port's isolation from the
JAX package: nothing under src/repro_torch/, nor chip_smoke.py, imports
`jax` or `repro`."""

from __future__ import annotations

import ast
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.bridge import params_from_numpy, tensor_from_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "src", "repro_torch")


def test_mixed_dtype_tree_round_trips_bit_exact():
    rng = np.random.default_rng(0)
    tree = {
        "b": {"w": jnp.asarray(rng.standard_normal((3, 4), dtype=np.float32), jnp.bfloat16)},
        "a": {"x": jnp.asarray(rng.standard_normal(5, dtype=np.float32)),
              "n": jnp.asarray(rng.integers(-9, 9, (2, 2)), jnp.int32)},
        "empty": {},
    }
    got = params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")
    # jax.tree.map hands the dict over with its keys sorted; values follow keys.
    assert sorted(got) == ["a", "b", "empty"] and got["empty"] == {}
    assert got["b"]["w"].dtype == torch.bfloat16
    assert got["a"]["x"].dtype == torch.float32 and got["a"]["n"].dtype == torch.int32
    back = np.asarray(tree["b"]["w"]).view(np.uint16)
    np.testing.assert_array_equal(got["b"]["w"].view(torch.int16).numpy().view(np.uint16), back)
    np.testing.assert_array_equal(got["a"]["x"].numpy(), np.asarray(tree["a"]["x"]))
    np.testing.assert_array_equal(got["a"]["n"].numpy(), np.asarray(tree["a"]["n"]))


def test_tensors_are_writable_copies():
    a = np.asarray(jnp.arange(4, dtype=jnp.float32))   # read-only view of JAX's buffer
    t = tensor_from_numpy(a, "cpu")
    t += 1
    np.testing.assert_array_equal(a, np.arange(4, dtype=np.float32))


def _port_files() -> list[str]:
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PORT):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: os.path.relpath(p, REPO))
def test_port_source_imports_neither_jax_nor_repro(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), f"{path}:{node.lineno} imports {name}"


def test_importing_the_port_loads_neither_jax_nor_repro():
    code = ("import sys, repro_torch, repro_torch.serve, repro_torch.launch.serve, "
            "repro_torch.kernels.ops, repro_torch.bridge; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')))")
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src")}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=REPO, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]"
