"""The dry-run's serving cells against the JAX package's `lower_cell`, on
the CPU, on torch's ``fake`` process group of 256 ranks (pod16x16).

Each config is cut to 2 layers (jamba to 8, its block pattern), on both
sides, as tests/dryrun_reference_compare.py cuts it; the reference runs in
a subprocess that forces 512 host devices before importing JAX, beside the
port's trace.

- smollm-135m-2l and whisper-large-v3-2l decode_32k and
  jamba-1.5-large-398b-8l long_500k: per-chip product FLOPs equal to the
  reference's dots to the last digit, the Mamba decode step's ``y = C h``
  included (a batched product on both sides), and `model_flops` equal. Before the vocab-sharded lookup and the weight
  gathered over the batch's axis (`layers._lookup`,
  `layers._gathered_over_batch`) the first two were 1.075x and 1.439x the
  reference; before the P·V split over the idle data axis
  (`layers._pv_split_over_idle_axes`) jamba's was 1.542x.
- mamba2-1.3b-2l long_500k (one token): no collective in the traced graph
  whose output holds a whole embedding table (``padded_vocab * d_model``
  elements; the lookup gathered the 206.6 MB table onto every rank before),
  and the collective bytes a chip at or under `LONG_500K_COLL_LIMIT`. The
  other cells above hold no whole-table collective either.

The limits are PERF.md §6's, written there before the repairs.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys

import pytest
import torch

from repro_torch.configs import base, get_config
from repro_torch.launch import dryrun
from repro_torch.roofline.graph_parse import COLLECTIVES
from dryrun_reference_compare import REFERENCE

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LONG_500K_COLL_LIMIT = 1.4e7       # B a chip; 2.196e8 before the sharded lookup
FLOPS_CELLS = [("smollm-135m", 2, "decode_32k"), ("whisper-large-v3", 2, "decode_32k"),
               ("jamba-1.5-large-398b", 8, "long_500k")]


def _register(arch: str, layers: int) -> str:
    name = f"{arch}-{layers}l"
    if name not in base.all_configs():
        base.register(dataclasses.replace(get_config(arch), num_layers=layers, name=name))
    return name


def _whole_table_collectives(gm, cfg) -> list:
    """The traced graph's collectives whose output holds a whole table."""
    table = cfg.padded_vocab() * cfg.d_model
    out = []
    for n in gm.graph.nodes:
        target = n.target
        if (n.op == "call_function" and isinstance(target, torch._ops.OpOverload)
                and target.namespace == "_c10d_functional"
                and target._schema.name.split("::")[-1] in COLLECTIVES):
            val = n.meta.get("val")
            if isinstance(val, torch.Tensor) and val.numel() == table:
                out.append((n.name, tuple(val.shape)))
    return out


@pytest.mark.parametrize("arch,layers,shape", FLOPS_CELLS,
                         ids=[f"{a}-{n}l-{s}" for a, n, s in FLOPS_CELLS])
def test_serving_cell_flops_match_reference(arch, layers, shape):
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src"), "JAX_PLATFORMS": "cpu"}
    ref = subprocess.Popen([sys.executable, "-c", REFERENCE, arch, shape, str(layers), "1", "0"],
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
                           cwd=REPO)
    try:
        name = _register(arch, layers)
        got, gm = dryrun.lower_cell(name, shape, verbose=False)
        out, err = ref.communicate(timeout=300)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    assert ref.returncode == 0, err[-3000:]
    want = json.loads(out.strip().splitlines()[-1])
    assert got["model_flops_total"] == want["model_flops"]
    assert got["flops_per_chip"] == want["flops"], (got["flops_per_chip"], want["flops"])
    assert _whole_table_collectives(gm, get_config(name)) == []


def test_long_500k_moves_no_table():
    name = _register("mamba2-1.3b", 2)
    got, gm = dryrun.lower_cell(name, "long_500k", verbose=False)
    assert _whole_table_collectives(gm, get_config(name)) == []
    assert got["coll_bytes_per_chip"] <= LONG_500K_COLL_LIMIT, got["coll_bytes_per_chip"]
