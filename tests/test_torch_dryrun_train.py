"""The dry-run's train cells against the JAX package's `lower_cell`, on the
CPU, on torch's ``fake`` process group of 256 ranks (pod16x16): the whole
train step (loss, remat recompute, backward, AdamW), each config cut to 2
layers on both sides, as tests/dryrun_reference_compare.py cuts it.

- smollm-135m-2l and granite-moe-3b-a800m-2l train_4k: the dominant term
  (both sides' counts over the same H100 peaks) equal to the reference's,
  collective bytes a chip at most `COLL_LIMIT` times the reference's, and
  per-chip product FLOPs equal to its dots to the last digit. Before the
  repairs both read 6.76x and 8.01x the reference's collective bytes, and
  smollm's dominant term was "collective" where the reference's is
  "memory".
- smollm-135m-2l train_4k: no collective in the traced graph moves a
  logits-shaped or a score-shaped tensor. Before, the loss's
  ``logsumexp`` gathered each 512-token chunk's fp32 logits over the
  vocabulary's ranks (an all-gather of (256, 512, 3072): the 16 model
  ranks' (16, 512, 3072) shards stacked on dim 0), and the kv_seq mode's
  backward reduce-scattered fp32 (16, 3, 512, 3, 4096) score-sized
  partial sums onto (..., 256). A functional all-gather stacks its shards
  on dim 0, so a dim 0 of 256 (16 rows times 16 ranks) says nothing of
  which dim is gathered; the check reads payload sizes and trailing dims.

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

from repro_torch.configs import SHAPES, base, get_config
from repro_torch.launch import dryrun
from repro_torch.roofline.graph_parse import COLLECTIVES
from dryrun_reference_compare import REFERENCE, dominant

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COLL_LIMIT = 2.0          # the port's collective bytes a chip over the reference's
LOSS_CHUNK = 512
CELLS = ["smollm-135m", "granite-moe-3b-a800m"]
_traced: dict = {}


def _cell(arch: str) -> tuple[dict, torch.fx.GraphModule, dict]:
    """(the port's record, its graph, the reference's record) of `arch`
    cut to 2 layers, train_4k on 16 x 16; traced once per process."""
    if arch not in _traced:
        env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src"), "JAX_PLATFORMS": "cpu"}
        ref = subprocess.Popen([sys.executable, "-c", REFERENCE, arch, "train_4k", "2", "1", "0"],
                               stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
                               cwd=REPO)
        try:
            name = f"{arch}-2l"
            if name not in base.all_configs():
                base.register(dataclasses.replace(get_config(arch), num_layers=2, name=name))
            got, gm = dryrun.lower_cell(name, "train_4k", verbose=False)
            out, err = ref.communicate(timeout=600)
        finally:
            if ref.poll() is None:
                ref.kill()
                ref.communicate()
        assert ref.returncode == 0, err[-3000:]
        want = json.loads(out.strip().splitlines()[-1])
        want["dominant"] = dominant(want["flops"], want["coll"], want["bytes"])
        _traced[arch] = (got, gm, want)
    return _traced[arch]


def _collectives(gm) -> list[tuple[str, tuple, int]]:
    """(kind, the shape it moves, the elements it moves) of every
    collective in the graph: a reduce-scatter's operand, any other's
    output."""
    out = []
    for n in gm.graph.nodes:
        target = n.target
        if not (n.op == "call_function" and isinstance(target, torch._ops.OpOverload)
                and target.namespace == "_c10d_functional"):
            continue
        kind = COLLECTIVES.get(target._schema.name.split("::")[-1])
        if kind is None:
            continue
        val = n.args[0].meta["val"] if kind == "reduce-scatter" else n.meta.get("val")
        if isinstance(val, torch.Tensor):
            out.append((kind, tuple(val.shape), val.numel()))
    return out


@pytest.mark.parametrize("arch", CELLS)
def test_train_cell_held_to_reference(arch):
    got, _, want = _cell(arch)
    assert got["kind"] == "train"
    assert got["model_flops_total"] == want["model_flops"]
    assert got["flops_per_chip"] == want["flops"], (got["flops_per_chip"], want["flops"])
    assert got["dominant"] == want["dominant"], (got["dominant"], want["dominant"])
    assert got["coll_bytes_per_chip"] <= COLL_LIMIT * want["coll"], (
        got["coll_bytes_per_chip"], want["coll"])


def test_train_cell_moves_no_logits_or_scores():
    """smollm-135m-2l: every collective moves fewer elements than a rank's
    fp32 logits of one loss chunk (16 rows x 512 x 49152) and than its
    kv_seq scores of one query chunk over the whole key sequence (16 x 3
    kv heads x 512 x 3 x 4096), and none ends in a loss chunk's
    vocabulary, whole or over the 16 model ranks, or in a key sequence
    whole or over them."""
    _, gm, _ = _cell("smollm-135m")
    cfg = get_config("smollm-135m")
    rows = SHAPES["train_4k"].global_batch // 16
    seq = SHAPES["train_4k"].seq_len
    vocab = cfg.padded_vocab()
    logits = rows * LOSS_CHUNK * vocab
    scores = rows * cfg.num_kv_heads * 512 * (cfg.num_heads // cfg.num_kv_heads) * seq
    moved = _collectives(gm)
    assert moved, "no collective traced"
    assert [m for m in moved if m[2] >= min(logits, scores)] == []
    assert [m for m in moved if m[1][-2:] in ((LOSS_CHUNK, vocab), (LOSS_CHUNK, vocab // 16))] == []
    assert [m for m in moved if len(m[1]) == 5 and m[1][-1] in (seq, seq // 16)] == []
