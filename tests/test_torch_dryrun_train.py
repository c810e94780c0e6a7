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
- command-r-plus-104b-2l train_4k: the same. Cohere's parallel block
  ends both branches in a product; before both products' operands were
  saved before either ran (`models.lm.products_saved_first`), the
  recomputed period ran the attention output projection again, which the
  reference's remat drops: 1.01386x its FLOPs.
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

import pytest

from repro_torch.configs import SHAPES, get_config
from dryrun_reference_compare import collectives, lower_both

COLL_LIMIT = 2.0          # the port's collective bytes a chip over the reference's
LOSS_CHUNK = 512
CELLS = ["smollm-135m", "granite-moe-3b-a800m", "command-r-plus-104b"]
_traced: dict = {}


def _cell(arch: str) -> tuple:
    """(the port's record, its graph, the reference's record) of `arch`
    cut to 2 layers, train_4k on 16 x 16; traced once per process."""
    if arch not in _traced:
        _traced[arch] = lower_both(arch, "train_4k", 2)
    return _traced[arch]


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
    moved = collectives(gm)
    assert moved, "no collective traced"
    assert [m for m in moved if m[2] >= min(logits, scores)] == []
    assert [m for m in moved if m[1][-2:] in ((LOSS_CHUNK, vocab), (LOSS_CHUNK, vocab // 16))] == []
    assert [m for m in moved if len(m[1]) == 5 and m[1][-1] in (seq, seq // 16)] == []
