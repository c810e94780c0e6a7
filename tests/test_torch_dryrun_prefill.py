"""The dry-run's prefill cells against the JAX package's `lower_cell`, on
the CPU, on torch's ``fake`` process group of 256 ranks (pod16x16): each
config cut to 2 layers on both sides, as tests/dryrun_reference_compare.py
cuts it, the reference in a subprocess beside the port's trace.

- smollm-135m-2l, granite-moe-3b-a800m-2l and whisper-large-v3-2l
  prefill_32k: the dominant term (both sides' counts over the same H100
  peaks) equal to the reference's, per-chip product FLOPs equal to its
  dots to the last digit, and collective bytes a chip at most
  `COLL_LIMIT` times the reference's. Before the normed residual was
  gathered whole along d in prefill (`models.lm.whole_along_d`), the
  expert weights at their use (`models.moe._gathered_over_rows`) and
  dispatch took its local slots, the first two read 2.138x and 4.556x;
  before the attention context was reduce-scattered onto its merged
  heads (`models.layers._context_for_wo`), k and v moved to their
  sequence split by an all-to-all (`sharding.rules.relaid`) and
  prefill gathered only its last position's hidden state (`lm_hidden`'s
  `last`), granite and whisper read 1.862x and 1.510x. granite's limit
  stays above 1.25x: the reference all-reduces its q/k/v partial sums as
  one tuple, which its `analyze_hlo` counts as 0 bytes (PERF.md §6).
- granite-moe-3b-a800m-2l and whisper-large-v3-2l: no collective moves
  an attention context (B, S, H, D) or (B, S, H_kv, g, D) with its heads
  whole (24 and 20: they do not split 16 ways), nor the merged context
  (B, S, H * D) with its columns whole (a functional reduce-scatter or
  all-gather along another dim than the first moves its shards stacked
  on dim 0, so the last dim of the tensor it moves is H * D only where
  the columns are not split). Before, whisper all-reduced (2, 32768, 20,
  64) a layer, and granite reduce-scattered its context onto the
  sequence and gathered (32, 2048, 24, 64) back.
- smollm-135m-2l: no collective moves the MLP's hidden state, whose last
  dim is d_ff (1536) or its 16th over the model ranks (96). Before, each
  layer reduce-scattered (2, 2048, 1536) partial sums and gathered (32,
  2048, 1536) back (a functional all-gather stacks its 16 shards on dim 0).
- granite-moe-3b-a800m-2l: no collective moves the MoE slots (B, E, C,
  D / 16) between their D split and their experts' split. Before, each
  layer all-gathered (32, 48, 8192, 96).

The limits are PERF.md §6's, written there before the repairs.
"""

from __future__ import annotations

import pytest

from repro_torch.configs import SHAPES, get_config
from repro_torch.models.moe import capacity
from dryrun_reference_compare import collectives, lower_both

COLL_LIMIT = {"smollm-135m": 1.6, "granite-moe-3b-a800m": 1.4, "whisper-large-v3": 1.25}
_traced: dict = {}


def _cell(arch: str) -> tuple:
    """(the port's record, its graph, the reference's record) of `arch`
    cut to 2 layers, prefill_32k on 16 x 16; traced once per process."""
    if arch not in _traced:
        _traced[arch] = lower_both(arch, "prefill_32k", 2)
    return _traced[arch]


@pytest.mark.parametrize("arch", sorted(COLL_LIMIT))
def test_prefill_cell_held_to_reference(arch):
    got, _, want = _cell(arch)
    assert got["kind"] == "prefill"
    assert got["model_flops_total"] == want["model_flops"]
    assert got["flops_per_chip"] == want["flops"], (got["flops_per_chip"], want["flops"])
    assert got["dominant"] == want["dominant"], (got["dominant"], want["dominant"])
    assert got["coll_bytes_per_chip"] <= COLL_LIMIT[arch] * want["coll"], (
        got["coll_bytes_per_chip"], want["coll"])


def test_prefill_moves_no_mlp_hidden_state():
    _, gm, _ = _cell("smollm-135m")
    d_ff = get_config("smollm-135m").d_ff
    moved = collectives(gm)
    assert moved, "no collective traced"
    # A hidden state is (rows, positions, width); the weights' FSDP gathers,
    # (576, 96) for w_up's 16th, are matrices.
    assert [m for m in moved if len(m[1]) >= 3 and m[1][-1] in (d_ff, d_ff // 16)] == []


def test_prefill_moves_no_moe_slots():
    _, gm, _ = _cell("granite-moe-3b-a800m")
    cfg = get_config("granite-moe-3b-a800m")
    slots = (cfg.moe_padded_experts, capacity(cfg, SHAPES["prefill_32k"].seq_len),
             cfg.d_model // 16)
    moved = collectives(gm)
    assert moved, "no collective traced"
    assert [m for m in moved if len(m[1]) == 4 and m[1][1:] == slots] == []


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "whisper-large-v3"])
def test_prefill_moves_no_whole_head_context(arch):
    _, gm, _ = _cell(arch)
    cfg = get_config(arch)
    hq, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    moved = collectives(gm)
    assert moved, "no collective traced"
    assert [m for m in moved if m[1][-2:] == (hq, dh) or m[1][-3:] == (hkv, hq // hkv, dh)] == []
    assert [m for m in moved if len(m[1]) >= 3 and m[1][-1] == hq * dh] == []
