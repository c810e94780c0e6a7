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
- granite-moe-3b-a800m-2l decode_32k: the same, and its collective bytes
  a chip at or under `DECODE_COLL_LIMIT`, their value once the normed
  residual was gathered whole along d (`models.lm.whole_along_d`) in
  decode as in prefill; 3.073e7 before, the reference's 6.21e7.
- jamba-1.5-large-398b-8l long_500k (one token): its collective bytes a
  chip at or under `DECODE_COLL_LIMIT` too, their value once the
  one-token residual's d moved between the model axis and the idle data
  axis by an all-to-all of its slices (`sharding.rules.relaid`, from
  `lm.whole_along_d` and the residual's `constrain`), 1387648 before.
- mamba2-1.3b-2l long_500k (one token): no collective in the traced graph
  that moves a whole embedding table (``padded_vocab * d_model``
  elements; the lookup gathered the 206.6 MB table onto every rank before),
  and the collective bytes a chip at or under `LONG_500K_COLL_LIMIT`, set
  by the same move (57544 before). The other cells above hold no
  whole-table collective either.
- smollm-135m-2l decode_32k: the bytes a chip at or above the floor a
  decode step must read, each weight shard and the K/V cache a chip holds,
  counted by hand (`_decode_floor`).

The limits are PERF.md §6's, written there before the repairs.
"""

from __future__ import annotations

import dataclasses

import pytest

from repro_torch.configs import SHAPES, base, get_config
from repro_torch.launch import dryrun
from dryrun_reference_compare import collectives, lower_both

# B a chip; 2.196e8 before the sharded lookup, 57544 before the residual's move
LONG_500K_COLL_LIMIT = 34504
DECODE_COLL_LIMIT = {"granite-moe-3b-a800m": 13058112,     # B a chip; 30727232 before
                     "jamba-1.5-large-398b": 930944}       # 1387648 before
FLOPS_CELLS = [("smollm-135m", 2, "decode_32k"), ("whisper-large-v3", 2, "decode_32k"),
               ("granite-moe-3b-a800m", 2, "decode_32k"),
               ("jamba-1.5-large-398b", 8, "long_500k")]


def _register(arch: str, layers: int) -> str:
    name = f"{arch}-{layers}l"
    if name not in base.all_configs():
        base.register(dataclasses.replace(get_config(arch), num_layers=layers, name=name))
    return name


def _whole_table_collectives(gm, cfg) -> list:
    """The traced graph's collectives that move a whole table."""
    table = cfg.padded_vocab() * cfg.d_model
    return [m for m in collectives(gm) if m[2] == table]


@pytest.mark.parametrize("arch,layers,shape", FLOPS_CELLS,
                         ids=[f"{a}-{n}l-{s}" for a, n, s in FLOPS_CELLS])
def test_serving_cell_flops_match_reference(arch, layers, shape):
    got, gm, want = lower_both(arch, shape, layers)
    assert got["model_flops_total"] == want["model_flops"]
    assert got["flops_per_chip"] == want["flops"], (got["flops_per_chip"], want["flops"])
    assert _whole_table_collectives(gm, get_config(_register(arch, layers))) == []
    if arch in DECODE_COLL_LIMIT:
        assert got["coll_bytes_per_chip"] <= DECODE_COLL_LIMIT[arch], got["coll_bytes_per_chip"]


def test_long_500k_moves_no_table():
    name = _register("mamba2-1.3b", 2)
    got, gm = dryrun.lower_cell(name, "long_500k", verbose=False)
    assert _whole_table_collectives(gm, get_config(name)) == []
    assert got["coll_bytes_per_chip"] <= LONG_500K_COLL_LIMIT, got["coll_bytes_per_chip"]


def _decode_floor(cfg, batch: int, seq: int) -> int:
    """Bytes a decode step of `cfg` (smollm-135m's shapes, bf16) must read
    on one chip of 16 x 16 (data 16, model 16) under DECODE_RULES: each
    weight shard and the K/V cache the chip holds, once. The table's rows
    split on model and its d on data; wq, wk, wv and wo split on data along
    d only (9 and 3 heads do not split 16 ways); the MLP's weights on data
    along d and on model along d_ff; the norms' scales whole; the cache's
    rows on data and its positions on model."""
    d, f, dh = cfg.d_model, cfg.d_ff, cfg.head_dim
    hq, hkv = cfg.num_heads, cfg.num_kv_heads
    table = cfg.padded_vocab() * d // 256
    attention = (2 * d * hq * dh + 2 * d * hkv * dh) // 16
    mlp = 3 * d * f // 256
    norms = 2 * d
    weights = table + cfg.num_layers * (attention + mlp + norms) + d
    cache = cfg.num_layers * 2 * (batch // 16) * (seq // 16) * hkv * dh
    return 2 * (weights + cache)


def test_decode_bytes_at_or_above_floor():
    name = _register("smollm-135m", 2)
    got, _ = dryrun.lower_cell(name, "decode_32k", verbose=False)
    shape = SHAPES["decode_32k"]
    floor = _decode_floor(get_config(name), shape.global_batch, shape.seq_len)
    # The hand count is the graph's inputs less the token ids.
    assert 0 <= got["memory_stats"]["argument_bytes"] - floor <= shape.global_batch * 8
    assert got["bytes_per_chip"] >= floor, (got["bytes_per_chip"], floor)

