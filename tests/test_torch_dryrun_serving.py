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
- mamba2-1.3b-2l long_500k (one token): no collective in the traced graph
  that moves a whole embedding table (``padded_vocab * d_model``
  elements; the lookup gathered the 206.6 MB table onto every rank before),
  and the collective bytes a chip at or under `LONG_500K_COLL_LIMIT`. The
  other cells above hold no whole-table collective either.

The limits are PERF.md §6's, written there before the repairs.
"""

from __future__ import annotations

import dataclasses

import pytest

from repro_torch.configs import base, get_config
from repro_torch.launch import dryrun
from dryrun_reference_compare import collectives, lower_both

LONG_500K_COLL_LIMIT = 1.4e7       # B a chip; 2.196e8 before the sharded lookup
DECODE_COLL_LIMIT = {"granite-moe-3b-a800m": 13058112}     # B a chip; 30727232 before
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
