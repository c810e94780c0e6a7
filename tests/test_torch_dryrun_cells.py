"""Full-size dry-run cells of the port against a hand count, on the CPU:
olmo-1b (16 layers, d 2048, 16 heads of 128, vocab 50304 padded to
50432) prefill_32k on the 16 x 16 mesh of a ``fake`` 256-rank group,
traced and parsed by `repro_torch.launch.dryrun` (its decode_32k cell, a
fifth of the time, is in tests/test_torch_dryrun.py, which imports
`check` from here).

Every product the model runs, counted by hand, sharded 256 ways:
- the layers' weights: 2 x (parameters - the embedding table) x tokens
  (q, k, v, o and the SwiGLU MLP; the norms have no parameters);
- attention: 4 x batch x query positions x key positions x d per layer,
  the masked half included (the plain path computes it, as the
  reference's does);
- the logits of the last position: 2 x batch x padded vocab x d.
The embedding lookup is a gather, not a product: the count that includes
the table, 2 x 1,177,026,560 x tokens + attention (6.972e15 for the
prefill, 2.723e13 a chip), is held to within 5%.
"""

from __future__ import annotations

import torch.distributed as dist

from repro_torch.configs import SHAPES, get_config
from repro_torch.launch.dryrun import lower_cell
from repro_torch.models import make_model

CHIPS = 256


def hand_count(kind: str) -> tuple[float, float]:
    """(every product, products and the embedding table as 2 N a token),
    per chip."""
    cfg = get_config("olmo-1b")
    n = make_model(cfg).param_count()
    table = cfg.padded_vocab() * cfg.d_model
    shape = SHAPES["prefill_32k" if kind == "prefill" else "decode_32k"]
    b, s = shape.global_batch, shape.seq_len
    queries = s if kind == "prefill" else 1
    tokens = b * queries
    attention = 4 * b * queries * s * cfg.d_model * cfg.num_layers
    products = 2 * (n - table) * tokens + attention + 2 * b * table
    return products / CHIPS, (2 * n * tokens + attention) / CHIPS


def check(kind: str) -> None:
    rec, gm = lower_cell("olmo-1b", f"{kind}_32k", verbose=False)
    print(f"{kind}: {rec['flops_per_chip']:.4e} FLOP a chip, {len(gm.graph.nodes)} graph nodes, "
          f"traced in {rec['lower_s']} s; {rec['dominant']}-bound")
    products, with_table = hand_count(kind)
    assert abs(rec["flops_per_chip"] / products - 1) <= 1e-3, (rec["flops_per_chip"], products)
    assert abs(rec["flops_per_chip"] / with_table - 1) <= 0.05
    assert rec["chips"] == CHIPS and rec["mesh"] == "pod16x16"
    assert rec["model_flops_total"] == 2 * make_model(get_config("olmo-1b")).param_count() * (
        SHAPES[f"{kind}_32k"].global_batch * (SHAPES[f"{kind}_32k"].seq_len
                                              if kind == "prefill" else 1))
    assert not dist.is_initialized()


def test_prefill_32k_matches_the_hand_count():
    products, with_table = hand_count("prefill")
    assert round(with_table * CHIPS / 1e15, 3) == 6.972
    assert round(with_table / 1e13, 3) == 2.723
    check("prefill")
