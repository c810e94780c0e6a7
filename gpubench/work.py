"""The yardstick's arithmetic: the card's peak and model FLOPs from a
configuration's published widths.

Everything here reads plain numbers (a configuration file's keys, a step's
shapes); nothing imports the program, so a change to the program cannot
move the yardstick.
"""

from __future__ import annotations

import math

# NVIDIA H100 SXM, data sheet, dense bf16 tensor-core FLOP/s. The rate
# assumes the card's full 700 W power limit.
PEAK_BF16_FLOPS_S = 989e12


# --------------------------------------------------------------------------- #
# Model FLOPs from published widths (a configuration file's keys)
# --------------------------------------------------------------------------- #
def block_matmul_params(c: dict) -> int:
    """Weights that a token multiplies in one block."""
    d = c["hidden_size"]
    if c["block"] == "attention":
        hq, hkv, dh = c["num_attention_heads"], c["num_key_value_heads"], c["head_dim"]
        f = c["intermediate_size"]
        return d * (hq + 2 * hkv) * dh + hq * dh * d + 3 * d * f
    if c["block"] == "mamba2":
        din = c["expand"] * d
        gn = c["n_groups"] * c["state_size"]
        return d * (2 * din + 2 * gn + din // c["head_dim"]) + din * d
    raise ValueError(f"unknown block {c['block']!r}")


def head_params(c: dict) -> int:
    return c["hidden_size"] * c["vocab_size"]


def _mixer_forward(c: dict, s: int) -> int:
    """Forward FLOPs of one layer's sequence mixing over a sequence of `s`
    tokens, beyond its weights: causal attention's two products, or the
    SSD's chunked quadratic form and the causal conv."""
    if c["block"] == "attention":
        return 4 * c["head_dim"] * c["num_attention_heads"] * (s * (s + 1) // 2)
    d = c["hidden_size"]
    din = c["expand"] * d
    h, p, n, q = din // c["head_dim"], c["head_dim"], c["state_size"], c["chunk_size"]
    chunks = math.ceil(s / q)
    scan = h * chunks * (2 * (q * (q + 1) // 2) * (n + p) + 4 * q * n * p)
    conv = 2 * c["conv_kernel"] * (din + 2 * c["n_groups"] * n) * s
    return scan + conv


def train_step_flops(c: dict, batch: int, seq_len: int) -> int:
    """Model FLOPs of one training step: 6 x the multiplied weights (blocks
    and head) a token, and three times the forward mixing (forward and two
    backward products). Recomputation is not counted."""
    tokens = batch * seq_len
    weights = block_matmul_params(c) * c["num_hidden_layers"] + head_params(c)
    mixing = 3 * c["num_hidden_layers"] * _mixer_forward(c, seq_len) * batch
    return 6 * weights * tokens + mixing
