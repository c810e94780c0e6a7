"""Mixture-of-Experts with capacity-based top-k routing.

The port of the JAX package's ``models/moe.py``. Dispatch uses slot
indices from cumulative positions (no (tokens, E, capacity) one-hot
dispatch tensor): each batch row routes its own tokens, each expert takes
at most `capacity` of them, in token order, and the rest go to a trash
slot that is dropped. The expert products are batched matmuls over the
(padded) expert axis; there is no MoE kernel in the JAX package and none
here.

Under a mesh the slots, the expert hidden states and the output are laid
out where the reference's `constrain` calls put them (experts on
``expert``, the hidden dim on ``tp``, the batch rows on ``batch``); every
gather and scatter indexes within a batch row, so a row's routing stays on
the ranks that hold the row.

Where a literal port would differ from the reference:
- router logits are fp32 products of operands in the activations' dtype
  (the reference's `preferred_element_type=float32`), as
  `lm.logits_from_hidden` computes them;
- top-k takes the first k of a stable descending sort, so among equal
  probabilities the lower expert index wins, as `jax.lax.top_k` orders
  them (`torch.topk` promises no order among ties);
- the combine gathers each token's k weighted slot outputs and adds them in
  ascending slot order, one rounding to the activations' dtype per add:
  the reference's sequential scatter-add, with no atomics on the card, so
  two calls give the same bits.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import _act
from repro_torch.models.spec import ParamSpec
from repro_torch.sharding.rules import (
    constrain,
    grad_in_layout,
    merge_dims,
    replicate_like,
    split_dim,
)

NEG_INF = -1e30


def moe_spec(cfg: ModelConfig) -> dict:
    e, d, f = cfg.moe_padded_experts, cfg.d_model, cfg.d_ff
    spec = {
        "w_router": ParamSpec((d, e), ("fsdp", None), ("fan_in", d)),
        "w_up": ParamSpec((e, d, f), ("expert", "fsdp", "tp"), ("fan_in", d)),
        "w_down": ParamSpec((e, f, d), ("expert", "tp", "fsdp"), ("fan_in", f)),
    }
    if cfg.glu:
        spec["w_gate"] = ParamSpec((e, d, f), ("expert", "fsdp", "tp"), ("fan_in", d))
    return spec


def capacity(cfg: ModelConfig, tokens_per_group: int) -> int:
    """Slots per expert for a group (batch row) of `tokens_per_group`
    tokens: ceil(tokens * k * factor / experts), rounded up to a multiple of
    8 from 8 on; below 8 exact (decode, one token a row, gets 1)."""
    cap = int(
        math.ceil(tokens_per_group * cfg.moe_top_k * cfg.moe_capacity_factor
                  / cfg.moe_num_experts)
    )
    if cap >= 8:
        return -(-cap // 8) * 8
    return max(1, cap)


def _experts(p: dict, cfg: ModelConfig, xe: torch.Tensor) -> torch.Tensor:
    """The expert MLPs on their slots: xe (B, E, C, D) -> (B, E, C, D), one
    batched matmul per weight over the expert axis (rows of all batch rows
    side by side), in the activations' dtype. The hidden states are laid
    out as (B, E, C, F) between the two products."""
    b, e, c, d = xe.shape
    xs = merge_dims(xe.transpose(0, 1), 1, 2)
    h = torch.bmm(xs, p["w_up"].to(xe.dtype))
    if cfg.glu:
        gate = torch.bmm(xs, p["w_gate"].to(xe.dtype))
        h = _act(cfg, gate) * h
    else:
        h = _act(cfg, h)
    h = constrain(_rows_by_batch(h, b, c), "batch", "expert", None, "tp")
    ye = torch.bmm(_rows_merged(h), p["w_down"].to(xe.dtype))
    return split_dim(ye, 1, (b, c)).transpose(0, 1)


def _rows_by_batch(h: torch.Tensor, b: int, c: int) -> torch.Tensor:
    """(E, B·C, F), B outer in the merged dim, as (B, E, C, F). A `DTensor`
    goes rank by rank through `local_map`, a split of the merged dim taken
    by B (replicated first where B does not divide): torch 2.11's `DTensor`
    takes the gradient's reshape back as a view of a transposed local
    shard, which raises."""
    if not isinstance(h, DTensor):
        return split_dim(h, 1, (b, c)).transpose(0, 1)
    mesh = h.device_mesh
    rows = [m for m, p in enumerate(h.placements) if isinstance(p, Shard) and p.dim % 3 == 1]
    if b % math.prod(mesh.size(m) for m in rows):
        h = h.redistribute(mesh, [Replicate() if m in rows else p
                                  for m, p in enumerate(h.placements)])
    out = [Shard((1, 0, 3)[p.dim % 3]) if isinstance(p, Shard) else p for p in h.placements]
    return local_map(lambda t: t.unflatten(1, (t.shape[1] // c, c)).transpose(0, 1),
                     out_placements=out, in_placements=(h.placements,),
                     device_mesh=mesh)(h)


def _rows_merged(h: torch.Tensor) -> torch.Tensor:
    """(B, E, C, F) as (E, B·C, F), `_rows_by_batch` undone (a split of C
    replicated first)."""
    if not isinstance(h, DTensor):
        return merge_dims(h.transpose(0, 1), 1, 2)
    mesh = h.device_mesh
    if any(isinstance(p, Shard) and p.dim % 4 == 2 for p in h.placements):
        h = h.redistribute(mesh, [Replicate() if isinstance(p, Shard) and p.dim % 4 == 2 else p
                                  for p in h.placements])
    out = [Shard((1, 0, None, 2)[p.dim % 4]) if isinstance(p, Shard) else p
           for p in h.placements]
    return local_map(lambda t: t.transpose(0, 1).flatten(1, 2), out_placements=out,
                     in_placements=(h.placements,), device_mesh=mesh)(h)


def combine(yw: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    """Each token's sum of its weighted slot outputs. yw: (B, n_slots, D);
    slots: (B, S, k), a token's slots, `n_slots` for a choice over
    capacity. The k rows (the trash slot reads a zero row) are added in
    ascending slot order, rounding to yw's dtype after each add: the
    reference's sequential scatter-add, bit for bit, with no atomics."""
    b, _, d = yw.shape
    s, k = slots.shape[1], slots.shape[2]
    yw = torch.cat([yw, yw.new_zeros((b, 1, d))], dim=1)
    order = merge_dims(slots.sort(dim=-1).values, 1, 2)[..., None].expand(b, s * k, d)
    picked = split_dim(torch.gather(yw, 1, order), 1, (s, k))        # (B, S, k, D)
    y = picked[:, :, 0]
    for j in range(1, slots.shape[-1]):
        y = y + picked[:, :, j]
    return y


def route(p: dict, cfg: ModelConfig,
          x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Router probabilities (B, S, E) in fp32, then each token's top-k
    gates, renormalised to sum to 1, and experts, (B, S, k) each, the
    likelier first."""
    e, k = cfg.moe_padded_experts, cfg.moe_top_k
    # The gradient stays split as the logits are, so the router's weight
    # gradient is a slice of experts on each rank, not whole on every one.
    logits = grad_in_layout(x.float() @ p["w_router"].to(x.dtype).float())   # (B, S, E)
    if e != cfg.moe_num_experts:
        # Padding experts (the reference's sharding alignment) never win.
        pad = replicate_like(torch.arange(e, device=x.device) >= cfg.moe_num_experts, logits)
        logits = logits.masked_fill(pad, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    # The ranking carries no gradient; the gates are gathered from the
    # probabilities by it. (The gradient of `sort` on a `DTensor` scatters
    # into a plain tensor in torch 2.11, which raises.)
    expert_idx = torch.sort(probs.detach(), dim=-1, descending=True, stable=True).indices[..., :k]
    gate_vals = torch.gather(probs, -1, expert_idx)
    return probs, gate_vals / gate_vals.sum(dim=-1, keepdim=True), expert_idx


def moe(p: dict, cfg: ModelConfig, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (output (B, S, D) in x's dtype, the Switch load-balancing aux
    loss, a 0-d fp32 tensor). Routing is per batch row."""
    b, s, d = x.shape
    e, k = cfg.moe_padded_experts, cfg.moe_top_k
    cap = capacity(cfg, s)
    n_slots = e * cap
    probs, gate_vals, expert_idx = route(p, cfg, x)

    # --- slot assignment (per-row cumulative positions) -----------------------
    # Over the flattened (S·k) axis, k inner: within an expert the earlier
    # token takes the earlier slot, and tokens past capacity go to the trash
    # slot `n_slots`.
    flat_e = merge_dims(expert_idx, 1, 2)
    onehot = F.one_hot(flat_e, e)                                    # (B, S*k, E)
    pos_in_e = (onehot.cumsum(dim=1) * onehot).sum(dim=-1) - 1
    keep = pos_in_e < cap
    slot = torch.where(keep, flat_e * cap + pos_in_e, n_slots)
    tok = replicate_like(torch.arange(s * k, device=x.device) // k, slot).expand(b, s * k)
    gate_flat = merge_dims(gate_vals, 1, 2) * keep

    # Each slot's token (s, the zero row, for an empty slot) and gate. Only
    # the trash column receives duplicate indices, which makes `scatter`'s
    # choice among them nondeterministic on the card and its gradient
    # assume unique indices; both are harmless because that column is
    # sliced off (its gradient is 0).
    slot_tok = replicate_like(
        torch.full((b, n_slots + 1), s, dtype=torch.long, device=x.device), slot)
    slot_tok = slot_tok.scatter(1, slot, tok)[:, :n_slots]
    slot_gate = x.new_zeros((b, n_slots + 1), dtype=torch.float32).scatter(1, slot, gate_flat)

    # --- expert computation -----------------------------------------------------
    xp = torch.cat([x, x.new_zeros((b, 1, d))], dim=1)
    xe = split_dim(torch.gather(xp, 1, slot_tok[..., None].expand(b, n_slots, d)), 1, (e, cap))
    xe = constrain(xe, "batch", "expert", None, None)
    ye = merge_dims(_experts(p, cfg, xe), 1, 2)

    # --- combine ----------------------------------------------------------------
    y = combine(ye * slot_gate[:, :n_slots, None].to(ye.dtype), split_dim(slot, 1, (s, k)))
    y = constrain(y, "batch", None, "residual")

    # --- aux load-balancing loss (Switch-style) -------------------------------
    # Means over the batch rows as sums over the count (what `mean`
    # computes): a partial sum over rows sharded across ranks.
    frac_tokens = F.one_hot(expert_idx[..., 0], e).float().sum(dim=(0, 1)) / (b * s)
    frac_probs = probs.sum(dim=(0, 1)) / (b * s)
    aux = e * (frac_tokens * frac_probs).sum()
    return y, aux
