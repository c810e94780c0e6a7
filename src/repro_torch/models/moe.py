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
the ranks that hold the row. Where the experts are split, each rank
gathers (`_dispatch`) and combines (`_combine_local_slots`) only its own
experts' slots, and in training and prefill the expert weights are
gathered over the rows' axes (`_gathered_over_rows`), as the reference's
partitioner lays them out.

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
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import _act, _reduced
from repro_torch.models.spec import ParamSpec
from repro_torch.sharding.rules import (
    constrain,
    current_rules,
    grad_in_layout,
    local_extent,
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
    h = torch.bmm(xs, _gathered_over_rows(p["w_up"].to(xe.dtype), xs))
    if cfg.glu:
        gate = torch.bmm(xs, _gathered_over_rows(p["w_gate"].to(xe.dtype), xs))
        h = _act(cfg, gate) * h
    else:
        h = _act(cfg, h)
    h = _rows_merged(constrain(_rows_by_batch(h, b, c), "batch", "expert", None, "tp"))
    ye = torch.bmm(h, _gathered_over_rows(p["w_down"].to(xe.dtype), h))
    return split_dim(ye, 1, (b, c)).transpose(0, 1)


def _gathered_over_rows(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The expert weight `w` (E, K, N) of ``bmm(x, w)``, `x` (E, R, K),
    whole on every mesh dim that splits the rows R of `x` wherever the
    rows outnumber the contraction (R > K: training, prefill): the FSDP
    weight gathered at its use, as the reference's partitioner gathers it,
    and its gradient reduce-scattered back. Not a `constrain` (the
    reference has none here): `DTensor`, weighing communication alone,
    otherwise splits the contraction over that mesh dim and
    reduce-scatters the (E, R, N) partial sums of every row onto the rows,
    R / K times the weight's bytes (jamba-8l prefill_32k on 16 x 16: a
    (1, 10240, 24576) bf16 reduce-scatter, 8.05e9 B, a product). A decode
    step's rows (one slot an expert a row) are fewer than K, and there
    the partial sums move less than the weight would."""
    if not (isinstance(w, DTensor) and isinstance(x, DTensor)) or x.shape[1] <= w.shape[1]:
        return w
    rows = {m for m, q in enumerate(x.placements) if isinstance(q, Shard) and q.dim % x.ndim == 1}
    placements = [Replicate() if m in rows else p for m, p in enumerate(w.placements)]
    if placements == list(w.placements):
        return w
    return w.redistribute(w.device_mesh, placements)


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


def _dispatch(x: torch.Tensor, slot_tok: torch.Tensor, e: int) -> torch.Tensor:
    """Each slot's token row: x (B, S, D) with a zero row appended (index
    S, an empty slot's), at slot_tok (B, n_slots) -> (B, n_slots, D).
    Where a mesh splits the experts, the rows are laid out whole along D
    first (at a batch of 1 `lm.whole_along_d` splits D over the idle data
    axis), before the zero row joins them, so no zero row moves: each rank
    gathers its own slots' rows, laid out as the slots' experts will be,
    and the gradient is each rank's scatter-add of its slots into the
    tokens, a partial sum that the backward pass reduces, as the
    reference's partitioner reduces it. `DTensor` would gather the rows of
    every slot on each rank and, in the backward pass, gather every slot's
    gradient: (B, E · capacity, D) a layer, 16 times a rank's share
    (granite: 2.4 GB a rank)."""
    b, _, d = x.shape
    n_slots = slot_tok.shape[1]
    rules = current_rules()
    if isinstance(x, DTensor) and rules is not None and rules.mesh is not None:
        mesh = x.device_mesh
        experts = list(rules.sharding(("batch", "expert", None), (b, e, d)).placements)
        rows = [Shard(0) if p == Shard(0) else Replicate() for p in experts]
        if Shard(1) in experts:
            x = x.redistribute(mesh, rows)
            xp = torch.cat([x, x.new_zeros((b, 1, d))], dim=1)
            grad = [Partial() if p == Shard(1) else q for p, q in zip(experts, rows)]
            return local_map(lambda t, i: torch.gather(t, 1, i[..., None].expand(*i.shape, d)),
                             out_placements=experts, in_placements=(rows, experts),
                             in_grad_placements=(grad, experts),
                             device_mesh=mesh)(xp, slot_tok.redistribute(mesh, experts))
    xp = torch.cat([x, x.new_zeros((b, 1, d))], dim=1)
    return torch.gather(xp, 1, slot_tok[..., None].expand(b, n_slots, d))


def combine(yw: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    """Each token's sum of its weighted slot outputs. yw: (B, n_slots, D);
    slots: (B, S, k), a token's slots, `n_slots` for a choice over
    capacity. The k rows (the trash slot reads a zero row) are added in
    ascending slot order, rounding to yw's dtype after each add: the
    reference's sequential scatter-add, bit for bit, with no atomics."""
    if isinstance(yw, DTensor) and any(isinstance(p, Shard) and p.dim % 3 == 1
                                       for p in yw.placements):
        return _combine_local_slots(yw, slots)
    return _combine(yw, slots, 0)


def _combine(yw: torch.Tensor, slots: torch.Tensor, first: int) -> torch.Tensor:
    """`combine` of the slots first .. first + n - 1 held in `yw` (B, n,
    D); every other slot reads a zero row, which adds nothing."""
    b, n, d = yw.shape
    s, k = slots.shape[1], slots.shape[2]
    yw = torch.cat([yw, yw.new_zeros((b, 1, d))], dim=1)
    j = slots.sort(dim=-1).values - first
    order = torch.where((j >= 0) & (j < n), j, n)
    order = merge_dims(order, 1, 2)[..., None].expand(b, s * k, d)
    picked = split_dim(torch.gather(yw, 1, order), 1, (s, k))        # (B, S, k, D)
    y = picked[:, :, 0]
    for i in range(1, k):
        y = y + picked[:, :, i]
    return y


def _combine_local_slots(yw: DTensor, slots: DTensor) -> DTensor:
    """`combine` with the slots split across ranks (the experts on
    ``expert``): each rank adds its own slots' rows, in ascending slot
    order, a partial sum over the mesh dims that split the slots, which the
    caller's layout reduces, as the reference's partitioner reduces its
    scatter-add's partial sums. `DTensor` would gather every slot's row
    onto each rank first: (B, E · capacity, D) a layer, 16 times a rank's
    share (granite: 2.4 GB a rank, against the partial sum's 0.2 GB). A
    token whose slots lie on several ranks is summed in another order than
    the one-rank combine's, as on the reference's mesh."""
    mesh = yw.device_mesh
    out = [Partial() if isinstance(p, Shard) and p.dim % 3 == 1 else p for p in yw.placements]
    ids = [Shard(0) if isinstance(p, Shard) and p.dim % 3 == 0 else Replicate()
           for p in yw.placements]
    slots = slots.redistribute(mesh, ids)
    first, _ = local_extent(yw, 1)
    return local_map(lambda y, i: _combine(y, i, first), out_placements=out,
                     in_placements=(yw.placements, ids), device_mesh=mesh)(yw, slots)


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
    b, s, _ = x.shape
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
    xe = constrain(split_dim(_dispatch(x, slot_tok, e), 1, (e, cap)),
                   "batch", "expert", None, None)
    ye = merge_dims(_experts(p, cfg, xe), 1, 2)

    # --- combine ----------------------------------------------------------------
    y = combine(ye * slot_gate[:, :n_slots, None].to(ye.dtype), split_dim(slot, 1, (s, k)))
    y = constrain(y, "batch", None, "residual")

    # --- aux load-balancing loss (Switch-style) -------------------------------
    # Means over the batch rows as sums over the count (what `mean`
    # computes): a partial sum over rows sharded across ranks.
    frac_tokens = F.one_hot(expert_idx[..., 0], e).float().sum(dim=(0, 1)) / (b * s)
    # The probabilities' sum is reduced here and its gradient whole on every
    # rank (`layers._reduced`): a partial-sum gradient, expanded over the
    # batch, would be reduce-scattered at the batch's whole (B, S, E) size.
    frac_probs = _reduced(probs.sum(dim=(0, 1))) / (b * s)
    aux = e * (frac_tokens * frac_probs).sum()
    return y, aux
