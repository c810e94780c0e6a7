"""Shared transformer layers: norms, RoPE, sinusoidal positions, GQA and
cross attention, gated MLP.

The port of the JAX package's ``models/layers.py``, dense parts, with its
layouts: activations are (B, S, H, D_h), ``wq`` is (d, Hq, D_h) and ``wo``
is (Hq, D_h, d). Matmuls run in bf16 on fp32 parameters cast at use, with
fp32 norm, softmax and score accumulation. Self-attention of a query block
at position 0 against an empty or absent cache (causal prefill, or the
encoder's non-causal pass) with no input that needs a gradient goes through
`ops.flash_attention` (the flash kernel for CUDA tensors, forward only). A
call that needs gradients goes through `ops.flash_attention_train` (the
flash kernel with its backward) where `trains_through_flash` finds that it
fits: bf16 on CUDA, no cache from position 0, head dim 64 or 128, whole
(batch, head) slices on every rank. Every other case, on the CPU and in the
dry-run's ``meta`` tensors included, goes through the plain `_attn_core`,
differentiable by autograd. The Mamba mixer is in ``models/ssd.py``.

Under a mesh (`sharding.rules.use_rules` with a mesh) the same code runs on
`DTensor`s and lays activations out where the reference's `constrain`
calls do, in its order. `_attn_core` has the reference's two modes: k/v
expanded to the q heads and sharded on ``heads`` when the q-head count
divides that axis (training, the encoder, cross-attention from source
states), else k/v and the scores sharded on ``kv_seq``, the softmax's max
and sum reduced across it. A prefill goes through the flash kernel only
where it needs no score tensor laid out: no head mode, and ``kv_seq`` over
one rank at most, so every rank holds whole (batch, head) slices. Where
`DTensor`, which weighs communication alone, would repeat work the
reference's partitioner splits, the layout is steered where it happens: the
vocab lookup never gathers the whole table (`_lookup`), a projection's FSDP
weight is gathered over the batch's mesh axes (`_gathered_over_batch`), at
batch 1 the kv_seq mode's P·V is split by heads over the mesh axes that
split nothing (`_pv_split_over_idle_axes`), and a sum over a split dim
(a norm's mean, the softmax's sum, the loss's ``logsumexp``, the kv_seq
mode's context in training) is all-reduced with its gradient whole
(`_reduced`).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard, distribute_tensor
from torch.distributed.tensor.experimental import local_map
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.spec import Ax, ParamSpec
from repro_torch.sharding.rules import (
    constrain,
    current_rules,
    grad_in_layout,
    local_extent,
    merge_dims,
    relaid,
    replicate_like,
    split_dim,
    under_current_rules,
    write_slice,
)

COMPUTE_DTYPE = torch.bfloat16
NEG_INF = -1e30


# --------------------------------------------------------------------------- #
# Norms
# --------------------------------------------------------------------------- #
def norm_spec(cfg: ModelConfig, dim: int | None = None) -> dict:
    d = dim if dim is not None else cfg.d_model
    if not cfg.parametric_norm:
        return {}
    spec = {"scale": ParamSpec((d,), (None,), "ones")}
    if cfg.norm_type == "layernorm" and cfg.norm_bias:
        spec["bias"] = ParamSpec((d,), (None,), "zeros")
    return spec


def _mean(x: torch.Tensor) -> torch.Tensor:
    """Mean over the last dim as its sum over the count (what `mean`
    computes): over a dim sharded across ranks a partial sum, all-reduced
    with its gradient whole (`_reduced`)."""
    return _reduced(x.sum(dim=-1, keepdim=True)) / x.shape[-1]


def apply_norm(p: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    if cfg.norm_type == "rmsnorm":
        var = _mean(xf.square())
        y = xf * torch.rsqrt(var + cfg.norm_eps)
    else:  # layernorm, the variance in two passes as the reference's
        mean = _mean(xf)
        var = _mean((xf - mean).square())
        y = (xf - mean) * torch.rsqrt(var + cfg.norm_eps)
    if p.get("scale") is not None:
        y = y * p["scale"].float()
    if p.get("bias") is not None:
        y = y + p["bias"].float()
    return y.to(x.dtype)


# --------------------------------------------------------------------------- #
# Rotary position embedding
# --------------------------------------------------------------------------- #
def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, H, D_h); positions: (S,), shared by every row."""
    half = x.shape[-1] // 2
    freqs = torch.exp(
        -math.log(theta)
        * torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    )
    angles = positions[:, None].float() * freqs  # (S, half)
    cos = replicate_like(torch.cos(angles)[None, :, None, :], x)
    sin = replicate_like(torch.sin(angles)[None, :, None, :], x)
    x1, x2 = x[..., :half], x[..., half:]
    rx1 = x1 * cos - x2 * sin
    rx2 = x2 * cos + x1 * sin
    return torch.cat([rx1, rx2], dim=-1).to(x.dtype)


def sinusoidal_positions(seq_len: int, d_model: int, offset: int = 0) -> torch.Tensor:
    """(seq_len, d_model) fp32 table of positions offset .. offset + seq_len - 1:
    sin on even columns, cos on odd ones, the reference's fp32 formula.
    Computed on the host, so the card and the host CPU add the same table:
    their `pow` and `sin` may differ in the last bit, and one bit of an
    angle near position 1500 is 1.2e-4."""
    pos = torch.arange(offset, offset + seq_len, dtype=torch.float32)[:, None]
    dim = torch.arange(0, d_model, 2, dtype=torch.float32)[None, :]
    angle = pos / torch.pow(10000.0, dim / d_model)
    pe = torch.zeros((seq_len, d_model), dtype=torch.float32)
    pe[:, 0::2] = torch.sin(angle)
    pe[:, 1::2] = torch.cos(angle)
    return pe


# --------------------------------------------------------------------------- #
# Embedding
# --------------------------------------------------------------------------- #
def embedding_spec(cfg: ModelConfig) -> dict:
    v = cfg.padded_vocab()
    spec = {"table": ParamSpec((v, cfg.d_model), ("tp", "fsdp"), ("normal", 0.02))}
    if not cfg.tie_embeddings:
        spec["out_table"] = ParamSpec(
            (v, cfg.d_model), ("tp", "fsdp"), ("normal", 0.02)
        )
    return spec


def _lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """table[ids]. A `DTensor` table (vocab rows on the model axis, d on the
    data axes) is looked up one of two ways, whichever moves fewer bytes,
    as the reference's partitioner weighs them:
      * where it lies (`_sharded_lookup`): the ids gathered and the looked-
        up rows' partial sums reduced, a few KB for a decode step;
      * by columns: the table relaid whole along its rows and split along d
        where its rows were split (gathered over the data axes, swapped
        between dims over the model axis: 1/16 of it a rank), each rank
        looking up its own ids in its own columns, which is the residual
        stream's layout; a prefill's or a training batch's activations
        would move more than that. Where no such split is (one rank on
        those axes) or d does not divide it, the lookup is in place.
    The table's gradient there is the sum of the ranks' partial ones.
    `DTensor`'s own strategies for an index into a sharded table are not in
    every release (torch 2.11 has none for the backward's ``index_add``),
    so both ways index local shards through `local_map`."""
    if not isinstance(table, DTensor):
        return table[ids]
    mesh = table.device_mesh
    ids = replicate_like(ids, table)
    cols = [Shard(1) if isinstance(t, Shard) and t.dim == 0 and not isinstance(p, Shard)
            else Replicate() for t, p in zip(table.placements, ids.placements)]
    ways = math.prod(mesh.size(m) for m, c in enumerate(cols) if c != Replicate())
    moved_by_ids = ids.numel() * (ids.element_size() + 2 * table.shape[1] * table.element_size())
    if (ways == 1 or table.shape[1] % ways
            or moved_by_ids < table.numel() * table.element_size() / ways):
        return _sharded_lookup(table, ids)
    # The mesh dims that go whole first (an all-gather of a slice), then
    # the rows' split swapped for the columns' by one all-to-all.
    grad = [Partial() if isinstance(p, Shard) else c for p, c in zip(ids.placements, cols)]
    out = [Shard(p.dim % ids.ndim) if isinstance(p, Shard) else Shard(ids.ndim) if c != Replicate()
           else Replicate() for p, c in zip(ids.placements, cols)]
    return local_map(lambda t, i: t[i], out_placements=out,
                     in_placements=(cols, ids.placements),
                     in_grad_placements=(grad, ids.placements),
                     device_mesh=mesh)(relaid(table, cols), ids)


def _sharded_lookup(table: DTensor, ids: DTensor) -> DTensor:
    """table[ids] with the table left where it lies: the ids are made whole
    on every mesh dim that splits the table, and each rank looks them up in
    its own rows, zeros for an id outside them. The output is split along
    d where the table's columns are, a partial sum over the mesh dims that
    split its rows, and laid out as the ids elsewhere; the caller's layout
    reduces it. The gradient is each rank's scatter-add of its own ids into
    its own rows, on its local shard: no `DTensor` ``index_add``; a partial
    sum over the mesh dims that split the ids and not the table."""
    mesh = table.device_mesh
    ids = ids.redistribute(mesh, [Replicate() if isinstance(t, Shard) else p
                                  for t, p in zip(table.placements, ids.placements)])
    out = [Partial() if isinstance(t, Shard) and t.dim == 0
           else Shard(ids.ndim) if isinstance(t, Shard)
           else Shard(p.dim % ids.ndim) if isinstance(p, Shard) else Replicate()
           for t, p in zip(table.placements, ids.placements)]
    grad = [Partial() if t == Replicate() and isinstance(p, Shard) else t
            for t, p in zip(table.placements, ids.placements)]
    first, rows = local_extent(table, 0)

    def lookup(t: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
        j = i - first
        mine = (j >= 0) & (j < rows)
        return torch.where(mine[..., None], t[j.clamp(0, rows - 1)], 0.0)

    return local_map(lookup, out_placements=out,
                     in_placements=(table.placements, ids.placements),
                     in_grad_placements=(grad, ids.placements),
                     device_mesh=mesh)(table, ids)


def embed_tokens(p: dict, cfg: ModelConfig, ids: torch.Tensor) -> torch.Tensor:
    x = _lookup(p["table"], ids).to(COMPUTE_DTYPE)
    return x * torch.tensor(cfg.embedding_multiplier, dtype=COMPUTE_DTYPE)


def output_table(p: dict) -> torch.Tensor:
    return p.get("out_table", p["table"])


# --------------------------------------------------------------------------- #
# Attention (GQA, RoPE, KV cache, cross-attention)
# --------------------------------------------------------------------------- #
@dataclass
class KVCache:
    k: torch.Tensor   # (B, S_max, H_kv, D_h), or (periods, B, ...) when stacked
    v: torch.Tensor
    length: int       # number of valid positions, kept on the host


def attention_spec(cfg: ModelConfig) -> dict:
    d, hq, hkv, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    spec = {
        "wq": ParamSpec((d, hq, dh), ("fsdp", "tp", None), ("fan_in", d)),
        "wk": ParamSpec((d, hkv, dh), ("fsdp", "tp", None), ("fan_in", d)),
        "wv": ParamSpec((d, hkv, dh), ("fsdp", "tp", None), ("fan_in", d)),
        "wo": ParamSpec((hq, dh, d), ("tp", None, "fsdp"), ("fan_in", hq * dh)),
    }
    if cfg.qkv_bias:
        spec["bq"] = ParamSpec((hq, dh), ("tp", None), "zeros")
        spec["bk"] = ParamSpec((hkv, dh), ("tp", None), "zeros")
        spec["bv"] = ParamSpec((hkv, dh), ("tp", None), "zeros")
    if cfg.out_bias:
        spec["bo"] = ParamSpec((d,), (None,), "zeros")
    if cfg.qk_norm:
        spec["q_norm"] = norm_spec(cfg, dh)
        spec["k_norm"] = norm_spec(cfg, dh)
    return spec


def _head_shardable(hq: int) -> bool:
    """True when the q-head count divides the tensor axis under the ambient
    rules — selects the collective-free head-sharded attention path."""
    rules = current_rules()
    return (
        rules is not None
        and rules.mesh is not None
        and rules.resolve_dim("heads", hq) is not None
    )


def _kv_seq_whole(sk: int) -> bool:
    """True when k/v of `sk` positions laid out on ``kv_seq`` leave every
    rank the whole sequence: no mesh, ``kv_seq`` unresolved, or resolved to
    mesh axes of one rank in all."""
    rules = current_rules()
    if rules is None or rules.mesh is None:
        return True
    axes = rules.resolve_dim("kv_seq", sk)
    return axes is None or math.prod(rules._axis_size(a) for a in axes) == 1


def _batch_only(t: torch.Tensor) -> torch.Tensor:
    """`t` split across ranks on its batch dim (dim 0) at most: a `DTensor`
    split elsewhere is gathered and a partial sum reduced, as the kv_seq
    mode's queries must be, every rank reading all heads against its k/v
    positions."""
    if not isinstance(t, DTensor):
        return t
    placements = [p if isinstance(p, Shard) and p.dim % t.ndim == 0 else Replicate()
                  for p in t.placements]
    if placements == list(t.placements):
        return t
    return t.redistribute(t.device_mesh, placements)


def _context_for_wo(o: torch.Tensor) -> torch.Tensor:
    """The attention output (B, S, H, D) as (B, S, H * D) for the output
    projection, split as ``wo``'s contraction is. Where the ambient rules
    split ``heads``, it is laid out as ``("batch", None, "heads", None)``.
    Elsewhere (the kv_seq mode: the heads do not split the tensor axis) a
    partial sum over the key positions' ranks is reduce-scattered onto the
    merged H * D columns, the rows of ``wo`` that each rank then multiplies,
    and the product's partial sums are reduced once, onto the residual
    stream. Not a `constrain` (the reference has none here): `DTensor`,
    weighing communication alone, all-reduces the whole context first
    (whisper-2l prefill_32k on 16 x 16: a (2, 32768, 20, 64) bf16
    all-reduce a layer) or reduce-scatters it onto the sequence and
    gathers it back (granite-2l: (2, 2048, 24, 64) and (32, 2048, 24, 64),
    2.01e8 B each), where the reference's partitioner reduces it once."""
    rules = current_rules()
    if not isinstance(o, DTensor) or rules is None or rules.mesh is None:
        return merge_dims(o, 2, 3)
    heads = rules.sharding(("batch", None, "heads", None), tuple(o.shape)).placements
    if any(isinstance(p, Shard) and p.dim == 2 for p in heads) or not any(
            p.is_partial() for p in o.placements):
        return merge_dims(o.redistribute(o.device_mesh, heads), 2, 3)
    mesh = o.device_mesh
    o = _rank_by_rank(lambda t: t.flatten(2, 3), o)
    cols = o.shape[2]
    return o.redistribute(mesh, [
        (Shard(2) if cols % mesh.size(m) == 0 else Replicate()) if p.is_partial() else p
        for m, p in enumerate(o.placements)])


def _contraction_split(o: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """`o` (B, S, H * D) for ``o @ wo``, ``wo`` being `w` (H * D, d). Under
    autograd, on a mesh dim of more than one rank across which both hold
    every head (the kv_seq mode: the heads do not split), `o` is split
    along its heads: the forward's contraction is split so already, and
    the gradient ``o^T dy`` is then computed a slice of rows on each rank
    of that dim rather than whole on each, which `DTensor`, weighing
    communication alone, picks otherwise."""
    if not (isinstance(o, DTensor) and isinstance(w, DTensor) and ops.needs_grad(o, w)):
        return o
    mesh = o.device_mesh
    placements = [Shard(2) if p == Replicate() and q == Replicate() and mesh.size(m) > 1
                  and o.shape[2] % mesh.size(m) == 0 else p
                  for m, (p, q) in enumerate(zip(o.placements, w.placements))]
    if placements == list(o.placements):
        return o
    return o.redistribute(mesh, placements)


def _repeat_heads(t: torch.Tensor, g: int) -> torch.Tensor:
    """(B, S, H_kv, D) -> (B, S, H_kv * g, D), kv head j at heads j*g ..
    j*g + g - 1."""
    if g == 1:
        return t
    b, s, h, d = t.shape
    return merge_dims(t.unsqueeze(3).expand(b, s, h, g, d), 2, 3)


def _head_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b over (B, H) batch dims. Two `DTensor`s laid out alike and split
    on those dims at most (head mode: batch and heads) multiply rank by
    rank, each its own (batch, head) slices: no collective, and no reshape
    of two split dims into one, which `DTensor` cannot always express."""
    if not isinstance(a, DTensor) or a.placements != b.placements or any(
            p.is_partial() or (isinstance(p, Shard) and p.dim % a.ndim > 1)
            for p in a.placements):
        return a @ b
    return local_map(torch.matmul, out_placements=list(a.placements),
                     in_placements=(a.placements, b.placements),
                     device_mesh=a.device_mesh)(a, b)


def _positions_along(t: torch.Tensor, dim: int) -> torch.Tensor:
    """arange(t.shape[dim]), a `DTensor` split as `t` splits dim `dim` when
    `t` is one: masks built from it meet the scores in their own layout."""
    pos = torch.arange(t.shape[dim], device=t.device)
    if not isinstance(t, DTensor):
        return pos
    placements = [Shard(0) if isinstance(p, Shard) and p.dim % t.ndim == dim else Replicate()
                  for p in t.placements]
    return distribute_tensor(pos, t.device_mesh, placements, src_data_rank=None)


def _reduced(t: torch.Tensor) -> torch.Tensor:
    """`t`, a reduction over a dim split across ranks (a partial sum there),
    all-reduced, and its gradient brought whole onto every rank of that
    dim before the backward pass expands it back over the split dim. The
    reference's partitioner does the same: a small all-reduce each way.
    `DTensor` otherwise reduces the sum inside the op that reads it and
    hands the backward a partial-sum gradient, which the expand turns into
    a partial sum of the split tensor's whole size, reduce-scattered onto
    its split (in the kv_seq mode a fp32 (B, H_kv, C, g, S_k) score-sized
    reduce-scatter a chunk), or moves the split tensor across the mesh to
    meet it (a norm's input, from its d split to a batch split)."""
    if not isinstance(t, DTensor) or not any(p.is_partial() for p in t.placements):
        return t
    t = t.redistribute(t.device_mesh, [Replicate() if p.is_partial() else p
                                       for p in t.placements])
    return grad_in_layout(t)


def _softmax(s: torch.Tensor) -> torch.Tensor:
    """Softmax over the last dim as the reference computes it, exp(s - max)
    over its sum, the max taken without gradient: on a dim sharded across
    ranks the max and the sum are partial reductions, all-reduced
    (`_reduced`), not a gather of the scores."""
    e = torch.exp(s - s.amax(dim=-1, keepdim=True).detach())
    return e / _reduced(e.sum(dim=-1, keepdim=True))


def _logsumexp(x: torch.Tensor) -> torch.Tensor:
    """log(sum(exp(x))) over the last dim as the reference computes it, the
    max (without gradient) plus the log of the sum of exp(x - max): on a
    dim sharded across ranks (the loss's vocabulary) two small
    all-reduces, where `DTensor`'s own ``logsumexp`` gathers the logits."""
    m = x.amax(dim=-1, keepdim=True).detach()
    return (m + torch.log(_reduced(torch.exp(x - m).sum(dim=-1, keepdim=True)))).squeeze(-1)


def _pv_split_over_idle_axes(pm: torch.Tensor, vt: torch.Tensor, g: int) -> torch.Tensor:
    """The kv_seq mode's ``pm @ vt``: probabilities (B, H_kv, C * g, S_k)
    (chunk rows outer, groups inner) times values (B, H_kv, S_k, D), in
    (B, H_kv, C * g, D). Where a mesh dim of more than one rank splits
    neither (the data axis at batch 1, long_500k's decode), its ranks each
    compute the product for their own slice of the H_kv * g query heads and
    the slices are gathered after, as the reference's partitioner splits
    the output there; otherwise every rank of that axis computes it whole
    (or, where `DTensor` split the probabilities' kv heads on its own, some
    ranks of it repeat each other's). Not a `constrain` (the reference has
    none here). Serving only: a call that needs gradients takes the plain
    product."""
    if not (isinstance(pm, DTensor) and isinstance(vt, DTensor)) or ops.needs_grad(pm, vt):
        return pm @ vt
    mesh = pm.device_mesh
    hkv, cg = pm.shape[1], pm.shape[2]
    heads = hkv * g
    idle = [m for m, q in enumerate(vt.placements) if q == Replicate() and mesh.size(m) > 1]
    n = math.prod(mesh.size(m) for m in idle)
    per = heads // n if idle and heads % n == 0 else 0
    # A rank's heads are some groups of one kv head, or whole kv heads.
    if not per or (g % per if per < g else per % g):
        return pm @ vt
    # Probabilities `DTensor` split there on its own are gathered first
    # (one query row a step: small), so that the heads split evenly.
    pm = pm.redistribute(mesh, [Replicate() if m in idle else p
                                for m, p in enumerate(pm.placements)])
    out = []
    for m, (p, q) in enumerate(zip(pm.placements, vt.placements)):
        if m in idle:
            out.append(Shard(1))
        elif p == q == Shard(0):
            out.append(p)
        elif p == Shard(3) and q == Shard(2):
            out.append(Partial())
        else:
            return pm @ vt
    coord = mesh.get_coordinate()
    rank = 0
    for m in idle:                      # the idle axes' ranks, mesh-major
        rank = rank * mesh.size(m) + coord[m]
    kvs, gs = max(1, per // g), min(g, per)
    j0, g0 = rank * per // g, rank * per % g
    c = cg // g

    def product(pl: torch.Tensor, vl: torch.Tensor) -> torch.Tensor:
        """This rank's heads (head h reads kv head h // g), (B, per, C, D):
        slices of the probabilities, views of the values."""
        pl = pl.unflatten(2, (c, g)).transpose(2, 3)[:, j0:j0 + kvs, g0:g0 + gs]
        o = pl.flatten(2, 3) @ vl[:, j0:j0 + kvs]                     # (B, kvs, gs * C, D)
        return o.unflatten(2, (gs, c)).flatten(1, 2)

    o = local_map(product, out_placements=out, in_placements=(pm.placements, vt.placements),
                  device_mesh=mesh)(pm, vt)
    o = o.redistribute(mesh, [Replicate() if m in idle else p for m, p in enumerate(o.placements)])
    o = split_dim(o, 1, (hkv, g)).transpose(2, 3)                      # (B, H_kv, C, g, D)
    return merge_dims(o, 2, 3)


def _attn_core(
    q: torch.Tensor,        # (B, S_q, H_q, D_h)
    k: torch.Tensor,        # (B, S_k, H_kv, D_h)
    v: torch.Tensor,
    *,
    causal: bool,
    q_offset: int,          # global position of q[:, 0]
    kv_valid_len: int | None = None,   # mask kv positions >= this
    q_chunk: int = 512,
    head_mode: bool | None = None,
) -> torch.Tensor:
    """Plain attention in query chunks, masking by absolute position and by
    the valid cache length. Under autograd each chunk is recomputed in the
    backward pass (as `jax.checkpoint` per chunk does), so no chunk's fp32
    probabilities are kept.

    The reference's two sharding modes:
      * head-sharded (`head_mode`; by default wherever the q heads divide
        the tensor axis): k/v expanded to the q heads (head h reads kv
        head h // g), laid out on ``heads`` with the query chunks and the
        scores; the context in v's dtype (the reference's
        preferred_element_type);
      * kv_seq-sharded otherwise: k/v on ``kv_seq``, the scores along it,
        GQA groups kept (q as (B, H_kv, S_q, g, D_h)), every rank reading
        all the query heads against its k/v positions."""
    b, sq, hq, dh = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = dh ** -0.5
    if head_mode is None:
        head_mode = _head_shardable(hq)

    if head_mode:
        # Head h reads kv head h // g: each kv head repeated g times in
        # place (the reference's take by arange(hq) // g), as a broadcast,
        # whose gradient is a sum rather than an indexed add.
        k = constrain(_repeat_heads(k, g), "batch", None, "heads", None)
        v = constrain(_repeat_heads(v, g), "batch", None, "heads", None)
    else:
        k = constrain(k, "batch", "kv_seq", None, None)
        v = constrain(v, "batch", "kv_seq", None, None)
        q = _batch_only(q)
    # The contractions are matmuls over (B, heads) batch dims with the
    # sequence dims last, the reference's einsums in an order that keeps
    # every reshape of a sharded dim at a shard boundary; the work that
    # does not depend on the chunk is done once, outside the chunk loop.
    kt = k.float().permute(0, 2, 3, 1)        # (B, H, D, S_k)
    vt = v.transpose(1, 2)                    # (B, H, S_k, D)
    kv_pos = _positions_along(k, 1).unsqueeze(0)    # (1, S_k), laid out as k's positions
    q_pos = replicate_like(q_offset + torch.arange(sq, device=q.device), kv_pos)
    # Positions past the valid length are masked in every chunk.
    invalid = None if kv_valid_len is None else kv_pos >= kv_valid_len
    if head_mode:
        qs = q                                # (B, S_q, H, D)
    else:
        qs = split_dim(q, 2, (hkv, g)).float().permute(0, 2, 1, 3, 4)   # (B, H_kv, S_q, g, D)

    def chunk_attn(q_c: torch.Tensor, i: int) -> torch.Tensor:
        """The context of queries i .. i + C - 1: (B, H, C, D) in head mode,
        (B, H_kv, C * g, D) (chunk rows outer, groups inner) otherwise."""
        c = q_c.shape[1] if head_mode else q_c.shape[2]
        masked = invalid
        if causal:
            later = kv_pos > q_pos[i:i + c].unsqueeze(1)      # (C, S_k)
            masked = later if masked is None else (later | masked)
        if head_mode:
            qh = constrain(q_c, "batch", None, "heads", None)
            s = _head_matmul(qh.float().transpose(1, 2), kt) * scale   # (B, H, C, S)
            s = constrain(s, "batch", "heads", None, None)
            if masked is not None:
                s = s.masked_fill(masked, NEG_INF)
            return _head_matmul(_softmax(s).to(v.dtype), vt)           # (B, H, C, D)
        s = split_dim(merge_dims(q_c, 2, 3) @ kt, 2, (c, g)) * scale
        s = constrain(s, "batch", None, None, None, "kv_seq")  # (B, H_kv, C, g, S)
        if masked is not None:
            s = s.masked_fill(masked.unsqueeze(1), NEG_INF)
        o = _pv_split_over_idle_axes(merge_dims(_softmax(s).to(v.dtype), 2, 3), vt, g)
        # Training all-reduces the context's partial sums over kv_seq, as
        # the reference does, so that its gradient reaches the products of
        # the scores whole and they stay split along S_k. `DTensor` would
        # reduce-scatter the sum onto the batch and bring the gradient back
        # so, moving score-sized tensors in the backward pass.
        return _reduced(o) if ops.needs_grad(o) else o

    dim = 1 if head_mode else 2               # the query dim of `qs`
    if sq <= q_chunk:
        out = chunk_attn(qs, 0)
    else:
        remat = ops.needs_grad(q, k, v)
        chunks = []
        for i in range(0, sq, q_chunk):
            args = (qs.narrow(dim, i, min(q_chunk, sq - i)), i)
            chunks.append(checkpoint(under_current_rules(chunk_attn), *args, use_reentrant=False)
                          if remat
                          else chunk_attn(*args))
        out = torch.cat(chunks, dim=2)
    if head_mode:
        return out.transpose(1, 2).to(q.dtype)

    def heads_last(t: torch.Tensor) -> torch.Tensor:
        """(B, H_kv, S_q * g, D) -> (B, S_q, H_kv * g, D)."""
        t = split_dim(t, 2, (sq, g)).permute(0, 2, 1, 3, 4)             # (B, S_q, H_kv, g, D)
        return merge_dims(t, 2, 3)

    return _rank_by_rank(heads_last, out).to(q.dtype)


def _rank_by_rank(fn, t: torch.Tensor) -> torch.Tensor:
    """``fn(t)`` for a reshape `fn` that keeps dim 0. A `DTensor` split on
    its batch dim at most goes rank by rank through `local_map`, so that a
    partial sum (the kv_seq mode's context) stays one: `DTensor` reduces a
    partial sum before a reshape that merges two dims (granite-2l
    prefill_32k: onto the sequence, gathered back after)."""
    if not isinstance(t, DTensor) or any(isinstance(p, Shard) and p.dim % t.ndim
                                         for p in t.placements):
        return fn(t)
    return local_map(fn, out_placements=list(t.placements), in_placements=(t.placements,),
                     device_mesh=t.device_mesh)(t)


def _gathered_over_batch(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The weight `w` (K, N) of a product ``x @ w`` where a mesh dim splits
    the batch of `x` (dim 0), laid out so that each rank multiplies its own
    shards: whole on every such mesh dim (the FSDP weight gathered at its
    use), split along K where `x` is split along K (the contraction split,
    a partial sum), and elsewhere split along N where it divides (each rank
    its own output columns). Not a `constrain` (the reference has none
    here): `DTensor`, weighing communication alone, otherwise gathers the
    activations' batch where they are the smaller tensor (a decode step's
    one token a row) and computes the product for the whole batch on every
    rank of the data axis, 16 times its share; the reference's partitioner
    gathers the weight. With no batch split (batch 1) `w` is left as it
    is: there a gather of the one row costs less than one of the weight."""
    if not (isinstance(w, DTensor) and isinstance(x, DTensor)) or not any(
            isinstance(q, Shard) and q.dim % x.ndim == 0 for q in x.placements):
        return w
    mesh = w.device_mesh
    placements = []
    for m, (p, q) in enumerate(zip(w.placements, x.placements)):
        if isinstance(q, Shard) and q.dim % x.ndim == 0:
            placements.append(Replicate())
        elif isinstance(q, Shard) and q.dim % x.ndim == x.ndim - 1:
            placements.append(Shard(0))
        elif p == Replicate() and q == Replicate() and w.shape[1] % mesh.size(m) == 0:
            placements.append(Shard(1))
        else:
            placements.append(p)
    if placements == list(w.placements):
        return w
    return w.redistribute(mesh, placements)


def _plus_bias(y: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """y + b, `b` over the trailing dims of `y`. Where `y` is a partial sum
    (a split contraction) on a mesh dim that splits `b`, the sum is reduced
    first into the bias's split, one reduce-scatter: the layout `DTensor`
    picks itself in torch 2.13, where 2.11 would make the split bias a
    partial sum instead and has no rule for that."""
    if isinstance(y, DTensor) and isinstance(b, DTensor):
        lead = y.ndim - b.ndim
        placements = [Shard(q.dim % b.ndim + lead) if p.is_partial() and isinstance(q, Shard)
                      else p for p, q in zip(y.placements, b.placements)]
        if placements != list(y.placements):
            y = y.redistribute(y.device_mesh, placements)
    return y + b


def _project(x: torch.Tensor, w: torch.Tensor, *, kv_seq: bool = False) -> torch.Tensor:
    """einsum("bsd,dhk->bshk") as one matmul over the flattened heads, the
    weight gathered over the batch's mesh axes. With `kv_seq` (k and v for
    the kv_seq mode) the output (B, S, H * D), split along its columns on
    the mesh dim that ``kv_seq`` resolves to, is split along S there
    instead, by one all-to-all (`relaid`). Not a `constrain` (the
    reference has none here)."""
    h, k = w.shape[1], w.shape[2]
    w = _gathered_over_batch(merge_dims(w.to(x.dtype), 1, 2), x)
    y = x @ w
    rules = current_rules()
    if kv_seq and isinstance(y, DTensor) and rules is not None and rules.mesh is not None:
        seq = rules.sharding(("batch", "kv_seq", None), tuple(y.shape)).placements
        y = relaid(y, [q if q == Shard(1) else p for p, q in zip(y.placements, seq)])
    return split_dim(y, -1, (h, k))


def attention(
    p: dict,
    cfg: ModelConfig,
    x: torch.Tensor,                       # (B, S, D)
    *,
    start: int = 0,                        # global position of x[:, 0]
    causal: bool = True,
    kv_source: torch.Tensor | None = None,  # cross-attention source (B, S_kv, D)
    cache: KVCache | None = None,
    update_cache: bool = False,            # prefill/decode: write new k/v into cache
    q_chunk: int = 512,
) -> tuple[torch.Tensor, KVCache | None]:
    """Positions of x are start .. start + S - 1 in every row, as in every
    caller of the JAX package's `attention`. With `kv_source` (training's
    cross-attention) k/v come from that sequence, unmasked; a cache passed
    without `update_cache` (the decoder's cross cache at prefill and decode)
    is read as it is. `attention_context`, then `attention_output`."""
    o, wo, new_cache = attention_context(p, cfg, x, start=start, causal=causal,
                                         kv_source=kv_source, cache=cache,
                                         update_cache=update_cache, q_chunk=q_chunk)
    return attention_output(p, o @ wo), new_cache


def attention_context(
    p: dict,
    cfg: ModelConfig,
    x: torch.Tensor,
    *,
    start: int = 0,
    causal: bool = True,
    kv_source: torch.Tensor | None = None,
    cache: KVCache | None = None,
    update_cache: bool = False,
    q_chunk: int = 512,
) -> tuple[torch.Tensor, torch.Tensor, KVCache | None]:
    """`attention` up to its output projection: (the context (B, S, H * D)
    laid out for ``wo``'s contraction, ``wo`` (H * D, d) in x's dtype, the
    cache)."""
    rope = cfg.use_rope and kv_source is None
    b, s, _ = x.shape
    positions = torch.arange(start, start + s, device=x.device)
    # A query block at position 0 against an empty or absent cache sees
    # exactly its own k/v: all of them (the encoder), or under the kernel's
    # top-left causal mask.
    prefill = (kv_source is None and start == 0
               and (cache is None or (update_cache and cache.length == 0)))

    # The reference's two attention modes (`_attn_core`): heads split over
    # the tensor axis where they divide it, except against a cache (the
    # serving layout keeps k/v on ``kv_seq``).
    head_mode = cache is None and _head_shardable(cfg.num_heads)
    q = _project(x, p["wq"])
    if "bq" in p:
        q = _plus_bias(q, p["bq"].to(x.dtype))
    if cfg.qk_norm:
        q = apply_norm(p["q_norm"], cfg, q)

    if cache is not None and not update_cache:
        # Read-only cache (precomputed KV).
        k, v, kv_len = cache.k, cache.v, cache.length
        new_cache = cache
    else:
        k, v = _kv(p, cfg, kv_source if kv_source is not None else x, kv_seq=not head_mode)
        if rope:
            k = apply_rope(k, positions, cfg.rope_theta)
        if cache is not None:
            # Append new K/V at cache.length, IN PLACE: unlike the JAX
            # package's functional update, the caller's buffers change and
            # the returned cache shares them.
            end = cache.length + s
            write_slice(cache.k, 1, cache.length, k)
            write_slice(cache.v, 1, cache.length, v)
            new_cache = KVCache(cache.k, cache.v, end)
            if prefill:
                kv_len = None     # the new k/v are the whole cache
            else:
                k, v, kv_len = cache.k, cache.v, end
        else:
            kv_len = None
            new_cache = None

    if rope:
        q = apply_rope(q, positions, cfg.rope_theta)

    # Training's calls that fit go through the flash kernel with its
    # backward; serving's prefill through the forward-only one. Under a mesh
    # both take only layouts with whole (batch, head) slices on every rank:
    # head mode, or the kv_seq mode's k/v over one rank at most.
    if trains_through_flash(q, k, v, cache=cache, start=start, head_mode=head_mode):
        entry = ops.flash_attention_train
    elif (prefill and not ops.needs_grad(q, k, v) and _kv_seq_whole(k.shape[1])
            and not head_mode):
        entry = ops.flash_attention
    else:
        entry = None
    if entry is not None:
        if head_mode:
            q, k, v = (constrain(t, "batch", None, "heads", None) for t in (q, k, v))
        else:
            k = constrain(k, "batch", "kv_seq", None, None)
            v = constrain(v, "batch", "kv_seq", None, None)
        # (B, S, H, D) -> (B, H, S, D) strided views, GQA's groups not
        # expanded (head h reads kv head h // g); the kernels write their
        # output in q's memory layout, so the transpose back is free.
        out = entry(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                    causal=causal and kv_source is None).transpose(1, 2)
    else:
        # Cache-backed paths (prefill/decode) keep the serving KV layout
        # (kv_seq-sharded); the head-sharded mode serves training and
        # encoder/cross attention computed from source activations.
        out = _attn_core(q, k, v, causal=causal and kv_source is None,
                         q_offset=start, kv_valid_len=kv_len, q_chunk=q_chunk,
                         head_mode=head_mode)
    wo = merge_dims(p["wo"].to(x.dtype), 0, 1)
    return _contraction_split(_context_for_wo(out), wo), wo, new_cache


def trains_through_flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         cache: KVCache | None, start: int, head_mode: bool) -> bool:
    """Whether an attention call of q (B, S_q, H_q, D), k, v (B, S_k, H_kv,
    D) goes through the flash kernel with its backward
    (`ops.flash_attention_train`): gradients are needed; the tensors are
    bf16 on CUDA; no cache and queries from position 0; a head dim the
    kernels compile; every rank holds whole (batch, head) slices (head mode,
    or k/v whole along the sequence). Every other call takes `_attn_core`
    as it was: the CPU, the dry-run's ``meta`` tensors, fp32 activations,
    kv_seq-split layouts, serving."""
    return (ops.needs_grad(q, k, v) and ops.flash_train_fits(q, k, v)
            and cache is None and start == 0
            and (head_mode or _kv_seq_whole(k.shape[1])))


def attention_output(p: dict, y: torch.Tensor) -> torch.Tensor:
    """The output projection `y` (``o @ wo`` of `attention_context`'s
    context), its bias added, laid out on the residual stream."""
    if "bo" in p:
        y = y + p["bo"].to(y.dtype)
    return constrain(y, "batch", None, "residual")


def _kv(p: dict, cfg: ModelConfig, src: torch.Tensor, *,
        kv_seq: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    k = _project(src, p["wk"], kv_seq=kv_seq)
    v = _project(src, p["wv"], kv_seq=kv_seq)
    if "bk" in p:
        k = _plus_bias(k, p["bk"].to(src.dtype))
        v = _plus_bias(v, p["bv"].to(src.dtype))
    if cfg.qk_norm:
        k = apply_norm(p["k_norm"], cfg, k)
    return k, v


def compute_kv(p: dict, cfg: ModelConfig, src: torch.Tensor) -> KVCache:
    """A read-only KV cache of `src` (encoder states, for cross-attention at
    prefill and decode), in `src`'s dtype, which is the activations' dtype
    as `make_cache`'s default is, laid out on ``kv_seq``; its host `length`
    is the source length."""
    k, v = _kv(p, cfg, src, kv_seq=True)
    k = constrain(k, "batch", "kv_seq", None, None)
    v = constrain(v, "batch", "kv_seq", None, None)
    return KVCache(k=k, v=v, length=src.shape[1])


def make_cache(cfg: ModelConfig, batch: int, max_len: int, *, device,
               dtype: torch.dtype | None = None, length: int = 0) -> KVCache:
    """Zero k/v buffers in `dtype`, by default the activations' dtype at the
    time of the call (`COMPUTE_DTYPE`, bf16), as the Mamba caches follow
    it: with fp32 activations, decode then reads the k/v that prefill
    computed, unrounded."""
    dtype = COMPUTE_DTYPE if dtype is None else dtype
    shape = (batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        length=length,
    )


def cache_logical_axes() -> KVCache:
    """Logical axes of a `KVCache`'s buffers (its host-side length has none)."""
    return KVCache(
        k=Ax(("batch", "kv_seq", None, None)),
        v=Ax(("batch", "kv_seq", None, None)),
        length=None,
    )


# --------------------------------------------------------------------------- #
# MLP (gated or plain)
# --------------------------------------------------------------------------- #
def mlp_spec(cfg: ModelConfig) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    spec = {
        "w_up": ParamSpec((d, f), ("fsdp", "tp"), ("fan_in", d)),
        "w_down": ParamSpec((f, d), ("tp", "fsdp"), ("fan_in", f)),
    }
    if cfg.glu:
        spec["w_gate"] = ParamSpec((d, f), ("fsdp", "tp"), ("fan_in", d))
    if cfg.out_bias:
        spec["b_up"] = ParamSpec((f,), ("tp",), "zeros")
        spec["b_down"] = ParamSpec((d,), (None,), "zeros")
    return spec


def _act(cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation.
    return F.silu(x) if cfg.act == "silu" else F.gelu(x, approximate="tanh")


def mlp(p: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    h, w_down = mlp_hidden(p, cfg, x)
    return mlp_output(p, h @ w_down)


def mlp_hidden(p: dict, cfg: ModelConfig, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """`mlp` up to its down projection: (the hidden state, laid out on
    ``tp``, ``w_down`` in x's dtype)."""
    h = x @ p["w_up"].to(x.dtype)
    if "b_up" in p:
        h = _plus_bias(h, p["b_up"].to(x.dtype))
    if cfg.glu:
        gate = x @ p["w_gate"].to(x.dtype)
        h = _act(cfg, gate) * h
    else:
        h = _act(cfg, h)
    return constrain(h, "batch", None, "tp"), p["w_down"].to(x.dtype)


def mlp_output(p: dict, y: torch.Tensor) -> torch.Tensor:
    """The down projection `y` of `mlp_hidden`'s hidden state, its bias
    added, laid out on the residual stream."""
    if "b_down" in p:
        y = y + p["b_down"].to(y.dtype)
    return constrain(y, "batch", None, "residual")
