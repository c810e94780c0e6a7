"""LM backbone: attention or Mamba mixers, each with a dense FFN, a
Mixture-of-Experts FFN (``models/moe.py``) or none, and in an
encoder-decoder's decoder blocks a cross-attention to the encoder
(``models/encdec.py``).

The port of the JAX package's ``models/lm.py``. The layer stack is
`cfg.periods` repetitions of the config's block pattern (or the given
`pattern` and periods: the encoder's stack, which keeps no cache) with
parameters stacked on a leading periods axis; `stack_fwd` walks that axis in a Python loop, each
period recomputed in the backward pass when `remat` is set. Decode caches
(attention KV caches, read-only cross-attention caches and Mamba conv/SSM
states) are stacked the same way and updated in place. MoE blocks return
a Switch auxiliary loss, summed over the stack. The training loss is
`lm_loss`: the hidden states, then `chunked_xent` over the output table,
plus the weighted aux term for MoE configs.

While a profiler session runs, each block's token mixer (``layer.mixer``;
not in a parallel block, whose last products mix both branches) and FFN
(``layer.mlp``) and the loss head (``layer.loss_head``) are spans
(`repro_torch.spans`), forward and backward.

Under a mesh the hidden states are laid out where the reference's
`constrain` puts them, the caches `lm_prefill` builds are sharded by
`stack_cache_axes` (the layout of the decode cells' abstract caches), and
the loss picks each label's logit by a masked sum over the vocabulary,
which `DTensor` computes on vocabulary-sharded logits; their ``logsumexp``
reduces a max and a sum across the vocabulary's ranks (`layers._logsumexp`),
and in training the output table is gathered over the batch's axes.
"""

from __future__ import annotations

import dataclasses
import struct

import torch
from torch.distributed.tensor import DTensor, Shard
from torch.utils.checkpoint import checkpoint

from repro_torch import spans
from repro_torch.configs.base import BlockDef, ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import ssd as S
from repro_torch.models.spec import Ax, abstract_like, stacked
from repro_torch.sharding.rules import (
    constrain,
    current_rules,
    relaid,
    under_current_rules,
)

NEG_INF = -1e30


def _check_block(cfg: ModelConfig, bd: BlockDef) -> None:
    if bd.mixer not in ("attn", "mamba") or bd.ffn not in ("dense", "moe", None):
        raise NotImplementedError(
            f"{cfg.name}: block {bd} is not ported; the port covers attention "
            f"and Mamba mixers with a dense or MoE FFN or none")


# --------------------------------------------------------------------------- #
# Block spec / forward
# --------------------------------------------------------------------------- #
def block_spec(cfg: ModelConfig, bd: BlockDef) -> dict:
    _check_block(cfg, bd)
    spec: dict = {"norm1": L.norm_spec(cfg)}
    if bd.mixer == "attn":
        spec["attn"] = L.attention_spec(cfg)
    else:
        spec["mamba"] = S.mamba_spec(cfg)
    if bd.cross_attn:
        spec["norm_cross"] = L.norm_spec(cfg)
        spec["cross"] = L.attention_spec(cfg)
    if bd.ffn is not None and not cfg.parallel_block:
        spec["norm2"] = L.norm_spec(cfg)
    if bd.ffn == "dense":
        spec["ffn"] = L.mlp_spec(cfg)
    elif bd.ffn == "moe":
        spec["ffn"] = M.moe_spec(cfg)
    return spec


def block_cache_spec(cfg: ModelConfig, bd: BlockDef) -> dict:
    """Logical-axis tree describing this block's decode cache."""
    spec: dict = {}
    if bd.mixer == "attn":
        spec["attn"] = L.cache_logical_axes()
    else:
        spec["mamba"] = S.mamba_cache_logical_axes()
    if bd.cross_attn:
        spec["cross"] = L.cache_logical_axes()
    return spec


def make_block_cache(cfg: ModelConfig, bd: BlockDef, batch: int, max_len: int,
                     *, device, cross_len: int = 0, length: int = 0) -> dict:
    """The block's decode caches; a cross-attention block's `"cross"` cache
    holds `cross_len` positions, all valid."""
    _check_block(cfg, bd)
    cache: dict = {}
    if bd.mixer == "attn":
        cache["attn"] = L.make_cache(cfg, batch, max_len, device=device, length=length)
    else:
        cache["mamba"] = S.make_mamba_cache(cfg, batch, device=device)
    if bd.cross_attn:
        cache["cross"] = L.make_cache(cfg, batch, cross_len, device=device, length=cross_len)
    return cache


def rounded_to(value: float, dtype: torch.dtype) -> float:
    """`value` rounded to `dtype` (float32 or bfloat16, nearest, ties to
    even; any other dtype keeps it), as a Python number: a product with it
    rounds as one with the reference's ``jnp.asarray(value, dtype)`` does,
    and saves no tensor for the backward pass, so a recomputed period
    stops at its last product's inputs instead of recomputing that
    product (torch.utils.checkpoint recomputes until every saved tensor
    is back)."""
    if dtype == torch.float32:
        return struct.unpack("<f", struct.pack("<f", value))[0]
    if dtype == torch.bfloat16:
        bits = struct.unpack("<I", struct.pack("<f", value))[0]
        bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
        return struct.unpack("<f", struct.pack("<I", bits))[0]
    return value


def whole_along_d(h: torch.Tensor) -> torch.Tensor:
    """A normed hidden state that feeds products (a block's input, the
    final norm's output), under a mesh whole along d on every rank, its
    batch split as the rules split it; where the batch leaves the FSDP
    axes idle (a batch of 1), d split over them instead, as the products'
    weights split their contraction (``("batch", None, "fsdp")``). Not a
    `constrain` (the reference has none here): the residual stream is
    split along d on the tensor axis (``residual``), so each product of it
    would give a partial sum, which `DTensor`, weighing communication
    alone, resolves by a reduce-scatter onto the sequence or the batch
    over the tensor axis, gathered back before the next product: the MLP's
    hidden state moved at d_ff width (smollm-2l prefill_32k on 16 x 16:
    (2, 2048, 1536) bf16 reduce-scatters and (32, 2048, 1536) all-gathers,
    2.01e8 B each), where the reference gathers the d-wide input once.
    Where a rank holds fewer rows than that axis has ranks (the 2 x 16 x
    16 mesh's train cells: 8 over 16) the split is uneven, and the
    backward pass's flatten of it is a strided shard that `DTensor` plans
    for minutes a product. Gathered first, every product is split by its
    output columns instead. A batch of 1 gathers nothing: each rank of the
    idle axes takes the slice of d its weight rows contract, by one
    all-to-all (`sharding.rules.relaid`; mamba2-2l long_500k on 16 x 16:
    (1, 1, 2048) gathers of 4 KB, 256 B now, as the reference's
    partitioner permutes it), and the products' partial sums are reduced
    over those axes, as with d whole."""
    rules = current_rules()
    if not (isinstance(h, DTensor) and rules is not None and rules.mesh is not None):
        return h
    target = rules.sharding(("batch", None, "fsdp"), tuple(h.shape)).placements
    if sum(isinstance(p, Shard) and p.dim == 2 for p in target) > 1:
        # Over two idle axes (pod and data) no one all-to-all moves the
        # split, and `DTensor` would gather d whole first: whole it is.
        target = rules.sharding(("batch", None, None), tuple(h.shape)).placements
    return relaid(h, target)


def block_fwd(
    p: dict,
    cfg: ModelConfig,
    bd: BlockDef,
    x: torch.Tensor,
    *,
    start: int,
    cache: dict | None = None,
    update_cache: bool = False,
    enc_hidden: torch.Tensor | None = None,
    causal: bool = True,
    q_chunk: int = 512,
) -> tuple[torch.Tensor, dict, torch.Tensor | None]:
    """Returns (x, new_cache, aux): aux is the MoE FFN's load-balancing loss,
    None for a block with no MoE FFN (where the reference returns a zero).
    A cross-attention block attends to `enc_hidden` when given (training),
    else to its read-only `"cross"` cache, which it passes on unchanged."""
    _check_block(cfg, bd)
    new_cache: dict = {}
    rm = rounded_to(cfg.residual_multiplier, x.dtype)

    h = whole_along_d(L.apply_norm(p["norm1"], cfg, x))
    # Cohere's parallel block with a dense FFN: both branches' inner work,
    # then both last products (`products_saved_first`).
    parallel = cfg.parallel_block and bd.mixer == "attn" and bd.ffn == "dense"
    # The parallel block's last products mix both branches: no layer span.
    with spans.layer("layer.mixer", enabled=not parallel) as mixer:
        hm = mixer.input(h)
        if bd.mixer == "attn":
            ctx, wo, kv = L.attention_context(
                p["attn"], cfg, hm,
                start=start,
                causal=causal,
                cache=None if cache is None else cache.get("attn"),
                update_cache=update_cache,
                q_chunk=q_chunk,
            )
            if kv is not None:
                new_cache["attn"] = kv
            if parallel:
                hid, w_down = L.mlp_hidden(p["ffn"], cfg, h)
                y_attn, y_ffn = products_saved_first(ctx, wo, hid, w_down)
                attn_out = L.attention_output(p["attn"], y_attn)
            else:
                attn_out = L.attention_output(p["attn"], ctx @ wo)
        else:
            attn_out, mc = S.mamba_block(
                p["mamba"], cfg, hm,
                cache=None if cache is None else cache.get("mamba"),
                update_cache=update_cache,
            )
            if mc is not None:
                new_cache["mamba"] = mc
        attn_out = mixer.output(attn_out)

    aux = None
    if cfg.parallel_block and bd.ffn is not None:
        # Cohere: attn and FFN both read the same normed input.
        ffn_out, aux = ((L.mlp_output(p["ffn"], y_ffn), None) if parallel
                        else _ffn(p["ffn"], cfg, bd, h))
        x = x + rm * (attn_out + ffn_out)
        return x, new_cache, aux

    x = x + rm * attn_out

    if bd.cross_attn:
        hc = whole_along_d(L.apply_norm(p["norm_cross"], cfg, x))
        if enc_hidden is not None:
            cross_out, _ = L.attention(p["cross"], cfg, hc, start=start, causal=False,
                                       kv_source=enc_hidden, q_chunk=q_chunk)
        else:
            cross_out, _ = L.attention(p["cross"], cfg, hc, start=start, causal=False,
                                       cache=cache.get("cross") if cache else None,
                                       update_cache=False, q_chunk=q_chunk)
        x = x + rm * cross_out
        if cache is not None and "cross" in cache:
            new_cache["cross"] = cache["cross"]

    if bd.ffn is not None:
        h2 = whole_along_d(L.apply_norm(p["norm2"], cfg, x))
        with spans.layer("layer.mlp") as mlp:
            ffn_out, aux = _ffn(p["ffn"], cfg, bd, mlp.input(h2))
            ffn_out = mlp.output(ffn_out)
        x = x + rm * ffn_out
    return x, new_cache, aux


class _SavedFirst(torch.autograd.Function):
    """The identity on its tensors, which it saves for `_ProductsOfSaved`."""

    @staticmethod
    def forward(ctx, *tensors):
        ctx.save_for_backward(*tensors)
        return tuple(t.view_as(t) for t in tensors)

    @staticmethod
    def backward(ctx, *grads):
        return grads


class _ProductsOfSaved(torch.autograd.Function):
    """``(a @ b, c @ d)`` of `_SavedFirst`'s outputs, saving nothing: the
    backward pass reads its operands from that node's saved tensors."""

    @staticmethod
    def forward(ctx, node, a, b, c, d):
        ctx.node = node
        return a @ b, c @ d

    @staticmethod
    def backward(ctx, g_ab, g_cd):
        a, b, c, d = ctx.node.saved_tensors
        return (None, *_matmul_grads(a, b, g_ab), *_matmul_grads(c, d, g_cd))


def _matmul_grads(x: torch.Tensor, w: torch.Tensor,
                  g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The gradients of ``x @ w`` (x (..., K), w (K, N)) given the output's
    `g`, as autograd's matmul computes them."""
    return g @ w.T, x.flatten(0, -2).T @ g.flatten(0, -2)


def products_saved_first(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                         d: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(a @ b, c @ d)``, where under autograd all four operands are saved
    before either product runs. torch.utils.checkpoint stops a period's
    recompute once every tensor the period saved is back: with each
    product saving its own operands, the first of two last products would
    run again in the backward pass (command-r-plus-2l train_4k: the
    attention output projection, 1.01386x the reference's FLOPs, whose
    remat drops it); saved first, neither does."""
    if not ops.needs_grad(a, b, c, d):
        return a @ b, c @ d
    saved = _SavedFirst.apply(a, b, c, d)
    return _ProductsOfSaved.apply(saved[0].grad_fn, *saved)


def _ffn(p: dict, cfg: ModelConfig, bd: BlockDef,
         h: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor | None]:
    if bd.ffn == "dense":
        return L.mlp(p, cfg, h), None
    return M.moe(p, cfg, h)


# --------------------------------------------------------------------------- #
# Stack (loop over periods)
# --------------------------------------------------------------------------- #
def stack_spec(cfg: ModelConfig, pattern: tuple[BlockDef, ...] | None = None,
               periods: int | None = None) -> dict:
    pattern = pattern if pattern is not None else cfg.pattern
    periods = periods if periods is not None else cfg.periods
    period = {f"block{i}": block_spec(cfg, bd) for i, bd in enumerate(pattern)}
    return stacked(periods, period)


def _tensor_fields(cache) -> dict:
    return {f.name: getattr(cache, f.name) for f in dataclasses.fields(cache)
            if isinstance(getattr(cache, f.name), torch.Tensor)}


def _host_fields(cache) -> dict:
    return {f.name: getattr(cache, f.name) for f in dataclasses.fields(cache)
            if not isinstance(getattr(cache, f.name), torch.Tensor)}


def make_stack_cache(cfg: ModelConfig, batch: int, max_len: int, *, device,
                     cross_len: int = 0, length: int = 0) -> dict:
    """One cache per block of the pattern (a `KVCache` or a `MambaCache`, and
    a cross-attention block's `"cross"` `KVCache`), its buffers stacked over
    periods: k/v are (periods, B, max_len, H_kv, D_h), the Mamba ssm state
    (periods, B, H, P, N). Under a mesh, zeros laid out by
    `stack_cache_axes`, each rank allocating only its shard (``meta``
    stand-ins on the ``meta`` device)."""
    rules = current_rules()
    if rules is None or rules.mesh is None:
        return _stack_cache(cfg, batch, max_len, device=device, cross_len=cross_len,
                            length=length)
    shapes = _stack_cache(cfg, batch, max_len, device="meta", cross_len=cross_len,
                          length=length)
    return abstract_like(shapes, stack_cache_axes(cfg), rules, device=device)


def _stack_cache(cfg: ModelConfig, batch: int, max_len: int, *, device,
                 cross_len: int, length: int) -> dict:
    out = {}
    for i, bd in enumerate(cfg.pattern):
        one = make_block_cache(cfg, bd, batch, max_len, device=device, cross_len=cross_len,
                               length=length)
        out[f"block{i}"] = {
            name: dataclasses.replace(c, **{
                k: t.unsqueeze(0).repeat(cfg.periods, *([1] * t.ndim))
                for k, t in _tensor_fields(c).items()})
            for name, c in one.items()
        }
    return out


def stack_cache_axes(cfg: ModelConfig) -> dict:
    """Logical-axes tree (Ax leaves) structurally matching make_stack_cache,
    a leading periods axis on every buffer; used to attach shardings to
    abstract decode-state inputs."""
    per = {f"block{i}": block_cache_spec(cfg, bd) for i, bd in enumerate(cfg.pattern)}

    def add_periods(c):
        return dataclasses.replace(c, **{
            f.name: Ax((None, *getattr(c, f.name).axes)) for f in dataclasses.fields(c)
            if isinstance(getattr(c, f.name), Ax)})

    return {block: {name: add_periods(c) for name, c in caches.items()}
            for block, caches in per.items()}


def _num_periods(tree: dict) -> int | None:
    """The leading axis of the stacked tree's first leaf (None if it has
    none); walks no further than that leaf."""
    for v in tree.values():
        n = _num_periods(v) if isinstance(v, dict) else v.shape[0]
        if n is not None:
            return n
    return None


def _unstack(tree: dict, n: int) -> list[dict]:
    """The `n` periods of a stacked parameter tree, as views. One `unbind`
    per leaf: under autograd a single backward op then gathers every
    period's gradient, where indexing each period would build a gradient
    of the whole stacked leaf per period and sum them."""
    cols = {k: _unstack(v, n) if isinstance(v, dict) else v.unbind(0) for k, v in tree.items()}
    return [{k: col[i] for k, col in cols.items()} for i in range(n)]


def stack_fwd(
    p_stack: dict,
    cfg: ModelConfig,
    x: torch.Tensor,
    *,
    start: int,
    caches: dict | None = None,
    update_cache: bool = False,
    enc_hidden: torch.Tensor | None = None,
    causal: bool = True,
    q_chunk: int = 512,
    remat: bool = False,
    pattern: tuple[BlockDef, ...] | None = None,
) -> tuple[torch.Tensor, dict | None, torch.Tensor]:
    """Run the periods in order over the residual stream. Each period's
    cache is a view into the stacked buffers, so the blocks' in-place
    updates land there directly; host-side fields (the KV length) are
    taken from the last period's cache. Returns (x, new_caches, aux): aux
    is the sum of the MoE blocks' aux losses in block order (a 0-d fp32
    zero with no MoE block). The period count is the parameters' leading
    axis, as in the reference: the encoder's stack has its own.

    `remat` (training, no caches) recomputes each period in the backward
    pass instead of keeping its activations, as `jax.checkpoint(period_fn)`
    does: the recompute reads the same period views of parameters that do
    not change before the backward pass."""
    if remat and caches is not None:
        raise ValueError("remat recomputes periods in training, which updates no cache")
    pattern = pattern if pattern is not None else cfg.pattern
    host: dict = {}
    periods = _unstack(p_stack, _num_periods(p_stack))

    def period(x: torch.Tensor, aux: torch.Tensor,
               idx: int) -> tuple[torch.Tensor, torch.Tensor]:
        pp = periods[idx]
        for i, bd in enumerate(pattern):
            name = f"block{i}"
            pc = None if caches is None else {
                key: dataclasses.replace(c, **{k: t[idx] for k, t in _tensor_fields(c).items()})
                for key, c in caches[name].items()
            }
            x, nc, block_aux = block_fwd(
                pp[name], cfg, bd, x,
                start=start,
                cache=pc,
                update_cache=update_cache,
                enc_hidden=enc_hidden,
                causal=causal,
                q_chunk=q_chunk,
            )
            if block_aux is not None:
                aux = aux + block_aux
            host[name] = {key: _host_fields(c) for key, c in nc.items()}
        return x, aux

    aux = x.new_zeros((), dtype=torch.float32)
    for idx in range(len(periods)):
        x, aux = (checkpoint(under_current_rules(period), x, aux, idx, use_reentrant=False)
                  if remat
                  else period(x, aux, idx))
    if caches is None:
        return x, None, aux
    return x, {
        name: {key: dataclasses.replace(c, **host[name][key]) for key, c in blk.items()}
        for name, blk in caches.items()
    }, aux


# --------------------------------------------------------------------------- #
# LM spec + forward + loss
# --------------------------------------------------------------------------- #
def lm_spec(cfg: ModelConfig) -> dict:
    return {
        "embed": L.embedding_spec(cfg),
        "layers": stack_spec(cfg),
        "final_norm": L.norm_spec(cfg),
    }


def lm_inputs_to_hidden(p: dict, cfg: ModelConfig, inputs: torch.Tensor) -> torch.Tensor:
    """Token ids (B,S) -> embeddings, or pass through (B,S,D) embeddings
    (VLM/audio stub frontends)."""
    if inputs.ndim == 3:
        return inputs.to(L.COMPUTE_DTYPE)
    return L.embed_tokens(p["embed"], cfg, inputs)


def lm_hidden(
    p: dict, cfg: ModelConfig, inputs: torch.Tensor, *,
    start: int = 0, caches: dict | None = None, update_cache: bool = False,
    q_chunk: int = 512, remat: bool = False, last: bool = False,
) -> tuple[torch.Tensor, dict | None, torch.Tensor]:
    """Final-normed hidden states, the updated caches and the stack's MoE aux
    loss. `start` is the global position of inputs[:, 0]. With `last`, the
    last position's alone (B, 1, D): a prefill's logits read no other, and
    under a mesh only that position is gathered whole along d."""
    x = lm_inputs_to_hidden(p, cfg, inputs)
    x = constrain(x, "batch", None, "residual")
    x, new_caches, aux = stack_fwd(
        p["layers"], cfg, x,
        start=start,
        caches=caches,
        update_cache=update_cache,
        q_chunk=q_chunk,
        remat=remat,
    )
    if last:
        x = x[:, -1:]
    return whole_along_d(L.apply_norm(p["final_norm"], cfg, x)), new_caches, aux


def logits_from_hidden(p: dict, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    """fp32 logits of bf16 operands (the JAX package's preferred_element_type
    fp32), padded vocab rows masked to NEG_INF. Under autograd on a mesh
    the bf16 table is gathered over the batch's mesh axes at its use (the
    FSDP weight, as the reference's partitioner gathers it) and upcast
    after, so each rank computes its own rows' logits for its own
    vocabulary columns; `DTensor` would otherwise split the product's
    contraction along d and all-reduce the fp32 logits (command-r-plus:
    (256, 512, 256000) a loss chunk)."""
    table = L.output_table(p["embed"]).to(h.dtype).T
    if ops.needs_grad(h, table):
        table = L._gathered_over_batch(table, h)
    logits = (h.float() @ table.float()) * cfg.logit_scale
    v_pad = cfg.padded_vocab()
    if v_pad != cfg.vocab_size:
        invalid = L._positions_along(logits, 2) >= cfg.vocab_size
        logits = logits.masked_fill(invalid, NEG_INF)
    return logits


def chunked_xent(
    p: dict, cfg: ModelConfig, h: torch.Tensor, labels: torch.Tensor,
    *, chunk: int = 512,
) -> torch.Tensor:
    """Mean next-token cross-entropy without materializing (B, S, V) at
    once: fp32 logits one (B, chunk) slice at a time. labels < 0 are
    masked out. Each label's logit is the sum over the vocabulary of the
    logits where the vocabulary index equals the label: one non-zero term,
    so the reference's gathered value exactly."""
    s = h.shape[1]
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"sequence length {s} is not a multiple of the loss chunk {chunk}")
    loss_sum = torch.zeros((), dtype=torch.float32, device=h.device)
    count = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(0, s, chunk):
        l_c = labels[:, i:i + chunk]
        logits = logits_from_hidden(p, cfg, h[:, i:i + chunk])     # (B, C, V) fp32
        lse = L._logsumexp(logits)
        hit = L._positions_along(logits, 2) == l_c.clamp_min(0)[..., None]
        picked = torch.where(hit, logits, 0.0).sum(dim=-1)
        valid = (l_c >= 0).float()
        loss_sum = loss_sum + ((lse - picked) * valid).sum()
        count = count + valid.sum()
    return loss_sum / count.clamp_min(1.0)


def lm_loss(
    p: dict, cfg: ModelConfig, inputs: torch.Tensor, labels: torch.Tensor,
    *, q_chunk: int = 512, loss_chunk: int = 512, remat: bool = True,
) -> torch.Tensor:
    """Mean next-token cross-entropy of a batch (a 0-d fp32 tensor), plus,
    for MoE configs, `moe_aux_loss_weight` times the stack's Switch aux loss
    over the number of layers."""
    h, _, aux = lm_hidden(p, cfg, inputs, q_chunk=q_chunk, remat=remat)
    with spans.layer("layer.loss_head") as head:
        loss = head.output(chunked_xent(p, cfg, head.input(h), labels, chunk=loss_chunk))
    if cfg.is_moe:
        loss = loss + cfg.moe_aux_loss_weight * aux / max(cfg.num_layers, 1)
    return loss


# --------------------------------------------------------------------------- #
# Serving steps
# --------------------------------------------------------------------------- #
def lm_prefill(
    p: dict, cfg: ModelConfig, inputs: torch.Tensor, *, max_len: int | None = None,
    q_chunk: int = 512,
) -> tuple[torch.Tensor, dict]:
    """Process the prompt; returns (last-position logits (B,V), caches)."""
    b, s = inputs.shape[0], inputs.shape[1]
    max_len = max_len if max_len is not None else s
    caches = make_stack_cache(cfg, b, max_len, device=inputs.device)
    h, caches, _ = lm_hidden(p, cfg, inputs, caches=caches, update_cache=True,
                             q_chunk=q_chunk, last=True)
    return logits_from_hidden(p, cfg, h)[:, 0], caches


def lm_decode_step(
    p: dict, cfg: ModelConfig, inputs: torch.Tensor, caches: dict, position: int,
) -> tuple[torch.Tensor, dict]:
    """One token step. inputs: (B, 1) ids or (B, 1, D) embeds; `position` is
    the global position of the new token. Returns (logits, caches)."""
    h, new_caches, _ = lm_hidden(p, cfg, inputs, start=position, caches=caches,
                                 update_cache=True, q_chunk=1)
    return logits_from_hidden(p, cfg, h)[:, 0], new_caches
