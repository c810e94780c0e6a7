"""Decoder-only LM backbone for the ``(attn, dense)`` and ``(mamba, -)``
block patterns.

The port of the JAX package's ``models/lm.py``. The layer stack is
`cfg.periods` repetitions of the config's block pattern with parameters
stacked on a leading periods axis; `stack_fwd` walks that axis in a Python
loop. Decode caches (attention KV caches and Mamba conv/SSM states) are
stacked the same way and updated in place. The MoE, cross-attention and
encoder-decoder branches are not ported yet and raise.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import BlockDef, ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import ssd as S
from repro_torch.models.spec import stacked

NEG_INF = -1e30


def _check_block(cfg: ModelConfig, bd: BlockDef) -> None:
    if bd.mixer not in ("attn", "mamba") or bd.ffn not in ("dense", None) \
            or bd.cross_attn or cfg.is_encdec:
        raise NotImplementedError(
            f"{cfg.name}: block {bd} is not ported yet; the port covers attention "
            f"and Mamba mixers with a dense FFN or none")


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
    if bd.ffn is not None and not cfg.parallel_block:
        spec["norm2"] = L.norm_spec(cfg)
    if bd.ffn == "dense":
        spec["ffn"] = L.mlp_spec(cfg)
    return spec


def make_block_cache(cfg: ModelConfig, bd: BlockDef, batch: int, max_len: int,
                     *, device, length: int = 0) -> dict:
    _check_block(cfg, bd)
    if bd.mixer == "attn":
        return {"attn": L.make_cache(cfg, batch, max_len, device=device, length=length)}
    return {"mamba": S.make_mamba_cache(cfg, batch, device=device)}


def block_fwd(
    p: dict,
    cfg: ModelConfig,
    bd: BlockDef,
    x: torch.Tensor,
    *,
    start: int,
    cache: dict | None = None,
    update_cache: bool = False,
    q_chunk: int = 512,
) -> tuple[torch.Tensor, dict]:
    """Returns (x, new_cache)."""
    _check_block(cfg, bd)
    new_cache: dict = {}
    rm = torch.tensor(cfg.residual_multiplier, dtype=x.dtype)

    h = L.apply_norm(p["norm1"], cfg, x)
    if bd.mixer == "attn":
        attn_out, kv = L.attention(
            p["attn"], cfg, h,
            start=start,
            cache=None if cache is None else cache.get("attn"),
            update_cache=update_cache,
            q_chunk=q_chunk,
        )
        if kv is not None:
            new_cache["attn"] = kv
    else:
        attn_out, mc = S.mamba_block(
            p["mamba"], cfg, h,
            cache=None if cache is None else cache.get("mamba"),
            update_cache=update_cache,
        )
        if mc is not None:
            new_cache["mamba"] = mc

    if cfg.parallel_block and bd.ffn is not None:
        # Cohere: attn and FFN both read the same normed input.
        x = x + rm * (attn_out + L.mlp(p["ffn"], cfg, h))
        return x, new_cache

    x = x + rm * attn_out
    if bd.ffn is not None:
        h2 = L.apply_norm(p["norm2"], cfg, x)
        x = x + rm * L.mlp(p["ffn"], cfg, h2)
    return x, new_cache


# --------------------------------------------------------------------------- #
# Stack (loop over periods)
# --------------------------------------------------------------------------- #
def stack_spec(cfg: ModelConfig) -> dict:
    period = {f"block{i}": block_spec(cfg, bd) for i, bd in enumerate(cfg.pattern)}
    return stacked(cfg.periods, period)


def _tensor_fields(cache) -> dict:
    return {f.name: getattr(cache, f.name) for f in dataclasses.fields(cache)
            if isinstance(getattr(cache, f.name), torch.Tensor)}


def _host_fields(cache) -> dict:
    return {f.name: getattr(cache, f.name) for f in dataclasses.fields(cache)
            if not isinstance(getattr(cache, f.name), torch.Tensor)}


def make_stack_cache(cfg: ModelConfig, batch: int, max_len: int, *, device,
                     length: int = 0) -> dict:
    """One cache per block of the pattern (a `KVCache` or a `MambaCache`),
    its buffers stacked over periods: k/v are (periods, B, max_len, H_kv,
    D_h), the Mamba ssm state (periods, B, H, P, N)."""
    out = {}
    for i, bd in enumerate(cfg.pattern):
        one = make_block_cache(cfg, bd, batch, max_len, device=device, length=length)
        out[f"block{i}"] = {
            name: dataclasses.replace(c, **{
                k: t.unsqueeze(0).repeat(cfg.periods, *([1] * t.ndim))
                for k, t in _tensor_fields(c).items()})
            for name, c in one.items()
        }
    return out


def _index(tree: dict, i: int) -> dict:
    """Period `i` of a stacked parameter tree, as views."""
    return {k: _index(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


def stack_fwd(
    p_stack: dict,
    cfg: ModelConfig,
    x: torch.Tensor,
    *,
    start: int,
    caches: dict | None = None,
    update_cache: bool = False,
    q_chunk: int = 512,
) -> tuple[torch.Tensor, dict | None]:
    """Run the periods in order over the residual stream. Each period's
    cache is a view into the stacked buffers, so the blocks' in-place
    updates land there directly; host-side fields (the KV length) are
    taken from the last period's cache. Returns (x, new_caches)."""
    host: dict = {}
    for idx in range(cfg.periods):
        pp = _index(p_stack, idx)
        for i, bd in enumerate(cfg.pattern):
            name = f"block{i}"
            pc = None if caches is None else {
                key: dataclasses.replace(c, **{k: t[idx] for k, t in _tensor_fields(c).items()})
                for key, c in caches[name].items()
            }
            x, nc = block_fwd(
                pp[name], cfg, bd, x,
                start=start,
                cache=pc,
                update_cache=update_cache,
                q_chunk=q_chunk,
            )
            host[name] = {key: _host_fields(c) for key, c in nc.items()}
    if caches is None:
        return x, None
    return x, {
        name: {key: dataclasses.replace(c, **host[name][key]) for key, c in blk.items()}
        for name, blk in caches.items()
    }


# --------------------------------------------------------------------------- #
# LM spec + forward
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
    q_chunk: int = 512,
) -> tuple[torch.Tensor, dict | None]:
    """`start` is the global position of inputs[:, 0]."""
    x = lm_inputs_to_hidden(p, cfg, inputs)
    x, new_caches = stack_fwd(
        p["layers"], cfg, x,
        start=start,
        caches=caches,
        update_cache=update_cache,
        q_chunk=q_chunk,
    )
    return L.apply_norm(p["final_norm"], cfg, x), new_caches


def logits_from_hidden(p: dict, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    """fp32 logits of bf16 operands (the JAX package's preferred_element_type
    fp32), padded vocab rows masked to NEG_INF."""
    table = L.output_table(p["embed"]).to(h.dtype)
    logits = (h.float() @ table.float().T) * cfg.logit_scale
    v_pad = cfg.padded_vocab()
    if v_pad != cfg.vocab_size:
        logits[..., cfg.vocab_size:] = NEG_INF
    return logits


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
    h, caches = lm_hidden(p, cfg, inputs, caches=caches, update_cache=True,
                          q_chunk=q_chunk)
    return logits_from_hidden(p, cfg, h[:, -1:, :])[:, 0], caches


def lm_decode_step(
    p: dict, cfg: ModelConfig, inputs: torch.Tensor, caches: dict, position: int,
) -> tuple[torch.Tensor, dict]:
    """One token step. inputs: (B, 1) ids or (B, 1, D) embeds; `position` is
    the global position of the new token. Returns (logits, caches)."""
    h, new_caches = lm_hidden(p, cfg, inputs, start=position, caches=caches,
                              update_cache=True, q_chunk=1)
    return logits_from_hidden(p, cfg, h)[:, 0], new_caches
