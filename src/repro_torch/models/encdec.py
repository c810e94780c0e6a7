"""Encoder-decoder backbone (Whisper-style).

The port of the JAX package's ``models/encdec.py``. The conv frontend is a
stub: encoder inputs arrive as precomputed frame embeddings (B, S_enc, D).
Both stacks add sinusoidal positions (the reference replaces Whisper's
learned decoder table with them). The encoder is a stack of `ENC_PATTERN`
blocks over `cfg.enc_layers` periods with non-causal self-attention, which
goes through the flash kernel's non-causal path when no gradient is
needed. The decoder's blocks add a cross-attention to the encoder states:
in training to `enc_hidden` itself, at prefill and decode to read-only
per-period caches of its k/v (`build_cross_caches`), which the plain
attention path reads. Under a mesh each stack's input is laid out where
the reference's `constrain` puts it, and the cross caches on ``kv_seq``.
"""

from __future__ import annotations

import functools

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.configs.base import BlockDef, ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import lm as LM
from repro_torch.models.spec import placed_tensor
from repro_torch.sharding.rules import NamedSharding, constrain, replicate_like, write_slice

ENC_PATTERN = (BlockDef("attn", "dense"),)


def encdec_spec(cfg: ModelConfig) -> dict:
    return {
        "embed": L.embedding_spec(cfg),
        "enc_layers": LM.stack_spec(cfg, ENC_PATTERN, cfg.enc_layers),
        "enc_final_norm": L.norm_spec(cfg),
        "layers": LM.stack_spec(cfg),           # decoder (cross_attn pattern)
        "final_norm": L.norm_spec(cfg),
    }


@functools.lru_cache(maxsize=8)
def _position_table(n: int, d_model: int, dtype: torch.dtype,
                    device: torch.device) -> torch.Tensor:
    """Positions 0 .. n - 1 rounded to `dtype` on `device`. Built on the host
    and copied once per key, so that a decode step neither computes sin/cos
    on the host nor waits on a copy from pageable memory."""
    return L.sinusoidal_positions(n, d_model).to(dtype).to(device)


def _add_sinusoid(x: torch.Tensor, offset: int = 0) -> torch.Tensor:
    """x plus the positions offset .. offset + S - 1, the table rounded to
    x's dtype before the add, as in the reference."""
    s = x.shape[1]
    if x.device.type == "meta":
        # A stand-in (the dry-run's trace): nothing to keep, and a kept
        # table would belong to the trace that made it.
        table = L.sinusoidal_positions(s, x.shape[2], offset).to(x.dtype).to("meta")
    else:
        n = max(4096, 1 << (offset + s - 1).bit_length())
        table = _position_table(n, x.shape[2], x.dtype, x.device)[offset:offset + s]
    return x + replicate_like(table, x)


def encode(p: dict, cfg: ModelConfig, enc_inputs: torch.Tensor, *,
           q_chunk: int = 512, remat: bool = False) -> torch.Tensor:
    """enc_inputs: (B, S_enc, D) stub frame embeddings -> encoder states."""
    x = constrain(_add_sinusoid(enc_inputs.to(L.COMPUTE_DTYPE)), "batch", None, "residual")
    x, _, _ = LM.stack_fwd(p["enc_layers"], cfg, x, start=0, causal=False,
                           q_chunk=q_chunk, remat=remat, pattern=ENC_PATTERN)
    return LM.whole_along_d(L.apply_norm(p["enc_final_norm"], cfg, x))


def decode_train(p: dict, cfg: ModelConfig, enc_hidden: torch.Tensor,
                 dec_ids: torch.Tensor, *, q_chunk: int = 512,
                 remat: bool = False) -> torch.Tensor:
    """Teacher-forced decoder over `dec_ids`, cross-attending to
    `enc_hidden`: the final-normed hidden states."""
    x = constrain(_add_sinusoid(L.embed_tokens(p["embed"], cfg, dec_ids)),
                  "batch", None, "residual")
    x, _, _ = LM.stack_fwd(p["layers"], cfg, x, start=0, enc_hidden=enc_hidden,
                           causal=True, q_chunk=q_chunk, remat=remat)
    return LM.whole_along_d(L.apply_norm(p["final_norm"], cfg, x))


def encdec_loss(p: dict, cfg: ModelConfig, enc_inputs: torch.Tensor,
                dec_ids: torch.Tensor, labels: torch.Tensor, *, q_chunk: int = 512,
                loss_chunk: int = 512, remat: bool = True) -> torch.Tensor:
    """Mean next-token cross-entropy of the decoder over `labels` (< 0
    masked), differentiable in `p`."""
    enc_hidden = encode(p, cfg, enc_inputs, q_chunk=q_chunk, remat=remat)
    h = decode_train(p, cfg, enc_hidden, dec_ids, q_chunk=q_chunk, remat=remat)
    return LM.chunked_xent(p, cfg, h, labels, chunk=loss_chunk)


def build_cross_caches(p: dict, cfg: ModelConfig, enc_hidden: torch.Tensor) -> L.KVCache:
    """Per-period read-only cross-attention KV of the encoder states,
    stacked on a leading periods axis as `make_stack_cache` stacks caches:
    k/v (periods, B, S_enc, H_kv, D_h), `length` S_enc. Written period by
    period into one buffer each, so the stack never exists twice; under a
    mesh a period's k/v keep their ``kv_seq`` layout in the stack."""
    cross = p["layers"]["block0"]["cross"]
    periods = cross["wk"].shape[0]
    # Period views by `unbind`, which a quantized leaf answers too.
    cols = {name: w.unbind(0) for name, w in cross.items()}
    k = v = None
    for i in range(periods):
        kv = L.compute_kv({name: col[i] for name, col in cols.items()}, cfg, enc_hidden)
        if k is None:
            k, v = (placed_tensor((periods, *t.shape), t.dtype, _stacked_layout(t),
                                  device=t.device) for t in (kv.k, kv.v))
        write_slice(k, 0, i, kv.k.unsqueeze(0))
        write_slice(v, 0, i, kv.v.unsqueeze(0))
    return L.KVCache(k=k, v=v, length=enc_hidden.shape[1])


def _stacked_layout(t: torch.Tensor) -> NamedSharding | None:
    """The layout of `t` (a `DTensor`) with a leading periods axis added."""
    if not isinstance(t, DTensor):
        return None
    return NamedSharding(t.device_mesh, tuple(
        Shard(p.dim % t.ndim + 1) if isinstance(p, Shard) else Replicate()
        for p in t.placements))


def _merge_cross(caches: dict, cross: L.KVCache) -> dict:
    out = dict(caches)
    blk = dict(out["block0"])
    blk["cross"] = cross
    out["block0"] = blk
    return out


def encdec_prefill(p: dict, cfg: ModelConfig, enc_inputs: torch.Tensor,
                   dec_prompt: torch.Tensor, *, max_len: int | None = None,
                   q_chunk: int = 512) -> tuple[torch.Tensor, dict]:
    """Encoder pass + decoder prompt prefill. Returns (last-position logits
    (B, V), caches with `max_len` self positions and the cross caches)."""
    b, s_dec = dec_prompt.shape
    max_len = max_len if max_len is not None else s_dec
    enc_hidden = encode(p, cfg, enc_inputs, q_chunk=q_chunk)
    caches = _merge_cross(LM.make_stack_cache(cfg, b, max_len, device=dec_prompt.device),
                          build_cross_caches(p, cfg, enc_hidden))
    x = constrain(_add_sinusoid(L.embed_tokens(p["embed"], cfg, dec_prompt)),
                  "batch", None, "residual")
    x, caches, _ = LM.stack_fwd(p["layers"], cfg, x, start=0, caches=caches,
                                update_cache=True, causal=True, q_chunk=q_chunk)
    h = L.apply_norm(p["final_norm"], cfg, x)
    return LM.logits_from_hidden(p, cfg, h[:, -1:, :])[:, 0], caches


def encdec_decode_step(p: dict, cfg: ModelConfig, ids: torch.Tensor, caches: dict,
                       position: int) -> tuple[torch.Tensor, dict]:
    """One decoder token (B, 1) at `position` against the self and cross
    caches; the sinusoid is taken at that position. Returns (logits,
    caches)."""
    x = constrain(_add_sinusoid(L.embed_tokens(p["embed"], cfg, ids), position),
                  "batch", None, "residual")
    x, caches, _ = LM.stack_fwd(p["layers"], cfg, x, start=position, caches=caches,
                                update_cache=True, causal=True, q_chunk=1)
    h = L.apply_norm(p["final_norm"], cfg, x)
    return LM.logits_from_hidden(p, cfg, h)[:, 0], caches


def make_decode_caches(cfg: ModelConfig, batch: int, self_len: int, cross_len: int, *,
                       device, length: int = 0) -> dict:
    return LM.make_stack_cache(cfg, batch, self_len, device=device, cross_len=cross_len,
                               length=length)
