"""Shared transformer layers: norms, RoPE, sinusoidal positions, GQA and
cross attention, gated MLP.

The port of the JAX package's ``models/layers.py``, dense parts, with its
layouts: activations are (B, S, H, D_h), ``wq`` is (d, Hq, D_h) and ``wo``
is (Hq, D_h, d). Matmuls run in bf16 on fp32 parameters cast at use, with
fp32 norm, softmax and score accumulation. Self-attention of a query block
at position 0 against an empty or absent cache (causal prefill, or the
encoder's non-causal pass) with no input that needs a gradient goes through
`ops.flash_attention` (the flash kernel for CUDA tensors, forward only);
every other case, training and cross-attention included, through the plain
`_attn_core`, differentiable by autograd. The Mamba mixer is in
``models/ssd.py``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.spec import Ax, ParamSpec

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


def apply_norm(p: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    if cfg.norm_type == "rmsnorm":
        var = xf.square().mean(dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + cfg.norm_eps)
    else:  # layernorm
        mean = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, unbiased=False, keepdim=True)
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
    cos = torch.cos(angles)[None, :, None, :]
    sin = torch.sin(angles)[None, :, None, :]
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


def embed_tokens(p: dict, cfg: ModelConfig, ids: torch.Tensor) -> torch.Tensor:
    x = p["table"][ids].to(COMPUTE_DTYPE)
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


def _attn_core(
    q: torch.Tensor,        # (B, S_q, H_q, D_h)
    k: torch.Tensor,        # (B, S_k, H_kv, D_h)
    v: torch.Tensor,
    *,
    causal: bool,
    q_offset: int,          # global position of q[:, 0]
    kv_valid_len: int | None = None,   # mask kv positions >= this
    q_chunk: int = 512,
) -> torch.Tensor:
    """Plain attention in query chunks, masking by absolute position and by
    the valid cache length; the JAX package's kv_seq path. Under autograd
    each chunk is recomputed in the backward pass (as `jax.checkpoint` per
    chunk does), so no chunk's fp32 probabilities are kept."""
    b, sq, hq, dh = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = dh ** -0.5
    kv_pos = torch.arange(sk, device=q.device)
    kf = k.float()

    def chunk_attn(q_c: torch.Tensor, offset: int) -> torch.Tensor:
        c = q_c.shape[1]
        mask = None
        if causal:
            q_pos = offset + torch.arange(c, device=q.device)
            mask = kv_pos[None, :] <= q_pos[:, None]          # (C, S_k)
        if kv_valid_len is not None:
            valid = (kv_pos < kv_valid_len)[None, :]
            mask = valid if mask is None else (mask & valid)
        qg = q_c.reshape(b, c, hkv, g, dh).float()
        s = torch.einsum("bqkgd,bskd->bkgqs", qg, kf) * scale
        if mask is not None:
            s = s.masked_fill(~mask, NEG_INF)
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bkgqs,bskd->bqkgd", p.to(v.dtype), v)
        return o.reshape(b, c, hq, dh).to(q.dtype)

    if sq <= q_chunk:
        return chunk_attn(q, q_offset)
    remat = ops.needs_grad(q, k, v)
    chunks = []
    for i in range(0, sq, q_chunk):
        args = (q[:, i:i + q_chunk], q_offset + i)
        chunks.append(checkpoint(chunk_attn, *args, use_reentrant=False) if remat
                      else chunk_attn(*args))
    return torch.cat(chunks, dim=1)


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk") as one matmul over the flattened heads."""
    d, h, k = w.shape
    return (x @ w.to(x.dtype).reshape(d, h * k)).view(*x.shape[:-1], h, k)


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
    is read as it is."""
    rope = cfg.use_rope and kv_source is None
    b, s, _ = x.shape
    positions = torch.arange(start, start + s, device=x.device)
    # A query block at position 0 against an empty or absent cache sees
    # exactly its own k/v: all of them (the encoder), or under the kernel's
    # top-left causal mask.
    prefill = (kv_source is None and start == 0
               and (cache is None or (update_cache and cache.length == 0)))

    q = _project(x, p["wq"])
    if "bq" in p:
        q = q + p["bq"].to(x.dtype)
    if cfg.qk_norm:
        q = apply_norm(p["q_norm"], cfg, q)

    if cache is not None and not update_cache:
        # Read-only cache (precomputed KV).
        k, v, kv_len = cache.k, cache.v, cache.length
        new_cache = cache
    else:
        kv = compute_kv(p, cfg, kv_source if kv_source is not None else x)
        k, v = kv.k, kv.v
        if rope:
            k = apply_rope(k, positions, cfg.rope_theta)
        if cache is not None:
            # Append new K/V at cache.length, IN PLACE: unlike the JAX
            # package's functional update, the caller's buffers change and
            # the returned cache shares them.
            end = cache.length + s
            cache.k[:, cache.length:end] = k
            cache.v[:, cache.length:end] = v
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

    # The kernel is forward only: a call that needs gradients (training)
    # takes the plain path, as the JAX package's training does.
    if prefill and not ops.needs_grad(q, k, v):
        # (B, S, H, D) -> (B, H, S, D) strided views; the kernel writes its
        # output in q's memory layout, so the transpose back is free.
        out = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                  v.transpose(1, 2), causal=causal).transpose(1, 2)
    else:
        out = _attn_core(q, k, v, causal=causal and kv_source is None,
                         q_offset=start, kv_valid_len=kv_len, q_chunk=q_chunk)
    hq, dh = out.shape[2], out.shape[3]
    y = out.reshape(b, s, hq * dh) @ p["wo"].to(x.dtype).reshape(hq * dh, -1)
    if "bo" in p:
        y = y + p["bo"].to(x.dtype)
    return y, new_cache


def compute_kv(p: dict, cfg: ModelConfig, src: torch.Tensor) -> KVCache:
    """A read-only KV cache of `src` (encoder states, for cross-attention at
    prefill and decode), in `src`'s dtype, which is the activations' dtype
    as `make_cache`'s default is; its host `length` is the source length."""
    k = _project(src, p["wk"])
    v = _project(src, p["wv"])
    if "bk" in p:
        k = k + p["bk"].to(src.dtype)
        v = v + p["bv"].to(src.dtype)
    if cfg.qk_norm:
        k = apply_norm(p["k_norm"], cfg, k)
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
    h = x @ p["w_up"].to(x.dtype)
    if "b_up" in p:
        h = h + p["b_up"].to(x.dtype)
    if cfg.glu:
        gate = x @ p["w_gate"].to(x.dtype)
        h = _act(cfg, gate) * h
    else:
        h = _act(cfg, h)
    y = h @ p["w_down"].to(x.dtype)
    if "b_down" in p:
        y = y + p["b_down"].to(x.dtype)
    return y
