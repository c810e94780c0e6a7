"""The port's dense layers against the JAX package's, on the CPU.

Each function gets the same seeded numpy inputs and parameters on both
sides. fp32 runs hold the algorithm (2e-3), bf16 runs the rounding (2e-2),
the tolerances of tests/test_kernels.py."""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import layers as JL
from repro_torch.bridge import params_from_numpy, tensor_from_numpy
from repro_torch.configs import get_config
from repro_torch.models import layers as L

DTYPES = [(jnp.float32, 2e-3), (jnp.bfloat16, 2e-2)]
DTYPE_IDS = ["fp32", "bf16"]


def _cfgs(name: str, **changes):
    """The reduced config `name` on both sides, with the same changes."""
    return (dataclasses.replace(jax_get_config(name).reduced(), **changes),
            dataclasses.replace(get_config(name).reduced(), **changes))


def _np_params(spec, rng) -> dict:
    """Seeded numpy values for a JAX spec tree, scaled like its init but with
    scales off 1 and biases off 0, so every parameter shows in the output."""
    out = {}
    for k, s in spec.items():
        if isinstance(s, dict):
            out[k] = _np_params(s, rng)
            continue
        kind = s.init if isinstance(s.init, str) else s.init[0]
        std = {"normal": lambda: s.init[1], "fan_in": lambda: s.init[1] ** -0.5}.get(
            kind, lambda: 0.1)()
        base = 1.0 if kind == "ones" else 0.0
        out[k] = (base + std * rng.standard_normal(s.shape)).astype(np.float32)
    return out


def _both(params: dict):
    """(jax tree, torch tree) of the same numpy parameters."""
    return ({k: _both(v)[0] if isinstance(v, dict) else jnp.asarray(v)
             for k, v in params.items()},
            params_from_numpy(params, "cpu"))


def _x(rng, shape, dtype):
    a = jnp.asarray(rng.standard_normal(shape, dtype=np.float32), dtype)
    return a, tensor_from_numpy(np.asarray(a), "cpu")


def _close(got: torch.Tensor, want, tol: float) -> None:
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype,tol", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("name,changes", [
    ("smollm-135m", {}),                          # RMSNorm with scale
    ("olmo-1b", {}),                              # non-parametric LayerNorm
    ("command-r-plus-104b", {"norm_bias": True}),  # LayerNorm, scale and bias
], ids=["rms", "ln-nonparam", "ln-bias"])
def test_apply_norm(name, changes, dtype, tol):
    jcfg, cfg = _cfgs(name, **changes)
    rng = np.random.default_rng(0)
    jp, p = _both(_np_params(JL.norm_spec(jcfg), rng))
    jx, x = _x(rng, (2, 5, jcfg.d_model), dtype)
    got = L.apply_norm(p, cfg, x)
    assert got.dtype == x.dtype
    _close(got, JL.apply_norm(jp, jcfg, jx), tol)


@pytest.mark.parametrize("dtype,tol", DTYPES, ids=DTYPE_IDS)
def test_apply_rope(dtype, tol):
    rng = np.random.default_rng(1)
    jx, x = _x(rng, (2, 10, 3, 16), dtype)
    pos = np.arange(5, 15)
    got = L.apply_rope(x, torch.from_numpy(pos), 10000.0)
    assert got.dtype == x.dtype
    _close(got, JL.apply_rope(jx, jnp.asarray(pos), 10000.0), tol)


@pytest.mark.parametrize("multiplier", [1.0, 12.0])
def test_embed_tokens(multiplier):
    jcfg, cfg = _cfgs("smollm-135m", embedding_multiplier=multiplier)
    rng = np.random.default_rng(2)
    jp, p = _both(_np_params(JL.embedding_spec(jcfg), rng))
    ids = rng.integers(0, jcfg.vocab_size, (2, 7))
    got = L.embed_tokens(p, cfg, torch.from_numpy(ids))
    assert got.dtype == torch.bfloat16
    _close(got, JL.embed_tokens(jp, jcfg, jnp.asarray(ids)), 2e-2)


@pytest.mark.parametrize("dtype,tol", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("changes", [
    {},                                              # SwiGLU
    {"act": "gelu", "glu": False, "out_bias": True},  # plain GELU MLP with biases
], ids=["swiglu", "gelu-bias"])
def test_mlp(changes, dtype, tol):
    jcfg, cfg = _cfgs("smollm-135m", **changes)
    rng = np.random.default_rng(3)
    jp, p = _both(_np_params(JL.mlp_spec(jcfg), rng))
    jx, x = _x(rng, (2, 6, jcfg.d_model), dtype)
    _close(L.mlp(p, cfg, x), JL.mlp(jp, jcfg, jx), tol)


def _attn_setup(name, seed):
    jcfg, cfg = _cfgs(name)
    rng = np.random.default_rng(seed)
    jp, p = _both(_np_params(JL.attention_spec(jcfg), rng))
    return jcfg, cfg, rng, jp, p


@pytest.mark.parametrize("dtype,tol", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("name", ["smollm-135m", "codeqwen1.5-7b"])  # GQA; MHA + qkv bias
@pytest.mark.parametrize("with_cache", [True, False], ids=["empty-cache", "no-cache"])
def test_attention_prefill(name, with_cache, dtype, tol):
    """Position 0 against an empty or absent cache: the flash path."""
    jcfg, cfg, rng, jp, p = _attn_setup(name, 4)
    b, s, s_max = 2, 12, 16
    jx, x = _x(rng, (b, s, jcfg.d_model), dtype)
    jcache = JL.make_cache(jcfg, b, s_max, dtype=dtype) if with_cache else None
    cache = L.make_cache(cfg, b, s_max, device="cpu", dtype=x.dtype) if with_cache else None
    want, jnew = JL.attention(jp, jcfg, jx, positions=jnp.arange(s), cache=jcache,
                              update_cache=with_cache)
    got, new = L.attention(p, cfg, x, start=0, cache=cache, update_cache=with_cache)
    _close(got, want, tol)
    if with_cache:
        assert new.length == int(jnew.length) == s
        _close(new.k, jnew.k, tol)
        _close(new.v, jnew.v, tol)
        assert new.k.data_ptr() == cache.k.data_ptr()   # appended in place
    else:
        assert new is None and jnew is None


@pytest.mark.parametrize("dtype,tol", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("new_tokens", [1, 3], ids=["decode", "chunk"])
def test_attention_against_filled_cache(new_tokens, dtype, tol):
    """New tokens at position 9 against 9 cached positions: the plain path."""
    jcfg, cfg, rng, jp, p = _attn_setup("smollm-135m", 5)
    b, filled, s_max = 2, 9, 16
    shape = (b, s_max, jcfg.num_kv_heads, jcfg.head_dim)
    kv = [rng.standard_normal(shape, dtype=np.float32) for _ in range(2)]
    for a in kv:
        a[:, filled:] = 0.0
    jk, jv = (jnp.asarray(a, dtype) for a in kv)
    jcache = JL.KVCache(jk, jv, jnp.asarray(filled, jnp.int32))
    cache = L.KVCache(tensor_from_numpy(np.asarray(jk), "cpu"),
                      tensor_from_numpy(np.asarray(jv), "cpu"), filled)
    jx, x = _x(rng, (b, new_tokens, jcfg.d_model), dtype)
    positions = jnp.arange(filled, filled + new_tokens)
    want, jnew = JL.attention(jp, jcfg, jx, positions=positions, cache=jcache,
                              update_cache=True)
    got, new = L.attention(p, cfg, x, start=filled, cache=cache, update_cache=True)
    _close(got, want, tol)
    assert new.length == int(jnew.length) == filled + new_tokens
    _close(new.k, jnew.k, tol)
    _close(new.v, jnew.v, tol)


def test_attention_read_only_cache():
    """A cache passed without update_cache is attended to and left as it is."""
    jcfg, cfg, rng, jp, p = _attn_setup("smollm-135m", 8)
    shape = (2, 10, jcfg.num_kv_heads, jcfg.head_dim)
    jk, jv = (jnp.asarray(rng.standard_normal(shape, dtype=np.float32)) for _ in range(2))
    jcache = JL.KVCache(jk, jv, jnp.asarray(7, jnp.int32))
    cache = L.KVCache(tensor_from_numpy(np.asarray(jk), "cpu"),
                      tensor_from_numpy(np.asarray(jv), "cpu"), 7)
    jx, x = _x(rng, (2, 1, jcfg.d_model), jnp.float32)
    want, _ = JL.attention(jp, jcfg, jx, positions=jnp.arange(9, 10), cache=jcache)
    got, new = L.attention(p, cfg, x, start=9, cache=cache)
    _close(got, want, 2e-3)
    assert new is cache and new.length == 7


def test_attention_cross_source():
    """Cross-attention (k/v from another sequence, no mask, no RoPE)."""
    jcfg, cfg, rng, jp, p = _attn_setup("smollm-135m", 6)
    jx, x = _x(rng, (2, 5, jcfg.d_model), jnp.float32)
    jsrc, src = _x(rng, (2, 11, jcfg.d_model), jnp.float32)
    want, _ = JL.attention(jp, jcfg, jx, positions=jnp.arange(5), kv_source=jsrc,
                           causal=False)
    got, _ = L.attention(p, cfg, x, start=0, kv_source=src, causal=False)
    _close(got, want, 2e-3)


def test_attn_core_chunks_queries():
    """Query chunking, ragged last chunk included, does not change the result."""
    rng = np.random.default_rng(7)
    q = torch.from_numpy(rng.standard_normal((1, 10, 4, 16), dtype=np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 14, 2, 16), dtype=np.float32))
    v = torch.from_numpy(rng.standard_normal((1, 14, 2, 16), dtype=np.float32))
    whole = L._attn_core(q, k, v, causal=True, q_offset=4, kv_valid_len=13)
    chunked = L._attn_core(q, k, v, causal=True, q_offset=4, kv_valid_len=13, q_chunk=4)
    torch.testing.assert_close(chunked, whole, rtol=1e-6, atol=1e-6)
