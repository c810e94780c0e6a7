"""The port's LM stack and model facade against the JAX package's, on the
CPU, with the JAX package's own weights carried across by
`params_from_numpy` (its init is not reproducible across processes, so
both sides must share one set of weights).

MoE configs compare with fp32 activations on both sides, on the port's
seeded weights carried to JAX (the same in every process). In bf16 the
two sides' hidden states differ by rounding, and where a token's k-th and
(k+1)-th router probabilities lie closer than that (0.001 apart on
reduced jamba), the sides route it to different experts and its output
moves by far more than TOL. The MoE layer alone is held in bf16 in
tests/test_torch_moe.py, where both sides route the same inputs."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import all_configs as jax_all_configs
from repro.configs import get_config as jax_get_config
from repro.configs.base import BlockDef
from repro.models import layers as JL
from repro.models import lm as JLM
from repro.models import make_model as jax_make_model
from repro.models.spec import ParamSpec as JaxParamSpec
from repro_torch.bridge import params_from_numpy, tensor_from_numpy
from repro_torch.configs import get_config
from repro_torch.models import layers as L
from repro_torch.models import lm as LM
from repro_torch.models import make_model
from repro_torch.models.spec import tree_leaves

TOL = 0.15          # whole-stack bf16 tolerance, tests/test_archs.py
MARGIN = 0.3        # compare argmax only where JAX's top-2 margin exceeds this
DENSE = sorted(n for n, c in jax_all_configs().items()
               if c.pattern == (BlockDef("attn", "dense"),) and not c.is_encdec)
MOE = sorted(n for n, c in jax_all_configs().items() if c.is_moe)
PORTED = DENSE + ["mamba2-1.3b"] + MOE
MAMBA_LEAVES = ("conv_x", "conv_b", "conv_c", "ssm")


def _cfgs(name: str, reduced: bool = True, **changes):
    jcfg, cfg = jax_get_config(name), get_config(name)
    if reduced:
        jcfg, cfg = jcfg.reduced(), cfg.reduced()
    return dataclasses.replace(jcfg, **changes), dataclasses.replace(cfg, **changes)


def _close(got: torch.Tensor, want, tol: float = TOL, err_msg: str = "") -> None:
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol, err_msg=err_msg)


def _inputs(cfg, rng, b: int, s: int):
    """(jax, torch) model inputs: token ids, or embeddings for VLM configs."""
    if cfg.embed_inputs:
        a = jnp.asarray(rng.standard_normal((b, s, cfg.d_model), dtype=np.float32),
                        jnp.bfloat16)
        return a, tensor_from_numpy(np.asarray(a), "cpu")
    ids = rng.integers(0, cfg.vocab_size, (b, s))
    return jnp.asarray(ids, jnp.int32), torch.from_numpy(ids)


def _fp32_activations(monkeypatch) -> None:
    """Both packages' activations (`layers.COMPUTE_DTYPE`) in fp32."""
    monkeypatch.setattr(JL, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(L, "COMPUTE_DTYPE", torch.float32)


def _to_numpy(t: dict) -> dict:
    return {k: _to_numpy(v) if isinstance(v, dict) else v.numpy() for k, v in t.items()}


def _check_prefill_and_decode(jcfg, cfg, seed: int, b: int = 2, s: int = 16,
                              steps: int = 4, port_weights: bool = False):
    """`port_weights`: the port's seeded init carried to JAX, instead of the
    JAX init carried to the port."""
    if port_weights:
        tparams = make_model(cfg).init(seed, device="cpu")
        params = jax.tree.map(jnp.asarray, _to_numpy(tparams))
    else:
        params = jax_make_model(jcfg).init(jax.random.key(seed))
        tparams = params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    rng = np.random.default_rng(seed)
    v = cfg.vocab_size

    jin, tin = _inputs(jcfg, rng, b, s)
    jl, jc = JLM.lm_prefill(params, jcfg, jin, max_len=s + steps)
    tl, tc = LM.lm_prefill(tparams, cfg, tin, max_len=s + steps)
    assert tl.shape == (b, cfg.padded_vocab()) and tl.dtype == torch.float32
    assert bool((tl[:, v:] == LM.NEG_INF).all())
    _close(tl[:, :v], np.asarray(jl)[:, :v], err_msg="prefill logits")
    _compare_caches(tc, jc, s)

    for t in range(s, s + steps):
        jlog = np.asarray(jl)[:, :v]
        top2 = np.sort(jlog, axis=-1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > MARGIN
        np.testing.assert_array_equal(tl[:, :v].argmax(-1).numpy()[clear],
                                      jlog.argmax(-1)[clear])
        if jcfg.embed_inputs:
            jstep, tstep = _inputs(jcfg, rng, b, 1)
        else:
            tok = jlog.argmax(-1)[:, None]
            jstep, tstep = jnp.asarray(tok, jnp.int32), torch.from_numpy(tok)
        jl, jc = JLM.lm_decode_step(params, jcfg, jstep, jc, t)
        tl, tc = LM.lm_decode_step(tparams, cfg, tstep, tc, t)
        _close(tl[:, :v], np.asarray(jl)[:, :v], err_msg=f"decode step {t}")
    _compare_caches(tc, jc, s + steps)


def _compare_caches(tc: dict, jc: dict, length: int) -> None:
    """Every block's stacked cache, leaf by leaf: attention k/v and length,
    or the Mamba conv and SSM states."""
    for name, blk in tc.items():
        assert set(blk) == set(jc[name])
        if "attn" in blk:
            want, got = jc[name]["attn"], blk["attn"]
            assert got.k.shape == want.k.shape
            assert got.length == length and (np.asarray(want.length) == length).all()
            _close(got.k, want.k, err_msg=f"{name} k cache")
            _close(got.v, want.v, err_msg=f"{name} v cache")
        if "mamba" in blk:
            want, got = jc[name]["mamba"], blk["mamba"]
            for leaf in MAMBA_LEAVES:
                g, w = getattr(got, leaf), getattr(want, leaf)
                assert tuple(g.shape) == w.shape, (name, leaf)
                # With fp32 activations the port keeps its conv states in
                # fp32 (they follow `layers.COMPUTE_DTYPE`); the reference's
                # stay bf16.
                if leaf == "ssm" or L.COMPUTE_DTYPE == torch.bfloat16:
                    assert str(g.dtype).removeprefix("torch.") == np.dtype(w.dtype).name
                _close(g, w, err_msg=f"{name} {leaf} cache")


@pytest.mark.parametrize("name", PORTED)
def test_reduced_prefill_and_decode_match_jax(name, monkeypatch):
    if name in MOE:
        _fp32_activations(monkeypatch)
    _check_prefill_and_decode(*_cfgs(name), seed=0, port_weights=name in MOE)


def test_full_width_smollm_two_layers_matches_jax():
    _check_prefill_and_decode(*_cfgs("smollm-135m", reduced=False, num_layers=2), seed=1)


def test_full_width_mamba2_two_layers_matches_jax():
    """mamba2-1.3b at its published widths (d_model 2048, 64 heads of 64,
    state 128, chunk 256), two layers, one 16-token prompt padded to a
    chunk, then decode steps from the scan's final state."""
    _check_prefill_and_decode(*_cfgs("mamba2-1.3b", reduced=False, num_layers=2), seed=2,
                              b=1, s=16, steps=2)


def test_full_width_granite_two_layers_matches_jax(monkeypatch):
    """granite-moe-3b-a800m at its published widths (d_model 1536, 24/8
    heads of 64, 40 experts padded to 48, top-8, d_ff 512), two layers,
    fp32 activations. At 16 tokens a row each expert takes 4, so the
    prefill drops tokens over capacity; a decode step takes 1."""
    _fp32_activations(monkeypatch)
    _check_prefill_and_decode(*_cfgs("granite-moe-3b-a800m", reduced=False, num_layers=2),
                              seed=1, b=2, s=16, steps=2, port_weights=True)


def test_incremental_decode_matches_full_forward():
    """Full forward (flash path, no cache) against prefill + one-token decode
    steps (plain path over the cache), within the port alone."""
    cfg = get_config("smollm-135m").reduced()
    model = make_model(cfg)
    params = model.init(3, device="cpu")
    ids = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size, (1, 24)))
    h, _, _ = LM.lm_hidden(params, cfg, ids)
    ref = LM.logits_from_hidden(params, cfg, h)
    logits, caches = LM.lm_prefill(params, cfg, ids[:, :16], max_len=24)
    torch.testing.assert_close(logits, ref[:, 15], rtol=TOL, atol=TOL)
    for t in range(16, 24):
        logits, caches = model.decode_step(params, ids[:, t:t + 1], caches, t)
        torch.testing.assert_close(logits, ref[:, t], rtol=TOL, atol=TOL)


def test_incremental_decode_matches_full_forward_mamba():
    """Full forward (the chunked scan, no cache) against a prefill of 12
    tokens and one-token decode steps from its conv and SSM states, within
    the port alone, across a chunk boundary of the reduced config (32)."""
    cfg = get_config("mamba2-1.3b").reduced()
    model = make_model(cfg)
    params = model.init(3, device="cpu")
    ids = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 40)))
    h, _, _ = LM.lm_hidden(params, cfg, ids)
    ref = LM.logits_from_hidden(params, cfg, h)
    logits, caches = LM.lm_prefill(params, cfg, ids[:, :12])
    torch.testing.assert_close(logits, ref[:, 11], rtol=TOL, atol=TOL)
    for t in range(12, 40):
        logits, caches = model.decode_step(params, ids[:, t:t + 1], caches, t)
        torch.testing.assert_close(logits, ref[:, t], rtol=TOL, atol=TOL)


def test_incremental_decode_matches_full_forward_moe():
    """Full forward against prefill + one-token decode steps on reduced
    granite, within the port alone, on a drop-free copy of the config (the
    capacity factor equal to the expert count, as tests/test_archs.py
    does): a batched pass legitimately drops tokens over capacity, and a
    single-token decode step never does."""
    cfg = get_config("granite-moe-3b-a800m").reduced()
    cfg = dataclasses.replace(cfg, moe_capacity_factor=float(cfg.moe_num_experts))
    model = make_model(cfg)
    params = model.init(3, device="cpu")
    ids = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 24)))
    h, _, _ = LM.lm_hidden(params, cfg, ids)
    ref = LM.logits_from_hidden(params, cfg, h)
    logits, caches = LM.lm_prefill(params, cfg, ids[:, :16], max_len=24)
    torch.testing.assert_close(logits, ref[:, 15], rtol=TOL, atol=TOL)
    for t in range(16, 24):
        logits, caches = model.decode_step(params, ids[:, t:t + 1], caches, t)
        torch.testing.assert_close(logits, ref[:, t], rtol=TOL, atol=TOL)


def _jax_spec_leaves(spec) -> dict:
    leaves = jax.tree_util.tree_flatten_with_path(
        spec, is_leaf=lambda x: isinstance(x, JaxParamSpec))[0]
    return {".".join(k.key for k in path): s for path, s in leaves}


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("name", PORTED + ["whisper-large-v3"])
def test_spec_matches_jax(name, reduced):
    jcfg, cfg = _cfgs(name, reduced=reduced)
    want = _jax_spec_leaves(jax_make_model(jcfg).spec())
    model = make_model(cfg)
    got = dict(tree_leaves(model.spec()))
    assert set(got) == set(want)
    for path, s in got.items():
        w = want[path]
        assert (s.shape, s.axes, s.init) == (w.shape, w.axes, w.init), path
        assert str(s.dtype).removeprefix("torch.") == np.dtype(w.dtype).name, path
    assert model.param_count() == jax_make_model(jcfg).param_count()


@pytest.mark.parametrize("block", [BlockDef("conv", "dense"), BlockDef("attn", "glu"),
                                   BlockDef("rwkv", None, cross_attn=True)],
                         ids=["mixer", "ffn", "cross-mixer"])
def test_unported_blocks_raise(block):
    """Every config of the repo builds (whisper-large-v3 since its
    encoder-decoder port); a block of a mixer or FFN kind the port does not
    know still raises, in the spec, the caches and the forward."""
    cfg = dataclasses.replace(get_config("smollm-135m").reduced(), pattern=(block,))
    with pytest.raises(NotImplementedError, match="not ported"):
        make_model(cfg).spec()
    with pytest.raises(NotImplementedError, match="not ported"):
        LM.make_block_cache(cfg, block, 1, 4, device="cpu")
    with pytest.raises(NotImplementedError, match="not ported"):
        LM.block_fwd({}, cfg, block, torch.zeros(1, 4, cfg.d_model), start=0)
    assert all(make_model(c.reduced()).param_count() > 0
               for c in map(get_config, jax_all_configs()))


def test_decode_helpers_match_jax():
    jcfg, cfg = _cfgs("smollm-135m")
    jm, m = jax_make_model(jcfg), make_model(cfg)
    want = jm.make_decode_caches(2, 8, filled=True)["block0"]["attn"]
    got = m.make_decode_caches(2, 8, filled=True, device="cpu")["block0"]["attn"]
    assert got.k.shape == want.k.shape and got.k.dtype == torch.bfloat16
    assert got.length == 7 and (np.asarray(want.length) == 7).all()
    assert tuple(m.decode_inputs(2, device="cpu").shape) == jm.decode_inputs(2).shape


def test_mamba_decode_helpers_match_jax():
    jcfg, cfg = _cfgs("mamba2-1.3b")
    want = jax_make_model(jcfg).make_decode_caches(2, 8, filled=True)["block0"]["mamba"]
    got = make_model(cfg).make_decode_caches(2, 8, filled=True, device="cpu")["block0"]["mamba"]
    for leaf in MAMBA_LEAVES:
        g, w = getattr(got, leaf), getattr(want, leaf)
        assert tuple(g.shape) == w.shape and not g.any(), leaf
        assert str(g.dtype).removeprefix("torch.") == np.dtype(w.dtype).name, leaf


def test_init_is_seeded_per_path():
    cfg = get_config("smollm-135m").reduced()
    model = make_model(cfg)
    a = dict(tree_leaves(model.init(0, device="cpu")))
    b = dict(tree_leaves(model.init(0, device="cpu")))
    c = dict(tree_leaves(model.init(1, device="cpu")))
    assert all(torch.equal(a[k], b[k]) for k in a)
    wk, wv = a["layers.block0.attn.wk"], a["layers.block0.attn.wv"]
    assert wk.shape == wv.shape and not torch.equal(wk, wv)
    assert not torch.equal(a["layers.block0.attn.wq"], c["layers.block0.attn.wq"])
    assert torch.equal(a["final_norm.scale"], torch.ones(cfg.d_model))
    # fan_in init: std 1/sqrt(d).
    std = a["layers.block0.ffn.w_up"].std().item()
    assert abs(std * cfg.d_model ** 0.5 - 1.0) < 0.1
