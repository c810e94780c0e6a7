"""The port's encoder-decoder (`repro_torch.models.encdec`, the cross-attention
branch of `models.lm`, the Model facade's encdec branches and the serving
driver) against the JAX package's, on the CPU, with reduced
whisper-large-v3 and the JAX package's own weights carried across by
`params_from_numpy` in the same process.

Tolerances: 0.15 in bf16 (the whole-stack bound of tests/test_archs.py);
1e-4 with fp32 activations on both sides. There the reference's KV caches
are made fp32 too: `make_cache` binds its dtype when the module is
imported, so under fp32 activations it would still round the self-attention
k/v to bf16, where the port's caches follow the activations."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import encdec as JED
from repro.models import layers as JL
from repro.models import make_model as jax_make_model
from repro_torch import tree
from repro_torch.bridge import params_from_numpy, tensor_from_numpy
from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.launch import serve as serve_main
from repro_torch.models import encdec as ED
from repro_torch.models import layers as L
from repro_torch.models import lm as LM
from repro_torch.models import make_model
from repro_torch.models.spec import tree_leaves

NAME = "whisper-large-v3"
TOL = {"bfloat16": 0.15, "float32": 1e-4}
GRAD_TOL = 1e-4                 # relative L2 per leaf, fp32 activations
B, S_ENC, S_DEC, PROMPT, Q_CHUNK = 2, 16, 16, 8, 8


@pytest.fixture
def activations(request, monkeypatch):
    """Both packages' activations (`layers.COMPUTE_DTYPE`) in `request.param`;
    in fp32 the reference's cache default too (module docstring)."""
    name = request.param
    monkeypatch.setattr(JL, "COMPUTE_DTYPE", getattr(jnp, name))
    monkeypatch.setattr(L, "COMPUTE_DTYPE", getattr(torch, name))
    if name == "float32":
        monkeypatch.setattr(JL.make_cache, "__defaults__", (jnp.float32, 0))
    return name


BOTH = pytest.mark.parametrize("activations", ["bfloat16", "float32"], indirect=True)
FP32 = pytest.mark.parametrize("activations", ["float32"], indirect=True)


def _setup(seed: int):
    """(jax cfg, port cfg, jax params, the same on the port, (jax, torch)
    frame embeddings (B, S_ENC, d) in bf16, (jax, torch) decoder ids
    (B, S_DEC))."""
    jcfg, cfg = jax_get_config(NAME).reduced(), get_config(NAME).reduced()
    params = jax_make_model(jcfg).init(jax.random.key(seed))
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    rng = np.random.default_rng(seed)
    enc = jnp.asarray(rng.standard_normal((B, S_ENC, cfg.d_model), dtype=np.float32),
                      jnp.bfloat16)
    ids = rng.integers(0, cfg.vocab_size, (B, S_DEC))
    return (jcfg, cfg, params, tparams, (enc, tensor_from_numpy(np.asarray(enc), "cpu")),
            (jnp.asarray(ids, jnp.int32), torch.from_numpy(ids)))


def _close(got: torch.Tensor, want, tol: float, err_msg: str = "") -> None:
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol, err_msg=err_msg)


def test_full_width_param_count_from_the_spec():
    """The spec tree against the reference's is tests/test_torch_lm.py's
    test_spec_matches_jax; here the published size, from the spec alone."""
    model = make_model(get_config(NAME))
    assert model.param_count() == 1_602_360_320 == model.active_param_count()
    spec = dict(tree_leaves(model.spec()))
    assert spec["enc_layers.block0.attn.wq"].shape == (32, 1280, 20, 64)
    assert spec["layers.block0.cross.wk"].shape == (32, 1280, 20, 64)
    assert "norm_cross" in model.spec()["layers"]["block0"]
    assert "cross" not in model.spec()["enc_layers"]["block0"]


def test_sinusoidal_positions_match_jax():
    for seq_len, d, offset in ((16, 64, 0), (1, 64, 11), (8, 1280, 3)):
        got = L.sinusoidal_positions(seq_len, d, offset)
        want = JL.sinusoidal_positions(seq_len, d, offset)
        assert got.dtype == torch.float32 and got.device.type == "cpu"
        _close(got, want, 1e-6)


@BOTH
def test_encode_matches_jax(activations):
    jcfg, cfg, params, tparams, (jenc, enc), _ = _setup(0)
    want = JED.encode(params, jcfg, jenc, q_chunk=Q_CHUNK)
    got = ED.encode(tparams, cfg, enc, q_chunk=Q_CHUNK)
    assert got.dtype == L.COMPUTE_DTYPE and got.shape == (B, S_ENC, cfg.d_model)
    _close(got, want, TOL[activations])


@BOTH
def test_decode_train_matches_jax(activations):
    jcfg, cfg, params, tparams, (jenc, enc), (jids, ids) = _setup(1)
    jh = JED.encode(params, jcfg, jenc, q_chunk=Q_CHUNK)
    want = JED.decode_train(params, jcfg, jh, jids, q_chunk=Q_CHUNK)
    got = ED.decode_train(tparams, cfg, ED.encode(tparams, cfg, enc, q_chunk=Q_CHUNK), ids,
                          q_chunk=Q_CHUNK)
    _close(got, want, TOL[activations])


@BOTH
def test_build_cross_caches_matches_jax(activations):
    """Per-period k/v of the encoder states, stacked on the periods axis, in
    the activations' dtype, `length` the source length."""
    jcfg, cfg, params, tparams, (jenc, enc), _ = _setup(2)
    want = JED.build_cross_caches(params, jcfg, JED.encode(params, jcfg, jenc, q_chunk=Q_CHUNK))
    got = ED.build_cross_caches(tparams, cfg, ED.encode(tparams, cfg, enc, q_chunk=Q_CHUNK))
    assert got.k.shape == want.k.shape == (cfg.periods, B, S_ENC, cfg.num_kv_heads,
                                           cfg.head_dim)
    assert got.k.dtype == got.v.dtype == L.COMPUTE_DTYPE
    assert got.length == S_ENC and (np.asarray(want.length) == S_ENC).all()
    _close(got.k, want.k, TOL[activations])
    _close(got.v, want.v, TOL[activations])


@BOTH
def test_prefill_and_decode_steps_match_jax(activations):
    """`encdec_prefill` of an 8-token prompt, then `encdec_decode_step`
    teacher-forced over the other 8 tokens: logits at every step, and the
    self and cross caches at the end."""
    tol = TOL[activations]
    jcfg, cfg, params, tparams, (jenc, enc), (jids, ids) = _setup(3)
    v = cfg.vocab_size
    jl, jc = JED.encdec_prefill(params, jcfg, jenc, jids[:, :PROMPT], max_len=S_DEC,
                                q_chunk=Q_CHUNK)
    tl, tc = ED.encdec_prefill(tparams, cfg, enc, ids[:, :PROMPT], max_len=S_DEC,
                               q_chunk=Q_CHUNK)
    assert tl.shape == (B, cfg.padded_vocab()) and tl.dtype == torch.float32
    _close(tl[:, :v], np.asarray(jl)[:, :v], tol, "prefill logits")
    for t in range(PROMPT, S_DEC):
        jl, jc = JED.encdec_decode_step(params, jcfg, jids[:, t:t + 1], jc, t)
        tl, tc = ED.encdec_decode_step(tparams, cfg, ids[:, t:t + 1], tc, t)
        _close(tl[:, :v], np.asarray(jl)[:, :v], tol, f"decode step {t}")
    assert set(tc["block0"]) == set(jc["block0"]) == {"attn", "cross"}
    for name, length in (("attn", S_DEC), ("cross", S_ENC)):
        got, want = tc["block0"][name], jc["block0"][name]
        assert got.k.shape == want.k.shape and got.k.dtype == L.COMPUTE_DTYPE, name
        assert got.length == length and (np.asarray(want.length) == length).all(), name
        _close(got.k, want.k, tol, f"{name} k cache")
        _close(got.v, want.v, tol, f"{name} v cache")


def _labels(cfg, seed: int):
    labels = np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S_DEC))
    labels[0, :3] = -1       # masked positions
    return jnp.asarray(labels, jnp.int32), torch.from_numpy(labels)


@BOTH
def test_loss_matches_jax(activations):
    jcfg, cfg, params, tparams, (jenc, enc), (jids, ids) = _setup(4)
    jlab, lab = _labels(cfg, 4)
    kw = dict(q_chunk=Q_CHUNK, loss_chunk=Q_CHUNK)
    want = JED.encdec_loss(params, jcfg, jenc, jids, jlab, **kw)
    with torch.no_grad():
        got = ED.encdec_loss(tparams, cfg, enc, ids, lab, **kw)
    assert got.dtype == torch.float32 and got.ndim == 0
    _close(got, want, TOL[activations])


@FP32
def test_loss_grads_per_leaf_match_jax(activations):
    """`encdec_loss` and its gradient w.r.t. every parameter leaf (encoder,
    decoder self and cross attention, norms, biases, the embedding) against
    `jax.value_and_grad`, with query chunks, loss chunks and remat on both
    sides. The k biases' gradients are zero but for rounding (softmax does
    not see a shift shared by all keys), so each leaf's error is taken
    relative to the largest leaf gradient's norm where its own is below
    it by 1e-3."""
    jcfg, cfg, params, tparams, (jenc, enc), (jids, ids) = _setup(5)
    jlab, lab = _labels(cfg, 5)
    kw = dict(q_chunk=Q_CHUNK, loss_chunk=Q_CHUNK, remat=True)
    want_loss, want_grads = jax.value_and_grad(
        lambda p: JED.encdec_loss(p, jcfg, jenc, jids, jlab, **kw))(params)
    live = tree.map_leaves(lambda t: t.detach().requires_grad_(True), tparams)
    loss = ED.encdec_loss(live, cfg, enc, ids, lab, **kw)
    grads = torch.autograd.grad(loss, tree.flatten(live))
    _close(loss, want_loss, 1e-5)
    flat = jax.tree_util.tree_flatten_with_path(want_grads)[0]
    assert len(grads) == len(flat)
    wants = [np.asarray(w, np.float32) for _, w in flat]
    largest = max(np.linalg.norm(w) for w in wants)
    for (path, _), want, got in zip(flat, wants, grads):
        name = jax.tree_util.keystr(path)
        assert got.shape == want.shape and got.dtype == torch.float32, name
        scale = max(np.linalg.norm(want), 1e-3 * largest)
        err = np.linalg.norm(got.numpy() - want) / scale
        assert err <= GRAD_TOL, f"{name}: relative L2 error {err:.3e}"


@pytest.mark.parametrize("activations", ["bfloat16", "float32"], indirect=True)
def test_encdec_incremental(activations):
    """tests/test_archs.py's test_encdec_incremental within the port:
    teacher-forced decoder logits against an 8-token prefill and one-token
    decode steps over the self and cross caches."""
    tol = TOL[activations]
    cfg = get_config(NAME).reduced()
    params = make_model(cfg).init(0, device="cpu")
    rng = np.random.default_rng(6)
    enc = torch.from_numpy(rng.standard_normal((1, S_ENC, cfg.d_model), dtype=np.float32))
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, S_DEC)))
    h = ED.decode_train(params, cfg, ED.encode(params, cfg, enc, q_chunk=Q_CHUNK), ids,
                        q_chunk=Q_CHUNK)
    ref = LM.logits_from_hidden(params, cfg, h)
    logits, caches = ED.encdec_prefill(params, cfg, enc, ids[:, :PROMPT], max_len=S_DEC,
                                       q_chunk=Q_CHUNK)
    torch.testing.assert_close(logits, ref[:, PROMPT - 1], rtol=tol, atol=tol)
    for t in range(PROMPT, S_DEC):
        logits, caches = ED.encdec_decode_step(params, cfg, ids[:, t:t + 1], caches, t)
        torch.testing.assert_close(logits, ref[:, t], rtol=tol, atol=tol,
                                   msg=lambda m, t=t: f"decode step {t}: {m}")


@pytest.mark.parametrize("activations", ["bfloat16"], indirect=True)
def test_model_facade_matches_jax(activations):
    """The `Model` facade's encdec branches: spec, loss, prefill, the decode
    caches and inputs, and a decode step over filled caches."""
    tol = TOL[activations]
    jcfg, cfg, params, tparams, (jenc, enc), (jids, ids) = _setup(7)
    jm, m = jax_make_model(jcfg), make_model(cfg)
    jlab, lab = _labels(cfg, 7)
    v = cfg.vocab_size
    assert m.param_count() == jm.param_count()
    want = jm.loss(params, {"enc_inputs": jenc, "dec_ids": jids, "labels": jlab},
                   q_chunk=Q_CHUNK, loss_chunk=Q_CHUNK)
    with torch.no_grad():
        got = m.loss(tparams, {"enc_inputs": enc, "dec_ids": ids, "labels": lab},
                     q_chunk=Q_CHUNK, loss_chunk=Q_CHUNK)
    _close(got, want, tol)
    jl, _ = jm.prefill(params, {"enc_inputs": jenc, "dec_prompt": jids[:, :PROMPT]},
                       q_chunk=Q_CHUNK)
    tl, tc = m.prefill(tparams, {"enc_inputs": enc, "dec_prompt": ids[:, :PROMPT]},
                       q_chunk=Q_CHUNK)
    _close(tl[:, :v], np.asarray(jl)[:, :v], tol, "prefill logits")
    assert tc["block0"]["attn"].k.shape[2] == PROMPT

    jc = jm.make_decode_caches(B, S_DEC, filled=True)
    tc = m.make_decode_caches(B, S_DEC, filled=True, device="cpu")
    for name in ("attn", "cross"):
        got, want = tc["block0"][name], jc["block0"][name]
        assert got.k.shape == want.k.shape and got.k.dtype == torch.bfloat16, name
        assert (np.asarray(want.length) == got.length).all(), name
    assert tc["block0"]["attn"].length == S_DEC - 1 and tc["block0"]["cross"].length == S_DEC
    step = m.decode_inputs(B, device="cpu")
    assert step.dtype == torch.long and tuple(step.shape) == jm.decode_inputs(B).shape
    jl, _ = jm.decode_step(params, jm.decode_inputs(B), jc, S_DEC - 1)
    tl, _ = m.decode_step(tparams, step, tc, S_DEC - 1)
    _close(tl[:, :v], np.asarray(jl)[:, :v], tol, "decode step")


def test_encoder_and_prompt_take_the_flash_entry(monkeypatch):
    """A spy on `ops.flash_attention`: a prefill calls it once per encoder
    layer without the causal mask and once per decoder layer with it (the
    prompt's self-attention); decode steps and every cross-attention never;
    the loss and its gradients never."""
    calls = []
    real = ops.flash_attention

    def spy(*args, **kw):
        calls.append(kw["causal"])
        return real(*args, **kw)

    monkeypatch.setattr(ops, "flash_attention", spy)
    cfg = dataclasses.replace(get_config(NAME).reduced(), num_layers=2, enc_layers=3)
    params = make_model(cfg).init(0, device="cpu")
    rng = np.random.default_rng(8)
    enc = torch.from_numpy(rng.standard_normal((B, S_ENC, cfg.d_model), dtype=np.float32))
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S_DEC)))
    _, caches = ED.encdec_prefill(params, cfg, enc, ids[:, :PROMPT], max_len=S_DEC)
    assert calls == [False] * 3 + [True] * 2
    for t in range(PROMPT, PROMPT + 2):
        _, caches = ED.encdec_decode_step(params, cfg, ids[:, t:t + 1], caches, t)
    assert len(calls) == 5
    live = tree.map_leaves(lambda t: t.detach().requires_grad_(True), params)
    loss = ED.encdec_loss(live, cfg, enc, ids, ids, q_chunk=Q_CHUNK, loss_chunk=Q_CHUNK)
    torch.autograd.grad(loss, tree.flatten(live))
    assert len(calls) == 5


def test_driver_serves_whisper_on_cpu(capsys):
    """The driver publishes and restores reduced whisper, encodes 16 stub
    frames a request, prefills an 8-token decoder prompt and decodes token
    ids (not embeddings) in range; CPU tensors launch no kernel."""
    before = fa.launches
    out = serve_main.main(["--arch", NAME, "--device", "cpu", "--store",
                           "sims3://w?latency_ms=0", "--batch", "2", "--prompt-len", "16",
                           "--gen", "4"])
    text = capsys.readouterr().out
    assert "weight restore (rolling): " in text
    assert "prefill:" in text and "2 prompts of 8 tokens" in text
    assert "decoded 4 tokens x 2 seqs" in text
    cfg = get_config(NAME).reduced()
    assert out.shape == (2, 4) and out.dtype == np.int64
    assert out.min() >= 0 and out.max() < cfg.vocab_size
    assert fa.launches == before
