"""The port's training pieces against the JAX package's, on the CPU: AdamW
(`schedule`, `apply_updates`), the loss (`chunked_xent`, `lm_loss`, with
the MoE aux term) and its gradients per parameter leaf, the periods'
recompute (`remat`), and the routing that keeps the forward-only kernels
off the training path.

Both sides start from the port's seeded weights, carried to JAX through
numpy (the JAX package's init differs between processes). Tolerances:
fp32 AdamW arithmetic 1e-6 relative (the two libraries sum the global
norm in different orders); gradients per leaf, as the relative L2 error,
1e-4 with fp32 activations (measured at most 7e-6) and 5e-2 with bf16
activations (measured at most 3.3e-2: every layer rounds its activations
to bf16, 2^-8 relative, in a different order on each side). MoE configs
compare with fp32 activations only: in bf16 a router near-tie can send a
token to other experts on each side (tests/test_torch_lm.py).
command-r-plus's parallel block holds the hand-written backward of its
two last products (`lm.products_saved_first`) to the reference's."""

from __future__ import annotations

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import get_config as jax_get_config
from repro.models import layers as JL
from repro.models import lm as JLM
from repro.train import optimizer as JOPT
from repro_torch import tree
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import lm as LM
from repro_torch.models import make_model
from repro_torch.train import optimizer as OPT

ARCHS = ["smollm-135m", "mamba2-1.3b", "command-r-plus-104b"]
MOE_ARCHS = ["granite-moe-3b-a800m", "jamba-1.5-large-398b"]
GRAD_TOL = {"float32": 1e-4, "bfloat16": 5e-2}


def to_numpy(t) -> dict:
    return {k: to_numpy(v) if isinstance(v, dict) else v.detach().numpy() for k, v in t.items()}


def to_jax(t: dict) -> dict:
    return jax.tree.map(jnp.asarray, to_numpy(t))


@pytest.fixture
def activations(request, monkeypatch):
    """Set both packages' activation dtype (`layers.COMPUTE_DTYPE`)."""
    name = request.param
    monkeypatch.setattr(JL, "COMPUTE_DTYPE", getattr(jnp, name))
    monkeypatch.setattr(L, "COMPUTE_DTYPE", getattr(torch, name))
    return name


def _cfgs(arch: str):
    return jax_get_config(arch).reduced(), get_config(arch).reduced()


def _batch(cfg, seed: int, b: int = 2, s: int = 64):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, cfg.vocab_size, (b, s))
    labels = rng.integers(0, cfg.vocab_size, (b, s))
    labels[0, :5] = -1       # masked positions
    return ids, labels


def _grads(params, cfg, ids, labels, **kw):
    live = tree.map_leaves(lambda p: p.detach().requires_grad_(True), params)
    loss = LM.lm_loss(live, cfg, torch.from_numpy(ids), torch.from_numpy(labels), **kw)
    return loss.detach(), torch.autograd.grad(loss, tree.flatten(live))


# --------------------------------------------------------------------------- #
# AdamW
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("cfg_kw", [
    dict(),
    dict(lr=1e-3, warmup_steps=3, total_steps=20, min_lr_ratio=0.0),
    dict(warmup_steps=0, total_steps=1),
])
def test_schedule_matches_reference(cfg_kw):
    jcfg, cfg = JOPT.AdamWConfig(**cfg_kw), OPT.AdamWConfig(**cfg_kw)
    for step in (0, 1, 2, 3, 4, 50, 99, 100, 101, 5000, 9999, 10000, 12000):
        want = float(JOPT.schedule(jcfg, jnp.asarray(step, jnp.int32)))
        got = OPT.schedule(cfg, torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.ndim == 0
        assert math.isclose(float(got), want, rel_tol=1e-6, abs_tol=1e-12), (step, got, want)


def _opt_tree(rng, shapes: dict, scale: float = 1.0) -> dict:
    return {k: _opt_tree(rng, v, scale) if isinstance(v, dict)
            else np.asarray(rng.standard_normal(v) * scale, np.float32) for k, v in shapes.items()}


SHAPES = {"w": (6, 5), "blk": {"b": (7,), "a": {"z": (3, 2, 4), "k": ()}}, "e": (0, 3)}


@pytest.mark.parametrize("clip", [False, True])
@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_apply_updates_matches_reference(moments, clip):
    rng = np.random.default_rng(0)
    params = _opt_tree(rng, SHAPES)
    grads = _opt_tree(rng, SHAPES, scale=10.0 if clip else 0.01)
    m = _opt_tree(rng, SHAPES, scale=0.01)
    v = jax.tree.map(np.abs, _opt_tree(rng, SHAPES, scale=1e-4))
    kw = dict(lr=1e-3, warmup_steps=3, total_steps=20, moments_dtype=moments)
    jcfg, cfg = JOPT.AdamWConfig(**kw), OPT.AdamWConfig(**kw)
    mdt_j = jnp.bfloat16 if moments == "bfloat16" else jnp.float32
    mdt_t = getattr(torch, moments)

    def jx(t, dt=jnp.float32):
        return jax.tree.map(lambda a: jnp.asarray(a, dt), t)

    def tt(t, dt=torch.float32):
        return tree.map_leaves(lambda a: torch.from_numpy(np.asarray(a)).to(dt), t)

    jstate = JOPT.AdamWState(jnp.asarray(4, jnp.int32), jx(m, mdt_j), jx(v, mdt_j))
    tstate = OPT.AdamWState(torch.tensor(4, dtype=torch.int32), tt(m, mdt_t), tt(v, mdt_t))
    jp, js, jm = JOPT.apply_updates(jcfg, jx(params), jx(grads), jstate)
    tp, ts, tm = OPT.apply_updates(cfg, tt(params), tt(grads), tstate)

    assert int(ts.step) == 5 and ts.step.dtype == torch.int32 and ts.step.ndim == 0
    for key in ("grad_norm", "lr"):
        assert math.isclose(float(tm[key]), float(jm[key]), rel_tol=1e-6), key
    if clip:
        assert float(tm["grad_norm"]) > cfg.grad_clip_norm
    for want, got in zip(jax.tree.leaves(jp), tree.flatten(tp)):
        assert got.dtype == torch.float32 and not got.requires_grad
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-9)
    # Moments: fp32 to 1e-6; bf16 to one bf16 ulp (2^-8 relative), since an
    # fp32 value one ulp apart may round to the neighbouring bf16.
    tol = 2.0 ** -8 if moments == "bfloat16" else 1e-6
    for want, got in zip(jax.tree.leaves((js.m, js.v)), tree.flatten((ts.m, ts.v))):
        assert got.dtype == mdt_t
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                   rtol=tol, atol=1e-30)


def test_init_state_and_global_norm():
    params = {"b": torch.ones(3), "a": {"w": torch.full((2, 2), 2.0)}}
    st = OPT.init_state(params, OPT.AdamWConfig(moments_dtype="bfloat16"))
    assert st.step.dtype == torch.int32 and st.step.ndim == 0 and int(st.step) == 0
    assert [t.dtype for t in tree.flatten((st.m, st.v))] == [torch.bfloat16] * 4
    assert all(not t.any() for t in tree.flatten((st.m, st.v)))
    assert list(st.m) == ["b", "a"]          # the parameters' structure
    assert OPT.init_state(params).m["a"]["w"].dtype == torch.float32
    assert float(OPT.global_norm(params)) == pytest.approx(math.sqrt(3 + 16))


# --------------------------------------------------------------------------- #
# Loss and gradients
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("chunk", [8, 32])
def test_chunked_xent_matches_jax_and_full_cross_entropy(chunk):
    """Several chunks and masked labels: equal to the JAX package's
    chunked_xent and to one `cross_entropy` over the whole (B, S, V)."""
    # A vocabulary that pads: the padded rows' logits are masked.
    jcfg, cfg = (dataclasses.replace(c, vocab_size=500) for c in _cfgs("smollm-135m"))
    assert cfg.padded_vocab() > cfg.vocab_size
    params = make_model(cfg).init(0, device="cpu")
    rng = np.random.default_rng(3)
    h = rng.standard_normal((2, 32, cfg.d_model)).astype(np.float32)
    labels = rng.integers(0, cfg.vocab_size, (2, 32))
    labels[1, 3:9] = -1
    got = LM.chunked_xent(params, cfg, torch.from_numpy(h), torch.from_numpy(labels), chunk=chunk)
    want = JLM.chunked_xent(to_jax(params), jcfg, jnp.asarray(h), jnp.asarray(labels, jnp.int32),
                            chunk=chunk)
    assert got.dtype == torch.float32 and got.ndim == 0
    assert math.isclose(float(got), float(want), rel_tol=1e-5)
    logits = LM.logits_from_hidden(params, cfg, torch.from_numpy(h))
    full = F.cross_entropy(logits.flatten(0, 1), torch.from_numpy(labels).flatten(),
                           ignore_index=-1)
    assert math.isclose(float(got), float(full), rel_tol=1e-5)
    with pytest.raises(ValueError, match="multiple of the loss chunk"):
        LM.chunked_xent(params, cfg, torch.from_numpy(h), torch.from_numpy(labels), chunk=12)


@pytest.mark.parametrize("activations", ["float32", "bfloat16"], indirect=True)
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_per_leaf_match_jax(arch, activations):
    """`lm_loss` and its gradient w.r.t. every parameter leaf against
    `jax.value_and_grad` of the JAX package's `lm_loss`, with query chunks,
    loss chunks and remat on both sides."""
    _check_loss_and_grads(arch, activations)


@pytest.mark.parametrize("activations", ["float32"], indirect=True)
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_loss_and_grads_per_leaf_match_jax(arch, activations):
    """The same for MoE configs, whose loss carries the weighted Switch aux
    term: the router's, the experts' and every other leaf's gradients
    against the reference's."""
    _check_loss_and_grads(arch, activations)


def _check_loss_and_grads(arch: str, activations: str) -> None:
    jcfg, cfg = _cfgs(arch)
    params = make_model(cfg).init(0, device="cpu")
    ids, labels = _batch(cfg, seed=0)
    kw = dict(q_chunk=32, loss_chunk=32, remat=True)
    want_loss, want_grads = jax.value_and_grad(
        lambda p: JLM.lm_loss(p, jcfg, jnp.asarray(ids, jnp.int32),
                              jnp.asarray(labels, jnp.int32), **kw))(to_jax(params))
    loss, grads = _grads(params, cfg, ids, labels, **kw)
    assert math.isclose(float(loss), float(want_loss), rel_tol=1e-5)
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(want_grads)[0]]
    assert len(grads) == len(paths)
    for path, want, got in zip(paths, jax.tree.leaves(want_grads), grads):
        want = np.asarray(want, np.float32)
        assert got.shape == want.shape and got.dtype == torch.float32, path
        err = np.linalg.norm(got.numpy() - want) / np.linalg.norm(want)
        assert err <= GRAD_TOL[activations], f"{path}: relative L2 error {err:.3e}"


@pytest.mark.parametrize("arch", ARCHS + MOE_ARCHS)
def test_remat_gives_the_same_grads(arch):
    """Recomputing each period (and each query chunk) in the backward pass
    changes no gradient: the recompute sees the same weights and inputs."""
    _, cfg = _cfgs(arch)
    params = make_model(cfg).init(1, device="cpu")
    ids, labels = _batch(cfg, seed=1)
    loss_on, on = _grads(params, cfg, ids, labels, q_chunk=16, loss_chunk=32, remat=True)
    loss_off, off = _grads(params, cfg, ids, labels, q_chunk=16, loss_chunk=32, remat=False)
    assert torch.equal(loss_on, loss_off)
    for a, b in zip(on, off):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-9)


def test_remat_refuses_caches():
    _, cfg = _cfgs("smollm-135m")
    params = make_model(cfg).init(0, device="cpu")
    caches = LM.make_stack_cache(cfg, 1, 8, device="cpu")
    with pytest.raises(ValueError, match="remat"):
        LM.stack_fwd(params["layers"], cfg, torch.zeros(1, 4, cfg.d_model), start=0,
                     caches=caches, update_cache=True, remat=True)


@pytest.mark.parametrize("arch,entry", [("smollm-135m", "flash_attention"),
                                        ("mamba2-1.3b", "ssd_scan"),
                                        ("granite-moe-3b-a800m", "flash_attention")])
def test_training_never_calls_the_kernels_and_prefill_still_does(monkeypatch, arch, entry):
    """A spy on each `ops` entry: a loss and its gradients call neither;
    `lm_prefill` without grad calls the model's kernel once per layer."""
    calls = {"flash_attention": 0, "ssd_scan": 0}
    for name in calls:
        real = getattr(ops, name)

        def spy(*args, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*args, **kw)

        monkeypatch.setattr(ops, name, spy)
    _, cfg = _cfgs(arch)
    params = make_model(cfg).init(0, device="cpu")
    ids, labels = _batch(cfg, seed=2)
    _grads(params, cfg, ids, labels, q_chunk=64, loss_chunk=64, remat=True)
    assert calls == {"flash_attention": 0, "ssd_scan": 0}
    # Parameters that require grad, as training holds them, but no grad mode.
    live = tree.map_leaves(lambda p: p.detach().requires_grad_(True), params)
    with torch.no_grad():
        LM.lm_prefill(live, cfg, torch.from_numpy(ids))
    assert calls == {name: cfg.num_layers if name == entry else 0 for name in calls}


@pytest.mark.parametrize("activations", ["float32"], indirect=True)
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_loss_adds_the_weighted_aux_term(arch, activations):
    """`lm_loss` is the cross-entropy plus `moe_aux_loss_weight` times the
    stack's aux over the layer count, and that aux equals the reference's."""
    jcfg, cfg = _cfgs(arch)
    params = make_model(cfg).init(2, device="cpu")
    ids, labels = _batch(cfg, seed=3)
    with torch.no_grad():
        loss = LM.lm_loss(params, cfg, torch.from_numpy(ids), torch.from_numpy(labels),
                          q_chunk=32, loss_chunk=32)
        h, _, aux = LM.lm_hidden(params, cfg, torch.from_numpy(ids), q_chunk=32)
        xent = LM.chunked_xent(params, cfg, h, torch.from_numpy(labels), chunk=32)
    assert any(bd.ffn == "moe" for bd in cfg.pattern) and float(aux) > 0
    assert float(loss) == pytest.approx(
        float(xent) + cfg.moe_aux_loss_weight * float(aux) / cfg.num_layers, rel=1e-6)
    _, _, want_aux = JLM.lm_hidden(to_jax(params), jcfg, jnp.asarray(ids, jnp.int32),
                                   q_chunk=32)
    assert math.isclose(float(aux), float(want_aux), rel_tol=1e-5)
