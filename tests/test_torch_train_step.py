"""Three train steps of reduced smollm-135m through the port's
`build_train_step` against the JAX package's, from the same parameters and
batches, with one and with two microbatches.

The port's seeded weights are carried to JAX through numpy. Tolerances:
`lr` to 1e-6 relative, always. With fp32 activations, loss and grad_norm
to 1e-5 relative and every parameter to 1e-5 absolute after three steps
(measured at most 1.5e-6; AdamW's first steps move a weight by about
lr = 1e-3 whatever the gradient's size, so a sign flip of a tiny gradient
would show as 2e-3). With bf16 activations, whose rounding differs in
order between XLA and PyTorch, loss to 2e-4 and grad_norm to 3e-3 relative
(measured at most 2.5e-5 and 7.4e-4); parameters are not compared there."""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import layers as JL
from repro.models import make_model as jax_make_model
from repro.train import AdamWConfig as JaxAdamWConfig
from repro.train import StepConfig as JaxStepConfig
from repro.train import TrainState as JaxTrainState
from repro.train import build_train_step as jax_build_train_step
from repro.train.optimizer import init_state as jax_init_state
from repro_torch import tree
from repro_torch.configs import get_config
from repro_torch.models import layers as L
from repro_torch.models import make_model
from repro_torch.train import (
    AdamWConfig,
    StepConfig,
    TrainState,
    build_train_step,
    init_train_state,
)

TOL = {"float32": {"loss": 1e-5, "grad_norm": 1e-5},
       "bfloat16": {"loss": 2e-4, "grad_norm": 3e-3}}
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)


def _to_jax(t: dict) -> dict:
    return {k: _to_jax(v) if isinstance(v, dict) else jnp.asarray(v.numpy())
            for k, v in t.items()}


@pytest.mark.parametrize("activations", ["float32", "bfloat16"])
@pytest.mark.parametrize("microbatches", [1, 2])
def test_three_steps_match_jax(monkeypatch, microbatches, activations):
    monkeypatch.setattr(JL, "COMPUTE_DTYPE", getattr(jnp, activations))
    monkeypatch.setattr(L, "COMPUTE_DTYPE", getattr(torch, activations))
    jcfg, cfg = jax_get_config("smollm-135m").reduced(), get_config("smollm-135m").reduced()
    model = make_model(cfg)
    state = init_train_state(model, 0, device="cpu")
    jparams = _to_jax(state.params)
    jstate = JaxTrainState(jparams, jax_init_state(jparams))
    step_kw = dict(microbatches=microbatches, q_chunk=32, loss_chunk=32)
    jstep = jax.jit(jax_build_train_step(jax_make_model(jcfg), JaxAdamWConfig(**OPT),
                                         JaxStepConfig(**step_kw)))
    step = build_train_step(model, AdamWConfig(**OPT), StepConfig(**step_kw))

    rng = np.random.default_rng(1)
    for i in range(3):
        ids = rng.integers(0, cfg.vocab_size, (4, 65))
        jstate, jm = jstep(jstate, {"inputs": jnp.asarray(ids[:, :-1], jnp.int32),
                                    "labels": jnp.asarray(ids[:, 1:], jnp.int32)})
        state, m = step(state, {"inputs": torch.from_numpy(ids[:, :-1]),
                                "labels": torch.from_numpy(ids[:, 1:])})
        assert isinstance(state, TrainState) and int(state.opt.step) == i + 1
        for key in ("loss", "grad_norm", "lr"):
            assert isinstance(m[key], torch.Tensor) and m[key].ndim == 0
            tol = 1e-6 if key == "lr" else TOL[activations][key]
            assert math.isclose(float(m[key]), float(jm[key]), rel_tol=tol), \
                (i, key, float(m[key]), float(jm[key]))
    if activations == "float32":
        for want, got in zip(jax.tree.leaves(jstate.params), tree.flatten(state.params)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def test_step_is_functional_and_keeps_state_off_the_graph():
    """The old state is left as it was; the new one holds plain tensors
    (no grad, no history), and the metrics are 0-d tensors."""
    cfg = get_config("smollm-135m").reduced()
    model = make_model(cfg)
    state = init_train_state(model, 0, device="cpu")
    before = [t.clone() for t in tree.flatten(state)]
    step = build_train_step(model, AdamWConfig(**OPT), StepConfig(q_chunk=16, loss_chunk=16))
    ids = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 17)))
    new, metrics = step(state, {"inputs": ids[:, :-1], "labels": ids[:, 1:]})
    for a, b in zip(before, tree.flatten(state)):
        assert torch.equal(a, b)
    for t in tree.flatten(new):
        assert not t.requires_grad and t.grad_fn is None
    assert any(not torch.equal(a, b) for a, b in zip(tree.flatten(state.params),
                                                     tree.flatten(new.params)))
    assert sorted(metrics) == ["grad_norm", "loss", "lr"]


def test_microbatches_must_divide_the_batch():
    cfg = get_config("smollm-135m").reduced()
    model = make_model(cfg)
    state = init_train_state(model, 0, device="cpu")
    step = build_train_step(model, AdamWConfig(**OPT), StepConfig(microbatches=2))
    ids = torch.zeros((3, 8), dtype=torch.long)
    with pytest.raises(ValueError, match="microbatches"):
        step(state, {"inputs": ids, "labels": ids})
