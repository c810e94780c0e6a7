"""The port's MoE layer and MoE stacks on the card, against the host CPU.

Every test here needs an NVIDIA GPU and skips without one; the file imports
no JAX, so it runs on a machine that has only PyTorch:

  PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_moe.py
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import tree
from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.models import lm as LM
from repro_torch.models import make_model
from repro_torch.models import moe as M

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _layer(cuda, dtype, **changes):
    """Reduced granite's MoE layer with `changes`: (cfg, weights on the
    card, the same on the host, x on the card, the same on the host)."""
    cfg = dataclasses.replace(get_config("granite-moe-3b-a800m").reduced(), **changes)
    rng = np.random.default_rng(0)
    host = {k: torch.from_numpy((rng.standard_normal(s.shape) * s.init[1] ** -0.5)
                                .astype(np.float32))
            for k, s in M.moe_spec(cfg).items()}
    x = torch.from_numpy(rng.standard_normal((2, 64, cfg.d_model), dtype=np.float32)).to(dtype)
    return cfg, {k: v.to(cuda) for k, v in host.items()}, host, x.to(cuda), x


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-3), (torch.bfloat16, 2e-2)],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("changes", [{}, {"moe_pad_multiple": 8},
                                     {"moe_capacity_factor": 0.5}],
                         ids=["granite", "padded", "overflow"])
def test_moe_on_the_card_matches_the_host(cuda, changes, dtype, tol):
    cfg, p, hp, x, hx = _layer(cuda, dtype, **changes)
    y, aux = M.moe(p, cfg, x)
    want, want_aux = M.moe(hp, cfg, hx)
    assert y.is_cuda and y.dtype == dtype
    torch.testing.assert_close(y.cpu().float(), want.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(aux.cpu(), want_aux, rtol=1e-6, atol=1e-6)


def test_moe_on_the_card_is_deterministic(cuda):
    """The combine adds each token's slot outputs in a fixed order with no
    atomics: two calls give the same bits, overflow included."""
    cfg, p, _, x, _ = _layer(cuda, torch.bfloat16, moe_capacity_factor=0.5)
    y1, aux1 = M.moe(p, cfg, x)
    y2, aux2 = M.moe(p, cfg, x)
    assert torch.equal(y1, y2) and torch.equal(aux1, aux2)


def test_moe_prefill_launches_flash_once_per_layer(cuda, monkeypatch):
    """Granite at full width, two layers: the prefill attention of every
    layer through the flash kernel, decode through the plain path, on a
    drop-free copy (capacity factor = expert count) so that prefill and
    decode route alike. fp32 activations, where the paths differ only in
    summation order (in bf16 a router near-tie can route a token to other
    experts on each path)."""
    from repro_torch.models import layers as L

    monkeypatch.setattr(L, "COMPUTE_DTYPE", torch.float32)
    cfg = dataclasses.replace(get_config("granite-moe-3b-a800m"), num_layers=2)
    cfg = dataclasses.replace(cfg, moe_capacity_factor=float(cfg.moe_num_experts))
    model = make_model(cfg)
    params = model.init(0, device=cuda)
    ids = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 24))).to(cuda)
    fa.launches = ssd.launches = 0
    full, _ = model.prefill(params, {"inputs": ids})
    assert fa.launches == cfg.num_layers
    logits, caches = LM.lm_prefill(params, cfg, ids[:, :16], max_len=24)
    for t in range(16, 24):
        logits, caches = model.decode_step(params, ids[:, t:t + 1], caches, t)
    assert fa.launches == 2 * cfg.num_layers and ssd.launches == 0
    torch.testing.assert_close(logits[:, : cfg.vocab_size], full[:, : cfg.vocab_size],
                               rtol=2e-3, atol=2e-3)


def test_moe_loss_and_grads_on_the_card_match_the_host(cuda, monkeypatch):
    """Reduced granite's `lm_loss` with its aux term and every leaf's
    gradient, fp32 activations, card against host from one set of weights."""
    from repro_torch.models import layers as L

    monkeypatch.setattr(L, "COMPUTE_DTYPE", torch.float32)
    cfg = get_config("granite-moe-3b-a800m").reduced()
    card = make_model(cfg).init(0, device=cuda)
    host = tree.map_leaves(lambda t: t.cpu(), card)
    rng = np.random.default_rng(4)
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 65)))

    def loss_and_grads(params, ids):
        live = tree.map_leaves(lambda t: t.detach().requires_grad_(True), params)
        loss = LM.lm_loss(live, cfg, ids[:, :-1], ids[:, 1:], q_chunk=32, loss_chunk=32)
        return loss, torch.autograd.grad(loss, tree.flatten(live))

    loss, grads = loss_and_grads(card, ids.to(cuda))
    want, want_grads = loss_and_grads(host, ids)
    torch.testing.assert_close(loss.cpu(), want, rtol=1e-5, atol=0)
    for got, ref in zip(grads, want_grads):
        err = (got.cpu() - ref).norm() / ref.norm().clamp_min(1e-30)
        assert err <= 1e-4, err
