"""Training on the card: the forward-only kernels refuse inputs that need a
gradient, training at the reduced configs' head dim 16 (which the flash
training kernels do not compile) launches neither kernel while serving
still does, a
train step on the card matches the same step on the host CPU, and the
device feeder's copies on its side stream are ordered before the
consumer's use of each batch.

Every test here needs an NVIDIA GPU and skips without one; the file imports
no JAX, so it runs on a machine that has only PyTorch:

  PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_train.py
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch import tree
from repro_torch.configs import get_config
from repro_torch.data import DeviceFeeder
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.models import layers as L
from repro_torch.models import lm as LM
from repro_torch.models import make_model
from repro_torch.train import AdamWConfig, StepConfig, build_train_step, init_train_state

pytestmark = pytest.mark.cuda

OPT = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def test_kernels_refuse_inputs_that_require_grad(cuda):
    g = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn((1, 2, 64, 32), generator=g, device=cuda, dtype=torch.bfloat16)
    k, v = torch.randn_like(q), torch.randn_like(q)
    x = torch.randn((1, 64, 2, 32), generator=g, device=cuda, dtype=torch.bfloat16)
    dt_a = -torch.rand((1, 64, 2), generator=g, device=cuda)
    b = torch.randn((1, 64, 1, 32), generator=g, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match="forward only"):
        ops.flash_attention(q, k.requires_grad_(), v)
    with pytest.raises(RuntimeError, match="forward only"):
        ops.ssd_scan(x, dt_a.requires_grad_(), b, b, chunk=64)
    before = (fa.launches, ssd.launches)
    with torch.no_grad():
        ops.flash_attention(q, k, v)
        ops.ssd_scan(x, dt_a, b, b, chunk=64)
    assert (fa.launches, ssd.launches) == (before[0] + 1, before[1] + 1)


@pytest.mark.parametrize("arch,kernel", [("smollm-135m", fa), ("mamba2-1.3b", ssd)])
def test_training_launches_no_kernel_and_serving_still_does(cuda, arch, kernel):
    cfg = get_config(arch).reduced()
    model = make_model(cfg)
    params = model.init(0, device=cuda)
    ids = torch.randint(0, cfg.vocab_size, (2, 65), device=cuda,
                        generator=torch.Generator(device=cuda).manual_seed(1))
    live = tree.map_leaves(lambda p: p.detach().requires_grad_(True), params)
    fa.launches = ssd.launches = 0
    loss = model.loss(live, {"inputs": ids[:, :-1], "labels": ids[:, 1:]},
                      q_chunk=32, loss_chunk=32)
    grads = torch.autograd.grad(loss, tree.flatten(live))
    torch.cuda.synchronize()
    assert (fa.launches, ssd.launches) == (0, 0)
    assert bool(torch.isfinite(loss))
    # No gradient was cut off at a kernel's output: every leaf has one.
    for g in grads:
        assert bool(torch.isfinite(g).all()) and bool((g != 0).any())
    with torch.no_grad():
        LM.lm_prefill(live, cfg, ids)
    assert kernel.launches == cfg.num_layers


@pytest.mark.parametrize("arch", ["smollm-135m", "mamba2-1.3b"])
def test_train_steps_on_the_card_match_the_host(cuda, monkeypatch, arch):
    """Two steps from the same parameters and batches, in fp32 activations:
    loss and grad_norm to 1e-4 relative, parameters to 1e-4 absolute
    (cuBLAS and the CPU sum in different orders)."""
    monkeypatch.setattr(L, "COMPUTE_DTYPE", torch.float32)
    cfg = get_config(arch).reduced()
    model = make_model(cfg)
    host = init_train_state(model, 0, device="cpu")
    card = tree.map_leaves(lambda t: t.to(cuda), host)
    step = build_train_step(model, OPT, StepConfig(q_chunk=32, loss_chunk=32))
    rng = np.random.default_rng(2)
    for _ in range(2):
        ids = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 65)))
        host, mh = step(host, {"inputs": ids[:, :-1], "labels": ids[:, 1:]})
        ids = ids.to(cuda)
        card, mc = step(card, {"inputs": ids[:, :-1], "labels": ids[:, 1:]})
        for key in ("loss", "grad_norm", "lr"):
            assert float(mc[key]) == pytest.approx(float(mh[key]), rel=1e-4), key
    for a, b in zip(tree.flatten(host.params), tree.flatten(card.params)):
        torch.testing.assert_close(b.cpu(), a, rtol=0, atol=1e-4)


def test_feeder_orders_copies_before_the_consumers_use(cuda):
    """Batches copied on the side stream while the consumer's stream is
    busy arrive intact: every batch's device sum equals its host sum."""
    rng = np.random.default_rng(3)
    host = [rng.integers(0, 1000, (4, 1 << 18), dtype=np.int64).astype(np.int32)
            for _ in range(12)]
    busy = torch.randn((2048, 2048), device=cuda)
    feeder = DeviceFeeder(iter([(h, {"i": i}) for i, h in enumerate(host)]), depth=2,
                          device=cuda)
    sums = []
    try:
        for x, meta in feeder:
            busy = busy @ busy / 2048      # keep the consumer's stream occupied
            assert x.is_cuda and x.dtype == torch.int32
            sums.append((meta["i"], x.long().sum()))
    finally:
        feeder.close()
    assert [i for i, _ in sums] == list(range(12))
    for i, s in sums:
        assert int(s) == int(host[i].astype(np.int64).sum())
