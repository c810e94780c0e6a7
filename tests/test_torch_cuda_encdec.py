"""The port's encoder-decoder (whisper-large-v3) on the card: the driver's
flash launches, the non-causal kernel at the encoder's shape, the card
against the host CPU, and prefill against token-by-token decode.

Every test here needs an NVIDIA GPU and skips without one; the file imports
no JAX, so it runs on a machine that has only PyTorch:

  PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_encdec.py
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
from repro_torch.launch import serve as serve_main
from repro_torch.models import encdec as ED
from repro_torch.models import lm as LM
from repro_torch.models import make_model

pytestmark = pytest.mark.cuda

NAME = "whisper-large-v3"
CROSS_TOL = 1e-4     # card vs host and prefill vs decode, fp32 activations


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture
def fp32_activations(monkeypatch):
    from repro_torch.models import layers as L

    monkeypatch.setattr(L, "COMPUTE_DTYPE", torch.float32)


def test_driver_launches_flash_per_encoder_and_decoder_layer(cuda, capsys):
    """Reduced whisper through the driver on the card: one non-causal flash
    launch per encoder layer and one causal per decoder layer (the prompt),
    none in decode or cross-attention, no scan; token ids in range."""
    cfg = get_config(NAME).reduced()
    fa.launches = ssd.launches = 0
    out = serve_main.main(["--arch", NAME, "--store", "sims3://w?latency_ms=0",
                           "--batch", "2", "--prompt-len", "100", "--gen", "4"])
    assert (fa.launches, ssd.launches) == (cfg.enc_layers + cfg.num_layers, 0)
    assert out.shape == (2, 4) and out.min() >= 0 and out.max() < cfg.vocab_size
    assert "2 prompts of 8 tokens" in capsys.readouterr().out


# Elementwise limits as in tests/test_kernels.py, and |out - ref| / |ref| in
# L2 norms: over 1500 keys an output is about 0.04 in size, and an unmasked
# ragged tail would shift it by about 1.5%, which only the second one sees.
KERNEL_TOL = {torch.float32: (2e-3, 1e-5), torch.bfloat16: (2e-2, 5e-3)}


def _hold_kernel(cuda, s: int, causal: bool, dtype: torch.dtype) -> None:
    g = torch.Generator(device=cuda)
    g.manual_seed(0)
    q, k, v = (torch.randn((8, s, 20, 64), generator=g, device=cuda).to(dtype)
               .transpose(1, 2) for _ in range(3))
    out = fa.flash_attention_cuda(q, k, v, causal=causal)
    ref = fa.flash_attention_plain(q, k, v, causal=causal)
    assert out.dtype == dtype and out.shape == q.shape
    tol, rel_tol = KERNEL_TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
    rel = ((out.float() - ref.float()).norm() / ref.float().norm()).item()
    assert rel <= rel_tol, rel


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_kernel_at_the_encoder_shape(cuda, dtype):
    """(8, 20, 1500, 64) unmasked: the last k tile holds 28 of 64 columns."""
    _hold_kernel(cuda, 1500, False, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_kernel_at_the_prompt_shape(cuda, dtype):
    """(8, 20, 8, 64) causal: the decoder's prompt, one partial 64-row tile."""
    _hold_kernel(cuda, 8, True, dtype)


def _two_layers(cuda):
    """Full-width whisper cut to 2 encoder and 2 decoder layers; one set of
    weights on the card and copied to the host."""
    cfg = dataclasses.replace(get_config(NAME), num_layers=2, enc_layers=2)
    card = make_model(cfg).init(0, device=cuda)
    return cfg, card, tree.map_leaves(lambda t: t.cpu(), card)


def _inputs(cfg, b: int, frames: int, tokens: int, seed: int):
    rng = np.random.default_rng(seed)
    enc = torch.from_numpy(rng.standard_normal((b, frames, cfg.d_model), dtype=np.float32))
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, tokens)))
    return enc.to(torch.bfloat16), ids


def _close(got: torch.Tensor, want: torch.Tensor, tol: float = CROSS_TOL) -> None:
    torch.testing.assert_close(got.cpu().float(), want.float(), rtol=tol, atol=tol)


def test_two_layers_on_the_card_match_the_host(cuda, fp32_activations):
    """Encoder states, prefill logits and 4 decode steps, card (flash for the
    encoder and the prompt) against host (plain), fp32 activations."""
    cfg, card, host = _two_layers(cuda)
    enc, ids = _inputs(cfg, 2, 300, 12, seed=1)
    with torch.no_grad():
        _close(ED.encode(card, cfg, enc.to(cuda)), ED.encode(host, cfg, enc))
        lc, cc = ED.encdec_prefill(card, cfg, enc.to(cuda), ids[:, :8].to(cuda), max_len=12)
        lh, ch = ED.encdec_prefill(host, cfg, enc, ids[:, :8], max_len=12)
        _close(lc, lh)
        for t in range(8, 12):
            lc, cc = ED.encdec_decode_step(card, cfg, ids[:, t:t + 1].to(cuda), cc, t)
            lh, ch = ED.encdec_decode_step(host, cfg, ids[:, t:t + 1], ch, t)
            _close(lc, lh)


def test_two_layers_loss_and_grads_on_the_card_match_the_host(cuda, fp32_activations):
    """`encdec_loss` and every leaf's gradient (the plain paths on both
    sides), fp32 activations; the k biases' gradients, zero but for
    rounding, against 1e-3 of the largest leaf gradient's norm."""
    cfg, card, host = _two_layers(cuda)
    enc, ids = _inputs(cfg, 2, 128, 17, seed=2)

    def loss_and_grads(params, device):
        live = tree.map_leaves(lambda t: t.detach().requires_grad_(True), params)
        loss = ED.encdec_loss(live, cfg, enc.to(device), ids[:, :-1].to(device),
                              ids[:, 1:].to(device), q_chunk=64, loss_chunk=16)
        return loss, torch.autograd.grad(loss, tree.flatten(live))

    fa.launches = 0
    loss, grads = loss_and_grads(card, cuda)
    assert fa.launches == 0
    want, want_grads = loss_and_grads(host, "cpu")
    torch.testing.assert_close(loss.cpu(), want, rtol=1e-5, atol=0)
    largest = max(g.norm() for g in want_grads)
    for got, ref in zip(grads, want_grads):
        err = (got.cpu() - ref).norm() / torch.maximum(ref.norm(), 1e-3 * largest)
        assert err <= CROSS_TOL, err


def test_prefill_matches_decode_on_the_card(cuda, fp32_activations):
    """Teacher-forced `decode_train` logits against an 8-token prefill and
    token-by-token decode steps over the self and cross caches, fp32
    activations, on the card alone."""
    cfg, card, _ = _two_layers(cuda)
    enc, ids = _inputs(cfg, 2, 1500, 16, seed=3)
    enc, ids = enc.to(cuda), ids.to(cuda)
    with torch.no_grad():
        h = ED.decode_train(card, cfg, ED.encode(card, cfg, enc), ids)
        ref = LM.logits_from_hidden(card, cfg, h)
        logits, caches = ED.encdec_prefill(card, cfg, enc, ids[:, :8], max_len=16)
        _close(logits, ref[:, 7].cpu())
        for t in range(8, 16):
            logits, caches = ED.encdec_decode_step(card, cfg, ids[:, t:t + 1], caches, t)
            _close(logits, ref[:, t].cpu())
