"""The port's int8 weight-only serving on the card: quantization and
dequantization against the host CPU bit for bit, a 2-layer full-width
codeqwen1.5-7b with int8 weights against the host, the driver's --quant
int8 on the card, and the flash kernel at head dim 128 (codeqwen's 32/32
heads of 128) against its plain version at codeqwen's two wave shapes.

Every test here needs an NVIDIA GPU and skips without one; the file imports
no JAX, so it runs on a machine that has only PyTorch:

  PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_quant.py
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import tree
from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.launch import serve as serve_main
from repro_torch.models import lm as LM
from repro_torch.models import make_model
from repro_torch.models.quant import quantize_array, quantize_params

pytestmark = pytest.mark.cuda

NAME = "codeqwen1.5-7b"
CROSS_TOL = 1e-4     # card vs host, fp32 activations (tests/test_torch_cuda_encdec.py)
# codeqwen's prefill waves (8 prompts of 512, 4 of 128), bf16, and its fp32
# card-vs-host shape: (b, hq, hkv, sq, sk, d, dtype), causal.
WAVES = [(8, 32, 32, 512, 512, 128, torch.bfloat16),
         (4, 32, 32, 128, 128, 128, torch.bfloat16),
         (2, 32, 32, 128, 128, 128, torch.float32)]
# tests/test_kernels.py's limits (rtol = atol), and chip_smoke.py's relative
# L2 limit over the whole output.
TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-3}
REL_TOL = {torch.bfloat16: 5e-3, torch.float32: 1e-5}


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


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.detach().cpu().contiguous().reshape(-1).view(torch.uint8)


def _weight(shape, seed: int) -> torch.Tensor:
    w = np.random.default_rng(seed).standard_normal(shape, dtype=np.float32) * 0.02
    w[..., 5] = 0.0                  # an all-zero output channel
    return torch.from_numpy(w)


@pytest.mark.parametrize("shape", [(4096, 1344), (4, 512, 13440 // 8), (2, 32, 128, 512)],
                         ids=str)
def test_quantization_on_the_card_equals_the_host(cuda, shape):
    """q and scale bit for bit, and the dequantized weight in bf16 and fp32:
    one fp32 true division and one rounding on each side."""
    w = _weight(shape, 0)
    card, host = quantize_array(w.to(cuda)), quantize_array(w)
    assert card.q.is_cuda and card.q.dtype == torch.int8
    assert torch.equal(_bits(card.q), _bits(host.q))
    assert torch.equal(_bits(card.scale), _bits(host.scale))
    for dtype in (torch.bfloat16, torch.float32):
        assert torch.equal(_bits(card.to(dtype)), _bits(host.to(dtype)))


def test_two_layer_codeqwen_int8_card_vs_host(cuda, fp32_activations):
    """codeqwen1.5-7b at full width cut to 2 layers, one set of weights
    quantized on the card and copied to the host: prefill logits of 2
    prompts of 64 (flash at D = 128 on the card, the plain version on the
    host) and 4 decode steps within CROSS_TOL."""
    cfg = dataclasses.replace(get_config(NAME), num_layers=2)
    q_card, n = quantize_params(make_model(cfg).init(0, device=cuda))
    q_host = tree.map_leaves(lambda t: t.cpu(), q_card)
    assert n == 10
    ids = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 68)))
    v = cfg.vocab_size

    def run(params, device):
        x = ids.to(device)
        with torch.no_grad():
            logits, caches = LM.lm_prefill(params, cfg, x[:, :64], max_len=68)
            out = [logits[:, :v]]
            for t in range(64, 68):
                logits, caches = LM.lm_decode_step(params, cfg, x[:, t:t + 1], caches, t)
                out.append(logits[:, :v])
        return torch.stack(out, dim=1).cpu()

    fa.launches = 0
    got = run(q_card, cuda)
    assert fa.launches == cfg.num_layers
    want = run(q_host, "cpu")
    torch.testing.assert_close(got, want, rtol=CROSS_TOL, atol=CROSS_TOL)


def test_driver_serves_int8_through_the_flash_kernel(cuda, capsys):
    """Reduced codeqwen through the driver with --quant int8 on the card:
    the reference's 10 quantized tensors, one flash launch per layer, no
    scan, token ids in range."""
    cfg = get_config(NAME).reduced()
    fa.launches = ssd.launches = 0
    out = serve_main.main(["--arch", NAME, "--quant", "int8", "--store",
                           "sims3://cq?latency_ms=0", "--batch", "2", "--prompt-len", "64",
                           "--gen", "4"])
    assert (fa.launches, ssd.launches) == (cfg.num_layers, 0)
    assert out.shape == (2, 4) and out.min() >= 0 and out.max() < cfg.vocab_size
    assert "quantized 10 weight tensors to int8 (weight-only)" in capsys.readouterr().out


@pytest.mark.parametrize("case", WAVES, ids=[str(c) for c in WAVES])
def test_flash_head_dim_128_matches_plain_at_codeqwen_waves(cuda, case):
    b, hq, hkv, sq, sk, d, dtype = case
    rng = np.random.default_rng(2)

    def make(h, s):  # (B, H, S, D) views of (B, S, H, D) tensors, the model's layout
        x = rng.standard_normal((b, s, h, d), dtype=np.float32)
        return torch.from_numpy(x).to(cuda, dtype).transpose(1, 2)

    q, k, v = make(hq, sq), make(hkv, sk), make(hkv, sk)
    before = fa.launches
    out = ops.flash_attention(q, k, v, causal=True)
    ref = fa.flash_attention_plain(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    err = (out.float() - ref.float()).abs()
    tol = TOL[dtype]
    assert bool((err <= tol + tol * ref.float().abs()).all()), err.max().item()
    assert (err.norm() / ref.float().norm()).item() <= REL_TOL[dtype]
