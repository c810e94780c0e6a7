"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs an NVIDIA GPU and skips without one; the file imports
no JAX, so it runs on a machine that has only PyTorch:

  PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_kernels.py
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.models import lm as LM
from repro_torch.models import make_model

pytestmark = pytest.mark.cuda

CASES = [
    # (b, hq, hkv, sq, sk, d, causal, dtype): tests/test_kernels.py's sweep ...
    (1, 4, 4, 256, 256, 64, True, torch.float32),
    (2, 8, 2, 256, 256, 128, True, torch.float32),
    (1, 8, 1, 128, 128, 64, True, torch.float32),
    (1, 4, 4, 128, 384, 64, False, torch.float32),
    (2, 4, 2, 256, 256, 64, True, torch.bfloat16),
    (1, 2, 2, 512, 512, 128, True, torch.bfloat16),
    (1, 4, 4, 128, 128, 32, False, torch.float32),
    # ... plus top-left causal with Sq != Sk, ragged lengths, head dim 16.
    (1, 2, 2, 128, 256, 64, True, torch.float32),
    (2, 9, 3, 200, 200, 64, True, torch.bfloat16),
    (1, 4, 2, 77, 130, 32, False, torch.float32),
    (2, 3, 1, 12, 12, 16, True, torch.bfloat16),
]


def _tol(dtype):
    return 2e-2 if dtype == torch.bfloat16 else 2e-3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(case, seed, device):
    b, hq, hkv, sq, sk, d, _, dtype = case
    rng = np.random.default_rng(seed)

    def make(h, s):  # (B, H, S, D) views of (B, S, H, D) tensors
        x = rng.standard_normal((b, s, h, d), dtype=np.float32)
        return torch.from_numpy(x).to(device, dtype).transpose(1, 2)

    return make(hq, sq), make(hkv, sk), make(hkv, sk)


@pytest.mark.parametrize("case", CASES, ids=[str(c[:7]) for c in CASES])
def test_kernel_matches_plain(cuda, case):
    q, k, v = _inputs(case, 0, cuda)
    causal, dtype = case[6], case[7]
    out = ops.flash_attention(q, k, v, causal=causal)
    ref = fa.flash_attention_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == q.shape
    tol = _tol(dtype)
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)


def test_causal_rows_see_only_their_prefix(cuda):
    """Uniform scores and v = position: causal row i averages 0..i = i/2."""
    sq = 256
    q = torch.ones((1, 1, sq, 64), device=cuda)
    k = torch.zeros((1, 1, sq, 64), device=cuda)
    v = torch.arange(sq, dtype=torch.float32, device=cuda)[None, None, :, None].expand(
        1, 1, sq, 64).contiguous()
    out = fa.flash_attention_cuda(q, k, v, causal=True)
    want = torch.arange(sq, dtype=torch.float32, device=cuda) / 2
    torch.testing.assert_close(out[0, 0, :, 0], want, rtol=1e-4, atol=1e-4)


def test_launch_counter_counts_launches_only(cuda):
    q, k, v = _inputs((1, 2, 2, 64, 64, 64, True, torch.bfloat16), 1, cuda)
    fa.launches = 0
    ops.flash_attention(q, k, v)
    fa.flash_attention_cuda(q, k, v)
    fa.flash_attention_plain(q, k, v)
    assert fa.launches == 2


def test_rejects_what_the_kernel_does_not_take(cuda):
    q, k, v = _inputs((1, 2, 2, 64, 64, 64, True, torch.float32), 2, cuda)
    with pytest.raises(ValueError, match="dtype"):
        ops.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="head dim"):
        ops.flash_attention(q[..., :48], k[..., :48], v[..., :48])
    with pytest.raises(ValueError, match="contiguous"):
        ops.flash_attention(q.transpose(2, 3), k.transpose(2, 3), v.transpose(2, 3))
    with pytest.raises(ValueError, match="one CUDA device"):
        ops.flash_attention(q, k.cpu(), v)
    with pytest.raises(ValueError, match="tile"):
        ops.flash_attention(q, k, v, block_q=128)


def test_prefill_launches_once_per_layer_and_decode_never(cuda):
    cfg = dataclasses.replace(get_config("smollm-135m"), num_layers=2)
    model = make_model(cfg)
    params = model.init(0, device=cuda)
    ids = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 24))).to(cuda)
    fa.launches = 0
    full, _ = model.prefill(params, {"inputs": ids})
    assert fa.launches == cfg.num_layers
    logits, caches = LM.lm_prefill(params, cfg, ids[:, :16], max_len=24)
    for t in range(16, 24):
        logits, caches = model.decode_step(params, ids[:, t:t + 1], caches, t)
    assert fa.launches == 2 * cfg.num_layers
    torch.testing.assert_close(logits[:, : cfg.vocab_size], full[:, : cfg.vocab_size],
                               rtol=0.15, atol=0.15)
