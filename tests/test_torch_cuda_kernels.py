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
from repro_torch.kernels import ssd_scan as ssd
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
    # ... plus bf16 cases that reach each path of the tensor-core kernel:
    # head dims 16, 32 and 128, causal Sq != Sk, ragged non-causal.
    (1, 4, 2, 256, 256, 16, True, torch.bfloat16),
    (1, 4, 2, 256, 256, 32, True, torch.bfloat16),
    (2, 4, 2, 200, 200, 128, True, torch.bfloat16),
    (1, 2, 2, 128, 256, 64, True, torch.bfloat16),
    (1, 4, 2, 77, 130, 32, False, torch.bfloat16),
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


@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "unaligned"])
def test_bf16_kernel_takes_strided_views(cuda, offset):
    """q, k, v as every other head of wider (B, S, H, D) tensors: 16-byte
    aligned rows go through cp.async, rows shifted by one element through
    ordinary loads."""
    b, h, s, d = 2, 4, 150, 64
    rng = np.random.default_rng(5)

    def view(heads):
        flat = torch.from_numpy(rng.standard_normal(b * s * 2 * heads * d + 1, dtype=np.float32))
        wide = flat.to(cuda, torch.bfloat16)[offset:offset + b * s * 2 * heads * d]
        return wide.view(b, s, 2 * heads, d)[:, :, ::2].transpose(1, 2)

    q, k, v = view(h), view(h // 2), view(h // 2)
    out = fa.flash_attention_cuda(q, k, v, causal=True)
    ref = fa.flash_attention_plain(q.contiguous(), k.contiguous(), v.contiguous(), causal=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.float(), rtol=2e-2, atol=2e-2)


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


# --------------------------------------------------------------------------- #
# SSD scan
# --------------------------------------------------------------------------- #
SSD_CASES = [
    # (b, s, h, g, p, n, chunk, dtype): tests/test_kernels.py's sweep ...
    (1, 128, 4, 1, 32, 32, 32, torch.float32),
    (2, 256, 8, 2, 64, 64, 64, torch.float32),
    (1, 512, 4, 4, 64, 128, 128, torch.float32),
    (1, 256, 4, 1, 64, 128, 256, torch.float32),
    (2, 256, 4, 1, 32, 64, 64, torch.bfloat16),
    # ... plus the two serving waves of mamba2-1.3b (the 128-token wave is
    # padded to one 256-row chunk), two groups, the reduced config's sizes,
    # a chunk that is not a multiple of the 64-row tile, and P = 128.
    (8, 512, 64, 1, 64, 128, 256, torch.bfloat16),
    (4, 256, 64, 1, 64, 128, 256, torch.bfloat16),
    (2, 512, 8, 2, 64, 128, 256, torch.bfloat16),
    (2, 64, 8, 1, 16, 16, 32, torch.bfloat16),
    (1, 200, 4, 2, 32, 64, 100, torch.float32),
    (1, 128, 2, 1, 128, 128, 128, torch.float32),
    # ... plus bf16 cases that reach each path of the tensor-core kernel:
    # P 16 and 128, N = 20 (zero-padded to 32; rows not 16-byte aligned, so
    # ordinary loads), Q = 100, and two groups.
    (1, 128, 4, 1, 16, 64, 64, torch.bfloat16),
    (1, 256, 2, 1, 128, 128, 128, torch.bfloat16),
    (2, 128, 4, 1, 32, 20, 64, torch.bfloat16),
    (1, 200, 4, 2, 32, 64, 100, torch.bfloat16),
    (2, 256, 8, 2, 64, 128, 128, torch.bfloat16),
]


def _ssd_inputs(case, seed, device, initial=False):
    """Seeded inputs with tests/test_kernels.py's scales."""
    b, s, h, g, p, n, _, dtype = case
    rng = np.random.default_rng(seed)

    def make(shape, scale, dt=dtype):
        a = rng.standard_normal(shape, dtype=np.float32) * scale
        return torch.from_numpy(a).to(device, dt)

    x = make((b, s, h, p), 0.5)
    dt_a = -make((b, s, h), 0.3, torch.float32).abs()
    bp, cp = make((b, s, g, n), 0.3), make((b, s, g, n), 0.3)
    init = make((b, h, p, n), 0.2, torch.float32) if initial else None
    return x, dt_a, bp, cp, init


@pytest.mark.parametrize("initial", [False, True], ids=["zero-state", "initial-state"])
@pytest.mark.parametrize("case", SSD_CASES, ids=[str(c[:7]) for c in SSD_CASES])
def test_ssd_kernel_matches_plain(cuda, case, initial):
    x, dt_a, bp, cp, init = _ssd_inputs(case, 0, cuda, initial)
    chunk = case[6]
    y, h = ops.ssd_scan(x, dt_a, bp, cp, chunk=chunk, initial_state=init)
    y_ref, h_ref = ssd.ssd_scan_plain(x, dt_a, bp, cp, chunk=chunk, initial_state=init)
    torch.cuda.synchronize()
    assert y.dtype == x.dtype and y.shape == x.shape
    assert h.dtype == torch.float32 and h.shape == h_ref.shape
    tol = _tol(case[7])
    torch.testing.assert_close(y.float(), y_ref.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(h, h_ref, rtol=tol, atol=tol)


def test_ssd_kernel_initial_state_continuation(cuda):
    """Two halves through the kernel, the state carried, equal one pass."""
    x, dt_a, bp, cp, _ = _ssd_inputs((1, 256, 4, 1, 32, 64, 64, torch.float32), 1, cuda)
    y_full, h_full = ssd.ssd_scan_cuda(x, dt_a, bp, cp, chunk=64)
    y1, h1 = ssd.ssd_scan_cuda(x[:, :128], dt_a[:, :128], bp[:, :128], cp[:, :128], chunk=64)
    y2, h2 = ssd.ssd_scan_cuda(x[:, 128:], dt_a[:, 128:], bp[:, 128:], cp[:, 128:], chunk=64,
                               initial_state=h1)
    torch.testing.assert_close(torch.cat([y1, y2], dim=1), y_full, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(h2, h_full, rtol=1e-4, atol=1e-4)


def test_ssd_kernel_takes_strided_views(cuda):
    """x, B and C as views with a unit last stride but no other contiguity,
    and the state of one period of a stacked cache."""
    x, dt_a, bp, cp, init = _ssd_inputs((2, 128, 4, 1, 32, 32, 64, torch.float32), 2, cuda,
                                        initial=True)
    wide = torch.zeros((2, 128, 8, 32), device=cuda)
    wide[:, :, ::2] = x
    stacked = torch.stack([init, init * 0.5])
    y, h = ssd.ssd_scan_cuda(wide[:, :, ::2], dt_a, bp, cp, chunk=64, initial_state=stacked[1])
    y_ref, h_ref = ssd.ssd_scan_plain(x, dt_a, bp, cp, chunk=64, initial_state=init * 0.5)
    torch.testing.assert_close(y, y_ref, rtol=2e-3, atol=2e-3)
    torch.testing.assert_close(h, h_ref, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "unaligned"])
def test_ssd_bf16_kernel_takes_strided_views(cuda, offset):
    """bf16 x as every other head of a wider tensor and B/C as views into
    one buffer: 16-byte aligned rows go through cp.async, rows shifted by
    one element through ordinary loads."""
    x, dt_a, bp, cp, init = _ssd_inputs((2, 256, 4, 1, 64, 128, 128, torch.bfloat16), 6, cuda,
                                        initial=True)
    wide = torch.zeros(2 * 256 * 8 * 64 + 8, device=cuda, dtype=torch.bfloat16)
    xv = wide[offset:offset + 2 * 256 * 8 * 64].view(2, 256, 8, 64)[:, :, ::2]
    xv.copy_(x)
    both = torch.zeros(2 * 256 * 2 * 128 + 8, device=cuda, dtype=torch.bfloat16)
    bc = both[offset:offset + 2 * 256 * 2 * 128].view(2, 256, 2, 128)
    bc[:, :, 0].copy_(bp[:, :, 0])
    bc[:, :, 1].copy_(cp[:, :, 0])
    y, h = ssd.ssd_scan_cuda(xv, dt_a, bc[:, :, :1], bc[:, :, 1:], chunk=128, initial_state=init)
    y_ref, h_ref = ssd.ssd_scan_plain(x, dt_a, bp, cp, chunk=128, initial_state=init)
    torch.cuda.synchronize()
    torch.testing.assert_close(y.float(), y_ref.float(), rtol=2e-2, atol=2e-2)
    torch.testing.assert_close(h, h_ref, rtol=2e-2, atol=2e-2)


def test_ssd_launch_counter_counts_launches_only(cuda):
    x, dt_a, bp, cp, _ = _ssd_inputs((1, 64, 2, 1, 16, 16, 32, torch.bfloat16), 3, cuda)
    ssd.launches = 0
    ops.ssd_scan(x, dt_a, bp, cp, chunk=32)
    ssd.ssd_scan_cuda(x, dt_a, bp, cp, chunk=32)
    ssd.ssd_scan_plain(x, dt_a, bp, cp, chunk=32)
    with pytest.raises(ValueError):
        ssd.ssd_scan_cuda(x, dt_a, bp, cp, chunk=48)
    assert ssd.launches == 2


def test_ssd_rejects_what_the_kernel_does_not_take(cuda):
    x, dt_a, bp, cp, _ = _ssd_inputs((1, 64, 2, 1, 32, 16, 32, torch.float32), 4, cuda)
    with pytest.raises(ValueError, match="dtype of x"):
        ops.ssd_scan(x.half(), dt_a, bp.half(), cp.half())
    with pytest.raises(ValueError, match="dtype of x"):
        ops.ssd_scan(x, dt_a, bp.bfloat16(), cp)
    with pytest.raises(ValueError, match="dtype of dt_a"):
        ops.ssd_scan(x, dt_a.double(), bp, cp)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ops.ssd_scan(x, dt_a, bp, cp, chunk=48)
    with pytest.raises(ValueError, match="one CUDA device"):
        ops.ssd_scan(x, dt_a.cpu(), bp, cp)
    with pytest.raises(ValueError, match="contiguous"):
        ops.ssd_scan(x.transpose(2, 3).contiguous().transpose(2, 3), dt_a, bp, cp)
    with pytest.raises(ValueError, match="head dim"):
        ops.ssd_scan(x[..., :24], dt_a, bp, cp)


def test_mamba_prefill_launches_once_per_layer_and_decode_never(cuda):
    cfg = dataclasses.replace(get_config("mamba2-1.3b"), num_layers=2)
    model = make_model(cfg)
    params = model.init(0, device=cuda)
    ids = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 24))).to(cuda)
    ssd.launches = 0
    fa.launches = 0
    full, _ = model.prefill(params, {"inputs": ids})
    assert ssd.launches == cfg.num_layers
    logits, caches = LM.lm_prefill(params, cfg, ids[:, :16])
    for t in range(16, 24):
        logits, caches = model.decode_step(params, ids[:, t:t + 1], caches, t)
    assert ssd.launches == 2 * cfg.num_layers and fa.launches == 0
    torch.testing.assert_close(logits[:, : cfg.vocab_size], full[:, : cfg.vocab_size],
                               rtol=0.15, atol=0.15)
