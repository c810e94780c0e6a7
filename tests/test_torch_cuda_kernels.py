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

from repro_torch import tree
from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.models import layers as L
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
# Flash attention for training: the forward with lse, and the backward
# --------------------------------------------------------------------------- #
TRAIN_CASES = [
    # (b, hq, hkv, sq, sk, d, causal): olmo-1b's heads at its context, causal;
    # smollm-135m's GQA (groups of 3) at D 64; whisper-large-v3's encoder,
    # unmasked, whose last 64-row tile holds 28 rows; and its decoder's
    # cross-attention, 448 queries against 1,500 frames.
    (2, 16, 16, 2048, 2048, 128, True),
    (2, 9, 3, 512, 512, 64, True),
    (2, 20, 20, 1500, 1500, 64, False),
    (2, 20, 20, 448, 1500, 64, False),
]
# bf16 has 8 significant bits (relative rounding up to 2^-9 = 1.95e-3): the
# kernels round q, k, v and dO as the inputs are, and P and dS before their
# products, and the outputs once. Each result is held to the plain version
# in fp32 on the same bf16 inputs (autograd's exact gradient of them) by a
# relative L2 error of 1e-2, five roundings' worth, and elementwise to
# 2e-2 of the tensor's largest value (the bf16 limit of the forward's
# tests). The log-sum-exp is fp32 throughout, so 1e-4 absolute.
TRAIN_REL, TRAIN_ELEM, LSE_TOL = 1e-2, 2e-2, 1e-4


def _train_inputs(case, seed, device):
    q, k, v = _inputs((*case, torch.bfloat16), seed, device)
    rng = np.random.default_rng(seed + 1)
    dout = torch.from_numpy(rng.standard_normal(q.shape, dtype=np.float32)).to(device, q.dtype)
    return q, k, v, dout


def _plain_train(q, k, v, dout, causal):
    """The plain version's output, lse and gradients in fp32 on the card."""
    q32, k32, v32 = (t.float().requires_grad_() for t in (q, k, v))
    out = fa.flash_attention_plain(q32, k32, v32, causal=causal)
    out.backward(dout.float())
    g = q.shape[1] // k.shape[1]
    s = q.float() @ k.float().repeat_interleave(g, 1).transpose(-1, -2) * q.shape[-1] ** -0.5
    if causal:
        s = s.masked_fill(torch.ones_like(s, dtype=torch.bool).triu(1), float("-inf"))
    return out.detach(), torch.logsumexp(s, dim=-1), q32.grad, k32.grad, v32.grad


def _close_rel(got, want, what):
    got, want = got.float(), want.float()
    rel = ((got - want).norm() / want.norm()).item()
    worst = (got - want).abs().max().item()
    assert rel <= TRAIN_REL, f"{what}: relative L2 error {rel:.3e}"
    assert worst <= TRAIN_ELEM * want.abs().max().item(), f"{what}: max |diff| {worst:.3e}"


@pytest.mark.parametrize("case", TRAIN_CASES, ids=[str(c) for c in TRAIN_CASES])
def test_train_kernels_match_plain_autograd(cuda, case):
    causal = case[6]
    q, k, v, dout = _train_inputs(case, 20, cuda)
    o, lse = fa.flash_attention_train_fwd_cuda(q, k, v, causal=causal)
    dq, dk, dv = fa.flash_attention_train_bwd_cuda(q, k, v, o, lse, dout, causal=causal)
    want_o, want_lse, want_dq, want_dk, want_dv = _plain_train(q, k, v, dout, causal)
    torch.cuda.synchronize()
    sq = q.shape[2]
    assert lse.shape == (q.shape[0], q.shape[1], -(-sq // 64) * 64)
    assert bool(torch.isinf(lse[..., sq:]).all())
    torch.testing.assert_close(lse[..., :sq], want_lse, rtol=0, atol=LSE_TOL)
    for what, got, want in (("o", o, want_o), ("dq", dq, want_dq), ("dk", dk, want_dk),
                            ("dv", dv, want_dv)):
        assert got.dtype == torch.bfloat16 and got.shape == want.shape, what
        _close_rel(got, want, what)


def test_train_entry_under_autograd_matches_the_kernels(cuda):
    """`ops.flash_attention_train` on CUDA tensors is the autograd function
    of the two launches: its output and q/k/v gradients are the kernels'
    own, bit for bit."""
    q, k, v, dout = _train_inputs((2, 9, 3, 200, 200, 64, True), 21, cuda)
    o, lse = fa.flash_attention_train_fwd_cuda(q, k, v)
    want = (o, *fa.flash_attention_train_bwd_cuda(q, k, v, o, lse, dout))
    live = [t.detach().requires_grad_() for t in (q, k, v)]
    out = ops.flash_attention_train(*live)
    out.backward(dout)
    for got, ref in zip((out, *(t.grad for t in live)), want):
        assert torch.equal(got, ref)


def test_train_backward_is_deterministic(cuda):
    """No atomics: two backward calls give the same bits."""
    q, k, v, dout = _train_inputs((2, 9, 3, 512, 512, 64, True), 22, cuda)
    o, lse = fa.flash_attention_train_fwd_cuda(q, k, v)
    first = fa.flash_attention_train_bwd_cuda(q, k, v, o, lse, dout)
    second = fa.flash_attention_train_bwd_cuda(q, k, v, o, lse, dout)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_train_launch_counters_count_launches_only(cuda):
    q, k, v, dout = _train_inputs((1, 2, 2, 64, 64, 64, True), 23, cuda)
    fa.launches = fa.backward_launches = 0
    live = [t.detach().requires_grad_() for t in (q, k, v)]
    ops.flash_attention_train(*live).backward(dout)
    o, lse = fa.flash_attention_train_fwd_cuda(q, k, v)
    fa.flash_attention_train_bwd_cuda(q, k, v, o, lse, dout)
    fa.flash_attention_plain(*live).backward(dout)
    ops.flash_attention_train(*(t.cpu().requires_grad_() for t in (q, k, v)))
    assert (fa.launches, fa.backward_launches) == (2, 2)


def test_serving_forward_is_bit_equal_to_the_training_forward(cuda):
    """The serving call (no lse) and the training forward run one kernel
    template: writing lse leaves the output's bits as they were."""
    for case in ((8, 16, 16, 512, 512, 128, True), (2, 20, 20, 1500, 1500, 64, False)):
        q, k, v = _inputs((*case, torch.bfloat16), 24, cuda)
        served = fa.flash_attention_cuda(q, k, v, causal=case[6])
        trained, _ = fa.flash_attention_train_fwd_cuda(q, k, v, causal=case[6])
        assert torch.equal(served, trained)


def test_train_rejects_what_the_kernels_do_not_take(cuda):
    q, k, v = _inputs((1, 2, 2, 64, 64, 64, True, torch.float32), 25, cuda)
    with pytest.raises(ValueError, match="dtype"):
        ops.flash_attention_train(q, k, v)
    q, k, v = (t.bfloat16() for t in (q, k, v))
    with pytest.raises(ValueError, match="head dim"):
        ops.flash_attention_train(q[..., :32], k[..., :32], v[..., :32])
    with pytest.raises(ValueError, match="one CUDA device"):
        ops.flash_attention_train(q, k.cpu(), v)


def test_olmo_train_step_launches_two_forwards_and_one_backward_a_layer(cuda, monkeypatch):
    """Full-width olmo-1b cut to 2 layers, bf16 activations, remat: a
    layer's attention runs its forward kernel twice (the forward and the
    period's recompute) and its backward once. Its loss and each leaf's
    gradient norm are those of the plain path (the kernel's P and dS in
    bf16 against the plain path's fp32): the loss to 1e-3 relative, each
    leaf's gradient norm to 1e-2 relative."""
    cfg = dataclasses.replace(get_config("olmo-1b"), num_layers=2)
    model = make_model(cfg)
    params = model.init(0, device=cuda)
    rng = np.random.default_rng(26)
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 1025))).to(cuda)

    def loss_and_norms():
        live = tree.map_leaves(lambda t: t.detach().requires_grad_(True), params)
        loss = model.loss(live, {"inputs": ids[:, :-1], "labels": ids[:, 1:]}, remat=True)
        grads = torch.autograd.grad(loss, tree.flatten(live))
        return loss.item(), [g.float().norm().item() for g in grads]

    fa.launches = fa.backward_launches = 0
    loss, norms = loss_and_norms()
    assert (fa.launches, fa.backward_launches) == (2 * cfg.num_layers, cfg.num_layers)
    monkeypatch.setattr(L, "trains_through_flash", lambda *a, **kw: False)
    want_loss, want_norms = loss_and_norms()
    assert (fa.launches, fa.backward_launches) == (2 * cfg.num_layers, cfg.num_layers)
    assert loss == pytest.approx(want_loss, rel=1e-3)
    for got, want in zip(norms, want_norms):
        assert got == pytest.approx(want, rel=1e-2)


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
