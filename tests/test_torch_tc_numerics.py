"""The bf16 tensor-core kernels' rounding scheme, emulated on the CPU.

The bf16 kernels in ``kernels/csrc/`` take their products on the tensor
cores: bf16 operands, fp32 sums. Against the plain versions (fp32 products
of the same bf16 inputs) they round in exactly these places, and nowhere
else:

* flash attention: P, the probabilities of each 64-column kv tile taken
  against the running max, rounded to bf16 before P V;
* the SSD scan: the masked, decayed scores before S X; the bf16 copy of the
  entering state in C h^T; and B exp(acs_last - acs) in the state update.

The emulations below make those roundings in plain PyTorch and are held to
the card tests' bf16 tolerance (rtol = atol = 2e-2) against
`flash_attention_plain` and `ssd_scan_plain`, over the card tests' bf16
shapes (batch or heads cut where CPU time demands). They settle the scheme
without a card; the kernels themselves are checked against the plain
versions on the card by tests/test_torch_cuda_kernels.py.
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ssd_scan as ssd

TOL = 2e-2       # bf16, tests/test_kernels.py
BLOCK = 64       # the kernels' kv / key tile
NEG_INF = -1e30


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def _exact(x: torch.Tensor) -> torch.Tensor:
    return x


def flash_emulated(q, k, v, *, causal: bool, rnd=_bf16) -> torch.Tensor:
    """The bf16 flash kernel's arithmetic: fp32 scores in the base-2
    domain, an online softmax over 64-column tiles, P rounded by `rnd`
    against the running max, fp32 row sums of the unrounded P, O / l."""
    b, hq, sq, d = q.shape
    sk, group = k.shape[2], hq // k.shape[1]
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    x = torch.matmul(q.float(), kf.transpose(-1, -2)) * (d ** -0.5 * math.log2(math.e))
    if causal:
        rows = torch.arange(sq)[:, None]
        cols = torch.arange(sk)[None, :]
        x = x.masked_fill(cols > rows, NEG_INF)
    m = torch.full((b, hq, sq, 1), NEG_INF)
    l = torch.zeros((b, hq, sq, 1))
    o = torch.zeros((b, hq, sq, d))
    for c0 in range(0, sk, BLOCK):
        xt = x[..., c0:c0 + BLOCK]
        m_new = torch.maximum(m, xt.amax(-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(xt - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        o = o * alpha + torch.matmul(rnd(p), vf[..., c0:c0 + BLOCK, :])
        m = m_new
    return (o / torch.where(l == 0, 1.0, l)).to(q.dtype)


def ssd_emulated(x, dt_a, b_proj, c_proj, *, chunk: int, initial_state=None, rnd=_bf16):
    """The bf16 scan kernel's arithmetic, chunk by chunk: fp32 products of
    the bf16 inputs, the state carried in fp32, and the three roundings
    (by `rnd`)."""
    bsz, s, h, p = x.shape
    g, n = b_proj.shape[2], b_proj.shape[3]
    rep = h // g
    xf = x.float()
    bh = b_proj.float().repeat_interleave(rep, dim=2)          # (B, S, H, N)
    ch = c_proj.float().repeat_interleave(rep, dim=2)
    state = (torch.zeros((bsz, h, p, n)) if initial_state is None
             else initial_state.float().clone())
    ys = []
    mask = torch.ones(chunk, chunk, dtype=torch.bool).tril()
    for c0 in range(0, s, chunk):
        sl = slice(c0, c0 + chunk)
        acs = torch.cumsum(dt_a[:, sl].float(), dim=1).permute(0, 2, 1)   # (B, H, Q)
        xc = xf[:, sl].permute(0, 2, 1, 3)                                 # (B, H, Q, P)
        bc = bh[:, sl].permute(0, 2, 1, 3)                                 # (B, H, Q, N)
        cc = ch[:, sl].permute(0, 2, 1, 3)
        scores = torch.matmul(cc, bc.transpose(-1, -2))
        decay = torch.exp(acs[..., :, None] - acs[..., None, :])
        scores = torch.where(mask, scores * decay, torch.zeros(()))
        y = torch.matmul(rnd(scores), xc)
        y = y + torch.matmul(cc, rnd(state).transpose(-1, -2)) * torch.exp(acs)[..., None]
        dec = torch.exp(acs[..., -1:] - acs)                              # (B, H, Q)
        state = state * torch.exp(acs[..., -1])[..., None, None] + torch.matmul(
            xc.transpose(-1, -2), rnd(bc * dec[..., None]))
        ys.append(y.permute(0, 2, 1, 3))
    return torch.cat(ys, dim=1).to(x.dtype), state


FLASH_CASES = [
    # (b, hq, hkv, sq, sk, d, causal): the card tests' bf16 cases ...
    (2, 4, 2, 256, 256, 64, True),
    (1, 2, 2, 512, 512, 128, True),
    (2, 9, 3, 200, 200, 64, True),
    (2, 3, 1, 12, 12, 16, True),
    (1, 4, 2, 256, 256, 16, True),
    (1, 4, 2, 256, 256, 32, True),
    (1, 2, 2, 128, 256, 64, True),
    (1, 4, 2, 77, 130, 32, False),
    # ... and the serving wave shapes, batch cut to 1.
    (1, 9, 3, 128, 128, 64, True),
    (1, 9, 3, 512, 512, 64, True),
]

SSD_CASES = [
    # (b, s, h, g, p, n, chunk): the card tests' bf16 cases, the serving
    # shapes with batch and heads cut ...
    (2, 256, 4, 1, 32, 64, 64),
    (1, 512, 4, 1, 64, 128, 256),
    (1, 256, 4, 1, 64, 128, 256),
    (1, 512, 4, 2, 64, 128, 256),
    (2, 64, 8, 1, 16, 16, 32),
    # ... and the new code paths: P 16 and 128, N = 20, Q = 100, G = 2.
    (1, 128, 4, 1, 16, 64, 64),
    (1, 256, 2, 1, 128, 128, 128),
    (2, 128, 4, 1, 32, 20, 64),
    (1, 200, 4, 2, 32, 64, 100),
    (2, 256, 8, 2, 64, 128, 128),
]


def _flash_inputs(case, seed):
    b, hq, hkv, sq, sk, d, _ = case
    rng = np.random.default_rng(seed)

    def make(hh, ss):
        return torch.from_numpy(rng.standard_normal((b, hh, ss, d), dtype=np.float32)).bfloat16()

    return make(hq, sq), make(hkv, sk), make(hkv, sk)


def _ssd_inputs(case, seed, initial):
    b, s, h, g, p, n, _ = case
    rng = np.random.default_rng(seed)

    def make(shape, scale):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32) * scale)

    x = make((b, s, h, p), 0.5).bfloat16()
    dt_a = -make((b, s, h), 0.3).abs()
    bp, cp = make((b, s, g, n), 0.3).bfloat16(), make((b, s, g, n), 0.3).bfloat16()
    init = make((b, h, p, n), 0.2) if initial else None
    return x, dt_a, bp, cp, init


@pytest.mark.parametrize("case", FLASH_CASES, ids=[str(c) for c in FLASH_CASES])
def test_flash_rounding_within_tolerance(case):
    q, k, v = _flash_inputs(case, 0)
    causal = case[6]
    got = flash_emulated(q, k, v, causal=causal)
    ref = fa.flash_attention_plain(q, k, v, causal=causal)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    torch.testing.assert_close(got.float(), ref.float(), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("initial", [False, True], ids=["zero-state", "initial-state"])
@pytest.mark.parametrize("case", SSD_CASES, ids=[str(c) for c in SSD_CASES])
def test_ssd_rounding_within_tolerance(case, initial):
    x, dt_a, bp, cp, init = _ssd_inputs(case, 0, initial)
    chunk = case[6]
    y, h = ssd_emulated(x, dt_a, bp, cp, chunk=chunk, initial_state=init)
    y_ref, h_ref = ssd.ssd_scan_plain(x, dt_a, bp, cp, chunk=chunk, initial_state=init)
    assert y.dtype == torch.bfloat16 and y.shape == x.shape and h.shape == h_ref.shape
    torch.testing.assert_close(y.float(), y_ref.float(), rtol=TOL, atol=TOL)
    torch.testing.assert_close(h, h_ref, rtol=TOL, atol=TOL)


def test_emulations_without_rounding_are_the_plain_versions():
    """With the roundings taken out, each emulation is its plain version to
    fp32 precision: what the tests above measure is the rounding alone."""
    q, k, v = (t.float() for t in _flash_inputs((1, 4, 2, 130, 130, 32, True), 1))
    torch.testing.assert_close(flash_emulated(q, k, v, causal=True, rnd=_exact),
                               fa.flash_attention_plain(q, k, v, causal=True),
                               rtol=1e-5, atol=1e-5)
    x, dt_a, bp, cp, init = _ssd_inputs((1, 128, 4, 2, 32, 20, 64), 1, True)
    x, bp, cp = x.float(), bp.float(), cp.float()
    got = ssd_emulated(x, dt_a, bp, cp, chunk=64, initial_state=init, rnd=_exact)
    ref = ssd.ssd_scan_plain(x, dt_a, bp, cp, chunk=64, initial_state=init)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kernel", ["flash", "ssd"])
def test_rounding_is_visible_and_inside_the_tolerance(kernel):
    """In fp32 outputs the roundings move the results by more than fp32
    noise and less than the tolerance."""
    if kernel == "flash":
        q, k, v = (t.float() for t in _flash_inputs((1, 2, 2, 256, 256, 64, True), 2))
        got = flash_emulated(q, k, v, causal=True)
        ref = flash_emulated(q, k, v, causal=True, rnd=_exact)
    else:
        x, dt_a, bp, cp, init = _ssd_inputs((1, 256, 4, 1, 64, 128, 256), 2, True)
        x, bp, cp = x.float(), bp.float(), cp.float()
        got = ssd_emulated(x, dt_a, bp, cp, chunk=256, initial_state=init)[0]
        ref = ssd_emulated(x, dt_a, bp, cp, chunk=256, initial_state=init, rnd=_exact)[0]
    diff = (got - ref).abs().max().item()
    assert 1e-4 < diff < TOL
