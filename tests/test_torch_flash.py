"""The port's flash attention entry and oracle against the JAX package's, on
the CPU: the same seeded numpy inputs go through the Pallas kernel (in
interpret mode) and through `repro_torch.kernels.ops.flash_attention`, which
takes its plain version for CPU tensors. The CUDA kernel itself is held
against that plain version in tests/test_torch_cuda_kernels.py."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.kernels.ref import attention_ref as jax_attention_ref
from repro_torch.bridge import tensor_from_numpy
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels.ref import attention_ref

FLASH_CASES = [
    # (b, hq, hkv, sq, sk, d, causal, dtype): tests/test_kernels.py's sweep ...
    (1, 4, 4, 256, 256, 64, True, jnp.float32),
    (2, 8, 2, 256, 256, 128, True, jnp.float32),
    (1, 8, 1, 128, 128, 64, True, jnp.float32),
    (1, 4, 4, 128, 384, 64, False, jnp.float32),
    (2, 4, 2, 256, 256, 64, True, jnp.bfloat16),
    (1, 2, 2, 512, 512, 128, True, jnp.bfloat16),
    (1, 4, 4, 128, 128, 32, False, jnp.float32),
    # ... plus causal with Sq != Sk, where the kernel's mask is top-left ...
    (1, 2, 2, 128, 256, 32, True, jnp.float32),
    # ... and reduced whisper-large-v3's encoder self-attention, unmasked
    # (batch 2, 4 heads of 16, 16 frames).
    (2, 4, 4, 16, 16, 16, False, jnp.float32),
    (2, 4, 4, 16, 16, 16, False, jnp.bfloat16),
]


def _tol(dtype):
    # tests/test_kernels.py: bf16 rounds the output, fp32 holds the algorithm.
    return dict(rtol=2e-2, atol=2e-2) if dtype == jnp.bfloat16 else dict(
        rtol=2e-3, atol=2e-3)


def _inputs(case, seed):
    """Seeded numpy inputs, as (jax q, k, v) and (torch q, k, v) of one dtype."""
    b, hq, hkv, sq, sk, d, _, dtype = case
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(shape, dtype=np.float32)
              for shape in ((b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, d))]
    jx = [jnp.asarray(a, dtype) for a in arrays]
    tx = [tensor_from_numpy(np.asarray(a), "cpu") for a in jx]
    return jx, tx


@pytest.mark.parametrize("case", FLASH_CASES, ids=[str(c[:7]) for c in FLASH_CASES])
def test_flash_matches_pallas_kernel(case):
    causal, dtype = case[6], case[7]
    (jq, jk, jv), (q, k, v) = _inputs(case, 0)
    want = jax_flash(jq, jk, jv, causal=causal, interpret=True)
    got = ops.flash_attention(q, k, v, causal=causal)
    assert got.dtype == q.dtype and got.shape == q.shape
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               **_tol(dtype))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,sk", [(128, 128), (64, 192)])
def test_attention_ref_matches_jax_oracle(causal, sq, sk):
    case = (2, 4, 2, sq, sk, 32, causal, jnp.float32)
    (jq, jk, jv), (q, k, v) = _inputs(case, 1)
    want = jax_attention_ref(jq, jk, jv, causal=causal)
    np.testing.assert_allclose(attention_ref(q, k, v, causal=causal).numpy(),
                               np.asarray(want), rtol=2e-3, atol=2e-3)


def test_causal_alignment_differs_from_oracle_only_when_lengths_differ():
    """The kernel counts the causal diagonal from the top-left, the oracle
    from the bottom-right: equal for Sq == Sk, not otherwise."""
    _, (q, k, v) = _inputs((1, 2, 2, 128, 256, 32, True, jnp.float32), 2)
    assert not torch.allclose(fa.flash_attention_plain(q, k, v), attention_ref(q, k, v),
                              atol=0.1)
    k, v = k[:, :, :128], v[:, :, :128]
    torch.testing.assert_close(fa.flash_attention_plain(q, k, v), attention_ref(q, k, v),
                               rtol=1e-5, atol=1e-5)


def test_causal_rows_see_only_their_prefix():
    """Uniform scores and v = position: causal row i averages 0..i = i/2."""
    sq = 256
    q = torch.ones((1, 1, sq, 64))
    k = torch.zeros((1, 1, sq, 64))
    v = torch.arange(sq, dtype=torch.float32)[None, None, :, None].expand(1, 1, sq, 64)
    out = ops.flash_attention(q, k, v, causal=True)
    torch.testing.assert_close(out[0, 0, :, 0], torch.arange(sq) / 2.0,
                               rtol=1e-4, atol=1e-4)


def test_relative_limit_sees_an_unmasked_ragged_tail():
    """At whisper-large-v3's encoder length the last 64-column k tile holds
    28 keys. A kernel that read its 36 padding columns as zero keys would
    shrink every output by about 1.5%: inside the elementwise bf16 limit,
    and over twice the relative L2 limit (5e-3) that chip_smoke.py and
    tests/test_torch_cuda_encdec.py also hold the CUDA kernel to."""
    _, (q, k, v) = _inputs((1, 2, 2, 64, 1500, 64, False, jnp.float32), 5)
    ref = fa.flash_attention_plain(q, k, v, causal=False)
    k_pad, v_pad = (torch.nn.functional.pad(t, (0, 0, 0, 36)) for t in (k, v))
    err = fa.flash_attention_plain(q, k_pad, v_pad, causal=False) - ref
    assert bool((err.abs() <= 2e-2 + 2e-2 * ref.abs()).all())
    assert (err.norm() / ref.norm()).item() > 2 * 5e-3


def test_cpu_tensors_take_the_plain_version_without_launching():
    _, (q, k, v) = _inputs((1, 2, 1, 16, 16, 16, True, jnp.bfloat16), 3)
    before = fa.launches
    out = ops.flash_attention(q, k, v)
    assert fa.launches == before
    assert torch.equal(out, fa.flash_attention_plain(q, k, v))


def test_entry_rejects_bad_shapes_and_tiles():
    _, (q, k, v) = _inputs((1, 4, 2, 16, 16, 16, True, jnp.float32), 4)
    with pytest.raises(ValueError, match="tile"):
        ops.flash_attention(q, k, v, block_q=128)
    with pytest.raises(ValueError, match="GQA"):
        ops.flash_attention(q[:, :3], k, v)
    with pytest.raises(ValueError, match="want q"):
        ops.flash_attention(q, k, v[:, :, :8])
