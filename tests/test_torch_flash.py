"""The port's flash attention entry and oracle against the JAX package's, on
the CPU: the same seeded numpy inputs go through the Pallas kernel (in
interpret mode) and through `repro_torch.kernels.ops.flash_attention`, which
takes its plain version for CPU tensors. The training entry
`ops.flash_attention_train` on CPU tensors (its plain version under
autograd) against `_attn_core`, and the model's dispatch to it. The CUDA
kernels themselves are held against the plain version in
tests/test_torch_cuda_kernels.py."""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.kernels.ref import attention_ref as jax_attention_ref
from repro_torch.bridge import tensor_from_numpy
from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels.ref import attention_ref
from repro_torch.models import layers as L
from repro_torch.models import make_model

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


# --------------------------------------------------------------------------- #
# Training: `ops.flash_attention_train` and the model's dispatch to it
# --------------------------------------------------------------------------- #
TRAIN_CASES = [
    # (b, hq, hkv, sq, sk, d, causal): causal self-attention over three query
    # chunks of `_attn_core`, the unmasked Sq != Sk of cross-attention, and
    # GQA with groups of 3 (smollm-135m's).
    (2, 4, 4, 80, 80, 32, True),
    (2, 4, 4, 24, 70, 32, False),
    (2, 9, 3, 64, 64, 16, True),
]


@pytest.mark.parametrize("case", TRAIN_CASES, ids=[str(c) for c in TRAIN_CASES])
def test_train_entry_matches_attn_core_under_autograd(case):
    """On CPU tensors the training entry is the plain version under
    autograd: its output and dQ/dK/dV equal `_attn_core`'s head-mode path
    (chunked, each chunk checkpointed) in fp32, to 1e-5 (softmax and sums in
    another order)."""
    b, hq, hkv, sq, sk, d, causal = case
    rng = np.random.default_rng(11)
    arrays = [rng.standard_normal(shape, dtype=np.float32)
              for shape in ((b, sq, hq, d), (b, sk, hkv, d), (b, sk, hkv, d))]
    dout = torch.from_numpy(rng.standard_normal((b, sq, hq, d), dtype=np.float32))

    def run(attn):
        q, k, v = (torch.from_numpy(a).requires_grad_() for a in arrays)
        out = attn(q, k, v)
        out.backward(dout)
        return out.detach(), q.grad, k.grad, v.grad

    before = (fa.launches, fa.backward_launches)
    got = run(lambda q, k, v: ops.flash_attention_train(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), causal=causal).transpose(1, 2))
    want = run(lambda q, k, v: L._attn_core(q, k, v, causal=causal, q_offset=0, q_chunk=32,
                                            head_mode=True))
    assert (fa.launches, fa.backward_launches) == before
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5, msg=name)


class _ReadsAsCuda(torch.Tensor):
    """A CPU tensor whose `is_cuda` reads True: the dispatch predicate's
    view of a CUDA tensor, on a machine without one."""

    @property
    def is_cuda(self):
        return True


def _predicate_inputs(*, device="cpu", dtype=torch.bfloat16, d=64, grad=True,
                      as_cuda=True):
    shape_q, shape_kv = (2, 16, 6, d), (2, 16, 2, d)
    q, k, v = (torch.zeros(s, device=device, dtype=dtype).requires_grad_(grad)
               for s in (shape_q, shape_kv, shape_kv))
    if as_cuda:
        q, k, v = (t.as_subclass(_ReadsAsCuda) for t in (q, k, v))
    return q, k, v


PREDICATE_CASES = {
    # name: (inputs, call's keywords, kv_seq whole, want)
    "fits": ({}, {}, True, True),
    "head-mode-seq-split": ({}, {"head_mode": True}, False, True),
    "cpu": ({"as_cuda": False}, {}, True, False),
    "meta": ({"device": "meta", "as_cuda": False}, {}, True, False),
    "fp32": ({"dtype": torch.float32}, {}, True, False),
    "no-grad": ({"grad": False}, {}, True, False),
    "cached": ({}, {"cache": "empty"}, True, False),
    "start": ({}, {"start": 3}, True, False),
    "kv_seq": ({}, {}, False, False),
    "head-dim-96": ({"d": 96}, {}, True, False),
}


@pytest.mark.parametrize("name", list(PREDICATE_CASES))
def test_dispatch_predicate(monkeypatch, name):
    """Training's attention takes the kernel with its backward only for
    bf16 CUDA tensors that need gradients, with no cache from position 0,
    at a compiled head dim, in a layout of whole (batch, head) slices;
    CPU, ``meta`` (the dry-run), fp32, cached, kv_seq-split and other head
    dims keep `_attn_core`."""
    inputs, kw, whole, want = PREDICATE_CASES[name]
    monkeypatch.setattr(L, "_kv_seq_whole", lambda sk: whole)
    q, k, v = _predicate_inputs(**inputs)
    call = {"cache": None, "start": 0, "head_mode": False, **kw}
    if call["cache"] == "empty":
        call["cache"] = L.KVCache(k.detach(), v.detach(), 0)
    assert L.trains_through_flash(q, k, v, **call) is want


WIRING_CASES = [
    # (config, cross-attention): GQA self-attention (causal); MHA with q/k/v
    # biases; cross-attention from an 11-frame source (unmasked, no RoPE).
    ("smollm-135m", False),
    ("codeqwen1.5-7b", False),
    ("smollm-135m", True),
]


@pytest.mark.parametrize("name,cross", WIRING_CASES, ids=[f"{n}-{'cross' if c else 'self'}"
                                                          for n, c in WIRING_CASES])
def test_attention_through_the_train_entry_matches_the_plain_path(monkeypatch, name, cross):
    """`attention` with the predicate forced true reaches the training entry
    (on the CPU its plain version) with k and v unexpanded, heads moved to
    dim 1 and the mask that the plain path applies: output and the
    gradients of x, the source and every weight equal the plain path's in
    fp32, to 1e-5."""
    cfg = dataclasses.replace(get_config(name).reduced(), num_heads=6, num_kv_heads=2)
    if name == "codeqwen1.5-7b":
        cfg = dataclasses.replace(cfg, num_kv_heads=6)
    p = make_model(cfg).init(0, device="cpu")["layers"]["block0"]["attn"]
    p = {k: v[0].float() for k, v in p.items()}
    rng = np.random.default_rng(12)
    x0 = torch.from_numpy(rng.standard_normal((2, 9, cfg.d_model), dtype=np.float32))
    src0 = torch.from_numpy(rng.standard_normal((2, 11, cfg.d_model), dtype=np.float32))
    dy = torch.from_numpy(rng.standard_normal((2, 9, cfg.d_model), dtype=np.float32))

    def run(through_entry: bool):
        monkeypatch.setattr(L, "trains_through_flash",
                            lambda q, k, v, **kw: through_entry and ops.needs_grad(q, k, v))
        live = {k: v.clone().requires_grad_() for k, v in p.items()}
        x, src = x0.clone().requires_grad_(), src0.clone().requires_grad_()
        y, _ = L.attention(live, cfg, x, kv_source=src if cross else None,
                           causal=not cross)
        y.backward(dy)
        grads = {"x": x.grad, **{k: t.grad for k, t in live.items()}}
        if cross:
            grads["src"] = src.grad
        return y.detach(), grads

    calls = []
    monkeypatch.setattr(ops, "flash_attention_train",
                        _recording(ops.flash_attention_train, calls))
    got, got_grads = run(True)
    assert [c[1] for c in calls] == [(2, 6, 9, cfg.head_dim)]
    assert calls[0][2] == (2, cfg.num_kv_heads, 11 if cross else 9, cfg.head_dim)
    assert calls[0][3] is not cross
    want, want_grads = run(False)
    assert len(calls) == 1
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert got_grads.keys() == want_grads.keys()
    for key in want_grads:
        torch.testing.assert_close(got_grads[key], want_grads[key], rtol=1e-5, atol=1e-5,
                                   msg=key)


def _recording(fn, calls: list):
    """`fn`, recording each call's (q, k) shapes and causal flag."""
    def wrapped(q, k, v, *, causal=True, scale=None):
        calls.append((None, tuple(q.shape), tuple(k.shape), causal))
        return fn(q, k, v, causal=causal, scale=scale)
    return wrapped


def test_train_entry_on_dtensors_carries_gradients():
    """`DTensor`s laid out whole per (batch, head) on a one-rank gloo mesh go
    through `local_map` to the training entry: the output keeps q's layout,
    and the gradients reach q, k and v as `DTensor`s with the plain
    tensors' values, bit for bit."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Shard, distribute_tensor

    from repro_torch.launch.mesh import make_debug_mesh

    _, (q, k, v) = _inputs((2, 6, 2, 24, 24, 16, True, jnp.float32), 13)
    dout = torch.from_numpy(np.random.default_rng(14).standard_normal(q.shape,
                                                                      dtype=np.float32))
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = make_debug_mesh(1, 1, device_type="cpu")
        live = [distribute_tensor(t, mesh, [Shard(0), Shard(1)]).requires_grad_()
                for t in (q, k, v)]
        out = ops.flash_attention_train(*live)
        out.backward(distribute_tensor(dout, mesh, [Shard(0), Shard(1)]))
        assert isinstance(out, DTensor) and list(out.placements) == [Shard(0), Shard(1)]
        got = [out.full_tensor().detach()] + [t.grad.full_tensor() for t in live]
    finally:
        dist.destroy_process_group()
    plain = [t.clone().requires_grad_() for t in (q, k, v)]
    want = ops.flash_attention_train(*plain)
    want.backward(dout)
    for g, w in zip(got, [want.detach()] + [t.grad for t in plain]):
        assert torch.equal(g, w)
