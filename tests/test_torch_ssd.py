"""The port's SSD scan and Mamba-2 block against the JAX package's, on the
CPU: the same seeded numpy inputs go through the Pallas `ssd_scan` (in
interpret mode), `ssd_chunked` and `ssd_ref` on the JAX side, and through
`repro_torch.kernels.ops.ssd_scan`, which takes its plain version for CPU
tensors, on the port's. The CUDA kernel itself is held against that plain
version in tests/test_torch_cuda_kernels.py."""

from __future__ import annotations

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels.ref import ssd_ref as jax_ssd_ref
from repro.kernels.ssd_scan import ssd_scan as jax_ssd_scan
from repro.models import ssd as JS
from repro.models.spec import init_params as jax_init_params
from repro_torch.bridge import params_from_numpy, tensor_from_numpy
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.kernels.ref import ssd_ref
from repro_torch.models import ssd as S
from repro_torch.models.spec import ParamSpec, init_params

SSD_CASES = [
    # (b, s, h, g, p, n, chunk, dtype): tests/test_kernels.py's sweep
    (1, 128, 4, 1, 32, 32, 32, jnp.float32),
    (2, 256, 8, 2, 64, 64, 64, jnp.float32),
    (1, 512, 4, 4, 64, 128, 128, jnp.float32),
    (1, 256, 4, 1, 64, 128, 256, jnp.float32),   # single chunk
    (2, 256, 4, 1, 32, 64, 64, jnp.bfloat16),
]


def _property_cases(count: int = 10, seed: int = 0) -> list[tuple]:
    """tests/test_kernels.py's property sweep, drawn from a seed: 1-4 chunks
    of 32, H in {2, 4}, G in {1, 2}, P in {16, 32}, N in {16, 64}."""
    rng = np.random.default_rng(seed)
    cases = []
    for _ in range(count):
        h, g = int(rng.choice([2, 4])), int(rng.choice([1, 2]))
        cases.append((1, 32 * int(rng.integers(1, 5)), h, g if h % g == 0 else 1,
                      int(rng.choice([16, 32])), int(rng.choice([16, 64])), 32, jnp.float32))
    return cases


PROPERTY_CASES = _property_cases()


def _tol(dtype):
    # tests/test_kernels.py: bf16 rounds y, fp32 holds the algorithm.
    return dict(rtol=2e-2, atol=2e-2) if dtype == jnp.bfloat16 else dict(
        rtol=2e-3, atol=2e-3)


def _inputs(case, seed: int = 0):
    """Seeded numpy inputs as (jax x, dt_a, B, C) and (torch x, dt_a, B, C),
    with the scales of tests/test_kernels.py's `_ssd_inputs`."""
    b, s, h, g, p, n, _, dtype = case
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p), dtype=np.float32) * 0.5
    dt_a = -np.abs(rng.standard_normal((b, s, h), dtype=np.float32)) * 0.3
    bp = rng.standard_normal((b, s, g, n), dtype=np.float32) * 0.3
    cp = rng.standard_normal((b, s, g, n), dtype=np.float32) * 0.3
    jx = [jnp.asarray(x, dtype), jnp.asarray(dt_a), jnp.asarray(bp, dtype),
          jnp.asarray(cp, dtype)]
    tx = [tensor_from_numpy(np.asarray(a), "cpu") for a in jx]
    return jx, tx


def _close(got: torch.Tensor, want, err_msg: str = "", **tol) -> None:
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               err_msg=err_msg, **tol)


@pytest.mark.parametrize("case", SSD_CASES, ids=[str(c[:7]) for c in SSD_CASES])
def test_scan_matches_pallas_kernel(case):
    chunk, dtype = case[6], case[7]
    (jx, ja, jb, jc), (x, a, b, c) = _inputs(case)
    y_want, h_want = jax_ssd_scan(jx, ja, jb, jc, chunk=chunk, interpret=True)
    y, h = ops.ssd_scan(x, a, b, c, chunk=chunk)
    assert y.dtype == x.dtype and y.shape == x.shape
    assert h.dtype == torch.float32 and tuple(h.shape) == h_want.shape
    _close(y, y_want, "y", **_tol(dtype))
    _close(h, h_want, "final state", **_tol(dtype))


@pytest.mark.parametrize("case", SSD_CASES[:3], ids=[str(c[:7]) for c in SSD_CASES[:3]])
def test_chunked_matches_jax_chunked(case):
    """The re-exported `ssd_chunked` against the JAX package's, from a
    nonzero entering state."""
    b, _, h, _, p, n, chunk, dtype = case
    (jx, ja, jb, jc), (x, a, bb, cc) = _inputs(case)
    init = np.random.default_rng(9).standard_normal((b, h, p, n), dtype=np.float32) * 0.2
    y_want, h_want = JS.ssd_chunked(jx, ja, jb, jc, chunk, initial_state=jnp.asarray(init))
    y, hf = S.ssd_chunked(x, a, bb, cc, chunk, initial_state=torch.from_numpy(init))
    _close(y, y_want, "y", **_tol(dtype))
    _close(hf, h_want, "final state", **_tol(dtype))


def test_segsum_matches_jax():
    x = np.random.default_rng(2).standard_normal((2, 3, 16), dtype=np.float32)
    want = np.asarray(JS.segsum(jnp.asarray(x)))
    got = S.segsum(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_allclose(got[~np.isinf(got)], want[~np.isinf(want)], rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("case", [SSD_CASES[0], SSD_CASES[4], (2, 40, 4, 2, 16, 16, 8,
                                                               jnp.float32)],
                         ids=["fp32", "bf16", "groups"])
def test_ssd_ref_matches_jax_ssd_ref(case):
    b, _, h, _, p, n, _, dtype = case
    (jx, ja, jb, jc), (x, a, bb, cc) = _inputs(case, seed=1)
    init = np.random.default_rng(3).standard_normal((b, h, p, n), dtype=np.float32) * 0.2
    y_want, h_want = jax_ssd_ref(jx, ja, jb, jc, initial_state=jnp.asarray(init))
    y, hf = ssd_ref(x, a, bb, cc, initial_state=torch.from_numpy(init))
    assert y.dtype == x.dtype
    _close(y, y_want, "y", **_tol(dtype))
    _close(hf, h_want, "final state", **_tol(dtype))


def test_initial_state_continuation():
    """Two halves with the carried state equal one pass (the decode/prefill
    contract), and the second half agrees with the Pallas kernel given the
    same entering state."""
    case = (1, 256, 4, 1, 32, 64, 64, jnp.float32)
    (jx, ja, jb, jc), (x, a, b, c) = _inputs(case)
    y_full, h_full = ops.ssd_scan(x, a, b, c, chunk=64)
    half = 128
    y1, h1 = ops.ssd_scan(x[:, :half], a[:, :half], b[:, :half], c[:, :half], chunk=64)
    y2, h2 = ops.ssd_scan(x[:, half:], a[:, half:], b[:, half:], c[:, half:], chunk=64,
                          initial_state=h1)
    torch.testing.assert_close(torch.cat([y1, y2], dim=1), y_full, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(h2, h_full, rtol=1e-4, atol=1e-4)
    y_want, h_want = jax_ssd_scan(jx[:, half:], ja[:, half:], jb[:, half:], jc[:, half:],
                                  chunk=64, initial_state=jnp.asarray(h1.numpy()),
                                  interpret=True)
    _close(y2, y_want, "second half y", rtol=2e-3, atol=2e-3)
    _close(h2, h_want, "second half state", rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("case", PROPERTY_CASES, ids=[str(c[1:6]) for c in PROPERTY_CASES])
def test_property_cases(case):
    (jx, ja, jb, jc), (x, a, b, c) = _inputs(case, seed=hash(case[:6]) % 2 ** 31)
    y_want, h_want = jax_ssd_scan(jx, ja, jb, jc, chunk=32, interpret=True)
    y, h = ops.ssd_scan(x, a, b, c, chunk=32)
    y_ref, h_ref = ssd_ref(x, a, b, c)
    for got, want, what in ((y, y_want, "y vs Pallas"), (h, h_want, "state vs Pallas"),
                            (y, y_ref.numpy(), "y vs ssd_ref"),
                            (h, h_ref.numpy(), "state vs ssd_ref")):
        _close(got, want, what, rtol=5e-3, atol=5e-3)


def test_chunk_is_capped_at_the_length_and_must_divide_it():
    _, (x, a, b, c) = _inputs((1, 48, 2, 1, 16, 16, 0, jnp.float32))
    y_capped, _ = ops.ssd_scan(x, a, b, c, chunk=256)     # min(256, 48) = 48
    y_one, _ = ssd.ssd_chunked(x, a, b, c, 48)
    torch.testing.assert_close(y_capped, y_one)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ops.ssd_scan(x, a, b, c, chunk=32)
    with pytest.raises(ValueError, match="initial_state"):
        ops.ssd_scan(x, a, b, c, initial_state=torch.zeros(1, 2, 16, 8))


def test_cpu_tensors_never_reach_the_kernel():
    """ops sends a CPU tensor to the plain version without touching the
    launch counter; the CUDA wrapper refuses CPU tensors before building or
    launching anything; any other device raises."""
    _, (x, a, b, c) = _inputs((1, 64, 2, 1, 16, 16, 32, jnp.float32))
    before = ssd.launches
    y, _ = ops.ssd_scan(x, a, b, c, chunk=32)
    torch.testing.assert_close(y, ssd.ssd_scan_plain(x, a, b, c, chunk=32)[0])
    with pytest.raises(ValueError, match="one CUDA device"):
        ssd.ssd_scan_cuda(x, a, b, c, chunk=32)
    with pytest.raises(ValueError, match="no ssd scan for device meta"):
        ops.ssd_scan(x.to("meta"), a.to("meta"), b.to("meta"), c.to("meta"))
    assert ssd.launches == before


# --------------------------------------------------------------------------- #
# Init kinds of the Mamba parameters
# --------------------------------------------------------------------------- #
def test_mamba_init_kinds_ranges():
    spec = {"a_log": ParamSpec((4096,), (None,), "a_log"),
            "dt_bias": ParamSpec((4096,), (None,), "dt_bias"),
            "u": ParamSpec((4096,), (None,), ("uniform", -0.5, 2.0))}
    p = init_params(spec, 0, device="cpu")
    a_log, dt_bias, u = p["a_log"], p["dt_bias"], p["u"]
    assert a_log.min() >= 0 and a_log.max() <= math.log(16)
    assert a_log.max() - a_log.min() > 0.9 * math.log(16)     # spread over the range
    dt = torch.nn.functional.softplus(dt_bias)
    assert dt.min() >= 1e-3 * (1 - 1e-5) and dt.max() <= 0.1 * (1 + 1e-5)
    # log-uniform: half of the draws lie below the geometric mean, 1e-2.
    assert abs((dt < 1e-2).float().mean().item() - 0.5) < 0.05
    assert u.min() >= -0.5 and u.max() <= 2.0 and abs(u.mean().item() - 0.75) < 0.05


# --------------------------------------------------------------------------- #
# Mamba-2 block against the JAX package's, on JAX's weights
# --------------------------------------------------------------------------- #
def _block_setup(seed: int):
    jcfg = jax_get_config("mamba2-1.3b").reduced()
    cfg = get_config("mamba2-1.3b").reduced()
    jp = jax_init_params(JS.mamba_spec(jcfg), jax.random.key(seed))
    # The bridge walks dicts by key: a Mamba tree needs no code of its own.
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    assert set(tp) == set(S.mamba_spec(cfg))
    return jcfg, cfg, jp, tp


def _leaves(cache: S.MambaCache) -> list[torch.Tensor]:
    return [getattr(cache, f.name) for f in dataclasses.fields(cache)]


def _compare_cache(got: S.MambaCache, want: JS.MambaCache, tol: float, what: str) -> None:
    for leaf in ("conv_x", "conv_b", "conv_c", "ssm"):
        g, w = getattr(got, leaf), getattr(want, leaf)
        assert tuple(g.shape) == w.shape, (what, leaf)
        assert str(g.dtype).removeprefix("torch.") == np.dtype(w.dtype).name, (what, leaf)
        _close(g, w, f"{what} {leaf}", rtol=tol, atol=tol)


# The block in fp32 agrees with JAX's within 1.2e-6, so fp32 is held to the
# kernel tolerance. In bf16, the serving dtype, the two frameworks' bf16
# matmuls round in another order and single elements differ by up to 0.032
# (1.49x the kernel bound of 2e-2; 33 runs: PYTHONHASHSEED 1-11, which
# reseeds JAX's init, times the three lengths below), so bf16 is held to
# 5e-2, still a third of the whole-stack bound.
BLOCK_TOL = {"float32": 2e-3, "bfloat16": 5e-2}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seq", [20, 32, 45], ids=["padded", "one-chunk", "two-chunks"])
def test_mamba_block_prefill_then_decode_matches_jax(seq, dtype):
    """Prefill from a zero cache (S padded up to a multiple of the chunk
    where it is not one), then one decode step from the resulting cache:
    outputs and every cache leaf agree with the JAX block."""
    jcfg, cfg, jp, tp = _block_setup(seed=seq)
    rng = np.random.default_rng(seq)
    b = 2
    xs = jnp.asarray(rng.standard_normal((b, seq + 1, cfg.d_model), dtype=np.float32),
                     getattr(jnp, dtype))
    tx = tensor_from_numpy(np.asarray(xs), "cpu")
    tol = BLOCK_TOL[dtype]

    jout, jcache = JS.mamba_block(jp, jcfg, xs[:, :seq], update_cache=True,
                                  cache=JS.make_mamba_cache(jcfg, b, getattr(jnp, dtype)))
    cache = S.make_mamba_cache(cfg, b, device="cpu", dtype=getattr(torch, dtype))
    buffers = _leaves(cache)
    out, tcache = S.mamba_block(tp, cfg, tx[:, :seq], cache=cache, update_cache=True)
    assert out.dtype == getattr(torch, dtype) and out.shape == (b, seq, cfg.d_model)
    _close(out, jout, "prefill out", rtol=tol, atol=tol)
    _compare_cache(tcache, jcache, tol, "prefill")
    # Updated in place: the returned cache holds the caller's buffers.
    assert all(t is u for t, u in zip(_leaves(tcache), buffers))

    jout, jcache = JS.mamba_block(jp, jcfg, xs[:, seq:], cache=jcache, update_cache=True)
    out, tcache = S.mamba_block(tp, cfg, tx[:, seq:], cache=tcache, update_cache=True)
    _close(out, jout, "decode out", rtol=tol, atol=tol)
    _compare_cache(tcache, jcache, tol, "decode")


def test_mamba_block_without_cache_matches_jax():
    jcfg, cfg, jp, tp = _block_setup(seed=5)
    xs = jnp.asarray(np.random.default_rng(5).standard_normal((1, 40, cfg.d_model),
                                                              dtype=np.float32), jnp.bfloat16)
    jout, jcache = JS.mamba_block(jp, jcfg, xs)
    out, cache = S.mamba_block(tp, cfg, tensor_from_numpy(np.asarray(xs), "cpu"))
    assert jcache is None and cache is None
    _close(out, jout, "out", rtol=BLOCK_TOL["bfloat16"], atol=BLOCK_TOL["bfloat16"])


def test_causal_conv_is_bit_exact_with_jax():
    """The shift-and-add conv in bf16, in the reference's order, with and
    without a carried state."""
    rng = np.random.default_rng(6)
    x = jnp.asarray(rng.standard_normal((2, 9, 24), dtype=np.float32), jnp.bfloat16)
    w = jnp.asarray(rng.standard_normal((4, 24), dtype=np.float32), jnp.bfloat16)
    st = jnp.asarray(rng.standard_normal((2, 3, 24), dtype=np.float32), jnp.bfloat16)
    for state in (None, st):
        jy, jst = JS.causal_conv(x, w, state)
        y, tst = S.causal_conv(*(tensor_from_numpy(np.asarray(a), "cpu") for a in (x, w)),
                               None if state is None else tensor_from_numpy(np.asarray(state),
                                                                            "cpu"))
        np.testing.assert_array_equal(y.float().numpy(), np.asarray(jy, np.float32))
        np.testing.assert_array_equal(tst.float().numpy(), np.asarray(jst, np.float32))
