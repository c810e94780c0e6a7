"""The paper's two streamline use cases in the port
(examples/torch/streamline_analysis.py) against the JAX example's own
functions (examples/streamline_analysis.py), on the CPU.

The JAX example runs both use cases when it is imported, so its
`lengths_of`, `classify` and `resample` are taken from its source with
`ast` and only those definitions are executed. Tolerances: lengths rtol
1e-5 (fp32 sums in another order); labels, resampled points and
histogram counts exact, except a histogram row whose length lies within
1e-4 relative of a bin edge, where the two fp32 sums may fall on either
side."""

from __future__ import annotations

import ast
import importlib.util
import io
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.trk import iter_streamlines_multi as jax_iter_streamlines_multi
from repro_torch.data.trk import synth_trk

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LENGTH_RTOL = 1e-5
EDGE_RTOL = 1e-4


def _jax_example() -> dict:
    path = os.path.join(REPO, "examples", "streamline_analysis.py")
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    keep = [node for node in tree.body if isinstance(node, ast.FunctionDef)
            and node.name in ("lengths_of", "classify", "resample")]
    assert len(keep) == 3
    ns = {"jax": jax, "jnp": jnp, "np": np}
    exec(compile(ast.Module(body=keep, type_ignores=[]), path, "exec"), ns)
    return ns


def _port_example():
    path = os.path.join(REPO, "examples", "torch", "streamline_analysis.py")
    spec = importlib.util.spec_from_file_location("torch_streamline_analysis", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


REF = _jax_example()
PORT = _port_example()


def _jax_refs():
    ref_cst = jax.random.normal(jax.random.key(0), (20, 3)).cumsum(axis=0)
    return ref_cst, ref_cst + 5.0


def _walks(rng, counts) -> list[np.ndarray]:
    return [rng.normal(size=(n, 3)).astype(np.float32).cumsum(axis=0) for n in counts]


def _padded(walks) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The JAX example's per-streamline packing: (N, 64, 3) zero padded,
    the true counts, and the counts truncated to 64."""
    pts = np.zeros((len(walks), 64, 3), np.float32)
    n = np.array([len(w) for w in walks])
    for i, w in enumerate(walks):
        pts[i, :min(len(w), 64)] = w[:64]
    return pts, n, np.minimum(n, 64)


def test_lengths_of_matches_jax_vmap():
    rng = np.random.default_rng(0)
    counts = [2, 64, 65, 80, 3] + list(rng.integers(2, 100, 59))
    pts, n, n64 = _padded(_walks(rng, counts))
    want = np.asarray(jax.vmap(REF["lengths_of"])(jnp.asarray(pts), jnp.asarray(n64)))
    got = PORT.lengths_of(torch.from_numpy(pts), torch.from_numpy(n))
    assert got.dtype == torch.float32 and got.shape == (len(counts),)
    np.testing.assert_allclose(got.numpy(), want, rtol=LENGTH_RTOL)
    # n = 2 is one segment; n > 64 counts only the first 63 segments.
    np.testing.assert_allclose(got[0].item(), np.linalg.norm(pts[0, 1] - pts[0, 0]),
                               rtol=LENGTH_RTOL)
    assert torch.equal(got, PORT.lengths_of(torch.from_numpy(pts), torch.from_numpy(n64)))


def test_classify_matches_jax_with_jax_references():
    ref_cst, ref_arc = _jax_refs()
    rng = np.random.default_rng(1)
    base = np.asarray(ref_cst, np.float64)
    # Near the first reference, near the second, and far from both.
    batch = np.concatenate([
        base + rng.normal(scale=1.0, size=(40, 20, 3)),
        base + 5.0 + rng.normal(scale=1.0, size=(40, 20, 3)),
        base + rng.normal(scale=30.0, size=(40, 20, 3)),
        base + 2.5 + rng.normal(scale=3.0, size=(40, 20, 3)),
    ]).astype(np.float32)
    want = np.asarray(REF["classify"](jnp.asarray(batch), ref_cst, ref_arc))
    got = PORT.classify(torch.from_numpy(batch), torch.from_numpy(np.array(ref_cst)),
                        torch.from_numpy(np.array(ref_arc))).numpy()
    assert set(np.unique(want)) == {0, 1, 2}
    np.testing.assert_array_equal(got, want)


def test_resampled_stack_is_the_jax_examples_fp32_stack():
    rng = np.random.default_rng(2)
    walks = _walks(rng, rng.integers(3, 90, 50))
    for w in walks[:5]:
        np.testing.assert_array_equal(PORT.resample(w), REF["resample"](w))
    got = PORT.resample_batch(walks)
    want = np.asarray(jnp.asarray(np.stack([REF["resample"](w) for w in walks])))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_references_are_seeded_and_placed_on_the_device():
    a_cst, a_arc = PORT.references("cpu")
    b_cst, _ = PORT.references("cpu")
    assert a_cst.shape == (20, 3) and a_cst.dtype == torch.float32
    assert torch.equal(a_cst, b_cst) and torch.equal(a_arc, a_cst + 5.0)


def _small_dataset() -> dict[str, bytes]:
    rng = np.random.default_rng(3)
    return {f"t/shard{i}.trk": synth_trk(rng, 300, mean_points=30) for i in range(3)}


LOW_LATENCY = "sims3://usecases?latency_ms=1&bw_mbps=2000"


@pytest.mark.parametrize("usecase", ["histogram", "bundle"])
def test_sequential_and_rolling_agree(usecase):
    fn = PORT.USE_CASES[usecase]
    objects = _small_dataset()
    seq = fn("sequential", "cpu", objects, LOW_LATENCY)
    roll = fn("rolling", "cpu", objects, LOW_LATENCY)
    np.testing.assert_array_equal(seq.result, roll.result)
    assert torch.equal(seq.values, roll.values)
    n = 900 if usecase == "bundle" else 20
    assert seq.result.shape == (n,)
    for run in (seq, roll):
        assert run.values.device.type == "cpu"
        assert run.store_gets > 0 and run.bytes_fetched == sum(map(len, objects.values()))
        assert 0.0 <= run.read_wait_s <= run.seconds
    if usecase == "histogram":
        assert seq.result.sum() == 900


def _bin_of(x: np.ndarray, edges: np.ndarray) -> np.ndarray:
    """np.histogram's bin of each value (the last bin holds its right edge)."""
    return np.minimum(np.searchsorted(edges, x, side="right") - 1, len(edges) - 2)


def _near_an_edge(x: np.ndarray, edges: np.ndarray) -> np.ndarray:
    return np.any(np.abs(x[:, None] - edges[None, :]) <= EDGE_RTOL * np.abs(edges[None, :]),
                  axis=1)


def _jax_streamlines(objects: dict[str, bytes]) -> list[np.ndarray]:
    stream = io.BytesIO(b"".join(objects[k] for k in sorted(objects)))
    return [sl.points for sl in jax_iter_streamlines_multi(stream, len(stream.getvalue()))]


def test_histogram_matches_the_jax_example():
    """The whole use case: the port's batched histogram against the JAX
    example's per-streamline `lengths_of` and `np.histogram` on the same
    streamlines."""
    objects = _small_dataset()
    run = PORT.histogram("rolling", "cpu", objects, LOW_LATENCY)
    want = []
    for p in _jax_streamlines(objects):
        pts = np.zeros((64, 3), np.float32)
        n = min(len(p), 64)
        pts[:n] = p[:n]
        want.append(float(REF["lengths_of"](jnp.asarray(pts), n)))
    want = np.asarray(want)
    got = run.values.numpy().astype(np.float64)
    np.testing.assert_allclose(got, want, rtol=LENGTH_RTOL)
    counts, edges = np.histogram(want, bins=20)
    got_edges = np.histogram_bin_edges(got, bins=20)
    exempt = _near_an_edge(want, edges) | _near_an_edge(got, got_edges)
    np.testing.assert_array_equal(_bin_of(got, got_edges)[~exempt], _bin_of(want, edges)[~exempt])
    if not exempt.any():
        np.testing.assert_array_equal(run.result, counts)


def test_bundle_recognition_matches_the_jax_example():
    """The whole use case with JAX's references passed to the port."""
    objects = _small_dataset()
    ref_cst, ref_arc = _jax_refs()
    refs = (torch.from_numpy(np.array(ref_cst)), torch.from_numpy(np.array(ref_arc)))
    run = PORT.bundle_recognition("rolling", "cpu", objects, LOW_LATENCY, refs=refs)
    batch = jnp.asarray(np.stack([REF["resample"](p) for p in _jax_streamlines(objects)]))
    np.testing.assert_array_equal(run.values.numpy(), np.asarray(batch))
    want = np.asarray(REF["classify"](batch, ref_cst, ref_arc))
    np.testing.assert_array_equal(run.result, want)


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without a card")
def test_cuda_without_a_card_raises():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PORT.main(["--device", "cuda"])
    with pytest.raises((RuntimeError, AssertionError)):
        PORT.histogram("rolling", "cuda", _small_dataset(), LOW_LATENCY)
