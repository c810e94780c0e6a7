"""Paper use-cases end-to-end on the GPU: streamline-length histogram and
bundle recognition over a prefetched multi-shard dataset, with the analysis
compute in PyTorch on ``--device`` (paper §II-D.4, Fig. 5). The PyTorch
counterpart of examples/streamline_analysis.py.

  PYTHONPATH=src python examples/torch/streamline_analysis.py [--device cpu]

Two departures from the JAX example. The histogram packs the streamlines
it reads into host batches of 512 and sends each full batch (and the tail)
to the device in one call, where the JAX example makes one device call and
one host sync per streamline; the read stays lazy and the arithmetic is per
row, so the histogram is the same. Bundle recognition draws its reference
bundles from a `torch.Generator` seeded 0, which cannot reproduce
``jax.random.normal(key(0))``, so its labels differ from the JAX example's
(`bundle_recognition` takes references as an argument for a comparison).
"""

from __future__ import annotations

import argparse
import time
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.data.trk import iter_streamlines_multi, synth_trk
from repro_torch.io import IOPolicy, PrefetchFS, open_store
from repro_torch.store import MemTier

STORE_URI = "sims3://hydi?latency_ms=20&bw_mbps=45"
MAX_POINTS = 64      # the histogram truncates each streamline to this many points
BATCH = 512          # streamlines a histogram batch sends to the device
N_RESAMPLE = 20      # points bundle recognition resamples each streamline to
THRESHOLD = 8.0      # mean distance beyond which a streamline is in no bundle
BINS = 20


def example_dataset() -> dict[str, bytes]:
    """The example's dataset: 4 shards of 3,000 streamlines, 15 points on
    average, from seed 1."""
    rng = np.random.default_rng(1)
    return {f"hydi/shard{i}.trk": synth_trk(rng, 3000, mean_points=15) for i in range(4)}


def open_stream(engine: str, objects: dict[str, bytes], uri: str = STORE_URI):
    """A fresh simulated store holding `objects`, and one logical stream
    over all of them through `engine`."""
    store = open_store(uri, fresh=True)
    for k, v in objects.items():
        store.backing.put(k, v)
    fs = PrefetchFS(
        store,
        policy=IOPolicy(engine=engine, blocksize=256 << 10, eviction_interval_s=0.05),
        tiers=[MemTier(4 << 20)],
    )
    return fs, fs.open_many(store.backing.list_objects())


class _TimedReads:
    """The stream as the use case reads it, adding up the seconds spent
    inside ``read``: the use case's wait on the reader."""

    def __init__(self, f) -> None:
        self._f = f
        self.wait_s = 0.0

    def read(self, n: int = -1) -> bytes:
        t0 = time.perf_counter()
        data = self._f.read(n)
        self.wait_s += time.perf_counter() - t0
        return data

    def tell(self) -> int:
        return self._f.tell()


@dataclass
class Run:
    """One timed run of a use case."""

    result: np.ndarray     # histogram counts, or one label per streamline
    values: torch.Tensor   # per-streamline lengths, or the resampled points, on the device
    seconds: float
    read_wait_s: float     # of `seconds`, spent waiting on the reader
    store_gets: int
    bytes_fetched: int


def _finish(fs: PrefetchFS, f, timed: _TimedReads, result, values, seconds: float) -> Run:
    f.close()
    totals = fs.stats().snapshot()["totals"]
    fs.close()
    return Run(result, values, seconds, timed.wait_s,
               totals.get("store_requests", 0), totals.get("bytes_fetched", 0))


# --- use-case 1: histogram of streamline lengths (lazy, data-intensive) ------
def lengths_of(points: torch.Tensor, n_points: torch.Tensor) -> torch.Tensor:
    """Per row of `points` (N, MAX_POINTS, 3), the length of the polyline
    through its first `n_points` points (truncated to MAX_POINTS)."""
    seg = torch.linalg.vector_norm(torch.diff(points, dim=1), dim=-1)
    n = n_points.clamp(max=points.shape[1])
    mask = torch.arange(seg.shape[1], device=points.device) < (n - 1)[:, None]
    return torch.sum(seg * mask, dim=1)


def histogram(mode: str, device, objects: dict[str, bytes], uri: str = STORE_URI) -> Run:
    device = torch.device(device)
    fs, f = open_stream(mode, objects, uri)
    timed = _TimedReads(f)
    t0 = time.perf_counter()
    pts = np.zeros((BATCH, MAX_POINTS, 3), np.float32)
    n_pts = np.zeros(BATCH, np.int64)
    chunks, k = [], 0

    def flush(k: int) -> None:
        chunks.append(lengths_of(torch.from_numpy(pts[:k]).to(device),
                                 torch.from_numpy(n_pts[:k]).to(device)))

    for sl in iter_streamlines_multi(timed, f.size):
        n = min(len(sl.points), MAX_POINTS)
        pts[k, :n] = sl.points[:n]
        pts[k, n:] = 0.0
        n_pts[k] = n
        k += 1
        if k == BATCH:
            flush(k)
            k = 0
    if k:
        flush(k)
    lengths = torch.cat(chunks)
    hist = np.histogram(lengths.cpu().numpy().astype(np.float64), bins=BINS)[0]
    return _finish(fs, f, timed, hist, lengths, time.perf_counter() - t0)


# --- use-case 2: bundle recognition (load-all-then-compute) --------------------
def distances(batch_points: torch.Tensor, ref_cst: torch.Tensor,
              ref_arc: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Mean distance of each streamline (N, N_RESAMPLE, 3) to each reference."""
    d_cst = torch.mean(torch.linalg.vector_norm(batch_points - ref_cst, dim=-1), dim=-1)
    d_arc = torch.mean(torch.linalg.vector_norm(batch_points - ref_arc, dim=-1), dim=-1)
    return d_cst, d_arc


def classify(batch_points: torch.Tensor, ref_cst: torch.Tensor,
             ref_arc: torch.Tensor) -> torch.Tensor:
    """0: no bundle (both references farther than THRESHOLD); 1: nearer the
    first reference; 2: otherwise."""
    d_cst, d_arc = distances(batch_points, ref_cst, ref_arc)
    best = torch.minimum(d_cst, d_arc)
    return torch.where(best > THRESHOLD, 0, torch.where(d_cst < d_arc, 1, 2)).to(torch.int32)


def resample(points: np.ndarray, n: int = N_RESAMPLE) -> np.ndarray:
    t = np.linspace(0, 1, len(points))
    ti = np.linspace(0, 1, n)
    return np.stack([np.interp(ti, t, points[:, i]) for i in range(3)], axis=1)


def resample_batch(streamlines: list[np.ndarray]) -> np.ndarray:
    """Every streamline resampled, stacked and cast to float32 (the dtype
    JAX gives the JAX example's float64 stack)."""
    return np.stack([resample(p) for p in streamlines]).astype(np.float32)


def references(device="cuda") -> tuple[torch.Tensor, torch.Tensor]:
    """The two reference bundles: a random walk from a CPU generator seeded
    0, and the same walk shifted by 5."""
    gen = torch.Generator().manual_seed(0)
    ref_cst = torch.randn((N_RESAMPLE, 3), generator=gen).cumsum(dim=0)
    return ref_cst.to(device), (ref_cst + 5.0).to(device)


def bundle_recognition(mode: str, device, objects: dict[str, bytes], uri: str = STORE_URI,
                       refs=None) -> Run:
    """`refs` is the pair of reference bundles, `references(device)` by default."""
    device = torch.device(device)
    fs, f = open_stream(mode, objects, uri)
    timed = _TimedReads(f)
    t0 = time.perf_counter()
    # Paper: the pipeline loads all data first (no lazy loading)...
    streamlines = [sl.points for sl in iter_streamlines_multi(timed, f.size)]
    # ...then computes.
    batch = torch.from_numpy(resample_batch(streamlines)).to(device)
    ref_cst, ref_arc = refs if refs is not None else references(device)
    labels = classify(batch, ref_cst.to(device), ref_arc.to(device)).cpu().numpy()
    return _finish(fs, f, timed, labels, batch, time.perf_counter() - t0)


USE_CASES = {"histogram": histogram, "bundle": bundle_recognition}


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device (pass --device cpu to run on the host)")
    objects = example_dataset()
    for usecase, fn in USE_CASES.items():
        fn("rolling", device, objects)  # warm-up: the device's first-use costs stay out of the timed runs
        seq = fn("sequential", device, objects)
        pf = fn("rolling", device, objects)
        match = np.array_equal(seq.result, pf.result)
        print(f"{usecase:>10s}: sequential {seq.seconds:.2f}s | rolling {pf.seconds:.2f}s | "
              f"speed-up {seq.seconds / pf.seconds:.2f}x | results identical: {match}")
    print("(paper Fig. 5: histogram ~1.5x, bundle ~1.14x; both < 2x)")


if __name__ == "__main__":
    main()
