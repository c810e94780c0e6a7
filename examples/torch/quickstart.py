"""Quickstart: Rolling Prefetch through the PrefetchFS facade in ~60 lines.

Creates a simulated S3 bucket of tractography shards, reads them through
the S3Fs-style sequential baseline and through Rolling Prefetch — both via
the same ``PrefetchFS.open_many`` call, differing only in
``IOPolicy(engine=...)`` — and compares the measured speed-up against the
paper's analytical model (Eq. 1-4).

  PYTHONPATH=src python examples/torch/quickstart.py
"""

import time

import numpy as np

from repro_torch.core import cost_model
from repro_torch.data.trk import iter_streamlines_multi, synth_trk
from repro_torch.io import IOPolicy, PrefetchFS, open_store
from repro_torch.store import MemTier

# --- 1. a bucket of .trk shards behind a simulated S3 link ------------------
LATENCY, BANDWIDTH = 0.02, 45e6           # scaled Table I constants
BLOCK = 256 << 10
BUCKET = f"sims3://hydi?latency_ms={LATENCY * 1e3:g}&bw_mbps={BANDWIDTH / 1e6:g}"

rng = np.random.default_rng(0)
objects = {f"hydi/shard{i}.trk": synth_trk(rng, 4000, mean_points=15)
           for i in range(4)}


def fresh_store():
    # fresh=True: each A/B arm gets its own link so neither inherits the
    # other's bandwidth-reservation state.
    store = open_store(BUCKET, fresh=True)
    for k, v in objects.items():
        store.backing.put(k, v)   # seed the substrate (no simulated cost)
    return store


def consume(f):
    """The application: lazily parse every streamline (affine applied on
    read — compute happens during reading, as in the paper)."""
    n = sum(1 for _ in iter_streamlines_multi(f, f.size))
    f.close()
    return n


# --- 2. sequential (S3Fs-style) baseline -------------------------------------
store = fresh_store()
fs = PrefetchFS(store, policy=IOPolicy(engine="sequential", blocksize=BLOCK))
t0 = time.perf_counter()
n = consume(fs.open_many(store.backing.list_objects()))
t_seq = time.perf_counter() - t0
print(f"sequential: {t_seq:.2f}s ({n} streamlines)")

# --- 3. Rolling Prefetch: same open, different policy -------------------------
store = fresh_store()
tier = MemTier(capacity=4 << 20)  # bounded cache: dataset streams through
fs = PrefetchFS(
    store,
    policy=IOPolicy(engine="rolling", blocksize=BLOCK, eviction_interval_s=0.05),
    tiers=[tier],
)
t0 = time.perf_counter()
n = consume(fs.open_many(store.backing.list_objects()))
t_pf = time.perf_counter() - t0
print(f"rolling prefetch: {t_pf:.2f}s ({n} streamlines)")
print(f"measured speed-up: {t_seq / t_pf:.2f}x  (paper bound: < 2x)")
print("fs stats:", fs.stats().snapshot()["totals"])

# --- 4. compare with the paper's model (Eq. 1-3) -----------------------------
total = sum(len(v) for v in objects.values())
n_b = total / BLOCK
c = max(0.0, (t_seq - n_b * LATENCY - total / BANDWIDTH)) / total  # fit c
p = cost_model.CostParams(f=total, n_b=int(n_b), l_c=LATENCY,
                          b_cr=BANDWIDTH, c=c)
print(f"model-predicted speed-up (Eq. 3): {cost_model.speedup(p):.2f}x")
print(f"optimal block size (Eq. 4): "
      f"{cost_model.optimal_blocksize(total, c, LATENCY) / 1024:.0f} KiB "
      f"(this run used {BLOCK / 1024:.0f} KiB)")
