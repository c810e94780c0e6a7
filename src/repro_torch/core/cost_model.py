"""The paper's analytical performance model (§II-B, Eq. 1-4).

All times in seconds, sizes in bytes, bandwidths in bytes/sec.

  T_seq  = n_b * l_c + f / b_cr + c * f                              (Eq. 1)
  T_pf   = T_cloud + (n_b - 1) * max(T_cloud, T_comp) + T_comp       (Eq. 2)
  S      = T_seq / T_pf < 2                                          (Eq. 3)
  n̂_b   = sqrt(c * f / l_c)                                         (Eq. 4)

with
  T_cloud = l_c + f/(b_cr n_b) + l_l + f/(b_lw n_b)   (cloud read + local write)
  T_comp  = l_l + f/(b_lr n_b) + c f / n_b            (local read + compute)
"""

from __future__ import annotations

import math
from dataclasses import dataclass


@dataclass(frozen=True)
class CostParams:
    f: float          # total bytes
    n_b: int          # number of blocks
    l_c: float        # cloud latency per request (s)
    b_cr: float       # cloud read bandwidth (B/s)
    c: float          # compute seconds per byte
    l_l: float = 0.0  # local-storage latency (s)
    b_lw: float = float("inf")  # local write bandwidth
    b_lr: float = float("inf")  # local read bandwidth


def t_cloud(p: CostParams) -> float:
    """Download one block from cloud and write it to local storage."""
    return p.l_c + p.f / (p.b_cr * p.n_b) + p.l_l + p.f / (p.b_lw * p.n_b)


def t_comp(p: CostParams) -> float:
    """Read one block from local storage and process it."""
    return p.l_l + p.f / (p.b_lr * p.n_b) + p.c * p.f / p.n_b


def t_seq(p: CostParams) -> float:
    """Eq. 1 — sequential transfers (S3Fs)."""
    return p.n_b * p.l_c + p.f / p.b_cr + p.c * p.f


def t_pf(p: CostParams) -> float:
    """Eq. 2 — Rolling Prefetch."""
    tc, tp = t_cloud(p), t_comp(p)
    return tc + (p.n_b - 1) * max(tc, tp) + tp


def speedup(p: CostParams) -> float:
    """Eq. 3 — predicted speed-up of prefetch over sequential."""
    return t_seq_pf_consistent(p) / t_pf(p)


def t_seq_pf_consistent(p: CostParams) -> float:
    """T_seq including local I/O terms so that T_seq and T_pf compare the
    same physical work when local storage is not free. With the paper's
    simplifying assumption (l_l=0, b_l*=inf) this equals Eq. 1."""
    return t_seq(p)


def speedup_bound(p: CostParams) -> float:
    """1 + (n_b - 1) * min(T_cloud, T_comp)/T_pf — the paper's derivation
    under free local storage; strictly < 2."""
    tc, tp = t_cloud(p), t_comp(p)
    return 1.0 + (p.n_b - 1) * min(tc, tp) / t_pf(p)


def optimal_num_blocks(f: float, c: float, l_c: float) -> float:
    """Eq. 4 — n̂_b = sqrt(c f / l_c), valid when l_l << l_c."""
    if l_c <= 0:
        return float("inf")
    return math.sqrt(c * f / l_c)


def optimal_blocksize(f: float, c: float, l_c: float) -> float:
    nb = optimal_num_blocks(f, c, l_c)
    return f / max(nb, 1.0)


def is_latency_bound(l_c: float, b_cr: float, blocksize: float) -> bool:
    """True when one request's fixed latency exceeds its payload transfer
    time — the regime where Eq. 1's `n_b * l_c` term dominates and
    coalescing adjacent blocks into one request wins."""
    if blocksize <= 0:
        return False
    if b_cr <= 0 or math.isinf(b_cr):
        return l_c > 0
    return l_c > blocksize / b_cr


def coalesce_width(l_c: float, b_cr: float, blocksize: float,
                   max_width: int) -> int:
    """How many adjacent blocks one GET should carry.

    A width-`w` request costs `l_c + w*blocksize/b_cr`, i.e. per block
    `l_c/w + blocksize/b_cr`. Growing `w` amortizes latency until the
    latency share drops below the (irreducible) transfer share, so the
    knee is `w = ceil(l_c * b_cr / blocksize)`; wider requests only
    coarsen the prefetch pipeline (Eq. 2's per-block overlap granularity)
    for no further gain. Bandwidth-bound links (`l_c <= blocksize/b_cr`)
    get width 1 — coalescing cannot help there.
    """
    if max_width <= 1 or l_c <= 0 or blocksize <= 0:
        return 1
    if b_cr <= 0 or math.isinf(b_cr):
        return max_width
    per_block_s = blocksize / b_cr
    if l_c <= per_block_s:
        return 1
    return max(1, min(max_width, math.ceil(l_c / per_block_s)))
