"""Rendezvous (highest-random-weight) hashing.

The one ownership function shared by the distributed-prefetch layers:
`repro_torch.peer.PeerGroup` maps a block id to its home host with it, and
`BlockPlan.shard` partitions a prefetch plan with the SAME function — so
the blocks a host warms proactively are exactly the blocks its siblings
will come asking it for.

Rendezvous hashing (vs a ring with virtual nodes) keeps the property the
peer layer leans on: removing a candidate reassigns ONLY that candidate's
items, uniformly across the survivors — a dead host's blocks spread over
the remaining peers with no other block changing owner.
"""

from __future__ import annotations

import hashlib
from typing import Iterable, Sequence


def _weight(item: str, candidate: int) -> int:
    h = hashlib.blake2b(f"{candidate}\x00{item}".encode(), digest_size=8)
    return int.from_bytes(h.digest(), "big")


def rendezvous_owner(item: str, candidates: Sequence[int] | Iterable[int]) -> int:
    """The candidate id owning `item`: argmax of a keyed hash, stable
    under candidate-set changes (deterministic across hosts and runs —
    no process seeding involved). Ties broken by the smaller id (blake2b
    collisions at digest_size=8 are negligible, but determinism must not
    depend on iteration order)."""
    best_id: int | None = None
    best_w = -1
    for c in candidates:
        w = _weight(item, c)
        if w > best_w or (w == best_w and (best_id is None or c < best_id)):
            best_id, best_w = c, w
    if best_id is None:
        raise ValueError("rendezvous_owner: empty candidate set")
    return best_id
