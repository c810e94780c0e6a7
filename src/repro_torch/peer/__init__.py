"""Distributed prefetch: sibling hosts' caches as one shared tier.

See README "Distributed prefetch". The pieces:

  * `protocol` — length-prefixed socket framing + `PeerError`;
  * `BlockServer` — serves the local `CacheIndex`/tiers to siblings and
    performs the group's single backing-store GET for blocks homed here;
  * `PeerClient` — pooled, retried, fault-injectable RPC endpoint;
  * `PeerGroup` / `PeerSpec` — static membership, rendezvous ownership,
    heartbeats (dead peer == cache miss, never an error);
  * `PeerTier` — the sibling caches as a `CacheTier` for HSM hierarchies;
  * `PeerAwareStore` — ownership-routed reads (the ``peer://`` store);
  * `sim` — in-process multi-host harness (`SimCluster`), imported
    lazily: it depends on `repro_torch.io`, which itself recognizes
    `PeerAwareStore`, and eager import here would close that cycle.
"""

from repro_torch.peer.client import PEER_RETRY, PeerClient
from repro_torch.peer.group import PeerGroup, PeerSpec
from repro_torch.peer.protocol import (
    PEER_OPS,
    PeerError,
    parse_block_id,
    span_block_id,
)
from repro_torch.peer.server import BlockServer
from repro_torch.peer.store import PEER_URI_PARAMS, PeerAwareStore, build_peer
from repro_torch.peer.tier import PeerTier

__all__ = [
    "BlockServer",
    "PeerClient",
    "PeerGroup",
    "PeerSpec",
    "PeerTier",
    "PeerAwareStore",
    "PeerError",
    "PEER_OPS",
    "PEER_RETRY",
    "PEER_URI_PARAMS",
    "build_peer",
    "span_block_id",
    "parse_block_id",
    "SimCluster",
    "SimHost",
]


def __getattr__(name: str):
    if name in ("SimCluster", "SimHost", "sim"):
        import repro_torch.peer.sim as sim
        if name == "sim":
            return sim
        return getattr(sim, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
