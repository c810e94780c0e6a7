"""PeerAwareStore: ownership-routed reads over a `PeerGroup`.

The composite store the ``peer://`` URI builds: every range GET is routed
to the block's *home* host first (`PeerGroup.owner_of`, rendezvous over
the alive members):

  * self-owned block → direct backing-store GET (we ARE the home; our
    local `BlockServer` + `CacheIndex` make it resident for siblings);
  * remote-owned block → ``owner=True`` fetch RPC to the home host,
    which serves it from cache or performs the ONE backing GET for the
    whole group (cross-host single-flight);
  * dead home / failed RPC / peer miss → direct backing GET. Degraded,
    never broken: peer faults cost WAN traffic, not correctness.

`PrefetchFS` recognizes the wrapper the same way it recognizes
`HSMStore` — it adopts ``tiers`` + ``index`` but keeps reading THROUGH
the wrapper, because the routing above lives in ``get_range`` /
``get_ranges``. Composes with ``hsm://`` by nesting: a ``backing=`` that
resolves to an `HSMStore` contributes its hierarchy, and the peer layer
routes whatever misses it.
"""

from __future__ import annotations

import threading
from urllib.parse import unquote

from repro_torch.io.integrity import block_digest
from repro_torch.peer.client import PeerClient
from repro_torch.peer.group import PeerGroup, PeerSpec
from repro_torch.peer.protocol import span_block_id
from repro_torch.peer.server import BlockServer
from repro_torch.peer.tier import PeerTier
from repro_torch.store.base import (
    MultipartUpload,
    ObjectMeta,
    ObjectStore,
    StoreError,
)
from repro_torch.store.hsm import (
    HSMIndex,
    HSMStore,
    MEM_LINK,
    parse_size,
)
from repro_torch.store.link import LinkModel, PeerLinkModel
from repro_torch.store.tiers import CacheIndex, CacheTier, MemTier
from repro_torch.utils import get_logger

log = get_logger("peer.store")


class PeerAwareStore(ObjectStore):
    def __init__(
        self,
        inner: ObjectStore,
        group: PeerGroup,
        *,
        tiers: list[CacheTier] | None = None,
        index: CacheIndex | None = None,
        server: BlockServer | None = None,
        owns_hierarchy: bool = False,
    ) -> None:
        if isinstance(inner, PeerAwareStore):
            raise ValueError("peer store cannot wrap another peer store")
        self.inner = inner
        self.group = group
        self.tiers = list(tiers) if tiers is not None else []
        self.index = index
        self.server = server
        self._owns_hierarchy = owns_hierarchy
        self._lock = threading.Lock()
        # Integrity posture for peer-served bytes. The transport already
        # verifies every BLOCK frame against its header digest; "full"
        # additionally cross-checks peer-served bytes against the
        # *backing store's* digest (`inner.digest_range`) — the one
        # authority a self-consistent byzantine sibling cannot forge.
        self.verify = "edges"
        # Telemetry (surfaced as FSStats.peer).
        self.peer_hits = 0             # blocks served by a sibling
        self.peer_misses = 0           # sibling probe came back empty
        self.local_fetches = 0         # self-owned blocks (direct GETs)
        self.dead_peer_fallbacks = 0   # home dead/unreachable -> direct GET
        self.integrity_rejects = 0     # peer bytes failed the cross-check
        self.bytes_from_peers = 0
        self.fallback_bytes = 0

    # -- routed reads --------------------------------------------------------
    def _route(self, key: str, start: int, end: int) -> tuple[PeerClient | None, int]:
        owner = self.group.owner_of(span_block_id(key, start, end))
        if owner == self.group.self_id:
            return None, owner
        return self.group.client_for(owner), owner

    def _fetch_via_peer(self, client: PeerClient, owner: int,
                        key: str, start: int, end: int) -> bytes | None:
        """One routed attempt; None means "use the backing store" (and
        the reason is already counted)."""
        try:
            data = client.fetch(key, start, end, owner=True)
        except StoreError as e:
            # PeerError or a retry-exhausted StoreError: the home is
            # suspect, the read is not.
            self.group.note_failure(owner)
            with self._lock:
                self.dead_peer_fallbacks += 1
            log.warning("peer %d fetch failed (%s); falling back to store",
                        owner, e)
            return None
        if data is None:
            with self._lock:
                self.peer_misses += 1
            return None
        with self._lock:
            self.peer_hits += 1
            self.bytes_from_peers += len(data)
        if self.verify == "full" and not self._cross_check(
                owner, key, start, end, data):
            return None
        return data

    def _cross_check(self, owner: int, key: str, start: int, end: int,
                     data: bytes) -> bool:
        """"full"-mode defense: compare peer-served bytes against the
        backing store's own digest of the range. Honest about its cost —
        the default `digest_range` reads the range from the store — which
        is why only "full" pays it. A failed check demotes the sibling
        (`note_failure`) and sends the caller to the backing store."""
        try:
            ref = self.inner.digest_range(key, start, end)
        except StoreError:
            return True   # no authority reachable; frame digest stands
        if ref == block_digest(data):
            return True
        self.group.note_failure(owner)
        with self._lock:
            self.integrity_rejects += 1
        log.warning(
            "peer %d served bytes for %s[%d:%d] that contradict the "
            "backing store (%s); falling back", owner, key, start, end, ref,
        )
        return False

    def get_range(self, key: str, start: int, end: int) -> bytes:
        client, owner = self._route(key, start, end)
        if client is not None:
            data = self._fetch_via_peer(client, owner, key, start, end)
            if data is not None:
                return data
        with self._lock:
            if client is None and owner == self.group.self_id:
                self.local_fetches += 1
            elif client is None:
                self.dead_peer_fallbacks += 1
            self.fallback_bytes += end - start
        return self.inner.get_range(key, start, end)

    def get_ranges(self, key: str, spans: list[tuple[int, int]]) -> list[bytes]:
        out: list[bytes | None] = [None] * len(spans)
        need: list[int] = []
        for i, (start, end) in enumerate(spans):
            client, owner = self._route(key, start, end)
            if client is not None:
                out[i] = self._fetch_via_peer(client, owner, key, start, end)
            if out[i] is None:
                with self._lock:
                    if client is None and owner == self.group.self_id:
                        self.local_fetches += 1
                    elif client is None:
                        self.dead_peer_fallbacks += 1
                    self.fallback_bytes += end - start
                need.append(i)
        if need:
            # One vectorized backing request for everything unrouted —
            # adjacent self-owned spans still coalesce inside the store.
            datas = self.inner.get_ranges(key, [spans[i] for i in need])
            for i, d in zip(need, datas):
                out[i] = d
        return out  # type: ignore[return-value]

    # -- verified reads ------------------------------------------------------
    # Peer-served bytes arrive frame-verified (PeerClient checked the
    # payload against the sibling's attested digest), so hashing them
    # here re-mints the SAME digest the sibling sent; fallback reads get
    # the backing store's own attestation. Either way the caller holds a
    # digest that covers the exact bytes returned.
    def get_range_verified(self, key: str, start: int,
                           end: int) -> tuple[bytes, str]:
        client, owner = self._route(key, start, end)
        if client is not None:
            data = self._fetch_via_peer(client, owner, key, start, end)
            if data is not None:
                return data, block_digest(data)
        with self._lock:
            if client is None and owner == self.group.self_id:
                self.local_fetches += 1
            elif client is None:
                self.dead_peer_fallbacks += 1
            self.fallback_bytes += end - start
        return self.inner.get_range_verified(key, start, end)

    def get_ranges_verified(
        self, key: str, spans: list[tuple[int, int]],
    ) -> list[tuple[bytes, str]]:
        out: list[tuple[bytes, str] | None] = [None] * len(spans)
        need: list[int] = []
        for i, (start, end) in enumerate(spans):
            client, owner = self._route(key, start, end)
            data = None
            if client is not None:
                data = self._fetch_via_peer(client, owner, key, start, end)
            if data is not None:
                out[i] = (data, block_digest(data))
            else:
                with self._lock:
                    if client is None and owner == self.group.self_id:
                        self.local_fetches += 1
                    elif client is None:
                        self.dead_peer_fallbacks += 1
                    self.fallback_bytes += end - start
                need.append(i)
        if need:
            pairs = self.inner.get_ranges_verified(
                key, [spans[i] for i in need])
            for i, pair in zip(need, pairs):
                out[i] = pair
        return out  # type: ignore[return-value]

    def digest_range(self, key: str, start: int, end: int) -> str:
        # Always the backing store's answer: this is the authoritative
        # reference the "full" cross-check compares peers against, so it
        # must never itself be peer-derived.
        return self.inner.digest_range(key, start, end)

    # -- plain delegation ----------------------------------------------------
    def get(self, key: str) -> bytes:
        # Whole-object reads (manifests, metadata) skip peer routing:
        # they are not block-shaped, so siblings would never have them
        # under a matching id.
        return self.inner.get(key)

    def list_objects(self, prefix: str = "") -> list[ObjectMeta]:
        return self.inner.list_objects(prefix)

    def size(self, key: str) -> int:
        return self.inner.size(key)

    def put(self, key: str, data: bytes) -> None:
        self.inner.put(key, data)

    def delete(self, key: str) -> None:
        self.inner.delete(key)

    def start_multipart(self, key: str) -> MultipartUpload:
        return self.inner.start_multipart(key)

    # -- telemetry / lifecycle ----------------------------------------------
    def peer_snapshot(self) -> dict:
        with self._lock:
            out = dict(
                peer_hits=self.peer_hits,
                peer_misses=self.peer_misses,
                local_fetches=self.local_fetches,
                dead_peer_fallbacks=self.dead_peer_fallbacks,
                integrity_rejects=self.integrity_rejects,
                bytes_from_peers=self.bytes_from_peers,
                fallback_bytes=self.fallback_bytes,
            )
        out["group"] = self.group.snapshot()
        if self.server is not None:
            out["server"] = self.server.snapshot()
        return out

    def close(self) -> None:
        if self.server is not None:
            self.server.close()
        self.group.close()
        if self._owns_hierarchy:
            if isinstance(self.inner, HSMStore):
                self.inner.close()
            else:
                if self.index is not None and hasattr(self.index, "close"):
                    self.index.close()
                for t in self.tiers:
                    t.close()


PEER_URI_PARAMS = {
    "backing", "self", "peers", "serve", "mem", "peer_tier",
    "peer_latency_ms", "peer_bw_mbps", "peer_rps", "heartbeat_ms",
    "verify",
}


def build_peer(uri, open_inner) -> PeerAwareStore:
    """Assemble a `PeerAwareStore` from a parsed ``peer://`` `StoreURI`::

        peer://?self=0&peers=0@127.0.0.1:9100,1@127.0.0.1:9101
              &backing=sims3%3A%2F%2Fbucket%3Flatency_ms%3D40&mem=64MB

    Params: ``self=<id>`` (required) and ``peers=<id>@<host>:<port>,...``
    (the static membership; must include self's serving address unless
    ``serve=0``); ``backing=<uri>`` (required, percent-encode nested
    queries — composing with ``hsm://`` adopts that hierarchy); ``mem``
    (local cache for a non-hsm backing, default 64MB); ``peer_tier=1``
    appends a `PeerTier` below the local tiers so HSM demotions spill to
    siblings instead of the floor; ``peer_latency_ms`` /
    ``peer_bw_mbps`` / ``peer_rps`` shape the LAN `PeerLinkModel`;
    ``heartbeat_ms`` enables liveness probing.

    ``open_inner`` resolves the backing URI (injected by the registry to
    keep this module import-cycle-free of the io layer).
    """
    uri.require_known_params(PEER_URI_PARAMS)
    backing_uri = uri.params.get("backing")
    if not backing_uri:
        raise ValueError("peer:// URI needs backing=<store uri>")
    if "self" not in uri.params:
        raise ValueError("peer:// URI needs self=<host id>")
    self_id = int(uri.params["self"])
    specs = [PeerSpec.parse(unquote(s))
             for s in uri.params.get("peers", "").split(",") if s]

    link = PeerLinkModel(
        latency_s=(uri.float_param("peer_latency_ms",
                                   PeerLinkModel.latency_s * 1e3) or 0.0) / 1e3,
        bandwidth_Bps=(
            uri.float_param("peer_bw_mbps") * 1e6
            if uri.float_param("peer_bw_mbps") is not None
            else PeerLinkModel.bandwidth_Bps
        ),
        rps_limit=(uri.float_param("peer_rps")
                   if uri.float_param("peer_rps") is not None
                   else float("inf")),
    )
    heartbeat_ms = uri.float_param("heartbeat_ms")
    group = PeerGroup(
        self_id, specs, link=link,
        heartbeat_interval_s=(heartbeat_ms / 1e3 if heartbeat_ms else None),
    )

    backing = open_inner(backing_uri)
    if isinstance(backing, HSMStore):
        if uri.params.get("mem") or uri.params.get("peer_tier"):
            raise ValueError(
                "peer:// with an hsm:// backing adopts that hierarchy; "
                "mem=/peer_tier= apply only to plain backings"
            )
        raw, tiers, index = backing.inner, backing.tiers, backing.index
        inner_for_close: ObjectStore = backing
    else:
        raw = backing
        mem_cap = parse_size(uri.params.get("mem", "64MB"))
        tiers = [MemTier(
            mem_cap,
            read_link=LinkModel(name="peer.mem.r", **MEM_LINK),
            write_link=LinkModel(name="peer.mem.w", **MEM_LINK),
            name="peer.mem",
        )]
        if uri.params.get("peer_tier") not in (None, "", "0"):
            tiers.append(PeerTier(group))
        if len(tiers) > 1:
            # Cost-ordered walk + demote-not-evict across mem -> peers.
            index = HSMIndex(tiers, mover_interval_s=None)
        else:
            index = CacheIndex(tiers, keep_cached=True)
        inner_for_close = raw

    server = None
    if uri.params.get("serve", "1") not in ("0", "false"):
        spec = group.specs.get(self_id)
        if spec is None or not spec.host:
            raise ValueError(
                "peer:// needs self's serving address in peers= "
                "(or serve=0 for a client-only member)"
            )
        server = BlockServer(index, raw, host=spec.host, port=spec.port,
                             host_id=self_id)

    store = PeerAwareStore(
        inner_for_close if isinstance(inner_for_close, HSMStore) else raw,
        group, tiers=tiers, index=index, server=server, owns_hierarchy=True,
    )
    verify = uri.params.get("verify")
    if verify is not None:
        if verify not in ("off", "edges", "full"):
            raise ValueError(
                f"peer:// verify= must be off/edges/full, got {verify!r}"
            )
        store.verify = verify
    return store
