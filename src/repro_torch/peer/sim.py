"""In-process multi-host simulation harness for the peer layer.

`SimCluster` stands up N complete hosts inside one process: each gets
its own cache tiers, `CacheIndex`, `BlockServer` on a loopback socket
(port 0 — the OS assigns, and the group specs are built AFTER every
server is bound, so membership carries real addresses), a `PeerGroup`
with its own egress `PeerLinkModel`, and a `PeerAwareStore`. All hosts
share ONE backing store — and therefore one backing `LinkModel`, which
is the physics of the experiment: the WAN is the contended resource, so
N hosts that each fetch everything divide one link's bandwidth by N,
while peer-routed hosts fetch once and fan out over N independent LAN
hops.

The backing store is wrapped in `CountingStore`, so tests and benchmarks
assert the headline number directly: ``cluster.backing_fetches`` is the
count of block GETs the whole cluster issued — ~1x the unique blocks
with peers working, ~Nx without.

``cluster.kill(i)`` closes host *i*'s server and group mid-run: siblings
observe connection errors, mark the peer dead, re-own its blocks
(rendezvous reassigns only the dead host's blocks), and degrade to
direct GETs — the host-death experiment of the issue, with zero read
errors expected throughout.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field

from repro_torch.io import IOPolicy, PrefetchFS
from repro_torch.peer.group import PeerGroup, PeerSpec
from repro_torch.peer.server import BlockServer
from repro_torch.peer.store import PeerAwareStore
from repro_torch.store.base import MultipartUpload, ObjectMeta, ObjectStore
from repro_torch.store.hsm import MEM_LINK
from repro_torch.store.link import LinkModel, PeerLinkModel
from repro_torch.store.tiers import CacheIndex, CacheTier, MemTier


class CountingStore(ObjectStore):
    """Transparent wrapper counting block fetches against the backing
    store (one `get_range` = one fetch; a vectorized `get_ranges` counts
    one fetch per span — spans are blocks, and block GETs are what the
    amplification claim is about)."""

    def __init__(self, inner: ObjectStore) -> None:
        self.inner = inner
        self._lock = threading.Lock()
        self.fetches = 0        # block-shaped range reads
        self.requests = 0       # store round trips carrying them
        self.bytes_fetched = 0

    def snapshot(self) -> dict:
        with self._lock:
            return dict(fetches=self.fetches, requests=self.requests,
                        bytes_fetched=self.bytes_fetched)

    def get_range(self, key: str, start: int, end: int) -> bytes:
        data = self.inner.get_range(key, start, end)
        with self._lock:
            self.fetches += 1
            self.requests += 1
            self.bytes_fetched += len(data)
        return data

    def get_ranges(self, key: str, spans: list[tuple[int, int]]) -> list[bytes]:
        datas = self.inner.get_ranges(key, spans)
        with self._lock:
            self.fetches += len(spans)
            self.requests += 1
            self.bytes_fetched += sum(len(d) for d in datas)
        return datas

    # Verified reads MUST delegate (not fall back to the base-class
    # hash-what-you-got default): when the inner store is a FaultyStore,
    # the digest has to attest the authoritative bytes, not whatever the
    # chaos layer mangled on the way out.
    def get_range_verified(self, key: str, start: int,
                           end: int) -> tuple[bytes, str]:
        data, digest = self.inner.get_range_verified(key, start, end)
        with self._lock:
            self.fetches += 1
            self.requests += 1
            self.bytes_fetched += len(data)
        return data, digest

    def get_ranges_verified(
        self, key: str, spans: list[tuple[int, int]],
    ) -> list[tuple[bytes, str]]:
        pairs = self.inner.get_ranges_verified(key, spans)
        with self._lock:
            self.fetches += len(spans)
            self.requests += 1
            self.bytes_fetched += sum(len(d) for d, _ in pairs)
        return pairs

    def digest_range(self, key: str, start: int, end: int) -> str:
        # The reference digest costs a real store read (the default
        # implementation fetches the range) — bill it like one, so
        # amplification claims stay honest under verify="full".
        digest = self.inner.digest_range(key, start, end)
        with self._lock:
            self.fetches += 1
            self.requests += 1
            self.bytes_fetched += end - start
        return digest

    def get(self, key: str) -> bytes:
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


@dataclass
class SimHost:
    host_id: int
    tiers: list[CacheTier]
    index: CacheIndex
    server: BlockServer
    group: PeerGroup
    store: PeerAwareStore
    alive: bool = True
    _fss: list[PrefetchFS] = field(default_factory=list)

    def open_fs(self, policy: IOPolicy | None = None, **kw) -> PrefetchFS:
        """A `PrefetchFS` over this host's peer store (it adopts the
        host's tiers + index; reads route through the peer layer)."""
        fs = PrefetchFS(self.store, policy, **kw)
        self._fss.append(fs)
        return fs


class SimCluster:
    def __init__(
        self,
        n_hosts: int,
        backing: ObjectStore,
        *,
        mem_bytes: int = 256 << 20,
        peer_latency_s: float = 2e-4,
        peer_bandwidth_Bps: float = 1.25e9,
        heartbeat_interval_s: float | None = None,
        miss_limit: int = 2,
        faults=None,
    ) -> None:
        if n_hosts < 1:
            raise ValueError(f"n_hosts must be >= 1, got {n_hosts}")
        self.backing = CountingStore(backing)
        self.hosts: list[SimHost] = []
        servers: list[tuple[list[CacheTier], CacheIndex, BlockServer]] = []
        # Bind every server first (port 0 -> kernel-assigned), THEN build
        # the groups: membership needs the full address map.
        for i in range(n_hosts):
            tiers: list[CacheTier] = [MemTier(
                mem_bytes,
                read_link=LinkModel(name=f"h{i}.mem.r", **MEM_LINK),
                write_link=LinkModel(name=f"h{i}.mem.w", **MEM_LINK),
                name=f"h{i}.mem",
            )]
            index = CacheIndex(tiers, keep_cached=True)
            server = BlockServer(index, self.backing, host="127.0.0.1",
                                 port=0, host_id=i)
            servers.append((tiers, index, server))
        specs = [PeerSpec(i, srv.address[0], srv.address[1])
                 for i, (_, _, srv) in enumerate(servers)]
        for i, (tiers, index, server) in enumerate(servers):
            group = PeerGroup(
                i, specs,
                link=PeerLinkModel(latency_s=peer_latency_s,
                                   bandwidth_Bps=peer_bandwidth_Bps,
                                   name=f"h{i}.peer"),
                heartbeat_interval_s=heartbeat_interval_s,
                miss_limit=miss_limit,
                faults=faults,
            )
            store = PeerAwareStore(self.backing, group, tiers=tiers,
                                   index=index, server=server)
            self.hosts.append(SimHost(i, tiers, index, server, group, store))

    # -- observability -------------------------------------------------------
    @property
    def backing_fetches(self) -> int:
        return self.backing.fetches

    def host(self, i: int) -> SimHost:
        return self.hosts[i]

    def snapshot(self) -> dict:
        return dict(
            backing=self.backing.snapshot(),
            hosts={h.host_id: h.store.peer_snapshot()
                   for h in self.hosts if h.alive},
        )

    # -- chaos ---------------------------------------------------------------
    def kill(self, i: int) -> None:
        """Hard-kill host `i` mid-run: its server stops answering and its
        own group goes away. Survivors detect the death through failed
        RPCs/heartbeats; nothing is announced — that is the point."""
        h = self.hosts[i]
        if not h.alive:
            return
        h.alive = False
        for fs in h._fss:
            try:
                fs.close()
            except Exception:   # repro: allow[RP005] — a dying host dies messy
                pass
        h.server.close()
        h.group.close()

    def close(self) -> None:
        for h in self.hosts:
            if h.alive:
                for fs in h._fss:
                    try:
                        fs.close()
                    except Exception:   # repro: allow[RP005] — shutdown close is best-effort
                        pass
                h.store.close()
                h.alive = False
