"""PeerGroup: static membership + liveness for one job's sibling hosts.

The group answers two questions the peer data path asks constantly:

  * **who owns this block?** — rendezvous hashing over the *alive*
    member ids (`repro_torch.utils.hashing.rendezvous_owner`, the same
    function `BlockPlan.shard` partitions prefetch plans with, so warmed
    shards and remote routing agree byte for byte);
  * **is that host alive?** — a static peer list refined by heartbeats
    (a ping thread; `miss_limit` consecutive failures mark a peer dead,
    one success revives it) and by data-path reports (`note_failure`
    after an RPC exhausts its retries).

A dead peer is never an error: `owner_of` simply stops electing it, its
blocks redistribute uniformly over the survivors (the rendezvous
property), and callers holding an in-flight request against it degrade
to the backing store. Membership is static by design — the mesh of
`launch/mesh.py` is fixed at job start, and `ft/elastic.py` handles
replacement hosts by warming them from survivors, not by mutating the
group.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Iterable

from repro_torch.io.retry import RetryPolicy
from repro_torch.peer.client import PeerClient
from repro_torch.store.link import LinkModel, PeerLinkModel
from repro_torch.utils import get_logger, rendezvous_owner

log = get_logger("peer.group")


@dataclass(frozen=True)
class PeerSpec:
    """One member of the group: a stable small-integer host id (the
    rendezvous candidate AND the mesh host id `BlockPlan.shard` takes)
    plus the address its `BlockServer` listens on."""

    host_id: int
    host: str
    port: int

    @classmethod
    def parse(cls, spec: str) -> "PeerSpec":
        """``"<id>@<host>:<port>"`` (the ``peers=`` URI grammar)."""
        ident, _, addr = spec.partition("@")
        host, _, port = addr.rpartition(":")
        if not ident or not host or not port:
            raise ValueError(
                f"peer spec must be '<id>@<host>:<port>', got {spec!r}"
            )
        return cls(host_id=int(ident), host=host, port=int(port))


class PeerGroup:
    def __init__(
        self,
        self_id: int,
        peers: Iterable[PeerSpec],
        *,
        link: LinkModel | None = None,
        retry: RetryPolicy | None = None,
        rpc_timeout_s: float = 10.0,
        heartbeat_interval_s: float | None = None,
        miss_limit: int = 2,
        faults=None,
    ) -> None:
        self.self_id = self_id
        self.specs: dict[int, PeerSpec] = {}
        for p in peers:
            if p.host_id in self.specs:
                raise ValueError(f"duplicate peer id {p.host_id}")
            self.specs[p.host_id] = p
        # Self need not carry an address (a client-only member never
        # serves), but it IS a rendezvous candidate: blocks it owns are
        # fetched directly from the backing store.
        self.specs.setdefault(self_id, PeerSpec(self_id, "", 0))
        #: One shared LAN link for all sibling hops — peer traffic
        #: contends with itself, the way one NIC serves all siblings.
        self.link = link if link is not None else PeerLinkModel()
        self.miss_limit = miss_limit
        self._clients: dict[int, PeerClient] = {
            pid: PeerClient((spec.host, spec.port), link=self.link,
                            retry=retry, timeout_s=rpc_timeout_s,
                            faults=faults, peer_id=pid)
            for pid, spec in self.specs.items() if pid != self_id
        }
        self._lock = threading.Lock()
        self._alive: dict[int, bool] = {pid: True for pid in self.specs}
        self._misses: dict[int, int] = {pid: 0 for pid in self.specs}
        # Telemetry.
        self.deaths = 0
        self.revivals = 0
        self.heartbeats = 0
        self._stop = threading.Event()
        self._hb_thread: threading.Thread | None = None
        if heartbeat_interval_s is not None:
            self._hb_thread = threading.Thread(
                target=self._heartbeat_loop, args=(heartbeat_interval_s,),
                name=f"peer-heartbeat-{self_id}", daemon=True,
            )
            self._hb_thread.start()

    # -- membership ---------------------------------------------------------
    def alive_ids(self) -> list[int]:
        with self._lock:
            return sorted(pid for pid, up in self._alive.items() if up)

    def is_alive(self, host_id: int) -> bool:
        with self._lock:
            return self._alive.get(host_id, False)

    def owner_of(self, block_id: str) -> int:
        """The alive host this block is homed on. Self is always a
        candidate (we cannot declare ourselves dead), so the set is
        never empty."""
        with self._lock:
            alive = [pid for pid, up in self._alive.items() if up]
            if self.self_id not in self._alive or not self._alive[self.self_id]:
                alive.append(self.self_id)
        return rendezvous_owner(block_id, alive)

    def client_for(self, host_id: int) -> PeerClient | None:
        """The RPC endpoint for an alive remote sibling; None for self,
        unknown ids, and dead peers (callers degrade to the store)."""
        if host_id == self.self_id or not self.is_alive(host_id):
            return None
        return self._clients.get(host_id)

    def mark_dead(self, host_id: int) -> None:
        if host_id == self.self_id:
            return
        with self._lock:
            if self._alive.get(host_id):
                self._alive[host_id] = False
                self.deaths += 1
                log.warning("peer %d marked dead", host_id)

    def note_failure(self, host_id: int) -> None:
        """Data path report: an RPC to this peer exhausted its retries.
        Counts toward the same miss limit as failed heartbeats, so a
        sick peer is demoted by whoever notices first."""
        if host_id == self.self_id:
            return
        with self._lock:
            self._misses[host_id] = self._misses.get(host_id, 0) + 1
            if (self._misses[host_id] >= self.miss_limit
                    and self._alive.get(host_id)):
                self._alive[host_id] = False
                self.deaths += 1
                log.warning("peer %d marked dead after %d failures",
                            host_id, self._misses[host_id])

    def _note_success(self, host_id: int) -> None:
        with self._lock:
            self._misses[host_id] = 0
            if not self._alive.get(host_id, True):
                self._alive[host_id] = True
                self.revivals += 1
                log.info("peer %d revived", host_id)

    # -- heartbeats ---------------------------------------------------------
    def _heartbeat_loop(self, interval_s: float) -> None:
        while not self._stop.wait(interval_s):
            for pid, client in list(self._clients.items()):
                if self._stop.is_set():
                    return
                with self._lock:
                    self.heartbeats += 1
                if client.ping():
                    self._note_success(pid)
                else:
                    self.note_failure(pid)

    # -- lifecycle ----------------------------------------------------------
    def close(self) -> None:
        self._stop.set()
        if self._hb_thread is not None:
            self._hb_thread.join(timeout=2.0)
        for c in self._clients.values():
            c.close()

    def snapshot(self) -> dict:
        with self._lock:
            alive = sorted(pid for pid, up in self._alive.items() if up)
        clients = {pid: c.snapshot() for pid, c in self._clients.items()}
        return dict(
            self_id=self.self_id,
            alive=alive,
            members=sorted(self.specs),
            deaths=self.deaths,
            revivals=self.revivals,
            heartbeats=self.heartbeats,
            rpcs=sum(c["rpcs"] for c in clients.values()),
            rpc_failures=sum(c["failures"] for c in clients.values()),
            bytes_from_peers=sum(c["bytes_received"] for c in clients.values()),
            bytes_to_peers=sum(c["bytes_sent"] for c in clients.values()),
        )
