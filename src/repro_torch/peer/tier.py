"""PeerTier: sibling hosts' caches as one level of the local hierarchy.

A `CacheTier` whose backing medium is the rest of the `PeerGroup`: reads
are non-owner fetch RPCs to the block's home host (pure cache probes —
a peer tier read NEVER triggers a backing-store GET, so the LAN cost its
`TierCostModel` advertises is honest), writes are push RPCs to the home
host (how an HSM demotes a cooling block out of local memory/disk
without losing it to the WAN), deletes only forget the local view (a
sibling's copy is the sibling's to evict).

Slot it between local disk and the backing store::

    peer  = PeerTier(group)
    index = HSMIndex([mem, disk, peer], store_link=wan)

`TierCostModel.from_tier` seeds the placement cost from the tier's
links, which here are the group's shared `PeerLinkModel` — so the HSM's
cost ordering puts it exactly where a ~0.2 ms / 1.25 GB/s LAN hop
belongs: below local media, far above the WAN.

Transport billing note: `PeerClient` bills every payload to the peer
link, so this tier's `read`/`write` overrides skip `CacheTier`'s own
link charge — one block moved over the LAN is billed once.

Integrity note: every block that crosses the LAN is frame-verified by
the transport — `PeerClient.fetch` checks the payload against the
digest the home host attested in the frame header, and `put` attests
what it pushes (the home host re-verifies before publishing). A frame
that fails the check surfaces here as a `StoreError`, which the index
treats like any lost tier block: invalidate and re-fetch from the next
authority. The tier itself therefore sets ``verifies_reads`` — a read
that returns at all returned digest-checked bytes.
"""

from __future__ import annotations

import threading

from repro_torch.peer.group import PeerGroup
from repro_torch.peer.protocol import PeerError, parse_block_id
from repro_torch.store.base import StoreError
from repro_torch.store.tiers import BlockMeta, CacheTier


class PeerTier(CacheTier):
    #: Nominal capacity: the aggregate of the siblings' caches is not
    #: locally bounded (each sibling enforces its own budgets), so the
    #: tier advertises effectively-infinite space and relies on remote
    #: admission (a push may come back "rejected") for pressure.
    DEFAULT_CAPACITY = 1 << 40

    #: Reads arrive digest-checked by the transport (see module
    #: docstring), so "edges" verification need not re-hash them.
    verifies_reads = True

    def __init__(self, group: PeerGroup, capacity: int = DEFAULT_CAPACITY,
                 *, name: str = "peer") -> None:
        super().__init__(capacity, read_link=group.link,
                         write_link=group.link, name=name)
        self.group = group
        # Local view of what we pushed/observed remotely: block_id -> size.
        # Advisory only — a sibling may evict behind our back, in which
        # case a read raises StoreError and the index invalidates the
        # entry (the same contract as a sibling-evicted DirTier file).
        self._known: dict[str, int] = {}
        self._known_lock = threading.Lock()
        # Telemetry.
        self.remote_reads = 0
        self.remote_writes = 0
        self.lost_blocks = 0   # reads that found the sibling copy gone

    # -- link billing override ----------------------------------------------
    # The transport (PeerClient) bills group.link per payload; billing
    # again here would double-charge the LAN. The links stay attached so
    # TierCostModel.from_tier seeds peer-accurate constants.
    def read(self, block_id: str, start: int = 0, end: int | None = None) -> bytes:
        return self._read(block_id, start, end)

    def write(self, block_id: str, data: bytes, *,
              meta: BlockMeta | None = None, durable: bool = True) -> None:
        prev = self._size_of(block_id)
        self._store_block(block_id, data, meta, durable)
        if prev > 0:
            with self._lock:
                self._used = max(0, self._used - prev)

    # -- backend hooks ------------------------------------------------------
    def _read(self, block_id: str, start: int, end: int | None) -> bytes:
        key, lo, hi = parse_block_id(block_id)
        owner = self.group.owner_of(block_id)
        client = self.group.client_for(owner)
        if client is None:
            # Self-owned or dead home: nothing a *peer* tier can serve.
            raise StoreError(
                f"{self.name}: no live home for {block_id} (owner {owner})"
            )
        try:
            data = client.fetch(key, lo, hi, owner=False)
        except PeerError as e:
            self.group.note_failure(owner)
            raise StoreError(f"{self.name}: {e}") from e
        if data is None:
            with self._known_lock:
                if self._known.pop(block_id, None) is not None:
                    self.lost_blocks += 1
            raise StoreError(
                f"{self.name}: block evicted by sibling {owner}: {block_id}"
            )
        with self._known_lock:
            self.remote_reads += 1
            self._known.setdefault(block_id, len(data))
        return data[start:end if end is not None else len(data)]

    def _store_block(self, block_id: str, data: bytes,
                     meta: BlockMeta | None, durable: bool) -> None:
        key, lo, hi = parse_block_id(block_id)
        owner = self.group.owner_of(block_id)
        client = self.group.client_for(owner)
        if client is None:
            raise StoreError(
                f"{self.name}: no live home to push {block_id} to "
                f"(owner {owner})"
            )
        try:
            stored = client.put(key, lo, hi, bytes(data))
        except PeerError as e:
            self.group.note_failure(owner)
            raise StoreError(f"{self.name}: {e}") from e
        if not stored:
            raise StoreError(
                f"{self.name}: sibling {owner} rejected {block_id}"
            )
        with self._known_lock:
            self.remote_writes += 1
            self._known[block_id] = len(data)

    def _write(self, block_id: str, data: bytes) -> None:
        self._store_block(block_id, data, None, True)

    def _delete(self, block_id: str) -> int:
        # Forget, don't reach across the wire: the copy on the home host
        # belongs to that host's cache (it may be serving other siblings).
        with self._known_lock:
            return self._known.pop(block_id, 0)

    def _contains(self, block_id: str) -> bool:
        with self._known_lock:
            return block_id in self._known

    def _size_of(self, block_id: str) -> int:
        with self._known_lock:
            return self._known.get(block_id, 0)

    def _resident_bytes(self) -> int:
        with self._known_lock:
            return sum(self._known.values())

    # resident_blocks() stays the base-class empty list on purpose: peer
    # residency must not be primed into a fresh CacheIndex (the blocks
    # live on siblings whose own indices already track them).
