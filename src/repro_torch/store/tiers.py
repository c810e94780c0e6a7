"""Bounded local cache tiers for Rolling Prefetch, plus the shared
crash-consistent cache index.

The paper writes prefetched blocks to a priority-ordered list of local
storage devices (tmpfs first, then disk), each with a user-set byte budget.
`used` accounting intentionally mirrors Algorithm 1: the prefetch thread
increments `used` optimistically, and reconciles with reality via
`verify_used()` when it believes a tier is full (evictions may have freed
space since the last check).

Two extensions turn the tiers from per-reader scratch space into a shared
cache subsystem (cf. the successor user-space HSM work, arXiv:2404.11556,
and the shared-cache analysis of arXiv:2108.06322):

  * `CacheIndex` — a refcounted residency map over a list of tiers with
    single-flight fetch registration: N readers of the same key trigger
    ONE store GET per block, a block pinned by any reader is never evicted
    out from under it, and unpinned blocks can stay resident (LRU-evicted
    only under capacity pressure) so a second epoch or a second reader
    starts warm.
  * persistent `DirTier` — every durable block write appends a journal
    record (block id, key, offset, length, checksum) next to the block
    files; a reconstructed tier replays the journal, drops torn/partial
    blocks by checksum, deletes orphans, and starts with its index (and
    `used` accounting) warm — a restarted job pays zero store GETs for
    blocks that survived the crash.
"""

from __future__ import annotations

import abc
import contextlib
import json
import os
import threading
import time
import zlib
from collections import OrderedDict
from dataclasses import dataclass
from urllib.parse import quote, unquote

from repro_torch.store.base import IntegrityError, StoreError
from repro_torch.store.link import LinkModel
from repro_torch.utils import get_logger

try:
    import fcntl
except ImportError:   # non-POSIX: no advisory root locking
    fcntl = None

log = get_logger("store.tiers")


@dataclass(frozen=True)
class BlockMeta:
    """Provenance of a cached block, journaled by persistent tiers so a
    recovered cache can be audited against the store."""

    key: str
    offset: int


class CacheTier(abc.ABC):
    """A bounded block cache with simulated (or real) transfer costs."""

    #: True when full-block reads are verified by the tier itself (the
    #: DirTier's journal-crc check) — engines running ``verify="edges"``
    #: trust such tiers and skip re-hashing what the tier just hashed;
    #: ``verify="full"`` re-checks regardless.
    verifies_reads = False

    def __init__(
        self,
        capacity: int,
        read_link: LinkModel | None = None,
        write_link: LinkModel | None = None,
        name: str = "tier",
    ) -> None:
        self.capacity = capacity
        self.read_link = read_link if read_link is not None else LinkModel(name=f"{name}.r")
        self.write_link = write_link if write_link is not None else LinkModel(name=f"{name}.w")
        self.name = name
        # Position in a storage hierarchy (0 = fastest). A flat tier list
        # leaves it at 0; the HSM assigns levels and persistent tiers
        # journal it with each block (the tier-generation field), so a
        # recovered block is known to have lived at this level.
        self.level = 0
        self._used = 0       # optimistic accounting: committed + in-flight
        self._inflight = 0   # reserved but not yet written
        self._lock = threading.Lock()

    # -- Algorithm-1 accounting -------------------------------------------
    @property
    def used(self) -> int:
        with self._lock:
            return self._used

    def available(self) -> int:
        with self._lock:
            return self.capacity - self._used

    def reserve(self, nbytes: int) -> bool:
        """Optimistically claim space (prefetch thread)."""
        with self._lock:
            if self.capacity - self._used < nbytes:
                return False
            self._used += nbytes
            self._inflight += nbytes
            return True

    def commit(self, nbytes: int) -> None:
        """The reserved bytes are now resident (write completed)."""
        with self._lock:
            self._inflight = max(0, self._inflight - nbytes)

    def cancel(self, nbytes: int) -> None:
        """A reservation was abandoned (fetch failed permanently)."""
        with self._lock:
            self._inflight = max(0, self._inflight - nbytes)
            self._used = max(0, self._used - nbytes)

    def release(self, nbytes: int) -> None:
        """Committed bytes were evicted."""
        with self._lock:
            self._used = max(0, self._used - nbytes)

    def verify_used(self) -> int:
        """Reconcile `used` with the bytes actually resident plus in-flight
        reservations (evictions may have freed space since the last check).
        Returns available space after reconciliation. Mirrors the paper's
        `verify_used()` in Algorithm 1."""
        actual = self._resident_bytes()
        with self._lock:
            self._used = min(self._used, max(actual, 0) + self._inflight)
            return self.capacity - self._used

    # -- storage ops (charged to the tier's links) --------------------------
    def write(self, block_id: str, data: bytes, *,
              meta: BlockMeta | None = None, durable: bool = True) -> None:
        """Store a block. ``meta`` is journaled by persistent tiers;
        ``durable=False`` marks transient staging data (write-behind parts)
        that must NOT survive a restart and is invisible to
        :meth:`resident_blocks`.

        Overwriting an already-resident ``block_id`` credits the replaced
        bytes back to `used` under the accounting lock — a reserve+write of
        a block that was already there must not double-count its size until
        some later `verify_used()` happens to run.
        """
        self.write_link.transfer(len(data))
        prev = self._size_of(block_id)
        self._store_block(block_id, data, meta, durable)
        if prev > 0:
            with self._lock:
                self._used = max(0, self._used - prev)

    def read(self, block_id: str, start: int = 0, end: int | None = None) -> bytes:
        data = self._read(block_id, start, end)
        self.read_link.transfer(len(data))
        return data

    def delete(self, block_id: str) -> int:
        """Remove the block; returns bytes freed. Does NOT adjust `used`
        (that is the prefetcher's job via verify_used / explicit release),
        matching the paper's decoupled eviction."""
        return self._delete(block_id)

    def contains(self, block_id: str) -> bool:
        return self._contains(block_id)

    def resident_blocks(self) -> list[tuple[str, int]]:
        """(block_id, size) of every durable resident block — what a
        `CacheIndex` primes itself with at construction. Transient staging
        blocks (``durable=False`` writes) are excluded."""
        return []

    def close(self) -> None:
        """Release tier-held OS resources (persistent tiers hold an
        advisory root lock). Cached blocks stay on their medium."""

    # -- backend hooks ------------------------------------------------------
    def _store_block(self, block_id: str, data: bytes,
                     meta: BlockMeta | None, durable: bool) -> None:
        """Backend write entry point; the default delegates to the legacy
        `_write` hook so subclasses that only override `_write` keep
        working."""
        self._write(block_id, data)

    def _size_of(self, block_id: str) -> int:
        """Bytes currently resident under `block_id` (0 when absent)."""
        return 0

    @abc.abstractmethod
    def _write(self, block_id: str, data: bytes) -> None: ...

    @abc.abstractmethod
    def _read(self, block_id: str, start: int, end: int | None) -> bytes: ...

    @abc.abstractmethod
    def _delete(self, block_id: str) -> int: ...

    @abc.abstractmethod
    def _contains(self, block_id: str) -> bool: ...

    @abc.abstractmethod
    def _resident_bytes(self) -> int: ...


class MemTier(CacheTier):
    """Dict-backed tier modeling tmpfs (costs from the tier's LinkModel)."""

    def __init__(self, capacity: int, **kw) -> None:
        super().__init__(capacity, **kw)
        self._blocks: dict[str, bytes] = {}
        self._transient: set[str] = set()
        self._blk_lock = threading.Lock()

    def _store_block(self, block_id: str, data: bytes,
                     meta: BlockMeta | None, durable: bool) -> None:
        self._write(block_id, data)   # via the hook so subclasses see it
        with self._blk_lock:
            if durable:
                self._transient.discard(block_id)
            else:
                self._transient.add(block_id)

    def _write(self, block_id: str, data: bytes) -> None:
        with self._blk_lock:
            self._blocks[block_id] = bytes(data)

    def _read(self, block_id: str, start: int, end: int | None) -> bytes:
        with self._blk_lock:
            try:
                data = self._blocks[block_id]
            except KeyError:
                raise StoreError(f"{self.name}: block missing: {block_id}") from None
        return data[start:end if end is not None else len(data)]

    def _delete(self, block_id: str) -> int:
        with self._blk_lock:
            data = self._blocks.pop(block_id, None)
            self._transient.discard(block_id)
            return len(data) if data is not None else 0

    def _contains(self, block_id: str) -> bool:
        with self._blk_lock:
            return block_id in self._blocks

    def _size_of(self, block_id: str) -> int:
        with self._blk_lock:
            data = self._blocks.get(block_id)
            return len(data) if data is not None else 0

    def _resident_bytes(self) -> int:
        with self._blk_lock:
            return sum(len(v) for v in self._blocks.values())

    def resident_blocks(self) -> list[tuple[str, int]]:
        with self._blk_lock:
            return [(bid, len(data)) for bid, data in self._blocks.items()
                    if bid not in self._transient]


class DirTier(CacheTier):
    """Real-directory tier (an actual tmpfs mount or scratch disk), with a
    journaled on-disk index so the cache survives restarts.

    Layout under ``root``::

        _index.jsonl          append-only journal of put/del records
        blk-<quoted-id>       one file per block (atomic tmp+replace)

    Block filenames percent-escape the block id (``quote(id, safe="")``),
    which is injective — the old ``id.replace("/", "__")`` mapped distinct
    ids ``a/b`` and ``a__b`` onto the same file and silently served wrong
    bytes.

    Durable writes append ``{"op": "put", id, key, off, len, crc}`` after
    the block file is atomically in place; deletes append a tombstone.
    Construction replays the journal (a torn trailing record is ignored),
    drops entries whose file is missing or fails the length/crc check
    (torn blocks), deletes orphaned block/tmp files, compacts the journal,
    and seeds `used` with the recovered bytes — so a restarted job's
    `CacheIndex` starts warm and `verify_used()` is already consistent.
    """

    INDEX_NAME = "_index.jsonl"
    LOCK_NAME = ".lock"
    JOURNAL_LOCK_NAME = ".journal.lock"
    BLOCK_PREFIX = "blk-"
    _COMPACT_SLACK = 1024   # journal records beyond live entries before compact

    def __init__(self, capacity: int, root: str, *,
                 verify_reads: bool = True, faults=None, **kw) -> None:
        super().__init__(capacity, **kw)
        self.root = root
        # Steady-state integrity: recovery has always crc-checked blocks,
        # but a block that rots AFTER recovery used to be served as-is
        # for the life of the process. With ``verify_reads`` every
        # full-block read recomputes the journal crc and raises
        # `IntegrityError` on mismatch (partial reads are not coverable
        # by a whole-block crc and pass through). ``faults`` is an
        # optional chaos hook (`FaultSchedule`): a fired ``flip_at_rest``
        # rule mutates the resident block file before the read, so the
        # detection path is exercisable deterministically.
        self.verifies_reads = verify_reads
        self.faults = faults
        self.integrity_failures = 0
        os.makedirs(root, exist_ok=True)
        self._journal_path = os.path.join(root, self.INDEX_NAME)
        self._journal_lock = threading.Lock()
        self._journal_records = 0
        self._live: dict[str, int] = {}        # block_id -> size (durable)
        self._meta: dict[str, dict] = {}       # block_id -> journal record
        self._transient: set[str] = set()
        self.recovered_blocks = 0
        self.discarded_blocks = 0
        # Advisory exclusive lock on the root: only the owner runs the
        # DESTRUCTIVE parts of recovery (orphan sweep, torn-file removal,
        # journal compaction). A second tier over the same directory —
        # another replica sharing a node's cache dir — still recovers the
        # journal read-only and serves/writes blocks, but never deletes a
        # live sibling's files or rewrites its journal records.
        self._lock_file = None
        self._owner_marker: str | None = None
        self.owns_root = True
        if fcntl is not None:
            f = open(os.path.join(root, self.LOCK_NAME), "a+b")  # noqa: SIM115
            try:
                fcntl.flock(f.fileno(), fcntl.LOCK_EX | fcntl.LOCK_NB)
                self._lock_file = f
            except OSError:
                f.close()
                self.owns_root = False
                log.warning(
                    "%s: cache root %s is owned by another live tier; "
                    "recovery cleanup and journal compaction are disabled "
                    "in this instance", self.name, root,
                )
        else:
            # Non-POSIX fallback: no advisory flock, so ownership is an
            # O_EXCL marker file — strictly single-owner (first opener
            # wins; every later opener recovers read-only). Without this,
            # every opener believed it owned the root and two live tiers
            # would delete each other's blocks as "orphans". The marker
            # is removed on close(); a crash leaves it behind, making the
            # NEXT opener conservatively read-only (delete the marker by
            # hand to reclaim ownership) — safe, never destructive.
            marker = os.path.join(root, self.LOCK_NAME + ".owner")
            try:
                fd = os.open(marker, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
                with contextlib.suppress(OSError):
                    os.write(fd, str(os.getpid()).encode("ascii"))
                os.close(fd)
                self._owner_marker = marker
            except FileExistsError:
                self.owns_root = False
                log.warning(
                    "%s: cache root %s has an owner marker (another live "
                    "tier, or a stale one from a crash); recovery cleanup "
                    "and journal compaction are disabled in this instance",
                    self.name, root,
                )
        self._recover()
        with self._lock:
            self._used = sum(self._live.values())

    def close(self) -> None:
        """Release the advisory root lock (blocks and journal stay on
        disk — that is the point). A later DirTier over the same root
        becomes the owner."""
        with self._journal_lock:
            if self._lock_file is not None:
                with contextlib.suppress(OSError):
                    fcntl.flock(self._lock_file.fileno(), fcntl.LOCK_UN)
                with contextlib.suppress(OSError):
                    self._lock_file.close()
                self._lock_file = None
            if self._owner_marker is not None:
                with contextlib.suppress(OSError):
                    os.remove(self._owner_marker)
                self._owner_marker = None

    # -- paths --------------------------------------------------------------
    def _path(self, block_id: str) -> str:
        # quote() is collision-free (every reserved byte, including "%"
        # itself, escapes to a unique %XX); the BLOCK_PREFIX keeps block
        # files disjoint from the journal.
        return os.path.join(self.root, self.BLOCK_PREFIX + quote(block_id, safe=""))

    def _id_from_filename(self, fn: str) -> str:
        return unquote(fn[len(self.BLOCK_PREFIX):])

    # -- journal ------------------------------------------------------------
    @contextlib.contextmanager
    def _journal_guard(self):
        """Cross-process serialization of journal appends/compaction for
        siblings sharing one root (a separate flock from the ownership
        lock, which the owner holds for its whole lifetime). In-process
        callers already hold `_journal_lock`; never nest this guard."""
        if fcntl is None:
            yield
            return
        with open(os.path.join(self.root, self.JOURNAL_LOCK_NAME), "a+b") as lf:
            fcntl.flock(lf.fileno(), fcntl.LOCK_EX)
            try:
                yield
            finally:
                fcntl.flock(lf.fileno(), fcntl.LOCK_UN)

    def _append_journal(self, rec: dict) -> None:
        """Caller holds `_journal_lock`."""
        with self._journal_guard():
            with open(self._journal_path, "a", encoding="utf-8") as f:
                f.write(json.dumps(rec, separators=(",", ":")) + "\n")
            self._journal_records += 1
            # Both owner AND non-owner compact: the rewrite replays the
            # file under the cross-process flock (sibling records survive
            # by construction), and without this a churning non-owner
            # would grow the journal unboundedly while the owner idles.
            if self._journal_records > len(self._live) + self._COMPACT_SLACK:
                self._compact_journal()

    def _replay_journal(self) -> dict[str, dict]:
        """Fold the journal file into its final per-id state (put records
        minus tombstones). A torn trailing record from a crash is
        ignored."""
        entries: dict[str, dict] = {}
        try:
            with open(self._journal_path, encoding="utf-8") as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        continue   # torn trailing record from a crash
                    if rec.get("op") == "put" and "id" in rec:
                        entries[rec["id"]] = rec
                    elif rec.get("op") == "del" and "id" in rec:
                        entries.pop(rec["id"], None)
        except OSError:
            pass
        return entries

    def _compact_journal(self) -> None:
        """Rewrite the journal with only live entries. The rewrite replays
        the FILE (not just this instance's in-memory view, which is a
        subset of it) so records appended by a non-owner sibling sharing
        this root survive the compaction; the caller-held `_journal_guard`
        flock keeps a sibling from appending mid-rewrite. Caller holds
        `_journal_lock` AND `_journal_guard`."""
        entries = self._replay_journal()
        tmp = self._journal_path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            for rec in entries.values():
                f.write(json.dumps(rec, separators=(",", ":")) + "\n")
        os.replace(tmp, self._journal_path)
        self._journal_records = len(entries)

    def _recover(self) -> None:
        entries = self._replay_journal()
        live: dict[str, dict] = {}
        for bid, rec in entries.items():
            path = self._path(bid)
            try:
                with open(path, "rb") as f:
                    data = f.read()
            except OSError:
                self.discarded_blocks += 1
                continue
            if (len(data) != rec.get("len")
                    or (zlib.crc32(data) & 0xFFFFFFFF) != rec.get("crc")):
                # Torn/partial block: the journal promised different
                # bytes. Never trusted; the file itself is removed only
                # by the root owner (a non-owner may be racing a sibling
                # whose write is mid-flight).
                self.discarded_blocks += 1
                if self.owns_root:
                    with contextlib.suppress(OSError):
                        os.remove(path)
                continue
            live[bid] = rec
        self._live = {bid: rec["len"] for bid, rec in live.items()}
        self._meta = live
        self.recovered_blocks = len(live)
        if not self.owns_root:
            return
        # Orphan sweep + compaction (owner only), under the journal flock
        # with a FRESH replay: anything a live sibling journaled since
        # our first read is known, not an orphan, and survives the
        # rewrite. Orphans proper are tmp leftovers and block files no
        # journal record committed (including transient write-behind
        # staging from a crashed producer).
        with self._journal_lock, self._journal_guard():
            known = set(live) | set(self._replay_journal())
            try:
                for fn in os.listdir(self.root):
                    full = os.path.join(self.root, fn)
                    if fn.endswith(".tmp") or (
                            fn.startswith(self.BLOCK_PREFIX)
                            and self._id_from_filename(fn) not in known):
                        with contextlib.suppress(OSError):
                            os.remove(full)
            except OSError:
                pass
            self._compact_journal()

    # -- backend hooks ------------------------------------------------------
    def _store_block(self, block_id: str, data: bytes,
                     meta: BlockMeta | None, durable: bool) -> None:
        path = self._path(block_id)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)
        # Journal record AFTER the block is atomically in place: a crash
        # between replace and append leaves an orphan file that recovery
        # deletes — never a journal entry pointing at missing bytes.
        with self._journal_lock:
            if durable:
                rec = {"op": "put", "id": block_id, "len": len(data),
                       "crc": zlib.crc32(data) & 0xFFFFFFFF,
                       "key": meta.key if meta is not None else None,
                       "off": meta.offset if meta is not None else None,
                       "lvl": self.level}
                self._meta[block_id] = rec
                self._live[block_id] = len(data)
                self._transient.discard(block_id)
                self._append_journal(rec)
            else:
                self._transient.add(block_id)
                self._live.pop(block_id, None)
                self._meta.pop(block_id, None)

    def _write(self, block_id: str, data: bytes) -> None:
        self._store_block(block_id, data, None, True)

    def _read(self, block_id: str, start: int, end: int | None) -> bytes:
        if self.faults is not None:
            self._maybe_rot(block_id)
        try:
            with open(self._path(block_id), "rb") as f:
                f.seek(start)
                data = f.read(None if end is None else end - start)
        except OSError:
            raise StoreError(f"{self.name}: block missing: {block_id}") from None
        if self.verifies_reads and start == 0:
            with self._journal_lock:
                rec = self._meta.get(block_id)
            # Only a read that covers the whole journaled block can be
            # checked against the whole-block crc.
            if (rec is not None and len(data) == rec.get("len")
                    and (zlib.crc32(data) & 0xFFFFFFFF) != rec.get("crc")):
                with self._journal_lock:
                    self.integrity_failures += 1
                raise IntegrityError(
                    f"{self.name}: journal crc mismatch for {block_id} "
                    f"(block rotted at rest)"
                )
        return data

    def _maybe_rot(self, block_id: str) -> None:
        """Chaos hook: when the schedule fires a ``flip_at_rest`` rule
        for this block, flip one byte of the resident file in place —
        at-rest bit rot between write and read."""
        rules = self.faults.decide("at_rest", block_id)
        if not any(getattr(r, "kind", None) == "flip_at_rest" for r in rules):
            return
        path = self._path(block_id)
        try:
            with open(path, "r+b") as f:
                f.seek(0, os.SEEK_END)
                size = f.tell()
                if size == 0:
                    return
                pos = size // 2
                f.seek(pos)
                byte = f.read(1)
                f.seek(pos)
                f.write(bytes([byte[0] ^ 0xFF]))
        except OSError:
            pass   # nothing resident to rot

    def _delete(self, block_id: str) -> int:
        path = self._path(block_id)
        try:
            size = os.path.getsize(path)
            os.remove(path)
        except OSError:
            return 0
        with self._journal_lock:
            if block_id in self._live:
                self._live.pop(block_id, None)
                self._meta.pop(block_id, None)
                try:
                    self._append_journal({"op": "del", "id": block_id})
                except OSError as e:
                    # Best-effort tombstone: delete() is called from
                    # eviction threads that must survive a full disk
                    # (ENOSPC is exactly when eviction runs). A lost
                    # tombstone is crash-safe — recovery finds a `put`
                    # whose file is gone and discards it.
                    log.warning("%s: journal tombstone failed for %s: %s",
                                self.name, block_id, e)
            self._transient.discard(block_id)
        return size

    def _contains(self, block_id: str) -> bool:
        return os.path.exists(self._path(block_id))

    def _size_of(self, block_id: str) -> int:
        try:
            return os.path.getsize(self._path(block_id))
        except OSError:
            return 0

    def _resident_bytes(self) -> int:
        total = 0
        try:
            for fn in os.listdir(self.root):
                if fn.startswith(self.BLOCK_PREFIX) and not fn.endswith(".tmp"):
                    total += os.path.getsize(os.path.join(self.root, fn))
        except OSError:
            pass
        return total

    def resident_blocks(self) -> list[tuple[str, int]]:
        with self._journal_lock:
            return list(self._live.items())

    def digest_of(self, block_id: str) -> str | None:
        """Canonical digest of a journaled block (``"crc32:%08x"``, the
        same value `repro_torch.io.integrity.block_digest` mints), so a
        recovered cache primes the `CacheIndex` with verifiable entries
        and the peer server can attest recovered blocks it serves."""
        with self._journal_lock:
            rec = self._meta.get(block_id)
            if rec is None or rec.get("crc") is None:
                return None
            return f"crc32:{rec['crc'] & 0xFFFFFFFF:08x}"

    def journaled_level(self, block_id: str) -> int | None:
        """Tier-generation of a recovered block: the hierarchy level this
        tier occupied when the block was journaled (pre-``lvl`` journals
        return None). The HSM uses it to re-seed heat for blocks that
        lived at a hotter level before the restart."""
        with self._journal_lock:
            rec = self._meta.get(block_id)
            return rec.get("lvl") if rec is not None else None


@dataclass(frozen=True)
class TierPlacement:
    """Where a cached block lives."""

    tier: CacheTier
    block_id: str


# --------------------------------------------------------------------------- #
# shared cache index: refcounts + single-flight fetch registration
# --------------------------------------------------------------------------- #
class CacheFlight:
    """One in-progress fetch of a block, owned by exactly one leader.
    Readers that arrive while it is in flight register as waiters and are
    pinned automatically when the leader publishes.

    ``started_t`` (monotonic creation time) drives the index's stale-flight
    reclamation: a leader that dies without `publish`/`abort_fetch` leaves
    the flight registered forever, and every later reader of the block
    would wedge on it. Past ``CacheIndex.flight_ttl_s`` the index expires
    the flight (``reclaimed``), fails its waiters, and lets the next
    `acquire()` elect a new leader."""

    __slots__ = ("block_id", "done", "tier", "error", "waiters", "io_class",
                 "started_t", "reclaimed")

    def __init__(self, block_id: str, io_class: str = "default") -> None:
        self.block_id = block_id
        self.done = False
        self.tier: CacheTier | None = None
        self.error: Exception | None = None
        self.waiters = 0
        self.io_class = io_class
        self.started_t = time.monotonic()
        self.reclaimed = False


class _IndexEntry:
    __slots__ = ("tier", "size", "refs", "evict_requested", "io_class",
                 "digest")

    def __init__(self, tier: CacheTier, size: int, refs: int,
                 io_class: str = "default",
                 digest: str | None = None) -> None:
        self.tier = tier
        self.size = size
        self.refs = refs
        self.evict_requested = False
        self.io_class = io_class
        # Content digest minted at the block's first store fetch (None
        # for verify="off" producers): the reference every later tier
        # read, HSM move, and peer-served frame is checked against.
        self.digest = digest


class CacheIndex:
    """Shared residency map over a list of cache tiers.

    Three guarantees:

      * **single flight** — `acquire()` returns ``("leader", flight)`` to
        exactly one caller per missing block; everyone else gets
        ``("wait", flight)`` and `join()`s the leader's fetch, so N
        concurrent readers of the same object issue ~1x (not Nx) store
        GETs;
      * **refcounted eviction** — every ``("hit", ...)`` and every
        published block holds a pin; `unpin(want_evict=True)` deletes the
        block from its tier only when the LAST pin drops, so a block one
        reader is using is never evicted out from under another;
      * **warm reuse** — with ``keep_cached=True`` (or for blocks nobody
        asked to evict) unpinned blocks stay resident and are LRU-evicted
        by `evict_from()` only under capacity pressure; construction
        primes the map from each tier's `resident_blocks()`, so a
        persistent `DirTier` makes a restarted job start warm.

    Thread-safe; safe to call while holding an engine lock (the index
    never calls back into an engine).
    """

    #: Default stale-flight TTL (seconds). Generous: it only has to beat
    #: a *dead* leader, and live leaders finish or abort far sooner (the
    #: engines' own per-fetch retry deadlines are single-digit seconds).
    FLIGHT_TTL_S = 30.0

    def __init__(self, tiers: list[CacheTier], *, keep_cached: bool = False,
                 flight_ttl_s: float | None = FLIGHT_TTL_S) -> None:
        self.tiers = list(tiers)
        self.keep_cached = keep_cached
        self.flight_ttl_s = flight_ttl_s
        self._cond = threading.Condition()
        self._entries: dict[str, _IndexEntry] = {}
        self._flights: dict[str, CacheFlight] = {}
        self._evictable: OrderedDict[str, None] = OrderedDict()
        # Blocks whose tier files are being deleted right now (entry
        # already removed, file I/O in progress OUTSIDE the lock).
        # acquire() waits these out so a re-fetch can never be deleted by
        # a stale eviction racing its fresh write.
        self._deleting: set[str] = set()
        self.hits = 0            # acquires served from a resident block
        self.misses = 0          # acquires that became fetch leaders
        self.joins = 0           # acquires that joined another reader's fetch
        self.evictions = 0       # blocks actually deleted from a tier
        self.recovered = 0       # blocks primed from persistent tiers
        self.reclaims = 0        # stale flights expired (leader presumed dead)
        self.quarantined = 0     # blocks evicted+tombstoned on digest mismatch
        for tier in self.tiers:
            tier_digest = getattr(tier, "digest_of", None)
            for block_id, size in tier.resident_blocks():
                if block_id not in self._entries:
                    dg = tier_digest(block_id) if tier_digest else None
                    self._entries[block_id] = _IndexEntry(tier, size, refs=0,
                                                          digest=dg)
                    self._evictable[block_id] = None
                    self.recovered += 1

    def set_keep_cached(self, keep: bool) -> None:
        """Flip the retention policy (an open requesting warm reuse over
        an index created without it upgrades it for everyone sharing the
        tier list)."""
        with self._cond:
            self.keep_cached = keep

    # -- residency / single flight ------------------------------------------
    def acquire(self, block_id: str, io_class: str = "default"):
        """Returns ``("hit", tier)`` with a pin taken, ``("leader",
        flight)`` when the caller must fetch the block (finish with
        `publish` or `abort_fetch`), or ``("wait", flight)`` when another
        reader's fetch is in flight (finish with `join` or `leave`).

        ``io_class`` names the workload class (``IOPolicy.io_class``)
        making the access — ignored here, consumed by the HSM subclass
        for heat tracking and per-class admission."""
        with self._cond:
            while block_id in self._deleting:
                self._cond.wait(timeout=0.5)
            e = self._entries.get(block_id)
            if e is not None:
                e.refs += 1
                self._evictable.pop(block_id, None)
                self.hits += 1
                self._note_hit(block_id, e, io_class)
                return "hit", e.tier
            fl = self._flights.get(block_id)
            if fl is not None and not self._maybe_reclaim(fl):
                fl.waiters += 1
                self.joins += 1
                return "wait", fl
            fl = CacheFlight(block_id, io_class)
            self._flights[block_id] = fl
            self.misses += 1
            return "leader", fl

    def _maybe_reclaim(self, fl: CacheFlight) -> bool:
        """Expire a flight whose leader has been silent past the TTL
        (died without `publish`/`abort_fetch`). Its waiters observe a
        ``("failed", ...)`` join and re-acquire — the next acquire elects
        a new leader — so neither the engines nor the cross-host peer
        path can wedge on a dead leader. Caller holds `_cond`. Returns
        True when the flight was reclaimed (it is no longer registered)."""
        if (self.flight_ttl_s is None or fl.done
                or time.monotonic() - fl.started_t < self.flight_ttl_s):
            return False
        fl.reclaimed = True
        fl.done = True
        fl.error = StoreError(
            f"fetch of {fl.block_id} reclaimed after {self.flight_ttl_s:g}s "
            f"(leader presumed dead)"
        )
        if self._flights.get(fl.block_id) is fl:
            del self._flights[fl.block_id]
        self.reclaims += 1
        self._cond.notify_all()
        return True

    def publish(self, flight: CacheFlight, tier: CacheTier, size: int,
                digest: str | None = None) -> None:
        """Leader: the block is written to `tier`. The entry is pinned once
        for the leader plus once per registered waiter (each waiter's
        `join` returns an already-pinned hit).

        A slow-but-alive leader whose flight was already reclaimed does
        NOT register an entry — a new leader owns the block id now, and
        overwriting its entry would corrupt refcounts. Its bytes are in
        the tier regardless (same content-addressed id, same bytes), so
        the waiters observe the reclamation's "failed" join (never an
        unpinned hit), re-acquire, and find the new leader's entry; at
        worst the duplicate copy is reconciled by the next `verify_used()`
        walk."""
        with self._cond:
            if flight.reclaimed:
                flight.done = True
                self._cond.notify_all()
                return
            e = _IndexEntry(tier, size, refs=1 + flight.waiters,
                            io_class=flight.io_class, digest=digest)
            self._entries[flight.block_id] = e
            self._on_insert(flight.block_id, e)
            flight.done = True
            flight.tier = tier
            if self._flights.get(flight.block_id) is flight:
                del self._flights[flight.block_id]
            self._cond.notify_all()

    def abort_fetch(self, flight: CacheFlight, error: Exception | None = None) -> None:
        """Leader: the fetch failed or was abandoned; waiters observe the
        error (or a bare retry signal) and re-acquire. The identity check
        on the registry pop matters after a reclamation: a zombie leader's
        late abort must not unregister the NEW leader's flight."""
        with self._cond:
            flight.done = True
            flight.error = error
            if self._flights.get(flight.block_id) is flight:
                del self._flights[flight.block_id]
            self._cond.notify_all()

    def join(self, flight: CacheFlight, timeout: float | None = None):
        """Waiter: wait for the leader. ``("hit", tier)`` (pin already
        taken by `publish`), ``("failed", error)``, or ``("timeout",
        None)`` — keep join()ing or `leave()`. A join that times out past
        the flight TTL reclaims the stale flight itself (waiters must not
        depend on some future `acquire()` to notice the dead leader)."""
        with self._cond:
            self._cond.wait_for(lambda: flight.done, timeout)
            if not flight.done:
                if self._maybe_reclaim(flight):
                    return "failed", flight.error
                return "timeout", None
            if flight.tier is not None:
                return "hit", flight.tier
            return "failed", flight.error

    def leave(self, flight: CacheFlight) -> None:
        """Waiter: stop waiting on a flight. If the leader already
        published (pinning on our behalf), the pin is released."""
        release = None
        with self._cond:
            if not flight.done:
                flight.waiters -= 1
            elif flight.tier is not None:
                release = flight.block_id
        if release is not None:
            self.unpin(release)

    def invalidate(self, block_id: str) -> None:
        """Drop a stale entry whose tier file vanished beneath it (a
        sibling process sharing a persistent cache dir evicted it).
        Readers still holding pins unpin harmlessly (no-op); the next
        acquire becomes a leader and re-fetches into the cache instead of
        paying a direct store GET on every read forever."""
        with self._cond:
            e = self._entries.pop(block_id, None)
            self._evictable.pop(block_id, None)
        if e is not None:
            # Converge the tier's byte accounting now rather than waiting
            # for the next verify_used() walk.
            e.tier.release(e.size)

    def digest_of(self, block_id: str) -> str | None:
        """Content digest carried by a resident block's entry (None when
        absent or minted by a verify="off" producer)."""
        with self._cond:
            e = self._entries.get(block_id)
            return e.digest if e is not None else None

    def quarantine(self, block_id: str) -> bool:
        """A reader caught the resident copy lying (digest mismatch):
        evict it NOW and tombstone the entry, regardless of pins — every
        pinned reader would read the same corrupt bytes, and their
        subsequent unpins are harmless no-ops (same contract as
        `invalidate`). Unlike `invalidate` (file already gone) the tier
        file is deleted here, so a persistent tier cannot re-prime the
        corrupt block after a restart. Returns True when an entry was
        actually removed."""
        with self._cond:
            e = self._entries.pop(block_id, None)
            if e is None:
                return False
            self._evictable.pop(block_id, None)
            self._deleting.add(block_id)
            self.quarantined += 1
        try:
            self._delete_from_tier(e.tier, block_id, e.size)
        finally:
            with self._cond:
                self._deleting.discard(block_id)
                self._cond.notify_all()
        return True

    # -- refcounted eviction -------------------------------------------------
    def unpin(self, block_id: str, *, want_evict: bool = False) -> bool:
        """Release one pin. With ``want_evict`` the caller asks for the
        block to be deleted (the rolling engine's consumed-block eviction);
        the delete happens only when the last pin drops, and not at all
        under ``keep_cached`` (capacity pressure evicts instead). Returns
        True when the block was actually deleted."""
        with self._cond:
            e = self._entries.get(block_id)
            if e is None:
                return False
            e.refs = max(0, e.refs - 1)
            if want_evict:
                e.evict_requested = True
            if e.refs > 0:
                return False
            if self.keep_cached or not e.evict_requested:
                # Stays resident, LRU-evictable under pressure.
                self._note_evictable(block_id, e)
                return False
            del self._entries[block_id]
            self._evictable.pop(block_id, None)
            self._deleting.add(block_id)
        # File I/O (delete + a persistent tier's journal tombstone) runs
        # OUTSIDE the global lock; the `_deleting` tombstone makes a
        # concurrent acquire() of the same id wait instead of racing its
        # fresh re-write against this delete.
        try:
            self._delete_from_tier(e.tier, block_id, e.size)
        finally:
            with self._cond:
                self._deleting.discard(block_id)
                self.evictions += 1
                self._cond.notify_all()
        return True

    # -- subclass hooks (no-ops in the flat index) ---------------------------
    def _note_hit(self, block_id: str, e: _IndexEntry, io_class: str) -> None:
        """A resident block was pinned. Caller holds `_cond`."""

    def _on_insert(self, block_id: str, e: _IndexEntry) -> None:
        """A fetched block was published. Caller holds `_cond`."""

    def _note_evictable(self, block_id: str, e: _IndexEntry) -> None:
        """The last pin dropped and the block stays resident: record it as
        an eviction candidate. The flat index is a plain LRU (most
        recently unpinned last); the HSM places scan-resistant classes at
        the FRONT so a bulk sweep evicts its own blocks first. Caller
        holds `_cond`."""
        self._evictable[block_id] = None
        self._evictable.move_to_end(block_id)

    def evict_from(self, tier: CacheTier, nbytes: int,
                   requester: str | None = None) -> int:
        """Capacity pressure: delete least-recently-unpinned blocks from
        `tier` until at least `nbytes` are freed (or nothing unpinned is
        left). Pinned blocks are untouchable. Returns bytes freed.
        ``requester`` names the workload class applying the pressure —
        ignored here, consumed by the HSM subclass (demote-not-evict,
        protected classes)."""
        freed = 0
        with self._cond:
            victims = []
            for bid in list(self._evictable):
                e = self._entries.get(bid)
                if e is None or e.tier is not tier:
                    continue
                victims.append((bid, e))
                freed += e.size
                if freed >= nbytes:
                    break
            for bid, e in victims:
                del self._entries[bid]
                self._evictable.pop(bid, None)
                self._deleting.add(bid)
        if not victims:
            return 0
        try:
            for bid, e in victims:
                self._delete_from_tier(e.tier, bid, e.size)
        finally:
            with self._cond:
                for bid, _ in victims:
                    self._deleting.discard(bid)
                self.evictions += len(victims)
                self._cond.notify_all()
        return freed

    @staticmethod
    def _delete_from_tier(tier: CacheTier, block_id: str, size: int) -> None:
        if tier.contains(block_id):
            tier.delete(block_id)
            tier.release(size)

    # -- placement -------------------------------------------------------------
    def reserve_space(self, nbytes: int,
                      io_class: str = "default") -> CacheTier | None:
        """Priority-ordered tier walk shared by every engine: reconcile
        (`verify_used`) when a tier looks full, reserve, and LRU-evict
        unpinned index blocks under capacity pressure before giving up on
        a tier (Algorithm 1 + shared-cache pressure eviction). Returns the
        tier holding the reservation, or None when every tier is full of
        pinned/in-flight bytes. ``io_class`` is ignored here; the HSM
        subclass applies per-class admission (entry level, cost-ordered
        candidates)."""
        for cand in self.tiers:
            if cand.available() < nbytes:
                cand.verify_used()
            if cand.reserve(nbytes):
                return cand
            if (self.evict_from(cand, nbytes, requester=io_class) > 0
                    and cand.reserve(nbytes)):
                return cand
        return None

    # -- introspection --------------------------------------------------------
    def contains(self, block_id: str) -> bool:
        with self._cond:
            return block_id in self._entries

    def resident_count(self) -> int:
        with self._cond:
            return len(self._entries)

    def resident_bytes(self) -> int:
        with self._cond:
            return sum(e.size for e in self._entries.values())

    def snapshot(self) -> dict:
        with self._cond:
            return dict(
                hits=self.hits,
                misses=self.misses,
                joins=self.joins,
                evictions=self.evictions,
                recovered=self.recovered,
                reclaims=self.reclaims,
                quarantined=self.quarantined,
                resident_blocks=len(self._entries),
                resident_bytes=sum(e.size for e in self._entries.values()),
                inflight=len(self._flights),
                keep_cached=self.keep_cached,
            )
