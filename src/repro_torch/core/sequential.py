"""Sequential-transfer baseline, modeling S3Fs/FSSpec on-demand block cache.

This is the paper's comparison point: data transfer and compute occur in
distinct phases. A ``read()`` that misses the single-block cache fetches
the containing block from the object store synchronously (paying one
request latency + bandwidth), then serves from memory. No background
threads, no overlap.

When the `PrefetchFS` facade hands this engine a shared `CacheIndex`
(i.e. the filesystem owns cache tiers), misses consult it first: blocks
another reader already fetched — or a recovered persistent `DirTier`
holds — are read from the local tier instead of the store, and
single-flight registration keeps N concurrent sequential readers of the
same object at ~1x store GETs. Constructed bare (no index), the engine
is byte- and request-identical to the paper's baseline.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import TYPE_CHECKING

from repro_torch.core.plan import Block, BlockPlan
from repro_torch.io.integrity import check_block
from repro_torch.io.retry import Retrier, RetryPolicy
from repro_torch.store.base import (
    IntegrityError,
    ObjectMeta,
    ObjectStore,
    StoreError,
    TransientStoreError,
)
from repro_torch.store.tiers import BlockMeta, CacheIndex

if TYPE_CHECKING:
    from repro_torch.core.autotune import BlockSizeTuner


@dataclass
class SequentialStats:
    blocks_fetched: int = 0
    bytes_fetched: int = 0
    bytes_read: int = 0
    fetch_s: float = 0.0
    store_requests: int = 0
    retries: int = 0            # transient faults retried (shared Retrier)
    throttles: int = 0          # ThrottleError responses (503 SlowDown)
    cache_hits: int = 0         # blocks served from the shared index
    flight_joins: int = 0       # blocks obtained from another reader's GET
    blocks_verified: int = 0    # digest checks that passed
    integrity_failures: int = 0  # digest mismatches detected (then healed)

    def snapshot(self) -> dict:
        return dict(self.__dict__)


@dataclass
class _CacheEntry:
    index: int
    data: bytes


class SequentialFile:
    """fsspec-style read-ahead block cache over the same logical stream the
    Rolling Prefetch file exposes, so both sides of every A/B benchmark
    perform byte-identical application reads."""

    def __init__(
        self,
        store: ObjectStore,
        files: list[ObjectMeta],
        blocksize: int,
        cache_blocks: int = 1,
        tuner: "BlockSizeTuner | None" = None,
        index: CacheIndex | None = None,
        retry: RetryPolicy | None = None,
        io_class: str = "default",
        verify: str = "edges",
    ) -> None:
        if verify not in ("off", "edges", "full"):
            raise ValueError(
                f"verify must be 'off', 'edges', or 'full', got {verify!r}"
            )
        self.store = store
        self.plan = BlockPlan(files, blocksize)
        self.cache_blocks = max(1, cache_blocks)
        self.tuner = tuner
        self.index = index
        self.io_class = io_class
        self.verify = verify
        self.stats = SequentialStats()
        # Pre-resilience-layer this engine retried NOTHING: the first
        # transient fault of a direct read or a `_join_flight` fallback
        # GET killed the application's read() while the rolling engine
        # rode out the same schedule. Every store request now resolves
        # through the shared Retrier (full-jitter backoff), so both
        # engines survive the same faults.
        self.retry = retry if retry is not None else RetryPolicy()
        self._retrier = Retrier(
            self.retry,
            on_retry=self._on_retry,
            on_throttle=self._on_throttle,
        )
        self._cache: dict[int, _CacheEntry] = {}
        self._lru: list[int] = []
        self._pos = 0
        self._closed = False

    @property
    def size(self) -> int:
        return self.plan.total_bytes

    @property
    def closed(self) -> bool:
        return self._closed

    def _get_block(self, index: int) -> bytes:
        entry = self._cache.get(index)
        if entry is not None:
            return entry.data
        # Read-ahead: with cache_blocks > 1 the miss fetches the run of
        # adjacent same-file blocks that fills the cache with ONE
        # vectorized request (fsspec's readahead cache, request-efficient
        # via `get_ranges`); cache_blocks == 1 keeps the paper's baseline
        # shape of exactly one request per block.
        run = []
        for b in self.plan.run_from(index, self.cache_blocks):
            if b.index in self._cache:
                break  # keep the request one adjacent span
            run.append(b)
        if self.index is None:
            datas = [d for d, _ in self._fetch_run(run)]
        else:
            datas = self._resolve_shared(run)
        for b, d in zip(run, datas):
            self._cache[b.index] = _CacheEntry(b.index, d)
            self._lru.append(b.index)
        while len(self._lru) > self.cache_blocks:
            self._cache.pop(self._lru.pop(0), None)
        return self._cache[index].data

    def _on_retry(self, attempt: int, exc: Exception, pause: float) -> None:
        self.stats.retries += 1

    def _on_throttle(self) -> None:
        self.stats.throttles += 1

    def _request(self, run: list[Block]) -> list[tuple[bytes, str | None]]:
        if self.verify == "off":
            if len(run) == 1:
                datas = [self.store.get_range(run[0].key, run[0].start,
                                              run[0].end)]
            else:
                datas = self.store.get_ranges(
                    run[0].key, [(b.start, b.end) for b in run]
                )
            pairs: list[tuple[bytes, str | None]] = [(d, None) for d in datas]
        else:
            if len(run) == 1:
                pairs = [self.store.get_range_verified(
                    run[0].key, run[0].start, run[0].end)]
            else:
                pairs = self.store.get_ranges_verified(
                    run[0].key, [(b.start, b.end) for b in run]
                )
        for b, (d, dig) in zip(run, pairs):
            if len(d) != b.size:
                # Short response reported as complete: retry, don't
                # cache-and-corrupt (same guard as the rolling engine).
                raise TransientStoreError(
                    f"truncated response for {b.block_id}: "
                    f"got {len(d)} of {b.size} bytes"
                )
            if dig is not None:
                # Received bytes vs store-attested digest: a mismatch is
                # transient (the Retrier re-fetches); exhaustion raises a
                # typed IntegrityError, never returns wrong bytes.
                try:
                    check_block(d, dig, what=f"fetched block {b.block_id}")
                except IntegrityError:
                    self.stats.integrity_failures += 1
                    raise
                self.stats.blocks_verified += 1
        return pairs

    def _fetch_run(self, run: list[Block]) -> list[tuple[bytes, str | None]]:
        """One synchronous (resilient) store request for a contiguous run
        of blocks. Returns (payload, digest) pairs; digests are None with
        verify="off"."""
        retries_before = self.stats.retries
        t0 = time.perf_counter()
        pairs = self._retrier.call(
            lambda: self._request(run),
            label=f"blocks {run[0].block_id}..{run[-1].block_id}",
        )
        dt = time.perf_counter() - t0
        nbytes = sum(len(d) for d, _ in pairs)
        self.stats.fetch_s += dt
        self.stats.store_requests += 1
        self.stats.blocks_fetched += len(run)
        self.stats.bytes_fetched += nbytes
        if self.tuner is not None and self.stats.retries == retries_before:
            # Synchronous fetches time the store request exactly, so this
            # engine closes the loop too: with autotune on, PrefetchFS
            # retunes the Eq.-4 blocksize from these samples on reopen.
            # Retried calls are excluded — their wall time carries
            # backoff sleeps, not link behaviour.
            self.tuner.observe_request(nbytes, dt)
        return pairs

    # -- shared-index path --------------------------------------------------
    def _resolve_shared(self, run: list[Block]) -> list[bytes]:
        """Resolve a run against the shared `CacheIndex`: resident blocks
        are read from their local tier, in-flight blocks join the other
        reader's fetch, and only led blocks hit the store (contiguous
        leader segments still coalesce into one request, published back to
        a tier for the next reader)."""
        out: dict[int, bytes] = {}
        group: list[tuple[Block, object]] = []
        for b in run:
            kind, val = self.index.acquire(b.block_id, self.io_class)
            if kind == "leader":
                group.append((b, val))
                continue
            try:
                self._fetch_leaders(group, out)
                group = []
            except Exception:  # repro: allow[RP005] — releases, then re-raises
                # The pin (hit) / waiter slot (wait) just taken for `b`
                # must not leak past a failed leader group, or the block
                # becomes unevictable forever.
                if kind == "hit":
                    self.index.unpin(b.block_id)
                else:
                    self.index.leave(val)
                raise
            if kind == "hit":
                out[b.index] = self._read_hit(b, val)
            else:
                out[b.index] = self._join_flight(b, val)
        self._fetch_leaders(group, out)
        return [out[b.index] for b in run]

    def _verify_tier_read(self, tier, data: bytes, block_id: str) -> None:
        """Engine-side digest re-check of a full-block tier read; same
        posture as the rolling engine ("edges" trusts self-verifying
        tiers, "full" re-checks unconditionally). Raises `IntegrityError`
        for the caller to quarantine and heal."""
        if self.verify == "off":
            return
        if self.verify == "edges" and getattr(tier, "verifies_reads", False):
            return
        dig = self.index.digest_of(block_id)
        if dig is None:
            return
        check_block(data, dig, what=f"cached block {block_id}")
        self.stats.blocks_verified += 1

    def _read_hit(self, b: Block, tier) -> bytes:
        """Serve a resident block from its tier. Hits/joins deliberately
        do NOT count into blocks_fetched/bytes_fetched — those mean store
        traffic, matching the rolling engine's accounting. The unpin asks
        for eviction unless the index retains (keep_cached), preserving
        the evict-when-consumed default for this engine too."""
        try:
            try:
                data = tier.read(b.block_id, 0, b.size)
                self._verify_tier_read(tier, data, b.block_id)
            finally:
                self.index.unpin(b.block_id,
                                 want_evict=not self.index.keep_cached)
        except IntegrityError:
            # The resident copy is provably wrong: quarantine (evict +
            # tombstone) and heal with a direct fetch — a rotted cache
            # block costs one GET, never wrong data.
            self.stats.integrity_failures += 1
            self.index.quarantine(b.block_id)
            return self._fetch_run([b])[0][0]
        except StoreError:
            # A sibling process sharing a persistent cache dir may have
            # evicted the file beneath the entry — drop the stale entry
            # and fetch it ourselves.
            self.index.invalidate(b.block_id)
            return self._fetch_run([b])[0][0]
        self.stats.cache_hits += 1
        return data

    def _fetch_leaders(self, group: list[tuple[Block, object]],
                       out: dict[int, bytes]) -> None:
        if not group:
            return
        blocks = [b for b, _ in group]
        try:
            pairs = self._fetch_run(blocks)
        except Exception as e:   # repro: allow[RP005] — waiters must not hang
            for _, fl in group:
                self.index.abort_fetch(fl, e)
            raise
        for (b, fl), (d, dig) in zip(group, pairs):
            out[b.index] = d
            if fl.waiters == 0 and not self.index.keep_cached:
                # Nobody is waiting and retention is off: publishing would
                # write the block into a tier and evict it on the very
                # next line — skip the dead work. (A waiter registering in
                # this racy instant just re-fetches itself.)
                self.index.abort_fetch(fl)
                continue
            tier = self.index.reserve_space(b.size, self.io_class)
            if tier is None:
                # Nowhere to publish (tiers full of pinned blocks): the
                # data is still returned; waiters re-acquire and fetch.
                self.index.abort_fetch(fl)
                continue
            try:
                tier.write(b.block_id, d,
                           meta=BlockMeta(key=b.key, offset=b.start))
            except Exception:   # repro: allow[RP005] — cache write is best-effort
                tier.cancel(b.size)
                self.index.abort_fetch(fl)
                continue
            tier.commit(b.size)
            self.index.publish(fl, tier, b.size, digest=dig)
            # No long pin (bytes copied out); without keep_cached the
            # block must not outlive its consumption — the paper's
            # evict-when-consumed default applies to this engine too.
            self.index.unpin(b.block_id,
                             want_evict=not self.index.keep_cached)

    # How long a synchronous reader waits on another reader's in-flight
    # fetch before giving up and fetching the block itself. A leaked
    # flight (leader killed without publish/abort) must never hang the
    # application's read() forever — a duplicate GET beats a deadlock.
    JOIN_PATIENCE_S = 10.0

    def _join_flight(self, b: Block, flight) -> bytes:
        waited = 0.0
        while True:
            kind, val = self.index.join(flight, timeout=0.5)
            if kind == "timeout":
                waited += 0.5
                if waited >= self.JOIN_PATIENCE_S:
                    self.index.leave(flight)
                    return self._fetch_run([b])[0][0]
                continue
            if kind == "hit":
                try:
                    try:
                        data = val.read(b.block_id, 0, b.size)
                        self._verify_tier_read(val, data, b.block_id)
                    finally:
                        self.index.unpin(b.block_id,
                                         want_evict=not self.index.keep_cached)
                except IntegrityError:
                    self.stats.integrity_failures += 1
                    self.index.quarantine(b.block_id)
                    return self._fetch_run([b])[0][0]
                except StoreError:
                    self.index.invalidate(b.block_id)
                    return self._fetch_run([b])[0][0]
                self.stats.flight_joins += 1
                return data
            # Leader failed: take over (or join the next attempt).
            kind, val = self.index.acquire(b.block_id, self.io_class)
            if kind == "hit":
                return self._read_hit(b, val)
            if kind == "wait":
                flight = val
                continue
            out: dict[int, bytes] = {}
            self._fetch_leaders([(b, val)], out)
            return out[b.index]

    def read(self, n: int = -1) -> bytes:
        if self._closed:
            raise ValueError("read on closed file")
        if n < 0:
            n = self.size - self._pos
        end = min(self._pos + n, self.size)
        out = bytearray()
        while self._pos < end:
            block = self.plan.block_at(self._pos)
            data = self._get_block(block.index)
            lo = self._pos - block.global_start
            hi = min(end, block.global_end) - block.global_start
            out.extend(data[lo:hi])
            self._pos += hi - lo
        self.stats.bytes_read += len(out)
        return bytes(out)

    def seek(self, offset: int, whence: int = 0) -> int:
        if whence == 1:
            offset += self._pos
        elif whence == 2:
            offset += self.size
        if not 0 <= offset <= self.size:
            raise ValueError(f"seek out of range: {offset}")
        self._pos = offset
        return self._pos

    def tell(self) -> int:
        return self._pos

    def close(self) -> None:
        self._closed = True
        self._cache.clear()
        self._lru.clear()

    def __enter__(self) -> "SequentialFile":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
