"""Rolling Prefetch — the paper's core contribution, with an adaptive
event-driven scheduler.

Three concurrent actors over a block plan (paper §II-A):

  * the READING thread (the caller of :meth:`RollingPrefetchFile.read`)
    serves bytes from cached blocks, blocking until the needed block has
    been prefetched, and flags fully-consumed blocks for eviction;
  * the PREFETCHING stream(s) claim *runs* of adjacent blocks inside a
    readahead horizon ahead of the reader, write them into the first
    priority-ordered cache tier with available budget (Algorithm 1:
    optimistic `used` accounting + `verify_used` reconciliation when a
    tier looks full), and park on a condition when no work is eligible —
    evictions and reader progress notify them, with a coarse wait timeout
    only as a missed-wakeup backstop;
  * the EVICTION thread deletes flagged blocks when notified (a consumed
    block pushed a tier past its high-water mark, or a prefetcher found
    every tier full), with the periodic interval only as a fallback, and
    performs a final sweep on shutdown.

Adaptive scheduling (all off by default so the faithful configuration is
the baseline):

  * ``coalesce > 1``: runs of adjacent blocks are fetched with ONE
    vectorized ``store.get_ranges`` request — one request latency for the
    whole run — when the cost model says the link is latency-bound
    (Eq. 1's ``n_b·l_c`` term dominates); results split back into
    per-block cache entries so eviction granularity is unchanged;
  * ``readahead_blocks``: bounds the fetch window to a horizon ahead of
    the reader position instead of racing to end-of-plan;
  * ``max_depth``: an AIMD controller grows concurrent fetch streams
    while observed fetch throughput holds and halves them when it
    regresses;
  * ``tuner``: a `BlockSizeTuner` fed per-request timings and reader
    compute gaps, closing the Eq.-4 loop (the `PrefetchFS` facade retunes
    blocksize/coalesce from it on the next open);
  * ``depth > 1``, ``hedge_timeout``, transient-failure retries: S3
    scales with request concurrency; thousand-node jobs need straggler +
    fault tolerance. All retrying and hedging resolves through the
    unified resilience layer (`repro_torch.io.retry`): one `Retrier` with
    full-jitter backoff and one capped `Hedger` per prefetcher, shared
    by every stream and the reader's direct-GET fallbacks. A
    `ThrottleError` (503 SlowDown) additionally halves the AIMD stream
    target, so backend pushback shrinks prefetch concurrency instead of
    just rescheduling the same herd.
"""

from __future__ import annotations

import enum
import threading
import time
import warnings
from dataclasses import dataclass, field

from repro_torch.core.autotune import AimdDepthController, BlockSizeTuner
from repro_torch.core.plan import Block, BlockPlan
from repro_torch.io.integrity import check_block
from repro_torch.io.retry import Hedger, Retrier, RetryPolicy
from repro_torch.store.base import (
    IntegrityError,
    ObjectMeta,
    ObjectStore,
    StoreError,
    TransientStoreError,
)
from repro_torch.store.tiers import BlockMeta, CacheFlight, CacheIndex, CacheTier
from repro_torch.utils import get_logger

log = get_logger("core.rolling")


class BlockState(enum.Enum):
    UNFETCHED = 0
    FETCHING = 1
    CACHED = 2
    CONSUMED = 3   # fully read; flagged for eviction
    EVICTED = 4
    FAILED = 5


@dataclass
class _BlockInfo:
    state: BlockState = BlockState.UNFETCHED
    tier: CacheTier | None = None
    error: Exception | None = None
    # The reader gave up waiting (READ_PATIENCE_S) and read this block
    # directly from the store: when the scheduled fetch finally lands, it
    # arrives pre-consumed so its pin is released instead of sitting
    # CACHED forever for a reader that already moved past it.
    abandoned: bool = False


@dataclass
class PrefetchStats:
    """Counters mutated from the reader, prefetch (possibly several when
    depth > 1), and eviction threads; all mutation goes through
    :meth:`bump` / :meth:`note_depth`, which serialize on an internal
    lock, and :meth:`snapshot` reads under the same lock for a consistent
    view."""

    blocks_fetched: int = 0
    blocks_evicted: int = 0
    bytes_fetched: int = 0
    bytes_read: int = 0
    reader_wait_s: float = 0.0
    fetch_s: float = 0.0        # cumulative time in store fetch + tier.write
    retries: int = 0
    throttles: int = 0          # ThrottleError responses (503 SlowDown)
    hedges: int = 0
    direct_reads: int = 0       # cache-miss fallbacks (backward seeks)
    cache_hits: int = 0         # blocks served from the shared index, no GET
    flight_joins: int = 0       # blocks obtained by joining another reader's GET
    store_requests: int = 0     # GETs issued (== blocks_fetched unless coalesced)
    coalesced_requests: int = 0  # GETs that carried more than one block
    coalesced_blocks: int = 0    # blocks delivered by coalesced GETs
    depth_peak: int = 0          # highest concurrent-stream target reached
    blocks_verified: int = 0     # digest checks that passed
    integrity_failures: int = 0  # digest mismatches detected (then healed)
    _lock: threading.Lock = field(default_factory=threading.Lock,
                                  repr=False, compare=False)

    def bump(self, **deltas: int | float) -> None:
        with self._lock:
            for name, delta in deltas.items():
                setattr(self, name, getattr(self, name) + delta)

    def note_depth(self, target: int) -> None:
        with self._lock:
            self.depth_peak = max(self.depth_peak, target)

    def snapshot(self) -> dict:
        with self._lock:
            return {k: v for k, v in self.__dict__.items()
                    if not k.startswith("_")}


class RollingPrefetcher:
    """Shared engine: block plan + tiered cache + the scheduler threads."""

    # Upper bound on how long the READER waits for a block the scheduler
    # has not delivered before degrading to a direct store read. Normal
    # waits are milliseconds; this only fires when the shared-cache
    # machinery is wedged (e.g. another reader's pinned readahead holds
    # every tier byte while that reader waits on our leader — a cycle no
    # eviction can break). A direct GET restores progress for everyone:
    # this reader consumes on, its pins release, the parked leader gets
    # space. The paper's worst-case contract (degrade to sequential
    # performance, never hang) is preserved.
    READ_PATIENCE_S = 30.0

    def __init__(
        self,
        store: ObjectStore,
        files: list[ObjectMeta],
        tiers: list[CacheTier],
        blocksize: int,
        *,
        depth: int = 1,
        max_depth: int | None = None,
        coalesce: int = 1,
        readahead_blocks: int | None = None,
        eviction_interval_s: float = 5.0,
        high_water: float = 0.75,
        max_retries: int = 3,
        retry_backoff_s: float = 0.05,
        retry: RetryPolicy | None = None,
        hedge_timeout_s: float | None = None,
        max_hedges: int = 4,
        throttle_aimd: bool = True,
        tuner: BlockSizeTuner | None = None,
        index: CacheIndex | None = None,
        io_class: str = "default",
        verify: str = "edges",
    ) -> None:
        if not tiers:
            raise ValueError("at least one cache tier is required")
        if verify not in ("off", "edges", "full"):
            raise ValueError(
                f"verify must be 'off', 'edges', or 'full', got {verify!r}"
            )
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        if max_depth is not None and max_depth < depth:
            raise ValueError(
                f"max_depth ({max_depth}) must be >= depth ({depth})"
            )
        if coalesce < 1:
            raise ValueError(f"coalesce must be >= 1, got {coalesce}")
        if readahead_blocks is not None and readahead_blocks < 1:
            raise ValueError(
                f"readahead_blocks must be >= 1, got {readahead_blocks}"
            )
        self.store = store
        self.plan = BlockPlan(files, blocksize)
        self.tiers = tiers
        self.depth = depth
        self.coalesce = coalesce
        self.readahead_blocks = readahead_blocks
        self.eviction_interval_s = eviction_interval_s
        self.high_water = high_water
        self.hedge_timeout_s = hedge_timeout_s
        self.tuner = tuner
        # Unified resilience layer: ONE Retrier (shared jitter rng and
        # retry budget across all prefetch streams + the reader's direct
        # GETs) and ONE Hedger (the max-hedges-in-flight cap bounds
        # duplicates across concurrent streams). ThrottleError responses
        # reach `_on_throttle`, which shrinks the AIMD stream target —
        # backend pushback lowers prefetch concurrency, not just this
        # request's schedule.
        self.retry = (retry if retry is not None else RetryPolicy(
            max_retries=max_retries, backoff_s=retry_backoff_s))
        self.throttle_aimd = throttle_aimd
        # Shared cache index: residency + refcounts + single-flight fetch
        # registration. When the caller (PrefetchFS) supplies one, every
        # reader over these tiers shares it — N readers of the same key
        # issue ~1x store GETs, and a block pinned by any reader is never
        # evicted from under another. A private index (one reader) behaves
        # exactly like the paper's per-reader cache, except that a
        # persistent DirTier still primes it warm after a restart.
        self.index = index if index is not None else CacheIndex(tiers)
        # Workload class stamped on every acquire/reserve: the HSM index
        # keys admission (entry tier, protection, scan resistance) and
        # per-class hit accounting off it; a flat index ignores it.
        self.io_class = io_class
        # End-to-end integrity posture: "off" never hashes, "edges" mints
        # a digest at the store fetch and re-checks at tier boundaries
        # (trusting self-verifying tiers), "full" re-checks every cached
        # read. See `repro_torch.io.integrity`.
        self.verify = verify
        self.stats = PrefetchStats()
        self._aimd = (
            AimdDepthController(depth, max_depth)
            if max_depth is not None else None
        )
        self._retrier = Retrier(
            self.retry,
            on_retry=lambda attempt, exc, pause: self.stats.bump(retries=1),
            on_throttle=self._on_throttle,
        )
        self._hedger = Hedger(
            hedge_timeout_s,
            max_in_flight=max_hedges,
            on_hedge=lambda: self.stats.bump(hedges=1),
        )
        self._streams = max_depth if max_depth is not None else depth
        self._spawned = 0             # streams actually started (lazy)

        self._info: list[_BlockInfo] = [_BlockInfo() for _ in self.plan.blocks]
        self._cond = threading.Condition()
        self._next_block = 0          # lowest block index not yet claimed
        self._reader_block = 0        # reader position, in block indexes
        self._target_depth = depth    # streams allowed to fetch right now
        self._probe_width = 0         # width alternator while tuner is cold
        self._fetch = True            # the paper's shared `fetch` flag
        self._threads: list[threading.Thread] = []
        self._started = False
        self._closed = False
        # Eviction wakeup channel: consumed-past-high-water and
        # tiers-all-full both notify here instead of waiting out the
        # periodic interval (which remains only as a fallback).
        self._evict_cond = threading.Condition()
        self._evict_wanted = False
        # Reader-side buffer of the current block: the application issues
        # many small reads (3 per streamline in the paper's Nibabel trace);
        # local storage is read once per block, small reads are served from
        # this buffer without touching locks or the tier.
        self._buf_index: int | None = None
        self._buf_data: bytes = b""
        # Compute-gap observation state (closed-loop autotune): wall time
        # between read_range calls is pure application compute.
        self._last_read_t: float | None = None
        self._last_read_bytes = 0

    # ------------------------------------------------------------------ #
    # lifecycle
    # ------------------------------------------------------------------ #
    def start(self) -> None:
        if self._closed:
            # close() cleared the fetch flag and block/tier state; worker
            # threads spawned now would exit immediately and the old ones
            # would be double-joined — refuse loudly instead.
            raise RuntimeError(
                "RollingPrefetcher cannot restart after close(); "
                "open a new reader instead"
            )
        if self._started:
            return
        self._started = True
        # Streams spawn lazily: `depth` now, more only if the AIMD target
        # actually grows — max_depth=64 must not cost 64 idle threads.
        self._spawn_streams(self._target_depth)
        t = threading.Thread(target=self._evict_loop, name="rp-evict", daemon=True)
        t.start()
        self._threads.append(t)

    def _spawn_streams(self, target: int) -> None:
        """Bring the number of spawned streams up to `min(target, ceiling)`.
        Workers above the current AIMD target park on `_cond`, so streams
        never need un-spawning when the target shrinks."""
        while True:
            with self._cond:
                if self._closed or not self._started:
                    return
                if self._spawned >= min(target, self._streams):
                    return
                i = self._spawned
                self._spawned += 1
            t = threading.Thread(
                target=self._prefetch_loop, args=(i,),
                name=f"rp-prefetch-{i}", daemon=True,
            )
            t.start()
            self._threads.append(t)

    def close(self) -> None:
        with self._cond:
            if self._closed:
                return
            self._closed = True
            self._fetch = False
            self._cond.notify_all()
        with self._evict_cond:
            self._evict_cond.notify_all()
        for t in self._threads:
            t.join(timeout=30.0)
        self._threads = []
        self._final_sweep()

    def __enter__(self) -> "RollingPrefetcher":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    @property
    def target_depth(self) -> int:
        """Current AIMD stream target (== `depth` when adaptation is off)."""
        with self._cond:
            return self._target_depth

    # ------------------------------------------------------------------ #
    # prefetching streams (Algorithm 1 + adaptive scheduler)
    # ------------------------------------------------------------------ #
    def _effective_coalesce(self) -> int:
        """Blocks per request for the next claim. Caller holds `_cond`."""
        if self.coalesce <= 1:
            return 1
        if self.tuner is None:
            return self.coalesce
        if self.tuner.latency_s is None:
            # Cold tuner: alternate 1- and 2-block requests so sizes vary
            # and the request-timing fit can split latency from bandwidth.
            self._probe_width += 1
            return 1 + (self._probe_width % 2)
        return self.tuner.suggest_coalesce(self.plan.blocksize, self.coalesce)

    def _claim_run(self, worker_id: int) -> list[Block] | None:
        """Claim the next run of adjacent unfetched blocks inside the
        readahead horizon; parks (condition wait) while this stream is
        over the AIMD target or the horizon is exhausted."""
        with self._cond:
            while True:
                if not self._fetch:
                    return None
                if worker_id >= self._target_depth:
                    # Parked by the depth controller; woken when the
                    # target grows (or on close).
                    self._cond.wait(timeout=0.5)
                    continue
                while (self._next_block < len(self.plan)
                       and self._info[self._next_block].state
                       != BlockState.UNFETCHED):
                    self._next_block += 1
                if self._next_block >= len(self.plan):
                    return None  # plan fully claimed -> stream terminates
                idx = self._next_block
                limit = None
                if self.readahead_blocks is not None:
                    limit = self._reader_block + self.readahead_blocks
                    if idx >= limit:
                        # Horizon exhausted; reader progress notifies.
                        self._cond.wait(timeout=0.5)
                        continue
                run: list[Block] = []
                for b in self.plan.run_from(idx, self._effective_coalesce(),
                                            limit):
                    if self._info[b.index].state != BlockState.UNFETCHED:
                        break
                    self._info[b.index].state = BlockState.FETCHING
                    run.append(b)
                self._next_block = run[-1].index + 1
                return run

    def _unclaim(self, blocks: list[Block]) -> None:
        """Return claimed blocks to the pool. Caller holds `_cond`."""
        for b in blocks:
            self._info[b.index].state = BlockState.UNFETCHED
        if blocks:
            self._next_block = min(self._next_block, blocks[0].index)

    def _prefetch_loop(self, worker_id: int) -> None:
        while True:
            run = self._claim_run(worker_id)
            if run is None:
                return
            if not self._place_run(run):
                return

    def _place_run(self, run: list[Block]) -> bool:
        """Resolve each claimed block against the shared cache index:
        blocks already resident (another reader, a previous epoch, or a
        recovered persistent tier) are pinned without a store request,
        blocks another reader is fetching right now are joined, and only
        blocks this stream leads are fetched — contiguous leader groups
        still go out as ONE coalesced request. Returns False when this
        stream should exit."""
        group: list[tuple[Block, CacheFlight]] = []
        for pos, b in enumerate(run):
            # repro: allow[RP009] — the only call between acquire and
            # discharge is _flush_group, which handles every fetch error
            # internally (leak-free by construction, see _fail_group).
            kind, val = self.index.acquire(b.block_id, self.io_class)
            if kind == "leader":
                group.append((b, val))
                continue
            if not self._flush_group(group):
                self._fail_rest(run[pos:], skip_acquired=(b, kind, val))
                return False
            group = []
            if kind == "hit":
                self.stats.bump(cache_hits=1)
                self._mark_cached(b, val)
            elif not self._join_flight(b, val):
                self._fail_rest(run[pos + 1:])
                return False
        return self._flush_group(group)

    def _fail_rest(self, rest: list[Block], skip_acquired=None) -> None:
        """A group failed permanently mid-run: the remaining claimed
        blocks can never be fetched by this stream — mark them FAILED so
        the reader raises instead of waiting forever (matching the old
        whole-run-FAILED semantics). On shutdown they are unclaimed
        instead. Pins/flights already acquired for them are released."""
        with self._cond:
            closing = not self._fetch
            err: Exception | None = None
            unclaim: list[Block] = []
            for b in rest:
                info = self._info[b.index]
                if info.state != BlockState.FETCHING:
                    continue
                if skip_acquired is not None and skip_acquired[0] is b:
                    _, kind, val = skip_acquired
                    if kind == "hit":
                        # repro: allow[RP002] — index calls are engine-lock-
                        # safe (tiers.py contract); at worst a local unlink.
                        self.index.unpin(b.block_id)
                    elif kind == "wait":
                        # repro: allow[RP002] — same contract as above.
                        self.index.leave(val)
                if closing:
                    unclaim.append(b)
                    continue
                if err is None:
                    err = StoreError("prefetch stream failed upstream")
                info.state = BlockState.FAILED
                info.error = err
            if unclaim:
                self._unclaim(unclaim)
            self._cond.notify_all()

    def _flush_group(self, group: list[tuple[Block, CacheFlight]]) -> bool:
        """Reserve tier space for a contiguous group of leader blocks and
        fetch it as one request; shrinks to the head block when only one
        fits, parks (eviction-notified) when every tier is full. Returns
        False when this stream should exit."""
        if not group:
            return True
        while True:
            with self._cond:
                if not self._fetch:
                    for b, fl in group:
                        self.index.abort_fetch(fl)
                    self._unclaim([b for b, _ in group])
                    return False
            total = sum(b.size for b, _ in group)
            try:
                tier = self._reserve(total)
            except Exception as e:  # repro: allow[RP005] — flights MUST abort:
                # _reserve runs eviction I/O (tier deletes); if that
                # blows up with the group's flights registered, every
                # waiter parks until the TTL. Fail the group leak-free.
                self._fail_group(group, e)
                return False
            if tier is None and len(group) > 1:
                # The full group doesn't fit anywhere — give back the tail
                # and try the head block alone before parking.
                with self._cond:
                    for b, fl in group[1:]:
                        self.index.abort_fetch(fl)
                    self._unclaim([b for b, _ in group[1:]])
                    self._cond.notify_all()
                group = group[:1]
                continue
            if tier is None:
                # Every tier full: demand eviction, then park until the
                # evictor (or close) notifies.
                self._request_eviction()
                with self._cond:
                    if self._fetch:
                        self._cond.wait(timeout=0.5)
                continue
            try:
                self._fetch_group(group, tier)
                return True
            except Exception as e:  # repro: allow[RP005] — flights MUST abort:
                # a leaked flight would park every waiter (other readers
                # included) until their patience fallback, and this
                # reader's blocks would stay FETCHING forever.
                tier.cancel(total)
                self._fail_group(group, e)
                return False

    def _fail_group(self, group: list[tuple[Block, CacheFlight]],
                    e: Exception) -> None:
        """Abort every flight in `group` and mark its blocks FAILED —
        the one leak-free way out of a group that cannot be fetched."""
        err = e if isinstance(e, StoreError) else StoreError(
            f"fetch failed for blocks "
            f"{group[0][0].block_id}..{group[-1][0].block_id}: {e}"
        )
        with self._cond:
            for b, fl in group:
                self.index.abort_fetch(fl, err)
                self._info[b.index].state = BlockState.FAILED
                self._info[b.index].error = err
            self._cond.notify_all()
        log.error("blocks %s..%s failed permanently: %s",
                  group[0][0].block_id, group[-1][0].block_id, e)

    def _join_flight(self, b: Block, flight: CacheFlight) -> bool:
        """Another reader is fetching `b` right now: wait for its flight
        instead of issuing a duplicate GET. If the leader fails, retry the
        block ourselves (possibly becoming the new leader). Returns False
        when this stream should exit."""
        while True:
            with self._cond:
                if not self._fetch:
                    # repro: allow[RP002] — engine-lock-safe (tiers.py
                    # contract); at worst a local unlink.
                    self.index.leave(flight)
                    self._unclaim([b])
                    return False
            kind, val = self.index.join(flight, timeout=0.5)
            if kind == "timeout":
                continue
            if kind == "hit":
                self.stats.bump(flight_joins=1)
                self._mark_cached(b, val)
                return True
            # Leader failed (or abandoned): re-acquire; the block may have
            # landed meanwhile, someone else may be retrying it, or we
            # become the leader and run our own retry budget.
            kind, val = self.index.acquire(b.block_id, self.io_class)
            if kind == "hit":
                self.stats.bump(cache_hits=1)
                self._mark_cached(b, val)
                return True
            if kind == "wait":
                flight = val
                continue
            return self._flush_group([(b, val)])

    def _mark_cached(self, b: Block, tier: CacheTier) -> None:
        evict = False
        with self._cond:
            info = self._info[b.index]
            info.state = (BlockState.CONSUMED if info.abandoned
                          else BlockState.CACHED)
            info.tier = tier
            evict = info.abandoned
            self._cond.notify_all()
        if evict:
            self._request_eviction()

    def _reserve(self, nbytes: int) -> CacheTier | None:
        # Priority-ordered tier walk with verify_used reconciliation and
        # capacity-pressure LRU eviction of unpinned index blocks, shared
        # with the sequential engine via the index.
        return self.index.reserve_space(nbytes, self.io_class)

    def _fetch_group(self, group: list[tuple[Block, CacheFlight]],
                     tier: CacheTier) -> None:
        run = [b for b, _ in group]
        total = sum(b.size for b in run)
        t0 = time.perf_counter()
        pairs, store_s = self._fetch_with_retries(run)
        written: list[Block] = []
        try:
            for b, (d, _) in zip(run, pairs):
                tier.write(b.block_id, d,
                           meta=BlockMeta(key=b.key, offset=b.start))
                written.append(b)
        except Exception as e:
            # A mid-run write failure must not orphan the blocks that
            # already landed: the caller cancels the whole reservation,
            # and FAILED blocks are invisible to eviction, so resident
            # bytes would leak past the tier's accounting forever. None of
            # these blocks were published yet, so no index entry to undo.
            for b in written:
                try:
                    tier.delete(b.block_id)
                except Exception:  # repro: allow[RP005] — best-effort cleanup
                    pass
            if isinstance(e, StoreError):
                raise
            # Translate e.g. ENOSPC from a disk tier into the StoreError
            # the caller handles — anything else would skip the
            # reservation cancel and leave the run FETCHING forever
            # (reader deadlock).
            raise StoreError(
                f"tier write failed for blocks "
                f"{run[0].block_id}..{run[-1].block_id}"
            ) from e
        tier.commit(total)
        deltas: dict = dict(
            fetch_s=time.perf_counter() - t0,
            blocks_fetched=len(run),
            bytes_fetched=total,
            store_requests=1,
        )
        if len(run) > 1:
            deltas.update(coalesced_requests=1, coalesced_blocks=len(run))
        self.stats.bump(**deltas)
        if self.tuner is not None and store_s is not None:
            self.tuner.observe_request(total, store_s)
        if self._aimd is not None:
            new = self._aimd.on_fetch(total, time.perf_counter())
            self.stats.note_depth(new)
            grew = False
            with self._cond:
                if new != self._target_depth:
                    grew = new > self._target_depth
                    self._target_depth = new
                    self._cond.notify_all()
            if grew:
                self._spawn_streams(new)
        evict = False
        with self._cond:
            for (b, fl), (_, dig) in zip(group, pairs):
                # Publish pins the entry for us (plus any waiters); our
                # pin is released when this reader's eviction unpins it.
                # The digest minted at the fetch travels with the entry —
                # every later boundary crossing can re-check it.
                self.index.publish(fl, tier, b.size, digest=dig)
                info = self._info[b.index]
                info.state = (BlockState.CONSUMED if info.abandoned
                              else BlockState.CACHED)
                info.tier = tier
                evict = evict or info.abandoned
            self._cond.notify_all()
        if evict:
            self._request_eviction()

    def _on_throttle(self) -> None:
        """ThrottleError from the store (via the shared Retrier): record
        it and — when AIMD depth control is on — cut the stream target
        multiplicatively right now. Backoff alone would keep `max_depth`
        streams hammering a rate-limited backend; shrinking concurrency
        is what actually relieves the pressure."""
        self.stats.bump(throttles=1)
        if self._aimd is None or not self.throttle_aimd:
            return
        new = self._aimd.on_throttle()
        self.stats.note_depth(new)
        with self._cond:
            if new != self._target_depth:
                self._target_depth = new
                self._cond.notify_all()

    def _fetch_with_retries(
        self, run: list[Block]
    ) -> tuple[list[tuple[bytes, str | None]], float | None]:
        """One resilient (retried, optionally hedged) fetch of a
        contiguous run. Returns ((payload, digest) pairs, store seconds);
        seconds is None when a hedge fired — racing duplicates
        contaminate the timing, so hedged samples never reach the
        tuner."""
        return self._retrier.call(
            lambda: self._hedger.call(lambda: self._request(run)),
            label=f"blocks {run[0].block_id}..{run[-1].block_id}",
        )

    def _request(self, run: list[Block]) -> list[tuple[bytes, str | None]]:
        """One store round trip for a contiguous run. Returns (payload,
        digest) pairs — the digest is the store's attestation of the
        authoritative bytes (None with verify="off"), already verified
        against the payload actually received."""
        if self.verify == "off":
            if len(run) == 1:
                b = run[0]
                datas = [self.store.get_range(b.key, b.start, b.end)]
            else:
                datas = self.store.get_ranges(
                    run[0].key, [(b.start, b.end) for b in run]
                )
            pairs: list[tuple[bytes, str | None]] = [
                (d, None) for d in datas]
        else:
            if len(run) == 1:
                b = run[0]
                pairs = [self.store.get_range_verified(b.key, b.start, b.end)]
            else:
                pairs = self.store.get_ranges_verified(
                    run[0].key, [(b.start, b.end) for b in run]
                )
        for b, (d, dig) in zip(run, pairs):
            self._check_fetched(b, d, dig)
        return pairs

    def _check_fetched(self, b: Block, d: bytes, dig: str | None) -> None:
        if len(d) != b.size:
            # A short response the server reported as complete
            # (dropped connection, proxy truncation): caching it
            # would silently corrupt the stream. Surface it as a
            # transient fault so the Retrier re-requests.
            raise TransientStoreError(
                f"truncated response for {b.block_id}: "
                f"got {len(d)} of {b.size} bytes"
            )
        if dig is not None:
            # Received bytes vs the store's attested digest: a mismatch
            # (bit-flip in transit) is transient — the Retrier re-fetches
            # — and exhaustion surfaces as a typed IntegrityError rather
            # than wrong bytes.
            try:
                check_block(d, dig, what=f"fetched block {b.block_id}")
            except IntegrityError:
                self.stats.bump(integrity_failures=1)
                raise
            self.stats.bump(blocks_verified=1)

    # ------------------------------------------------------------------ #
    # reading path (called from the application thread)
    # ------------------------------------------------------------------ #
    def read_range(self, global_start: int, global_end: int,
                   *, view: bool = False) -> bytes | memoryview:
        """Read logical-stream bytes [global_start, global_end); blocks
        until the data has been prefetched (paper: the reader waits,
        bounding the worst case at sequential performance).

        With ``view=True`` a request contained in one cached block is
        served as a zero-copy `memoryview` over the block buffer (valid
        indefinitely — the underlying bytes are immutable); multi-block
        requests still return `bytes`.
        """
        self._observe_compute_gap()
        try:
            if global_end <= global_start:
                return b""
            block = self.plan.block_at(global_start)
            if global_end <= block.global_end:
                # Fast path: one block — at most one copy (zero with view).
                data = self._read_single(block, global_start, global_end,
                                         view=view)
                self._last_read_bytes = len(data)
                self.stats.bump(bytes_read=len(data))
                return data
            out = bytearray()
            pos = global_start
            while pos < global_end:
                block = self.plan.block_at(pos)
                hi = min(global_end, block.global_end)
                out += self._read_single(block, pos, hi, view=True)
                pos = hi
            self._last_read_bytes = len(out)
            self.stats.bump(bytes_read=len(out))
            return bytes(out)
        finally:
            self._last_read_t = time.perf_counter()

    def _observe_compute_gap(self) -> None:
        if self.tuner is None:
            return
        now = time.perf_counter()
        if self._last_read_t is not None and self._last_read_bytes > 0:
            self.tuner.observe_compute(self._last_read_bytes,
                                       now - self._last_read_t)

    def _read_single(self, block: Block, gstart: int, gend: int,
                     *, view: bool) -> bytes | memoryview:
        lo = gstart - block.global_start
        hi = gend - block.global_start
        if self._buf_index == block.index:
            data = (memoryview(self._buf_data)[lo:hi] if view
                    else self._buf_data[lo:hi])
        else:
            data = self._read_from_block(block, gstart, gend, view=view)
        if gend >= block.global_end:
            if self._buf_index == block.index:
                self._buf_index, self._buf_data = None, b""
            self._mark_consumed(block)
        return data

    def _direct_get(self, block: Block, lo: int, hi: int) -> bytes:
        """Direct store read on the reader thread (patience fallback,
        backward seek past eviction, integrity healing) — resilient via
        the shared Retrier like every other production store call."""
        self.stats.bump(direct_reads=1)

        def attempt() -> bytes:
            if self.verify == "off":
                data, dig = self.store.get_range(
                    block.key, block.start + lo, block.start + hi), None
            else:
                data, dig = self.store.get_range_verified(
                    block.key, block.start + lo, block.start + hi)
            if len(data) != hi - lo:
                # Same guard as _request: a short response the server
                # reported as complete must retry, not silently hand the
                # application fewer bytes than it asked for.
                raise TransientStoreError(
                    f"truncated response for {block.block_id}: "
                    f"got {len(data)} of {hi - lo} bytes"
                )
            if dig is not None:
                try:
                    check_block(data, dig,
                                what=f"direct read {block.block_id}")
                except IntegrityError:
                    self.stats.bump(integrity_failures=1)
                    raise
                self.stats.bump(blocks_verified=1)
            return data

        return self._retrier.call(
            attempt, label=f"direct read {block.block_id}",
        )

    def _verify_tier_read(self, tier: CacheTier, data: bytes,
                          block_id: str) -> None:
        """Engine-side digest re-check of a full-block tier read. "edges"
        trusts self-verifying tiers (DirTier's journal crc, the peer
        transport's frame check) — hashing twice would pay the <5%
        overhead budget twice for the same guarantee; "full" re-checks
        unconditionally. Raises `IntegrityError` (the caller quarantines
        and heals)."""
        if self.verify == "off":
            return
        if self.verify == "edges" and getattr(tier, "verifies_reads", False):
            return
        dig = self.index.digest_of(block_id)
        if dig is None:
            return
        # Mismatch counting happens at the catch site — the tier itself
        # may also raise (DirTier's crc), and both must count once.
        check_block(data, dig, what=f"cached block {block_id}")
        self.stats.bump(blocks_verified=1)

    def _read_from_block(self, block: Block, gstart: int, gend: int,
                         *, view: bool = False) -> bytes | memoryview:
        info = self._info[block.index]
        t0 = time.perf_counter()
        stalled = False
        with self._cond:
            # Advancing the reader position releases readahead-horizon
            # headroom — wake parked prefetch streams BEFORE waiting on
            # them, or neither side would move.
            if block.index > self._reader_block:
                self._reader_block = block.index
                self._cond.notify_all()
            while info.state in (BlockState.UNFETCHED, BlockState.FETCHING):
                # An already-abandoned block short-circuits: once one
                # read() burned the full patience on this block, later
                # reads into it go direct immediately instead of paying
                # another 30 s each.
                if info.abandoned or time.perf_counter() - t0 > self.READ_PATIENCE_S:
                    stalled = True
                    info.abandoned = True
                    break
                self._cond.wait(timeout=0.5)
            state, tier, err = info.state, info.tier, info.error
        self.stats.bump(reader_wait_s=time.perf_counter() - t0)
        lo = gstart - block.global_start
        hi = gend - block.global_start
        if stalled:
            # Patience expired: the scheduler owes us this block but can't
            # deliver (wedged tier space / leaked flight). Degrade to a
            # direct read so the pipeline unwedges instead of hanging.
            return self._direct_get(block, lo, hi)
        if state == BlockState.CACHED and tier is not None:
            try:
                # Load the whole block from the tier once; serve subsequent
                # small reads from the reader-side buffer.
                self._buf_data = tier.read(block.block_id, 0, block.size)
                self._verify_tier_read(tier, self._buf_data, block.block_id)
            except IntegrityError:
                # The cached copy is provably wrong (tier-level crc or the
                # index digest disagrees with the bytes). Quarantine —
                # evict + tombstone, so no reader (local or sibling) can
                # hit it again — and heal from the backing store. A rotted
                # cache block costs one GET, never wrong data.
                self.stats.bump(integrity_failures=1)
                self.index.quarantine(block.block_id)
                return self._direct_get(block, lo, hi)
            except StoreError:
                # A sibling process sharing a persistent cache dir may
                # have evicted the file beneath our index entry — the
                # bytes are one range GET away, don't crash the reader.
                # Drop the stale entry so the next acquire re-fetches into
                # the cache instead of paying a direct GET forever.
                self.index.invalidate(block.block_id)
                return self._direct_get(block, lo, hi)
            self._buf_index = block.index
            return (memoryview(self._buf_data)[lo:hi] if view
                    else self._buf_data[lo:hi])
        if state == BlockState.FAILED:
            # Keep the failure typed: unhealable corruption must surface as
            # IntegrityError at the reader, not a generic prefetch failure.
            cls = IntegrityError if isinstance(err, IntegrityError) else StoreError
            raise cls(f"block {block.block_id} failed to prefetch") from err
        # CONSUMED/EVICTED (backward seek): the shared cache may still
        # hold the block (keep_cached, another reader's pin) — serve it
        # locally before paying a store GET.
        kind, val = self.index.acquire(block.block_id, self.io_class)
        if kind == "hit":
            try:
                if self.verify == "off":
                    data = val.read(block.block_id, lo, hi)
                else:
                    # Digests cover whole blocks: read the full block so
                    # the check can run, then slice. A backward seek is
                    # rare enough that the extra bytes are noise next to
                    # serving rotted data from an unverified partial read.
                    full = val.read(block.block_id, 0, block.size)
                    self._verify_tier_read(val, full, block.block_id)
                    data = full[lo:hi]
                self.stats.bump(cache_hits=1)
                return data
            except IntegrityError:
                # Rotted beneath us: quarantine (the unpin below is a
                # no-op once the entry is gone) and go direct.
                self.stats.bump(integrity_failures=1)
                self.index.quarantine(block.block_id)
            except StoreError:
                # Vanished beneath us: drop the stale entry, go direct.
                self.index.invalidate(block.block_id)
            finally:
                self.index.unpin(block.block_id)
        elif kind == "leader":
            self.index.abort_fetch(val)   # not fetching into the tier here
        else:
            self.index.leave(val)
        return self._direct_get(block, lo, hi)

    def _mark_consumed(self, block: Block) -> None:
        notify_evict = False
        with self._cond:
            info = self._info[block.index]
            if block.index + 1 > self._reader_block:
                self._reader_block = block.index + 1
            if info.state == BlockState.CACHED:
                info.state = BlockState.CONSUMED
                tier = info.tier
                # Eviction-latency fix: a consumed block sitting in a tier
                # past its high-water mark wakes the evictor NOW — a full
                # tier must not stall prefetchers for up to the whole
                # eviction interval.
                if (tier is not None
                        and tier.used >= self.high_water * tier.capacity):
                    notify_evict = True
            self._cond.notify_all()
        if notify_evict:
            self._request_eviction()

    # ------------------------------------------------------------------ #
    # eviction thread
    # ------------------------------------------------------------------ #
    def _request_eviction(self) -> None:
        with self._evict_cond:
            self._evict_wanted = True
            self._evict_cond.notify_all()

    def _evictable(self) -> list[Block]:
        with self._cond:
            return [
                self.plan.blocks[i]
                for i, info in enumerate(self._info)
                if info.state == BlockState.CONSUMED
            ]

    def _evict_blocks(self, blocks: list[Block]) -> None:
        for block in blocks:
            with self._cond:
                info = self._info[block.index]
                if info.state != BlockState.CONSUMED or info.tier is None:
                    continue
                # Claim the transition before unpinning so overlapping
                # eviction rounds never double-release the same pin.
                info.state = BlockState.EVICTED
                info.tier = None
            # Refcount-aware eviction replaces the old fire-and-forget
            # delete: the block disappears only when the LAST reader's pin
            # drops (and stays resident under keep_cached, where capacity
            # pressure evicts instead).
            evicted = self.index.unpin(block.block_id, want_evict=True)
            with self._cond:
                self._cond.notify_all()
            if evicted:
                self.stats.bump(blocks_evicted=1)

    def _evict_loop(self) -> None:
        while True:
            with self._evict_cond:
                if self._fetch and not self._evict_wanted:
                    self._evict_cond.wait(timeout=self.eviction_interval_s)
                self._evict_wanted = False
            if not self._fetch:
                return
            self._evict_blocks(self._evictable())

    def _final_sweep(self) -> None:
        """Release this reader's pin on every remaining cached block
        (paper: the eviction thread ensures deletion of all remaining
        files prior to terminating). Blocks another reader still pins, or
        a keep_cached index keeps warm for the next open/restart, survive
        the sweep — only the pin is dropped."""
        for i, info in enumerate(self._info):
            with self._cond:
                tier = info.tier
                state = info.state
                if tier is not None and state in (BlockState.CACHED,
                                                  BlockState.CONSUMED):
                    info.state = BlockState.EVICTED
                    info.tier = None
                else:
                    continue
            self.index.unpin(self.plan.blocks[i].block_id, want_evict=True)


class RollingPrefetchFile:
    """File-like view over a prefetched multi-file logical stream.

    Matches the subset of the S3Fs file API the paper's applications use:
    sequential ``read``/``seek``/``tell``. Backward seeks degrade to direct
    store reads when the target block was already evicted. ``readview``
    is the zero-copy variant for consumers (numpy decoding, device upload)
    that accept a `memoryview`.
    """

    def __init__(self, prefetcher: RollingPrefetcher) -> None:
        self._pf = prefetcher
        self._pos = 0
        self._closed = False
        prefetcher.start()

    # Deprecated constructor: forwards to the PrefetchFS reader registry.
    @classmethod
    def open(
        cls,
        store: ObjectStore,
        files: list[ObjectMeta],
        tiers: list[CacheTier],
        blocksize: int,
        **kw,
    ) -> "RollingPrefetchFile":
        warnings.warn(
            "RollingPrefetchFile.open(...) is deprecated; use "
            "repro_torch.io.PrefetchFS(store, policy=IOPolicy(engine='rolling', "
            "...)).open_many(files) instead",
            DeprecationWarning,
            stacklevel=2,
        )
        from repro_torch.io import IOPolicy, PrefetchFS

        policy = IOPolicy(engine="rolling", blocksize=blocksize, **kw)
        return PrefetchFS(store, policy=policy, tiers=tiers).open_many(files)

    @property
    def size(self) -> int:
        return self._pf.plan.total_bytes

    @property
    def stats(self) -> PrefetchStats:
        return self._pf.stats

    @property
    def closed(self) -> bool:
        return self._closed

    def read(self, n: int = -1) -> bytes:
        data = self._read_impl(n, view=False)
        return data if type(data) is bytes else bytes(data)

    def readview(self, n: int = -1) -> bytes | memoryview:
        """Like :meth:`read` but may return a zero-copy `memoryview` over
        the cached block buffer when the request lies within one block.
        The view stays valid after subsequent reads (the underlying block
        bytes are immutable)."""
        return self._read_impl(n, view=True)

    def _read_impl(self, n: int, *, view: bool) -> bytes | memoryview:
        if self._closed:
            raise ValueError("read on closed file")
        if n < 0:
            n = self.size - self._pos
        end = min(self._pos + n, self.size)
        if end <= self._pos:
            return b""
        data = self._pf.read_range(self._pos, end, view=view)
        self._pos = end
        return data

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
        if not self._closed:
            self._closed = True
            self._pf.close()

    def __enter__(self) -> "RollingPrefetchFile":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
