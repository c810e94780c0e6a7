"""Write-behind upload pipeline: the producer-side mirror of Rolling Prefetch.

A `Writer` (returned by ``PrefetchFS.open_write``) buffers application
writes into part-sized chunks (``IOPolicy.blocksize``), stages each sealed
part in a local cache tier (the bounded staging budget doubles as
backpressure), and hands it to a shared `UploadPool` whose
``IOPolicy.write_depth`` background threads upload parts concurrently with
ongoing application writes — ``max(T_compute, T_upload)`` instead of
``T_compute + T_upload``, the paper's read-side pipeline run in reverse
(cf. the successor user-space hierarchical-storage work, arXiv:2404.11556,
and the checkpoint-stall analysis of arXiv:2108.06322).

Durability contract:

  * ``write()`` may return before bytes reach the store;
  * ``flush()`` seals the current buffer as a part and blocks until every
    sealed part is durably uploaded, raising the first upload error;
  * ``close()`` flushes, then atomically publishes the object (multipart
    ``complete()`` — or one background ``put`` when everything fit in a
    single part, matching the legacy sync path request-for-request), so a
    crashed writer never leaves a partially visible object;
  * ``close_async()`` + ``join()`` split close into enqueue-publish and
    barrier, so producers closing many writers (checkpoint save) overlap
    the final round-trips instead of paying one per writer serially;
  * ``abort()`` drops pending work and never publishes.

Transient store faults retry through the unified resilience layer
(`repro_torch.io.retry`): full-jitter exponential backoff via the policy's
`RetryPolicy`, and an optional hedge (``IOPolicy.hedge_timeout_s``,
capped by ``max_hedges``) duplicates a straggling part upload — puts to
the same part index are idempotent, so taking the first copy that lands
is safe. The rolling read engine resolves through the same layer.
"""

from __future__ import annotations

import itertools
import queue
import threading
import time
from contextlib import suppress
from dataclasses import dataclass, field
from typing import Callable, Sequence

from repro_torch.io.policy import IOPolicy
from repro_torch.io.retry import Hedger, Retrier
from repro_torch.store.base import ObjectStore, StoreError
from repro_torch.store.tiers import CacheIndex, CacheTier
from repro_torch.utils import get_logger

log = get_logger("io.write")

_WRITER_IDS = itertools.count()


@dataclass
class WriteStats:
    """Counters mutated from the application thread and the upload pool;
    same bump()/locked-snapshot discipline as the reader `PrefetchStats`."""

    bytes_written: int = 0      # accepted from the application
    bytes_uploaded: int = 0     # durably handed to the store
    parts_uploaded: int = 0
    put_requests: int = 0
    retries: int = 0
    throttles: int = 0          # ThrottleError responses (503 SlowDown)
    hedges: int = 0
    upload_s: float = 0.0       # cumulative time inside store calls
    stage_wait_s: float = 0.0   # application blocked on staging backpressure
    barrier_wait_s: float = 0.0  # flush()/close() waiting on in-flight parts
    unstaged_parts: int = 0     # parts too big for any tier (carried in RAM)
    _lock: threading.Lock = field(default_factory=threading.Lock,
                                  repr=False, compare=False)

    def bump(self, **deltas: int | float) -> None:
        with self._lock:
            for name, delta in deltas.items():
                setattr(self, name, getattr(self, name) + delta)

    def snapshot(self) -> dict:
        with self._lock:
            return {k: v for k, v in self.__dict__.items()
                    if not k.startswith("_")}


class UploadPool:
    """Shared pool of daemon threads draining part-upload jobs from every
    writer of one `PrefetchFS`; grows on demand to the largest
    ``write_depth`` any writer asked for."""

    def __init__(self) -> None:
        self._q: queue.Queue = queue.Queue()
        self._threads: list[threading.Thread] = []
        self._lock = threading.Lock()
        self._closed = False

    @property
    def depth(self) -> int:
        with self._lock:
            return len(self._threads)

    def ensure(self, depth: int) -> None:
        with self._lock:
            if self._closed:
                raise ValueError("UploadPool is closed")
            while len(self._threads) < depth:
                t = threading.Thread(
                    target=self._worker,
                    name=f"fs-upload-{len(self._threads)}",
                    daemon=True,
                )
                t.start()
                self._threads.append(t)

    def submit(self, job: Callable[[], None]) -> None:
        # Enqueue UNDER the lock: checking `_closed` and putting outside
        # it raced with close() — a job could land behind the shutdown
        # sentinels and be silently dropped while its writer's barrier
        # waited on a `_done` bump that would never come.
        with self._lock:
            if self._closed:
                raise ValueError("submit on closed UploadPool")
            self._q.put(job)

    def _worker(self) -> None:
        while True:
            job = self._q.get()
            if job is None:
                return
            try:
                job()
            except BaseException:   # repro: allow[RP005] — jobs capture their own errors; belt only
                log.exception("upload job leaked an exception")

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            threads = list(self._threads)
            # Sentinels go in while still holding the lock, so every job
            # accepted by submit() is strictly ahead of them in the FIFO —
            # workers drain all remaining jobs before they see a sentinel.
            for _ in threads:
                self._q.put(None)
        for t in threads:
            t.join(timeout=30.0)


class _Part:
    """One sealed part awaiting upload: either staged in a tier (data is
    read back at upload time) or carried inline when no tier can hold it.
    ``digest`` is minted over the sealed bytes at staging time (only with
    ``IOPolicy.verify="full"``) and re-checked after the tier read-back,
    so a part that rotted in staging fails the upload loudly instead of
    persisting corruption to the store."""

    __slots__ = ("index", "size", "tier", "block_id", "data", "digest")

    def __init__(self, index: int, size: int, tier: CacheTier | None,
                 block_id: str | None, data: bytes | None,
                 digest: str | None = None) -> None:
        self.index = index
        self.size = size
        self.tier = tier
        self.block_id = block_id
        self.data = data
        self.digest = digest


class Writer:
    """Write-behind file-like object; construct via ``PrefetchFS.open_write``."""

    def __init__(
        self,
        store: ObjectStore,
        key: str,
        policy: IOPolicy,
        tiers: Sequence[CacheTier],
        pool: UploadPool,
        index: CacheIndex | None = None,
    ) -> None:
        self.store = store
        self.key = key
        self.policy = policy
        self.tiers = list(tiers)
        # Shared cache index over the same tiers (when the fs has one):
        # staging backpressure may pressure-evict unpinned cached blocks
        # instead of spinning forever against a tier filled by
        # keep_cached readers.
        self.index = index
        self.stats = WriteStats()
        self._pool = pool
        self._cond = threading.Condition()
        self._buf = bytearray()
        self._next_index = 0
        self._sealed = 0            # jobs handed to the pool
        self._done = 0              # jobs finished (success, skip, or error)
        self._mp = None             # multipart handle, created at first seal
        self._error: Exception | None = None
        self._closing = False       # close_async() called; no more writes
        self._closed = False
        self._aborted = False
        self._pos = 0
        self._uid = next(_WRITER_IDS)
        # Unified resilience layer: one Retrier (full-jitter backoff,
        # shared across this writer's concurrent part uploads) and one
        # Hedger (max-hedges-in-flight cap) replace the old inline
        # `2 ** attempt` loop and its copy-pasted hedging.
        self._retrier = Retrier(
            policy.retry_policy(),
            on_retry=lambda attempt, exc, pause: self.stats.bump(retries=1),
            on_throttle=lambda: self.stats.bump(throttles=1),
        )
        self._hedger = Hedger(
            policy.hedge_timeout_s,
            max_in_flight=policy.max_hedges,
            on_hedge=lambda: self.stats.bump(hedges=1, put_requests=1),
        )

    # ------------------------------------------------------------------ #
    # file-object surface
    # ------------------------------------------------------------------ #
    @property
    def closed(self) -> bool:
        return self._closed

    def tell(self) -> int:
        return self._pos

    def write(self, data) -> int:
        """Accept bytes; returns immediately once the bytes are staged
        (upload happens behind the write barrier)."""
        if self._closed or self._closing:
            raise ValueError("write on closed Writer")
        self._raise_pending()
        data = bytes(data)
        self._buf += data
        self._pos += len(data)
        self.stats.bump(bytes_written=len(data))
        bs = self.policy.blocksize
        while len(self._buf) >= bs:
            part = bytes(self._buf[:bs])
            del self._buf[:bs]
            self._seal(part)
        return len(data)

    def flush(self) -> None:
        """Barrier: seal the current buffer (forcing multipart mode) and
        block until every sealed part is durably uploaded."""
        if self._closed or self._closing:
            raise ValueError("flush on closed Writer")
        if self._buf:
            part = bytes(self._buf)
            self._buf.clear()
            self._seal(part)
        self._barrier()

    def close_async(self) -> None:
        """Seal the remainder and enqueue the final publish on the upload
        pool; pair with :meth:`join`. Lets a producer closing many writers
        (checkpoint save) overlap their publishes instead of paying one
        store round-trip per writer serially."""
        if self._closed:
            raise ValueError("close_async on closed Writer")
        if self._closing:
            return
        self._closing = True
        if self._mp is None:
            # Everything fits one part: a single background put — the
            # same request shape as the legacy sync path.
            data = bytes(self._buf)
            self._buf.clear()
            with self._cond:
                self._sealed += 1
            self._pool.submit(lambda: self._upload_whole(data))
        else:
            if self._buf:
                part = bytes(self._buf)
                self._buf.clear()
                self._seal(part)
            # The finisher job runs multipart complete() once every part
            # job (all enqueued before it — FIFO) has finished, so it
            # never waits on work queued behind itself: no pool deadlock.
            with self._cond:
                self._sealed += 1
            self._pool.submit(self._finish_multipart)

    def join(self) -> None:
        """Block until the object published by :meth:`close_async` is
        durable; raises `StoreError` (and aborts) on permanent failure."""
        if not self._closing:
            raise ValueError("join() before close_async()")
        if self._closed:
            return
        try:
            self._barrier()
        except BaseException:
            self.abort()
            raise
        self._closed = True

    def close(self) -> None:
        """Flush and atomically publish the object. Raises `StoreError` if
        any part upload failed permanently (the object is then aborted and
        never becomes visible)."""
        if self._closed:
            return
        self.close_async()
        self.join()

    def abort(self) -> None:
        """Drop buffered and in-flight work; the object is never published
        (queued parts drain as no-ops and release their staging budget)."""
        with self._cond:
            self._aborted = True
            self._closed = True
            self._cond.notify_all()
        self._buf.clear()
        if self._mp is not None:
            with suppress(Exception):
                self._mp.abort()

    def __enter__(self) -> "Writer":
        return self

    def __exit__(self, exc_type, *exc) -> None:
        if exc_type is not None:
            self.abort()
        else:
            self.close()

    # ------------------------------------------------------------------ #
    # sealing + staging (application thread)
    # ------------------------------------------------------------------ #
    def _seal(self, data: bytes) -> None:
        # The multipart handshake is a store round-trip; doing it under
        # _cond stalled every upload worker's barrier bump behind the
        # first seal's network latency. Only the application thread
        # seals, so the lazy init cannot race itself, and workers read
        # _mp only from jobs queued after this publish.
        if self._mp is None:
            mp = self.store.start_multipart(self.key)
            with self._cond:
                self._mp = mp
        with self._cond:
            index = self._next_index
            self._next_index += 1
            self._sealed += 1
        part = None
        try:
            part = self._stage(index, data)
            self._pool.submit(lambda: self._upload(part))
        except BaseException:
            # Staging failed (tier I/O error) or the pool refused the job
            # (closed underneath us): no upload will ever bump `_done`
            # for this seal, so `_sealed` must be unwound or every later
            # barrier — flush(), close(), join() — wedges forever. A
            # part that did get staged also gives its tier budget back.
            with self._cond:
                self._sealed -= 1
                self._cond.notify_all()
            if part is not None and part.tier is not None:
                with suppress(Exception):
                    part.tier.delete(part.block_id)
                    part.tier.release(part.size)
            raise

    def _stage(self, index: int, data: bytes) -> _Part:
        """Park the sealed part in the first tier with budget; block (the
        paper's bounded-cache backpressure, pointed at the producer) until
        an upload frees space. Parts no tier could ever hold are carried
        in memory so the pipeline cannot deadlock."""
        block_id = f"wb/{self._uid:04d}/{self.key}/{index:06d}"
        t0 = time.perf_counter()
        try:
            if not self.tiers or all(len(data) > t.capacity for t in self.tiers):
                self.stats.bump(unstaged_parts=1)
                return _Part(index, len(data), None, None, data)
            while True:
                for cand in self.tiers:
                    if len(data) > cand.capacity:
                        continue
                    if cand.available() < len(data):
                        cand.verify_used()
                    reserved = cand.reserve(len(data))
                    if not reserved and self.index is not None:
                        # Tier full of retained cache blocks (keep_cached
                        # readers), not in-flight parts: evict unpinned
                        # ones, or the producer would wait forever on
                        # uploads that free nothing.
                        if self.index.evict_from(cand, len(data)) > 0:
                            reserved = cand.reserve(len(data))
                    if reserved:
                        try:
                            # durable=False: staged parts are transient — a
                            # persistent DirTier must not journal them (a
                            # crashed producer's staging is garbage-collected
                            # at recovery, never resurrected into the cache).
                            cand.write(block_id, data, durable=False)
                        except Exception:
                            # ENOSPC / torn tier write: hand the budget
                            # back or the tier's inflight accounting
                            # shrinks it forever (verify_used treats
                            # inflight bytes as legitimate).
                            cand.cancel(len(data))
                            raise
                        cand.commit(len(data))
                        digest = None
                        if self.policy.verify == "full":
                            from repro_torch.io.integrity import block_digest
                            digest = block_digest(data)
                        return _Part(index, len(data), cand, block_id, None,
                                     digest)
                with self._cond:
                    if self._error is not None or self._aborted:
                        # Pipeline is failing anyway; skip backpressure so
                        # the caller reaches the error at the next barrier.
                        self.stats.bump(unstaged_parts=1)
                        return _Part(index, len(data), None, None, data)
                    self._cond.wait(timeout=0.01)
        finally:
            self.stats.bump(stage_wait_s=time.perf_counter() - t0)

    # ------------------------------------------------------------------ #
    # upload jobs (UploadPool threads)
    # ------------------------------------------------------------------ #
    def _upload(self, part: _Part) -> None:
        try:
            with self._cond:
                skip = self._aborted or self._error is not None
            data = part.data
            if part.tier is not None:
                try:
                    if not skip:   # skipped jobs only free their staging
                        data = part.tier.read(part.block_id, 0, part.size)
                        if part.digest is not None:
                            # verify="full": the sealed bytes' digest must
                            # survive the staging round-trip. A mismatch
                            # is NOT healable — the application's bytes
                            # exist nowhere else — so it fails the writer
                            # loudly at the next barrier rather than
                            # persisting corruption.
                            from repro_torch.io.integrity import check_block
                            check_block(
                                data, part.digest,
                                what=f"staged part {part.block_id}",
                            )
                finally:
                    part.tier.delete(part.block_id)
                    part.tier.release(part.size)
            if not skip:
                t0 = time.perf_counter()
                self._execute_put(lambda: self._mp.put_part(part.index, data))
                self.stats.bump(
                    upload_s=time.perf_counter() - t0,
                    parts_uploaded=1,
                    bytes_uploaded=part.size,
                )
        except Exception as e:   # repro: allow[RP005] — surfaced at the barrier
            self._record_error(e)
        finally:
            with self._cond:
                self._done += 1
                self._cond.notify_all()

    def _finish_multipart(self) -> None:
        """Pool job: wait for every part job (all queued ahead of this
        one), then publish via multipart complete()."""
        try:
            with self._cond:
                self._cond.wait_for(lambda: self._done >= self._sealed - 1)
                skip = self._aborted or self._error is not None
            if not skip:
                t0 = time.perf_counter()
                self._execute_put(self._mp.complete)
                self.stats.bump(upload_s=time.perf_counter() - t0)
        except Exception as e:   # repro: allow[RP005] — surfaced at the barrier
            self._record_error(e)
        finally:
            with self._cond:
                self._done += 1
                self._cond.notify_all()

    def _upload_whole(self, data: bytes) -> None:
        try:
            with self._cond:
                skip = self._aborted
            if not skip:
                t0 = time.perf_counter()
                self._execute_put(lambda: self.store.put(self.key, data))
                self.stats.bump(
                    upload_s=time.perf_counter() - t0,
                    parts_uploaded=1,
                    bytes_uploaded=len(data),
                )
        except Exception as e:   # repro: allow[RP005] — surfaced at the barrier
            self._record_error(e)
        finally:
            with self._cond:
                self._done += 1
                self._cond.notify_all()

    def _execute_put(self, fn: Callable[[], None]) -> None:
        """Retries + optional hedging around one store request, resolved
        through the shared resilience layer (puts to the same key/part
        index are idempotent, so taking the first hedged copy that lands
        is safe)."""

        def attempt():
            self.stats.bump(put_requests=1)
            return self._hedger.call(fn)

        self._retrier.call(attempt, label=f"upload {self.key!r}")

    # ------------------------------------------------------------------ #
    # error + barrier plumbing
    # ------------------------------------------------------------------ #
    def _record_error(self, e: Exception) -> None:
        with self._cond:
            if self._error is None:
                self._error = e
            self._cond.notify_all()
        log.error("writer %s: upload failed: %s", self.key, e)

    def _raise_pending(self) -> None:
        with self._cond:
            err = self._error
        if err is not None:
            raise StoreError(
                f"write-behind upload failed for {self.key!r}"
            ) from err

    def _barrier(self) -> None:
        t0 = time.perf_counter()
        with self._cond:
            self._cond.wait_for(lambda: self._done >= self._sealed)
        self.stats.bump(barrier_wait_s=time.perf_counter() - t0)
        self._raise_pending()
