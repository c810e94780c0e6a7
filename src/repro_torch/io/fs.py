"""PrefetchFS: one filesystem-style facade for reads AND writes.

Following the S3Fs idiom the paper extends, applications hold a filesystem
object and open file-like readers and writers from it::

    fs = PrefetchFS("sims3://bucket?latency_ms=40",       # URI or ObjectStore
                    policy=IOPolicy(engine="rolling", blocksize=8 << 20))
    with fs:
        f = fs.open("bucket/key")              # one object
        g = fs.open_many(metas, depth=4)       # multi-object logical stream,
                                               # per-open policy override
        w = fs.open_write("out/key")           # write-behind upload pipeline
        w.write(data); w.close()               # close() = durable publish
        print(fs.stats().snapshot())           # aggregated across all opens

The facade owns cache-tier lifecycle (builds a bounded MemTier on demand
when an engine needs one and none was supplied), resolves store URIs
through the store registry (``repro_torch.io.open_store``), dispatches
``IOPolicy.engine`` through the reader registry, runs one shared
`UploadPool` for every write-behind `Writer`, and aggregates per-handle
statistics into one `FSStats` view (writers fold in under the
``"write-behind"`` engine name). Training data loading, checkpoint
save/restore, serving cold-start, and every A/B benchmark construct their
I/O exclusively through this API.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Iterable, Sequence

from repro_torch.core.autotune import BlockSizeTuner
from repro_torch.io.policy import IOPolicy
from repro_torch.io.registry import available_engines, engine_spec
from repro_torch.io.stores import open_store
from repro_torch.io.write import UploadPool, Writer
from repro_torch.store.base import ObjectMeta, ObjectStore
from repro_torch.store.hsm import HSMStore
from repro_torch.store.tiers import CacheIndex, CacheTier, MemTier

# Importing the engines module populates the registry with the built-ins.
import repro_torch.io.engines  # noqa: F401  (side-effect import)

WRITE_ENGINE = "write-behind"   # per_engine stats bucket for writers

# Coalesce-width ceiling applied when autotune is on but the caller left
# `IOPolicy.coalesce` unset (None) — autotune alone should be able to
# engage coalesced fetches, and the cost model holds the width at 1
# anyway while the link looks bandwidth-bound.
AUTOTUNE_COALESCE_CAP = 16

# The facade's tuner accepts block sizes well below the paper-scale 1 MiB
# floor: scaled benchmarks and tests run with KiB-range blocks.
TUNER_MIN_BLOCKSIZE = 4 << 10


@dataclass
class FSStats:
    """Aggregated I/O statistics across every reader and writer a
    PrefetchFS opened.

    ``totals`` sums every numeric counter that any engine reports
    (bytes_read, bytes_fetched, bytes_uploaded, retries, hedges, ...);
    ``per_engine`` keeps the same sums split by engine name, with writers
    under ``"write-behind"``.
    """

    opens: int = 0
    totals: dict = field(default_factory=dict)
    per_engine: dict = field(default_factory=dict)
    # Closed-loop tuner estimates (latency_s, bandwidth_Bps,
    # compute_s_per_byte, requests_observed); None when autotune is off.
    tuner: dict | None = None
    # Shared cache-index counters (hits, misses, joins, evictions,
    # recovered, resident_blocks/bytes); None until the fs has tiers.
    cache: dict | None = None
    # HSM placement counters (promotions, demotions, per-tier and
    # per-class hits, residency per tier, cost-model estimates); None
    # unless the fs index is an `HSMIndex`.
    hsm: dict | None = None
    # Distributed-prefetch counters (peer hits/misses, bytes from peers,
    # dead-peer fallbacks, plus nested group/server views); None unless
    # the fs store is a `PeerAwareStore`.
    peer: dict | None = None
    # End-to-end integrity counters (repro_torch.io.integrity):
    # ``blocks_verified`` digest checks that passed, ``failures`` digest
    # mismatches the engines detected (each one healed by a re-fetch, or
    # surfaced as a typed IntegrityError on exhaustion), ``quarantined``
    # cache entries evicted + tombstoned for failing verification. All
    # zeros under ``verify="off"``.
    integrity: dict = field(default_factory=dict)

    def snapshot(self) -> dict:
        return {
            "opens": self.opens,
            "totals": dict(self.totals),
            "per_engine": {k: dict(v) for k, v in self.per_engine.items()},
            "tuner": dict(self.tuner) if self.tuner is not None else None,
            "cache": dict(self.cache) if self.cache is not None else None,
            "hsm": dict(self.hsm) if self.hsm is not None else None,
            "peer": dict(self.peer) if self.peer is not None else None,
            "integrity": dict(self.integrity),
        }


class PrefetchFS:
    """Filesystem facade over an `ObjectStore` with pluggable prefetching."""

    def __init__(
        self,
        store: ObjectStore | str,
        policy: IOPolicy | None = None,
        tiers: Sequence[CacheTier] | None = None,
        index: CacheIndex | None = None,
    ) -> None:
        # `store` may be a URI ("mem://", "local:///path", "sims3://bucket")
        # resolved through the store registry; same URI -> same instance.
        self.store = open_store(store)
        # An `hsm://` composite store carries its whole hierarchy: adopt
        # its tiers and `HSMIndex` (unless the caller overrides them) and
        # read through the backing store — every engine then places blocks
        # via HSM admission/promotion with no call-site changes. Two
        # filesystems opened on the same hsm URI share one hierarchy.
        if isinstance(self.store, HSMStore):
            if tiers is None:
                tiers = self.store.tiers
            if index is None:
                index = self.store.index
            self.store = self.store.inner
        # A `peer://` composite store likewise carries a hierarchy —
        # adopt it — but unlike HSM the store itself stays in place:
        # ownership routing (home-host fetch vs direct GET) lives in the
        # wrapper's get_range/get_ranges, so engines must keep reading
        # through it. Imported lazily: repro_torch.peer depends on
        # repro_torch.io.retry, so an eager import here would close the cycle
        # for whichever package is imported first.
        from repro_torch.peer.store import PeerAwareStore
        self._peer_store: PeerAwareStore | None = None
        if isinstance(self.store, PeerAwareStore):
            self._peer_store = self.store
            if tiers is None and self.store.tiers:
                tiers = self.store.tiers
            if index is None and self.store.index is not None:
                index = self.store.index
        self.policy = policy if policy is not None else IOPolicy()
        self._tiers: list[CacheTier] | None = (
            list(tiers) if tiers is not None else None
        )
        # One CacheIndex per distinct tier list: every reader this fs opens
        # over the same tiers shares residency, refcounts, and in-flight
        # fetch registration. An explicit `index` (e.g. handed to several
        # fs instances) extends that sharing across filesystems; its tiers
        # become the fs tiers unless `tiers` overrides them.
        self._indexes: dict[tuple[int, ...], CacheIndex] = {}
        if index is not None:
            if self._tiers is None:
                self._tiers = list(index.tiers)
            self._indexes[tuple(id(t) for t in index.tiers)] = index
        self._lock = threading.RLock()
        # Open readers AND writers, as (engine-name, handle) pairs.
        self._handles: list[tuple[str, object]] = []
        # Stats of already-closed handles, folded per engine so a loader
        # that reopens a stream every epoch doesn't accumulate dead reader
        # objects (see _prune_closed).
        self._folded: dict[str, dict] = {}
        self._pool: UploadPool | None = None
        self._closed = False
        # One tuner per filesystem: every autotuned open shares (and
        # feeds) the same link/compute estimates.
        self._tuner: BlockSizeTuner | None = (
            BlockSizeTuner(min_blocksize=TUNER_MIN_BLOCKSIZE)
            if self.policy.autotune else None
        )

    # ------------------------------------------------------------------ #
    # opening readers
    # ------------------------------------------------------------------ #
    def open(self, key, *, policy: IOPolicy | None = None,
             tiers: Sequence[CacheTier] | None = None, **overrides):
        """Open one object (or a list of them) as a `Reader`.

        ``key`` is an object key string, an `ObjectMeta`, or a list of
        either (lists delegate to :meth:`open_many`). Keyword overrides
        (``engine=``, ``blocksize=``, ``depth=``, ...) apply on top of the
        filesystem policy for this open only.
        """
        if isinstance(key, (list, tuple)):
            return self.open_many(key, policy=policy, tiers=tiers, **overrides)
        return self.open_many([key], policy=policy, tiers=tiers, **overrides)

    def open_many(self, keys: Iterable, *, policy: IOPolicy | None = None,
                  tiers: Sequence[CacheTier] | None = None, **overrides):
        """Open a list of objects as ONE logical sequential stream — the
        paper's multi-file case ("treating a list of files as a single
        file"). Returns a `Reader`."""
        pol = policy if policy is not None else self.policy
        if overrides:
            pol = pol.replace(**overrides)
        spec = engine_spec(pol.engine)
        # Flag check BEFORE any store metadata round-trip, so an open on a
        # closed (or closing) filesystem short-circuits without issuing
        # store requests. Resolution itself stays outside the lock —
        # holding it across store.size() would serialize every open and
        # block stats()/close() behind simulated network latency.
        with self._lock:
            if self._closed:
                raise ValueError("open on closed PrefetchFS")
        files = [self._resolve(k) for k in keys]
        # Re-check + factory call + registration under one lock: an open
        # racing with close() either lands in close()'s sweep or observes
        # the closed flag — never an orphaned reader.
        with self._lock:
            if self._closed:
                raise ValueError("open on closed PrefetchFS")
            if pol.autotune:
                pol = self._retune(pol, files, tiers)
            if tiers is not None:
                use_tiers = list(tiers)
            elif spec.needs_tiers:
                use_tiers = self._ensure_tiers(pol)
            else:
                # Engines that merely *accept* an index still share the fs
                # tiers when the fs already has them (sequential warm
                # reads); none are created just for them.
                use_tiers = list(self._tiers) if self._tiers else []
            kw: dict = {}
            if spec.accepts_tuner:
                kw["tuner"] = self._tuner
            if spec.accepts_index:
                kw["index"] = self._index_for(use_tiers, pol)
            reader = spec.factory(self.store, files, use_tiers, pol, **kw)
            self._prune_closed()
            self._handles.append((pol.engine, reader))
        return reader

    def _index_for(self, tiers: Sequence[CacheTier],
                   pol: IOPolicy) -> CacheIndex | None:
        """Shared `CacheIndex` for a tier list (created on first use, one
        per distinct list, primed from persistent tiers' recovered
        blocks). An open asking for ``keep_cached`` upgrades an existing
        index to retention — the reverse never downgrades, since other
        readers may rely on warm blocks. Caller holds `_lock`."""
        if not tiers:
            return None
        key = tuple(id(t) for t in tiers)
        idx = self._indexes.get(key)
        if idx is None:
            idx = CacheIndex(list(tiers), keep_cached=pol.keep_cached)
            self._indexes[key] = idx
        elif pol.keep_cached and not idx.keep_cached:
            idx.set_keep_cached(True)
        return idx

    def _retune(self, pol: IOPolicy, files: list[ObjectMeta],
                tiers: Sequence[CacheTier] | None) -> IOPolicy:
        """Closed-loop per-open retuning: pick the Eq.-4 blocksize from
        the tuner's current link/compute estimates (falling back to the
        policy blocksize while unobserved) and open the coalesce-width
        ceiling so the engine's cost model can amortize request latency.
        Caller holds `_lock`."""
        tuner = self._ensure_tuner()
        total = sum(m.size for m in files)
        use_tiers = list(tiers) if tiers is not None else self._tiers
        budget = (sum(t.capacity for t in use_tiers) if use_tiers
                  else pol.default_tier_capacity())
        blocksize = tuner.suggest_blocksize(
            total, cache_budget=budget, default=pol.blocksize
        )
        # Open the ceiling only when the caller left coalesce unset: an
        # explicit IOPolicy.coalesce — including 1, i.e. coalescing off —
        # bounds the payload one request may carry (memory per GET,
        # tier-fit granularity) and is not the tuner's to override.
        coalesce = (pol.coalesce if pol.coalesce is not None
                    else AUTOTUNE_COALESCE_CAP)
        return pol.replace(blocksize=blocksize, coalesce=coalesce)

    def _ensure_tuner(self) -> BlockSizeTuner:
        if self._tuner is None:
            self._tuner = BlockSizeTuner(min_blocksize=TUNER_MIN_BLOCKSIZE)
        return self._tuner

    @property
    def tuner(self) -> BlockSizeTuner | None:
        """The filesystem's closed-loop tuner (None until an autotuned
        policy is seen)."""
        with self._lock:
            return self._tuner

    def open_write(self, key, *, policy: IOPolicy | None = None,
                   tiers: Sequence[CacheTier] | None = None,
                   **overrides) -> Writer:
        """Open `key` for writing through the write-behind pipeline.

        Returns a `Writer`: ``write()`` buffers into part-sized chunks
        staged in the cache tiers, a shared pool of ``write_depth``
        threads uploads parts in the background, ``flush()`` is a
        durability barrier, and ``close()`` atomically publishes the
        object. Keyword overrides (``blocksize=``, ``write_depth=``,
        ``hedge_timeout_s=``, ...) apply to this writer only.
        """
        pol = policy if policy is not None else self.policy
        if overrides:
            pol = pol.replace(**overrides)
        with self._lock:
            if self._closed:
                raise ValueError("open_write on closed PrefetchFS")
            use_tiers = list(tiers) if tiers is not None \
                else self._ensure_tiers(pol)
            if self._pool is None:
                self._pool = UploadPool()
            self._pool.ensure(pol.write_depth)
            writer = Writer(self.store, str(key), pol, use_tiers, self._pool,
                            index=self._index_for(use_tiers, pol))
            self._prune_closed()
            self._handles.append((WRITE_ENGINE, writer))
        return writer

    def _resolve(self, key) -> ObjectMeta:
        if isinstance(key, ObjectMeta):
            return key
        key = str(key)
        return ObjectMeta(key, self.store.size(key))

    def _ensure_tiers(self, policy: IOPolicy) -> list[CacheTier]:
        with self._lock:
            if self._tiers is None:
                self._tiers = [
                    MemTier(policy.default_tier_capacity(), name="prefetchfs.mem")
                ]
            return self._tiers

    # ------------------------------------------------------------------ #
    # introspection
    # ------------------------------------------------------------------ #
    def ls(self, prefix: str = "") -> list[ObjectMeta]:
        """List objects under a prefix (one store metadata request)."""
        return self.store.list_objects(prefix)

    def engines(self) -> tuple[str, ...]:
        return available_engines()

    @property
    def tiers(self) -> list[CacheTier]:
        """The cache tiers this filesystem manages (empty until an engine
        that needs them is opened, unless tiers were supplied)."""
        with self._lock:
            return list(self._tiers or [])

    @property
    def cache_index(self) -> CacheIndex | None:
        """The shared `CacheIndex` over the fs-level tiers (None until a
        reader over them has been opened)."""
        with self._lock:
            if not self._tiers:
                return None
            return self._indexes.get(tuple(id(t) for t in self._tiers))

    @staticmethod
    def _fold_snapshot(bucket: dict, reader) -> None:
        bucket["opens"] = bucket.get("opens", 0) + 1
        stats_obj = getattr(reader, "stats", None)
        snap = stats_obj.snapshot() if stats_obj is not None else {}
        for k, v in snap.items():
            if not isinstance(v, (int, float)):
                continue
            if k == "depth_peak":
                # A high-water mark, not a counter: folding across
                # reopened readers keeps the peak, not the sum of peaks.
                bucket[k] = max(bucket.get(k, 0), v)
            else:
                bucket[k] = bucket.get(k, 0) + v

    def _prune_closed(self) -> None:
        """Fold the stats of closed readers/writers into `_folded` and drop
        the handle objects, so per-epoch reopen loops stay O(1) memory.
        Caller holds `_lock`."""
        live = []
        for engine, handle in self._handles:
            if getattr(handle, "closed", False):
                self._fold_snapshot(self._folded.setdefault(engine, {}), handle)
            else:
                live.append((engine, handle))
        self._handles = live

    def stats(self) -> FSStats:
        """Aggregate statistics across every reader and writer opened so
        far (open or closed); closed handles' stats persist in the folded
        totals (writers appear under the ``"write-behind"`` engine)."""
        with self._lock:
            per_engine = {k: dict(v) for k, v in self._folded.items()}
            handles = list(self._handles)
            tuner = self._tuner
            index = None
            if self._tiers:
                index = self._indexes.get(tuple(id(t) for t in self._tiers))
        for engine, handle in handles:
            self._fold_snapshot(per_engine.setdefault(engine, {}), handle)
        out = FSStats(per_engine=per_engine)
        if tuner is not None:
            out.tuner = tuner.estimates()
        if index is not None:
            out.cache = index.snapshot()
            hsm_snap = getattr(index, "hsm_snapshot", None)
            if hsm_snap is not None:
                out.hsm = hsm_snap()
        if self._peer_store is not None:
            out.peer = self._peer_store.peer_snapshot()
        for bucket in per_engine.values():
            out.opens += bucket.get("opens", 0)
            for k, v in bucket.items():
                if k == "opens":
                    continue
                if k == "depth_peak":
                    out.totals[k] = max(out.totals.get(k, 0), v)
                else:
                    out.totals[k] = out.totals.get(k, 0) + v
        out.integrity = dict(
            blocks_verified=out.totals.get("blocks_verified", 0),
            failures=out.totals.get("integrity_failures", 0),
            quarantined=(out.cache or {}).get("quarantined", 0),
        )
        return out

    # ------------------------------------------------------------------ #
    # lifecycle
    # ------------------------------------------------------------------ #
    def close(self) -> None:
        """Close every reader and writer this filesystem opened (engines
        run their final eviction sweep so owned tiers end empty — unless
        ``IOPolicy.keep_cached`` retains consumed blocks warm for the next
        open or a restarted job; writers flush and publish), then shut
        down the upload pool. The first writer-close failure is re-raised
        after everything is closed."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            handles = list(self._handles)
            pool = self._pool
        # Closing outside the lock: rolling close joins worker threads and
        # writer close blocks on its upload barrier.
        first_err: Exception | None = None
        for _, handle in handles:
            try:
                handle.close()
            except Exception as e:   # repro: allow[RP005] — re-raised below
                if first_err is None:
                    first_err = e
        if pool is not None:
            pool.close()
        if first_err is not None:
            raise first_err

    def __enter__(self) -> "PrefetchFS":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
