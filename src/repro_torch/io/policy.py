"""IOPolicy: the single configuration object for every reader engine.

The paper's extension of S3Fs keeps prefetch configuration out of the
application: callers open files and the filesystem carries the policy
(block size, cache tiers, concurrency). `IOPolicy` plays that role here —
one frozen value object covering every knob any engine understands, built
from keyword arguments, another config object (`from_config`), or an
existing policy plus per-open overrides (`replace`). Engines read only the
fields they care about; unknown-engine validation happens in the registry.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Mapping

from repro_torch.io.retry import RetryPolicy


@dataclass(frozen=True)
class IOPolicy:
    """Reader *and* writer configuration shared by all engines.

    Fields consumed per engine:
      * ``rolling``    — blocksize, depth, max_depth, coalesce,
        readahead_blocks, eviction_interval_s, retry (or
        max_retries/retry_backoff_s), hedge_timeout_s, max_hedges,
        throttle_aimd, autotune, tier_capacity;
      * ``sequential`` — blocksize, cache_blocks, retry;
      * ``direct``     — none (pass-through range reads);
      * write-behind `Writer` (``PrefetchFS.open_write``) — blocksize (the
        part size), write_depth, retry (or max_retries/retry_backoff_s),
        hedge_timeout_s, max_hedges, tier_capacity (staging budget).

    The adaptive-scheduling knobs:
      * ``coalesce`` — max adjacent blocks one store request may carry;
        >1 turns on coalesced ``get_ranges`` fetches (the engine holds the
        width at 1 while the link looks bandwidth-bound). The default
        ``None`` means "unset": the engine fetches block-at-a-time, but
        ``autotune`` may open the ceiling. An explicit value — including
        1, i.e. coalescing off — is a hard bound autotune respects;
      * ``readahead_blocks`` — fetch-window horizon ahead of the reader
        position (None = race to end-of-plan, the paper's behaviour);
      * ``max_depth`` — upper bound for the AIMD stream controller; None
        pins concurrency at ``depth``;
      * ``autotune`` — `PrefetchFS` owns a `BlockSizeTuner` fed by the
        engine's observed request timings and compute gaps, and retunes
        ``blocksize`` and ``coalesce`` on every open.
    """

    engine: str = "rolling"
    blocksize: int = 8 << 20
    depth: int = 1                      # concurrent prefetch streams
    max_depth: int | None = None        # AIMD stream ceiling (None = fixed depth)
    coalesce: int | None = None         # max blocks per range GET (None=unset)
    readahead_blocks: int | None = None  # fetch horizon ahead of the reader
    write_depth: int = 2                # concurrent write-behind part uploads
    eviction_interval_s: float = 5.0
    max_retries: int = 3
    retry_backoff_s: float = 0.05
    # The full resilience configuration. None (the default) builds a
    # `RetryPolicy` from the legacy `max_retries`/`retry_backoff_s`
    # knobs (full-jitter backoff); pass an explicit `RetryPolicy` for
    # the budget/deadline/jitter knobs. See :meth:`retry_policy`.
    retry: RetryPolicy | None = None
    hedge_timeout_s: float | None = None
    max_hedges: int = 4                 # hedge duplicates in flight, per handle
    # Throttle→depth feedback: a `ThrottleError` from the store halves
    # the AIMD stream target immediately (rolling engine, max_depth set).
    # False keeps the throttle-oblivious behaviour — retries back off but
    # concurrency stays up (the A/B baseline in bench_resilience).
    throttle_aimd: bool = True
    cache_blocks: int = 1               # sequential engine read-ahead cache
    autotune: bool = False              # retune blocksize/coalesce per open
    tier_capacity: int | None = None    # default cache budget when the FS owns tiers
    # Shared-cache retention: with True, fully-consumed blocks stay
    # resident in the tiers after a reader (or the whole fs) closes —
    # LRU-evicted only under capacity pressure — so per-epoch reopens,
    # other readers of the same keys, and (with a persistent DirTier)
    # restarted jobs start warm. False keeps the paper's
    # evict-when-consumed behaviour.
    keep_cached: bool = False
    # End-to-end block integrity (repro_torch.io.integrity). "off": no digests,
    # the zero-overhead baseline. "edges" (default): digests are minted
    # at the store fetch (verified against the store-attested digest),
    # carried in the CacheIndex, and re-checked whenever a block crosses
    # a tier/peer/store boundary — self-verifying tiers (DirTier's
    # journal crc) are trusted and not double-hashed. "full": edges plus
    # recomputation on EVERY cached read (even self-verifying tiers),
    # write-behind staging read-back verification, and an authoritative
    # backing-store cross-check of peer-served bytes (catches a
    # byzantine sibling whose frames are self-consistent). Mismatches
    # quarantine the block and heal through the shared Retrier.
    verify: str = "edges"
    # Workload class carried to the cache layer (HSM admission): "loader"
    # (bulk epoch sweeps: disk-level entry, scan-resistant), "ckpt"
    # (restore streams: top-tier entry), "serve" (latency-critical
    # restores: top-tier entry, protected from displacement by other
    # classes), or "default". A flat CacheIndex ignores it; the loader,
    # checkpoint, and serve call sites stamp their class when the caller
    # left this at "default".
    io_class: str = "default"

    def __post_init__(self) -> None:
        if self.blocksize <= 0:
            raise ValueError(f"blocksize must be positive, got {self.blocksize}")
        if self.depth < 1:
            raise ValueError(f"depth must be >= 1, got {self.depth}")
        if self.max_depth is not None and self.max_depth < self.depth:
            raise ValueError(
                f"max_depth ({self.max_depth}) must be >= depth ({self.depth})"
            )
        if self.coalesce is not None and self.coalesce < 1:
            raise ValueError(f"coalesce must be >= 1, got {self.coalesce}")
        if self.readahead_blocks is not None and self.readahead_blocks < 1:
            raise ValueError(
                f"readahead_blocks must be >= 1, got {self.readahead_blocks}"
            )
        if self.write_depth < 1:
            raise ValueError(
                f"write_depth must be >= 1, got {self.write_depth}"
            )
        if self.max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, got {self.max_retries}")
        if self.max_hedges < 1:
            raise ValueError(f"max_hedges must be >= 1, got {self.max_hedges}")
        if not self.io_class or not isinstance(self.io_class, str):
            raise ValueError(
                f"io_class must be a non-empty string, got {self.io_class!r}"
            )
        if self.verify not in ("off", "edges", "full"):
            raise ValueError(
                f"verify must be 'off', 'edges', or 'full', got {self.verify!r}"
            )

    def retry_policy(self) -> RetryPolicy:
        """The effective `RetryPolicy`: the explicit ``retry`` object
        when given, else one built from the legacy scalar knobs (with
        full-jitter backoff — the unjittered ``2 ** attempt`` loops this
        replaces synchronized concurrent streams into retry storms)."""
        if self.retry is not None:
            return self.retry
        return RetryPolicy(max_retries=self.max_retries,
                           backoff_s=self.retry_backoff_s)

    def replace(self, **overrides: Any) -> "IOPolicy":
        """A copy with the given fields overridden (per-open tweaks)."""
        return dataclasses.replace(self, **overrides)

    @classmethod
    def from_config(cls, src: Mapping[str, Any] | Any = None,
                    **overrides: Any) -> "IOPolicy":
        """Build a policy from a mapping or any object whose attribute
        names match `IOPolicy` field names exactly; unknown keys are
        ignored, explicit keyword overrides win. Configs with their own
        reader-knob spellings need an explicit mapping instead (e.g.
        `LoaderConfig.reader_policy()` maps `prefetch_depth` -> `depth`)."""
        names = {f.name for f in dataclasses.fields(cls)}
        kw: dict[str, Any] = {}
        if src is not None:
            if isinstance(src, Mapping):
                kw.update((k, v) for k, v in src.items() if k in names)
            else:
                kw.update((n, getattr(src, n)) for n in names if hasattr(src, n))
        kw.update(overrides)
        return cls(**kw)

    def default_tier_capacity(self) -> int:
        """Cache budget used when the filesystem builds its own tier: at
        least four in-flight blocks so the pipeline can roll."""
        if self.tier_capacity is not None:
            return self.tier_capacity
        return max(4 * self.blocksize, 64 << 20)
