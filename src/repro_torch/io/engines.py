"""Built-in reader engines.

  * ``rolling``    — the paper's Rolling Prefetch (three-thread engine over
    bounded cache tiers); requires tiers, which `PrefetchFS` supplies;
  * ``sequential`` — the S3Fs/fsspec-style on-demand block cache baseline;
  * ``direct``     — uncached pass-through range reads.

Each factory receives ``(store, files, tiers, policy)`` and returns a
`Reader`. New engines (real S3, async, sharded multi-host) register the
same way and become reachable from every `PrefetchFS` call site.

The core engine modules are imported lazily inside the factories: they
depend on ``repro_torch.io.retry`` (the unified resilience layer), and a
module-level import here would close an import cycle through the
``repro_torch.io`` package init.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

from repro_torch.io.policy import IOPolicy
from repro_torch.io.registry import register_reader
from repro_torch.store.base import ObjectMeta, ObjectStore
from repro_torch.store.tiers import CacheIndex, CacheTier

if TYPE_CHECKING:
    from repro_torch.core.autotune import BlockSizeTuner


@register_reader("rolling", needs_tiers=True, accepts_tuner=True,
                 accepts_index=True)
def open_rolling(store: ObjectStore, files: list[ObjectMeta],
                 tiers: list[CacheTier], policy: IOPolicy,
                 tuner: "BlockSizeTuner | None" = None,
                 index: CacheIndex | None = None):
    from repro_torch.core.rolling import RollingPrefetcher, RollingPrefetchFile

    return RollingPrefetchFile(
        RollingPrefetcher(
            store, files, tiers, policy.blocksize,
            depth=policy.depth,
            max_depth=policy.max_depth,
            coalesce=policy.coalesce if policy.coalesce is not None else 1,
            readahead_blocks=policy.readahead_blocks,
            eviction_interval_s=policy.eviction_interval_s,
            retry=policy.retry_policy(),
            hedge_timeout_s=policy.hedge_timeout_s,
            max_hedges=policy.max_hedges,
            throttle_aimd=policy.throttle_aimd,
            tuner=tuner,
            index=index,
            io_class=policy.io_class,
            verify=policy.verify,
        )
    )


@register_reader("sequential", accepts_tuner=True, accepts_index=True)
def open_sequential(store: ObjectStore, files: list[ObjectMeta],
                    tiers: list[CacheTier], policy: IOPolicy,
                    tuner: "BlockSizeTuner | None" = None,
                    index: CacheIndex | None = None):
    from repro_torch.core.sequential import SequentialFile

    return SequentialFile(store, files, policy.blocksize,
                          cache_blocks=policy.cache_blocks, tuner=tuner,
                          index=index, retry=policy.retry_policy(),
                          io_class=policy.io_class, verify=policy.verify)


@register_reader("direct")
def open_direct(store: ObjectStore, files: list[ObjectMeta],
                tiers: list[CacheTier], policy: IOPolicy):
    from repro_torch.io.reader import DirectReader

    return DirectReader(store, files)
