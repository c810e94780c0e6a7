"""Rolling Prefetch — the paper's primary contribution, as a composable
library: block planning, the three-thread prefetch/read/evict engine over
bounded cache tiers, the S3Fs-like sequential baseline it is benchmarked
against, the Eq. 1-4 analytical cost model, and the online autotuner that
closes the paper's optimal-block-size loop.

Applications should not construct these engines directly: open readers
through the `repro_torch.io.PrefetchFS` facade (`IOPolicy(engine="rolling")`
et al.), which owns tier lifecycle and engine dispatch. The classes here
are the engine layer that facade drives."""

from repro_torch.core.plan import Block, BlockPlan
from repro_torch.core.rolling import (
    BlockState,
    PrefetchStats,
    RollingPrefetcher,
    RollingPrefetchFile,
)
from repro_torch.core.sequential import SequentialFile, SequentialStats
from repro_torch.core import cost_model
from repro_torch.core.autotune import AimdDepthController, BlockSizeTuner

__all__ = [
    "AimdDepthController",
    "Block",
    "BlockPlan",
    "BlockState",
    "PrefetchStats",
    "RollingPrefetcher",
    "RollingPrefetchFile",
    "SequentialFile",
    "SequentialStats",
    "cost_model",
    "BlockSizeTuner",
]
