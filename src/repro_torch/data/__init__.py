from repro_torch.data.loader import (
    DataCursor,
    DeviceFeeder,
    LoaderConfig,
    PrefetchingDataLoader,
)
from repro_torch.data.tokens import (
    TokenStreamReader,
    synth_token_shard,
    write_token_shard,
)

__all__ = [
    "DataCursor",
    "DeviceFeeder",
    "LoaderConfig",
    "PrefetchingDataLoader",
    "TokenStreamReader",
    "synth_token_shard",
    "write_token_shard",
]
