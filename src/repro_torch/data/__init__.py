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
from repro_torch.data.trk import (
    LazyTrkReader,
    Streamline,
    TrkHeader,
    iter_streamlines_multi,
    synth_trk,
    write_trk,
)

__all__ = [
    "DataCursor",
    "DeviceFeeder",
    "LoaderConfig",
    "PrefetchingDataLoader",
    "TokenStreamReader",
    "synth_token_shard",
    "write_token_shard",
    "LazyTrkReader",
    "Streamline",
    "TrkHeader",
    "iter_streamlines_multi",
    "synth_trk",
    "write_trk",
]
