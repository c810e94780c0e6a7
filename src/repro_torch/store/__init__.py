from repro_torch.store.base import (
    MultipartUpload,
    ObjectMeta,
    ObjectStore,
    StoreError,
    ThrottleError,
    TransientStoreError,
)
from repro_torch.store.faults import (
    ALL_OPS,
    META_OPS,
    READ_OPS,
    WRITE_OPS,
    FaultRule,
    FaultSchedule,
    FaultyStore,
)
from repro_torch.store.hsm import (
    AdmissionPolicy,
    HSMIndex,
    HSMStore,
    TierCostModel,
    parse_size,
)
from repro_torch.store.link import LinkModel, PeerLinkModel
from repro_torch.store.sim_s3 import SimS3Store
from repro_torch.store.local import DirStore, MemStore
from repro_torch.store.tiers import (
    BlockMeta,
    CacheFlight,
    CacheIndex,
    CacheTier,
    DirTier,
    MemTier,
)

__all__ = [
    "ALL_OPS",
    "META_OPS",
    "READ_OPS",
    "WRITE_OPS",
    "BlockMeta",
    "CacheFlight",
    "CacheIndex",
    "FaultRule",
    "FaultSchedule",
    "FaultyStore",
    "MultipartUpload",
    "ObjectStore",
    "ObjectMeta",
    "StoreError",
    "ThrottleError",
    "TransientStoreError",
    "LinkModel",
    "PeerLinkModel",
    "SimS3Store",
    "DirStore",
    "MemStore",
    "CacheTier",
    "MemTier",
    "DirTier",
    "AdmissionPolicy",
    "HSMIndex",
    "HSMStore",
    "TierCostModel",
    "parse_size",
]
