"""The store tier: full-precision rows off the card for the rerank, and
the search that uses them (port of rabitq_tpu.store)."""

from rabitq_tpu_torch.store.vector_store import (
    VectorStore,
    DeviceStore,
    MmapStore,
    BlockCachedStore,
    FileBlockSource,
    HttpRangeSource,
    download_meta,
    search_with_store,
)
from rabitq_tpu_torch.store.sigv4 import (
    Credentials,
    S3RangeSource,
    SigV4Signer,
)

__all__ = [
    "VectorStore",
    "DeviceStore",
    "MmapStore",
    "BlockCachedStore",
    "FileBlockSource",
    "HttpRangeSource",
    "S3RangeSource",
    "SigV4Signer",
    "Credentials",
    "download_meta",
    "search_with_store",
]
