from rabitq_tpu_torch.index.build import build_index
from rabitq_tpu_torch.index.convert import index_from_arrays
from rabitq_tpu_torch.index.index import RaBitQIndex, SearchParams
from rabitq_tpu_torch.index.search import (
    estimate_candidates,
    search,
    search_many,
    search_with_stats,
)

__all__ = [
    "RaBitQIndex",
    "SearchParams",
    "build_index",
    "index_from_arrays",
    "search",
    "search_many",
    "search_with_stats",
    "estimate_candidates",
]
