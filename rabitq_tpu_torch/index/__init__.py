from rabitq_tpu_torch.index.build import build_index
from rabitq_tpu_torch.index.convert import index_from_arrays
from rabitq_tpu_torch.index.filter import RowFilter, make_row_filter
from rabitq_tpu_torch.index.index import RaBitQIndex, SearchParams
from rabitq_tpu_torch.index.mutate import compact, delete, insert, update
from rabitq_tpu_torch.index.search import (
    estimate_candidates,
    search,
    search_adaptive,
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
    "search_adaptive",
    "estimate_candidates",
    "RowFilter",
    "make_row_filter",
    "insert",
    "update",
    "delete",
    "compact",
]
