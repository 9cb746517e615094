"""An index sharded over a mesh of devices, and data-parallel build and
training (port of rabitq_tpu.parallel)."""

from rabitq_tpu_torch.parallel.checkpoint import (
    dump_index_sharded,
    load_global_positions,
    load_index_sharded,
    load_shard_as_single,
)
from rabitq_tpu_torch.parallel.sharding import (
    Mesh,
    ShardedIndex,
    build_index_sharded,
    dp_build_chunk,
    init_distributed,
    make_mesh,
    make_sharded_row_filter,
    shard_global_positions,
    shard_index,
    sharded_lloyd_step,
    sharded_search,
    sharded_search_with_store,
)

__all__ = [
    "build_index_sharded",
    "dump_index_sharded",
    "load_global_positions",
    "load_index_sharded",
    "load_shard_as_single",
    "init_distributed",
    "make_mesh",
    "make_sharded_row_filter",
    "shard_index",
    "shard_global_positions",
    "sharded_search",
    "sharded_search_with_store",
    "dp_build_chunk",
    "sharded_lloyd_step",
    "Mesh",
    "ShardedIndex",
]
