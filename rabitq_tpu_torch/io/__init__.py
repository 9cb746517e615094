from rabitq_tpu_torch.io.vecs import (
    mmap_fvecs_matrix,
    read_bvecs_matrix,
    read_matrix,
    read_u64_vecs,
    read_vecs,
    write_bvecs_matrix,
    write_matrix,
    write_u64_vecs,
    write_vecs,
)

__all__ = [
    "read_vecs",
    "read_matrix",
    "read_u64_vecs",
    "read_bvecs_matrix",
    "write_vecs",
    "write_matrix",
    "write_u64_vecs",
    "write_bvecs_matrix",
    "mmap_fvecs_matrix",
]
