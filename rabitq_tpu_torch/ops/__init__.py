from rabitq_tpu_torch.ops.distances import l2sq, pairwise_l2sq
from rabitq_tpu_torch.ops.int4 import (
    cuda_int4_dot,
    int4_dot_reference,
    pack_int4,
    unpack_int4,
)
from rabitq_tpu_torch.ops.quantize import (
    cuda_quantize_residuals,
    pack_query_nibbles,
    quantize_query_residuals,
    quantize_residuals_reference,
    unpack_query_nibbles,
)
from rabitq_tpu_torch.ops.rerank_kernel import (
    cuda_gather_l2,
    gather_l2_reference,
)
from rabitq_tpu_torch.ops.rotation import gen_random_orthogonal, rotate
from rabitq_tpu_torch.ops.scan_kernel import (
    cuda_rough_scan,
    rough_scan_reference,
)

__all__ = [
    "gen_random_orthogonal",
    "rotate",
    "quantize_query_residuals",
    "quantize_residuals_reference",
    "cuda_quantize_residuals",
    "pack_query_nibbles",
    "unpack_query_nibbles",
    "pairwise_l2sq",
    "l2sq",
    "cuda_rough_scan",
    "rough_scan_reference",
    "cuda_gather_l2",
    "gather_l2_reference",
    "pack_int4",
    "unpack_int4",
    "int4_dot_reference",
    "cuda_int4_dot",
]
