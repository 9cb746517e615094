from rabitq_tpu_torch.ops.distances import l2sq, pairwise_l2sq
from rabitq_tpu_torch.ops.quantize import quantize_query_residuals
from rabitq_tpu_torch.ops.rotation import gen_random_orthogonal, rotate
from rabitq_tpu_torch.ops.scan_kernel import (
    cuda_rough_scan,
    rough_scan_reference,
)

__all__ = [
    "gen_random_orthogonal",
    "rotate",
    "quantize_query_residuals",
    "pairwise_l2sq",
    "l2sq",
    "cuda_rough_scan",
    "rough_scan_reference",
]
