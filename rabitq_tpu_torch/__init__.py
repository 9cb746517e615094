"""rabitq_tpu_torch — the PyTorch/CUDA port of rabitq_tpu.

Same module paths and public names as the JAX package (``build_index``,
``search``, ``SearchParams``, ``RaBitQIndex``, ``kmeans``), on torch tensors
with an explicit device. On a CUDA device the rough scan runs the
hand-written sm_90a kernel in ``csrc/``; on the CPU its plain twin.
"""

import torch

# Full fp32 matmuls everywhere: a TF32 rotation flips code signs and a TF32
# ranking misorders near-tied clusters (the GPU form of the JAX package's
# Precision.HIGHEST).
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from rabitq_tpu_torch import consts  # noqa: E402
from rabitq_tpu_torch.index import (  # noqa: E402
    RaBitQIndex,
    SearchParams,
    build_index,
    estimate_candidates,
    index_from_arrays,
    search,
    search_many,
    search_with_stats,
)
from rabitq_tpu_torch.kmeans import kmeans  # noqa: E402
from rabitq_tpu_torch.metrics import METRICS  # noqa: E402
from rabitq_tpu_torch.utils import calculate_recall  # noqa: E402

__version__ = "0.1.0"

__all__ = [
    "consts",
    "RaBitQIndex",
    "SearchParams",
    "build_index",
    "index_from_arrays",
    "search",
    "search_many",
    "search_with_stats",
    "estimate_candidates",
    "kmeans",
    "METRICS",
    "calculate_recall",
]
