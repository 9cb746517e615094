"""Algorithm hyperparameters for RaBitQ (same values as rabitq_tpu.consts).

These are the constants of the RaBitQ paper's 1-bit quantization scheme with
a 4-bit asymmetrically quantized query.
"""

# Fallback for <x-c, sign(x-c)>/(|x-c| * sqrt(D)) when the denominator is
# zero/subnormal.
DEFAULT_X_DOT_PRODUCT: float = 0.8

# Error-bound multiplier (epsilon in the RaBitQ paper).
EPSILON: float = 1.9

# Number of bits used to quantize the query residual.
THETA_LOG_DIM: int = 4

# 1 / (2^THETA_LOG_DIM - 1): the scalar quantization step multiplier.
SCALAR: float = 1.0 / ((1 << THETA_LOG_DIM) - 1)

# Dimensions are padded to a multiple of this, and cluster capacities are
# rounded up to it, exactly as in the JAX package — so an index built by
# either package has the same padded dim, capacity and rerank budget.
LANES: int = 128

# Candidates between threshold updates of the host HeuristicReRanker.
WINDOW_SIZE: int = 12
