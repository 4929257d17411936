"""The cast lists of ``contrib.amp``, the reference's
(``tpu_mx/contrib/amp/lists.py``) name for name.

The operators sent to the low-precision dtype are the matrix products
and convolutions (the tensor cores' work: cuBLAS and cuDNN on the card,
the flash kernels behind them); those kept in float32 are the
numerically sensitive reductions and exponentials.  An operator not
listed runs in whatever dtype its inputs have (PyTorch's type promotion
plays the reference's "widest type cast" role).
"""

# run in the AMP target dtype (bfloat16 by default): the products
TARGET_DTYPE_OPS = [
    "FullyConnected",
    "Convolution",
    "Deconvolution",
    "dot",
    "batch_dot",
]

# always promoted to float32: loss / normalization / exponential families
FP32_OPS = [
    "softmax",
    "log_softmax",
    "softmax_cross_entropy",
    "SoftmaxActivation",
    "SoftmaxOutput",
    "norm",
    "L2Normalization",
    "LayerNorm",
    "InstanceNorm",
    "GroupNorm",
    "masked_softmax",
    "masked_log_softmax",
    "RMSNorm",
    "BatchNorm",
    "exp",
    "log",
    "log2",
    "log10",
    "log1p",
    "expm1",
]

# ops whose float inputs are cast to the *widest* float dtype present
WIDEST_TYPE_CASTS = [
    "add_n",
    "concat",
    "stack",
    "where",
]
