"""tpu_mx_torch: the PyTorch/CUDA port of tpu_mx, for one NVIDIA H100.

The JAX package ``tpu_mx`` beside it is the reference; this package
imports nothing of it and nothing of jax.  The port goes slice by slice;
this one is the serving path (:mod:`tpu_mx_torch.serving`) with its two
hand-written Hopper kernels (:mod:`tpu_mx_torch.kernels`).  Entry points
take ``device=`` and default to ``"cuda"`` (:mod:`tpu_mx_torch.device`).
"""
from .base import MXNetError, NumericDivergence

__all__ = ["MXNetError", "NumericDivergence"]
