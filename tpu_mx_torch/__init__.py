"""tpu_mx_torch: the PyTorch/CUDA port of tpu_mx, for one NVIDIA H100.

The JAX package ``tpu_mx`` beside it is the reference; this package
imports nothing of it and nothing of jax.  The port goes slice by slice:

- serving (:mod:`tpu_mx_torch.serving`), over the flash forward and the
  paged-decode kernels;
- one BERT-base pretraining step (:mod:`tpu_mx_torch.models`,
  :mod:`tpu_mx_torch.parallel`, :mod:`tpu_mx_torch.optimizer`,
  :mod:`tpu_mx_torch.gluon`, :mod:`tpu_mx_torch.ndarray`), over the
  flash forward with its training options and the flash backward
  kernels;
- the flash kernels' additive bias with its gradient
  (``parallel.attention(..., bias=)``), and runtime-compiled CUDA user
  kernels (:mod:`tpu_mx_torch.rtc`);
- the ResNet training step (:mod:`tpu_mx_torch.gluon.model_zoo`, the
  convolution, pooling and BatchNorm layers of :mod:`tpu_mx_torch.gluon`,
  :mod:`tpu_mx_torch.layout`, SGD), channels-last on cuDNN.

The hand-written Hopper kernels are in :mod:`tpu_mx_torch.kernels`.
Entry points take ``device=`` and default to ``"cuda"``
(:mod:`tpu_mx_torch.device`); a :mod:`~tpu_mx_torch.context` (``mx.gpu(0)``,
``mx.cpu()``) is taken wherever a device is.
"""
from .base import MXNetError, NumericDivergence
from .context import (Context, cpu, cpu_pinned, current_context, gpu,
                      num_gpus, tpu)

__all__ = ["MXNetError", "NumericDivergence", "Context", "cpu", "cpu_pinned",
           "current_context", "gpu", "num_gpus", "tpu"]
