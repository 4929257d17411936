"""tpu_mx_torch: the PyTorch/CUDA port of tpu_mx, for one NVIDIA H100.

The JAX package ``tpu_mx`` beside it is the reference; this package
imports nothing of it and nothing of jax.  ``import tpu_mx_torch as mx``
reads like the reference's scripts: ``mx.nd`` (arrays and operators),
``mx.autograd``, ``mx.gluon`` (blocks, ``Parameter``, ``Trainer``,
``utils``, ``nn``, ``loss``), ``mx.metric``, ``mx.io``, ``mx.init``,
``mx.optimizer``, ``mx.random``, ``mx.cpu()``/``mx.gpu(i)``.

The port goes slice by slice:

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
- the ResNet-50, PTB LSTM and SSD-512 training steps;
- the imperative surface: ``NDArray``, ``autograd.record()``, Gluon's
  ``Parameter`` with deferred shapes, ``Trainer``, ``io.NDArrayIter``,
  ``metric``, and LeNet for MNIST.

The hand-written Hopper kernels are in :mod:`tpu_mx_torch.kernels`.
Entry points take ``device=`` and default to ``"cuda"``
(:mod:`tpu_mx_torch.device`); a :mod:`~tpu_mx_torch.context` (``mx.gpu(0)``,
``mx.cpu()``) is taken wherever a device is, and ``with mx.cpu():``
makes the host the current context (the default is the card).
"""
from . import autograd, gluon, io, metric, ndarray, optimizer, random
from . import initializer
from . import initializer as init
from .base import MXNetError, NumericDivergence
from .context import (Context, cpu, cpu_pinned, current_context, gpu,
                      num_gpus, tpu)
from . import ndarray as nd

__all__ = ["MXNetError", "NumericDivergence", "Context", "cpu", "cpu_pinned",
           "current_context", "gpu", "num_gpus", "tpu", "autograd", "gluon",
           "init", "initializer", "io", "metric", "nd", "ndarray",
           "optimizer", "random"]
