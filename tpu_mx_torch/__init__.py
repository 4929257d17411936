"""tpu_mx_torch: the PyTorch/CUDA port of tpu_mx, for one NVIDIA H100.

The JAX package ``tpu_mx`` beside it is the reference; this package
imports nothing of it and nothing of jax.  ``import tpu_mx_torch as mx``
reads like the reference's scripts: ``mx.nd`` (arrays and operators),
``mx.autograd``, ``mx.gluon`` (blocks, ``Parameter``, ``Trainer``,
``utils``, ``nn``, ``loss``), ``mx.metric``, ``mx.io``, ``mx.init``,
``mx.optimizer``, ``mx.random``, ``mx.cpu()``/``mx.gpu(i)``.

The port goes slice by slice:

- serving (:mod:`tpu_mx_torch.serving`), over the flash forward and the
  paged-decode kernels, with its robustness and recovery planes
  (:mod:`tpu_mx_torch.supervisor`, the committed-token journal, the SLO
  monitor, the capacity ledger);
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
  ``metric``, and LeNet for MNIST;
- Gluon's training vocabulary (the layers, initializers, optimizers with
  learning-rate schedules, losses and metrics, the reference's
  ``.params`` files, the prefetching iterators) and the vision zoo
  (``gluon.model_zoo.vision.get_model``);
- the data plane: ``mx.recordio``, the native JPEG pipeline
  (:mod:`tpu_mx_torch.lib`), the file and record iterators of ``mx.io``,
  ``mx.gluon.data`` and ``mx.image``;
- supervised, deterministically resumable training: checkpoint
  manifests (:mod:`tpu_mx_torch.checkpoint`), auto-resume
  (:mod:`tpu_mx_torch.elastic`), capsules (:mod:`tpu_mx_torch.resume`),
  the :class:`~tpu_mx_torch.supervisor.Supervisor`, the chaos training
  sites, the cross-replica fingerprint vote
  (``parallel.integrity.IntegrityMonitor``) and ``mx.profiler``;
- ``engine.bulk()`` with the fusion engine (:mod:`tpu_mx_torch.fusion`),
  ``mx.kvstore`` (``mx.kv``, ``dist_*`` over ``torch.distributed``) and
  elastic fleets (:mod:`tpu_mx_torch.parallel.fleet`,
  :mod:`~tpu_mx_torch.parallel.fleet_obs`, the launcher
  ``tpu_mx_torch.tools.launch``);
- the operator families of ``linalg_ops``, ``sample_ops`` and
  ``vision_ops``, the rest of ``nd.contrib``, and ``mx.np`` /
  ``mx.npx`` (:mod:`tpu_mx_torch.numpy`, :mod:`tpu_mx_torch.npx`);
- sparse storage (``nd.sparse``, ``io.LibSVMIter``) and the graph API:
  ``mx.sym`` with its executors, ``mx.mod`` (``Module``,
  ``BucketingModule``), ``mx.model``, ``mx.callback``, ``mx.AttrScope``,
  ``mx.name``, and ``HybridBlock.export`` / ``SymbolBlock.imports``
  through ``torch.export``;
- the long tail: ``gluon.contrib.nn``/``rnn``, ``mx.contrib`` (``amp``,
  ``text``, ``onnx``, ``tensorrt``, ``quantization``, ``compression``,
  ``chaos``), ``mx.monitor``, ``mx.viz``, ``mx.runtime``,
  ``mx.libinfo``, ``mx.test_utils`` and ``mx.util``.

The hand-written Hopper kernels are in :mod:`tpu_mx_torch.kernels`.
Entry points take ``device=`` and default to ``"cuda"``
(:mod:`tpu_mx_torch.device`); a :mod:`~tpu_mx_torch.context` (``mx.gpu(0)``,
``mx.cpu()``) is taken wherever a device is, and ``with mx.cpu():``
makes the host the current context (the default is the card).

Under the launcher (``python -m tpu_mx_torch.tools.launch``) the import
joins the workers' ``torch.distributed`` group first
(:func:`~tpu_mx_torch.base.dist_boot`), as the reference's does.
"""
__version__ = "0.1.0"

from .base import dist_boot as _dist_boot
_dist_boot()

from . import autograd, gluon, io, metric, ndarray, operator, optimizer
from . import profiler
from . import random
from . import recordio
from . import image
from . import initializer
from . import initializer as init
from .base import MXNetError, NumericDivergence
from .context import (Context, cpu, cpu_pinned, current_context, gpu,
                      num_gpus, tpu)
from . import ndarray as nd
from . import kvstore
from . import kvstore as kv
from . import fusion
from . import engine
from . import numpy as np
from . import npx
from . import symbol
from . import symbol as sym
from . import attribute
from .attribute import AttrScope
from . import name
from . import executor
from . import module
from . import module as mod
from . import model
from . import callback
from .optimizer import lr_scheduler
from . import util
from . import libinfo
from . import runtime
from . import monitor
from . import visualization
from . import visualization as viz
from . import contrib
from . import test_utils

__all__ = ["MXNetError", "NumericDivergence", "Context", "cpu", "cpu_pinned",
           "current_context", "gpu", "num_gpus", "tpu", "autograd", "gluon",
           "image", "init", "initializer", "io", "metric", "nd", "ndarray",
           "operator", "optimizer", "profiler", "random", "recordio",
           "kvstore", "kv", "fusion", "engine", "np", "npx", "symbol", "sym",
           "attribute", "AttrScope", "name", "executor", "module", "mod",
           "model", "callback", "lr_scheduler", "util", "libinfo", "runtime",
           "monitor", "visualization", "viz", "contrib", "test_utils"]
