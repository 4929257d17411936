"""The Gluon layer of the port: :class:`Block`/:class:`HybridBlock`
(:mod:`.block`), :class:`Parameter`/:class:`ParameterDict`
(:mod:`.parameter`), :class:`Trainer` (:mod:`.trainer`), :mod:`.utils`,
the :mod:`.nn` layers, the :mod:`.rnn` layers and cells, :mod:`.loss` and
the :mod:`.model_zoo`.

The port's blocks are :class:`torch.nn.Module`s; called with
:class:`~tpu_mx_torch.ndarray.NDArray` arguments they are the reference's
imperative blocks (``autograd.record()``, ``loss.backward()``,
``trainer.step()``), called with tensors plain modules.
"""
from . import block, loss, model_zoo, nn, parameter, rnn, trainer, utils
from .block import Block, HybridBlock
from .parameter import (Constant, DeferredInitializationError, Parameter,
                        ParameterDict)
from .trainer import Trainer

__all__ = ["block", "loss", "model_zoo", "nn", "parameter", "rnn", "trainer",
           "utils", "Block", "HybridBlock", "Constant",
           "DeferredInitializationError", "Parameter", "ParameterDict",
           "Trainer"]
