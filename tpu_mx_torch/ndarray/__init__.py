"""``mx.nd``: the :class:`NDArray` handle (:mod:`.ndarray`), the
operators (:mod:`.ops`, exported here as the reference's ``nd.*``
namespace, ``nd.random`` included), the fused RNN operator
(:mod:`.rnn_op`, exported as ``RNN`` and ``rnn_param_size``) and the
detection operators (:mod:`.contrib`).

Every operator takes tensors or arrays: given tensors it returns
tensors (the port's models call them so), given arrays it returns
arrays and records under ``autograd.record()``.
"""
from . import contrib, ops, rnn_op
from .ndarray import (NDArray, array, concatenate, from_numpy, load, save,
                      waitall)
from .ops import *  # noqa: F401,F403
from .rnn_op import RNN, rnn_param_size

__all__ = ["contrib", "ops", "rnn_op", "RNN", "rnn_param_size", "NDArray",
           "array", "concatenate", "from_numpy", "load", "save",
           "waitall"] + list(ops.__all__)
