"""``mx.nd``: the :class:`NDArray` handle (:mod:`.ndarray`), the
operators (:mod:`.ops`, exported here as the reference's ``nd.*``
namespace, ``nd.random`` included), the optimizer update operators
(:mod:`.optimizer_ops`, ``nd.*_update``), the fused RNN operator
(:mod:`.rnn_op`, exported as ``RNN`` and ``rnn_param_size``), the
``linalg_*``, vision and ``sample_*`` families (:mod:`.linalg_ops`,
:mod:`.vision_ops`, :mod:`.sample_ops`, in ``ops``) and ``nd.contrib``
(:mod:`.contrib`).

Every operator takes tensors or arrays: given tensors it returns
tensors (the port's models call them so), given arrays it returns
arrays and records under ``autograd.record()``.
"""
from . import contrib, ops, optimizer_ops, rnn_op, sparse
from .ndarray import (NDArray, array, concatenate, from_numpy, load, save,
                      waitall)
from .ops import *  # noqa: F401,F403
from .optimizer_ops import *  # noqa: F401,F403
from .rnn_op import RNN, rnn_param_size

__all__ = ["contrib", "ops", "optimizer_ops", "rnn_op", "sparse", "RNN",
           "rnn_param_size", "NDArray", "array", "concatenate", "from_numpy",
           "load", "save", "waitall"] + list(ops.__all__) \
    + list(optimizer_ops.__all__)
