"""The port's operators (:mod:`.ops`), the fused RNN operator
(:mod:`.rnn_op`, exported as ``RNN`` and ``rnn_param_size``) and the
detection operators (:mod:`.contrib`): plain functions on tensors.

The reference's ``NDArray`` handle, its imperative ``autograd.record``
and the ``ops._apply`` dispatch are not ported yet (ROADMAP A3): the
port's models call these functions on :class:`torch.Tensor` directly and
take gradients with ``torch.autograd``.
"""
from . import contrib, ops, rnn_op
from .rnn_op import RNN, rnn_param_size

__all__ = ["contrib", "ops", "rnn_op", "RNN", "rnn_param_size"]
