"""The port's operators (:mod:`.ops`): plain functions on tensors.

The reference's ``NDArray`` handle, its imperative ``autograd.record``
and the ``ops._apply`` dispatch are not ported yet (ROADMAP A3): the
port's models call these functions on :class:`torch.Tensor` directly and
take gradients with ``torch.autograd``.
"""
from . import ops

__all__ = ["ops"]
