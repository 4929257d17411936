"""The Gluon layer of the port: :mod:`.nn` layers, the :mod:`.rnn` layers
and cells, :mod:`.loss`, the blocks' shared base (:mod:`.block`) and
the :mod:`.model_zoo`.

The port's blocks are :class:`torch.nn.Module`s.  The reference's
``Parameter``/``hybridize`` surface and ``gluon.Trainer`` are not ported
yet (ROADMAP A4).
"""
from . import block, loss, model_zoo, nn, rnn

__all__ = ["block", "loss", "model_zoo", "nn", "rnn"]
