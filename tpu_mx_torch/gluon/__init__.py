"""The Gluon layer the BERT slice needs: :mod:`.nn` layers and :mod:`.loss`.

The port's blocks are :class:`torch.nn.Module`s.  The reference's
``Block``/``HybridBlock``/``Parameter``/``hybridize`` surface and
``gluon.Trainer`` are not ported yet (ROADMAP A4).
"""
from . import loss, nn

__all__ = ["loss", "nn"]
