"""``gluon.contrib``: the Estimator training-loop facade
(:mod:`.estimator`).  The reference's contrib ``nn`` layers and ``rnn``
cells are not ported yet (ROADMAP A item 10)."""
from . import estimator

__all__ = ["estimator"]
