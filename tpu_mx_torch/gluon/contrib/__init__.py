"""``gluon.contrib``: the contrib layers (:mod:`.nn`), the contrib
recurrent cells (:mod:`.rnn`) and the Estimator training-loop facade
(:mod:`.estimator`)."""
from . import estimator, nn, rnn

__all__ = ["estimator", "nn", "rnn"]
