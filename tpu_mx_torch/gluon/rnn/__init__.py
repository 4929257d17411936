"""``gluon.rnn``: the fused ``RNN``/``LSTM``/``GRU`` layers
(:mod:`.rnn_layer`) and the one-step cells (:mod:`.rnn_cell`), as in
``tpu_mx/gluon/rnn/__init__.py``."""
from .rnn_cell import (BidirectionalCell, DropoutCell, GRUCell,
                       HybridSequentialRNNCell, LSTMCell, ModifierCell,
                       RecurrentCell, ResidualCell, RNNCell,
                       SequentialRNNCell, ZoneoutCell)
from .rnn_layer import GRU, LSTM, RNN

__all__ = ["BidirectionalCell", "DropoutCell", "GRUCell",
           "HybridSequentialRNNCell", "LSTMCell", "ModifierCell",
           "RecurrentCell", "ResidualCell", "RNNCell", "SequentialRNNCell",
           "ZoneoutCell", "GRU", "LSTM", "RNN"]
