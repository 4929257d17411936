"""The PTB word-level language model of ``tpu_mx/models/lstm_lm.py``:
embedding → multi-layer RNN (``gluon.rnn``) → decoder, trained with
truncated BPTT.

Parameters have the reference's names, shapes and ``collect_params()``
order (encoder, RNN layers, decoder), so :meth:`RNNModel.from_numpy`
carries the reference's weights over one to one.  With ``tie_weights``
the decoder's weight is the encoder's one ``Parameter`` and is counted
once.  (The reference's model asks for that by handing its ``Dense`` the
encoder's parameter dict, but the reference's ``ParameterDict`` looks
the shared weight up under the ``Dense``'s own prefix, finds none and
draws a second weight: its ``tie_weights`` does not tie.)
"""
from __future__ import annotations

from .. import device as _device
from .. import random as _random
from ..base import MXNetError
from ..gluon import rnn
from ..gluon.block import HybridBlock, load_numpy
from ..gluon.nn import Dense, Dropout, Embedding

__all__ = ["RNNModel"]

MODES = ("lstm", "gru", "rnn_relu", "rnn_tanh")


class RNNModel(HybridBlock):
    """``RNNModel(mode, vocab_size, num_embed, num_hidden, num_layers,
    dropout, tie_weights, dtype=, device=None, generator=g)``: every
    parameter in ``dtype`` on ``device``, drawn from ``g`` (default:
    ``random.generator(device)``), which also draws the dropout masks.
    ``forward(inputs, state=None)``: ``(T, N)`` token ids (integers or
    floats) to ``(T, N, vocab_size)`` logits in the parameters' dtype,
    and with ``state`` the new state too."""

    def __init__(self, mode="lstm", vocab_size=10000, num_embed=200,
                 num_hidden=200, num_layers=2, dropout=0.5, tie_weights=False,
                 dtype="float32", device=None, generator=None):
        super().__init__()
        if mode not in MODES:
            raise ValueError(f"RNNModel mode {mode!r}: one of {MODES}")
        dev = _device.resolve(device)
        g = _random.generator(dev) if generator is None else generator
        if g.device.type != dev.type:
            raise MXNetError(f"RNNModel(device={str(device)!r}): the "
                             f"generator lives on {g.device}")
        kw = dict(dtype=dtype, generator=g)
        self.drop = Dropout(dropout, g)
        self.encoder = Embedding(vocab_size, num_embed, **kw)
        layer_kw = dict(dropout=dropout, input_size=num_embed, **kw)
        if mode == "lstm":
            self.rnn = rnn.LSTM(num_hidden, num_layers, **layer_kw)
        elif mode == "gru":
            self.rnn = rnn.GRU(num_hidden, num_layers, **layer_kw)
        else:
            self.rnn = rnn.RNN(num_hidden, num_layers,
                               activation=mode.split("_")[1], **layer_kw)
        self.decoder = Dense(vocab_size, flatten=False, in_units=num_hidden,
                             **kw)
        if tie_weights:
            if num_embed != num_hidden:
                raise MXNetError("RNNModel: tied weights need num_embed == "
                                 "num_hidden")
            self.decoder.weight = self.encoder._parameters["weight"]

    def begin_state(self, batch_size=0):
        return self.rnn.begin_state(batch_size)

    def forward(self, inputs, state=None):
        emb = self.drop(self.encoder(inputs))
        if state is None:
            return self.decoder(self.drop(self.rnn(emb)))
        output, state = self.rnn(emb, state)
        return self.decoder(self.drop(output)), state

    @classmethod
    def from_numpy(cls, params, mode="lstm", vocab_size=10000, num_embed=200,
                   num_hidden=200, num_layers=2, dropout=0.5,
                   tie_weights=False, dtype="float32", device=None,
                   generator=None):
        """The port's model computing the reference's function: ``params``
        maps the reference's ``collect_params()`` names to numpy arrays in
        that order (``gluon.block.load_numpy``: every array consumed once,
        names checked by suffix).  A tied model takes one weight for the
        encoder and the decoder."""
        return load_numpy(cls(mode, vocab_size, num_embed, num_hidden,
                              num_layers, dropout, tie_weights, dtype=dtype,
                              device=device, generator=generator), params)
