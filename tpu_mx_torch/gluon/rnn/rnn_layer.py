"""The fused multi-layer ``RNN``, ``LSTM`` and ``GRU`` layers of
``tpu_mx/gluon/rnn/rnn_layer.py``, over the recurrence of
:mod:`tpu_mx_torch.ndarray.rnn_op` (its ``scan`` arm on the CPU, ATen's
fused recurrence on the card; ``rnn_op.rnn_arm`` chooses).

Parameters have the reference's names, shapes and order:
``l{L}_i2h_weight``, ``l{L}_h2h_weight``, ``l{L}_i2h_bias``,
``l{L}_h2h_bias`` per layer, with ``r{L}_...`` for the reverse
direction after each forward one.  ``input_size`` must be given: the
port has no deferred initialization.

The states follow the promoted dtype of the input, the layer's
parameters and any states given (a bfloat16 layer on bfloat16 input
recurs in bfloat16, any mixed call in the promoted type), and the
products run in it.  Dropout runs between layers only, in training
(``module.train()``) with a rate above 0, drawn from the layer's
generator.
"""
from __future__ import annotations

import torch

from ...base import MXNetError
from ...ndarray import rnn_op
from ..block import HybridBlock, as_dtype, default_generator

__all__ = ["RNN", "LSTM", "GRU"]


class _RNNLayer(HybridBlock):
    def __init__(self, mode, hidden_size, num_layers, layout, dropout,
                 bidirectional, input_size, i2h_weight_initializer=None,
                 h2h_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", dtype="float32",
                 generator=None):
        super().__init__()
        if mode not in rnn_op.GATES:
            raise ValueError(f"RNN mode {mode!r}: one of "
                             f"{sorted(rnn_op.GATES)}")
        if layout not in ("TNC", "NTC"):
            raise ValueError(f"RNN layout {layout!r}: 'TNC' or 'NTC'")
        if not input_size:
            raise MXNetError(f"{type(self).__name__}: input_size must be "
                             "given (the port has no deferred "
                             "initialization)")
        g, dt = default_generator(generator), as_dtype(dtype)
        self._mode = mode
        self._hidden_size = hidden_size
        self._num_layers = num_layers
        self._layout = layout
        self._dropout = dropout
        self._dir = 2 if bidirectional else 1
        self._generator = g
        ng = rnn_op.GATES[mode] * hidden_size
        for layer in range(num_layers):
            in_sz = input_size if layer == 0 else hidden_size * self._dir
            for d in range(self._dir):
                pre = f"{'lr'[d]}{layer}_"
                for leaf, shape, init in (
                        ("i2h_weight", (ng, in_sz), i2h_weight_initializer),
                        ("h2h_weight", (ng, hidden_size),
                         h2h_weight_initializer),
                        ("i2h_bias", (ng,), i2h_bias_initializer),
                        ("h2h_bias", (ng,), h2h_bias_initializer)):
                    self._declare(pre + leaf, shape, init, dt, g)

    @property
    def dtype(self):
        """The parameters' dtype (it follows ``cast``)."""
        return self.l0_i2h_weight.dtype

    def state_info(self, batch_size=0):
        infos = [{"shape": (self._num_layers * self._dir, batch_size,
                            self._hidden_size), "__layout__": "LNC"}]
        if self._mode == "lstm":
            infos.append(dict(infos[0]))
        return infos

    def begin_state(self, batch_size=0, func=None, **kwargs):
        """Zero states in the parameters' dtype, on their device."""
        dev = self.l0_i2h_weight.device
        return [torch.zeros(info["shape"], dtype=self.dtype, device=dev)
                for info in self.state_info(batch_size)]

    def forward(self, inputs, states=None):
        """``inputs`` ``(T, N, C)`` (``(N, T, C)`` for NTC).  Returns the
        output alone without ``states``, else ``(output, [h, c])``."""
        skip_states = states is None
        if self._layout == "NTC":
            inputs = inputs.transpose(0, 1)
        if isinstance(states, torch.Tensor):
            states = [states]
        dt = torch.promote_types(inputs.dtype, self.dtype)
        if skip_states:
            states = [torch.zeros(info["shape"], dtype=dt,
                                  device=inputs.device)
                      for info in self.state_info(inputs.shape[1])]
        else:
            for s in states:
                dt = torch.promote_types(dt, s.dtype)
        # declared in (layer, direction) order, w_ih, w_hh, b_ih, b_hh
        weights = [p.to(dt) for p in self._parameters.values()]
        out, h, c = rnn_op.recurrence(
            self._mode, inputs.to(dt), [s.to(dt) for s in states], weights,
            self._num_layers, self._dir == 2, self._dropout, self.training,
            self._generator)
        if self._layout == "NTC":
            out = out.transpose(0, 1)
        if skip_states:
            return out
        return out, [h, c] if self._mode == "lstm" else [h]

    def extra_repr(self):
        return (f"{self._hidden_size}, num_layers={self._num_layers}, "
                f"layout={self._layout!r}, bidirectional={self._dir == 2}")


class RNN(_RNNLayer):
    """Elman RNN with ``activation`` ``"relu"`` or ``"tanh"``."""

    def __init__(self, hidden_size, num_layers=1, activation="relu",
                 layout="TNC", dropout=0, bidirectional=False, input_size=0,
                 **kwargs):
        super().__init__(f"rnn_{activation}", hidden_size, num_layers, layout,
                         dropout, bidirectional, input_size, **kwargs)


class LSTM(_RNNLayer):
    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0, **kwargs):
        super().__init__("lstm", hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, **kwargs)


class GRU(_RNNLayer):
    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0, **kwargs):
        super().__init__("gru", hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, **kwargs)
