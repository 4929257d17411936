"""``gluon.contrib.rnn``, from ``tpu_mx/gluon/contrib/rnn.py``:
``VariationalDropoutCell``, ``LSTMPCell`` and the convolutional cells
``Conv{1,2,3}D{RNN,LSTM,GRU}Cell``, on the port's cell protocol
(``state_info``, ``begin_state``, ``unroll``, ``cell(inputs, states) ->
(output, new_states)``).

Parameters have the reference's names, shapes and order; an input size
left at 0 (``input_size``, or no ``input_shape`` for a convolutional
cell) is inferred at the first step.  The products go through
``ops.FullyConnected`` and ``ops.Convolution`` (cuBLAS and cuDNN on the
card), as the reference's go through ``F``, so ``contrib.amp`` casts
them as it casts the reference's.

``VariationalDropoutCell`` draws one mask per input, state and output
from its explicit generator at the first training step after a
``reset()`` (``unroll`` resets first) and applies the same mask at every
step until the next ``reset()``; outside training it is the identity.
"""
from __future__ import annotations

import torch

from ...base import MXNetError
from ...ndarray import ops
from ..block import as_dtype, default_generator
from ..rnn.rnn_cell import ModifierCell, RecurrentCell

__all__ = ["VariationalDropoutCell", "LSTMPCell", "Conv1DRNNCell",
           "Conv2DRNNCell", "Conv3DRNNCell", "Conv1DLSTMCell",
           "Conv2DLSTMCell", "Conv3DLSTMCell", "Conv1DGRUCell",
           "Conv2DGRUCell", "Conv3DGRUCell"]


class VariationalDropoutCell(ModifierCell):
    """Locked dropout around ``base_cell`` (Gal and Ghahramani): one
    inverted-dropout mask per sequence for the inputs (``drop_inputs``),
    the states (``drop_states``) and the outputs (``drop_outputs``)."""

    def __init__(self, base_cell, drop_inputs=0.0, drop_states=0.0,
                 drop_outputs=0.0, generator=None):
        super().__init__(base_cell)
        self._di, self._ds, self._do = drop_inputs, drop_states, drop_outputs
        self._generator = default_generator(generator)
        self.reset()

    def reset(self):
        super().reset()
        self._mask_in = self._mask_out = self._mask_states = None

    def _draw(self, rate, like):
        keep = 1.0 - rate
        mask = torch.rand(like.shape, generator=self._generator,
                          device=like.device) < keep
        return mask.to(like.dtype) / keep

    def forward(self, inputs, states):
        if self.training and self._di > 0:
            if self._mask_in is None:
                self._mask_in = self._draw(self._di, inputs)
            inputs = inputs * self._mask_in
        if self.training and self._ds > 0:
            if self._mask_states is None:
                self._mask_states = [self._draw(self._ds, s) for s in states]
            states = [s * m for s, m in zip(states, self._mask_states)]
        out, new_states = self.base_cell(inputs, states)
        if self.training and self._do > 0:
            if self._mask_out is None:
                self._mask_out = self._draw(self._do, out)
            out = out * self._mask_out
        return out, new_states


class LSTMPCell(RecurrentCell):
    """LSTM with a projected recurrent state (Sak et al. 2014):
    ``r = (o ∘ tanh(c))·W_rᵀ``, so the recurrent product is ``4h x p``
    instead of ``4h x h``.  States ``[r (N, p), c (N, h)]``."""

    def __init__(self, hidden_size, projection_size, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 h2r_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", dtype="float32",
                 generator=None):
        super().__init__()
        g, dt = default_generator(generator), as_dtype(dtype)
        self._hidden_size = hidden_size
        self._projection_size = projection_size
        n = 4 * hidden_size
        self._declare("i2h_weight", (n, input_size), i2h_weight_initializer,
                      dt, g)
        self._declare("h2h_weight", (n, projection_size),
                      h2h_weight_initializer, dt, g)
        self._declare("h2r_weight", (projection_size, hidden_size),
                      h2r_weight_initializer, dt, g)
        self._declare("i2h_bias", (n,), i2h_bias_initializer, dt, g)
        self._declare("h2h_bias", (n,), h2h_bias_initializer, dt, g)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._projection_size),
                 "__layout__": "NC"},
                {"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}]

    def infer_shape(self, x, *args):
        self._reg_params["i2h_weight"].shape_hint(
            (4 * self._hidden_size, x.shape[-1]))

    def forward(self, inputs, states):
        p = self._parameters
        n = 4 * self._hidden_size
        gates = ops.FullyConnected(inputs, p["i2h_weight"], p["i2h_bias"],
                                   num_hidden=n) + \
            ops.FullyConnected(states[0], p["h2h_weight"], p["h2h_bias"],
                               num_hidden=n)
        i, f, g, o = gates.chunk(4, -1)
        c = torch.sigmoid(f) * states[1] + torch.sigmoid(i) * torch.tanh(g)
        r = ops.FullyConnected(torch.sigmoid(o) * torch.tanh(c),
                               p["h2r_weight"], None, no_bias=True,
                               num_hidden=self._projection_size)
        return r, [r, c]


class _ConvRNNBase(RecurrentCell):
    """What the convolutional cells share: ``gates = conv(x; Wi, bi) +
    conv(h; Wh, bh)`` with "same" padding, states ``(N, hidden, *S)``."""

    _n_states = 1

    def __init__(self, hidden_channels, kernel, n_gates, ndim,
                 input_shape=None, activation="tanh", dtype="float32",
                 generator=None):
        super().__init__()
        self._hc = hidden_channels
        self._ndim = ndim
        self._kernel = (kernel,) * ndim if isinstance(kernel, int) \
            else tuple(kernel)
        if len(self._kernel) != ndim:
            raise MXNetError(f"kernel must be int or length-{ndim}")
        if any(k % 2 == 0 for k in self._kernel):
            raise MXNetError("conv-RNN kernels must be odd (same-pad)")
        self._pad = tuple(k // 2 for k in self._kernel)
        self._ng = n_gates
        self._activation = activation
        # input_shape=(C, *spatial): with it begin_state()/unroll() work
        # before any step; without it the sizes come from the first step
        in_c, self._spatial = 0, None
        if input_shape is not None:
            input_shape = tuple(int(s) for s in input_shape)
            if len(input_shape) != ndim + 1:
                raise MXNetError(
                    f"input_shape must be (C, {'x'.join('S' * ndim)})")
            in_c, self._spatial = input_shape[0], input_shape[1:]
        g, dt = default_generator(generator), as_dtype(dtype)
        n = n_gates * hidden_channels
        self._declare("i2h_weight", (n, in_c) + self._kernel, None, dt, g)
        self._declare("h2h_weight", (n, hidden_channels) + self._kernel,
                      None, dt, g)
        self._declare("i2h_bias", (n,), "zeros", dt, g)
        self._declare("h2h_bias", (n,), "zeros", dt, g)

    def infer_shape(self, x, *args):
        self._reg_params["i2h_weight"].shape_hint(
            (self._ng * self._hc, x.shape[1]) + self._kernel)
        self._spatial = tuple(x.shape[2:])

    def state_info(self, batch_size=0):
        if self._spatial is None:
            raise MXNetError(
                f"{type(self).__name__}: spatial state shape unknown — "
                "construct with input_shape=(C, *spatial) or run one "
                "forward before begin_state()/unroll()")
        return [{"shape": (batch_size, self._hc) + self._spatial,
                 "__layout__": "NC" + "DHW"[-self._ndim:]}
                for _ in range(self._n_states)]

    def _convs(self, inputs, h):
        p, n = self._parameters, self._ng * self._hc
        gi = ops.Convolution(inputs, p["i2h_weight"], p["i2h_bias"],
                             kernel=self._kernel, pad=self._pad,
                             num_filter=n)
        gh = ops.Convolution(h, p["h2h_weight"], p["h2h_bias"],
                             kernel=self._kernel, pad=self._pad,
                             num_filter=n)
        return gi, gh

    def _act(self, x):
        return ops.Activation(x, act_type=self._activation)


class _ConvRNNCell(_ConvRNNBase):
    def __init__(self, hidden_channels, kernel, ndim, **kwargs):
        super().__init__(hidden_channels, kernel, 1, ndim, **kwargs)

    def forward(self, inputs, states):
        self._spatial = tuple(inputs.shape[2:])
        gi, gh = self._convs(inputs, states[0])
        h = self._act(gi + gh)
        return h, [h]


class _ConvLSTMCell(_ConvRNNBase):
    _n_states = 2

    def __init__(self, hidden_channels, kernel, ndim, **kwargs):
        super().__init__(hidden_channels, kernel, 4, ndim, **kwargs)

    def forward(self, inputs, states):
        self._spatial = tuple(inputs.shape[2:])
        gi, gh = self._convs(inputs, states[0])
        i, f, g, o = (gi + gh).chunk(4, 1)
        c = torch.sigmoid(f) * states[1] + torch.sigmoid(i) * self._act(g)
        h = torch.sigmoid(o) * self._act(c)
        return h, [h, c]


class _ConvGRUCell(_ConvRNNBase):
    def __init__(self, hidden_channels, kernel, ndim, **kwargs):
        super().__init__(hidden_channels, kernel, 3, ndim, **kwargs)

    def forward(self, inputs, states):
        self._spatial = tuple(inputs.shape[2:])
        h = states[0]
        gi, gh = self._convs(inputs, h)
        ir, iz, inew = gi.chunk(3, 1)
        hr, hz, hnew = gh.chunk(3, 1)
        r = torch.sigmoid(ir + hr)
        z = torch.sigmoid(iz + hz)
        n = self._act(inew + r * hnew)
        out = (1 - z) * n + z * h
        return out, [out]


def _make(base, ndim, name):
    def __init__(self, hidden_channels, kernel=3, **kwargs):
        base.__init__(self, hidden_channels, kernel, ndim, **kwargs)
    return type(name, (base,), {
        "__init__": __init__, "__module__": __name__,
        "__doc__": f"{name}: the {ndim}-D convolutional cell of "
                   "``tpu_mx/gluon/contrib/rnn.py``."})


Conv1DRNNCell = _make(_ConvRNNCell, 1, "Conv1DRNNCell")
Conv2DRNNCell = _make(_ConvRNNCell, 2, "Conv2DRNNCell")
Conv3DRNNCell = _make(_ConvRNNCell, 3, "Conv3DRNNCell")
Conv1DLSTMCell = _make(_ConvLSTMCell, 1, "Conv1DLSTMCell")
Conv2DLSTMCell = _make(_ConvLSTMCell, 2, "Conv2DLSTMCell")
Conv3DLSTMCell = _make(_ConvLSTMCell, 3, "Conv3DLSTMCell")
Conv1DGRUCell = _make(_ConvGRUCell, 1, "Conv1DGRUCell")
Conv2DGRUCell = _make(_ConvGRUCell, 2, "Conv2DGRUCell")
Conv3DGRUCell = _make(_ConvGRUCell, 3, "Conv3DGRUCell")
