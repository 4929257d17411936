"""The unfused RNN cells of ``tpu_mx/gluon/rnn/rnn_cell.py``: one step at
a time, with the reference's API (``state_info``, ``begin_state``,
``unroll``, ``cell(inputs, states) -> (output, new_states)``); like a
call, ``unroll`` takes tensors or arrays and answers in kind.

The fused multi-step path is :mod:`.rnn_layer`; these cells are for
custom per-step control flow.  Parameters (``i2h_weight``,
``h2h_weight``, ``i2h_bias``, ``h2h_bias``) have the reference's names,
shapes and order; ``input_size`` must be given (no deferred
initialization).  A step runs in the promoted dtype of its input, states
and parameters.  ``DropoutCell`` and ``ZoneoutCell`` draw from their
explicit generator; dropout runs in training (``module.train()``) only,
zoneout whenever its rates are above 0, as in the reference.
"""
from __future__ import annotations

import functools

import torch

from ... import autograd
from ...base import MXNetError
from ...ndarray import ops
from ...ndarray.ops import _holds_array, _unwrap, _wrap
from ..block import HybridBlock, as_dtype, default_generator

__all__ = ["RecurrentCell", "RNNCell", "LSTMCell", "GRUCell",
           "SequentialRNNCell", "HybridSequentialRNNCell",
           "BidirectionalCell", "ModifierCell", "DropoutCell",
           "ZoneoutCell", "ResidualCell"]


def _steps(inputs, length, layout):
    """The per-step ``(N, C)`` inputs of a sequence tensor or list."""
    if isinstance(inputs, (list, tuple)):
        return list(inputs)
    if inputs.shape[layout.find("T")] != length:
        raise ValueError(f"unroll: length {length} for a sequence of "
                         f"{inputs.shape[layout.find('T')]} steps")
    return list(inputs.unbind(layout.find("T")))


def _imperative(unroll):
    """``unroll`` at the imperative boundary, as a block's call is: given
    arrays (the sequence, the states or the lengths) it runs on their
    tensors in ``autograd``'s training mode, with a graph only under
    ``record()``, and returns arrays."""
    @functools.wraps(unroll)
    def run(self, length, inputs, begin_state=None, layout="NTC",
            merge_outputs=None, valid_length=None):
        if not _holds_array([inputs, begin_state, valid_length]):
            return unroll(self, length, inputs, begin_state, layout,
                          merge_outputs, valid_length)
        with torch.set_grad_enabled(autograd.is_recording()):
            self.train(autograd.is_training())
            out, states = unroll(self, length, _unwrap(inputs),
                                 _unwrap(begin_state), layout,
                                 merge_outputs, _unwrap(valid_length))
        return _wrap(out), _wrap(states)
    return run


def _merge(outputs, merge_outputs, axis):
    if merge_outputs or merge_outputs is None:
        return torch.stack(outputs, axis)
    return outputs


class RecurrentCell(HybridBlock):
    """Base of the cells: ``state_info``, ``begin_state``, ``unroll``."""

    def __init__(self):
        super().__init__()
        self.reset()

    def reset(self):
        """Reset per-sequence state (zoneout's previous output) here and
        in every child cell; ``unroll`` does so first."""
        for cell in self.children():
            if isinstance(cell, RecurrentCell):
                cell.reset()

    def state_info(self, batch_size=0):
        raise NotImplementedError

    def begin_state(self, batch_size=0, func=None, **kwargs):
        """Zero states of :meth:`state_info`'s shapes, in ``dtype``
        (default the parameters' dtype) on the parameters' device."""
        ref = next(self.parameters(), None)
        dtype = as_dtype(kwargs["dtype"]) if "dtype" in kwargs else \
            (ref.dtype if ref is not None else torch.float32)
        device = ref.device if ref is not None else None
        return [torch.zeros(info["shape"], dtype=dtype, device=device)
                for info in self.state_info(batch_size)]

    @_imperative
    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        """Step through ``length`` steps of ``inputs`` (a tensor in
        ``layout``, or a list of ``(N, C)`` steps).  With
        ``valid_length`` (one length a sequence) the outputs past a
        sequence's length are zeroed and its states freeze at its last
        valid step.  Returns ``(outputs, states)``; outputs stacked on
        the T axis unless ``merge_outputs`` is False."""
        self.reset()
        axis = layout.find("T")
        steps = _steps(inputs, length, layout)
        states = begin_state if begin_state is not None else \
            self.begin_state(steps[0].shape[0])
        vl = None
        if valid_length is not None:
            vl = torch.as_tensor(valid_length, device=steps[0].device)
        outputs = []
        for t in range(length):
            out, new_states = self(steps[t], states)
            if vl is None:
                states = new_states
            else:
                live = vl > t

                def keep(new, old):
                    mask = live.view(-1, *([1] * (new.dim() - 1)))
                    return torch.where(mask, new, old)
                out = keep(out, torch.zeros_like(out))
                states = [keep(ns, s) for s, ns in zip(states, new_states)]
            outputs.append(out)
        return _merge(outputs, merge_outputs, axis), states


class _GatedCell(RecurrentCell):
    """A cell with the four parameters of ``gates`` gate blocks."""

    def __init__(self, gates, hidden_size, input_size,
                 i2h_weight_initializer, h2h_weight_initializer,
                 i2h_bias_initializer, h2h_bias_initializer, dtype,
                 generator):
        super().__init__()
        if not input_size:
            raise MXNetError(f"{type(self).__name__}: input_size must be "
                             "given (the port has no deferred "
                             "initialization)")
        g, dt = default_generator(generator), as_dtype(dtype)
        self._hidden_size = hidden_size
        n = gates * hidden_size
        self._declare("i2h_weight", (n, input_size), i2h_weight_initializer,
                      dt, g)
        self._declare("h2h_weight", (n, hidden_size), h2h_weight_initializer,
                      dt, g)
        self._declare("i2h_bias", (n,), i2h_bias_initializer, dt, g)
        self._declare("h2h_bias", (n,), h2h_bias_initializer, dt, g)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}]

    def _projections(self, inputs, states):
        """``(x·Wiᵀ + bi, h·Whᵀ + bh, states)`` in the promoted dtype,
        each product through ``ops.FullyConnected``, as the reference's
        cells call ``F.FullyConnected`` (so ``contrib.amp`` casts them
        alike)."""
        dt = self.i2h_weight.dtype
        for t in (inputs, *states):
            dt = torch.promote_types(dt, t.dtype)
        states = [s.to(dt) for s in states]
        n = self.i2h_weight.shape[0]
        i2h = ops.FullyConnected(inputs.to(dt), self.i2h_weight.to(dt),
                                 self.i2h_bias.to(dt), num_hidden=n)
        h2h = ops.FullyConnected(states[0], self.h2h_weight.to(dt),
                                 self.h2h_bias.to(dt), num_hidden=n)
        return i2h, h2h, states


class RNNCell(_GatedCell):
    """``h' = act(x·Wiᵀ + bi + h·Whᵀ + bh)``."""

    def __init__(self, hidden_size, activation="tanh", input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 dtype="float32", generator=None):
        super().__init__(1, hidden_size, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, dtype, generator)
        self._activation = activation

    def forward(self, inputs, states):
        i2h, h2h, _ = self._projections(inputs, states)
        out = ops.Activation(i2h + h2h, act_type=self._activation)
        return out, [out]


class LSTMCell(_GatedCell):
    """Gate order i,f,g,o, as the fused op's."""

    def __init__(self, hidden_size, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 dtype="float32", generator=None):
        super().__init__(4, hidden_size, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, dtype, generator)

    def state_info(self, batch_size=0):
        return super().state_info(batch_size) * 2

    def forward(self, inputs, states):
        i2h, h2h, states = self._projections(inputs, states)
        i, f, g, o = (i2h + h2h).chunk(4, -1)
        c = torch.sigmoid(f) * states[1] + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        return h, [h, c]


class GRUCell(_GatedCell):
    """Gate order r,z,n (reset, update, new), as the fused op's."""

    def __init__(self, hidden_size, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 dtype="float32", generator=None):
        super().__init__(3, hidden_size, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, dtype, generator)

    def forward(self, inputs, states):
        i2h, h2h, states = self._projections(inputs, states)
        i_r, i_z, i_n = i2h.chunk(3, -1)
        h_r, h_z, h_n = h2h.chunk(3, -1)
        r = torch.sigmoid(i_r + h_r)
        z = torch.sigmoid(i_z + h_z)
        n = torch.tanh(i_n + r * h_n)
        h = (1 - z) * n + z * states[0]
        return h, [h]


class SequentialRNNCell(RecurrentCell):
    """Cells stacked: each step runs them in the order added, the i-th
    named ``"i"``; the states are theirs, concatenated."""

    def add(self, cell):
        self.add_module(str(len(self._modules)), cell)

    def state_info(self, batch_size=0):
        return [info for c in self._modules.values()
                for info in c.state_info(batch_size)]

    def begin_state(self, batch_size=0, func=None, **kwargs):
        return [s for c in self._modules.values()
                for s in c.begin_state(batch_size, **kwargs)]

    def forward(self, inputs, states):
        next_states, p = [], 0
        for cell in self._modules.values():
            n = len(cell.state_info())
            inputs, new_states = cell(inputs, states[p:p + n])
            next_states.extend(new_states)
            p += n
        return inputs, next_states

    def __len__(self):
        return len(self._modules)


class HybridSequentialRNNCell(SequentialRNNCell):
    """The same container (the reference keeps a hybrid twin by name)."""


class DropoutCell(RecurrentCell):
    """Inverted dropout on the step's input, no state."""

    def __init__(self, rate, generator=None):
        super().__init__()
        self._rate = rate
        self._generator = default_generator(generator)

    def state_info(self, batch_size=0):
        return []

    def forward(self, inputs, states):
        return ops.Dropout(inputs, self._rate, generator=self._generator,
                           training=self.training), states


class ModifierCell(RecurrentCell):
    """Base of the cells that wrap ``base_cell``: its states are theirs."""

    def __init__(self, base_cell):
        super().__init__()
        self.base_cell = base_cell

    def state_info(self, batch_size=0):
        return self.base_cell.state_info(batch_size)

    def begin_state(self, batch_size=0, func=None, **kwargs):
        return self.base_cell.begin_state(batch_size, func=func, **kwargs)


class ZoneoutCell(ModifierCell):
    """Zoneout: each new state element keeps its old value with
    probability ``zoneout_states``, each output element the previous
    step's output with probability ``zoneout_outputs``."""

    def __init__(self, base_cell, zoneout_outputs=0.0, zoneout_states=0.0,
                 generator=None):
        super().__init__(base_cell)
        self._zo = zoneout_outputs
        self._zs = zoneout_states
        self._generator = default_generator(generator)
        self._prev_output = None

    def reset(self):
        super().reset()
        self._prev_output = None

    def _draw(self, like, rate):
        return torch.rand(like.shape, generator=self._generator,
                          device=like.device) < rate

    def forward(self, inputs, states):
        out, new_states = self.base_cell(inputs, states)
        if self._zs > 0:
            new_states = [torch.where(self._draw(ns, self._zs), s, ns)
                          for s, ns in zip(states, new_states)]
        if self._zo > 0:
            prev = self._prev_output if self._prev_output is not None \
                else torch.zeros_like(out)
            out = torch.where(self._draw(out, self._zo), prev, out)
            self._prev_output = out
        return out, new_states


class ResidualCell(ModifierCell):
    """``base_cell``'s output plus its input."""

    def forward(self, inputs, states):
        out, new_states = self.base_cell(inputs, states)
        return out + inputs, new_states


class BidirectionalCell(RecurrentCell):
    """``l_cell`` forward and ``r_cell`` backward over the sequence, their
    per-step outputs concatenated.  Only :meth:`unroll` runs it: a single
    step has no direction, as in the reference.  ``output_prefix`` (a
    symbol name in the reference) is accepted and has no effect."""

    def __init__(self, l_cell, r_cell, output_prefix="bi_"):
        super().__init__()
        self.l_cell = l_cell
        self.r_cell = r_cell

    def state_info(self, batch_size=0):
        return (self.l_cell.state_info(batch_size)
                + self.r_cell.state_info(batch_size))

    def begin_state(self, batch_size=0, func=None, **kwargs):
        return (self.l_cell.begin_state(batch_size, func=func, **kwargs)
                + self.r_cell.begin_state(batch_size, func=func, **kwargs))

    def forward(self, *args, **kwargs):
        raise MXNetError("BidirectionalCell cannot be stepped one input "
                         "at a time; use unroll()")

    @_imperative
    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        self.reset()
        steps = _steps(inputs, length, layout)
        n_l = len(self.l_cell.state_info())
        l_states = r_states = None
        if begin_state is not None:
            l_states, r_states = begin_state[:n_l], begin_state[n_l:]
        l_out, l_states = self.l_cell.unroll(
            length, steps, begin_state=l_states, layout=layout,
            merge_outputs=False, valid_length=valid_length)
        r_out, r_states = self.r_cell.unroll(
            length, steps[::-1], begin_state=r_states, layout=layout,
            merge_outputs=False, valid_length=valid_length)
        outs = [torch.cat([lo, ro], -1)
                for lo, ro in zip(l_out, r_out[::-1])]
        return (_merge(outs, merge_outputs, layout.find("T")),
                list(l_states) + list(r_states))
