"""The fused RNN operator of ``tpu_mx/ndarray/rnn_op.py`` (``RNN`` over a
packed parameter blob), and the multi-layer recurrence that it and the
``gluon.rnn`` layers share.

The blob has the reference's (cuDNN's) layout: per layer and direction
the input weights ``Wx`` and then the recurrent weights ``Wh``, for all
layers, and then all the biases (``bx``, ``bh`` per layer and direction)
at the tail.  Gate order is i,f,g,o for LSTM and r,z,n for GRU; for GRU
``bh`` stays inside the reset gate's product, ``r * (h·Whᵀ + bh)``.

Two arms compute the recurrence; :func:`rnn_arm` picks one, a pure
function of the device type, dtype, mode, dropout and training flag,
and each call counts its arm in ``rnn.arm{kind=...}``:

- ``"scan"``: plain PyTorch repeating the reference's arithmetic step
  for step.  The input projection of every time step is hoisted into one
  product over ``T·N`` rows (with ``bx + bh`` folded in for LSTM and the
  RNN modes); each step is the ``(N, H)`` recurrent product and the gate
  math.  The CPU runs it, and it is the parity oracle on the card.
- ``"fused"``: ATen's fused recurrence (``torch._VF.lstm``, ``gru``,
  ``rnn_tanh``, ``rnn_relu``) given the per-(layer, direction) weights as
  its flat weight list, in the reference's order ``w_ih, w_hh, b_ih,
  b_hh``.  On the card ATen hands it to cuDNN's RNN, bfloat16 included
  (``torch.cudnn_is_acceptable``), in IEEE float32 while
  ``device.resolve`` keeps TF32 off.  The weights are separate tensors
  (the reference's parameters, or views of the blob), not cuDNN's one
  packed buffer, so cuDNN copies them into one on every call and says so
  in a warning; the copy is kept visible.
- ``"fused_layers"``: the fused arm one layer at a time, with the
  dropout between layers drawn from the caller's explicit generator:
  the fused call itself is never asked for dropout, which it would draw
  from PyTorch's global generator.

Nothing switches arms because a call failed, and nothing runs on the
CPU unless the tensors are there.
"""
from __future__ import annotations

import torch
from torch import _VF

from .. import telemetry as _telemetry
from . import ops

__all__ = ["RNN", "rnn_param_size", "rnn_arm", "recurrence", "unpack",
           "GATES", "ARMS"]

GATES = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}
ARMS = ("scan", "fused", "fused_layers")


def _check_mode(mode):
    if mode not in GATES:
        raise ValueError(f"RNN mode {mode!r}: one of {sorted(GATES)}")


def rnn_param_size(mode, input_size, state_size, num_layers=1,
                   bidirectional=False):
    """Total packed-parameter count (the reference's blob size)."""
    _check_mode(mode)
    g, d = GATES[mode], 2 if bidirectional else 1
    total = 0
    for layer in range(num_layers):
        in_sz = input_size if layer == 0 else state_size * d
        total += d * (g * state_size * (in_sz + state_size)
                      + 2 * g * state_size)
    return total


def unpack(params, mode, input_size, state_size, num_layers, bidirectional):
    """The blob as the flat weight list ``[wx, wh, bx, bh]`` per (layer,
    direction), in that order: views of ``params``, no copy."""
    want = rnn_param_size(mode, input_size, state_size, num_layers,
                          bidirectional)
    if params.numel() != want:
        raise ValueError(f"RNN: a blob of {params.numel()} parameters for "
                         f"{want} ({mode}, input {input_size}, state "
                         f"{state_size}, {num_layers} layers)")
    g, d, h = GATES[mode], 2 if bidirectional else 1, state_size
    weights, off = [], 0

    def take(*shape):
        nonlocal off
        n = 1
        for s in shape:
            n *= s
        view = params[off:off + n].view(*shape)
        off += n
        return view

    for layer in range(num_layers):
        in_sz = input_size if layer == 0 else h * d
        for _ in range(d):
            weights.append([take(g * h, in_sz), take(g * h, h)])
    for i in range(num_layers * d):
        weights[i] += [take(g * h), take(g * h)]
    return [w for per_dir in weights for w in per_dir]


def rnn_arm(device, dtype, mode, dropout, training):
    """The arm :func:`recurrence` takes on a ``device`` (a device type
    such as ``"cuda"``, or a :class:`torch.device`) for tensors of
    ``dtype``: ``"scan"`` off the card; on the card ``"fused"``, or
    ``"fused_layers"`` when dropout between layers is on (``dropout > 0``
    in training)."""
    _check_mode(mode)
    if torch.device(device).type != "cuda":
        return "scan"
    if dropout > 0 and training:
        return "fused_layers"
    return "fused"


def _scan_direction(mode, x, state, wi, wh, bi, bh):
    """One direction of one layer.  x: (T, N, C); state: (h,) or (h, c),
    each (N, H).  Returns the outputs (T, N, H) and the final state."""
    t_len, n = x.shape[:2]
    hoisted = bi if mode == "gru" else bi + bh
    xproj = torch.addmm(hoisted, x.reshape(t_len * n, -1), wi.t()) \
        .view(t_len, n, -1)
    h = state[0]
    c = state[1] if mode == "lstm" else None
    act = torch.relu if mode == "rnn_relu" else torch.tanh
    outs = []
    for t in range(t_len):
        if mode == "lstm":
            i, f, g, o = torch.addmm(xproj[t], h, wh.t()).chunk(4, 1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
        elif mode == "gru":
            xr, xz, xn = xproj[t].chunk(3, 1)
            hr, hz, hn = torch.addmm(bh, h, wh.t()).chunk(3, 1)
            r = torch.sigmoid(xr + hr)
            z = torch.sigmoid(xz + hz)
            nn_ = torch.tanh(xn + r * hn)
            h = (1 - z) * nn_ + z * h
        else:
            h = act(torch.addmm(xproj[t], h, wh.t()))
        outs.append(h)
    return torch.stack(outs), (h, c)


def _scan_layer(mode, x, states, weights, bidirectional):
    """One layer, both directions: the reverse one flips its input and
    its output.  ``states``: ``(D, N, H)`` slices."""
    outs, hs, cs = [], [], []
    for di in range(2 if bidirectional else 1):
        wi, wh, bi, bh = weights[4 * di:4 * di + 4]
        seq = x.flip(0) if di else x
        out, (h, c) = _scan_direction(mode, seq, [s[di] for s in states],
                                      wi, wh, bi, bh)
        outs.append(out.flip(0) if di else out)
        hs.append(h)
        cs.append(c)
    out = outs[0] if len(outs) == 1 else torch.cat(outs, -1)
    return out, torch.stack(hs), (torch.stack(cs) if mode == "lstm" else None)


def _fused_call(mode, x, states, weights, num_layers, bidirectional):
    """ATen's fused recurrence over ``num_layers`` layers, dropout 0.
    cuDNN keeps what its backward needs only in training mode, so the
    call trains whenever autograd records."""
    fn = getattr(_VF, mode)
    train = torch.is_grad_enabled()
    if mode == "lstm":
        out, h, c = fn(x, (states[0], states[1]), weights, True, num_layers,
                       0.0, train, bidirectional, False)
        return out, h, c
    out, h = fn(x, states[0], weights, True, num_layers, 0.0, train,
                bidirectional, False)
    return out, h, None


def recurrence(mode, x, states, weights, num_layers=1, bidirectional=False,
               dropout=0.0, training=False, generator=None, arm=None):
    """The stacked (optionally bidirectional) recurrence.

    x       — ``(T, N, C)``
    states  — ``[h0]`` or, for LSTM, ``[h0, c0]``, each ``(L·D, N, H)``
    weights — ``[w_ih, w_hh, b_ih, b_hh]`` per (layer, direction), flat
    dropout — inverted dropout on every layer's output but the last, in
              ``training`` only, drawn from ``generator``
    arm     — None for :func:`rnn_arm`'s choice, or an arm by name (the
              tests run both on the CPU)

    Every tensor has one dtype and device.  Returns ``(out, hN, cN)``:
    out ``(T, N, D·H)``, hN and cN ``(L·D, N, H)`` (cN None but for
    LSTM)."""
    _check_mode(mode)
    if arm is None:
        arm = rnn_arm(x.device, x.dtype, mode, dropout, training)
    elif arm not in ARMS:
        raise ValueError(f"RNN arm {arm!r}: one of {ARMS}")
    _telemetry.counter("rnn.arm", kind=arm).inc()
    d = 2 if bidirectional else 1
    if arm == "fused":
        if dropout > 0 and training and num_layers > 1:
            raise ValueError("RNN: the fused arm runs no dropout; dropout "
                             "between layers takes \"fused_layers\"")
        return _fused_call(mode, x, states, weights, num_layers,
                           bidirectional)
    hs, cs, inp = [], [], x
    for layer in range(num_layers):
        ws = weights[4 * d * layer:4 * d * (layer + 1)]
        st = [s[d * layer:d * (layer + 1)] for s in states]
        if arm == "scan":
            inp, h, c = _scan_layer(mode, inp, st, ws, bidirectional)
        else:
            inp, h, c = _fused_call(mode, inp, st, ws, 1, bidirectional)
        hs.append(h)
        cs.append(c)
        if layer < num_layers - 1:
            inp = ops.Dropout(inp, dropout, generator=generator,
                              training=training)
    return (inp, torch.cat(hs), torch.cat(cs) if mode == "lstm" else None)


def RNN(data, parameters, state, state_cell=None, state_size=None,
        num_layers=1, mode="lstm", bidirectional=False, p=0.0,
        state_outputs=False, arm=None, **kwargs):
    """Fused multi-layer (bi)RNN over the packed blob ``parameters``.

    data ``(T, N, I)``; state, and for LSTM state_cell, ``(L·D, N, H)``.
    Returns the output ``(T, N, D·H)``, and with ``state_outputs`` also
    the final h (and c for LSTM): ``(out, hN[, cN])``.  The tensors take
    their promoted dtype.  ``p`` (dropout) is accepted and ignored, as
    the reference ignores it; so are the reference's other keyword
    arguments.  ``arm`` as in :func:`recurrence`."""
    _check_mode(mode)
    is_lstm = mode == "lstm"
    states = [state] + ([state_cell] if is_lstm else [])
    dt = torch.promote_types(data.dtype, parameters.dtype)
    for s in states:
        dt = torch.promote_types(dt, s.dtype)
    weights = unpack(parameters.to(dt), mode, data.shape[-1], state_size,
                     num_layers, bidirectional)
    out, h, c = recurrence(mode, data.to(dt), [s.to(dt) for s in states],
                           weights, num_layers, bidirectional, arm=arm)
    if not state_outputs:
        return out
    return (out, h, c) if is_lstm else (out, h)


# the imperative face of ndarray/ops.py: arrays in, arrays out
RNN = ops._op(RNN)
