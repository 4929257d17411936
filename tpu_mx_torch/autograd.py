"""Imperative autograd, from ``tpu_mx/autograd.py``: ``record()`` /
``pause()`` / ``backward()`` over PyTorch's own tape.

The reference keeps a Python tape of ``jax.vjp`` pullbacks.  The port
does not keep a second tape: PyTorch's autograd records every operation
on a tensor that requires a gradient, and this module decides when it
may.  Recording is a thread-local flag, as in the reference; each
``nd.*`` call and each :class:`~tpu_mx_torch.gluon.Block` call given
:class:`~tpu_mx_torch.ndarray.NDArray` handles runs under
``torch.set_grad_enabled(is_recording())``, so no graph is built outside
``record()`` or inside ``pause()``.  Training mode (dropout,
BatchNorm's batch statistics) is the second flag, set by ``record()``
and ``train_mode()``, cleared by ``pause()`` and ``predict_mode()``.

``attach_grad`` makes an array's tensor a leaf that requires a gradient
and gives it a gradient buffer.  :func:`backward` computes the gradients
of every live attached leaf with one ``torch.autograd.grad`` call and
writes each into its buffer by its ``grad_req``: ``"write"`` overwrites,
``"add"`` accumulates over calls, and a leaf the heads do not reach
keeps its old gradient (``torch.Tensor.grad`` would always accumulate).
"""
from __future__ import annotations

import threading
import weakref

import torch

from .base import MXNetError

__all__ = ["record", "pause", "train_mode", "predict_mode", "is_recording",
           "is_training", "mark_variables", "backward", "grad", "Function"]


class _State(threading.local):
    def __init__(self):
        self.recording = False
        self.training = False
        # > 0 inside a HybridBlock's forward: the creation ops return
        # tensors there, as the reference's do inside a functional trace
        self.functional = 0


_STATE = _State()

# every array with an attached gradient buffer, by id (weak: an array
# that is collected leaves; its id is not reused before that)
_ATTACHED = weakref.WeakValueDictionary()


class _Scope:
    def __init__(self, recording, training):
        self._rec, self._train = recording, training

    def __enter__(self):
        self._old = (_STATE.recording, _STATE.training)
        if self._rec is not None:
            _STATE.recording = self._rec
        if self._train is not None:
            _STATE.training = self._train
        return self

    def __exit__(self, *exc):
        _STATE.recording, _STATE.training = self._old
        return False


def record(train_mode=True):
    """``with autograd.record():`` — build graphs (and train) inside."""
    return _Scope(True, train_mode)


def pause(train_mode=False):
    """``with autograd.pause():`` — build no graph inside."""
    return _Scope(False, train_mode)


def train_mode():
    return _Scope(None, True)


def predict_mode():
    return _Scope(None, False)


def is_recording():
    return _STATE.recording


def is_training():
    return _STATE.training


def _register(array):
    _ATTACHED[id(array)] = array


def mark_variables(variables, gradients, grad_reqs="write"):
    """Attach ``gradients`` (arrays) as the gradient buffers of
    ``variables`` (the reference's ``MXAutogradMarkVariables``)."""
    if not isinstance(variables, (list, tuple)):
        variables, gradients = [variables], [gradients]
    if isinstance(grad_reqs, str):
        grad_reqs = [grad_reqs] * len(variables)
    for v, g, req in zip(variables, gradients, grad_reqs):
        v._make_leaf()
        v._grad = g
        v._grad_req = req
        _register(v)


def _heads(heads, head_grads):
    from .ndarray.ndarray import NDArray
    if not isinstance(heads, (list, tuple)):
        heads = [heads]
    if head_grads is None:
        head_grads = [None] * len(heads)
    elif not isinstance(head_grads, (list, tuple)):
        head_grads = [head_grads]
    outs, grads = [], []
    for h, hg in zip(heads, head_grads):
        t = h._data
        if not t.requires_grad:
            continue             # not recorded: nothing flows from it
        outs.append(t)
        if hg is None:
            grads.append(torch.ones_like(t))
        else:
            g = hg._data if isinstance(hg, NDArray) else \
                torch.as_tensor(hg, dtype=t.dtype, device=t.device)
            grads.append(g.to(t.dtype).expand_as(t))
    return outs, grads


def backward(heads, head_grads=None, retain_graph=False, train_mode=True):
    """Gradients of ``heads`` (weighted by ``head_grads``, default ones)
    into every attached leaf's buffer, by its ``grad_req``; a leaf the
    heads do not reach keeps its gradient.  The graph is freed unless
    ``retain_graph``."""
    outs, grads = _heads(heads, head_grads)
    if not outs:
        return
    leaves = [a for a in list(_ATTACHED.values()) if a._grad_req != "null"
              and a._data.requires_grad and a._data.is_leaf]
    if not leaves:
        return
    got = torch.autograd.grad(outs, [a._data for a in leaves], grads,
                              retain_graph=retain_graph, allow_unused=True)
    with torch.no_grad():
        for leaf, g in zip(leaves, got):
            if g is not None:
                leaf._deposit(g)


def grad(heads, variables, head_grads=None, retain_graph=None,
         create_graph=False, train_mode=True):
    """Gradients of ``heads`` with respect to ``variables`` as new arrays
    (zeros where a variable is not reached); no gradient buffer is
    touched.  ``create_graph`` records the gradients' own graph."""
    from .ndarray.ndarray import NDArray
    single = not isinstance(variables, (list, tuple))
    if single:
        variables = [variables]
    outs, grads = _heads(heads, head_grads)
    ins = [v._data for v in variables]
    if not outs:
        got = [None] * len(ins)
    else:
        for v, t in zip(variables, ins):
            if not t.requires_grad:
                raise MXNetError("autograd.grad: a variable was not "
                                 "recorded (attach_grad() it before "
                                 "record())")
        got = torch.autograd.grad(outs, ins, grads,
                                  retain_graph=retain_graph,
                                  create_graph=create_graph,
                                  allow_unused=True)
    res = [NDArray(torch.zeros_like(t) if g is None else g)
           for t, g in zip(ins, got)]
    return res[0] if single else res


class Function:
    """A user operator with its own forward and backward, on arrays::

        class Sigmoid(autograd.Function):
            def forward(self, x):
                y = 1 / (1 + nd.exp(-x))
                self.save_for_backward(y)
                return y
            def backward(self, dy):
                y, = self.saved_tensors
                return dy * y * (1 - y)

    Under ``record()`` the call runs as a ``torch.autograd.Function``
    whose backward calls :meth:`backward`; both run paused."""

    def __init__(self):
        self._saved = ()

    def save_for_backward(self, *arrays):
        self._saved = arrays

    @property
    def saved_tensors(self):
        return self._saved

    def forward(self, *inputs):
        raise NotImplementedError

    def backward(self, *output_grads):
        raise NotImplementedError

    def __call__(self, *inputs):
        from .ndarray.ndarray import NDArray
        if not (_STATE.recording and any(
                isinstance(a, NDArray) and a._data.requires_grad
                for a in inputs)):
            with pause(_STATE.training):
                return self.forward(*inputs)
        user = self
        shape = {}

        class _Op(torch.autograd.Function):
            @staticmethod
            def forward(ctx, *tensors):
                with pause(_STATE.training):
                    out = user.forward(*[NDArray(t) for t in tensors])
                shape["single"] = not isinstance(out, (list, tuple))
                outs = [out] if shape["single"] else list(out)
                return tuple(o._data for o in outs)

            @staticmethod
            def backward(ctx, *dys):
                with pause():
                    got = user.backward(*[NDArray(d) for d in dys])
                if not isinstance(got, (list, tuple)):
                    got = [got]
                return tuple(None if g is None else g._data for g in got)

        outs = _Op.apply(*[a._data for a in inputs])
        outs = [NDArray(t) for t in outs]
        return outs[0] if shape["single"] else outs
