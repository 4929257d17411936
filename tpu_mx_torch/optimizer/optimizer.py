"""Optimizers from ``tpu_mx/optimizer/optimizer.py``: the base, SGD,
Adam and LAMB, and the ``Updater``.

As in the reference, an optimizer's math is a pure functional core,
``update_core(weight, grad, state, lr, wd, t) -> (new_weight,
new_state)``, here on tensors; ``CompiledTrainStep`` applies it to the
float32 masters of low-precision parameters when ``multi_precision`` is
set.  The imperative face (``gluon.Trainer``, :class:`Updater`) calls
``update_multi_precision(index, weight, grad, state)`` on arrays: it
counts the index's updates (``t``), takes the index's learning rate and
weight decay (times the ``Parameter``'s ``lr_mult``/``wd_mult``), and
writes the new weight into the weight's own tensor in place; with
``multi_precision`` a float16/bfloat16 weight's state is ``(float32
master, inner state)`` (``create_state_multi_precision``), the update
runs on the master and the weight becomes its cast.  Not ported yet
(ROADMAP A5): the lr schedulers and ``param_idx2name`` (refused by name
when set), and the other optimizers (AdamW, NAG, RMSProp, AdaGrad,
AdaDelta, Ftrl, Signum, LBSGD, DCASGD, SGLD, Adamax, Nadam, FTML).
"""
from __future__ import annotations

import torch

from ..base import refuse_unported
from ..ndarray import ops

__all__ = ["Optimizer", "SGD", "Adam", "LAMB", "Updater", "create",
           "get_updater", "register", "registry"]

_LOW_PRECISION = (torch.float16, torch.bfloat16)

registry = {}


def register(obj=None, *, name=None, aliases=()):
    """Register an optimizer class under its lower-cased name (or
    ``name``) and each of ``aliases``; usable bare (``@register``) or
    with arguments (``@register(name="sgd2")``)."""
    def add(cls):
        for key in (name or cls.__name__, *aliases):
            registry[key.lower()] = cls
        return cls
    return add if obj is None else add(obj)


def create(name, **kwargs):
    """``create("lamb", learning_rate=1e-4, multi_precision=True)``."""
    if isinstance(name, Optimizer):
        return name
    try:
        return registry[name.lower()](**kwargs)
    except KeyError:
        raise ValueError(f"unknown optimizer {name!r}; the port has "
                         f"{sorted(registry)}") from None


class Optimizer:
    """Base optimizer: learning rate, weight decay, gradient rescale and
    clip, mixed-precision flag."""

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=0.01, lr_scheduler=None,
                 sym=None, begin_num_update=0, multi_precision=False,
                 param_dict=None):
        refuse_unported("Optimizer", "A5", param_idx2name=(param_idx2name,
                                                           None),
                        lr_scheduler=(lr_scheduler, None))
        refuse_unported("Optimizer", "A17 (symbol)", sym=(sym, None))
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.wd = wd
        self.clip_gradient = clip_gradient
        self.multi_precision = multi_precision
        self.param_dict = param_dict or {}
        self.begin_num_update = begin_num_update
        self.num_update = begin_num_update
        self._index_update_count = {}

    def set_learning_rate(self, lr):
        self.lr = lr

    def _update_count(self, index):
        self._index_update_count[index] = \
            self._index_update_count.get(index, self.begin_num_update) + 1
        self.num_update = max(self._index_update_count[index],
                              self.num_update)

    def _get_lr(self, index):
        p = self.param_dict.get(index)
        return self.lr * (p.lr_mult if p is not None else 1.0)

    def _get_wd(self, index):
        p = self.param_dict.get(index)
        return self.wd * (p.wd_mult if p is not None else 1.0)

    def create_state(self, index, weight):
        """Per-weight state (tensors, tuples of them, or None)."""
        return None

    def create_state_multi_precision(self, index, weight):
        """State for ``weight`` (an array or tensor): with
        ``multi_precision`` and a float16/bfloat16 weight, ``(float32
        master, the master's state)``."""
        w = _tensor(weight).detach()
        if self.multi_precision and w.dtype in _LOW_PRECISION:
            master = w.float().clone()
            return (master, self.create_state(index, master))
        return self.create_state(index, w)

    def update_core(self, weight, grad, state, lr, wd, t):
        raise NotImplementedError

    def _step(self, index):
        self._update_count(index)
        return (self._get_lr(index), self._get_wd(index),
                self._index_update_count[index])

    def update(self, index, weight, grad, state):
        """One update of array ``weight`` by ``grad``, in place; returns
        the new state."""
        lr, wd, t = self._step(index)
        w = _tensor(weight)
        with torch.no_grad():
            new_w, new_state = self.update_core(w.detach(), _tensor(grad),
                                                state, lr, wd, t)
            w.copy_(new_w)
        return new_state

    def update_multi_precision(self, index, weight, grad, state):
        """:meth:`update`, on the float32 master for a low-precision
        weight under ``multi_precision`` (the weight becomes its cast)."""
        w = _tensor(weight)
        if not (self.multi_precision and w.dtype in _LOW_PRECISION):
            return self.update(index, weight, grad, state)
        lr, wd, t = self._step(index)
        master, inner = state
        with torch.no_grad():
            new_master, new_inner = self.update_core(
                master, _tensor(grad).float(), inner, lr, wd, t)
            w.copy_(new_master)
        return (new_master, new_inner)

    def _preprocess(self, grad, weight, wd):
        g = grad * self.rescale_grad
        if self.clip_gradient is not None:
            g = g.clamp(-self.clip_gradient, self.clip_gradient)
        return g


def _tensor(x):
    """The tensor of an array (or the tensor itself)."""
    return x if isinstance(x, torch.Tensor) else x._data


def _state_dtype(weight):
    return torch.float32 if weight.dtype in (torch.float16, torch.bfloat16) \
        else weight.dtype


@register
class SGD(Optimizer):
    """SGD, with momentum the reference's rule
    (``ops.sgd_mom_update_core``): ``mom = momentum·mom - lr·(g + wd·w);
    w += mom``.  Weight decay applies to every parameter it is given.
    The momentum is float32 for a low-precision weight and has the
    weight's memory format.  ``lazy_update`` (sparse gradients) is taken
    and has no effect: the port's gradients are dense."""

    def __init__(self, momentum=0.0, lazy_update=True, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        if self.momentum != 0.0:
            return torch.zeros_like(weight, dtype=_state_dtype(weight))
        return None

    def update_core(self, weight, grad, state, lr, wd, t):
        if self.momentum == 0.0:
            return ops.sgd_update_core(weight, grad, lr, wd,
                                       self.rescale_grad,
                                       self.clip_gradient), None
        return ops.sgd_mom_update_core(weight, grad, state, lr,
                                       self.momentum, wd, self.rescale_grad,
                                       self.clip_gradient)


@register
class Adam(Optimizer):
    """Adam, the reference's rule (``ops.adam_update_core``): weight
    decay enters the gradient; the moments are float32 for a
    low-precision weight."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_update=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def create_state(self, index, weight):
        dt = _state_dtype(weight)
        return (torch.zeros(weight.shape, dtype=dt, device=weight.device),
                torch.zeros(weight.shape, dtype=dt, device=weight.device))

    def update_core(self, weight, grad, state, lr, wd, t):
        mean, var = state
        new_w, m, v = ops.adam_update_core(
            weight, grad, mean, var, lr, self.beta1, self.beta2,
            self.epsilon, wd, t, self.rescale_grad, self.clip_gradient)
        return new_w, (m, v)


@register
class LAMB(Optimizer):
    """Layer-wise adaptive large-batch optimizer (the BERT path).  The
    trust ratio ``‖w‖ / ‖update‖`` is taken over each whole parameter,
    and is 1 where either norm is 0; ``update`` includes ``wd·w``."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-6, lower_bound=None, upper_bound=None,
                 bias_correction=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.lower_bound, self.upper_bound = lower_bound, upper_bound
        self.bias_correction = bias_correction

    def create_state(self, index, weight):
        dt = _state_dtype(weight)
        return (torch.zeros(weight.shape, dtype=dt, device=weight.device),
                torch.zeros(weight.shape, dtype=dt, device=weight.device))

    def update_core(self, weight, grad, state, lr, wd, t):
        mean, var = state
        g = self._preprocess(grad, weight, wd)
        m = self.beta1 * mean + (1 - self.beta1) * g
        v = self.beta2 * var + (1 - self.beta2) * g * g
        if self.bias_correction:
            mhat = m / (1 - self.beta1 ** t)
            vhat = v / (1 - self.beta2 ** t)
        else:
            mhat, vhat = m, v
        update = mhat / (vhat.sqrt() + self.epsilon) + wd * weight
        wnorm = torch.linalg.vector_norm(weight)
        unorm = torch.linalg.vector_norm(update)
        ratio = torch.where((wnorm > 0) & (unorm > 0), wnorm / unorm,
                            torch.ones_like(wnorm))
        if self.lower_bound is not None:
            ratio = ratio.clamp_min(self.lower_bound)
        if self.upper_bound is not None:
            ratio = ratio.clamp_max(self.upper_bound)
        return weight - lr * ratio * update, (m, v)


class Updater:
    """Applies an optimizer's updates by parameter index, keeping each
    index's state (the reference's ``Updater``, a KVStore's updater)."""

    def __init__(self, optimizer):
        self.optimizer = optimizer
        self.states = {}

    def __call__(self, index, grad, weight):
        if index not in self.states:
            self.states[index] = \
                self.optimizer.create_state_multi_precision(index, weight)
        self.states[index] = self.optimizer.update_multi_precision(
            index, weight, grad, self.states[index])

    def set_states(self, states):
        self.states = states

    def get_states(self):
        return self.states


def get_updater(optimizer):
    return Updater(optimizer)
