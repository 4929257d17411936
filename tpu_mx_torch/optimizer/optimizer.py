"""Optimizers from ``tpu_mx/optimizer/optimizer.py``: the base, SGD and
LAMB.

As in the reference, an optimizer's math is a pure functional core,
``update_core(weight, grad, state, lr, wd, t) -> (new_weight,
new_state)``, here on tensors; ``CompiledTrainStep`` applies it to the
float32 masters of low-precision parameters when ``multi_precision`` is
set.  The imperative ``update``/``Updater`` face, lr schedulers, the
per-parameter lr/wd multipliers and the other optimizers (Adam, AdamW,
...) are not ported yet (ROADMAP A5).
"""
from __future__ import annotations

import torch

from ..ndarray import ops

__all__ = ["Optimizer", "SGD", "LAMB", "create", "register", "registry"]

registry = {}


def register(cls):
    """Register an optimizer class under its lower-cased name."""
    registry[cls.__name__.lower()] = cls
    return cls


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

    def __init__(self, rescale_grad=1.0, wd=0.0, clip_gradient=None,
                 learning_rate=0.01, multi_precision=False):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.wd = wd
        self.clip_gradient = clip_gradient
        self.multi_precision = multi_precision

    def create_state(self, index, weight):
        """Per-weight state (tensors, tuples of them, or None)."""
        return None

    def update_core(self, weight, grad, state, lr, wd, t):
        raise NotImplementedError

    def _preprocess(self, grad, weight, wd):
        g = grad * self.rescale_grad
        if self.clip_gradient is not None:
            g = g.clamp(-self.clip_gradient, self.clip_gradient)
        return g


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
