"""Optimizers from ``tpu_mx/optimizer/optimizer.py``: the base, SGD,
LBSGD, NAG, Adam, AdamW, RMSProp, AdaGrad, AdaDelta, Ftrl, Signum,
LAMB, DCASGD, SGLD, Adamax, Nadam and FTML, and the ``Updater``.

As in the reference, an optimizer's math is a pure functional core,
``update_core(weight, grad, state, lr, wd, t) -> (new_weight,
new_state)``, here on tensors; ``CompiledTrainStep`` applies it to the
float32 masters of low-precision parameters when ``multi_precision`` is
set.  The imperative face (``gluon.Trainer``, :class:`Updater`) calls
``update_multi_precision(index, weight, grad, state)`` on arrays: it
counts the index's updates (``t``), takes the index's learning rate
(``lr_scheduler(num_update)`` with a scheduler, else ``lr``) and weight
decay (times the ``Parameter``'s ``lr_mult``/``wd_mult``), and writes
the new weight into the weight's own tensor in place; with
``multi_precision`` a float16/bfloat16 weight's state is ``(float32
master, inner state)`` (``create_state_multi_precision``), the update
runs on the master and the weight becomes its cast.  State tensors have
the reference's types: float32 for a low-precision weight where the
reference says so (SGD, LBSGD, Adam, AdamW, LAMB, Adamax, Nadam, FTML),
the weight's own type where it says that (NAG, RMSProp, AdaGrad,
AdaDelta, Ftrl, Signum, DCASGD).  ``SGLD`` draws its noise from a
``torch.Generator`` (``generator=``, else the process's generator for
the weight's device), not the reference's key stream.  The learning
rate and weight decay of an index take the multiplier of the first of:
its ``Parameter`` in ``param_dict`` (a ``Trainer`` sets one for every
index), the index-keyed ``set_lr_mult``/``set_wd_mult`` entry, the entry
of its name in ``param_idx2name``, as in the reference.
"""
from __future__ import annotations

import math

import torch

from .. import random as _random
from ..ndarray import ops

__all__ = ["Optimizer", "SGD", "LBSGD", "NAG", "Adam", "AdamW", "RMSProp",
           "AdaGrad", "AdaDelta", "Ftrl", "Signum", "LAMB", "DCASGD", "SGLD",
           "Adamax", "Nadam", "FTML", "Updater", "create", "get_updater",
           "register", "registry"]

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
    clip, mixed-precision flag.  ``sym`` is taken and read by nothing,
    as in the reference: the multipliers come from ``set_lr_mult`` /
    ``set_wd_mult``."""

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=0.01, lr_scheduler=None,
                 sym=None, begin_num_update=0, multi_precision=False,
                 param_dict=None):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            lr_scheduler.base_lr = learning_rate
        self.wd = wd
        self.clip_gradient = clip_gradient
        self.multi_precision = multi_precision
        self.param_dict = param_dict or {}
        self.begin_num_update = begin_num_update
        self.num_update = begin_num_update
        self._index_update_count = {}
        self.idx2name = param_idx2name or {}
        self.lr_mult = {}
        self.wd_mult = {}

    # the update is elementwise in (weight, grad, state) with scalar
    # hyperparameters (no per-tensor norm, no draw): set on the classes
    # the reference marks so
    elementwise_update = False

    def set_learning_rate(self, lr):
        self.lr = lr

    def set_lr_mult(self, args_lr_mult):
        """Learning-rate multipliers by index or by name."""
        self.lr_mult = dict(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        """Weight-decay multipliers by index or by name."""
        self.wd_mult = dict(args_wd_mult)

    def _mult(self, index, table, attr):
        p = self.param_dict.get(index)
        if p is not None:
            return getattr(p, attr)
        if index in table:
            return table[index]
        if index in self.idx2name:
            return table.get(self.idx2name[index], 1.0)
        return 1.0

    def _update_count(self, index):
        self._index_update_count[index] = \
            self._index_update_count.get(index, self.begin_num_update) + 1
        self.num_update = max(self._index_update_count[index],
                              self.num_update)

    def _get_lr(self, index):
        lr = self.lr_scheduler(self.num_update) if self.lr_scheduler \
            else self.lr
        return lr * self._mult(index, self.lr_mult, "lr_mult")

    def _get_wd(self, index):
        return self.wd * self._mult(index, self.wd_mult, "wd_mult")

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


def _zeros(weight, dtype=None):
    """Zeros shaped like ``weight`` in ``dtype`` (default the weight's),
    in the weight's memory format."""
    return torch.zeros_like(weight, dtype=dtype or weight.dtype)


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
        v = self.beta2 * var + (1 - self.beta2) * g.square()
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


@register
class LBSGD(Optimizer):
    """Large-batch SGD (LARS): momentum SGD whose rate is scaled per
    tensor by ``eta·‖w‖ / (‖g‖ + wd·‖w‖ + epsilon)`` (1 where either
    norm is 0) and warmed up linearly over ``warmup_epochs·
    updates_per_epoch`` updates; the momentum accumulates ``g + wd·w``
    and the step is ``w - rate·mom``."""

    def __init__(self, momentum=0.0, warmup_strategy="linear",
                 warmup_epochs=5, batch_scale=1, updates_per_epoch=32,
                 begin_epoch=0, num_epochs=60, eta=0.001, epsilon=1e-9,
                 **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.eta = eta
        self.epsilon = epsilon
        self.warmup_updates = max(1, int(warmup_epochs * updates_per_epoch))
        self.warmup_strategy = warmup_strategy

    def create_state(self, index, weight):
        if self.momentum != 0.0:
            return _zeros(weight, _state_dtype(weight))
        return None

    def update_core(self, weight, grad, state, lr, wd, t):
        warm = min(1.0, t / self.warmup_updates) \
            if self.warmup_strategy == "linear" else 1.0
        g = self._preprocess(grad, weight, wd)
        wnorm = torch.linalg.vector_norm(weight.float())
        gnorm = torch.linalg.vector_norm(g.float())
        trust = torch.where((wnorm > 0) & (gnorm > 0), self.eta * wnorm /
                            (gnorm + wd * wnorm + self.epsilon),
                            torch.ones_like(wnorm))
        eff_lr = (lr * warm * trust).to(weight.dtype)
        g = g + wd * weight
        if self.momentum == 0.0:
            return weight - eff_lr * g, None
        new_mom = self.momentum * state + g
        return weight - eff_lr * new_mom, new_mom


@register
class NAG(Optimizer):
    """Nesterov momentum: ``mom = momentum·mom + g'`` with ``g' = g +
    wd·w``, then ``w -= lr·(g' + momentum·mom)``."""

    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        return _zeros(weight)

    def update_core(self, weight, grad, state, lr, wd, t):
        g = self._preprocess(grad, weight, wd) + wd * weight
        new_mom = self.momentum * state + g
        return weight - lr * (g + self.momentum * new_mom), new_mom


@register
class AdamW(Optimizer):
    """Adam with decoupled weight decay: bias-corrected moments of the
    (rescaled, clipped) gradient, and ``wd·w`` added to the step, not to
    the gradient."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def create_state(self, index, weight):
        dt = _state_dtype(weight)
        return (_zeros(weight, dt), _zeros(weight, dt))

    def update_core(self, weight, grad, state, lr, wd, t):
        mean, var = state
        g = self._preprocess(grad, weight, wd)
        m = self.beta1 * mean + (1 - self.beta1) * g
        v = self.beta2 * var + (1 - self.beta2) * g.square()
        mhat = m / (1 - self.beta1 ** t)
        vhat = v / (1 - self.beta2 ** t)
        return weight - lr * (mhat / (vhat.sqrt() + self.epsilon)
                              + wd * weight), (m, v)


@register
class RMSProp(Optimizer):
    """RMSProp on ``g' = g + wd·w``: ``n = (1-γ1)·g'² + γ1·n``, ``w -=
    lr·g'/sqrt(n + eps)``; ``centered`` also tracks the mean gradient
    and a momentum ``delta`` (``gamma2``), the step being ``w +=
    delta``.  ``clip_weights`` is taken and, as in the reference,
    unused."""

    def __init__(self, learning_rate=0.001, gamma1=0.9, gamma2=0.9,
                 epsilon=1e-8, centered=False, clip_weights=None, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.gamma1, self.gamma2 = gamma1, gamma2
        self.epsilon = epsilon
        self.centered = centered

    def create_state(self, index, weight):
        if self.centered:
            return (_zeros(weight), _zeros(weight), _zeros(weight))
        return _zeros(weight)

    def update_core(self, weight, grad, state, lr, wd, t):
        g = self._preprocess(grad, weight, wd) + wd * weight
        g1 = self.gamma1
        if self.centered:
            n, mg, delta = state
            n = (1 - g1) * g.square() + g1 * n
            mg = (1 - g1) * g + g1 * mg
            delta = self.gamma2 * delta - lr * g / torch.sqrt(
                n - mg.square() + self.epsilon)
            return weight + delta, (n, mg, delta)
        n = (1 - g1) * g.square() + g1 * state
        return weight - lr * g / torch.sqrt(n + self.epsilon), n


@register
class AdaGrad(Optimizer):
    """``hist += g'²``, ``w -= lr·g'/sqrt(hist + eps)`` with ``g' = g +
    wd·w``."""

    def __init__(self, eps=1e-7, **kwargs):
        super().__init__(**kwargs)
        self.float_stable_eps = eps

    def create_state(self, index, weight):
        return _zeros(weight)

    def update_core(self, weight, grad, state, lr, wd, t):
        g = self._preprocess(grad, weight, wd) + wd * weight
        hist = state + g.square()
        return weight - lr * g / torch.sqrt(hist + self.float_stable_eps), \
            hist


@register
class AdaDelta(Optimizer):
    """AdaDelta (the learning rate is not used): running averages of
    ``g'²`` and of the squared step, ``rho`` their decay."""

    def __init__(self, rho=0.90, epsilon=1e-5, **kwargs):
        super().__init__(**kwargs)
        self.rho, self.epsilon = rho, epsilon

    def create_state(self, index, weight):
        return (_zeros(weight), _zeros(weight))

    def update_core(self, weight, grad, state, lr, wd, t):
        acc_g, acc_delta = state
        g = self._preprocess(grad, weight, wd) + wd * weight
        acc_g = self.rho * acc_g + (1 - self.rho) * g.square()
        delta = torch.sqrt(acc_delta + self.epsilon) / \
            torch.sqrt(acc_g + self.epsilon) * g
        acc_delta = self.rho * acc_delta + (1 - self.rho) * delta.square()
        return weight - delta, (acc_g, acc_delta)


@register
class Ftrl(Optimizer):
    """FTRL-proximal with L1 ``lamda1`` and L2 ``wd``: state ``(z,
    n)``; a weight is 0 where ``|z| <= lamda1``."""

    def __init__(self, lamda1=0.01, learning_rate=0.1, beta=1, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.lamda1, self.beta = lamda1, beta

    def create_state(self, index, weight):
        return (_zeros(weight), _zeros(weight))

    def update_core(self, weight, grad, state, lr, wd, t):
        z, n = state
        g = self._preprocess(grad, weight, wd)
        sigma = (torch.sqrt(n + g.square()) - torch.sqrt(n)) / lr
        z = z + g - sigma * weight
        n = n + g.square()
        new_w = torch.where(
            z.abs() > self.lamda1,
            -(z - torch.sign(z) * self.lamda1)
            / ((self.beta + torch.sqrt(n)) / lr + wd),
            torch.zeros((), dtype=z.dtype, device=z.device))
        return new_w.to(weight.dtype), (z, n)


@register
class Signum(Optimizer):
    """signSGD with momentum: ``mom = momentum·mom - (1-momentum)·g``,
    ``w = (1 - lr·wd_lh)·w + lr·sign(mom)`` (without momentum, ``w -=
    lr·sign(g)``)."""

    def __init__(self, learning_rate=0.01, momentum=0.9, wd_lh=0.0,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum
        self.wd_lh = wd_lh

    def create_state(self, index, weight):
        return _zeros(weight) if self.momentum else None

    def update_core(self, weight, grad, state, lr, wd, t):
        g = self._preprocess(grad, weight, wd)
        if self.momentum:
            mom = self.momentum * state - (1 - self.momentum) * g
            return (1 - lr * self.wd_lh) * weight + lr * torch.sign(mom), mom
        return (1 - lr * self.wd_lh) * weight - lr * torch.sign(g), None


@register
class DCASGD(Optimizer):
    """Delay-compensated SGD: the gradient plus ``lamda·g²·(w - w_prev)``
    (``w_prev`` the weight after the last update), then momentum SGD;
    state ``(mom, w_prev)``."""

    def __init__(self, learning_rate=0.01, momentum=0.0, lamda=0.04,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum
        self.lamda = lamda

    def create_state(self, index, weight):
        return (_zeros(weight), weight.detach().clone())

    def update_core(self, weight, grad, state, lr, wd, t):
        g = self._preprocess(grad, weight, wd)
        mom, prev_w = state
        comp = g + self.lamda * g * g * (weight - prev_w)
        mom = self.momentum * mom - lr * comp
        new_w = weight + mom
        return new_w, (mom, new_w)


@register
class SGLD(Optimizer):
    """Stochastic gradient Langevin dynamics: ``w - lr/2·g +
    sqrt(lr)·ξ``, ``ξ`` standard normal noise drawn from ``generator``
    (None: the process's generator for the weight's device)."""

    def __init__(self, learning_rate=0.01, generator=None, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.generator = generator

    def update_core(self, weight, grad, state, lr, wd, t):
        g = self._preprocess(grad, weight, wd)
        gen = self.generator if self.generator is not None \
            else _random.generator(weight.device)
        noise = torch.randn(weight.shape, generator=gen,
                            device=weight.device)
        return weight - 0.5 * lr * g + \
            (math.sqrt(lr) * noise).to(weight.dtype), None


@register
class Adamax(Optimizer):
    """Adam with the infinity norm: ``u = max(beta2·u, |g|)``, ``w -=
    lr/(1 - beta1ᵗ)·m/(u + 1e-8)``; float32 state."""

    def __init__(self, learning_rate=0.002, beta1=0.9, beta2=0.999,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2 = beta1, beta2

    def create_state(self, index, weight):
        return (_zeros(weight, torch.float32), _zeros(weight, torch.float32))

    def update_core(self, weight, grad, state, lr, wd, t):
        g = self._preprocess(grad, weight, wd).float()
        m, u = state
        m = self.beta1 * m + (1 - self.beta1) * g
        u = torch.maximum(self.beta2 * u, g.abs())
        lr_t = lr / (1 - self.beta1 ** t)
        return weight - (lr_t * m / (u + 1e-8)).to(weight.dtype), (m, u)


@register
class Nadam(Optimizer):
    """Nesterov Adam with the momentum schedule ``mu_t = beta1·(1 -
    0.5·0.96^(t·schedule_decay))``; state ``(m, v, prod mu)``, float32."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, schedule_decay=0.004, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2 = beta1, beta2
        self.epsilon = epsilon
        self.schedule_decay = schedule_decay

    def create_state(self, index, weight):
        return (_zeros(weight, torch.float32), _zeros(weight, torch.float32),
                torch.ones((), dtype=torch.float32, device=weight.device))

    def update_core(self, weight, grad, state, lr, wd, t):
        g = self._preprocess(grad, weight, wd).float()
        m, v, m_sched = state
        mu_t = self.beta1 * (1 - 0.5 * 0.96 ** (t * self.schedule_decay))
        mu_t1 = self.beta1 * (1 - 0.5 * 0.96 **
                              ((t + 1) * self.schedule_decay))
        m_sched_new = m_sched * mu_t
        g_prime = g / (1 - m_sched_new)
        m = self.beta1 * m + (1 - self.beta1) * g
        m_prime = m / (1 - m_sched_new * mu_t1)
        v = self.beta2 * v + (1 - self.beta2) * g * g
        v_prime = v / (1 - self.beta2 ** t)
        m_bar = (1 - mu_t) * g_prime + mu_t1 * m_prime
        step = lr * m_bar / (v_prime.sqrt() + self.epsilon)
        return weight - step.to(weight.dtype), (m, v, m_sched_new)


@register
class FTML(Optimizer):
    """Follow the moving leader: state ``(d, v, z)``, float32; the new
    weight is ``-z/d``."""

    def __init__(self, learning_rate=0.0025, beta1=0.6, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2 = beta1, beta2
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return tuple(_zeros(weight, torch.float32) for _ in range(3))

    def update_core(self, weight, grad, state, lr, wd, t):
        g = self._preprocess(grad, weight, wd).float()
        d_prev, v_prev, z_prev = state
        v = self.beta2 * v_prev + (1 - self.beta2) * g * g
        d = (1 - self.beta1 ** t) / lr * (
            torch.sqrt(v / (1 - self.beta2 ** t)) + self.epsilon)
        sigma = d - self.beta1 * d_prev
        z = self.beta1 * z_prev + (1 - self.beta1) * g - sigma * weight
        return (-z / d).to(weight.dtype), (d, v, z)


for _cls in (SGD, NAG, Adam, AdamW, RMSProp, AdaGrad, AdaDelta, Signum,
             Adamax, Nadam, FTML):
    _cls.elementwise_update = True
del _cls


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
