"""Weight initializers from ``tpu_mx/initializer.py``: ``Uniform``,
``Zero``/``One``, ``Constant`` and ``Xavier``, by instance or by
registered name (``"uniform"``, ``"zeros"``, ``"ones"``, ``"constant"``,
``"xavier"``).

As in the reference, an initializer is called with the parameter's name
and dispatches on the name convention first: names ending in ``gamma``
or ``running_var`` get 1, names ending in ``beta``, ``bias`` or
``running_mean`` get 0 (so every bias of BERT is zero, whatever
initializer it was given), and only the remaining weights are drawn.
Parameters with no initializer of their own take ``Uniform(0.07)``, the
reference's default (``gluon/parameter.py``).  ``shape`` is always the
reference's shape of the parameter: a fan (``Xavier``) is read from it,
and a layer that stores the tensor in another order (a channels-last
convolution's weight) permutes the draw afterwards.

Draws take an explicit :class:`torch.Generator` and are made on its
device; the port never uses PyTorch's global RNG.  The numbers differ
from the reference's (another generator): parity tests carry weights
over with ``from_numpy`` instead.
"""
from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["Initializer", "Uniform", "Zero", "One", "Constant", "Xavier",
           "create", "registry", "DEFAULT"]

registry = {}


def register(cls=None, *, aliases=()):
    """Register an initializer under its lower-cased name and aliases."""
    def _do(c):
        for key in (c.__name__.lower(),) + tuple(aliases):
            registry[key] = c
        return c
    return _do(cls) if cls is not None else _do


def _aux_value(name):
    """Name-convention constant for aux/affine params, or None for weights."""
    if name.endswith(("running_mean", "moving_mean")):
        return 0.0
    if name.endswith(("running_var", "moving_var")):
        return 1.0
    if name.endswith("gamma"):
        return 1.0
    if name.endswith(("beta", "bias")):
        return 0.0
    return None


class Initializer:
    """Base: the name convention, then :meth:`_init_weight`."""

    def __call__(self, name, shape, dtype, generator):
        aux = _aux_value(name)
        if aux is not None:
            return torch.full(shape, aux, dtype=dtype,
                              device=generator.device)
        return self._init_weight(shape, generator).to(dtype)

    def _init_weight(self, shape, generator):
        raise NotImplementedError


def _uniform(shape, scale, generator):
    u = torch.rand(shape, generator=generator, device=generator.device)
    return u * (2 * scale) - scale


@register
class Uniform(Initializer):
    """U(-scale, scale), drawn in float32 and cast to the parameter's type."""

    def __init__(self, scale=0.07):
        self.scale = scale

    def _init_weight(self, shape, generator):
        return _uniform(shape, self.scale, generator)


@register(aliases=("zeros",))
class Zero(Initializer):
    def _init_weight(self, shape, generator):
        return torch.zeros(shape, device=generator.device)


@register(aliases=("ones",))
class One(Initializer):
    def _init_weight(self, shape, generator):
        return torch.ones(shape, device=generator.device)


@register
class Constant(Initializer):
    """Every entry ``value`` (SSD's conv4_3 scale starts at 20)."""

    def __init__(self, value=0.0):
        self.value = value

    def _init_weight(self, shape, generator):
        return torch.full(shape, self.value, dtype=torch.float64,
                          device=generator.device)


def _fan(shape, factor_type):
    """The reference's fan of a weight of (reference) shape ``shape``:
    in = ``shape[1]`` times the product of ``shape[2:]``, out =
    ``shape[0]`` times it.  For a channels-last convolution's
    ``(O, kh, kw, I)`` that reads ``kw·I`` as the window, as the
    reference does."""
    hw = int(np.prod(shape[2:])) if len(shape) > 2 else 1
    fan_in = shape[1] * hw if len(shape) > 1 else shape[0]
    fan_out = shape[0] * hw
    if factor_type == "in":
        return fan_in
    if factor_type == "out":
        return fan_out
    return (fan_in + fan_out) / 2.0


@register
class Xavier(Initializer):
    """U(-s, s) (``rnd_type="uniform"``) or N(0, s) (``"gaussian"``) with
    ``s = sqrt(magnitude / fan)``, the fan of :func:`_fan`."""

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3):
        if rnd_type not in ("uniform", "gaussian"):
            raise ValueError(f"Xavier: unknown rnd_type {rnd_type!r}")
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = magnitude

    def scale(self, shape):
        return math.sqrt(self.magnitude / _fan(shape, self.factor_type))

    def _init_weight(self, shape, generator):
        s = self.scale(shape)
        if self.rnd_type == "uniform":
            return _uniform(shape, s, generator)
        return s * torch.randn(shape, generator=generator,
                               device=generator.device)


DEFAULT = Uniform(0.07)


def create(init):
    """An :class:`Initializer` from an instance, a registered name
    (``"xavier"``, ``"zeros"``, ...) or None for the default
    ``Uniform(0.07)``."""
    if init is None:
        return DEFAULT
    if isinstance(init, Initializer):
        return init
    if isinstance(init, str) and init.lower() in registry:
        return registry[init.lower()]()
    raise ValueError(f"initializer {init!r} is not in the port's registry "
                     f"({sorted(registry)})")
