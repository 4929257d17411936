"""Weight initializers: the part of ``tpu_mx/initializer.py`` BERT reaches.

As in the reference, an initializer is called with the parameter's name
and dispatches on the name convention first: names ending in ``gamma``
get 1, names ending in ``beta`` or ``bias`` get 0 (so every bias of BERT
is zero, whatever initializer it was given), and only the remaining
weights are drawn.  Parameters with no initializer of their own take
``Uniform(0.07)``, the reference's default (``gluon/parameter.py``).

Draws take an explicit :class:`torch.Generator` and are made on its
device; the port never uses PyTorch's global RNG.  The numbers differ
from the reference's (another generator): parity tests carry weights
over with ``from_numpy`` instead.
"""
from __future__ import annotations

import torch

__all__ = ["Initializer", "Uniform", "create", "DEFAULT"]


def _aux_value(name):
    """Name-convention constant for affine params, or None for weights."""
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


class Uniform(Initializer):
    """U(-scale, scale), drawn in float32 and cast to the parameter's type."""

    def __init__(self, scale=0.07):
        self.scale = scale

    def _init_weight(self, shape, generator):
        u = torch.rand(shape, generator=generator, device=generator.device)
        return u * (2 * self.scale) - self.scale


DEFAULT = Uniform(0.07)


def create(init):
    """An :class:`Initializer` from an instance, or None for the default
    ``Uniform(0.07)``.  The reference's registry of named initializers
    (``"xavier"``, ``"normal"``, ...) is not ported yet."""
    if init is None:
        return DEFAULT
    if isinstance(init, Initializer):
        return init
    raise ValueError(f"initializer {init!r}: the port takes an Initializer "
                     "instance or None (its named registry is not ported)")
