"""``Dense``, ``LayerNorm`` and ``Dropout`` from ``gluon/nn/basic_layers.py``.

As :class:`torch.nn.Module`s with the reference's parameter names
(``weight``/``bias``, ``gamma``/``beta``) and initializers.  Shapes are
declared up front (``in_units``/``in_channels``): the port has no
deferred initialization.  Parameters are created on the device of the
``generator`` that draws them, in ``dtype``.
"""
from __future__ import annotations

import torch
from torch import nn

from ... import initializer as _init
from ...base import MXNetError
from ...ndarray import ops

__all__ = ["Dense", "LayerNorm", "Dropout", "make_param"]


def make_param(name, shape, generator, dtype=torch.float32, init=None):
    """A trainable parameter drawn by ``init`` (an initializer, or None for
    the reference's default ``Uniform(0.07)``), which sees ``name`` for
    its name convention: biases and betas are 0, gammas 1."""
    data = _init.create(init)(name, tuple(shape), dtype, generator)
    return nn.Parameter(data)


class Dense(nn.Module):
    """``y = x·Wᵀ + b`` over the last axis (the reference's
    ``flatten=False``; no activation: BERT applies gelu itself)."""

    def __init__(self, units, in_units=0, dtype=torch.float32,
                 generator=None):
        super().__init__()
        if not in_units:
            raise MXNetError("Dense: in_units must be given (the port has "
                             "no deferred initialization)")
        self.weight = make_param("weight", (units, in_units), generator,
                                 dtype)
        self.bias = make_param("bias", (units,), generator, dtype)

    def forward(self, x):
        return ops.FullyConnected(x, self.weight, self.bias)


class LayerNorm(nn.Module):
    """Layer normalization over the last axis with float32 statistics
    (``ops.LayerNorm``); gamma starts at 1, beta at 0."""

    def __init__(self, epsilon=1e-5, in_channels=0, dtype=torch.float32,
                 generator=None):
        super().__init__()
        if not in_channels:
            raise MXNetError("LayerNorm: in_channels must be given (the "
                             "port has no deferred initialization)")
        self._eps = epsilon
        self.gamma = make_param("gamma", (in_channels,), generator, dtype)
        self.beta = make_param("beta", (in_channels,), generator, dtype)

    def forward(self, x):
        return ops.LayerNorm(x, self.gamma, self.beta, eps=self._eps)


class Dropout(nn.Module):
    """Inverted dropout in training mode (``module.train()``), drawing its
    masks from the explicit ``generator``."""

    def __init__(self, rate, generator):
        super().__init__()
        self._rate = rate
        self._generator = generator

    def forward(self, x):
        return ops.Dropout(x, self._rate, self._generator, self.training)
