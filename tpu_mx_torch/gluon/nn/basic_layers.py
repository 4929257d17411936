"""Basic layers from ``gluon/nn/basic_layers.py``: ``Dense``,
``BatchNorm``, ``LayerNorm``, ``Dropout``, ``Embedding``, ``Activation``,
``Flatten`` and ``HybridSequential``.

As :class:`torch.nn.Module`s with the reference's parameter names
(``weight``/``bias``, ``gamma``/``beta``, ``running_mean``/
``running_var``), order and initializers.  An input size left at 0
(``in_units``/``in_channels``) is inferred at the first forward by the
reference's rules (``infer_shape``), after ``initialize()``.  Parameters
of known shape are created on the device of the ``generator`` that draws
them (default: the current context's), in ``dtype``.  ``prefix`` names a
layer's parameters as in the reference; ``params`` shares another
block's.
"""
from __future__ import annotations

import math

import torch

from ... import layout as _layout
from ...base import refuse_unported
from ...ndarray import ops
from ..block import HybridBlock, as_dtype, default_generator

__all__ = ["Dense", "BatchNorm", "LayerNorm", "Dropout", "Embedding",
           "Activation", "Flatten", "HybridSequential"]


class Activation(HybridBlock):
    """``ops.Activation`` as a layer (``"relu"``, ``"sigmoid"``, ...)."""

    def __init__(self, activation, prefix=None, params=None):
        super().__init__(prefix, params)
        self._act_type = activation

    def forward(self, x):
        return ops.Activation(x, act_type=self._act_type)

    def extra_repr(self):
        return self._act_type


class Dense(HybridBlock):
    """``y = act(x·Wᵀ + b)``.  With ``flatten`` (the default) an input of
    rank > 2 is reshaped to ``(N, prod(shape[1:]))`` first; with
    ``flatten=False`` the product runs over the last axis (BERT).  With
    ``use_bias=False`` there is no ``bias`` parameter.  ``in_units=0``:
    ``prod(shape[1:])`` of the first input with ``flatten``, else its
    last axis."""

    def __init__(self, units, activation=None, use_bias=True, flatten=True,
                 dtype=torch.float32, weight_initializer=None,
                 bias_initializer="zeros", in_units=0, generator=None,
                 prefix=None, params=None):
        super().__init__(prefix, params)
        g, dt = default_generator(generator), as_dtype(dtype)
        self._units = units
        self._flatten = flatten
        self._declare("weight", (units, in_units), weight_initializer, dt, g)
        if use_bias:
            self._declare("bias", (units,), bias_initializer, dt, g)
        else:
            self.bias = None
        self.act = Activation(activation) if activation else None

    def infer_shape(self, x, *args):
        in_units = math.prod(x.shape[1:]) if self._flatten else x.shape[-1]
        self._reg_params["weight"].shape_hint((self._units, in_units))

    def forward(self, x):
        out = ops.FullyConnected(x, self.weight, self.bias,
                                 no_bias=self.bias is None,
                                 flatten=self._flatten)
        return self.act(out) if self.act is not None else out


class BatchNorm(HybridBlock):
    """Batch normalization with the reference's numerics
    (``basic_layers.py:BatchNorm``, its one-pass form).

    In training (``module.train()``, unless ``use_global_stats``) the
    statistics over every axis but ``axis`` are float32 (float64 for a
    float64 input) sums
    ``s1 = Σx``, ``s2 = Σx²`` of ``n`` elements: ``mean = s1/n``,
    ``var = max(s2/n - mean², 0)``, the biased (population) variance,
    both for the normalization and for the running statistics, which
    become ``m·rs + (1 - m)·stat`` in their own dtype (``m`` =
    ``momentum``).  This is not ``F.batch_norm``'s update, which keeps the
    unbiased variance and takes ``1 - m`` as its momentum.  Otherwise the
    running statistics normalize.  The normalization is one float32
    per-channel scale and bias, cast once to ``x``'s dtype:
    ``x·scale + bias``.  ``axis=None`` follows ``layout.bn_axis()``:
    1 channels-first, -1 under a channels-last default.  ``in_channels=0``:
    the first input's size along ``axis``."""

    def __init__(self, axis=None, momentum=0.9, epsilon=1e-5, center=True,
                 scale=True, use_global_stats=False, beta_initializer="zeros",
                 gamma_initializer="ones", running_mean_initializer="zeros",
                 running_variance_initializer="ones", in_channels=0,
                 dtype=torch.float32, generator=None, prefix=None,
                 params=None):
        super().__init__(prefix, params)
        g, dt = default_generator(generator), as_dtype(dtype)
        self._axis = _layout.bn_axis() if axis is None else axis
        self._momentum = momentum
        self._eps = epsilon
        self._center = center
        self._scale = scale
        self._use_global_stats = use_global_stats
        shape = (in_channels,)
        self._declare("gamma", shape, gamma_initializer, dt, g, grad=scale)
        self._declare("beta", shape, beta_initializer, dt, g, grad=center)
        self._declare("running_mean", shape, running_mean_initializer, dt, g,
                      aux=True)
        self._declare("running_var", shape, running_variance_initializer,
                      dt, g, aux=True)

    def infer_shape(self, x, *args):
        for leaf in ("gamma", "beta", "running_mean", "running_var"):
            self._reg_params[leaf].shape_hint((x.shape[self._axis],))

    def forward(self, x):
        axis = self._axis % x.dim()
        shape = [1] * x.dim()
        shape[axis] = x.shape[axis]
        red = tuple(i for i in range(x.dim()) if i != axis)
        gamma = self.gamma if self._scale else torch.ones_like(self.gamma)
        beta = self.beta if self._center else torch.zeros_like(self.beta)
        acc = torch.promote_types(x.dtype, torch.float32)
        if self.training and not self._use_global_stats:
            n = math.prod(x.shape[i] for i in red)
            s1 = torch.sum(x, dim=red, dtype=acc)
            # Σx² in float32 without a float32 copy of x kept for the
            # backward: the norm saves x itself
            s2 = torch.linalg.vector_norm(x, 2, dim=red, dtype=acc).square()
            mean = s1 * (1.0 / n)
            var = torch.clamp_min(s2 * (1.0 / n) - mean.square(), 0.0)
            with torch.no_grad():
                m = self._momentum
                for rs, stat in ((self.running_mean, mean),
                                 (self.running_var, var)):
                    rs.copy_(m * rs + (1 - m) * stat.to(rs.dtype))
        else:
            mean = self.running_mean.to(acc)
            var = self.running_var.to(acc)
        scale = torch.rsqrt(var + self._eps) * gamma.to(acc)
        bias = beta.to(acc) - mean * scale
        return torch.addcmul(bias.to(x.dtype).view(shape), x,
                             scale.to(x.dtype).view(shape))


class LayerNorm(HybridBlock):
    """Layer normalization over the last axis with float32 statistics
    (``ops.LayerNorm``); gamma starts at 1, beta at 0.  ``in_channels=0``:
    the first input's last axis."""

    def __init__(self, epsilon=1e-5, in_channels=0, dtype=torch.float32,
                 generator=None, axis=-1, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 prefix=None, params=None):
        super().__init__(prefix, params)
        refuse_unported("LayerNorm", "A3", axis=(axis, -1))
        g, dt = default_generator(generator), as_dtype(dtype)
        self._eps = epsilon
        self._declare("gamma", (in_channels,), gamma_initializer, dt, g,
                      grad=scale)
        self._declare("beta", (in_channels,), beta_initializer, dt, g,
                      grad=center)

    def infer_shape(self, x, *args):
        for leaf in ("gamma", "beta"):
            self._reg_params[leaf].shape_hint((x.shape[-1],))

    def forward(self, x):
        return ops.LayerNorm(x, self.gamma, self.beta, eps=self._eps)


class Dropout(HybridBlock):
    """Inverted dropout in training mode (``autograd.record()`` on
    arrays, ``module.train()`` on tensors), drawing its masks from the
    explicit ``generator`` (None: the process's generator for the
    input's device).  ``axes`` (a mask shared along axes) is not ported
    yet."""

    def __init__(self, rate, generator=None, axes=(), prefix=None,
                 params=None):
        super().__init__(prefix, params)
        refuse_unported("Dropout", "A3", axes=(tuple(axes), ()))
        self._rate = rate
        self._generator = generator

    def forward(self, x):
        return ops.Dropout(x, self._rate, self._generator, self.training)


class Embedding(HybridBlock):
    """Row lookup ``weight[x]`` of a ``(input_dim, output_dim)`` table.
    Token ids may come as floats (the word-LM benchmark passes float32
    ids); ``ops.Embedding`` takes them as integers.  ``sparse_grad`` is
    accepted and has no effect: the gradient is dense, as in the
    reference."""

    def __init__(self, input_dim, output_dim, dtype=torch.float32,
                 weight_initializer=None, sparse_grad=False, generator=None,
                 prefix=None, params=None):
        super().__init__(prefix, params)
        g, dt = default_generator(generator), as_dtype(dtype)
        self._input_dim, self._output_dim = input_dim, output_dim
        self._declare("weight", (input_dim, output_dim), weight_initializer,
                      dt, g)

    def forward(self, x):
        return ops.Embedding(x, self.weight)

    def extra_repr(self):
        return f"{self._input_dim} -> {self._output_dim}"


class Flatten(HybridBlock):
    """``(N, ...)`` → ``(N, prod(...))`` in the logical order of the
    axes, whatever the memory format (a channels-last ``(N, C, H, W)``
    tensor flattens in (C, H, W) order, as the reference's NCHW array
    does)."""

    def forward(self, x):
        return x.reshape(x.shape[0], -1)


class HybridSequential(HybridBlock):
    """Children run in the order added; the i-th is named ``"i"``, as
    the reference's ``_children`` keys."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix, params)

    def add(self, *blocks):
        for b in blocks:
            self.add_module(str(len(self._modules)), b)

    def forward(self, x):
        for block in self._modules.values():
            x = block(x)
        return x

    def __len__(self):
        return len(self._modules)

    def __getitem__(self, key):
        items = list(self._modules.values())
        if isinstance(key, slice):
            net = type(self)()
            net.add(*items[key])
            return net
        return items[key]

    def __iter__(self):
        return iter(self._modules.values())

