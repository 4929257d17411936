"""Basic layers from ``gluon/nn/basic_layers.py``: ``Dense``,
``BatchNorm``, ``LayerNorm``, ``InstanceNorm``, ``GroupNorm``,
``Dropout``, ``Embedding``, ``Activation`` and the other activations
(``LeakyReLU``, ``PReLU``, ``ELU``, ``SELU``, ``GELU``, ``Swish``),
``Flatten``, ``ReflectionPad2D``, ``Sequential``/``HybridSequential``
and ``Lambda``/``HybridLambda``.

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
import os

import torch
import torch.nn.functional as F

from ... import initializer as _init
from ... import layout as _layout
from ...base import MXNetError
from ...ndarray import ops
from ..block import Block, HybridBlock, as_dtype, default_generator

__all__ = ["Sequential", "HybridSequential", "Dense", "Dropout", "BatchNorm",
           "GroupNorm", "ReflectionPad2D", "LayerNorm", "InstanceNorm",
           "Embedding", "Flatten", "Activation", "LeakyReLU", "PReLU", "ELU",
           "SELU", "GELU", "Swish", "Lambda", "HybridLambda"]


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
        bias = self._parameters.get("bias")
        out = ops.FullyConnected(x, self._parameters["weight"], bias,
                                 no_bias=bias is None, flatten=self._flatten)
        return self.act(out) if self.act is not None else out


def _coll():
    from ...parallel import collectives   # parallel imports gluon
    return collectives


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
    the first input's size along ``axis``.

    Inside a train step's SPMD region whose batch is split over ranks
    (``collectives.batch_split``) the statistics are the global batch's,
    as the reference's mesh program computes them: each rank's sums are
    added over the batch axes (ranks of equal batches) with
    ``collectives.batch_sum``, whose backward adds the cotangents too, so
    the normalized output, the input gradient and the running statistics
    are those of the global batch at world size 1.  Under the compressed
    per-shard reduction the region names no batch axes and each rank
    keeps its own."""

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
        gamma, beta = self._parameters["gamma"], self._parameters["beta"]
        running_mean = self._buffers["running_mean"]
        running_var = self._buffers["running_var"]
        if not self._scale:
            gamma = torch.ones_like(gamma)
        if not self._center:
            beta = torch.zeros_like(beta)
        if os.environ.get("TPUMX_BN_ONEPASS", "1") != "1":
            return self._legacy_forward(x, gamma, beta, running_mean,
                                        running_var, red, shape)
        acc = torch.promote_types(x.dtype, torch.float32)
        if self.training and not self._use_global_stats:
            n = math.prod(x.shape[i] for i in red)
            s1 = torch.sum(x, dim=red, dtype=acc)
            # Σx² in float32 without a float32 copy of x kept for the
            # backward: the norm saves x itself
            s2 = torch.linalg.vector_norm(x, 2, dim=red, dtype=acc).square()
            coll = _coll()
            mesh, axes, ranks, _ = coll.batch_split()
            if mesh is not None:     # one all-reduce of Σx and Σx²
                c = x.shape[axis]
                tot = coll.batch_sum(torch.cat([s1, s2]), mesh, axes)
                s1, s2, n = tot[:c], tot[c:], n * ranks
            mean = s1 * (1.0 / n)
            var = torch.clamp_min(s2 * (1.0 / n) - mean.square(), 0.0)
            with torch.no_grad():
                m = self._momentum
                for rs, stat in ((running_mean, mean), (running_var, var)):
                    rs.copy_(m * rs + (1 - m) * stat.to(rs.dtype))
            inv = torch.rsqrt(var + self._eps)
        else:
            mean = running_mean.to(acc)
            var = running_var.to(acc)
            # from the running statistics the inverse deviation is
            # rounded once from float64, the same on the card and the
            # host: float32 rsqrt differs between them in ~30% of values,
            # and int8 inference requantizes after every norm, where a
            # 1-ulp scale flips quanta (PERF.md §6)
            inv = torch.rsqrt(var.double() + self._eps).to(acc)
        scale = inv * gamma.to(acc)
        bias = beta.to(acc) - mean * scale
        return torch.addcmul(bias.to(x.dtype).view(shape), x,
                             scale.to(x.dtype).view(shape))

    def _legacy_forward(self, x, gamma, beta, running_mean, running_var,
                        red, shape):
        """The reference's two-pass form (``TPUMX_BN_ONEPASS`` set to
        anything but ``"1"``, read every call): ``mean``, then
        ``var = mean((x - mean)²)``, both in ``x``'s dtype (a bfloat16
        mean is summed in float32 and rounded once, as ``jnp.mean``
        does), the running statistics ``m·rs + (1 - m)·stat`` in the
        promoted dtype of the two, and the normalization unfolded:
        ``(x - mean)·rsqrt(var + eps)·gamma + beta``."""
        if self.training and not self._use_global_stats:
            coll = _coll()
            mesh, axes, ranks, _ = coll.batch_split()
            if mesh is None:
                mean = x.mean(dim=red)
                var = (x - mean.view(shape)).square().mean(dim=red)
            else:   # the global batch's mean, then its centred squares
                acc = torch.promote_types(x.dtype, torch.float32)
                n = math.prod(x.shape[i] for i in red) * ranks
                total = lambda t: coll.batch_sum(
                    t.sum(dim=red, dtype=acc), mesh, axes) * (1.0 / n)
                mean = total(x).to(x.dtype)
                var = total((x - mean.view(shape)).square()).to(x.dtype)
            with torch.no_grad():
                m = self._momentum
                for rs, stat in ((running_mean, mean), (running_var, var)):
                    rs.copy_(m * rs + (1 - m) * stat)
        else:
            mean, var = running_mean, running_var
        inv = torch.rsqrt(var.view(shape) + self._eps)
        return (x - mean.view(shape)) * inv * gamma.view(shape) \
            + beta.view(shape)


class LayerNorm(HybridBlock):
    """Layer normalization over ``axis`` (the last by default) with
    float32 statistics (``ops.LayerNorm``); gamma starts at 1, beta at 0.
    ``in_channels=0``: the first input's size along ``axis``."""

    def __init__(self, epsilon=1e-5, in_channels=0, dtype=torch.float32,
                 generator=None, axis=-1, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 prefix=None, params=None):
        super().__init__(prefix, params)
        g, dt = default_generator(generator), as_dtype(dtype)
        self._eps = epsilon
        self._axis = axis
        self._declare("gamma", (in_channels,), gamma_initializer, dt, g,
                      grad=scale)
        self._declare("beta", (in_channels,), beta_initializer, dt, g,
                      grad=center)

    def infer_shape(self, x, *args):
        for leaf in ("gamma", "beta"):
            self._reg_params[leaf].shape_hint((x.shape[self._axis],))

    def forward(self, x):
        return ops.LayerNorm(x, self._parameters["gamma"],
                             self._parameters["beta"], axis=self._axis,
                             eps=self._eps)


class InstanceNorm(HybridBlock):
    """Each example's each channel normalized over its positions
    (``(N, C, *S)`` input; ``axis`` is taken and, as in the reference,
    the channel axis is 1), float32 statistics; ``in_channels=0``: the
    first input's channels."""

    def __init__(self, axis=1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, dtype=torch.float32, generator=None,
                 prefix=None, params=None):
        super().__init__(prefix, params)
        g, dt = default_generator(generator), as_dtype(dtype)
        self._eps = epsilon
        self._declare("gamma", (in_channels,), gamma_initializer, dt, g)
        self._declare("beta", (in_channels,), beta_initializer, dt, g)

    def infer_shape(self, x, *args):
        for leaf in ("gamma", "beta"):
            self._reg_params[leaf].shape_hint((x.shape[1],))

    def forward(self, x):
        return ops.InstanceNorm(x, self._parameters["gamma"],
                                self._parameters["beta"], eps=self._eps)


class GroupNorm(HybridBlock):
    """Group normalization of ``(N, C, *S)`` input: C split into
    ``num_groups`` groups, each normalized over its channels and
    positions with float32 statistics; ``gamma``/``beta`` are per group,
    ``(num_groups,)``, as in the reference, so its weights load as they
    are."""

    def __init__(self, num_groups=1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 dtype=torch.float32, generator=None, prefix=None,
                 params=None):
        super().__init__(prefix, params)
        g, dt = default_generator(generator), as_dtype(dtype)
        self._ng = int(num_groups)
        self._eps = epsilon
        self._declare("gamma", (self._ng,), gamma_initializer, dt, g,
                      grad=scale)
        self._declare("beta", (self._ng,), beta_initializer, dt, g,
                      grad=center)

    def forward(self, x):
        if x.shape[1] % self._ng:
            raise MXNetError(f"GroupNorm: channels {x.shape[1]} not "
                             f"divisible by num_groups {self._ng}")
        return ops.GroupNorm(x, self._parameters["gamma"],
                             self._parameters["beta"], num_groups=self._ng,
                             eps=self._eps)


class Dropout(HybridBlock):
    """Inverted dropout in training mode (``autograd.record()`` on
    arrays, ``module.train()`` on tensors), drawing its masks from the
    explicit ``generator`` (None: the process's generator for the
    input's device); with ``axes`` one draw is shared along those
    axes."""

    def __init__(self, rate, generator=None, axes=(), prefix=None,
                 params=None):
        super().__init__(prefix, params)
        self._rate = rate
        self._generator = generator
        self._axes = tuple(axes)

    def forward(self, x):
        return ops.Dropout(x, self._rate, axes=self._axes,
                           generator=self._generator, training=self.training)


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
        return ops.Embedding(x, self._parameters["weight"])

    def extra_repr(self):
        return f"{self._input_dim} -> {self._output_dim}"


class LeakyReLU(HybridBlock):
    """``x`` above 0, ``alpha·x`` below."""

    def __init__(self, alpha=0.01, prefix=None, params=None):
        super().__init__(prefix, params)
        self._alpha = alpha

    def forward(self, x):
        return ops.LeakyReLU(x, act_type="leaky", slope=self._alpha)


class PReLU(HybridBlock):
    """Leaky ReLU with a learned slope ``alpha`` of shape ``(1,)``
    (``Constant(0.25)`` unless ``alpha_initializer`` says otherwise)."""

    def __init__(self, alpha_initializer=None, dtype=torch.float32,
                 generator=None, prefix=None, params=None):
        super().__init__(prefix, params)
        g, dt = default_generator(generator), as_dtype(dtype)
        self._declare("alpha", (1,), alpha_initializer or
                      _init.Constant(0.25), dt, g)

    def forward(self, x):
        return ops.LeakyReLU(x, gamma=self._parameters["alpha"],
                             act_type="prelu")


class ELU(HybridBlock):
    """``x`` above 0, ``alpha·(eˣ - 1)`` below."""

    def __init__(self, alpha=1.0, prefix=None, params=None):
        super().__init__(prefix, params)
        self._alpha = alpha

    def forward(self, x):
        return ops.LeakyReLU(x, act_type="elu", slope=self._alpha)


class SELU(HybridBlock):
    def forward(self, x):
        return ops.LeakyReLU(x, act_type="selu")


class GELU(HybridBlock):
    """GELU, the erf form."""

    def forward(self, x):
        return ops.gelu(x)


class Swish(HybridBlock):
    """``x·sigmoid(beta·x)``."""

    def __init__(self, beta=1.0, prefix=None, params=None):
        super().__init__(prefix, params)
        self._beta = beta

    def forward(self, x):
        return x * torch.sigmoid(self._beta * x)


class ReflectionPad2D(HybridBlock):
    """Mirror padding of the H and W axes of ``(N, C, H, W)`` input:
    ``padding`` is one int or ``(left, right, top, bottom)``."""

    def __init__(self, padding=0, prefix=None, params=None):
        super().__init__(prefix, params)
        if isinstance(padding, int):
            padding = (padding,) * 4
        self._pad = tuple(int(p) for p in padding)

    def forward(self, x):
        return F.pad(x, self._pad, mode="reflect")


class Lambda(Block):
    """A block that calls ``function`` on its arguments (arrays in,
    arrays out)."""

    def __init__(self, function, prefix=None, params=None):
        super().__init__(prefix, params)
        self._fn = function

    def forward(self, *args):
        return self._fn(*args)


class HybridLambda(HybridBlock):
    """A hybrid block that calls ``function(F, *args)``, ``F`` being the
    port's ``nd`` namespace as :meth:`HybridBlock.hybrid_forward` gets
    it (MobileNet's ReLU6 is ``lambda F, x: F.clip(x, 0, 6)``)."""

    def __init__(self, function, prefix=None, params=None):
        super().__init__(prefix, params)
        self._fn = function

    def hybrid_forward(self, F, *args):
        return self._fn(F, *args)


class Flatten(HybridBlock):
    """``(N, ...)`` → ``(N, prod(...))`` in the logical order of the
    axes, whatever the memory format (a channels-last ``(N, C, H, W)``
    tensor flattens in (C, H, W) order, as the reference's NCHW array
    does)."""

    def forward(self, x):
        return x.reshape(x.shape[0], -1)


class _Stack:
    """What ``Sequential`` and ``HybridSequential`` share: children run
    in the order added; the i-th is named ``"i"``, as the reference's
    ``_children`` keys."""

    def add(self, *blocks):
        for b in blocks:
            self.add_module(str(len(self._modules)), b)

    def forward(self, x, *args):
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


class Sequential(_Stack, Block):
    """A stack of blocks that is not hybridizable, as in the reference:
    it hands what it is given (arrays) to each child in turn."""

    def __init__(self, prefix=None, params=None):
        Block.__init__(self, prefix, params)


class HybridSequential(_Stack, HybridBlock):
    """A stack of hybrid blocks."""

    def __init__(self, prefix=None, params=None):
        HybridBlock.__init__(self, prefix, params)

