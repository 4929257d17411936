"""Weight initializers from ``tpu_mx/initializer.py``: ``Uniform``,
``Normal``, ``Zero``/``One``, ``Constant``, ``Xavier``, ``MSRAPrelu``,
``Orthogonal``, ``Bilinear`` and ``LSTMBias``, by instance or by
registered name (``"uniform"``, ``"normal"``, ``"zeros"``, ``"ones"``,
``"constant"``, ``"xavier"``, ``"msraprelu"``, ``"orthogonal"``,
``"bilinear"``, ``"lstmbias"``); and ``Mixed`` (the first pattern that
matches a parameter's name picks its initializer) and ``Load`` (arrays
saved by name).

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

__all__ = ["Initializer", "Uniform", "Normal", "Zero", "One", "Constant",
           "Xavier", "MSRAPrelu", "Orthogonal", "Bilinear", "LSTMBias",
           "Mixed", "Load", "create", "registry", "DEFAULT"]

registry = {}


def register(cls=None, *, name=None, aliases=()):
    """Register an initializer under its lower-cased name (or ``name``)
    and aliases."""
    def _do(c):
        for key in ((name or c.__name__).lower(),) + tuple(aliases):
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


@register
class Normal(Initializer):
    """N(0, sigma), drawn in float32."""

    def __init__(self, sigma=0.01):
        self.sigma = sigma

    def _init_weight(self, shape, generator):
        return self.sigma * torch.randn(shape, generator=generator,
                                        device=generator.device)


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


@register(name="msraprelu")
class MSRAPrelu(Xavier):
    """He initialization for PReLU nets: Gaussian Xavier with magnitude
    ``2 / (1 + slope²)``."""

    def __init__(self, factor_type="avg", slope=0.25):
        super().__init__("gaussian", factor_type, 2.0 / (1 + slope ** 2))


@register
class Orthogonal(Initializer):
    """``scale`` times an orthonormal basis: the left or right singular
    vectors (whichever has the weight's ``(rows, prod(rest))`` shape) of
    a uniform(-1, 1) (``rand_type="uniform"``) or standard normal draw,
    found in float64."""

    def __init__(self, scale=1.414, rand_type="uniform"):
        self.scale = scale
        self.rand_type = rand_type

    def _init_weight(self, shape, generator):
        rows, cols = shape[0], int(np.prod(shape[1:]))
        dev = generator.device
        tmp = _uniform((rows, cols), 1.0, generator) \
            if self.rand_type == "uniform" else \
            torch.randn((rows, cols), generator=generator, device=dev)
        u, _, v = torch.linalg.svd(tmp.double(), full_matrices=False)
        q = u if tuple(u.shape) == (rows, cols) else v
        return (self.scale * q).reshape(shape).float()


@register
class Bilinear(Initializer):
    """The bilinear upsampling kernel of a ``(.., .., kh, kw)`` weight
    (a transposed convolution's), as the reference builds it."""

    def _init_weight(self, shape, generator):
        i = torch.arange(int(np.prod(shape)), dtype=torch.float64,
                         device=generator.device)
        f = math.ceil(shape[3] / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        x = torch.remainder(i, shape[3])
        y = torch.remainder(torch.div(i, shape[3], rounding_mode="floor"),
                            shape[2])
        return ((1 - (x / f - c).abs()) * (1 - (y / f - c).abs())).reshape(
            shape)


@register(name="lstmbias")
class LSTMBias(Initializer):
    """An LSTM's bias: 0, and ``forget_bias`` on the forget gate (the
    second quarter), whatever the parameter's name."""

    def __init__(self, forget_bias=1.0):
        self.forget_bias = forget_bias

    def __call__(self, name, shape, dtype, generator):
        b = torch.zeros(shape, dtype=dtype, device=generator.device)
        n = shape[0] // 4
        b[n:2 * n] = self.forget_bias
        return b


class Mixed(Initializer):
    """The first of ``patterns`` (regular expressions, searched in the
    parameter's name) that matches picks the initializer; none matching
    raises (add a ``".*"`` catch-all)."""

    def __init__(self, patterns, initializers):
        import re
        if len(patterns) != len(initializers):
            raise ValueError("patterns and initializers must pair up")
        self._map = [(re.compile(p), create(i))
                     for p, i in zip(patterns, initializers)]

    def __call__(self, name, shape, dtype, generator):
        for pat, init in self._map:
            if pat.search(name):
                return init(name, shape, dtype, generator)
        raise ValueError(f"no initializer pattern matches {name!r}; "
                         "add a '.*' catch-all")


class Load(Initializer):
    """Arrays saved by name (a dict, or an ``nd.save`` file of either
    package; a ``arg:``/``aux:`` prefix is dropped); a name not there
    takes ``default_init``, and with none raises."""

    def __init__(self, param, default_init=None, verbose=False):
        if isinstance(param, str):
            from .context import cpu
            from .ndarray.ndarray import load as nd_load
            param = nd_load(param, ctx=cpu())
        self._param = {k.split(":", 1)[-1]: v for k, v in param.items()}
        self._default = default_init
        self._verbose = verbose

    def __call__(self, name, shape, dtype, generator):
        if name in self._param:
            arr = self._param[name]
            t = arr._data if hasattr(arr, "_data") else torch.as_tensor(
                np.asarray(arr))
            if tuple(t.shape) != tuple(shape):
                raise ValueError(f"Load: shape mismatch for {name}: saved "
                                 f"{tuple(t.shape)} vs wanted "
                                 f"{tuple(shape)}")
            return t.detach().to(device=generator.device, dtype=dtype,
                                 copy=True)
        if self._default is None:
            raise ValueError(f"Load: {name!r} not in saved params and no "
                             "default_init given")
        return create(self._default)(name, shape, dtype, generator)


DEFAULT = Uniform(0.07)


def create(name, **kwargs):
    """An :class:`Initializer` from an instance, a registered name
    (``"xavier"``, ``"zeros"``, ...) built with ``kwargs``
    (``create("xavier", magnitude=2)``), or None for the default
    ``Uniform(0.07)``."""
    if name is None:
        return DEFAULT
    if isinstance(name, Initializer):
        return name
    if isinstance(name, str) and name.lower() in registry:
        return registry[name.lower()](**kwargs)
    raise ValueError(f"initializer {name!r} is not in the port's registry "
                     f"({sorted(registry)})")
