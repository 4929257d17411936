"""``mx.np.random``: numpy-style sampling from the port's generators
(:func:`tpu_mx_torch.random.generator` for the context's device), as
``tpu_mx/numpy/random.py`` draws from the reference's key stream.  The
two streams differ, so the draws match the reference's in
distribution, shape and type, not bit for bit.  Each sampler takes
numpy's arguments plus ``dtype`` and ``ctx`` (default: the current
context); the integer samplers give int32, the rest float32, as the
reference's do."""
from __future__ import annotations

import math

import numpy as _onp
import torch

from .. import random as _random
from ..ndarray import NDArray
from ..ndarray import ops as _ops
from ..ndarray.ndarray import _torch_dtype
from . import _dev

__all__ = ["uniform", "normal", "randn", "rand", "randint", "choice",
           "shuffle", "permutation", "multinomial", "beta", "gamma",
           "exponential", "seed",
           "poisson", "binomial", "chisquare", "geometric", "gumbel",
           "laplace", "logistic", "lognormal", "pareto", "power", "rayleigh",
           "weibull"]


def seed(s):
    _random.seed(s)


def _shape(size):
    if size is None:
        return ()
    return (size,) if isinstance(size, int) else tuple(size)


def _draw(fn, size, dtype, ctx, default="float32"):
    """``fn(generator, shape, device)`` on ``ctx``, cast to ``dtype``."""
    dev = _dev(ctx)
    with torch.no_grad():
        out = fn(_random.generator(dev), _shape(size), dev)
    return _ops._place(out.to(_torch_dtype(dtype or default)))


def _u(g, s, d):
    return torch.rand(s, generator=g, device=d)


def _u_open(g, s, d):
    """Uniform on (0, 1): a log of it is finite."""
    return torch.rand(s, generator=g, device=d).clamp_min(
        torch.finfo(torch.float32).tiny)


def _gamma(g, k, s, d):
    return torch._standard_gamma(torch.full(s, float(k), device=d),
                                 generator=g)


def _value(v):
    if isinstance(v, NDArray):
        return v._data
    return v


def uniform(low=0.0, high=1.0, size=None, dtype=None, ctx=None):
    return _draw(lambda g, s, d: _u(g, s, d) * (high - low) + low, size,
                 dtype, ctx)


def normal(loc=0.0, scale=1.0, size=None, dtype=None, ctx=None):
    return _draw(lambda g, s, d: torch.randn(s, generator=g, device=d)
                 * scale + loc, size, dtype, ctx)


def randn(*size):
    return normal(size=size or None)


def rand(*size):
    return uniform(size=size or None)


def randint(low, high=None, size=None, dtype=None, ctx=None):
    if high is None:
        low, high = 0, low
    return _draw(lambda g, s, d: torch.randint(int(low), int(high), s,
                                               generator=g, device=d),
                 size, dtype, ctx, "int32")


def choice(a, size=None, replace=True, p=None, ctx=None):
    """Entries of ``a`` (an array, or ``arange(a)``), with probabilities
    ``p`` (default: uniform), with or without replacement."""
    dev = _dev(ctx)
    arr = torch.arange(a, device=dev) if isinstance(a, int) else \
        torch.as_tensor(_value(a), device=dev)
    w = torch.ones(arr.shape[0], device=dev) if p is None else \
        torch.as_tensor(_value(p), device=dev).float()
    n = math.prod(_shape(size))
    idx = torch.multinomial(w, n, replacement=replace,
                            generator=_random.generator(dev))
    return _ops._place(arr[idx].reshape(_shape(size) + tuple(arr.shape[1:])))


def permutation(x):
    """A permuted ``arange(x)``, or ``x``'s rows in a random order."""
    if isinstance(x, int):
        dev = _dev(None)
        return _ops._place(torch.randperm(
            x, generator=_random.generator(dev), device=dev))
    t = torch.as_tensor(_value(x))
    perm = torch.randperm(t.shape[0], generator=_random.generator(t.device),
                          device=t.device)
    return _ops._place(t[perm])


def shuffle(x):
    """Shuffle ``x``'s rows in place (the handle is rebound to the
    permuted tensor)."""
    if not isinstance(x, NDArray):
        raise TypeError("shuffle needs an NDArray")
    t = x._data
    perm = torch.randperm(t.shape[0], generator=_random.generator(t.device),
                          device=t.device)
    x._rebind(t[perm])


def multinomial(n, pvals, size=None):
    """Counts of ``n`` draws over the categories of ``pvals``, shape
    ``size + (len(pvals),)``, int32."""
    dev = _dev(None)
    pv = torch.as_tensor(_onp.asarray(pvals, _onp.float64) if not isinstance(
        pvals, (NDArray, torch.Tensor)) else _value(pvals), device=dev).float()
    k = pv.shape[-1]
    rows = math.prod(_shape(size))
    draws = torch.multinomial(pv.clamp_min(1e-30), rows * n,
                              replacement=True,
                              generator=_random.generator(dev))
    counts = torch.nn.functional.one_hot(draws.reshape(rows, n), k).sum(1)
    return _ops._place(counts.reshape(_shape(size) + (k,)).int())


def beta(a, b, size=None, dtype=None, ctx=None):
    def f(g, s, d):
        x, y = _gamma(g, a, s, d), _gamma(g, b, s, d)
        return x / (x + y)
    return _draw(f, size, dtype, ctx)


def gamma(shape, scale=1.0, size=None, dtype=None, ctx=None):
    return _draw(lambda g, s, d: _gamma(g, shape, s, d) * scale, size, dtype,
                 ctx)


def exponential(scale=1.0, size=None, dtype=None, ctx=None):
    return _draw(lambda g, s, d: torch.empty(s, device=d).exponential_(
        1.0, generator=g) * scale, size, dtype, ctx)


def poisson(lam=1.0, size=None, dtype=None, ctx=None):
    return _draw(lambda g, s, d: torch.poisson(
        torch.full(s, float(lam), device=d), generator=g), size, dtype, ctx,
        "int32")


def binomial(n, p, size=None, dtype=None, ctx=None):
    return _draw(lambda g, s, d: torch.binomial(
        torch.full(s, float(n), device=d), torch.full(s, float(p), device=d),
        generator=g), size, dtype, ctx, "int32")


def chisquare(df, size=None, dtype=None, ctx=None):
    return _draw(lambda g, s, d: 2.0 * _gamma(g, df / 2.0, s, d), size,
                 dtype, ctx)


def geometric(p, size=None, dtype=None, ctx=None):
    """Trials to the first success (support 1, 2, ...)."""
    return _draw(lambda g, s, d: torch.floor(
        torch.log(_u_open(g, s, d)) / math.log1p(-p)) + 1, size, dtype, ctx,
        "int32")


def gumbel(loc=0.0, scale=1.0, size=None, dtype=None, ctx=None):
    return _draw(lambda g, s, d: loc - scale * torch.log(
        -torch.log(_u_open(g, s, d))), size, dtype, ctx)


def laplace(loc=0.0, scale=1.0, size=None, dtype=None, ctx=None):
    def f(g, s, d):
        u = _u(g, s, d) - 0.5
        return loc - scale * torch.sign(u) * torch.log1p(-2 * u.abs())
    return _draw(f, size, dtype, ctx)


def logistic(loc=0.0, scale=1.0, size=None, dtype=None, ctx=None):
    def f(g, s, d):
        u = _u_open(g, s, d)
        return loc + scale * (torch.log(u) - torch.log1p(-u))
    return _draw(f, size, dtype, ctx)


def lognormal(mean=0.0, sigma=1.0, size=None, dtype=None, ctx=None):
    return _draw(lambda g, s, d: torch.exp(mean + sigma * torch.randn(
        s, generator=g, device=d)), size, dtype, ctx)


def pareto(a, size=None, dtype=None, ctx=None):
    """numpy's Pareto II (Lomax): ``U**(-1/a) - 1``."""
    return _draw(lambda g, s, d: _u_open(g, s, d).pow(-1.0 / a) - 1.0, size,
                 dtype, ctx)


def power(a, size=None, dtype=None, ctx=None):
    """``U**(1/a)``: numpy's power distribution."""
    return _draw(lambda g, s, d: _u(g, s, d).pow(1.0 / a), size, dtype, ctx)


def rayleigh(scale=1.0, size=None, dtype=None, ctx=None):
    return _draw(lambda g, s, d: scale * torch.sqrt(
        -2.0 * torch.log(_u_open(g, s, d))), size, dtype, ctx)


def weibull(a, size=None, dtype=None, ctx=None):
    return _draw(lambda g, s, d: (-torch.log(_u_open(g, s, d))).pow(
        1.0 / a), size, dtype, ctx)
