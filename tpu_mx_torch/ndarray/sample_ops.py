"""The per-element samplers of ``tpu_mx/ndarray/sample_ops.py``
(``nd.sample_*``, the reference's multisample family) and the two
negative-binomial ``nd.random_*`` draws.

Each distribution parameter is a tensor (or a number); the parameters
are broadcast together and every element draws ``shape`` values with
its own parameters, so the output is the parameters' shape followed by
``shape`` (the draws on the trailing axes).  The draws come from the
port's generator for the parameters' device (:mod:`tpu_mx_torch.random`),
in float32, and are cast to ``dtype``; they carry no gradient.  The
gamma and Poisson draws are PyTorch's (``torch._standard_gamma``,
``torch.poisson``), and the negative binomials their gamma–Poisson
mixtures, as in the reference.  The two packages' streams differ, so
the draws match the reference's in distribution, not bit for bit.
"""
from __future__ import annotations

import torch

from .. import random as _random
from .ndarray import _torch_dtype
from .ops import _dev, _op, _place

__all__ = ["sample_uniform", "sample_normal", "sample_gamma",
           "sample_exponential", "sample_poisson",
           "sample_negative_binomial", "sample_generalized_negative_binomial",
           "random_negative_binomial",
           "random_generalized_negative_binomial"]


def _extra_shape(shape):
    if shape is None:
        return ()
    if isinstance(shape, int):
        return (shape,)
    return tuple(shape)


@torch.no_grad()
def _sampled(draw, params, shape, dtype):
    """``draw(generator, params, full_shape)`` on the parameters,
    broadcast together and given ``len(shape)`` trailing axes; the draws
    cast to ``dtype``."""
    dev = next((p.device for p in params if isinstance(p, torch.Tensor)),
               None) or _dev(None)
    ps = [p.detach().float() if isinstance(p, torch.Tensor)
          else torch.tensor(float(p), device=dev) for p in params]
    ps = torch.broadcast_tensors(*ps)
    extra = _extra_shape(shape)
    full = tuple(ps[0].shape) + extra
    ps = [p.reshape(tuple(p.shape) + (1,) * len(extra)).expand(full)
          for p in ps]
    out = draw(_random.generator(dev), ps, full)
    return out.to(_torch_dtype(dtype))


def _gamma(gen, alpha):
    return torch._standard_gamma(alpha.contiguous(), generator=gen)


def _poisson(gen, lam):
    return torch.poisson(lam.contiguous(), generator=gen)


def sample_uniform(low, high, shape=None, dtype="float32", **kw):
    return _sampled(lambda g, ps, s: torch.rand(
        s, generator=g, device=g.device) * (ps[1] - ps[0]) + ps[0],
        (low, high), shape, dtype)


def sample_normal(mu, sigma, shape=None, dtype="float32", **kw):
    return _sampled(lambda g, ps, s: ps[0] + ps[1] * torch.randn(
        s, generator=g, device=g.device), (mu, sigma), shape, dtype)


def sample_gamma(alpha, beta, shape=None, dtype="float32", **kw):
    """Gamma with shape ``alpha`` and scale ``beta``."""
    return _sampled(lambda g, ps, s: _gamma(g, ps[0]) * ps[1],
                    (alpha, beta), shape, dtype)


def sample_exponential(lam, shape=None, dtype="float32", **kw):
    """Exponential with rate ``lam``."""
    return _sampled(lambda g, ps, s: torch.empty(
        s, device=g.device).exponential_(1.0, generator=g) / ps[0],
        (lam,), shape, dtype)


def sample_poisson(lam, shape=None, dtype="float32", **kw):
    return _sampled(lambda g, ps, s: _poisson(g, ps[0]), (lam,), shape,
                    dtype)


def _negbin(gen, k, p):
    """NB(k successes, success probability p) as the reference draws it:
    ``λ ~ Gamma(k, (1-p)/p)``, ``X ~ Poisson(λ)``."""
    return _poisson(gen, _gamma(gen, k) * (1.0 - p) / p)


def _gen_negbin(gen, mu, alpha):
    """The mean/dispersion form: ``λ ~ Gamma(1/alpha, alpha·mu)``."""
    return _poisson(gen, _gamma(gen, 1.0 / alpha) * (alpha * mu))


def sample_negative_binomial(k, p, shape=None, dtype="float32", **kw):
    return _sampled(lambda g, ps, s: _negbin(g, ps[0], ps[1]), (k, p),
                    shape, dtype)


def sample_generalized_negative_binomial(mu, alpha, shape=None,
                                         dtype="float32", **kw):
    return _sampled(lambda g, ps, s: _gen_negbin(g, ps[0], ps[1]),
                    (mu, alpha), shape, dtype)


def _scalar_draw(fn, a, b, shape, dtype, ctx):
    dev = _dev(ctx)
    s = tuple(shape) if shape else ()
    full = lambda v: torch.full(s, float(v), device=dev)  # noqa: E731
    with torch.no_grad():
        out = fn(_random.generator(dev), full(a), full(b))
    return _place(out.to(_torch_dtype(dtype)))


def random_negative_binomial(k=1, p=1.0, shape=(1,), dtype="float32",
                             ctx=None, **kw):
    """``shape`` negative-binomial draws on ``ctx`` (default: the current
    context)."""
    return _scalar_draw(_negbin, k, p, shape, dtype, ctx)


def random_generalized_negative_binomial(mu=1.0, alpha=1.0, shape=(1,),
                                         dtype="float32", ctx=None, **kw):
    return _scalar_draw(_gen_negbin, mu, alpha, shape, dtype, ctx)


# the per-element samplers take arrays (arrays out); the two creation
# draws place their results themselves
for _name in __all__[:7]:
    globals()[_name] = _op(globals()[_name])
del _name
