"""The ``linalg_*`` and ``sample_*`` families against the JAX reference,
on the CPU.

``linalg_*``: one case per name and option that changes the math; the
same inputs, made with numpy from a seed, go through ``tpu_mx.nd`` and
``tpu_mx_torch.nd``, forward and (under ``autograd.record()``, one
random head gradient) gradient.  Tolerances: 1e-5 relative (to the
output's largest entry) for the products, packers and gathers, 1e-4 for
the solvers, on well-conditioned inputs (SPD as A·Aᵀ + n·I, triangular
factors with a dominant diagonal).  ``syevd``'s eigenvectors are each
defined up to sign, and the two packages' LAPACK calls may pick either:
its rows are compared after each is signed so that its largest entry is
positive, and its gradient through a sign-free function of them
(``U∘U``, the eigenvalues).

``sample_*``: jax's key stream cannot be reproduced, so the samplers are
held by shape and dtype (against the reference's output), support, and
each mean within 5 standard errors of the distribution's (2**15 draws).
"""
import math

import numpy as np
import pytest
import torch

from tpu_mx import autograd as jag
from tpu_mx import nd as jnd

import tpu_mx_torch as mx
from tpu_mx_torch import autograd, nd

RTOL = 1e-5
SOLVER_RTOL = 1e-4


@pytest.fixture(autouse=True)
def _host():
    with mx.cpu():
        yield


def _normal(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _spd(b, n, seed=0):
    a = np.random.RandomState(seed).randn(b, n, n)
    return (a @ a.transpose(0, 2, 1) + n * np.eye(n)).astype(np.float32)


def _tri(b, n, seed=0, lower=True):
    """A well-conditioned triangular factor (the other triangle random,
    which the operators must not read)."""
    a = _normal(b, n, n, seed=seed) * 0.3
    a += np.eye(n, dtype=np.float32) * (2.0 + np.arange(n))
    return a


def _sym(b, n, seed=0):
    a = _normal(b, n, n, seed=seed)
    return ((a + a.transpose(0, 2, 1)) / 2).astype(np.float32)


def _outs(out):
    outs = out if isinstance(out, (list, tuple)) else [out]
    return [o.asnumpy() for o in outs]


def _run(ndm, ag, name, args, kw, grad, post=None):
    arrs = [ndm.array(a) for a in args]
    for i in grad:
        arrs[i].attach_grad()
    with ag.record():
        out = getattr(ndm, name)(*arrs, **kw)
        if post is not None:
            out = post(ndm, out)
    outs = out if isinstance(out, (list, tuple)) else [out]
    if grad:
        heads = [ndm.array(_normal(*o.shape, seed=7 + j))
                 for j, o in enumerate(outs)]
        ag.backward(outs, heads)
    return _outs(out), [arrs[i].grad.asnumpy() for i in grad]


def _same(got, want, rtol, what):
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    w = want.astype(np.float64)
    scale = max(np.abs(w).max(), 1e-30) if w.size else 1.0
    np.testing.assert_allclose(got.astype(np.float64), w, rtol=rtol,
                               atol=rtol * scale, err_msg=what)


def _sign_rows(ndm, out):
    """syevd's ``(U, λ)`` → ``(U∘U, λ)``: free of each row's sign."""
    u, lam = out
    return [u * u, lam]


B, N = 3, 5
A_TRI = _tri(B, N)
A_TRI_U = np.ascontiguousarray(A_TRI.transpose(0, 2, 1))
RHS = _normal(B, N, 4, seed=1)
RHS_R = _normal(B, 4, N, seed=2)
SPD = _spd(B, N)
VEC = _normal(B, 4, seed=3)
MAT = _normal(B, 4, 4, seed=4)
WIDE = _normal(B, 3, 6, seed=5)
POS_DIAG = np.abs(_normal(B, N, N, seed=6)) + 0.5

CASES = [
    # (id, name, args, kw, differentiable inputs, rtol)
    ("trsm", "linalg_trsm", [A_TRI, RHS], {}, (0, 1), SOLVER_RTOL),
    ("trsm-transpose-alpha", "linalg_trsm", [A_TRI, RHS],
     dict(transpose=True, alpha=2.5), (0, 1), SOLVER_RTOL),
    ("trsm-rightside", "linalg_trsm", [A_TRI, RHS_R],
     dict(rightside=True), (0, 1), SOLVER_RTOL),
    ("trsm-upper-rightside-transpose", "linalg_trsm", [A_TRI_U, RHS_R],
     dict(rightside=True, transpose=True, lower=False, alpha=-0.5), (0, 1),
     SOLVER_RTOL),
    ("trmm", "linalg_trmm", [A_TRI, RHS], {}, (0, 1), RTOL),
    ("trmm-upper-transpose-rightside", "linalg_trmm", [A_TRI, RHS_R],
     dict(lower=False, transpose=True, rightside=True, alpha=0.5), (0, 1),
     RTOL),
    ("det", "linalg_det", [SPD / 5], {}, (0,), SOLVER_RTOL),
    ("slogdet", "linalg_slogdet", [MAT], {}, (0,), SOLVER_RTOL),
    ("inverse", "linalg_inverse", [SPD], {}, (0,), SOLVER_RTOL),
    ("potri", "linalg_potri", [A_TRI], {}, (0,), SOLVER_RTOL),
    ("potri-upper", "linalg_potri", [A_TRI_U], dict(lower=False), (0,),
     SOLVER_RTOL),
    ("makediag", "linalg_makediag", [VEC], {}, (0,), RTOL),
    ("makediag-offset", "linalg_makediag", [VEC], dict(offset=2), (0,),
     RTOL),
    ("makediag-negative-offset", "linalg_makediag", [VEC],
     dict(offset=-1), (0,), RTOL),
    ("extractdiag", "linalg_extractdiag", [MAT], {}, (0,), RTOL),
    ("extractdiag-offset", "linalg_extractdiag", [MAT], dict(offset=-2),
     (0,), RTOL),
    ("maketrian", "linalg_maketrian", [_normal(B, 10, seed=8)], {}, (0,),
     RTOL),
    ("maketrian-upper", "linalg_maketrian", [_normal(B, 10, seed=8)],
     dict(lower=False), (0,), RTOL),
    ("maketrian-offset", "linalg_maketrian", [_normal(B, 6, seed=9)],
     dict(offset=1), (0,), RTOL),
    ("maketrian-upper-offset", "linalg_maketrian", [_normal(B, 6, seed=9)],
     dict(offset=2, lower=False), (0,), RTOL),
    ("extracttrian", "linalg_extracttrian", [MAT], {}, (0,), RTOL),
    ("extracttrian-upper", "linalg_extracttrian", [MAT], dict(lower=False),
     (0,), RTOL),
    ("extracttrian-offset", "linalg_extracttrian", [MAT], dict(offset=1),
     (0,), RTOL),
    ("extracttrian-upper-offset", "linalg_extracttrian", [MAT],
     dict(offset=1, lower=False), (0,), RTOL),
    ("gelqf", "linalg_gelqf", [WIDE], {}, (0,), SOLVER_RTOL),
    ("sumlogdiag", "linalg_sumlogdiag", [POS_DIAG], {}, (0,), RTOL),
]


@pytest.mark.parametrize("cid,name,args,kw,grad,rtol", CASES,
                         ids=[c[0] for c in CASES])
def test_linalg_operator_matches_the_reference(cid, name, args, kw, grad,
                                               rtol):
    want, want_g = _run(jnd, jag, name, args, kw, grad)
    got, got_g = _run(nd, autograd, name, args, kw, grad)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        _same(g, w, rtol, f"{cid} output {i}")
    for i, (g, w) in zip(grad, zip(got_g, want_g)):
        _same(g, w, rtol, f"{cid} gradient {i}")


def test_syevd_matches_the_reference_up_to_each_rows_sign():
    a = _sym(B, N, seed=10)
    want, want_g = _run(jnd, jag, "linalg_syevd", [a], {}, (0,), _sign_rows)
    got, got_g = _run(nd, autograd, "linalg_syevd", [a], {}, (0,),
                      _sign_rows)
    for g, w, what in zip(got + got_g, want + want_g,
                          ("U∘U", "λ", "gradient")):
        _same(g, w, SOLVER_RTOL, what)
    u, lam = [o.asnumpy() for o in nd.linalg_syevd(nd.array(a))]
    assert (np.diff(lam, axis=-1) > 0).all()              # ascending
    # rows are the eigenvectors: A = Uᵀ diag(λ) U
    np.testing.assert_allclose(
        u.transpose(0, 2, 1) @ (lam[..., None] * u), a, atol=1e-5)


def test_gelqf_factors_have_the_references_signs():
    low, q = [o.asnumpy() for o in nd.linalg_gelqf(nd.array(WIDE))]
    assert (np.diagonal(low, axis1=-2, axis2=-1) >= 0).all()
    np.testing.assert_allclose(low @ q, WIDE, atol=1e-5)
    np.testing.assert_allclose(q @ q.transpose(0, 2, 1),
                               np.broadcast_to(np.eye(3), (B, 3, 3)),
                               atol=1e-5)


def test_potri_is_the_inverse_of_the_cholesky_product():
    low = np.tril(A_TRI)
    got = nd.linalg_potri(nd.array(A_TRI)).asnumpy()
    np.testing.assert_allclose(got, np.linalg.inv(low @ low.transpose(0, 2, 1)),
                               rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("name,args", [
    ("linalg_inverse", [SPD]), ("linalg_potri", [A_TRI]),
    ("linalg_trsm", [A_TRI, RHS]), ("linalg_gelqf", [WIDE])])
def test_16_bit_inputs_are_solved_in_float32_and_cast_back(name, args):
    got = getattr(nd, name)(*[torch.from_numpy(a).bfloat16()
                              for a in args])
    want = getattr(nd, name)(*[torch.from_numpy(a).bfloat16().float()
                               for a in args])
    for g, w in zip(got if isinstance(got, tuple) else [got],
                    want if isinstance(want, tuple) else [want]):
        assert g.dtype == torch.bfloat16
        torch.testing.assert_close(g, w.bfloat16(), rtol=0, atol=0)


def test_linalg_operators_take_tensors_and_give_tensors():
    out = nd.linalg_det(torch.from_numpy(SPD))
    assert isinstance(out, torch.Tensor) and out.shape == (B,)


# -- samplers -----------------------------------------------------------------
N_DRAWS = 1 << 15


def _mean_within(d, mean, var):
    se = math.sqrt(var / d.size)
    assert abs(d.mean() - mean) < 5 * se, (d.mean(), mean, se)


P1 = np.asarray([0.5, 2.0, 4.0], np.float32)
P2 = np.asarray([[1.0], [3.0]], np.float32)          # broadcasts against P1

SAMPLERS = [
    # name, params, mean(p...), var(p...), support
    ("sample_uniform", (P1 - 3, P1), lambda lo, hi: (lo + hi) / 2,
     lambda lo, hi: (hi - lo) ** 2 / 12,
     lambda d, lo, hi: ((d >= lo) & (d < hi)).all()),
    ("sample_normal", (P1, P2), lambda m, s: m, lambda m, s: s * s,
     lambda d, *p: np.isfinite(d).all()),
    ("sample_gamma", (P1, P2), lambda a, b: a * b, lambda a, b: a * b * b,
     lambda d, *p: (d > 0).all()),
    ("sample_exponential", (P1,), lambda lam: 1 / lam,
     lambda lam: 1 / lam ** 2, lambda d, *p: (d >= 0).all()),
    ("sample_poisson", (P1,), lambda lam: lam, lambda lam: lam,
     lambda d, *p: ((d >= 0) & (d == np.round(d))).all()),
    ("sample_negative_binomial", (P1 + 1, np.float32(0.4) + 0 * P2),
     lambda k, p: k * (1 - p) / p, lambda k, p: k * (1 - p) / p ** 2,
     lambda d, *p: ((d >= 0) & (d == np.round(d))).all()),
    ("sample_generalized_negative_binomial", (P1, P2 / 4),
     lambda mu, a: mu, lambda mu, a: mu + a * mu * mu,
     lambda d, *p: ((d >= 0) & (d == np.round(d))).all()),
]


@pytest.mark.parametrize("name,params,mean,var,support", SAMPLERS,
                         ids=[s[0] for s in SAMPLERS])
def test_sampler_shape_dtype_support_and_mean(name, params, mean, var,
                                             support):
    for shape in (None, 3, (2, 4)):
        want = getattr(jnd, name)(*[jnd.array(p) for p in params],
                                  shape=shape)
        got = getattr(nd, name)(*[nd.array(p) for p in params], shape=shape)
        assert got.shape == want.shape, (shape, got.shape, want.shape)
        assert str(got.dtype) == str(want.dtype) == "float32"
    assert getattr(nd, name)(*[nd.array(p) for p in params], shape=2,
                             dtype="float16").dtype == np.float16
    mx.random.seed(13)
    d = getattr(nd, name)(*[nd.array(p) for p in params],
                          shape=N_DRAWS).asnumpy().astype(np.float64)
    ps = np.broadcast_arrays(*[p.astype(np.float64) for p in params])
    for idx in np.ndindex(ps[0].shape):
        pv = [p[idx] for p in ps]
        assert support(d[idx], *pv), (idx, pv)
        _mean_within(d[idx], mean(*pv), var(*pv))


def test_samplers_take_scalars_and_record_no_gradient():
    assert nd.sample_normal(0.0, 1.0, shape=(3,)).shape == (3,)
    a = nd.array(P1)
    a.attach_grad()
    with autograd.record():
        y = nd.sample_gamma(a, a, shape=4)
    assert y.shape == (3, 4)
    assert not y._data.requires_grad


@pytest.mark.parametrize("name,kw,mean,var", [
    ("random_negative_binomial", dict(k=3, p=0.4), 4.5, 11.25),
    ("random_generalized_negative_binomial", dict(mu=2.0, alpha=0.5), 2.0,
     4.0)])
def test_random_negative_binomials(name, kw, mean, var):
    want = getattr(jnd, name)(shape=(4, 5), **kw)
    got = getattr(nd, name)(shape=(4, 5), **kw)
    assert got.shape == want.shape and str(got.dtype) == str(want.dtype)
    assert got.context == mx.cpu()
    mx.random.seed(17)
    d = getattr(nd, name)(shape=(N_DRAWS,), **kw).asnumpy().astype(
        np.float64)
    assert ((d >= 0) & (d == np.round(d))).all()
    _mean_within(d, mean, var)
    # the defaults: p = 1 gives no failures at all
    assert (nd.random_negative_binomial(shape=(8,)).asnumpy() == 0).all()
