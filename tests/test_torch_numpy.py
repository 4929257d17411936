"""``mx.np`` (``np``, ``np.fft``, ``np.linalg``, ``np.random``) and
``mx.npx`` against the JAX reference, on the CPU.

Each routine of the reference's lists is a parametrised case: the same
inputs, made with numpy from a seed, go through ``tpu_mx.np`` and
``tpu_mx_torch.np`` as arrays; every output is held to the reference's
(float32 within 1e-5 of the output's largest entry, 1e-4 for the
solvers and the FFTs; integer and boolean outputs by value, since the
port keeps int64 where the reference, without x64, has int32) and,
where the routine has a float output, so is the gradient of every float
input under ``autograd.record()`` from one random head gradient.  The
inputs keep entries apart (no ties), so sorts, medians and extrema have
one gradient.  Decompositions whose factors are defined up to sign or
order (``eig``, ``eigh``, ``svd``) are compared by their sign-free
products.  ``np.random`` is held by shape, dtype, support and each mean
within 5 standard errors (2**15 draws), since jax's key stream cannot
be reproduced.  ``np.frexp`` is held to numpy (edge values bit for
bit), not to the reference, whose own tests of it fail under jax 0.9.
"""
import ast
import inspect
import math
import pathlib
import re

import numpy as np
import pytest
import torch

import tpu_mx as jmx
from tpu_mx import autograd as jag

import tpu_mx_torch as mx
from tpu_mx_torch import autograd

jnp_ = jmx.np
pnp = mx.np
RTOL = 1e-5
SOLVER_RTOL = 1e-4
REF = pathlib.Path(jmx.__file__).parent / "numpy"


def _ref_list(module, name="_WRAPPED"):
    src = (REF / module).read_text()
    m = re.search(name + r" = \[(.*?)\]", src, re.S)
    return ast.literal_eval("[" + m.group(1) + "]")


@pytest.fixture(autouse=True)
def _host():
    with mx.cpu():
        yield


def _rs(seed):
    return np.random.RandomState(seed)


def _normal(*shape, seed=0):
    return np.asarray(_rs(seed).randn(*shape), np.float32)


def _distinct(*shape, seed=0):
    """Normal entries, all far apart (no ties for sorts and extrema)."""
    n = int(np.prod(shape))
    v = (_rs(seed).permutation(n) - n / 2) / (n / 4)
    return (v + _rs(seed + 1).uniform(-0.05, 0.05, n)).astype(
        np.float32).reshape(shape)


A = _distinct(3, 4, seed=0)
B = _distinct(3, 4, seed=10)
P = (np.abs(_normal(3, 4, seed=2)) + 0.5).astype(np.float32)
U = _rs(3).uniform(-0.9, 0.9, (3, 4)).astype(np.float32)
I1 = _rs(4).randint(1, 9, (3, 4))
I2 = _rs(5).randint(1, 9, (3, 4))
V = _distinct(6, seed=6)
V2 = _distinct(6, seed=16)
M = (_normal(4, 4, seed=7) + 4 * np.eye(4)).astype(np.float32)
A3 = _distinct(2, 3, 4, seed=8)
B3 = _distinct(3, 4, 5, seed=9)
ANAN = A.copy()
ANAN[0, 1] = ANAN[2, 3] = np.nan
AINF = A.copy()
AINF[1, 2], AINF[0, 0], AINF[2, 1] = np.inf, -np.inf, np.nan

# name -> [(id, args, kwargs)]; lists of arrays stay lists
CASES = {
    "abs": [((A,), {})], "absolute": [((A,), {})],
    "add": [((A, B), {}), ((A, 2.5), {})],
    "all": [((A > -1.5,), {}), ((A > 0,), dict(axis=1))],
    "allclose": [((A, A + 1e-7), {}), ((A, B), {})],
    "amax": [((A,), dict(axis=1))], "amin": [((A,), dict(axis=0))],
    "any": [((A > 1.5,), dict(axis=0))],
    "append": [((A, B), dict(axis=0)), ((V, A), {})],
    "arccos": [((U,), {})], "arccosh": [((P + 1,), {})],
    "arcsin": [((U,), {})], "arcsinh": [((A,), {})],
    "arctan": [((A,), {})], "arctan2": [((A, B), {})],
    "arctanh": [((U,), {})],
    "argmax": [((A,), dict(axis=1)), ((A,), {})],
    "argmin": [((A,), dict(axis=0))],
    "argsort": [((A,), {}), ((A,), dict(axis=0))],
    "around": [((A * 10,), dict(decimals=1))],
    "array_split": [((V, 4), {})],
    "atleast_1d": [((np.float32(3.0),), {})],
    "atleast_2d": [((V,), {})], "atleast_3d": [((A,), {})],
    "average": [((A,), dict(axis=1, weights=np.asarray(
        [1, 2, 3, 4], np.float32))), ((A,), {})],
    "bincount": [((I1.ravel(),), dict(minlength=12))],
    "bitwise_and": [((I1, I2), {})], "bitwise_or": [((I1, I2), {})],
    "bitwise_xor": [((I1, I2), {})],
    "broadcast_arrays": [((V[:4], A), {})],
    "broadcast_to": [((V[:4], (3, 4)), {})],
    "cbrt": [((A,), {})], "ceil": [((A * 3,), {})],
    "clip": [((A, -0.5, 0.7), {})],
    "column_stack": [(([V, V2],), {})],
    "concatenate": [(([A, B],), dict(axis=1)), (([A, B],), {})],
    "copysign": [((A, B), {})], "cos": [((A,), {})], "cosh": [((A,), {})],
    "cross": [((A[:, :3], B[:, :3]), {})],
    "cumprod": [((P,), dict(axis=1))], "cumsum": [((A,), {})],
    "deg2rad": [((A,), {})], "degrees": [((A,), {})],
    "delete": [((A, 1), dict(axis=1)), ((V, np.asarray([0, 2])), {})],
    "diag": [((M,), dict(k=1)), ((V,), {})],
    "diagflat": [((V[:3],), dict(k=-1))],
    "diagonal": [((A3,), dict(offset=1, axis1=1, axis2=2))],
    "diff": [((A,), {}), ((A,), dict(n=2, axis=0))],
    "divide": [((A, P), {})], "divmod": [((A * 5, P), {})],
    "dot": [((A, B.T), {}), ((A3, V[:4]), {}), ((A3, B3), {})],
    "dsplit": [((A3, 2), {})],
    "dstack": [(([A, B],), {})],
    "ediff1d": [((A,), dict(to_end=np.float32(9.0),
                            to_begin=np.asarray([1, 2], np.float32)))],
    "einsum": [(("ij,kj->ik", A, B), {})],
    "equal": [((I1, I2), {})], "exp": [((A,), {})], "exp2": [((A,), {})],
    "expand_dims": [((A, 1), {}), ((A, (0, 3)), {})],
    "expm1": [((A,), {})],
    "flatnonzero": [((A > 0,), {})],
    "flip": [((A,), dict(axis=1)), ((A,), {})],
    "fliplr": [((A,), {})], "flipud": [((A,), {})],
    "floor": [((A * 3,), {})], "floor_divide": [((A * 5, P), {})],
    "fmax": [((ANAN, B), {})], "fmin": [((ANAN, B), {})],
    "fmod": [((A * 5, P), {})], "gcd": [((I1, I2), {})],
    "greater": [((A, B), {})], "greater_equal": [((I1, I2), {})],
    "histogram": [((V,), dict(bins=4, range=(-2.0, 2.0))),
                  ((A,), dict(bins=3))],
    "hsplit": [((A, 2), {})], "hstack": [(([A, B],), {})],
    "hypot": [((A, B), {})], "inner": [((A, B), {})],
    "insert": [((V, 2, 9.0), {}), ((A, 1, np.float32(5.0)), dict(axis=1))],
    "interp": [((np.asarray([-3, -0.5, 0.2, 1.0, 3.5, 9], np.float32),
                 np.asarray([-1, 0, 1, 2, 4], np.float32),
                 np.asarray([3, 1, 4, 1, 5], np.float32)), {})],
    "invert": [((I1,), {})],
    "isclose": [((A, A + 1e-3 * (A > 0)), {})],
    "isfinite": [((AINF,), {})], "isinf": [((AINF,), {})],
    "isnan": [((AINF,), {})], "isneginf": [((AINF,), {})],
    "isposinf": [((AINF,), {})],
    "kron": [((A[:2, :2], B[:2, :3]), {})], "lcm": [((I1, I2), {})],
    "ldexp": [((A, I1), {})],
    "less": [((A, B), {})], "less_equal": [((I1, I2), {})],
    "log": [((P,), {})], "log10": [((P,), {})], "log1p": [((P,), {})],
    "log2": [((P,), {})], "logaddexp": [((A, B), {})],
    "logaddexp2": [((A, B), {})],
    "logical_and": [((A > 0, B > 0), {})], "logical_not": [((A > 0,), {})],
    "logical_or": [((A > 0, B > 0), {})],
    "logical_xor": [((A > 0, B > 0), {})],
    "matmul": [((A, B.T), {}), ((A3, _distinct(2, 4, 5, seed=11)), {})],
    "max": [((A,), {}), ((A,), dict(axis=1, keepdims=True))],
    "maximum": [((A, B), {})],
    "mean": [((A,), dict(axis=0)), ((I1,), {})],
    "median": [((A,), dict(axis=1)), ((A,), {})],
    "meshgrid": [((V[:3], V2[:4]), {}), ((V[:3], V2[:4]),
                                         dict(indexing="ij"))],
    "min": [((A,), dict(axis=0))], "minimum": [((A, B), {})],
    "mod": [((A * 5, P), {})],
    "moveaxis": [((A3, 0, -1), {})], "multiply": [((A, B), {})],
    "nan_to_num": [((AINF,), {})],
    "nanmax": [((ANAN,), dict(axis=1))], "nanmean": [((ANAN,), {})],
    "nanmin": [((ANAN,), dict(axis=0))], "nansum": [((ANAN,), dict(axis=1))],
    "negative": [((A,), {})],
    "nonzero": [((A > 0,), {})],
    "not_equal": [((I1, I2), {})],
    "outer": [((V, V2), {})],
    "pad": [((A, ((1, 2), (0, 1))), {}),
            ((A, 1), dict(mode="constant", constant_values=2.5)),
            ((A, ((1, 1), (2, 0))), dict(mode="edge")),
            ((A, ((2, 1), (1, 2))), dict(mode="reflect"))],
    "percentile": [((A, 30.0), dict(axis=1))],
    "polyval": [((np.asarray([2, -1, 0.5], np.float32), V), {})],
    "power": [((P, B), {})],
    "prod": [((P,), dict(axis=1)), ((P,), {})],
    "ptp": [((A,), dict(axis=1))],
    "quantile": [((A, 0.3), {}), ((A, 0.75), dict(axis=0))],
    "rad2deg": [((A,), {})], "radians": [((A,), {})],
    "ravel": [((A,), {})], "reciprocal": [((P,), {})],
    "remainder": [((A * 5, P), {})],
    "repeat": [((A, 2), dict(axis=1)), ((A, 2), {})],
    "reshape": [((A, (2, 6)), {}), ((A, (-1, 3)), {})],
    "resize": [((V, (2, 5)), {})],
    "roll": [((A, 2), dict(axis=1)), ((A, -3), {})],
    "rot90": [((A,), {}), ((A3,), dict(k=2, axes=(1, 2)))],
    "searchsorted": [((np.sort(V), V2), {}),
                     ((np.sort(V), V2), dict(side="right"))],
    "sign": [((A,), {})], "sin": [((A,), {})], "sinh": [((A,), {})],
    "sort": [((A,), {}), ((A,), dict(axis=0))],
    "split": [((A, 2), dict(axis=1)), ((V, [1, 4]), {})],
    "sqrt": [((P,), {})], "square": [((A,), {})],
    "squeeze": [((A[None, :, None],), {}), ((A[None],), dict(axis=0))],
    "stack": [(([A, B],), dict(axis=1))],
    "std": [((A,), dict(axis=1)), ((A,), dict(ddof=1))],
    "subtract": [((A, B), {})],
    "sum": [((A,), dict(axis=1)), ((I1,), {})],
    "swapaxes": [((A3, 0, 2), {})],
    "take": [((A, np.asarray([[0, 2], [3, 1]])), dict(axis=1)),
             ((A, np.asarray([1, -1, 5])), {})],
    "take_along_axis": [((A, np.argsort(B, axis=1)[:, :2], 1), {})],
    "tan": [((U,), {})], "tanh": [((A,), {})],
    "tensordot": [((A3, B3), dict(axes=2)),
                  ((A3, B3), dict(axes=([1], [0])))],
    "tile": [((V, 2), {}), ((A, (2, 1)), {})],
    "trace": [((M,), {})],
    "transpose": [((A3,), dict(axes=(2, 0, 1))), ((A,), {})],
    "tril": [((M,), dict(k=-1))], "triu": [((M,), {})],
    "true_divide": [((A, P), {})], "trunc": [((A * 3,), {})],
    "unique": [((I1,), {}),
               ((I1,), dict(return_index=True, return_inverse=True,
                            return_counts=True))],
    "unravel_index": [((np.asarray([0, 5, 11]), (3, 4)), {})],
    "vander": [((V[:4],), dict(N=3))],
    "var": [((A,), dict(axis=0))],
    "vdot": [((A, B), {})],
    "vsplit": [((M, 2), {})], "vstack": [(([A, B],), {})],
    "where": [((A > 0, A, B), {}), ((A > 0,), {})],
}


def _flat_cases():
    out = []
    for name, cases in sorted(CASES.items()):
        for i, (args, kw) in enumerate(cases):
            out.append(pytest.param(name, args, kw, id=f"{name}-{i}"))
    return out


def _make(ndmod, a):
    if isinstance(a, np.ndarray) or isinstance(a, np.generic):
        return ndmod.array(np.asarray(a))
    if isinstance(a, list) and a and isinstance(a[0], np.ndarray):
        return [ndmod.array(x) for x in a]
    return a


def _floats(arrs):
    for a in arrs:
        for x in (a if isinstance(a, list) else [a]):
            if hasattr(x, "attach_grad") and np.dtype(x.dtype).kind == "f":
                yield x


def _outs(out):
    return list(out) if isinstance(out, (list, tuple)) else [out]


def _call(pkg, ag, fn, args, kw, grad):
    arrs = [_make(pkg.np, a) for a in args]
    leaves = list(_floats(arrs)) if grad else []
    for x in leaves:
        x.attach_grad()
    with ag.record():
        out = getattr(pkg.np, fn)(*arrs, **kw) if isinstance(fn, str) \
            else fn(pkg.np, *arrs, **kw)
    outs = _outs(out)
    heads = [(o, pkg.np.array(_normal(*o.shape, seed=30 + j)))
             for j, o in enumerate(outs)
             if hasattr(o, "asnumpy") and np.dtype(o.dtype).kind == "f"]
    if leaves and heads:
        ag.backward([h[0] for h in heads], [h[1] for h in heads])
    grads = [x.grad.asnumpy() for x in leaves] if leaves and heads else []
    return [o.asnumpy() if hasattr(o, "asnumpy") else np.asarray(o)
            for o in outs], grads


def _same(got, want, rtol, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if want.dtype.kind in "iub":
        assert got.dtype.kind == want.dtype.kind, (what, got.dtype,
                                                   want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=what)
        return
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    w = want.astype(np.complex128 if want.dtype.kind == "c" else np.float64)
    fin = np.isfinite(w)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want),
                                  err_msg=what)
    np.testing.assert_array_equal(got[~fin & ~np.isnan(want)],
                                  want[~fin & ~np.isnan(want)], err_msg=what)
    scale = max(np.abs(w[fin]).max(), 1e-30) if fin.any() else 1.0
    np.testing.assert_allclose(got[fin], w[fin], rtol=rtol,
                               atol=rtol * scale, err_msg=what)


def _compare(fn, args, kw, rtol=RTOL, grad=True):
    want, want_g = _call(jmx, jag, fn, args, kw, grad)
    got, got_g = _call(mx, autograd, fn, args, kw, grad)
    assert len(got) == len(want), (len(got), len(want))
    for i, (g, w) in enumerate(zip(got, want)):
        _same(g, w, rtol, f"output {i}")
    assert len(got_g) == len(want_g)
    for i, (g, w) in enumerate(zip(got_g, want_g)):
        _same(g, w, rtol, f"gradient {i}")


def test_the_routine_lists_are_the_references():
    assert pnp._WRAPPED == sorted(_ref_list("__init__.py"))
    assert pnp.fft._WRAPPED == _ref_list("fft.py")
    assert pnp.linalg._WRAPPED == sorted(_ref_list("linalg.py"))
    assert set(CASES) == set(pnp._WRAPPED)
    for mod, ref in ((pnp, jmx.np), (pnp.fft, jmx.np.fft),
                     (pnp.linalg, jmx.np.linalg),
                     (pnp.random, jmx.np.random), (mx.npx, jmx.npx)):
        public = {n for n, v in vars(ref).items() if not n.startswith("_")
                  and not inspect.ismodule(v)
                  and type(v).__module__ != "__future__"
                  and not inspect.isclass(v)}
        assert not public - set(dir(mod)), (mod.__name__,
                                            public - set(dir(mod)))


@pytest.mark.parametrize("name,args,kw", _flat_cases())
def test_np_routine_matches_the_reference(name, args, kw):
    _compare(name, args, kw)


@pytest.mark.parametrize("alias,target", [("round", "around"),
                                          ("concat", "concatenate"),
                                          ("fix", "trunc")])
def test_np_aliases(alias, target):
    assert getattr(pnp, alias) is getattr(pnp, target)
    arg = [A, B] if target == "concatenate" else A * 3
    _compare(alias, (arg,), {})


@pytest.mark.parametrize("fn,args,kw", [
    ("array", ([[1.0, 2.0], [3.0, 4.0]],), {}),
    ("array", ([1, 2, 3],), dict(dtype="float16")),
    ("zeros", ((2, 3),), {}), ("ones", ((3,),), dict(dtype="int32")),
    ("full", ((2, 2), 1.5), {}), ("full", ((2,), 7), {}),
    ("arange", (5,), {}), ("arange", (1.0, 3.0, 0.5), {}),
    ("linspace", (-1.0, 2.0, 7), {}),
    ("linspace", (0.0, 1.0, 4), dict(endpoint=False)),
    ("eye", (3,), dict(k=1)), ("eye", (2, 4), {}), ("identity", (3,), {}),
    ("logspace", (0.0, 2.0, 5), {}),
    ("indices", ((2, 3),), {}),
    ("empty", ((2, 2),), {}),
], ids=lambda v: v if isinstance(v, str) else None)
def test_np_creation_matches_the_reference(fn, args, kw):
    want = getattr(jnp_, fn)(*args, **kw)
    got = getattr(pnp, fn)(*args, **kw)
    _same(got.asnumpy(), want.asnumpy(), RTOL, fn)
    assert got.context == mx.cpu()


@pytest.mark.parametrize("fn", ["zeros_like", "ones_like", "full_like",
                                "empty_like"])
def test_np_like_creation(fn):
    extra = (2.5,) if fn == "full_like" else ()
    want = getattr(jnp_, fn)(jnp_.array(A), *extra)
    got = getattr(pnp, fn)(pnp.array(A), *extra)
    _same(got.asnumpy(), want.asnumpy(), RTOL, fn)
    got16 = getattr(pnp, fn)(pnp.array(A), *extra, dtype="float16")
    assert got16.dtype == np.float16


def test_np_default_float32_contract_and_helpers():
    assert pnp.array(np.arange(3.0)).dtype == np.float32
    assert pnp.array(np.arange(3)).dtype.kind == "i"
    assert pnp.mean(pnp.array(I1)).dtype == np.float32
    x = pnp.array(A)
    assert pnp.shape(x) == (3, 4) and pnp.ndim(x) == 2 and pnp.size(x) == 12
    assert pnp.may_share_memory(x, x) is False
    d = pnp.diag_indices(3)
    assert len(d) == 2 and (d[0].asnumpy() == [0, 1, 2]).all()
    for name in ("pi", "e", "inf", "nan", "euler_gamma", "newaxis",
                 "float32", "int64", "bool_"):
        a, b = getattr(pnp, name), getattr(jnp_, name)
        assert a == b or (a != a and b != b)
    assert pnp.ndarray is mx.nd.NDArray


def test_the_real_numpy_stays_reachable_inside_the_package():
    import numpy
    from tpu_mx_torch.ndarray import ndarray as nd_module
    assert nd_module.np is numpy
    assert pnp._onp is numpy and mx.np is pnp
    assert pnp.fft.torch is torch


def test_np_routines_take_tensors_inside_a_forward():
    out = pnp.sum(torch.from_numpy(A), axis=1)
    assert isinstance(out, torch.Tensor)
    np.testing.assert_allclose(out.numpy(), A.sum(1), rtol=1e-6)


# -- frexp, held to numpy ---------------------------------------------------------
EDGE = np.asarray([0.0, -0.0, 1.0, -1.5, 0.75, 3e38, 1e-40, -1e-45, 2.0 ** -126,
                   np.inf, -np.inf, np.nan, 12345.678], np.float32)


def test_frexp_is_numpys_bit_for_bit():
    m, e = pnp.frexp(pnp.array(EDGE))
    wm, we = np.frexp(EDGE)
    np.testing.assert_array_equal(m.asnumpy().view(np.int32),
                                  wm.view(np.int32))
    np.testing.assert_array_equal(e.asnumpy(), we)
    m2, e2 = pnp.frexp(pnp.array(A))
    np.testing.assert_array_equal(
        np.ldexp(m2.asnumpy(), e2.asnumpy()), A)


def test_frexp_mantissa_gradient_is_two_to_the_minus_exponent():
    x = pnp.array(EDGE)
    x.attach_grad()
    with autograd.record():
        m, e = pnp.frexp(x)
    m.backward(pnp.ones_like(m))
    _, we = np.frexp(EDGE)
    with np.errstate(over="ignore"):      # 2**148 of a subnormal is inf
        want = np.where(np.isfinite(EDGE), np.ldexp(np.ones_like(EDGE), -we),
                        0.0).astype(np.float32)
    np.testing.assert_array_equal(x.grad.asnumpy(), want)


# -- np.fft -------------------------------------------------------------------
C = (_normal(3, 8, seed=20) + 1j * _normal(3, 8, seed=21)).astype(np.complex64)
FFT_CASES = [
    ("fft", (A,), {}), ("fft", (A,), dict(n=6, axis=0)),
    ("ifft", (C,), {}), ("fft2", (A3,), {}), ("ifft2", (C,), {}),
    ("fftn", (A3,), dict(axes=(0, 2))), ("ifftn", (C,), {}),
    ("rfft", (A,), {}), ("irfft", (C,), dict(n=14)),
    ("rfft2", (A3,), {}), ("irfft2", (C,), {}),
    ("rfftn", (A3,), {}), ("irfftn", (C,), {}),
    ("hfft", (C,), {}), ("ihfft", (A,), {}),
    ("fftshift", (A,), {}), ("ifftshift", (A3,), dict(axes=1)),
]


@pytest.mark.parametrize("name,args,kw", FFT_CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(FFT_CASES)])
def test_np_fft_matches_the_reference(name, args, kw):
    def fn(npm, x, **k):
        return getattr(npm.fft, name)(x, **k)
    real_out = name in ("irfft", "irfft2", "irfftn", "hfft", "fftshift",
                        "ifftshift")
    _compare(fn, args, kw, SOLVER_RTOL, grad=real_out)


@pytest.mark.parametrize("name", ["fftfreq", "rfftfreq"])
def test_np_fft_frequencies(name):
    want = getattr(jnp_.fft, name)(8, 0.5).asnumpy()
    got = getattr(pnp.fft, name)(8, 0.5).asnumpy()
    _same(got, want, RTOL, name)


# -- np.linalg ----------------------------------------------------------------
SPD = (M @ M.T + 4 * np.eye(4)).astype(np.float32)
SYM = ((M + M.T) / 2).astype(np.float32)
TALL = _normal(5, 3, seed=22)
LINALG_CASES = [
    ("cholesky", (SPD,), {}), ("cond", (M,), {}), ("det", (M,), {}),
    ("eigvalsh", (SYM,), {}), ("inv", (M,), {}),
    ("matrix_power", (M / 4, 3), {}), ("matrix_rank", (M,), {}),
    # the reference takes raw arrays only (its wrapper does not flatten
    # a list of arrays), so both get numpy arrays and no gradient
    ("multi_dot", ((A, B.T, M[:3]),), {}),
    ("norm", (A,), {}), ("norm", (A,), dict(axis=1)),
    ("norm", (M,), dict(ord="fro")), ("pinv", (TALL,), {}),
    ("qr", (TALL,), {}), ("slogdet", (M,), {}),
    ("solve", (SPD, A[:, :4].T.copy()), {}),
    ("tensorinv", (np.ascontiguousarray((np.eye(6) * 2 + _normal(
        6, 6, seed=23) * 0.1).astype(np.float32).reshape(6, 2, 3)),),
     dict(ind=1)),
    ("tensorsolve", (np.ascontiguousarray((np.eye(6) * 2 + _normal(
        6, 6, seed=24) * 0.1).astype(np.float32).reshape(2, 3, 6)),
        _normal(2, 3, seed=25)), {}),
]


@pytest.mark.parametrize("name,args,kw", LINALG_CASES,
                         ids=[f"{c[0]}-{i}" for i, c in
                              enumerate(LINALG_CASES)])
def test_np_linalg_matches_the_reference(name, args, kw):
    def fn(npm, *a, **k):
        return getattr(npm.linalg, name)(*a, **k)
    # the reference cannot differentiate its named-tuple results (jax's
    # vjp rejects the tuple its tape hands back): qr and slogdet forward
    _compare(fn, args, kw, SOLVER_RTOL,
             grad=name not in ("matrix_rank", "qr", "slogdet"))


def test_np_linalg_decompositions_match_up_to_sign_and_order():
    def sign_free(npm):
        x = npm.array(M)
        s = npm.array(SYM)
        w, v = npm.linalg.eigh(s)
        u, sv, vh = npm.linalg.svd(npm.array(TALL), full_matrices=False)
        ev = npm.linalg.eigvals(x).asnumpy()
        ew, evec = npm.linalg.eig(x)
        lstsq = npm.linalg.lstsq(npm.array(TALL), npm.array(V[:5]))
        return dict(
            eigh_w=w.asnumpy(), eigh_vv=(v * v).asnumpy(),
            svd_s=sv.asnumpy(),
            svd_usv=npm.matmul(u * sv[None], vh).asnumpy(),
            eigvals=np.sort_complex(ev),
            eig_w=np.sort_complex(ew.asnumpy()),
            eig_residual=np.abs(M.astype(np.complex64) @ evec.asnumpy()
                                - evec.asnumpy() * ew.asnumpy()[None]).max(),
            lstsq_x=lstsq[0].asnumpy())
    want, got = sign_free(jnp_), sign_free(pnp)
    for k in want:
        if k == "eig_residual":
            assert got[k] < 1e-4
            continue
        _same(got[k], want[k], SOLVER_RTOL, k)


# -- np.random ----------------------------------------------------------------
N_DRAWS = 1 << 15
RANDOM = [
    ("uniform", dict(low=-1.0, high=3.0), 1.0, 16 / 12,
     lambda d: ((d >= -1) & (d < 3)).all(), "float32"),
    ("normal", dict(loc=2.0, scale=0.5), 2.0, 0.25, None, "float32"),
    ("randint", dict(low=3, high=10), 6.0, (49 - 1) / 12,
     lambda d: ((d >= 3) & (d < 10)).all(), "int32"),
    ("beta", dict(a=2.0, b=3.0), 0.4, 0.04,
     lambda d: ((d > 0) & (d < 1)).all(), "float32"),
    ("gamma", dict(shape=2.5, scale=2.0), 5.0, 10.0, lambda d: (d > 0).all(),
     "float32"),
    ("exponential", dict(scale=1.5), 1.5, 2.25, lambda d: (d >= 0).all(),
     "float32"),
    ("poisson", dict(lam=3.5), 3.5, 3.5, lambda d: (d >= 0).all(), "int32"),
    ("binomial", dict(n=10, p=0.3), 3.0, 2.1,
     lambda d: ((d >= 0) & (d <= 10)).all(), "int32"),
    ("chisquare", dict(df=3.0), 3.0, 6.0, lambda d: (d > 0).all(), "float32"),
    ("geometric", dict(p=0.25), 4.0, 12.0, lambda d: (d >= 1).all(),
     "int32"),
    ("gumbel", dict(loc=1.0, scale=2.0), 1.0 + 2.0 * np.euler_gamma,
     math.pi ** 2 / 6 * 4, None, "float32"),
    ("laplace", dict(loc=-1.0, scale=0.5), -1.0, 0.5, None, "float32"),
    ("logistic", dict(loc=0.5, scale=1.5), 0.5, math.pi ** 2 / 3 * 2.25,
     None, "float32"),
    ("lognormal", dict(mean=0.0, sigma=0.5), math.exp(0.125),
     (math.exp(0.25) - 1) * math.exp(0.25), lambda d: (d > 0).all(),
     "float32"),
    ("pareto", dict(a=5.0), 0.25, 5 / (16 * 3), lambda d: (d >= 0).all(),
     "float32"),
    ("power", dict(a=3.0), 0.75, 3 / 80, lambda d: ((d >= 0) & (d <= 1))
     .all(), "float32"),
    ("rayleigh", dict(scale=2.0), 2.0 * math.sqrt(math.pi / 2),
     (4 - math.pi) / 2 * 4, lambda d: (d >= 0).all(), "float32"),
    ("weibull", dict(a=2.0), math.gamma(1.5),
     math.gamma(2.0) - math.gamma(1.5) ** 2, lambda d: (d >= 0).all(),
     "float32"),
]


@pytest.mark.parametrize("name,kw,mean,var,support,dtype", RANDOM,
                         ids=[r[0] for r in RANDOM])
def test_np_random_shape_dtype_support_and_mean(name, kw, mean, var, support,
                                                dtype):
    want = getattr(jnp_.random, name)(size=(2, 3), **kw)
    got = getattr(pnp.random, name)(size=(2, 3), **kw)
    assert got.shape == want.shape == (2, 3)
    assert str(got.dtype) == str(want.dtype) == dtype
    assert got.context == mx.cpu()
    pnp.random.seed(21)
    d = getattr(pnp.random, name)(size=N_DRAWS, **kw).asnumpy().astype(
        np.float64)
    if support is not None:
        assert support(d)
    se = math.sqrt(var / N_DRAWS)
    assert abs(d.mean() - mean) < 5 * se, (d.mean(), mean, se)


def test_np_random_rest():
    pnp.random.seed(3)
    assert pnp.random.rand(2, 3).shape == jnp_.random.rand(2, 3).shape
    assert pnp.random.randn(4).shape == (4,)
    assert pnp.random.rand().shape == ()
    c = pnp.random.choice(5, size=(3, 4)).asnumpy()
    assert c.shape == (3, 4) and ((c >= 0) & (c < 5)).all()
    c = pnp.random.choice(pnp.array(V), size=6, replace=False).asnumpy()
    np.testing.assert_array_equal(np.sort(c), np.sort(V))
    d = pnp.random.choice(3, size=N_DRAWS, p=[0.2, 0.0, 0.8]).asnumpy()
    assert not (d == 1).any() and abs((d == 2).mean() - 0.8) < 0.02
    perm = pnp.random.permutation(10).asnumpy()
    np.testing.assert_array_equal(np.sort(perm), np.arange(10))
    rows = pnp.random.permutation(pnp.array(A)).asnumpy()
    np.testing.assert_array_equal(np.sort(rows[:, 0]), np.sort(A[:, 0]))
    x = pnp.array(A)
    pnp.random.shuffle(x)
    np.testing.assert_array_equal(np.sort(x.asnumpy(), 0), np.sort(A, 0))
    with pytest.raises(TypeError):
        pnp.random.shuffle(A)
    m = pnp.random.multinomial(20, [0.1, 0.6, 0.3], size=(4,)).asnumpy()
    want = jnp_.random.multinomial(20, [0.1, 0.6, 0.3], size=(4,))
    assert m.shape == want.shape == (4, 3)
    assert (m.sum(1) == 20).all()


# -- npx ----------------------------------------------------------------------
def test_npx_switch_and_aliases():
    assert not mx.npx.is_np_array()
    mx.npx.set_np()
    assert mx.npx.is_np_array() and mx.npx.is_np_shape()
    mx.npx.reset_np()
    assert not mx.npx.is_np_array()
    for name in ("activation", "batch_norm", "convolution",
                 "fully_connected", "pooling", "dropout", "embedding",
                 "one_hot", "pick", "topk", "softmax", "log_softmax",
                 "sigmoid", "relu", "batch_dot", "reshape_like",
                 "gather_nd", "sequence_mask", "leaky_relu",
                 "batch_flatten", "broadcast_like", "ctc_loss",
                 "deconvolution", "erf", "erfinv", "layer_norm",
                 "multibox_detection", "multibox_prior", "multibox_target",
                 "rnn", "roi_pooling", "scatter_nd", "shape_array", "slice",
                 "smooth_l1", "foreach", "while_loop", "cond"):
        assert callable(getattr(mx.npx, name)), name
    assert mx.npx.roi_pooling is mx.nd.ROIPooling
    assert mx.npx.foreach is mx.nd.contrib.foreach


@pytest.mark.parametrize("name,args,kw", [
    ("gelu", (A,), {}), ("arange_like", (A3,), dict(start=1.0, step=0.5)),
    ("arange_like", (A3,), dict(axis=1)), ("relu", (A,), {}),
    ("softmax", (A,), {}), ("topk", (A,), dict(k=2, ret_typ="value")),
])
def test_npx_routine_matches_the_reference(name, args, kw):
    def fn(npm, *a, **k):
        pkg = jmx if npm is jnp_ else mx
        return getattr(pkg.npx, name)(*a, **k)
    _compare(fn, args, kw, RTOL, grad=name != "arange_like")


def test_npx_save_load_waitall_seed(tmp_path):
    f = str(tmp_path / "a.params")
    mx.npx.save(f, {"a": pnp.array(A)})
    np.testing.assert_array_equal(mx.npx.load(f)["a"].asnumpy(), A)
    mx.npx.waitall()
    mx.npx.seed(5)
    a = pnp.random.uniform(size=3).asnumpy()
    mx.npx.seed(5)
    np.testing.assert_array_equal(pnp.random.uniform(size=3).asnumpy(), a)
