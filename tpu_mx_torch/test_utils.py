"""``mx.test_utils``, from ``tpu_mx/test_utils.py``: the reference's test
kit.

- ``assert_almost_equal``/``almost_equal`` with per-dtype default
  tolerances (``default_tols``: float16 and bfloat16 1e-2, float32
  1e-4 relative / 1e-5 absolute, float64 1e-6 / 1e-8);
- ``check_numeric_gradient``: central differences against the tape's
  gradients;
- ``check_consistency``: one function on several contexts, outputs and
  input gradients held to the first context's.  The default list is
  ``[cpu(0)]``, plus ``gpu(0)`` when a card is present (the reference's
  is ``[cpu(0)]`` plus ``tpu(0)``);
- ``check_symbolic_forward``/``check_symbolic_backward`` through the
  port's executors (``Symbol.simple_bind``);
- ``default_context``/``set_default_context``, ``rand_ndarray``,
  ``rand_shape_2d``/``3d``, ``assert_exception``, ``same`` and
  ``list_gpus`` (the cards' indices).
"""
from __future__ import annotations

import numpy as np
import torch

from . import autograd, context
from .ndarray.ndarray import NDArray, array
from .random import host_rng as _host_rng
from .runtime import fetch_sync

_DEFAULT_CTX = [None]

_DTYPE_TOL = {
    np.dtype(np.float16): (1e-2, 1e-2),
    np.dtype(np.float32): (1e-4, 1e-5),
    np.dtype(np.float64): (1e-6, 1e-8),
}


def default_context():
    return _DEFAULT_CTX[0] or context.current_context()


def set_default_context(ctx):
    _DEFAULT_CTX[0] = ctx


def _dtype_name(a):
    if isinstance(a, NDArray):
        return a.dtype if isinstance(a.dtype, str) else str(a.dtype)
    if isinstance(a, torch.Tensor):
        return str(a.dtype).replace("torch.", "")
    return np.asarray(a).dtype.name


def default_tols(*arrays):
    """``(rtol, atol)``: the loosest of the arrays' dtypes' tolerances."""
    rtol, atol = 1e-5, 1e-7
    for a in arrays:
        name = _dtype_name(a)
        if name == "bfloat16":
            rtol, atol = max(rtol, 1e-2), max(atol, 1e-2)
            continue
        dt = np.dtype(name)
        if dt in _DTYPE_TOL:
            r, at = _DTYPE_TOL[dt]
            rtol, atol = max(rtol, r), max(atol, at)
    return rtol, atol


def assert_almost_equal(a, b, rtol=None, atol=None, names=("a", "b")):
    a_np = fetch_sync(a).astype(np.float64)
    b_np = fetch_sync(b).astype(np.float64)
    if rtol is None or atol is None:
        r, at = default_tols(a, b)
        rtol = rtol if rtol is not None else r
        atol = atol if atol is not None else at
    np.testing.assert_allclose(a_np, b_np, rtol=rtol, atol=atol,
                               err_msg=f"{names[0]} vs {names[1]}")


def almost_equal(a, b, rtol=None, atol=None):
    try:
        assert_almost_equal(a, b, rtol, atol)
        return True
    except AssertionError:
        return False


def same(a, b):
    return np.array_equal(fetch_sync(a), fetch_sync(b))


def rand_ndarray(shape, dtype="float32", ctx=None, low=-1.0, high=1.0):
    """Uniform draws in ``[low, high)`` from the host generator, as an
    array on ``ctx`` (default: :func:`default_context`)."""
    data = _host_rng().uniform(low, high, size=shape).astype(dtype)
    return array(data, ctx=ctx or default_context())


def check_numeric_gradient(fn, inputs, eps=1e-3, rtol=1e-2, atol=1e-3):
    """Hold the tape's gradients of ``fn(arrays).sum()`` to central
    differences of step ``eps``.  ``fn`` takes a list of arrays;
    ``inputs`` is a list of numpy arrays, run in float32."""
    nds = [array(x.astype(np.float32)) for x in inputs]
    for a in nds:
        a.attach_grad()
    with autograd.record():
        loss = fn(nds).sum()
    loss.backward()
    analytic = [a.grad.asnumpy().copy() for a in nds]

    def total():
        return float(fn([array(v.astype(np.float32))
                         for v in inputs]).sum().asscalar())

    for idx, x in enumerate(inputs):
        numeric = np.zeros_like(x, dtype=np.float64)
        flat, num_flat = x.reshape(-1), numeric.reshape(-1)
        for j in range(flat.size):
            orig = flat[j]
            flat[j] = orig + eps
            lp = total()
            flat[j] = orig - eps
            lm = total()
            flat[j] = orig
            num_flat[j] = (lp - lm) / (2 * eps)
        np.testing.assert_allclose(analytic[idx], numeric, rtol=rtol,
                                   atol=atol,
                                   err_msg=f"gradient mismatch for input "
                                   f"{idx}")


def check_consistency(fn, inputs, ctx_list=None, grad=True, rtol=None,
                      atol=None):
    """Run ``fn`` on each context of ``ctx_list`` (default ``[cpu(0)]``,
    plus ``gpu(0)`` when a card is present) and hold each output, and
    with ``grad`` each input's gradient of the output's sum, to the
    first context's.  Returns ``[(output, [gradients])]`` as numpy."""
    if ctx_list is None:
        ctx_list = [context.cpu(0)]
        if context.num_gpus():
            ctx_list.append(context.gpu(0))
    results = []
    for ctx in ctx_list:
        nds = [array(x, ctx=ctx) for x in inputs]
        if grad:
            for a in nds:
                a.attach_grad()
            with autograd.record():
                out = fn(nds)
                loss = out.sum()
            loss.backward()
            results.append((out.asnumpy(), [a.grad.asnumpy() for a in nds]))
        else:
            results.append((fn(nds).asnumpy(), []))
    ref_out, ref_grads = results[0]
    for (out, grads), ctx in zip(results[1:], ctx_list[1:]):
        assert_almost_equal(out, ref_out, rtol, atol,
                            names=(str(ctx), str(ctx_list[0])))
        for g, rg in zip(grads, ref_grads):
            assert_almost_equal(g, rg, rtol, atol,
                                names=(str(ctx), str(ctx_list[0])))
    return results


def assert_exception(fn, exception_type, *args, **kwargs):
    """Assert that ``fn(*args, **kwargs)`` raises ``exception_type``."""
    try:
        fn(*args, **kwargs)
    except exception_type:
        return
    raise AssertionError(f"{fn} did not raise {exception_type.__name__}")


def rand_shape_2d(dim0=10, dim1=10):
    return (_host_rng().randint(1, dim0 + 1), _host_rng().randint(1, dim1 + 1))


def rand_shape_3d(dim0=10, dim1=10, dim2=10):
    return (_host_rng().randint(1, dim0 + 1), _host_rng().randint(1, dim1 + 1),
            _host_rng().randint(1, dim2 + 1))


def list_gpus():
    """The indices of the cards PyTorch sees."""
    return list(range(context.num_gpus()))


def _bind(sym, inputs, ctx, grad_req):
    args = sym.list_arguments()
    shapes = {a: np.asarray(x).shape for a, x in zip(args, inputs)}
    ex = sym.simple_bind(ctx, grad_req=grad_req, **shapes)
    for a, x in zip(args, inputs):
        ex.arg_dict[a][:] = np.asarray(x)
    return args, ex


def check_symbolic_forward(sym, inputs, expected, rtol=1e-5, atol=1e-20,
                           ctx=None):
    """Bind ``sym`` on ``ctx`` (default :func:`default_context`, the
    current context; the reference's default is the CPU) with ``inputs``
    (ordered as ``list_arguments()``) and hold its outputs to
    ``expected``."""
    _, ex = _bind(sym, inputs, ctx or default_context(), "write")
    outs = ex.forward()
    for out, exp in zip(outs, expected):
        np.testing.assert_allclose(out.asnumpy(), np.asarray(exp),
                                   rtol=rtol, atol=atol)
    return outs


def check_symbolic_backward(sym, inputs, out_grads, expected, rtol=1e-5,
                            atol=1e-20, ctx=None):
    """Forward and backward of ``sym`` with head gradients ``out_grads``;
    hold each argument's gradient to ``expected`` (None skips one).
    ``ctx`` as in :func:`check_symbolic_forward`."""
    ctx = ctx or default_context()
    args, ex = _bind(sym, inputs, ctx, "write")
    ex.forward(is_train=True)
    ex.backward([array(np.asarray(g).astype(np.float32), ctx=ctx)
                 for g in out_grads])
    for a, exp in zip(args, expected):
        if exp is None:
            continue
        np.testing.assert_allclose(ex.grad_dict[a].asnumpy(),
                                   np.asarray(exp), rtol=rtol, atol=atol)
    return [ex.grad_dict[a] for a in args]
