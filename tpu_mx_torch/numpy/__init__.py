"""``mx.np``: the NumPy-compatible namespace of ``tpu_mx/numpy``, over
PyTorch.

Every routine of the reference's list (``_WRAPPED``) is a function on
tensors with numpy's signature, run through ``ndarray.ops._apply`` as
the ``nd`` operators are: arrays in, arrays out (recorded under
``autograd.record()``); tensors in, tensors out (inside a
``HybridBlock``'s forward).  Arrays are the port's one ``NDArray``
type, as in the reference.

The default float type is float32 (``_to_f32``: float64 data becomes
float32, as the reference's does; a routine of integers that yields a
fraction, such as ``mean``, gives float32).  Integer data stays int64
where the reference, without jax's x64, makes int32.  Creation routines
take ``ctx=`` (default: the current context).  A Python scalar beside a
tensor takes the tensor's type, as jax's weakly typed scalars do.  The
routines whose result's size depends on the data (``nonzero``,
``unique``, ``flatnonzero``, one-argument ``where``) read the data on
the host.  ``frexp`` is numpy's, with a gradient on the mantissa
(``2**-e``); ``np.random`` draws from the port's generators.

The real numpy stays ``import numpy`` inside the package: every module
imports it absolutely (``_onp`` here).
"""
from __future__ import annotations

import builtins as _builtins
import math as _math

import numpy as _onp
import torch

from .. import device as _device
from ..context import current_context
from ..ndarray import NDArray
from ..ndarray import ops as _ops
from ..ndarray.ndarray import _torch_dtype

newaxis = None
pi = _onp.pi
e = _onp.e
inf = _onp.inf
nan = _onp.nan
euler_gamma = _onp.euler_gamma
float32, float64, float16 = "float32", "float64", "float16"
int32, int64, int8, uint8 = "int32", "int64", "int8", "uint8"
bool_ = "bool"
ndarray = NDArray


# -- creation -----------------------------------------------------------------
def _to_f32(dtype, obj):
    """The dtype to make ``obj`` in: ``dtype``, else float32 for float64
    data (the default-float32 contract), else None (keep)."""
    if dtype is not None:
        return dtype
    if _onp.asarray(obj).dtype == _onp.float64:
        return _onp.float32
    return None


def _dev(ctx):
    return _device.resolve(ctx if ctx is not None else current_context())


def _made(t, ctx):
    return _ops._place(t.to(_dev(ctx)))


def _dt(dtype):
    return _torch_dtype(dtype or "float32")


def array(object, dtype=None, ctx=None):
    if isinstance(object, NDArray):
        object = object._data
    if isinstance(object, torch.Tensor):
        t = object.detach()
        if dtype is not None:
            t = t.to(_torch_dtype(dtype))
        elif t.dtype == torch.float64:
            t = t.float()
        return _made(t, ctx)
    a = _onp.asarray(object)
    dt = _to_f32(dtype, a)
    if dt is not None:
        a = a.astype(dt)
    return _made(torch.from_numpy(_onp.array(a, order="C")), ctx)


def zeros(shape, dtype=None, ctx=None, **kw):
    return _ops._place(torch.zeros(shape, dtype=_dt(dtype), device=_dev(ctx)))


def ones(shape, dtype=None, ctx=None, **kw):
    return _ops._place(torch.ones(shape, dtype=_dt(dtype), device=_dev(ctx)))


def full(shape, fill_value, dtype=None, ctx=None, **kw):
    dt = _torch_dtype(dtype or _to_f32(None, fill_value))
    return _ops._place(torch.full(shape if not isinstance(shape, int)
                                  else (shape,), fill_value, dtype=dt,
                                  device=_dev(ctx)))


def arange(start, stop=None, step=1, dtype=None, ctx=None):
    if stop is None:
        start, stop = 0, start
    out = torch.arange(start, stop, step, device=_dev(ctx))
    if dtype is not None:
        out = out.to(_torch_dtype(dtype))
    return _ops._place(out)


def linspace(start, stop, num=50, endpoint=True, dtype=None, ctx=None,
             **kw):
    a = _onp.linspace(start, stop, num, endpoint=endpoint)
    return _made(torch.from_numpy(a).to(_dt(dtype)), ctx)


def eye(N, M=None, k=0, dtype=None, ctx=None, **kw):
    return _made(torch.from_numpy(_onp.eye(N, M, k, dtype=_onp.float32))
                 .to(_dt(dtype)), ctx)


def identity(n, dtype=None, ctx=None):
    return eye(n, dtype=dtype, ctx=ctx)


# -- the routines -------------------------------------------------------------
def _t(x, like=None):
    """``x`` as a tensor: a Python scalar in ``like``'s type (a weak
    scalar), array-like data on ``like``'s device (float64 as float32)."""
    if isinstance(x, torch.Tensor):
        return x
    dev = like.device if isinstance(like, torch.Tensor) else _dev(None)
    if isinstance(x, (bool, int, float)) and isinstance(like, torch.Tensor):
        return torch.full((), x, dtype=torch.result_type(like, x), device=dev)
    a = _onp.asarray(x)
    if a.dtype == _onp.float64:
        a = a.astype(_onp.float32)
    return torch.as_tensor(a, device=dev)


def _ts(a, b):
    if isinstance(a, torch.Tensor):
        return a, _t(b, a)
    b = _t(b)
    return _t(a, b), b


def _un(tfn):
    return lambda x, *a, **k: tfn(_t(x))


def _bi(tfn):
    return lambda x1, x2, *a, **k: tfn(*_ts(x1, x2))


def _float(x):
    return x if x.is_floating_point() or x.is_complex() else x.float()


def _dims(a, axis):
    if axis is None:
        return tuple(range(a.dim()))
    return tuple(axis) if isinstance(axis, (list, tuple)) else (axis,)


def _keep_all(out, a, axis, keepdims):
    """A full reduction kept as ``(1,)*ndim`` where numpy keeps it."""
    if axis is None and keepdims:
        return out.reshape((1,) * a.dim())
    return out


def _red(tfn, floating=False):
    """A reduction over ``axis`` (None: all) with ``keepdims``."""
    def op(a, axis=None, dtype=None, out=None, keepdims=False, **kw):
        a = _t(a)
        if floating:
            a = _float(a)
        if dtype is not None:
            a = a.to(_torch_dtype(dtype))
        return tfn(a, _dims(a, axis), bool(keepdims))
    return op


def _prod(a, dims, keep):
    for d in sorted((d % a.dim() for d in dims), reverse=True):
        a = a.prod(dim=d, keepdim=keep)
    return a


def _arg(tfn):
    def op(a, axis=None, out=None, keepdims=False, **kw):
        a = _t(a)
        if axis is None:
            return _keep_all(tfn(a.reshape(-1), dim=0), a, None, keepdims)
        return tfn(a, dim=axis, keepdim=bool(keepdims))
    return op


def _moved(a, axis):
    """``a`` with ``axis`` (tuple: all merged) last, and what to reshape
    a kept result to."""
    dims = _dims(a, axis)
    rest = [d for d in range(a.dim()) if d not in {x % a.dim() for x in dims}]
    m = a.permute(rest + [d % a.dim() for d in dims]).reshape(
        [a.shape[d] for d in rest] + [-1])
    keep = [1 if d in {x % a.dim() for x in dims} else a.shape[d]
            for d in range(a.dim())]
    return m, keep


def _quant(a, q, axis=None, keepdims=False):
    a = _float(_t(a))
    qt = _t(q, a).to(a.dtype)
    m, keep = _moved(a, axis)
    out = torch.quantile(m, qt, dim=-1)
    if keepdims:
        out = out.reshape(tuple(qt.shape) + tuple(keep))
    return out


def _clip(a, a_min=None, a_max=None, *, min=None, max=None, **kw):
    a = _t(a)
    lo = a_min if a_min is not None else min
    hi = a_max if a_max is not None else max
    if lo is not None:
        a = torch.maximum(a, _t(lo, a).to(a.dtype))
    if hi is not None:
        a = torch.minimum(a, _t(hi, a).to(a.dtype))
    return a


def _concatenate(arrays, axis=0, **kw):
    ts = [_t(x) for x in arrays]
    if axis is None:
        return torch.cat([x.reshape(-1) for x in ts])
    return torch.cat(ts, dim=axis)


def _dot(a, b):
    a, b = _ts(a, b)
    if a.dim() == 0 or b.dim() == 0:
        return a * b
    if b.dim() == 1:
        return torch.tensordot(a, b, dims=([-1], [0]))
    if a.dim() <= 2 and b.dim() <= 2:
        return torch.matmul(a, b)
    return torch.tensordot(a, b, dims=([-1], [-2]))


def _split(ary, indices_or_sections, axis=0):
    a = _t(ary)
    if isinstance(indices_or_sections, int) and \
            a.shape[axis] % indices_or_sections:
        raise ValueError("array split does not result in an equal division")
    return list(torch.tensor_split(a, indices_or_sections, dim=axis))


def _pad(array, pad_width, mode="constant", constant_values=0, **kw):
    a = _t(array)
    pw = _onp.broadcast_to(_onp.asarray(pad_width, dtype=_onp.int64),
                           (a.dim(), 2))
    if mode == "constant":
        flat = [int(v) for b, af in reversed(pw.tolist()) for v in (b, af)]
        return torch.nn.functional.pad(a, flat, value=constant_values)
    out = a
    for axis, (b, af) in enumerate(pw.tolist()):
        if not (b or af):
            continue
        n = out.shape[axis]
        idx = torch.arange(-b, n + af, device=a.device)
        if mode == "edge":
            idx = idx.clamp(0, n - 1)
        elif mode == "wrap":
            idx = idx % n
        elif mode in ("reflect", "symmetric"):
            period = 2 * n - (2 if mode == "reflect" else 0)
            idx = idx % period
            top = n - 1 if mode == "reflect" else n
            idx = torch.where(idx > n - 1, 2 * top - idx -
                              (0 if mode == "reflect" else 1), idx)
        else:
            raise ValueError(f"pad: unsupported mode {mode!r}")
        out = out.index_select(axis, idx)
    return out


def _take(a, indices, axis=None, mode=None, **kw):
    a = _t(a)
    i = _t(indices, a).long() if not isinstance(indices, torch.Tensor) \
        else indices.long()
    src = a.reshape(-1) if axis is None else a
    ax = 0 if axis is None else axis % a.dim()
    n = src.shape[ax]
    i = torch.where(i < 0, i + n, i)
    inside = (i >= 0) & (i < n)
    got = src.index_select(ax, torch.where(inside, i, 0).reshape(-1))
    got = got.reshape(tuple(src.shape[:ax]) + tuple(i.shape)
                      + tuple(src.shape[ax + 1:]))
    if got.is_floating_point():
        mask = inside.reshape((1,) * ax + tuple(i.shape)
                              + (1,) * (src.dim() - ax - 1))
        got = torch.where(mask, got, _math.nan)
    return got


def _where(condition, x=None, y=None):
    c = _t(condition)
    if x is None and y is None:
        return list(torch.nonzero(c, as_tuple=True))
    x, y = _ts(x, y)
    return torch.where(c.bool(), x, y)


def _unique(ar, return_index=False, return_inverse=False, return_counts=False,
            axis=None, **kw):
    a = _t(ar)
    src = a.reshape(-1) if axis is None else a
    u, inv, cnt = torch.unique(src, sorted=True, return_inverse=True,
                               return_counts=True, dim=axis)
    out = [u]
    if return_index:
        pos = torch.arange(src.shape[0 if axis is None else axis],
                           device=a.device)
        first = torch.full((u.shape[0 if axis is None else axis],),
                           pos.numel(), device=a.device, dtype=pos.dtype)
        out.append(first.scatter_reduce(0, inv.reshape(-1), pos, "amin"))
    if return_inverse:
        out.append(inv.reshape(a.shape) if axis is None else inv)
    if return_counts:
        out.append(cnt)
    return out[0] if len(out) == 1 else out


def _histogram(a, bins=10, range=None, weights=None, density=None):
    a = _float(_t(a)).reshape(-1)
    if isinstance(bins, int):
        # the edges follow the data's extremes, with their gradient
        lo, hi = (_t(range[0], a), _t(range[1], a)) if range is not None \
            else (a.min(), a.max())
        same = hi == lo
        lo, hi = torch.where(same, lo - 0.5, lo), torch.where(same, hi + 0.5,
                                                              hi)
        edges = lo + (hi - lo) * (torch.arange(
            bins + 1, device=a.device, dtype=a.dtype) / bins)
    else:
        edges = _t(bins, a).to(a.dtype)
    nb = edges.numel() - 1
    idx = torch.bucketize(a, edges, right=True) - 1
    idx = torch.where(a == edges[-1], nb - 1, idx)
    inside = (idx >= 0) & (idx < nb)
    w = torch.ones_like(a) if weights is None else \
        _float(_t(weights, a)).reshape(-1)
    hist = torch.zeros(nb, dtype=a.dtype, device=a.device).index_add(
        0, torch.where(inside, idx, 0), torch.where(inside, w, 0.0))
    if density:
        hist = hist / (hist.sum() * (edges[1:] - edges[:-1]))
    return [hist, edges]


def _interp(x, xp, fp, left=None, right=None, period=None):
    x = _float(_t(x))
    xp, fp = _t(xp, x).to(x.dtype), _t(fp, x).to(x.dtype)
    n = xp.shape[0]
    i = (torch.searchsorted(xp, x.contiguous(), right=True) - 1) \
        .clamp(0, n - 2)
    x0, x1, f0, f1 = xp[i], xp[i + 1], fp[i], fp[i + 1]
    y = f0 + (x - x0) / (x1 - x0) * (f1 - f0)
    y = torch.where(x < xp[0], fp[0] if left is None else left, y)
    return torch.where(x > xp[-1], fp[-1] if right is None else right, y)


def _delete(arr, obj, axis=None):
    a = _t(arr)
    src = a.reshape(-1) if axis is None else a
    ax = 0 if axis is None else axis % a.dim()
    n = src.shape[ax]
    drop = _onp.zeros(n, bool)
    drop[_onp.arange(n)[obj] if isinstance(obj, slice) else
         _onp.asarray(obj)] = True
    keep = torch.from_numpy(_onp.flatnonzero(~drop)).to(a.device)
    return src.index_select(ax, keep)


def _insert(arr, obj, values, axis=None):
    a = _t(arr)
    src = a.reshape(-1) if axis is None else a
    ax = 0 if axis is None else axis % a.dim()
    v = _t(values, src).to(src.dtype)
    idx = _onp.atleast_1d(_onp.asarray(obj))
    shape = list(src.shape)
    shape[ax] = len(idx)
    if _onp.ndim(obj) == 0 and v.dim() == src.dim() - 1:
        v = v.unsqueeze(ax)
    v = torch.broadcast_to(v, shape)
    pieces, start = [], 0
    for j, at in enumerate(sorted(int(i) % (src.shape[ax] + 1)
                                  for i in idx)):
        pieces += [src.narrow(ax, start, at - start), v.narrow(ax, j, 1)]
        start = at
    pieces.append(src.narrow(ax, start, src.shape[ax] - start))
    return torch.cat(pieces, dim=ax)


def _polyval(p, x):
    p, x = _ts(p, x)
    y = torch.zeros_like(x * p[0])
    for i in range(p.shape[0]):
        y = y * x + p[i]
    return y


def _resize(a, new_shape):
    a = _t(a).reshape(-1)
    shape = (new_shape,) if isinstance(new_shape, int) else tuple(new_shape)
    n = _math.prod(shape)
    reps = -(-n // _builtins.max(a.numel(), 1))
    return a.repeat(reps)[:n].reshape(shape)


def _average(a, axis=None, weights=None, returned=False, keepdims=False):
    a = _float(_t(a))
    dims = _dims(a, axis)
    if weights is None:
        avg = a.mean(dim=dims, keepdim=bool(keepdims))
        scl = torch.full_like(avg, a.numel() / _builtins.max(avg.numel(), 1))
    else:
        w = _t(weights, a).to(a.dtype)
        if w.dim() == 1 and a.dim() > 1 and axis is not None:
            shape = [1] * a.dim()
            shape[axis] = -1
            w = w.reshape(shape)
        w = torch.broadcast_to(w, a.shape)
        scl = w.sum(dim=dims, keepdim=bool(keepdims))
        avg = (a * w).sum(dim=dims, keepdim=bool(keepdims)) / scl
    return [avg, scl] if returned else avg


def _nanext(tfn, fill):
    def op(a, axis=None, out=None, keepdims=False, **kw):
        a = _t(a)
        dims = _dims(a, axis)
        nan_ = torch.isnan(a)
        got = tfn(torch.where(nan_, fill, a), dim=dims, keepdim=bool(keepdims))
        return torch.where(nan_.all(dim=dims, keepdim=bool(keepdims)),
                           _math.nan, got)
    return op


def _expand_dims(a, axis):
    a = _t(a)
    axes = axis if isinstance(axis, (list, tuple)) else (axis,)
    n = a.dim() + len(axes)
    for ax in sorted(x % n for x in axes):
        a = a.unsqueeze(ax)
    return a


def _repeat(a, repeats, axis=None):
    a = _t(a)
    r = repeats if isinstance(repeats, int) else _t(repeats, a).long()
    if axis is None:
        return a.reshape(-1).repeat_interleave(r)
    return a.repeat_interleave(r, dim=axis)


def _reshape(a, shape=None, order="C", **kw):
    shape = kw.get("newshape", shape)
    return _t(a).reshape((shape,) if isinstance(shape, int) else
                         tuple(shape))


def _flip(m, axis=None):
    m = _t(m)
    return torch.flip(m, dims=_dims(m, axis))


def _sort(a, axis=-1, kind=None, order=None, **kw):
    a = _t(a)
    if axis is None:
        a, axis = a.reshape(-1), 0
    return torch.sort(a, dim=axis, stable=True).values


def _argsort(a, axis=-1, kind=None, order=None, **kw):
    a = _t(a)
    if axis is None:
        a, axis = a.reshape(-1), 0
    return torch.argsort(a, dim=axis, stable=True)


def _cum(tfn):
    def op(a, axis=None, dtype=None, out=None):
        a = _t(a)
        if dtype is not None:
            a = a.to(_torch_dtype(dtype))
        if axis is None:
            a, axis = a.reshape(-1), 0
        return tfn(a, dim=axis)
    return op


def _std(correction_of):
    def op(a, axis=None, dtype=None, out=None, ddof=0, keepdims=False, **kw):
        a = _float(_t(a))
        return correction_of(a, dim=_dims(a, axis), correction=ddof,
                             keepdim=bool(keepdims))
    return op


def _ediff1d(ary, to_end=None, to_begin=None):
    a = _t(ary).reshape(-1)
    parts = [a[1:] - a[:-1]]
    if to_begin is not None:
        parts.insert(0, _t(to_begin, a).to(a.dtype).reshape(-1))
    if to_end is not None:
        parts.append(_t(to_end, a).to(a.dtype).reshape(-1))
    return torch.cat(parts)


def _floor_div(x1, x2):
    """Floor division (no gradient, as the reference's)."""
    return torch.div(*_ts(x1, x2), rounding_mode="floor")


def _vander(x, N=None, increasing=False):
    x = _t(x)
    n = x.shape[0] if N is None else N
    p = torch.arange(n, device=x.device)
    return x[:, None] ** (p if increasing else p.flip(0))


def _cbrt(x):
    x = _float(_t(x))
    return torch.sign(x) * x.abs().pow(1.0 / 3.0)


def _cross(a, b, axisa=-1, axisb=-1, axisc=-1, axis=None):
    a, b = _ts(a, b)
    return torch.linalg.cross(a, b, dim=-1 if axis is None else axis)


def _bincount(x, weights=None, minlength=0, **kw):
    x = _t(x).long()
    w = None if weights is None else _t(weights, x).float()
    return torch.bincount(x, w, int(minlength or 0))


_IMPL = {
    "abs": _un(torch.abs), "absolute": _un(torch.abs),
    "add": _bi(torch.add),
    "all": _red(lambda a, d, k: torch.all(a, dim=d, keepdim=k)),
    "allclose": lambda a, b, rtol=1e-5, atol=1e-8, equal_nan=False:
        torch.isclose(*_ts(a, b), rtol=rtol, atol=atol,
                      equal_nan=equal_nan).all(),
    "amax": _red(lambda a, d, k: torch.amax(a, dim=d, keepdim=k)),
    "amin": _red(lambda a, d, k: torch.amin(a, dim=d, keepdim=k)),
    "any": _red(lambda a, d, k: torch.any(a, dim=d, keepdim=k)),
    "append": lambda arr, values, axis=None: _concatenate(
        [arr, values], axis),
    "arccos": _un(torch.acos), "arccosh": _un(torch.acosh),
    "arcsin": _un(torch.asin), "arcsinh": _un(torch.asinh),
    "arctan": _un(torch.atan), "arctan2": _bi(torch.atan2),
    "arctanh": _un(torch.atanh),
    "argmax": _arg(torch.argmax), "argmin": _arg(torch.argmin),
    "argsort": _argsort,
    "around": lambda a, decimals=0, out=None: torch.round(
        _t(a), decimals=decimals),
    "array_split": lambda ary, indices_or_sections, axis=0: list(
        torch.tensor_split(_t(ary), indices_or_sections, dim=axis)),
    "atleast_1d": lambda *arys: torch.atleast_1d(*[_t(a) for a in arys]),
    "atleast_2d": lambda *arys: torch.atleast_2d(*[_t(a) for a in arys]),
    "atleast_3d": lambda *arys: torch.atleast_3d(*[_t(a) for a in arys]),
    "average": _average,
    "bincount": _bincount,
    "bitwise_and": _bi(torch.bitwise_and), "bitwise_or": _bi(
        torch.bitwise_or), "bitwise_xor": _bi(torch.bitwise_xor),
    "broadcast_arrays": lambda *args: list(torch.broadcast_tensors(
        *[_t(a) for a in args])),
    "broadcast_to": lambda array, shape: torch.broadcast_to(
        _t(array), (shape,) if isinstance(shape, int) else tuple(shape)),
    "cbrt": _cbrt, "ceil": _un(torch.ceil), "clip": _clip,
    "column_stack": lambda tup: torch.column_stack([_t(x) for x in tup]),
    "concatenate": _concatenate,
    "copysign": _bi(torch.copysign), "cos": _un(torch.cos),
    "cosh": _un(torch.cosh), "cross": _cross,
    "cumprod": _cum(torch.cumprod), "cumsum": _cum(torch.cumsum),
    "deg2rad": _un(lambda x: torch.deg2rad(_float(x))),
    "degrees": _un(lambda x: torch.rad2deg(_float(x))),
    "delete": _delete,
    "diag": lambda v, k=0: torch.diag(_t(v), k),
    "diagflat": lambda v, k=0: torch.diagflat(_t(v), offset=k),
    "diagonal": lambda a, offset=0, axis1=0, axis2=1: torch.diagonal(
        _t(a), offset, axis1, axis2),
    "diff": lambda a, n=1, axis=-1, prepend=None, append=None: torch.diff(
        _t(a), n, axis, prepend, append),
    "divide": _bi(torch.true_divide),
    "divmod": lambda x1, x2: [_floor_div(x1, x2),
                              torch.remainder(*_ts(x1, x2))],
    "dot": _dot,
    "dsplit": lambda ary, s: list(torch.dsplit(_t(ary), s)),
    "dstack": lambda tup: torch.dstack([_t(x) for x in tup]),
    "ediff1d": _ediff1d,
    "einsum": lambda subscripts, *operands, **kw: torch.einsum(
        subscripts, *[_t(o) for o in operands]),
    "equal": _bi(torch.eq), "exp": _un(torch.exp),
    "exp2": _un(lambda x: torch.exp2(_float(x))),
    "expand_dims": _expand_dims, "expm1": _un(torch.expm1),
    "flatnonzero": lambda a: torch.nonzero(_t(a).reshape(-1)).reshape(-1),
    "flip": _flip, "fliplr": _un(torch.fliplr), "flipud": _un(torch.flipud),
    "floor": _un(torch.floor), "floor_divide": _floor_div,
    "fmax": _bi(torch.fmax), "fmin": _bi(torch.fmin),
    "fmod": _bi(torch.fmod), "gcd": _bi(torch.gcd),
    "greater": _bi(torch.gt), "greater_equal": _bi(torch.ge),
    "histogram": _histogram,
    "hsplit": lambda ary, s: list(torch.hsplit(_t(ary), s)),
    "hstack": lambda tup: torch.hstack([_t(x) for x in tup]),
    "hypot": _bi(torch.hypot), "inner": _bi(torch.inner),
    "insert": _insert, "interp": _interp,
    "invert": _un(torch.bitwise_not),
    "isclose": lambda a, b, rtol=1e-5, atol=1e-8, equal_nan=False:
        torch.isclose(*_ts(a, b), rtol=rtol, atol=atol, equal_nan=equal_nan),
    "isfinite": _un(torch.isfinite), "isinf": _un(torch.isinf),
    "isnan": _un(torch.isnan), "isneginf": _un(torch.isneginf),
    "isposinf": _un(torch.isposinf), "kron": _bi(torch.kron),
    "lcm": _bi(torch.lcm),
    "ldexp": lambda x1, x2: torch.ldexp(_float(_t(x1)), _t(x2)),
    "less": _bi(torch.lt), "less_equal": _bi(torch.le),
    "log": _un(torch.log), "log10": _un(torch.log10),
    "log1p": _un(torch.log1p), "log2": _un(torch.log2),
    "logaddexp": _bi(torch.logaddexp), "logaddexp2": _bi(torch.logaddexp2),
    "logical_and": _bi(torch.logical_and), "logical_not": _un(
        torch.logical_not), "logical_or": _bi(torch.logical_or),
    "logical_xor": _bi(torch.logical_xor), "matmul": _bi(torch.matmul),
    "max": _red(lambda a, d, k: torch.amax(a, dim=d, keepdim=k)),
    "maximum": _bi(torch.maximum),
    "mean": _red(lambda a, d, k: torch.mean(a, dim=d, keepdim=k), True),
    "median": lambda a, axis=None, out=None, overwrite_input=False,
    keepdims=False: _quant(a, 0.5, axis, keepdims),
    "meshgrid": lambda *xi, indexing="xy", **kw: list(torch.meshgrid(
        *[_t(x) for x in xi], indexing=indexing)),
    "min": _red(lambda a, d, k: torch.amin(a, dim=d, keepdim=k)),
    "minimum": _bi(torch.minimum), "mod": _bi(torch.remainder),
    "moveaxis": lambda a, source, destination: torch.movedim(
        _t(a), source, destination),
    "multiply": _bi(torch.mul),
    "nan_to_num": lambda x, copy=True, nan=0.0, posinf=None, neginf=None:
        torch.nan_to_num(_t(x), nan, posinf, neginf),
    "nanmax": _nanext(torch.amax, -_math.inf),
    "nanmean": _red(lambda a, d, k: torch.nanmean(a, dim=d, keepdim=k),
                    True),
    "nanmin": _nanext(torch.amin, _math.inf),
    "nansum": _red(lambda a, d, k: torch.nansum(a, dim=d, keepdim=k)),
    "negative": _un(torch.neg),
    "nonzero": lambda a: list(torch.nonzero(_t(a), as_tuple=True)),
    "not_equal": _bi(torch.ne),
    "outer": lambda a, b: torch.outer(*[x.reshape(-1) for x in _ts(a, b)]),
    "pad": _pad,
    "percentile": lambda a, q, axis=None, out=None, overwrite_input=False,
    method="linear", keepdims=False, **kw: _quant(
        a, _t(q, _float(_t(a))) / 100.0, axis, keepdims),
    "polyval": _polyval, "power": _bi(torch.pow),
    "prod": _red(_prod),
    "ptp": lambda a, axis=None, out=None, keepdims=False: (
        torch.amax(_t(a), dim=_dims(_t(a), axis), keepdim=bool(keepdims))
        - torch.amin(_t(a), dim=_dims(_t(a), axis), keepdim=bool(keepdims))),
    "quantile": lambda a, q, axis=None, out=None, overwrite_input=False,
    method="linear", keepdims=False, **kw: _quant(a, q, axis, keepdims),
    "rad2deg": _un(lambda x: torch.rad2deg(_float(x))),
    "radians": _un(lambda x: torch.deg2rad(_float(x))),
    "ravel": lambda a, order="C": _t(a).reshape(-1),
    "reciprocal": _un(torch.reciprocal), "remainder": _bi(torch.remainder),
    "repeat": _repeat, "reshape": _reshape, "resize": _resize,
    "roll": lambda a, shift, axis=None: torch.roll(_t(a), shift) \
    if axis is None else torch.roll(_t(a), shift, axis),
    "rot90": lambda m, k=1, axes=(0, 1): torch.rot90(_t(m), k, list(axes)),
    "searchsorted": lambda a, v, side="left", sorter=None, **kw:
        torch.searchsorted(_t(a), _t(v, _t(a)).contiguous(),
                           right=(side == "right")),
    "sign": _un(torch.sign), "sin": _un(torch.sin), "sinh": _un(torch.sinh),
    "sort": _sort, "split": _split, "sqrt": _un(torch.sqrt),
    "square": _un(torch.square),
    "squeeze": lambda a, axis=None: _t(a).squeeze() if axis is None
    else _t(a).squeeze(tuple(axis) if isinstance(axis, (list, tuple))
                       else axis),
    "stack": lambda arrays, axis=0, **kw: torch.stack(
        [_t(x) for x in arrays], dim=axis),
    "std": _std(torch.std),
    "subtract": _bi(torch.sub),
    "sum": _red(lambda a, d, k: torch.sum(a, dim=d, keepdim=k)),
    "swapaxes": lambda a, axis1, axis2: torch.swapaxes(_t(a), axis1, axis2),
    "take": _take,
    "take_along_axis": lambda arr, indices, axis, **kw: torch.take_along_dim(
        _t(arr), _t(indices).long(), dim=axis),
    "tan": _un(torch.tan), "tanh": _un(torch.tanh),
    "tensordot": lambda a, b, axes=2: torch.tensordot(
        *_ts(a, b), dims=axes if isinstance(axes, int)
        else [list(_onp.atleast_1d(x)) for x in axes]),
    "tile": lambda A, reps: torch.tile(_t(A), (reps,) if isinstance(
        reps, int) else tuple(reps)),
    "trace": lambda a, offset=0, axis1=0, axis2=1, dtype=None, out=None:
        torch.diagonal(_t(a), offset, axis1, axis2).sum(-1),
    "transpose": lambda a, axes=None: _t(a).permute(
        tuple(axes) if axes is not None else
        tuple(reversed(range(_t(a).dim())))),
    "tril": lambda m, k=0: torch.tril(_t(m), k),
    "triu": lambda m, k=0: torch.triu(_t(m), k),
    "true_divide": _bi(torch.true_divide), "trunc": _un(torch.trunc),
    "unique": _unique,
    "unravel_index": lambda indices, shape, order="C": list(
        torch.unravel_index(_t(indices).long(), tuple(shape))),
    "vander": _vander,
    "var": _std(torch.var),
    "vdot": lambda a, b: torch.vdot(*[x.reshape(-1) for x in _ts(a, b)]),
    "vsplit": lambda ary, s: list(torch.vsplit(_t(ary), s)),
    "vstack": lambda tup: torch.vstack([_t(x) for x in tup]),
    "where": _where,
}


def _wrap(name, public=None):
    impl = _IMPL[name]

    def op(*args, **kwargs):
        return _ops._apply(impl, args, kwargs)

    op.__name__ = op.__qualname__ = public or name
    op.__doc__ = (f"mx.np.{public or name}: numpy.{name} on tensors, "
                  "through the operators' dispatch (arrays in, arrays out)")
    return op


# one generated wrapper per routine; names follow numpy.  Keep sorted.
_WRAPPED = sorted(_IMPL)
for _name in _WRAPPED:
    globals()[_name] = _wrap(_name)
round = globals()["around"]
concat = globals()["concatenate"]
fix = globals()["trunc"]


class _Frexp(torch.autograd.Function):
    """numpy's ``frexp`` with the mantissa's gradient ``2**-e`` (the
    exponent is piecewise constant; zero at non-finite inputs)."""

    @staticmethod
    def forward(ctx, x):
        m, ex = torch.frexp(x)
        ctx.save_for_backward(x, ex)
        ctx.mark_non_differentiable(ex)
        return m, ex

    @staticmethod
    def backward(ctx, gm, ge):
        x, ex = ctx.saved_tensors
        if gm is None:
            return None
        h = (-ex) // 2
        scale = torch.ldexp(torch.ldexp(torch.ones_like(x), h), -ex - h)
        return torch.where(torch.isfinite(x), gm * scale, 0.0)


def frexp(x):
    """``(mantissa, exponent)`` with ``x = m·2**e`` and ``0.5 <= |m| <
    1`` (``(0, 0)`` at zero; ``x`` itself and 0 at inf and NaN), as
    numpy's, subnormals included; the mantissa's gradient is ``2**-e``
    (the reference attaches the same, straight through)."""
    def f(v):
        v = _t(v)
        if not v.is_floating_point():
            v = v.float()
        m, ex = _Frexp.apply(v)
        fin = torch.isfinite(v)
        return torch.where(fin, m, v.detach()), torch.where(fin, ex, 0)
    return _ops._apply(f, (x,), {})


def zeros_like(a, dtype=None, **kw):
    return _ops._apply(lambda x: torch.zeros_like(
        x, dtype=_torch_dtype(dtype)), (a,), {})


def ones_like(a, dtype=None, **kw):
    return _ops._apply(lambda x: torch.ones_like(
        x, dtype=_torch_dtype(dtype)), (a,), {})


def full_like(a, fill_value, dtype=None, **kw):
    return _ops._apply(lambda x: torch.full_like(
        x, fill_value, dtype=_torch_dtype(dtype)), (a,), {})


def empty(shape, dtype=None, ctx=None, **kw):
    """Zeros (a tensor has no uninitialized state worth exposing)."""
    return zeros(shape, dtype, ctx)


def empty_like(a, dtype=None, **kw):
    return zeros_like(a, dtype)


def logspace(start, stop, num=50, endpoint=True, base=10.0, dtype=None,
             ctx=None, **kw):
    a = _onp.logspace(start, stop, num, endpoint=endpoint, base=base)
    return _made(torch.from_numpy(a).to(_dt(dtype)), ctx)


def indices(dimensions, dtype="int32", ctx=None):
    """One ``(ndim, *dimensions)`` array of each position's index."""
    dev = _dev(ctx)
    grids = torch.meshgrid(*[torch.arange(d, device=dev)
                             for d in dimensions], indexing="ij")
    return _ops._place(torch.stack(grids).to(_torch_dtype(dtype)))


def diag_indices(n, ndim=2):
    idx = torch.arange(n, device=_dev(None))
    return tuple(NDArray(idx) for _ in range(ndim))


def may_share_memory(a, b):
    return False


def shape(a):
    return tuple(a.shape)


def ndim(a):
    return len(a.shape)


def size(a):
    return int(_onp.prod(a.shape)) if a.shape else 1


from . import fft         # noqa: E402
from . import linalg      # noqa: E402
from . import random      # noqa: E402

__all__ = (["array", "zeros", "ones", "full", "arange", "linspace", "eye",
            "identity", "zeros_like", "ones_like", "full_like", "ndarray",
            "fix", "newaxis", "pi", "e", "inf", "nan", "fft", "linalg",
            "random", "shape", "ndim", "size", "round", "concat", "empty",
            "frexp", "empty_like", "logspace", "indices", "diag_indices"]
           + _WRAPPED)
