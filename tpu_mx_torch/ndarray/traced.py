"""The arrays a user's ``hybrid_forward`` gets: tensors with jax's array
methods.

The reference runs ``hybrid_forward`` inside its traced path, so the
arguments, the parameters and whatever the body computes from them are
jax arrays, and a user's code may call their numpy-style methods
(``mask.astype("float32")``, ``x.size``, ``x.sum(axis=1,
keepdims=True)``).  :class:`TracedArray` is a :class:`torch.Tensor`
subclass that gives the port's tensors those methods with jax's
meaning, for the body of a ``hybrid_forward`` only:

- ``HybridBlock.forward`` hands ``hybrid_forward`` its arguments and
  parameters as :class:`TracedArray` views (:func:`traced`, autograd
  stays attached) and returns plain tensors (:func:`plain`);
- an operation on a :class:`TracedArray` runs on plain tensors and its
  tensor results come back as :class:`TracedArray`, so the methods hold
  through the body;
- a block called from the body runs on plain tensors (the port's own
  layers never see the subclass) and hands its results back as
  :class:`TracedArray`.

The methods that differ from a tensor's, or that a tensor lacks:
``astype``, ``size`` (an int that a call still answers as
``Tensor.size`` does), ``T``/``transpose`` (a permutation), ``std``/
``var`` (``ddof=0``), ``max``/``min``/``sort`` (the values),
``argmax``/``argmin``/``sum``/``mean``/``prod``/``all``/``any``/
``cumsum``/``cumprod`` (``axis``, ``keepdims``; a cumulative op over
the flattened array without an axis), ``repeat`` (each element,
``jnp.repeat``), ``copy``, ``ptp``, ``take``, ``nonzero`` (a tuple),
``dot``, ``at[...]`` (``set``/``add``/``multiply``/``min``/``max``/
``get``), ``block_until_ready`` and ``__array__`` (a host copy, as
``np.asarray`` reads a jax array).  ``dtype`` stays a
:class:`torch.dtype`.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["TracedArray", "traced", "plain", "host_readable"]

_DTYPES = {"float32": torch.float32, "float16": torch.float16,
           "bfloat16": torch.bfloat16, "float64": torch.float64,
           "int8": torch.int8, "int16": torch.int16, "int32": torch.int32,
           "int64": torch.int64, "uint8": torch.uint8, "bool": torch.bool}


def _dtype(dtype):
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str) and dtype in _DTYPES:
        return _DTYPES[dtype]
    name = np.dtype(dtype).name
    if name not in _DTYPES:
        raise TypeError(f"astype: no tensor type for {dtype!r}")
    return _DTYPES[name]


def _plain(a):
    if type(a) is TracedArray:
        return a.as_subclass(torch.Tensor)
    if type(a) in (list, tuple):
        return type(a)(_plain(x) for x in a)
    return a


def traced(tree):
    """``tree``'s tensors (in lists, tuples and dicts) as
    :class:`TracedArray` views; unchanged while ``torch.export`` traces
    (``HybridBlock.export``), whose fake tensors take no subclass: a
    ``hybrid_forward`` that calls jax's methods cannot be exported."""
    if torch.compiler.is_exporting():
        return tree
    if type(tree) is torch.Tensor or isinstance(tree, torch.nn.Parameter):
        return tree.as_subclass(TracedArray)
    if type(tree) in (list, tuple):
        return type(tree)(traced(x) for x in tree)
    if isinstance(tree, dict):
        return {k: traced(v) for k, v in tree.items()}
    return tree


class _Size(int):
    """``x.size``: jax's element count, which ``x.size()`` /
    ``x.size(dim)`` still answer as ``Tensor.size`` does."""

    def __new__(cls, shape):
        obj = super().__new__(cls, int(np.prod(shape, dtype=np.int64)))
        obj._shape = shape
        return obj

    def __call__(self, dim=None):
        return self._shape if dim is None else self._shape[dim]


class _At:
    """``x.at[idx]``: jax's functional indexed update (a new array)."""

    def __init__(self, x):
        self._x = x

    def __getitem__(self, idx):
        return _AtIndex(self._x, idx)


class _AtIndex:
    def __init__(self, x, idx):
        self._x, self._idx = x, idx

    def get(self, **_):
        return self._x[self._idx]

    def _update(self, fn, v):
        out = self._x.clone()
        out[self._idx] = fn(out[self._idx], v)
        return out

    def set(self, v, **_):
        return self._update(lambda old, new: new, v)

    def add(self, v, **_):
        return self._update(lambda old, new: old + new, v)

    def multiply(self, v, **_):
        return self._update(lambda old, new: old * new, v)

    def min(self, v, **_):
        return self._update(torch.minimum, torch.as_tensor(v))

    def max(self, v, **_):
        return self._update(torch.maximum, torch.as_tensor(v))


def _axes(axis):
    return tuple(axis) if isinstance(axis, (list, tuple)) else axis


class TracedArray(torch.Tensor):
    """A tensor with the methods of a jax array (see the module
    docstring); an operation on it returns :class:`TracedArray`s."""

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        with torch._C.DisableTorchFunctionSubclass():
            out = func(*_plain(args), **_plain(kwargs or {}))
        return out if func is torch.Tensor.as_subclass else traced(out)

    # -- type and shape ---------------------------------------------------
    def astype(self, dtype, copy=False, device=None):
        return self.to(_dtype(dtype))

    @property
    def size(self):
        return _Size(tuple(self.shape))

    @property
    def T(self):
        return self.permute(*reversed(range(self.dim())))

    def transpose(self, *axes):
        if len(axes) == 1 and isinstance(axes[0], (list, tuple)):
            axes = tuple(axes[0])
        if not axes:
            axes = tuple(reversed(range(self.dim())))
        return self.permute(*axes)

    def copy(self):
        return self.clone()

    @property
    def at(self):
        return _At(self)

    def block_until_ready(self):
        if self.is_cuda:
            torch.cuda.synchronize(self.device)
        return self

    def __array__(self, dtype=None, copy=None):
        arr = plain(self).detach().cpu()
        if arr.dtype == torch.bfloat16:
            arr = arr.float()
        arr = arr.numpy()
        return arr if dtype is None else arr.astype(dtype)

    # -- reductions (jax: axis/keepdims; values, not (values, indices)) ----
    def _reduce(self, fn, axis, keepdims, **kw):
        if axis is None:
            out = fn(self, **kw)
            return out.reshape((1,) * self.dim()) if keepdims else out
        return fn(self, dim=_axes(axis), keepdim=keepdims, **kw)

    def sum(self, axis=None, dtype=None, out=None, keepdims=False, **_):
        return self._reduce(torch.sum, axis, keepdims, dtype=_dtype(dtype))

    def mean(self, axis=None, dtype=None, out=None, keepdims=False, **_):
        return self._reduce(torch.mean, axis, keepdims, dtype=_dtype(dtype))

    def prod(self, axis=None, dtype=None, out=None, keepdims=False, **_):
        if isinstance(axis, (list, tuple)):
            x = self
            for a in sorted((a % self.dim() for a in axis), reverse=True):
                x = torch.prod(x, dim=a, keepdim=keepdims)
            return x
        return self._reduce(torch.prod, axis, keepdims, dtype=_dtype(dtype))

    def all(self, axis=None, out=None, keepdims=False, **_):
        return self._reduce(torch.all, axis, keepdims)

    def any(self, axis=None, out=None, keepdims=False, **_):
        return self._reduce(torch.any, axis, keepdims)

    def max(self, axis=None, out=None, keepdims=False, **_):
        return self._reduce(torch.amax, axis, keepdims)

    def min(self, axis=None, out=None, keepdims=False, **_):
        return self._reduce(torch.amin, axis, keepdims)

    def ptp(self, axis=None, out=None, keepdims=False):
        return self.max(axis, keepdims=keepdims) \
            - self.min(axis, keepdims=keepdims)

    def argmax(self, axis=None, out=None, keepdims=False):
        return torch.argmax(self, dim=axis, keepdim=keepdims)

    def argmin(self, axis=None, out=None, keepdims=False):
        return torch.argmin(self, dim=axis, keepdim=keepdims)

    def var(self, axis=None, dtype=None, out=None, ddof=0, keepdims=False,
            **_):
        return self._reduce(torch.var, axis, keepdims, correction=ddof)

    def std(self, axis=None, dtype=None, out=None, ddof=0, keepdims=False,
            **_):
        return self._reduce(torch.std, axis, keepdims, correction=ddof)

    def cumsum(self, axis=None, dtype=None, out=None):
        x = self.reshape(-1) if axis is None else self
        return torch.cumsum(x, dim=0 if axis is None else axis,
                            dtype=_dtype(dtype))

    def cumprod(self, axis=None, dtype=None, out=None):
        x = self.reshape(-1) if axis is None else self
        return torch.cumprod(x, dim=0 if axis is None else axis,
                             dtype=_dtype(dtype))

    def sort(self, axis=-1, **_):
        x = self.reshape(-1) if axis is None else self
        return torch.sort(x, dim=-1 if axis is None else axis).values

    # -- indexing and products ----------------------------------------------
    def repeat(self, repeats, axis=None, **_):
        x = self.reshape(-1) if axis is None else self
        return torch.repeat_interleave(x, repeats, dim=0 if axis is None
                                       else axis)

    def take(self, indices, axis=None, **_):
        idx = torch.as_tensor(indices, device=self.device).long()
        if axis is None:
            return torch.take(self, idx)
        return torch.index_select(self, axis, idx.reshape(-1)).reshape(
            self.shape[:axis % self.dim()] + idx.shape
            + self.shape[axis % self.dim() + 1:])

    def nonzero(self, *, size=None, fill_value=None):
        return tuple(torch.nonzero(self, as_tuple=True))

    def dot(self, other):
        if self.dim() == 0 or torch.as_tensor(other).dim() == 0:
            return self * other
        if torch.as_tensor(other).dim() == 1:
            return torch.matmul(self, other)
        return torch.tensordot(self, other, dims=([-1], [-2]))


def plain(tree):
    """``tree``'s :class:`TracedArray`s (in lists and tuples) as plain
    tensors."""
    with torch._C.DisableTorchFunctionSubclass():
        return _plain(tree)


def host_readable(t):
    """``t`` as a :class:`TracedArray`, which ``np.asarray`` reads by a
    host copy as it reads a jax array (the reference's
    ``np.asarray(loss._data)``)."""
    return t.as_subclass(TracedArray)
