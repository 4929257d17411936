"""NDArray: the imperative array handle, from ``tpu_mx/ndarray/ndarray.py``.

As the reference's ``NDArray`` is a handle around one jax array, the
port's is a handle around one :class:`torch.Tensor` (``_data``), not a
tensor subclass: tensors flow unwrapped inside the port's modules and
kernel wrappers, and only an ``nd.*`` call or a ``Block`` call wraps and
unwraps at the boundary.

Mutation follows the reference's ``_rebind``: ``x[:] = v``, ``x += y``
and ``copyto`` point the handle at a new tensor rather than writing in
place (an in-place write on a leaf that requires a gradient raises in
PyTorch).  An array over a Gluon parameter (``Parameter.data()``) is the
exception: its writes go into the parameter's own tensor, in place, so
the module sees them.

Divergences: ``dtype`` is a numpy dtype where numpy has one and the
``torch.dtype`` otherwise (bfloat16), and ``asnumpy()`` of a bfloat16
array is float32; there is no engine, so ``wait_to_read`` synchronizes
the card.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import autograd
from .. import device as _device
from ..context import Context, cpu, current_context, gpu

__all__ = ["NDArray", "array", "concatenate", "waitall", "from_numpy",
           "save", "load"]

_NP_DTYPES = {torch.float16: np.float16, torch.float32: np.float32,
              torch.float64: np.float64, torch.int8: np.int8,
              torch.uint8: np.uint8, torch.int16: np.int16,
              torch.int32: np.int32, torch.int64: np.int64,
              torch.bool: np.bool_}


def _torch_dtype(dtype):
    """A :class:`torch.dtype` from a name, numpy dtype or torch dtype."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    name = np.dtype(dtype).name if not isinstance(dtype, str) else dtype
    return {"bool": torch.bool}.get(name) or getattr(torch, name)


def _context_of(t):
    if t.device.type == "cuda":
        return gpu(t.device.index or 0)
    return cpu()


class NDArray:
    """Handle around one tensor, with the reference's imperative face:
    arithmetic, comparisons (0/1 arrays), indexing, the shape methods,
    ``attach_grad``/``grad``/``backward``, ``asnumpy``."""

    __slots__ = ("_data", "_grad", "_grad_req", "__weakref__")

    def __init__(self, data, ctx=None):
        if isinstance(data, NDArray):
            data = data._data
        elif not isinstance(data, torch.Tensor):
            data = torch.as_tensor(np.asarray(data))
        if ctx is not None:
            data = data.to(_device.resolve(ctx))
        self._data = data
        self._grad = None
        self._grad_req = "null"

    # -- meta -------------------------------------------------------------
    @property
    def shape(self):
        return tuple(self._data.shape)

    @property
    def dtype(self):
        t = self._data.dtype
        return np.dtype(_NP_DTYPES[t]) if t in _NP_DTYPES else t

    @property
    def size(self):
        return self._data.numel()

    @property
    def ndim(self):
        return self._data.dim()

    @property
    def context(self):
        return _context_of(self._data)

    ctx = context

    @property
    def stype(self):
        return "default"

    # -- gradients ----------------------------------------------------------
    @property
    def grad(self):
        return self._grad

    def _make_leaf(self):
        """Make ``_data`` a leaf that requires a gradient."""
        t = self._data
        if not (t.is_leaf and t.requires_grad):
            self._data = t.detach().requires_grad_(True)

    def attach_grad(self, grad_req="write", stype=None):
        """Give the array a zero gradient buffer; :func:`backward` then
        writes (``"write"``) or adds (``"add"``) its gradient there.
        Gradients are dense whatever ``stype`` says, as in the
        reference."""
        self._make_leaf()
        self._grad = NDArray(torch.zeros_like(self._data))
        self._grad_req = grad_req
        autograd._register(self)

    def drop_grad(self):
        self._grad = None
        self._grad_req = "null"

    def _deposit(self, g):
        """Write or add gradient ``g`` into the buffer (under no_grad)."""
        buf = self._grad._data
        if self._grad_req == "add":
            buf.add_(g.to(buf.dtype))
        else:
            buf.copy_(g)

    def backward(self, out_grad=None, retain_graph=False, train_mode=True):
        """Gradients from this array into every attached leaf
        (:func:`tpu_mx_torch.autograd.backward`)."""
        autograd.backward([self], None if out_grad is None else [out_grad],
                          retain_graph=retain_graph, train_mode=train_mode)

    def detach(self):
        return NDArray(self._data.detach())

    # -- transfer -----------------------------------------------------------
    def asnumpy(self):
        """A numpy copy (float32 for bfloat16)."""
        t = self._data.detach()
        if t.dtype not in _NP_DTYPES:
            t = t.float()
        a = t.cpu().numpy()
        return a.copy() if t.device.type == "cpu" else a

    def asscalar(self):
        if self.size != 1:
            raise ValueError("The current array is not a scalar")
        return self.asnumpy().reshape(())[()]

    item = asscalar

    def tolist(self):
        return self.asnumpy().tolist()

    def __array__(self, dtype=None, copy=None):
        a = self.asnumpy()
        return a.astype(dtype) if dtype is not None else a

    def copy(self):
        return NDArray(self._data.detach().clone())

    def copyto(self, other):
        """Into array ``other`` (rebinding it) or onto a context (a new
        array)."""
        if isinstance(other, NDArray):
            if other.shape != self.shape:
                raise ValueError(f"copyto shape mismatch {self.shape} vs "
                                 f"{other.shape}")
            other._rebind(self._data.detach().to(other._data.device,
                                                  other._data.dtype))
            return other
        if isinstance(other, Context):
            return NDArray(self._data.detach(), ctx=other)
        raise TypeError(f"copyto: unsupported target {type(other)}")

    def as_in_context(self, ctx):
        if ctx == self.context:
            return self
        return NDArray(self._data.detach(), ctx=ctx)

    as_in_ctx = as_in_context

    def astype(self, dtype, copy=True):
        from . import ops
        return ops.cast(self, dtype=dtype)

    def wait_to_read(self):
        """Wait until the card has computed this array."""
        if self._data.is_cuda:
            torch.cuda.current_stream(self._data.device).synchronize()
        return self

    wait_to_write = wait_to_read

    # -- mutation -----------------------------------------------------------
    def _rebind(self, t):
        """Point the handle at tensor ``t`` (the reference's in-place
        write).  An attached leaf stays an attached leaf unless ``t``
        was recorded from it."""
        if self._grad is not None and t.grad_fn is None \
                and t.is_floating_point():
            t = t.detach().requires_grad_(True)
        self._data = t

    def __setitem__(self, key, value):
        v = value._data if isinstance(value, NDArray) else value
        t = self._data.detach().clone()
        t[_index(key)] = torch.as_tensor(v, dtype=t.dtype, device=t.device)
        self._rebind(t)

    def __getitem__(self, key):
        from . import ops
        return ops._apply(lambda t: t[_index(key)], (self,), {})

    def _inplace(self, o, name):
        from . import ops
        self._rebind(getattr(ops, name)(self, o)._data)
        return self

    def __iadd__(self, o):
        return self._inplace(o, "add")

    def __isub__(self, o):
        return self._inplace(o, "subtract")

    def __imul__(self, o):
        return self._inplace(o, "multiply")

    def __itruediv__(self, o):
        return self._inplace(o, "divide")

    # -- arithmetic (the ops of ndarray/ops.py) -----------------------------
    def _binop(self, other, name, reflected=False):
        from . import ops
        f = getattr(ops, name)
        return f(other, self) if reflected else f(self, other)

    def __add__(self, o): return self._binop(o, "add")
    def __radd__(self, o): return self._binop(o, "add", True)
    def __sub__(self, o): return self._binop(o, "subtract")
    def __rsub__(self, o): return self._binop(o, "subtract", True)
    def __mul__(self, o): return self._binop(o, "multiply")
    def __rmul__(self, o): return self._binop(o, "multiply", True)
    def __truediv__(self, o): return self._binop(o, "divide")
    def __rtruediv__(self, o): return self._binop(o, "divide", True)
    def __mod__(self, o): return self._binop(o, "mod")
    def __rmod__(self, o): return self._binop(o, "mod", True)
    def __pow__(self, o): return self._binop(o, "power")
    def __rpow__(self, o): return self._binop(o, "power", True)
    def __eq__(self, o): return self._binop(o, "equal")
    def __ne__(self, o): return self._binop(o, "not_equal")
    def __gt__(self, o): return self._binop(o, "greater")
    def __ge__(self, o): return self._binop(o, "greater_equal")
    def __lt__(self, o): return self._binop(o, "lesser")
    def __le__(self, o): return self._binop(o, "lesser_equal")
    __hash__ = object.__hash__

    def __neg__(self):
        from . import ops
        return ops.negative(self)

    def __abs__(self):
        from . import ops
        return ops.abs(self)

    def __len__(self):
        if not self.shape:
            raise TypeError("len() of a 0-d NDArray")
        return self.shape[0]

    def __bool__(self):
        if self.size != 1:
            raise ValueError("ambiguous truth value of multi-element NDArray")
        return bool(self.asscalar())

    def __float__(self):
        return float(self.asscalar())

    def __int__(self):
        return int(self.asscalar())

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def __repr__(self):
        return f"\n{self.asnumpy()}\n<NDArray {self.shape} @{self.context}>"

    # -- method forms ---------------------------------------------------------
    def reshape(self, *shape, **kwargs):
        from . import ops
        if len(shape) == 1 and isinstance(shape[0], (list, tuple)):
            shape = tuple(shape[0])
        return ops.reshape(self, shape=kwargs.get("shape", shape))

    def reshape_like(self, other):
        return self.reshape(other.shape)

    def broadcast_like(self, other):
        return self.broadcast_to(other.shape)

    @property
    def T(self):
        return self.transpose()


def _method(name):
    def method(self, *args, **kwargs):
        from . import ops
        return getattr(ops, name)(self, *args, **kwargs)
    method.__name__ = name
    method.__doc__ = f"Method form of ``nd.{name}``."
    return method


for _name in ("transpose", "flatten", "expand_dims", "squeeze",
              "broadcast_to", "slice_axis", "clip", "abs", "sqrt", "square",
              "exp", "log", "sum", "mean", "max", "min", "prod", "argmax",
              "argmin", "norm", "softmax", "log_softmax", "one_hot", "take",
              "split", "pick", "sign", "relu", "sigmoid", "tanh", "dot",
              "zeros_like", "ones_like", "swapaxes", "flip", "tile",
              "repeat", "round", "floor", "ceil"):
    setattr(NDArray, _name, _method(_name))
del _name


def _index(key):
    """An indexing key with arrays unwrapped (float index arrays as
    integers)."""
    def one(k):
        if isinstance(k, NDArray):
            k = k._data
        if isinstance(k, torch.Tensor) and k.is_floating_point():
            k = k.long()
        return k
    return tuple(one(k) for k in key) if isinstance(key, tuple) else one(key)


def array(source_array, ctx=None, dtype=None):
    """``nd.array``: a new array on ``ctx`` (default: the current context,
    the card unless ``with mx.cpu():``).  float64 sources become float32,
    as in the reference."""
    if isinstance(source_array, NDArray):
        src = source_array._data.detach()
    elif isinstance(source_array, torch.Tensor):
        src = source_array.detach()
    else:
        a = np.asarray(source_array)
        src = torch.as_tensor(a if a.flags.c_contiguous else a.copy())
    dt = _torch_dtype(dtype)
    if dt is None:
        dt = torch.float32 if src.dtype == torch.float64 else src.dtype
    dev = _device.resolve(ctx if ctx is not None else current_context())
    return NDArray(src.to(device=dev, dtype=dt, copy=True))


def from_numpy(a, zero_copy=False):
    return array(a)


def waitall():
    """Wait for every launch queued on the card."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def concatenate(arrays, axis=0):
    from . import ops
    return ops.concat(*arrays, dim=axis)


def save(fname, data):
    """``nd.save`` of an array, a list or a dict of arrays, in the port's
    own format (``torch.save`` of host tensors; the reference's ``.npz``
    container is not read or written: ROADMAP A1)."""
    if isinstance(data, NDArray):
        data = [data]
    if isinstance(data, (list, tuple)):
        payload = [a._data.detach().cpu() for a in data]
    elif isinstance(data, dict):
        payload = {k: v._data.detach().cpu() for k, v in data.items()}
    else:
        raise TypeError("save: need NDArray, list or dict of NDArray")
    torch.save(payload, fname)


def load(fname, ctx=None):
    """What :func:`save` wrote, as arrays on ``ctx`` (default: the
    current context)."""
    payload = torch.load(fname, map_location="cpu", weights_only=True)
    if isinstance(payload, dict):
        return {k: array(v, ctx=ctx) for k, v in payload.items()}
    return [array(v, ctx=ctx) for v in payload]
