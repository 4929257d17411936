"""Gluon ``Parameter`` / ``ParameterDict``, from ``tpu_mx/gluon/parameter.py``.

A port block keeps each of its tensors in PyTorch's slots: a trainable
one as a :class:`torch.nn.Parameter` in ``_parameters``, a running
statistic (the reference's ``grad_req="null"`` auxiliary state) as a
buffer.  A :class:`Parameter` is the reference's handle onto one slot:
``data()`` is an :class:`~tpu_mx_torch.ndarray.NDArray` over the
module's own tensor and ``grad`` one over its gradient (``tensor.grad``),
not copies, so an optimizer step through them is seen by the module.

Deferred initialization: a layer whose input size is not given
(``Dense(500)``, ``Conv2D(20, 5)``) registers an empty slot in its
declaration order.  ``initialize(init)`` records the initializer; the
first forward infers the shape (the layer's ``infer_shape``), draws the
tensor with it on the input's device and fills the slot, so
``collect_params()`` keeps the reference's order.  A forward before
``initialize()`` raises :class:`DeferredInitializationError`.  A tensor
whose shape is known is drawn when the layer is built (the port's draw);
``initialize`` draws it again.

For the callers of the earlier ``{name: tensor}`` dictionary, a
:class:`Parameter` also stands in for its tensor: attributes it does not
define (``detach``, ``dim``, ``fill_``, ...) are the tensor's, and
``torch`` functions take it (``__torch_function__``).  ``shape`` is the
tensor's (a channels-last convolution's weight is ``(O, I, kh, kw)`` with
channels-last strides) and ``dtype`` is a ``torch.dtype``.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .. import autograd
from .. import device as _device
from .. import initializer as _init
from .. import random as _random
from ..base import MXNetError, refuse_unported
from ..context import current_context
from ..ndarray.ndarray import NDArray, _torch_dtype

__all__ = ["Parameter", "Constant", "ParameterDict",
           "DeferredInitializationError"]


class DeferredInitializationError(MXNetError):
    """A parameter's shape is not known yet (no forward has run)."""


def _incomplete(shape):
    return shape is None or any(s in (0, None, -1) for s in shape)


class _ParamArray(NDArray):
    """The array of a :class:`Parameter`: reads and writes go to the
    parameter's own tensor (in place) and its gradient."""

    __slots__ = ("_param",)

    def __init__(self, param):
        self._param = param

    @property
    def _data(self):
        return self._param._tensor()

    @_data.setter
    def _data(self, t):
        self._rebind(t)

    @property
    def _grad(self):
        return self._param.grad

    @property
    def _grad_req(self):
        return self._param.grad_req

    def _make_leaf(self):
        pass

    def attach_grad(self, grad_req="write", stype=None):
        self._param.grad_req = grad_req

    def drop_grad(self):
        self._param.grad_req = "null"

    def _rebind(self, t):
        with torch.no_grad():
            self._param._tensor().copy_(t)

    def _deposit(self, g):
        t = self._param._tensor()
        if t.grad is None or t.grad.shape != t.shape \
                or t.grad.dtype != t.dtype:
            t.grad = g.to(t.dtype).clone()
        elif self._param.grad_req == "add":
            t.grad.add_(g.to(t.dtype))
        else:
            t.grad.copy_(g)


class Parameter:
    """A weight or running statistic of a block (the reference's
    ``Parameter``): ``grad_req`` ("write", "add" or "null"),
    ``lr_mult``/``wd_mult``, ``init``, deferred shapes."""

    def __init__(self, name, grad_req="write", shape=None, dtype="float32",
                 lr_mult=1.0, wd_mult=1.0, init=None,
                 allow_deferred_init=False, differentiable=True,
                 stype="default", grad_stype="default"):
        refuse_unported("Parameter", "A17 (sparse storage)",
                        stype=(stype, "default"),
                        grad_stype=(grad_stype, "default"))
        self.name = name
        self._grad_req = grad_req if differentiable else "null"
        self._shape = tuple(shape) if shape is not None else None
        self._dtype = _torch_dtype(dtype)
        self.lr_mult = lr_mult
        self.wd_mult = wd_mult
        self.init = init
        self.allow_deferred_init = allow_deferred_init
        self._owner = None       # the module whose slot holds the tensor
        self._leaf = None
        self._aux = False        # a buffer (running statistic)
        self._axes = None        # reference shape -> stored order
        self._own = None         # the tensor while bound to no module
        self._pending = None     # (init, generator) until the first forward
        self._array = None

    # -- the slot -------------------------------------------------------------
    def _bind(self, owner, leaf, aux=False, axes=None):
        """Make ``owner``'s slot ``leaf`` this parameter's home."""
        if self._owner is not None and self._owner is not owner:
            t = self._tensor()
            if t is None:
                raise MXNetError(f"Parameter {self.name}: sharing a "
                                 "parameter that is not initialized yet is "
                                 "not ported")
            slots = owner._buffers if aux else owner._parameters
            slots[leaf] = t
            return
        t = self._own
        self._owner, self._leaf, self._aux, self._axes = owner, leaf, aux, axes
        self._own = None
        (owner._buffers if aux else owner._parameters)[leaf] = t

    def _tensor(self):
        if self._owner is None:
            return self._own
        slots = self._owner._buffers if self._aux else \
            self._owner._parameters
        return slots.get(self._leaf)

    def _set_tensor(self, data):
        if not self._aux:
            data = nn.Parameter(data, requires_grad=self._grad_req != "null"
                                and data.is_floating_point())
        if self._owner is None:
            self._own = data
        else:
            (self._owner._buffers if self._aux else
             self._owner._parameters)[self._leaf] = data
        if not self._aux:
            autograd._register(self._nd())

    def _nd(self):
        if self._array is None:
            self._array = _ParamArray(self)
        return self._array

    # -- meta -----------------------------------------------------------------
    @property
    def shape(self):
        t = self._tensor()
        return tuple(t.shape) if t is not None else self._shape

    @shape.setter
    def shape(self, shape):
        if self._tensor() is not None:
            raise MXNetError(f"Parameter {self.name}: the shape of an "
                             "initialized parameter is fixed")
        self._shape = tuple(shape)

    @property
    def dtype(self):
        t = self._tensor()
        return t.dtype if t is not None else self._dtype

    @property
    def grad_req(self):
        return self._grad_req

    @grad_req.setter
    def grad_req(self, req):
        if req not in ("write", "add", "null"):
            raise ValueError(f"grad_req must be write, add or null: {req!r}")
        self._grad_req = req
        t = self._tensor()
        if t is not None and not self._aux and t.is_floating_point():
            t.requires_grad_(req != "null")
            if req == "null":
                t.grad = None

    def _shape_incomplete(self):
        return _incomplete(self.shape)

    def shape_hint(self, shape):
        """Fill the unknown (0) dims from an observed shape: ``shape`` is
        the reference's (for a channels-last weight, ``(O, kh, kw, I)``)."""
        ref = self._ref_shape()
        if ref is None:
            ref = tuple(shape)
        self._shape = self._stored(tuple(o if s in (0, None, -1) else s
                                         for s, o in zip(ref, shape)))

    def _ref_shape(self):
        """The shape in the reference's order (what an initializer sees)."""
        shape = self.shape
        if shape is None or self._axes is None:
            return shape
        ref = [0] * len(shape)
        for i, a in enumerate(self._axes):
            ref[a] = shape[i]
        return tuple(ref)

    def _stored(self, ref_shape):
        if self._axes is None:
            return tuple(ref_shape)
        return tuple(ref_shape[a] for a in self._axes)

    # -- initialization -------------------------------------------------------
    def _draw(self, init, generator, device):
        """A tensor of the reference's shape drawn by ``init`` on
        ``device``, permuted into the stored order."""
        g = generator if generator is not None else _random.generator(device)
        leaf = self._leaf or self.name
        data = _init.create(init)(leaf, self._ref_shape(), self.dtype, g)
        if self._axes is not None:
            data = data.permute(self._axes)
        return data.to(device)

    def initialize(self, init=None, ctx=None, default_init=None,
                   force_reinit=False, generator=None):
        """Draw the tensor with ``init`` (else the parameter's own
        initializer, else ``default_init``, else ``Uniform(0.07)``) from
        ``generator`` (default: the process's generator for its device).
        A tensor that exists is drawn again in place; one whose shape is
        unknown is drawn at the first forward."""
        initializer = init if init is not None else \
            self.init if self.init is not None else default_init
        t = self._tensor()
        if t is not None:
            with torch.no_grad():
                t.copy_(self._draw(initializer, generator, t.device))
            return
        if self._shape_incomplete():
            if not self.allow_deferred_init:
                raise DeferredInitializationError(
                    f"Parameter {self.name} has unknown shape {self.shape}")
            self._pending = (initializer, generator)
            return
        dev = _device.resolve(ctx if ctx is not None else current_context())
        self._pending = None
        self._set_tensor(self._init_data(initializer, generator, dev))

    def _init_data(self, initializer, generator, device):
        return self._draw(initializer, generator, device)

    def _finish_deferred_init(self, device):
        """Draw the tensor at the first forward (its shape is known)."""
        if self._pending is None:
            raise MXNetError(
                f"Parameter {self.name} has not been initialized. Call "
                ".initialize() on the block before the first forward pass "
                "(reference semantics)")
        if self._shape_incomplete():
            raise DeferredInitializationError(
                f"Parameter {self.name}: the shape {self.shape} is still "
                "unknown after inferring it from the input")
        initializer, generator = self._pending
        self._pending = None
        self._set_tensor(self._init_data(initializer, generator, device))

    def _is_pending(self):
        return self._tensor() is None

    # -- access ---------------------------------------------------------------
    def data(self, ctx=None):
        """The parameter's tensor as an array (no copy)."""
        if self._tensor() is None:
            if self._pending is not None or self._shape_incomplete():
                raise DeferredInitializationError(
                    f"Parameter {self.name} deferred-init pending; run a "
                    "forward pass with real data first")
            raise MXNetError(f"Parameter {self.name} not initialized")
        return self._nd()

    @property
    def grad(self):
        """The gradient buffer as an array (zeros before any backward)."""
        t = self._tensor()
        if t is None or self._grad_req == "null" or self._aux:
            raise MXNetError(f"Parameter {self.name} has no gradient buffer")
        if t.grad is None:
            t.grad = torch.zeros_like(t)
        return NDArray(t.grad)

    def zero_grad(self):
        t = self._tensor()
        if t is not None and t.grad is not None:
            t.grad.zero_()

    def set_data(self, data):
        """Set the value (an array, tensor or numpy array of the stored
        shape, or of the reference's for a channels-last weight); an
        uninitialized parameter takes the data's shape."""
        src = data._data.detach() if isinstance(data, NDArray) else \
            data.detach() if isinstance(data, torch.Tensor) else \
            torch.as_tensor(np.asarray(data))
        shape = tuple(src.shape)
        if self._axes is not None and shape == self._ref_shape() \
                and len(shape) == len(self._axes):
            src, shape = src.permute(self._axes), self._stored(shape)
        want = self.shape
        if want is not None and len(want) == len(shape):
            for w, g in zip(want, shape):
                if w not in (0, None, -1) and w != g:
                    raise MXNetError(
                        f"Parameter {self.name}: shape mismatch, declared "
                        f"{want} but got data of shape {shape}")
        elif want is not None and not _incomplete(want):
            raise MXNetError(f"Parameter {self.name}: rank mismatch, "
                             f"declared {want} but got data of shape {shape}")
        t = self._tensor()
        if t is None:
            dev = src.device if isinstance(data, (NDArray, torch.Tensor)) \
                else _device.resolve(current_context())
            self._shape, self._pending = shape, None
            self._set_tensor(src.to(device=dev, dtype=self._dtype,
                                    copy=True))
            return
        with torch.no_grad():
            t.copy_(src.to(t.device, t.dtype).reshape(t.shape))

    def cast(self, dtype):
        dt = _torch_dtype(dtype)
        self._dtype = dt
        t = self._tensor()
        if t is not None and t.is_floating_point():
            with torch.no_grad():
                t.data = t.data.to(dt)
                if t.grad is not None:
                    t.grad = t.grad.to(dt)

    def __repr__(self):
        return f"Parameter {self.name} (shape={self.shape}, " \
               f"dtype={self.dtype})"

    # -- standing in for the tensor -------------------------------------------
    def __getattr__(self, name):
        if name.startswith("__") or name in Parameter.__dict__:
            raise AttributeError(name)
        t = self.__dict__.get("_owner") is not None or \
            self.__dict__.get("_own") is not None
        tensor = self._tensor() if t else None
        if tensor is None:
            raise AttributeError(f"Parameter {self.__dict__.get('name')!r} "
                                 f"has no tensor yet for attribute {name!r}")
        return getattr(tensor, name)

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        def un(a):
            if isinstance(a, Parameter):
                return a._tensor()
            if isinstance(a, (list, tuple)):
                return type(a)(un(x) for x in a)
            return a
        return func(*un(args), **{k: un(v) for k, v in
                                  (kwargs or {}).items()})


class Constant(Parameter):
    """A parameter that keeps ``value`` and takes no gradient."""

    def __init__(self, name, value):
        value = np.asarray(value)
        super().__init__(name, grad_req="null", shape=value.shape,
                         dtype=value.dtype.name, differentiable=False)
        self._value = value

    def _init_data(self, initializer, generator, device):
        return torch.as_tensor(self._value, dtype=self._dtype, device=device)


class ParameterDict:
    """Ordered ``key -> Parameter`` with a prefix (the reference's
    ``ParameterDict``).  A dict made with :meth:`get` is keyed by the
    parameters' names (``prefix + name``); ``Block.collect_params()``
    keys each parameter by its structural name (``0.weight``, the port's
    keys since its first slices) and looks it up by either that or its
    name (``dense0_weight``)."""

    def __init__(self, prefix="", shared=None):
        self.prefix = prefix
        self._params = {}
        self._names = {}        # a parameter's name -> its key if other
        self._shared = shared

    def _add(self, key, param):
        self._params[key] = param
        if key != param.name:
            self._names[param.name] = key

    def get(self, name, **kwargs):
        """The parameter ``prefix + name``, made with ``kwargs`` if there
        is none (here or in the shared dict)."""
        full = self.prefix + name
        if full in self._params:
            return self._params[full]
        if self._shared is not None and full in self._shared._params:
            self._params[full] = self._shared._params[full]
            return self._params[full]
        p = Parameter(full, **kwargs)
        self._params[full] = p
        return p

    def get_constant(self, name, value=None):
        full = self.prefix + name
        if full not in self._params:
            self._params[full] = Constant(full, value)
        return self._params[full]

    def update(self, other):
        for k, v in other.items():
            self._add(k, v)

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False, generator=None):
        """Initialize every parameter, ``init`` being the default under
        each one's own initializer (the reference's rule)."""
        for p in self.values():
            p.initialize(None, ctx, default_init=init,
                         force_reinit=force_reinit, generator=generator)

    def zero_grad(self):
        for p in self.values():
            p.zero_grad()

    def setattr(self, name, value):
        for p in self.values():
            setattr(p, name, value)

    def save(self, fname, strip_prefix=""):
        """The initialized parameters by name (``strip_prefix`` cut), in
        the port's own file format (``nd.save``)."""
        from ..ndarray.ndarray import save as nd_save
        payload = {}
        for k, p in self._params.items():
            if p._tensor() is None:
                continue
            key = k[len(strip_prefix):] if k.startswith(strip_prefix) else k
            payload[key] = p.data()
        nd_save(fname, payload)

    def load(self, fname, ctx=None, allow_missing=False, ignore_extra=False,
             restore_prefix=""):
        from ..ndarray.ndarray import load as nd_load
        loaded = {restore_prefix + k: v for k, v in
                  nd_load(fname, ctx=ctx).items()}
        for k, p in self._params.items():
            if k in loaded:
                p.set_data(loaded[k])
            elif not allow_missing:
                raise MXNetError(f"Parameter {k} missing in file {fname}")
        extra = set(loaded) - set(self._params)
        if extra and not ignore_extra:
            raise MXNetError(f"Extra parameters in file: {sorted(extra)}")

    def items(self):
        return self._params.items()

    def keys(self):
        return self._params.keys()

    def values(self):
        return self._params.values()

    def __getitem__(self, k):
        if k not in self._params and k in self._names:
            k = self._names[k]
        return self._params[k]

    def __contains__(self, k):
        return k in self._params or k in self._names

    def __iter__(self):
        return iter(self._params)

    def __len__(self):
        return len(self._params)

    def __repr__(self):
        lines = "\n".join(f"  {p!r}" for p in self._params.values())
        return f"ParameterDict({self.prefix}\n{lines}\n)"
