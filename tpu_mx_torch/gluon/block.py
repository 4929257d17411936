"""Gluon ``Block`` / ``HybridBlock``, from ``tpu_mx/gluon/block.py``.

The port's blocks are :class:`torch.nn.Module`s.  A trainable tensor is
a :class:`torch.nn.Parameter`; a running statistic (BatchNorm's
``running_mean``/``running_var``, the reference's ``grad_req="null"``
parameters) is a buffer; :class:`~tpu_mx_torch.gluon.parameter.Parameter`
is the reference's handle onto either.  A layer declares each tensor
with :meth:`Block._declare`: its reference name and shape, its own
initializer and, where the port stores it in another order (a
channels-last convolution's weight), the axes that take the reference's
array to it.  A tensor whose shape is known is drawn at construction
(with the layer's initializer, or the reference's default
``Uniform(0.07)``); one with an unknown input size (``in_units=0``) is
drawn at the first forward, after ``initialize()``.

Calling a block with :class:`~tpu_mx_torch.ndarray.NDArray` arguments is
the imperative boundary: a :class:`HybridBlock` unwraps them, sets every
module's training mode from ``autograd.is_training()``, runs its forward
on tensors under ``torch.set_grad_enabled(autograd.is_recording())`` and
wraps what it returns.  Called with tensors (inside another block, or by
``CompiledTrainStep``) it is a plain ``nn.Module`` call.  A
:class:`Block` (a ``forward`` written on arrays) passes its arguments on
as they are.

Parameters carry the reference's per-instance names (``dense0_weight``).
``collect_params()`` lists them in the reference's order (each block's
own parameters, then its own running statistics, then its children in
the order they were added, depth first), keyed by structural name
(``0.weight``, as the port's earlier slices keyed it; a parameter is
found by its name too); ``save_parameters`` names them by structure in
the port's own file format.

``hybridize()`` keeps the reference's observable contract (the flag; the
first call resolves deferred shapes; the results are those of the
unhybridized forward) and runs the same eager forward: capture into a
CUDA graph is open work (ROADMAP A8), and ``export``/``optimize_for``
refuse by name.
"""
from __future__ import annotations

import threading

import numpy as np
import torch
from torch import nn

from .. import autograd
from .. import device as _device
from .. import initializer as _init
from .. import random as _random
from ..base import MXNetError, refuse_unported
from ..context import current_context
from ..ndarray.ops import _holds_array, _unwrap, _wrap
from .parameter import Parameter, ParameterDict, _incomplete

__all__ = ["Block", "HybridBlock", "HookHandle", "as_dtype",
           "default_generator", "load_numpy", "reference_tensors"]

_DTYPES = {"float32": torch.float32, "float16": torch.float16,
           "bfloat16": torch.bfloat16, "float64": torch.float64}

_NAME_COUNTER = {}
_NAME_LOCK = threading.Lock()


def _gen_prefix(hint):
    """The reference's per-instance prefix: ``dense0_``, ``dense1_``..."""
    with _NAME_LOCK:
        idx = _NAME_COUNTER.get(hint, 0)
        _NAME_COUNTER[hint] = idx + 1
    return f"{hint}{idx}_"


def as_dtype(dtype):
    """A :class:`torch.dtype` from a reference dtype name or a dtype."""
    return _DTYPES[dtype] if isinstance(dtype, str) else dtype


def default_generator(generator):
    """``generator``, or with None the process's generator for the
    current context's device (:func:`tpu_mx_torch.random.generator`; the
    card unless ``with mx.cpu():``), which raises without a card."""
    if generator is not None:
        return generator
    return _random.generator(_device.resolve(current_context()))


def reference_tensors(module):
    """``(name, tensor, owner, leaf)`` for every parameter and buffer of
    ``module`` in the reference's ``collect_params()`` order: each block's
    own parameters, then its own running statistics, then its children
    in the order they were added, depth first.  A tensor that two blocks
    share (a tied decoder's weight) comes once, where it is first
    met."""
    for name, p in _slots(module):
        t = p._tensor()
        if t is not None:
            yield name, t, p._owner, p._leaf


def _reg_params(owner):
    """``owner``'s ``{leaf: Parameter}``, made on first use for a plain
    ``nn.Module``."""
    reg = owner.__dict__.get("_reg_params")
    if reg is None:
        reg = owner.__dict__["_reg_params"] = {}
    return reg


def _prefix_of(owner):
    prefix = owner.__dict__.get("_prefix")
    if prefix is None:
        prefix = owner.__dict__["_prefix"] = _gen_prefix(
            type(owner).__name__.lower())
    return prefix


def _wrap_slot(owner, leaf, t, aux):
    """A :class:`Parameter` over a tensor a plain module registered."""
    p = Parameter(_prefix_of(owner) + leaf,
                  grad_req="write" if t.requires_grad else "null",
                  shape=tuple(t.shape), dtype=t.dtype)
    p._owner, p._leaf, p._aux = owner, leaf, aux
    if not aux:
        autograd._register(p._nd())
    _reg_params(owner)[leaf] = p
    return p


def _slots(module):
    """``(structural name, Parameter)`` for every slot of ``module``
    (deferred ones included), in the reference's order, each tensor
    once."""
    seen = set()
    for path, owner in module.named_modules():
        reg = _reg_params(owner)
        for aux, slots in ((False, owner._parameters), (True, owner._buffers)):
            for leaf, t in list(slots.items()):
                p = reg.get(leaf)
                if p is None:
                    if t is None:
                        continue
                    p = _wrap_slot(owner, leaf, t, aux)
                key = id(t) if t is not None else id(p)
                if key in seen:
                    continue
                seen.add(key)
                yield (f"{path}.{leaf}" if path else leaf), p


def _axes_of(owner, leaf):
    """How ``owner`` stores ``leaf`` against the reference's array: the
    axes that take the reference's array to the port's tensor, or None
    where both have one shape."""
    p = owner.__dict__.get("_reg_params", {}).get(leaf)
    return None if p is None else p._axes


def load_numpy(module, params):
    """Set every parameter and running statistic of ``module`` from
    ``params``, the reference's ``collect_params()`` as numpy arrays in
    the reference's (structural) order.  Reference names carry
    per-instance prefixes (``conv2d3_weight``), so the i-th array goes to
    the i-th tensor of :func:`reference_tensors`, after checking that its
    name ends in the tensor's name and that the shapes agree: every array
    is consumed once and every tensor is set.  A tensor the port stores
    in another order (a channels-last convolution's weight, the
    reference's ``(O, kh, kw, I)``) takes the array transposed."""
    ours = list(reference_tensors(module))
    theirs = list(params.items())
    if len(ours) != len(theirs):
        raise MXNetError(f"from_numpy: {len(theirs)} arrays for "
                         f"{len(ours)} parameters")
    with torch.no_grad():
        for (name, t, owner, leaf), (ref, arr) in zip(ours, theirs):
            if not (ref == leaf or ref.endswith(("_" + leaf, "." + leaf))):
                raise MXNetError(f"from_numpy: array {ref!r} does not "
                                 f"match parameter {name!r}")
            arr = np.array(arr, dtype=np.float32)
            axes = _axes_of(owner, leaf)
            if axes is not None and arr.ndim == len(axes):
                arr = arr.transpose(axes)
            if tuple(arr.shape) != tuple(t.shape):
                raise MXNetError(f"from_numpy: {ref!r} has shape "
                                 f"{arr.shape}, {name!r} wants "
                                 f"{tuple(t.shape)}")
            t.copy_(torch.from_numpy(arr))
    return module


class HookHandle:
    """Removable handle of a forward hook (``detach``/``remove``)."""

    def __init__(self, hooks, hook):
        self._hooks, self._hook = hooks, hook

    def detach(self):
        if self._hooks is not None and self._hook in self._hooks:
            self._hooks.remove(self._hook)
        self._hooks = None

    remove = detach

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.detach()


class Block(nn.Module):
    """Define-by-run block: a subclass writes ``forward`` on arrays (or
    tensors) and gets the reference's Gluon surface: a per-instance
    ``prefix``, ``params``, ``collect_params``, ``initialize``, ``cast``,
    ``save_parameters``/``load_parameters``, forward hooks."""

    def __init__(self, prefix=None, params=None):
        super().__init__()
        self._prefix = prefix if prefix is not None else \
            _gen_prefix(type(self).__name__.lower())
        self._params = ParameterDict(self._prefix, shared=params)
        self._reg_params = {}
        self._deferred = []
        self._fwd_hooks = []
        self._fwd_pre_hooks = []
        self._active = False

    def __setattr__(self, name, value):
        if isinstance(value, Parameter):
            self.__dict__.get("_reg_params", {})[name] = value
            value._bind(self, name)
            if value._tensor() is None:
                self._deferred.append(value)
            object.__setattr__(self, name, value)
        else:
            super().__setattr__(name, value)

    def _declare(self, leaf, shape, init, dtype, generator, *, aux=False,
                 grad=True, axes=None):
        """Register parameter (or, with ``aux``, running statistic)
        ``leaf`` of the reference's ``shape``, drawn by ``init`` (None:
        the default) from ``generator`` in ``dtype`` now, or at the first
        forward where ``shape`` has a 0 (an input size to infer).
        ``axes`` permutes the draw into the port's order (a view: a
        channels-last weight keeps its channels-last strides)."""
        stored = tuple(shape) if axes is None else \
            tuple(shape[a] for a in axes)
        p = Parameter(self._prefix + leaf,
                      grad_req="null" if aux or not grad else "write",
                      shape=stored, dtype=dtype, init=init,
                      allow_deferred_init=True)
        p._bind(self, leaf, aux, None if axes is None else tuple(axes))
        self._reg_params[leaf] = p
        self._params._params[p.name] = p
        if _incomplete(shape):
            self._deferred.append(p)
            return p
        data = _init.create(init)(leaf, tuple(shape), dtype, generator)
        p._set_tensor(data if axes is None else data.permute(axes))
        return p

    # -- names ----------------------------------------------------------------
    @property
    def prefix(self):
        return self._prefix

    @property
    def name(self):
        return self._prefix.rstrip("_")

    @property
    def params(self):
        """This block's own parameters (not its children's)."""
        return self._params

    def collect_params(self, select=None):
        """Every parameter of this block and its children as one
        :class:`ParameterDict`, in the reference's order, keyed by
        structural name (``0.weight``) and found by its name
        (``dense0_weight``) too; ``select`` (a regular expression) keeps
        the parameters whose names it matches, as in the reference."""
        import re
        ret = ParameterDict(self._prefix)
        pat = re.compile(select) if select is not None else None
        for key, p in _slots(self):
            if pat is None or pat.match(p.name):
                ret._add(key, p)
        return ret

    # -- parameters -----------------------------------------------------------
    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False, generator=None):
        """Draw every parameter and running statistic: each with its own
        initializer if it was given one (a layer's
        ``weight_initializer``, ``"zeros"`` for biases, ...), else with
        ``init`` (a name such as ``"xavier"``, an initializer, or None for
        ``Uniform(0.07)``), as the reference's ``initialize(init)`` does.
        Tensors that exist are drawn again in place, at the reference's
        shapes (a fan is the reference's); deferred ones record ``init``
        and are drawn at the first forward.  Draws come from
        ``generator`` (default: the process's generator for each
        tensor's device; a generator is also taken in ``ctx``'s place).
        With ``ctx`` the block moves to that device first."""
        if isinstance(ctx, torch.Generator):
            generator, ctx = ctx, None
        if ctx is not None:
            self.to(_device.resolve(ctx))
        self.collect_params().initialize(init, ctx, verbose, force_reinit,
                                         generator)
        return self

    def cast(self, dtype):
        """Cast every floating parameter and running statistic to
        ``dtype`` (``"bfloat16"`` or a :class:`torch.dtype`), as the
        reference's ``Block.cast`` does; memory formats are kept, and a
        deferred parameter is drawn in ``dtype``."""
        dt = as_dtype(dtype)
        for _, p in _slots(self):
            if p._tensor() is None:
                p._dtype = dt
        return self.to(dt)

    def save_parameters(self, filename):
        """Every initialized tensor by its structural name (``0.weight``,
        ``encoder.ln.gamma``) in the port's own file format."""
        from ..ndarray.ndarray import save as nd_save
        nd_save(filename, {k: p.data() for k, p in _slots(self)
                           if p._tensor() is not None})

    def load_parameters(self, filename, ctx=None, allow_missing=False,
                        ignore_extra=False, cast_dtype=False):
        """Set the tensors from a :meth:`save_parameters` file; a missing
        or extra name, or a shape that does not match, raises."""
        from ..ndarray.ndarray import load as nd_load
        if ctx is None:
            t = next((p._tensor() for _, p in _slots(self)
                      if p._tensor() is not None), None)
            ctx = t.device if t is not None else None
        loaded = nd_load(filename, ctx=ctx)
        params = dict(_slots(self))
        for k, p in params.items():
            if k in loaded:
                p.set_data(loaded[k])
            elif not allow_missing:
                raise MXNetError(f"Parameter {k} missing in {filename}")
        extra = set(loaded) - set(params)
        if extra and not ignore_extra:
            raise MXNetError(f"Extra params in file: {sorted(extra)}")

    save_params = save_parameters
    load_params = load_parameters

    # -- calls ----------------------------------------------------------------
    def register_forward_hook(self, hook):
        """``hook(block, args, out)`` after each call, with what the
        caller passed and got."""
        self._fwd_hooks.append(hook)
        return HookHandle(self._fwd_hooks, hook)

    def register_forward_pre_hook(self, hook):
        """``hook(block, args)`` before each call."""
        self._fwd_pre_hooks.append(hook)
        return HookHandle(self._fwd_pre_hooks, hook)

    def _run(self, args, kwargs):
        return nn.Module.__call__(self, *args, **kwargs)

    def __call__(self, *args, **kwargs):
        for hook in self._fwd_pre_hooks:
            hook(self, args)
        out = self._run(args, kwargs)
        for hook in self._fwd_hooks:
            hook(self, args, out)
        return out

    def hybridize(self, active=True, **kwargs):
        """Set the hybridize flag of this block and every block under it
        (the port runs the same eager forward either way)."""
        for m in self.modules():
            if isinstance(m, Block):
                m._active = active

    def _resolve_deferred(self, args):
        """Infer and draw this block's deferred parameters from the
        first forward's inputs."""
        pending = [p for p in self._deferred if p._tensor() is None]
        if pending:
            if any(p._shape_incomplete() for p in pending):
                self.infer_shape(*args)
            tensors = [a for a in args if isinstance(a, torch.Tensor)]
            dev = tensors[0].device if tensors else \
                _device.resolve(current_context())
            for p in pending:
                p._finish_deferred_init(dev)
        self._deferred = []

    def infer_shape(self, *args):
        """Give this block's deferred parameters their shapes from
        example inputs (layers override it with their rule).  A block
        whose own parameters are deferred and that has no rule raises;
        otherwise one predict-mode forward finalizes the children."""
        own = [p.name for p in self._reg_params.values()
               if p._tensor() is None and p._shape_incomplete()]
        if own:
            raise MXNetError(
                f"{type(self).__name__} has deferred-shape parameters {own} "
                "but no infer_shape override; declare full shapes "
                "(in_units/in_channels/...) or override "
                "infer_shape(self, *args) with the block's shape rule")
        with autograd.predict_mode(), torch.no_grad():
            self(*args)

    def finalize_shapes(self, *args):
        """Draw every deferred parameter with one predict-mode forward
        over example inputs (nothing when every shape is known)."""
        if any(p._tensor() is None for p in self.collect_params().values()):
            with autograd.predict_mode(), torch.no_grad():
                self(*args)
        return self

    def export(self, path, epoch=0, **kwargs):
        raise MXNetError("HybridBlock.export is not ported yet (ROADMAP "
                         "A17: the port has no compiled program to write)")

    def optimize_for(self, *args, **kwargs):
        raise MXNetError("HybridBlock.optimize_for is not ported yet "
                         "(ROADMAP A8: hybridize runs the eager forward)")


class HybridBlock(Block):
    """Base of the port's layers, models and losses, and of user blocks
    written as ``hybrid_forward(self, F, x, **params)`` with ``F`` the
    port's ``nd`` namespace (its operators take and return tensors
    inside the forward; ``params`` are this block's own tensors by
    attribute name)."""

    def _run(self, args, kwargs):
        if _holds_array(args) or _holds_array(kwargs.values()):
            with torch.set_grad_enabled(autograd.is_recording()):
                self.train(autograd.is_training())
                return _wrap(self._run_tensors(
                    [_unwrap(a) for a in args],
                    {k: _unwrap(v) for k, v in kwargs.items()}))
        return self._run_tensors(args, kwargs)

    def _run_tensors(self, args, kwargs):
        if self._deferred:
            self._resolve_deferred(args)
        autograd._STATE.functional += 1
        try:
            return nn.Module.__call__(self, *args, **kwargs)
        finally:
            autograd._STATE.functional -= 1

    def forward(self, *args, **kwargs):
        from .. import ndarray as F
        params = {leaf: p._tensor() for leaf, p in self._reg_params.items()}
        return self.hybrid_forward(F, *args, **params, **kwargs)

    def hybrid_forward(self, F, *args, **kwargs):
        raise NotImplementedError

    def hybridize(self, active=True, static_alloc=False, static_shape=False,
                  backend=None, **kwargs):
        refuse_unported("HybridBlock.hybridize", "A8", backend=(backend, None))
        super().hybridize(active)
