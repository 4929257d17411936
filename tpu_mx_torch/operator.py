"""Custom operators, from ``tpu_mx/operator.py``: a user's operator with
a Python ``forward``/``backward``, invoked as ``nd.Custom(*args,
op_type=name)``.

The reference's three classes and its protocol: :class:`CustomOpProp`
describes the operator (arguments, outputs, shapes, types) and makes it
(``create_operator``); :class:`CustomOp` computes it, writing its
outputs and input gradients through ``assign`` under the ``req``
protocol; :func:`register` files a ``CustomOpProp`` under a name.  The
forward runs with recording paused; when the inputs are recorded, the
outputs are joined to PyTorch's tape by a ``torch.autograd.Function``
whose backward calls the user's ``backward`` with the gradients that
reach the outputs (the reference's pullback).
"""
from __future__ import annotations

import torch

from .base import MXNetError

__all__ = ["CustomOp", "CustomOpProp", "register", "get_all_registered"]

_registry = {}


class CustomOp:
    """Base class: override ``forward`` and ``backward``.  Use
    ``self.assign(dst, req, src)`` to honour the write/add/null request
    as the reference does."""

    def forward(self, is_train, req, in_data, out_data, aux):
        raise NotImplementedError

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        raise NotImplementedError

    @staticmethod
    def assign(dst, req, src):
        if req == "null":
            return
        if req in ("write", "inplace"):
            dst[:] = src
        elif req == "add":
            dst[:] = dst + src
        else:
            raise MXNetError(f"unknown req {req!r}")


class CustomOpProp:
    """An operator's description: its argument, output and auxiliary
    names, shapes and types, and the factory of its :class:`CustomOp`.
    ``need_top_grad`` says whether its backward reads the output
    gradients (``declare_backward_dependency``)."""

    def __init__(self, need_top_grad=True):
        self.need_top_grad_ = need_top_grad

    def list_arguments(self):
        return ["data"]

    def list_outputs(self):
        return ["output"]

    def list_auxiliary_states(self):
        return []

    def infer_shape(self, in_shape):
        return in_shape, [in_shape[0]], []

    def infer_type(self, in_type):
        return in_type, [in_type[0]] * len(self.list_outputs()), []

    def create_operator(self, ctx, shapes, dtypes):
        raise NotImplementedError

    def declare_backward_dependency(self, out_grad, in_data, out_data):
        deps = []
        if self.need_top_grad_:
            deps.extend(out_grad)
        deps.extend(in_data)
        deps.extend(out_data)
        return deps


def register(reg_name):
    """Class decorator: ``@mx.operator.register("my_op")`` on a
    :class:`CustomOpProp` subclass."""
    def wrap(prop_cls):
        if not issubclass(prop_cls, CustomOpProp):
            raise MXNetError("register() expects a CustomOpProp subclass")
        _registry[reg_name] = prop_cls
        return prop_cls
    return wrap


def get_all_registered():
    return dict(_registry)


class _Custom(torch.autograd.Function):
    """The outputs of a custom operator's forward, already computed, on
    the tape; backward runs the user's ``backward``."""

    @staticmethod
    def forward(ctx, run, *inputs):
        ctx.run = run
        return tuple(o._data.detach().clone() for o in run.out_data)

    @staticmethod
    def backward(ctx, *grads):
        return (None,) + tuple(ctx.run.backward(grads))


class _Run:
    def __init__(self, op, in_data, out_data, aux, in_shapes, in_types,
                 device):
        self.op, self.in_data, self.out_data, self.aux = \
            op, in_data, out_data, aux
        self.in_shapes, self.in_types, self.device = \
            in_shapes, in_types, device

    def backward(self, grads):
        from . import autograd
        from .ndarray import NDArray
        in_grad = [NDArray(torch.zeros(s, dtype=t, device=self.device))
                   for s, t in zip(self.in_shapes, self.in_types)]
        with autograd.pause():
            self.op.backward(req=["write"] * len(in_grad),
                             out_grad=[NDArray(g) for g in grads],
                             in_data=self.in_data, out_data=self.out_data,
                             in_grad=in_grad, aux=self.aux)
        return [g._data for g in in_grad]


def _invoke_custom(args, op_type, **op_params):
    """``nd.Custom``: make the operator, run its forward, and, when the
    inputs are recorded, put its outputs on the tape."""
    from . import autograd
    from .context import current_context
    from .ndarray import NDArray
    from .ndarray.ndarray import _torch_dtype

    if op_type not in _registry:
        raise MXNetError(f"custom op {op_type!r} is not registered "
                         f"(known: {sorted(_registry)})")
    prop = _registry[op_type](**op_params)
    in_shapes = [tuple(a.shape) for a in args]
    in_types = [a.dtype for a in args]
    _, out_shapes, aux_shapes = prop.infer_shape(list(in_shapes))
    _, out_types, _ = prop.infer_type(list(in_types))
    op = prop.create_operator(current_context(), in_shapes, in_types)
    device = args[0]._data.device
    in_data = list(args)
    out_data = [NDArray(torch.zeros(s, dtype=_torch_dtype(t), device=device))
                for s, t in zip(out_shapes, out_types)]
    aux = [NDArray(torch.zeros(s, dtype=torch.float32, device=device))
           for s in aux_shapes]
    with autograd.pause():
        op.forward(is_train=autograd.is_recording(),
                   req=["write"] * len(out_data), in_data=in_data,
                   out_data=out_data, aux=aux)
    tensors = [a._data for a in in_data]
    if autograd.is_recording() and any(t.requires_grad for t in tensors):
        run = _Run(op, in_data, out_data, aux, in_shapes,
                   [_torch_dtype(t) for t in in_types], device)
        out_data = [NDArray(t) for t in _Custom.apply(run, *tensors)]
    return out_data[0] if len(out_data) == 1 else out_data
