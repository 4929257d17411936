"""What the port's layers share with the reference's ``gluon/block.py``:
the reference's parameter order, ``cast``, ``initialize``, and loading
the reference's weights.

The port's blocks are :class:`torch.nn.Module`s.  A parameter is a
:class:`torch.nn.Parameter`; a running statistic (BatchNorm's
``running_mean``/``running_var``, the reference's ``grad_req="null"``
parameters) is a buffer.  Parameters exist from construction on, drawn
with each one's own initializer or the reference's default
``Uniform(0.07)``: the port has no deferred initialization, so
:meth:`HybridBlock.initialize` draws them again.  Not ported yet
(ROADMAP A4): ``hybridize``, ``Parameter``/``ParameterDict``,
``save_parameters``/``load_parameters``.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .. import device as _device
from .. import initializer as _init
from .. import random as _random
from ..base import MXNetError

__all__ = ["HybridBlock", "as_dtype", "default_generator", "load_numpy",
           "reference_tensors"]

_DTYPES = {"float32": torch.float32, "float16": torch.float16,
           "bfloat16": torch.bfloat16}


def as_dtype(dtype):
    """A :class:`torch.dtype` from a reference dtype name or a dtype."""
    return _DTYPES[dtype] if isinstance(dtype, str) else dtype


def default_generator(generator):
    """``generator``, or with None the process's generator on the card
    (:func:`tpu_mx_torch.random.generator`), which raises without one."""
    if generator is not None:
        return generator
    return _random.generator(_device.resolve())


def reference_tensors(module):
    """``(name, tensor, owner, leaf)`` for every parameter and buffer of
    ``module`` in the reference's ``collect_params()`` order: each block's
    own parameters, then its own running statistics, then its children
    in the order they were added, depth first.  A tensor that two blocks
    share (a tied decoder's weight) comes once, where it is first
    met."""
    seen = set()
    for prefix, owner in module.named_modules():
        for leaf, t in list(owner._parameters.items()) \
                + list(owner._buffers.items()):
            if t is not None and id(t) not in seen:
                seen.add(id(t))
                yield (f"{prefix}.{leaf}" if prefix else leaf), t, owner, leaf


def _axes_of(owner, leaf):
    """How ``owner`` stores ``leaf`` against the reference's array: the
    axes that take the reference's array to the port's tensor, or None
    where both have one shape."""
    return getattr(owner, "_axes", {}).get(leaf)


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


class HybridBlock(nn.Module):
    """Base of the port's Gluon layers and model-zoo blocks.

    A layer declares each tensor with :meth:`_declare`: its reference
    name and shape, its own initializer, and, where the port stores it in
    another order, the axes that take the reference's array to it."""

    def __init__(self):
        super().__init__()
        self._inits = {}
        self._axes = {}

    def _declare(self, leaf, shape, init, dtype, generator, *, aux=False,
                 grad=True, axes=None):
        """Register parameter (or, with ``aux``, running statistic)
        ``leaf`` of the reference's ``shape``, drawn by ``init`` (None: the
        default) from ``generator`` in ``dtype``; ``axes`` permutes the
        draw into the port's order (a view: a channels-last weight keeps
        its channels-last strides)."""
        data = _init.create(init)(leaf, tuple(shape), dtype, generator)
        if axes is not None:
            data = data.permute(axes)
            self._axes[leaf] = tuple(axes)
        self._inits[leaf] = init
        if aux:
            self.register_buffer(leaf, data)
        else:
            self.register_parameter(leaf, nn.Parameter(data,
                                                       requires_grad=grad))

    def collect_params(self):
        """``{name: tensor}`` of every parameter and running statistic,
        in the reference's order (:func:`reference_tensors`)."""
        return {name: t for name, t, _, _ in reference_tensors(self)}

    def cast(self, dtype):
        """Cast every floating parameter and running statistic to
        ``dtype`` (``"bfloat16"`` or a :class:`torch.dtype`), as the
        reference's ``Block.cast`` does; memory formats are kept."""
        return self.to(as_dtype(dtype))

    def initialize(self, init=None, generator=None):
        """Draw every parameter and running statistic again, in place:
        each with its own initializer if it was given one (a layer's
        ``weight_initializer``, ``"zeros"`` for biases, ...), else with
        ``init`` (a name such as ``"xavier"``, an initializer, or None for
        ``Uniform(0.07)``), as the reference's ``initialize(init)`` does.
        Draws come from ``generator`` (default: the process's generator
        for the net's device) at the reference's shapes, so a fan is the
        reference's."""
        tensors = list(reference_tensors(self))
        if generator is None:
            generator = _random.generator(tensors[0][1].device)
        with torch.no_grad():
            for _, t, owner, leaf in tensors:
                own = getattr(owner, "_inits", {}).get(leaf)
                axes = _axes_of(owner, leaf)
                shape = list(t.shape)
                if axes is not None:
                    for i, a in enumerate(axes):
                        shape[a] = t.shape[i]
                data = _init.create(own if own is not None else init)(
                    leaf, tuple(shape), t.dtype, generator)
                t.copy_(data if axes is None else data.permute(axes))
        return self
