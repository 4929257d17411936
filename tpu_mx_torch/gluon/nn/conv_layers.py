"""2-D convolution and pooling layers from ``gluon/nn/conv_layers.py``.

Every layer takes the reference's ``layout=``; None picks up the
thread-local default of :func:`tpu_mx_torch.layout.default_layout`.
Under a channels-last layout a layer takes and returns ``(N, H, W, C)``
tensors, as the reference does, and runs PyTorch's operator on the
``(N, C, H, W)``-shaped view of them, which has ``torch.channels_last``
strides (no copy).  A convolution's weight is an ``(O, I/g, kh, kw)``
parameter; channels-last it has ``channels_last`` strides and takes the
reference's ``(O, kh, kw, I/g)`` arrays transposed (``from_numpy``), and
its initializer sees the reference's shape (a fan is the reference's).
``in_channels=0`` is inferred at the first forward (the input's channel
axis), after ``initialize()``.

Not ported yet (ROADMAP): Conv1D/Conv3D, the transposed convolutions and
the 1-D/3-D pooling layers.
"""
from __future__ import annotations

import torch

from ... import layout as _layout
from ...ndarray import ops
from ..block import HybridBlock, as_dtype, default_generator
from .basic_layers import Activation

__all__ = ["Conv2D", "MaxPool2D", "AvgPool2D", "GlobalMaxPool2D",
           "GlobalAvgPool2D"]


def _tuple(v, n):
    return (v,) * n if isinstance(v, int) else tuple(v)


class Conv2D(HybridBlock):
    """2-D convolution, ``act(conv(x, W) + b)``."""

    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 dilation=(1, 1), groups=1, layout=None, in_channels=0,
                 activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", dtype=torch.float32,
                 generator=None, prefix=None, params=None):
        super().__init__(prefix, params)
        g, dt = default_generator(generator), as_dtype(dtype)
        self._channels = channels
        self._kernel = _tuple(kernel_size, 2)
        self._strides = _tuple(strides, 2)
        self._padding = _tuple(padding, 2)
        self._dilation = _tuple(dilation, 2)
        self._groups = groups
        self._layout = layout or _layout.get_default_layout(2)
        self._channels_last = _layout.is_channels_last(self._layout)
        axes = (0, 3, 1, 2) if self._channels_last else None
        self._declare("weight", self._weight_shape(in_channels),
                      weight_initializer, dt, g, axes=axes)
        if use_bias:
            self._declare("bias", (channels,), bias_initializer, dt, g)
        else:
            self.bias = None
        self.act = Activation(activation) if activation else None

    def _weight_shape(self, c_in):
        """The reference's weight shape: ``(O, I/g, kh, kw)``, or
        channels-last ``(O, kh, kw, I/g)``."""
        io = (self._channels, c_in // self._groups)
        if self._channels_last:
            return (io[0],) + self._kernel + (io[1],)
        return io + self._kernel

    def infer_shape(self, x, *args):
        c_in = x.shape[-1 if self._channels_last else 1]
        self._reg_params["weight"].shape_hint(self._weight_shape(c_in))

    def forward(self, x):
        # the op takes the reference's weight layout: the (O, kh, kw, I)
        # view of the channels-last weight, which it permutes back
        w = self.weight.permute(0, 2, 3, 1) if self._channels_last \
            else self.weight
        out = ops.Convolution(x, w, self.bias, kernel=self._kernel,
                              stride=self._strides, dilate=self._dilation,
                              pad=self._padding, num_filter=self._channels,
                              num_group=self._groups,
                              no_bias=self.bias is None, layout=self._layout)
        return self.act(out) if self.act is not None else out

    def extra_repr(self):
        return (f"{self._reg_params['weight'].shape[1] * self._groups} -> "
                f"{self._channels}, "
                f"kernel_size={self._kernel}, stride={self._strides}, "
                f"padding={self._padding}, layout={self._layout}")


class _Pool(HybridBlock):
    def __init__(self, pool_size, strides, padding, global_pool, pool_type,
                 layout, ceil_mode=False, count_include_pad=True,
                 prefix=None, params=None):
        super().__init__(prefix, params)
        self._kernel = pool_size
        self._stride = strides if strides is not None else pool_size
        self._pad = padding
        self._global = global_pool
        self._type = pool_type
        self._layout = layout or _layout.get_default_layout(len(pool_size))
        self._convention = "full" if ceil_mode else "valid"
        self._count_include_pad = count_include_pad

    def forward(self, x):
        return ops.Pooling(x, kernel=self._kernel, pool_type=self._type,
                           global_pool=self._global, stride=self._stride,
                           pad=self._pad, pooling_convention=self._convention,
                           count_include_pad=self._count_include_pad,
                           layout=self._layout)


def _make_pool(name, ptype, global_pool):
    if global_pool:
        class GPool(_Pool):
            def __init__(self, layout=None, **kwargs):
                super().__init__((1, 1), None, (0, 0), True, ptype, layout,
                                 **kwargs)
        GPool.__name__ = GPool.__qualname__ = name
        return GPool

    class Pool(_Pool):
        def __init__(self, pool_size=2, strides=None, padding=0, layout=None,
                     ceil_mode=False, **kwargs):
            super().__init__(_tuple(pool_size, 2),
                             _tuple(strides, 2) if strides is not None
                             else None, _tuple(padding, 2), False, ptype,
                             layout, ceil_mode=ceil_mode, **kwargs)
    Pool.__name__ = Pool.__qualname__ = name
    return Pool


MaxPool2D = _make_pool("MaxPool2D", "max", False)
AvgPool2D = _make_pool("AvgPool2D", "avg", False)
GlobalMaxPool2D = _make_pool("GlobalMaxPool2D", "max", True)
GlobalAvgPool2D = _make_pool("GlobalAvgPool2D", "avg", True)
