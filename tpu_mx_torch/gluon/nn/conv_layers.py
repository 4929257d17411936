"""Convolution and pooling layers from ``gluon/nn/conv_layers.py``:
``Conv1D``/``Conv2D``/``Conv3D``, their transposes, and max, average
and global pooling in 1, 2 and 3 dimensions.

Every layer takes the reference's ``layout=``; None picks up the
thread-local default of :func:`tpu_mx_torch.layout.default_layout`.
Under a channels-last layout a layer takes and returns ``(N, *S, C)``
tensors, as the reference does, and runs PyTorch's operator on the
``(N, C, *S)``-shaped view of them, which has channels-last strides
(no copy).  A convolution's weight is an ``(O, I/g, *k)`` parameter (a
transposed one's ``(I, O/g, *k)``, PyTorch's orders); channels-last it
takes the reference's ``(O, *k, I/g)`` (``(I, *k, O/g)``) arrays
transposed (``from_numpy``, ``load_parameters``), and its initializer
sees the reference's shape (a fan is the reference's).
``in_channels=0`` is inferred at the first forward (the input's channel
axis), after ``initialize()``.
"""
from __future__ import annotations

import torch

from ... import layout as _layout
from ...ndarray import ops
from ..block import HybridBlock, as_dtype, default_generator
from .basic_layers import Activation

__all__ = ["Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose",
           "Conv2DTranspose", "Conv3DTranspose", "MaxPool1D", "MaxPool2D",
           "MaxPool3D", "AvgPool1D", "AvgPool2D", "AvgPool3D",
           "GlobalMaxPool1D", "GlobalMaxPool2D", "GlobalMaxPool3D",
           "GlobalAvgPool1D", "GlobalAvgPool2D", "GlobalAvgPool3D"]


def _tuple(v, n):
    return (v,) * n if isinstance(v, int) else tuple(v)


class _Conv(HybridBlock):
    """What the convolutions and their transposes share: ``act(conv(x,
    W) + b)``."""

    def __init__(self, channels, kernel_size, strides, padding, dilation,
                 groups, layout, in_channels=0, activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", transpose=False, output_padding=0,
                 dtype=torch.float32, generator=None, prefix=None,
                 params=None):
        super().__init__(prefix, params)
        g, dt = default_generator(generator), as_dtype(dtype)
        nd_ = len(kernel_size)
        self._channels = channels
        self._kernel = tuple(kernel_size)
        self._strides = _tuple(strides, nd_)
        self._padding = _tuple(padding, nd_)
        self._dilation = _tuple(dilation, nd_)
        self._groups = groups
        self._transpose = transpose
        self._output_padding = _tuple(output_padding, nd_)
        self._layout = layout or _layout.get_default_layout(nd_)
        self._channels_last = _layout.is_channels_last(self._layout)
        axes = ops._to_channels_first(nd_) if self._channels_last else None
        self._declare("weight", self._weight_shape(in_channels),
                      weight_initializer, dt, g, axes=axes)
        if use_bias:
            self._declare("bias", (channels,), bias_initializer, dt, g)
        else:
            self.bias = None
        self.act = Activation(activation) if activation else None

    def _weight_shape(self, c_in):
        """The reference's weight shape: ``(O, I/g, *k)`` (transposed
        ``(I, O/g, *k)``), or channels-last ``(O, *k, I/g)``
        (``(I, *k, O/g)``)."""
        io = (c_in, self._channels // self._groups) if self._transpose \
            else (self._channels, c_in // self._groups)
        if self._channels_last:
            return (io[0],) + self._kernel + (io[1],)
        return io + self._kernel

    def infer_shape(self, x, *args):
        c_in = x.shape[-1 if self._channels_last else 1]
        self._reg_params["weight"].shape_hint(self._weight_shape(c_in))

    def forward(self, x):
        # the ops take the reference's weight layout: the channels-last
        # view of the stored weight, which they permute back
        w = self._parameters["weight"]
        if self._channels_last:
            w = w.permute(ops._to_channels_last(len(self._kernel)))
        bias = self._parameters.get("bias")
        kw = dict(kernel=self._kernel, stride=self._strides,
                  dilate=self._dilation, pad=self._padding,
                  num_filter=self._channels, num_group=self._groups,
                  no_bias=bias is None, layout=self._layout)
        out = ops.Deconvolution(x, w, bias, adj=self._output_padding, **kw) \
            if self._transpose else ops.Convolution(x, w, bias, **kw)
        return self.act(out) if self.act is not None else out

    def extra_repr(self):
        return (f"{self._channels}, kernel_size={self._kernel}, "
                f"stride={self._strides}, padding={self._padding}, "
                f"layout={self._layout}")


class Conv1D(_Conv):
    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 dilation=1, groups=1, layout=None, in_channels=0,
                 activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", **kwargs):
        super().__init__(channels, _tuple(kernel_size, 1), strides, padding,
                         dilation, groups, layout, in_channels, activation,
                         use_bias, weight_initializer, bias_initializer,
                         **kwargs)


class Conv2D(_Conv):
    """2-D convolution, ``act(conv(x, W) + b)``."""

    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 dilation=(1, 1), groups=1, layout=None, in_channels=0,
                 activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", **kwargs):
        super().__init__(channels, _tuple(kernel_size, 2), strides, padding,
                         dilation, groups, layout, in_channels, activation,
                         use_bias, weight_initializer, bias_initializer,
                         **kwargs)


class Conv3D(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), dilation=(1, 1, 1), groups=1,
                 layout=None, in_channels=0, activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros", **kwargs):
        super().__init__(channels, _tuple(kernel_size, 3), strides, padding,
                         dilation, groups, layout, in_channels, activation,
                         use_bias, weight_initializer, bias_initializer,
                         **kwargs)


class Conv1DTranspose(_Conv):
    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 output_padding=0, dilation=1, groups=1, layout=None,
                 in_channels=0, activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros", **kwargs):
        super().__init__(channels, _tuple(kernel_size, 1), strides, padding,
                         dilation, groups, layout, in_channels, activation,
                         use_bias, weight_initializer, bias_initializer,
                         transpose=True, output_padding=output_padding,
                         **kwargs)


class Conv2DTranspose(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 output_padding=(0, 0), dilation=(1, 1), groups=1,
                 layout=None, in_channels=0, activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros", **kwargs):
        super().__init__(channels, _tuple(kernel_size, 2), strides, padding,
                         dilation, groups, layout, in_channels, activation,
                         use_bias, weight_initializer, bias_initializer,
                         transpose=True, output_padding=output_padding,
                         **kwargs)


class Conv3DTranspose(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), output_padding=(0, 0, 0),
                 dilation=(1, 1, 1), groups=1, layout=None, in_channels=0,
                 activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", **kwargs):
        super().__init__(channels, _tuple(kernel_size, 3), strides, padding,
                         dilation, groups, layout, in_channels, activation,
                         use_bias, weight_initializer, bias_initializer,
                         transpose=True, output_padding=output_padding,
                         **kwargs)


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


def _make_pool(name, ndim, ptype, global_pool):
    if global_pool:
        class GPool(_Pool):
            def __init__(self, layout=None, **kwargs):
                super().__init__((1,) * ndim, None, (0,) * ndim, True, ptype,
                                 layout, **kwargs)
        GPool.__name__ = GPool.__qualname__ = name
        return GPool

    class Pool(_Pool):
        def __init__(self, pool_size=2, strides=None, padding=0, layout=None,
                     ceil_mode=False, **kwargs):
            super().__init__(_tuple(pool_size, ndim),
                             _tuple(strides, ndim) if strides is not None
                             else None, _tuple(padding, ndim), False, ptype,
                             layout, ceil_mode=ceil_mode, **kwargs)
    Pool.__name__ = Pool.__qualname__ = name
    return Pool


MaxPool1D = _make_pool("MaxPool1D", 1, "max", False)
MaxPool2D = _make_pool("MaxPool2D", 2, "max", False)
MaxPool3D = _make_pool("MaxPool3D", 3, "max", False)
AvgPool1D = _make_pool("AvgPool1D", 1, "avg", False)
AvgPool2D = _make_pool("AvgPool2D", 2, "avg", False)
AvgPool3D = _make_pool("AvgPool3D", 3, "avg", False)
GlobalMaxPool1D = _make_pool("GlobalMaxPool1D", 1, "max", True)
GlobalMaxPool2D = _make_pool("GlobalMaxPool2D", 2, "max", True)
GlobalMaxPool3D = _make_pool("GlobalMaxPool3D", 3, "max", True)
GlobalAvgPool1D = _make_pool("GlobalAvgPool1D", 1, "avg", True)
GlobalAvgPool2D = _make_pool("GlobalAvgPool2D", 2, "avg", True)
GlobalAvgPool3D = _make_pool("GlobalAvgPool3D", 3, "avg", True)
