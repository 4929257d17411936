"""Int8 quantized operators, from ``tpu_mx/ndarray/quantized_ops.py``.

``quantize_v2``, ``dequantize``, ``requantize``,
``quantized_fully_connected``, ``quantized_conv``, ``quantized_pooling``
and ``quantized_flatten``, re-exported as ``nd.*`` as the reference's
star import does.  Every quantized operator returns ``(data, min, max)``,
the reference's three-output convention: the ranges ride along as 0-d
float32 tensors (arrays when an argument was an array).  The scale
arithmetic is the reference's, operation for operation, in float32;
``round`` is half-to-even (``torch.round``, as ``jnp.round``).

The products accumulate int8 x int8 in **int32**, exact as the
reference's ``preferred_element_type=int32``; no float accumulator
touches the int8 path.  Each device takes its own route to that:

- **the card**: ``torch._int_mm``, cuBLASLt's int8 x int8 -> int32
  product.  It wants more than 16 rows and both the reduced and the
  output width a multiple of 8, so the operands are zero-padded (exact:
  the padding adds zero products) and the padding is sliced off.
  PyTorch has no int8 convolution on CUDA, so a convolution is an
  im2col of the padded int8 input (``Tensor.unfold`` views over the
  channels-last layout, copied once into ``(N*out, C*k)`` rows) times
  the weight, per group.  The reference computes these products outside
  any Pallas kernel (``lax.dot_general``/``conv_general_dilated``), so a
  library product stands here.
- **the CPU**: the same im2col, then ``torch.matmul`` of int32 operands.

Pooling reads the same windows: max over the int8 window padded with
-128, average as an int32 window sum over the padded window size, rounded
back to int8.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..base import MXNetError
from .ops import _apply

__all__ = ["quantize_v2", "dequantize", "requantize",
           "quantized_fully_connected", "quantized_conv",
           "quantized_flatten", "quantized_pooling"]

_INT8_RANGE = 127.0


def _f32(v, device):
    """A range operand as a 0-d float32 tensor on ``device``."""
    return torch.as_tensor(v, dtype=torch.float32, device=device)


def _amax(mn, mx):
    return torch.maximum(mn.abs(), mx.abs())


def _round_clip_int8(x):
    return torch.clamp(torch.round(x), -127, 127).to(torch.int8)


def _pad_to(t, dim, multiple, least=0):
    """``t`` zero-padded along ``dim`` to a multiple of ``multiple`` and at
    least ``least`` long."""
    n = t.shape[dim]
    want = max(-(-n // multiple) * multiple, least)
    if want == n:
        return t
    shape = list(t.shape)
    shape[dim] = want - n
    return torch.cat([t, t.new_zeros(shape)], dim=dim)


def int8_matmul(a, b):
    """``a · bᵀ`` of int8 ``a`` ``(M, K)`` and ``b`` ``(N, K)``, accumulated
    exactly in int32: ``(M, N)`` int32 (module docstring for the route each
    device takes)."""
    m, n = a.shape[0], b.shape[0]
    if a.device.type == "cuda":
        ap = _pad_to(_pad_to(a, 1, 8), 0, 1, least=17).contiguous()
        bp = _pad_to(_pad_to(b, 1, 8), 0, 8).contiguous()
        return torch._int_mm(ap, bp.t())[:m, :n]
    return torch.matmul(a.to(torch.int32), b.to(torch.int32).t())


def _windows(x, kernel, stride, pad, dilation, fill):
    """Channels-last ``x`` ``(N, *S, C)`` -> a ``(N, *O, C, *k)`` view of
    every window (padding by ``fill``, dilation by striding the window)."""
    nd_ = len(kernel)
    spec = [0, 0]
    for p in reversed(pad):
        spec += [p, p]
    x = F.pad(x, spec, value=fill)
    for d in range(nd_):
        span = (kernel[d] - 1) * dilation[d] + 1
        x = x.unfold(1 + d, span, stride[d])
    if any(v != 1 for v in dilation):
        x = x[(Ellipsis,) + tuple(slice(None, None, v) for v in dilation)]
    return x


def _channels_last(x, nd_):
    return x.permute((0,) + tuple(range(2, nd_ + 2)) + (1,))


def _channels_first(x, nd_):
    return x.permute((0, nd_ + 1) + tuple(range(1, nd_ + 1)))


def quantize_v2(data, min_calib_range=None, max_calib_range=None,
                out_type="int8", **kw):
    """float -> int8 with the symmetric scale of the calibrated (or
    observed) range; returns ``(q, -amax, amax)``."""

    def f(x):
        if min_calib_range is not None:
            mn = _f32(min_calib_range, x.device)
            mx = _f32(max_calib_range, x.device)
        else:
            mn = x.min().float()
            mx = x.max().float()
        amax = _amax(mn, mx)
        scale = _INT8_RANGE / torch.clamp_min(amax, 1e-12)
        return _round_clip_int8(x.float() * scale), -amax, amax

    return _apply(f, [data], {})


def dequantize(data, min_range, max_range, out_type="float32", **kw):
    """int8 -> float32: ``q · amax / 127``."""

    def f(q, mn, mx):
        amax = _amax(_f32(mn, q.device), _f32(mx, q.device))
        return q.float() * (amax / _INT8_RANGE)

    return _apply(f, [data, min_range, max_range], {})


def requantize(data, min_range, max_range, min_calib_range=None,
               max_calib_range=None, **kw):
    """int32 accumulator -> int8 with a new range: the accumulator holds
    ``q32 · amax_in / 127²``."""

    def f(q32, mn, mx):
        amax_in = _amax(_f32(mn, q32.device), _f32(mx, q32.device))
        real = q32.float() * (amax_in / _INT8_RANGE ** 2)
        if min_calib_range is not None:
            amax_out = _f32(max(abs(float(min_calib_range)),
                                abs(float(max_calib_range))), q32.device)
        else:
            amax_out = torch.clamp_min(real.abs().max(), 1e-12)
        q8 = _round_clip_int8(real * (_INT8_RANGE / amax_out))
        return q8, -amax_out, amax_out

    return _apply(f, [data, min_range, max_range], {})


def quantized_fully_connected(data, weight, bias, min_data, max_data,
                              min_weight, max_weight, min_bias=None,
                              max_bias=None, num_hidden=None, no_bias=False,
                              **kw):
    """int8 x int8 -> int32 dense over ``data``'s last axis and the
    weight's second: ``(y_int32, -s, s)`` where ``y`` stands for ``y · s /
    127²``, ``s = amax_d · amax_w``.  A bias arrives int8 with its own
    range and is rescaled into the accumulator's grid."""
    if not no_bias and min_bias is None:
        raise MXNetError("quantized_fully_connected: a bias needs min_bias "
                         "and max_bias (or no_bias=True)")

    def f(x, w, *rest):
        if no_bias:
            b = None
            mnd, mxd, mnw, mxw = rest[:4]
        else:
            b, mnd, mxd, mnw, mxw = rest[:5]
        dev = x.device
        lead = x.shape[:-1]
        y = int8_matmul(x.to(torch.int8).reshape(-1, x.shape[-1]),
                        w.to(torch.int8)).reshape(lead + (w.shape[0],))
        amax_d = _amax(_f32(mnd, dev), _f32(mxd, dev))
        amax_w = _amax(_f32(mnw, dev), _f32(mxw, dev))
        out_scale = amax_d * amax_w
        if b is not None:
            amax_b = _amax(_f32(rest[5], dev), _f32(rest[6], dev))
            b32 = torch.round(b.float() * (amax_b / _INT8_RANGE)
                              * _INT8_RANGE ** 2
                              / torch.clamp_min(out_scale, 1e-12))
            y = y + b32.to(torch.int32)
        return y, -out_scale, out_scale

    args = [data, weight] + ([] if no_bias else [bias]) + \
        [min_data, max_data, min_weight, max_weight] + \
        ([] if no_bias else [min_bias, max_bias])
    return _apply(f, args, {})


def quantized_conv(data, weight, bias, min_data, max_data, min_weight,
                   max_weight, kernel=None, stride=None, pad=None,
                   dilate=None, num_filter=None, num_group=1, no_bias=True,
                   layout="NCHW", **kw):
    """int8 convolution with int32 accumulation, ``(out, -s, s)`` as
    :func:`quantized_fully_connected` (the bias is not added, as in the
    reference).  ``layout`` channels-last takes the weight as ``(O, *k,
    I/g)``, else ``(O, I/g, *k)``."""
    nd_ = len(kernel)
    strides = tuple(stride or (1,) * nd_)
    pads = tuple(pad or (0,) * nd_)
    dilation = tuple(dilate or (1,) * nd_)
    if layout is None:
        layout = "NC" + "DHW"[-nd_:]
    channels_last = layout.endswith("C")

    def f(x, w, mnd, mxd, mnw, mxw):
        dev = x.device
        x = x.to(torch.int8)
        w = w.to(torch.int8)
        if not channels_last:
            x = _channels_last(x, nd_)
        else:
            w = _channels_first(w, nd_)          # (O, I/g, *k)
        n = x.shape[0]
        win = _windows(x, kernel, strides, pads, dilation, 0)
        out_sp = win.shape[1:1 + nd_]
        k = math.prod(kernel)
        g = int(num_group)
        o, ig = w.shape[0], w.shape[1]
        cols = win.reshape(-1, g, ig * k)
        wg = w.reshape(g, o // g, ig * k)
        y = torch.cat([int8_matmul(cols[:, i], wg[i]) for i in range(g)],
                      dim=1) if g > 1 else int8_matmul(cols[:, 0], wg[0])
        y = y.reshape((n,) + tuple(out_sp) + (o,))
        if not channels_last:
            y = _channels_first(y, nd_).contiguous()
        amax_d = _amax(_f32(mnd, dev), _f32(mxd, dev))
        amax_w = _amax(_f32(mnw, dev), _f32(mxw, dev))
        out_scale = amax_d * amax_w
        return y, -out_scale, out_scale

    return _apply(f, [data, weight, min_data, max_data, min_weight,
                      max_weight], {})


def quantized_pooling(data, min_data, max_data, kernel=None,
                      pool_type="max", stride=None, pad=None,
                      global_pool=False, layout="NCHW", **kw):
    """int8 pooling with the ranges passed through: max over the int8
    window, average as an int32 window sum over the window size (padding
    included), rounded back to int8."""
    channels_last = layout.endswith("C")
    nd_ = len(layout) - 2

    def f(x, mn, mx):
        if global_pool:
            axes = tuple(range(1, 1 + nd_)) if channels_last else \
                tuple(range(2, 2 + nd_))
            if pool_type == "max":
                y = x.amax(dim=axes, keepdim=True)
            else:
                s = x.to(torch.int32).sum(dim=axes, keepdim=True)
                cnt = math.prod(x.shape[a] for a in axes)
                y = _round_clip_int8(s.float() / cnt)
            return y, mn, mx
        strides = tuple(stride or (1,) * nd_)
        pads = tuple(pad or (0,) * nd_)
        xl = x if channels_last else _channels_last(x, nd_)
        win_dims = tuple(range(-nd_, 0))
        if pool_type == "max":
            y = _windows(xl, kernel, strides, pads, (1,) * nd_,
                         -128).amax(dim=win_dims)
        else:
            s = _windows(xl.to(torch.int32), kernel, strides, pads,
                         (1,) * nd_, 0).sum(dim=win_dims)
            y = _round_clip_int8(s / math.prod(kernel))
        if not channels_last:
            y = _channels_first(y, nd_)
        return y.contiguous(), mn, mx

    return _apply(f, [data, min_data, max_data], {})


def quantized_flatten(data, min_data, max_data, **kw):
    def f(x, mn, mx):
        return x.reshape(x.shape[0], -1), mn, mx

    return _apply(f, [data, min_data, max_data], {})
