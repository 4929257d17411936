"""The operators the port's models call (BERT, ResNet, SSD), from
``tpu_mx/ndarray/ops.py``, on tensors.

Same names and semantics as the reference's, including its numerics in
mixed precision: ``LayerNorm`` computes its statistics in float32 and
casts the result back to the input's type, ``gelu`` is the erf form.
Matrix products and convolutions go to PyTorch (cuBLAS and cuDNN on the
card), as the reference left them to XLA; none of these is a kernel of
the port.

Layouts are the reference's: ``layout="NHWC"`` takes ``(N, H, W, C)``
data and an ``(O, kh, kw, I)`` convolution weight.  The operators
permute them to ``(N, C, H, W)``-shaped views, which for contiguous
channels-last data have ``torch.channels_last`` strides (no copy), run
PyTorch's operator there and permute the result back.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .. import layout as _layout

__all__ = ["FullyConnected", "Embedding", "LayerNorm", "gelu", "log_softmax",
           "pick", "Dropout", "Convolution", "Pooling", "Activation",
           "space_to_depth", "depth_to_space", "L2Normalization",
           "sgd_update_core", "sgd_mom_update_core"]


def _pair(v, n):
    if isinstance(v, int):
        return (v,) * n
    t = tuple(v)
    return t if len(t) == n else t + t[-1:] * (n - len(t))


def _to_channels_first(nd_):
    return (0, nd_ + 1) + tuple(range(1, nd_ + 1))


def _to_channels_last(nd_):
    return (0,) + tuple(range(2, nd_ + 2)) + (1,)


def FullyConnected(data, weight, bias=None, num_hidden=None, no_bias=False,
                   flatten=True):
    """``y = x·Wᵀ + b``.  With ``flatten`` (the reference's default) an
    input of rank > 2 is first reshaped to ``(N, prod(shape[1:]))``;
    without it the product runs over the last axis (BERT's form)."""
    if flatten and data.dim() > 2:
        data = data.reshape(data.shape[0], -1)
    return F.linear(data, weight, None if no_bias else bias)


def Convolution(data, weight, bias=None, kernel=None, stride=None,
                dilate=None, pad=None, num_filter=None, num_group=1,
                no_bias=False, layout=None):
    """N-D convolution (1-3 spatial axes) with the reference's arguments.
    ``layout`` channels-first (default) or channels-last; the weight is
    ``(O, I/g, *kernel)`` or, channels-last, ``(O, *kernel, I/g)``."""
    nd_ = len(kernel)
    strides = _pair(stride, nd_) if stride else (1,) * nd_
    dilation = _pair(dilate, nd_) if dilate else (1,) * nd_
    padding = _pair(pad, nd_) if pad else (0,) * nd_
    channels_last = _layout.is_channels_last(layout)
    if channels_last:
        data = data.permute(_to_channels_first(nd_))
        weight = weight.permute(_to_channels_first(nd_))
    conv = (F.conv1d, F.conv2d, F.conv3d)[nd_ - 1]
    y = conv(data, weight, None if no_bias else bias, strides, padding,
             dilation, num_group)
    return y.permute(_to_channels_last(nd_)) if channels_last else y


def Pooling(data, kernel=None, pool_type="max", global_pool=False,
            stride=None, pad=None, pooling_convention="valid",
            count_include_pad=True, layout=None):
    """Max/avg/sum pooling with the reference's arguments.  Max pads with
    -inf; avg divides by the whole window with ``count_include_pad``,
    else by its elements inside the input; ``"full"`` (ceil mode) pads
    the trailing side by ``stride - 1`` more, as the reference does."""
    channels_last = _layout.is_channels_last(layout)
    nd_ = data.dim() - 2
    if global_pool:
        axes = tuple(range(1, nd_ + 1)) if channels_last \
            else tuple(range(2, nd_ + 2))
        if pool_type == "avg":
            return data.mean(dim=axes, keepdim=True)
        if pool_type == "max":
            return data.amax(dim=axes, keepdim=True)
        return data.sum(dim=axes, keepdim=True)
    k = _pair(kernel, nd_)
    s = _pair(stride, nd_) if stride else k
    p = _pair(pad, nd_) if pad else (0,) * nd_
    x = data.permute(_to_channels_first(nd_)) if channels_last else data
    max_pool = (F.max_pool1d, F.max_pool2d, F.max_pool3d)[nd_ - 1]
    avg_pool = (F.avg_pool1d, F.avg_pool2d, F.avg_pool3d)[nd_ - 1]
    if pooling_convention != "full" and all(2 * pp <= kk
                                            for pp, kk in zip(p, k)) \
            and pool_type != "sum":
        # PyTorch's own padding computes the reference's windows here
        y = max_pool(x, k, s, p) if pool_type == "max" else \
            avg_pool(x, k, s, p, count_include_pad=count_include_pad)
    else:
        extra = [st - 1 if pooling_convention == "full" else 0 for st in s]
        pads = [v for pp, e in reversed(list(zip(p, extra)))
                for v in (pp, pp + e)]
        if pool_type == "max":
            y = max_pool(F.pad(x, pads, value=-math.inf), k, s)
        else:
            y = avg_pool(F.pad(x, pads), k, s)
            if pool_type == "sum":
                y = y * math.prod(k)
            elif not count_include_pad:
                ones = F.pad(torch.ones((1, 1) + tuple(x.shape[2:]),
                                        dtype=x.dtype, device=x.device), pads)
                y = y / avg_pool(ones, k, s)
    return y.permute(_to_channels_last(nd_)) if channels_last else y


_ACTIVATIONS = {"relu": torch.relu, "sigmoid": torch.sigmoid,
                "tanh": torch.tanh, "softrelu": F.softplus,
                "softsign": F.softsign}


def Activation(data, act_type="relu"):
    return _ACTIVATIONS[act_type](data)


def space_to_depth(data, block_size):
    """NCHW ``(N, C, H, W)`` → ``(N, b²C, H/b, W/b)``, block offsets
    leading the channels: out channel ``(bh·b + bw)·C + c``."""
    b = int(block_size)
    n, c, h, w = data.shape
    y = data.reshape(n, c, h // b, b, w // b, b).permute(0, 3, 5, 1, 2, 4)
    return y.reshape(n, b * b * c, h // b, w // b)


def depth_to_space(data, block_size):
    """Inverse of :func:`space_to_depth`."""
    b = int(block_size)
    n, c, h, w = data.shape
    y = data.reshape(n, b, b, c // (b * b), h, w).permute(0, 3, 4, 1, 5, 2)
    return y.reshape(n, c // (b * b), h * b, w * b)


def Embedding(data, weight):
    """Row lookup ``weight[data]`` (dense gradient, as in the reference)."""
    return F.embedding(data.long(), weight)


def LayerNorm(data, gamma, beta, eps=1e-5):
    """Layer normalization over the last axis with float32 statistics,
    result in ``data``'s type."""
    x = data.float()
    return F.layer_norm(x, x.shape[-1:], gamma.float(), beta.float(),
                        eps).to(data.dtype)


def L2Normalization(data, eps=1e-10, mode="instance"):
    """``x / sqrt(Σx² + eps)`` over the channel axis (``"channel"``), the
    spatial axes (``"spatial"``) or every axis but the batch's
    (``"instance"``, and any other mode, as in the reference).  The sum
    of squares accumulates in float32 and the result is cast back to
    ``data``'s type, as in the reference."""
    if mode == "channel":
        axes = (1,)
    elif mode == "spatial":
        axes = tuple(range(2, data.dim()))
    else:
        axes = tuple(range(1, data.dim()))
    x = data.float()
    norm = torch.sqrt(x.square().sum(dim=axes, keepdim=True) + eps)
    return (x / norm).to(data.dtype)


def gelu(data):
    """GELU with the exact erf form (``approximate=False``)."""
    return F.gelu(data)


def log_softmax(data, axis=-1):
    return F.log_softmax(data, dim=axis)


def _fill_value(dtype):
    """What the reference's ``take_along_axis`` reads at an index out of
    range: NaN for floating types, else the most negative value (the
    largest for an unsigned type)."""
    if dtype.is_floating_point:
        return math.nan
    info = torch.iinfo(dtype)
    return info.min if info.min < 0 else info.max


def pick(data, index, axis=-1, keepdims=False):
    """``data`` at ``index`` along ``axis`` (the reference's ``pick``, a
    ``take_along_axis``).  Float indices are truncated to integers; an
    index in ``[-C, -1]`` counts from the end (``-1`` is the last of the
    ``C`` entries); one ``>= C`` or ``< -C`` reads NaN (for floating
    ``data``) and passes no gradient.  The gather itself always reads
    inside the axis, so no index makes it fail on the CPU or assert on
    the card."""
    axis = axis % data.dim()
    c = data.shape[axis]
    i = index.long().unsqueeze(axis)
    i = torch.where(i < 0, i + c, i)
    inside = (i >= 0) & (i < c)
    out = torch.gather(data, axis, torch.where(inside, i, 0))
    out = torch.where(inside, out, _fill_value(data.dtype))
    return out if keepdims else out.squeeze(axis)


def Dropout(data, p, generator, training=True):
    """Inverted dropout: keep each element with probability ``1 - p`` and
    scale kept ones by ``1/(1-p)``; the mask is drawn from ``generator``
    (on ``data``'s device).  Identity when not training or ``p == 0``."""
    if not training or p <= 0:
        return data
    keep = torch.rand(data.shape, generator=generator,
                      device=data.device) >= p
    return torch.where(keep, data / (1.0 - p), torch.zeros((), dtype=data.dtype,
                                                           device=data.device))


def _clip(g, rescale_grad, clip_gradient):
    g = g * rescale_grad
    if clip_gradient is not None and clip_gradient > 0:
        g = g.clamp(-clip_gradient, clip_gradient)
    return g


def sgd_update_core(weight, grad, lr, wd, rescale_grad=1.0,
                    clip_gradient=None):
    """Plain SGD: ``w - lr·(g + wd·w)``, ``g`` rescaled and clipped."""
    g = _clip(grad, rescale_grad, clip_gradient)
    return weight - lr * (g + wd * weight)


def sgd_mom_update_core(weight, grad, mom, lr, momentum, wd, rescale_grad=1.0,
                        clip_gradient=None):
    """Momentum SGD, the reference's rule (not ``torch.optim.SGD``'s):
    ``mom = momentum·mom - lr·(g + wd·w); w = w + mom``.  Returns
    ``(new_weight, new_mom)``."""
    g = _clip(grad, rescale_grad, clip_gradient)
    new_mom = momentum * mom - lr * (g + wd * weight)
    return weight + new_mom, new_mom
