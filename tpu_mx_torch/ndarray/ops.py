"""The operators of ``tpu_mx/ndarray/ops.py``: the ``nd.*`` namespace.

Every operator is a plain function on tensors wrapped by :func:`_apply`,
which follows the reference's rule (``ops.py:62-72``): a call with no
:class:`~tpu_mx_torch.ndarray.NDArray` among its arguments runs the
function on what it was given and returns raw tensors, so the port's
models call these functions on tensors at no cost beyond a scan of the
arguments; a call with arrays unwraps them, runs under
``torch.set_grad_enabled(autograd.is_recording())`` (a graph only inside
``record()``) and wraps the tensors it returns.  Creation operators
(``zeros``, ``arange``, ``random.uniform``, ...) return arrays on
``ctx`` (default: the current context), and tensors inside a
``HybridBlock``'s forward, as the reference's do inside a trace.

Same names and semantics as the reference's, including its numerics in
mixed precision: ``LayerNorm`` computes its statistics in float32 and
casts the result back to the input's type, ``gelu`` is the erf form,
comparisons return 0/1 in the operands' type, ``argmax`` returns
float32.  Matrix products and convolutions go to PyTorch (cuBLAS and
cuDNN on the card), as the reference left them to XLA; none of these is
a kernel of the port.

Layouts are the reference's: ``layout="NHWC"`` takes ``(N, H, W, C)``
data and an ``(O, kh, kw, I)`` convolution weight.  The operators
permute them to ``(N, C, H, W)``-shaped views, which for contiguous
channels-last data have ``torch.channels_last`` strides (no copy), run
PyTorch's operator there and permute the result back.

Not ported yet (ROADMAP A3, by name): the linear-algebra, sampling,
sort/topk, sequence, ``im2col``/``col2im``, ``gather_nd``/``scatter_nd``,
``pad``, the loss-output heads (``SoftmaxOutput``, ...), ``Custom`` and
the long tail of the reference's elementwise functions.
"""
from __future__ import annotations

import builtins
import functools
import math

import torch
import torch.nn.functional as F

from .. import autograd
from .. import device as _device
from .. import layout as _layout
from .. import random as _random
from ..context import current_context
from .ndarray import NDArray, _torch_dtype

# -- the imperative face ------------------------------------------------------
def _holds_array(values):
    for a in values:
        if isinstance(a, NDArray):
            return True
        if isinstance(a, (list, tuple)) and any(isinstance(x, NDArray)
                                                for x in a):
            return True
    return False


def _unwrap(a):
    if isinstance(a, NDArray):
        return a._data
    if isinstance(a, (list, tuple)):
        return type(a)(_unwrap(x) for x in a)
    return a


def _wrap(out):
    if isinstance(out, torch.Tensor):
        return NDArray(out)
    if isinstance(out, (list, tuple)):
        return [_wrap(o) for o in out]
    return out


def _apply(fn, args, kwargs):
    """Run ``fn(*args, **kwargs)``: on raw tensors as given, or, when an
    argument is an array, on the unwrapped tensors under the recording
    flag, wrapping the outputs (a list for several)."""
    if not (_holds_array(args) or _holds_array(kwargs.values())):
        return fn(*args, **kwargs)
    with torch.set_grad_enabled(autograd.is_recording()):
        out = fn(*[_unwrap(a) for a in args],
                 **{k: _unwrap(v) for k, v in kwargs.items()})
    return _wrap(out)


def _op(fn):
    """``fn`` with the imperative face of :func:`_apply`."""
    @functools.wraps(fn)
    def op(*args, **kwargs):
        return _apply(fn, args, kwargs)
    return op


def _place(t):
    """A created tensor as an array, or as itself inside a forward."""
    return t if autograd._STATE.functional else NDArray(t)


def _dev(ctx):
    return _device.resolve(ctx if ctx is not None else current_context())


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
    if no_bias or bias is None:
        return F.linear(data, weight)
    if data.dtype in (torch.float16, torch.bfloat16):
        # the reference rounds the product to the operands' type before
        # it adds the bias (two roundings, where one fused call rounds once)
        return F.linear(data, weight) + bias
    return F.linear(data, weight, bias)


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


def log_softmax(data, axis=-1, temperature=None):
    return F.log_softmax(data / temperature if temperature else data,
                         dim=axis)


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


def Dropout(data, p=0.5, generator=None, training=True):
    """Inverted dropout: keep each element with probability ``1 - p`` and
    scale kept ones by ``1/(1-p)``; the mask is drawn from ``generator``
    (on ``data``'s device; None: the process's generator there).
    Identity when not training or ``p == 0``."""
    if not training or p <= 0:
        return data
    if generator is None:
        generator = _random.generator(data.device)
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


def adam_update_core(weight, grad, mean, var, lr, beta1, beta2, epsilon, wd,
                     t, rescale_grad=1.0, clip_gradient=None):
    """Adam, the reference's rule: the gradient rescaled, clipped and
    given ``wd·w``; bias-corrected moments.  Returns ``(new_weight,
    new_mean, new_var)``."""
    g = _clip(grad, rescale_grad, clip_gradient) + wd * weight
    m = beta1 * mean + (1 - beta1) * g
    v = beta2 * var + (1 - beta2) * g.square()
    mhat = m / (1 - beta1 ** t)
    vhat = v / (1 - beta2 ** t)
    return weight - lr * mhat / (vhat.sqrt() + epsilon), m, v


# -- creation -----------------------------------------------------------------
def zeros(shape, ctx=None, dtype="float32", **kw):
    return _place(torch.zeros(shape, dtype=_torch_dtype(dtype),
                              device=_dev(ctx)))


def ones(shape, ctx=None, dtype="float32", **kw):
    return _place(torch.ones(shape, dtype=_torch_dtype(dtype),
                             device=_dev(ctx)))


def full(shape, val, ctx=None, dtype="float32", **kw):
    return _place(torch.full(shape, val, dtype=_torch_dtype(dtype),
                             device=_dev(ctx)))


def empty(shape, ctx=None, dtype="float32"):
    return zeros(shape, ctx=ctx, dtype=dtype)


def arange(start, stop=None, step=1.0, repeat=1, ctx=None, dtype="float32"):
    if stop is None:
        start, stop = 0, start
    a = torch.arange(start, stop, step, dtype=torch.float64,
                     device=_dev(ctx)).to(_torch_dtype(dtype))
    return _place(a.repeat_interleave(repeat) if repeat != 1 else a)


def zeros_like(data, **kw):
    return torch.zeros_like(data)


def ones_like(data, **kw):
    return torch.ones_like(data)


def full_like(data, fill_value, **kw):
    return torch.full_like(data, fill_value)


def cast(data, dtype, **kw):
    return data.to(_torch_dtype(dtype))


Cast = astype = cast


def BlockGrad(data, **kw):
    """The value, with no gradient flowing through it."""
    return data.detach()


stop_gradient = BlockGrad


def identity(data, **kw):
    return data


# -- elementwise --------------------------------------------------------------
def _unary(tfn, name):
    def op(data, **kw):
        return tfn(data)
    op.__name__ = op.__qualname__ = name
    return op


abs = _unary(torch.abs, "abs")
sign = _unary(torch.sign, "sign")
ceil = _unary(torch.ceil, "ceil")
floor = _unary(torch.floor, "floor")
trunc = fix = _unary(torch.trunc, "trunc")
round = rint = _unary(torch.round, "round")
exp = _unary(torch.exp, "exp")
expm1 = _unary(torch.expm1, "expm1")
log = _unary(torch.log, "log")
log2 = _unary(torch.log2, "log2")
log10 = _unary(torch.log10, "log10")
log1p = _unary(torch.log1p, "log1p")
sqrt = _unary(torch.sqrt, "sqrt")
rsqrt = _unary(torch.rsqrt, "rsqrt")
square = _unary(torch.square, "square")
reciprocal = _unary(torch.reciprocal, "reciprocal")
negative = _unary(torch.neg, "negative")
sin = _unary(torch.sin, "sin")
cos = _unary(torch.cos, "cos")
tan = _unary(torch.tan, "tan")
arcsin = _unary(torch.asin, "arcsin")
arccos = _unary(torch.acos, "arccos")
arctan = _unary(torch.atan, "arctan")
sinh = _unary(torch.sinh, "sinh")
cosh = _unary(torch.cosh, "cosh")
tanh = _unary(torch.tanh, "tanh")
sigmoid = _unary(torch.sigmoid, "sigmoid")
softsign = _unary(F.softsign, "softsign")
relu = _unary(torch.relu, "relu")
erf = _unary(torch.erf, "erf")
erfinv = _unary(torch.erfinv, "erfinv")
logical_not = _unary(lambda x: (x == 0).to(x.dtype), "logical_not")
isnan = _unary(torch.isnan, "isnan")
isinf = _unary(torch.isinf, "isinf")
isfinite = _unary(torch.isfinite, "isfinite")


def _binary(tfn, name):
    def op(lhs, rhs, **kw):
        return tfn(lhs, rhs)
    op.__name__ = op.__qualname__ = name
    return op


def _compare(cmp):
    return lambda a, b: cmp(a, b).to(torch.result_type(a, b))


add = _binary(lambda a, b: a + b, "add")
subtract = _binary(lambda a, b: a - b, "subtract")
multiply = _binary(lambda a, b: a * b, "multiply")
divide = _binary(lambda a, b: a / b, "divide")
mod = _binary(lambda a, b: a % b, "mod")
power = _binary(lambda a, b: a ** b, "power")
maximum = _binary(lambda a, b: torch.maximum(*_tensors(a, b)), "maximum")
minimum = _binary(lambda a, b: torch.minimum(*_tensors(a, b)), "minimum")
hypot = _binary(lambda a, b: torch.hypot(*_tensors(a, b)), "hypot")
equal = _binary(_compare(lambda a, b: a == b), "equal")
not_equal = _binary(_compare(lambda a, b: a != b), "not_equal")
greater = _binary(_compare(lambda a, b: a > b), "greater")
greater_equal = _binary(_compare(lambda a, b: a >= b), "greater_equal")
lesser = _binary(_compare(lambda a, b: a < b), "lesser")
lesser_equal = _binary(_compare(lambda a, b: a <= b), "lesser_equal")


def _tensors(a, b):
    """Both operands as tensors (a Python scalar takes the other's type,
    as the reference's weakly typed scalars do)."""
    if not isinstance(a, torch.Tensor):
        a = torch.as_tensor(a, dtype=torch.result_type(a, b), device=b.device)
    if not isinstance(b, torch.Tensor):
        b = torch.as_tensor(b, dtype=torch.result_type(a, b), device=a.device)
    return a, b


broadcast_add = broadcast_plus = elemwise_add = add
broadcast_sub = broadcast_minus = elemwise_sub = subtract
broadcast_mul = elemwise_mul = multiply
broadcast_div = elemwise_div = divide
broadcast_mod = mod
broadcast_power = power
broadcast_maximum = maximum
broadcast_minimum = minimum
broadcast_equal = equal
broadcast_not_equal = not_equal
broadcast_greater = greater
broadcast_greater_equal = greater_equal
broadcast_lesser = lesser
broadcast_lesser_equal = lesser_equal


def add_n(*args, **kw):
    return functools.reduce(lambda a, b: a + b, args)


ElementWiseSum = add_n


# -- reductions ---------------------------------------------------------------
def _axes(data, axis, exclude=False):
    """``axis`` as a tuple of dims (None: all)."""
    if axis is None:
        return None
    ax = tuple(axis) if isinstance(axis, (list, tuple)) else (axis,)
    if exclude:
        keep = {a % data.dim() for a in ax}
        ax = tuple(i for i in range(data.dim()) if i not in keep)
    return ax


def _reduce(tfn, name, floating=False):
    def op(data, axis=None, keepdims=False, exclude=False, **kw):
        if floating and not data.is_floating_point():
            data = data.float()
        ax = _axes(data, axis, exclude)
        if ax is None:
            out = tfn(data, tuple(range(data.dim())), False)
            return out.reshape((1,) * data.dim()) if keepdims else out
        return tfn(data, ax, keepdims)
    op.__name__ = op.__qualname__ = name
    return op


def _prod(x, dims, keep):
    for d in sorted((d % x.dim() for d in dims), reverse=True):
        x = x.prod(dim=d, keepdim=keep)
    return x


sum = sum_axis = _reduce(lambda x, d, k: torch.sum(x, dim=d, keepdim=k)
                         if d else x.clone(), "sum")
mean = _reduce(lambda x, d, k: torch.mean(x, dim=d, keepdim=k)
               if d else x.clone(), "mean", floating=True)
max = max_axis = _reduce(lambda x, d, k: torch.amax(x, dim=d, keepdim=k)
                         if d else x.clone(), "max")
min = min_axis = _reduce(lambda x, d, k: torch.amin(x, dim=d, keepdim=k)
                         if d else x.clone(), "min")
prod = _reduce(_prod, "prod")


def _arg(tfn, name):
    def op(data, axis=None, keepdims=False, **kw):
        if axis is None:
            out = tfn(data.reshape(-1), dim=0)
            return (out.reshape((1,) * data.dim()) if keepdims
                    else out).float()
        return tfn(data, dim=axis, keepdim=keepdims).float()
    op.__name__ = op.__qualname__ = name
    return op


argmax = _arg(torch.argmax, "argmax")
argmin = _arg(torch.argmin, "argmin")


def norm(data, ord=2, axis=None, keepdims=False, **kw):
    """L1 (``ord=1``) or L2 norm over ``axis`` (None: all)."""
    x = data.abs() if ord == 1 else data.square()
    ax = _axes(data, axis)
    s = x.sum() if ax is None else x.sum(dim=ax, keepdim=keepdims)
    if ax is None and keepdims:
        s = s.reshape((1,) * data.dim())
    return s if ord == 1 else s.sqrt()


# -- shapes -------------------------------------------------------------------
def reshape(data, shape=None, reverse=False, **kw):
    """The reference's reshape with its special codes: 0 keeps a dim,
    -1 infers one, -2 copies the rest, -3 merges two."""
    out, src, i = [], list(data.shape), 0
    for s in tuple(shape):
        if s == 0:
            out.append(src[i])
            i += 1
        elif s == -1:
            out.append(-1)
            i += 1
        elif s == -2:
            out.extend(src[i:])
            i = len(src)
        elif s == -3:
            out.append(src[i] * src[i + 1])
            i += 2
        elif s == -4:
            continue
        else:
            out.append(s)
            i += 1
    return data.reshape(tuple(out))


Reshape = reshape


def reshape_like(lhs, rhs, **kw):
    return lhs.reshape(rhs.shape)


def flatten(data, **kw):
    return data.reshape(data.shape[0], -1)


Flatten = flatten


def transpose(data, axes=None, **kw):
    return data.permute(tuple(axes) if axes else
                        tuple(reversed(range(data.dim()))))


def swapaxes(data, dim1=0, dim2=0, **kw):
    return data.transpose(dim1, dim2)


SwapAxis = swapaxes


def expand_dims(data, axis, **kw):
    return data.unsqueeze(axis)


def squeeze(data, axis=None, **kw):
    if axis is None:
        return data.squeeze()
    return data.squeeze(tuple(axis) if isinstance(axis, (list, tuple))
                        else axis)


def broadcast_to(data, shape, **kw):
    """To ``shape``; a 0 there keeps the dim."""
    return data.expand(tuple(data.shape[i] if s == 0 else s
                             for i, s in enumerate(shape)))


def broadcast_like(lhs, rhs, **kw):
    return lhs.expand(rhs.shape)


def flip(data, axis, **kw):
    return torch.flip(data, dims=(axis,) if isinstance(axis, int)
                      else tuple(axis))


reverse = flip


def tile(data, reps, **kw):
    return data.tile(tuple(reps) if isinstance(reps, (list, tuple))
                     else (reps,))


def repeat(data, repeats, axis=None, **kw):
    if axis is None:
        return data.reshape(-1).repeat_interleave(repeats)
    return data.repeat_interleave(repeats, dim=axis)


def concat(*data, dim=1, **kw):
    if len(data) == 1 and isinstance(data[0], (list, tuple)):
        data = tuple(data[0])
    return torch.cat(data, dim=dim)


Concat = concat


def stack(*data, axis=0, **kw):
    if len(data) == 1 and isinstance(data[0], (list, tuple)):
        data = tuple(data[0])
    return torch.stack(data, dim=axis)


def split(data, num_outputs, axis=1, squeeze_axis=False, **kw):
    """``num_outputs`` equal parts along ``axis``, as a list."""
    n = data.shape[axis]
    if n % num_outputs:
        raise ValueError(f"split: axis of {n} does not divide into "
                         f"{num_outputs} parts")
    parts = data.split(n // num_outputs, dim=axis)
    return [p.squeeze(axis) for p in parts] if squeeze_axis else list(parts)


SliceChannel = split


def slice_axis(data, axis, begin, end, **kw):
    idx = [builtins.slice(None)] * data.dim()
    idx[axis] = builtins.slice(begin, end)
    return data[tuple(idx)]


def clip(data, a_min, a_max, **kw):
    return torch.clamp(data, a_min, a_max)


def where(condition, x, y, **kw):
    return torch.where(condition != 0, x, y)


def take(a, indices, axis=0, mode="clip", **kw):
    """``a``'s entries along ``axis`` at ``indices`` (floats truncated),
    clipped into range (``mode="wrap"``: taken modulo the axis)."""
    n = a.shape[axis]
    i = indices.long()
    i = i % n if mode == "wrap" else i.clamp(0, n - 1)
    out = torch.index_select(a, axis, i.reshape(-1))
    return out.reshape(a.shape[:axis] + i.shape + a.shape[axis + 1:])


def one_hot(indices, depth, on_value=1.0, off_value=0.0, dtype="float32",
            **kw):
    """Rows of ``depth`` with ``on_value`` at each index (floats
    truncated); an index outside ``[0, depth)`` gives a row of
    ``off_value``."""
    hot = indices.long().unsqueeze(-1) == torch.arange(
        depth, device=indices.device)
    dt = _torch_dtype(dtype)
    return hot.to(dt) * (on_value - off_value) + off_value


# -- products -----------------------------------------------------------------
def dot(lhs, rhs, transpose_a=False, transpose_b=False, **kw):
    """The last axis of ``lhs`` against the first of ``rhs`` (matrix
    transposes first where asked)."""
    if transpose_a and lhs.dim() > 1:
        lhs = lhs.transpose(-1, -2)
    if transpose_b and rhs.dim() > 1:
        rhs = rhs.transpose(-1, -2)
    if lhs.dim() <= 2 and rhs.dim() <= 2:
        return torch.matmul(lhs, rhs)
    return torch.tensordot(lhs, rhs, dims=([-1], [0]))


def batch_dot(lhs, rhs, transpose_a=False, transpose_b=False, **kw):
    if transpose_a:
        lhs = lhs.transpose(-1, -2)
    if transpose_b:
        rhs = rhs.transpose(-1, -2)
    return torch.matmul(lhs, rhs)


# -- softmax ------------------------------------------------------------------
def softmax(data, axis=-1, temperature=None, length=None, **kw):
    """Softmax over ``axis``; with ``length`` only the first
    ``length[...]`` entries of each row take part."""
    z = data / temperature if temperature else data
    if length is not None:
        shape = [1] * data.dim()
        shape[axis] = data.shape[axis]
        steps = torch.arange(data.shape[axis],
                             device=data.device).reshape(shape)
        ln = length.reshape(tuple(length.shape)
                            + (1,) * (data.dim() - length.dim()))
        z = torch.where(steps < ln, z, -math.inf)
    return F.softmax(z, dim=axis)


def softmax_cross_entropy(data, label, **kw):
    """``-Σ log softmax(data)[label]`` over the batch (one number)."""
    logp = F.log_softmax(data, dim=-1)
    return -logp.gather(-1, label.long().unsqueeze(-1)).sum()


# -- random -------------------------------------------------------------------
class _RandomNS:
    """``nd.random``: draws on ``ctx`` (default: the current context)
    from the port's generator for that device."""

    @staticmethod
    def uniform(low=0.0, high=1.0, shape=(1,), dtype="float32", ctx=None,
                **kw):
        dev = _dev(ctx)
        u = torch.rand(tuple(shape) if shape else (), device=dev,
                       generator=_random.generator(dev))
        return _place((u * (high - low) + low).to(_torch_dtype(dtype)))

    @staticmethod
    def normal(loc=0.0, scale=1.0, shape=(1,), dtype="float32", ctx=None,
               **kw):
        dev = _dev(ctx)
        n = torch.randn(tuple(shape) if shape else (), device=dev,
                        generator=_random.generator(dev))
        return _place((n * scale + loc).to(_torch_dtype(dtype)))


random = _RandomNS()
random_uniform = uniform = random.uniform
random_normal = normal = random.normal


# every function above that takes arrays gets the imperative face
_CREATION = {"zeros", "ones", "full", "empty", "arange", "random",
             "random_uniform", "random_normal", "uniform", "normal"}
for _name, _fn in list(globals().items()):
    if callable(_fn) and getattr(_fn, "__module__", None) == __name__ \
            and not _name.startswith("_") and _name not in _CREATION \
            and not isinstance(_fn, type):
        globals()[_name] = _op(_fn)
del _name, _fn

__all__ = sorted(n for n, v in globals().items()
                 if not n.startswith("_") and (callable(v) or n == "random")
                 and getattr(v, "__module__", None) == __name__)
