"""The rest of ``tpu_mx/ndarray/ops.py``'s operators, re-exported by
:mod:`.ops` as one ``nd.*`` namespace (the reference defines them in
that one module, and each reports it as its module here too).

The families, in the reference's order: the sequence operators
(``SequenceMask``/``Reverse``/``Last``, which gather along axis 0
whatever ``axis`` says, as the reference's do); ordering (``sort``,
``argsort``, ``topk``, ``argmax_channel``: a descending order is the
flip of a stable ascending sort, so tied entries come out in reverse
index order; ``topk`` keeps the lower index first among ties, as
``lax.top_k`` does; indices are float32 by default); indexing and shape
(``gather_nd`` indexes the first M axes by an ``(M, ...)`` array,
``diag`` defaults to axes (0, 1), ``ravel_multi_index`` clips,
``shape_array`` is int64); math; linear algebra (PyTorch's products and
Cholesky); ``BatchNorm`` with the reference's one-pass float32
statistics and the folded scale and bias applied in the input's type;
``RMSNorm``, ``LRN``, the masked softmaxes, ``im2col``/``col2im``
(PyTorch's ``unfold``/``fold``: the column order is (C, kh, kw), as
``lax.conv_general_dilated_patches``'); the legacy output heads, whose
backward injects the loss gradient and ignores the incoming one
(``torch.autograd.Function``s); the deprecated 0.x aliases; the random
samplers, drawn from the port's generators (:mod:`tpu_mx_torch.random`)
and so not bit-equal to the reference's key stream; and ``Custom``
(:mod:`tpu_mx_torch.operator`).

None of these reaches a Pallas kernel in the reference, so none is a
kernel of the port: each is PyTorch on tensors, on the card as on the
host.
"""
from __future__ import annotations

import builtins
import functools
import math
import warnings

import torch
import torch.nn.functional as F

from .. import autograd
from .. import random as _random
from ..base import MXNetError
from .ndarray import NDArray, _torch_dtype
from . import ops as _ops
from .ops import (_apply, _binary, _dev, _op, _op_out, _place, _prod,
                  _reduce, _tensors, _unary, _unwrap)

_OPS = _ops.__name__


# -- helpers ------------------------------------------------------------------
def _take_along(x, idx, axis):
    """``jnp.take_along_axis``: ``idx`` broadcast against ``x`` on every
    other axis, an index in ``[-n, -1]`` counted from the end and one
    outside ``[-n, n)`` reading the fill value (NaN for floats)."""
    axis = axis % x.dim()
    n = x.shape[axis]
    shape = [builtins.max(a, b) if d != axis else b
             for d, (a, b) in enumerate(zip(x.shape, idx.shape))]
    i = idx.long()
    i = torch.where(i < 0, i + n, i)
    inside = (i >= 0) & (i < n)
    i = torch.where(inside, i, 0).expand(shape)
    src_shape = list(shape)
    src_shape[axis] = n
    out = torch.gather(x.expand(src_shape), axis, i)
    return torch.where(inside.expand(shape), out, _ops._fill_value(x.dtype))


def _one_hot(y, n, axis, dtype):
    """``jax.nn.one_hot(y, n, axis=axis)``: an index outside ``[0, n)``
    gives a row of zeros."""
    pos = axis if axis >= 0 else y.dim() + 1 + axis
    shape = [1] * (y.dim() + 1)
    shape[pos] = n
    classes = torch.arange(n, device=y.device).reshape(shape)
    return (y.long().unsqueeze(pos) == classes).to(dtype)


# -- sequences ----------------------------------------------------------------
def SequenceMask(data, sequence_length=None, use_sequence_length=False,
                 value=0.0, axis=0, **kw):
    """Steps at or past each sequence's length set to ``value`` (time
    along ``axis`` 0 or 1, batch along the other)."""
    if not use_sequence_length or sequence_length is None:
        return data
    steps = torch.arange(data.shape[axis], device=data.device)
    mask = steps[:, None] < sequence_length[None, :]
    if axis == 1:
        mask = mask.T
    mask = mask.reshape(mask.shape + (1,) * (data.dim() - 2))
    return torch.where(mask, data, torch.as_tensor(value, dtype=data.dtype,
                                                   device=data.device))


def SequenceReverse(data, sequence_length=None, use_sequence_length=False,
                    axis=0, **kw):
    """Each sequence's first ``length`` steps reversed, the rest kept
    (the gather runs along axis 0, as in the reference)."""
    if not use_sequence_length or sequence_length is None:
        return torch.flip(data, (axis,))
    idx = torch.arange(data.shape[axis], device=data.device)[:, None]
    sl = sequence_length[None, :]
    rev = sl.long() - 1 - idx
    gather_idx = torch.where(idx < sl, rev, idx)
    return _take_along(data, gather_idx.reshape(
        gather_idx.shape + (1,) * (data.dim() - 2)), 0)


def SequenceLast(data, sequence_length=None, use_sequence_length=False,
                 axis=0, **kw):
    """Each sequence's step at ``length - 1`` (the last step without
    lengths), gathered along axis 0 as in the reference."""
    if use_sequence_length:
        idx = sequence_length.long() - 1
    else:
        idx = torch.full((data.shape[1],), data.shape[axis] - 1,
                         device=data.device)
    return _take_along(data, idx.reshape((1, -1) + (1,) * (data.dim() - 2)),
                       0)[0]


# -- ordering -----------------------------------------------------------------
def sort(data, axis=-1, is_ascend=True, **kw):
    s = torch.sort(data, dim=axis, stable=True).values
    return s if is_ascend else torch.flip(s, (axis,))


def argsort(data, axis=-1, is_ascend=True, dtype="float32", **kw):
    s = torch.sort(data.detach(), dim=axis, stable=True).indices
    if not is_ascend:
        s = torch.flip(s, (axis,))
    return s.to(_torch_dtype(dtype))


def topk(data, axis=-1, k=1, ret_typ="indices", is_ascend=False,
         dtype="float32", **kw):
    """The ``k`` largest (``is_ascend``: smallest) entries along
    ``axis``: ``"value"``, ``"indices"``, ``"both"`` or a 0/1 ``"mask"``.
    A stable sort orders them, so ties keep the lower index first."""
    xm = data.movedim(axis, -1)
    srt = torch.sort(xm, dim=-1, descending=not is_ascend, stable=True)
    vals = srt.values[..., :k].movedim(-1, axis)
    idx = srt.indices[..., :k]
    dt = _torch_dtype(dtype)
    if ret_typ == "value":
        return vals
    if ret_typ == "indices":
        return idx.movedim(-1, axis).to(dt)
    if ret_typ == "both":
        return vals.detach(), idx.movedim(-1, axis).to(dt)
    if ret_typ == "mask":
        m = torch.zeros(xm.shape, dtype=dt, device=data.device)
        return m.scatter_(-1, idx, 1).movedim(-1, axis)
    raise ValueError(ret_typ)


def argmax_channel(data, **kw):
    """Argmax over axis 1, as float32."""
    return torch.argmax(data, dim=1).float()


# -- indexing and shape -------------------------------------------------------
def gather_nd(data, indices, **kw):
    """``data[indices[0], ..., indices[M-1]]``."""
    i = indices.long()
    return data[tuple(i[k] for k in range(i.shape[0]))]


def scatter_nd(data, indices, shape, **kw):
    """Zeros of ``shape`` with ``data`` added at ``indices`` (the
    inverse of :func:`gather_nd`)."""
    i = indices.long()
    out = torch.zeros(tuple(shape), dtype=data.dtype, device=data.device)
    return out.index_put(tuple(i[k] for k in range(i.shape[0])), data,
                         accumulate=True)


def batch_take(a, indices, **kw):
    """``out[i] = a[i, indices[i]]``."""
    return _take_along(a, indices[:, None], 1)[:, 0]


def choose_element_0index(lhs, rhs, **kw):
    """``out[i] = lhs[i, rhs[i]]``."""
    return lhs[torch.arange(lhs.shape[0], device=lhs.device), rhs.long()]


def fill_element_0index(lhs, mhs, rhs, **kw):
    """``lhs`` with ``lhs[i, rhs[i]] = mhs[i]``."""
    rows = torch.arange(lhs.shape[0], device=lhs.device)
    return lhs.index_put((rows, rhs.long()), mhs.to(lhs.dtype))


def slice(data, begin, end, step=None, **kw):
    """``data[begin[i]:end[i]:step[i]]`` on each leading axis (an end of
    None is the axis' length, as in the reference; a negative step
    too)."""
    out = data
    for i in range(len(begin)):
        n = out.shape[i]
        e = end[i] if end[i] is not None else n
        s = (step[i] if step else None) or 1
        sl = builtins.slice(begin[i], e, s)
        if s > 0:
            out = out[(builtins.slice(None),) * i + (sl,)]
        else:
            idx = torch.arange(*sl.indices(n), device=data.device)
            out = out.index_select(i, idx)
    return out


def slice_like(data, shape_like, axes=None, **kw):
    idx = [builtins.slice(None)] * data.dim()
    for a in (axes if axes is not None else range(shape_like.dim())):
        idx[a] = builtins.slice(0, shape_like.shape[a])
    return data[tuple(idx)]


def diag(data, k=0, axis1=0, axis2=1, **kw):
    """A 1-D input: the matrix with it on diagonal ``k``.  Otherwise
    diagonal ``k`` over ``(axis1, axis2)``, which default to (0, 1), not
    numpy's last two."""
    if data.dim() == 1:
        return torch.diag(data, k)
    return torch.diagonal(data, offset=k, dim1=axis1, dim2=axis2)


def unravel_index(data, shape=None, **kw):
    """Flat indices to coordinate rows, ``(ndim, N)``."""
    idx = data.long()
    coords = []
    for d in reversed(tuple(int(s) for s in shape)):
        coords.append(torch.remainder(idx, d))
        idx = torch.div(idx, d, rounding_mode="floor")
    return torch.stack(coords[::-1])


def ravel_multi_index(data, shape=None, **kw):
    """Coordinate rows ``(ndim, N)`` to flat indices, each coordinate
    clipped into its axis."""
    dims = tuple(int(s) for s in shape)
    flat = torch.zeros(data.shape[1:], dtype=torch.int64, device=data.device)
    for i, d in enumerate(dims):
        flat = flat * d + data[i].long().clamp(0, d - 1)
    return flat


def shape_array(data, **kw):
    return torch.tensor(tuple(data.shape), dtype=torch.int64,
                        device=data.device)


def size_array(data, **kw):
    return torch.tensor([data.numel()], dtype=torch.int64, device=data.device)


def Crop(data, *like, offset=(0, 0), h_w=(0, 0), center_crop=False, **kw):
    """Spatial crop of ``(N, C, H, W)`` data to ``h_w`` or to the second
    input's spatial size, at ``offset`` or centred."""
    if not like and (int(h_w[0]) <= 0 or int(h_w[1]) <= 0):
        raise ValueError("Crop: pass a crop_like second input or a "
                         "positive h_w target size")
    th, tw = (like[0].shape[2:4] if like else (int(h_w[0]), int(h_w[1])))
    h, w = data.shape[2], data.shape[3]
    if center_crop:
        oy, ox = (h - th) // 2, (w - tw) // 2
    else:
        oy, ox = int(offset[0]), int(offset[1])
    return data[:, :, oy:oy + th, ox:ox + tw]


def broadcast_axis(data, axis=0, size=1, **kw):
    """``data`` broadcast to ``size`` along ``axis`` (each a value or a
    list)."""
    axes = axis if isinstance(axis, (list, tuple)) else (axis,)
    sizes = size if isinstance(size, (list, tuple)) else (size,)
    shp = list(data.shape)
    for a, s in zip(axes, sizes):
        shp[a] = s
    return data.expand(tuple(shp))


broadcast_axes = broadcast_axis


def eye(N, M=0, k=0, ctx=None, dtype="float32"):
    dev = _dev(ctx)
    m = M if M else N
    diff = torch.arange(m, device=dev)[None, :] - \
        torch.arange(N, device=dev)[:, None]
    return _place((diff == k).to(_torch_dtype(dtype)))


def linspace(start, stop, num, endpoint=True, ctx=None, dtype="float32"):
    dev = _dev(ctx)
    if endpoint:
        a = torch.linspace(start, stop, num, dtype=torch.float64, device=dev)
    else:
        a = torch.linspace(start, stop, num + 1, dtype=torch.float64,
                           device=dev)[:num]
    return _place(a.to(_torch_dtype(dtype)))


# -- math ---------------------------------------------------------------------
arctan2 = _binary(lambda a, b: torch.atan2(*_tensors(a, b)), "arctan2")
erfcinv = _unary(lambda x: -torch.special.ndtri(x.float() / 2.0)
                 / math.sqrt(2.0), "erfcinv")
nansum = _reduce(lambda x, d, k: torch.nansum(x, dim=d, keepdim=k)
                 if d else torch.where(x.isnan(), 0, x), "nansum")
nanprod = _reduce(lambda x, d, k: _prod(torch.where(x.isnan(), 1, x), d, k)
                  if d else torch.where(x.isnan(), 1, x), "nanprod")


def cumsum(data, axis=None, dtype=None):
    """Running sum along ``axis`` (None: of the flattened array)."""
    x = data.reshape(-1) if axis is None else data
    return torch.cumsum(x, dim=0 if axis is None else axis,
                        dtype=_torch_dtype(dtype))


def polygamma(n, data, **kw):
    return torch.special.polygamma(int(n), data)


def gammainc(a, x, **kw):
    """The regularized lower incomplete gamma function."""
    return torch.special.gammainc(*_tensors(a, x))


def nextafter(lhs, rhs, **kw):
    return torch.nextafter(*_tensors(lhs, rhs)).detach()


def moments(data, axes=None, keepdims=False, **kw):
    """``(mean, variance)`` over ``axes`` (None: all), in ``data``'s
    type."""
    ax = tuple(axes) if axes is not None else tuple(range(data.dim()))
    mu = data.mean(dim=ax, keepdim=True)
    var = (data - mu).square().mean(dim=ax, keepdim=keepdims)
    return (mu if keepdims else mu.reshape(var.shape)), var


def khatri_rao(*matrices, **kw):
    """Column-wise Kronecker product: ``(r_i, k)`` inputs give a
    ``(prod r_i, k)`` matrix."""
    out = matrices[0]
    for m in matrices[1:]:
        out = torch.einsum("ik,jk->ijk", out, m).reshape(-1, out.shape[-1])
    return out


def multi_all_finite(*arrays, num_arrays=None, init_output=True, **kw):
    """``[1.]`` when every element of every input is finite, else
    ``[0.]``."""
    ok = torch.ones((1,), dtype=torch.float32, device=arrays[0].device)
    for x in arrays:
        ok = ok * torch.isfinite(x.detach()).all().float()
    return ok


all_finite = multi_all_finite


def amp_cast(data, dtype, **kw):
    return data.to(_torch_dtype(dtype))


def amp_multicast(*data, num_outputs=None, **kw):
    """Every input cast to the widest of their types."""
    widest = functools.reduce(torch.promote_types, [d.dtype for d in data])
    return [d.to(widest) for d in data]


# -- linear algebra -----------------------------------------------------------
def _op_t(a, flag):
    return a.transpose(-1, -2) if flag else a


def linalg_gemm(A, B, C, transpose_a=False, transpose_b=False, alpha=1.0,
                beta=1.0, **kw):
    """``alpha·op(A)·op(B) + beta·C``."""
    return alpha * torch.matmul(_op_t(A, transpose_a),
                                _op_t(B, transpose_b)) + beta * C


def linalg_gemm2(A, B, transpose_a=False, transpose_b=False, alpha=1.0,
                 **kw):
    """``alpha·op(A)·op(B)``."""
    return alpha * torch.matmul(_op_t(A, transpose_a), _op_t(B, transpose_b))


def linalg_potrf(A, **kw):
    """The lower Cholesky factor."""
    return torch.linalg.cholesky(A)


def linalg_syrk(A, transpose=False, alpha=1.0, **kw):
    """``alpha·Aᵀ·A`` (``transpose``) or ``alpha·A·Aᵀ``."""
    at = A.transpose(-1, -2)
    return alpha * (torch.matmul(at, A) if transpose else torch.matmul(A, at))


# -- normalization, activation, patches ---------------------------------------
def _onepass_stats(xf, axes):
    """``(mean, var)`` from one pass of sum and sum of squares, the
    variance clamped at 0 (the reference's BatchNorm statistics)."""
    n = math.prod(xf.shape[a] for a in axes)
    mu = xf.sum(dim=axes) / n
    return mu, torch.clamp(xf.square().sum(dim=axes) / n - mu.square(),
                           min=0.0)


def batch_norm_core(x, gamma, beta, moving_mean, moving_var, eps,
                    use_batch_stats, axis=1, fix_gamma=False):
    """BatchNorm's forward: ``(out, mean, var)``.  Batch statistics in
    float32 in one pass, or the moving ones; the per-channel scale and
    bias folded in float32 and applied in ``x``'s type."""
    axis = axis % x.dim()
    shape = [1] * x.dim()
    shape[axis] = x.shape[axis]
    g = torch.ones_like(gamma) if fix_gamma else gamma
    if use_batch_stats:
        mu, var = _onepass_stats(
            x.float(), tuple(i for i in range(x.dim()) if i != axis))
        inv = torch.rsqrt(var + eps)
    else:
        mu, var = moving_mean.float(), moving_var.float()
        # rounded once from float64, as the Gluon layer's
        inv = torch.rsqrt(var.double() + eps).float()
    scale = inv * g.float()
    bias = beta.float() - mu * scale
    y = x * scale.reshape(shape).to(x.dtype) + bias.reshape(shape).to(x.dtype)
    return y, mu, var


def BatchNorm(data, gamma, beta, moving_mean, moving_var, eps=1e-5,
              momentum=0.9, fix_gamma=True, use_global_stats=False, axis=1,
              **kw):
    """The operator: batch statistics in training (and not
    ``use_global_stats``), the moving ones otherwise.  It updates no
    running statistic (Gluon's ``BatchNorm`` layer does, on its own
    path)."""
    training = autograd.is_training() and not use_global_stats
    return batch_norm_core(data, gamma, beta, moving_mean, moving_var, eps,
                           training, axis, fix_gamma)[0]


def RMSNorm(data, gamma=None, axis=-1, eps=1e-6, **kw):
    """``x / sqrt(mean(x²) + eps) · gamma`` in float32, result in
    ``data``'s type."""
    xf = data.float()
    ms = xf.square().mean(dim=axis, keepdim=True)
    shape = [1] * data.dim()
    shape[axis] = data.shape[axis]
    return (xf * torch.rsqrt(ms + eps) * gamma.reshape(shape)).to(data.dtype)


def LRN(data, alpha=1e-4, beta=0.75, knorm=2.0, nsize=5, **kw):
    """Local response normalization across the channels of ``(N, C, H,
    W)`` data, in float32."""
    sq = data.float().square()
    half = nsize // 2
    padded = F.pad(sq, (0, 0, 0, 0, half, half))
    c = data.shape[1]
    acc = builtins.sum(padded[:, i:i + c] for i in range(nsize))
    norm = (knorm + alpha * acc / nsize) ** beta
    return (data.float() / norm).to(data.dtype)


def SoftmaxActivation(data, mode="instance", **kw):
    return _ops.softmax(data, axis=1 if mode == "channel" else -1)


def _masked(fn, fill):
    def op(data, mask, axis=-1, temperature=1.0, **kw):
        keep = mask != 0
        z = torch.where(keep, data.float() / temperature,
                        torch.finfo(torch.float32).min)
        return torch.where(keep, fn(z, dim=axis), fill).to(data.dtype)
    return op


masked_softmax = _masked(F.softmax, 0.0)
masked_softmax.__name__ = masked_softmax.__qualname__ = "masked_softmax"
masked_softmax.__doc__ = """Softmax over the positions where ``mask`` is
not 0, in float32; a fully masked row gives 0."""
masked_log_softmax = _masked(F.log_softmax, -math.inf)
masked_log_softmax.__name__ = masked_log_softmax.__qualname__ = \
    "masked_log_softmax"
masked_log_softmax.__doc__ = """Log-softmax over the positions where
``mask`` is not 0, in float32; a fully masked row gives -inf."""


def _patch_args(kernel, stride, dilate, pad):
    k = (kernel, kernel) if isinstance(kernel, int) else tuple(kernel)
    return dict(kernel_size=k,
                stride=_ops._pair(stride, 2) if stride else (1, 1),
                dilation=_ops._pair(dilate, 2) if dilate else (1, 1),
                padding=_ops._pair(pad, 2) if pad else (0, 0))


def im2col(data, kernel, stride=None, dilate=None, pad=None, **kw):
    """Sliding-window patches as columns: ``(N, C, H, W)`` to ``(N,
    C·kh·kw, L)``, rows in (C, kh, kw) order."""
    return F.unfold(data, **_patch_args(kernel, stride, dilate, pad))


def col2im(data, output_size, kernel, stride=None, dilate=None, pad=None,
           **kw):
    """The columns added back into an ``output_size`` image (the adjoint
    of :func:`im2col`)."""
    return F.fold(data, tuple(output_size),
                  **_patch_args(kernel, stride, dilate, pad))


# -- output heads -------------------------------------------------------------
class _Head(torch.autograd.Function):
    """A loss layer: ``fwd(x, y)`` forward; backward ``grad(out, x, y)``,
    whatever gradient arrives (the reference's ``_output_head``)."""

    @staticmethod
    def forward(ctx, x, y, fwd, grad):
        out = fwd(x, y)
        ctx.grad = grad
        ctx.save_for_backward(out, x, y)
        return out

    @staticmethod
    def backward(ctx, g):
        out, x, y = ctx.saved_tensors
        return ctx.grad(out, x, y), None, None, None


def _head(x, y, fwd, grad):
    if not isinstance(y, torch.Tensor):
        y = torch.as_tensor(y, dtype=x.dtype, device=x.device)
    return _Head.apply(x, y, fwd, grad)


def SoftmaxOutput(data, label, grad_scale=1.0, ignore_label=-1.0,
                  multi_output=False, use_ignore=False, preserve_shape=False,
                  normalization="null", out_grad=False, smooth_alpha=0.0,
                  **kw):
    """Softmax forward (over axis 1 with ``multi_output``); backward
    ``(p - onehot(label)) · grad_scale``, with label smoothing, ignored
    labels and ``normalization`` ``"null"``/``"batch"``/``"valid"``."""
    axis = 1 if multi_output else -1

    def grad(p, x, y):
        n_class = x.shape[axis]
        oh = _one_hot(y, n_class, axis, x.dtype)
        if smooth_alpha:
            oh = oh * (1.0 - smooth_alpha) + smooth_alpha / n_class
        g = p - oh
        if use_ignore:
            valid = (y != ignore_label).to(x.dtype)
            g = g * valid.unsqueeze(axis if axis != -1 else x.dim() - 1)
        if normalization == "batch":
            g = g / x.shape[0]
        elif normalization == "valid":
            if use_ignore:
                cnt = torch.clamp((y != ignore_label).sum(), min=1).to(
                    x.dtype)
            else:
                cnt = torch.tensor(float(math.prod(y.shape)), dtype=x.dtype,
                                   device=x.device)
            g = g / cnt
        return g * grad_scale

    return _head(data, label, lambda x, y: F.softmax(x, dim=axis), grad)


def SVMOutput(data, label, margin=1.0, regularization_coefficient=1.0,
              use_linear=False, **kw):
    """Scores forward; backward the L2-SVM (``use_linear``: L1) hinge
    subgradient: for ``j != y`` ``2λh`` (``λ`` where ``h > 0``) with ``h
    = max(0, margin + x_j - x_y)``, for ``j = y`` minus their sum."""
    def grad(out, x, y):
        yi = y.long()
        xy = torch.gather(x, -1, yi.unsqueeze(-1))
        h = torch.clamp(margin + x - xy, min=0.0)
        lam = regularization_coefficient
        g = torch.where(h > 0, lam, 0.0).to(x.dtype) if use_linear \
            else 2.0 * lam * h
        oh = _one_hot(yi, x.shape[-1], -1, x.dtype)
        g = g * (1 - oh)
        g = g - oh * g.sum(dim=-1, keepdim=True)
        return g.to(x.dtype)

    return _head(data, label, lambda x, y: x.clone(), grad)


def _regression_head(link, residual, name, doc):
    def make(data, label, grad_scale=1.0, **kw):
        def grad(out, x, y):
            return residual(out, y.reshape(out.shape)) * \
                (grad_scale / out.shape[0])
        return _head(data, label, lambda x, y: link(x), grad)
    make.__name__ = make.__qualname__ = name
    make.__doc__ = doc
    return make


LinearRegressionOutput = _regression_head(
    lambda x: x.clone(), lambda o, y: o - y, "LinearRegressionOutput",
    "Identity forward; backward ``(out - label)·grad_scale/N``.")
MAERegressionOutput = _regression_head(
    lambda x: x.clone(), lambda o, y: torch.sign(o - y),
    "MAERegressionOutput",
    "Identity forward; backward ``sign(out - label)·grad_scale/N``.")
LogisticRegressionOutput = _regression_head(
    torch.sigmoid, lambda o, y: o - y, "LogisticRegressionOutput",
    "Sigmoid forward; backward ``(out - label)·grad_scale/N``.")


def MakeLoss(data, grad_scale=1.0, valid_thresh=0.0, normalization="null",
             **kw):
    """``data`` taken as a loss: identity forward, backward
    ``grad_scale`` (over the batch, or over the entries above
    ``valid_thresh``)."""
    def grad(out, x, y):
        g = torch.full_like(x, grad_scale)
        if normalization == "batch":
            g = g / x.shape[0]
        elif normalization == "valid":
            g = g / torch.clamp((x > valid_thresh).sum(), min=1).to(x.dtype)
        return g

    return _head(data, 0.0, lambda x, y: x.clone(), grad)


def make_loss(data, **kw):
    """Identity: the gradient of ones flows from it."""
    return data


class _KLSparse(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, rho_hat, rho, pen):
        if rho_hat is None:
            rho_hat = x.reshape(x.shape[0], -1).mean(dim=0).clamp(
                1e-6, 1.0 - 1e-6)
        ctx.rho_hat, ctx.rho, ctx.pen, ctx.shape = rho_hat, rho, pen, x.shape
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        rho_hat = ctx.rho_hat
        kl = ctx.pen * (-ctx.rho / rho_hat + (1 - ctx.rho) / (1 - rho_hat))
        return g + kl.reshape((1,) + tuple(ctx.shape[1:])), None, None, None


def IdentityAttachKLSparseReg(data, sparseness_target=0.1, penalty=0.001,
                              momentum=0.9, moving_avg=None, **kw):
    """Identity forward; the backward adds ``penalty·(-ρ/ρ̂ +
    (1-ρ)/(1-ρ̂))`` per unit, ``ρ`` the target and ``ρ̂`` the unit's mean
    activation over the batch, or its moving average with ``moving_avg``
    (blended with ``momentum`` and rebound in place while recording)."""
    rho, pen, mom = float(sparseness_target), float(penalty), float(momentum)
    rho_hat = None
    if moving_avg is not None:
        if autograd._STATE.functional:
            raise MXNetError(
                "IdentityAttachKLSparseReg: the moving_avg state cannot be "
                "updated inside a hybridized forward; use moving_avg=None "
                "there, or train this block eagerly")
        x = _unwrap(data).detach()
        ma = _unwrap(moving_avg)
        new_ma = mom * ma.reshape(-1) + (1 - mom) * \
            x.reshape(x.shape[0], -1).mean(dim=0)
        rho_hat = new_ma.clamp(1e-6, 1.0 - 1e-6)
        if autograd.is_recording() and isinstance(moving_avg, NDArray):
            moving_avg._rebind(new_ma.reshape(ma.shape).to(ma.dtype))
    return _apply(lambda t: _KLSparse.apply(t, rho_hat, rho, pen), (data,),
                  {})


# -- random -------------------------------------------------------------------
def _draw(shape, ctx, dtype, fn):
    dev = _dev(ctx)
    out = fn(tuple(shape) if shape else (), dev, _random.generator(dev))
    return _place(out.to(_torch_dtype(dtype)))


def random_randint(low, high, shape=(1,), dtype="int32", ctx=None, **kw):
    return _draw(shape, ctx, dtype, lambda s, d, g: torch.randint(
        int(low), int(high), s, device=d, generator=g))


def random_gamma(alpha=1.0, beta=1.0, shape=(1,), dtype="float32", ctx=None,
                 **kw):
    return _draw(shape, ctx, dtype, lambda s, d, g: torch._standard_gamma(
        torch.full(s, float(alpha), device=d), generator=g) * beta)


def random_exponential(scale=1.0, shape=(1,), dtype="float32", ctx=None,
                       **kw):
    return _draw(shape, ctx, dtype, lambda s, d, g: torch.empty(
        s, device=d).exponential_(1.0, generator=g) * scale)


def random_poisson(lam=1.0, shape=(1,), dtype="float32", ctx=None, **kw):
    return _draw(shape, ctx, dtype, lambda s, d, g: torch.poisson(
        torch.full(s, float(lam), device=d), generator=g))


def random_bernoulli(prob=0.5, shape=(1,), dtype="float32", ctx=None, **kw):
    return _draw(shape, ctx, dtype, lambda s, d, g: torch.rand(
        s, device=d, generator=g) < prob)


def randn(*shape, **kw):
    return _ops.random_normal(shape=shape, **kw)


def sample_multinomial(data, shape=1, get_prob=False, dtype="int32", **kw):
    """``shape`` draws of a class from each row of probabilities ``data``
    (the last axis), as ``data.shape[:-1] + (n,)`` (n = 1: without that
    axis)."""
    n = shape if isinstance(shape, int) else math.prod(shape)
    p = data.detach().float().reshape(-1, data.shape[-1])
    s = torch.multinomial(torch.clamp(p, min=1e-30), n, replacement=True,
                          generator=_random.generator(data.device))
    s = s.reshape(tuple(data.shape[:-1]) + (n,)).to(_torch_dtype(dtype))
    return s.squeeze(-1) if n == 1 else s


def shuffle(data, **kw):
    """``data``'s rows (axis 0) in a random order."""
    perm = torch.randperm(data.shape[0], device=data.device,
                          generator=_random.generator(data.device))
    return data.detach()[perm]


# -- custom operators ---------------------------------------------------------
def Custom(*args, op_type=None, **op_params):
    """A registered custom operator (``@mx.operator.register(name)``) on
    ``args``: ``nd.Custom(x, ..., op_type=name, **params)``."""
    from .. import operator as _operator
    if op_type is None:
        raise ValueError("Custom requires op_type=")
    return _operator._invoke_custom(args, op_type, **op_params)


# every function above that takes arrays gets the imperative face, the
# elementwise ones the reference's out=; each is reported as an operator
# of :mod:`.ops`.  The creation operators place their results themselves,
# and the last two take the array handles they rebind or hand on
_OWN_FACE = {"eye", "linspace", "random_randint", "random_gamma",
             "random_exponential", "random_poisson", "random_bernoulli",
             "randn", "IdentityAttachKLSparseReg", "Custom"}
for _name, _fn in list(globals().items()):
    if callable(_fn) and not _name.startswith("_") \
            and not isinstance(_fn, type) \
            and getattr(_fn, "__module__", None) in (__name__, _OPS):
        if _name not in _OWN_FACE:
            _fn = (_op_out if getattr(_fn, "_out", False) else _op)(_fn)
        _fn.__module__ = _OPS
        globals()[_name] = _fn
del _name, _fn


def _deprecated_v1(new_fn, old_name):
    """``new_fn`` under its 0.x name, with its signature, warning once a
    call that the name is deprecated."""
    @functools.wraps(new_fn)
    def op(*args, **kw):
        warnings.warn(f"{old_name} is the deprecated 0.x alias of "
                      f"{new_fn.__name__}; it forwards with identical "
                      "semantics", DeprecationWarning, stacklevel=2)
        return new_fn(*args, **kw)
    op.__name__ = op.__qualname__ = old_name
    op.__doc__ = f"Deprecated alias of :func:`{new_fn.__name__}`."
    return op


BatchNorm_v1 = _deprecated_v1(BatchNorm, "BatchNorm_v1")
# the 0.x name of SoftmaxOutput (softmax forward, injected gradient), not
# of softmax
Softmax = _deprecated_v1(SoftmaxOutput, "Softmax")
Convolution_v1 = _deprecated_v1(_ops.Convolution, "Convolution_v1")
Pooling_v1 = _deprecated_v1(_ops.Pooling, "Pooling_v1")

__all__ = sorted(n for n, v in globals().items()
                 if not n.startswith("_") and callable(v)
                 and not isinstance(v, type)
                 and getattr(v, "__module__", None) == _OPS)
