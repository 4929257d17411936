"""Int8 post-training quantization, from ``tpu_mx/contrib/quantization.py``.

The same pieces as the reference: the affine-symmetric ``quantize`` /
``dequantize`` (scale ``max(|min|, |max|, 1e-8) / 127``, round half to
even, clip to ±127), a min/max calibration pass over a calibration
iterator (forward hooks on every quantizable leaf, run eager), and
``quantize_net``, which swaps every Gluon ``Dense`` and every forward
convolution for an int8 version: the input quantized with its
calibrated range, the weight once at build, the product int8 x int8 ->
int32 exactly (:mod:`tpu_mx_torch.ndarray.quantized_ops`: cuBLASLt's
int8 product on the card, integer ``matmul`` on the CPU), rescaled to
float32, the float bias added and the layer's activation applied after
the rescale.  Pooling, BatchNorm and activations between the leaves run
in float, as in the reference.

The reference compiles the quantized net's call with its own
``jax.jit`` (``TPUMX_QUANT_JIT=0`` turns that off) and clears every
block's hybridize flag around calibration and the call, since its hooks
and patched leaves act on the eager path only.  The port's forward is
eager whether hybridized or not: the call runs eager, each leaf's
forward shadowed by its int8 version for its duration, under
``torch.no_grad()``, and the knob is not read.
"""
from __future__ import annotations

import torch

from ..base import MXNetError
from ..ndarray import NDArray
from ..ndarray import quantized_ops as _q

__all__ = ["quantize", "dequantize", "calib_minmax", "QuantizedDense",
           "QuantizedConv", "quantize_net"]


def _tensor(x):
    if isinstance(x, NDArray):
        return x._data
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(x)


def _amax(min_range, max_range):
    return max(abs(min_range), abs(max_range), 1e-8)


def _int8(x, min_range, max_range):
    """``x`` quantized with the range's scale: an int8 tensor."""
    scale = 127.0 / _amax(min_range, max_range)
    return torch.clamp(torch.round(x.float() * scale), -127, 127) \
        .to(torch.int8)


def quantize(data, min_range=None, max_range=None, out_type="int8"):
    """Affine-symmetric int8 quantization (the reference's ``quantize``
    op): ``scale = max(|min|, |max|) / 127``, the range observed when not
    given.  Returns ``(q, min_range, max_range)``."""
    if out_type != "int8":
        raise MXNetError("only int8 quantization is supported")
    x = _tensor(data)
    if min_range is None or max_range is None:
        lo, hi = torch.aminmax(x.detach().float())
        if min_range is None:
            min_range = float(lo)
        if max_range is None:
            max_range = float(hi)
    return NDArray(_int8(x, min_range, max_range)), min_range, max_range


def dequantize(q, min_range, max_range):
    """Inverse of :func:`quantize` (the reference's ``dequantize`` op)."""
    return NDArray(_tensor(q).float()
                   * (_amax(min_range, max_range) / 127.0))


def calib_minmax(net, calib_iter, num_batches=10):
    """Min/max calibration (the reference's ``calib_mode='naive'``): run
    up to ``num_batches`` of ``calib_iter`` through ``net`` and record
    each quantizable leaf's input range, ``{name: (min, max)}``."""
    ranges = {}
    handles = []

    def make_hook(name):
        def hook(blk, inputs, output):
            x = inputs[0]
            if isinstance(x, NDArray):
                x = x._data
            if isinstance(x, torch.Tensor):
                lo, hi = torch.aminmax(x.detach().float())
                lo, hi = float(lo), float(hi)
                old = ranges.get(name, (lo, hi))
                ranges[name] = (min(old[0], lo), max(old[1], hi))
        return hook

    for name, blk in _named_quantizable(net):
        handles.append(blk.register_forward_hook(make_hook(name)))
    try:
        with torch.no_grad():
            for i, batch in enumerate(calib_iter):
                if i >= num_batches:
                    break
                data = batch.data[0] if hasattr(batch, "data") else batch
                net(data)
    finally:
        for h in handles:
            h.detach()
    return ranges


def _is_quantizable_conv(block):
    """Forward (not transposed) convolutions of any rank quantize;
    transposed ones stay float, as in the reference."""
    from ..gluon.nn.conv_layers import _Conv
    return isinstance(block, _Conv) and not block._transpose


def _children(block):
    """``(key, child)`` in registration order, a child registered under
    two keys once under each (as the reference's ``_children`` lists it;
    ``named_children`` would drop the repeat)."""
    return [(k, m) for k, m in block._modules.items() if m is not None]


def _named_quantizable(block, prefix=""):
    """``(name, block)`` of every quantizable leaf (``Dense`` and forward
    convolutions), named by the path of child keys."""
    from ..gluon import nn
    if isinstance(block, nn.Dense):
        yield prefix or "dense", block
        return
    if _is_quantizable_conv(block):
        yield prefix or "conv", block
        return
    for key, child in _children(block):
        sub = f"{prefix}.{key}" if prefix else str(key)
        yield from _named_quantizable(child, sub)


def _weight(layer):
    """The layer's weight in the reference's layout (a view)."""
    return layer._reg_params["weight"]._ref_view().detach()


def _bias(layer):
    p = layer._reg_params.get("bias")
    return None if p is None else p._tensor()


class QuantizedDense:
    """Int8 inference ``Dense``: int8 x int8 -> int32, rescaled to float
    (the reference's ``quantized_fully_connected``)."""

    def __init__(self, dense, input_range):
        self._wq, self._wmin, self._wmax = quantize(_weight(dense))
        self._bias = _bias(dense)
        self._act = dense.act
        self._flatten = getattr(dense, "_flatten", True)
        self._in_range = input_range

    def __call__(self, x):
        x = _tensor(x)
        xq, xmin, xmax = quantize(x, *self._in_range)
        xd = xq._data
        # Dense's input contract: flatten the trailing dims (default) or
        # contract the last axis only
        xd = xd.reshape(xd.shape[0], -1) if self._flatten \
            else xd.reshape(-1, xd.shape[-1])
        acc = _q.int8_matmul(xd, self._wq._data)
        if not self._flatten and xq.ndim > 2:
            acc = acc.reshape(tuple(xq.shape[:-1]) + (acc.shape[-1],))
        out = acc.float() * (_amax(xmin, xmax) / 127.0) \
            * (_amax(self._wmin, self._wmax) / 127.0)
        if self._bias is not None:
            out = out + self._bias
        return self._act(out) if self._act is not None else out


class QuantizedConv:
    """Int8 inference convolution through ``nd.quantized_conv`` (int32
    accumulation), rescaled to float: the weight quantized once at build,
    the input each call with its calibrated range.  Pooling and
    activations around it run in float; both preserve the range, so
    rescaling at the convolution loses nothing."""

    def __init__(self, conv, input_range):
        self._wq, self._wmin, self._wmax = quantize(_weight(conv))
        self._bias = _bias(conv)
        self._act = conv.act
        self._in_range = input_range
        self._conv = conv

    def __call__(self, x):
        c = self._conv
        x = _tensor(x)
        xq, xmin, xmax = quantize(x, *self._in_range)
        out, _, _ = _q.quantized_conv(
            xq._data, self._wq._data, None, xmin, xmax, self._wmin,
            self._wmax, kernel=c._kernel, stride=c._strides,
            pad=c._padding, dilate=c._dilation, num_filter=c._channels,
            num_group=c._groups, no_bias=True, layout=c._layout)
        y = out.float() * ((_amax(xmin, xmax) / 127.0)
                           * (_amax(self._wmin, self._wmax) / 127.0))
        if self._bias is not None:
            b = self._bias.float()
            if not c._channels_last:
                b = b.reshape((1, -1) + (1,) * len(c._kernel))
            y = y + b
        return self._act(y) if self._act is not None else y


class _QuantizedNet:
    """The inference wrapper :func:`quantize_net` returns.  For the
    duration of a call each quantizable leaf's ``forward`` is shadowed by
    its int8 version (an instance attribute over the class's method) and
    the original net's forward runs, so residual and branching
    architectures keep their control flow; between calls the net is
    untouched."""

    def __init__(self, net, qmap):
        self._net = net
        self._qmap = qmap

    def _run_patched(self, x):
        patched = []
        patched_ids = set()
        with torch.no_grad():
            try:
                for name, blk in _named_quantizable(self._net):
                    q = self._qmap.get(name)
                    # a shared layer appears under several names: patch
                    # (and unpatch) each instance once
                    if q is not None and id(blk) not in patched_ids:
                        blk.forward = q
                        patched.append(blk)
                        patched_ids.add(id(blk))
                return self._net(x)
            finally:
                for blk in patched:
                    del blk.forward

    def __call__(self, x):
        return self._run_patched(x)


def quantize_net(net, calib_iter=None, calib_data=None, num_batches=10,
                 quantize_convs=True):
    """Swap every ``Dense`` and, by default, every forward convolution for
    its int8 version, from the input ranges calibrated over
    ``calib_iter`` (or the one batch ``calib_data``).  Returns the
    wrapper; the net itself is left as it was."""
    from ..gluon import nn
    if calib_iter is None:
        if calib_data is None:
            raise MXNetError("need calib_iter or calib_data")
        calib_iter = [calib_data]
    ranges = calib_minmax(net, calib_iter, num_batches)
    qmap = {}
    for name, blk in _named_quantizable(net):
        if name not in ranges:
            continue
        if isinstance(blk, nn.Dense):
            qmap[name] = QuantizedDense(blk, ranges[name])
        elif quantize_convs:
            qmap[name] = QuantizedConv(blk, ranges[name])
    return _QuantizedNet(net, qmap)
