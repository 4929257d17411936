"""The gradient quantizers of ``tpu_mx/contrib/compression.py``.

Each core takes a gradient and its error-feedback residual and returns
``(dequantized_gradient, new_residual)``: the value a worker's reduction
would carry after quantizing ``grad + residual``, and what the rounding
left behind for the next step.  :class:`GradientCompression` is the
kvstore's round trip (``KVStore.set_gradient_compression``); the cores
are also the train step's compressed ``dp`` reduction
(``CompiledTrainStep(gradient_compression=)`` over a mesh).
"""
from __future__ import annotations

import torch

__all__ = ["GradientCompression", "quantize_2bit_core", "quantize_int8_core",
           "quantize_fp8_core"]


def quantize_2bit_core(grad, residual, threshold):
    """Values snap to {-threshold, 0, +threshold}; the rounding error
    feeds back."""
    acc = grad + residual
    zero = torch.zeros((), dtype=acc.dtype, device=acc.device)
    q = torch.where(acc >= threshold, zero + threshold,
                    torch.where(acc <= -threshold, zero - threshold, zero))
    return q, acc - q


def quantize_int8_core(grad, residual):
    """int8 per-tensor max-abs quantization: the wire value is
    round(acc/scale) in [-127, 127], scale = max|acc|/127."""
    acc = grad + residual
    scale = torch.clamp(acc.abs().max(), min=1e-8) / 127.0
    deq = torch.clamp(torch.round(acc / scale), -127, 127) * scale
    return deq, acc - deq


def quantize_fp8_core(grad, residual):
    """float8 (e4m3) per-tensor scaled quantization: the wire value is
    (acc/scale) cast to e4m3 (range ±448), scale = max|acc|/448."""
    acc = grad + residual
    amax = acc.abs().max()
    scale = torch.where(amax > 0, amax / 448.0, torch.ones_like(amax))
    wire = (acc / scale).to(torch.float8_e4m3fn)
    deq = wire.to(torch.float32) * scale
    return deq, acc - deq


class GradientCompression:
    """The reference's gradient compression with error feedback:
    ``compress_decompress(grad, key=)`` returns what a worker's push would
    carry after the wire format (``"2bit"`` around ``threshold``,
    ``"int8"`` or ``"fp8"``) and keeps the rounding error as the residual
    the next call under ``key`` adds back.  Without a ``key`` the residual
    is keyed by ``id(grad)``, as in the reference."""

    def __init__(self, type="2bit", threshold=0.5):
        if type not in ("2bit", "int8", "fp8"):
            raise ValueError(f"unsupported compression type {type!r} "
                             "(have: 2bit, int8, fp8)")
        self.type = type
        self.threshold = float(threshold)
        self._residuals = {}

    def compress_decompress(self, grad, key=None):
        """Round-trip a gradient (an array or a tensor) through the wire
        format; returns the same kind."""
        from ..ndarray import NDArray
        raw = grad._data if isinstance(grad, NDArray) else grad
        rkey = key if key is not None else id(grad)
        residual = self._residuals.get(rkey)
        if residual is None or residual.shape != raw.shape:
            residual = torch.zeros_like(raw)
        if self.type == "2bit":
            q, new_residual = quantize_2bit_core(raw, residual,
                                                 self.threshold)
        elif self.type == "fp8":
            q, new_residual = quantize_fp8_core(raw, residual)
        else:
            q, new_residual = quantize_int8_core(raw, residual)
        self._residuals[rkey] = new_residual
        return NDArray(q) if isinstance(grad, NDArray) else q

    def get_params(self):
        return {"type": self.type, "threshold": self.threshold}
