"""The gradient quantizers of ``tpu_mx/contrib/compression.py``.

Each core takes a gradient and its error-feedback residual and returns
``(dequantized_gradient, new_residual)``: the value a worker's reduction
would carry after quantizing ``grad + residual``, and what the rounding
left behind for the next step.  ``GradientCompression`` and the step's
compressed reduction need a mesh with a ``dp`` axis above 1 (ROADMAP A
item 9).
"""
from __future__ import annotations

import torch

__all__ = ["quantize_2bit_core", "quantize_int8_core", "quantize_fp8_core"]


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
