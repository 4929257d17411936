"""The operators BERT calls, from ``tpu_mx/ndarray/ops.py``, on tensors.

Same names and semantics as the reference's, including its numerics in
mixed precision: ``LayerNorm`` computes its statistics in float32 and
casts the result back to the input's type, ``gelu`` is the erf form.
Matrix products go to PyTorch (cuBLAS on the card), as the reference
left them to XLA; none of these is a kernel of the port.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["FullyConnected", "Embedding", "LayerNorm", "gelu", "log_softmax",
           "pick", "Dropout"]


def FullyConnected(data, weight, bias=None):
    """``y = x·Wᵀ + b`` over the last axis of ``x``: the reference's
    ``flatten=False``, the only form BERT uses (its default ``flatten=True``
    is not ported)."""
    return F.linear(data, weight, bias)


def Embedding(data, weight):
    """Row lookup ``weight[data]`` (dense gradient, as in the reference)."""
    return F.embedding(data.long(), weight)


def LayerNorm(data, gamma, beta, eps=1e-5):
    """Layer normalization over the last axis with float32 statistics,
    result in ``data``'s type."""
    x = data.float()
    return F.layer_norm(x, x.shape[-1:], gamma.float(), beta.float(),
                        eps).to(data.dtype)


def gelu(data):
    """GELU with the exact erf form (``approximate=False``)."""
    return F.gelu(data)


def log_softmax(data, axis=-1):
    return F.log_softmax(data, dim=axis)


def pick(data, index, axis=-1):
    """``data`` at ``index`` along ``axis`` (the reference's ``pick``)."""
    return torch.gather(data, axis, index.long().unsqueeze(axis)) \
        .squeeze(axis)


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
