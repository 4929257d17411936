"""Serving attention: flash-kernel prefill and paged-kernel decode.

The port of ``tpu_mx/serving/attention.py``.  Two shapes of attention
exist in a serving engine and each has its kernel:

- **Prefill** — the whole prompt at once, ``(L, H, D)`` causal
  self-attention: :func:`prefill_attention` folds it to ``(H, L, D)``
  and calls the flash forward (``kernels/flash_attention.py``).
- **Decode** — each sequence's new token against the paged cache:
  :func:`decode_attention` hands the pool and the block tables to the
  paged kernel (``kernels/paged_attention.py``).

On CUDA tensors both launch their kernel; on CPU tensors the kernel
wrappers run their plain PyTorch versions.  The reference's
``TPUMX_PAGED_DECODE`` arms and its host dense-gather decode are not
ported: the port has one decode path.  :func:`dense_attention`, the
reference's plain masked attention, is kept as the oracle the paged
and flash versions are held to.
"""
from __future__ import annotations

import math

import torch

from .. import telemetry as _telemetry
from ..kernels.flash_attention import flash_attention
from ..kernels.paged_attention import paged_attention

__all__ = ["dense_attention", "prefill_attention", "decode_attention"]

# finite mask value, as in the kernels: exp() underflows to exactly 0
# without inf-inf = nan corners in the float32 statistics
_NEG_INF = -1e30


def dense_attention(q, k, v, lengths=None, causal=False):
    """Reference attention: ``softmax(q·kᵀ/√D  [+masks]) · v``.

    ``q``: (B, Tq, H, D); ``k``/``v``: (B, Tk, H, D); ``lengths``:
    optional int (B,) — key positions >= length are masked out.
    ``causal`` aligns the LAST query to the LAST valid key (prefill:
    Tq == Tk; decode: Tq == 1 attending to all cached keys).  float32
    scores/softmax, output cast back to ``q.dtype``."""
    b, tq, h, d = q.shape
    tk = k.shape[1]
    dev = q.device
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(d)
    kpos = torch.arange(tk, device=dev)
    lens = (torch.as_tensor(lengths, device=dev).long().reshape(b)
            if lengths is not None else torch.full((b,), tk, device=dev))
    keep = kpos.reshape(1, 1, 1, tk) < lens.reshape(b, 1, 1, 1)
    if causal:
        # query i sits at absolute position (valid_len - Tq + i)
        qpos = (lens.reshape(b, 1, 1, 1) - tq
                + torch.arange(tq, device=dev).reshape(1, 1, tq, 1))
        keep = keep & (kpos.reshape(1, 1, 1, tk) <= qpos)
    s = torch.where(keep, s, torch.full_like(s, _NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return out.to(q.dtype)


def prefill_attention(q, k, v):
    """Causal self-attention over one prompt: ``q``/``k``/``v`` are
    ``(L, H, D)`` tensors; returns ``(L, H, D)``.  The flash forward
    takes the ``(H, L, D)`` layout (heads folded into its batch axis)."""
    fold = lambda x: x.transpose(0, 1).contiguous()
    out = flash_attention(fold(q), fold(k), fold(v), causal=True)
    return out.transpose(0, 1)


def decode_attention(q, cache, layer, tables, lengths):
    """One decode step's attention for a batch, against ``layer``'s pool
    of the paged ``cache``: ``q`` is ``(B, H, D)`` (or a ``(B, Tq, H,
    D)`` window), ``tables``/``lengths`` the batch's block tables and
    true lengths as device tensors (the new token's K/V already written
    at position ``length - 1``).  Returns q's shape.  Every call counts
    ``serve.decode_attention{kind="paged"}``, the reference's observable
    of which arm a decode took."""
    kp, vp = cache.pool(layer)
    out = paged_attention(q, kp, vp, tables, lengths)
    _telemetry.counter("serve.decode_attention", kind="paged").inc()
    return out
