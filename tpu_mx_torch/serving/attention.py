"""Serving attention: flash-kernel prefill and paged-kernel decode.

The port of ``tpu_mx/serving/attention.py``.  Two shapes of attention
exist in a serving engine and each has its kernel:

- **Prefill** — the whole prompt at once, ``(L, H, D)`` causal
  self-attention: :func:`prefill_attention` folds it to ``(H, L, D)``
  and calls the flash forward (``kernels/flash_attention.py``).  The
  suffix of a prompt whose prefix is cached (``S`` queries over ``L >
  S`` keys) takes the dense arm, the reference's route for that shape.
- **Decode** — each sequence's new token against the paged cache:
  :func:`decode_attention` hands the pool and the block tables to the
  paged kernel (``kernels/paged_attention.py``).

On CUDA tensors both launch their kernel; on CPU tensors the kernel
wrappers run their plain PyTorch versions.  For shapes the kernels do
not instantiate both take a dense arm, as the reference does off its
kernels' gates: :func:`dense_attention` for prefill, and the reference's
dense-gather decode (the batch's block tables gathered into padded
``(B, NB*BS, H, D)`` keys and values).  On the card that is only where
the reference's gate sends the shape dense too (a head dim that is not
a multiple of 64, a float16 prompt); a shape its kernel takes and the
port has no instance for raises there.  The arm is a pure function of
shape, dtype and device (:func:`prefill_arm`, :func:`decode_arm`) and
each call counts it: ``serve.prefill_attention{kind="flash"|"dense"}``
and the reference's ``serve.decode_attention{kind="paged"|"dense"}``.
The reference's ``TPUMX_PAGED_DECODE`` knob is not ported: a shape the
paged kernel takes always decodes through it.
"""
from __future__ import annotations

import math

import torch

from .. import telemetry as _telemetry
from ..kernels import flash_attention as _fa
from ..kernels import paged_attention as _pa

__all__ = ["dense_attention", "dense_decode_attention",
           "prefill_attention", "decode_attention", "prefill_arm",
           "decode_arm"]

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


def prefill_arm(head_dim, dtype, device_type="cuda", queries=None,
                keys=None):
    """``"flash"`` where the flash forward has an instance for this head
    dim and dtype and the prefill is a whole prompt, else ``"dense"``; a
    suffix prefill (``keys`` > ``queries``) is dense, as in the
    reference.  On the card a whole-prompt shape the reference's kernel
    takes without an instance here raises
    (``kernels.flash_attention.card_dense_arm``)."""
    suffix = keys is not None and keys != queries
    if _fa.kernel_takes(head_dim, dtype) and not suffix:
        return "flash"
    if device_type != "cuda":
        return "dense"
    return _fa.card_dense_arm("prefill_attention", head_dim, dtype,
                              suffix=suffix)


def decode_arm(head_dim, q_dtype, pool_dtype, window=1, device_type="cuda"):
    """``"paged"`` where the paged kernel has an instance for this decode
    (head dim, query and pool dtypes, window ``Tq``), else ``"dense"``;
    on the card a decode the reference's kernel takes (its gate reads
    the head dim and the query's dtype) without an instance here
    raises."""
    if _pa.kernel_takes(head_dim, q_dtype, pool_dtype, window):
        return "paged"
    if device_type != "cuda":
        return "dense"
    return _fa.card_dense_arm("decode_attention", head_dim, q_dtype,
                              f" (pool {pool_dtype}, window {window})")


def prefill_attention(q, k, v):
    """Causal self-attention over one prompt: ``q`` is ``(S, H, D)`` and
    ``k``/``v`` are ``(L, H, D)`` with ``L >= S``; returns ``(S, H, D)``.
    ``L == S`` is a whole prompt; ``L > S`` a suffix after a cached
    prefix, query ``i`` at position ``L - S + i``.  The flash forward
    takes the ``(H, L, D)`` layout (heads folded into its batch axis);
    the dense arm (:func:`prefill_arm`) runs :func:`dense_attention`."""
    kind = prefill_arm(q.shape[-1], q.dtype, q.device.type, q.shape[0],
                       k.shape[0])
    _telemetry.counter("serve.prefill_attention", kind=kind).inc()
    if kind == "dense":
        return dense_attention(q[None], k[None], v[None], causal=True)[0]
    fold = lambda x: x.transpose(0, 1).contiguous()
    out = _fa.flash_attention(fold(q), fold(k), fold(v), causal=True)
    return out.transpose(0, 1)


def dense_decode_attention(q, k_pool, v_pool, tables, lengths):
    """The dense-gather decode arm: each row's block table gathered into
    padded ``(B, NB*BS, H, D)`` keys and values, then
    :func:`dense_attention` with the row's length (and, for a ``(B, Tq,
    H, D)`` window, the causal alignment of its last query to its last
    key).  ``q`` is ``(B, H, D)`` or ``(B, Tq, H, D)``; returns its
    shape."""
    b, nb = tables.shape
    idx = tables.long()
    gather = lambda pool: pool[idx].reshape((b, nb * pool.shape[1])
                                            + tuple(pool.shape[2:]))
    kd, vd = gather(k_pool), gather(v_pool)
    if q.dim() == 4:
        return dense_attention(q, kd, vd, lengths=lengths, causal=True)
    return dense_attention(q[:, None], kd, vd, lengths=lengths)[:, 0]


def decode_attention(q, cache, layer, tables, lengths):
    """One decode step's attention for a batch, against ``layer``'s pool
    of the paged ``cache``: ``q`` is ``(B, H, D)`` (or a ``(B, Tq, H,
    D)`` window), ``tables``/``lengths`` the batch's block tables and
    true lengths as device tensors (the new token's K/V already written
    at position ``length - 1``).  Returns q's shape.  The paged kernel
    runs where it has an instance (:func:`decode_arm`), the dense-gather
    arm otherwise.  Every call counts ``serve.decode_attention{kind=
    "paged"|"dense"}``, the reference's observable of which arm a
    decode took."""
    kp, vp = cache.pool(layer)
    window = q.shape[1] if q.dim() == 4 else 1
    kind = decode_arm(q.shape[-1], q.dtype, kp.dtype, window, q.device.type)
    if kind == "paged":
        out = _pa.paged_attention(q, kp, vp, tables, lengths)
    else:
        out = dense_decode_attention(q, kp, vp, tables, lengths)
    _telemetry.counter("serve.decode_attention", kind=kind).inc()
    return out
