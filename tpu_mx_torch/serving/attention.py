"""Serving attention: flash-kernel prefill and the decode arms.

The port of ``tpu_mx/serving/attention.py``.  Two shapes of attention
exist in a serving engine and each has its kernel:

- **Prefill** — the whole prompt at once, ``(L, H, D)`` causal
  self-attention: :func:`prefill_attention` folds it to ``(H, L, D)``
  and calls the flash forward (``kernels/flash_attention.py``).  The
  suffix of a prompt whose prefix is cached (``S`` queries over ``L >
  S`` keys) takes the dense arm, the reference's route for that shape.
- **Decode** — each sequence's new token (or speculative window)
  against the paged cache: :func:`decode_attention` takes one of the
  reference's three arms, chosen by ``TPUMX_PAGED_DECODE``
  (:func:`decode_path`, resolved once per engine):

  * ``"dense"`` (``0``/``dense``/``off``): the dense-gather arm, the
    batch's block tables gathered into padded ``(B, Lpad, H, D)`` keys
    and values (``PagedKVCache.gather_batch``, on the pools' device)
    and :func:`dense_decode_attention` masked by the true lengths;
  * ``"paged"`` (``1``/``auto``/``paged``/``xla``/``on``): the paged
    kernel (``kernels/paged_attention.py``) over the pool and the raw
    block tables, where it has an instance for the shape
    (:func:`decode_arm`); the dense-gather arm otherwise;
  * ``"paged-kernel"`` (``kernel``/``interpret``): the paged kernel and
    nothing else (on the card a shape without an instance raises).

  The port's default, with the knob unset, is ``"paged"``: the
  reference's is ``"dense"``, chosen for a process where jax might be
  missing, and its fused arm needs a paged engine; the port's paged arm
  needs nothing it might lack.  An explicit value selects the
  reference's arm exactly.  :func:`decode_on_tables` is the arm's body
  for the engine's fused step, which builds the tables on the device
  once a step.

On CUDA tensors the arms launch their kernel; on CPU tensors the kernel
wrappers run their plain PyTorch versions.  For shapes the kernels do
not instantiate both take a dense arm, as the reference does off its
kernels' gates: :func:`dense_attention` for prefill, the dense gather
for decode.  On the card that is only where the reference's gate sends
the shape dense too (a head dim that is not a multiple of 64, a
float16 prompt); a shape its kernel takes and the port has no instance
for raises there.  Each call counts its arm:
``serve.prefill_attention{kind="flash"|"dense"}`` and the reference's
``serve.decode_attention{kind="dense"|"paged"|"paged-kernel"}``.
"""
from __future__ import annotations

import math
import os

import numpy as np
import torch

from .. import telemetry as _telemetry
from ..kernels import flash_attention as _fa
from ..kernels import paged_attention as _pa

__all__ = ["dense_attention", "prefill_attention", "decode_attention",
           "dense_decode_attention", "decode_path", "resolve_decode_path",
           "prefill_arm", "decode_arm", "decode_on_tables"]

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


def dense_decode_attention(q, keys, values, lengths):
    """The dense-gather decode arm (and the paged arms' parity oracle):
    ``q`` ``(B, H, D)``, each sequence's new-token query; ``keys``/
    ``values`` ``(B, Lmax, H, D)``, the padded gather of each sequence's
    block table (``PagedKVCache.gather_batch``, the new token's K/V
    written at ``length - 1``); ``lengths`` ``(B,)``.  Returns ``(B, H,
    D)``."""
    return dense_attention(q[:, None], keys, values, lengths=lengths)[:, 0]


def _gathered(pool, tables):
    b, nb = tables.shape
    return pool[tables.long()].reshape((b, nb * pool.shape[1])
                                       + tuple(pool.shape[2:]))


def _dense_on_tables(q, k_pool, v_pool, tables, lengths):
    """The dense-gather arm from the batch's device block tables: ``q``
    ``(B, H, D)``, or a ``(B, Tq, H, D)`` window with each row's last
    query at its last key (the causal alignment of
    :func:`dense_attention`)."""
    kd, vd = _gathered(k_pool, tables), _gathered(v_pool, tables)
    if q.dim() == 4:
        return dense_attention(q, kd, vd, lengths=lengths, causal=True)
    return dense_decode_attention(q, kd, vd, lengths)


# -- decode dispatch ----------------------------------------------------------
_PAGED_ENV = "TPUMX_PAGED_DECODE"


def decode_path():
    """The decode arm ``TPUMX_PAGED_DECODE`` asks for: ``"dense"``
    (``0``), ``"paged"`` (``1``/``auto``; and the port's default, with
    the knob unset) or ``"paged-kernel"`` (``kernel``).  Unknown values
    raise: a typo silently taking another arm would let a kernel parity
    run pass without the kernel."""
    v = os.environ.get(_PAGED_ENV)
    if v is None:
        return "paged"
    v = v.strip().lower()
    if v in ("", "0", "dense", "off"):
        return "dense"
    if v in ("kernel", "interpret"):
        return "paged-kernel"
    if v in ("1", "auto", "paged", "xla", "on"):
        return "paged"
    raise ValueError(
        f"{_PAGED_ENV}={v!r} is not a recognized decode arm — use 0 "
        "(dense-gather reference), 1 (paged: kernel on TPU / XLA twin "
        "off-TPU) or kernel (force the Pallas kernel, interpret off-TPU)")


def resolve_decode_path():
    """:func:`decode_path`.  The reference downgrades a paged request to
    ``"dense"`` where jax is missing; every arm of the port is always
    there."""
    return decode_path()


def decode_on_tables(q, cache, layer, tables, lengths, kind="paged"):
    """A paged arm (``kind`` ``"paged"`` or ``"paged-kernel"``) on the
    batch's block tables and true lengths as int32 device tensors:
    ``q`` ``(B, H, D)`` or a ``(B, Tq, H, D)`` window, the window's K/V
    already written.  ``"paged"`` takes the dense gather where the kernel
    has no instance for the shape (:func:`decode_arm`).  Counts
    ``serve.decode_attention`` under the arm that ran; returns q's
    shape."""
    kp, vp = cache.pool(layer)
    if kind == "paged":
        window = q.shape[1] if q.dim() == 4 else 1
        kind = decode_arm(q.shape[-1], q.dtype, kp.dtype, window,
                          q.device.type)
    if kind == "dense":
        out = _dense_on_tables(q, kp, vp, tables, lengths)
    else:
        out = _pa.paged_attention(q, kp, vp, tables, lengths)
    _telemetry.counter("serve.decode_attention", kind=kind).inc()
    return out


def decode_attention(q, cache, seq_ids, layer, kind=None, batch=None):
    """One decode step's attention for a batch of sequences against the
    paged ``cache``: ``q`` ``(B, H, D)`` — each sequence's new-token
    query — or a ``(B, Tq, H, D)`` speculative window (query ``t`` at
    position ``length - Tq + t``), the K/V already written; ``seq_ids``
    the batch in row order; ``layer`` the pool to read.  ``kind`` pins
    the arm (default :func:`resolve_decode_path`); ``batch`` is an
    optional precomputed ``cache.batch_tables(seq_ids)`` for the paged
    arms (the tables do not change between a step's layers).  Returns
    q's shape, and counts ``serve.decode_attention{kind=...}``."""
    kind = resolve_decode_path() if kind is None else kind
    if kind == "dense":
        kd, vd, lens = cache.gather_batch(seq_ids, layer)
        out = (dense_attention(q, kd, vd, lengths=lens, causal=True)
               if q.dim() == 4 else dense_decode_attention(q, kd, vd, lens))
        _telemetry.counter("serve.decode_attention", kind=kind).inc()
        return out
    tables, lengths = cache.batch_tables(seq_ids) if batch is None \
        else batch
    if not isinstance(tables, torch.Tensor):
        tables, lengths = device_tables(tables, lengths, q.device)
    return decode_on_tables(q, cache, layer, tables, lengths, kind)


def device_tables(tables, lengths, device):
    """Host block tables ``(B, NB)`` and lengths ``(B,)`` as int32 tensors
    on ``device``, in one copy."""
    host = torch.from_numpy(np.concatenate(
        [np.asarray(tables, np.int32),
         np.asarray(lengths, np.int32).reshape(-1, 1)], axis=1))
    both = host.to(device)
    return both[:, :-1].contiguous(), both[:, -1].contiguous()
