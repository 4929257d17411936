"""Attention dispatch: the mesh-less arms of ``tpu_mx/parallel/ring_attention.py``.

``attention`` is what models call.  :func:`attention_arm` picks the arm,
a pure function of the device type, head dim and dtype:

- ``"flash_kernel"`` (the reference's ``pallas_flash``): on the card,
  for every shape the kernels instantiate (head dims 16/32/64/128,
  float32 or bfloat16; ``kernels/flash_attention.py``).  They mask
  ragged tails, so there is no ``T`` gate, and gradients flow through
  their backward kernels;
- ``"dense"`` (the reference's ``xla_dense``): the dense plain version
  (``_dense_mask`` + ``_block_attn``) on the CPU, and on the card for
  the shapes that the reference's own gate sends dense too (a head dim
  that is not a multiple of 64, such as 80 or 96; float16), with the
  kernels' dropout mask so every arm computes the same function.  On
  the card it logs a warning, as the reference's does on its chip.  A
  shape the reference's kernel takes and the port has no instance for
  (head dims 192, 256) raises on the card
  (``kernels.flash_attention.card_dense_arm``).

Each distinct call signature is counted once in ``dispatch_counts``
under its arm.  The reference's crossover knobs
(``TPUMX_ATTENTION``, ``TPUMX_DENSE_MAX_KV``) are not ported: its table
was measured on a TPU, and a dense↔flash crossover for the H100 is open
work (ROADMAP).  Both arms take the additive ``(B|1, H|1, T|1, Tk)``
bias (ALiBi, relative positions), with its gradient.  Sequence
parallelism over a mesh's ``sp`` axis (ring, Ulysses) is not ported yet.
"""
from __future__ import annotations

import logging
import math

import torch

from ..base import MXNetError
from ..kernels import flash_attention as _fa

__all__ = ["attention", "local_flash_attention", "attention_arm",
           "dispatch_counts"]

_logger = logging.getLogger(__name__)

# Which attention path each distinct call signature took, deduplicated by
# (path, detail) as in the reference: a new shape or dtype counts once.
dispatch_counts = {"flash_kernel": 0, "dense": 0}
_seen_signatures = set()


def attention_arm(device_type, head_dim, dtype):
    """The arm :func:`local_flash_attention` takes for q/k/v of this head
    dim and dtype on a ``device_type`` (``"cuda"`` or ``"cpu"``) device:
    ``"flash_kernel"`` or ``"dense"`` (see the module docstring)."""
    if device_type != "cuda":
        return "dense"
    if _fa.kernel_takes(head_dim, dtype):
        return "flash_kernel"
    return _fa.card_dense_arm("attention", head_dim, dtype)


def _count(path, detail, warn=False):
    sig = (path, detail)
    if sig in _seen_signatures:
        return
    _seen_signatures.add(sig)
    dispatch_counts[path] += 1
    if warn:
        # the card wants the kernels: a dense arm there is a slow path
        _logger.warning("attention: dense O(T^2) arm on the card (%s)",
                        detail)
    else:
        _logger.info("attention dispatch: %s %s", path, detail)


def _dense_mask(t, tk, causal, valid_length, device):
    """Combined causal + key-padding mask ``(B|1, 1, T|1, Tk)``, or None.
    True = attend."""
    mask = None
    if causal:
        mask = (torch.arange(t, device=device)[:, None]
                >= torch.arange(tk, device=device)[None, :])[None, None]
    if valid_length is not None:
        km = (torch.arange(tk, device=device)[None, None, None, :]
              < torch.as_tensor(valid_length, device=device)
              .long()[:, None, None, None])
        mask = km if mask is None else mask & km
    return mask


def _block_attn(q, k, v, bias=None, mask=None, scale=1.0, dropout_rate=0.0,
                dropout_seed=None):
    """One q-block × k-block attention: ``(l, o)`` statistics, float32
    (the reference also returns the row max ``m`` for the ring's merge,
    which the port does not have).
    q: (B, H, Tq, D), k/v: (B, H, Tk, D); bias: added (in float32) to the
    scaled scores before the mask; mask: bool, True = attend.
    Dropout hits only the V-accumulation (the denominator ``l`` stays
    un-dropped); its mask is the flash kernels' (row ``bh = b*H + h``).
    Unlike the reference's dense arm the probabilities stay float32 for
    the PV product, as in the port's kernels."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        s = s + bias.float()
    if mask is not None:
        s = s.masked_fill(~mask, -math.inf)
    m_safe = s.amax(dim=-1).clamp_min(-1e30)   # fully masked: exp(-inf) = 0
    p = torch.exp(s - m_safe[..., None])
    l = p.sum(dim=-1)
    if dropout_rate > 0.0 and dropout_seed is not None:
        b, h, t, tk = p.shape
        dev = p.device
        keep = _fa.dropout_keep_mask(
            torch.as_tensor(dropout_seed, device=dev).reshape(1),
            torch.arange(b * h, device=dev).reshape(b, h, 1, 1),
            torch.arange(t, device=dev).reshape(1, 1, t, 1),
            torch.arange(tk, device=dev).reshape(1, 1, 1, tk), dropout_rate)
        p = torch.where(keep, p / (1.0 - dropout_rate), 0.0)
    o = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    return l, o


def local_flash_attention(q, k, v, causal=False, valid_length=None,
                          dropout_rate=0.0, dropout_seed=None, bias=None):
    """Single-device attention over ``(B, H, T, D)``: the flash kernels
    for CUDA tensors of a shape they take, the dense plain version
    otherwise (:func:`attention_arm`).  ``dropout_seed`` is a ``(1,)``
    int32 tensor (``random.take_seed``); pass ``dropout_rate > 0`` only
    in training.  ``bias`` is an additive ``(B|1, H|1, T|1, Tk)``
    attention bias."""
    rate = float(dropout_rate) if dropout_seed is not None else 0.0
    arm = attention_arm(q.device.type, q.shape[-1], q.dtype)
    _count(arm, f"shape={tuple(q.shape)} dtype={q.dtype} "
                f"device={q.device.type}",
           warn=arm == "dense" and q.device.type == "cuda")
    if arm == "flash_kernel":
        return _fa.mha_flash_attention(q, k, v, causal=causal,
                                       valid_length=valid_length,
                                       dropout_rate=rate,
                                       dropout_seed=dropout_seed, bias=bias)
    mask = _dense_mask(q.shape[2], k.shape[2], causal, valid_length,
                       q.device)
    l, o = _block_attn(q, k, v, bias=bias, mask=mask,
                          scale=1.0 / math.sqrt(q.shape[-1]),
                          dropout_rate=rate, dropout_seed=dropout_seed)
    return (o / l.clamp_min(1e-30)[..., None]).to(q.dtype)


def attention(q, k, v, mesh=None, causal=False, valid_length=None,
              dropout_rate=0.0, dropout_seed=None, bias=None,
              sp_strategy=None):
    """Dispatch: local attention (:func:`local_flash_attention`).
    ``sp_strategy`` (``"ring"``, ``"ulysses"`` or None) is checked on
    every call, mesh or not, so a typo never selects the local path
    silently.  A mesh with an ``sp`` axis longer than 1 — sequence
    parallelism — raises: ring and Ulysses attention are not ported yet
    (ROADMAP A16)."""
    if sp_strategy is not None and sp_strategy not in ("ring", "ulysses"):
        raise ValueError(f"unknown sp_strategy {sp_strategy!r}; use 'ring' "
                         "or 'ulysses'")
    if mesh is not None and "sp" in getattr(mesh, "axis_names", ()) \
            and mesh.shape["sp"] > 1:
        raise MXNetError("attention: sequence parallelism over a mesh's "
                         "'sp' axis is not ported yet (ROADMAP A16)")
    return local_flash_attention(q, k, v, causal=causal,
                                 valid_length=valid_length,
                                 dropout_rate=dropout_rate,
                                 dropout_seed=dropout_seed, bias=bias)
