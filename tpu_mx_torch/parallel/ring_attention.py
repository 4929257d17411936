"""Attention dispatch: the mesh-less arms of ``tpu_mx/parallel/ring_attention.py``.

``attention`` is what models call.  :func:`attention_arm` picks the arm,
a pure function of the device type, head dim, dtype, the
``TPUMX_ATTENTION`` mode and the key length:

- ``"flash_kernel"`` (the reference's ``pallas_flash``): on the card,
  for every shape the kernels instantiate (head dims 16/32/64/128,
  float32 or bfloat16; ``kernels/flash_attention.py``).  They mask
  ragged tails, so there is no ``T`` gate, and gradients flow through
  their backward kernels;
- ``"dense"`` (the reference's ``xla_dense``): the dense plain version
  (``_dense_mask`` + ``_block_attn``), with the kernels' dropout mask so
  every arm computes the same function.  It runs on the CPU whatever the
  mode, as the reference's does off its chip; on the card where the
  mode asks for it (``dense``, or ``auto`` at a key length of at most
  ``TPUMX_DENSE_MAX_KV``), and for the shapes the reference's own gate
  sends dense too (a head dim that is not a multiple of 64, such as 80
  or 96; float16), where it logs a warning as the reference's does on
  its chip: a deliberate dense choice does not.  A shape the
  reference's kernel takes and the port has no instance for (head dims
  192, 256) raises on the card unless the mode chose dense
  (``kernels.flash_attention.card_dense_arm``).

``TPUMX_ATTENTION`` (``auto``, the default, ``dense`` or ``flash``) and
``TPUMX_DENSE_MAX_KV`` are read and checked on every call, as the
reference reads them.  The reference's default of 512 was measured on a
TPU; the port's, :data:`DENSE_MAX_KV_DEFAULT`, is the largest key length
at which the dense arm beat the kernels' forward plus backward on the
H100 in both bfloat16 and float32 (``chip_smoke.py``'s ``crossover``
phase: causal and padded, H=12 D=64 and H=32 D=128, T from 128 to 2048
at 16384 tokens, recorded in PERF.md), 0 where it never did: flash
everywhere.

Each distinct call signature is counted once in ``dispatch_counts``
under its arm.  Both arms take the additive ``(B|1, H|1, T|1, Tk)``
bias (ALiBi, relative positions), with its gradient.  Sequence
parallelism over a mesh's ``sp`` axis (ring, Ulysses) is not ported yet.
"""
from __future__ import annotations

import logging
import math
import os

import torch

from ..base import MXNetError
from ..kernels import flash_attention as _fa

__all__ = ["attention", "local_flash_attention", "attention_arm",
           "attention_mode", "dispatch_counts", "DENSE_MAX_KV_DEFAULT"]

_logger = logging.getLogger(__name__)

# Which attention path each distinct call signature took, deduplicated by
# (path, detail) as in the reference: a new shape or dtype counts once.
dispatch_counts = {"flash_kernel": 0, "dense": 0}
_seen_signatures = set()

#: the key length up to which ``TPUMX_ATTENTION=auto`` takes the dense arm
#: on the card when ``TPUMX_DENSE_MAX_KV`` is unset (module docstring)
DENSE_MAX_KV_DEFAULT = 0
_MODES = ("auto", "dense", "flash")


def attention_mode():
    """``TPUMX_ATTENTION``, checked: ``auto`` (unset), ``dense`` or
    ``flash``."""
    mode = os.environ.get("TPUMX_ATTENTION", "auto")
    if mode not in _MODES:
        raise ValueError(f"TPUMX_ATTENTION must be auto|dense|flash, "
                         f"got {mode!r}")
    return mode


def _dense_max_kv():
    """The largest key length at which ``auto`` prefers the dense arm:
    ``TPUMX_DENSE_MAX_KV``, else :data:`DENSE_MAX_KV_DEFAULT`.  Read on
    every call, so a probe can sweep the crossover at run time."""
    raw = os.environ.get("TPUMX_DENSE_MAX_KV")
    if raw is None:
        return DENSE_MAX_KV_DEFAULT
    try:
        return int(raw)
    except ValueError:
        raise ValueError(f"TPUMX_DENSE_MAX_KV must be an integer, got "
                         f"{raw!r}") from None


def _choose(device_type, head_dim, dtype, mode, kv_len):
    """``(arm, deliberate)``: the arm, and whether a dense arm was the
    mode's choice (no warning) rather than the shape's."""
    mode = attention_mode() if mode is None else mode
    if mode not in _MODES:
        raise ValueError(f"TPUMX_ATTENTION must be auto|dense|flash, "
                         f"got {mode!r}")
    if device_type != "cuda":
        return "dense", True
    if mode == "dense" or (mode == "auto" and kv_len is not None
                           and kv_len <= _dense_max_kv()):
        return "dense", True
    if _fa.kernel_takes(head_dim, dtype):
        return "flash_kernel", False
    return _fa.card_dense_arm("attention", head_dim, dtype), False


def attention_arm(device_type, head_dim, dtype, mode=None, kv_len=None):
    """The arm :func:`local_flash_attention` takes for q/k/v of this head
    dim and dtype on a ``device_type`` (``"cuda"`` or ``"cpu"``) device:
    ``"flash_kernel"`` or ``"dense"`` (see the module docstring).
    ``mode`` is a ``TPUMX_ATTENTION`` value (None: read it); ``kv_len``
    the key length ``auto`` compares with ``TPUMX_DENSE_MAX_KV`` (None:
    no comparison)."""
    return _choose(device_type, head_dim, dtype, mode, kv_len)[0]


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


def _dropout_seed(dropout_key, dropout_seed):
    """The reference's ``dropout_key`` (a JAX PRNG key there) is the
    port's seed: an int or a ``(1,)`` int32 tensor, as ``dropout_seed``
    is; giving both raises."""
    if dropout_key is None:
        return dropout_seed
    if dropout_seed is not None:
        raise ValueError("attention: pass dropout_key or dropout_seed, "
                         "not both")
    return dropout_key


def local_flash_attention(q, k, v, causal=False, valid_length=None,
                          dropout_rate=0.0, dropout_key=None, bias=None,
                          dropout_seed=None):
    """Single-device attention over ``(B, H, T, D)``: the flash kernels
    for CUDA tensors of a shape they take, the dense plain version
    otherwise, or where ``TPUMX_ATTENTION`` asks for the dense arm
    (:func:`attention_arm`).  ``dropout_seed`` (or the
    reference's name, ``dropout_key``) is a ``(1,)`` int32 tensor
    (``random.take_seed``); pass ``dropout_rate > 0`` only in training.
    ``bias`` is an additive ``(B|1, H|1, T|1, Tk)`` attention bias."""
    dropout_seed = _dropout_seed(dropout_key, dropout_seed)
    rate = float(dropout_rate) if dropout_seed is not None else 0.0
    arm, deliberate = _choose(q.device.type, q.shape[-1], q.dtype, None,
                              k.shape[2])
    _count(arm, f"shape={tuple(q.shape)} dtype={q.dtype} "
                f"device={q.device.type} kv_len={k.shape[2]}",
           warn=arm == "dense" and not deliberate)
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
              dropout_rate=0.0, dropout_key=None, bias=None,
              sp_strategy=None, dropout_seed=None):
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
                                 dropout_seed=_dropout_seed(dropout_key,
                                                            dropout_seed),
                                 bias=bias)
