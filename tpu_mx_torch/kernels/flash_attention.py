"""Flash-attention forward: the hand-written CUDA kernel and its plain twin.

The port of the forward half of ``tpu_mx/kernels/flash_attention.py``:
``softmax(q·kᵀ·scale [causal])·v`` over ``(BH, T, D)`` tensors, with the
per-row logsumexp the backward pass needs.  The causal mask is the
reference's (query row ``i`` sees key columns ``j <= i``).  Unlike the
TPU kernel, any ``T`` is taken: the ragged tail is masked in the kernel,
not refused by a ``T % 128`` gate.

- the kernel (``csrc/flash_attention_fwd.cu``), launched for CUDA
  tensors: 64-row query tiles, a loop over 64-row K/V tiles that stops
  at the causal diagonal, float32 throughout.  It takes float32 inputs
  and head dims 16/32/64/128; anything else on the card raises;
- :func:`flash_attention_plain`, the same function in PyTorch (the full
  score matrix, softmax in float32), run for CPU tensors — and on the
  card only to check the kernel.

Not yet ported (ROADMAP): the backward kernels (dq, dk/dv), the
``kv_valid`` key-padding mask, the additive bias and in-kernel dropout.
:func:`flash_attention` counts its kernel launches in
``flash_attention.launches`` (a plain int; set it to 0 to start a count).
"""
from __future__ import annotations

import ctypes
import math

import torch

from ..base import MXNetError
from .. import device as _device
from . import _build

__all__ = ["flash_attention", "flash_attention_plain", "HEAD_DIMS"]

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128)   # the kernel's template instances

_lib = None


def _kernel_lib():
    global _lib
    if _lib is None:
        lib = _build.load("flash_attention_fwd")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.tmx_flash_attention_fwd.argtypes = [
            p, p, p, p, p, i, i, i, i, ctypes.c_float, i, p]
        lib.tmx_flash_attention_fwd.restype = i
        _lib = lib
    return _lib


def flash_attention_plain(q, k, v, scale, causal=False):
    """``(out, lse)`` for ``(BH, T, D)`` inputs, computed densely in
    float32; ``out`` is in ``q.dtype``, ``lse`` is float32 ``(BH, T)``."""
    s = torch.matmul(q.float(), k.float().transpose(1, 2)) * scale
    if causal:
        t, tk = s.shape[1], s.shape[2]
        keep = (torch.arange(tk, device=s.device)[None, :]
                <= torch.arange(t, device=s.device)[:, None])
        s = torch.where(keep, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.matmul(p, v.float()) / l
    return out.to(q.dtype), (m + torch.log(l))[..., 0]


def _launch(q, k, v, scale, causal):
    bh, t, d = q.shape
    tk = k.shape[1]
    if not (q.dtype == k.dtype == v.dtype == torch.float32):
        raise MXNetError(f"flash_attention kernel: q/k/v must be float32, "
                         f"got {q.dtype}/{k.dtype}/{v.dtype}")
    if d not in HEAD_DIMS:
        raise MXNetError(f"flash_attention kernel: head_dim {d} not in "
                         f"{HEAD_DIMS}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    lse = torch.empty((bh, t), dtype=torch.float32, device=q.device)
    lib = _kernel_lib()
    code = lib.tmx_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), bh, t, tk, d, float(scale), int(bool(causal)),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, code, "flash_attention")
    flash_attention.launches += 1
    return out, lse


def flash_attention(q, k, v, scale=None, causal=False, return_lse=False,
                    device=None):
    """Attention over ``(BH, T, D)`` q and ``(BH, Tk, D)`` k/v; returns
    ``out`` ``(BH, T, D)``, or ``(out, lse)`` with ``return_lse=True``.

    Runs where the operands live: ``device=None`` takes ``q``'s device
    when ``q`` is a tensor and ``"cuda"`` otherwise; host data (numpy)
    is copied to that device, a tensor on another device raises.  CUDA
    operands launch the kernel or raise; CPU operands run
    :func:`flash_attention_plain`."""
    if device is None:
        device = q.device if isinstance(q, torch.Tensor) \
            else _device.DEFAULT_DEVICE
    dev = _device.resolve(device)
    q = _device.as_tensor(q, dev)
    k = _device.as_tensor(k, dev)
    v = _device.as_tensor(v, dev)
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape \
            or k.shape[0] != q.shape[0] or k.shape[2] != q.shape[2]:
        raise ValueError(f"flash_attention: q must be (BH, T, D) and k/v "
                         f"(BH, Tk, D); got {tuple(q.shape)} / "
                         f"{tuple(k.shape)} / {tuple(v.shape)}")
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)
    if dev.type == "cuda":
        out, lse = _launch(q, k, v, scale, causal)
    else:
        out, lse = flash_attention_plain(q, k, v, scale, causal)
    return (out, lse) if return_lse else out


flash_attention.launches = 0
