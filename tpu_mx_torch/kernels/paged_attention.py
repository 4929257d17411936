"""Paged-attention decode: the hand-written CUDA kernel and its plain twin.

The port of ``tpu_mx/kernels/paged_attention.py``: decode attention of
each sequence's new-token query window against a paged KV pool, walking
the sequence's block table with an online softmax in float32.  The
shape contract is the reference's:

- ``q``: ``(B, H, D)`` or ``(B, Tq, H, D)``; query ``t`` of row ``b``
  sits at position ``lengths[b] - Tq + t`` and sees key positions
  ``< lengths[b] - (Tq - 1 - t)`` (``Tq > 1`` is a speculative window);
- ``k_pool``/``v_pool``: ``(num_blocks, block_size, H, D)``, one layer's
  pool, float32, bfloat16 or float16;
- ``block_tables``: int ``(B, NB)``; entries past a row's real blocks
  must still be valid pool indices (the cache pads with block 0);
- ``lengths``: int ``(B,)`` true context lengths, ``>= Tq``.

Two versions share that contract:

- the kernel (``csrc/paged_attention.cu``), launched for CUDA tensors:
  split over the keys (flash-decoding), grid ``(B, H, S)`` with ``S``
  splits of 64 keys from the table's width, then a merge launch of grid
  ``(B, H)`` over the float32 partials, which the wrapper allocates.
  Nothing is read back to the host, so a call can be captured in a CUDA
  graph and replayed after the tables and lengths change in place.  It
  takes float32 or bfloat16 queries (the output in their dtype, float32
  math), float32, bfloat16 or float16 pools, head dims
  16/32/64/128/192/256 and any window, walked in chunks of
  :data:`WINDOW_CHUNK` rows (a split and a merge launch a chunk); head
  dims of 320 and more (any multiple of 64) run the runtime-D instance
  (``csrc/paged_attention_dn.cu``: D an argument, the split's queries
  and scores in shared memory, the same partials and merge);
- :func:`paged_attention_plain`, the same block walk written in PyTorch,
  run for CPU tensors — and on the card only to check the kernel.  The
  reference's names for it are here too: :func:`window_walk` (the walk
  over the canonical ``(B, Tq, H, D)`` window) and
  :func:`paged_attention_reference` (the walk with the wrapper's
  operand handling, on whatever device the operands are: the parity
  oracle).

:func:`paged_attention` counts its kernel launches in
``paged_attention.launches`` (a plain int; set it to 0 to start a count),
by the route the C entry point reports in ``paged_attention.routes``
(``{"split_k": n}``) and by window in ``paged_attention.windows``
(``{Tq: n}``).
"""
from __future__ import annotations

import ctypes
import math

import torch

from ..base import MXNetError
from .. import device as _device
from . import _build

__all__ = ["paged_attention", "paged_attention_plain", "kernel_takes",
           "WINDOW_CHUNK", "HEAD_DIMS", "RUNTIME_D_STEP", "window_walk",
           "paged_attention_reference", "DEFAULT_BLOCK_SIZE"]

NEG_INF = -1e30
# tokens a pool block holds: the reference's serving block size (its
# sweep ran on a TPU), the port's PagedKVCache default; not re-measured
# on the card
DEFAULT_BLOCK_SIZE = 16
WINDOW_CHUNK = 8                # kTqMax: the window rows a launch takes
HEAD_DIMS = (16, 32, 64, 128, 192, 256)   # the kernel's template instances
# above them, every multiple of RUNTIME_D_STEP runs the runtime-D instance
RUNTIME_D_STEP = 64
_Q_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_POOL_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
SPLIT_KEYS = 64                 # kSplitKeys: the keys of a split
ROUTES = ("split_k",)           # the kernels the C entry point reports

_libs = {}


def runtime_d(head_dim):
    """Whether this head dim runs the runtime-D instance: above
    :data:`HEAD_DIMS`, a multiple of :data:`RUNTIME_D_STEP`."""
    return head_dim > HEAD_DIMS[-1] and head_dim % RUNTIME_D_STEP == 0


def _kernel_lib(head_dim):
    unit = "paged_attention_dn" if runtime_d(head_dim) else "paged_attention"
    lib = _libs.get(unit)
    if lib is None:
        lib = _build.load(unit)
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.tmx_paged_attention.argtypes = [
            p, p, p, p, p, p, i, i, i, i, i, i, ctypes.c_float, i, i, p, p,
            i, p, ctypes.POINTER(i)]
        lib.tmx_paged_attention.restype = i
        _libs[unit] = lib
    return lib


def kernel_takes(head_dim, q_dtype, pool_dtype, window=1):
    """Whether the kernel has an instance for this decode: head dim
    (:data:`HEAD_DIMS`, or a multiple of 64 above them), query and pool
    dtypes, window ``Tq`` (the wrapper raises on the card for anything
    else; the serving decode dispatches on this, a pure function of shape
    and dtype)."""
    return ((head_dim in HEAD_DIMS or runtime_d(head_dim))
            and q_dtype in _Q_DTYPES and pool_dtype in _POOL_DTYPES
            and window >= 1)


def _normalize_q(q):
    """(B, H, D) or (B, Tq, H, D) -> (B, Tq, H, D) + whether it was 4-d."""
    if q.dim() == 4:
        return q, True
    if q.dim() != 3:
        raise ValueError(f"paged_attention: q must be (B, H, D) or "
                         f"(B, Tq, H, D), got shape {tuple(q.shape)}")
    return q.unsqueeze(1), False


def _check_operands(q, k_pool, v_pool, block_tables, lengths):
    b, tq, h, d = q.shape
    if k_pool.dim() != 4 or k_pool.shape != v_pool.shape:
        raise ValueError(
            f"paged_attention: pools must be matching (num_blocks, "
            f"block_size, H, D); got {tuple(k_pool.shape)} / "
            f"{tuple(v_pool.shape)}")
    if tuple(k_pool.shape[2:]) != (h, d):
        raise ValueError(
            f"paged_attention: pool heads/dim {tuple(k_pool.shape[2:])} != "
            f"query ({h}, {d})")
    if block_tables.dim() != 2 or block_tables.shape[0] != b:
        raise ValueError(
            f"paged_attention: block_tables must be (B={b}, NB); got "
            f"{tuple(block_tables.shape)}")
    if tuple(lengths.shape) != (b,):
        raise ValueError(
            f"paged_attention: lengths must be (B={b},); got "
            f"{tuple(lengths.shape)}")


def paged_attention_plain(q, k_pool, v_pool, block_tables, lengths, scale):
    """The kernel's algorithm in PyTorch: every row walks all ``NB``
    table entries (entries past its length are masked out exactly, as
    the reference's ``window_walk`` does).  ``q`` is ``(B, Tq, H, D)``;
    returns the same shape in ``q.dtype``."""
    b, tq, h, d = q.shape
    bs = k_pool.shape[1]
    dev = q.device
    qf = q.float()
    lengths = lengths.long()
    # query t admits key positions < length - (Tq - 1 - t)
    limit = (lengths[:, None] - (tq - 1)
             + torch.arange(tq, device=dev))[:, :, None, None]
    m = torch.full((b, tq, h), NEG_INF, device=dev)
    l = torch.zeros((b, tq, h), device=dev)
    acc = torch.zeros((b, tq, h, d), device=dev)
    for i in range(block_tables.shape[1]):
        bid = block_tables[:, i].long()
        k = k_pool[bid].float()                           # (B, BS, H, D)
        v = v_pool[bid].float()
        s = torch.einsum("bthd,bshd->bths", qf, k) * scale
        kpos = i * bs + torch.arange(bs, device=dev)
        s = torch.where(kpos < limit, s, torch.full_like(s, NEG_INF))
        m_cur = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_cur)
        p = torch.exp(s - m_cur[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bths,bshd->bthd", p, v)
        m = m_cur
    return (acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)


def window_walk(q, k_pool, v_pool, block_tables, lengths, scale):
    """The reference's name for the block walk over a canonical ``(B,
    Tq, H, D)`` window: :func:`paged_attention_plain`."""
    return paged_attention_plain(q, k_pool, v_pool, block_tables, lengths,
                                 scale)


def paged_attention_reference(q, k_pool, v_pool, block_tables, lengths,
                              scale=None):
    """The kernel's algorithm in plain PyTorch with the wrapper's operand
    contract (``(B, H, D)`` or ``(B, Tq, H, D)`` queries, the default
    scale), on the operands' device: the paged kernel's parity oracle,
    never a kernel launch."""
    q, had_t = _normalize_q(q)
    _check_operands(q, k_pool, v_pool, block_tables, lengths)
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)
    out = paged_attention_plain(q, k_pool, v_pool, block_tables, lengths,
                                scale)
    return out if had_t else out[:, 0]


def _launch(q, k_pool, v_pool, block_tables, lengths, scale):
    b, tq, h, d = q.shape
    if q.dtype not in _Q_DTYPES:
        raise MXNetError(f"paged_attention kernel: q must be float32 or "
                         f"bfloat16, got {q.dtype}")
    if k_pool.dtype not in _POOL_DTYPES or v_pool.dtype != k_pool.dtype:
        raise MXNetError(f"paged_attention kernel: pools must both be "
                         f"float32, bfloat16 or float16, got {k_pool.dtype} "
                         f"/ {v_pool.dtype}")
    if not (d in HEAD_DIMS or runtime_d(d)):
        raise MXNetError(f"paged_attention kernel: head_dim {d} is neither "
                         f"in {HEAD_DIMS} nor a multiple of "
                         f"{RUNTIME_D_STEP} above them")
    q = q.contiguous()
    k_pool = k_pool.contiguous()
    v_pool = v_pool.contiguous()
    tables = block_tables.to(torch.int32).contiguous()
    lengths = lengths.to(torch.int32).contiguous()
    if k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16:
        raise MXNetError("paged_attention kernel: pools must start 16-byte "
                         "aligned")
    out = torch.empty_like(q)
    lib = _kernel_lib(d)
    bs, nb = k_pool.shape[1], tables.shape[1]
    # the splits from the table's width, never from the lengths (no read
    # back: the call stays capturable in a CUDA graph); their float32
    # partials in one buffer, reused by each chunk of the window: (m, l)
    # (2, B, S, c, H), then acc (B, S, c, H, D), c = min(Tq, WINDOW_CHUNK)
    splits = -(-nb * bs // SPLIT_KEYS)
    rows = b * splits * min(tq, WINDOW_CHUNK) * h
    part = torch.empty(rows * (2 + d), dtype=torch.float32, device=q.device)
    route = ctypes.c_int(-1)
    code = lib.tmx_paged_attention(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        b, tq, h, d, bs, nb, float(scale), _Q_DTYPES[q.dtype],
        _POOL_DTYPES[k_pool.dtype], part.data_ptr(),
        part.data_ptr() + 2 * rows * 4, splits, _build.stream(q),
        ctypes.byref(route))
    _build.check(lib, code, "paged_attention")
    paged_attention.launches += 1
    paged_attention.routes[ROUTES[route.value]] += 1
    paged_attention.windows[tq] = paged_attention.windows.get(tq, 0) + 1
    return out


def paged_attention(q, k_pool, v_pool, block_tables, lengths, scale=None,
                    device=None):
    """Decode attention over a paged KV pool (see module docstring).

    Runs where the operands live: ``device=None`` takes ``q``'s device
    when ``q`` is a tensor and ``"cuda"`` otherwise; host data (numpy)
    is copied to that device, a tensor on another device raises.  CUDA
    operands launch the kernel or raise; CPU operands run
    :func:`paged_attention_plain`.  Returns ``(B, H, D)`` (or
    ``(B, Tq, H, D)`` for a 4-d ``q``) in ``q.dtype``."""
    dev = _device.of(q, device)
    q = _device.as_tensor(q, dev)
    k_pool = _device.as_tensor(k_pool, dev)
    v_pool = _device.as_tensor(v_pool, dev)
    block_tables = _device.as_tensor(block_tables, dev)
    lengths = _device.as_tensor(lengths, dev)
    q, had_t = _normalize_q(q)
    _check_operands(q, k_pool, v_pool, block_tables, lengths)
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)
    if dev.type == "cuda":
        out = _launch(q, k_pool, v_pool, block_tables, lengths, scale)
    else:
        out = paged_attention_plain(q, k_pool, v_pool, block_tables,
                                    lengths, scale)
    return out if had_t else out[:, 0]


paged_attention.launches = 0
paged_attention.routes = dict.fromkeys(ROUTES, 0)
paged_attention.windows = {}
