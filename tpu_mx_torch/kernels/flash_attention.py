"""Flash attention: the hand-written CUDA kernels and their plain twins.

The port of ``tpu_mx/kernels/flash_attention.py``:
``softmax(q·kᵀ·scale [masks])·v`` over ``(BH, T, D)`` tensors, with the
per-row logsumexp the backward pass reads, and the two backward kernels
that recompute the probabilities from it.  Unlike the TPU kernel, any
``T`` is taken: ragged tails are masked in the kernels, not refused by a
``T % 128`` gate.

Masks and options, as in the reference:

- ``causal``: query row ``i`` sees key columns ``j <= i``;
- ``kv_valid``: ``(BH,)`` int32, the number of valid keys of each row;
  key columns ``>= kv_valid[bh]`` are masked, and key tiles wholly past
  it are never loaded (their dk/dv rows are written as zeros);
- ``dropout_rate``/``dropout_seed``: attention-probability dropout
  inside the kernels.  The softmax normalizer uses the un-dropped
  probabilities and kept ones are scaled by ``1/(1-rate)``.  The keep
  decision is a pure function of ``(seed, bh, query index, key index)``
  (:func:`dropout_keep_mask`), so the forward and both backward kernels
  regenerate the same mask whatever their tile sizes, and the plain
  versions compute the same bits in integer arithmetic.  The TPU's PRNG
  bits cannot be reproduced; the mask is not the reference's.
- ``bias``: an additive bias ``(planes, T, Tk)``, added to the scaled
  scores before the masks.  ``planes`` is BH (one plane per row), 1
  (shared by every row) or G with ``bias_groups=G`` dividing BH (row
  ``bh`` reads plane ``bh % G``: one plane per head, shared over the
  batch).  Its gradient is the dq kernel's ``d_bias = p∘(dp − δ)``, a
  ``(BH, T, Tk)`` float32 array summed to the bias's shape outside the
  kernel, as in the reference.  A row whose scores are all ``-inf`` (or
  all masked) gets ``out = 0`` and zero gradients.

Each kernel has a wrapper that launches it for CUDA tensors (or raises)
and runs the plain PyTorch version for CPU tensors, and counts its
launches in ``<wrapper>.launches`` (a plain int; set it to 0 to start a
count):

- :func:`flash_attention` — the forward (``csrc/flash_attention_fwd.cu``);
- :func:`flash_attention_bwd_dq` and :func:`flash_attention_bwd_dkv` —
  the backward (``csrc/flash_attention_bwd.cu``).

The kernel is chosen by dtype: bfloat16 runs on the tensor cores
(``wgmma``) in all three; float32 runs on the tensor cores in split
precision in all three too (``tf32x3``: each operand split into two
TF32 halves, three products, float32 sums — within float32 rounding of
the plain version, as the serving path and float32 training need).
Each wrapper also counts its launches by the route the C entry point
reports, in ``<wrapper>.routes`` (``{"wgmma": n, "tf32x3": n}``); there
is no fallback between them.

Gradients flow through :class:`FlashAttentionFunction`, whose backward
calls the two backward wrappers.  The plain versions
(:func:`flash_attention_plain`, :func:`flash_attention_bwd_plain`) work
on ``block_q`` query rows at a time, so their memory stays bounded at
BERT's shapes; the tiling changes no result bit of the mask.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ..base import MXNetError
from .. import device as _device
from . import _build

__all__ = ["flash_attention", "mha_flash_attention", "flash_attention_plain",
           "flash_attention_bwd_plain", "flash_attention_bwd_dq",
           "flash_attention_bwd_dkv", "flash_attention_delta",
           "reduce_d_bias", "kernel_takes", "card_dense_arm",
           "dropout_keep_mask", "FlashAttentionFunction", "HEAD_DIMS"]

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128)   # the kernels' template instances
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_BIAS_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
PLAIN_BLOCK_Q = 128             # query rows per step of the plain versions
# the kernels a C entry point reports, by index (0 is reserved: the C ABI
# keeps its numbering)
ROUTES = {1: "wgmma", 2: "tf32x3"}

_M32 = 0xFFFFFFFF
_ROW_SALT = 0x9E3779B9          # the constants of csrc/flash_common.cuh
_Q_MULT = 0x85EBCA77
_K_MULT = 0xC2B2AE3D

_libs = {}


def _lib(name):
    lib = _libs.get(name)
    if lib is None:
        lib = _build.load(name)
        p, i, u, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32,
                      ctypes.c_float)
        # (..., kv_valid, seed, bh, tq, tk, d, scale, causal, threshold,
        #  keep_scale, dtype, stream)
        tail = [p, p, i, i, i, i, f, i, u, f, i, p]
        bias = [p, i, i]    # bias, bias_planes, bias_dtype
        route = [ctypes.POINTER(i)]   # out: the kernel launched
        if name == "flash_attention_fwd":
            lib.tmx_flash_attention_fwd.argtypes = [p] * 5 + bias + tail \
                + route
            lib.tmx_flash_attention_fwd.restype = i
        else:
            d_bias = [p]
            lib.tmx_flash_attention_bwd_dq.argtypes = [p] * 7 + bias \
                + d_bias + tail + route
            lib.tmx_flash_attention_bwd_dq.restype = i
            lib.tmx_flash_attention_bwd_dkv.argtypes = [p] * 8 + bias + tail \
                + route
            lib.tmx_flash_attention_bwd_dkv.restype = i
        _libs[name] = lib
    return lib


# ----------------------------------------------------------------------------
# the dropout mask: a pure function of (seed, bh, query, key)
# ----------------------------------------------------------------------------
def _mul32(a, c):
    """``a * c mod 2**32`` for int64 tensors ``a`` in [0, 2**32) and a
    constant ``c`` < 2**32, without overflowing int64: ``a`` is split
    into 16-bit halves."""
    lo, hi = a & 0xFFFF, a >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & _M32


def _fmix32(h):
    """MurmurHash3's 32-bit finalizer (a bijection of 32-bit words)."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def _threshold(rate):
    """Keep iff the 32 bits are ``>=`` this: ``P(keep) = 1 - rate``."""
    return min(int(rate * 2 ** 32), _M32)


def dropout_keep_mask(seed, bh, q_idx, k_idx, rate):
    """The keep mask the kernels draw, as a bool tensor broadcast over
    ``bh``, ``q_idx`` and ``k_idx`` (int64 index tensors).  ``seed`` is
    a ``(1,)`` int32 tensor, read as an unsigned 32-bit word::

        row  = fmix32(seed ^ fmix32(bh + 0x9E3779B9))
        qkey = fmix32(row ^ (q * 0x85EBCA77))
        bits = fmix32(qkey ^ (k * 0xC2B2AE3D))       (all mod 2**32)
        keep = bits >= min(floor(rate * 2**32), 2**32 - 1)
    """
    s = seed.reshape(()).to(torch.int64) & _M32
    row = _fmix32(s ^ _fmix32((bh + _ROW_SALT) & _M32))
    qkey = _fmix32(row ^ _mul32(q_idx, _Q_MULT))
    bits = _fmix32(qkey ^ _mul32(k_idx, _K_MULT))
    return bits >= _threshold(rate)


# ----------------------------------------------------------------------------
# plain versions (PyTorch, float32 math, block_q query rows at a time)
# ----------------------------------------------------------------------------
def _bias_rows(bias, bh, q0, bq):
    """Float32 bias of query rows [q0, q0+bq) for every row: ``(BH|1, bq,
    Tk)``, plane ``bh % planes`` for row ``bh``."""
    b = bias[:, q0:q0 + bq].float()
    if b.shape[0] not in (1, bh):
        b = b.repeat(bh // b.shape[0], 1, 1)
    return b


def _block_masks(bh, q0, bq, tk, causal, kv_valid, rate, seed, dev):
    """(score mask, keep mask or None) of query rows [q0, q0+bq)."""
    qi = torch.arange(q0, q0 + bq, device=dev).reshape(1, bq, 1)
    ki = torch.arange(tk, device=dev).reshape(1, 1, tk)
    ok = torch.ones((1, bq, tk), dtype=torch.bool, device=dev)
    if causal:
        ok = ok & (ki <= qi)
    if kv_valid is not None:
        ok = ok & (ki < kv_valid.to(dev, torch.int64).reshape(bh, 1, 1))
    keep = None
    if rate > 0.0:
        keep = dropout_keep_mask(seed.to(dev),
                                 torch.arange(bh, device=dev).reshape(bh, 1, 1),
                                 qi, ki, rate)
    return ok, keep


def flash_attention_plain(q, k, v, scale, causal=False, kv_valid=None,
                          dropout_rate=0.0, dropout_seed=None, bias=None,
                          block_q=PLAIN_BLOCK_Q):
    """``(out, lse)`` for ``(BH, T, D)`` inputs in float32 math; ``out``
    is in ``q.dtype``, ``lse`` is float32 ``(BH, T)``.  ``bias`` is
    ``(BH|1|G, T, Tk)`` (see the module docstring).  Masked scores get
    probability exactly 0, as in the kernel; a row with no valid key, or
    no finite score, gets ``out = 0``."""
    bh, t, _ = q.shape
    tk = k.shape[1]
    kf, vf = k.float(), v.float()
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((bh, t), dtype=torch.float32, device=q.device)
    for q0 in range(0, t, block_q):
        bq = min(block_q, t - q0)
        ok, keep = _block_masks(bh, q0, bq, tk, causal, kv_valid,
                                dropout_rate, dropout_seed, q.device)
        s = torch.matmul(q[:, q0:q0 + bq].float(), kf.transpose(1, 2)) * scale
        if bias is not None:
            s = s + _bias_rows(bias, bh, q0, bq)
        s = torch.where(ok, s, NEG_INF)
        m = s.amax(dim=-1, keepdim=True).clamp_min(NEG_INF)
        p = torch.where(ok, torch.exp(s - m), 0.0)
        l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
        if keep is not None:
            p = torch.where(keep, p * (1.0 / (1.0 - dropout_rate)), 0.0)
        out[:, q0:q0 + bq] = (torch.matmul(p, vf) / l).to(q.dtype)
        lse[:, q0:q0 + bq] = (m + torch.log(l))[..., 0]
    return out, lse


def flash_attention_delta(do, out):
    """``delta = rowsum(dO · O)`` in float32, ``(BH, T)`` — a PyTorch op
    outside the kernels, as it is a ``jnp`` op outside them in the
    reference (``_bwd``)."""
    return (do.float() * out.float()).sum(dim=-1)


def f32_bwd_error_bounds(q, k, v, do, scale=1.0):
    """Elementwise bounds on the float32 backward's error against float64
    at ``(BH, T, D)`` inputs without masks, fed the float64 lse and delta
    rounded to float32, and the float64 ``(dq, dk, dv)``, lse and delta.
    With ``c(n) = 3 * 2^-22 + 3n/8 * 2^-23`` (a split product's error and
    n/8 float32 accumulations, each off by a whole unit in the last
    place): a score is off by ``c(D) sum|q||k|`` and dP by ``c(D)
    sum|dO||v|``; ``p = exp(s - lse)`` by ``p (e_s + 2^-23 (|lse| + |s -
    lse|) + 2^-21) + 2^-126`` (lse's rounding, the subtraction, expf, a p
    below float32's normal range flushed); ``dS = p (dP - delta)`` by
    ``|dp_err| |dP - delta| + p (dP_err + 2^-23 |delta| + 2^-22 |dP -
    delta|)``; ``dq = dS K scale`` by ``sum|dS_err||K| + c(Tk) sum|dS||K|``
    (dk likewise over the queries with Q), ``dv = P^T dO`` by
    ``sum|p_err||dO| + c(T) sum p|dO|``; every term doubled for the
    second-order terms left out."""
    q, k, v, do = (x.double() for x in (q, k, v, do))
    d, t, tk = q.shape[-1], q.shape[1], k.shape[1]
    c = lambda n: 3 * 2 ** -22 + 3 * n / 8 * 2 ** -23
    s = q @ k.transpose(1, 2) * scale
    lse = torch.logsumexp(s, -1, keepdim=True)
    p = torch.exp(s - lse)
    dp = do @ v.transpose(1, 2)
    delta = (do * (p @ v)).sum(-1, keepdim=True)
    ds = p * (dp - delta)
    exact = (ds @ k * scale, ds.transpose(1, 2) @ q * scale,
             p.transpose(1, 2) @ do)
    e_s = c(d) * (q.abs() @ k.abs().transpose(1, 2)) * scale
    e_dp = c(d) * (do.abs() @ v.abs().transpose(1, 2))
    e_p = p * (e_s + 2 ** -23 * (lse.abs() + (s - lse).abs()) + 2 ** -21) \
        + 2 ** -126
    e_ds = e_p * (dp - delta).abs() + p * (
        e_dp + 2 ** -23 * delta.abs() + 2 ** -22 * (dp - delta).abs())
    bounds = (
        (e_ds @ k.abs() + c(tk) * (ds.abs() @ k.abs())) * scale,
        (e_ds.transpose(1, 2) @ q.abs()
         + c(t) * (ds.abs().transpose(1, 2) @ q.abs())) * scale,
        e_p.transpose(1, 2) @ do.abs() + c(t) * (p.transpose(1, 2)
                                                 @ do.abs()))
    return exact, [2 * b for b in bounds], lse[..., 0], delta[..., 0]


def flash_attention_bwd_plain(q, k, v, do, lse, delta, scale, causal=False,
                              kv_valid=None, dropout_rate=0.0,
                              dropout_seed=None, bias=None,
                              block_q=PLAIN_BLOCK_Q):
    """``(dq, dk, dv)``, and with a ``bias`` ``(dq, dk, dv, d_bias)``, by
    the flash backward's formulas, with ``P`` recomputed from the saved
    ``lse`` (not autograd of the forward)::

        s  = q · kᵀ · scale + bias
        p  = exp(s - lse)                 (0 where masked)
        dp = dO · Vᵀ,  then z/(1-r) · dp  with the keep mask z
        d_bias = p ∘ (dp - delta)         (BH, T, Tk) float32
        ds = d_bias · scale
        dq = ds · K,   dk = dsᵀ · Q,   dv = (z/(1-r) · p)ᵀ · dO
    """
    bh, t, _ = q.shape
    tk = k.shape[1]
    kf, vf = k.float(), v.float()
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=q.device)
    d_bias = None if bias is None else torch.empty(
        (bh, t, tk), dtype=torch.float32, device=q.device)
    for q0 in range(0, t, block_q):
        bq = min(block_q, t - q0)
        ok, keep = _block_masks(bh, q0, bq, tk, causal, kv_valid,
                                dropout_rate, dropout_seed, q.device)
        qf = q[:, q0:q0 + bq].float()
        dof = do[:, q0:q0 + bq].float()
        s = torch.matmul(qf, kf.transpose(1, 2)) * scale
        if bias is not None:
            s = s + _bias_rows(bias, bh, q0, bq)
        p = torch.where(ok, torch.exp(s - lse[:, q0:q0 + bq, None]), 0.0)
        dp = torch.matmul(dof, vf.transpose(1, 2))
        p_drop = p
        if keep is not None:
            inv = 1.0 / (1.0 - dropout_rate)
            dp = torch.where(keep, dp * inv, 0.0)
            p_drop = torch.where(keep, p * inv, 0.0)
        ds = p * (dp - delta[:, q0:q0 + bq, None])
        if d_bias is not None:
            d_bias[:, q0:q0 + bq] = ds
        ds = ds * scale
        dq[:, q0:q0 + bq] = torch.matmul(ds, kf).to(q.dtype)
        dk += torch.matmul(ds.transpose(1, 2), qf)
        dv += torch.matmul(p_drop.transpose(1, 2), dof)
    grads = (dq, dk.to(k.dtype), dv.to(v.dtype))
    return grads if bias is None else grads + (d_bias,)


def reduce_d_bias(d_bias, bias):
    """The ``(BH, T, Tk)`` float32 ``d_bias`` summed to ``bias``'s shape
    (``(BH|1|G, T, Tk)``) and cast to its dtype — a PyTorch op outside
    the kernels, as ``jnp.sum`` is outside them in the reference."""
    bh, planes = d_bias.shape[0], bias.shape[0]
    if planes == 1:
        d_bias = d_bias.sum(dim=0, keepdim=True)
    elif planes != bh:
        d_bias = d_bias.reshape(bh // planes, planes,
                                *d_bias.shape[1:]).sum(dim=0)
    return d_bias.to(bias.dtype)


# ----------------------------------------------------------------------------
# kernel launches
# ----------------------------------------------------------------------------
def kernel_takes(head_dim, dtype):
    """Whether the kernels have an instance for q/k/v of this head dim and
    dtype (the wrappers raise on the card for anything else; callers with
    a dense arm dispatch on this, a pure function of shape and dtype)."""
    return head_dim in HEAD_DIMS and dtype in _DTYPES


def card_dense_arm(what, head_dim, dtype, detail="", suffix=False):
    """``"dense"`` for a caller whose kernel has no instance for this head
    dim and (query) dtype on the card, where the reference's own gate
    (``supported()`` of its flash and paged kernels: a head dim that is a
    multiple of 64, float32 or bfloat16) sends the shape dense too, and
    for a ``suffix`` prefill (fewer queries than keys), which the
    reference's gate sends dense whatever the head dim.  A shape the
    reference's kernel takes raises instead (head dims 192, 256, ...):
    the port does not put a plain version on the card in a kernel's
    place."""
    if not suffix and head_dim % 64 == 0 and dtype in _DTYPES:
        raise MXNetError(
            f"{what}: no kernel instance for head dim {head_dim}, {dtype}"
            f"{detail}, a shape the reference's kernel takes; the port's "
            f"instances are head dims {HEAD_DIMS} (ROADMAP B item 8)")
    return "dense"


def _check_kernel_operands(what, q, *rest):
    if q.dtype not in _DTYPES:
        raise MXNetError(f"{what} kernel: q/k/v must be float32 or "
                         f"bfloat16, got {q.dtype}")
    for x in rest:
        if x.dtype != q.dtype:
            raise MXNetError(f"{what} kernel: operands must share q's dtype "
                             f"{q.dtype}, got {x.dtype}")
    if q.shape[-1] not in HEAD_DIMS:
        raise MXNetError(f"{what} kernel: head_dim {q.shape[-1]} not in "
                         f"{HEAD_DIMS}")


def _tail(q, k, kv_valid, rate, seed, scale, causal):
    """The C entry points' shared trailing arguments."""
    bh, t, d = q.shape
    drop = rate > 0.0
    return (kv_valid.data_ptr() if kv_valid is not None else None,
            seed.data_ptr() if drop else None, bh, t, k.shape[1], d,
            float(scale), int(bool(causal)), _threshold(rate) if drop else 0,
            1.0 / (1.0 - rate), _DTYPES[q.dtype],
            _build.stream(q))


def _bias_abi(bias):
    """The C entry points' (bias, bias_planes, bias_dtype) arguments."""
    if bias is None:
        return None, 0, 0
    return bias.data_ptr(), bias.shape[0], _BIAS_DTYPES[bias.dtype]


def _check_aligned(what, *tensors):
    """The kernels copy 16-byte chunks: their operands and outputs must
    start 16-byte aligned (a fresh or contiguous-copied tensor does)."""
    if any(x.data_ptr() % 16 for x in tensors):
        raise MXNetError(f"{what} kernel: {tensors[0].dtype} operands "
                         "must start 16-byte aligned")


def _count(wrapper, route):
    """One launch of ``wrapper``'s kernel, on the route the C entry point
    reported (a key of :data:`ROUTES`)."""
    wrapper.launches += 1
    wrapper.routes[ROUTES[route.value]] += 1


def _launch_fwd(q, k, v, scale, causal, kv_valid, rate, seed, bias=None):
    _check_kernel_operands("flash_attention", q, k, v)
    out = torch.empty_like(q)
    _check_aligned("flash_attention", q, k, v, out)
    lse = torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)
    lib = _lib("flash_attention_fwd")
    route = ctypes.c_int(-1)
    code = lib.tmx_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), *_bias_abi(bias),
        *_tail(q, k, kv_valid, rate, seed, scale, causal),
        ctypes.byref(route))
    _build.check(lib, code, "flash_attention")
    _count(flash_attention, route)
    return out, lse


def flash_attention_bwd_dq(q, k, v, do, lse, delta, scale, causal=False,
                           kv_valid=None, dropout_rate=0.0, dropout_seed=None,
                           bias=None, want_d_bias=False):
    """dq of the flash backward (``_bwd_dq_kernel``): the CUDA kernel for
    CUDA tensors, the plain backward for CPU tensors.  Operands as
    :func:`flash_attention_bwd_plain` takes them, already normalized by
    :func:`flash_attention` (contiguous, ``kv_valid`` int32, seed a
    ``(1,)`` int32 tensor, bias contiguous).  With ``want_d_bias`` (and
    a bias) returns ``(dq, d_bias)``, ``d_bias`` the ``(BH, T, Tk)``
    float32 gradient before :func:`reduce_d_bias`."""
    want_d_bias = want_d_bias and bias is not None
    if q.device.type != "cuda":
        grads = flash_attention_bwd_plain(q, k, v, do, lse, delta, scale,
                                          causal, kv_valid, dropout_rate,
                                          dropout_seed, bias)
        return (grads[0], grads[3]) if want_d_bias else grads[0]
    _check_kernel_operands("flash_attention_bwd_dq", q, k, v, do)
    d_bias = torch.empty((q.shape[0], q.shape[1], k.shape[1]),
                         dtype=torch.float32, device=q.device) \
        if want_d_bias else None
    dq = torch.empty_like(q)
    _check_aligned("flash_attention_bwd_dq", q, k, v, do, dq)
    lib = _lib("flash_attention_bwd")
    route = ctypes.c_int(-1)
    code = lib.tmx_flash_attention_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), *_bias_abi(bias),
        d_bias.data_ptr() if want_d_bias else None,
        *_tail(q, k, kv_valid, dropout_rate, dropout_seed, scale, causal),
        ctypes.byref(route))
    _build.check(lib, code, "flash_attention_bwd_dq")
    _count(flash_attention_bwd_dq, route)
    return (dq, d_bias) if want_d_bias else dq


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, scale, causal=False,
                            kv_valid=None, dropout_rate=0.0,
                            dropout_seed=None, bias=None):
    """``(dk, dv)`` of the flash backward (``_bwd_dkv_kernel``); see
    :func:`flash_attention_bwd_dq`."""
    if q.device.type != "cuda":
        return flash_attention_bwd_plain(q, k, v, do, lse, delta, scale,
                                         causal, kv_valid, dropout_rate,
                                         dropout_seed, bias)[1:3]
    _check_kernel_operands("flash_attention_bwd_dkv", q, k, v, do)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _check_aligned("flash_attention_bwd_dkv", q, k, v, do, dk, dv)
    lib = _lib("flash_attention_bwd")
    route = ctypes.c_int(-1)
    code = lib.tmx_flash_attention_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        *_bias_abi(bias),
        *_tail(q, k, kv_valid, dropout_rate, dropout_seed, scale, causal),
        ctypes.byref(route))
    _build.check(lib, code, "flash_attention_bwd_dkv")
    _count(flash_attention_bwd_dkv, route)
    return dk, dv


def _forward(q, k, v, scale, causal, kv_valid, rate, seed, bias=None):
    if q.device.type == "cuda":
        return _launch_fwd(q, k, v, scale, causal, kv_valid, rate, seed,
                           bias)
    return flash_attention_plain(q, k, v, scale, causal, kv_valid, rate,
                                 seed, bias)


class FlashAttentionFunction(torch.autograd.Function):
    """The flash forward with the flash backward as its gradient (the
    reference's ``jax.custom_vjp`` ``_flash_core``).  Saves ``(q, k, v,
    bias, kv_valid, seed, out, lse)``; the backward computes delta with a
    PyTorch op and runs the dq and dk/dv wrappers, and reduces the dq
    kernel's ``d_bias`` to the bias's shape when the bias needs a
    gradient."""

    @staticmethod
    def forward(ctx, q, k, v, bias, kv_valid, seed, scale, causal, rate):
        out, lse = _forward(q, k, v, scale, causal, kv_valid, rate, seed,
                            bias)
        ctx.save_for_backward(q, k, v, bias, kv_valid, seed, out, lse)
        ctx.args = (scale, causal, rate)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, bias, kv_valid, seed, out, lse = ctx.saved_tensors
        scale, causal, rate = ctx.args
        do = do.to(q.dtype).contiguous()
        delta = flash_attention_delta(do, out)
        args = (q, k, v, do, lse, delta, scale, causal, kv_valid, rate, seed,
                bias)
        want_d_bias = ctx.needs_input_grad[3]
        dq = flash_attention_bwd_dq(*args, want_d_bias=want_d_bias)
        db = None
        if want_d_bias:
            dq, d_bias = dq
            db = reduce_d_bias(d_bias, bias)
        dk, dv = flash_attention_bwd_dkv(*args)
        return dq, dk, dv, db, None, None, None, None, None


def flash_attention(q, k, v, scale=None, causal=False, kv_valid=None,
                    dropout_rate=0.0, dropout_seed=None, bias=None,
                    bias_groups=None, block_q=None, block_k=None,
                    return_lse=False, device=None):
    """Attention over ``(BH, T, D)`` q and ``(BH, Tk, D)`` k/v; returns
    ``out`` ``(BH, T, D)`` in q's dtype, or ``(out, lse)`` with
    ``return_lse=True`` (no gradient then: the serving prefill's call).

    ``kv_valid``: optional ``(BH,)`` valid-key counts.  ``dropout_rate``
    in [0, 1) with ``dropout_seed`` (an int or a ``(1,)`` int32 tensor,
    e.g. from :func:`tpu_mx_torch.random.take_seed`).  ``bias``: an
    additive ``(BH, T, Tk)``, ``(1, T, Tk)`` or ``(G, T, Tk)`` bias, G
    passed as ``bias_groups`` and dividing BH (a bare divisor is
    ambiguous between per-head and per-batch); float32, bfloat16 or
    float16 (another float type is read as float32).  Differentiable in
    q, k, v and the bias through :class:`FlashAttentionFunction`.
    ``block_q``/``block_k`` (the TPU kernel's block sizes) are accepted
    and ignored: the CUDA kernels' tiles are fixed per instance.

    Runs where the operands live: ``device=None`` takes ``q``'s device
    when ``q`` is a tensor and ``"cuda"`` otherwise; host data (numpy)
    is copied to that device, a tensor on another device raises.  CUDA
    operands launch the kernels or raise; CPU operands run the plain
    versions."""
    dev = _device.of(q, device)
    q, k, v = (_device.as_tensor(x, dev).contiguous() for x in (q, k, v))
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape \
            or k.shape[0] != q.shape[0] or k.shape[2] != q.shape[2]:
        raise ValueError(f"flash_attention: q must be (BH, T, D) and k/v "
                         f"(BH, Tk, D); got {tuple(q.shape)} / "
                         f"{tuple(k.shape)} / {tuple(v.shape)}")
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)
    if not 0.0 <= dropout_rate < 1.0:
        raise ValueError(f"dropout_rate must be in [0, 1): {dropout_rate}")
    rate = float(dropout_rate)
    if rate > 0.0:
        if dropout_seed is None:
            raise ValueError("dropout_rate > 0 requires dropout_seed")
        dropout_seed = _device.as_tensor(dropout_seed, dev,
                                         torch.int32).reshape(1)
    else:
        dropout_seed = None
    if kv_valid is not None:
        kv_valid = _device.as_tensor(kv_valid, dev, torch.int32) \
            .reshape(q.shape[0]).contiguous()
    if bias is not None:
        bias = _check_bias(_device.as_tensor(bias, dev), q.shape[0],
                           q.shape[1], k.shape[1], bias_groups)
    if return_lse:
        return _forward(q, k, v, scale, causal, kv_valid, rate, dropout_seed,
                        bias)
    if torch.is_grad_enabled() and any(
            x is not None and x.requires_grad for x in (q, k, v, bias)):
        return FlashAttentionFunction.apply(q, k, v, bias, kv_valid,
                                            dropout_seed, scale, causal, rate)
    return _forward(q, k, v, scale, causal, kv_valid, rate, dropout_seed,
                    bias)[0]


def _check_bias(bias, bh, t, tk, bias_groups):
    """The reference's bias validation; returns the bias contiguous, in
    a type the kernels read (another float type becomes float32)."""
    lead = bias.shape[0] if bias.dim() == 3 else None
    ok_lead = lead in (bh, 1) or (bias_groups is not None and
                                  lead == bias_groups and
                                  bh % bias_groups == 0)
    if lead is None or tuple(bias.shape[1:]) != (t, tk) or not ok_lead:
        raise ValueError(
            f"bias shape {tuple(bias.shape)} must be (BH, {t}, {tk}), "
            f"(1, {t}, {tk}), or (G, {t}, {tk}) with G passed as "
            f"bias_groups and dividing BH={bh} — a bare divisor is "
            "ambiguous between per-head and per-batch")
    if bias.dtype not in _BIAS_DTYPES:
        bias = bias.float()
    return bias.contiguous()


def mha_flash_attention(q, k, v, causal=False, valid_length=None,
                        dropout_rate=0.0, dropout_seed=None, bias=None,
                        block_q=None, block_k=None):
    """Multi-head wrapper: q/k/v are ``(B, H, T, D)``; batch and heads are
    folded for the kernels and the layout restored.  ``valid_length`` is
    per batch row ``(B,)`` and is repeated over the heads.  ``bias``
    broadcasts to ``(B, H, T, Tk)`` and is folded as the reference folds
    it: ``(B, H, T, Tk)`` one plane per row, ``(1, H, T, Tk)`` one per
    head (``bias_groups=H``), ``(1, 1, T, Tk)`` one shared plane; any
    other layout (e.g. ALiBi's ``(1, H, 1, Tk)``) is expanded to a plane
    per row, and autograd sums its gradient back.  ``block_q``/
    ``block_k`` are ignored, as in :func:`flash_attention`."""
    b, h, t, d = q.shape
    fold = lambda x: x.reshape(b * h, x.shape[2], d)
    kv_valid = None
    if valid_length is not None:
        kv_valid = torch.as_tensor(valid_length, device=q.device) \
            .to(torch.int32).repeat_interleave(h)
    kbias, groups = None, None
    if bias is not None:
        tk = k.shape[2]
        full = (b, h, t, tk)
        if bias.dim() != 4 or any(n not in (1, f)
                                  for n, f in zip(bias.shape, full)):
            raise ValueError(f"bias shape {tuple(bias.shape)} does not "
                             f"broadcast to (B, H, T, Tk) = {full}")
        lead, full_t = tuple(bias.shape[:2]), tuple(bias.shape[2:]) == (t, tk)
        if full_t and lead == (b, h):
            kbias = bias.reshape(b * h, t, tk)
        elif full_t and lead == (1, h):
            kbias, groups = bias.reshape(h, t, tk), h
        elif full_t and lead == (1, 1):
            kbias = bias.reshape(1, t, tk)
        else:
            kbias = bias.expand(full).reshape(b * h, t, tk)
    out = flash_attention(fold(q), fold(k), fold(v), None, causal, kv_valid,
                          dropout_rate, dropout_seed, kbias, groups)
    return out.reshape(b, h, t, d)


flash_attention.launches = 0
flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dkv.launches = 0


def route_counts():
    """A wrapper's ``routes`` with no launch counted."""
    return dict.fromkeys(ROUTES.values(), 0)


flash_attention.routes = route_counts()
flash_attention_bwd_dq.routes = route_counts()
flash_attention_bwd_dkv.routes = route_counts()
