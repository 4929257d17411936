"""Attention dispatch and ring attention, from
``tpu_mx/parallel/ring_attention.py``.

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
  320 and more) raises on the card unless the mode chose dense
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
bias (ALiBi, relative positions), with its gradient.

**Sequence parallelism.**  With a mesh whose ``sp`` axis is longer than
1, ``attention`` takes the reference's strategies (``ulysses`` where the
heads divide by ``sp`` and ``tp`` is 1, else ``ring``; counted under
``ring``/``ulysses``).  :func:`ring_attention` is the reference's: each
rank holds a ``T/sp`` block of q, k and v, the k/v blocks travel the
ring by :func:`~.collectives.ppermute` in ``sp`` steps, and each step
merges its block's online-softmax statistics (row max, denominator,
numerator) into float32 carries; causal masking, ``valid_length`` and
the bias's column slice follow the global position of the block held,
and ``step_chunk`` cuts each step's ``(T/sp, T/sp)`` scores into
``(T/sp, C)`` pieces.  Each block is computed by the plain
:func:`_block_attn`, as the reference computes it by its own plain
``_block_attn`` and not by its Pallas kernel: the card runs the ring in
PyTorch operations.  Dropout draws the kernels' keep mask at the global
(q, k) positions with a seed folded with the rank's index along every
axis the q spec shards over, so shards that differ only in ``dp`` or
``tp`` draw different masks.  Outside a :func:`~.collectives.spmd`
region q/k/v are the reference's global ``(B, H, T, D)`` arrays (the
same on every rank) and so is the result; inside one (the train step
on a mesh) they are the rank's blocks, and a ``DTensor`` is taken by
its local block and returned as one.
"""
from __future__ import annotations

import logging
import math
import os

import torch

from ..kernels import flash_attention as _fa
from . import collectives as _coll
from .mesh import P

__all__ = ["attention", "local_flash_attention", "ring_attention",
           "attention_arm", "attention_mode", "dispatch_counts",
           "DENSE_MAX_KV_DEFAULT"]

_logger = logging.getLogger(__name__)

# Which attention path each distinct call signature took, deduplicated by
# (path, detail) as in the reference: a new shape or dtype counts once.
dispatch_counts = {"flash_kernel": 0, "dense": 0, "ring": 0, "ulysses": 0}
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
                dropout_seed=None, q_offset=0, k_offset=0):
    """One q-block × k-block attention: ``(m, l, o)`` statistics, float32
    (row max, floored at -1e30 where every key is masked, denominator,
    numerator).
    q: (B, H, Tq, D), k/v: (B, H, Tk, D); bias: added (in float32) to the
    scaled scores before the mask; mask: bool, True = attend.
    Dropout hits only the V-accumulation (the denominator ``l`` stays
    un-dropped); its mask is the flash kernels' (row ``bh = b*H + h``) at
    query positions ``q_offset + i`` and key positions ``k_offset + j``.
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
            (q_offset + torch.arange(t, device=dev)).reshape(1, 1, t, 1),
            (k_offset + torch.arange(tk, device=dev)).reshape(1, 1, 1, tk),
            dropout_rate)
        p = torch.where(keep, p / (1.0 - dropout_rate), 0.0)
    o = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    return m_safe, l, o


def _merge(m1, l1, o1, m2, l2, o2):
    """Merge two online-softmax partial results."""
    m = torch.maximum(m1, m2)
    a1 = torch.exp(m1 - m)
    a2 = torch.exp(m2 - m)
    return m, l1 * a1 + l2 * a2, o1 * a1[..., None] + o2 * a2[..., None]


def fold_seed(seed, index):
    """A ``(1,)`` int32 dropout seed mixed with an integer ``index`` on
    the seed's device (the reference's ``fold_in``): equal inputs give
    equal seeds, different indices different streams."""
    s = torch.as_tensor(seed).reshape(1).to(torch.int64) & _fa._M32
    h = _fa._fmix32(s ^ _fa._fmix32((s * 0 + int(index) + _fa._ROW_SALT
                                     + 0x632BE5AB) & _fa._M32))
    return (h & 0x7FFFFFFF).to(torch.int32)


def _fold_axes(seed, mesh, axes):
    for ax in axes:
        seed = fold_seed(seed, mesh.axis_index(ax))
    return seed


def _ring_chunk(tb, prefer=1024):
    """Each ring step's inner chunk: the per-step score block is
    ``(Tb, C)``, not ``(Tb, Tb)``; a ``prefer`` that does not divide
    ``Tb`` falls down the power-of-two ladder (the reference's)."""
    if tb <= prefer:
        return tb
    if tb % prefer == 0:
        return prefer
    for c in (512, 256, 128):
        if c <= prefer and tb % c == 0:
            return c
    return tb


def _ring_body(q, k, v, valid, seed, bias, *, mesh, axis_name, causal,
               scale, rate, key_axes, step_chunk):
    """One rank's ring: q/k/v its ``(B, H, Tb, D)`` blocks, ``valid`` the
    ``(B,)`` global key counts or None, ``bias`` its ``(B|1, H|1, Tb,
    T)`` rows or None, ``seed`` a ``(1,)`` int32 tensor or None."""
    n = mesh.axis_size(axis_name)
    my = mesh.axis_index(axis_name)
    b, h, tb, _ = q.shape
    dev = q.device
    m = torch.full((b, h, tb), -1e30, dtype=torch.float32, device=dev)
    l = torch.zeros((b, h, tb), dtype=torch.float32, device=dev)
    o = torch.zeros(q.shape, dtype=torch.float32, device=dev)
    perm = [(i, (i + 1) % n) for i in range(n)]
    if seed is not None:
        seed = _fold_axes(seed, mesh, key_axes)
    c = _ring_chunk(tb, step_chunk) if step_chunk else _ring_chunk(tb)
    qpos = my * tb + torch.arange(tb, device=dev)
    k_cur, v_cur = k, v
    for i in range(n):
        k_idx = (my - i) % n              # whose K block this rank holds
        for ci in range(tb // c):
            k0 = k_idx * tb + ci * c
            kpos = k0 + torch.arange(c, device=dev)
            mask = None
            if causal:
                mask = (qpos[:, None] >= kpos[None, :])[None, None]
            if valid is not None:
                km = kpos[None, None, None, :] < valid.long()[:, None, None,
                                                              None]
                mask = km if mask is None else mask & km
            bm, bl, bo = _block_attn(
                q, k_cur[:, :, ci * c:(ci + 1) * c],
                v_cur[:, :, ci * c:(ci + 1) * c],
                bias=None if bias is None else bias[..., k0:k0 + c],
                mask=mask, scale=scale, dropout_rate=rate,
                dropout_seed=seed, q_offset=my * tb, k_offset=k0)
            m, l, o = _merge(m, l, o, bm, bl, bo)
        if i < n - 1:
            k_cur = _coll.ppermute(k_cur, mesh, axis_name, perm)
            v_cur = _coll.ppermute(v_cur, mesh, axis_name, perm)
    return (o / l.clamp_min(1e-30)[..., None]).to(q.dtype)


def _sp_spec(mesh, axis_name, q_spec, batch_axes, present):
    bax, hax = (tuple(batch_axes) + (None, None))[:2]
    return q_spec or P(bax if bax and present(bax) else None,
                       hax if hax and present(hax) else None,
                       axis_name if present(axis_name) else None, None)


def _sp_call(body, q, k, v, mesh, spec, valid_length, dropout_seed, bias,
             bias_spec):
    """Run ``body(q, k, v, valid, seed, bias)`` on this rank's blocks: the
    reference's ``shard_map`` over global arrays outside an SPMD region
    (operands scattered by their specs, the result gathered), the blocks
    themselves inside one, a ``DTensor``'s local block for a
    ``DTensor``."""
    from .mesh import spec_axes
    dtensor = None
    try:
        from torch.distributed.tensor import DTensor
        if isinstance(q, DTensor):
            dtensor = q
            q, k, v = q.to_local(), k.to_local(), v.to_local()
    except ImportError:      # pragma: no cover - torch without DTensor
        pass
    glob = dtensor is None and _coll.current_spmd() is None
    valid = None
    if valid_length is not None:
        valid = torch.as_tensor(valid_length, device=q.device)
        if glob:
            valid = _coll.scatter(valid, mesh, spec_axes(spec[0]), 0)
    if glob:
        q, k, v = (_coll.scatter_spec(x, mesh, spec) for x in (q, k, v))
        if bias is not None:
            bias = _coll.scatter_spec(bias, mesh, bias_spec)
    out = body(q, k, v, valid, dropout_seed, bias)
    if glob:
        return _coll.gather_spec(out, mesh, spec)
    if dtensor is not None:
        from torch.distributed.tensor import DTensor
        return DTensor.from_local(out, dtensor.device_mesh,
                                  dtensor.placements)
    return out


def ring_attention(q, k, v, mesh, axis_name="sp", causal=False, q_spec=None,
                   valid_length=None, dropout_rate=0.0, dropout_key=None,
                   bias=None, batch_axes=("dp", "tp"), step_chunk=None,
                   dropout_seed=None):
    """Sequence-parallel attention (module docstring).  q/k/v: global
    ``(B, H, T, D)`` arrays whose T axis is split over ``axis_name``
    (rank blocks inside an SPMD region); returns the output laid out
    alike.  ``q_spec`` overrides the default
    ``P(batch_axes[0], batch_axes[1], axis_name, None)`` (axes absent
    from the mesh dropped).  ``valid_length``: ``(B,)`` valid key
    counts.  ``dropout_seed`` (or ``dropout_key``): a ``(1,)`` int32
    seed.  ``bias``: ``(B|1, H|1, T, T)`` additive bias whose rows split
    with q and whose columns each step slices for the block it holds."""
    dropout_seed = _dropout_seed(dropout_key, dropout_seed)
    present = lambda ax: ax in mesh.axis_names
    spec = _sp_spec(mesh, axis_name, q_spec, batch_axes, present)
    scale = 1.0 / math.sqrt(q.shape[-1])
    rate = float(dropout_rate) if dropout_seed is not None else 0.0
    if not present(axis_name):
        mask = _dense_mask(q.shape[2], k.shape[2], causal, valid_length,
                           q.device)
        _, l, o = _block_attn(q, k, v, bias=bias, mask=mask, scale=scale,
                              dropout_rate=rate, dropout_seed=dropout_seed)
        return (o / l.clamp_min(1e-30)[..., None]).to(q.dtype)
    _count("ring", f"sp={mesh.shape[axis_name]} shape={tuple(q.shape)} "
                   f"dtype={q.dtype}")
    bspec = None
    if bias is not None:
        bspec = P(spec[0] if bias.shape[0] > 1 else None,
                  spec[1] if bias.shape[1] > 1 else None, spec[2], None)
    key_axes = tuple(a for entry in spec for a in
                     (entry if isinstance(entry, tuple) else (entry,))
                     if a is not None)

    def body(q, k, v, valid, seed, b):
        return _ring_body(q, k, v, valid, seed if rate > 0.0 else None, b,
                          mesh=mesh, axis_name=axis_name, causal=causal,
                          scale=scale, rate=rate, key_axes=key_axes,
                          step_chunk=step_chunk)
    return _sp_call(body, q, k, v, mesh, spec, valid_length, dropout_seed,
                    bias, bspec)


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
    _, l, o = _block_attn(q, k, v, bias=bias, mask=mask,
                          scale=1.0 / math.sqrt(q.shape[-1]),
                          dropout_rate=rate, dropout_seed=dropout_seed)
    return (o / l.clamp_min(1e-30)[..., None]).to(q.dtype)


def attention(q, k, v, mesh=None, causal=False, valid_length=None,
              dropout_rate=0.0, dropout_key=None, bias=None,
              sp_strategy=None, dropout_seed=None):
    """Dispatch: sequence parallelism when the mesh (the SPMD region's,
    else ``mesh``) has an ``sp`` axis longer than 1 — ``sp_strategy``
    (``"ring"``/``"ulysses"``, else :func:`~.ulysses.get_sp_strategy`),
    Ulysses only where ``H % sp == 0`` and ``tp`` is 1, ring otherwise —
    else :func:`local_flash_attention`.  ``sp_strategy`` is checked on
    every call, mesh or not, so a typo never selects the local path
    silently.  Inside an SPMD region the local arm's dropout seed is
    folded with the rank's index along every mesh axis, so each rank
    draws its own mask."""
    if sp_strategy is not None and sp_strategy not in ("ring", "ulysses"):
        raise ValueError(f"unknown sp_strategy {sp_strategy!r}; use 'ring' "
                         "or 'ulysses'")
    seed = _dropout_seed(dropout_key, dropout_seed)
    region = _coll.current_spmd()
    mesh = region if region is not None else mesh
    if mesh is not None and "sp" in getattr(mesh, "axis_names", ()) \
            and mesh.shape["sp"] > 1:
        from .ulysses import get_sp_strategy, ulysses_attention
        strategy = sp_strategy or get_sp_strategy()
        kw = dict(causal=causal, valid_length=valid_length,
                  dropout_rate=dropout_rate, dropout_seed=seed, bias=bias)
        if strategy == "ulysses" and q.shape[1] % mesh.shape["sp"] == 0 \
                and mesh.shape.get("tp", 1) == 1:
            return ulysses_attention(q, k, v, mesh, **kw)
        return ring_attention(q, k, v, mesh, **kw)
    if region is not None and seed is not None and dropout_rate > 0.0:
        seed = _fold_axes(seed, region, region.axis_names)
    return local_flash_attention(q, k, v, causal=causal,
                                 valid_length=valid_length,
                                 dropout_rate=dropout_rate,
                                 dropout_seed=seed, bias=bias)
