"""State fingerprints, from ``tpu_mx/parallel/integrity.py``.

:func:`device_fingerprint` folds a parameter tree into one 32-bit digest
on the device, bit for bit the reference's: leaves in ``tree_leaves``
order (a dict's keys sorted, lists and tuples in order), each leaf's
bits read as unsigned 32-bit words (float32 as they are, float16 and
bfloat16 widened from 16 bits, float64 as the XOR of its halves,
integers and booleans by value), summed modulo 2^32 and folded FNV-style
(``acc = acc·16777619 + sum``, from 2166136261).  A flipped bit in any
leaf moves its sum by ±2^b and so always changes the digest.

PyTorch has no general uint32 arithmetic, so the port reads the bits
with ``Tensor.view`` (never a value cast) as signed words and sums them
in int64: a signed word is its unsigned one less 2^32 or nothing, so the
sums agree modulo 2^32; a 16-bit word is offset by 2^15 (sign bit
flipped) and the offset added back.  The fold runs over all leaves at
once, in 16-bit halves so no product leaves int64.

:func:`host_fingerprint` is the host-side twin.  The monitor, the
shadow auditor and their helpers (``IntegrityMonitor``,
``ShadowAuditor``, ``bits_equal``, ``sampled``) are ROADMAP A item 8.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["device_fingerprint", "host_fingerprint", "leaf_word_sum",
           "fold_sums"]

_FNV_BASIS = 2166136261
_FNV_PRIME = 16777619
_MASK = 0xFFFFFFFF


def _leaves(tree):
    """``jax.tree_util.tree_leaves`` order over dicts, lists and tuples;
    None holds no leaf, and only values with a dtype count."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    if isinstance(tree, (np.ndarray, np.generic)):
        return [torch.from_numpy(np.array(tree, copy=True))]
    return [tree] if isinstance(tree, torch.Tensor) else []


def leaf_word_sum(x):
    """The sum of ``x``'s unsigned 32-bit words, modulo 2^32 up to a
    multiple of it: a 0-d int64 tensor on ``x``'s device (no host
    read)."""
    x = x.detach()
    if x.dtype.is_floating_point:
        size = x.element_size()
        if size == 4:
            return x.reshape(-1).view(torch.int32).sum(dtype=torch.int64)
        if size == 2:
            w = x.reshape(-1).view(torch.int16) ^ -32768
            return w.sum(dtype=torch.int64) + 32768 * w.numel()
        if size == 8:
            u = x.reshape(-1).view(torch.int64)
            return ((u & _MASK) ^ ((u >> 32) & _MASK)).sum()
        raise TypeError(f"device_fingerprint: unsupported leaf dtype "
                        f"{x.dtype}")
    if x.dtype.is_complex:
        raise TypeError(f"device_fingerprint: unsupported leaf dtype "
                        f"{x.dtype}")
    return x.reshape(-1).sum(dtype=torch.int64)


def fold_sums(sums):
    """The FNV fold of per-leaf word sums (int64, any residue mod 2^32),
    as a 0-d int64 tensor holding the digest (``0 <= d < 2^32``)."""
    n = len(sums)
    if n == 0:
        return torch.tensor(_FNV_BASIS, dtype=torch.int64)
    s = torch.stack([t.to(sums[0].device) for t in sums]) & _MASK
    # acc_n = basis·P^n + Σ s_i·P^(n-1-i)  (mod 2^32)
    pows = [1] * n
    for i in range(n - 2, -1, -1):
        pows[i] = pows[i + 1] * _FNV_PRIME & _MASK
    head = _FNV_BASIS * pow(_FNV_PRIME, n, 1 << 32) & _MASK
    p = torch.tensor(pows, dtype=torch.int64, device=s.device)
    lo = (s & 0xFFFF) * p                         # < 2^48
    hi = ((s >> 16) * p & 0xFFFF) << 16           # mod 2^32, < 2^32
    return ((lo & _MASK).sum() + hi.sum() + head) & _MASK


def device_fingerprint(tree):
    """Fold a parameter tree (dicts, lists and tuples of tensors or numpy
    arrays) into one digest: a 0-d int64 tensor on the leaves' device
    holding the reference's uint32 value."""
    return fold_sums([leaf_word_sum(x) for x in _leaves(tree)])


def host_fingerprint(value):
    """The host-side twin: fold numpy arrays / scalars / nested
    lists-of-arrays into one Python int with the same FNV shape (over
    each value's bytes; not comparable with :func:`device_fingerprint`)."""
    acc = _FNV_BASIS
    stack = [value]
    while stack:
        v = stack.pop()
        if v is None:
            continue
        if isinstance(v, (list, tuple)):
            stack.extend(reversed(v))
            continue
        if isinstance(v, torch.Tensor):
            v = _host(v)
        arr = np.asarray(v)
        word = int(np.frombuffer(arr.tobytes(), dtype=np.uint8)
                   .astype(np.uint64).sum() % (1 << 32))
        acc = (acc * _FNV_PRIME + word) % (1 << 32)
    return acc


def _host(t):
    """A tensor's bits as a numpy array (bfloat16 as its uint16 words)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()
