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

:func:`host_fingerprint` is the host-side twin.

:class:`ShadowAuditor` is the detector for a worker with no peer to vote
with (the serving engine's decode self-check, ``TPUMX_SELF_CHECK``): on a
seeded sampled cadence (:func:`sampled`, the reference's splitmix64
hash, so a seed and rate audit the same steps in both packages) it
re-executes the identical step on the identical operands and compares
the results bit for bit (:func:`bits_equal`).  The step is
deterministic, so a mismatch is flaky hardware by construction and
raises :class:`~tpu_mx_torch.supervisor.DataCorruption`; the chaos
``flaky_recompute`` knob flips a bit of the re-execution
(:func:`_perturb`) so the detector's alarm is testable.  The
cross-replica vote (``IntegrityMonitor``) is ROADMAP A item 8.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import telemetry as _telemetry
from .. import tracing as _tracing
from ..supervisor import DataCorruption

__all__ = ["DataCorruption", "ShadowAuditor", "device_fingerprint",
           "host_fingerprint", "bits_equal", "sampled", "leaf_word_sum",
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


def _bits(x):
    """``(dtype, shape, bytes)`` of a step result leaf (a tensor, a numpy
    array or a scalar)."""
    if isinstance(x, torch.Tensor):
        return str(x.dtype), tuple(x.shape), _host(x).tobytes()
    a = np.asarray(x)
    return str(a.dtype), a.shape, a.tobytes()


def bits_equal(a, b):
    """Bit-exact comparison of two step results (ints, numpy arrays,
    tensors, or nested lists/tuples of them).  NaN equals NaN here: the
    comparison is over bit patterns, not IEEE semantics."""
    if isinstance(a, (list, tuple)) or isinstance(b, (list, tuple)):
        if not isinstance(a, (list, tuple)) \
                or not isinstance(b, (list, tuple)) or len(a) != len(b):
            return False
        return all(bits_equal(x, y) for x, y in zip(a, b))
    if a is None or b is None:
        return a is None and b is None
    return _bits(a) == _bits(b)


# -- the seeded sampled cadence -----------------------------------------------
def _mix64(x):
    """The splitmix64 finalizer: a stateless seeded hash, so the audit
    schedule is a function of (seed, index) alone (a restarted run audits
    the same steps) and a periodic fault cannot dodge it."""
    x = (x + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return x ^ (x >> 31)


def sampled(seed, index, rate):
    """True when ``index`` is in the seeded sample of density ``rate``."""
    if rate <= 0.0:
        return False
    if rate >= 1.0:
        return True
    h = _mix64((int(seed) << 32) ^ (int(index) & 0xFFFFFFFF))
    return (h / float(1 << 64)) < float(rate)


def _perturb(value):
    """Flip one bit of a step result: the simulated flaky re-execution
    (chaos ``flaky_recompute``), kept beside the comparison it must
    defeat."""
    if isinstance(value, (list, tuple)):
        return type(value)([_perturb(value[0])] + list(value[1:]))
    if value is None:
        return value
    if isinstance(value, torch.Tensor):
        if value.numel() == 0:
            return value
        flat = value.detach().clone().reshape(-1)
        words = flat.view(torch.uint8)
        words[0] ^= 1
        return flat.reshape(value.shape)
    arr = np.asarray(value)
    if arr.size == 0:
        return value
    flat = arr.copy().reshape(-1).view(np.uint8)
    flat[0] ^= 1
    out = flat.view(arr.dtype).reshape(arr.shape)
    return int(out) if np.isscalar(value) or arr.shape == () else out


class ShadowAuditor:
    """Sampled bit-exact re-execution (module docstring).

    ``rate`` is the audit density (0 disarms), ``seed`` fixes the schedule
    (:func:`sampled`).  :meth:`should_audit` asks whether a step is in the
    sample; :meth:`audit` compares the committed result ``first`` (an
    int, an array, a tensor or a nested tuple of them) with
    ``recompute()``, a re-execution of the identical program on the
    identical operands, and raises
    :class:`~tpu_mx_torch.supervisor.DataCorruption` (``self_corrupt``:
    there is no one else to blame) when their bits differ.  Counts
    ``integrity.shadow_audits`` and ``integrity.shadow_mismatches`` and
    emits ``integrity.shadow_audit``."""

    def __init__(self, rate=0.0, seed=0, surface="train"):
        self.rate = float(rate)
        self.seed = int(seed)
        self.surface = str(surface)
        self.audits = 0
        self.mismatches = 0

    def should_audit(self, index):
        return sampled(self.seed, index, self.rate)

    def audit(self, first, recompute, step=0):
        """Compare the committed result with a shadow re-execution: True
        on a bit-exact match, :class:`DataCorruption` otherwise."""
        from ..contrib import chaos

        self.audits += 1
        _telemetry.counter("integrity.shadow_audits").inc()
        second = recompute()
        if chaos.maybe_flaky_recompute():
            second = _perturb(second)
        ok = bits_equal(first, second)
        _tracing.emit("integrity.shadow_audit", step=int(step),
                      match=bool(ok), surface=self.surface)
        if ok:
            return True
        self.mismatches += 1
        _telemetry.counter("integrity.shadow_mismatches").inc()
        raise DataCorruption(
            f"shadow-step audit mismatch at {self.surface} step {step}: "
            "re-executing the identical program on the identical operands "
            "produced different bits — flaky hardware on this worker",
            step=int(step), surface=self.surface, self_corrupt=True)

    def maybe_audit(self, index, first, recompute):
        """:meth:`audit` when ``index`` is in the seeded sample, else
        None."""
        if not self.should_audit(index):
            return None
        return self.audit(first, recompute, step=index)
