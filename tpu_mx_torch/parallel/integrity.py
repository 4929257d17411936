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
(:func:`_perturb`) so the detector's alarm is testable.

:class:`IntegrityMonitor` is the cross-replica vote, the reference's
protocol and files: every ``interval`` committed steps each rank
publishes its fingerprint (``CompiledTrainStep.fingerprint``) with a
ring of earlier ones to ``<root>/integrity/fp-<rank>.json``, waits for
the cohort and votes.  Replicas fed the same batches are bit-identical,
so any disagreement is corruption: a strict majority names the minority
(a tie detects but names no one), and the verdict raises
:class:`~tpu_mx_torch.supervisor.DataCorruption` at the step boundary —
``self_corrupt`` on a voted-out rank — and is appended to
``votes-<rank>.jsonl``.  An all-agree vote of the whole cohort advances
``verified_step``, the rollback anchor the resume capsule carries.
"""
from __future__ import annotations

import json
import logging
import os
import time

import numpy as np
import torch

from .. import checkpoint as _ckpt
from .. import telemetry as _telemetry
from .. import tracing as _tracing
from ..supervisor import DataCorruption

__all__ = ["DataCorruption", "IntegrityMonitor", "ShadowAuditor",
           "device_fingerprint", "host_fingerprint", "bits_equal", "sampled",
           "leaf_word_sum", "fold_sums"]

log = logging.getLogger(__name__)

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


def _record_fp_at(rec, step):
    """The fingerprint a published record carries for ``step`` — the
    newest entry or one from its history ring — or None."""
    if not isinstance(rec, dict):
        return None
    if int(rec.get("step", -1)) == int(step):
        return int(rec["fp"])
    for s, v in rec.get("history") or ():
        if int(s) == int(step):
            return int(v)
    return None


# ---------------------------------------------------------------------------
# cross-replica fingerprint voting
# ---------------------------------------------------------------------------
class IntegrityMonitor:
    """One rank's handle on the fingerprint-vote protocol.

    ``root`` is a directory the ranks share;
    ``rank`` this replica's slot; ``world`` the ranks expected to vote
    (refresh with :meth:`set_world` after a reshard).  ``interval`` is K:
    fingerprints are published and compared every K committed steps —
    detection latency is bounded by K, which is the knob trading audit
    I/O against blast radius.  ``fingerprint_fn`` is a zero-arg callable
    returning the step's digest (``CompiledTrainStep.fingerprint``);
    the supervisor calls :meth:`on_committed_step` at every step
    boundary, which raises :class:`DataCorruption` on a disagreeing
    vote.

    The monitor is fleet-agnostic (plain directory paths): the files are
    the reference's, and one process can drive a multi-rank vote.
    ``heartbeat`` is a plain callable, called in a vote's wait."""

    def __init__(self, root, rank=0, world=None, interval=8,
                 fingerprint_fn=None, history=256, vote_timeout=2.0,
                 poll=0.02, heartbeat=None):
        self.root = os.fspath(root)
        self.rank = int(rank)
        self.world = sorted(int(m) for m in (world or [rank]))
        self.interval = max(1, int(interval))
        self.fingerprint_fn = fingerprint_fn
        self.history_limit = int(history)
        self.vote_timeout = float(vote_timeout)
        self.poll = float(poll)
        # called every poll iteration of a vote wait: a rank blocked on
        # slower peers keeps renewing whatever lease it holds
        self.heartbeat = heartbeat
        self.history = []              # [(step, fp), ...] ring
        self._pub_ring = []            # published (step, fp) pairs
        self.verified_step = 0         # last all-agree vote step
        self.first_disagree_step = None
        self.published = 0
        os.makedirs(self._dir(), exist_ok=True)

    # -- files ------------------------------------------------------------
    def _dir(self):
        return os.path.join(self.root, "integrity")

    def _fp_path(self, rank):
        return os.path.join(self._dir(), f"fp-{int(rank)}.json")

    def _votes_path(self):
        return os.path.join(self._dir(), f"votes-{self.rank}.jsonl")

    def set_world(self, world):
        """Adopt a new voting cohort (after a reshard/quarantine — the
        vote must not wait on a rank that is no longer in the world)."""
        self.world = sorted(int(m) for m in world)

    # -- publish / read ---------------------------------------------------
    def publish(self, step, fp):
        """Atomically publish this rank's fingerprint for ``step``.

        The record carries a short ring of PRIOR published (step, fp)
        pairs: a fast rank overwrites this file long before slow peers
        reach their vote for an earlier step, and without the ring those
        voters would be starved of the very record they compare (30s
        timeout stalls, missed attribution — the fp file is newest-only
        by design, the ring is what makes the vote race-free)."""
        self._pub_ring.append((int(step), int(fp)))
        del self._pub_ring[:-32]
        body = {"member": self.rank, "step": int(step), "fp": int(fp),
                "wall_time": time.time(),
                "history": [[s, v] for s, v in self._pub_ring]}
        with _ckpt.atomic_write(self._fp_path(self.rank), mode="w") as f:
            f.write(json.dumps(body))
        self.published += 1
        _telemetry.counter("integrity.fingerprints").inc()
        _tracing.emit("integrity.fingerprint", step=int(step), fp=int(fp),
                      rank=self.rank)

    def peers(self):
        """All published fingerprint records: {rank: record}."""
        out = {}
        try:
            names = os.listdir(self._dir())
        except OSError:
            return out
        for name in names:
            if not (name.startswith("fp-") and name.endswith(".json")):
                continue
            try:
                with open(os.path.join(self._dir(), name),
                          encoding="utf-8") as f:
                    rec = json.load(f)
            except (OSError, ValueError):
                continue
            if isinstance(rec, dict) and "member" in rec:
                out[int(rec["member"])] = rec
        return out

    # -- the vote ---------------------------------------------------------
    def vote(self, step, wait=True):
        """Compare the cohort's fingerprints at ``step``.

        Waits up to ``vote_timeout`` for every world rank to publish the
        step's record (all ranks publish on the same committed-step
        cadence, so the wait covers scheduling skew, not drift).  Ranks
        that never show are counted absent — the vote proceeds among
        those present when at least two did (below that there is nothing
        to compare: shadow audits are the one-replica story).  Returns the
        verdict dict (also appended to this rank's ``votes-*.jsonl``),
        or None when no quorum formed."""
        deadline = time.monotonic() + (self.vote_timeout if wait else 0.0)
        next_beat = 0.0
        while True:
            recs = self.peers()
            votes = {}
            for m in self.world:
                fp = _record_fp_at(recs.get(m), step)
                if fp is not None:
                    votes[m] = fp
            if len(votes) == len(self.world) \
                    or time.monotonic() >= deadline:
                break
            if self.heartbeat is not None \
                    and time.monotonic() >= next_beat:
                next_beat = time.monotonic() + 0.25
                try:
                    self.heartbeat()
                except Exception:   # noqa: BLE001 — lease renewal is
                    pass            # best-effort inside the wait
            time.sleep(self.poll)
        if len(votes) < 2:
            return None
        counts = {}
        for fp in votes.values():
            counts[fp] = counts.get(fp, 0) + 1
        majority_fp, majority_n = max(counts.items(),
                                      key=lambda kv: (kv[1], -kv[0]))
        agree = len(counts) == 1
        # a strict majority names the minority; a tie (2 ranks, or 2v2)
        # detects corruption but cannot attribute — minority stays empty
        # and every voter treats itself as a survivor (rolls back)
        quorum = majority_n * 2 > len(votes)
        minority = sorted(m for m, fp in votes.items()
                          if fp != majority_fp) if quorum and not agree \
            else []
        verdict = {"step": int(step), "agree": bool(agree),
                   "quorum": bool(quorum), "majority_fp": int(majority_fp),
                   "votes": {str(m): int(fp) for m, fp in votes.items()},
                   "minority": [int(m) for m in minority],
                   "absent": sorted(m for m in self.world
                                    if m not in votes),
                   "world": list(self.world), "wall_time": time.time()}
        self._record_vote(verdict)
        _telemetry.counter("integrity.votes").inc()
        _tracing.emit("integrity.vote", step=int(step), agree=bool(agree),
                      majority_fp=int(majority_fp),
                      minority=",".join(str(m) for m in minority),
                      world_size=len(votes))
        if agree:
            # certification needs the FULL cohort: an agree vote among a
            # subset (a peer's publish raced the timeout) proves nothing
            # about the absent ranks, so it must not advance the
            # rollback anchor
            if not verdict["absent"]:
                self.verified_step = max(self.verified_step, int(step))
                _telemetry.gauge("integrity.verified_step") \
                    .set(self.verified_step)
        else:
            _telemetry.counter("integrity.mismatches").inc()
            if self.first_disagree_step is None \
                    or int(step) < self.first_disagree_step:
                self.first_disagree_step = int(step)
        return verdict

    def _record_vote(self, verdict):
        try:
            with open(self._votes_path(), "a", encoding="utf-8") as f:
                f.write(json.dumps(verdict) + "\n")
        except OSError:
            pass  # forensics must never fail the step they describe

    # -- the supervised-step hook -----------------------------------------
    def on_committed_step(self, step, fp=None):
        """The per-step duty cycle, called by the supervisor after each
        committed step: fold the fingerprint into history and, every
        ``interval`` steps, publish + vote.  Raises
        :class:`DataCorruption` when the vote disagrees — at the step
        boundary, so the rollback never lands mid-step."""
        if fp is None and self.fingerprint_fn is not None:
            fp = self.fingerprint_fn()
        if fp is None:
            return None
        step, fp = int(step), int(fp)
        self.history.append((step, fp))
        if len(self.history) > self.history_limit:
            del self.history[:len(self.history) - self.history_limit]
        if step % self.interval != 0:
            return None
        self.publish(step, fp)
        verdict = self.vote(step)
        if verdict is None or verdict["agree"]:
            return verdict
        minority = verdict["minority"]
        self_corrupt = self.rank in minority
        raise DataCorruption(
            f"cross-replica fingerprint vote disagreed at step {step}: "
            f"rank {self.rank} fp={fp:#010x}, majority "
            f"fp={verdict['majority_fp']:#010x}, minority "
            f"{minority or '(no quorum to attribute)'} — "
            + ("this rank is corrupt: quarantine" if self_corrupt else
               "rolling back to the last verified checkpoint "
               f"(step {self.verified_step})"),
            step=step, minority=minority,
            verified_step=self.verified_step, surface="train",
            self_corrupt=self_corrupt)

    # -- capsule seam ------------------------------------------------------
    def state_dict(self):
        """The fingerprint ledger the resume capsule carries — a restored
        run knows its last PROVEN-good step (and any disagreement it was
        recovering from) instead of re-deriving trust from nothing."""
        return {"rank": self.rank, "interval": self.interval,
                "history": [[int(s), int(f)] for s, f in self.history],
                "verified_step": int(self.verified_step),
                "first_disagree_step": self.first_disagree_step,
                "published": int(self.published)}

    def load_state_dict(self, state):
        self.history = [(int(s), int(f))
                        for s, f in state.get("history", [])]
        self.verified_step = int(state.get("verified_step", 0))
        fd = state.get("first_disagree_step")
        self.first_disagree_step = None if fd is None else int(fd)
        self.published = int(state.get("published", 0))


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
