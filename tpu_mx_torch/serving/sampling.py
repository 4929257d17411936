"""Samplers whose random state is data: ``tpu_mx/serving/sampling.py``.

Greedy decode needs no state: its ``argmax`` stays on the device, in the
decode step.  A non-greedy stream is replayable only if the sampler's
state is kept as data, so :class:`TopKSampler` draws from a private
``numpy.random.RandomState`` (MT19937, in float64, on the host — the
same generator and arithmetic as the reference, so the same logits and
seed give the same token and the same ``state_dict``), and
``state_dict``/``load_state_dict`` round-trip its exact state
(:func:`tpu_mx_torch.resume.encode_state`).

The server resolves sampling once (:func:`parse_sampling`) and gives
each request its own sampler, seeded by :func:`fold_seed` of the
server's seed and the request id.  A sampled request's decode step
hands the last position's logits back to the server's step thread,
which samples there; the engine pins the speculative window to 1 for a
non-greedy server (speculation verifies greedily).
"""
from __future__ import annotations

import zlib

import numpy as np

from ..base import MXNetError
from ..resume import decode_state, encode_state

__all__ = ["GreedySampler", "TopKSampler", "fold_seed", "make_sampler",
           "parse_sampling"]


def parse_sampling(spec):
    """``"greedy"`` or ``"top_k:K"`` → ``("greedy", None)`` /
    ``("top_k", K)``; anything else raises (at the server's
    construction, not at request N)."""
    spec = str(spec or "greedy").strip()
    if spec == "greedy":
        return "greedy", None
    kind, _, arg = spec.partition(":")
    if kind == "top_k":
        try:
            k = int(arg)
        except ValueError:
            k = 0
        if k >= 1:
            return "top_k", k
    raise MXNetError(
        f"serving: unknown sampling spec {spec!r} — expected 'greedy' "
        f"or 'top_k:K' with K >= 1")


def fold_seed(base_seed, request_id):
    """One deterministic 32-bit seed per request: the server's
    ``sampling_seed`` folded with the request id."""
    return (int(base_seed) * 1000003
            + zlib.crc32(str(request_id).encode("utf-8"))) & 0xFFFFFFFF


class GreedySampler:
    """Stateless argmax — the trivial member of the sampler protocol."""

    kind = "greedy"

    def sample(self, logits):
        return int(np.argmax(np.asarray(logits).reshape(-1)))

    def state_dict(self):
        return {"kind": self.kind}

    def load_state_dict(self, state):
        if state.get("kind") != self.kind:
            raise MXNetError(f"sampler state kind {state.get('kind')!r} "
                             f"!= {self.kind!r}")

    def reset(self):
        pass


class TopKSampler:
    """Softmax over the ``k`` largest logits, drawn from a private
    MT19937 (see the module docstring)."""

    kind = "top_k"

    def __init__(self, k, seed=0):
        self.k = int(k)
        if self.k < 1:
            raise MXNetError(f"TopKSampler: k must be >= 1, got {k}")
        self._rng = np.random.RandomState(int(seed) & 0xFFFFFFFF)
        self._initial = self._rng.get_state()

    def sample(self, logits):
        logits = np.asarray(logits, np.float64).reshape(-1)
        k = min(self.k, logits.size)
        idx = np.argpartition(logits, -k)[-k:]
        # one candidate order whatever argpartition returned: logit
        # descending, index ascending on ties
        idx = idx[np.lexsort((idx, -logits[idx]))]
        z = logits[idx] - logits[idx][0]
        p = np.exp(z)
        p /= p.sum()
        return int(idx[self._rng.choice(k, p=p)])

    def state_dict(self):
        """The generator's exact state as JSON-safe data."""
        return {"kind": self.kind, "k": self.k,
                "state": encode_state(list(self._rng.get_state()))}

    def load_state_dict(self, state):
        if state.get("kind") != self.kind:
            raise MXNetError(f"sampler state kind {state.get('kind')!r} "
                             f"!= {self.kind!r}")
        if int(state.get("k", self.k)) != self.k:
            raise MXNetError(
                f"sampler state k={state.get('k')} != configured "
                f"k={self.k} — the stream was drawn under another "
                "distribution")
        st = decode_state(state["state"])
        self._rng.set_state((str(st[0]), np.asarray(st[1], np.uint32),
                             int(st[2]), int(st[3]), float(st[4])))

    def reset(self):
        """Back to the state the sampler was built with."""
        self._rng.set_state(self._initial)


def make_sampler(kind, k, seed):
    """A request's sampler, or None for greedy (the device's argmax)."""
    if kind == "greedy":
        return None
    if kind == "top_k":
        return TopKSampler(k, seed=seed)
    raise MXNetError(f"serving: unknown sampler kind {kind!r}")
