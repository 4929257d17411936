"""RNG state: the port's ``mx.random`` over explicit ``torch.Generator``s.

The reference (``tpu_mx/random.py``) splits one process-global JAX key
per draw (``take_key``).  PyTorch's generators are stateful streams, one
per device, so the port keeps a seeded :class:`torch.Generator` for each
device it is asked about (:func:`generator`) and hands it out explicitly:
parameter init, hidden dropout and the attention-dropout seed each take
a generator as an argument, and nothing here touches PyTorch's global
RNG.  :func:`take_seed` is the counterpart of ``take_key`` for the flash
kernels: a fresh ``(1,)`` int32 seed drawn on the generator's device, so
drawing it needs no device-to-host copy.

The reference's seed contract holds: :func:`seed` also seeds numpy's
global state (host-path initializers draw from it) and returns the
prior state token, and :func:`get_state`/:func:`set_state` snapshot and
restore every generator handed out plus numpy's global state bit for
bit.  The token is plain JSON (lists and numbers), so a JSON round trip
hands it back whole.

The two packages give different numbers from the same seed; parity
tests make their inputs with numpy and hand them to both.
"""
from __future__ import annotations

import threading

import numpy as np
import torch

__all__ = ["seed", "generator", "take_seed", "get_state", "set_state",
           "host_rng"]

_lock = threading.Lock()
_seed = 0
_generators = {}


def get_state():
    """Snapshot the port's generators and numpy's global state as a
    JSON-ready token for :func:`set_state`: ``{"seed": int, "torch":
    {device: [state bytes]}, "numpy": [name, keys, pos, has_gauss,
    cached_gaussian]}``."""
    name, keys, pos, has_gauss, cached = np.random.get_state()
    with _lock:
        gens = {str(dev): g.get_state().tolist()
                for dev, g in _generators.items()}
        return {"seed": _seed, "torch": gens,
                "numpy": [str(name), keys.tolist(), int(pos),
                          int(has_gauss), float(cached)]}


def set_state(state):
    """Restore a :func:`get_state` / :func:`seed` token bit for bit (also
    after a JSON round trip).  A generator made after the snapshot
    restarts from the token's seed, as it would have been made then."""
    global _seed
    name, keys, pos, has_gauss, cached = state["numpy"]
    np.random.set_state((str(name), np.asarray(keys, dtype=np.uint32),
                         int(pos), int(has_gauss), float(cached)))
    with _lock:
        _seed = int(state["seed"])
        for dev, g in _generators.items():
            saved = state["torch"].get(str(dev))
            if saved is None:
                g.manual_seed(_seed)
            else:
                g.set_state(torch.tensor(saved, dtype=torch.uint8))


def seed(seed_state, ctx="all"):
    """Reseed every device's generator and numpy's global state
    (``mx.random.seed``); returns the prior state token (see
    :func:`get_state`).  Generators handed out before keep their
    identity and restart their streams from ``seed_state``; ones made
    later start from it too.  ``ctx`` is taken and, as in the
    reference, every stream is reseeded whatever it names."""
    global _seed
    prior = get_state()
    with _lock:
        _seed = int(seed_state)
        for g in _generators.values():
            g.manual_seed(_seed)
    np.random.seed(int(seed_state) % (2 ** 32))
    return prior


def host_rng():
    """The host-side generator: numpy's global ``RandomState`` itself,
    the stream :func:`seed` seeds and :func:`get_state` snapshots.  The
    data plane's samplers and transforms draw through it, so a seeded
    shuffle is the reference's bit for bit."""
    return np.random.mtrand._rand


def generator(device="cuda"):
    """The process's seeded generator for ``device`` (made at first use).
    A caller that wants a stream of its own passes its own
    ``torch.Generator(device=...).manual_seed(s)`` instead."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    with _lock:
        g = _generators.get(dev)
        if g is None:
            g = _generators[dev] = torch.Generator(device=dev)
            g.manual_seed(_seed)
        return g


def take_seed(gen):
    """A fresh int32 dropout seed, as a ``(1,)`` tensor on ``gen``'s
    device — one per attention call, as the reference takes one key."""
    return torch.randint(0, 2 ** 31 - 1, (1,), generator=gen,
                         device=gen.device, dtype=torch.int32)
