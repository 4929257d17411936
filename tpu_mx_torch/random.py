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

The two packages give different numbers from the same seed; parity
tests make their inputs with numpy and hand them to both.
"""
from __future__ import annotations

import threading

import torch

__all__ = ["seed", "generator", "take_seed"]

_lock = threading.Lock()
_seed = 0
_generators = {}


def seed(seed_state):
    """Reseed every device's generator (``mx.random.seed``): generators
    handed out before keep their identity and restart their streams from
    ``seed_state``; ones made later start from it too."""
    global _seed
    with _lock:
        _seed = int(seed_state)
        for g in _generators.values():
            g.manual_seed(_seed)


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
