"""Device context: ``mx.cpu()`` / ``mx.gpu(i)`` / ``mx.tpu(i)``, from
``tpu_mx/context.py``.

A :class:`Context` is a logical device handle that resolves to a
:class:`torch.device`: ``gpu(i)`` is ``cuda:i``, ``tpu(i)`` is kept as an
alias of the accelerator (``cuda:i`` too), so scripts written for either
package run unchanged; ``cpu()``, ``cpu_pinned()`` and ``cpu_shared()``
are the host.  ``with ctx:`` nests a thread-local current context, as
in the reference.

One difference, on purpose: the reference's implicit context is the
accelerator when one is visible and the CPU otherwise.  The port runs on
the card unless asked for the host, so its implicit context is
``gpu(0)`` always, and resolving it without a card raises
:class:`~tpu_mx_torch.base.MXNetError` (:func:`tpu_mx_torch.device.resolve`
takes a :class:`Context` wherever it takes ``device=``).
"""
from __future__ import annotations

import threading

import torch

__all__ = ["Context", "cpu", "gpu", "tpu", "cpu_pinned", "current_context",
           "num_gpus", "num_tpus"]

_DEVTYPE_ALIASES = {
    "cpu": "cpu",
    "cpu_pinned": "cpu",
    "cpu_shared": "cpu",
    "gpu": "gpu",
    "tpu": "gpu",      # the accelerator of the reference's scripts
}


class Context:
    """Logical device: ``device_type`` in {cpu, gpu, tpu (alias of gpu),
    cpu_pinned, cpu_shared}, and an id."""

    _tls = threading.local()

    def __init__(self, device_type, device_id=0):
        if device_type not in _DEVTYPE_ALIASES:
            raise ValueError(f"unknown device type {device_type!r}")
        self.device_type = device_type
        self.device_id = int(device_id)

    @property
    def kind(self):
        """``"gpu"`` for the accelerator (``gpu``/``tpu``), else ``"cpu"``."""
        return _DEVTYPE_ALIASES[self.device_type]

    def torch_device(self):
        """The :class:`torch.device` this context names (not checked:
        :func:`tpu_mx_torch.device.resolve` checks it)."""
        if self.kind == "gpu":
            return torch.device("cuda", self.device_id)
        return torch.device("cpu")

    def __enter__(self):
        stack = getattr(Context._tls, "stack", None)
        if stack is None:
            stack = Context._tls.stack = []
        stack.append(self)
        return self

    def __exit__(self, *exc):
        Context._tls.stack.pop()
        return False

    def __eq__(self, other):
        return (isinstance(other, Context) and self.kind == other.kind
                and self.device_id == other.device_id)

    def __hash__(self):
        return hash((self.kind, self.device_id))

    def __repr__(self):
        return f"{self.device_type}({self.device_id})"


def cpu(device_id=0):
    return Context("cpu", device_id)


def cpu_pinned(device_id=0):
    return Context("cpu_pinned", device_id)


def gpu(device_id=0):
    """Card ``device_id`` (``cuda:device_id``)."""
    return Context("gpu", device_id)


def tpu(device_id=0):
    """Alias of :func:`gpu`: the reference's accelerator is the card here."""
    return Context("tpu", device_id)


def num_gpus():
    return torch.cuda.device_count()


num_tpus = num_gpus


def current_context():
    """The innermost ``with ctx:`` context of this thread, else ``gpu(0)``."""
    stack = getattr(Context._tls, "stack", None)
    return stack[-1] if stack else gpu(0)
