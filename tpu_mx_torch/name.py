"""``mx.name``: ``NameManager`` and ``Prefix``, from ``tpu_mx/name.py`` (a
copy: the module needs nothing but the standard library).

Symbol names (``fullyconnected0``, ...) go through the active
``NameManager``; ``with mx.name.Prefix("block1_"):`` prefixes every name
made in the scope, explicit names included."""
from __future__ import annotations

import threading

__all__ = ["NameManager", "Prefix"]

_tls = threading.local()


def _current():
    return getattr(_tls, "manager", None)


class NameManager:
    """Counts per-hint and yields `hint0, hint1, ...`; subclass `get` for
    custom schemes."""

    def __init__(self):
        self._counter = {}

    def get(self, name, hint):
        if name is not None:
            return name
        i = self._counter.get(hint, 0)
        self._counter[hint] = i + 1
        return f"{hint}{i}"

    def __enter__(self):
        self._old = _current()
        _tls.manager = self
        return self

    def __exit__(self, *exc):
        _tls.manager = self._old
        return False


class Prefix(NameManager):
    def __init__(self, prefix):
        super().__init__()
        self._prefix = prefix

    def get(self, name, hint):
        return self._prefix + super().get(name, hint)
