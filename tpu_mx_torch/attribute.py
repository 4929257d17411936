"""``mx.attribute``: ``AttrScope``, from ``tpu_mx/attribute.py`` (a copy:
the module needs nothing but the standard library).

``with mx.AttrScope(ctx_group="dev1", lr_mult="0.1"):`` attaches the
given attributes to every Symbol node (and Variable) created inside the
scope.  Scopes nest; inner values win."""
from __future__ import annotations

import threading

__all__ = ["AttrScope", "current_attrs"]

_tls = threading.local()


def _stack():
    if not hasattr(_tls, "stack"):
        _tls.stack = []
    return _tls.stack


def current_attrs():
    """Merged attribute dict of the active scopes (inner wins)."""
    merged = {}
    for frame in _stack():
        merged.update(frame)
    return merged


class AttrScope:
    def __init__(self, **attrs):
        # every value is kept as a string, as Symbol.attr returns it
        self._attrs = {k: str(v) for k, v in attrs.items()}

    def __enter__(self):
        _stack().append(self._attrs)
        return self

    def __exit__(self, *exc):
        _stack().pop()
        return False
