"""``mx.util``, from ``tpu_mx/util.py``: the numpy-semantics switches
and the small helpers reference code imports from here.  The port has
one array type, as the reference has, so ``np_array``/``use_np`` set
and restore the flag :mod:`~tpu_mx_torch.npx` records and change no
array."""
from __future__ import annotations

import functools
import inspect
import os

from . import npx as _npx

__all__ = ["is_np_array", "is_np_shape", "set_np", "reset_np", "use_np",
           "use_np_array", "use_np_shape", "np_array", "np_shape",
           "getenv", "setenv"]

is_np_array = _npx.is_np_array
is_np_shape = _npx.is_np_shape
set_np = _npx.set_np
reset_np = _npx.reset_np


class _NpScope:
    """Context manager and decorator that sets the numpy-array flag and
    restores it after.  On a class (the reference's ``@use_np`` on a
    Block) it wraps the class's own ``__init__``, ``forward``,
    ``hybrid_forward`` and ``__call__`` and returns the class."""

    def __init__(self, active=True):
        self._active = active

    def __enter__(self):
        self._prev = _npx.is_np_array()
        _npx.set_np(array=self._active)
        return self

    def __exit__(self, *exc):
        _npx.set_np(array=self._prev)
        return False

    def __call__(self, fn):
        if inspect.isclass(fn):
            for meth in ("__init__", "forward", "hybrid_forward",
                         "__call__"):
                if meth in vars(fn):
                    setattr(fn, meth, type(self)(self._active)(
                        vars(fn)[meth]))
            return fn

        @functools.wraps(fn)
        def wrapped(*a, **kw):
            with type(self)(self._active):
                return fn(*a, **kw)
        return wrapped


np_array = _NpScope
np_shape = _NpScope


def use_np_array(fn):
    return _NpScope(True)(fn)


def use_np_shape(fn):
    return _NpScope(True)(fn)


def use_np(fn):
    """Run ``fn`` (or a class's methods) under numpy semantics."""
    return _NpScope(True)(fn)


def getenv(name):
    """Environment variable ``name``: an int if it is all digits, else
    the string, or None when unset."""
    v = os.environ.get(name)
    return int(v) if v is not None and v.isdigit() else v


def setenv(name, value):
    os.environ[name] = str(value)
