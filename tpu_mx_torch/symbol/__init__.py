"""``mx.sym`` / ``mx.symbol``: the symbolic API, from
``tpu_mx/symbol/__init__.py``.

A stub is generated for each operator of the port's table
(:mod:`tpu_mx_torch.ndarray.ops`, with the operator families it
re-exports, and the names the reference's table holds beside them:
``RNN``, ``rnn_param_size``, ``array``, ...), with the reference's
aliases (``SliceChannel``, ``Flatten``, ``Concat``, ``Cast``,
``Reshape``), and ``mx.sym.contrib`` over ``nd.contrib``.
"""
from __future__ import annotations

import inspect as _inspect

from .. import ndarray as _nd
from ..ndarray import ops as _ops
from .symbol import (Executor, Group, Symbol, Variable, load, load_json,
                     register_sym_op, var)
from . import symbol as _symbol_mod

__all__ = ["Symbol", "Variable", "var", "Group", "load", "load_json",
           "Executor", "zeros", "ones"]

_SKIP = {"random", "uniform", "normal", "randn"}  # namespaces and aliases
# the reference's table holds these beside its operators; the port's
# are in nd
_FROM_ND = ("RNN", "rnn_param_size", "array", "concatenate", "load", "save",
            "waitall")


def _autogen():
    g = globals()
    table = {name: getattr(_ops, name) for name in dir(_ops)}
    table.update({name: getattr(_nd, name) for name in _FROM_ND})
    for name in sorted(table):
        fn = table[name]
        if name.startswith("_") or name in _SKIP or not callable(fn) \
                or _inspect.isclass(fn):
            continue
        register_sym_op(name, fn)
        g.setdefault(name, _symbol_mod._symbolic_stub(
            name, fn, _inspect.signature(fn)))
        __all__.append(name)
    for alias, target in {"SliceChannel": "split", "Flatten": "flatten",
                          "Concat": "concat", "Cast": "cast",
                          "Reshape": "reshape"}.items():
        fn = getattr(_ops, target)
        register_sym_op(alias, fn)
        g[alias] = _symbol_mod._symbolic_stub(alias, fn,
                                              _inspect.signature(fn))
        __all__.append(alias)


_autogen()

zeros = globals().get("zeros")
ones = globals().get("ones")


class _ContribNS:
    """``mx.sym.contrib.*``: stubs over ``nd.contrib``."""


def _autogen_contrib():
    from ..ndarray import contrib as _nd_contrib
    ns = _ContribNS()
    for name in _nd_contrib.__all__:
        fn = getattr(_nd_contrib, name)
        register_sym_op(name, fn)
        setattr(ns, name, _symbol_mod._symbolic_stub(
            name, fn, _inspect.signature(fn)))
    return ns


contrib = _autogen_contrib()
__all__.append("contrib")
