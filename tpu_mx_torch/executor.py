"""``mx.executor``: the :class:`Executor` that ``Symbol.bind`` and
``simple_bind`` return, in a module of its own as in the reference
(``from mxnet.executor import Executor``)."""
from .symbol.symbol import Executor

__all__ = ["Executor"]
