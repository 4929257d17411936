"""``mx.contrib.tensorrt``, from ``tpu_mx/contrib/tensorrt.py``: every
entry point raises :class:`MXNetError`, as the reference's do.  TensorRT
is not installed on the card's machine, and the port's deployment
artifact is ``HybridBlock.export``'s ``.pt2`` program, which
``SymbolBlock.imports`` runs."""
from ..base import MXNetError

__all__ = ["init_tensorrt_params", "optimize_graph", "get_optimized_symbol"]

_MSG = ("TensorRT is not available to the port (it is not installed on "
        "the card's machine); export the model with HybridBlock.export() "
        "(a .pt2 program) and load it with SymbolBlock.imports")


def init_tensorrt_params(*a, **k):
    raise MXNetError(_MSG)


def optimize_graph(*a, **k):
    raise MXNetError(_MSG)


def get_optimized_symbol(*a, **k):
    raise MXNetError(_MSG)
