"""Basic layers (:mod:`.basic_layers`)."""
from .basic_layers import Dense, Dropout, LayerNorm, make_param

__all__ = ["Dense", "Dropout", "LayerNorm", "make_param"]
