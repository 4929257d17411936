"""Basic layers (:mod:`.basic_layers`) and the convolution and pooling
layers (:mod:`.conv_layers`)."""
from .basic_layers import *  # noqa: F401,F403
from .basic_layers import __all__ as _basic
from .conv_layers import *  # noqa: F401,F403
from .conv_layers import __all__ as _conv

__all__ = list(_basic) + list(_conv)
