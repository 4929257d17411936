"""``mx.contrib``: the contributed planes, as ``tpu_mx/contrib`` has them:
:mod:`.compression` (the gradient quantizers), :mod:`.amp` (automatic
mixed precision), :mod:`.quantization` (int8 inference), :mod:`.text`
(vocabularies and embeddings), :mod:`.onnx` (ONNX export and import),
:mod:`.tensorrt` (refused, as in the reference) and :mod:`.chaos`
(fault injection)."""
from . import compression
from . import amp
from . import quantization
from . import text
from . import onnx
from . import tensorrt
from . import chaos
