"""Hand-written CUDA kernels of the port, each beside its plain PyTorch twin.

- :mod:`.flash_attention` — flash-attention forward (prefill);
- :mod:`.paged_attention` — paged-attention decode.

Sources live in ``tpu_mx_torch/csrc`` and are built at first use
(:mod:`._build`).  As in the reference package, the submodules are the
package's attributes and the functions carry an ``_fn`` suffix here.
"""
from . import flash_attention
from . import paged_attention
from .flash_attention import flash_attention as flash_attention_fn
from .paged_attention import paged_attention as paged_attention_fn
