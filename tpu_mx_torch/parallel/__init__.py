"""Attention dispatch and the train step, mesh-less.

- :mod:`.ring_attention` — ``attention`` / ``local_flash_attention``:
  the flash kernels on the card, the dense plain version on the CPU;
- :mod:`.train_step` — ``CompiledTrainStep`` on one device, eager.

Meshes, sharding rules, ring/Ulysses sequence parallelism and the rest
of ``tpu_mx/parallel`` are not ported yet (ROADMAP A16).
"""
from .ring_attention import attention, dispatch_counts, local_flash_attention
from .train_step import CompiledTrainStep

__all__ = ["attention", "local_flash_attention", "dispatch_counts",
           "CompiledTrainStep"]
