"""Attention dispatch, the train step, and the mesh layer at world size 1.

- :mod:`.ring_attention` — ``attention`` / ``local_flash_attention``:
  the flash kernels on the card, the dense plain version on the CPU;
- :mod:`.train_step` — ``CompiledTrainStep`` on one device, eager, with
  the reference's rules, checkpoint and fingerprint;
- :mod:`.mesh` — ``make_mesh``/``P`` over one device;
- :mod:`.moe` — ``MoEFFN`` and its routing;
- :mod:`.integrity` — the state fingerprints;
- :mod:`.fleet` / :mod:`.fleet_obs` — elastic fleet membership (the
  file store, ``Fleet``, ``MembershipChange``, ``reshard_live``) and its
  cross-rank observability.

Ring/Ulysses sequence parallelism, pipelines and every mesh of more than
one device are not ported yet (ROADMAP A item 9).
"""
from .fleet import Fleet, MembershipChange, reshard_live
from .mesh import Mesh, NamedSharding, P, hybrid_mesh, local_mesh, make_mesh
from .moe import MoEFFN, moe_sharding_rules
from .ring_attention import attention, dispatch_counts, local_flash_attention
from .train_step import (CompiledTrainStep, apply_rules, fsdp_rules,
                         sharding_for)

__all__ = ["attention", "local_flash_attention", "dispatch_counts",
           "CompiledTrainStep", "apply_rules", "fsdp_rules", "sharding_for",
           "Mesh", "NamedSharding", "P", "make_mesh", "local_mesh",
           "hybrid_mesh", "MoEFFN", "moe_sharding_rules", "Fleet",
           "MembershipChange", "reshard_live"]
