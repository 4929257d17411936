"""Attention dispatch, the train step and the mesh layer over
``torch.distributed``.

- :mod:`.ring_attention` — ``attention`` / ``local_flash_attention`` (the
  flash kernels on the card, the dense plain version on the CPU) and
  ``ring_attention``; :mod:`.ulysses` — ``ulysses_attention`` and the
  ``sp`` strategy switch;
- :mod:`.pipeline` — GPipe over a ``pp`` axis;
- :mod:`.train_step` — ``CompiledTrainStep``, eager, with the
  reference's rules, checkpoint and fingerprint, on one device or over a
  mesh of ranks;
- :mod:`.mesh` — ``make_mesh``/``P`` over the process group's ranks;
  :mod:`.collectives` — the differentiable collectives over its axes;
- :mod:`.moe` — ``MoEFFN`` and its routing;
- :mod:`.integrity` — the state fingerprints;
- :mod:`.fleet` / :mod:`.fleet_obs` — elastic fleet membership (the
  file store, ``Fleet``, ``MembershipChange``, ``reshard_live``) and its
  cross-rank observability.
"""
from .fleet import Fleet, MembershipChange, reshard_live
from .mesh import Mesh, NamedSharding, P, hybrid_mesh, local_mesh, make_mesh
from .moe import MoEFFN, moe_sharding_rules
from .pipeline import pipeline_apply, stack_stage_params
from .ring_attention import (attention, dispatch_counts,
                             local_flash_attention, ring_attention)
from .ulysses import get_sp_strategy, set_sp_strategy, ulysses_attention
from .train_step import (CompiledTrainStep, apply_rules, fsdp_rules,
                         sharding_for)

__all__ = ["attention", "local_flash_attention", "ring_attention",
           "ulysses_attention", "set_sp_strategy", "get_sp_strategy",
           "pipeline_apply", "stack_stage_params", "dispatch_counts",
           "CompiledTrainStep", "apply_rules", "fsdp_rules", "sharding_for",
           "Mesh", "NamedSharding", "P", "make_mesh", "local_mesh",
           "hybrid_mesh", "MoEFFN", "moe_sharding_rules", "Fleet",
           "MembershipChange", "reshard_live"]
