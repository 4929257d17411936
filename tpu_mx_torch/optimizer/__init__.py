"""Optimizers (:mod:`.optimizer`): the base, the registry and LAMB."""
from .optimizer import LAMB, Optimizer, create, register, registry

__all__ = ["Optimizer", "LAMB", "create", "register", "registry"]
