"""Optimizers (:mod:`.optimizer`): the base, the registry, SGD and LAMB."""
from .optimizer import LAMB, SGD, Optimizer, create, register, registry

__all__ = ["Optimizer", "SGD", "LAMB", "create", "register", "registry"]
