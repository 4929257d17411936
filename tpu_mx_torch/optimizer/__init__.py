"""Optimizers (:mod:`.optimizer`): the base, the registry, SGD, Adam,
LAMB and the ``Updater``."""
from .optimizer import (LAMB, SGD, Adam, Optimizer, Updater, create,
                        get_updater, register, registry)

__all__ = ["Optimizer", "SGD", "Adam", "LAMB", "Updater", "create",
           "get_updater", "register", "registry"]
