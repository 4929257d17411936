"""Optimizers (:mod:`.optimizer`: the base, the registry, the
optimizers and the ``Updater``) and learning-rate schedulers
(:mod:`.lr_scheduler`)."""
from . import lr_scheduler
from .lr_scheduler import (CosineScheduler, FactorScheduler, LRScheduler,
                           MultiFactorScheduler, PolyScheduler)
from .optimizer import (DCASGD, FTML, LAMB, LBSGD, NAG, SGD, SGLD, AdaDelta,
                        AdaGrad, Adam, Adamax, AdamW, Ftrl, Nadam, Optimizer,
                        RMSProp, Signum, Updater, create, get_updater,
                        register, registry)

__all__ = ["Optimizer", "SGD", "LBSGD", "NAG", "Adam", "AdamW", "RMSProp",
           "AdaGrad", "AdaDelta", "Ftrl", "Signum", "LAMB", "DCASGD", "SGLD",
           "Adamax", "Nadam", "FTML", "Updater", "create", "get_updater",
           "register", "registry", "lr_scheduler", "LRScheduler",
           "FactorScheduler", "MultiFactorScheduler", "PolyScheduler",
           "CosineScheduler"]
