"""``mx.contrib.amp``: automatic mixed precision (:mod:`.amp`, with the
cast lists of :mod:`.lists`)."""
from . import lists
from .amp import (LossScaler, convert_model, init, init_trainer, scale_loss,
                  unscale)
