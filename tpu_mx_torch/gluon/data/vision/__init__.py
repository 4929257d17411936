"""``gluon.data.vision``: the vision datasets and transforms."""
from .datasets import *  # noqa: F401,F403
from . import transforms
