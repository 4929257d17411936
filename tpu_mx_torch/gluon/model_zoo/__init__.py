"""The model zoo: :mod:`.vision` (ResNet v1/v2 so far)."""
from . import vision

__all__ = ["vision"]
