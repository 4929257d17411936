"""The model zoo: :mod:`.vision` (ResNet, AlexNet, VGG, SqueezeNet,
MobileNet v1/v2, DenseNet, Inception v3 and ``get_model``)."""
from . import vision

__all__ = ["vision"]
