"""Vision models of ``gluon/model_zoo/vision``: ResNet v1/v2
(:mod:`.resnet`).  AlexNet, VGG, MobileNet, SqueezeNet, DenseNet and
Inception are not ported yet (ROADMAP)."""
from . import resnet
from .resnet import *  # noqa: F401,F403
from .resnet import __all__ as _resnet_all

__all__ = ["resnet"] + list(_resnet_all)
