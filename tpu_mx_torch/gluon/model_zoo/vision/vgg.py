"""VGG 11/13/16/19 and their BatchNorm variants, from
``tpu_mx/gluon/model_zoo/vision/vgg.py``."""
from __future__ import annotations

from ... import nn
from ._zoo import ZooNet, building, refuse_pretrained

__all__ = ["VGG", "vgg11", "vgg13", "vgg16", "vgg19", "vgg11_bn", "vgg13_bn",
           "vgg16_bn", "vgg19_bn", "get_vgg"]

vgg_spec = {
    11: ([1, 1, 2, 2, 2], [64, 128, 256, 512, 512]),
    13: ([2, 2, 2, 2, 2], [64, 128, 256, 512, 512]),
    16: ([2, 2, 3, 3, 3], [64, 128, 256, 512, 512]),
    19: ([2, 2, 4, 4, 4], [64, 128, 256, 512, 512]),
}


class VGG(ZooNet):
    """``layers[i]`` 3x3 convolutions of ``filters[i]`` channels (each
    with a BatchNorm when ``batch_norm``) and a 2x2 max pool per stage,
    then two 4096-wide dense layers with dropout 0.5."""

    def __init__(self, layers, filters, classes=1000, batch_norm=False,
                 dtype="float32", device=None, prefix=None, params=None):
        super().__init__(prefix, params)
        with building(device):
            self.features = nn.HybridSequential()
            for i, num in enumerate(layers):
                for _ in range(num):
                    self.features.add(nn.Conv2D(filters[i], 3, padding=1))
                    if batch_norm:
                        self.features.add(nn.BatchNorm())
                    self.features.add(nn.Activation("relu"))
                self.features.add(nn.MaxPool2D(2, 2))
            self.features.add(nn.Flatten())
            self.features.add(nn.Dense(4096, activation="relu"))
            self.features.add(nn.Dropout(0.5))
            self.features.add(nn.Dense(4096, activation="relu"))
            self.features.add(nn.Dropout(0.5))
            self.output = nn.Dense(classes)
        self._finish(dtype)


def get_vgg(num_layers, pretrained=False, ctx=None, **kwargs):
    """VGG of ``num_layers`` (11, 13, 16 or 19) layers; ``ctx`` is where
    it lives (``device=``)."""
    refuse_pretrained(f"vgg{num_layers}", pretrained)
    if ctx is not None:
        kwargs["device"] = ctx
    layers, filters = vgg_spec[num_layers]
    return VGG(layers, filters, **kwargs)


def vgg11(**kwargs):
    return get_vgg(11, **kwargs)


def vgg13(**kwargs):
    return get_vgg(13, **kwargs)


def vgg16(**kwargs):
    return get_vgg(16, **kwargs)


def vgg19(**kwargs):
    return get_vgg(19, **kwargs)


def vgg11_bn(**kwargs):
    return get_vgg(11, batch_norm=True, **kwargs)


def vgg13_bn(**kwargs):
    return get_vgg(13, batch_norm=True, **kwargs)


def vgg16_bn(**kwargs):
    return get_vgg(16, batch_norm=True, **kwargs)


def vgg19_bn(**kwargs):
    return get_vgg(19, batch_norm=True, **kwargs)
