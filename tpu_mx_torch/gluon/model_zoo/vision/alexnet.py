"""AlexNet, from ``tpu_mx/gluon/model_zoo/vision/alexnet.py``."""
from __future__ import annotations

from ... import nn
from ._zoo import ZooNet, building, refuse_pretrained

__all__ = ["AlexNet", "alexnet"]


class AlexNet(ZooNet):
    """Five convolutions (relu), three max pools, two 4096-wide dense
    layers with dropout 0.5, then ``classes`` logits."""

    def __init__(self, classes=1000, dtype="float32", device=None,
                 prefix=None, params=None):
        super().__init__(prefix, params)
        with building(device):
            self.features = nn.HybridSequential()
            self.features.add(nn.Conv2D(64, 11, 4, 2, activation="relu"))
            self.features.add(nn.MaxPool2D(3, 2))
            self.features.add(nn.Conv2D(192, 5, padding=2,
                                        activation="relu"))
            self.features.add(nn.MaxPool2D(3, 2))
            self.features.add(nn.Conv2D(384, 3, padding=1,
                                        activation="relu"))
            self.features.add(nn.Conv2D(256, 3, padding=1,
                                        activation="relu"))
            self.features.add(nn.Conv2D(256, 3, padding=1,
                                        activation="relu"))
            self.features.add(nn.MaxPool2D(3, 2))
            self.features.add(nn.Flatten())
            self.features.add(nn.Dense(4096, activation="relu"))
            self.features.add(nn.Dropout(0.5))
            self.features.add(nn.Dense(4096, activation="relu"))
            self.features.add(nn.Dropout(0.5))
            self.output = nn.Dense(classes)
        self._finish(dtype)


def alexnet(pretrained=False, ctx=None, **kwargs):
    """:class:`AlexNet`; ``ctx`` is where it lives (``device=``)."""
    refuse_pretrained("alexnet", pretrained)
    if ctx is not None:
        kwargs["device"] = ctx
    return AlexNet(**kwargs)
