"""SqueezeNet 1.0 and 1.1, from
``tpu_mx/gluon/model_zoo/vision/squeezenet.py``."""
from __future__ import annotations

from .... import layout as _layout
from ....ndarray import ops
from ... import nn
from ...block import HybridBlock
from ._zoo import ZooNet, building, refuse_pretrained

__all__ = ["SqueezeNet", "squeezenet1_0", "squeezenet1_1"]


class _Expand(HybridBlock):
    """A fire module's 1x1 and 3x3 expansions, concatenated on the
    channel axis of the layout it was built under."""

    def __init__(self, expand1x1_channels, expand3x3_channels):
        super().__init__()
        self.e1 = nn.Conv2D(expand1x1_channels, 1, activation="relu")
        self.e3 = nn.Conv2D(expand3x3_channels, 3, padding=1,
                            activation="relu")
        self._caxis = _layout.channel_axis()

    def forward(self, x):
        return ops.concat(self.e1(x), self.e3(x), dim=self._caxis)


def _make_fire(squeeze_channels, expand1x1_channels, expand3x3_channels):
    out = nn.HybridSequential()
    out.add(nn.Conv2D(squeeze_channels, 1, activation="relu"))
    out.add(_Expand(expand1x1_channels, expand3x3_channels))
    return out


class SqueezeNet(ZooNet):
    """SqueezeNet ``version`` "1.0" or "1.1": fire modules between
    ceil-mode max pools, dropout 0.5, and a 1x1 convolution to
    ``classes`` (relu) averaged over the positions."""

    def __init__(self, version, classes=1000, dtype="float32", device=None,
                 prefix=None, params=None):
        super().__init__(prefix, params)
        if version not in ("1.0", "1.1"):
            raise ValueError(f"SqueezeNet: no version {version!r}")
        with building(device):
            f = self.features = nn.HybridSequential()
            if version == "1.0":
                f.add(nn.Conv2D(96, 7, 2, activation="relu"))
                f.add(nn.MaxPool2D(3, 2, ceil_mode=True))
                f.add(_make_fire(16, 64, 64))
                f.add(_make_fire(16, 64, 64))
                f.add(_make_fire(32, 128, 128))
                f.add(nn.MaxPool2D(3, 2, ceil_mode=True))
                f.add(_make_fire(32, 128, 128))
                f.add(_make_fire(48, 192, 192))
                f.add(_make_fire(48, 192, 192))
                f.add(_make_fire(64, 256, 256))
                f.add(nn.MaxPool2D(3, 2, ceil_mode=True))
                f.add(_make_fire(64, 256, 256))
            else:
                f.add(nn.Conv2D(64, 3, 2, activation="relu"))
                f.add(nn.MaxPool2D(3, 2, ceil_mode=True))
                f.add(_make_fire(16, 64, 64))
                f.add(_make_fire(16, 64, 64))
                f.add(nn.MaxPool2D(3, 2, ceil_mode=True))
                f.add(_make_fire(32, 128, 128))
                f.add(_make_fire(32, 128, 128))
                f.add(nn.MaxPool2D(3, 2, ceil_mode=True))
                f.add(_make_fire(48, 192, 192))
                f.add(_make_fire(48, 192, 192))
                f.add(_make_fire(64, 256, 256))
                f.add(_make_fire(64, 256, 256))
            f.add(nn.Dropout(0.5))
            self.output = nn.HybridSequential()
            self.output.add(nn.Conv2D(classes, 1, activation="relu"))
            self.output.add(nn.GlobalAvgPool2D())
            self.output.add(nn.Flatten())
        self._finish(dtype)


def squeezenet1_0(**kwargs):
    refuse_pretrained("squeezenet1_0", kwargs.pop("pretrained", False))
    return SqueezeNet("1.0", **kwargs)


def squeezenet1_1(**kwargs):
    refuse_pretrained("squeezenet1_1", kwargs.pop("pretrained", False))
    return SqueezeNet("1.1", **kwargs)
