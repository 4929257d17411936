"""MobileNet v1 and v2, from ``tpu_mx/gluon/model_zoo/vision/mobilenet.py``:
depthwise convolutions are ``Conv2D(groups=channels)`` (cuDNN's grouped
convolution on the card)."""
from __future__ import annotations

from ... import nn
from ...block import HybridBlock
from ._zoo import ZooNet, building, refuse_pretrained

__all__ = ["MobileNet", "MobileNetV2", "mobilenet1_0", "mobilenet0_75",
           "mobilenet0_5", "mobilenet0_25", "mobilenet_v2_1_0",
           "mobilenet_v2_0_75", "mobilenet_v2_0_25", "mobilenet_v2_0_5"]


def _relu6(F, x):
    return F.clip(x, 0, 6)


def _relu(F, x):
    return F.relu(x)


def _add_conv(out, channels, kernel=1, stride=1, pad=0, num_group=1,
              active=True, relu6=False):
    out.add(nn.Conv2D(channels, kernel, stride, pad, groups=num_group,
                      use_bias=False))
    out.add(nn.BatchNorm())
    if active:
        out.add(nn.HybridLambda(_relu6 if relu6 else _relu))


class LinearBottleneck(HybridBlock):
    """MobileNet v2's inverted residual: a 1x1 expansion by ``t``
    (ReLU6), a 3x3 depthwise convolution (ReLU6), a linear 1x1
    projection, and the shortcut where the shapes allow."""

    def __init__(self, in_channels, channels, t, stride, prefix=None,
                 params=None):
        super().__init__(prefix, params)
        self.use_shortcut = stride == 1 and in_channels == channels
        self.out = nn.HybridSequential()
        if t != 1:
            _add_conv(self.out, in_channels * t, relu6=True)
        _add_conv(self.out, in_channels * t, kernel=3, stride=stride, pad=1,
                  num_group=in_channels * t, relu6=True)
        _add_conv(self.out, channels, active=False)

    def forward(self, x):
        out = self.out(x)
        return x + out if self.use_shortcut else out


class MobileNet(ZooNet):
    """MobileNet v1 at width ``multiplier``: depthwise-separable
    convolutions, global average pooling, a dense classifier."""

    def __init__(self, multiplier=1.0, classes=1000, dtype="float32",
                 device=None, prefix=None, params=None):
        super().__init__(prefix, params)
        with building(device):
            self.features = nn.HybridSequential()
            _add_conv(self.features, int(32 * multiplier), 3, 2, 1)
            dw_channels = [int(x * multiplier) for x in
                           [32, 64] + [128] * 2 + [256] * 2 + [512] * 6
                           + [1024]]
            channels = [int(x * multiplier) for x in
                        [64] + [128] * 2 + [256] * 2 + [512] * 6
                        + [1024] * 2]
            strides = [1, 2, 1, 2, 1, 2] + [1] * 5 + [2, 1]
            for dwc, c, s in zip(dw_channels, channels, strides):
                _add_conv(self.features, dwc, 3, s, 1, num_group=dwc)
                _add_conv(self.features, c)
            self.features.add(nn.GlobalAvgPool2D())
            self.features.add(nn.Flatten())
            self.output = nn.Dense(classes)
        self._finish(dtype)


class MobileNetV2(ZooNet):
    """MobileNet v2 at width ``multiplier``: 17 inverted residuals, a
    1x1 convolution to 1280 (ReLU6), global average pooling and a 1x1
    convolution to ``classes``."""

    def __init__(self, multiplier=1.0, classes=1000, dtype="float32",
                 device=None, prefix=None, params=None):
        super().__init__(prefix, params)
        with building(device):
            self.features = nn.HybridSequential()
            _add_conv(self.features, int(32 * multiplier), 3, 2, 1,
                      relu6=True)
            in_c = [int(multiplier * x) for x in
                    [32] + [16] + [24] * 2 + [32] * 3 + [64] * 4 + [96] * 3
                    + [160] * 3]
            channels = [int(multiplier * x) for x in
                        [16] + [24] * 2 + [32] * 3 + [64] * 4 + [96] * 3
                        + [160] * 3 + [320]]
            ts = [1] + [6] * 16
            strides = [1, 2, 1, 2, 1, 1, 2, 1, 1, 1, 1, 1, 1, 2, 1, 1, 1]
            for ic, c, t, s in zip(in_c, channels, ts, strides):
                self.features.add(LinearBottleneck(ic, c, t, s))
            last = int(1280 * multiplier) if multiplier > 1.0 else 1280
            _add_conv(self.features, last, relu6=True)
            self.features.add(nn.GlobalAvgPool2D())
            self.output = nn.HybridSequential()
            self.output.add(nn.Conv2D(classes, 1, use_bias=False))
            self.output.add(nn.Flatten())
        self._finish(dtype)


def _factory(cls, multiplier, name):
    def make(**kwargs):
        refuse_pretrained(name, kwargs.pop("pretrained", False))
        return cls(multiplier, **kwargs)
    make.__name__ = make.__qualname__ = name
    make.__doc__ = f":class:`{cls.__name__}` at width {multiplier}."
    return make


mobilenet1_0 = _factory(MobileNet, 1.0, "mobilenet1_0")
mobilenet0_75 = _factory(MobileNet, 0.75, "mobilenet0_75")
mobilenet0_5 = _factory(MobileNet, 0.5, "mobilenet0_5")
mobilenet0_25 = _factory(MobileNet, 0.25, "mobilenet0_25")
mobilenet_v2_1_0 = _factory(MobileNetV2, 1.0, "mobilenet_v2_1_0")
mobilenet_v2_0_75 = _factory(MobileNetV2, 0.75, "mobilenet_v2_0_75")
mobilenet_v2_0_5 = _factory(MobileNetV2, 0.5, "mobilenet_v2_0_5")
mobilenet_v2_0_25 = _factory(MobileNetV2, 0.25, "mobilenet_v2_0_25")
