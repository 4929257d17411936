"""ResNet v1/v2, from ``tpu_mx/gluon/model_zoo/vision/resnet.py``.

The same architectures (18/34/50/101/152, BasicBlock/Bottleneck, v1
post-activation and v2 pre-activation, the classic 7x7 and the
space-to-depth stems) with the reference's parameter names, shapes and
structural order (``features``'s children ``"0"``, ``"1"``, ...), so
:meth:`ResNetV1.from_numpy` carries the reference's ``collect_params()``
over one to one.  Build a channels-last net inside
``layout.default_layout("NHWC")``: it then takes ``(N, H, W, C)``
images and its convolutions run on ``torch.channels_last`` tensors.

The stems take 3-channel images, as the reference's do.  Every layer's
parameters are drawn from the net's explicit ``torch.Generator`` in
``dtype`` on ``device``; :meth:`~tpu_mx_torch.gluon.block.HybridBlock.
initialize` draws them again (``"xavier"``), and
:meth:`~tpu_mx_torch.gluon.block.HybridBlock.cast` casts them, running
statistics included, as the reference's ``net.cast("bfloat16")`` does.
"""
from __future__ import annotations

import contextlib

import torch

from .... import device as _device
from .... import layout as _layout
from .... import random as _random
from ....base import MXNetError
from ....ndarray import ops
from ... import nn
from ...block import HybridBlock, as_dtype, load_numpy

__all__ = ["ResNetV1", "ResNetV2", "SpaceToDepthStem", "BasicBlockV1",
           "BasicBlockV2", "BottleneckV1", "BottleneckV2", "resnet18_v1",
           "resnet34_v1", "resnet50_v1", "resnet101_v1", "resnet152_v1",
           "resnet18_v2", "resnet34_v2", "resnet50_v2", "resnet101_v2",
           "resnet152_v2", "get_resnet"]


def _conv3x3(channels, stride, in_channels, kw):
    return nn.Conv2D(channels, kernel_size=3, strides=stride, padding=1,
                     use_bias=False, in_channels=in_channels, **kw)


class SpaceToDepthStem(HybridBlock):
    """A 4x4 space-to-depth of the image, then a 3x3 stride-1 conv,
    BatchNorm and relu: ``(N, 224, 224, 3)`` → ``(N, 56, 56, C0)``, the
    shape the classic 7x7/2 conv and 3x3/2 max pool give.  Select with
    ``get_resnet(..., stem="s2d")``."""

    def __init__(self, channels, block=4, dtype=torch.float32,
                 generator=None):
        super().__init__()
        kw = dict(dtype=dtype, generator=generator)
        self._block = block
        self._nhwc = _layout.is_channels_last(_layout.get_default_layout(2))
        self.conv = nn.Conv2D(channels, kernel_size=3, strides=1, padding=1,
                              use_bias=False, in_channels=3 * block * block,
                              **kw)
        self.bn = nn.BatchNorm(in_channels=channels, **kw)

    def forward(self, x):
        b = self._block
        if self._nhwc:
            n, h, w, c = x.shape
            x = x.reshape(n, h // b, b, w // b, b, c).permute(0, 1, 3, 2, 4, 5)
            x = x.reshape(n, h // b, w // b, b * b * c)
        else:
            x = ops.space_to_depth(x, b)
        return ops.Activation(self.bn(self.conv(x)), act_type="relu")


def _downsample_v1(channels, stride, in_channels, kw):
    ds = nn.HybridSequential()
    ds.add(nn.Conv2D(channels, kernel_size=1, strides=stride, use_bias=False,
                     in_channels=in_channels, **kw))
    ds.add(nn.BatchNorm(in_channels=channels, **kw))
    return ds


class BasicBlockV1(HybridBlock):
    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 dtype=torch.float32, generator=None):
        super().__init__()
        kw = dict(dtype=dtype, generator=generator)
        self.body = nn.HybridSequential()
        self.body.add(_conv3x3(channels, stride, in_channels, kw))
        self.body.add(nn.BatchNorm(in_channels=channels, **kw))
        self.body.add(nn.Activation("relu"))
        self.body.add(_conv3x3(channels, 1, channels, kw))
        self.body.add(nn.BatchNorm(in_channels=channels, **kw))
        self.downsample = _downsample_v1(channels, stride, in_channels, kw) \
            if downsample else None

    def forward(self, x):
        residual = x
        x = self.body(x)
        if self.downsample is not None:
            residual = self.downsample(residual)
        return ops.Activation(residual + x, act_type="relu")


class BottleneckV1(HybridBlock):
    """1x1 (stride), 3x3, 1x1; the two 1x1 convolutions of the body keep
    their bias, as in the reference (only the 3x3 and the downsample are
    ``use_bias=False``)."""

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 dtype=torch.float32, generator=None):
        super().__init__()
        kw = dict(dtype=dtype, generator=generator)
        self.body = nn.HybridSequential()
        self.body.add(nn.Conv2D(channels // 4, kernel_size=1, strides=stride,
                                in_channels=in_channels, **kw))
        self.body.add(nn.BatchNorm(in_channels=channels // 4, **kw))
        self.body.add(nn.Activation("relu"))
        self.body.add(_conv3x3(channels // 4, 1, channels // 4, kw))
        self.body.add(nn.BatchNorm(in_channels=channels // 4, **kw))
        self.body.add(nn.Activation("relu"))
        self.body.add(nn.Conv2D(channels, kernel_size=1, strides=1,
                                in_channels=channels // 4, **kw))
        self.body.add(nn.BatchNorm(in_channels=channels, **kw))
        self.downsample = _downsample_v1(channels, stride, in_channels, kw) \
            if downsample else None

    def forward(self, x):
        residual = x
        x = self.body(x)
        if self.downsample is not None:
            residual = self.downsample(residual)
        return ops.Activation(x + residual, act_type="relu")


class BasicBlockV2(HybridBlock):
    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 dtype=torch.float32, generator=None):
        super().__init__()
        kw = dict(dtype=dtype, generator=generator)
        self.bn1 = nn.BatchNorm(in_channels=in_channels, **kw)
        self.conv1 = _conv3x3(channels, stride, in_channels, kw)
        self.bn2 = nn.BatchNorm(in_channels=channels, **kw)
        self.conv2 = _conv3x3(channels, 1, channels, kw)
        self.downsample = nn.Conv2D(channels, 1, stride, use_bias=False,
                                    in_channels=in_channels, **kw) \
            if downsample else None

    def forward(self, x):
        residual = x
        x = ops.Activation(self.bn1(x), act_type="relu")
        if self.downsample is not None:
            residual = self.downsample(x)
        x = self.conv1(x)
        x = ops.Activation(self.bn2(x), act_type="relu")
        x = self.conv2(x)
        return x + residual


class BottleneckV2(HybridBlock):
    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 dtype=torch.float32, generator=None):
        super().__init__()
        kw = dict(dtype=dtype, generator=generator)
        self.bn1 = nn.BatchNorm(in_channels=in_channels, **kw)
        self.conv1 = nn.Conv2D(channels // 4, kernel_size=1, strides=1,
                               use_bias=False, in_channels=in_channels, **kw)
        self.bn2 = nn.BatchNorm(in_channels=channels // 4, **kw)
        self.conv2 = _conv3x3(channels // 4, stride, channels // 4, kw)
        self.bn3 = nn.BatchNorm(in_channels=channels // 4, **kw)
        self.conv3 = nn.Conv2D(channels, kernel_size=1, strides=1,
                               use_bias=False, in_channels=channels // 4,
                               **kw)
        self.downsample = nn.Conv2D(channels, 1, stride, use_bias=False,
                                    in_channels=in_channels, **kw) \
            if downsample else None

    def forward(self, x):
        residual = x
        x = ops.Activation(self.bn1(x), act_type="relu")
        if self.downsample is not None:
            residual = self.downsample(x)
        x = self.conv1(x)
        x = ops.Activation(self.bn2(x), act_type="relu")
        x = self.conv2(x)
        x = ops.Activation(self.bn3(x), act_type="relu")
        x = self.conv3(x)
        return x + residual


class _ResNet(HybridBlock):
    """What V1 and V2 share: the device and generator checks, the stem,
    the stages, ``forward`` and :meth:`from_numpy`."""

    def _checked(self, layers, channels, dtype, device, generator):
        """The layers' ``dtype``/``generator`` arguments, after checking
        the spec and that the generator lives on ``device``."""
        if len(layers) != len(channels) - 1:
            raise ValueError("ResNet: len(layers) must be len(channels) - 1")
        dev = _device.resolve(device)
        gen = _random.generator(dev) if generator is None else generator
        if gen.device.type != dev.type:
            raise MXNetError(f"{type(self).__name__}(device={str(device)!r}):"
                             f" the generator lives on {gen.device}")
        return dict(dtype=as_dtype(dtype), generator=gen)

    @staticmethod
    def _stem(features, channels0, thumbnail, stem, kw):
        if thumbnail:
            features.add(_conv3x3(channels0, 1, 3, kw))
        elif stem == "s2d":
            features.add(SpaceToDepthStem(channels0, **kw))
        else:
            features.add(nn.Conv2D(channels0, 7, 2, 3, use_bias=False,
                                   in_channels=3, **kw))
            features.add(nn.BatchNorm(in_channels=channels0, **kw))
            features.add(nn.Activation("relu"))
            features.add(nn.MaxPool2D(3, 2, 1))

    @staticmethod
    def _make_layer(block, layers, channels, stride, in_channels, kw):
        layer = nn.HybridSequential()
        layer.add(block(channels, stride, channels != in_channels,
                        in_channels=in_channels, **kw))
        for _ in range(layers - 1):
            layer.add(block(channels, 1, False, in_channels=channels, **kw))
        return layer

    def forward(self, x):
        return self.output(self.features(x))

    @classmethod
    def from_numpy(cls, params, *args, layout=None, dtype="float32",
                   device="cuda", generator=None, **kwargs):
        """The port's net computing the reference's function: built as
        ``cls(*args, **kwargs)`` (under ``default_layout(layout)`` when
        ``layout`` is given), then every parameter and running statistic
        set from ``params``, the reference's ``collect_params()`` as numpy
        arrays in its structural order (``gluon.block.load_numpy``:
        every array consumed once, names checked by suffix, channels-last
        conv weights ``(O, kh, kw, I)`` transposed)."""
        scope = _layout.default_layout(layout) if layout \
            else contextlib.nullcontext()
        with scope:
            net = cls(*args, dtype=dtype, device=device, generator=generator,
                      **kwargs)
        return load_numpy(net, params)


class ResNetV1(_ResNet):
    """ResNet v1 (post-activation).  ``forward(x)`` returns ``(N,
    classes)`` logits in the parameters' dtype."""

    def __init__(self, block, layers, channels, classes=1000, thumbnail=False,
                 stem="classic", dtype="float32", device="cuda",
                 generator=None):
        super().__init__()
        kw = self._checked(layers, channels, dtype, device, generator)
        self.features = nn.HybridSequential()
        self._stem(self.features, channels[0], thumbnail, stem, kw)
        for i, num_layer in enumerate(layers):
            stride = 1 if i == 0 else 2
            self.features.add(self._make_layer(block, num_layer,
                                               channels[i + 1], stride,
                                               channels[i], kw))
        self.features.add(nn.GlobalAvgPool2D())
        self.output = nn.Dense(classes, in_units=channels[-1], **kw)


class ResNetV2(_ResNet):
    """ResNet v2 (pre-activation), with the reference's input BatchNorm
    (no scale, no center)."""

    def __init__(self, block, layers, channels, classes=1000, thumbnail=False,
                 stem="classic", dtype="float32", device="cuda",
                 generator=None):
        super().__init__()
        kw = self._checked(layers, channels, dtype, device, generator)
        self.features = nn.HybridSequential()
        self.features.add(nn.BatchNorm(scale=False, center=False,
                                       in_channels=3, **kw))
        self._stem(self.features, channels[0], thumbnail, stem, kw)
        in_channels = channels[0]
        for i, num_layer in enumerate(layers):
            stride = 1 if i == 0 else 2
            self.features.add(self._make_layer(block, num_layer,
                                               channels[i + 1], stride,
                                               in_channels, kw))
            in_channels = channels[i + 1]
        self.features.add(nn.BatchNorm(in_channels=in_channels, **kw))
        self.features.add(nn.Activation("relu"))
        self.features.add(nn.GlobalAvgPool2D())
        self.features.add(nn.Flatten())
        self.output = nn.Dense(classes, in_units=in_channels, **kw)


resnet_spec = {
    18: ("basic_block", [2, 2, 2, 2], [64, 64, 128, 256, 512]),
    34: ("basic_block", [3, 4, 6, 3], [64, 64, 128, 256, 512]),
    50: ("bottle_neck", [3, 4, 6, 3], [64, 256, 512, 1024, 2048]),
    101: ("bottle_neck", [3, 4, 23, 3], [64, 256, 512, 1024, 2048]),
    152: ("bottle_neck", [3, 8, 36, 3], [64, 256, 512, 1024, 2048]),
}
resnet_net_versions = [ResNetV1, ResNetV2]
resnet_block_versions = [
    {"basic_block": BasicBlockV1, "bottle_neck": BottleneckV1},
    {"basic_block": BasicBlockV2, "bottle_neck": BottleneckV2},
]


def get_resnet(version, num_layers, pretrained=False, ctx=None, **kwargs):
    """``ResNetV{version}`` of ``num_layers`` layers; ``ctx`` (a
    :class:`~tpu_mx_torch.context.Context`) is where it lives, in place
    of ``device=`` (default: the card)."""
    if num_layers not in resnet_spec or version not in (1, 2):
        raise ValueError(f"get_resnet: no ResNet v{version} with "
                         f"{num_layers} layers (have {sorted(resnet_spec)})")
    if pretrained:
        raise MXNetError("get_resnet: no pretrained weights (nothing is "
                         "downloaded)")
    if ctx is not None:
        kwargs["device"] = ctx
    block_type, layers, channels = resnet_spec[num_layers]
    net_class = resnet_net_versions[version - 1]
    block_class = resnet_block_versions[version - 1][block_type]
    return net_class(block_class, layers, channels, **kwargs)


def resnet18_v1(**kwargs):
    return get_resnet(1, 18, **kwargs)


def resnet34_v1(**kwargs):
    return get_resnet(1, 34, **kwargs)


def resnet50_v1(**kwargs):
    return get_resnet(1, 50, **kwargs)


def resnet101_v1(**kwargs):
    return get_resnet(1, 101, **kwargs)


def resnet152_v1(**kwargs):
    return get_resnet(1, 152, **kwargs)


def resnet18_v2(**kwargs):
    return get_resnet(2, 18, **kwargs)


def resnet34_v2(**kwargs):
    return get_resnet(2, 34, **kwargs)


def resnet50_v2(**kwargs):
    return get_resnet(2, 50, **kwargs)


def resnet101_v2(**kwargs):
    return get_resnet(2, 101, **kwargs)


def resnet152_v2(**kwargs):
    return get_resnet(2, 152, **kwargs)
