"""DenseNet 121/161/169/201, from
``tpu_mx/gluon/model_zoo/vision/densenet.py``."""
from __future__ import annotations

from .... import layout as _layout
from ....ndarray import ops
from ... import nn
from ...block import HybridBlock
from ._zoo import ZooNet, building, refuse_pretrained

__all__ = ["DenseNet", "densenet121", "densenet161", "densenet169",
           "densenet201"]


class _DenseLayer(HybridBlock):
    """BN-relu-1x1 (``bn_size·growth_rate``), BN-relu-3x3
    (``growth_rate``), concatenated after its input on the channel
    axis."""

    def __init__(self, growth_rate, bn_size, dropout):
        super().__init__()
        self.body = nn.HybridSequential()
        self.body.add(nn.BatchNorm())
        self.body.add(nn.Activation("relu"))
        self.body.add(nn.Conv2D(bn_size * growth_rate, 1, use_bias=False))
        self.body.add(nn.BatchNorm())
        self.body.add(nn.Activation("relu"))
        self.body.add(nn.Conv2D(growth_rate, 3, padding=1, use_bias=False))
        if dropout:
            self.body.add(nn.Dropout(dropout))
        self._caxis = _layout.channel_axis()

    def forward(self, x):
        return ops.concat(x, self.body(x), dim=self._caxis)


def _make_transition(num_output_features):
    out = nn.HybridSequential()
    out.add(nn.BatchNorm())
    out.add(nn.Activation("relu"))
    out.add(nn.Conv2D(num_output_features, 1, use_bias=False))
    out.add(nn.AvgPool2D(2, 2))
    return out


densenet_spec = {
    121: (64, 32, [6, 12, 24, 16]),
    161: (96, 48, [6, 12, 36, 24]),
    169: (64, 32, [6, 12, 32, 32]),
    201: (64, 32, [6, 12, 48, 32]),
}


class DenseNet(ZooNet):
    """A 7x7 stem, dense blocks of ``block_config[i]`` layers with
    halving transitions between them, BN-relu, global average pooling
    and a dense classifier."""

    def __init__(self, num_init_features, growth_rate, block_config,
                 bn_size=4, dropout=0, classes=1000, dtype="float32",
                 device=None, prefix=None, params=None):
        super().__init__(prefix, params)
        with building(device):
            f = self.features = nn.HybridSequential()
            f.add(nn.Conv2D(num_init_features, 7, 2, 3, use_bias=False))
            f.add(nn.BatchNorm())
            f.add(nn.Activation("relu"))
            f.add(nn.MaxPool2D(3, 2, 1))
            num_features = num_init_features
            for i, num_layers in enumerate(block_config):
                block = nn.HybridSequential()
                for _ in range(num_layers):
                    block.add(_DenseLayer(growth_rate, bn_size, dropout))
                f.add(block)
                num_features += num_layers * growth_rate
                if i != len(block_config) - 1:
                    num_features //= 2
                    f.add(_make_transition(num_features))
            f.add(nn.BatchNorm())
            f.add(nn.Activation("relu"))
            f.add(nn.GlobalAvgPool2D())
            f.add(nn.Flatten())
            self.output = nn.Dense(classes)
        self._finish(dtype)


def _get(num_layers, **kwargs):
    refuse_pretrained(f"densenet{num_layers}",
                      kwargs.pop("pretrained", False))
    init_f, growth, config = densenet_spec[num_layers]
    return DenseNet(init_f, growth, config, **kwargs)


def densenet121(**kwargs):
    return _get(121, **kwargs)


def densenet161(**kwargs):
    return _get(161, **kwargs)


def densenet169(**kwargs):
    return _get(169, **kwargs)


def densenet201(**kwargs):
    return _get(201, **kwargs)
