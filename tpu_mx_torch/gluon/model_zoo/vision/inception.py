"""Inception v3, from ``tpu_mx/gluon/model_zoo/vision/inception.py``
(Szegedy et al. 2015): 299x299 input (75x75 the least it takes), the
reference's channel plan for the A, B, C, D and E blocks."""
from __future__ import annotations

from .... import layout as _layout
from ....ndarray import ops
from ... import nn
from ...block import HybridBlock
from ._zoo import ZooNet, building, refuse_pretrained

__all__ = ["Inception3", "inception_v3"]


def _conv(channels, kernel, stride=1, padding=0):
    out = nn.HybridSequential()
    out.add(nn.Conv2D(channels, kernel, stride, padding, use_bias=False))
    out.add(nn.BatchNorm(epsilon=0.001))
    out.add(nn.Activation("relu"))
    return out


def _seq(*blocks):
    out = nn.HybridSequential()
    for b in blocks:
        out.add(b)
    return out


class _Branches(HybridBlock):
    """Parallel branches (children ``b0``, ``b1``, ...) concatenated on
    the channel axis."""

    def __init__(self, branches):
        super().__init__()
        self.branches = []
        for i, b in enumerate(branches):
            setattr(self, f"b{i}", b)
            self.branches.append(b)
        self._caxis = _layout.channel_axis()

    def forward(self, x):
        return ops.concat(*[b(x) for b in self.branches], dim=self._caxis)


def _make_A(pool_features):
    return _Branches([
        _conv(64, 1),
        _seq(_conv(48, 1), _conv(64, 5, padding=2)),
        _seq(_conv(64, 1), _conv(96, 3, padding=1), _conv(96, 3, padding=1)),
        _seq(nn.AvgPool2D(3, 1, 1), _conv(pool_features, 1)),
    ])


def _make_B():
    return _Branches([
        _conv(384, 3, 2),
        _seq(_conv(64, 1), _conv(96, 3, padding=1), _conv(96, 3, 2)),
        _seq(nn.MaxPool2D(3, 2)),
    ])


def _make_C(channels_7x7):
    c = channels_7x7
    return _Branches([
        _conv(192, 1),
        _seq(_conv(c, 1), _conv(c, (1, 7), padding=(0, 3)),
             _conv(192, (7, 1), padding=(3, 0))),
        _seq(_conv(c, 1), _conv(c, (7, 1), padding=(3, 0)),
             _conv(c, (1, 7), padding=(0, 3)),
             _conv(c, (7, 1), padding=(3, 0)),
             _conv(192, (1, 7), padding=(0, 3))),
        _seq(nn.AvgPool2D(3, 1, 1), _conv(192, 1)),
    ])


def _make_D():
    return _Branches([
        _seq(_conv(192, 1), _conv(320, 3, 2)),
        _seq(_conv(192, 1), _conv(192, (1, 7), padding=(0, 3)),
             _conv(192, (7, 1), padding=(3, 0)), _conv(192, 3, 2)),
        _seq(nn.MaxPool2D(3, 2)),
    ])


class _MixedE(HybridBlock):
    """Mixed 7a/7b: branches whose stems fan out again."""

    def __init__(self):
        super().__init__()
        self.b0 = _conv(320, 1)
        self.b1_stem = _conv(384, 1)
        self.b1a = _conv(384, (1, 3), padding=(0, 1))
        self.b1b = _conv(384, (3, 1), padding=(1, 0))
        self.b2_stem = _seq(_conv(448, 1), _conv(384, 3, padding=1))
        self.b2a = _conv(384, (1, 3), padding=(0, 1))
        self.b2b = _conv(384, (3, 1), padding=(1, 0))
        self.b3 = _seq(nn.AvgPool2D(3, 1, 1), _conv(192, 1))
        self._caxis = _layout.channel_axis()

    def forward(self, x):
        y1 = self.b1_stem(x)
        y2 = self.b2_stem(x)
        return ops.concat(self.b0(x), self.b1a(y1), self.b1b(y1),
                          self.b2a(y2), self.b2b(y2), self.b3(x),
                          dim=self._caxis)


class Inception3(ZooNet):
    """Inception v3: the stem, three A blocks, B, four C blocks, D, two
    E blocks, global average pooling, dropout 0.5 and a dense
    classifier."""

    def __init__(self, classes=1000, dtype="float32", device=None,
                 prefix=None, params=None):
        super().__init__(prefix, params)
        with building(device):
            f = nn.HybridSequential()
            f.add(_conv(32, 3, 2))
            f.add(_conv(32, 3))
            f.add(_conv(64, 3, padding=1))
            f.add(nn.MaxPool2D(3, 2))
            f.add(_conv(80, 1))
            f.add(_conv(192, 3))
            f.add(nn.MaxPool2D(3, 2))
            f.add(_make_A(32))
            f.add(_make_A(64))
            f.add(_make_A(64))
            f.add(_make_B())
            f.add(_make_C(128))
            f.add(_make_C(160))
            f.add(_make_C(160))
            f.add(_make_C(192))
            f.add(_make_D())
            f.add(_MixedE())
            f.add(_MixedE())
            f.add(nn.GlobalAvgPool2D())
            f.add(nn.Dropout(0.5))
            self.features = f
            self.output = nn.Dense(classes)
        self._finish(dtype)


def inception_v3(pretrained=False, classes=1000, **kwargs):
    refuse_pretrained("inception_v3", pretrained)
    return Inception3(classes=classes, **kwargs)
