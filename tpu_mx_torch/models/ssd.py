"""The SSD object detector of ``tpu_mx/models/ssd.py``: a backbone, extra
scales, a class head and a box head per scale, and the anchors of
``ndarray.contrib.MultiBoxPrior``.

Both backbones of the reference: ``"compact"`` (conv-BatchNorm-relu
blocks, the benchmark's smoke net) and ``"vgg16_reduced"`` (VGG16 with
pool5 3x3/1, atrous fc6 and fc7 as convolutions, and a scaled L2
normalization of conv4_3), with the reference's parameter names, shapes
and ``collect_params()`` order, so :meth:`SSD.from_numpy` carries the
reference's weights over one to one.

The logical layout is the reference's NCHW (the heads' outputs are
transposed ``(0, 2, 3, 1)``, the anchors read H and W from the last two
axes).  On the card the activations and convolution weights are held in
``torch.channels_last`` *memory format*: cuDNN's tensor-core
convolutions work on NHWC data, and the format changes no result.  The
heads' transposes are then free views.  The anchors depend only on the
image size, so a net makes them once per size and device (the
reference folds them into its compiled program).
"""
from __future__ import annotations

import torch

from .. import device as _device
from .. import random as _random
from ..base import MXNetError
from ..gluon import nn
from ..gluon.block import HybridBlock, as_dtype, default_generator, \
    load_numpy
from ..initializer import Constant
from ..ndarray import contrib, ops

__all__ = ["SSD", "VGG16ReducedFeatures", "SSDTrainingTargets", "ssd_512",
           "ssd_300"]


def _body_block(filters, in_channels, kw):
    """The compact backbone's block: 2 x (conv-BatchNorm-relu), then a
    2x2 max pool."""
    blk = nn.HybridSequential()
    for j in range(2):
        blk.add(nn.Conv2D(filters, kernel_size=3, padding=1,
                          in_channels=in_channels if j == 0 else filters,
                          **kw),
                nn.BatchNorm(in_channels=filters, **kw),
                nn.Activation("relu"))
    blk.add(nn.MaxPool2D(2, 2))
    return blk


def _scale_block(filters, strides, padding, in_channels, kw):
    """An extra scale: a 1x1 reduction to ``filters // 2``, then a 3x3
    convolution (stride 2, padding 1 halves the map; SSD-300's tail is
    stride 1, padding 0), each with BatchNorm and relu."""
    blk = nn.HybridSequential()
    blk.add(nn.Conv2D(filters // 2, kernel_size=1, in_channels=in_channels,
                      **kw),
            nn.BatchNorm(in_channels=filters // 2, **kw),
            nn.Activation("relu"),
            nn.Conv2D(filters, kernel_size=3, strides=strides,
                      padding=padding, in_channels=filters // 2, **kw),
            nn.BatchNorm(in_channels=filters, **kw),
            nn.Activation("relu"))
    return blk


class _L2NormScale(HybridBlock):
    """Per-position L2 normalization over the channels with a learned
    per-channel ``scale`` of shape ``(1, C, 1, 1)``, which starts at 20
    (its own ``Constant`` initializer, kept by ``initialize``)."""

    def __init__(self, channels, init_scale=20.0, dtype=torch.float32,
                 generator=None):
        super().__init__()
        self._declare("scale", (1, channels, 1, 1), Constant(init_scale),
                      as_dtype(dtype), default_generator(generator))

    def forward(self, x):
        return ops.L2Normalization(x, mode="channel") * self.scale


class VGG16ReducedFeatures(HybridBlock):
    """The VGG16-reduced backbone: conv1_1 ... conv5_3 (relu after each),
    ceil-mode 2x2 max pools after stages 1-3 and after conv4_3 (``pool4``,
    outside stage 4 so that conv4_3 is tapped before it), ``pool5`` 3x3
    stride 1 padding 1, atrous ``fc6`` (1024, 3x3, dilation 6) and
    ``fc7`` (1024, 1x1).  ``forward(x)`` → ``[scaled conv4_3 (stride
    8), fc7 (stride 16)]``."""

    def __init__(self, in_channels=3, dtype=torch.float32, generator=None):
        super().__init__()
        kw = dict(dtype=dtype, generator=generator)
        in_ch = in_channels
        self.stages = []
        for i, (num, f) in enumerate(zip([2, 2, 3, 3, 3],
                                         [64, 128, 256, 512, 512])):
            stage = nn.HybridSequential()
            for _ in range(num):
                stage.add(nn.Conv2D(f, kernel_size=3, padding=1,
                                    in_channels=in_ch, **kw),
                          nn.Activation("relu"))
                in_ch = f
            if i < 3:
                stage.add(nn.MaxPool2D(2, 2, ceil_mode=True))
            self.stages.append(stage)
            setattr(self, f"stage{i + 1}", stage)
        self.pool4 = nn.MaxPool2D(2, 2, ceil_mode=True)
        self.pool5 = nn.MaxPool2D(3, 1, padding=1)
        self.fc6 = nn.Conv2D(1024, kernel_size=3, padding=6, dilation=6,
                             in_channels=512, **kw)
        self.fc7 = nn.Conv2D(1024, kernel_size=1, in_channels=1024, **kw)
        self.norm4 = _L2NormScale(512, **kw)

    def forward(self, x):
        x = self.stages[2](self.stages[1](self.stages[0](x)))
        conv4_3 = self.stages[3](x)
        x = self.pool5(self.stages[4](self.pool4(conv4_3)))
        x = ops.Activation(self.fc6(x), act_type="relu")
        fc7 = ops.Activation(self.fc7(x), act_type="relu")
        return [self.norm4(conv4_3), fc7]


class SSD(HybridBlock):
    """Multi-scale single-shot detector.  ``SSD(num_classes, sizes,
    ratios, ..., dtype=, device="cuda", generator=g)``: every parameter in
    ``dtype`` on ``device``, drawn from ``g`` (default:
    ``random.generator(device)``).

    ``forward(x)`` on ``(B, 3, H, W)`` images → ``(anchors (1, A, 4)
    float32, cls_preds (B, A, num_classes + 1), box_preds (B, A·4))``,
    the heads in the parameters' dtype."""

    def __init__(self, num_classes, sizes, ratios, base_filters=(16, 32, 64),
                 scale_filters=128, num_scales=None, backbone="compact",
                 extra_specs=None, in_channels=3, dtype="float32",
                 device="cuda", generator=None):
        super().__init__()
        dev = _device.resolve(device)
        g = _random.generator(dev) if generator is None else generator
        if g.device.type != dev.type:
            raise MXNetError(f"SSD(device={str(device)!r}): the generator "
                             f"lives on {g.device}")
        kw = dict(dtype=as_dtype(dtype), generator=g)
        self.num_classes = num_classes
        self.sizes = [tuple(s) for s in sizes]
        self.ratios = [tuple(r) for r in ratios]
        n = num_scales or len(self.sizes)
        if not len(self.sizes) == len(self.ratios) == n:
            raise ValueError("SSD: sizes and ratios need one entry a scale")
        anchors = [len(s) + len(r) - 1 for s, r in zip(self.sizes,
                                                       self.ratios)]
        if backbone == "vgg16_reduced":
            if n < 2:
                raise ValueError("SSD: vgg16_reduced yields 2 base scales")
            self.backbone = VGG16ReducedFeatures(in_channels, **kw)
            feat_channels = [512, 1024]       # scaled conv4_3, atrous fc7
        elif backbone == "compact":
            self.backbone = nn.HybridSequential()
            in_ch = in_channels
            for f in base_filters:
                self.backbone.add(_body_block(f, in_ch, kw))
                in_ch = f
            feat_channels = [base_filters[-1]]
        else:
            raise ValueError(f"unknown backbone {backbone!r}")
        self._n_base = len(feat_channels)
        specs = list(extra_specs or [(2, 1)] * (n - self._n_base))
        if len(specs) != n - self._n_base:
            raise ValueError(f"SSD: {len(specs)} extra_specs for "
                             f"{n - self._n_base} extra scales")
        self.scale_blocks, self.cls_heads, self.box_heads = [], [], []
        for i in range(n):
            if i >= self._n_base:
                st, pd = specs[i - self._n_base]
                blk = _scale_block(scale_filters, st, pd, feat_channels[-1],
                                   kw)
                self.scale_blocks.append(blk)
                setattr(self, f"scale_{i}", blk)
                feat_channels.append(scale_filters)
            ch = nn.Conv2D(anchors[i] * (num_classes + 1), kernel_size=3,
                           padding=1, in_channels=feat_channels[i], **kw)
            bh = nn.Conv2D(anchors[i] * 4, kernel_size=3, padding=1,
                           in_channels=feat_channels[i], **kw)
            self.cls_heads.append(ch)
            self.box_heads.append(bh)
            setattr(self, f"cls_head_{i}", ch)
            setattr(self, f"box_head_{i}", bh)
        self._format = torch.channels_last if dev.type == "cuda" \
            else torch.contiguous_format
        self.to(memory_format=self._format)
        self._anchors = {}      # (H, W, device) -> (1, A, 4), shared

    def forward(self, x):
        """``(anchors, cls_preds, box_preds)``; ``anchors`` is the net's
        own tensor for this image size, not to be written."""
        key = tuple(x.shape[-2:]) + (x.device,)
        anchors = self._anchors.get(key)
        base = self.backbone(x.contiguous(memory_format=self._format))
        feats = base if isinstance(base, list) else [base]
        priors, cls_preds, box_preds = [], [], []
        for i in range(len(self.sizes)):
            if i >= self._n_base:
                feats.append(self.scale_blocks[i - self._n_base](feats[-1]))
            f = feats[i]
            if anchors is None:
                priors.append(contrib.MultiBoxPrior(f, sizes=self.sizes[i],
                                                    ratios=self.ratios[i]))
            c = self.cls_heads[i](f).permute(0, 2, 3, 1)
            cls_preds.append(c.reshape(c.shape[0], -1, self.num_classes + 1))
            b = self.box_heads[i](f).permute(0, 2, 3, 1)
            box_preds.append(b.reshape(b.shape[0], -1))
        if anchors is None:
            anchors = self._anchors[key] = torch.cat(priors, 1)
        return anchors, torch.cat(cls_preds, 1), torch.cat(box_preds, 1)

    @torch.no_grad()
    def detect(self, x, threshold=0.01, nms_threshold=0.45, nms_topk=400,
               force_suppress=False):
        """Inference (BatchNorm on its running statistics): decode and NMS
        → ``(B, A, 6)`` rows ``[class_id, score, x1, y1, x2, y2]``, -1
        where dropped."""
        was_training = self.training
        self.eval()
        try:
            anchors, cls_preds, box_preds = self(x)
        finally:
            self.train(was_training)
        cls_prob = torch.softmax(cls_preds, -1).transpose(1, 2)
        return contrib.MultiBoxDetection(
            cls_prob, box_preds, anchors, threshold=threshold,
            nms_threshold=nms_threshold, nms_topk=nms_topk,
            force_suppress=force_suppress)

    @classmethod
    def from_numpy(cls, params, *args, **kwargs):
        """The port's net computing the reference's function: built as
        ``cls(*args, **kwargs)``, then every parameter and running
        statistic set from ``params``, the reference's
        ``collect_params()`` as numpy arrays in its order
        (``gluon.block.load_numpy``)."""
        return load_numpy(cls(*args, **kwargs), params)


class SSDTrainingTargets:
    """``MultiBoxTarget`` with SSD's settings (overlap 0.5, hard negatives
    at 3 to 1 under IoU 0.5), taking ``(B, A, C+1)`` class predictions."""

    def __init__(self, overlap_threshold=0.5, negative_mining_ratio=3.0,
                 negative_mining_thresh=0.5):
        self.kw = dict(overlap_threshold=overlap_threshold,
                       negative_mining_ratio=negative_mining_ratio,
                       negative_mining_thresh=negative_mining_thresh)

    def __call__(self, anchors, labels, cls_preds):
        return contrib.MultiBoxTarget(anchors, labels,
                                      cls_preds.transpose(1, 2), **self.kw)


def ssd_512(num_classes=20, **kwargs):
    """SSD-512's anchors: 7 scales with 4/6/6/6/6/4/4 anchors a position
    (with ``backbone="vgg16_reduced"`` the maps of a 512² image are
    64/32/16/8/4/2/1: 24,564 anchors)."""
    sizes = [(0.07, 0.1025), (0.15, 0.2121), (0.3, 0.3674), (0.45, 0.5196),
             (0.6, 0.6708), (0.75, 0.8216), (0.9, 0.9721)]
    ratios = [(1, 2, 0.5)] + [(1, 2, 0.5, 3, 1.0 / 3)] * 4 + \
        [(1, 2, 0.5)] * 2
    return SSD(num_classes, sizes, ratios, **kwargs)


def ssd_300(num_classes=20, **kwargs):
    """SSD-300's anchors: 6 scales with 4/6/6/6/4/4 a position; with
    ``backbone="vgg16_reduced"`` the tail is two stride-1 valid
    convolutions (38/19/10/5/3/1 maps: 8,732 anchors)."""
    sizes = [(0.1, 0.141), (0.2, 0.272), (0.37, 0.447), (0.54, 0.619),
             (0.71, 0.79), (0.88, 0.961)]
    ratios = [(1, 2, 0.5)] + [(1, 2, 0.5, 3, 1.0 / 3)] * 3 + \
        [(1, 2, 0.5)] * 2
    if kwargs.get("backbone") == "vgg16_reduced" and \
            "extra_specs" not in kwargs:
        kwargs["extra_specs"] = [(2, 1), (2, 1), (1, 0), (1, 0)]
    return SSD(num_classes, sizes, ratios, **kwargs)
