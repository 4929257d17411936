"""DenseNet and Inception v3 of the port's vision zoo against the
reference, on the CPU (see ``test_torch_zoo_common.py``).

DenseNet is held through its own class, thin: ``DenseNet(8, 4, [2, 2],
bn_size=2)`` (two-layer blocks, a transition between them) at 32x32,
both layouts.  Inception v3 at its least input, 75x75: the whole net's
predict-mode logits; then each block kind (``_make_A`` … ``_make_D``,
``_MixedE``) alone, channels-last, on a small feature map: its output,
and the gradients of its input and parameters in predict mode.
"""
import numpy as np
import pytest

from tpu_mx import autograd as jag
from tpu_mx import layout as jlayout
from tpu_mx import nd as jnd
from tpu_mx.gluon.model_zoo import vision as jvision
from tpu_mx.gluon.model_zoo.vision import inception as jinception

import tpu_mx_torch as tmx
from tpu_mx_torch import autograd, layout, nd
from tpu_mx_torch.gluon.block import load_numpy
from tpu_mx_torch.gluon.model_zoo import vision
from tpu_mx_torch.gluon.model_zoo.vision import inception

from test_torch_zoo_common import (LOGITS_TOL, STEP_TOL,  # noqa
                                   check_gradients, check_logits, close,
                                   host_setup, images, labels, nhwc, pair,
                                   ref_params)

DENSE_THIN = (8, 4, [2, 2])


@pytest.mark.parametrize("lay", ["NCHW", "NHWC"])
def test_thin_densenet_matches_the_reference(lay):
    x = images(lay, 32)
    jnet, net, ref = pair(
        lambda: jvision.DenseNet(*DENSE_THIN, bn_size=2, classes=10),
        lambda: vision.DenseNet(*DENSE_THIN, bn_size=2, classes=10), lay, x)
    check_logits(net, x, ref)
    check_gradients(jnet, net, x, labels(10))


def test_inception_v3_logits_match_the_reference():
    x = images("NCHW", 75)
    _, net, ref = pair(lambda: jvision.inception_v3(classes=10),
                       lambda: vision.inception_v3(classes=10), "NCHW", x)
    check_logits(net, x, ref)


BLOCKS = {"A": (lambda m: m._make_A(8), 9, 12),
          "B": (lambda m: m._make_B(), 9, 12),
          "C": (lambda m: m._make_C(16), 7, 12),
          "D": (lambda m: m._make_D(), 9, 12),
          "E": (lambda m: m._MixedE(), 5, 12)}


@pytest.mark.parametrize("kind", sorted(BLOCKS))
def test_inception_block_matches_the_reference(kind):
    build, size, channels = BLOCKS[kind]
    x = nhwc(np.random.RandomState(3).randn(2, channels, size, size)
             .astype(np.float32))
    with jlayout.default_layout("NHWC"):
        jblock = build(jinception)
    np.random.seed(0)
    jblock.initialize(init="xavier")
    jx = jnd.array(x)
    jx.attach_grad()
    w = np.random.RandomState(4).randn(
        *jblock(jnd.array(x)).shape).astype(np.float32)
    with jag.record(train_mode=False):
        jy = jblock(jx)
        jl = (jy * jnd.array(w)).sum()
    jl.backward()
    with tmx.cpu(), layout.default_layout("NHWC"):
        block = build(inception)
        load_numpy(block, ref_params(jblock))
        tx = nd.array(x)
        tx.attach_grad()
        with autograd.record(train_mode=False):
            ty = block(tx)
            tl = (ty * nd.array(w)).sum()
        tl.backward()
        close(ty.asnumpy(), jy.asnumpy(), LOGITS_TOL, "output")
        close(tx.grad.asnumpy(), jx.grad.asnumpy(), STEP_TOL, "input grad")
        jparams = [p for p in jblock.collect_params().values()
                   if p.grad_req != "null"]
        tparams = [p for p in block.collect_params().values()
                   if p.grad_req != "null"]
        assert len(jparams) == len(tparams)
        for jp, tp in zip(jparams, tparams):
            g = tp.grad.asnumpy()
            if tp._axes is not None:
                g = g.transpose(np.argsort(tp._axes))
            close(g, jp.grad.asnumpy(), STEP_TOL, jp.name)
