"""AlexNet, VGG and SqueezeNet of the port's vision zoo against the
reference, on the CPU (see ``test_torch_zoo_common.py``): AlexNet and
squeezenet1_1 at small inputs, VGG as ``VGG(layers, filters)`` thin,
with and without BatchNorm; predict-mode logits and the losses and
gradients of ``check_gradients``, and SqueezeNet's momentum-SGD step
through ``CompiledTrainStep`` on each side."""
import numpy as np
import pytest

import tpu_mx as mx
from tpu_mx import nd as jnd
from tpu_mx.gluon import loss as jloss
from tpu_mx.gluon.model_zoo import vision as jvision
from tpu_mx.parallel import CompiledTrainStep as JCompiledTrainStep

import tpu_mx_torch as tmx
from tpu_mx_torch import nd, optimizer
from tpu_mx_torch.gluon import loss as tloss
from tpu_mx_torch.gluon.model_zoo import vision
from tpu_mx_torch.parallel import CompiledTrainStep

from test_torch_zoo_common import (STEP_TOL, check_gradients,  # noqa
                                   check_logits, close, host_setup, images,
                                   labels, no_dropout, pair)

VGG_THIN = ([1, 1, 1], [4, 8, 8])
SGD = dict(learning_rate=0.1, momentum=0.9, wd=1e-4)


@pytest.mark.parametrize("lay", ["NCHW", "NHWC"])
def test_alexnet_matches_the_reference(lay):
    x = images(lay, 63)     # the least input: 3x3/2 pools to 1x1
    jnet, net, ref = pair(lambda: jvision.AlexNet(classes=10),
                          lambda: vision.AlexNet(classes=10), lay, x)
    check_logits(net, x, ref)
    check_gradients(jnet, net, x, labels(10))


@pytest.mark.parametrize("lay,batch_norm", [("NCHW", True),
                                            ("NHWC", False)])
def test_thin_vgg_matches_the_reference(lay, batch_norm):
    x = images(lay, 16)
    jnet, net, ref = pair(lambda: jvision.VGG(*VGG_THIN, classes=10,
                                              batch_norm=batch_norm),
                          lambda: vision.VGG(*VGG_THIN, classes=10,
                                             batch_norm=batch_norm), lay, x)
    check_logits(net, x, ref)
    check_gradients(jnet, net, x, labels(10))


def test_squeezenet_matches_the_reference_and_steps_alike():
    """squeezenet1_1 channels-last (ceil-mode pools, the fire modules'
    concatenation on the last axis): logits, gradients, then the
    recipe's step (softmax cross-entropy, SGD momentum 0.9, wd 1e-4):
    the loss and every weight after it."""
    x, y = images("NHWC", 40), labels(10)
    build = (lambda: jvision.squeezenet1_1(classes=10),
             lambda: vision.squeezenet1_1(classes=10))
    jnet, net, ref = pair(*build, "NHWC", x)
    check_logits(net, x, ref)
    check_gradients(jnet, net, x, y)
    jnet, net, _ = pair(*build, "NHWC", x)
    no_dropout(jnet, net)
    jstep = JCompiledTrainStep(jnet, jloss.SoftmaxCrossEntropyLoss(),
                               mx.optimizer.create("sgd", **SGD))
    jl = float(np.asarray(jstep.step(jnd.array(x), jnd.array(y))._data))
    with tmx.cpu():
        step = CompiledTrainStep(net, tloss.SoftmaxCrossEntropyLoss(),
                                 optimizer.create("sgd", **SGD))
        tl = step.step(nd.array(x), nd.array(y))
    assert isinstance(tl, nd.NDArray)   # arrays in, an array out
    close(float(tl.asnumpy()), jl, STEP_TOL, "loss")
    values = {k: np.array(v) for k, v in jstep.values.items()}
    for (key, p), jkey in zip(net.collect_params().items(),
                              jnet.collect_params().keys()):
        close(p._ref_view().detach().numpy(), values[jkey], STEP_TOL, key)
