"""MobileNet v1 and v2 of the port's vision zoo against the reference,
on the CPU (see ``test_torch_zoo_common.py``): mobilenet0_25 and
mobilenet_v2_0_25 at 64x64 (at 32x32 their last BatchNorms see two
samples a channel, and float32 batch statistics of two samples part
from float64 by up to 1% in either package); predict-mode logits and
the losses and gradients of ``check_gradients``."""
import pytest

from tpu_mx.gluon.model_zoo import vision as jvision

from tpu_mx_torch.gluon.model_zoo import vision

from test_torch_zoo_common import (check_gradients, check_logits,  # noqa
                                   host_setup, images, labels, pair)


@pytest.mark.parametrize("name,lay", [("mobilenet0_25", "NCHW"),
                                      ("mobilenet_v2_0_25", "NHWC")])
def test_mobilenet_matches_the_reference(name, lay):
    x = images(lay, 64)
    jnet, net, ref = pair(lambda: getattr(jvision, name)(classes=10),
                          lambda: getattr(vision, name)(classes=10), lay, x)
    check_logits(net, x, ref)
    check_gradients(jnet, net, x, labels(10))
