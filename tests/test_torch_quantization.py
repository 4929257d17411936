"""``contrib.quantization`` against the JAX reference, on the CPU.

The reference's nets (Xavier-initialized, shapes fixed by one forward)
are carried into the port with ``load_numpy``; both are calibrated on the
same batches and quantized with ``quantize_net``.  Held: the calibrated
input ranges of every quantizable leaf (1e-6 relative: float32 min/max
of the same forward), the int8 weights bit for bit (the same scale,
round half to even, clip), and the int8 nets' logits (1e-5 of
max|logit|: the int32 products are exact in both, the float layers
between them agree to float32 rounding).  ``quantize``/``dequantize``
are bit-equal, ties at .5 included.
"""
import contextlib

import numpy as np
import pytest
import torch

from tpu_mx import layout as jlayout
from tpu_mx import nd as jnd
from tpu_mx.contrib import quantization as jq
from tpu_mx.gluon import nn as jnn
from tpu_mx.gluon.model_zoo import vision as jvision

import tpu_mx_torch as mx
from tpu_mx_torch import layout, nd
from tpu_mx_torch.base import MXNetError
from tpu_mx_torch.contrib import quantization as q
from tpu_mx_torch.gluon import nn
from tpu_mx_torch.gluon.block import load_numpy
from tpu_mx_torch.gluon.model_zoo import vision

RANGE_RTOL = 1e-6
LOGITS_TOL = 1e-5


@pytest.fixture(autouse=True)
def _host():
    torch.backends.mkldnn.enabled = False
    with mx.cpu():
        yield


def _conv_net(m, classes=4):
    """The example's network (``examples/quantization/quantize_cnn.py``)."""
    net = m.HybridSequential()
    net.add(m.Conv2D(8, 3, padding=1, activation="relu"), m.MaxPool2D(2),
            m.Conv2D(16, 3, padding=1, activation="relu"), m.MaxPool2D(2),
            m.Dense(32, activation="relu"), m.Dense(classes))
    return net


def _strided_net(m):
    """Channels-last, a strided and a grouped convolution, no bias on one."""
    net = m.HybridSequential()
    net.add(m.Conv2D(8, 3, strides=2, padding=1, activation="relu"),
            m.Conv2D(8, 3, padding=1, groups=2, use_bias=False),
            m.GlobalAvgPool2D(), m.Dense(5))
    return net


def _dense_net(m):
    """Dense layers over the last axis of a 3-d input, then flattened."""
    net = m.HybridSequential()
    net.add(m.Dense(16, activation="tanh", flatten=False),
            m.Dense(12, activation="relu", flatten=False), m.Dense(3))
    return net


def _resnet(m):
    return m.ResNetV1(m.BasicBlockV1, [1, 1, 1, 1], [8, 8, 16, 32, 64],
                      classes=10)


CASES = {
    # name: (the reference's net, the port's net, layout, input shape)
    "conv": (lambda: _conv_net(jnn), lambda: _conv_net(nn), "NCHW",
             (16, 1, 16, 16)),
    "strided_nhwc": (lambda: _strided_net(jnn), lambda: _strided_net(nn),
                     "NHWC", (8, 12, 12, 3)),
    "dense": (lambda: _dense_net(jnn), lambda: _dense_net(nn), "NCHW",
              (8, 5, 7)),
    "resnet_nhwc": (lambda: _resnet(jvision), lambda: _resnet(vision),
                    "NHWC", (4, 32, 32, 3)),
}


def _scope(mod, lay):
    return mod.default_layout(lay) if lay == "NHWC" \
        else contextlib.nullcontext()


def _pair(name):
    """Both nets with the reference's weights, and the calibration and
    evaluation batches."""
    jbuild, tbuild, lay, shape = CASES[name]
    rng = np.random.RandomState(7)
    calib = [rng.randn(*shape).astype(np.float32) for _ in range(3)]
    x = rng.randn(*shape).astype(np.float32)
    with _scope(jlayout, lay):
        jnet = jbuild()
    np.random.seed(0)
    jnet.initialize(init="xavier")
    jnet(jnd.array(calib[0]))
    with _scope(layout, lay):
        net = tbuild()
    net.initialize()
    load_numpy(net, {k: np.array(p.data()._data)
                     for k, p in jnet.collect_params().items()})
    return jnet, net, calib, x


@pytest.mark.parametrize("name", sorted(CASES))
def test_calibrated_ranges_are_the_references(name):
    jnet, net, calib, _ = _pair(name)
    want = jq.calib_minmax(jnet, [jnd.array(c) for c in calib])
    got = q.calib_minmax(net, [nd.array(c) for c in calib])
    assert sorted(got) == sorted(want) and got
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RANGE_RTOL,
                                   err_msg=k)


@pytest.mark.parametrize("name", sorted(CASES))
def test_quantize_net_is_the_references(name):
    jnet, net, calib, x = _pair(name)
    jqnet = jq.quantize_net(jnet, calib_iter=[jnd.array(c) for c in calib])
    qnet = q.quantize_net(net, calib_iter=[nd.array(c) for c in calib])
    assert sorted(qnet._qmap) == sorted(jqnet._qmap)
    for k, jl in jqnet._qmap.items():
        tl = qnet._qmap[k]
        w, jw = tl._wq.asnumpy(), np.asarray(jl._wq._data)
        assert w.dtype == jw.dtype == np.int8
        assert w.shape == jw.shape and (w == jw).all(), k
        assert (tl._wmin, tl._wmax) == pytest.approx(
            (jl._wmin, jl._wmax), rel=RANGE_RTOL)
    want = jqnet(jnd.array(x)).asnumpy()
    got = qnet(nd.array(x)).asnumpy()
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=LOGITS_TOL * np.abs(want).max())
    # the wrapped net is left as it was: its float forward is untouched
    with torch.no_grad():
        plain = net(nd.array(x)).asnumpy()
    assert not np.array_equal(plain, got)
    assert all("forward" not in vars(b) for b in net.modules())


def test_quantize_and_dequantize_are_the_references():
    x = np.array([0.5, 1.5, 2.5, -0.5, -2.5, 3.49, 127.5, -300.0, 0.0],
                 np.float32)
    for rng in ((None, None), (-127.0, 127.0), (-2.0, 9.0)):
        jq8, jmn, jmx = jq.quantize(jnd.array(x), *rng)
        q8, mn, mx_ = q.quantize(nd.array(x), *rng)
        assert (mn, mx_) == (jmn, jmx)
        assert q8.asnumpy().tobytes() == np.asarray(jq8._data).tobytes()
        back = q.dequantize(q8, mn, mx_).asnumpy()
        jback = np.asarray(jq.dequantize(jq8, jmn, jmx)._data)
        assert back.tobytes() == jback.tobytes()
    # the ties at scale 1: half to even
    q8, _, _ = q.quantize(nd.array(x[:5]), -127.0, 127.0)
    assert q8.asnumpy().tolist() == [0, 2, 2, 0, -2]
    with pytest.raises(MXNetError, match="int8"):
        q.quantize(nd.array(x), out_type="uint8")
    with pytest.raises(MXNetError, match="calib"):
        q.quantize_net(nn.Dense(2))


def test_a_shared_layer_is_patched_once():
    """A leaf reachable under two names is quantized under each and its
    forward shadowed (and restored) once."""
    class Twice(nn.HybridSequential):
        pass

    shared = nn.Dense(6, activation="relu")
    net = Twice()
    net.add(shared, nn.Dense(6), shared)
    net.initialize()
    x = np.random.RandomState(3).randn(4, 6).astype(np.float32)
    qnet = q.quantize_net(net, calib_data=nd.array(x))
    assert set(qnet._qmap) == {"0", "1", "2"}
    out = qnet(nd.array(x)).asnumpy()
    assert out.shape == (4, 6) and np.isfinite(out).all()
    assert "forward" not in vars(shared)
