"""The port's ResNet training slice against the JAX reference, on the CPU.

Inputs and weights are made with numpy from a seed and fed to both
packages; the reference's ``collect_params()`` (running statistics
included) is carried into the port with ``from_numpy``.  Each case runs
the reference's function on the CPU and its counterpart in
``tpu_mx_torch`` with ``device="cpu"``, at a small size: thin nets
(stages of one block, widths 8-128), 32x32 or 64x64 images, batch 2.
"""
import inspect
import math

import numpy as np
import pytest
import torch

import tpu_mx as mx
from tpu_mx import autograd, gluon, nd
from tpu_mx import context as jcontext
from tpu_mx import layout as jlayout
from tpu_mx.gluon import nn as jnn
from tpu_mx.gluon.model_zoo.vision import resnet as jresnet
from tpu_mx.initializer import _fan as jfan
from tpu_mx.ndarray import ops as jops
from tpu_mx.optimizer.optimizer import SGD as JSGD
from tpu_mx.parallel import CompiledTrainStep as JCompiledTrainStep

import tpu_mx_torch as tmx
from tpu_mx_torch import device as tdevice
from tpu_mx_torch import initializer, layout, optimizer
from tpu_mx_torch.base import MXNetError
from tpu_mx_torch.gluon import loss as tloss
from tpu_mx_torch.gluon import nn
from tpu_mx_torch.gluon.block import load_numpy
from tpu_mx_torch.gluon.model_zoo import vision
from tpu_mx_torch.ndarray import ops
from tpu_mx_torch.parallel import CompiledTrainStep

OP_TOL = 1e-5       # one f32 operator, two implementations
LOGITS_TOL = 2e-4   # the reference's own NHWC-vs-NCHW ResNet tolerance
STEP_TOL = 1e-4     # three f32 SGD steps: losses (relative), weights
BF16_TOL = 2e-2     # bf16 results, relative to max|ref|

THIN = {"basic": (jresnet.BasicBlockV1, vision.BasicBlockV1,
                  [8, 8, 16, 32, 64]),
        "bottleneck": (jresnet.BottleneckV1, vision.BottleneckV1,
                       [8, 16, 32, 64, 128]),
        "basic_v2": (jresnet.BasicBlockV2, vision.BasicBlockV2,
                     [8, 8, 16, 32, 64]),
        "bottleneck_v2": (jresnet.BottleneckV2, vision.BottleneckV2,
                          [8, 16, 32, 64, 128])}


@pytest.fixture(autouse=True)
def _host_init(monkeypatch):
    # the reference draws its initial weights with numpy, not with a
    # compiled program per shape; the values are replaced anyway
    monkeypatch.setenv("TPUMX_HOST_INIT", "1")


@pytest.fixture(autouse=True)
def _native_cpu_convolutions(monkeypatch):
    # PyTorch's oneDNN CPU convolution corrupts memory in the backward of
    # a channels-last 1x1 stride-2 convolution at some small shapes (a
    # segmentation fault later, in either package; torch 2.13 on the
    # CPU); PyTorch's native CPU convolutions do not
    monkeypatch.setattr(torch.backends.mkldnn, "enabled", False)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _ref_params(net):
    # copies: a view of a reference array dangles once a step donates it
    return {k: np.array(p.data()._data)
            for k, p in net.collect_params().items()}


# -- Dense, the fault ---------------------------------------------------------
def test_dense_flattens_by_default_as_the_reference_does():
    """``Dense(10, in_units=12)`` on a ``(2, 3, 4)`` input: the reference
    flattens to ``(2, 12)`` and returns ``(2, 10)``; the port raised."""
    jd = jnn.Dense(10, in_units=12)
    jd.initialize()
    d = nn.Dense(10, in_units=12, generator=torch.Generator())
    load_numpy(d, _ref_params(jd))
    x = np.ones((2, 3, 4), np.float32)
    ref = jd(nd.array(x)).asnumpy()
    out = d(_t(x)).detach().numpy()
    assert out.shape == ref.shape == (2, 10)
    np.testing.assert_allclose(out, ref, rtol=OP_TOL, atol=OP_TOL)


@pytest.mark.parametrize("flatten", [True, False])
@pytest.mark.parametrize("activation", [None, "relu", "tanh"])
@pytest.mark.parametrize("use_bias", [True, False])
def test_dense_matches_the_reference(flatten, activation, use_bias):
    in_units = 12 if flatten else 4
    jd = jnn.Dense(6, activation=activation, use_bias=use_bias,
                   flatten=flatten, in_units=in_units)
    jd.initialize(init="xavier")
    d = nn.Dense(6, activation=activation, use_bias=use_bias,
                 flatten=flatten, in_units=in_units,
                 generator=torch.Generator())
    assert [n for n, _ in d.named_parameters()] == \
        (["weight", "bias"] if use_bias else ["weight"])
    load_numpy(d, _ref_params(jd))
    x = np.random.RandomState(1).randn(2, 3, 4).astype(np.float32)
    ref = jd(nd.array(x)).asnumpy()
    out = d(_t(x)).detach().numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=OP_TOL, atol=OP_TOL)


# -- layout --------------------------------------------------------------------
@pytest.mark.parametrize("name", ["NHWC", "NCHW", "NWC", "NCDHW", "NDHWC",
                                  "channels_last", "channels_first"])
def test_layout_follows_the_reference(name):
    def read(mod):
        with mod.default_layout(name):
            inner = ([mod.get_default_layout(n) for n in (1, 2, 3)],
                     mod.channel_axis(), mod.bn_axis(),
                     mod.is_channels_last(mod.get_default_layout(2)))
        return inner, mod.get_default_layout(2), mod.bn_axis()
    assert read(layout) == read(jlayout)


def test_layout_errors_and_nesting_follow_the_reference():
    for mod in (layout, jlayout):
        with pytest.raises(ValueError, match="unknown layout"):
            with mod.default_layout("NHCW"):
                pass
        with mod.default_layout("NHWC"):
            with mod.default_layout("NCHW"):
                assert mod.bn_axis() == 1
            assert mod.bn_axis() == -1
        assert mod.get_default_layout() == "NCHW"
        assert not mod.is_channels_last(None)


# -- operators -----------------------------------------------------------------
def _nhwc(x):
    return np.ascontiguousarray(np.transpose(x, (0, 2, 3, 1)))


@pytest.mark.parametrize("lay", ["NCHW", "NHWC"])
@pytest.mark.parametrize("stride,pad", [(1, 0), (2, 1), (1, 1)])
@pytest.mark.parametrize("bias", [True, False])
def test_convolution_matches_the_reference(lay, stride, pad, bias):
    rng = np.random.RandomState(2)
    x = rng.randn(2, 5, 9, 9).astype(np.float32)
    w = rng.randn(7, 5, 3, 3).astype(np.float32)
    b = rng.randn(7).astype(np.float32)
    if lay == "NHWC":
        x, w = _nhwc(x), _nhwc(w)
    kw = dict(kernel=(3, 3), stride=(stride, stride), pad=(pad, pad),
              num_filter=7, no_bias=not bias, layout=lay)
    ref = jops.Convolution(nd.array(x), nd.array(w),
                           nd.array(b) if bias else None, **kw).asnumpy()
    out = ops.Convolution(_t(x), _t(w), _t(b) if bias else None, **kw)
    if lay == "NHWC":   # channels-last strides in, out and through
        assert out.is_contiguous()
    np.testing.assert_allclose(out.numpy(), ref, rtol=OP_TOL, atol=OP_TOL)


_POOLS = [
    dict(pool_type="max", kernel=(3, 3), stride=(2, 2), pad=(1, 1)),
    dict(pool_type="max", kernel=(2, 2), stride=(2, 2), pad=(0, 0),
         pooling_convention="full"),
    dict(pool_type="avg", kernel=(3, 3), stride=(2, 2), pad=(1, 1)),
    dict(pool_type="avg", kernel=(3, 3), stride=(2, 2), pad=(1, 1),
         count_include_pad=False),
    dict(pool_type="avg", kernel=(3, 3), stride=(2, 2), pad=(1, 1),
         pooling_convention="full"),
    dict(pool_type="avg", kernel=(3, 3), stride=(2, 2), pad=(1, 1),
         pooling_convention="full", count_include_pad=False),
    dict(pool_type="sum", kernel=(2, 2), stride=(1, 1), pad=(0, 0)),
    dict(pool_type="avg", global_pool=True),
    dict(pool_type="max", global_pool=True),
]


@pytest.mark.parametrize("lay", ["NCHW", "NHWC"])
@pytest.mark.parametrize("kw", _POOLS, ids=lambda kw: "-".join(
    str(v) for v in kw.values()))
def test_pooling_matches_the_reference(lay, kw):
    x = np.random.RandomState(3).randn(2, 4, 8, 9).astype(np.float32)
    if lay == "NHWC":
        x = _nhwc(x)
    ref = jops.Pooling(nd.array(x), layout=lay, **kw).asnumpy()
    out = ops.Pooling(_t(x), layout=lay, **kw).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=OP_TOL, atol=OP_TOL)


def test_space_to_depth_matches_the_reference():
    x = np.random.RandomState(4).randn(2, 3, 8, 8).astype(np.float32)
    ref = jops.space_to_depth(nd.array(x), 4).asnumpy()
    out = ops.space_to_depth(_t(x), 4)
    np.testing.assert_array_equal(out.numpy(), ref)
    # out channel (bh·b + bw)·C + c holds in[c, i·b + bh, j·b + bw]
    assert out[1, (2 * 4 + 3) * 3 + 1, 0, 1] == x[1, 1, 2, 7]
    np.testing.assert_array_equal(ops.depth_to_space(out, 4).numpy(), x)
    np.testing.assert_array_equal(
        ops.depth_to_space(out, 4).numpy(),
        jops.depth_to_space(nd.array(ref), 4).asnumpy())


def test_softmax_cross_entropy_takes_float_labels_as_the_reference():
    rng = np.random.RandomState(5)
    pred = rng.randn(4, 10).astype(np.float32)
    label = rng.randint(0, 10, 4).astype(np.float32)
    ref = gluon.loss.SoftmaxCrossEntropyLoss()(nd.array(pred),
                                               nd.array(label)).asnumpy()
    out = tloss.SoftmaxCrossEntropyLoss()(_t(pred), _t(label)).numpy()
    np.testing.assert_allclose(out, ref, rtol=OP_TOL, atol=OP_TOL)


# -- BatchNorm -----------------------------------------------------------------
def _bn_pair(lay, c=5, seed=6):
    with jlayout.default_layout(lay):
        jbn = jnn.BatchNorm(in_channels=c)
    jbn.initialize()
    rng = np.random.RandomState(seed)
    params = {"gamma": rng.uniform(0.5, 1.5, c), "beta": rng.randn(c) * 0.2,
              "running_mean": rng.randn(c) * 0.1,
              "running_var": rng.uniform(0.5, 1.5, c)}
    for k, p in jbn.collect_params().items():
        leaf = next(n for n in params if k.endswith(n))
        p.set_data(nd.array(params[leaf].astype(np.float32)))
    with layout.default_layout(lay):
        bn = nn.BatchNorm(in_channels=c, generator=torch.Generator())
    load_numpy(bn, _ref_params(jbn))
    return jbn, bn


@pytest.mark.parametrize("lay", ["NCHW", "NHWC"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batchnorm_training_matches_the_reference(lay, dtype):
    """At n = 2·8·8 = 128 the unbiased variance is 0.8% above the
    biased one the reference keeps: ``F.batch_norm``'s running variance
    fails this test."""
    jbn, bn = _bn_pair(lay)
    x = (np.random.RandomState(7).randn(2, 5, 8, 8) * 2 + 1) \
        .astype(np.float32)
    if lay == "NHWC":
        x = _nhwc(x)
    if dtype == "bfloat16":
        jbn.cast("bfloat16")
        bn.cast("bfloat16")
    jx = nd.cast(nd.array(x), dtype) if dtype == "bfloat16" else nd.array(x)
    with autograd.record():
        ref = jbn(jx).asnumpy().astype(np.float32)
    bn.train()
    out = bn(_t(x).to(getattr(torch, dtype))).float().detach().numpy()
    ref_stats = [np.asarray(jbn.running_mean.data()._data, np.float32),
                 np.asarray(jbn.running_var.data()._data, np.float32)]
    stats = [bn.running_mean.float().numpy(), bn.running_var.float().numpy()]
    if dtype == "float32":
        np.testing.assert_allclose(out, ref, rtol=OP_TOL, atol=OP_TOL)
        for s, r in zip(stats, ref_stats):
            np.testing.assert_allclose(s, r, rtol=OP_TOL, atol=OP_TOL)
    else:
        assert bn.running_var.dtype == torch.bfloat16
        tol = BF16_TOL * np.abs(ref).max()
        np.testing.assert_allclose(out, ref, rtol=0, atol=tol)
        for s, r in zip(stats, ref_stats):
            np.testing.assert_allclose(s, r, rtol=0,
                                       atol=BF16_TOL * np.abs(r).max())


@pytest.mark.parametrize("lay", ["NCHW", "NHWC"])
def test_batchnorm_eval_uses_the_running_statistics(lay):
    jbn, bn = _bn_pair(lay)
    x = np.random.RandomState(8).randn(2, 5, 4, 4).astype(np.float32)
    if lay == "NHWC":
        x = _nhwc(x)
    ref = jbn(nd.array(x)).asnumpy()
    before = bn.running_mean.clone()
    bn.eval()
    out = bn(_t(x)).detach().numpy()
    np.testing.assert_allclose(out, ref, rtol=OP_TOL, atol=OP_TOL)
    assert torch.equal(bn.running_mean, before)


# -- initializers --------------------------------------------------------------
@pytest.mark.parametrize("shape", [(8, 16, 3, 3), (8, 3, 3, 16), (10, 12)])
def test_xavier_bound_is_the_references(shape):
    bound = math.sqrt(3 / jfan(shape, "avg"))
    assert initializer.Xavier().scale(shape) == pytest.approx(bound)
    w = initializer.create("xavier")("weight", shape, torch.float32,
                                     torch.Generator().manual_seed(0))
    assert w.shape == shape
    assert w.abs().max() <= bound and w.abs().max() > 0.95 * bound


@pytest.mark.parametrize("lay,ref_shape", [("NCHW", (8, 16, 3, 3)),
                                           ("NHWC", (8, 3, 3, 16))])
def test_conv_weight_takes_the_references_fan(lay, ref_shape):
    """The port stores ``(O, I, kh, kw)``; channels-last the reference's
    weight is ``(O, kh, kw, I)`` and its fan is read from that shape."""
    with layout.default_layout(lay):
        conv = nn.Conv2D(8, 3, in_channels=16, generator=torch.Generator())
    conv.initialize("xavier", torch.Generator().manual_seed(1))
    w = conv.weight
    assert tuple(w.shape) == (8, 16, 3, 3)
    assert w.is_contiguous(memory_format=torch.channels_last) == \
        (lay == "NHWC")
    bound = math.sqrt(3 / jfan(ref_shape, "avg"))
    assert bound * 0.95 < float(w.detach().abs().max()) <= bound
    assert torch.all(conv.bias == 0)


def test_initialize_follows_each_tensors_own_initializer():
    bn = nn.BatchNorm(in_channels=4, generator=torch.Generator())
    for t in bn.collect_params().values():
        with torch.no_grad():
            t.fill_(7.0)
    bn.initialize("xavier", torch.Generator())
    assert [float(t.detach()[0]) for t in bn.collect_params().values()] == \
        [1.0, 0.0, 0.0, 1.0]


# -- SGD -----------------------------------------------------------------------
@pytest.mark.parametrize("momentum", [0.0, 0.9])
@pytest.mark.parametrize("clip", [None, 0.0, 0.3])
def test_sgd_update_matches_the_reference(momentum, clip):
    rng = np.random.RandomState(10)
    w, g, m = (rng.randn(5, 6).astype(np.float32) for _ in range(3))
    kw = dict(learning_rate=0.1, momentum=momentum, wd=1e-3,
              rescale_grad=0.5, clip_gradient=clip)
    jopt, opt = JSGD(**kw), optimizer.create("sgd", **kw)
    jstate = None if momentum == 0 else nd.array(m)._data
    state = None if momentum == 0 else _t(m)
    jw, js = jopt.update_core(nd.array(w)._data, nd.array(g)._data, jstate,
                              0.1, 1e-3, 1)
    tw, ts = opt.update_core(_t(w), _t(g), state, 0.1, 1e-3, 1)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6,
                               atol=1e-6)
    if momentum:
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6,
                                   atol=1e-6)
    else:
        assert ts is None and js is None


def test_sgd_momentum_is_float32_for_bfloat16_weights():
    opt = optimizer.create("sgd", momentum=0.9)
    w = torch.zeros((4, 3, 2, 2), dtype=torch.bfloat16) \
        .to(memory_format=torch.channels_last)
    s = opt.create_state(0, w)
    assert s.dtype == torch.float32
    assert s.is_contiguous(memory_format=torch.channels_last)


# -- context -------------------------------------------------------------------
def test_context_maps_onto_torch_devices():
    assert tmx.gpu(1).torch_device() == torch.device("cuda", 1)
    assert tmx.tpu(0).torch_device() == torch.device("cuda", 0)
    assert tmx.cpu().torch_device() == tmx.cpu_pinned(0).torch_device() \
        == torch.device("cpu")
    for mod in (tmx, jcontext):
        assert mod.gpu(0) == mod.tpu(0) and mod.cpu(0) != mod.gpu(0)
        assert repr(mod.gpu(2)) == "gpu(2)"
        with pytest.raises(ValueError, match="unknown device type"):
            mod.Context("fpga")
        with mod.cpu(0):
            with mod.gpu(1):
                assert mod.current_context() == mod.gpu(1)
            assert mod.current_context() == mod.cpu(0)
    assert tmx.current_context() == tmx.gpu(0)     # the card, always
    assert tmx.num_gpus() == torch.cuda.device_count()


def test_context_resolves_as_a_device():
    assert tdevice.resolve(tmx.cpu()) == torch.device("cpu")
    if torch.cuda.is_available():
        assert tdevice.resolve(tmx.gpu(0)) == torch.device("cuda", 0)
    else:
        with pytest.raises(MXNetError, match="no CUDA device"):
            tdevice.resolve(tmx.gpu(0))


# -- the thin ResNet -------------------------------------------------------------
def _thin_pair(block, stem, lay, seed=0):
    """The reference's thin ResNet (v2 for a ``*_v2`` block; Xavier
    weights, random BatchNorm affine and running statistics) and the
    port's, from one weight set."""
    jblock, tblock, channels = THIN[block]
    jcls, cls = (jresnet.ResNetV2, vision.ResNetV2) \
        if block.endswith("_v2") else (jresnet.ResNetV1, vision.ResNetV1)
    with jlayout.default_layout(lay):
        jnet = jcls(jblock, [1, 1, 1, 1], channels, classes=10, stem=stem)
    np.random.seed(seed)
    jnet.initialize(init="xavier")
    rng = np.random.RandomState(seed + 100)
    for k, p in jnet.collect_params().items():
        a = p.data().asnumpy()
        if k.endswith(("gamma", "running_var")):
            p.set_data(nd.array(rng.uniform(0.5, 1.5, a.shape)
                                .astype(np.float32)))
        elif k.endswith(("beta", "running_mean", "bias")):
            p.set_data(nd.array((rng.randn(*a.shape) * 0.1)
                                .astype(np.float32)))
    params = _ref_params(jnet)
    net = cls.from_numpy(params, tblock, [1, 1, 1, 1], channels, classes=10,
                         stem=stem, layout=lay, device="cpu",
                         generator=torch.Generator())
    return jnet, net, params


def _images(lay, size=32, batch=2, seed=11):
    x = np.random.RandomState(seed).rand(batch, 3, size, size) \
        .astype(np.float32)
    return _nhwc(x) if lay == "NHWC" else x


@pytest.mark.parametrize("lay", ["NCHW", "NHWC"])
@pytest.mark.parametrize("stem", ["classic", "s2d"])
@pytest.mark.parametrize("block", ["basic", "bottleneck"])
def test_thin_resnet_logits_match_the_reference(block, stem, lay):
    jnet, net, _ = _thin_pair(block, stem, lay)
    x = _images(lay)
    ref = jnet(nd.array(x)).asnumpy()
    net.eval()
    out = net(_t(x)).detach().numpy()
    assert out.shape == ref.shape == (2, 10)
    np.testing.assert_allclose(out, ref, rtol=LOGITS_TOL, atol=LOGITS_TOL)


@pytest.mark.parametrize("lay", ["NCHW", "NHWC"])
@pytest.mark.parametrize("block,stem", [("basic_v2", "classic"),
                                        ("bottleneck_v2", "s2d")])
def test_thin_resnet_v2_logits_match_the_reference(block, stem, lay):
    jnet, net, _ = _thin_pair(block, stem, lay)
    x = _images(lay)
    ref = jnet(nd.array(x)).asnumpy()
    net.eval()
    out = net(_t(x)).detach().numpy()
    assert out.shape == ref.shape == (2, 10)
    np.testing.assert_allclose(out, ref, rtol=LOGITS_TOL, atol=LOGITS_TOL)


def test_from_numpy_consumes_every_array_once():
    jnet, net, params = _thin_pair("bottleneck", "s2d", "NHWC")
    assert len(net.collect_params()) == len(params)
    for (name, t), (ref, a) in zip(net.collect_params().items(),
                                   params.items()):
        if t.dim() == 4:     # channels-last weights: the transposed array
            a = a.transpose(0, 3, 1, 2)
            assert t.is_contiguous(memory_format=torch.channels_last), name
        np.testing.assert_array_equal(t.detach().numpy(), a, err_msg=name)
    items = list(params.items())
    build = dict(block=vision.BottleneckV1, layers=[1, 1, 1, 1],
                 channels=THIN["bottleneck"][2])

    def load(p):
        return vision.ResNetV1.from_numpy(p, build["block"], build["layers"],
                                          build["channels"], classes=10,
                                          stem="s2d", layout="NHWC",
                                          device="cpu")
    with pytest.raises(MXNetError, match="arrays for"):
        load(dict(items[:-1]))
    # the first bottleneck's 1x1 conv keeps its bias: swap it with the
    # BatchNorm gamma after it
    i = next(i for i, (k, _) in enumerate(items) if k.endswith("bias"))
    with pytest.raises(MXNetError, match="does not match"):
        load(dict(items[:i] + [items[i + 1], items[i]] + items[i + 2:]))
    bad = dict(params)
    bad[items[0][0]] = items[0][1][:-1]
    with pytest.raises(MXNetError, match="shape"):
        load(bad)


def _steps(jnet, net, lay, n=3, dtype="float32", size=64, **step_kw):
    """``n`` SGD steps (lr 0.1, momentum 0.9, wd 1e-4) of both packages'
    ``CompiledTrainStep`` on one batch; returns both loss lists."""
    kw = dict(learning_rate=0.1, momentum=0.9, wd=1e-4,
              multi_precision=dtype == "bfloat16")
    x = _images(lay, size=size)
    label = np.array([1, 7], np.float32)
    jstep = JCompiledTrainStep(jnet, gluon.loss.SoftmaxCrossEntropyLoss(),
                               mx.optimizer.create("sgd", **kw), mesh=None,
                               **step_kw)
    step = CompiledTrainStep(net, tloss.SoftmaxCrossEntropyLoss(),
                             optimizer.create("sgd", **kw), device="cpu",
                             **step_kw)
    jx = nd.array(x) if dtype == "float32" else nd.cast(nd.array(x), dtype)
    tx = _t(x).to(getattr(torch, dtype))
    jl = [float(np.asarray(jstep.step(jx, nd.array(label))._data).ravel()[0])
          for _ in range(n)]
    tl = [float(step.step(tx, _t(label))) for _ in range(n)]
    return jl, tl, jstep, step


@pytest.mark.parametrize("block,stem,lay", [("bottleneck", "s2d", "NHWC"),
                                            ("basic", "classic", "NCHW")])
def test_three_sgd_steps_match_the_reference(block, stem, lay):
    jnet, net, _ = _thin_pair(block, stem, lay)
    jl, tl, jstep, _ = _steps(jnet, net, lay)
    np.testing.assert_allclose(tl, jl, rtol=STEP_TOL)
    assert tl[-1] < tl[0]
    ref = {k: np.array(v) for k, v in jstep.values.items()}
    for (name, t), key in zip(net.collect_params().items(),
                              jnet.collect_params().keys()):
        a = ref[key]
        if t.dim() == 4 and lay == "NHWC":
            a = a.transpose(0, 3, 1, 2)
        np.testing.assert_allclose(t.detach().numpy(), a, rtol=STEP_TOL,
                                   atol=STEP_TOL, err_msg=name)


def test_bfloat16_first_loss_matches_the_reference():
    jnet, net, _ = _thin_pair("bottleneck", "s2d", "NHWC")
    jnet.cast("bfloat16")
    net.cast("bfloat16")
    assert all(t.dtype == torch.bfloat16
               for t in net.collect_params().values())
    jl, tl, _, step = _steps(jnet, net, "NHWC", n=1, dtype="bfloat16")
    assert abs(tl[0] - jl[0]) <= BF16_TOL * abs(jl[0])
    assert step.masters and all(m.dtype == torch.float32
                                for m in step.masters.values())


def test_batchnorm_statistics_update_on_every_microbatch():
    """``accum_steps=2``: the first call applies no update, but the
    running statistics move in both packages, to the same values."""
    jnet, net, _ = _thin_pair("basic", "s2d", "NHWC")
    before = {k: t.clone() for k, t in net.collect_params().items()}
    _, _, jstep, step = _steps(jnet, net, "NHWC", n=1, accum_steps=2)
    ref = {k: np.array(v) for k, v in jstep.values.items()}
    moved = 0
    for (name, t), key in zip(net.collect_params().items(),
                              jnet.collect_params().keys()):
        if "running" in name:
            moved += not torch.equal(t, before[name])
            np.testing.assert_allclose(t.numpy(), ref[key], rtol=STEP_TOL,
                                       atol=STEP_TOL, err_msg=name)
        else:
            assert torch.equal(t.detach(), before[name]), name
    assert moved == sum("running" in k for k in before)


def test_state_dict_round_trip_includes_the_running_statistics():
    _, net, _ = _thin_pair("bottleneck", "classic", "NHWC")
    step = CompiledTrainStep(net, tloss.SoftmaxCrossEntropyLoss(),
                             optimizer.create("sgd", learning_rate=0.1,
                                              momentum=0.9, wd=1e-4),
                             device="cpu")
    x, label = _t(_images("NHWC", size=32)), torch.tensor([1.0, 7.0])
    step.step(x, label)
    sd = step.state_dict()
    stats = [k for k in sd["values"] if "running" in k]
    assert len(stats) == 2 * sum(isinstance(m, nn.BatchNorm)
                                 for m in net.modules())
    assert set(sd["opt_states"]) == {k for k, p in net.named_parameters()
                                     if p.requires_grad}
    first = [float(step.step(x, label)) for _ in range(2)]
    step.load_state_dict(sd)
    for k in stats:
        assert torch.equal(net.get_buffer(k), sd["values"][k])
    assert [float(step.step(x, label)) for _ in range(2)] == first


# -- entry points ----------------------------------------------------------------
def test_resnet_entry_points_default_to_the_card():
    for fn in (vision.ResNetV1.__init__, vision.ResNetV2.__init__,
               vision.ResNetV1.from_numpy):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    net = vision.resnet18_v1(classes=4, ctx=tmx.cpu(),
                             generator=torch.Generator())
    assert next(net.parameters()).device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(MXNetError, match="no CUDA device"):
            vision.resnet18_v1(classes=4)
        with pytest.raises(MXNetError, match="no CUDA device"):
            vision.resnet18_v1(classes=4, ctx=tmx.gpu(0))
        with pytest.raises(MXNetError, match="no CUDA device"):
            nn.Conv2D(4, 3, in_channels=3)   # no generator: the card's


@pytest.mark.parametrize("version", [1, 2])
def test_resnet_v1_v2_layouts_and_cast(version):
    """ResNet-18 of either version built channels-last runs on
    ``(N, H, W, C)`` images with channels-last weights, and ``cast``
    takes the running statistics to bfloat16 too."""
    with layout.default_layout("NHWC"):
        net = vision.get_resnet(version, 18, classes=5, stem="s2d",
                                device="cpu", generator=torch.Generator())
    net.cast("bfloat16")
    convs = [m for m in net.modules() if isinstance(m, nn.Conv2D)]
    assert all(c.weight.is_contiguous(memory_format=torch.channels_last)
               for c in convs)
    assert net.features[0 if version == 1 else 1].bn.running_var.dtype \
        == torch.bfloat16
    net.train()
    out = net(torch.rand(2, 32, 32, 3).to(torch.bfloat16))
    assert out.shape == (2, 5) and torch.isfinite(out.float()).all()
