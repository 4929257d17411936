"""The port's Gluon vocabulary against the reference, on the CPU: the
operators the new layers call (``LeakyReLU``'s act types,
``InstanceNorm``, ``GroupNorm``, ``Deconvolution``, ``pad``,
``Convolution``/``Pooling`` in 1 and 3 dimensions, the elementwise
names), every layer added to ``gluon.nn``, the ``Block``/``Parameter``
methods (``name_scope``, ``apply_fn``, ``list_data``/``list_grad``,
``reset_ctx``) and the initializers.

Inputs are made with numpy from a seed; a layer's parameters go from
the reference's net into the port's with ``load_numpy``.  Float32 at
``OP_TOL`` of ``test_torch_resnet.py`` (relative to max(1, |ref|)); the
initializers that draw from the reference's generator (``Normal``,
``Orthogonal``, ``MSRAPrelu``) by their properties over 10^5 draws.
"""
import contextlib
import math

import numpy as np
import pytest
import torch

from tpu_mx import autograd as jag
from tpu_mx import initializer as jinit
from tpu_mx import layout as jlayout
from tpu_mx import nd as jnd
from tpu_mx.gluon import nn as jnn
from tpu_mx.initializer import _fan as jfan

import tpu_mx_torch as tmx
from tpu_mx_torch import autograd, initializer, layout, nd
from tpu_mx_torch.base import MXNetError
from tpu_mx_torch.gluon import nn
from tpu_mx_torch.gluon.block import load_numpy
from tpu_mx_torch.initializer import _fan

OP_TOL = 1e-5       # test_torch_resnet.py: one f32 operator


@pytest.fixture(autouse=True)
def _host(monkeypatch):
    monkeypatch.setenv("TPUMX_HOST_INIT", "1")
    monkeypatch.setattr(torch.backends.mkldnn, "enabled", False)
    with tmx.cpu():
        yield


def _normal(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _close(got, want, tol=OP_TOL, msg=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, msg
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * max(1.0, np.abs(want).max()),
                               err_msg=msg)


def _op(name, args, kw, tol=OP_TOL):
    """``nd.<name>`` of both packages on the same arrays, the result and
    the gradient of every floating argument (under ``record()``)."""
    jargs = [jnd.array(a) for a in args]
    targs = [nd.array(a) for a in args]
    for a in jargs + targs:
        a.attach_grad()
    with jag.record():
        jy = getattr(jnd, name)(*jargs, **kw)
    with autograd.record():
        ty = getattr(nd, name)(*targs, **kw)
    _close(ty.asnumpy(), jy.asnumpy(), tol, name)
    w = _normal(*jy.shape, seed=9)
    (jy * jnd.array(w)).sum().backward()
    (ty * nd.array(w)).sum().backward()
    for i, (j, t) in enumerate(zip(jargs, targs)):
        _close(t.grad.asnumpy(), j.grad.asnumpy(), tol, f"{name} grad {i}")


# -- operators -------------------------------------------------------------------
@pytest.mark.parametrize("act,kw", [("leaky", dict(slope=0.1)),
                                    ("elu", dict(slope=0.7)),
                                    ("selu", {}), ("gelu", {}),
                                    ("prelu", {})])
def test_leaky_relu_act_types_match_the_reference(act, kw):
    x = _normal(2, 3, 4)
    if act == "prelu":
        _op("LeakyReLU", (x, np.array([0.3], np.float32)),
            dict(act_type=act))
    else:
        _op("LeakyReLU", (x,), dict(act_type=act, **kw))


def test_instance_norm_matches_the_reference():
    _op("InstanceNorm", (_normal(2, 3, 5, 4), _normal(3, seed=1),
                         _normal(3, seed=2)), dict(eps=1e-3))


def test_group_norm_matches_the_reference():
    _op("GroupNorm", (_normal(2, 6, 3, 4), _normal(3, seed=1),
                      _normal(3, seed=2)), dict(num_groups=3))


DECONV = [
    ("1d", (2, 3, 7), (3, 4, 3), dict(kernel=(3,), stride=(2,), pad=(1,),
                                      adj=(1,))),
    ("2d", (2, 3, 5, 4), (3, 4, 3, 2), dict(kernel=(3, 2), stride=(2, 1),
                                            pad=(1, 0), adj=(1, 0),
                                            dilate=(1, 2))),
    ("2d_nhwc", (2, 5, 4, 3), (3, 3, 2, 4), dict(kernel=(3, 2), stride=(2, 2),
                                                pad=(1, 1), layout="NHWC")),
    ("3d", (1, 2, 3, 4, 3), (2, 3, 2, 2, 2), dict(kernel=(2, 2, 2),
                                                  stride=(2, 1, 2))),
]


@pytest.mark.parametrize("case", DECONV, ids=lambda c: c[0])
def test_deconvolution_matches_the_reference(case):
    _, xs, ws, kw = case
    _op("Deconvolution", (_normal(*xs), _normal(*ws, seed=1),
                          _normal(ws[-1] if "layout" in kw else ws[1],
                                  seed=2)),
        dict(num_filter=4, no_bias=False, **kw))


@pytest.mark.parametrize("mode", ["constant", "edge", "reflect"])
def test_pad_matches_the_reference(mode):
    kw = dict(mode=mode, pad_width=(0, 0, 0, 0, 1, 2, 2, 1))
    if mode == "constant":
        kw["constant_value"] = 1.5
    _op("pad", (_normal(2, 3, 4, 5),), kw)
    _op("Pad", (_normal(1, 2, 3, 4),), dict(kw, pad_width=(0, 0, 1, 1, 0, 0,
                                                           2, 2)))


@pytest.mark.parametrize("dims,lay", [(1, "NCW"), (1, "NWC"), (3, "NCDHW"),
                                      (3, "NDHWC")])
def test_convolution_and_pooling_in_one_and_three_dimensions(dims, lay):
    spatial = (6,) * dims
    cl = lay.endswith("C")
    xs = (2,) + spatial + (3,) if cl else (2, 3) + spatial
    ws = (4,) + (3,) * dims + (3,) if cl else (4, 3) + (3,) * dims
    x = _normal(*xs)
    _op("Convolution", (x, _normal(*ws, seed=1), _normal(4, seed=2)),
        dict(kernel=(3,) * dims, stride=(2,) * dims, pad=(1,) * dims,
             num_filter=4, layout=lay))
    for ptype in ("max", "avg"):
        _op("Pooling", (x,), dict(kernel=(2,) * dims, stride=(2,) * dims,
                                  pool_type=ptype, layout=lay))
        _op("Pooling", (x,), dict(kernel=(3,) * dims, stride=(2,) * dims,
                                  pool_type=ptype, layout=lay,
                                  pooling_convention="full"))


UNARY = ["softrelu", "log_sigmoid", "gelu_tanh", "softmin", "hard_sigmoid",
         "smooth_l1", "mish", "hard_swish", "cbrt", "arcsinh", "degrees",
         "radians"]
POSITIVE = ["gammaln", "gamma", "digamma", "rcbrt", "arccosh"]


@pytest.mark.parametrize("name", UNARY + POSITIVE + ["arctanh"])
def test_elementwise_names_match_the_reference(name):
    x = _normal(3, 4)
    if name in POSITIVE:
        x = np.abs(x) + 1.5
    elif name == "arctanh":
        x = np.tanh(x) * 0.9
    _op(name, (x,), {})


@pytest.mark.parametrize("name", ["logical_and", "logical_or",
                                  "logical_xor"])
def test_logical_names_match_the_reference(name):
    a = np.array([[0, 1, 2], [0, 0, -1]], np.float32)
    b = np.array([[1, 0, 3], [0, 2, 0]], np.float32)
    want = getattr(jnd, name)(jnd.array(a), jnd.array(b)).asnumpy()
    got = getattr(nd, name)(nd.array(a), nd.array(b)).asnumpy()
    np.testing.assert_array_equal(got, want)


# -- layers ----------------------------------------------------------------------
def _layer(jbuild, tbuild, x, lay=None, train=False):
    """The reference's layer (Xavier-initialized, shapes fixed by a
    forward) and the port's from its arrays: outputs and the gradients
    of the input and of every parameter."""
    def scope(mod):
        return mod.default_layout(lay) if lay else contextlib.nullcontext()
    with scope(jlayout):
        jl = jbuild(jnn)
    np.random.seed(0)
    jl.initialize(init="xavier")
    with jag.predict_mode():
        jl(jnd.array(x))
    with scope(layout):
        tl = tbuild(nn)
    tl.initialize()
    load_numpy(tl, {k: np.array(p.data()._data)
                    for k, p in jl.collect_params().items()})
    jx, tx = jnd.array(x), nd.array(x)
    jx.attach_grad()
    tx.attach_grad()
    with jag.record(train_mode=train):
        jy = jl(jx)
        w = _normal(*jy.shape, seed=5)
        js = (jy * jnd.array(w)).sum()
    js.backward()
    with autograd.record(train_mode=train):
        ty = tl(tx)
        ts = (ty * nd.array(w)).sum()
    ts.backward()
    _close(ty.asnumpy(), jy.asnumpy(), msg="output")
    _close(tx.grad.asnumpy(), jx.grad.asnumpy(), msg="input grad")
    jp = [p for p in jl.collect_params().values() if p.grad_req != "null"]
    tp = [p for p in tl.collect_params().values() if p.grad_req != "null"]
    assert len(jp) == len(tp)
    for a, b in zip(jp, tp):
        g = b.grad.asnumpy()
        if b._axes is not None:
            g = g.transpose(np.argsort(b._axes))
        _close(g, a.grad.asnumpy(), msg=a.name)
    return tl


LAYERS = [
    ("conv1d", lambda m: m.Conv1D(4, 3, strides=2, padding=1), (2, 3, 9),
     None),
    ("conv1d_nwc", lambda m: m.Conv1D(4, 3, groups=1), (2, 9, 3), "NWC"),
    ("conv3d", lambda m: m.Conv3D(4, 2, strides=(1, 2, 1)), (1, 2, 4, 5, 3),
     None),
    ("conv3d_ndhwc", lambda m: m.Conv3D(4, 2), (1, 4, 5, 3, 2), "NDHWC"),
    ("conv1d_transpose", lambda m: m.Conv1DTranspose(4, 3, strides=2,
                                                    output_padding=1),
     (2, 3, 5), None),
    ("conv2d_transpose", lambda m: m.Conv2DTranspose(
        4, (3, 2), strides=(2, 1), padding=(1, 0)), (2, 3, 5, 4), None),
    ("conv2d_transpose_nhwc", lambda m: m.Conv2DTranspose(
        4, 3, strides=2, padding=1, output_padding=1), (2, 5, 4, 3), "NHWC"),
    ("conv3d_transpose", lambda m: m.Conv3DTranspose(3, 2, strides=2),
     (1, 2, 3, 2, 3), None),
    ("maxpool1d", lambda m: m.MaxPool1D(3, 2, ceil_mode=True), (2, 3, 8),
     None),
    ("avgpool1d", lambda m: m.AvgPool1D(2), (2, 8, 3), "NWC"),
    ("maxpool3d", lambda m: m.MaxPool3D(2), (1, 2, 4, 4, 4), None),
    ("avgpool3d", lambda m: m.AvgPool3D(3, 2, 1), (1, 5, 5, 5, 2), "NDHWC"),
    ("globalmaxpool1d", lambda m: m.GlobalMaxPool1D(), (2, 3, 7), None),
    ("globalavgpool1d", lambda m: m.GlobalAvgPool1D(), (2, 7, 3), "NWC"),
    ("globalmaxpool3d", lambda m: m.GlobalMaxPool3D(), (1, 2, 3, 4, 3),
     None),
    ("globalavgpool3d", lambda m: m.GlobalAvgPool3D(), (1, 3, 4, 3, 2),
     "NDHWC"),
    ("instancenorm", lambda m: m.InstanceNorm(), (2, 3, 4, 5), None),
    ("groupnorm", lambda m: m.GroupNorm(num_groups=2), (2, 4, 3, 3), None),
    ("leakyrelu", lambda m: m.LeakyReLU(0.2), (2, 5), None),
    ("prelu", lambda m: m.PReLU(), (2, 5), None),
    ("elu", lambda m: m.ELU(0.5), (2, 5), None),
    ("selu", lambda m: m.SELU(), (2, 5), None),
    ("gelu", lambda m: m.GELU(), (2, 5), None),
    ("swish", lambda m: m.Swish(1.5), (2, 5), None),
    ("reflectionpad2d", lambda m: m.ReflectionPad2D((1, 2, 2, 1)),
     (2, 3, 4, 5), None),
    ("hybridlambda", lambda m: m.HybridLambda(
        lambda F, x: F.clip(x, -0.5, 0.5) * 2), (2, 5), None),
    ("lambda", lambda m: m.Lambda(lambda x: x * x), (2, 5), None),
]


@pytest.mark.parametrize("case", LAYERS, ids=lambda c: c[0])
def test_layer_matches_the_reference(case):
    _, build, shape, lay = case
    _layer(build, build, _normal(*shape), lay)


def test_sequential_is_a_block_that_is_not_hybridizable():
    def build(m):
        net = m.Sequential()
        net.add(m.Dense(4, activation="relu"), m.BatchNorm(), m.Dense(3))
        return net
    net = _layer(build, build, _normal(4, 6), train=True)
    assert isinstance(net, tmx.gluon.Block) and \
        not isinstance(net, tmx.gluon.HybridBlock)
    assert len(net) == 3 and isinstance(net[1], nn.BatchNorm)
    assert isinstance(net[:2], nn.Sequential) and len(net[:2]) == 2
    assert [type(b).__name__ for b in net] == ["Dense", "BatchNorm", "Dense"]


def test_group_norm_refuses_channels_it_cannot_split():
    layer = nn.GroupNorm(num_groups=3)
    with pytest.raises(MXNetError, match="not divisible"):
        layer(nd.ones((2, 4, 3)))


# -- Block and Parameter ---------------------------------------------------------
def test_name_scope_apply_and_parameter_lists():
    net = nn.HybridSequential()
    with net.name_scope():
        net.add(nn.Dense(3, in_units=2), nn.Dense(2, in_units=3))
    seen = []
    assert net.apply_fn(lambda b: seen.append(type(b).__name__)) is net
    assert seen == ["Dense", "Dense", "HybridSequential"]
    p = net[0].weight
    assert len(p.list_data()) == 1 and \
        p.list_data()[0].asnumpy().shape == (3, 2)
    x = nd.array(_normal(4, 2))
    with autograd.record():
        y = net(x)
    y.backward()
    g = p.list_grad()
    assert len(g) == 1 and np.abs(g[0].asnumpy()).sum() > 0
    p.reset_ctx(tmx.cpu())
    assert p.data().context == tmx.cpu()
    jnet = jnn.HybridSequential()
    with jnet.name_scope():
        jnet.add(jnn.Dense(3, in_units=2))
    jseen = []
    jnet.apply_fn(lambda b: jseen.append(type(b).__name__))
    assert jseen == ["Dense", "HybridSequential"]


# -- initializers ----------------------------------------------------------------
def _draw(init, shape, name="weight", seed=0):
    return init(name, shape, torch.float32,
                torch.Generator().manual_seed(seed)).numpy()


def test_normal_draws_have_the_references_moments():
    a = _draw(initializer.Normal(0.05), (100000,))
    np.random.seed(0)
    b = jinit.Normal(0.05)("weight", (100000,))
    for x in (a, b):
        assert abs(x.mean()) < 1e-3 and abs(x.std() - 0.05) < 5e-4
    assert initializer.create("normal", sigma=2.0).sigma == 2.0


@pytest.mark.parametrize("rand_type", ["uniform", "normal"])
@pytest.mark.parametrize("shape", [(6, 4, 2), (4, 12)])
def test_orthogonal_gives_an_orthonormal_basis_times_the_scale(shape,
                                                               rand_type):
    for w in (_draw(initializer.Orthogonal(1.414, rand_type), shape),
              jinit.Orthogonal(1.414, rand_type)("weight", shape)):
        assert w.shape == shape
        q = w.reshape(shape[0], -1).astype(np.float64) / 1.414
        gram = q @ q.T if q.shape[0] <= q.shape[1] else q.T @ q
        np.testing.assert_allclose(gram, np.eye(gram.shape[0]), atol=1e-5)


def test_msraprelu_is_gaussian_xavier_at_the_prelu_magnitude():
    shape = (64, 32, 7, 7)
    want = math.sqrt(2.0 / (1 + 0.25 ** 2) / jfan(shape, "avg"))
    a = _draw(initializer.MSRAPrelu(), shape)
    np.random.seed(0)
    b = jinit.MSRAPrelu()("weight", shape)
    for x in (a, b):
        assert abs(x.std() / want - 1) < 0.01 and abs(x.mean()) < want / 50
    assert initializer.create("msraprelu").magnitude == \
        jinit.MSRAPrelu().magnitude


@pytest.mark.parametrize("shape", [(2, 1, 4, 4), (3, 3, 3, 5)])
def test_bilinear_equals_the_reference(shape):
    np.testing.assert_allclose(_draw(initializer.Bilinear(), shape),
                               jinit.Bilinear()("weight", shape), atol=1e-7)


def test_lstm_bias_equals_the_reference():
    np.testing.assert_array_equal(
        _draw(initializer.LSTMBias(2.0), (16,), "lstm0_i2h_bias"),
        jinit.LSTMBias(2.0)("lstm0_i2h_bias", (16,)))


def test_mixed_routes_by_the_first_matching_pattern():
    """The first pattern searched in the name picks the initializer (a
    bias still takes 0 by the name convention, in both packages)."""
    mixed = initializer.Mixed(["conv", ".*"],
                              [initializer.Constant(3.0), "ones"])
    jmixed = jinit.Mixed(["conv", ".*"], [jinit.Constant(3.0), "ones"])
    for name, shape in (("conv0_weight", (2,)), ("dense0_weight", (2, 2)),
                        ("conv0_bias", (3,))):
        np.testing.assert_array_equal(_draw(mixed, shape, name),
                                      jmixed(name, shape), err_msg=name)
    with pytest.raises(ValueError, match="no initializer pattern"):
        _draw(initializer.Mixed(["bias"], ["zeros"]), (2,), "w")
    net = nn.Dense(2, in_units=3)
    net.initialize(initializer.Mixed([".*weight", ".*"],
                                     [initializer.Constant(0.5), "zeros"]))
    np.testing.assert_array_equal(net.weight.data().asnumpy(),
                                  np.full((2, 3), 0.5))


def test_load_takes_arrays_by_name_from_a_reference_file(tmp_path):
    f = str(tmp_path / "w.params")
    w = _normal(2, 3)
    jnd.save(f, {"arg:dense9_weight": jnd.array(w)})
    load = initializer.Load(f, default_init=initializer.Constant(7.0))
    np.testing.assert_array_equal(_draw(load, (2, 3), "dense9_weight"), w)
    np.testing.assert_array_equal(_draw(load, (2,), "prelu0_alpha"),
                                  np.full(2, 7.0))
    with pytest.raises(ValueError, match="shape mismatch"):
        _draw(load, (3, 2), "dense9_weight")
    with pytest.raises(ValueError, match="no default_init"):
        _draw(initializer.Load({"a": w}), (2,), "b")


@pytest.mark.parametrize("shape", [(32, 1, 3, 3), (32, 3, 3, 1),
                                   (64, 8, 3, 3), (64, 3, 3, 8),
                                   (10, 4), (7,)])
@pytest.mark.parametrize("factor", ["in", "out", "avg"])
def test_fan_reads_grouped_and_depthwise_weights_as_the_reference(shape,
                                                                  factor):
    """A depthwise weight is ``(C, 1, kh, kw)`` channels-first and
    ``(C, kh, kw, 1)`` channels-last (MobileNet's): the fan is the
    reference's reading of that shape."""
    assert _fan(shape, factor) == jfan(shape, factor)
    with layout.default_layout("NHWC"):
        conv = nn.Conv2D(32, 3, groups=32, in_channels=32)
    assert conv._reg_params["weight"]._ref_shape() == (32, 3, 3, 1)


def test_clip_halves_the_gradient_at_its_bounds_as_the_reference():
    """The reference's ``clip`` is ``jnp.clip``: at a bound the gradient
    is 1/2 (``torch.clamp`` would pass it whole); MobileNet's ReLU6
    meets the lower bound at exact zeros."""
    _op("clip", (np.array([[0.0, 6.0, 3.0, -1.0, 7.0, 0.0]], np.float32),),
        dict(a_min=0.0, a_max=6.0))
    _op("clip", (_normal(3, 4),), dict(a_min=-0.5, a_max=None))
