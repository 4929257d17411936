"""The port's vision zoo against the reference: what every family's
parity test shares, and the zoo's own surface (``get_model`` over every
factory, ``pretrained=True`` refused, the hard-coded ``Dropout(0.5)``).

A family is held against the reference through its own class at a thin
configuration (the full widths take minutes a forward in the
reference's eager CPU path): the reference's net is built, given the
recipe's Xavier weights (zero biases) and run once to fix its shapes;
its ``collect_params()`` goes into the port's net with ``load_numpy``.
JAX's and PyTorch's random streams cannot agree, so every
``nn.Dropout``'s rate is set to 0 on both built nets before a training
pass, the same way on both sides; the keep rate and the shared mask are
held by their own test.  Each family's cases live in their own file, so
that ``--dist loadfile`` spreads them over the workers.
"""
import numpy as np
import pytest
import torch

from tpu_mx import autograd as jag
from tpu_mx import layout as jlayout
from tpu_mx import nd as jnd
from tpu_mx.gluon import loss as jloss
from tpu_mx.gluon import nn as jnn
from tpu_mx.gluon.model_zoo import vision as jvision

import tpu_mx_torch as tmx
from tpu_mx_torch import autograd, layout, nd
from tpu_mx_torch.base import MXNetError
from tpu_mx_torch.gluon import loss as tloss
from tpu_mx_torch.gluon import nn
from tpu_mx_torch.gluon.block import load_numpy
from tpu_mx_torch.gluon.model_zoo import vision

LOGITS_TOL = 2e-4   # test_torch_resnet.py: a net's f32 logits
STEP_TOL = 1e-4     # test_torch_resnet.py: f32 losses and updates


def nhwc(x):
    return np.ascontiguousarray(x.transpose(0, 2, 3, 1))


def images(lay, size, batch=2, seed=11):
    x = np.random.RandomState(seed).rand(batch, 3, size, size) \
        .astype(np.float32)
    return nhwc(x) if lay == "NHWC" else x


def labels(classes, batch=2, seed=12):
    return np.random.RandomState(seed).randint(0, classes, batch) \
        .astype(np.float32)


def ref_params(net):
    return {k: np.array(p.data()._data)
            for k, p in net.collect_params().items()}


def _ref_blocks(block):
    yield block
    for child in block._children.values():
        yield from _ref_blocks(child)


def no_dropout(jnet, net):
    """Every ``nn.Dropout`` of both nets at rate 0."""
    for b in _ref_blocks(jnet):
        if isinstance(b, jnn.Dropout):
            b._rate = 0.0
    for m in net.modules():
        if isinstance(m, nn.Dropout):
            m._rate = 0.0


def pair(build_ref, build_port, lay, x, seed=0):
    """The reference's net (Xavier, shapes fixed by one predict-mode
    forward on ``x``, whose logits are returned too) and the port's,
    built on the host from its arrays.  The reference runs eagerly: its
    hybridized forward under ``record(train_mode=False)`` normalizes
    with batch statistics."""
    with jlayout.default_layout(lay):
        jnet = build_ref()
    np.random.seed(seed)
    jnet.initialize(init="xavier")
    with jag.predict_mode():
        ref = jnet(jnd.array(x)).asnumpy()
    with tmx.cpu(), layout.default_layout(lay):
        net = build_port()
        load_numpy(net, ref_params(jnet))
    return jnet, net, ref


def close(got, want, tol, msg=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, msg
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * max(1.0, np.abs(want).max()),
                               err_msg=msg)


def check_logits(net, x, ref, tol=LOGITS_TOL):
    """The port's predict-mode logits against the reference's."""
    with tmx.cpu():
        out = net(nd.array(x)).asnumpy()
    close(out, ref, tol)


def _ce(record, net, x, label, loss_cls, backward=True):
    with record():
        loss = loss_cls()(net(x), label)
    if backward:
        loss.backward()
    return loss


def check_gradients(jnet, net, x, label, tol=STEP_TOL):
    """Softmax cross-entropy in predict mode (running statistics): the
    losses, the input's gradient and every parameter's gradient agree;
    then in training mode (batch statistics) the losses agree.  The
    gradient through batch statistics of a few samples is ill
    conditioned in float32 (the float32 and float64 runs of either
    package part by up to a few percent on MobileNet's last stages at
    batch 2), so the backward of every layer is held where BatchNorm is
    an affine map."""
    no_dropout(jnet, net)
    jlab = jnd.array(label)
    jx = jnd.array(x)
    jx.attach_grad()
    jl = _ce(lambda: jag.record(train_mode=False), jnet, jx, jlab,
             jloss.SoftmaxCrossEntropyLoss)
    with tmx.cpu():
        tlab = nd.array(label)
        tx = nd.array(x)
        tx.attach_grad()
        tl = _ce(lambda: autograd.record(train_mode=False), net, tx, tlab,
                 tloss.SoftmaxCrossEntropyLoss)
        close(tl.asnumpy(), jl.asnumpy(), tol, "loss")
        close(tx.grad.asnumpy(), jx.grad.asnumpy(), tol, "input gradient")
        jparams = [p for p in jnet.collect_params().values()
                   if p.grad_req != "null"]
        tparams = [p for p in net.collect_params().values()
                   if p.grad_req != "null"]
        assert len(jparams) == len(tparams)
        for jp, tp in zip(jparams, tparams):
            g = tp.grad.asnumpy()
            if tp._axes is not None:        # channels-last, stored OIHW
                g = g.transpose(np.argsort(tp._axes))
            close(g, jp.grad.asnumpy(), tol, jp.name)
    jl = _ce(jag.train_mode, jnet, jnd.array(x), jlab,
             jloss.SoftmaxCrossEntropyLoss, backward=False)
    with tmx.cpu():
        tl = _ce(autograd.train_mode, net, nd.array(x), tlab,
                 tloss.SoftmaxCrossEntropyLoss, backward=False)
        close(tl.asnumpy(), jl.asnumpy(), tol, "training-mode loss")


@pytest.fixture(autouse=True)
def host_setup(monkeypatch):
    # the reference draws its initial weights with numpy; PyTorch's
    # oneDNN CPU convolution corrupts memory in some channels-last
    # backward passes (test_torch_resnet.py), its native one does not
    monkeypatch.setenv("TPUMX_HOST_INIT", "1")
    monkeypatch.setattr(torch.backends.mkldnn, "enabled", False)


# -- the zoo's own surface --------------------------------------------------------
def test_get_model_builds_every_factory_the_reference_registers():
    assert sorted(vision._models) == sorted(jvision._models)
    with tmx.cpu():
        for name in sorted(vision._models):
            if name.startswith("get_"):          # get_resnet, get_vgg
                continue
            net = vision.get_model(name.upper(), classes=7)
            assert {p.device.type for p in net.parameters()} <= {"cpu"}
            assert type(net).__name__ == type(
                jvision.get_model(name, classes=7)).__name__, name
    with pytest.raises(ValueError, match="not in model zoo"):
        vision.get_model("lenet")


@pytest.mark.parametrize("name", ["alexnet", "vgg16", "squeezenet1_0",
                                  "mobilenet1_0", "mobilenet_v2_1_0",
                                  "densenet121", "inception_v3",
                                  "resnet50_v1"])
def test_pretrained_weights_are_refused_by_name(name):
    with tmx.cpu(), pytest.raises(MXNetError, match="pretrained"):
        vision.get_model(name, pretrained=True)


def test_families_follow_the_current_context_and_device():
    # outside ``with mx.cpu():`` the current context is the card
    if not torch.cuda.is_available():
        with pytest.raises(MXNetError, match="no CUDA device"):
            vision.alexnet()
    net = vision.VGG([1], [4], classes=3, batch_norm=True, device="cpu",
                     dtype="bfloat16")
    with tmx.cpu():
        net.initialize("xavier")
        y = net(nd.array(images("NCHW", 8), dtype="bfloat16"))
    assert y.dtype == torch.bfloat16 and y.shape == (2, 3)
    assert {p.dtype for p in net.parameters()} == {torch.bfloat16}


def test_dropout_keeps_half_and_shares_its_mask_along_axes():
    """The zoo's ``Dropout(0.5)``: in training about half the entries
    survive, scaled by 2, and with ``axes`` one draw is shared along
    them, in both packages."""
    x = np.ones((64, 256), np.float32)
    with jag.record():
        ref = jnn.Dropout(0.5)(jnd.array(x)).asnumpy()
        ref_ax = jnn.Dropout(0.5, axes=(0,))(jnd.array(x)).asnumpy()
    with tmx.cpu():
        with autograd.record():
            out = nn.Dropout(0.5)(nd.array(x)).asnumpy()
            out_ax = nn.Dropout(0.5, axes=(0,))(nd.array(x)).asnumpy()
    for y in (ref, out):
        assert set(np.unique(y)) <= {0.0, 2.0}
        assert abs((y != 0).mean() - 0.5) < 0.02
    for y in (ref_ax, out_ax):
        assert (y == y[:1]).all() and 0.35 < (y[0] != 0).mean() < 0.65


def test_from_numpy_builds_a_family_net_from_the_references_arrays():
    """``ZooNet.from_numpy`` builds the port's net under ``layout`` on
    ``device`` and fills its deferred slots from the reference's
    ``collect_params()``: the same logits."""
    x = images("NHWC", 16)
    with jlayout.default_layout("NHWC"):
        jnet = jvision.VGG([1, 1], [4, 8], classes=10, batch_norm=True)
    np.random.seed(0)
    jnet.initialize(init="xavier")
    with jag.predict_mode():
        ref = jnet(jnd.array(x)).asnumpy()
    net = vision.VGG.from_numpy(ref_params(jnet), [1, 1], [4, 8],
                                classes=10, batch_norm=True, layout="NHWC",
                                device="cpu")
    assert {p.device.type for p in net.parameters()} == {"cpu"}
    check_logits(net, x, ref)
