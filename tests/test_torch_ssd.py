"""The port's SSD slice against the JAX reference, on the CPU.

``ops.pick`` with the reference's index semantics (negative indices
wrap, indices out of range read NaN), ``L2Normalization``,
``HuberLoss``, ``Constant``, the detection operators of
``ndarray.contrib``, the SSD model with both backbones, ``detect`` and
the benchmark's SSD train step.  Inputs and weights are made with numpy
from a seed and fed to both packages; the reference's
``collect_params()`` is carried into the port with ``from_numpy``.
Small sizes: 64x64 images, batch 1-2, a few dozen anchors for the
operators.
"""
import inspect
import math

import numpy as np
import pytest
import torch

import tpu_mx as mx
from tpu_mx import autograd, gluon, nd
from tpu_mx.gluon.block import HybridBlock as JHybridBlock
from tpu_mx.models import ssd as jssd
from tpu_mx.parallel import CompiledTrainStep as JCompiledTrainStep

from tpu_mx_torch import initializer, optimizer
from tpu_mx_torch.base import MXNetError
from tpu_mx_torch.gluon import loss as tloss
from tpu_mx_torch.gluon.block import HybridBlock
from tpu_mx_torch.models import ssd
from tpu_mx_torch.ndarray import contrib, ops
from tpu_mx_torch.parallel import CompiledTrainStep

OP_TOL = 1e-5       # one f32 operator, two implementations
PRIOR_TOL = 1e-6    # anchors: the same float32 arithmetic
MODEL_RTOL = 1e-4   # the VGG16-reduced forward, relative to max |output|
STEP_TOL = 1e-4     # three f32 SGD steps: losses (relative)
UPDATE_TOL = 1e-2   # per-tensor change over the steps, relative in norm
UPDATE_ATOL = 1e-5  # the same, for a tensor that gets no gradient
BF16_TOL = 2e-2     # bf16 results, relative

# the benchmark's smoke net (bench.py::_ssd_once with smoke)
SMOKE = dict(num_classes=3, sizes=[[0.2, 0.35], [0.5, 0.7]],
             ratios=[[1, 2, 0.5]] * 2, base_filters=(8, 16))


@pytest.fixture(autouse=True)
def _host_init(monkeypatch):
    # the reference draws its initial weights with numpy, not with a
    # compiled program per shape; the values are replaced anyway
    monkeypatch.setenv("TPUMX_HOST_INIT", "1")


@pytest.fixture(autouse=True)
def _native_cpu_convolution(monkeypatch):
    # the port's CPU tests run PyTorch's native CPU convolutions (oneDNN's
    # corrupt memory in some channels-last backwards, ROADMAP queue C)
    monkeypatch.setattr(torch.backends.mkldnn, "enabled", False)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    return x.asnumpy() if hasattr(x, "asnumpy") else x


def _close(a, b, tol, msg=""):
    np.testing.assert_allclose(_np(a), _np(b), rtol=tol, atol=tol,
                               err_msg=msg)


def _ref_params(block):
    return {k: np.array(p.data()._data)
            for k, p in block.collect_params().items()}


def _boxes(rng, n, lo=0.0, hi=1.0):
    """``n`` corner boxes inside ``[lo, hi]``, float32."""
    p = np.sort(rng.uniform(lo, hi, (n, 2, 2)), axis=1)
    return p.transpose(0, 2, 1).reshape(n, 4).astype(np.float32)


# -- C6: pick ---------------------------------------------------------------------
@pytest.mark.parametrize("axis", [-1, 0])
def test_pick_wraps_negative_and_fills_out_of_range_as_the_reference(axis):
    c = 4
    idx = np.arange(-c - 1, c + 1).astype(np.float32)    # -5 ... 4
    rng = np.random.RandomState(0)
    shape = (len(idx), c) if axis == -1 else (c, len(idx))
    x = rng.randn(*shape).astype(np.float32)
    w = rng.randn(len(idx)).astype(np.float32)
    xj = nd.array(x)
    xj.attach_grad()
    with autograd.record():
        yj = nd.pick(xj, nd.array(idx), axis=axis)
        (yj * nd.array(w)).sum().backward()
    xt = _t(x).requires_grad_()
    yt = ops.pick(xt, _t(idx), axis=axis)
    (yt * _t(w)).sum().backward()
    ref = yj.asnumpy()
    assert np.isnan(ref).tolist() == torch.isnan(yt).tolist() \
        == [True] + [False] * (2 * c) + [True]        # -C-1 and C read NaN
    np.testing.assert_array_equal(yt.detach().numpy(), ref)
    np.testing.assert_array_equal(xt.grad.numpy(), xj.grad.asnumpy())


def test_pick_keepdims_and_integer_fill_follow_the_reference():
    x = np.arange(12, dtype=np.int32).reshape(3, 4)
    idx = np.array([-1, 4, 1], np.float32)
    ref = nd.pick(nd.array(x, dtype="int32"), nd.array(idx), keepdims=True)
    got = ops.pick(_t(x), _t(idx), keepdims=True)
    assert tuple(got.shape) == ref.shape == (3, 1)
    np.testing.assert_array_equal(got.numpy(), ref.asnumpy())


def test_softmax_ce_reads_ignored_labels_as_the_last_class():
    """``MultiBoxTarget``'s ``ignore_label=-1`` goes straight into the
    loss in the benchmark: the reference counts ``-log p(last class)``."""
    rng = np.random.RandomState(1)
    pred = rng.randn(2, 5, 4).astype(np.float32)
    label = np.array([[-1, 0, 3, -1, 2], [1, -1, -1, 0, 3]], np.float32)
    ref = gluon.loss.SoftmaxCrossEntropyLoss()(nd.array(pred),
                                               nd.array(label))
    got = tloss.SoftmaxCrossEntropyLoss()(_t(pred), _t(label))
    _close(got, ref, OP_TOL)


# -- L2Normalization, HuberLoss, Constant ----------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["instance", "channel", "spatial"])
def test_l2_normalization_matches_the_reference(mode, dtype):
    x = np.random.RandomState(2).randn(2, 6, 5, 3).astype(np.float32)
    ref = nd.L2Normalization(nd.array(x).astype(dtype), mode=mode)
    got = ops.L2Normalization(_t(x).to(getattr(torch, dtype)), mode=mode)
    assert got.dtype == getattr(torch, dtype)
    tol = OP_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(got.float().numpy(),
                               ref.astype("float32").asnumpy(),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("rho,weight,sample", [(1.0, None, False),
                                               (0.5, 2.0, True)])
def test_huber_loss_matches_the_reference(rho, weight, sample):
    rng = np.random.RandomState(3)
    pred = (rng.randn(4, 12) * 2).astype(np.float32)
    label = (rng.randn(4, 3, 4) * 2).astype(np.float32)   # reshaped like pred
    sw = rng.rand(4, 1).astype(np.float32) if sample else None
    ref = gluon.loss.HuberLoss(rho=rho, weight=weight)(
        nd.array(pred), nd.array(label),
        None if sw is None else nd.array(sw))
    got = tloss.HuberLoss(rho=rho, weight=weight)(
        _t(pred), _t(label), None if sw is None else _t(sw))
    assert tuple(got.shape) == (4,)
    _close(got, ref, OP_TOL)


def test_constant_initializer_is_registered_and_kept_by_initialize():
    assert initializer.create("constant").value == 0.0
    c = initializer.Constant(2.5)("w", (2, 3), torch.bfloat16,
                                  torch.Generator())
    assert c.dtype == torch.bfloat16 and bool((c == 2.5).all())
    # the name convention still comes first, as in the reference
    assert bool((initializer.Constant(7.0)("b_bias", (2,), torch.float32,
                                           torch.Generator()) == 0).all())
    net = ssd.VGG16ReducedFeatures(generator=torch.Generator())
    net.initialize("xavier", torch.Generator().manual_seed(1))
    assert tuple(net.norm4.scale.shape) == (1, 512, 1, 1)
    assert bool((net.norm4.scale == 20.0).all())


# -- the detection operators ------------------------------------------------------
@pytest.mark.parametrize("fmt", ["corner", "center"])
def test_box_iou_matches_the_reference(fmt):
    rng = np.random.RandomState(4)
    a, b = _boxes(rng, 12).reshape(2, 6, 4), _boxes(rng, 8).reshape(2, 4, 4)
    ref = nd.contrib.box_iou(nd.array(a), nd.array(b), format=fmt)
    got = contrib.box_iou(_t(a), _t(b), format=fmt)
    assert tuple(got.shape) == ref.shape == (2, 6, 4)
    _close(got, ref, OP_TOL)


PRIOR_CASES = [
    dict(sizes=(0.5, 0.25), ratios=(1, 2)),
    dict(sizes=(0.9,), clip=True),
    dict(sizes=(0.3, 0.4), ratios=(1, 2, 0.5, 3, 1.0 / 3), clip=True),
    dict(sizes=(0.2,), ratios=(1, 0.5), steps=(0.1, 0.2), offsets=(0.3, 0.6)),
    dict(sizes="(0.07, 0.1025)", ratios="[1, 2, 0.5]"),
]


@pytest.mark.parametrize("kw", PRIOR_CASES, ids=range(len(PRIOR_CASES)))
def test_multibox_prior_matches_the_reference(kw):
    x = np.zeros((1, 3, 5, 7), np.float32)
    ref = nd.contrib.MultiBoxPrior(nd.array(x), **kw)
    got = contrib.MultiBoxPrior(_t(x), **kw)
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape
    _close(got, ref, PRIOR_TOL)


def _target_case(name):
    """``(anchors, labels, cls_pred, kwargs)`` of one MultiBoxTarget case."""
    rng = np.random.RandomState(5)
    mining = dict(negative_mining_ratio=3.0, negative_mining_thresh=0.5)
    if name == "basic":                  # tests/test_contrib_det.py
        anc = np.array([[0.1, 0.1, 0.3, 0.3], [0.5, 0.5, 0.9, 0.9],
                        [0.0, 0.0, 0.05, 0.05]], np.float32)[None]
        lab = np.array([[[1, 0.1, 0.1, 0.3, 0.3], [-1] * 5]], np.float32)
        return anc, lab, np.zeros((1, 3, 3), np.float32), {}
    if name == "shared_best_anchor":
        # both boxes' best anchor is anchor 1 (under the threshold for
        # box 0): the later box's write stands
        anc = np.array([[0.0, 0.0, 0.2, 0.2], [0.3, 0.3, 0.6, 0.6],
                        [0.7, 0.7, 0.9, 0.9]], np.float32)[None]
        lab = np.array([[[0, 0.25, 0.25, 0.55, 0.7],
                         [2, 0.3, 0.3, 0.62, 0.6]]], np.float32)
        return anc, lab, rng.randn(1, 4, 3).astype(np.float32), {}
    if name == "padded_after_valid":
        # box 0's best anchor is anchor 0 (IoU under 0.5); the padded row
        # after it also writes anchor 0 (its argmax over zeros), last
        anc = np.array([[0.1, 0.1, 0.4, 0.4], [0.6, 0.6, 0.9, 0.9]],
                       np.float32)[None]
        lab = np.array([[[1, 0.1, 0.1, 0.25, 0.45], [-1] * 5]], np.float32)
        return anc, lab, rng.randn(1, 3, 2).astype(np.float32), {}
    anc = np.concatenate([np.array([[0.1, 0.1, 0.4, 0.4]], np.float32),
                          _boxes(rng, 40)])[None]
    lab = np.full((3, 3, 5), -1, np.float32)
    for b, n in enumerate((1, 2, 3)):
        for m in range(n):
            x0, y0 = rng.uniform(0.05, 0.5, 2)
            lab[b, m] = [rng.randint(0, 3), x0, y0, x0 + 0.3, y0 + 0.35]
    lab[2, 1] = -1                               # a padded row between two
    pred = rng.randn(3, 4, 41).astype(np.float32)
    if name == "random":
        return anc, lab, pred, {}
    if name == "mining":
        return anc, lab, pred, mining
    if name == "mining_bf16_ties":
        # logits rounded through bf16, coarsely, so hardness values tie
        pred = np.round(pred * 2) / 2
        pred = torch.from_numpy(pred).bfloat16().float().numpy()
        return anc, lab, pred, dict(mining, minimum_negative_samples=5)
    raise KeyError(name)


TARGET_CASES = ["basic", "shared_best_anchor", "padded_after_valid",
                "random", "mining", "mining_bf16_ties"]


@pytest.mark.parametrize("case", TARGET_CASES)
def test_multibox_target_matches_the_reference(case):
    anc, lab, pred, kw = _target_case(case)
    ref = nd.contrib.MultiBoxTarget(nd.array(anc), nd.array(lab),
                                    nd.array(pred), **kw)
    got = contrib.MultiBoxTarget(_t(anc), _t(lab), _t(pred), **kw)
    for name, g, r in zip(("loc_target", "loc_mask", "cls_target"), got,
                          ref):
        assert tuple(g.shape) == r.shape and g.dtype == torch.float32, name
        assert not g.requires_grad
    _close(got[0], ref[0], OP_TOL, "loc_target")
    np.testing.assert_array_equal(got[1].numpy(), ref[1].asnumpy())
    np.testing.assert_array_equal(got[2].numpy(), ref[2].asnumpy())
    if kw:
        assert (got[2] == -1).any() and (got[2] == 0).any()


def test_multibox_target_scatter_cases_pin_the_later_write():
    """What the two scatter cases hold, spelled out."""
    _, _, cls_t = contrib.MultiBoxTarget(
        *map(_t, _target_case("shared_best_anchor")[:3]))
    assert cls_t[0].tolist() == [0.0, 3.0, 0.0]      # box 1 (class 2) wins
    _, mask, cls_t = contrib.MultiBoxTarget(
        *map(_t, _target_case("padded_after_valid")[:3]))
    assert cls_t[0].tolist() == [0.0, 0.0] and not mask.any()


NMS_CASES = {
    "basic": dict(overlap_thresh=0.5, valid_thresh=0.01, id_index=0),
    "force": dict(overlap_thresh=0.5, valid_thresh=0.01, id_index=0,
                  force_suppress=True),
    "topk": dict(overlap_thresh=0.3, valid_thresh=0.01, id_index=0, topk=3),
    "background": dict(overlap_thresh=0.3, id_index=0, background_id=1),
    "no_id": dict(overlap_thresh=0.4),
    "center_in": dict(overlap_thresh=0.4, in_format="center", id_index=0),
    "center_out": dict(overlap_thresh=0.4, out_format="center", topk=5),
}


@pytest.mark.parametrize("case", sorted(NMS_CASES))
def test_box_nms_matches_the_reference(case):
    rng = np.random.RandomState(6)
    n = 24
    rows = np.concatenate([rng.randint(0, 3, (2, n, 1)),
                           rng.rand(2, n, 1),
                           _boxes(rng, 2 * n, 0.0, 0.6).reshape(2, n, 4)],
                          -1).astype(np.float32)
    rows[0, :4, 1] = 0.0                                   # below threshold
    rows[1, 5, 2:] = rows[1, 6, 2:]                        # a duplicate box
    rows = rows.reshape(2, 1, n, 6)                        # extra batch axis
    kw = dict(NMS_CASES[case], coord_start=2, score_index=1)
    ref = nd.contrib.box_nms(nd.array(rows), **kw)
    got = contrib.box_nms(_t(rows), **kw)
    assert tuple(got.shape) == ref.shape
    _close(got, ref, OP_TOL)
    kept = (got[..., 1] > -1).sum()
    assert 0 < kept < 2 * n


def test_box_nms_reference_cases():
    """``tests/test_contrib_det.py``'s cases, through the port."""
    boxes = np.array([[0, 0.9, 0.1, 0.1, 0.5, 0.5],
                      [0, 0.8, 0.12, 0.12, 0.52, 0.52],
                      [0, 0.7, 0.6, 0.6, 0.9, 0.9],
                      [1, 0.6, 0.1, 0.1, 0.5, 0.5],
                      [0, 0.0, 0, 0, 0, 0]], np.float32)
    kw = dict(overlap_thresh=0.5, valid_thresh=0.01, id_index=0,
              coord_start=2, score_index=1)
    for force, kept in ((False, [0.6, 0.7, 0.9]), (True, [0.7, 0.9])):
        out = contrib.box_nms(_t(boxes), force_suppress=force, **kw)
        ref = nd.contrib.box_nms(nd.array(boxes), force_suppress=force, **kw)
        _close(out, ref, OP_TOL)
        np.testing.assert_allclose(
            sorted(out[out[:, 1] > 0][:, 1].tolist()), kept, rtol=1e-6)


@pytest.mark.parametrize("nms_topk", [-1, 6, 40])
@pytest.mark.parametrize("force", [False, True])
def test_multibox_detection_matches_the_reference(nms_topk, force):
    rng = np.random.RandomState(7)
    a = 30
    anc = _boxes(rng, a, 0.1, 0.9)[None]
    logits = rng.randn(2, 4, a).astype(np.float32) * 2
    prob = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    loc = (rng.randn(2, a * 4) * 0.5).astype(np.float32)
    kw = dict(threshold=0.2, nms_threshold=0.3, nms_topk=nms_topk,
              force_suppress=force)
    ref = nd.contrib.MultiBoxDetection(nd.array(prob), nd.array(loc),
                                       nd.array(anc), **kw)
    got = contrib.MultiBoxDetection(_t(prob), _t(loc), _t(anc), **kw)
    assert tuple(got.shape) == ref.shape == (2, a, 6)
    _close(got, ref, OP_TOL)
    assert (got[..., 0] >= 0).any() and (got[..., 0] == -1).any()


def test_multibox_detection_decodes_what_target_encodes():
    """The reference's round trip: MultiBoxTarget's location target
    decodes back to the ground-truth box."""
    anc = np.array([[0.15, 0.15, 0.35, 0.45], [0.5, 0.5, 0.9, 0.9]],
                   np.float32)[None]
    gt = np.array([[[0, 0.1, 0.2, 0.4, 0.4]]], np.float32)
    loc_t, _, cls_t = contrib.MultiBoxTarget(
        _t(anc), _t(gt), torch.zeros(1, 2, 2), overlap_threshold=0.3)
    assert cls_t[0, 0] == 1.0
    prob = torch.tensor([[[0.1, 0.9], [0.9, 0.1]]])
    det = contrib.MultiBoxDetection(prob, loc_t, _t(anc), threshold=0.5,
                                    clip=False)[0, 0]
    assert det[0] == 0.0 and abs(float(det[1]) - 0.9) < 1e-6
    _close(det[2:], np.array([0.1, 0.2, 0.4, 0.4], np.float32), OP_TOL)


@pytest.mark.parametrize("is_ascend,threshold,topk", [
    (False, 0.3, -1), (True, 0.6, -1), (False, 0.1, 2), (False, 2.0, -1)])
def test_bipartite_matching_matches_the_reference(is_ascend, threshold,
                                                  topk):
    rng = np.random.RandomState(8)
    s = np.round(rng.rand(3, 5, 4), 1).astype(np.float32)   # ties
    ref = nd.contrib.bipartite_matching(nd.array(s), is_ascend=is_ascend,
                                        threshold=threshold, topk=topk)
    got = contrib.bipartite_matching(_t(s), is_ascend=is_ascend,
                                     threshold=threshold, topk=topk)
    for g, r in zip(got, ref):
        assert tuple(g.shape) == r.shape
        np.testing.assert_array_equal(g.numpy(), r.asnumpy())
    with pytest.raises(ValueError):
        contrib.bipartite_matching(_t(s))


# -- the model ---------------------------------------------------------------------
def _ssd_pair(perturb=True, **kw):
    """The reference's ``SSD(**kw)`` with the recipe's Xavier weights
    (zero biases) or, with ``perturb``, seeded normal weights, biases and
    running statistics; and the port's built from its
    ``collect_params()``."""
    jnet = jssd.SSD(**kw)
    jnet.initialize(init="xavier")
    rng = np.random.RandomState(0)
    for name, p in jnet.collect_params().items() if perturb else ():
        if name.endswith("running_var"):
            v = rng.uniform(0.5, 1.5, p.shape)
        elif name.endswith(("bias", "beta", "running_mean")):
            v = rng.randn(*p.shape) * 0.1
        else:
            v = rng.randn(*p.shape) * math.sqrt(2.0 / np.prod(p.shape[1:]))
        p.set_data(nd.array(v.astype(np.float32)))
    params = _ref_params(jnet)
    return jnet, ssd.SSD.from_numpy(params, device="cpu", **kw), params


@pytest.fixture(scope="module")
def smoke_pair():
    return _ssd_pair(**SMOKE)


def _forward_check(jnet, net, x, tol):
    ref = jnet(nd.array(x))
    with torch.no_grad():
        got = net.eval()(_t(x))
    for name, g, r in zip(("anchors", "cls_preds", "box_preds"), got, ref):
        assert tuple(g.shape) == r.shape, name
        r = r.asnumpy()
        scale = max(1.0, float(np.abs(r).max()))
        np.testing.assert_allclose(g.numpy(), r, rtol=0,
                                   atol=tol * scale, err_msg=name)
    return got


def _names_match(net, params):
    ours = list(net.collect_params().items())
    assert len(ours) == len(params)
    for (name, t), (ref, arr) in zip(ours, params.items()):
        assert ref.endswith("_" + name.rsplit(".", 1)[-1]), (name, ref)
        assert tuple(t.shape) == arr.shape, (name, ref)


def test_smoke_ssd_matches_the_reference(smoke_pair):
    jnet, net, params = smoke_pair
    _names_match(net, params)
    x = np.random.RandomState(9).rand(2, 3, 64, 64).astype(np.float32)
    anchors, cls_preds, box_preds = _forward_check(jnet, net, x, OP_TOL)
    with torch.no_grad():
        assert net(_t(x[:1]))[0] is anchors      # made once per image size
    a = 16 * 16 * 4 + 8 * 8 * 4
    assert tuple(anchors.shape) == (1, a, 4)
    assert tuple(cls_preds.shape) == (2, a, 4)
    assert tuple(box_preds.shape) == (2, a * 4)


def test_vgg16_reduced_ssd_512_matches_the_reference():
    kw = dict(num_classes=20, backbone="vgg16_reduced")
    jnet = jssd.ssd_512(**kw)
    jnet.initialize(init="xavier")
    params = _ref_params(jnet)
    net = ssd.SSD.from_numpy(params, 20, jnet.sizes, jnet.ratios,
                             backbone="vgg16_reduced", device="cpu")
    _names_match(net, params)
    # the scale keeps its Constant(20) through initialize("xavier")
    assert bool((net.backbone.norm4.scale == 20.0).all())
    x = np.random.RandomState(10).rand(1, 3, 64, 64).astype(np.float32)
    anchors, _, _ = _forward_check(jnet, net, x, MODEL_RTOL)
    # maps 8/4/2/1/1/1/1 at 64x64, 4/6/6/6/6/4/4 anchors a position
    assert anchors.shape[1] == 8 * 8 * 4 + 4 * 4 * 6 + 2 * 2 * 6 + 6 + 6 \
        + 4 + 4


def test_vgg16_reduced_ceil_mode_pools_match_the_reference():
    """The small-map equivalent of SSD-300's 75 -> 38 pool: at 36x36 the
    third pool sees a 9x9 map (ceil 5, not 4) and pool4 a 5x5 one."""
    jnet = jssd.VGG16ReducedFeatures()
    jnet.initialize(init="xavier")
    net = ssd.VGG16ReducedFeatures(generator=torch.Generator())
    from tpu_mx_torch.gluon.block import load_numpy
    load_numpy(net, _ref_params(jnet))
    x = np.random.RandomState(11).rand(1, 3, 36, 36).astype(np.float32)
    ref = jnet(nd.array(x))
    with torch.no_grad():
        got = net(_t(x))
    assert [tuple(g.shape) for g in got] == [r.shape for r in ref] \
        == [(1, 512, 5, 5), (1, 1024, 3, 3)]
    for g, r in zip(got, ref):
        r = r.asnumpy()
        np.testing.assert_allclose(g.numpy(), r, rtol=0,
                                   atol=MODEL_RTOL * np.abs(r).max())


def test_ssd_300_anchor_count_follows_the_reference_geometry():
    """SSD-300's canonical 8732 anchors, counted from the maps the port's
    layers give (38/19/10/5/3/1), without running the 300x300 net."""
    net = ssd.ssd_300(num_classes=3, backbone="vgg16_reduced", device="cpu",
                      generator=torch.Generator())
    k = [len(s) + len(r) - 1 for s, r in zip(net.sizes, net.ratios)]
    m, maps = 300, []
    for _ in range(3):
        m = math.ceil(m / 2)
    maps.append(m)                                   # conv4_3
    maps.append(math.ceil(m / 2))                    # pool4 (ceil), fc7
    for blk in net.scale_blocks:
        conv = blk[3]
        s, p = conv._strides[0], conv._padding[0]
        maps.append((maps[-1] + 2 * p - 3) // s + 1)
    assert maps == [38, 19, 10, 5, 3, 1]
    assert sum(n * n * kk for n, kk in zip(maps, k)) == 8732


def test_detect_matches_the_reference(smoke_pair):
    jnet, net, _ = smoke_pair
    x = np.random.RandomState(12).rand(1, 3, 64, 64).astype(np.float32)
    ref = jnet.detect(nd.array(x), threshold=0.3)
    net.train()
    got = net.detect(_t(x), threshold=0.3)
    assert net.training                       # the mode is restored
    assert tuple(got.shape) == ref.shape == (1, 1280, 6)
    _close(got, ref, OP_TOL)
    kept = got[0][got[0, :, 0] >= 0]
    assert kept.shape[0] >= 1 and bool(torch.isfinite(kept).all())


# -- the benchmark's train step ---------------------------------------------------
class JSSDTrain(JHybridBlock):
    """The reference benchmark's SSD objective (``bench.py::_ssd_once``)."""

    def __init__(self, net, **kw):
        super().__init__(**kw)
        self.net = net
        self._targets = jssd.SSDTrainingTargets()
        self._cls = gluon.loss.SoftmaxCrossEntropyLoss()
        self._box = gluon.loss.HuberLoss()

    def forward(self, x, labels):
        anchors, cls_preds, box_preds = self.net(x)
        anchors = nd.cast(anchors, "float32")
        cls_preds = nd.cast(cls_preds, "float32")
        box_preds = nd.cast(box_preds, "float32")
        with autograd.pause():
            loc_t, loc_m, cls_t = self._targets(anchors, labels, cls_preds)
        return self._cls(cls_preds, cls_t) + \
            self._box(box_preds * loc_m, loc_t * loc_m)


class SSDTrain(HybridBlock):
    """The same objective for the port (as ``chip_smoke.ssd_train_block``
    builds it)."""

    def __init__(self, net):
        super().__init__()
        self.net = net
        self._targets = ssd.SSDTrainingTargets()
        self._cls = tloss.SoftmaxCrossEntropyLoss()
        self._box = tloss.HuberLoss()

    def forward(self, x, labels):
        anchors, cls_preds, box_preds = (t.float() for t in self.net(x))
        with torch.no_grad():
            loc_t, loc_m, cls_t = self._targets(anchors, labels, cls_preds)
        return self._cls(cls_preds, cls_t) + \
            self._box(box_preds * loc_m, loc_t * loc_m)


def _bench_labels(batch, classes, seed=0):
    """``bench.py::_ssd_once``'s labels: one box an image and a padding
    row."""
    rng = np.random.RandomState(seed)
    labels = np.full((batch, 2, 5), -1.0, np.float32)
    for b in range(batch):
        cls = rng.randint(0, classes)
        x0, y0 = rng.uniform(0.05, 0.5, 2)
        labels[b, 0] = [cls, x0, y0, min(x0 + 0.3, 0.95),
                        min(y0 + 0.3, 0.95)]
    return labels


def _train_steps(n, dtype="float32", batch=2):
    # the recipe's initialization: with the perturbed biases the
    # reference's float32 BatchNorm backward drifts ~0.3% a step from the
    # float64 result (the port's stays within 1e-4 of it; ROADMAP, "Red
    # on the reference side")
    jnet, net, _ = _ssd_pair(perturb=False, **SMOKE)
    jw, w = JSSDTrain(jnet), SSDTrain(net)
    x = np.random.RandomState(13).uniform(0, 0.1, (batch, 3, 64, 64)) \
        .astype(np.float32)
    labels = _bench_labels(batch, SMOKE["num_classes"])
    jw.finalize_shapes(nd.array(x), nd.array(labels))
    xj, xt = nd.array(x), _t(x)
    if dtype != "float32":
        jw.cast(dtype)
        w.cast(dtype)
        xj, xt = nd.cast(xj, dtype), xt.to(getattr(torch, dtype))
    kw = dict(learning_rate=0.01, momentum=0.9, wd=5e-4,
              multi_precision=dtype != "float32")
    jstep = JCompiledTrainStep(jw, gluon.loss.PassThrough(),
                               mx.optimizer.create("sgd", **kw))
    step = CompiledTrainStep(w, tloss.PassThrough(),
                             optimizer.create("sgd", **kw), device="cpu")
    dummy = np.zeros((1,), np.float32)
    before = {k: t.detach().clone() for k, t in w.collect_params().items()}
    jl = [float(np.asarray(jstep.step(xj, nd.array(labels),
                                      nd.array(dummy))._data).ravel()[0])
          for _ in range(n)]
    tl = [float(step.step(xt, _t(labels), _t(dummy))) for _ in range(n)]
    return jl, tl, jstep, jw, w, step, before


def test_three_sgd_steps_match_the_reference():
    jl, tl, jstep, jw, w, _, before = _train_steps(3)
    np.testing.assert_allclose(tl, jl, rtol=STEP_TOL)
    assert all(map(math.isfinite, tl))
    ref = {k: np.array(v) for k, v in jstep.values.items()}
    assert len(ref) == len(before)
    for (name, t), key in zip(w.collect_params().items(),
                              jw.collect_params().keys()):
        moved = t.detach() - before[name]
        ref_moved = _t(ref[key]) - before[name]
        diff, size = float((moved - ref_moved).norm()), \
            float(ref_moved.norm())
        if size <= UPDATE_ATOL:     # a conv bias in front of a BatchNorm:
            assert diff <= UPDATE_ATOL, name       # no gradient, wd on 0
        else:
            assert diff / size <= UPDATE_TOL, name


def test_float32_steps_hold_to_float64_with_offset_conv_biases():
    """With conv biases of N(0, 0.1) the BatchNorm inputs carry channel
    means large against their spread, where a one-pass float32 backward
    loses digits: the port's float32 steps stay with its float64 ones."""
    x = np.random.RandomState(13).uniform(0, 0.1, (2, 3, 64, 64)) \
        .astype(np.float32)
    labels = _bench_labels(2, SMOKE["num_classes"])
    moved = {}
    for dtype in (torch.float32, torch.float64):
        _, net, _ = _ssd_pair(**SMOKE)
        w = SSDTrain(net.to(dtype))
        step = CompiledTrainStep(w, tloss.PassThrough(), optimizer.create(
            "sgd", learning_rate=0.01, momentum=0.9, wd=5e-4), device="cpu")
        before = {k: t.detach().clone() for k, t in w.collect_params().items()}
        for _ in range(3):
            step.step(_t(x).to(dtype), _t(labels).to(dtype),
                      torch.zeros(1, dtype=dtype))
        moved[dtype] = {k: (t.detach() - before[k]).double()
                        for k, t in w.collect_params().items()}
    for name, ref in moved[torch.float64].items():
        diff = float((moved[torch.float32][name] - ref).norm())
        # the float32 weights themselves are kept to ~1e-7 of their size,
        # which bounds how well a small change can be read from them
        floor = 1e-6 * float(before[name].norm())
        assert diff <= 1e-3 * float(ref.norm()) + floor, name


def test_bfloat16_first_loss_matches_the_reference():
    jl, tl, _, _, w, step, _ = _train_steps(1, dtype="bfloat16")
    assert abs(tl[0] - jl[0]) <= BF16_TOL * abs(jl[0])
    assert all(t.dtype == torch.bfloat16
               for t in w.collect_params().values())
    assert step.masters and all(v.dtype == torch.float32
                                for v in step.masters.values())


# -- entry points ------------------------------------------------------------------
def test_entry_points_default_to_the_card():
    assert inspect.signature(ssd.SSD.__init__).parameters["device"] \
        .default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(MXNetError, match="no CUDA device"):
            ssd.ssd_512(20, backbone="vgg16_reduced")
        with pytest.raises(MXNetError, match="no CUDA device"):
            ssd.SSD(**SMOKE)
        with pytest.raises(MXNetError, match="no CUDA device"):
            ssd.VGG16ReducedFeatures()             # no generator: the card's
    with pytest.raises(ValueError, match="backbone"):
        ssd.SSD(**SMOKE, backbone="resnet", device="cpu",
                generator=torch.Generator())
