"""The vision operators (``tpu_mx/ndarray/vision_ops.py``) against the JAX
reference, on the CPU.

One case per name and per option that changes the math: the same inputs,
made with numpy from a seed, go through ``tpu_mx.nd`` and
``tpu_mx_torch.nd``, forward and (under ``autograd.record()``, one
random head gradient per output) gradient of every floating input the
reference differentiates: the features, the ROIs' coordinates, the
offsets, the grids, the affine parameters, the deltas.  Tolerance: 1e-5
of the output's largest entry (float32 gathers, bilinear weights and
sums); ``Correlation``'s channel sums 1e-5 too.  The resize cases hold
``BilinearResize2D`` and ``UpSampling`` to ``jax.image.resize``'s half-
pixel centres and, where an axis shrinks, its antialiasing.  The
``Proposal`` cases take random scores at a small map (NMS over every
candidate) and check the reference's padding of suppressed rows.
"""
import numpy as np
import pytest
import torch

from tpu_mx import autograd as jag
from tpu_mx import nd as jnd

import tpu_mx_torch as mx
from tpu_mx_torch import autograd, nd

RTOL = 1e-5


@pytest.fixture(autouse=True)
def _host():
    torch.backends.mkldnn.enabled = False
    with mx.cpu():
        yield


def _rs(seed):
    return np.random.RandomState(seed)


def _normal(*shape, seed=0):
    return _rs(seed).randn(*shape).astype(np.float32)


def _rois(n, H, W, stride, seed=0, batch=2):
    """``n`` ROIs ``[batch, x1, y1, x2, y2]`` in image coordinates of a
    ``(H, W)`` map at ``stride``, some reaching past its border."""
    r = _rs(seed)
    x1 = r.uniform(-4, W * stride * 0.7, n)
    y1 = r.uniform(-4, H * stride * 0.7, n)
    w = r.uniform(2, W * stride * 0.6, n)
    h = r.uniform(2, H * stride * 0.6, n)
    b = r.randint(0, batch, n)
    return np.stack([b, x1, y1, x1 + w, y1 + h], 1).astype(np.float32)


def _outs(out):
    outs = out if isinstance(out, (list, tuple)) else [out]
    return outs


def _run(ndm, ag, name, args, kw, grad):
    arrs = [ndm.array(a) if isinstance(a, np.ndarray) else a for a in args]
    for i in grad:
        arrs[i].attach_grad()
    with ag.record():
        out = getattr(ndm, name)(*arrs, **kw)
    outs = _outs(out)
    if grad:
        heads = [ndm.array(_normal(*o.shape, seed=7 + j))
                 for j, o in enumerate(outs)]
        ag.backward(outs, heads)
    return [o.asnumpy() for o in outs], [arrs[i].grad.asnumpy()
                                         for i in grad]


def _same(got, want, rtol, what):
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    w = want.astype(np.float64)
    scale = max(np.abs(w).max(), 1e-30) if w.size else 1.0
    np.testing.assert_allclose(got.astype(np.float64), w, rtol=rtol,
                               atol=rtol * scale, err_msg=what)


FEAT = _normal(2, 6, 9, 11, seed=1)
ROIS = _rois(7, 9, 11, 4.0, seed=2)
PS_FEAT = _normal(2, 3 * 3 * 3, 8, 10, seed=3)            # output_dim 3, g 3
PS_ROIS = _rois(6, 8, 10, 2.0, seed=4)
TRANS = (_normal(6, 2, 3, 3, seed=5) * 0.5).astype(np.float32)
TRANS_CLS = (_normal(6, 6, 2, 2, seed=6) * 0.5).astype(np.float32)
AFFINE = np.tile(np.asarray([[0.9, 0.1, 0.05, -0.2, 1.1, -0.1]],
                            np.float32), (2, 1)) \
    + _normal(2, 6, seed=7) * 0.05
GRID = (_normal(2, 2, 5, 7, seed=8) * 0.8).astype(np.float32)
FLOW = (_normal(2, 2, 6, 5, seed=9) * 2).astype(np.float32)
IMG = _normal(2, 3, 12, 10, seed=10)

CASES = [
    ("ROIPooling", "ROIPooling", [FEAT, ROIS],
     dict(pooled_size=(3, 2), spatial_scale=0.25), (0, 1)),
    ("ROIAlign", "ROIAlign", [FEAT, ROIS],
     dict(pooled_size=(3, 3), spatial_scale=0.25), (0, 1)),
    ("ROIAlign-sample_ratio3", "ROIAlign", [FEAT, ROIS],
     dict(pooled_size=(2, 4), spatial_scale=0.25, sample_ratio=3), (0, 1)),
    ("ROIAlign-position_sensitive", "ROIAlign", [PS_FEAT, PS_ROIS],
     dict(pooled_size=(3, 3), spatial_scale=0.5, position_sensitive=True),
     (0, 1)),
    ("PSROIPooling", "PSROIPooling", [PS_FEAT, PS_ROIS],
     dict(spatial_scale=0.5, output_dim=3, pooled_size=3), (0, 1)),
    ("PSROIPooling-group", "PSROIPooling", [_normal(2, 12, 8, 10, seed=11),
                                            PS_ROIS],
     dict(spatial_scale=0.5, output_dim=3, pooled_size=4, group_size=2),
     (0, 1)),
    ("DeformablePSROIPooling", "DeformablePSROIPooling",
     [PS_FEAT, PS_ROIS, TRANS],
     dict(spatial_scale=0.5, output_dim=3, group_size=3, pooled_size=3,
          part_size=3, sample_per_part=2, trans_std=0.1), (0, 1, 2)),
    ("DeformablePSROIPooling-per-class", "DeformablePSROIPooling",
     [PS_FEAT, PS_ROIS, TRANS_CLS],
     dict(spatial_scale=0.5, output_dim=3, group_size=3, pooled_size=3,
          part_size=2, sample_per_part=3, trans_std=0.2), (0, 1, 2)),
    ("DeformablePSROIPooling-no_trans", "DeformablePSROIPooling",
     [PS_FEAT, PS_ROIS],
     dict(spatial_scale=0.5, output_dim=3, group_size=3, pooled_size=3,
          sample_per_part=2, no_trans=True), (0, 1)),
    ("GridGenerator-affine", "GridGenerator", [AFFINE],
     dict(transform_type="affine", target_shape=(5, 7)), (0,)),
    ("GridGenerator-warp", "GridGenerator", [FLOW],
     dict(transform_type="warp"), (0,)),
    ("BilinearSampler", "BilinearSampler", [IMG, GRID], {}, (0, 1)),
    ("SpatialTransformer", "SpatialTransformer", [IMG, AFFINE],
     dict(target_shape=(6, 5)), (0, 1)),
    ("BilinearResize2D-up", "BilinearResize2D", [IMG],
     dict(height=20, width=17), (0,)),
    ("BilinearResize2D-down", "BilinearResize2D", [IMG],
     dict(height=5, width=4), (0,)),
    ("BilinearResize2D-mixed-scales", "BilinearResize2D", [IMG],
     dict(scale_height=0.5, scale_width=1.7), (0,)),
    ("UpSampling-nearest", "UpSampling", [IMG],
     dict(scale=2, sample_type="nearest"), (0,)),
    ("UpSampling-bilinear", "UpSampling", [IMG],
     dict(scale=3, sample_type="bilinear", num_filter=3), (0,)),
    ("Correlation", "Correlation",
     [_normal(2, 4, 9, 8, seed=12), _normal(2, 4, 9, 8, seed=13)],
     dict(kernel_size=1, max_displacement=2, stride2=1, pad_size=2), (0, 1)),
    ("Correlation-strided-kernel3", "Correlation",
     [_normal(1, 3, 11, 12, seed=14), _normal(1, 3, 11, 12, seed=15)],
     dict(kernel_size=3, max_displacement=4, stride1=2, stride2=2,
          pad_size=3), (0, 1)),
    ("Correlation-subtract", "Correlation",
     [_normal(1, 3, 7, 7, seed=16), _normal(1, 3, 7, 7, seed=17)],
     dict(max_displacement=1, pad_size=1, is_multiply=False), (0, 1)),
]


@pytest.mark.parametrize("cid,name,args,kw,grad", CASES,
                         ids=[c[0] for c in CASES])
def test_vision_operator_matches_the_reference(cid, name, args, kw, grad):
    want, want_g = _run(jnd, jag, name, args, kw, grad)
    got, got_g = _run(nd, autograd, name, args, kw, grad)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        _same(g, w, RTOL, f"{cid} output {i}")
    for i, g, w in zip(grad, got_g, want_g):
        _same(g, w, RTOL, f"{cid} gradient {i}")


def _proposal_inputs(seed, n=2, a=6, hf=5, wf=6):
    r = _rs(seed)
    cls = r.rand(n, 2 * a, hf, wf).astype(np.float32)
    deltas = ((r.rand(n, 4 * a, hf, wf) - 0.5) * 0.4).astype(np.float32)
    im_info = np.asarray([[80, 96, 1.0], [70, 90, 1.5]], np.float32)[:n]
    return cls, deltas, im_info


PROPOSALS = [
    ("default", dict(rpn_pre_nms_top_n=60, rpn_post_nms_top_n=12,
                     scales=(2, 4), ratios=(0.5, 1, 2), rpn_min_size=4)),
    ("output_score", dict(rpn_pre_nms_top_n=40, rpn_post_nms_top_n=20,
                          threshold=0.5, scales=(2, 4), ratios=(0.5, 1, 2),
                          rpn_min_size=4, output_score=True)),
    ("min_size_filters", dict(rpn_pre_nms_top_n=200, rpn_post_nms_top_n=30,
                              scales=(1, 2), ratios=(1, 2, 0.5),
                              rpn_min_size=20, threshold=0.3,
                              output_score=True)),
]


@pytest.mark.parametrize("name", ["Proposal", "MultiProposal"])
@pytest.mark.parametrize("cid,kw", PROPOSALS, ids=[p[0] for p in PROPOSALS])
def test_proposal_matches_the_reference(name, cid, kw):
    args = list(_proposal_inputs(3))
    grad = (1,)
    want, want_g = _run(jnd, jag, name, args, kw, grad)
    got, got_g = _run(nd, autograd, name, args, kw, grad)
    for i, (g, w) in enumerate(zip(got, want)):
        _same(g, w, RTOL, f"{cid} output {i}")
    _same(got_g[0], want_g[0], RTOL, f"{cid} gradient of the deltas")
    rois = got[0]
    assert rois.shape == (2, kw["rpn_post_nms_top_n"], 5)
    np.testing.assert_array_equal(
        rois[:, :, 0], np.broadcast_to([[0.0], [1.0]], rois.shape[:2]))
    if kw.get("output_score"):
        score = got[1][..., 0]
        # a suppressed row holds the best box and the score -1
        sup = score < 0
        assert sup.any() and (~sup).any()
        np.testing.assert_array_equal(
            rois[sup], np.broadcast_to(rois[:, :1], rois.shape)[sup])


def test_bilinear_border_extension_is_exact():
    """A sample far outside the image reads the border value exactly
    (the coordinates are clamped before the weights are taken)."""
    x = np.tile(np.arange(8, dtype=np.float32)[None, None, :, None],
                (1, 1, 1, 8))
    rois = np.array([[0, 2, 2, 5, 5]], np.float32)
    t_up = np.zeros((1, 2, 1, 1), np.float32)
    t_up[0, 0] = -100.0
    out = nd.DeformablePSROIPooling(
        nd.array(x), nd.array(rois), nd.array(t_up), output_dim=1,
        pooled_size=1, group_size=1, part_size=1, trans_std=1.0)
    np.testing.assert_array_equal(out.asnumpy().ravel(), [0.0])


def test_position_sensitive_bins_read_their_own_channel_only():
    """Output channel d at bin (i, j) of PSROIPooling reads input channel
    (d·g + i)·g + j alone: a map that is zero except that channel gives
    zero at every other bin."""
    x = np.zeros((1, 2 * 4, 6, 6), np.float32)
    x[0, (1 * 2 + 1) * 2 + 0] = 1.0                        # d=1, bin (1, 0)
    rois = np.array([[0, 0, 0, 11, 11]], np.float32)
    out = nd.PSROIPooling(nd.array(x), nd.array(rois), spatial_scale=0.5,
                          output_dim=2, pooled_size=2).asnumpy()[0]
    want = np.zeros((2, 2, 2), np.float32)
    want[1, 1, 0] = 1.0
    np.testing.assert_array_equal(out, want)


def test_deformable_psroi_pooling_needs_trans_unless_told():
    with pytest.raises(ValueError, match="trans"):
        nd.DeformablePSROIPooling(nd.array(PS_FEAT), nd.array(PS_ROIS),
                                  output_dim=3, pooled_size=3)


def test_correlation_refuses_an_even_kernel_and_a_short_input():
    a = nd.array(_normal(1, 2, 5, 5))
    with pytest.raises(ValueError, match="odd"):
        nd.Correlation(a, a, kernel_size=2)
    with pytest.raises(ValueError, match="larger"):
        nd.Correlation(a, a, max_displacement=4)


def test_vision_operators_take_tensors_and_give_tensors():
    out = nd.ROIAlign(torch.from_numpy(FEAT), torch.from_numpy(ROIS),
                      pooled_size=(2, 2), spatial_scale=0.25)
    assert isinstance(out, torch.Tensor) and out.shape == (7, 6, 2, 2)
