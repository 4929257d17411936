"""The rest of the ``nd.*`` operators against the JAX reference, on the CPU.

One case per name (and per option that changes the math): the same
inputs, made with numpy from a seed, go through ``tpu_mx.nd`` and
``tpu_mx_torch.nd``; the values are held to ``RTOL`` (float32 rounding;
``PRODUCT_RTOL`` for products, statistics and special functions) and,
where the operator is differentiable, so are the gradients from one
random head gradient under ``autograd.record()``.  Integer outputs are
compared by value (the port keeps int64 where the reference, without
x64, has int32).  The ordering cases hold ties, so the tie order is
checked too.  The random operators cannot be bit-equal to the
reference's key stream: they are held by shape, dtype, support and
moments (each mean within 5 standard errors of the distribution's).
"""
import inspect
import math
import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import tpu_mx as jmx
from tpu_mx import autograd as jag
from tpu_mx import nd as jnd

import tpu_mx_torch as mx
from tpu_mx_torch import autograd, nd

CPU = mx.cpu()
RTOL = 1e-5
PRODUCT_RTOL = 1e-4


@pytest.fixture(autouse=True)
def _host():
    torch.backends.mkldnn.enabled = False
    with CPU:
        yield


def _rng(seed):
    return np.random.RandomState(seed)


def _normal(*shape, seed=0):
    return _rng(seed).randn(*shape).astype(np.float32)


def _positive(*shape, seed=0):
    return (np.abs(_rng(seed).randn(*shape)) + 0.5).astype(np.float32)


def _ties(*shape, seed=0):
    return _rng(seed).randint(0, 4, shape).astype(np.float32)


def _spd(n, seed=0):
    a = _normal(n, n, seed=seed)
    return (a @ a.T + n * np.eye(n)).astype(np.float32)


def _f(*vals):
    return np.asarray(vals, np.float32)


class Case:
    """``name(*args, **kw)``; ``grad`` the indices of the arguments whose
    gradient is compared; ``train`` runs it recorded in training mode."""

    def __init__(self, name, args, kw=None, grad=(), rtol=RTOL, train=False,
                 id=None, raw_ref=False):
        self.name, self.args, self.kw = name, args, kw or {}
        self.grad, self.rtol, self.train = tuple(grad), rtol, train
        self.id = id or name
        # the reference's function takes jax arrays, not NDArrays
        self.raw_ref = raw_ref


def _outputs(out):
    outs = out if isinstance(out, (list, tuple)) else [out]
    return [np.asarray(o.asnumpy() if hasattr(o, "asnumpy") else o)
            for o in outs]


def _run(ndm, ag, case):
    wrap = jnp.asarray if case.raw_ref and ndm is jnd else ndm.array
    arrs = [wrap(a) if isinstance(a, np.ndarray) else a for a in case.args]
    for i in case.grad:
        arrs[i].attach_grad()
    if not (case.grad or case.train):
        return _outputs(getattr(ndm, case.name)(*arrs, **case.kw)), []
    with ag.record(train_mode=True):
        out = getattr(ndm, case.name)(*arrs, **case.kw)
    if case.grad:
        head = _normal(*out.shape, seed=7)
        out.backward(ndm.array(head))
    return _outputs(out), [arrs[i].grad.asnumpy() for i in case.grad]


def _same(got, want, rtol, what):
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if want.dtype.kind in "iub":
        assert got.dtype.kind in "iub", (what, got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=what)
        return
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    g, w = got.astype(np.float64), want.astype(np.float64)
    scale = np.nanmax(np.abs(w[np.isfinite(w)])) if np.isfinite(w).any() \
        else 1.0
    np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=what)
    np.testing.assert_array_equal(np.isinf(g) & (g > 0),
                                  np.isinf(w) & (w > 0), err_msg=what)
    np.testing.assert_array_equal(np.isinf(g) & (g < 0),
                                  np.isinf(w) & (w < 0), err_msg=what)
    fin = np.isfinite(w)
    np.testing.assert_allclose(g[fin], w[fin], rtol=rtol,
                               atol=rtol * max(scale, 1e-30), err_msg=what)


X = _normal(4, 6)
SEQ = _normal(5, 3, 4, seed=1)
LENS = _f(2, 5, 1)
IMG = _normal(2, 3, 7, 6, seed=2)
SCORES = _normal(2, 3, 5, seed=3)
MASK = np.ones((2, 3, 5), np.float32)
MASK[0, 1] = 0
MASK[1, :, 3:] = 0
LABELS = _f(0, 2, 5, 1)
HEAD_X = _normal(4, 6, seed=4)
GAMMA = _positive(3, seed=5)
BETA = _normal(3, seed=6)
MEAN = _normal(3, seed=8) * 0.1
VAR = _positive(3, seed=9)

CASES = [
    # sequences
    Case("SequenceMask", [SEQ, LENS], dict(use_sequence_length=True,
                                           value=-1.0), grad=(0,)),
    Case("SequenceMask", [SEQ.transpose(1, 0, 2).copy(), LENS],
         dict(use_sequence_length=True, axis=1), grad=(0,),
         id="SequenceMask-axis1"),
    Case("SequenceMask", [SEQ], grad=(0,), id="SequenceMask-no-lengths"),
    Case("SequenceReverse", [SEQ, LENS], dict(use_sequence_length=True),
         grad=(0,)),
    Case("SequenceReverse", [SEQ], grad=(0,), id="SequenceReverse-all"),
    Case("SequenceLast", [SEQ, LENS], dict(use_sequence_length=True),
         grad=(0,)),
    Case("SequenceLast", [SEQ], grad=(0,), id="SequenceLast-no-lengths"),
    # ordering, with ties
    Case("sort", [_ties(4, 6)], id="sort-ties"),
    Case("sort", [X], dict(is_ascend=False, axis=0), grad=(0,),
         id="sort-descending"),
    Case("argsort", [_ties(4, 6)], id="argsort-ties"),
    Case("argsort", [_ties(4, 6)], dict(is_ascend=False, axis=0,
                                        dtype="int32"),
         id="argsort-descending-ties"),
    Case("topk", [_ties(4, 6)], dict(k=3), id="topk-indices-ties"),
    Case("topk", [X], dict(k=2, ret_typ="value", axis=0), grad=(0,),
         id="topk-value"),
    Case("topk", [_ties(4, 6)], dict(k=3, ret_typ="both", is_ascend=True),
         id="topk-both-ascending-ties"),
    Case("topk", [_ties(4, 6)], dict(k=2, ret_typ="mask"), id="topk-mask"),
    Case("argmax_channel", [_ties(3, 4, 2)]),
    # indexing and shape
    Case("gather_nd", [_normal(4, 5, 3), _f([0, 3, 1, 2, 3, 0],
                                           [4, 0, 2, 2, 1, 4])], grad=(0,)),
    Case("scatter_nd", [_normal(6), _f([0, 3, 1, 2, 3, 0],
                                       [4, 0, 2, 2, 1, 3])],
         dict(shape=(4, 5)), grad=(0,)),
    Case("batch_take", [X, _f(0, 5, 2, 3)], grad=(0,)),
    Case("choose_element_0index", [X, _f(0, 5, 2, 3)], grad=(0,)),
    Case("fill_element_0index", [X, _f(9, 8, 7, 6), _f(0, 5, 2, 3)],
         grad=(0, 1)),
    Case("slice", [X], dict(begin=(1, 0), end=(4, None), step=(2, 1)),
         grad=(0,)),
    Case("slice", [X], dict(begin=(3,), end=(0,), step=(-1,)), grad=(0,),
         id="slice-negative-step"),
    Case("slice_like", [X, _normal(2, 3)], grad=(0,)),
    Case("slice_like", [X, _normal(2, 3)], dict(axes=(1,)), grad=(0,),
         id="slice_like-axes"),
    Case("diag", [X], dict(k=1), grad=(0,)),
    Case("diag", [_normal(3, 4, 5)], grad=(0,), id="diag-3d-default-axes"),
    Case("diag", [_normal(4)], dict(k=-1), grad=(0,), id="diag-1d"),
    Case("ravel_multi_index", [_f([0, 3, 7, 2, -1, 1],
                                  [4, 0, 2, 9, 1, 3])], dict(shape=(4, 5))),
    Case("unravel_index", [_f(0, 7, 19, 12, 5)], dict(shape=(4, 5))),
    Case("shape_array", [_normal(2, 3, 4)]),
    Case("size_array", [_normal(2, 3, 4)]),
    Case("Crop", [IMG], dict(h_w=(3, 4), offset=(1, 2)), grad=(0,)),
    Case("Crop", [IMG], dict(h_w=(3, 4), center_crop=True), grad=(0,),
         id="Crop-center"),
    Case("Crop", [IMG, _normal(1, 1, 5, 2)], grad=(0,), id="Crop-like"),
    Case("broadcast_axis", [_normal(1, 3, 1)], dict(axis=(0, 2),
                                                    size=(2, 4)), grad=(0,)),
    Case("broadcast_axes", [_normal(1, 3)], dict(axis=0, size=3),
         grad=(0,)),
    Case("eye", [4], dict(M=5, k=1)),
    Case("linspace", [-1.0, 2.0, 7]),
    Case("linspace", [-1.0, 2.0, 7], dict(endpoint=False),
         id="linspace-open"),
    # math
    Case("arctan2", [X, _normal(4, 6, seed=1)], grad=(0, 1)),
    Case("broadcast_hypot", [X, _normal(1, 6, seed=1)], grad=(0, 1)),
    Case("broadcast_logical_and", [_ties(4, 6), _ties(1, 6, seed=1)]),
    Case("broadcast_logical_or", [_ties(4, 6), _ties(1, 6, seed=1)]),
    Case("broadcast_logical_xor", [_ties(4, 6), _ties(1, 6, seed=1)]),
    Case("cumsum", [X], dict(axis=1), grad=(0,)),
    Case("cumsum", [X], grad=(0,), id="cumsum-flat"),
    Case("nansum", [np.where(_ties(4, 6) == 0, np.nan, X).astype(
        np.float32)], dict(axis=1)),
    Case("nansum", [np.where(_ties(4, 6) == 0, np.nan, X).astype(
        np.float32)], id="nansum-all"),
    Case("nanprod", [np.where(_ties(4, 6) == 0, np.nan, X).astype(
        np.float32)], dict(axis=0, keepdims=True)),
    Case("erfcinv", [_rng(0).uniform(1e-6, 1.999, (4, 6)).astype(
        np.float32)], rtol=PRODUCT_RTOL),
    Case("polygamma", [1, _positive(4, 6)], grad=(1,), rtol=PRODUCT_RTOL),
    Case("gammainc", [_positive(4, 6), _positive(4, 6, seed=1)],
         rtol=PRODUCT_RTOL),
    Case("nextafter", [X, _f(0.0)]),
    Case("moments", [X], dict(axes=(0,))),
    Case("moments", [X], dict(axes=(1,), keepdims=True),
         id="moments-keepdims"),
    Case("khatri_rao", [_normal(3, 4), _normal(2, 4, seed=1)],
         grad=(0, 1)),
    Case("multi_all_finite", [X, _normal(3)]),
    Case("multi_all_finite", [X, _f(1.0, np.inf)],
         id="multi_all_finite-inf"),
    Case("all_finite", [_f(np.nan, 1.0)]),
    Case("amp_cast", [X], dict(dtype="float16")),
    Case("amp_multicast", [X.astype(np.float16), _normal(3)]),
    # linear algebra
    Case("linalg_gemm", [_normal(2, 3, 4), _normal(2, 5, 4, seed=1),
                         _normal(2, 3, 5, seed=2)],
         dict(transpose_b=True, alpha=0.5, beta=2.0), grad=(0, 1, 2),
         rtol=PRODUCT_RTOL),
    Case("linalg_gemm2", [_normal(2, 4, 3), _normal(2, 4, 5, seed=1)],
         dict(transpose_a=True, alpha=2.0), grad=(0, 1), rtol=PRODUCT_RTOL),
    Case("linalg_potrf", [_spd(5)], grad=(0,), rtol=PRODUCT_RTOL),
    Case("linalg_syrk", [_normal(2, 3, 4)], dict(transpose=True, alpha=0.5),
         grad=(0,), rtol=PRODUCT_RTOL),
    Case("linalg_syrk", [_normal(3, 4)], grad=(0,), rtol=PRODUCT_RTOL,
         id="linalg_syrk-plain"),
    # normalization, activation, patches
    Case("batch_norm_core", [IMG, GAMMA, BETA, MEAN, VAR, 1e-5, True],
         rtol=PRODUCT_RTOL, raw_ref=True),
    Case("batch_norm_core", [IMG.transpose(0, 2, 3, 1).copy(), GAMMA, BETA,
                             MEAN, VAR, 1e-3, False],
         dict(axis=-1, fix_gamma=True), rtol=PRODUCT_RTOL, raw_ref=True,
         id="batch_norm_core-moving-channels-last"),
    Case("BatchNorm", [IMG, GAMMA, BETA, MEAN, VAR], dict(fix_gamma=False),
         grad=(0, 1, 2), train=True, rtol=PRODUCT_RTOL,
         id="BatchNorm-training"),
    Case("BatchNorm", [IMG, GAMMA, BETA, MEAN, VAR], rtol=PRODUCT_RTOL,
         id="BatchNorm-inference"),
    Case("BatchNorm", [IMG, GAMMA, BETA, MEAN, VAR],
         dict(use_global_stats=True), train=True, rtol=PRODUCT_RTOL,
         id="BatchNorm-global-stats"),
    Case("RMSNorm", [X, _positive(6)], grad=(0, 1), rtol=PRODUCT_RTOL),
    Case("LRN", [IMG], dict(nsize=3, alpha=0.1), grad=(0,),
         rtol=PRODUCT_RTOL),
    Case("SoftmaxActivation", [IMG], dict(mode="channel"), grad=(0,)),
    Case("SoftmaxActivation", [X], grad=(0,), id="SoftmaxActivation"
         "-instance"),
    Case("masked_softmax", [SCORES, MASK], dict(temperature=0.5),
         grad=(0,)),
    Case("masked_log_softmax", [SCORES, MASK]),
    Case("im2col", [IMG], dict(kernel=(3, 2), stride=(2, 1), pad=(1, 0),
                               dilate=(1, 2)), grad=(0,)),
    Case("col2im", [_normal(2, 12, 16)], dict(output_size=(7, 6),
                                              kernel=(2, 2), stride=2,
                                              pad=1), grad=(0,)),
    # output heads: the injected gradient, whatever the head gradient
    Case("SoftmaxOutput", [HEAD_X, LABELS], grad=(0,)),
    Case("SoftmaxOutput", [HEAD_X, _f(0, 2, -1, 1)],
         dict(use_ignore=True, normalization="valid", grad_scale=2.0),
         grad=(0,), id="SoftmaxOutput-ignore-valid"),
    Case("SoftmaxOutput", [HEAD_X, LABELS],
         dict(normalization="batch", smooth_alpha=0.1), grad=(0,),
         id="SoftmaxOutput-batch-smooth"),
    Case("SoftmaxOutput", [_normal(2, 4, 3), _f([0, 3, 1], [2, 2, 0])],
         dict(multi_output=True, normalization="valid"), grad=(0,),
         id="SoftmaxOutput-multi"),
    Case("SVMOutput", [HEAD_X, LABELS], dict(margin=0.5), grad=(0,)),
    Case("SVMOutput", [HEAD_X, LABELS], dict(use_linear=True,
                                             regularization_coefficient=
                                             0.3), grad=(0,),
         id="SVMOutput-linear"),
    Case("LinearRegressionOutput", [HEAD_X, _normal(4, 6, seed=3)],
         dict(grad_scale=2.0), grad=(0,)),
    Case("MAERegressionOutput", [HEAD_X, _normal(24, seed=3)], grad=(0,)),
    Case("LogisticRegressionOutput", [HEAD_X, _positive(4, 6) / 3],
         grad=(0,)),
    Case("MakeLoss", [HEAD_X], dict(grad_scale=3.0), grad=(0,)),
    Case("MakeLoss", [HEAD_X], dict(normalization="valid",
                                    valid_thresh=0.2), grad=(0,),
         id="MakeLoss-valid"),
    Case("MakeLoss", [HEAD_X], dict(normalization="batch"), grad=(0,),
         id="MakeLoss-batch"),
    Case("make_loss", [HEAD_X], grad=(0,)),
    Case("IdentityAttachKLSparseReg", [_positive(4, 6) / 3],
         dict(sparseness_target=0.2, penalty=0.01), grad=(0,)),
    # the deprecated aliases forward to their targets
    Case("BatchNorm_v1", [IMG, GAMMA, BETA, MEAN, VAR], rtol=PRODUCT_RTOL),
    Case("Softmax", [HEAD_X, LABELS], grad=(0,)),
    Case("Convolution_v1", [IMG, _normal(4, 3, 3, 3)],
         dict(kernel=(3, 3), no_bias=True, pad=(1, 1)), grad=(0, 1),
         rtol=PRODUCT_RTOL),
    Case("Pooling_v1", [IMG], dict(kernel=(2, 2), pool_type="avg"),
         grad=(0,)),
]


@pytest.mark.parametrize("case", CASES, ids=[c.id for c in CASES])
def test_operator_matches_the_reference(case):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        want, want_g = _run(jnd, jag, case)
        got, got_g = _run(nd, autograd, case)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        _same(g, w, case.rtol, f"{case.id} output {i}")
    for i, (g, w) in enumerate(zip(got_g, want_g)):
        _same(g, w, case.rtol, f"{case.id} gradient {case.grad[i]}")


def test_every_operator_of_the_slice_has_a_case():
    names = {c.name for c in CASES} | {
        "random_randint", "random_gamma", "random_exponential",
        "random_poisson", "random_bernoulli", "sample_multinomial",
        "shuffle", "randn", "Custom", "CTCLoss", "ctc_loss"}
    from tpu_mx_torch.ndarray import ops_tail
    assert set(ops_tail.__all__) | {"broadcast_hypot",
                                    "broadcast_logical_and",
                                    "broadcast_logical_or",
                                    "broadcast_logical_xor"} <= names


@pytest.mark.parametrize("name,target", [
    ("BatchNorm_v1", "BatchNorm"), ("Convolution_v1", "Convolution"),
    ("Pooling_v1", "Pooling"), ("Softmax", "SoftmaxOutput")])
def test_deprecated_alias_warns_and_keeps_its_targets_signature(name,
                                                                target):
    assert inspect.signature(getattr(nd, name)) == \
        inspect.signature(getattr(nd, target))

    def named(fn):
        return [p.name for p in inspect.signature(fn).parameters.values()
                if p.kind != p.VAR_KEYWORD]
    assert named(getattr(nd, name)) == named(getattr(jnd, name))
    x = nd.array(HEAD_X)
    args = {"BatchNorm_v1": (nd.array(IMG), nd.array(GAMMA), nd.array(BETA),
                             nd.array(MEAN), nd.array(VAR)),
            "Convolution_v1": (nd.array(IMG), nd.array(_normal(4, 3, 3, 3))),
            "Pooling_v1": (nd.array(IMG),),
            "Softmax": (x, nd.array(LABELS))}[name]
    kw = {"Convolution_v1": dict(kernel=(3, 3), no_bias=True),
          "Pooling_v1": dict(kernel=(2, 2))}.get(name, {})
    with pytest.warns(DeprecationWarning, match=target):
        getattr(nd, name)(*args, **kw)


def test_the_kl_sparse_moving_average_moves_only_while_recording():
    x = _positive(4, 6) / 3
    for ndm, ag in ((jnd, jag), (nd, autograd)):
        ma = ndm.array(np.full(6, 0.3, np.float32))
        ndm.IdentityAttachKLSparseReg(ndm.array(x), moving_avg=ma)
        np.testing.assert_array_equal(ma.asnumpy(), np.float32(0.3))
    ma_ref, ma = jnd.array(np.full(6, 0.3, np.float32)), \
        nd.array(np.full(6, 0.3, np.float32))
    grads = []
    for ndm, ag, m in ((jnd, jag, ma_ref), (nd, autograd, ma)):
        a = ndm.array(x)
        a.attach_grad()
        with ag.record():
            y = ndm.IdentityAttachKLSparseReg(a, sparseness_target=0.2,
                                              penalty=0.01, moving_avg=m)
        y.backward(ndm.array(_normal(4, 6, seed=7)))
        grads.append(a.grad.asnumpy())
    _same(ma.asnumpy(), ma_ref.asnumpy(), RTOL, "moving_avg")
    _same(grads[1], grads[0], RTOL, "gradient")


def test_fully_masked_rows_give_zero_and_minus_inf():
    mask = np.ones((2, 5), np.float32)
    mask[1] = 0
    s = nd.array(_normal(2, 5))
    p = nd.masked_softmax(s, nd.array(mask)).asnumpy()
    lp = nd.masked_log_softmax(s, nd.array(mask)).asnumpy()
    assert (p[1] == 0).all() and np.isneginf(lp[1]).all()
    np.testing.assert_allclose(p[0].sum(), 1.0, rtol=1e-6)


def test_im2col_columns_are_channel_major_and_col2im_is_its_adjoint():
    x = _normal(1, 2, 4, 4)
    cols = nd.im2col(nd.array(x), kernel=(2, 2)).asnumpy()
    # row (c, i, j) of column 0 is x[c, i, j] (the first window)
    np.testing.assert_array_equal(cols[0, :, 0], x[0, :, :2, :2].reshape(-1))
    c = _normal(1, 8, 9, seed=1)
    img = nd.col2im(nd.array(c), output_size=(4, 4), kernel=(2, 2)).asnumpy()
    # <im2col(x), c> == <x, col2im(c)>
    np.testing.assert_allclose((cols * c).sum(), (x * img).sum(), rtol=1e-5)


def test_output_heads_ignore_the_head_gradient():
    for head in (np.ones((4, 6), np.float32), _normal(4, 6, seed=3) * 9):
        a = nd.array(HEAD_X)
        a.attach_grad()
        with autograd.record():
            y = nd.SoftmaxOutput(a, nd.array(LABELS), normalization="valid")
        y.backward(nd.array(head))
        p = torch.softmax(torch.from_numpy(HEAD_X), -1).numpy()
        oh = np.eye(6, dtype=np.float32)[LABELS.astype(int)]
        np.testing.assert_allclose(a.grad.asnumpy(), (p - oh) / 4,
                                   rtol=1e-5, atol=1e-7)


# -- random: shape, dtype, support and moments --------------------------------
N_DRAWS = 1 << 15


def _mean_within(draws, mean, var):
    se = math.sqrt(var / draws.size)
    assert abs(draws.mean() - mean) < 5 * se, (draws.mean(), mean, se)


RANDOM = [
    ("random_randint", dict(low=2, high=9), "int32",
     lambda d: ((d >= 2) & (d < 9)).all(), 5.0, (49 - 1) / 12),
    ("random_gamma", dict(alpha=3.0, beta=0.5), "float32",
     lambda d: (d > 0).all(), 1.5, 0.75),
    ("random_exponential", dict(scale=2.0), "float32",
     lambda d: (d >= 0).all(), 2.0, 4.0),
    ("random_poisson", dict(lam=4.0), "float32",
     lambda d: ((d >= 0) & (d == np.round(d))).all(), 4.0, 4.0),
    ("random_bernoulli", dict(prob=0.3), "float32",
     lambda d: np.isin(d, (0.0, 1.0)).all(), 0.3, 0.21),
]


@pytest.mark.parametrize("name,kw,dtype,support,mean,var", RANDOM,
                         ids=[r[0] for r in RANDOM])
def test_sampler_shape_dtype_support_and_mean(name, kw, dtype, support,
                                              mean, var):
    want = getattr(jnd, name)(shape=(4, 5), **kw)
    got = getattr(nd, name)(shape=(4, 5), **kw)
    assert got.shape == want.shape and str(got.dtype) == str(want.dtype) \
        == dtype
    mx.random.seed(11)
    d = getattr(nd, name)(shape=(N_DRAWS,), **kw).asnumpy()
    assert support(d)
    _mean_within(d.astype(np.float64), mean, var)
    short = name[len("random_"):]
    assert getattr(nd.random, short)(shape=(3,), **kw).shape == (3,)


def test_randn_and_normal_with_array_arguments():
    assert nd.randn(2, 3).shape == jnd.randn(2, 3).shape == (2, 3)
    mx.random.seed(3)
    d = nd.randn(N_DRAWS).asnumpy().astype(np.float64)
    _mean_within(d, 0.0, 1.0)


def test_sample_multinomial_support_shape_and_frequencies():
    p = np.asarray([[0.1, 0.6, 0.0, 0.3], [0.25, 0.25, 0.25, 0.25]],
                   np.float32)
    for shape in (1, 3, (2, 2)):
        want = jnd.sample_multinomial(jnd.array(p), shape=shape)
        got = nd.sample_multinomial(nd.array(p), shape=shape)
        assert got.shape == want.shape and str(got.dtype) == \
            str(want.dtype)
    mx.random.seed(5)
    d = nd.random.multinomial(nd.array(p), shape=N_DRAWS).asnumpy()
    assert ((d >= 0) & (d < 4)).all() and not (d[0] == 2).any()
    for row in range(2):
        for k in np.flatnonzero(p[row]):
            q = p[row, k]
            _mean_within((d[row] == k).astype(np.float64), q, q * (1 - q))


def test_shuffle_permutes_rows():
    x = np.arange(40, dtype=np.float32).reshape(10, 4)
    got = nd.shuffle(nd.array(x)).asnumpy()
    assert got.shape == jnd.shuffle(jnd.array(x)).shape
    assert sorted(got[:, 0]) == sorted(x[:, 0])
    np.testing.assert_array_equal(got[:, 1:] - got[:, :1], x[:, 1:] - x[:, :1])
    assert nd.random.shuffle(nd.array(x)).shape == (10, 4)


# -- nd.Custom ----------------------------------------------------------------
def _register(mxmod, tag, need_top_grad):
    class Cube(mxmod.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            self.assign(out_data[0], req[0], in_data[0] ** 3 + in_data[1])

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            g = out_grad[0] if need_top_grad else 1.0
            self.assign(in_grad[0], req[0], 3 * in_data[0] ** 2 * g)
            self.assign(in_grad[1], req[1], in_data[1] * 0 + g)

    @mxmod.operator.register(tag)
    class CubeProp(mxmod.operator.CustomOpProp):
        def __init__(self, **kw):
            super().__init__(need_top_grad=need_top_grad)

        def list_arguments(self):
            return ["x", "y"]

        def create_operator(self, ctx, shapes, dtypes):
            return Cube()
    return CubeProp


@pytest.mark.parametrize("need_top_grad", [True, False])
def test_custom_operator_matches_the_reference(need_top_grad):
    tag = f"cube_{need_top_grad}"
    _register(jmx, tag, need_top_grad)
    prop = _register(mx, tag, need_top_grad)
    assert mx.operator.get_all_registered()[tag] is prop
    outs = []
    for ndm, ag in ((jnd, jag), (nd, autograd)):
        a, b = ndm.array(X), ndm.array(_normal(4, 6, seed=1))
        a.attach_grad()
        b.attach_grad()
        with ag.record():
            y = ndm.Custom(a, b, op_type=tag)
        y.backward(ndm.array(_normal(4, 6, seed=7)))
        outs.append([y.asnumpy(), a.grad.asnumpy(), b.grad.asnumpy()])
    for g, w in zip(outs[1], outs[0]):
        _same(g, w, RTOL, tag)
    with pytest.raises(mx.MXNetError, match="not registered"):
        nd.Custom(nd.array(X), op_type="no_such_op")
