"""The int8 ``nd.*`` operators against the JAX reference, on the CPU.

The same inputs, made with numpy from a seed, go through
``tpu_mx.nd`` and ``tpu_mx_torch.nd``.  Every output is held bit for
bit: the int8 and int32 data (the products accumulate exactly in int32
in both packages) and the float32 ranges and dequantized values (the
same float32 operations in the same order).  The quantize cases hold
exact ties at .5, which both round to even.
"""
import numpy as np
import pytest
import torch

import tpu_mx as jmx  # noqa: F401 -- the reference's nd namespace
from tpu_mx import nd as jnd

import tpu_mx_torch as mx
from tpu_mx_torch import nd
from tpu_mx_torch.ndarray import quantized_ops as qops


@pytest.fixture(autouse=True)
def _host():
    with mx.cpu():
        yield


def _rng(seed):
    return np.random.RandomState(seed)


def _int8(*shape, seed=0):
    return _rng(seed).randint(-127, 128, shape).astype(np.int8)


def _pair(fn_name, arrays, **kw):
    """``nd.<fn_name>`` of both packages on the same numpy inputs (None
    passes through); every output as numpy."""
    def run(ndm):
        args = [None if a is None else ndm.array(a, dtype=a.dtype)
                for a in arrays]
        out = getattr(ndm, fn_name)(*args, **kw)
        return [np.asarray(o.asnumpy()) for o in out] \
            if isinstance(out, (list, tuple)) else [out.asnumpy()]
    return run(nd), run(jnd)


def _bit_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape, (g.shape, w.shape)
        assert g.dtype == w.dtype, (g.dtype, w.dtype)
        assert g.tobytes() == w.tobytes(), np.abs(
            g.astype(np.float64) - w.astype(np.float64)).max()


def _f32(v):
    return np.asarray(v, np.float32)


TIES = np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -126.5, 127.5,
                 200.0, -3.49, 3.51], np.float32)


@pytest.mark.parametrize("case", ["observed", "calibrated", "ties"])
def test_quantize_v2_is_the_references(case):
    x = _rng(1).randn(4, 33).astype(np.float32) * 3
    kw = {}
    if case == "calibrated":
        kw = dict(min_calib_range=-2.5, max_calib_range=4.0)
    elif case == "ties":     # scale 127/127 = 1: each .5 a tie
        x = TIES
        kw = dict(min_calib_range=-127.0, max_calib_range=127.0)
    got, want = _pair("quantize_v2", [x], **kw)
    _bit_equal(got, want)
    if case == "ties":
        assert got[0].tolist()[:8] == [0, 2, 2, 0, -2, -2, 126, -126]


def test_dequantize_is_the_references():
    q = _int8(5, 7, seed=2)
    got, want = _pair("dequantize", [q, _f32(-1.7), _f32(2.9)])
    _bit_equal(got, want)


@pytest.mark.parametrize("calibrated", [False, True])
def test_requantize_is_the_references(calibrated):
    q32 = _rng(3).randint(-2 ** 20, 2 ** 20, (6, 9)).astype(np.int32)
    kw = dict(min_calib_range=-3.0, max_calib_range=2.0) if calibrated \
        else {}
    got, want = _pair("requantize", [q32, _f32(-0.8), _f32(1.1)], **kw)
    _bit_equal(got, want)


@pytest.mark.parametrize("shape,bias", [((8, 40), False), ((8, 40), True),
                                        ((2, 3, 40), False)])
def test_quantized_fully_connected_is_the_references(shape, bias):
    x, w = _int8(*shape, seed=4), _int8(12, 40, seed=5)
    ranges = [_f32(-2.0), _f32(3.0), _f32(-0.4), _f32(0.3)]
    if bias:
        args = [x, w, _int8(12, seed=6)] + ranges + [_f32(-0.1), _f32(0.2)]
        got, want = _pair("quantized_fully_connected", args, num_hidden=12)
    else:
        got, want = _pair("quantized_fully_connected",
                          [x, w, None] + ranges, num_hidden=12,
                          no_bias=True)
    assert got[0].dtype == np.int32
    _bit_equal(got, want)


CONV_CASES = {
    # name: (input shape, weight shape, kwargs)
    "nchw_3x3": ((2, 6, 9, 9), (8, 6, 3, 3),
                 dict(kernel=(3, 3), pad=(1, 1))),
    "nhwc_7x7_s2": ((2, 11, 11, 3), (8, 7, 7, 3),
                    dict(kernel=(7, 7), stride=(2, 2), pad=(3, 3),
                         layout="NHWC")),
    "nhwc_1x1_s2": ((3, 8, 8, 16), (24, 1, 1, 16),
                    dict(kernel=(1, 1), stride=(2, 2), layout="NHWC")),
    "nchw_dilated_groups": ((2, 8, 10, 10), (12, 4, 3, 3),
                            dict(kernel=(3, 3), pad=(2, 2), dilate=(2, 2),
                                 num_group=2)),
    "ncw_1d": ((2, 5, 17), (6, 5, 4), dict(kernel=(4,), stride=(3,),
                                           pad=(1,), layout="NCW")),
    "ndhwc_3d": ((1, 5, 6, 7, 4), (6, 3, 2, 3, 4),
                 dict(kernel=(3, 2, 3), pad=(1, 0, 1), layout="NDHWC")),
}


@pytest.mark.parametrize("name", sorted(CONV_CASES))
def test_quantized_conv_is_the_references(name):
    xs, ws, kw = CONV_CASES[name]
    x, w = _int8(*xs, seed=7), _int8(*ws, seed=8)
    got, want = _pair("quantized_conv",
                      [x, w, None, _f32(-1.5), _f32(2.0), _f32(-0.3),
                       _f32(0.25)], num_filter=ws[0], **kw)
    assert got[0].dtype == np.int32
    _bit_equal(got, want)


def test_a_full_3x3x512_tap_sum_is_exact():
    """4608 taps of 127 x 127: 7.4e7, past float32's 2**24."""
    x = np.full((1, 3, 3, 512), 127, np.int8)
    w = np.full((1, 3, 3, 512), 127, np.int8)
    w[0, 0, 0, 0] = 126                  # a sum float32 cannot hold
    got, want = _pair("quantized_conv",
                      [x, w, None, _f32(-1), _f32(1), _f32(-1), _f32(1)],
                      kernel=(3, 3), num_filter=1, layout="NHWC")
    _bit_equal(got, want)
    assert int(got[0].reshape(-1)[0]) == 4608 * 127 * 127 - 127


@pytest.mark.parametrize("pool_type", ["max", "avg"])
@pytest.mark.parametrize("layout,kw", [
    ("NCHW", dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1))),
    ("NHWC", dict(kernel=(2, 2), stride=(2, 2))),
    ("NHWC", dict(global_pool=True)),
    ("NCHW", dict(global_pool=True)),
])
def test_quantized_pooling_is_the_references(pool_type, layout, kw):
    shape = (2, 5, 9, 9) if layout == "NCHW" else (2, 9, 9, 5)
    got, want = _pair("quantized_pooling",
                      [_int8(*shape, seed=9), _f32(-1.0), _f32(1.5)],
                      pool_type=pool_type, layout=layout, **kw)
    _bit_equal(got, want)


def test_quantized_flatten_is_the_references():
    got, want = _pair("quantized_flatten",
                      [_int8(3, 4, 5, seed=10), _f32(-1.0), _f32(1.0)])
    _bit_equal(got, want)


@pytest.mark.parametrize("m,k,n", [(3, 147, 64), (40, 8, 8), (17, 9, 5)])
def test_int8_matmul_padding_is_exact(m, k, n):
    """The card's operand padding (rows to 17, widths to multiples of 8)
    changes no product: the padded product, sliced, equals the plain
    int32 one."""
    a = torch.from_numpy(_int8(m, k, seed=m))
    b = torch.from_numpy(_int8(n, k, seed=n))
    ap = qops._pad_to(qops._pad_to(a, 1, 8), 0, 1, least=17)
    bp = qops._pad_to(qops._pad_to(b, 1, 8), 0, 8)
    assert ap.shape[0] >= 17 and ap.shape[1] % 8 == 0 \
        and bp.shape[0] % 8 == 0 and bp.shape[1] == ap.shape[1]
    padded = qops.int8_matmul(ap, bp)[:m, :n]
    want = a.long() @ b.long().t()
    assert torch.equal(padded.long(), want)
    assert torch.equal(qops.int8_matmul(a, b).long(), want)


def test_tensors_in_tensors_out():
    """Given tensors (as a model's forward passes them) the operators
    return tensors, the ranges 0-d float32."""
    q, mn, mx_ = nd.quantize_v2(torch.tensor([0.5, -1.0, 2.0]))
    assert isinstance(q, torch.Tensor) and q.dtype == torch.int8
    assert mn.dtype == torch.float32 and mn.dim() == 0 and float(mx_) == 2.0
