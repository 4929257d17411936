"""The port's imperative surface against the JAX reference, on the CPU.

``NDArray`` and the ``nd.*`` operators (values and gradients under
``autograd.record()``), ``autograd`` (scopes, ``grad_req``, ``grad``,
``Function``, ``mark_variables``), Gluon's ``Parameter``/``ParameterDict``
with deferred shapes, ``HybridBlock`` with ``hybrid_forward``, the
``Trainer`` with SGD, Adam and LAMB, ``io.NDArrayIter``, ``metric``,
``gluon.utils``, LeNet trained imperatively, and the imperative BERT
step against the port's own ``CompiledTrainStep``.  Inputs are made with
numpy from a seed and fed to both packages; the port runs ``with
mx.cpu():`` (its implicit context is the card).
"""
import re

import numpy as np
import pytest
import torch

import tpu_mx as jmx
from tpu_mx import autograd as jag
from tpu_mx import gluon as jgluon
from tpu_mx import nd as jnd
from tpu_mx.models.lenet import lenet as jlenet

import tpu_mx_torch as mx
from tpu_mx_torch import autograd, gluon, nd, optimizer, rtc
from tpu_mx_torch.base import MXNetError
from tpu_mx_torch.gluon.parameter import DeferredInitializationError
from tpu_mx_torch.models.lenet import lenet

CPU = mx.cpu()
OP_RTOL = 1e-5          # elementwise, reductions, shapes: float32 rounding
PRODUCT_RTOL = 1e-4     # products and convolutions: summation order


@pytest.fixture(autouse=True)
def _host():
    torch.backends.mkldnn.enabled = False
    with CPU:
        yield


def _rng(seed=0):
    return np.random.RandomState(seed)


def _normal(*shape, seed=0):
    return np.asarray(_rng(seed).randn(*shape), np.float32)


def _positive(*shape, seed=0):
    return (np.abs(_rng(seed).randn(*shape)) + 0.5).astype(np.float32)


def _unit(*shape, seed=0):
    return _rng(seed).uniform(-0.9, 0.9, shape).astype(np.float32)


def _close(got, want, rtol, msg=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, msg
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(1.0, np.abs(want).max()
                                               if want.size else 1.0),
                               err_msg=msg)


# -- every nd.* operator: value, and gradient under record/backward -----------
X34 = _normal(3, 4)
Y34 = _normal(3, 4, seed=1)
IDX = np.array([2, 0, 3], np.float32)

# (id, call(F, *arrays), inputs, differentiable, tolerance)
OPS = [
    ("zeros", lambda F: F.zeros((2, 3)), [], False, OP_RTOL),
    ("ones", lambda F: F.ones((2, 3), dtype="float32"), [], False, OP_RTOL),
    ("full", lambda F: F.full((2, 3), 2.5), [], False, OP_RTOL),
    ("arange", lambda F: F.arange(1, 7, 1.5), [], False, OP_RTOL),
    ("arange_repeat", lambda F: F.arange(4, repeat=2), [], False, OP_RTOL),
    ("zeros_like", lambda F, x: F.zeros_like(x), [X34], False, OP_RTOL),
    ("ones_like", lambda F, x: F.ones_like(x), [X34], False, OP_RTOL),
    ("full_like", lambda F, x: F.full_like(x, 3.0), [X34], False, OP_RTOL),
    ("cast", lambda F, x: F.cast(x, dtype="float64") * 2, [X34], True,
     OP_RTOL),
    ("add", lambda F, x, y: F.add(x, y), [X34, Y34], True, OP_RTOL),
    ("add_scalar", lambda F, x: x + 2.0, [X34], True, OP_RTOL),
    ("radd_rsub", lambda F, x: 3.0 - (1.0 + x), [X34], True, OP_RTOL),
    ("subtract", lambda F, x, y: F.subtract(x, y), [X34, Y34], True,
     OP_RTOL),
    ("multiply", lambda F, x, y: F.multiply(x, y), [X34, Y34], True,
     OP_RTOL),
    ("divide", lambda F, x, y: F.divide(x, y), [X34, _positive(3, 4)],
     True, OP_RTOL),
    ("rdiv", lambda F, x: 2.0 / x, [_positive(3, 4)], True, OP_RTOL),
    ("mod", lambda F, x, y: F.mod(x, y), [X34, _positive(3, 4, seed=2)],
     False, OP_RTOL),
    ("power", lambda F, x, y: F.power(x, y), [_positive(3, 4), Y34], True,
     OP_RTOL),
    ("pow_scalar", lambda F, x: x ** 3, [X34], True, OP_RTOL),
    ("maximum", lambda F, x, y: F.maximum(x, y), [X34, Y34], True, OP_RTOL),
    ("minimum", lambda F, x, y: F.minimum(x, y), [X34, Y34], True, OP_RTOL),
    ("maximum_scalar", lambda F, x: F.maximum(x, 0.1), [X34], True,
     OP_RTOL),
    ("hypot", lambda F, x, y: F.hypot(x, y), [X34, Y34], True, OP_RTOL),
    ("broadcast_add", lambda F, x, y: F.broadcast_add(x, y),
     [X34, _normal(1, 4, seed=3)], True, OP_RTOL),
    ("broadcast_mul", lambda F, x, y: F.broadcast_mul(x, y),
     [X34, _normal(3, 1, seed=3)], True, OP_RTOL),
    ("add_n", lambda F, x, y: F.add_n(x, y, x), [X34, Y34], True, OP_RTOL),
    ("equal", lambda F, x: x == F.round(x), [X34 * 0 + 1.0], False,
     OP_RTOL),
    ("not_equal", lambda F, x, y: F.not_equal(x, y), [X34, Y34], False,
     OP_RTOL),
    ("greater", lambda F, x, y: x > y, [X34, Y34], False, OP_RTOL),
    ("greater_equal", lambda F, x, y: x >= y, [X34, Y34], False, OP_RTOL),
    ("lesser", lambda F, x, y: x < y, [X34, Y34], False, OP_RTOL),
    ("lesser_equal", lambda F, x: x <= 0.0, [X34], False, OP_RTOL),
    ("neg_abs", lambda F, x: abs(-x), [X34], True, OP_RTOL),
    ("getitem", lambda F, x: x[1:, ::2] * 2, [X34], True, OP_RTOL),
    ("getitem_int", lambda F, x: x[2], [X34], True, OP_RTOL),
    ("Activation_relu", lambda F, x: F.Activation(x, act_type="relu"),
     [X34], True, OP_RTOL),
    ("Activation_sigmoid", lambda F, x: F.Activation(x, act_type="sigmoid"),
     [X34], True, OP_RTOL),
    ("Activation_tanh", lambda F, x: F.Activation(x, act_type="tanh"),
     [X34], True, OP_RTOL),
    ("Activation_softrelu", lambda F, x: F.Activation(x,
                                                      act_type="softrelu"),
     [X34], True, OP_RTOL),
    ("Activation_softsign", lambda F, x: F.Activation(x,
                                                      act_type="softsign"),
     [X34], True, OP_RTOL),
    ("sum", lambda F, x: F.sum(x), [X34], True, OP_RTOL),
    ("sum_axis_keepdims", lambda F, x: F.sum(x, axis=1, keepdims=True),
     [X34], True, OP_RTOL),
    ("sum_exclude", lambda F, x: F.sum(x, axis=0, exclude=True), [X34],
     True, OP_RTOL),
    ("mean", lambda F, x: F.mean(x, axis=(0, 1)), [X34], True, OP_RTOL),
    ("mean_all", lambda F, x: x.mean(), [X34], True, OP_RTOL),
    ("max", lambda F, x: F.max(x, axis=0), [X34], True, OP_RTOL),
    ("max_all_keepdims", lambda F, x: F.max(x, keepdims=True), [X34], True,
     OP_RTOL),
    ("min", lambda F, x: F.min(x, axis=-1), [X34], True, OP_RTOL),
    ("prod", lambda F, x: F.prod(x, axis=1), [X34], True, OP_RTOL),
    ("argmax", lambda F, x: F.argmax(x, axis=1), [X34], False, OP_RTOL),
    ("argmax_all", lambda F, x: F.argmax(x), [X34], False, OP_RTOL),
    ("argmin", lambda F, x: F.argmin(x, axis=0), [X34], False, OP_RTOL),
    ("norm", lambda F, x: F.norm(x), [X34], True, OP_RTOL),
    ("norm_l1_axis", lambda F, x: F.norm(x, ord=1, axis=1), [X34], True,
     OP_RTOL),
    ("reshape", lambda F, x: F.reshape(x, shape=(2, -1)), [X34], True,
     OP_RTOL),
    ("reshape_codes", lambda F, x: F.reshape(x, shape=(0, -1, 2)),
     [_normal(2, 3, 4)], True, OP_RTOL),
    ("reshape_code_m2", lambda F, x: F.reshape(x, shape=(0, -2)),
     [_normal(2, 3, 4)], True, OP_RTOL),
    ("reshape_code_m3", lambda F, x: F.reshape(x, shape=(-3, 4)),
     [_normal(2, 3, 4)], True, OP_RTOL),
    ("method_reshape", lambda F, x: x.reshape((4, 3)), [X34], True,
     OP_RTOL),
    ("reshape_like", lambda F, x, y: F.reshape_like(x, y),
     [X34, _normal(6, 2)], True, OP_RTOL),
    ("flatten", lambda F, x: F.flatten(x), [_normal(2, 3, 4)], True,
     OP_RTOL),
    ("transpose", lambda F, x: F.transpose(x), [_normal(2, 3, 4)], True,
     OP_RTOL),
    ("transpose_axes", lambda F, x: F.transpose(x, axes=(1, 0, 2)),
     [_normal(2, 3, 4)], True, OP_RTOL),
    ("T", lambda F, x: x.T, [X34], True, OP_RTOL),
    ("swapaxes", lambda F, x: F.swapaxes(x, 0, 2), [_normal(2, 3, 4)],
     True, OP_RTOL),
    ("expand_dims", lambda F, x: F.expand_dims(x, axis=1), [X34], True,
     OP_RTOL),
    ("squeeze", lambda F, x: F.squeeze(x), [_normal(3, 1, 4)], True,
     OP_RTOL),
    ("squeeze_axis", lambda F, x: F.squeeze(x, axis=1), [_normal(3, 1, 4)],
     True, OP_RTOL),
    ("broadcast_to", lambda F, x: F.broadcast_to(x, shape=(2, 3, 4)),
     [_normal(3, 1)], True, OP_RTOL),
    ("broadcast_to_keep", lambda F, x: F.broadcast_to(x, shape=(0, 4)),
     [_normal(3, 1)], True, OP_RTOL),
    ("broadcast_like", lambda F, x, y: x.broadcast_like(y),
     [_normal(1, 4), X34], True, OP_RTOL),
    ("flip", lambda F, x: F.flip(x, axis=1), [X34], True, OP_RTOL),
    ("tile", lambda F, x: F.tile(x, reps=(2, 1)), [X34], True, OP_RTOL),
    ("repeat", lambda F, x: F.repeat(x, repeats=2, axis=0), [X34], True,
     OP_RTOL),
    ("concat", lambda F, x, y: F.concat(x, y, dim=1), [X34, Y34], True,
     OP_RTOL),
    ("concat_axis0", lambda F, x, y: F.concat(x, y, dim=0), [X34, Y34],
     True, OP_RTOL),
    ("concatenate", lambda F, x, y: F.concatenate([x, y], axis=0),
     [X34, Y34], True, OP_RTOL),
    ("stack", lambda F, x, y: F.stack(x, y, axis=1), [X34, Y34], True,
     OP_RTOL),
    ("split", lambda F, x: F.split(x, num_outputs=2, axis=1), [X34], True,
     OP_RTOL),
    ("split_squeeze", lambda F, x: F.split(x, num_outputs=3, axis=0,
                                           squeeze_axis=True),
     [X34], True, OP_RTOL),
    ("slice_axis", lambda F, x: F.slice_axis(x, axis=1, begin=1, end=3),
     [X34], True, OP_RTOL),
    ("slice_axis_open", lambda F, x: F.slice_axis(x, axis=0, begin=1,
                                                  end=None),
     [X34], True, OP_RTOL),
    ("clip", lambda F, x: F.clip(x, -0.5, 0.5), [X34], True, OP_RTOL),
    ("where", lambda F, c, x, y: F.where(c, x, y),
     [(X34 > 0).astype(np.float32), X34, Y34], True, OP_RTOL),
    ("take", lambda F, x, i: F.take(x, i), [X34, IDX[:2]], True, OP_RTOL),
    ("take_axis1_clip", lambda F, x, i: F.take(x, i, axis=1),
     [X34, np.array([[0, 5], [3, 1]], np.float32)], True, OP_RTOL),
    ("take_wrap", lambda F, x, i: F.take(x, i, axis=1, mode="wrap"),
     [X34, np.array([5, -1], np.float32)], True, OP_RTOL),
    ("one_hot", lambda F, i: F.one_hot(i, depth=5, on_value=2.0,
                                       off_value=-1.0),
     [np.array([2, 0, 4, 7], np.float32)], False, OP_RTOL),
    ("pick", lambda F, x, i: F.pick(x, i, axis=1), [X34, IDX], True,
     OP_RTOL),
    ("dot", lambda F, x, y: F.dot(x, y), [X34, _normal(4, 5)], True,
     PRODUCT_RTOL),
    ("dot_transpose", lambda F, x, y: F.dot(x, y, transpose_a=True,
                                            transpose_b=True),
     [_normal(4, 3), _normal(5, 4)], True, PRODUCT_RTOL),
    ("dot_3d", lambda F, x, y: F.dot(x, y), [_normal(2, 3, 4),
                                             _normal(4, 5)], True,
     PRODUCT_RTOL),
    ("batch_dot", lambda F, x, y: F.batch_dot(x, y),
     [_normal(2, 3, 4), _normal(2, 4, 5)], True, PRODUCT_RTOL),
    ("batch_dot_transpose", lambda F, x, y: F.batch_dot(
        x, y, transpose_a=True, transpose_b=True),
     [_normal(2, 4, 3), _normal(2, 5, 4)], True, PRODUCT_RTOL),
    ("softmax", lambda F, x: F.softmax(x), [X34], True, OP_RTOL),
    ("softmax_axis0_temperature", lambda F, x: F.softmax(x, axis=0,
                                                         temperature=2.0),
     [X34], True, OP_RTOL),
    ("softmax_length", lambda F, x, n: F.softmax(x, length=n),
     [X34, np.array([4, 2, 1], np.float32)], True, OP_RTOL),
    ("log_softmax", lambda F, x: F.log_softmax(x), [X34], True, OP_RTOL),
    ("log_softmax_temperature", lambda F, x: F.log_softmax(
        x, temperature=0.5), [X34], True, OP_RTOL),
    ("softmax_cross_entropy", lambda F, x, y: F.softmax_cross_entropy(x, y),
     [X34, IDX], True, OP_RTOL),
    ("BlockGrad", lambda F, x: F.BlockGrad(x * 2) + x, [X34], True,
     OP_RTOL),
    ("stop_gradient", lambda F, x: x * F.stop_gradient(x), [X34], True,
     OP_RTOL),
    ("identity", lambda F, x: F.identity(x) * 3, [X34], True, OP_RTOL),
    ("FullyConnected", lambda F, x, w, b: F.FullyConnected(
        x, w, b, num_hidden=5), [_normal(2, 3, 4), _normal(5, 12),
                                 _normal(5)], True, PRODUCT_RTOL),
    ("FullyConnected_noflatten", lambda F, x, w: F.FullyConnected(
        x, w, no_bias=True, flatten=False),
     [_normal(2, 3, 4), _normal(5, 4)], True, PRODUCT_RTOL),
    ("Convolution", lambda F, x, w, b: F.Convolution(
        x, w, b, kernel=(3, 3), stride=(1, 1), pad=(1, 1), num_filter=4),
     [_normal(2, 3, 6, 6), _normal(4, 3, 3, 3), _normal(4)], True,
     PRODUCT_RTOL),
    ("Convolution_nhwc", lambda F, x, w: F.Convolution(
        x, w, kernel=(3, 3), stride=(2, 2), num_filter=4, no_bias=True,
        layout="NHWC"),
     [_normal(2, 7, 7, 3), _normal(4, 3, 3, 3)], True, PRODUCT_RTOL),
    ("Pooling_max", lambda F, x: F.Pooling(x, kernel=(2, 2), stride=(2, 2),
                                           pool_type="max"),
     [_normal(2, 3, 6, 6)], True, OP_RTOL),
    ("Pooling_avg_full", lambda F, x: F.Pooling(
        x, kernel=(3, 3), stride=(2, 2), pool_type="avg",
        pooling_convention="full"), [_normal(2, 3, 6, 6)], True, OP_RTOL),
    ("Pooling_global", lambda F, x: F.Pooling(x, kernel=(1, 1),
                                              global_pool=True,
                                              pool_type="avg"),
     [_normal(2, 3, 6, 6)], True, OP_RTOL),
    ("Embedding", lambda F, i, w: F.Embedding(i, w), [IDX, _normal(5, 3)],
     True, OP_RTOL),
    ("LayerNorm", lambda F, x, g, b: F.LayerNorm(x, g, b), [X34,
                                                             _normal(4),
                                                             _normal(4)],
     True, OP_RTOL),
    ("L2Normalization", lambda F, x: F.L2Normalization(x),
     [_normal(2, 3, 4)], True, OP_RTOL),
    ("gelu", lambda F, x: F.gelu(x), [X34], True, OP_RTOL),
    ("space_to_depth", lambda F, x: F.space_to_depth(x, 2),
     [_normal(1, 2, 4, 4)], True, OP_RTOL),
    ("depth_to_space", lambda F, x: F.depth_to_space(x, 2),
     [_normal(1, 8, 2, 2)], True, OP_RTOL),
]
UNARY = {"abs": X34, "sign": X34, "ceil": X34, "floor": X34, "trunc": X34,
         "fix": X34, "round": X34, "rint": X34, "exp": X34, "expm1": X34,
         "log": _positive(3, 4), "log2": _positive(3, 4),
         "log10": _positive(3, 4), "log1p": _positive(3, 4),
         "sqrt": _positive(3, 4), "rsqrt": _positive(3, 4), "square": X34,
         "reciprocal": _positive(3, 4), "negative": X34, "sin": X34,
         "cos": X34, "tan": _unit(3, 4), "arcsin": _unit(3, 4),
         "arccos": _unit(3, 4), "arctan": X34, "sinh": X34, "cosh": X34,
         "tanh": X34, "sigmoid": X34, "softsign": X34, "relu": X34,
         "erf": X34, "erfinv": _unit(3, 4), "logical_not": np.round(X34)}
NONDIFF_UNARY = {"sign", "ceil", "floor", "trunc", "fix", "round", "rint",
                 "logical_not"}
OPS += [(name, (lambda n: lambda F, x: getattr(F, n)(x))(name), [x],
         name not in NONDIFF_UNARY, OP_RTOL) for name, x in UNARY.items()]
OPS += [(f"{name}_bool", (lambda n: lambda F, x: getattr(F, n)(x))(name),
         [np.array([1.0, np.inf, -np.inf, np.nan], np.float32)], False,
         OP_RTOL) for name in ("isnan", "isinf", "isfinite")]
OPS += [(f"method_{m}", (lambda m: lambda F, x: getattr(x, m)())(m), [X34],
         m not in ("argmax", "argmin"), OP_RTOL)
        for m in ("abs", "sqrt" if False else "square", "exp", "sum", "mean",
                  "max", "min", "flatten", "argmax", "softmax",
                  "log_softmax", "sigmoid", "tanh", "relu")]


def _run(F, arr, call, inputs, diff, head_seed):
    """Outputs and input gradients of ``call`` in one package."""
    xs = [arr(a) for a in inputs]
    grads = diff and all(a.dtype == np.float32 for a in inputs)
    if grads:
        for x in xs:
            x.attach_grad()
    with F.autograd.record():
        out = call(F.nd, *xs)
    outs = out if isinstance(out, list) else [out]
    if grads:
        heads = [F.nd.array(_normal(*o.shape, seed=head_seed + i)
                            .astype(o.asnumpy().dtype))
                 for i, o in enumerate(outs)]
        F.autograd.backward(outs, heads)
    return ([o.asnumpy() for o in outs],
            [x.grad.asnumpy() for x in xs] if grads else [])


class _Pkg:
    def __init__(self, nd_, autograd_):
        self.nd, self.autograd = nd_, autograd_


REF, PORT = _Pkg(jnd, jag), _Pkg(nd, autograd)


@pytest.mark.parametrize("case", OPS, ids=[c[0] for c in OPS])
def test_nd_op_matches_the_reference(case):
    name, call, inputs, diff, tol = case
    want, want_g = _run(REF, jnd.array, call, inputs, diff, 7)
    got, got_g = _run(PORT, lambda a: nd.array(a), call, inputs, diff, 7)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _close(g, w, tol, name)
    assert len(got_g) == len(want_g)
    for i, (g, w) in enumerate(zip(got_g, want_g)):
        _close(g, w, tol, f"{name}: gradient of input {i}")


def test_every_exported_op_family_is_covered():
    names = {c[0].split("_")[0] for c in OPS} | set(UNARY)
    for op in ("zeros", "ones", "full", "arange", "cast", "sum", "mean",
               "max", "min", "argmax", "norm", "reshape", "transpose",
               "flatten", "expand", "squeeze", "concat", "stack", "split",
               "slice", "take", "one", "broadcast", "clip", "where", "dot",
               "batch", "softmax", "log", "BlockGrad", "stop", "Activation"):
        assert op in names, op


def test_random_draws_land_on_the_context_with_their_law():
    mx.random.seed(3)
    u = nd.random.uniform(-1.0, 3.0, shape=(4000,))
    n = nd.random.normal(2.0, 0.5, shape=(4000,), dtype="float64")
    assert isinstance(u, nd.NDArray) and u.context == CPU
    a, b = u.asnumpy(), n.asnumpy()
    assert a.min() >= -1.0 and a.max() < 3.0 and abs(a.mean() - 1.0) < 0.1
    assert b.dtype == np.float64 and abs(b.mean() - 2.0) < 0.05
    assert abs(b.std() - 0.5) < 0.05
    mx.random.seed(3)
    np.testing.assert_array_equal(nd.random.uniform(-1.0, 3.0,
                                                    shape=(4000,)).asnumpy(),
                                  a)


def test_dropout_reaches_arrays_and_is_identity_when_not_training():
    x = nd.array(_normal(64, 64))
    np.testing.assert_array_equal(nd.Dropout(x, 0.5, training=False)
                                  .asnumpy(), x.asnumpy())
    # outside record() the array face is the identity, as the
    # reference's; mode="always" drops there too
    np.testing.assert_array_equal(nd.Dropout(x, 0.5).asnumpy(), x.asnumpy())
    y = nd.Dropout(x, 0.5, mode="always",
                   generator=torch.Generator().manual_seed(0)).asnumpy()
    kept = y != 0
    assert 0.4 < kept.mean() < 0.6
    np.testing.assert_allclose(y[kept], 2 * x.asnumpy()[kept], rtol=1e-6)


def test_ops_on_tensors_return_tensors():
    t = torch.ones(2, 3)
    for out in (nd.sum(t), nd.relu(t), nd.FullyConnected(t, torch.ones(4, 3)),
                nd.concat(t, t, dim=0), nd.split(t, 3, axis=1)[0]):
        assert isinstance(out, torch.Tensor)
    assert isinstance(nd.sum(nd.array(t)), nd.NDArray)


# -- NDArray ------------------------------------------------------------------
def test_ndarray_meta_transfer_and_mutation_match_the_reference():
    a = _normal(3, 4)
    j, t = jnd.array(a), nd.array(a)
    assert t.shape == j.shape and t.size == j.size and t.ndim == j.ndim
    assert t.dtype == np.float32 and t.context == CPU
    assert nd.array(a.astype(np.float64)).dtype == np.float32
    assert nd.array(a, dtype="float16").dtype == np.float16
    assert nd.array(a).astype("bfloat16").dtype == torch.bfloat16
    assert t[1, 2].asscalar() == pytest.approx(float(a[1, 2]))
    assert float(t[0, 0]) == pytest.approx(float(a[0, 0]))
    assert len(t) == 3 and [r.shape for r in t] == [(4,)] * 3
    for x in (j, t):
        x[1] = 5.0
        x[:, 0] = nd.array(np.arange(3, dtype=np.float32)) if x is t else \
            jnd.array(np.arange(3, dtype=np.float32))
        x += 1
        x *= 2
        x -= 0.5
        x /= 4
    np.testing.assert_allclose(t.asnumpy(), j.asnumpy(), rtol=1e-6)
    c = t.copy()
    c[:] = 0
    assert t.asnumpy().any() and not c.asnumpy().any()
    d = nd.zeros((3, 4))
    t.copyto(d)
    np.testing.assert_array_equal(d.asnumpy(), t.asnumpy())
    assert t.as_in_context(CPU) is t and t.copyto(CPU).shape == (3, 4)
    assert t.detach().shape == t.shape and t.wait_to_read() is t
    assert np.asarray(t).shape == (3, 4) and t.tolist()[0][0] == \
        pytest.approx(float(t.asnumpy()[0, 0]))
    assert "NDArray (3, 4) @cpu(0)" in repr(t)
    with pytest.raises(ValueError):
        bool(t)
    with pytest.raises(ValueError):
        t.asscalar()


def test_array_without_a_card_needs_the_host_context():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the implicit context works")
    with mx.gpu(0):
        with pytest.raises(MXNetError, match="no CUDA device"):
            nd.array(np.ones(3))
        with pytest.raises(MXNetError, match="no CUDA device"):
            nd.zeros((2,))
    assert nd.array(np.ones(3), ctx=mx.cpu()).context == CPU


def test_indexing_with_arrays_and_setitem_on_an_attached_leaf():
    x = nd.array(_normal(4, 3))
    i = nd.array(np.array([3, 1], np.float32))
    np.testing.assert_array_equal(x[i].asnumpy(), x.asnumpy()[[3, 1]])
    x.attach_grad()
    x[0] = 1.0                      # rebinds, stays an attached leaf
    with autograd.record():
        y = (x * x).sum()
    y.backward()
    np.testing.assert_allclose(x.grad.asnumpy(), 2 * x.asnumpy(), rtol=1e-6)


def test_save_and_load_arrays_round_trip(tmp_path):
    a, b = nd.array(_normal(2, 3)), nd.array(_normal(4))
    nd.save(str(tmp_path / "list"), [a, b])
    nd.save(str(tmp_path / "dict"), {"a": a, "b": b})
    la = nd.load(str(tmp_path / "list"))
    ld = nd.load(str(tmp_path / "dict"))
    np.testing.assert_array_equal(la[1].asnumpy(), b.asnumpy())
    np.testing.assert_array_equal(ld["a"].asnumpy(), a.asnumpy())


# -- autograd -----------------------------------------------------------------
def test_recording_scopes_nest_as_the_reference():
    seen = []
    for ag in (jag, autograd):
        states = [(ag.is_recording(), ag.is_training())]
        with ag.record():
            states.append((ag.is_recording(), ag.is_training()))
            with ag.pause():
                states.append((ag.is_recording(), ag.is_training()))
                with ag.train_mode():
                    states.append((ag.is_recording(), ag.is_training()))
            with ag.predict_mode():
                states.append((ag.is_recording(), ag.is_training()))
            states.append((ag.is_recording(), ag.is_training()))
        with ag.record(train_mode=False):
            states.append((ag.is_recording(), ag.is_training()))
        with ag.pause(train_mode=True):
            states.append((ag.is_recording(), ag.is_training()))
        states.append((ag.is_recording(), ag.is_training()))
        seen.append(states)
    assert seen[0] == seen[1]


def test_no_graph_outside_record_or_inside_pause():
    x = nd.array(_normal(3, 3))
    x.attach_grad()
    assert not (x * 2)._data.requires_grad
    with autograd.record():
        assert (x * 2)._data.requires_grad
        with autograd.pause():
            assert not (x * 2)._data.requires_grad
    net = gluon.nn.Dense(2, in_units=3, generator=torch.Generator())
    assert not net(x)._data.requires_grad
    with autograd.record():
        assert net(x)._data.requires_grad


def _grad_req_run(ag, nd_, req):
    a, b = nd_.array(_normal(3)), nd_.array(_normal(3, seed=1))
    c = nd_.array(_normal(3, seed=2))
    for v in (a, b, c):
        v.attach_grad(grad_req=req)
    out = []
    for k in range(2):
        with ag.record():
            y = (a * b * (k + 1)).sum()
            if k == 0:                  # c is reached only the first time
                y = y + (c * c).sum()
        y.backward()
        out.append([v.grad.asnumpy().copy() for v in (a, b, c)])
    return out


@pytest.mark.parametrize("req", ["write", "add"])
def test_grad_req_over_two_backward_calls_and_an_unreached_leaf(req):
    want = _grad_req_run(jag, jnd, req)
    got = _grad_req_run(autograd, nd, req)
    for gw, ww in zip(got, want):
        for g, w in zip(gw, ww):
            np.testing.assert_allclose(g, w, rtol=1e-6)
    # the leaf not reached by the second backward keeps its gradient
    np.testing.assert_array_equal(got[1][2], got[0][2])


def _retain_run(ag, nd_):
    x = nd_.array(_normal(4))
    x.attach_grad(grad_req="add")
    with ag.record():
        y = (x * x * x).sum()
    y.backward(retain_graph=True)
    y.backward()
    return x.grad.asnumpy()


def test_retain_graph_keeps_the_graph_for_a_second_backward():
    np.testing.assert_allclose(_retain_run(autograd, nd),
                               _retain_run(jag, jnd), rtol=1e-6)


def test_head_gradients_and_several_heads():
    res = []
    for ag, nd_ in ((jag, jnd), (autograd, nd)):
        x = nd_.array(_normal(2, 3))
        x.attach_grad()
        with ag.record():
            y1, y2 = x * 2, (x * x).sum(axis=1)
        ag.backward([y1, y2], [nd_.array(_normal(2, 3, seed=4)), None])
        res.append(x.grad.asnumpy())
    np.testing.assert_allclose(res[1], res[0], rtol=1e-6)


def test_autograd_grad_leaves_the_buffers_alone():
    res = []
    for ag, nd_ in ((jag, jnd), (autograd, nd)):
        x, w = nd_.array(_normal(3)), nd_.array(_normal(3, seed=1))
        x.attach_grad()
        w.attach_grad()
        with ag.record():
            y = (nd_.exp(x) * w).sum()
        gx, gw = ag.grad(y, [x, w])
        assert not x.grad.asnumpy().any()
        res.append((gx.asnumpy(), gw.asnumpy()))
    for g, w in zip(res[1], res[0]):
        np.testing.assert_allclose(g, w, rtol=1e-6)


def test_autograd_grad_creates_a_graph_for_second_derivatives():
    x = nd.array(_normal(3))
    x.attach_grad()
    with autograd.record():
        y = (x * x * x).sum()
        dx = autograd.grad(y, x, create_graph=True)
        z = dx.sum()
    z.backward()
    np.testing.assert_allclose(x.grad.asnumpy(), 6 * x.asnumpy(), rtol=1e-6)


def _sigmoid_fn(ag, nd_):
    class Sigmoid(ag.Function):
        def forward(self, x):
            y = 1 / (1 + nd_.exp(-x))
            self.save_for_backward(y)
            return y

        def backward(self, dy):
            y, = self.saved_tensors
            return dy * y * (1 - y)
    x = nd_.array(_normal(5))
    x.attach_grad()
    with ag.record():
        y = Sigmoid()(x)
        z = (y * nd_.array(_normal(5, seed=3))).sum()
    z.backward()
    return y.asnumpy(), x.grad.asnumpy()


def test_function_runs_its_own_backward():
    want, got = _sigmoid_fn(jag, jnd), _sigmoid_fn(autograd, nd)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-6)


def test_mark_variables_attaches_given_buffers():
    res = []
    for ag, nd_ in ((jag, jnd), (autograd, nd)):
        x = nd_.array(_normal(3))
        g = nd_.zeros((3,))
        ag.mark_variables([x], [g], grad_reqs="add")
        for _ in range(2):
            with ag.record():
                y = (x * 3).sum()
            y.backward()
        res.append((x.grad.asnumpy(), x.grad is g))
    np.testing.assert_allclose(res[1][0], res[0][0])
    assert res[1][1] and res[0][1]


# -- Parameter, ParameterDict, deferred shapes --------------------------------
def _strip(name):
    return re.sub(r"\d+_", "_", name)


def _names(params):
    """The parameters' names, instance numbers dropped."""
    return [_strip(p.name) for p in params.values()]


def _mlp(pkg):
    n = pkg.gluon.nn
    net = n.HybridSequential()
    net.add(n.Dense(8, activation="relu"), n.BatchNorm(), n.Dense(3))
    return net


def test_deferred_params_infer_their_shapes_at_the_first_forward():
    jnet, net = _mlp(jmx), _mlp(mx)
    for n in (jnet, net):
        n.initialize(init="xavier")
    assert [p.shape for p in net.collect_params().values()] == \
        [(8, 0), (8,), (0,), (0,), (0,), (0,), (3, 0), (3,)]
    x = _normal(4, 2, 3)
    jnet(jnd.array(x))
    net(nd.array(x))
    jshapes = [tuple(p.shape) for p in jnet.collect_params().values()]
    assert [p.shape for p in net.collect_params().values()] == jshapes
    assert _names(net.collect_params()) == \
        [_strip(k) for k in jnet.collect_params()]
    assert list(net.collect_params()) == ["0.weight", "0.bias", "1.gamma",
                                          "1.beta", "1.running_mean",
                                          "1.running_var", "2.weight",
                                          "2.bias"]
    assert all(p.dtype == torch.float32 for p in
               net.collect_params().values())


def test_forward_before_initialize_raises():
    net = _mlp(mx)
    weight = next(iter(net.collect_params().values()))
    with pytest.raises(DeferredInitializationError):
        weight.data()
    with pytest.raises(MXNetError, match="initialize"):
        net(nd.array(_normal(2, 3)))
    with pytest.raises(MXNetError, match="not initialized"):
        weight.data()


def test_collect_params_select_names_and_order_match_the_reference():
    jnet, net = _mlp(jmx), _mlp(mx)
    for sel in (None, ".*weight", ".*batchnorm.*", ".*(bias|gamma)"):
        want = [_strip(k) for k in jnet.collect_params(sel)]
        got = _names(net.collect_params(sel))
        assert got == want, sel
        assert got
    params = net.collect_params()
    assert all(re.fullmatch(r"(dense|batchnorm)\d+_\w+", p.name)
               for p in params.values())
    for key, p in params.items():
        assert params[p.name] is p and p.name in params and key in params


def test_parameters_are_the_modules_own_tensors():
    net = gluon.nn.Dense(3, in_units=2, generator=torch.Generator())
    w = net.collect_params()[net.prefix + "weight"]
    tensor = net._parameters["weight"]
    assert net.weight is w              # the attribute is the handle
    assert w.data()._data is tensor
    w.set_data(nd.ones((3, 2)))
    assert torch.equal(tensor.detach(), torch.ones(3, 2))
    w.data()[:] = 2.0
    assert torch.equal(tensor.detach(), torch.full((3, 2), 2.0))
    x = nd.array(_normal(4, 2))
    with autograd.record():
        y = net(x).sum()
    y.backward()
    assert w.grad._data is tensor.grad
    np.testing.assert_allclose(w.grad.asnumpy(),
                               np.tile(x.asnumpy().sum(0), (3, 1)), rtol=1e-6)
    w.zero_grad()
    assert not w.grad.asnumpy().any()
    w.grad_req = "null"
    assert not tensor.requires_grad
    with pytest.raises(MXNetError, match="no gradient"):
        w.grad
    with pytest.raises(MXNetError, match="shape mismatch"):
        w.set_data(np.ones((2, 3), np.float32))


def test_parameter_dict_surface():
    pd = gluon.ParameterDict("blk_")
    p = pd.get("w", shape=(2, 3), init="ones")
    assert pd.get("w") is p and "blk_w" in pd and len(pd) == 1
    c = pd.get_constant("c", np.arange(3.0))
    pd.initialize()
    np.testing.assert_array_equal(p.data().asnumpy(), np.ones((2, 3)))
    np.testing.assert_array_equal(c.data().asnumpy(), np.arange(3.0))
    assert c.grad_req == "null"
    pd.setattr("lr_mult", 0.5)
    assert p.lr_mult == 0.5 and c.lr_mult == 0.5
    shared = gluon.ParameterDict("blk_", shared=pd)
    assert shared.get("w") is p
    with pytest.raises(DeferredInitializationError):
        gluon.Parameter("u", shape=(0, 2)).initialize()


def test_parameter_dict_save_and_load(tmp_path):
    net = _mlp(mx).initialize()
    net(nd.array(_normal(2, 3)))
    params = net.collect_params()
    params.save(str(tmp_path / "p"))
    other = _mlp(mx).initialize()       # structural keys: loads across
    other.collect_params().load(str(tmp_path / "p"))
    for a, b in zip(params.values(), other.collect_params().values()):
        np.testing.assert_array_equal(a.data().asnumpy(), b.data().asnumpy())
    with pytest.raises(MXNetError, match="missing"):
        other.collect_params().load(str(tmp_path / "p"), restore_prefix="x.")
    with pytest.raises(MXNetError, match="Extra"):
        other.collect_params(".*dense").load(str(tmp_path / "p"))
    other.collect_params(".*dense").load(str(tmp_path / "p"),
                                         ignore_extra=True)
    pd = gluon.ParameterDict("blk_")
    pd.get("w", shape=(2,), init="ones").initialize()
    pd.save(str(tmp_path / "q"), strip_prefix="blk_")
    pd2 = gluon.ParameterDict("blk_")
    pd2.get("w", shape=(2,), init="zeros")
    pd2.load(str(tmp_path / "q"), restore_prefix="blk_")
    np.testing.assert_array_equal(pd2["blk_w"].data().asnumpy(), np.ones(2))


def test_save_and_load_parameters_round_trip_and_mismatch(tmp_path):
    net = _mlp(mx).initialize(init="xavier")
    x = nd.array(_normal(4, 3))
    with autograd.record():             # moves the running statistics
        net(x)
    f = str(tmp_path / "net.params")
    net.save_parameters(f)
    fresh = _mlp(mx).initialize()       # deferred: takes the file's shapes
    fresh.load_parameters(f)
    with autograd.predict_mode():
        np.testing.assert_array_equal(fresh(x).asnumpy(), net(x).asnumpy())
    for (k, a), (_, b) in zip(net.collect_params().items(),
                              fresh.collect_params().items()):
        np.testing.assert_array_equal(a.data().asnumpy(),
                                      b.data().asnumpy(), err_msg=k)
    wide = gluon.nn.HybridSequential()
    wide.add(gluon.nn.Dense(9), gluon.nn.BatchNorm(), gluon.nn.Dense(3))
    wide.initialize()
    wide(x)
    with pytest.raises(MXNetError, match="shape mismatch"):
        wide.load_parameters(f)
    short = gluon.nn.HybridSequential()
    short.add(gluon.nn.Dense(8))
    short.initialize()
    with pytest.raises(MXNetError, match="Extra params"):
        short.load_parameters(f)
    short.load_parameters(f, ignore_extra=True)
    longer = _mlp(mx)
    longer.add(gluon.nn.Dense(2))
    longer.initialize()
    with pytest.raises(MXNetError, match="missing"):
        longer.load_parameters(f)


def test_cast_before_the_first_forward_holds():
    net = _mlp(mx).initialize()
    net.cast("bfloat16")
    net(nd.array(_normal(2, 3)).astype("bfloat16"))
    assert all(p.dtype == torch.bfloat16
               for p in net.collect_params().values())


def test_initialize_records_the_initializer_for_deferred_params():
    net = gluon.nn.Dense(4, weight_initializer=None)
    net.initialize(mx.init.Constant(0.25))
    net(nd.array(_normal(2, 6)))
    np.testing.assert_array_equal(net.weight.detach().numpy(),
                                  np.full((4, 6), 0.25, np.float32))
    own = gluon.nn.Dense(4, weight_initializer="ones")
    own.initialize(mx.init.Constant(0.25))   # the layer's own wins
    own(nd.array(_normal(2, 6)))
    assert torch.equal(own.weight.detach(), torch.ones(4, 6))


@pytest.mark.parametrize("rule", ["dense_flatten", "dense_last_axis",
                                  "conv_nchw", "conv_nhwc", "batchnorm_nhwc",
                                  "layernorm"])
def test_each_layer_infers_its_input_size_as_the_reference(rule):
    x = _normal(2, 5, 6, 7)

    def build(n):
        return {"dense_flatten": lambda: n.Dense(3),
                "dense_last_axis": lambda: n.Dense(3, flatten=False),
                "conv_nchw": lambda: n.Conv2D(4, 3, groups=1),
                "conv_nhwc": lambda: n.Conv2D(4, 3, layout="NHWC"),
                "batchnorm_nhwc": lambda: n.BatchNorm(axis=-1),
                "layernorm": lambda: n.LayerNorm()}[rule]()
    jb, tb = build(jgluon.nn), build(gluon.nn)
    jb.initialize()
    tb.initialize()
    jb(jnd.array(x))
    tb(nd.array(x))
    for (k, jp), tp in zip(jb.collect_params().items(),
                           tb.collect_params().values()):
        shape = tuple(jp.shape)
        if rule == "conv_nhwc" and k.endswith("weight"):
            shape = (shape[0], shape[3], shape[1], shape[2])
        assert tp.shape == shape, k


def test_batchnorm_statistics_move_as_the_reference_in_both_modes():
    x = _normal(6, 4, 3, 3) * 2 + 1
    jbn, bn = jgluon.nn.BatchNorm(), gluon.nn.BatchNorm()
    jbn.initialize()
    bn.initialize()
    outs = []
    for b, nd_, ag in ((jbn, jnd, jag), (bn, nd, autograd)):
        o = []
        with ag.record():
            o.append(b(nd_.array(x)).asnumpy())       # batch stats, moves
        with ag.train_mode():
            o.append(b(nd_.array(x)).asnumpy())       # batch stats, moves
        o.append(b(nd_.array(x)).asnumpy())           # running stats
        with ag.pause():
            o.append(b(nd_.array(x)).asnumpy())
        o += [p.data().asnumpy() for p in b.collect_params().values()]
        outs.append(o)
    for g, w in zip(outs[1], outs[0]):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)


def test_flatten_keeps_nchw_order_for_channels_last_memory():
    x = torch.from_numpy(_normal(2, 3, 4, 5))
    cl = x.contiguous(memory_format=torch.channels_last)
    f = gluon.nn.Flatten()
    assert torch.equal(f(cl), f(x))
    np.testing.assert_array_equal(f(nd.array(cl)).asnumpy(),
                                  jnd.flatten(jnd.array(x.numpy()))
                                  .asnumpy())


# -- blocks -------------------------------------------------------------------
def _user_block(pkg):
    class Scale(pkg.gluon.HybridBlock):
        def __init__(self, **kw):
            super().__init__(**kw)
            self.w = self.params.get("w", shape=(4, 3))
            self.b = self.params.get("b", shape=(4,), init="zeros")

        def hybrid_forward(self, F, x, w, b):
            return F.relu(F.FullyConnected(x, w, b, num_hidden=4)) * 2

    return Scale()


def test_user_hybrid_forward_block_and_hybridize_match_the_reference(
        tmp_path):
    jb, tb = _user_block(jmx), _user_block(mx)
    assert _names(tb.collect_params()) == \
        [_strip(k) for k in jb.collect_params()]
    with pytest.raises(MXNetError, match="initialize"):
        tb(nd.array(_normal(2, 3)))
    jb.initialize()
    tb.initialize()
    for jp, tp in zip(jb.collect_params().values(),
                      tb.collect_params().values()):
        tp.set_data(np.asarray(jp.data()._data))
    x = _normal(5, 3)
    want = jb(jnd.array(x)).asnumpy()
    got = tb(nd.array(x)).asnumpy()
    np.testing.assert_allclose(got, want, rtol=PRODUCT_RTOL)
    tb.hybridize()
    assert tb._active
    np.testing.assert_array_equal(tb(nd.array(x)).asnumpy(), got)
    # export, once refused, writes the forward of the last call (the
    # reference's rule), and its import computes the same bits
    prefix = str(tmp_path / "model")
    tb.export(prefix)
    back = gluon.SymbolBlock.imports(prefix + "-symbol.json", ["data"],
                                     prefix + "-0000.params.npz")
    np.testing.assert_array_equal(back(nd.array(x)).asnumpy(), got)
    with pytest.raises(MXNetError, match="optimize_for"):
        tb.optimize_for(nd.array(x))


def test_hybridize_resolves_deferred_shapes_and_changes_nothing():
    torch.manual_seed(0)
    a = lenet(10).initialize(init="xavier", generator=torch.Generator()
                             .manual_seed(1))
    b = lenet(10).initialize(init="xavier", generator=torch.Generator()
                             .manual_seed(1))
    b.hybridize()
    x = nd.array(_normal(2, 1, 28, 28))
    np.testing.assert_array_equal(b(x).asnumpy(), a(x).asnumpy())
    assert all(m._active for m in b.modules())


def test_forward_hooks_see_what_the_caller_passed():
    net = gluon.nn.Dense(2, in_units=3, generator=torch.Generator())
    seen = []
    h1 = net.register_forward_pre_hook(lambda b, a: seen.append(type(a[0])))
    h2 = net.register_forward_hook(lambda b, a, o: seen.append(type(o)))
    net(nd.array(_normal(1, 3)))
    net(torch.ones(1, 3))
    h1.detach()
    with h2:
        pass
    net(nd.array(_normal(1, 3)))
    assert seen == [nd.NDArray, nd.NDArray, torch.Tensor, torch.Tensor]


def test_forward_only_block_runs_on_arrays():
    class Twice(gluon.Block):
        def __init__(self):
            super().__init__()
            self.dense = gluon.nn.Dense(2, in_units=3,
                                        generator=torch.Generator())

        def forward(self, x):
            assert isinstance(x, nd.NDArray)
            return self.dense(x) * 2 + nd.ones((1, 2))

    blk = Twice()
    x = nd.array(_normal(4, 3))
    out = blk(x)
    want = blk.dense(x).asnumpy() * 2 + 1
    np.testing.assert_allclose(out.asnumpy(), want, rtol=1e-6)


# -- Trainer and the optimizers -----------------------------------------------
def _dense_net(pkg, dtype="float32"):
    """Two Dense layers.  In bfloat16 they have no bias and no activation:
    XLA rounds a bfloat16 reduction (a bias's gradient) and each step of
    tanh's backward to bfloat16, where PyTorch's CPU kernels work in
    float32 and round once, so those gradients differ by a bfloat16 ulp
    in single entries (``test_bf16_gradients_differ_from_the_reference_
    by_rounding_only``), which a step of Adam or LAMB amplifies; products
    round once in both."""
    n = pkg.gluon.nn
    low = dtype != "float32"
    net = n.HybridSequential()
    net.add(n.Dense(16, activation=None if low else "tanh", in_units=8,
                    use_bias=not low),
            n.Dense(4, in_units=16, use_bias=not low))
    return net


def _shapes(dtype):
    if dtype == "float32":
        return [(16, 8), (16,), (4, 16), (4,)]
    return [(16, 8), (4, 16)]


def _trainer_run(pkg, name, params, dtype, weights, steps=3):
    nd_, ag = pkg.nd, pkg.autograd
    net = _dense_net(pkg, dtype)
    net.initialize()
    for p, w in zip(net.collect_params().values(), weights):
        p.set_data(nd_.array(w))
    if dtype != "float32":
        net.cast(dtype)
    before = [p.data().astype("float32").asnumpy()
              for p in net.collect_params().values()]
    trainer = pkg.gluon.Trainer(net.collect_params(), name, dict(params))
    rng = _rng(5)
    x = nd_.array(rng.randn(6, 8).astype(np.float32)).astype(dtype)
    y = nd_.array(rng.randn(6, 4).astype(np.float32))
    losses = []
    for _ in range(steps):
        with ag.record():
            out = net(x).astype("float32")
            loss = ((out - y) ** 2).sum(axis=1)
        loss.backward()
        trainer.step(6)
        losses.append(float(loss.mean().asscalar()))
    after = [p.data().astype("float32").asnumpy()
             for p in net.collect_params().values()]
    return losses, [a - b for a, b in zip(after, before)]


TRAINERS = {"sgd_momentum": ("sgd", {"learning_rate": 0.1, "momentum": 0.9,
                                     "wd": 1e-3}, "float32"),
            "adam": ("adam", {"learning_rate": 0.01, "wd": 1e-3}, "float32"),
            "lamb_bf16_multi_precision": ("lamb", {"learning_rate": 0.01,
                                                   "multi_precision": True},
                                          "bfloat16")}


def _weights(dtype, seed=9):
    rng = _rng(seed)
    weights = [(rng.randn(*s) * 0.3).astype(np.float32)
               for s in _shapes(dtype)]
    if dtype == "bfloat16":             # exactly representable in bf16
        weights = [np.round(w * 64) / 64 for w in weights]
    return weights


@pytest.mark.parametrize("case", list(TRAINERS))
def test_three_trainer_steps_match_the_reference(case):
    name, params, dtype = TRAINERS[case]
    weights = _weights(dtype)
    want, want_d = _trainer_run(jmx, name, params, dtype, weights)
    got, got_d = _trainer_run(mx, name, params, dtype, weights)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[-1] < got[0]
    for i, (g, w) in enumerate(zip(got_d, want_d)):
        rel = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30)
        assert rel <= 1e-2, (i, rel)


def test_bf16_gradients_differ_from_the_reference_by_rounding_only():
    """The bfloat16 Dense net with biases and tanh: every gradient entry
    within two bfloat16 roundings (2^-7 relative, of the larger of the
    entry and the tensor's largest entry) of the reference's, which
    rounds after each add of the batch sum and each step of tanh's
    backward (one rounding measured at most 1.02 of 2^-8 here)."""
    grads = []
    for pkg in (jmx, mx):
        n = pkg.gluon.nn
        net = n.HybridSequential()
        net.add(n.Dense(16, activation="tanh", in_units=8),
                n.Dense(4, in_units=16))
        net.initialize()
        for p, w in zip(net.collect_params().values(), _weights("float32")):
            p.set_data(pkg.nd.array(np.round(w * 64) / 64))
        net.cast("bfloat16")
        rng = _rng(5)
        x = pkg.nd.array(rng.randn(6, 8).astype(np.float32)) \
            .astype("bfloat16")
        y = pkg.nd.array(rng.randn(6, 4).astype(np.float32))
        with pkg.autograd.record():
            loss = ((net(x).astype("float32") - y) ** 2).sum(axis=1)
        loss.backward()
        grads.append([p.grad.astype("float32").asnumpy()
                      for p in net.collect_params().values()])
    for i, (g, w) in enumerate(zip(*grads[::-1])):
        bound = 2.0 ** -7 * np.maximum(np.abs(w), np.abs(w).max())
        assert (np.abs(g - w) <= bound).all(), i
        assert g.any()


def test_trainer_before_the_first_forward_and_its_surface(tmp_path):
    net = _mlp(mx).initialize(init="xavier")
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 0.1, "momentum": 0.5})
    assert len(trainer._params) == 6       # running statistics excluded
    x, y = nd.array(_normal(4, 3)), nd.array(np.array([0, 1, 2, 1.0]))
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    with pytest.raises(MXNetError, match="not initialized"):
        trainer.step(4)

    def step():
        with autograd.record():
            loss = loss_fn(net(x), y)
        loss.backward()
        trainer.step(4)
        return loss.mean().asscalar()
    l0 = step()
    assert trainer.learning_rate == 0.1
    trainer.set_learning_rate(0.05)
    assert trainer.optimizer.lr == 0.05
    f = str(tmp_path / "states")
    trainer.save_states(f)
    snap = {k: p.data().asnumpy().copy()
            for k, p in net.collect_params().items()}
    l1 = step()
    for k, p in net.collect_params().items():
        p.set_data(snap[k])
    trainer.load_states(f)
    assert step() == pytest.approx(l1, rel=1e-6) and l1 < l0
    dist = gluon.Trainer(net.collect_params(), "sgd", kvstore="dist_sync")
    assert (dist._kvstore.type, dist._kvstore.num_workers) == ("dist_sync", 1)
    with pytest.raises(MXNetError, match="unknown KVStore type"):
        gluon.Trainer(net.collect_params(), "sgd", kvstore="dist_bogus")


def test_lr_and_wd_multipliers_and_the_updater():
    w = nd.array(np.ones(3, np.float32))
    g = nd.array(np.full(3, 0.5, np.float32))
    opt = optimizer.create("sgd", learning_rate=0.1, wd=0.1)
    upd = optimizer.get_updater(opt)
    upd(0, g, w)
    np.testing.assert_allclose(w.asnumpy(), 1 - 0.1 * (0.5 + 0.1), rtol=1e-6)
    assert opt.num_update == 1 and 0 in upd.get_states()
    net = gluon.nn.Dense(1, in_units=3, use_bias=False,
                         generator=torch.Generator())
    p = next(iter(net.collect_params().values()))
    p.lr_mult = 0.0
    before = net.weight.detach().clone()
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 1.0})
    with autograd.record():
        out = net(nd.ones((2, 3)))
    out.backward()
    trainer.step(2)
    assert torch.equal(net.weight.detach(), before)


def test_adam_update_core_matches_the_reference():
    from tpu_mx.ndarray.ops import adam_update_core as jcore
    from tpu_mx_torch.ndarray.ops import adam_update_core as tcore
    a = [_normal(5, seed=s) for s in range(3)]
    args = dict(lr=0.01, beta1=0.9, beta2=0.99, epsilon=1e-8, wd=0.1, t=3,
                rescale_grad=0.5, clip_gradient=0.3)
    want = jcore(*[jnd.array(x)._data for x in a], np.abs(a[0]), **args)
    got = tcore(*[torch.from_numpy(x) for x in a],
                torch.from_numpy(np.abs(a[0])), **args)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)


# -- io, metric, utils --------------------------------------------------------
@pytest.mark.parametrize("last", ["pad", "discard", "roll_over"])
def test_ndarray_iter_batches_equal_the_reference(last):
    rng = _rng(2)
    data = rng.randn(21, 3).astype(np.float32)
    label = rng.randint(0, 5, 21).astype(np.float32)
    runs = []
    for io_ in (jmx.io, mx.io):
        it = io_.NDArrayIter(data, label, batch_size=4, shuffle=True,
                             last_batch_handle=last, seed=11)
        epochs = []
        for _ in range(3):
            it.reset()
            epochs.append([(b.data[0].asnumpy(), b.label[0].asnumpy(),
                            b.pad) for b in it])
        runs.append(epochs)
        assert it.provide_data[0].shape == (4, 3)
        assert it.provide_label[0].name == "softmax_label"
    for ew, eg in zip(*runs):
        assert len(eg) == len(ew)
        for (dw, lw, pw), (dg, lg, pg) in zip(ew, eg):
            np.testing.assert_array_equal(dg, dw)
            np.testing.assert_array_equal(lg, lw)
            assert pg == pw


def test_ndarray_iter_global_shuffle_and_state_dict():
    data = np.arange(20, dtype=np.float32).reshape(10, 2)
    runs = []
    for io_ in (jmx.io, mx.io):
        np.random.seed(4)
        it = io_.NDArrayIter(data, batch_size=3, shuffle=True)
        runs.append([b.data[0].asnumpy() for b in it])
    for g, w in zip(runs[1], runs[0]):
        np.testing.assert_array_equal(g, w)
    it = mx.io.NDArrayIter(data, batch_size=3, shuffle=True, seed=1)
    next(it)
    state = it.state_dict()
    rest = [b.data[0].asnumpy() for b in it]
    again = mx.io.NDArrayIter(data, batch_size=3, shuffle=True, seed=1)
    again.load_state_dict(state)
    for g, w in zip([b.data[0].asnumpy() for b in again], rest):
        np.testing.assert_array_equal(g, w)
    # elastic sharding: each rank's slices equal the reference's
    for io_ in (jmx.io, mx.io):
        its = [io_.NDArrayIter(data, batch_size=4, shuffle=True, seed=2,
                               num_workers=2, rank=r) for r in range(2)]
        runs.append([[(b.data[0].asnumpy(), b.pad) for b in it]
                     for it in its])
    for (dg, pg), (dw, pw) in zip(sum(runs[-1], []), sum(runs[-2], [])):
        np.testing.assert_array_equal(dg, dw)
        assert pg == pw


def test_metrics_equal_the_reference():
    rng = _rng(3)
    labels = [rng.randint(0, 5, 8).astype(np.float32) for _ in range(3)]
    logits = [rng.randn(8, 5).astype(np.float32) for _ in range(3)]
    probs = [np.exp(z) / np.exp(z).sum(1, keepdims=True) for z in logits]
    for name, kw in (("acc", {}), ("ce", {}), ("perplexity",
                                              {"ignore_label": 2}),
                     ("loss", {})):
        jm, tm = jmx.metric.create(name, **kw), mx.metric.create(name, **kw)
        for lab, pr, z in zip(labels, probs, logits):
            src = z if name == "acc" else pr
            jm.update([jnd.array(lab)], [jnd.array(src)])
            tm.update([nd.array(lab)], [nd.array(src)])
        assert tm.get()[0] == jm.get()[0]
        assert tm.get()[1] == pytest.approx(float(jm.get()[1]), rel=1e-6)
        tm.reset()
        assert np.isnan(tm.get()[1])
    m = mx.metric.Accuracy()
    m.update(nd.array(labels[0]), torch.from_numpy(logits[0]))
    assert m.get_name_value()[0][0] == "accuracy"
    with pytest.raises(MXNetError, match="not registered"):
        mx.metric.create("bleu")


def test_clip_global_norm_and_split_and_load():
    arrays = [_normal(3, 4), _normal(5, seed=1)]
    j = [jnd.array(a) for a in arrays]
    t = [nd.array(a) for a in arrays]
    want = jgluon.utils.clip_global_norm(j, 1.0)
    got = gluon.utils.clip_global_norm(t, 1.0)
    assert got == pytest.approx(want, rel=1e-6)
    for g, w in zip(t, j):
        np.testing.assert_allclose(g.asnumpy(), w.asnumpy(), rtol=1e-6)
    held = t[0]._data
    gluon.utils.clip_global_norm(t, 0.1)        # in place
    assert t[0]._data is held
    assert np.linalg.norm(np.concatenate([a.asnumpy().ravel() for a in t])) \
        == pytest.approx(0.1, rel=1e-5)
    x = nd.array(_normal(6, 2))
    parts = gluon.utils.split_data(x, 3)
    assert [p.shape for p in parts] == [(2, 2)] * 3
    assert gluon.utils.split_and_load(x, [CPU])[0] is x
    with pytest.raises(ValueError):
        gluon.utils.split_data(x, 4)
    uneven = gluon.utils.split_data(x, 4, even_split=False)
    assert [p.shape[0] for p in uneven] == [1, 1, 1, 3]


# -- LeNet --------------------------------------------------------------------
def _lenet_pair(batch=8):
    jmx.random.seed(0)
    jnet, net = jlenet(10), lenet(10)
    jnet.initialize(init="xavier")
    net.initialize(init="xavier")
    x = _rng(1).rand(batch, 1, 28, 28).astype(np.float32)
    jnet(jnd.array(x))
    net(nd.array(x))
    for jp, tp in zip(jnet.collect_params().values(),
                      net.collect_params().values()):
        assert tuple(jp.shape) == tp.shape
        tp.set_data(np.asarray(jp.data()._data))
    return jnet, net, x


def test_lenet_logits_match_the_reference_after_deferred_init():
    jnet, net, x = _lenet_pair()
    assert _names(net.collect_params()) == \
        [_strip(k) for k in jnet.collect_params()]
    want = jnet(jnd.array(x)).asnumpy()
    got = net(nd.array(x)).asnumpy()
    assert got.shape == (8, 10)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_three_imperative_lenet_sgd_steps_match_the_reference():
    jnet, net, x = _lenet_pair()
    y = _rng(2).randint(0, 10, 8).astype(np.float32)
    losses = []
    for pkg, model in ((jmx, jnet), (mx, net)):
        trainer = pkg.gluon.Trainer(model.collect_params(), "sgd",
                                    {"learning_rate": 0.05,
                                     "momentum": 0.9})
        loss_fn = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
        run = []
        for _ in range(3):
            with pkg.autograd.record():
                loss = loss_fn(model(pkg.nd.array(x)), pkg.nd.array(y))
            loss.backward()
            trainer.step(8)
            run.append(float(loss.mean().asscalar()))
        losses.append(run)
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-4)
    for (k, jp), tp in zip(jnet.collect_params().items(),
                           net.collect_params().values()):
        np.testing.assert_allclose(tp.data().asnumpy(),
                                   np.asarray(jp.data()._data), rtol=1e-4,
                                   atol=1e-4, err_msg=k)


def test_the_mnist_example_loop_runs_unchanged():
    """``examples/mnist/train_mnist.py``'s loop body, at 512 samples and
    one epoch, with the import and the context changed."""
    n, batch_size = 512, 128
    rng = np.random.RandomState(0)
    y = rng.randint(0, 10, n)
    x = rng.rand(n, 1, 28, 28).astype(np.float32) * 0.1
    for i, lbl in enumerate(y):
        x[i, 0, lbl * 2:lbl * 2 + 4, 4:24] += 0.9
    train_iter = mx.io.NDArrayIter(x, y.astype(np.float32),
                                   batch_size=batch_size, shuffle=True,
                                   label_name="softmax_label")
    net = lenet(classes=10)
    net.initialize(init="xavier")
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 0.05, "momentum": 0.9})
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    train_iter.reset()
    metric = mx.metric.Accuracy()
    seen = 0
    for batch in train_iter:
        data, label = batch.data[0], batch.label[0]
        with autograd.record():
            out = net(data)
            loss = loss_fn(out, label)
        loss.backward()
        trainer.step(data.shape[0])
        metric.update([label], [out])
        seen += data.shape[0]
    assert seen == n
    acc = metric.get()[1]
    assert 0.0 <= acc <= 1.0 and np.isfinite(loss.asnumpy()).all()
    train_iter.reset()
    final = mx.metric.Accuracy()
    for batch in train_iter:
        final.update([batch.label[0]], [net(batch.data[0])])
    assert final.get()[1] > 0.5


# -- the imperative BERT step against CompiledTrainStep -----------------------
def test_imperative_bert_step_equals_compiled_train_step():
    from tpu_mx_torch.models import BERTModel, MLMLoss, bert_base_config
    from tpu_mx_torch.parallel import CompiledTrainStep
    cfg = bert_base_config(vocab_size=100, max_len=64)
    cfg.update(num_layers=2, units=64, hidden_size=128, num_heads=4,
               dropout=0.0)
    rng = _rng(0)
    b, t, m = 4, 32, 5
    tokens = rng.randint(4, 100, (b, t)).astype(np.int32)
    types = rng.randint(0, 2, (b, t)).astype(np.int32)
    valid = rng.randint(m + 1, t + 1, b).astype(np.int32)
    pos = np.stack([rng.choice(n, m, replace=False)
                    for n in valid]).astype(np.int32)
    labels = np.take_along_axis(tokens, pos, axis=1).astype(np.float32)
    a = BERTModel(cfg, device="cpu", generator=torch.Generator()
                  .manual_seed(0))
    c = BERTModel.from_numpy({k: v.detach().numpy()
                              for k, v in a.named_parameters()}, cfg,
                             device="cpu")
    step = CompiledTrainStep(c, MLMLoss(), optimizer.create(
        "lamb", learning_rate=1e-3, wd=0.01), device="cpu")
    trainer = gluon.Trainer(a.collect_params(), "lamb",
                            {"learning_rate": 1e-3, "wd": 0.01})
    loss_fn = MLMLoss()
    batch = [nd.array(x) for x in (tokens, types, valid, pos, labels)]
    for _ in range(2):
        want = float(step.step(*(torch.from_numpy(x) for x in
                                 (tokens, types, valid, pos, labels))))
        with autograd.record():
            loss = loss_fn(a(*batch[:4]), batch[4])
        loss.backward()
        trainer.step(b)
        got = float(loss.mean().asscalar())
        assert abs(got - want) <= 1e-5 * abs(want)
    named = dict(c.named_parameters())
    for k, p in a.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(),
                                   named[k].detach().numpy(), rtol=1e-4,
                                   atol=1e-4, err_msg=k)


def test_no_graph_is_kept_alive_across_steps():
    net = _mlp(mx).initialize()
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 0.1})
    x, y = nd.array(_normal(4, 3)), nd.array(np.array([0, 1, 2, 1.0]))
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    metric = mx.metric.Accuracy()
    for _ in range(3):
        with autograd.record():
            out = net(x)
            loss = loss_fn(out, y)
        loss.backward()
        trainer.step(4)
        metric.update([y], [out])
        assert not loss.mean()._data.requires_grad
        assert not (next(iter(net.collect_params().values())).data() * 2) \
            ._data.requires_grad
    assert out._data.grad_fn is not None          # until it is dropped
    with pytest.raises(RuntimeError):             # the graph was freed
        loss.backward()


# -- rtc with arrays ----------------------------------------------------------
def test_rtc_launch_takes_arrays(monkeypatch):
    mod = rtc.CudaModule('extern "C" __global__ void scale(const float* x, '
                         'float* y, float alpha, int n) { '
                         'int i = blockIdx.x * blockDim.x + threadIdx.x; '
                         'if (i < n) y[i] = x[i] * alpha; }')
    k = mod.get_kernel("scale", alpha=3.0)
    with pytest.raises(MXNetError, match="no CUDA-C interpreter"):
        k.launch((nd.array(np.ones(8, np.float32)),))
    calls = []

    def fake(self, args, *rest):
        calls.append(args)
        return args[0] * 3.0
    monkeypatch.setattr(rtc.Kernel, "_launch", fake)
    x = nd.array(np.arange(4, dtype=np.float32))
    y = k.launch((x,))
    assert isinstance(y, nd.NDArray)
    np.testing.assert_array_equal(y.asnumpy(), x.asnumpy() * 3)
    assert isinstance(calls[0][0], torch.Tensor)
    assert isinstance(k(x), nd.NDArray)
    assert isinstance(k.launch((x._data,)), torch.Tensor)
    assert isinstance(k.launch(x), nd.NDArray)
