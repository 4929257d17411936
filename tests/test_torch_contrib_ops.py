"""The rest of ``nd.contrib`` (``tpu_mx/ndarray/contrib.py:342-830``)
against the JAX reference, on the CPU.

The operators: one case per name and option that changes the math, the
same inputs (numpy, from a seed) through both packages, forward and,
where the reference differentiates, gradient under
``autograd.record()`` from one random head gradient.  Tolerance 1e-5
of the output's largest entry (float32 gathers, products, FFTs); 1e-4
for ``hawkesll`` (a float32 recursion of exponentials and logs over the
events) and ``DeformableConvolution`` (a C·kh·kw-long product).

Control flow (``foreach``, ``while_loop``, ``cond``) is held to the
reference both eagerly and inside a hybridized ``HybridBlock`` (the
reference traces it there; the port runs the same Python loop), and
``foreach``'s gradient eagerly.  ``boolean_mask`` has a data-dependent
shape: it runs eagerly and in a block that is not hybridized, and
raises ``MXNetError`` inside a hybridized block's call and a
``CompiledTrainStep``, where the reference's raises under its trace.
"""
import numpy as np
import pytest
import torch

import tpu_mx as jmx
from tpu_mx import autograd as jag
from tpu_mx import nd as jnd

import tpu_mx_torch as mx
from tpu_mx_torch import autograd, gluon, nd

RTOL = 1e-5
LONG_RTOL = 1e-4


@pytest.fixture(autouse=True)
def _host():
    torch.backends.mkldnn.enabled = False
    with mx.cpu():
        yield


def _rs(seed):
    return np.random.RandomState(seed)


def _normal(*shape, seed=0):
    return _rs(seed).randn(*shape).astype(np.float32)


def _run(ndm, ag, name, args, kw, grad):
    arrs = [ndm.array(a) if isinstance(a, np.ndarray) else a for a in args]
    for i in grad:
        arrs[i].attach_grad()
    with ag.record():
        out = getattr(ndm.contrib, name)(*arrs, **kw)
    outs = out if isinstance(out, (list, tuple)) else [out]
    if grad:
        heads = [ndm.array(_normal(*o.shape, seed=7 + j))
                 for j, o in enumerate(outs)]
        ag.backward(outs, heads)
    return [o.asnumpy() for o in outs], [arrs[i].grad.asnumpy()
                                         for i in grad]


def _same(got, want, rtol, what):
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if want.dtype.kind in "iub":
        assert got.dtype.kind == want.dtype.kind, (what, got.dtype)
        np.testing.assert_array_equal(got, want, err_msg=what)
        return
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    w = want.astype(np.float64)
    scale = max(np.abs(w).max(), 1e-30) if w.size else 1.0
    np.testing.assert_allclose(got.astype(np.float64), w, rtol=rtol,
                               atol=rtol * scale, err_msg=what)


def _hawkes_inputs(seed=0, n=3, k=4, t=7):
    r = _rs(seed)
    lda = r.uniform(0.2, 1.0, (n, k)).astype(np.float32)
    alpha = r.uniform(0.1, 0.6, k).astype(np.float32)
    beta = r.uniform(0.5, 2.0, k).astype(np.float32)
    state = r.uniform(0.0, 0.5, (n, k)).astype(np.float32)
    lags = r.uniform(0.05, 1.0, (n, t)).astype(np.float32)
    marks = r.randint(0, k, (n, t)).astype(np.float32)
    valid = np.asarray([t, 4, 0], np.float32)[:n]
    max_time = (lags.sum(1) + r.uniform(0.0, 2.0, n)).astype(np.float32)
    return [lda, alpha, beta, state, lags, marks, valid, max_time]


IMG = _normal(2, 4, 7, 6, seed=1)
X = _normal(5, 8, seed=2)
MASK = np.asarray([1, 0, 2, 0, -1], np.float32)
DC_DATA = _normal(2, 4, 7, 8, seed=3)
DC_W = _normal(5, 4, 3, 3, seed=4) * 0.3
DC_B = _normal(5, seed=5)
DC_OFF = _normal(2, 2 * 9, 7, 8, seed=6) * 1.5
DC_OFF2 = _normal(2, 2 * 2 * 9, 4, 4, seed=7) * 1.5

CASES = [
    ("AdaptiveAvgPooling2D", "AdaptiveAvgPooling2D", [IMG],
     dict(output_size=3), (0,), RTOL),
    ("AdaptiveAvgPooling2D-pair", "AdaptiveAvgPooling2D", [IMG],
     dict(output_size=(4, 5)), (0,), RTOL),
    ("DeformableConvolution", "DeformableConvolution",
     [DC_DATA, DC_OFF, DC_W, DC_B],
     dict(kernel=(3, 3), pad=(1, 1), num_filter=5), (0, 1, 2, 3),
     LONG_RTOL),
    ("DeformableConvolution-groups-stride-dilate", "DeformableConvolution",
     [DC_DATA, DC_OFF2, DC_W],
     dict(kernel=(3, 3), stride=(2, 2), dilate=(2, 1), pad=(2, 1),
          num_filter=5, num_deformable_group=2, no_bias=True), (0, 1, 2),
     LONG_RTOL),
    ("allclose-true", "allclose", [X, X + 1e-7], {}, (), RTOL),
    ("allclose-false", "allclose", [X, X + 1e-3], dict(rtol=1e-6), (),
     RTOL),
    ("arange_like", "arange_like", [IMG], dict(start=2.0, step=0.5), (),
     RTOL),
    ("arange_like-axis", "arange_like", [IMG], dict(axis=2, step=3.0), (),
     RTOL),
    ("arange_like-repeat", "arange_like", [X], dict(repeat=3, start=1.0),
     (), RTOL),
    ("boolean_mask", "boolean_mask", [X, MASK], {}, (0,), RTOL),
    ("boolean_mask-axis1", "boolean_mask",
     [X, np.asarray([0, 1, 1, 0, 0, 0, 1, 1], np.float32)], dict(axis=1),
     (0,), RTOL),
    ("count_sketch", "count_sketch",
     [X, _rs(8).randint(0, 5, 8).astype(np.float32),
      np.sign(_normal(8, seed=9))], dict(out_dim=5), (0, 2), RTOL),
    ("div_sqrt_dim", "div_sqrt_dim", [IMG], {}, (0,), RTOL),
    ("fft", "fft", [_normal(3, 16, seed=10)], {}, (0,), RTOL),
    ("ifft", "ifft", [_normal(3, 32, seed=11)], {}, (0,), RTOL),
    ("gradientmultiplier", "gradientmultiplier", [X], dict(scalar=-0.3),
     (0,), RTOL),
    ("hawkesll", "hawkesll", _hawkes_inputs(), {}, (0, 1, 2, 3, 4, 7),
     LONG_RTOL),
    ("index_array", "index_array", [IMG], {}, (), RTOL),
    ("index_array-axes", "index_array", [IMG], dict(axes=(3, 1)), (), RTOL),
    ("index_copy", "index_copy",
     [X, np.asarray([3, 0], np.float32), _normal(2, 8, seed=12)], {},
     (0, 2), RTOL),
    ("quadratic", "quadratic", [X], dict(a=0.5, b=-2.0, c=3.0), (0,), RTOL),
]


@pytest.mark.parametrize("cid,name,args,kw,grad,rtol", CASES,
                         ids=[c[0] for c in CASES])
def test_contrib_operator_matches_the_reference(cid, name, args, kw, grad,
                                                rtol):
    want, want_g = _run(jnd, jag, name, args, kw, grad)
    got, got_g = _run(nd, autograd, name, args, kw, grad)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        _same(g, w, rtol, f"{cid} output {i}")
    for i, g, w in zip(grad, got_g, want_g):
        _same(g, w, rtol, f"{cid} gradient {i}")


def test_ifft_is_unnormalized_and_inverts_fft():
    x = _normal(2, 8, seed=13)
    back = nd.contrib.ifft(nd.contrib.fft(nd.array(x))).asnumpy()
    np.testing.assert_allclose(back, 8 * x, rtol=1e-5, atol=1e-5)
    f = nd.contrib.fft(nd.array(x)).asnumpy().reshape(2, 8, 2)
    want = np.fft.fft(x)
    np.testing.assert_allclose(f[..., 0], want.real, atol=1e-5)
    np.testing.assert_allclose(f[..., 1], want.imag, atol=1e-5)


def test_gradientmultiplier_is_the_identity_forward():
    a = nd.array(X)
    a.attach_grad()
    with autograd.record():
        y = nd.contrib.gradientmultiplier(a, scalar=2.5)
    y.backward()
    np.testing.assert_array_equal(y.asnumpy(), X)
    np.testing.assert_array_equal(a.grad.asnumpy(), np.full_like(X, 2.5))


def test_hawkesll_carries_its_state_across_calls():
    """Two calls over the halves of a sequence, the state carried, give
    the log-likelihood of one call over the whole."""
    lda, alpha, beta, state, lags, marks, _, _ = _hawkes_inputs(seed=3, n=2,
                                                                t=6)
    valid = np.full(2, 6, np.float32)
    t_half = lags[:, :3].sum(1)
    t_end = lags.sum(1) + 0.5
    whole, _ = nd.contrib.hawkesll(*[nd.array(a) for a in (
        lda, alpha, beta, state, lags, marks, valid, t_end)])
    first, s1 = nd.contrib.hawkesll(*[nd.array(a) for a in (
        lda, alpha, beta, state, lags[:, :3], marks[:, :3],
        np.full(2, 3, np.float32), t_half)])
    second, _ = nd.contrib.hawkesll(
        *[nd.array(a) for a in (lda, alpha, beta)], s1,
        *[nd.array(a) for a in (lags[:, 3:], marks[:, 3:],
                                np.full(2, 3, np.float32), t_end - t_half)])
    np.testing.assert_allclose((first + second).asnumpy(), whole.asnumpy(),
                               rtol=1e-5)


# -- control flow ---------------------------------------------------------------
SEQ = _normal(5, 3, 4, seed=14)
H0 = _normal(3, 4, seed=15)


def _foreach(F, C, seq, h):
    def body(x, states):
        s = F.tanh(x + states[0])
        return s * 2, [s, states[1] + x]
    out, fin = C.foreach(body, seq, [h, h * 0])
    return out, fin[0], fin[1]


def _while(F, C, h, limit, max_iterations):
    def cond_fn(i, s):
        return i < limit

    def func(i, s):
        s2 = F.tanh(s) + 1
        return s2 * i, [i + 1, s2]
    out, fin, _ = C.while_loop(cond_fn, func, [h[:1, :1] * 0, h],
                                       max_iterations=max_iterations)
    return out, fin[0], fin[1]


def _cond(F, C, x):
    return C.cond(F.sum(x) > 0, lambda: x * 2, lambda: x - 1)


def _block(pkg, contrib, fn):
    """A block over ``fn(F, contrib, *args)`` (the reference's ``F``
    inside a trace is its operator module, without ``contrib``)."""
    class Body(pkg.gluon.HybridBlock):
        def hybrid_forward(self, F, *args):
            return fn(F, contrib, *args)
    return Body()


def _outs(out):
    return [o.asnumpy() for o in (out if isinstance(out, (list, tuple))
                                  else [out])]


FLOW = [
    ("foreach", _foreach, [SEQ, H0], {}),
    ("while_loop", lambda F, C, h: _while(F, C, h, 3.0, 6), [H0], {}),
    ("while_loop-full", lambda F, C, h: _while(F, C, h, 9.0, 4), [H0], {}),
    ("while_loop-zero-trip", lambda F, C, h: _while(F, C, h, -1.0, 3), [H0],
     {}),
    ("cond-then", _cond, [np.abs(H0)], {}),
    ("cond-else", _cond, [-np.abs(H0)], {}),
]


@pytest.mark.parametrize("hybrid", [False, True], ids=["eager", "hybridized"])
@pytest.mark.parametrize("cid,fn,args,kw", FLOW, ids=[f[0] for f in FLOW])
def test_control_flow_matches_the_reference(cid, fn, args, kw, hybrid):
    def call(pkg, ndm):
        arrs = [ndm.array(a) for a in args]
        if not hybrid:
            return _outs(fn(ndm, ndm.contrib, *arrs))
        blk = _block(pkg, ndm.contrib, fn)
        blk.hybridize()
        return _outs(blk(*arrs))
    want, got = call(jmx, jnd), call(mx, nd)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        _same(g, w, RTOL, f"{cid} output {i}")


def test_foreach_gradient_matches_the_reference():
    grads = []
    for ndm, ag in ((jnd, jag), (nd, autograd)):
        seq, h = ndm.array(SEQ), ndm.array(H0)
        seq.attach_grad()
        h.attach_grad()
        with ag.record():
            out, a, b = _foreach(ndm, ndm.contrib, seq, h)
            loss = (out * ndm.array(_normal(5, 3, 4, seed=16))).sum() \
                + (a * b).sum()
        loss.backward()
        grads.append((seq.grad.asnumpy(), h.grad.asnumpy()))
    for g, w, what in zip(grads[1], grads[0], ("seq", "h")):
        _same(g, w, RTOL, what)


def test_while_loop_steps_and_buffer():
    for limit, steps in ((3.0, 3), (9.0, 4), (-1.0, 0)):
        h = nd.array(H0)
        out, fin, n = nd.contrib.while_loop(
            lambda i, s: i < limit,
            lambda i, s: (s * 1.0, [i + 1, s]), [nd.zeros((1,)), h],
            max_iterations=4)
        assert n == steps and out.shape == (4, 3, 4)
        assert (out.asnumpy()[steps:] == 0).all()
        assert float(fin[0].asnumpy()[0]) == steps
    with pytest.raises(ValueError, match="max_iterations"):
        nd.contrib.while_loop(lambda i: i < 1, lambda i: (i, [i]),
                              [nd.zeros((1,))], max_iterations=0)


def _masking(pkg, contrib):
    class Mask(pkg.gluon.HybridBlock):
        def hybrid_forward(self, F, x, m):
            return contrib.boolean_mask(x, m)
    return Mask()


def test_boolean_mask_runs_in_a_block_that_is_not_hybridized():
    x, m = nd.array(X), nd.array(MASK)
    out = _masking(mx, nd.contrib)(x, m).asnumpy()
    np.testing.assert_array_equal(out, X[MASK != 0])
    ref = _masking(jmx, jnd.contrib)(jnd.array(X), jnd.array(MASK)).asnumpy()
    np.testing.assert_array_equal(out, ref)


def test_boolean_mask_refuses_under_hybridize_as_the_reference():
    for pkg, ndm in ((jmx, jnd), (mx, nd)):
        blk = _masking(pkg, ndm.contrib)
        blk.hybridize()
        with pytest.raises(pkg.MXNetError, match="data-dependent"):
            blk(ndm.array(X), ndm.array(MASK))
    # the scope ends with the call: eager use works again
    assert nd.contrib.boolean_mask(nd.array(X), nd.array(MASK)).shape == \
        (3, 8)


def test_boolean_mask_refuses_in_a_compiled_train_step():
    from tpu_mx.parallel import CompiledTrainStep as RefStep
    from tpu_mx_torch import optimizer
    from tpu_mx_torch.parallel import CompiledTrainStep

    def net(pkg, contrib):
        class Masked(pkg.gluon.HybridBlock):
            def __init__(self):
                super().__init__()
                self.dense = pkg.gluon.nn.Dense(2, in_units=8)

            def hybrid_forward(self, F, x):
                return self.dense(contrib.boolean_mask(x, x[:, 0] > 0))
        n = Masked()
        n.initialize()
        return n

    x, y = X, np.zeros((5, 2), np.float32)
    ref = RefStep(net(jmx, jnd.contrib), jmx.gluon.loss.L2Loss(),
                  jmx.optimizer.create("sgd", learning_rate=0.1))
    with pytest.raises(jmx.MXNetError, match="data-dependent"):
        ref.step(jnd.array(x), jnd.array(y))
    step = CompiledTrainStep(net(mx, nd.contrib), gluon.loss.L2Loss(),
                             optimizer.create("sgd", learning_rate=0.1))
    with pytest.raises(mx.MXNetError, match="data-dependent"):
        step.step(torch.from_numpy(x), torch.from_numpy(y))
    assert autograd._STATE.traced == 0


def test_control_flow_inside_a_compiled_train_step_matches_the_reference():
    """``foreach`` (differentiable), ``while_loop`` and ``cond`` inside a
    ``CompiledTrainStep``'s forward: the reference traces them (a scan,
    a while loop, a cond), the port runs them eagerly; three SGD steps
    give the same losses and weights.  (The port's loop also carries a
    gradient through ``while_loop`` there; the reference's traced one
    cannot, so this case blocks it.)"""
    from tpu_mx.parallel import CompiledTrainStep as RefStep
    from tpu_mx_torch import optimizer
    from tpu_mx_torch.parallel import CompiledTrainStep

    w0 = _normal(4, 4, seed=20) * 0.3

    def net(pkg, contrib):
        class Loop(pkg.gluon.HybridBlock):
            def __init__(self):
                super().__init__()
                self.dense = pkg.gluon.nn.Dense(4, in_units=4,
                                                use_bias=False)

            def hybrid_forward(self, F, x):
                def body(xt, st):
                    s = F.tanh(self.dense(xt) + st)
                    return s, s
                out, last = contrib.foreach(body, x, x[0] * 0)
                buf, (_, fin), _ = contrib.while_loop(
                    lambda i, s: i < 2,
                    lambda i, s: (s * 0.5, [i + 1, s * 0.5]),
                    [F.zeros_like(last[:1, :1]), last], max_iterations=3)
                # the reference's traced while_loop has no gradient (jax's
                # while loop): its outputs enter the loss as constants
                buf, fin = F.BlockGrad(buf), F.BlockGrad(fin)
                scale = contrib.cond(F.sum(fin) > 1e6, lambda: fin * 0,
                                     lambda: fin + 1)
                return out.sum(axis=0) + buf.sum(axis=0) + scale
        n = Loop()
        n.initialize()
        n.dense.weight.set_data(pkg.nd.array(w0))
        return n

    x, y = SEQ, np.zeros((3, 4), np.float32)
    ref_net, port_net = net(jmx, jnd.contrib), net(mx, nd.contrib)
    ref = RefStep(ref_net, jmx.gluon.loss.L2Loss(),
                  jmx.optimizer.create("sgd", learning_rate=0.5))
    step = CompiledTrainStep(port_net, gluon.loss.L2Loss(),
                             optimizer.create("sgd", learning_rate=0.5))
    for _ in range(3):
        want = float(np.asarray(ref.step(jnd.array(x), jnd.array(y))))
        got = float(step.step(torch.from_numpy(x), torch.from_numpy(y)))
        np.testing.assert_allclose(got, want, rtol=1e-5)
    step.sync_to_net()
    ref.sync_to_net()
    np.testing.assert_allclose(port_net.dense.weight.data().asnumpy(),
                               ref_net.dense.weight.data().asnumpy(),
                               rtol=1e-5, atol=1e-6)
