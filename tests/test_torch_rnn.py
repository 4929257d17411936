"""The port's PTB LSTM slice against the JAX reference, on the CPU.

The fused RNN operator (``nd.RNN``), the ``gluon.rnn`` layers and cells,
``Embedding``, ``RNNModel`` and the word-LM train step.  Inputs and
weights are made with numpy from a seed and fed to both packages; the
reference's ``collect_params()`` is carried into the port with
``load_numpy``/``from_numpy``.  Small sizes: T 5-8, N 3-4, widths 4-32,
1-2 layers.  Both arms of the recurrence run here: ``scan`` (plain
PyTorch) and ``fused`` (ATen's own CPU recurrence: oneDNN's RNN, which
ATen takes on the CPU when oneDNN is on, is switched off so the backend
is pinned).
"""
import inspect
import math

import numpy as np
import pytest
import torch

import tpu_mx as mx
from tpu_mx import autograd, gluon, nd
from tpu_mx.gluon import nn as jnn
from tpu_mx.gluon import rnn as jrnn
from tpu_mx.models.lstm_lm import RNNModel as JRNNModel
from tpu_mx.ndarray.rnn_op import rnn_param_size as j_rnn_param_size
from tpu_mx.parallel import CompiledTrainStep as JCompiledTrainStep

import tpu_mx_torch as tmx
from tpu_mx_torch import ndarray, optimizer, telemetry
from tpu_mx_torch.base import MXNetError
from tpu_mx_torch.gluon import loss as tloss
from tpu_mx_torch.gluon import nn, rnn
from tpu_mx_torch.gluon.block import load_numpy
from tpu_mx_torch.models import RNNModel
from tpu_mx_torch.ndarray import rnn_op
from tpu_mx_torch.parallel import CompiledTrainStep

OP_TOL = 1e-5       # one f32 operator or layer, two implementations
GRAD_TOL = 1e-4     # gradients through the recurrence
STEP_TOL = 1e-4     # three f32 SGD steps: losses (relative)
UPDATE_TOL = 1e-2   # per-tensor change over the steps, relative in norm
BF16_TOL = 2e-2     # the first bf16 loss, relative

# the reference's fused-op cases (tests/test_ops_ext.py:272-275)
OP_CASES = [("lstm", 1, False), ("lstm", 2, False), ("lstm", 1, True),
            ("gru", 1, False), ("gru", 2, True),
            ("rnn_tanh", 1, False), ("rnn_relu", 1, False)]
LAYERS = {"lstm": (jrnn.LSTM, rnn.LSTM, {}),
          "gru": (jrnn.GRU, rnn.GRU, {}),
          "rnn_relu": (jrnn.RNN, rnn.RNN, {"activation": "relu"}),
          "rnn_tanh": (jrnn.RNN, rnn.RNN, {"activation": "tanh"})}


@pytest.fixture(autouse=True)
def _host_init(monkeypatch):
    # the reference draws its initial weights with numpy, not with a
    # compiled program per shape; the values are replaced anyway
    monkeypatch.setenv("TPUMX_HOST_INIT", "1")


@pytest.fixture(autouse=True)
def _aten_cpu_recurrence(monkeypatch):
    # with oneDNN on, ATen's CPU LSTM runs oneDNN's RNN
    # (aten::mkldnn_rnn_layer); the fused arm's CPU cases pin ATen's own
    monkeypatch.setattr(torch.backends.mkldnn, "enabled", False)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _ref_params(block):
    return {k: np.array(p.data()._data)
            for k, p in block.collect_params().items()}


def _randomize(block, seed, scale=0.4):
    """Set every reference parameter to seeded normal draws; returns
    them as numpy arrays in ``collect_params()`` order."""
    rng = np.random.RandomState(seed)
    for p in block.collect_params().values():
        p.set_data(nd.array((rng.randn(*p.shape) * scale)
                            .astype(np.float32)))
    return _ref_params(block)


def _close(a, b, tol, msg=""):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol,
                               atol=tol, err_msg=msg)


# -- nd.RNN ---------------------------------------------------------------------
def _op_inputs(mode, layers, bi, seed=0, t=5, n=3, i=4, h=6):
    rng = np.random.RandomState(seed)
    d = 2 if bi else 1
    size = j_rnn_param_size(mode, i, h, layers, bi)
    return dict(x=rng.rand(t, n, i).astype(np.float32),
                params=(rng.randn(size) * 0.4).astype(np.float32),
                h0=(rng.randn(layers * d, n, h) * 0.5).astype(np.float32),
                c0=(rng.randn(layers * d, n, h) * 0.5).astype(np.float32),
                h=h)


@pytest.mark.parametrize("arm", ["scan", "fused"])
@pytest.mark.parametrize("mode,layers,bi", OP_CASES)
def test_rnn_op_matches_the_reference(mode, layers, bi, arm):
    a = _op_inputs(mode, layers, bi)
    assert rnn_op.rnn_param_size(mode, 4, a["h"], layers, bi) \
        == j_rnn_param_size(mode, 4, a["h"], layers, bi) == a["params"].size
    kw = dict(state_size=a["h"], num_layers=layers, mode=mode,
              bidirectional=bi, state_outputs=True)
    cell = [a["c0"]] if mode == "lstm" else []
    ref = nd.RNN(nd.array(a["x"]), nd.array(a["params"]), nd.array(a["h0"]),
                 *[nd.array(c) for c in cell], **kw)
    out = ndarray.RNN(_t(a["x"]), _t(a["params"]), _t(a["h0"]),
                      *[_t(c) for c in cell], arm=arm, **kw)
    assert len(out) == len(ref) == (3 if mode == "lstm" else 2)
    for name, o, r in zip(("out", "hN", "cN"), out, ref):
        assert tuple(o.shape) == tuple(r.shape), name
        _close(o.numpy(), r.asnumpy(), OP_TOL, name)


def test_rnn_op_ignores_p_and_returns_the_output_alone():
    a = _op_inputs("lstm", 2, False)
    args = (_t(a["x"]), _t(a["params"]), _t(a["h0"]), _t(a["c0"]))
    out = ndarray.RNN(*args, state_size=a["h"], num_layers=2)
    dropped = ndarray.RNN(*args, state_size=a["h"], num_layers=2, p=0.9)
    ref = nd.RNN(*[nd.array(x.numpy()) for x in args], state_size=a["h"],
                 num_layers=2, p=0.9)
    assert isinstance(out, torch.Tensor) and torch.equal(out, dropped)
    _close(out.numpy(), ref.asnumpy(), OP_TOL)


def test_rnn_op_blob_views_and_size_check():
    a = _op_inputs("gru", 2, True)
    blob = _t(a["params"])
    ws = rnn_op.unpack(blob, "gru", 4, a["h"], 2, True)
    assert len(ws) == 16
    assert all(w.untyped_storage().data_ptr()
               == blob.untyped_storage().data_ptr() for w in ws)
    assert [tuple(w.shape) for w in ws[:4]] == [(18, 4), (18, 6), (18,),
                                                (18,)]
    assert tuple(ws[8].shape) == (18, 12)          # layer 1: 2·H inputs
    with pytest.raises(ValueError, match="blob of"):
        rnn_op.unpack(blob[:-1], "gru", 4, a["h"], 2, True)
    with pytest.raises(ValueError, match="mode"):
        rnn_op.rnn_param_size("lstmp", 4, 6)


def test_cpu_fused_arm_runs_atens_own_recurrence():
    a = _op_inputs("lstm", 1, False)
    args = [_t(a[k]) for k in ("x", "params", "h0", "c0")]
    with torch.profiler.profile() as prof:
        ndarray.RNN(*args, state_size=a["h"], arm="fused")
    ops_seen = {e.key for e in prof.key_averages()}
    assert "aten::lstm" in ops_seen
    assert not any("mkldnn" in k for k in ops_seen), ops_seen


# -- the arm rule ------------------------------------------------------------------
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16, torch.float64])
@pytest.mark.parametrize("mode", list(LAYERS))
def test_rnn_arm_is_a_pure_function(mode, dtype):
    """No card needed: the device is a value."""
    for dev in ("cpu", torch.device("cpu")):
        for dropout, training in ((0.0, True), (0.5, True), (0.5, False)):
            assert rnn_op.rnn_arm(dev, dtype, mode, dropout, training) \
                == "scan"
    for dev in ("cuda", torch.device("cuda"), torch.device("cuda", 1),
                "cuda:0"):
        assert rnn_op.rnn_arm(dev, dtype, mode, 0.0, True) == "fused"
        assert rnn_op.rnn_arm(dev, dtype, mode, 0.5, False) == "fused"
        assert rnn_op.rnn_arm(dev, dtype, mode, 0.5, True) == "fused_layers"


def test_rnn_arm_refuses_unknown_modes_and_arms():
    with pytest.raises(ValueError, match="mode"):
        rnn_op.rnn_arm("cuda", torch.float32, "lstmp", 0.0, False)
    x = torch.zeros(2, 1, 3)
    with pytest.raises(ValueError, match="arm"):
        rnn_op.recurrence("gru", x, [torch.zeros(1, 1, 4)],
                          [torch.zeros(12, 3), torch.zeros(12, 4),
                           torch.zeros(12), torch.zeros(12)], arm="cudnn")


def test_recurrence_counts_its_arm():
    a = _op_inputs("gru", 1, False)
    before = {k: telemetry.counter("rnn.arm", kind=k).value
              for k in rnn_op.ARMS}
    args = [_t(a[k]) for k in ("x", "params", "h0")]
    ndarray.RNN(*args, state_size=a["h"], mode="gru")
    ndarray.RNN(*args, state_size=a["h"], mode="gru", arm="fused")
    after = {k: telemetry.counter("rnn.arm", kind=k).value
             for k in rnn_op.ARMS}
    assert {k: after[k] - before[k] for k in after} == \
        {"scan": 1, "fused": 1, "fused_layers": 0}


# -- the layers -----------------------------------------------------------------
def _layer_pair(mode, layers=2, bi=False, layout="TNC", hidden=6, inp=4,
                seed=1, dropout=0.0):
    jcls, cls, extra = LAYERS[mode]
    jl = jcls(hidden, layers, layout=layout, bidirectional=bi,
              input_size=inp, dropout=dropout, **extra)
    jl.initialize()
    params = _randomize(jl, seed)
    tl = cls(hidden, layers, layout=layout, bidirectional=bi, input_size=inp,
             dropout=dropout, generator=torch.Generator(), **extra)
    load_numpy(tl, params)
    return jl, tl, params


@pytest.mark.parametrize("states", [False, True])
@pytest.mark.parametrize("bi", [False, True])
@pytest.mark.parametrize("layout", ["TNC", "NTC"])
@pytest.mark.parametrize("mode", list(LAYERS))
def test_layer_and_its_gradients_match_the_reference(mode, layout, bi,
                                                     states):
    jl, tl, params = _layer_pair(mode, bi=bi, layout=layout)
    assert [k.split("_", 2)[-1] for k in params] == \
        [n for n, _ in tl.named_parameters()]
    rng = np.random.RandomState(2)
    t, n = 5, 3
    x = rng.rand(*((t, n, 4) if layout == "TNC" else (n, t, 4))) \
        .astype(np.float32)
    d = 2 if bi else 1
    st = [(rng.randn(2 * d, n, 6) * 0.5).astype(np.float32)
          for _ in range(2 if mode == "lstm" else 1)]
    out_shape = (t, n, 6 * d) if layout == "TNC" else (n, t, 6 * d)
    w_out = rng.randn(*out_shape).astype(np.float32)
    w_h = rng.randn(2 * d, n, 6).astype(np.float32)

    jx = nd.array(x)
    jx.attach_grad()
    with autograd.record():
        if states:
            jout, jst = jl(jx, [nd.array(s) for s in st])
            jloss = (jout * nd.array(w_out)).sum() \
                + (jst[0] * nd.array(w_h)).sum()
        else:
            jout = jl(jx)
            jloss = (jout * nd.array(w_out)).sum()
    jloss.backward()

    tx = _t(x).requires_grad_()
    if states:
        tout, tst = tl(tx, [_t(s) for s in st])
        assert len(tst) == len(jst)
        for a, b in zip(tst, jst):
            _close(a.detach().numpy(), b.asnumpy(), OP_TOL, "state")
        tloss_ = (tout * _t(w_out)).sum() + (tst[0] * _t(w_h)).sum()
    else:
        tout = tl(tx)
        tloss_ = (tout * _t(w_out)).sum()
    assert tuple(tout.shape) == tuple(jout.shape) == out_shape
    _close(tout.detach().numpy(), jout.asnumpy(), OP_TOL, "output")
    grads = torch.autograd.grad(tloss_, [tx, *tl.parameters()])
    _close(grads[0].numpy(), jx.grad.asnumpy(), GRAD_TOL, "d input")
    for g, (k, p) in zip(grads[1:], jl.collect_params().items()):
        _close(g.numpy(), p.grad.asnumpy(), GRAD_TOL, f"d {k}")


def test_layer_states_and_begin_state_follow_the_reference():
    jl, tl, _ = _layer_pair("lstm", bi=True)
    for a, b in zip(tl.state_info(3), jl.state_info(3)):
        assert a == b
    states = tl.begin_state(batch_size=3)
    assert [tuple(s.shape) for s in states] == [(4, 3, 6)] * 2
    assert all(s.dtype == torch.float32 and not s.any() for s in states)
    with pytest.raises(MXNetError, match="input_size"):
        rnn.LSTM(8, generator=torch.Generator())
    with pytest.raises(ValueError, match="layout"):
        rnn.GRU(8, layout="NCT", input_size=4, generator=torch.Generator())


# -- the dtype contract (tests/test_rnn.py:194-231) -----------------------------
def _dtype_pair():
    jl = jrnn.LSTM(8, 1, input_size=4)
    jl.initialize()
    params = _randomize(jl, 3)
    tl = rnn.LSTM(8, 1, input_size=4, generator=torch.Generator())
    load_numpy(tl, params)
    x = np.random.RandomState(0).rand(3, 2, 4).astype(np.float32)
    return jl, tl, x


def _dt(t):
    return str(t.dtype).replace("torch.", "")


def test_bf16_cast_keeps_the_recurrence_in_bf16():
    jl, tl, x = _dtype_pair()
    jl.cast("bfloat16")
    tl.cast("bfloat16")
    assert tl.dtype == torch.bfloat16
    jout = jl(nd.cast(nd.array(x), "bfloat16"))
    out = tl(_t(x).bfloat16())
    assert _dt(out) == str(jout.dtype) == "bfloat16"
    states = tl.begin_state(batch_size=2)
    assert all(s.dtype == torch.bfloat16 for s in states)
    out2, new_states = tl(_t(x).bfloat16(), states)
    assert out2.dtype == torch.bfloat16
    assert all(s.dtype == torch.bfloat16 for s in new_states)
    np.testing.assert_allclose(out.float().detach().numpy(),
                               np.asarray(jout.astype("float32").asnumpy()),
                               atol=BF16_TOL)


def test_mixed_dtype_input_promotes():
    jl, tl, x = _dtype_pair()
    out = tl(_t(x).bfloat16())                   # f32 net, bf16 input
    jout = jl(nd.cast(nd.array(x), "bfloat16"))
    assert _dt(out) == str(jout.dtype) == "float32"
    _close(out.detach().numpy(), jout.asnumpy(), OP_TOL)
    jl.cast("bfloat16")
    tl.cast("bfloat16")
    out2 = tl(_t(x))                             # bf16 net, f32 input
    assert _dt(out2) == str(jl(nd.array(x)).dtype) == "float32"


def test_explicit_states_promote_after_cast():
    jl, tl, x = _dtype_pair()
    stale = tl.begin_state(batch_size=2)
    jstale = jl.begin_state(batch_size=2)
    jl.cast("bfloat16")
    tl.cast("bfloat16")
    out, _ = tl(_t(x), tl.begin_state(batch_size=2))
    jout, _ = jl(nd.array(x), jl.begin_state(batch_size=2))
    assert _dt(out) == str(jout.dtype) == "float32"
    out2, _ = tl(_t(x).bfloat16(), stale)
    jout2, _ = jl(nd.cast(nd.array(x), "bfloat16"), jstale)
    assert _dt(out2) == str(jout2.dtype) == "float32"
    out3, _ = tl(_t(x).bfloat16(), tl.begin_state(batch_size=2))
    assert out3.dtype == torch.bfloat16


# -- dropout between layers ------------------------------------------------------
def _dropout_layer(rate, layers=2, seed=0, hidden=32):
    return rnn.LSTM(hidden, layers, dropout=rate, input_size=8,
                    generator=torch.Generator().manual_seed(seed))


def test_dropout_same_generator_seed_same_result():
    x = _t(np.random.RandomState(0).rand(6, 4, 8).astype(np.float32))
    a, b = _dropout_layer(0.5, seed=7), _dropout_layer(0.5, seed=7)
    b.load_state_dict(a.state_dict())
    ya, yb = a(x), b(x)
    assert torch.equal(ya, yb)
    assert not torch.equal(ya, a(x))      # the stream moves on
    a.eval()
    assert torch.equal(a(x), a(x))        # no dropout in inference


def test_nothing_is_dropped_after_the_last_layer():
    x = _t(np.random.RandomState(0).rand(6, 4, 8).astype(np.float32))
    one = _dropout_layer(0.9, layers=1)
    train = one(x)
    one.eval()
    assert torch.equal(train, one(x))
    two = _dropout_layer(0.5)
    st = two.begin_state(batch_size=4)
    _, (h_train, c_train) = two(x, st)
    two.eval()
    _, (h_eval, c_eval) = two(x, st)
    # the first layer runs before any dropout: its final state is the same
    assert torch.equal(h_train[0], h_eval[0])
    assert torch.equal(c_train[0], c_eval[0])
    assert not torch.equal(h_train[1], h_eval[1])


@pytest.mark.parametrize("rate", [0.2, 0.5])
def test_dropout_keep_rate_and_scale(rate, monkeypatch):
    seen = []
    real = rnn_op.ops.Dropout

    def spy(data, p, generator=None, training=None, **kw):
        out = real(data, p, generator=generator, training=training, **kw)
        seen.append((data.detach(), out.detach(), p, training))
        return out
    monkeypatch.setattr(rnn_op.ops, "Dropout", spy)
    layer = _dropout_layer(rate, layers=3, hidden=32)
    x = _t(np.random.RandomState(1).rand(8, 64, 8).astype(np.float32))
    layer(x)
    assert len(seen) == 2                  # between layers only
    for data, out, p, training in seen:
        assert p == rate and training
        kept = out != 0
        share = kept.float().mean().item()
        assert abs(share - (1 - rate)) < 0.02, share
        torch.testing.assert_close(out[kept], data[kept] / (1 - rate))


def test_fused_arm_is_never_asked_for_dropout(monkeypatch):
    calls = []

    class SpyVF:
        def __getattr__(self, name):
            fn = getattr(torch._VF, name)

            def wrapped(*args):
                calls.append((name, args[4], args[5]))   # layers, dropout
                return fn(*args)
            return wrapped
    monkeypatch.setattr(rnn_op, "_VF", SpyVF())
    layer = _dropout_layer(0.5, layers=3)
    x = _t(np.random.RandomState(0).rand(6, 4, 8).astype(np.float32))
    ws = [p for p in layer.parameters()]
    st = layer.begin_state(batch_size=4)
    g = torch.Generator().manual_seed(3)
    fused = rnn_op.recurrence("lstm", x, st, ws, 3, False, 0.5, True, g,
                              arm="fused_layers")
    g.manual_seed(3)
    scan = rnn_op.recurrence("lstm", x, st, ws, 3, False, 0.5, True, g,
                             arm="scan")
    assert calls == [("lstm", 1, 0.0)] * 3
    for a, b in zip(fused, scan):
        torch.testing.assert_close(a, b, rtol=OP_TOL, atol=OP_TOL)
    with pytest.raises(ValueError, match="fused_layers"):
        rnn_op.recurrence("lstm", x, st, ws, 3, False, 0.5, True, g,
                          arm="fused")
    calls.clear()
    rnn_op.recurrence("lstm", x, st, ws, 3, False, 0.5, False, g,
                      arm="fused")
    assert calls == [("lstm", 3, 0.0)]


# -- the cells ---------------------------------------------------------------------
CELLS = {"rnn_tanh": (jrnn.RNNCell, rnn.RNNCell, {"activation": "tanh"}),
         "rnn_relu": (jrnn.RNNCell, rnn.RNNCell, {"activation": "relu"}),
         "lstm": (jrnn.LSTMCell, rnn.LSTMCell, {}),
         "gru": (jrnn.GRUCell, rnn.GRUCell, {})}


def _cell_pair(kind, hidden=5, inp=3, seed=4):
    jcls, cls, extra = CELLS[kind]
    jc = jcls(hidden, input_size=inp, **extra)
    jc.initialize()
    params = _randomize(jc, seed)
    tc = cls(hidden, input_size=inp, generator=torch.Generator(), **extra)
    load_numpy(tc, params)
    return jc, tc


@pytest.mark.parametrize("kind", list(CELLS))
def test_cell_step_matches_the_reference(kind):
    jc, tc = _cell_pair(kind)
    rng = np.random.RandomState(5)
    x = rng.rand(4, 3).astype(np.float32)
    st = [rng.randn(*info["shape"]).astype(np.float32)
          for info in jc.state_info(4)]
    assert [i["shape"] for i in tc.state_info(4)] == \
        [i["shape"] for i in jc.state_info(4)]
    jout, jst = jc(nd.array(x), [nd.array(s) for s in st])
    out, new = tc(_t(x), [_t(s) for s in st])
    _close(out.detach().numpy(), jout.asnumpy(), OP_TOL)
    for a, b in zip(new, jst):
        _close(a.detach().numpy(), b.asnumpy(), OP_TOL)


@pytest.mark.parametrize("valid", [False, True])
@pytest.mark.parametrize("layout", ["NTC", "TNC"])
@pytest.mark.parametrize("kind", ["lstm", "gru"])
def test_cell_unroll_matches_the_reference(kind, layout, valid):
    jc, tc = _cell_pair(kind)
    rng = np.random.RandomState(6)
    x = rng.rand(*((3, 6, 3) if layout == "NTC" else (6, 3, 3))) \
        .astype(np.float32)
    vl = np.array([6, 2, 4], np.float32) if valid else None
    jouts, jst = jc.unroll(6, nd.array(x), layout=layout,
                           valid_length=None if vl is None else nd.array(vl))
    outs, st = tc.unroll(6, _t(x), layout=layout,
                         valid_length=None if vl is None else _t(vl))
    assert tuple(outs.shape) == tuple(jouts.shape)
    _close(outs.detach().numpy(), jouts.asnumpy(), OP_TOL)
    for a, b in zip(st, jst):
        _close(a.detach().numpy(), b.asnumpy(), OP_TOL)
    if valid:
        o = outs.detach().numpy() if layout == "NTC" else \
            outs.detach().numpy().transpose(1, 0, 2)
        assert (o[1, 2:] == 0).all() and (o[1, :2] != 0).any()
        # row 1's states are an unroll cut at its length, 2
        cut = x[:, :2] if layout == "NTC" else x[:2]
        _, st2 = tc.unroll(2, _t(cut), layout=layout)
        for a, b in zip(st, st2):
            torch.testing.assert_close(a[1], b[1], rtol=1e-6, atol=1e-6)


def test_unroll_takes_a_list_and_can_leave_outputs_unmerged():
    jc, tc = _cell_pair("lstm")
    x = np.random.RandomState(7).rand(2, 4, 3).astype(np.float32)
    steps = [_t(x[:, t]) for t in range(4)]
    outs, _ = tc.unroll(4, steps, merge_outputs=False)
    jouts, _ = jc.unroll(4, [nd.array(x[:, t]) for t in range(4)],
                         merge_outputs=False)
    assert isinstance(outs, list) and len(outs) == len(jouts) == 4
    for a, b in zip(outs, jouts):
        _close(a.detach().numpy(), b.asnumpy(), OP_TOL)
    with pytest.raises(ValueError, match="length"):
        tc.unroll(3, _t(x))


def test_bidirectional_cell_unroll_matches_the_reference():
    jl, tl = _cell_pair("lstm", hidden=4, seed=8)
    jr, tr = _cell_pair("lstm", hidden=4, seed=9)
    jbi = jrnn.BidirectionalCell(jl, jr)
    bi = rnn.BidirectionalCell(tl, tr)
    assert len(bi.collect_params()) == len(jbi.collect_params()) == 8
    x = np.random.RandomState(0).rand(2, 5, 3).astype(np.float32)
    jouts, jst = jbi.unroll(5, nd.array(x), layout="NTC")
    outs, st = bi.unroll(5, _t(x), layout="NTC")
    assert tuple(outs.shape) == (2, 5, 8) and len(st) == len(jst) == 4
    _close(outs.detach().numpy(), jouts.asnumpy(), OP_TOL)
    for a, b in zip(st, jst):
        _close(a.detach().numpy(), b.asnumpy(), OP_TOL)
    # the composition: forward cell ++ the reversed backward cell
    lo, _ = tl.unroll(5, _t(x), layout="NTC")
    ro, _ = tr.unroll(5, _t(x).flip(1), layout="NTC")
    torch.testing.assert_close(outs, torch.cat([lo, ro.flip(1)], -1))
    with pytest.raises(MXNetError, match="unroll"):
        bi(_t(x), st)


def test_sequential_and_residual_cells_match_the_reference():
    jseq = jrnn.SequentialRNNCell()
    seq = rnn.SequentialRNNCell()
    for i, (jc, tc) in enumerate([_cell_pair("gru", 4, 3, 10),
                                  _cell_pair("lstm", 4, 4, 11)]):
        jseq.add(jrnn.ResidualCell(jc) if i else jc)
        seq.add(rnn.ResidualCell(tc) if i else tc)
    assert len(seq) == len(jseq) == 2
    assert [i["shape"] for i in seq.state_info(2)] == \
        [i["shape"] for i in jseq.state_info(2)] == [(2, 4)] * 3
    x = np.random.RandomState(1).rand(2, 5, 3).astype(np.float32)
    jouts, jst = jseq.unroll(5, nd.array(x))
    outs, st = seq.unroll(5, _t(x))
    _close(outs.detach().numpy(), jouts.asnumpy(), OP_TOL)
    for a, b in zip(st, jst):
        _close(a.detach().numpy(), b.asnumpy(), OP_TOL)
    out, st1 = seq(_t(x[:, 0]), seq.begin_state(2))
    assert tuple(out.shape) == (2, 4) and len(st1) == 3
    hyb = rnn.HybridSequentialRNNCell()
    hyb.add(rnn.DropoutCell(0.0, generator=torch.Generator()))
    assert hyb.state_info(2) == []


def test_dropout_cell_draws_from_its_generator_in_training_only():
    x = torch.ones(64, 32)
    cell = rnn.DropoutCell(0.25, generator=torch.Generator().manual_seed(0))
    out, st = cell(x, [])
    assert st == []
    assert abs((out != 0).float().mean().item() - 0.75) < 0.02
    torch.testing.assert_close(out[out != 0], x[out != 0] / 0.75)
    cell.eval()
    assert torch.equal(cell(x, [])[0], x)


def test_zoneout_cell():
    jc, tc = _cell_pair("lstm", hidden=4, seed=12)
    x = np.random.RandomState(2).rand(3, 3).astype(np.float32)
    st = tc.begin_state(3)
    plain, plain_st = tc(_t(x), st)
    none = rnn.ZoneoutCell(tc, generator=torch.Generator())
    out, new = none(_t(x), st)
    assert torch.equal(out, plain) and all(
        torch.equal(a, b) for a, b in zip(new, plain_st))
    keep = rnn.ZoneoutCell(tc, zoneout_outputs=1.0, zoneout_states=1.0,
                           generator=torch.Generator())
    out, new = keep(_t(x), st)
    assert not out.any() and all(torch.equal(a, b)
                                 for a, b in zip(new, st))
    half = rnn.ZoneoutCell(tc, zoneout_outputs=0.5,
                           generator=torch.Generator().manual_seed(0))
    outs, _ = half.unroll(4, _t(np.random.rand(3, 4, 3).astype(np.float32)))
    assert half._prev_output is not None
    half.reset()
    assert half._prev_output is None
    assert [i["shape"] for i in keep.state_info(3)] == \
        [i["shape"] for i in jrnn.ZoneoutCell(jc).state_info(3)]
    assert len(keep.collect_params()) == 4


# -- Embedding ---------------------------------------------------------------------
def test_embedding_matches_the_reference():
    je = jnn.Embedding(20, 6)
    je.initialize()
    params = _randomize(je, 13)
    e = nn.Embedding(20, 6, sparse_grad=True, generator=torch.Generator())
    load_numpy(e, params)
    ids = np.random.RandomState(0).randint(0, 20, (5, 3)).astype(np.float32)
    w = np.random.RandomState(1).rand(5, 3, 6).astype(np.float32)
    with autograd.record():
        jout = je(nd.array(ids))
        jloss = (jout * nd.array(w)).sum()
    jloss.backward()
    out = e(_t(ids))
    _close(out.detach().numpy(), jout.asnumpy(), OP_TOL)
    (g,) = torch.autograd.grad((out * _t(w)).sum(), [e.weight])
    _close(g.numpy(), je.weight.grad.asnumpy(), OP_TOL)


# -- RNNModel ------------------------------------------------------------------------
THIN = dict(vocab_size=40, num_embed=16, num_hidden=16, num_layers=2)


def _model_pair(mode, tie=False, seed=14, dropout=0.0, **kw):
    cfg = dict(THIN, **kw)
    jm = JRNNModel(mode=mode, dropout=dropout, tie_weights=tie, **cfg)
    jm.initialize()
    jm(nd.array(_tokens(vocab=cfg["vocab_size"])))   # the tied Dense's shape
    params = _randomize(jm, seed, scale=0.3)
    if tie:
        # the reference's tie_weights does not tie (its Dense draws a
        # second weight): tie it here, and hand the port one array
        enc, dec = [k for k in params if k.endswith("_weight")
                    and params[k].shape == (cfg["vocab_size"],
                                            cfg["num_embed"])]
        jm.decoder.weight.set_data(jm.encoder.weight.data())
        params = {k: v for k, v in _ref_params(jm).items() if k != dec}
    m = RNNModel.from_numpy(params, mode, dropout=dropout, tie_weights=tie,
                            device="cpu", generator=torch.Generator(), **cfg)
    return jm, m, params


def _tokens(t=6, n=3, vocab=40, seed=15):
    return np.random.RandomState(seed).randint(0, vocab, (t, n)) \
        .astype(np.float32)


@pytest.mark.parametrize("mode,tie", [("lstm", False), ("gru", False),
                                      ("rnn_relu", False),
                                      ("rnn_tanh", False), ("lstm", True)])
def test_rnn_model_logits_match_the_reference(mode, tie):
    jm, m, _ = _model_pair(mode, tie)
    x = _tokens()
    ref = jm(nd.array(x)).asnumpy()
    out = m(_t(x))
    assert tuple(out.shape) == ref.shape == (6, 3, 40)
    _close(out.detach().numpy(), ref, OP_TOL)
    jst = jm.begin_state(batch_size=3)
    st = m.begin_state(batch_size=3)
    assert [tuple(s.shape) for s in st] == [tuple(s.shape) for s in jst]
    rng = np.random.RandomState(16)
    given = [(rng.randn(*s.shape) * 0.5).astype(np.float32) for s in st]
    ref2, jst2 = jm(nd.array(x), [nd.array(s) for s in given])
    out2, st2 = m(_t(x), [_t(s) for s in given])
    _close(out2.detach().numpy(), ref2.asnumpy(), OP_TOL)
    for a, b in zip(st2, jst2):
        _close(a.detach().numpy(), b.asnumpy(), OP_TOL)


def test_tied_weights_share_one_parameter():
    _, m, params = _model_pair("lstm", tie=True)
    assert m.decoder.weight.data()._data is m.encoder.weight.data()._data
    names = list(m.collect_params())
    assert names.count("encoder.weight") == 1 and "decoder.weight" \
        not in names and len(names) == len(params) == 10
    logits = m(_t(_tokens()))
    (g,) = torch.autograd.grad(logits.sum(),
                               [m.encoder.weight.data()._data])
    # the gradient holds the decoder's share: every row is touched
    assert (g.abs().sum(1) > 0).all()
    with pytest.raises(MXNetError, match="tied"):
        RNNModel("lstm", 40, 16, 8, tie_weights=True, device="cpu",
                 generator=torch.Generator())


def test_from_numpy_consumes_the_reference_collect_params():
    jm, m, params = _model_pair("lstm")
    ours = list(m.collect_params().items())
    assert [k for k, _ in ours] == [
        "encoder.weight", "rnn.l0_i2h_weight", "rnn.l0_h2h_weight",
        "rnn.l0_i2h_bias", "rnn.l0_h2h_bias", "rnn.l1_i2h_weight",
        "rnn.l1_h2h_weight", "rnn.l1_i2h_bias", "rnn.l1_h2h_bias",
        "decoder.weight", "decoder.bias"]
    assert len(ours) == len(params)
    for (name, t), (ref, a) in zip(ours, params.items()):
        assert ref.endswith("_" + name.split(".")[-1]), (ref, name)
        np.testing.assert_array_equal(t.detach().numpy(), a, err_msg=name)
    items = list(params.items())
    with pytest.raises(MXNetError, match="arrays for"):
        RNNModel.from_numpy(dict(items[:-1]), "lstm", device="cpu", **THIN)
    swapped = items[:1] + [items[2], items[1]] + items[3:]
    with pytest.raises(MXNetError, match="does not match"):
        RNNModel.from_numpy(dict(swapped), "lstm", device="cpu", **THIN)
    bad = dict(params)
    bad[items[1][0]] = items[1][1][:-1]
    with pytest.raises(MXNetError, match="shape"):
        RNNModel.from_numpy(bad, "lstm", device="cpu", **THIN)


def test_rnn_model_dropout_draws_from_its_generator():
    _, m, _ = _model_pair("lstm", dropout=0.5)
    x = _t(_tokens())
    g = m.drop._generator
    assert m.rnn._generator is g
    g.manual_seed(1)
    a = m(x)
    g.manual_seed(1)
    assert torch.equal(a, m(x))
    m.eval()
    _, ref, _ = _model_pair("lstm")
    torch.testing.assert_close(m(x), ref(x))


# -- the train step ---------------------------------------------------------------
class JFlatCE(gluon.loss.Loss):
    """The reference benchmark's loss (``bench.py::_lstm_once``)."""

    def __init__(self, **kw):
        super().__init__(weight=None, batch_axis=0, **kw)
        self._ce = gluon.loss.SoftmaxCrossEntropyLoss()

    def hybrid_forward(self, F, logits, labels):
        v = logits.shape[-1]
        return self._ce(F.cast(F.reshape(logits, shape=(-1, v)),
                               dtype="float32"),
                        F.reshape(labels, shape=(-1,)))


class FlatCE(tloss.Loss):
    """The same for the port: ``(T·N, V)`` logits upcast to float32."""

    def __init__(self):
        super().__init__(weight=None, batch_axis=0)
        self._ce = tloss.SoftmaxCrossEntropyLoss()

    def forward(self, logits, labels):
        return self._ce(logits.reshape(-1, logits.shape[-1]).float(),
                        labels.reshape(-1))


def _steps(mode, n=3, dtype="float32", bptt=6, batch=4):
    jm, m, _ = _model_pair(mode)
    if dtype != "float32":
        jm.cast(dtype)
        m.cast(dtype)
    rng = np.random.RandomState(0)
    x = rng.randint(0, THIN["vocab_size"], (bptt, batch)).astype(np.float32)
    y = rng.randint(0, THIN["vocab_size"], (bptt * batch,)) \
        .astype(np.float32)
    kw = dict(learning_rate=1.0, multi_precision=dtype != "float32")
    jm(nd.array(x))
    jstep = JCompiledTrainStep(jm, JFlatCE(), mx.optimizer.create("sgd",
                                                                  **kw))
    step = CompiledTrainStep(m, FlatCE(), optimizer.create("sgd", **kw),
                             device="cpu")
    before = {k: t.detach().clone() for k, t in m.collect_params().items()}
    jl = [float(np.asarray(jstep.step(nd.array(x), nd.array(y))._data)
                .ravel()[0]) for _ in range(n)]
    tl = [float(step.step(_t(x), _t(y))) for _ in range(n)]
    return jl, tl, jstep, jm, m, step, before


@pytest.mark.parametrize("mode", ["lstm", "gru"])
def test_three_sgd_steps_match_the_reference(mode):
    jl, tl, jstep, jm, m, _, before = _steps(mode)
    np.testing.assert_allclose(tl, jl, rtol=STEP_TOL)
    assert tl[-1] < tl[0]
    ref = {k: np.array(v) for k, v in jstep.values.items()}
    for (name, t), key in zip(m.collect_params().items(),
                              jm.collect_params().keys()):
        moved = t.detach() - before[name]
        ref_moved = _t(ref[key]) - before[name]
        rel = float((moved - ref_moved).norm() / ref_moved.norm())
        assert rel <= UPDATE_TOL, (name, rel)


def test_bfloat16_first_loss_matches_the_reference():
    jl, tl, _, _, m, step, _ = _steps("lstm", n=1, dtype="bfloat16")
    assert abs(tl[0] - jl[0]) <= BF16_TOL * abs(jl[0])
    assert all(t.dtype == torch.bfloat16
               for t in m.collect_params().values())
    assert step.masters and all(v.dtype == torch.float32
                                for v in step.masters.values())


# -- entry points ------------------------------------------------------------------
def test_entry_points_default_to_the_card():
    # None is the current context: the card outside ``with mx.cpu():``
    assert tmx.current_context() == tmx.gpu(0)
    for fn in (RNNModel.__init__, RNNModel.from_numpy):
        assert inspect.signature(fn).parameters["device"].default is None
    if not torch.cuda.is_available():
        with pytest.raises(MXNetError, match="no CUDA device"):
            RNNModel("lstm", **THIN)
        with pytest.raises(MXNetError, match="no CUDA device"):
            rnn.LSTM(8, input_size=4)             # no generator: the card's
        with pytest.raises(MXNetError, match="no CUDA device"):
            nn.Embedding(10, 4)
        with pytest.raises(MXNetError, match="no CUDA device"):
            rnn.LSTMCell(8, input_size=4)
    with torch.no_grad():
        logits = RNNModel("gru", device="cpu", generator=torch.Generator(),
                          **THIN)(_t(_tokens()))
    assert math.isfinite(float(logits.sum()))
