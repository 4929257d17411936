"""The port's ``gluon.contrib.nn`` and ``gluon.contrib.rnn`` against the
reference's, on the CPU: each test of ``tests/test_contrib_layers.py``
for the layers and cells, with the reference beside it on the same
seeded inputs and the same weights (the reference's ``collect_params()``
into the port's ``load_numpy``).  ``SyncBatchNorm``'s global-statistics
property under a dp=2 mesh is held in ``tests/test_torch_mesh_train.py``
(its two-process pool); the Estimator in ``test_torch_estimator.py``.

Tolerances: the pixel shuffles and ``Identity`` are bit-equal (pure
data movement); float32 outputs and gradients within 1e-5 relative and
1e-6 absolute (the products' sums in PyTorch's order against XLA's).
``VariationalDropoutCell``'s masks come from each package's own
generator, so they are held by the reference's properties (the same
mask at every step, redrawn after ``reset()``, the keep rate within 4
standard deviations), not bit for bit.
"""
import numpy as np
import pytest
import torch

import tpu_mx as jmx
from tpu_mx import autograd as jag
from tpu_mx.gluon import nn as jnn
from tpu_mx.gluon.contrib import nn as jcnn
from tpu_mx.gluon.contrib import rnn as jcrnn

import tpu_mx_torch as mx
from tpu_mx_torch import autograd, nd
from tpu_mx_torch.gluon import nn
from tpu_mx_torch.gluon.block import load_numpy
from tpu_mx_torch.gluon.contrib import nn as cnn
from tpu_mx_torch.gluon.contrib import rnn as crnn

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def _host():
    torch.backends.mkldnn.enabled = False
    with mx.cpu():
        yield


def _rand(*shape, seed=0):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


def _copy(ref_block, port_block):
    load_numpy(port_block, {k: p.data().asnumpy() for k, p in
                            ref_block.collect_params().items()})


def _close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(a.asnumpy(), b.asnumpy(), rtol=rtol,
                               atol=atol)


def test_concurrent_concat():
    x = _rand(2, 4)
    nets = []
    for m_nn, m_cnn in ((jnn, jcnn), (nn, cnn)):
        net = m_cnn.HybridConcurrent(axis=-1)
        net.add(m_nn.Dense(3, in_units=4), m_nn.Dense(5, in_units=4),
                m_cnn.Identity())
        net.initialize()
        nets.append(net)
    _copy(*nets)
    ref, got = nets[0](jmx.nd.array(x)), nets[1](nd.array(x))
    assert got.shape == ref.shape == (2, 3 + 5 + 4)
    _close(got, ref)
    np.testing.assert_array_equal(got.asnumpy()[:, -4:], x)


def test_concurrent_is_the_hybrid_container():
    net = cnn.Concurrent(axis=1)
    net.add(nn.Dense(2, in_units=3), cnn.Identity())
    net.initialize()
    assert isinstance(net, cnn.HybridConcurrent)
    assert net(nd.array(_rand(4, 3))).shape == (4, 5)


@pytest.mark.parametrize("cls,factor,shape", [
    ("PixelShuffle1D", 3, (2, 6, 5)),
    ("PixelShuffle2D", 2, (1, 8, 2, 3)),
    ("PixelShuffle2D", (2, 3), (2, 12, 3, 2)),
    ("PixelShuffle3D", 2, (1, 16, 2, 3, 4)),
    ("PixelShuffle3D", (1, 2, 3), (1, 12, 2, 2, 2)),
])
def test_pixelshuffle_matches_the_reference(cls, factor, shape):
    x = np.arange(int(np.prod(shape)), dtype=np.float32).reshape(shape)
    ref = getattr(jcnn, cls)(factor)(jmx.nd.array(x)).asnumpy()
    got = getattr(cnn, cls)(factor)(nd.array(x)).asnumpy()
    np.testing.assert_array_equal(got, ref)


def test_pixelshuffle_2d_matches_manual():
    x = np.arange(1 * 8 * 2 * 3, dtype=np.float32).reshape(1, 8, 2, 3)
    out = cnn.PixelShuffle2D(2)(nd.array(x)).asnumpy()
    want = x.reshape(1, 2, 2, 2, 2, 3).transpose(0, 1, 4, 2, 5, 3) \
        .reshape(1, 2, 4, 6)
    np.testing.assert_array_equal(out, want)


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_pixelshuffle_refuses_what_the_reference_refuses(pkg):
    m_cnn, m = (jcnn, jmx) if pkg == "ref" else (cnn, mx)
    with pytest.raises(m.base.MXNetError, match="not divisible"):
        m_cnn.PixelShuffle2D(2)(m.nd.array(_rand(1, 6, 2, 2)))
    with pytest.raises(m.base.MXNetError, match="length-2"):
        m_cnn.PixelShuffle2D((2, 2, 2))


def test_pixelshuffle_gradient_is_the_inverse_permutation():
    x = nd.array(_rand(1, 8, 2, 3))
    jx = jmx.nd.array(x.asnumpy())
    for a, m, ag in ((x, cnn, autograd), (jx, jcnn, jag)):
        a.attach_grad()
        w = np.arange(2 * 4 * 6, dtype=np.float32).reshape(1, 2, 4, 6)
        with ag.record():
            y = (m.PixelShuffle2D(2)(a) * type(a)(w) if m is jcnn else
                 m.PixelShuffle2D(2)(a) * nd.array(w))
            loss = y.sum()
        loss.backward()
    np.testing.assert_array_equal(x.grad.asnumpy(), jx.grad.asnumpy())


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_sync_batchnorm_refuses_nonpositive_devices(pkg):
    m_cnn, m = (jcnn, jmx) if pkg == "ref" else (cnn, mx)
    with pytest.raises(m.base.MXNetError, match="positive"):
        m_cnn.SyncBatchNorm(in_channels=4, num_devices=0)


@pytest.mark.parametrize("training", [True, False])
def test_sync_batchnorm_on_one_device_is_batchnorm_over_axis_1(training):
    x = (np.random.RandomState(3).randn(4, 3, 5, 5) * 2 + 1).astype(
        np.float32)
    nets = [jcnn.SyncBatchNorm(in_channels=3, num_devices=4),
            cnn.SyncBatchNorm(in_channels=3, num_devices=4)]
    for n_ in nets:
        n_.initialize()
    _copy(*nets)
    outs = []
    for net, m, ag in ((nets[0], jmx, jag), (nets[1], mx, autograd)):
        a = m.nd.array(x)
        if training:
            with ag.record():
                outs.append(net(a))
        else:
            outs.append(net(a))
    _close(outs[1], outs[0], rtol=1e-5, atol=1e-5)
    assert nets[1]._axis == 1
    for k in ("running_mean", "running_var"):
        np.testing.assert_allclose(
            getattr(nets[1], k).data().asnumpy(),
            getattr(nets[0], k).data().asnumpy(), rtol=1e-5, atol=1e-6)


def test_sparse_embedding_has_the_references_dense_gradient():
    ids = np.array([[0, 3, 3], [5, 1, 0]], np.float32)
    nets = [jcnn.SparseEmbedding(8, 4), cnn.SparseEmbedding(8, 4)]
    for n_ in nets:
        n_.initialize()
    _copy(*nets)
    grads, outs = [], []
    for net, m, ag in ((nets[0], jmx, jag), (nets[1], mx, autograd)):
        with ag.record():
            out = net(m.nd.array(ids))
            loss = (out * out).sum()
        loss.backward()
        outs.append(out)
        grads.append(net.weight.grad.asnumpy())
    _close(outs[1], outs[0])
    assert grads[1].shape == grads[0].shape == (8, 4)
    np.testing.assert_allclose(grads[1], grads[0], rtol=RTOL, atol=ATOL)


def _cell_pair(jcls, pcls, *args, seed_x=0, **kw):
    jcell, pcell = jcls(*args, **kw), pcls(*args, **kw)
    jcell.initialize(init="xavier")
    pcell.initialize()
    return jcell, pcell


def _steps(cell, m, ag, xs, grads=True):
    """Two steps of ``cell`` on ``xs`` from its zero states, under
    ``record()``: the outputs, the states and each parameter's gradient
    of the summed outputs."""
    states = [m.nd.array(np.zeros(s.shape, np.float32))
              for s in cell.begin_state(xs[0].shape[0])]
    with ag.record():
        outs = []
        for x in xs:
            out, states = cell(m.nd.array(x), states)
            outs.append(out)
        loss = sum((o * o).sum() for o in outs)
    if grads:
        loss.backward()
    g = [p.grad.asnumpy() for p in cell.collect_params().values()] \
        if grads else []
    return outs, states, g


def test_lstmp_cell_matches_the_reference_with_deferred_input():
    jcell, pcell = _cell_pair(jcrnn.LSTMPCell, crnn.LSTMPCell,
                              hidden_size=8, projection_size=5)
    xs = [_rand(3, 4, seed=s) for s in (1, 2)]
    jcell(jmx.nd.array(xs[0]), [jmx.nd.zeros((3, 5)), jmx.nd.zeros((3, 8))])
    pcell(nd.array(xs[0]), [nd.zeros((3, 5)), nd.zeros((3, 8))])
    assert pcell.i2h_weight.shape == (32, 4)
    _copy(jcell, pcell)
    ref = _steps(jcell, jmx, jag, xs)
    got = _steps(pcell, mx, autograd, xs)
    assert got[0][0].shape == (3, 5)
    assert [s.shape for s in got[1]] == [(3, 5), (3, 8)]
    for a, b in zip(got[0] + got[1], ref[0] + ref[1]):
        _close(a, b)
    for a, b in zip(got[2], ref[2]):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)


# the reference's five cases, and the 1-D RNN and GRU cells
_CONV = [("Conv1DLSTMCell", 1), ("Conv2DLSTMCell", 2), ("Conv2DGRUCell", 2),
         ("Conv2DRNNCell", 2), ("Conv3DLSTMCell", 3), ("Conv1DRNNCell", 1),
         ("Conv1DGRUCell", 1)]


@pytest.mark.parametrize("name,ndim", _CONV, ids=[n for n, _ in _CONV])
def test_conv_rnn_cell_steps_match_the_reference(name, ndim):
    spatial = (5, 6, 4)[:ndim]
    jcell, pcell = _cell_pair(getattr(jcrnn, name), getattr(crnn, name),
                              hidden_channels=3, kernel=3,
                              input_shape=(2,) + spatial)
    _copy(jcell, pcell)
    xs = [_rand(2, 2, *spatial, seed=s) for s in (4, 5)]
    ref = _steps(jcell, jmx, jag, xs)
    got = _steps(pcell, mx, autograd, xs)
    assert got[0][0].shape == (2, 3) + spatial
    assert not np.allclose(got[0][0].asnumpy(), got[0][1].asnumpy())
    for a, b in zip(got[0] + got[1], ref[0] + ref[1]):
        _close(a, b)
    for a, b in zip(got[2], ref[2]):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=1e-5)


@pytest.mark.parametrize("kind", ["RNN", "LSTM", "GRU"])
def test_every_conv_cell_steps_in_1_2_and_3_dimensions(kind):
    """Each of the nine classes steps twice from ``begin_state`` (the
    reference's step test, on the port alone: the seven cases above hold
    the arithmetic to the reference)."""
    for ndim in (1, 2, 3):
        spatial = (4, 3, 2)[:ndim]
        cell = getattr(crnn, f"Conv{ndim}D{kind}Cell")(
            hidden_channels=2, kernel=3, input_shape=(3,) + spatial)
        x = nd.array(_rand(2, 3, *spatial))
        out, states = cell(x, cell.begin_state(batch_size=2))
        out2, _ = cell(x, states)
        assert out.shape == out2.shape == (2, 2) + spatial
        assert len(states) == (2 if kind == "LSTM" else 1)
        assert not np.allclose(out.asnumpy(), out2.asnumpy())


def test_conv_cell_infers_its_input_channels_at_the_first_step():
    jcell, pcell = _cell_pair(jcrnn.Conv2DGRUCell, crnn.Conv2DGRUCell,
                              hidden_channels=2, kernel=(3, 5))
    x = _rand(2, 3, 4, 6)
    for cell, m in ((jcell, jmx), (pcell, mx)):
        cell(m.nd.array(x), [m.nd.zeros((2, 2, 4, 6))])
    assert pcell.i2h_weight.shape == jcell.i2h_weight.shape == (6, 3, 3, 5)
    assert pcell.state_info(2) == jcell.state_info(2)


def test_conv_rnn_unroll_and_deferred_state_error():
    seq = _rand(2, 3, 1, 4, 4)
    cells = _cell_pair(jcrnn.Conv2DLSTMCell, crnn.Conv2DLSTMCell,
                       hidden_channels=2, kernel=3, input_shape=(1, 4, 4))
    _copy(*cells)
    ref, _ = cells[0].unroll(3, jmx.nd.array(seq), layout="NTC")
    got, states = cells[1].unroll(3, nd.array(seq), layout="NTC")
    assert got.shape == ref.shape == (2, 3, 2, 4, 4)
    _close(got, ref)
    for m_crnn, m in ((jcrnn, jmx), (crnn, mx)):
        with pytest.raises(m.base.MXNetError, match="input_shape"):
            m_crnn.Conv2DLSTMCell(hidden_channels=2, kernel=3) \
                .begin_state(batch_size=2)
        with pytest.raises(m.base.MXNetError, match="odd"):
            m_crnn.Conv2DLSTMCell(hidden_channels=2, kernel=2)


def _dropped(out):
    return out.asnumpy() == 0.0


def test_variational_dropout_locks_its_mask_and_redraws_after_reset():
    base = crnn.LSTMPCell(hidden_size=6, projection_size=4, input_size=3,
                          generator=torch.Generator().manual_seed(0))
    cell = crnn.VariationalDropoutCell(
        base, drop_outputs=0.5, generator=torch.Generator().manual_seed(1))
    x = nd.array(np.ones((2, 3), np.float32))
    states = cell.begin_state(batch_size=2)
    with autograd.record():
        o1, states = cell(x, states)
        o2, states = cell(x, states)
    z1, z2 = _dropped(o1), _dropped(o2)
    np.testing.assert_array_equal(z1, z2)
    assert z1.any()
    changed = False
    for _ in range(12):
        cell.reset()
        with autograd.record():
            o, _ = cell(x, cell.begin_state(batch_size=2))
        if not np.array_equal(_dropped(o), z1):
            changed = True
            break
    assert changed, "the variational mask was never redrawn after reset()"
    # a new sequence: unroll resets, the same mask at each of its steps
    with autograd.record():
        outs, _ = cell.unroll(4, nd.array(np.ones((2, 4, 3), np.float32)),
                              layout="NTC")
    z = outs.asnumpy() == 0.0
    for t in range(1, 4):
        np.testing.assert_array_equal(z[:, t], z[:, 0])


@pytest.mark.parametrize("which,rate", [("inputs", 0.3), ("states", 0.5),
                                        ("outputs", 0.2)])
def test_variational_dropout_keep_rate_and_scale(which, rate):
    """The inverted mask keeps 1 - rate of the units (within 4 standard
    deviations over 64 x 256 draws) and scales them by 1/(1 - rate), as
    the reference's ``_draw``; outside training the cell is its base."""
    base = crnn.LSTMPCell(hidden_size=256, projection_size=256,
                          input_size=256,
                          generator=torch.Generator().manual_seed(0))
    cell = crnn.VariationalDropoutCell(
        base, generator=torch.Generator().manual_seed(2),
        **{f"drop_{which}": rate})
    x = torch.ones(64, 256)
    states = [torch.ones(64, 256), torch.ones(64, 256)]
    cell.train()
    cell(x, states)
    mask = {"inputs": cell._mask_in, "outputs": cell._mask_out,
            "states": cell._mask_states and cell._mask_states[0]}[which]
    kept = (mask != 0).float().mean().item()
    n = mask.numel()
    assert abs(kept - (1 - rate)) <= 4 * np.sqrt(rate * (1 - rate) / n)
    np.testing.assert_allclose(mask[mask != 0].numpy(), 1 / (1 - rate),
                               rtol=1e-6)
    cell.eval()
    cell.reset()
    out, _ = cell(x, states)
    want, _ = base(x, states)
    torch.testing.assert_close(out, want, rtol=0, atol=0)
    assert cell._mask_in is None and cell._mask_out is None


def test_variational_dropout_outside_training_matches_the_reference():
    jbase, pbase = _cell_pair(jcrnn.LSTMPCell, crnn.LSTMPCell,
                              hidden_size=6, projection_size=4,
                              input_size=3)
    _copy(jbase, pbase)
    cells = [jcrnn.VariationalDropoutCell(jbase, drop_inputs=0.5,
                                          drop_outputs=0.5),
             crnn.VariationalDropoutCell(pbase, drop_inputs=0.5,
                                         drop_outputs=0.5)]
    x = _rand(2, 3)
    outs = []
    for cell, m in zip(cells, (jmx, mx)):
        out, _ = cell(m.nd.array(x), [m.nd.zeros((2, 4)),
                                      m.nd.zeros((2, 6))])
        outs.append(out)
    _close(outs[1], outs[0])
