"""The port's ``contrib.amp`` against the reference's, on the CPU: each test
of ``tests/test_amp.py`` with the reference beside it, then where the
patch lands.  Under ``amp.init()`` each package records the patched
operators its blocks call (a recorder over every patched name, in both
``nd`` namespaces): Gluon's layers, the norms, the recurrent cells, the
contrib layers, the losses and a thin BERT call the same names in the
same order and return the same dtypes; ``engine.bulk()`` casts inside
its segment with the same statistics; ``mx.sym``'s executors cast
nothing in either.  ``_deinit()`` restores every patched name.  Every
``init()`` here has its ``_deinit()`` in a ``finally`` (the fixture).

Tolerances: dtypes and call lists are equal; a bfloat16 BERT's logits
within 2e-2·max|ref| of the reference's (bfloat16 products summed in
another order); float32 losses and weights within 1e-5 relative.
"""
import importlib
import types

import numpy as np
import pytest
import torch

import tpu_mx as jmx
from tpu_mx import autograd as jag
from tpu_mx.contrib import amp as jamp

import tpu_mx_torch as mx
from tpu_mx_torch import autograd, gluon, nd
from tpu_mx_torch.contrib import amp
from tpu_mx_torch.contrib.amp import amp as amp_mod
from tpu_mx_torch.gluon.block import load_numpy

BF16_REL = 2e-2


@pytest.fixture(autouse=True)
def _host():
    torch.backends.mkldnn.enabled = False
    with mx.cpu():
        yield
    # a failed test must not leave either package patched
    amp_mod._deinit()
    jamp.amp._deinit()


@pytest.fixture
def amp_active():
    amp.init(target_dtype="bfloat16")
    jamp.init(target_dtype="bfloat16")
    try:
        yield
    finally:
        amp_mod._deinit()
        jamp.amp._deinit()


def _name(dtype):
    return str(dtype).replace("torch.", "")


PKGS = {"ref": (jmx, jamp, jag), "port": (mx, amp, autograd)}


# -- the tests of tests/test_amp.py, both packages ----------------------------
@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_amp_casts_matmul_to_bf16(amp_active, pkg):
    m, _, _ = PKGS[pkg]
    a = m.nd.array(np.random.RandomState(0).rand(8, 8).astype(np.float32))
    out = m.nd.dot(a, a)
    assert _name(out.dtype) == "bfloat16"
    assert _name(m.nd.softmax(out, axis=-1).dtype) == "float32"


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_amp_widest_cast(amp_active, pkg):
    m, _, _ = PKGS[pkg]
    a = m.nd.array(np.random.RandomState(0).rand(4, 4).astype(np.float32))
    b = a.astype("bfloat16")
    assert _name(m.nd.concat(a, b, dim=0).dtype) == "float32"
    assert _name(m.nd.stack(b, b).dtype) == "bfloat16"
    assert _name(m.nd.add_n(b, a, b).dtype) == "float32"


def test_loss_scaler_dynamics():
    for lib in (jamp, amp):
        s = lib.LossScaler(init_scale=16.0, scale_factor=2.0, scale_window=2,
                           target_dtype="float16")
        s.update_scale(overflow=True)
        assert s.loss_scale == 8.0
        s.update_scale(False)
        s.update_scale(False)
        assert s.loss_scale == 16.0
        b = lib.LossScaler(target_dtype="bfloat16")
        assert b.loss_scale == 1.0
        b.update_scale(True)
        assert b.loss_scale == 1.0


def _mlp(m, seed_params=None):
    net = m.gluon.nn.Sequential()
    net.add(m.gluon.nn.Dense(16, activation="relu", in_units=8))
    net.add(m.gluon.nn.Dense(4, in_units=16))
    net.initialize()
    return net


def test_amp_training_loop(amp_active):
    """The reference's loop (bf16 amp, SGD, ``scale_loss``) in both
    packages from the same weights: the losses fall, and each step's
    loss is within bf16's distance of the reference's."""
    ref, port = _mlp(jmx), _mlp(mx)
    load_numpy(port, {k: p.data().asnumpy()
                      for k, p in ref.collect_params().items()})
    X = np.random.RandomState(0).rand(32, 8).astype(np.float32)
    Y = (X.sum(axis=1) > 4).astype(np.int32)
    losses = {}
    for name, net in (("ref", ref), ("port", port)):
        m, lib, ag = PKGS[name]
        trainer = m.gluon.Trainer(net.collect_params(), "sgd",
                                  {"learning_rate": 0.05})
        lib.init_trainer(trainer)
        loss_fn = m.gluon.loss.SoftmaxCrossEntropyLoss()
        run = []
        for _ in range(8):
            with ag.record():
                loss = loss_fn(net(m.nd.array(X)), m.nd.array(Y))
            with lib.scale_loss(loss, trainer) as scaled:
                scaled.backward()
            trainer.step(32)
            run.append(float(loss.mean().asnumpy()))
        losses[name] = run
    assert losses["port"][-1] < losses["port"][0]
    np.testing.assert_allclose(losses["port"], losses["ref"], rtol=BF16_REL)


def _poisoned_step(pkg):
    m, lib, ag = PKGS[pkg]
    net = m.gluon.nn.Dense(2, in_units=4)
    net.initialize()
    x = m.nd.array(np.random.RandomState(1).rand(4, 4).astype(np.float32))
    with ag.record():
        loss = net(x).sum()
    loss.backward()
    trainer = m.gluon.Trainer(net.collect_params(), "sgd",
                              {"learning_rate": 0.1})
    state = lib.amp._amp_state
    state["target_dtype"] = "float16"
    try:
        lib.init_trainer(trainer)
    finally:
        state["target_dtype"] = None
    scaler = trainer._amp_loss_scaler
    scale0 = scaler.loss_scale
    w0 = net.weight.data().asnumpy().copy()
    return net, trainer, scaler, scale0, w0


def test_fp16_overflow_skips_step():
    ref = _poisoned_step("ref")
    ref[0].weight.grad._rebind(ref[0].weight.grad._data.at[0, 0].set(np.inf))
    port = _poisoned_step("port")
    port[0].weight.grad._data[0, 0] = np.inf
    reads = amp.LossScaler.host_reads
    for net, trainer, scaler, scale0, w0 in (ref, port):
        with pytest.warns(UserWarning, match="overflow"):
            trainer.step(4)
        np.testing.assert_array_equal(net.weight.data().asnumpy(), w0)
        assert scaler.loss_scale == scale0 / 2
    # one device-to-host read for the step, whatever the parameter count
    assert amp.LossScaler.host_reads == reads + 1


def test_has_overflow_reads_the_device_once_for_many_parameters(
        monkeypatch):
    net = gluon.nn.HybridSequential()
    for _ in range(12):
        net.add(gluon.nn.Dense(3, in_units=3))
    net.initialize()
    with autograd.record():
        loss = net(nd.ones((2, 3))).sum()
    loss.backward()
    params = list(net.collect_params().values())
    assert len(params) == 24
    # a second dtype group, as under convert_model
    params += [types.SimpleNamespace(grad=torch.randn(4, 3).bfloat16())
               for _ in range(10)]
    grads = [amp_mod._grads([p])[0].clone() for p in params]
    calls = []
    fused = torch._amp_foreach_non_finite_check_and_unscale_

    def counted(group, found, inv):
        calls.append(len(group))
        return fused(group, found, inv)
    monkeypatch.setattr(torch, "_amp_foreach_non_finite_check_and_unscale_",
                        counted)
    scaler = amp.LossScaler()
    reads = amp.LossScaler.host_reads
    assert scaler.has_overflow(params) is False
    # one fused call for the float32 group (bfloat16 takes two foreach
    # reductions), and the gradients' bits unchanged
    assert calls == [24]
    for g, p in zip(grads, params):
        assert torch.equal(g, amp_mod._grads([p])[0])
    # each non-finite kind in each group, alone
    for i, bad in ((17, "nan"), (17, "inf"), (30, "nan"), (30, "-inf")):
        g = amp_mod._grads([params[i]])[0]
        keep = g.view(-1)[0].item()
        g.view(-1)[0] = float(bad)
        assert scaler.has_overflow(params) is True
        g.view(-1)[0] = keep
    g = amp_mod._grads([params[30]])[0]   # finite: sum|x| above bf16's max
    g.fill_(3e38)
    assert scaler.has_overflow(params) is False
    assert amp.LossScaler.host_reads == reads + 6
    assert len(calls) == 6


def _converted(m, lib, excluded=(), nested=False, norm=True):
    net = m.gluon.nn.Sequential()
    if nested:
        sub = m.gluon.nn.Sequential()
        sub.add(m.gluon.nn.Dense(8, in_units=4))
        net.add(sub)
    else:
        net.add(m.gluon.nn.Dense(8, in_units=4))
    net.add(m.gluon.nn.BatchNorm(in_channels=8) if norm
            else m.gluon.nn.Dense(4, in_units=8))
    net.initialize()
    net(m.nd.array(np.random.RandomState(2).rand(2, 4).astype(np.float32)))
    return net


def _dtypes(net):
    return [_name(p.data().dtype) for p in net.collect_params().values()]


@pytest.mark.parametrize("excluded,nested,norm", [
    ((), False, True), (["1"], False, False), (["0"], True, False)],
    ids=["keeps_norms_fp32", "excluded_sym_names", "excluded_container"])
def test_convert_model_casts_as_the_reference(excluded, nested, norm):
    nets = [_converted(m, lib, excluded, nested, norm)
            for m, lib, _ in (PKGS["ref"], PKGS["port"])]
    for net, lib in zip(nets, (jamp, amp)):
        lib.convert_model(net, target_dtype="bfloat16",
                          excluded_sym_names=excluded)
    assert _dtypes(nets[1]) == _dtypes(nets[0])
    assert "bfloat16" in _dtypes(nets[1]) and "float32" in _dtypes(nets[1])


def test_convert_model_preserves_norm_values():
    gamma0 = np.full(8, 1.0009765625, np.float32)  # 1 + 2**-10
    for m, lib, _ in (PKGS["ref"], PKGS["port"]):
        net = _converted(m, lib)
        net[1].gamma.set_data(m.nd.array(gamma0))
        net[1].running_var.set_data(m.nd.array(gamma0))
        lib.convert_model(net, target_dtype="bfloat16")
        np.testing.assert_array_equal(net[1].gamma.data().asnumpy(), gamma0)
        np.testing.assert_array_equal(net[1].running_var.data().asnumpy(),
                                      gamma0)


@pytest.mark.parametrize("pkg", sorted(PKGS))
@pytest.mark.parametrize("positional", [False, True])
def test_conditional_fp32_ops(pkg, positional):
    m, lib, _ = PKGS[pkg]
    lib.init(target_dtype="bfloat16",
             conditional_fp32_ops=[("Activation", "act_type", ["softsign"])])
    try:
        x = m.nd.array(np.random.RandomState(0).rand(4, 4)
                       .astype(np.float32)).astype("bfloat16")
        out = m.nd.Activation(x, "softsign") if positional else \
            m.nd.Activation(x, act_type="softsign")
        assert _name(out.dtype) == "float32"
        assert _name(m.nd.Activation(x, act_type="relu").dtype) == \
            "bfloat16"
    finally:
        lib.amp._deinit()


def test_hook_handle_detach():
    from tpu_mx_torch.gluon.block import HookHandle
    calls = []
    net = gluon.nn.Dense(2, in_units=3)
    net.initialize()
    h = net.register_forward_hook(lambda blk, ins, out: calls.append(1))
    assert isinstance(h, HookHandle)
    net(nd.array(np.random.rand(2, 3).astype(np.float32)))
    h.remove()
    net(nd.array(np.random.rand(2, 3).astype(np.float32)))
    assert len(calls) == 1


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_amp_kwarg_call_is_cast(amp_active, pkg):
    m, _, _ = PKGS[pkg]
    x = m.nd.array(np.random.rand(4, 4).astype(np.float32)).astype("bfloat16")
    assert _name(m.nd.softmax(data=x, axis=-1).dtype) == "float32"


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_amp_reinit_warns(amp_active, pkg):
    _, lib, _ = PKGS[pkg]
    with pytest.warns(UserWarning, match="already ran"):
        lib.init(target_dtype="float16")
    with pytest.raises(ValueError, match="target_dtype"):
        lib.amp._deinit()
        lib.init(target_dtype="float64")


# -- where the patch lands ----------------------------------------------------
def _record(lib):
    """Replace every patched name, in both namespaces, by a recorder of
    its calls; returns (calls, undo)."""
    calls, saved = [], []
    nss = lib.amp._namespaces()
    for name in lib.amp._amp_state["originals"]:
        fn = getattr(nss[0], name)

        def rec(*a, _fn=fn, _n=name, **k):
            calls.append(_n)
            return _fn(*a, **k)
        for ns in nss:
            if getattr(ns, name, None) is fn:
                saved.append((ns, name, fn))
                setattr(ns, name, rec)

    def undo():
        for ns, name, fn in saved:
            setattr(ns, name, fn)
    return calls, undo


def _block_case(m, case):
    nn_ = m.gluon.nn
    cnn = m.gluon.contrib.nn
    if case == "dense_relu":
        return nn_.Dense(8, activation="relu", in_units=4), (2, 4)
    if case == "conv":
        return nn_.Conv2D(4, 3, in_channels=3), (1, 3, 8, 8)
    if case == "layernorm":
        return nn_.LayerNorm(in_channels=4), (2, 4)
    if case == "batchnorm":
        return nn_.BatchNorm(in_channels=4), (2, 4)
    if case == "instancenorm":
        return nn_.InstanceNorm(in_channels=3), (2, 3, 4)
    if case == "groupnorm":
        return nn_.GroupNorm(2), (2, 4, 4)
    if case == "mlp_bn":
        net = nn_.HybridSequential()
        net.add(nn_.Dense(8, activation="relu", in_units=4),
                nn_.BatchNorm(in_channels=8), nn_.Dense(3, in_units=8))
        return net, (2, 4)
    if case == "concurrent":
        net = cnn.HybridConcurrent(axis=1)
        net.add(nn_.Dense(3, in_units=4), cnn.Identity())
        return net, (2, 4)
    if case == "pixelshuffle":
        return cnn.PixelShuffle2D(2), (1, 8, 2, 2)
    raise KeyError(case)


BLOCKS = ["dense_relu", "conv", "layernorm", "batchnorm", "instancenorm",
          "groupnorm", "mlp_bn", "concurrent", "pixelshuffle"]


def _amp_calls(pkg, build, run):
    """``run(net)`` under ``amp.init()`` with the recorder: the calls and
    the output's dtype."""
    m, lib, ag = PKGS[pkg]
    lib.init()
    try:
        net = build(m)
        calls, undo = _record(lib)
        try:
            with ag.record():
                out = run(m, net)
        finally:
            undo()
        return calls, _name(out.dtype)
    finally:
        lib.amp._deinit()


@pytest.mark.parametrize("case", BLOCKS)
def test_amp_casts_the_layers_calls_as_the_reference(case):
    x = np.random.RandomState(0).rand(*_block_case(jmx, case)[1]) \
        .astype(np.float32)

    def build(m):
        net = _block_case(m, case)[0]
        net.initialize()
        return net
    got = [_amp_calls(p, build, lambda m, net: net(m.nd.array(x)))
           for p in ("ref", "port")]
    assert got[1] == got[0]


CELLS = {"rnn": ("rnn", "RNNCell", dict(hidden_size=4, input_size=3)),
         "lstm": ("rnn", "LSTMCell", dict(hidden_size=4, input_size=3)),
         "gru": ("rnn", "GRUCell", dict(hidden_size=4, input_size=3)),
         "lstmp": ("contrib.rnn", "LSTMPCell",
                   dict(hidden_size=4, projection_size=2, input_size=3)),
         "conv_lstm": ("contrib.rnn", "Conv2DLSTMCell",
                       dict(hidden_channels=2, kernel=3,
                            input_shape=(3, 4, 4))),
         "conv_gru": ("contrib.rnn", "Conv1DGRUCell",
                      dict(hidden_channels=2, kernel=3, input_shape=(3, 5)))}


@pytest.mark.parametrize("case", sorted(CELLS))
def test_amp_casts_the_cells_calls_as_the_reference(case):
    where, cls, kw = CELLS[case]
    shape = (2,) + kw.get("input_shape", (3,))

    def build(m):
        mod = m.gluon.contrib.rnn if where == "contrib.rnn" else m.gluon.rnn
        cell = getattr(mod, cls)(**kw)
        cell.initialize()
        return cell

    def run(m, cell):
        x = m.nd.array(np.random.RandomState(1).rand(*shape)
                       .astype(np.float32))
        states = [m.nd.array(np.zeros(s.shape, np.float32))
                  for s in cell.begin_state(2)]
        return cell(x, states)[0]
    got = [_amp_calls(p, build, run) for p in ("ref", "port")]
    assert got[1] == got[0]


LOSSES = [("SoftmaxCrossEntropyLoss", {}), ("L2Loss", {}), ("L1Loss", {}),
          ("SigmoidBinaryCrossEntropyLoss", {}),
          ("SigmoidBinaryCrossEntropyLoss", {"from_sigmoid": True}),
          ("KLDivLoss", {}), ("KLDivLoss", {"from_logits": False}),
          ("HuberLoss", {}), ("HingeLoss", {}), ("SquaredHingeLoss", {}),
          ("LogisticLoss", {}), ("PoissonNLLLoss", {}),
          ("PoissonNLLLoss", {"from_logits": False, "compute_full": True}),
          ("TripletLoss", {}), ("CosineEmbeddingLoss", {})]


@pytest.mark.parametrize("name,kw", LOSSES,
                         ids=[f"{n}{sorted(k)}" for n, k in LOSSES])
def test_amp_casts_the_losses_calls_as_the_reference(name, kw):
    rng = np.random.RandomState(3)
    pred = rng.rand(4, 5).astype(np.float32) + 0.1
    if name == "SoftmaxCrossEntropyLoss":
        args = [pred, np.array([0, 1, 2, 3], np.float32)]
    elif name == "CosineEmbeddingLoss":
        args = [pred, rng.rand(4, 5).astype(np.float32),
                np.array([1, -1, 1, -1], np.float32)]
    elif name == "TripletLoss":
        args = [pred, rng.rand(4, 5).astype(np.float32),
                rng.rand(4, 5).astype(np.float32)]
    else:
        args = [pred, rng.rand(4, 5).astype(np.float32) * 2]

    def build(m):
        return getattr(m.gluon.loss, name)(**kw)
    got = [_amp_calls(p, build,
                      lambda m, loss: loss(*[m.nd.array(a) for a in args]))
           for p in ("ref", "port")]
    assert got[1] == got[0]


def _bert_pair():
    from tpu_mx.models.bert import BERTModel as JBERT
    from tpu_mx_torch.models import BERTModel, bert_base_config
    cfg = bert_base_config(vocab_size=50, max_len=16)
    cfg.update(num_layers=2, units=16, hidden_size=32, num_heads=2,
               dropout=0.0)
    jmx.random.seed(0)
    ref = JBERT(cfg)
    ref.initialize(init="xavier")
    rng = np.random.RandomState(0)
    batch = (rng.randint(4, 50, (2, 16)).astype(np.int32),
             np.zeros((2, 16), np.int32), np.array([16, 11], np.int32))
    ref(*[jmx.nd.array(a) for a in batch])
    params = {k: p.data().asnumpy() for k, p in ref.collect_params().items()}
    return ref, BERTModel.from_numpy(params, cfg, device="cpu"), batch


@pytest.mark.parametrize("target", ["bfloat16", "float16"])
def test_amp_bert_casts_as_the_reference(target):
    """A float32 BERT under ``amp.init(target)`` and ``convert_model``: the
    same patched calls (LayerNorm in float32, each FullyConnected in the
    target dtype), the same parameter dtypes in the reference's order
    (the LayerNorms' float32), float32 logits within bf16's distance;
    under float16, q/k/v are float16, which both packages' kernel gates
    send to the dense arm (no error)."""
    from tpu_mx.kernels import flash_attention as jfa
    from tpu_mx_torch.kernels import flash_attention as fa
    ring_attention = importlib.import_module(
        "tpu_mx_torch.parallel.ring_attention")
    ref, port, batch = _bert_pair()
    got = {}
    for name, net, args in (
            ("ref", ref, [jmx.nd.array(a) for a in batch]),
            ("port", port, [torch.from_numpy(a) for a in batch])):
        _, lib, _ = PKGS[name]
        lib.init(target)
        try:
            lib.convert_model(net)
            calls, undo = _record(lib)
            try:
                out = net(*args)
            finally:
                undo()
            logits = out.asnumpy() if name == "ref" else out.detach().numpy()
            got[name] = (calls, _name(out.dtype), _dtypes(net), logits)
        finally:
            lib.amp._deinit()
    assert got["port"][:3] == got["ref"][:3]
    assert got["port"][1] == "float32"
    assert "float32" in got["port"][2] and target in got["port"][2]
    ref_logits = got["ref"][3]
    np.testing.assert_allclose(got["port"][3], ref_logits, rtol=0,
                               atol=BF16_REL * np.abs(ref_logits).max())
    if target == "float16":
        assert not jfa.supported((2, 2, 128, 64), "float16")
        assert fa.card_dense_arm("flash_attention", 64,
                                 torch.float16) == "dense"
        assert ring_attention.attention_arm("cuda", 64, torch.float16,
                                            "auto", 512) == "dense"


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_amp_casts_inside_bulk_segments_as_the_reference(pkg):
    m, lib, _ = PKGS[pkg]
    x = np.random.RandomState(0).rand(4, 6).astype(np.float32)
    lib.init()
    try:
        a = m.nd.array(x)
        b = a.astype("bfloat16")
        m.engine.reset_bulk_stats()
        with m.engine.bulk(16):
            y = m.nd.softmax(m.nd.exp(b) * 2.0, axis=-1)
            z = m.nd.dot(a, m.nd.array(x.T))
            w = m.nd.concat(b, a, dim=0)
        stats = m.engine.bulk_stats()
        out = (_name(y.dtype), _name(z.dtype), _name(w.dtype),
               {k: stats[k] for k in ("ops_fused", "segments_flushed")})
        vals = [v.asnumpy().astype(np.float64) for v in (y, z, w)]
    finally:
        lib.amp._deinit()
    assert out == ("float32", "bfloat16", "float32",
                   {"ops_fused": 7, "segments_flushed": 2})
    np.testing.assert_allclose(vals[0], np.exp(np.exp(x) * 2)
                               / np.exp(np.exp(x) * 2).sum(-1, keepdims=True),
                               rtol=BF16_REL)


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_amp_leaves_the_executors_uncast_as_the_reference(pkg):
    """``mx.sym``'s operator table was filled at import, so neither
    package's executor reaches the patched names."""
    m, lib, _ = PKGS[pkg]
    x = np.random.RandomState(0).rand(4, 6).astype(np.float32)
    lib.init()
    try:
        s = m.sym.softmax(m.sym.FullyConnected(m.sym.var("data"),
                                               num_hidden=3, name="fc"))
        ex = s.simple_bind(m.cpu(), data=(4, 6))
        ex.arg_dict["data"][:] = x
        ex.arg_dict["fc_weight"][:] = np.full((3, 6), 0.1, np.float32)
        ex.arg_dict["fc_bias"][:] = np.zeros(3, np.float32)
        calls, undo = _record(lib)
        try:
            out = ex.forward()[0]
        finally:
            undo()
    finally:
        lib.amp._deinit()
    assert calls == [] and _name(out.dtype) == "float32"


def test_deinit_restores_every_patched_name():
    from tpu_mx_torch import ndarray as nd_pkg
    from tpu_mx_torch.ndarray import ops
    names = sorted(set(amp.lists.TARGET_DTYPE_OPS + amp.lists.FP32_OPS
                       + amp.lists.WIDEST_TYPE_CASTS + ["Activation"]))
    before = {(ns.__name__, n): getattr(ns, n, None)
              for ns in (ops, nd_pkg) for n in names}
    amp.init(conditional_fp32_ops=[("Activation", "act_type",
                                    ["softsign"])])
    try:
        assert ops.FullyConnected is not before[(ops.__name__,
                                                 "FullyConnected")]
        assert nd_pkg.softmax is ops.softmax
        assert getattr(ops.softmax, "__amp_wrapped__", False)
    finally:
        amp_mod._deinit()
    after = {(ns.__name__, n): getattr(ns, n, None)
             for ns in (ops, nd_pkg) for n in names}
    assert after == before
    assert not amp_mod._amp_state["originals"]
    assert amp_mod._amp_state["initialized"] is False
    # a layer run after _deinit() is as without amp
    net = gluon.nn.Dense(3, in_units=4)
    net.initialize()
    assert net(nd.ones((2, 4))).dtype == np.float32


def test_amp_lists_are_the_references():
    for name in ("TARGET_DTYPE_OPS", "FP32_OPS", "WIDEST_TYPE_CASTS"):
        assert getattr(amp.lists, name) == getattr(jamp.lists, name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_unscale_divides_the_gradients_by_the_scale(dtype):
    net = gluon.nn.Dense(2, in_units=3)
    net.initialize()
    net.cast(dtype)
    with autograd.record():
        loss = net(nd.ones((2, 3), dtype=dtype)).sum()
    loss.backward()
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 0.1})
    amp.init("float16")
    try:
        amp.init_trainer(trainer)
        g0 = net.weight.grad.asnumpy().copy()
        trainer._amp_loss_scaler.loss_scale = 8.0
        amp.unscale(trainer)
        np.testing.assert_allclose(net.weight.grad.asnumpy(), g0 / 8.0)
        assert trainer._scale == 1.0
    finally:
        amp_mod._deinit()
