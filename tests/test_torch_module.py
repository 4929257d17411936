"""The port's ``mx.mod`` (``Module``, ``BucketingModule``), ``mx.model``
and ``mx.callback`` against the reference's, on the CPU: each test of
``tests/test_module.py`` with the reference beside it, the two modules
bound to the same weights (the reference's ``get_params()`` as numpy
arrays into the port's ``set_params``) and fed the same seeded batches;
checkpoints written by either package read by the other; a thin
two-layer symbolic LSTM language model in a ``BucketingModule``; and the
supervised ``fit`` (``supervisor.for_module``, ``resume.ModuleState``,
``elastic.auto_resume(module=)``).

Tolerances: a forward within 1e-5 relative; weights after a few SGD
steps within 1e-4 relative (the float32 sums of every step in another
order); checkpoints bit-equal.
"""
import logging
import os

import numpy as np
import pytest

import tpu_mx as jmx

import tpu_mx_torch as mx

FWD_RTOL, STEP_RTOL = 1e-5, 1e-4


@pytest.fixture(autouse=True)
def _host():
    with mx.cpu():
        yield


def _mlp_sym(m, num_hidden=32, num_classes=4):
    data = m.sym.Variable("data")
    fc1 = m.sym.FullyConnected(data, num_hidden=num_hidden, name="fc1")
    act = m.sym.Activation(fc1, act_type="relu", name="relu1")
    fc2 = m.sym.FullyConnected(act, num_hidden=num_classes, name="fc2")
    return m.sym.SoftmaxOutput(fc2, m.sym.Variable("softmax_label"),
                               name="softmax")


def _toy_dataset(n=256, dim=10, classes=4, seed=0):
    rng = np.random.RandomState(seed)
    centers = rng.randn(classes, dim) * 3.0
    y = rng.randint(0, classes, n)
    x = centers[y] + rng.randn(n, dim).astype("float64") * 0.5
    return x.astype("float32"), y.astype("float32")


def _numpy(params):
    return {k: v.asnumpy() for k, v in params.items()}


def _pair(batch=8, init_seed=0, **bind):
    """A reference module and a port module bound alike, the port's
    weights set to the reference's."""
    ref = jmx.module.Module(_mlp_sym(jmx), context=jmx.cpu())
    mod = mx.module.Module(_mlp_sym(mx), context=mx.cpu())
    for m in (ref, mod):
        m.bind(data_shapes=[("data", (batch, 10))],
               label_shapes=[("softmax_label", (batch,))], **bind)
    ref.init_params(initializer=jmx.init.Normal(0.1))
    arg, aux = ref.get_params()
    mod.init_params(arg_params=_numpy(arg), aux_params=_numpy(aux))
    return ref, mod


def _batch(m, x, y):
    return m.io.DataBatch(data=[m.nd.array(x)], label=[m.nd.array(y)])


def _close_params(a, b, rtol=STEP_RTOL, atol=1e-6):
    (pa, xa), (pb, xb) = a.get_params(), b.get_params()
    assert sorted(pa) == sorted(pb) and sorted(xa) == sorted(xb)
    for k in pa:
        np.testing.assert_allclose(pa[k].asnumpy(), pb[k].asnumpy(),
                                   rtol=rtol, atol=atol, err_msg=k)


def test_module_bind_forward():
    ref, mod = _pair()
    x = np.random.RandomState(3).randn(8, 10).astype("float32")
    y = np.zeros((8,), "float32")
    for m, module in ((jmx, ref), (mx, mod)):
        module.forward(_batch(m, x, y), is_train=False)
    (out,), (want,) = mod.get_outputs(), ref.get_outputs()
    assert out.shape == (8, 4)
    np.testing.assert_allclose(out.asnumpy(), want.asnumpy(), rtol=FWD_RTOL,
                               atol=1e-7)
    np.testing.assert_allclose(out.asnumpy().sum(axis=1), np.ones(8),
                               rtol=1e-5)
    assert mod.output_shapes == ref.output_shapes == \
        [("softmax_output", (8, 4))]
    assert mod.data_names == ["data"] and mod.label_names == \
        ["softmax_label"]
    with pytest.raises(mx.MXNetError, match="Symbol"):
        mx.module.Module("not a symbol")


def test_module_learns():
    """The reference's train-threshold test, and the first two epochs of
    the same fit (no shuffling) in both packages against each other."""
    x, y = _toy_dataset()
    it = mx.io.NDArrayIter(x, y, batch_size=32, shuffle=True,
                           label_name="softmax_label")
    mod = mx.module.Module(_mlp_sym(mx), context=mx.cpu())
    mod.fit(it, num_epoch=12, optimizer="sgd",
            optimizer_params={"learning_rate": 0.1, "rescale_grad": 1 / 32},
            initializer=mx.init.Xavier(), eval_metric="acc")
    res = dict(mod.score(mx.io.NDArrayIter(x, y, batch_size=32,
                                           label_name="softmax_label"),
                         "acc"))
    assert res["accuracy"] > 0.9, res
    ref, port = _pair(batch=32)
    for m, module in ((jmx, ref), (mx, port)):
        module.fit(m.io.NDArrayIter(x, y, batch_size=32,
                                    label_name="softmax_label"),
                   num_epoch=2, optimizer="sgd",
                   optimizer_params={"learning_rate": 0.1,
                                     "rescale_grad": 1 / 32})
    _close_params(port, ref)


def test_module_get_set_params():
    mod = mx.module.Module(_mlp_sym(mx), context=mx.cpu())
    mod.bind(data_shapes=[("data", (4, 10))],
             label_shapes=[("softmax_label", (4,))])
    mod.init_params(initializer=mx.init.Normal(0.1))
    arg, aux = mod.get_params()
    assert set(arg) == {"fc1_weight", "fc1_bias", "fc2_weight", "fc2_bias"}
    mod.set_params({k: mx.nd.array(np.ones_like(v.asnumpy()))
                    for k, v in arg.items()}, aux)
    got, _ = mod.get_params()
    np.testing.assert_array_equal(got["fc1_weight"].asnumpy(), 1.0)
    with pytest.raises(mx.MXNetError, match="missing parameter"):
        mod.set_params({"fc1_weight": got["fc1_weight"]}, {})
    mod.set_params({"fc1_weight": got["fc1_weight"] * 2}, {},
                   allow_missing=True)
    np.testing.assert_array_equal(
        mod.get_params()[0]["fc1_weight"].asnumpy(), 2.0)
    with pytest.raises(mx.MXNetError, match="bind before"):
        mx.module.Module(_mlp_sym(mx)).init_params()
    # the get_params copies do not alias the module's arrays
    got["fc2_bias"][:] = 7.0
    assert (mod.get_params()[0]["fc2_bias"].asnumpy() != 7.0).all()


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_module_checkpoint_crosses(tmp_path, writer):
    """``save_checkpoint`` of either package read by the other's
    ``load_checkpoint`` and ``Module.load``: the same weights, bit for
    bit, and the same forward."""
    ref, mod = _pair(batch=4)
    src, dst = (mod, jmx) if writer == "port" else (ref, mx)
    prefix = str(tmp_path / "mlp")
    src.save_checkpoint(prefix, 3)
    assert os.path.exists(prefix + "-0003.params")
    assert os.path.exists(prefix + "-symbol.json")
    assert os.path.exists(prefix + "-0003.manifest.json")
    sym, arg, aux = dst.model.load_checkpoint(prefix, 3)
    assert set(arg) == {"fc1_weight", "fc1_bias", "fc2_weight", "fc2_bias"}
    assert sym.list_arguments() == src.symbol.list_arguments()
    want = _numpy(src.get_params()[0])
    for k in want:
        np.testing.assert_array_equal(arg[k].asnumpy(), want[k])
    loaded = dst.module.Module.load(prefix, 3, context=dst.cpu())
    loaded.bind(data_shapes=[("data", (4, 10))],
                label_shapes=[("softmax_label", (4,))])
    loaded.init_params()
    x = np.random.RandomState(4).randn(4, 10).astype("float32")
    for m, module in ((dst, loaded), (jmx if src is ref else mx, src)):
        module.forward(_batch(m, x, np.zeros(4, "float32")), is_train=False)
    np.testing.assert_allclose(loaded.get_outputs()[0].asnumpy(),
                               src.get_outputs()[0].asnumpy(),
                               rtol=FWD_RTOL, atol=1e-7)


def test_module_input_grads():
    ref, mod = _pair(batch=4, inputs_need_grad=True)
    x = np.random.RandomState(5).randn(4, 10).astype("float32")
    y = np.array([0, 1, 2, 3], "float32")
    for m, module in ((jmx, ref), (mx, mod)):
        module.forward_backward(_batch(m, x, y))
    (gin,), (want,) = mod.get_input_grads(), ref.get_input_grads()
    assert gin.shape == (4, 10) and np.abs(gin.asnumpy()).sum() > 0
    np.testing.assert_allclose(gin.asnumpy(), want.asnumpy(), rtol=FWD_RTOL,
                               atol=1e-7)
    _, plain = _pair(batch=4)
    with pytest.raises(mx.MXNetError, match="inputs_need_grad"):
        plain.get_input_grads()


def test_module_variable_last_batch():
    ref, mod = _pair(batch=8)
    for bs in (8, 5):
        x = np.random.RandomState(bs).randn(bs, 10).astype("float32")
        for m, module in ((jmx, ref), (mx, mod)):
            module.forward(_batch(m, x, np.zeros(bs, "float32")),
                           is_train=False)
        assert mod.get_outputs()[0].shape == (bs, 4)
        np.testing.assert_allclose(mod.get_outputs()[0].asnumpy(),
                                   ref.get_outputs()[0].asnumpy(),
                                   rtol=FWD_RTOL, atol=1e-7)


def _mean_sym_gen(m):
    def sym_gen(seq_len):
        data = m.sym.Variable("data")
        fc = m.sym.FullyConnected(m.sym.mean(data, axis=1), num_hidden=3,
                                  name="shared_fc")
        return (m.sym.SoftmaxOutput(fc, m.sym.Variable("softmax_label"),
                                    name="softmax"),
                ("data",), ("softmax_label",))
    return sym_gen


def test_bucketing_module():
    """Bucketed executors sharing their parameters (the symbolic PTB
    pattern), step for step the reference's."""
    mods = {}
    for m in (jmx, mx):
        b = m.module.BucketingModule(_mean_sym_gen(m), default_bucket_key=10,
                                  context=m.cpu())
        b.bind(data_shapes=[("data", (4, 10, 6))],
               label_shapes=[("softmax_label", (4,))])
        mods[m] = b
    mods[jmx].init_params(initializer=jmx.init.Normal(0.1))
    arg, aux = mods[jmx].get_params()
    mods[mx].init_params(arg_params=_numpy(arg), aux_params=_numpy(aux))
    rng = np.random.RandomState(0)
    for seq_len in (10, 7, 10, 13):
        x = rng.randn(4, seq_len, 6).astype("float32")
        for m, b in mods.items():
            if not b.optimizer_initialized:
                b.init_optimizer(optimizer="sgd",
                                 optimizer_params={"learning_rate": 0.1})
            batch = _batch(m, x, np.array([0, 1, 2, 0], "float32"))
            batch.bucket_key = seq_len
            b.forward(batch, is_train=True)
            b.backward()
            b.update()
            assert b.get_outputs()[0].shape == (4, 3)
        np.testing.assert_allclose(mods[mx].get_outputs()[0].asnumpy(),
                                   mods[jmx].get_outputs()[0].asnumpy(),
                                   rtol=STEP_RTOL, atol=1e-6)
    bmod = mods[mx]
    w_default = bmod._buckets[10]._exec.arg_dict["shared_fc_weight"]
    w_7 = bmod._buckets[7]._exec.arg_dict["shared_fc_weight"]
    assert w_default is w_7
    assert bmod._buckets[13]._updater_states is \
        bmod._buckets[10]._updater_states
    _close_params(bmod, mods[jmx])
    assert bmod.symbol.list_arguments() == \
        mods[jmx].symbol.list_arguments()


def _lm_sym_gen(m, vocab, embed, hidden, layers, batch):
    """The symbolic PTB word LM (Embedding, a fused LSTM over the packed
    blob, a vocabulary projection, SoftmaxOutput), batch-major ids."""
    size = m.nd.rnn_param_size("lstm", embed, hidden, layers)

    def sym_gen(seq_len):
        data = m.sym.Variable("data")
        label = m.sym.Variable("softmax_label")
        emb = m.sym.Embedding(data, input_dim=vocab, output_dim=embed,
                              name="embed")
        x = m.sym.swapaxes(emb, dim1=0, dim2=1)
        # zero initial states (L, N, H) from the data (the reference's
        # symbolic zeros cannot be evaluated)
        zero = m.sym.slice_axis(m.sym.slice_axis(
            m.sym.zeros_like(x), axis=2, begin=0, end=1), axis=0, begin=0,
            end=1)
        state = m.sym.broadcast_to(zero, shape=(layers, batch, hidden))
        cell = m.sym.broadcast_to(zero, shape=(layers, batch, hidden))
        out = m.sym.RNN(x, m.sym.Variable("lstm_parameters", shape=(size,)),
                        state, cell, state_size=hidden, num_layers=layers,
                        mode="lstm", name="lstm")
        out = m.sym.reshape(m.sym.swapaxes(out, dim1=0, dim2=1),
                            shape=(-1, hidden))
        pred = m.sym.FullyConnected(out, num_hidden=vocab, name="pred")
        return (m.sym.SoftmaxOutput(pred, m.sym.reshape(label, shape=(-1,)),
                                    name="softmax"),
                ("data",), ("softmax_label",))
    return sym_gen


def test_symbolic_lstm_lm_in_a_bucketing_module():
    """A thin two-layer symbolic LSTM LM over buckets of 3, 5 and 8 steps,
    three SGD steps a bucket in both packages from the same weights: the
    outputs and the weights step for step."""
    vocab, embed, hidden, layers, batch = 30, 8, 8, 2, 4
    mods = {}
    for m in (jmx, mx):
        b = m.module.BucketingModule(
            _lm_sym_gen(m, vocab, embed, hidden, layers, batch),
            default_bucket_key=8, context=m.cpu())
        b.bind(data_shapes=[("data", (batch, 8))],
               label_shapes=[("softmax_label", (batch, 8))])
        mods[m] = b
    mods[jmx].init_params(initializer=jmx.init.Uniform(0.1))
    arg, aux = mods[jmx].get_params()
    assert sorted(arg) == ["embed_weight", "lstm_parameters", "pred_bias",
                           "pred_weight"]
    mods[mx].set_params(_numpy(arg), _numpy(aux))
    for b in mods.values():
        b.init_optimizer(optimizer="sgd",
                         optimizer_params={"learning_rate": 0.5})
    rng = np.random.RandomState(1)
    for seq_len in (8, 3, 5, 8, 5, 3):
        ids = rng.randint(0, vocab, (batch, seq_len + 1)).astype("float32")
        for m, b in mods.items():
            batch_ = _batch(m, ids[:, :-1], ids[:, 1:])
            batch_.bucket_key = seq_len
            b.forward(batch_, is_train=True)
            b.backward()
            b.update()
        got = mods[mx].get_outputs()[0].asnumpy()
        assert got.shape == (batch * seq_len, vocab)
        np.testing.assert_allclose(got, mods[jmx].get_outputs()[0].asnumpy(),
                                   rtol=STEP_RTOL, atol=1e-6)
    _close_params(mods[mx], mods[jmx])
    b = mods[mx]
    assert b._buckets[3]._exec.arg_dict["lstm_parameters"] is \
        b._buckets[8]._exec.arg_dict["lstm_parameters"]


def test_module_multi_context_dp():
    """A context list: the reference's sharded program over its devices,
    the port's whole batch on the list's first context; the same
    weights after the same epochs."""
    import jax
    x, y = _toy_dataset(n=128)
    ref = jmx.module.Module(_mlp_sym(jmx), context=[
        jmx.cpu(i) for i in range(len(jax.devices()))])
    mod = mx.module.Module(_mlp_sym(mx), context=[mx.cpu(0), mx.cpu(1)])
    for m, module in ((jmx, ref), (mx, mod)):
        module.bind(data_shapes=[("data", (32, 10))],
                    label_shapes=[("softmax_label", (32,))])
    ref.init_params(initializer=jmx.init.Xavier())
    arg, aux = ref.get_params()
    mod.init_params(arg_params=_numpy(arg), aux_params=_numpy(aux))
    for m, module in ((jmx, ref), (mx, mod)):
        module.fit(m.io.NDArrayIter(x, y, batch_size=32,
                                    label_name="softmax_label",
                                    last_batch_handle="discard"),
                   num_epoch=4, optimizer="sgd",
                   optimizer_params={"learning_rate": 0.1,
                                     "rescale_grad": 1 / 32})
    _close_params(mod, ref)
    res = dict(mod.score(mx.io.NDArrayIter(x, y, batch_size=32,
                                           label_name="softmax_label"),
                         "acc"))
    assert res["accuracy"] > 0.9, res


def test_module_predict_and_pad():
    x, y = _toy_dataset(n=50)
    ref, mod = _pair(batch=16)
    outs = {}
    for m, module in ((jmx, ref), (mx, mod)):
        it = m.io.NDArrayIter(x, y, batch_size=16, label_name="softmax_label")
        outs[m] = module.predict(it)
        assert outs[m].shape == (50, 4)
        metric = m.metric.Accuracy()
        module.score(it, metric)
        assert metric.num_inst == 50
        parts = module.predict(it, merge_batches=False, num_batch=2)
        assert len(parts) == 2 and parts[0][0].shape == (16, 4)
    np.testing.assert_allclose(outs[mx].asnumpy(), outs[jmx].asnumpy(),
                               rtol=FWD_RTOL, atol=1e-7)


def test_checkpoint_exact_filename(tmp_path):
    prefix = str(tmp_path / "ck")
    _, mod = _pair(batch=4)
    mod.save_checkpoint(prefix, 7)
    assert os.path.exists(prefix + "-0007.params")
    assert os.path.exists(prefix + "-symbol.json")
    from tpu_mx_torch import checkpoint
    assert checkpoint.newest_verified_epoch(prefix) == 7


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_optimizer_state_roundtrip(tmp_path, writer):
    """Momentum survives save/load_optimizer_states, into either
    package."""
    prefix = str(tmp_path / "opt")
    x, y = _toy_dataset(n=64)
    ref, mod = _pair(batch=32)
    opt = {"learning_rate": 0.1, "momentum": 0.9, "rescale_grad": 1 / 32}
    for m, module in ((jmx, ref), (mx, mod)):
        module.fit(m.io.NDArrayIter(x, y, batch_size=32,
                                    label_name="softmax_label"),
                   num_epoch=2, optimizer="sgd", optimizer_params=opt)
    np.testing.assert_allclose(
        np.asarray(mod._updater_states["fc1_weight"]),
        np.asarray(ref._updater_states["fc1_weight"]), rtol=STEP_RTOL,
        atol=1e-6)
    src, dst = (mod, mx) if writer == "port" else (ref, jmx)
    src.save_checkpoint(prefix, 2, save_optimizer_states=True)
    for m in (mx, jmx):
        back = m.module.Module.load(prefix, 2, load_optimizer_states=True)
        it = m.io.NDArrayIter(x, y, batch_size=32,
                              label_name="softmax_label")
        back.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
        back.init_params()
        back.init_optimizer(optimizer="sgd", optimizer_params=opt)
        s1 = np.asarray(src._updater_states["fc1_weight"])
        s2 = np.asarray(back._updater_states["fc1_weight"])
        np.testing.assert_array_equal(s1, s2)
        assert np.abs(s2).sum() > 0
    assert dst is not None


def test_install_monitor_waits_for_item_10f(capsys):
    """Item 10 (f) is ported: ``install_monitor`` takes an
    ``mx.monitor.Monitor`` and hooks nothing, as the reference's does
    (its executors run whole graphs), so ``fit(monitor=)`` records and
    prints nothing in either package, and trains as without it."""
    ref, mod = _pair(batch=4)
    x, y = _toy_dataset(n=8)
    printed = []
    for m, module in ((jmx, ref), (mx, mod)):
        mon = m.monitor.Monitor(interval=1)
        assert module.install_monitor(mon) is None
        module.fit(m.io.NDArrayIter(x, y, batch_size=4,
                                    label_name="softmax_label"),
                   num_epoch=1, monitor=mon,
                   optimizer_params={"learning_rate": 0.1})
        assert mon.toc() == []
        printed.append(capsys.readouterr().out)
    assert printed[0] == printed[1] == ""
    _close_params(ref, mod)
    with pytest.raises(AttributeError, match="nothing"):
        mod.nothing


def test_supervised_fit_and_module_resume(tmp_path):
    """``fit(supervised=)`` commits an epoch a checkpoint through
    ``for_module``, ``auto_resume(module=)`` restores the newest into a
    fresh module, and ``ModuleState`` carries weights and momentum."""
    from tpu_mx_torch import elastic, resume, supervisor
    x, y = _toy_dataset(n=64)
    prefix = str(tmp_path / "sup")
    ref, mod = _pair(batch=16)
    opt = {"learning_rate": 0.1, "momentum": 0.9, "rescale_grad": 1 / 16}
    results = {}
    for m, module, sup in ((jmx, ref, jmx.supervisor),
                           (mx, mod, supervisor)):
        results[m] = module.fit(
            m.io.NDArrayIter(x, y, batch_size=16,
                             label_name="softmax_label"),
            num_epoch=3, optimizer="sgd", optimizer_params=opt,
            supervised=sup.Supervise(prefix=prefix + ("_j" if m is jmx
                                                      else ""),
                                     save_optimizer_states=True,
                                     blackbox=None))
    assert results[mx].status == results[jmx].status
    assert results[mx].last_epoch == results[jmx].last_epoch
    _close_params(mod, ref)
    fresh = mx.module.Module(_mlp_sym(mx), context=mx.cpu())
    fresh.bind(data_shapes=[("data", (16, 10))],
               label_shapes=[("softmax_label", (16,))])
    fresh.init_params(initializer=mx.init.Normal(0.1))
    jfresh = jmx.module.Module(_mlp_sym(jmx), context=jmx.cpu())
    jfresh.bind(data_shapes=[("data", (16, 10))],
                label_shapes=[("softmax_label", (16,))])
    jfresh.init_params(initializer=jmx.init.Normal(0.1))
    assert elastic.auto_resume(prefix, module=fresh) == \
        jmx.elastic.auto_resume(prefix + "_j", module=jfresh) == 3
    _close_params(fresh, mod, rtol=0, atol=0)
    state = resume.ModuleState(mod).state_dict()
    assert sorted(state) == sorted(jmx.resume.ModuleState(ref).state_dict())
    other = mx.module.Module(_mlp_sym(mx), context=mx.cpu())
    other.bind(data_shapes=[("data", (16, 10))],
               label_shapes=[("softmax_label", (16,))])
    other.init_params()
    other.init_optimizer(optimizer="sgd", optimizer_params=opt)
    resume.ModuleState(other).load_state_dict(state)
    _close_params(other, mod, rtol=0, atol=0)
    np.testing.assert_array_equal(
        np.asarray(other._updater_states["fc1_weight"]),
        np.asarray(mod._updater_states["fc1_weight"]))


def test_callbacks_through_fit(tmp_path, caplog):
    x, y = _toy_dataset(n=64)
    files = {}
    for m in (mx, jmx):
        prefix = str(tmp_path / ("cb" if m is mx else "jcb"))
        module = m.module.Module(_mlp_sym(m), context=m.cpu())
        with caplog.at_level(logging.INFO):
            caplog.clear()
            module.fit(
                m.io.NDArrayIter(x, y, batch_size=16,
                                 label_name="softmax_label"),
                eval_data=m.io.NDArrayIter(x, y, batch_size=16,
                                           label_name="softmax_label"),
                num_epoch=2, optimizer="sgd",
                optimizer_params={"learning_rate": 0.1},
                batch_end_callback=[m.callback.Speedometer(16, frequent=2),
                                    m.callback.log_train_metric(2),
                                    m.callback.ProgressBar(4)],
                epoch_end_callback=[m.callback.do_checkpoint(prefix),
                                    m.callback.module_checkpoint(
                                        module, prefix + "_m", period=2)],
                eval_batch_end_callback=
                m.callback.LogValidationMetricsCallback())
            text = caplog.text
        assert "Speed" in text and "Train-accuracy" in text
        assert "Validation-accuracy" in text and "[" in text
        files[m] = sorted(f.replace("jcb", "cb")
                          for f in os.listdir(tmp_path)
                          if f.startswith("jcb" if m is jmx else "cb"))
    assert files[mx] == files[jmx]
    assert "cb-0002.params" in files[mx] and "cb_m-0002.params" in files[mx]
    from tpu_mx_torch.model import BatchEndParam
    assert BatchEndParam is mx.module.module.BatchEndParam
    assert mx.mod is mx.module
