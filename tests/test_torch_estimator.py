"""``gluon.contrib.estimator`` against the JAX reference, on the CPU.

The reference's net (Xavier, two Dense layers) is carried into the
port with ``load_numpy``; both ``Estimator.fit`` the same batches for 2
epochs with one stock handler at a time, under SGD.  Held: the running
training loss after every batch (1e-5 relative: the same float32 steps
in both), the evaluation's metrics, the checkpoint files each writes,
the epoch an early stop or a batch budget ends on, and the log lines.
"""
import logging
import os

import numpy as np
import pytest
import torch

from tpu_mx import gluon as jgluon
from tpu_mx import nd as jnd
from tpu_mx.gluon import nn as jnn
from tpu_mx.gluon.contrib import estimator as jest

import tpu_mx as jmx
import tpu_mx_torch as mx
from tpu_mx_torch import gluon, nd
from tpu_mx_torch.base import MXNetError
from tpu_mx_torch.gluon import nn
from tpu_mx_torch.gluon.block import load_numpy
from tpu_mx_torch.gluon.contrib import estimator as est

LOSS_RTOL = 1e-5
EPOCHS = 2


@pytest.fixture(autouse=True)
def _host():
    with mx.cpu():
        yield


def _batches(ndm, n=4, batch=16, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        x = rng.randn(batch, 2).astype(np.float32)
        y = (x[:, 0] * x[:, 1] > 0).astype(np.float32)
        out.append((ndm.array(x), ndm.array(y)))
    return out


def _nets():
    def build(m):
        net = m.HybridSequential()
        net.add(m.Dense(8, activation="relu", in_units=2),
                m.Dense(2, in_units=8))
        return net

    jnet = build(jnn)
    np.random.seed(0)
    jnet.initialize(init="xavier")
    net = build(nn)
    net.initialize()
    load_numpy(net, {k: np.array(p.data()._data)
                     for k, p in jnet.collect_params().items()})
    return jnet, net


def _recorder(base):
    """An event handler (of ``base``) recording the running loss after
    every batch and each epoch's end."""
    class Recorder(base):
        def __init__(self):
            self.losses = []
            self.epochs = []

        def batch_end(self, estimator):
            self.losses.append(estimator.train_metrics[0].get()[1])

        def epoch_end(self, estimator):
            self.epochs.append(estimator.current_epoch)

    return Recorder()


def _handlers(mod, kind, tmp):
    if kind == "logging":
        return [mod.LoggingHandler(log_interval=2)]
    if kind == "checkpoint":
        return [mod.CheckpointHandler(tmp, save_best=True, monitor="loss",
                                      mode="min", max_checkpoints=1)]
    if kind == "early_stopping":     # "max" on a falling loss: stops
        return [mod.EarlyStoppingHandler(monitor="loss", patience=1,
                                         mode="max")]
    if kind == "stopping":
        return [mod.StoppingHandler(max_batch=3)]
    return []                        # validation: fit(val_data=...)


def _fit(net, ref, kind, tmp):
    """One package's run: the recorder, the estimator, its handlers."""
    mod, ndm, g = (jest, jnd, jgluon) if ref else (est, nd, gluon)
    rec = _recorder(mod.EventHandler)
    handlers = _handlers(mod, kind, tmp)
    e = mod.Estimator(net, g.loss.SoftmaxCrossEntropyLoss(),
                      trainer=g.Trainer(net.collect_params(), "sgd",
                                        {"learning_rate": 0.5}))
    e.fit(_batches(ndm), val_data=_batches(ndm, n=2, seed=1)
          if kind == "validation" else None, epochs=EPOCHS,
          event_handlers=handlers + [rec])
    return rec, e, handlers


@pytest.mark.parametrize("kind", ["logging", "checkpoint", "early_stopping",
                                  "stopping", "validation"])
def test_fit_with_each_handler_is_the_references(kind, tmp_path, caplog):
    jnet, net = _nets()
    caplog.set_level(logging.INFO)
    jrec, je, jh = _fit(jnet, True, kind, str(tmp_path / "ref"))
    ref_logs = [r.getMessage().split(" (")[0] for r in caplog.records
                if r.name == "tpu_mx.estimator"]
    rec, e, h = _fit(net, False, kind, str(tmp_path / "port"))
    logs = [r.getMessage().split(" (")[0] for r in caplog.records
            if r.name == "tpu_mx_torch.estimator"]
    assert len(rec.losses) == len(jrec.losses) > 0
    np.testing.assert_allclose(rec.losses, jrec.losses, rtol=LOSS_RTOL)
    assert rec.epochs == jrec.epochs
    assert e.global_batch == je.global_batch
    assert e.current_epoch == je.current_epoch
    assert logs == ref_logs
    if kind == "logging":
        assert len(logs) == EPOCHS * 2
    if kind == "checkpoint":
        files = sorted(os.listdir(tmp_path / "port"))
        assert files == sorted(os.listdir(tmp_path / "ref"))
        assert files == ["model-best.params", f"model-epoch{EPOCHS - 1}"
                         ".params"]
    if kind == "early_stopping":
        assert h[0].stopped_epoch == jh[0].stopped_epoch == 1
    if kind == "stopping":
        assert e.global_batch == 3 and rec.epochs == [0]
    if kind == "validation":
        got = {m.get()[0]: m.get()[1] for m in e.val_metrics}
        want = {m.get()[0]: m.get()[1] for m in je.val_metrics}
        assert sorted(got) == sorted(want) == ["loss"]
        np.testing.assert_allclose(got["loss"], want["loss"],
                                   rtol=LOSS_RTOL)


def test_evaluate_with_accuracy_is_the_references():
    jnet, net = _nets()
    _, je, _ = _fit(jnet, True, "none", None)
    _, e, _ = _fit(net, False, "none", None)
    metrics = [mx.metric.Loss("loss"), mx.metric.Accuracy()]
    jmetrics = [jmx.metric.Loss("loss"), jmx.metric.Accuracy()]
    got = e.evaluate(_batches(nd, seed=2), metrics=metrics)
    want = je.evaluate(_batches(jnd, seed=2), metrics=jmetrics)
    assert sorted(got) == sorted(want) == ["accuracy", "loss"]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_RTOL)
    assert got["accuracy"] == want["accuracy"]


def test_bad_modes_raise():
    for handler in (est.CheckpointHandler, est.EarlyStoppingHandler):
        kw = {"model_dir": "x"} if handler is est.CheckpointHandler else {}
        with pytest.raises(MXNetError, match="'min' or 'max'"):
            handler(mode="up", **kw)


def test_the_default_trainer_and_metrics(tmp_path):
    _, net = _nets()
    e = est.Estimator(net, gluon.loss.SoftmaxCrossEntropyLoss())
    assert isinstance(e.trainer, gluon.Trainer)
    assert [m.get()[0] for m in e.train_metrics] == ["loss"]
    before = [p.data().asnumpy().copy()
              for p in net.collect_params().values()]
    e.fit(_batches(nd, n=2), epochs=1,
          event_handlers=[est.CheckpointHandler(str(tmp_path))])
    after = [p.data().asnumpy() for p in net.collect_params().values()]
    assert any(not np.array_equal(a, b) for a, b in zip(before, after))
    assert os.listdir(tmp_path) == ["model-epoch0.params"]
    assert torch.isfinite(torch.tensor(e.train_metrics[0].get()[1]))
