"""``gluon.contrib.estimator``, from ``tpu_mx/gluon/contrib/estimator.py``.

The Estimator's fit/evaluate loop with the reference's event-handler
protocol (``train_begin`` / ``epoch_begin`` / ``batch_begin`` /
``batch_end`` / ``epoch_end`` / ``train_end``) and its stock handlers:
``StoppingHandler``, ``LoggingHandler``, ``CheckpointHandler``,
``EarlyStoppingHandler`` and ``ValidationHandler``.  The step is the
port's imperative one: the forward under ``autograd.record()``,
``loss.backward()``, ``Trainer.step(batch_size)``, on the device the
net's parameters live on.  The Estimator is Python orchestration around
it, as in the reference.
"""
from __future__ import annotations

import logging
import os
import time

import numpy as np

from ... import autograd, metric as metric_mod
from ...base import MXNetError
from ..trainer import Trainer

__all__ = ["Estimator", "EventHandler", "StoppingHandler", "LoggingHandler",
           "CheckpointHandler", "EarlyStoppingHandler", "ValidationHandler"]


class EventHandler:
    """Base event handler: override any subset of the six hooks."""

    def train_begin(self, estimator):
        pass

    def train_end(self, estimator):
        pass

    def epoch_begin(self, estimator):
        pass

    def epoch_end(self, estimator):
        pass

    def batch_begin(self, estimator):
        pass

    def batch_end(self, estimator):
        pass


class StoppingHandler(EventHandler):
    """Stop on max_epoch / max_batch (REF event_handler.py:StoppingHandler)."""

    def __init__(self, max_epoch=None, max_batch=None):
        self.max_epoch = max_epoch
        self.max_batch = max_batch

    def batch_end(self, estimator):
        if self.max_batch and estimator.global_batch >= self.max_batch:
            estimator.stop_training = True

    def epoch_end(self, estimator):
        if self.max_epoch and estimator.current_epoch + 1 >= self.max_epoch:
            estimator.stop_training = True


class LoggingHandler(EventHandler):
    """Periodic train-metric logging (REF event_handler.py:LoggingHandler)."""

    def __init__(self, log_interval=50, logger=None):
        self.log_interval = log_interval
        self.logger = logger or logging.getLogger("tpu_mx_torch.estimator")
        self._tic = None
        self._count = 0

    def epoch_begin(self, estimator):
        self._tic = time.time()
        self._count = 0

    def batch_end(self, estimator):
        self._count += 1
        if self._count % self.log_interval == 0:
            dt = time.time() - self._tic
            metrics = ", ".join(f"{n}={v:.4f}" for n, v in
                                (m.get() for m in estimator.train_metrics)
                                if np.isfinite(v))
            self.logger.info(
                "epoch %d batch %d: %s (%.1f batch/s)",
                estimator.current_epoch, self._count, metrics,
                self._count / max(dt, 1e-9))


class CheckpointHandler(EventHandler):
    """Save params (+ trainer state) every epoch; keeps `max_checkpoints`
    (REF event_handler.py:CheckpointHandler)."""

    def __init__(self, model_dir, model_prefix="model", max_checkpoints=5,
                 save_best=False, monitor=None, mode="min"):
        if mode not in ("min", "max"):
            raise MXNetError("mode must be 'min' or 'max'")
        self.model_dir = model_dir
        self.model_prefix = model_prefix
        self.max_checkpoints = max_checkpoints
        self.save_best = save_best
        self.monitor = monitor
        self.mode = mode
        self._saved = []
        self._best = None

    def epoch_end(self, estimator):
        os.makedirs(self.model_dir, exist_ok=True)
        epoch = estimator.current_epoch
        path = os.path.join(self.model_dir,
                            f"{self.model_prefix}-epoch{epoch}.params")
        estimator.net.save_parameters(path)
        self._saved.append(path)
        while len(self._saved) > self.max_checkpoints:
            old = self._saved.pop(0)
            if os.path.exists(old):
                os.remove(old)
        if self.save_best:
            value = self._monitored(estimator)
            better = value is not None and (
                self._best is None or
                (value < self._best if self.mode == "min"
                 else value > self._best))
            if better:
                self._best = value
                estimator.net.save_parameters(os.path.join(
                    self.model_dir, f"{self.model_prefix}-best.params"))

    def _monitored(self, estimator):
        for m in (estimator.val_metrics or estimator.train_metrics):
            name, value = m.get()
            if self.monitor is None or name == self.monitor:
                return value
        return None


class EarlyStoppingHandler(EventHandler):
    """Stop when the monitored metric stops improving
    (REF event_handler.py:EarlyStoppingHandler).  `mode` 'min' or 'max'."""

    def __init__(self, monitor="loss", min_delta=0.0, patience=3,
                 mode="min"):
        if mode not in ("min", "max"):
            raise MXNetError("mode must be 'min' or 'max'")
        self.monitor = monitor
        self.min_delta = min_delta
        self.patience = patience
        self.mode = mode
        self._best = None
        self._wait = 0
        self.stopped_epoch = None

    def epoch_end(self, estimator):
        value = None
        for m in (estimator.val_metrics or estimator.train_metrics):
            name, v = m.get()
            if name == self.monitor:
                value = v
        if value is None or not np.isfinite(value):
            return
        better = (self._best is None or
                  (self.mode == "min" and value < self._best - self.min_delta)
                  or (self.mode == "max" and
                      value > self._best + self.min_delta))
        if better:
            self._best = value
            self._wait = 0
        else:
            self._wait += 1
            if self._wait >= self.patience:
                self.stopped_epoch = estimator.current_epoch
                estimator.stop_training = True


class ValidationHandler(EventHandler):
    """Run evaluate() on val_data every `epoch_period` epochs
    (REF event_handler.py:ValidationHandler)."""

    def __init__(self, val_data, eval_fn=None, epoch_period=1):
        self.val_data = val_data
        self.eval_fn = eval_fn
        self.epoch_period = epoch_period

    def epoch_end(self, estimator):
        if (estimator.current_epoch + 1) % self.epoch_period:
            return
        if self.eval_fn is not None:
            self.eval_fn(self.val_data)
        else:
            estimator.evaluate(self.val_data)


class Estimator:
    """Training-loop facade (REF estimator.py:Estimator).

    ``fit()`` runs, for each batch, the forward under
    ``autograd.record()``, ``backward()`` and ``Trainer.step(batch_size)``:
    the path of a hand-written loop."""

    def __init__(self, net, loss, train_metrics=None, trainer=None,
                 context=None):
        self.net = net
        self.loss = loss
        self.train_metrics = self._as_metrics(train_metrics)
        self.val_metrics = []
        self.trainer = trainer or Trainer(
            net.collect_params(), "adam", {"learning_rate": 1e-3})
        self.context = context
        self.stop_training = False
        self.current_epoch = 0
        self.global_batch = 0

    @staticmethod
    def _as_metrics(metrics):
        if metrics is None:
            return [metric_mod.Loss("loss")]
        if not isinstance(metrics, (list, tuple)):
            metrics = [metrics]
        return list(metrics)

    def _update_metrics(self, metrics, labels, preds, losses):
        for m in metrics:
            if isinstance(m, metric_mod.Loss):
                m.update(None, losses)
            else:
                m.update(labels, preds)

    def fit(self, train_data, val_data=None, epochs=1, event_handlers=None,
            batch_fn=None):
        handlers = list(event_handlers or [])
        handlers.append(StoppingHandler(max_epoch=epochs))
        if val_data is not None and not any(
                isinstance(h, ValidationHandler) for h in handlers):
            handlers.append(ValidationHandler(val_data))
        # validation must fire before its consumers (early-stop, save_best)
        # read val_metrics at the same epoch_end — the reference's handler
        # priority ordering; stable sort keeps user order otherwise
        handlers.sort(key=lambda h: 0 if isinstance(h, ValidationHandler)
                      else 1)
        self.stop_training = False
        for h in handlers:
            h.train_begin(self)
        for epoch in range(epochs):
            self.current_epoch = epoch
            for m in self.train_metrics:
                m.reset()
            for h in handlers:
                h.epoch_begin(self)
            for batch in train_data:
                data, label = batch_fn(batch) if batch_fn else batch
                for h in handlers:
                    h.batch_begin(self)
                with autograd.record():
                    out = self.net(data)
                    loss = self.loss(out, label)
                loss.backward()
                bsz = int(np.prod(loss.shape)) or 1
                self.trainer.step(bsz)
                self.global_batch += 1
                self._update_metrics(self.train_metrics, label, out, loss)
                for h in handlers:
                    h.batch_end(self)
                if self.stop_training:
                    break
            for h in handlers:
                h.epoch_end(self)
            if self.stop_training:
                break
        for h in handlers:
            h.train_end(self)
        return self

    def evaluate(self, val_data, metrics=None, batch_fn=None):
        metrics = self._as_metrics(metrics) if metrics is not None \
            else (self.val_metrics or self._as_metrics(None))
        self.val_metrics = metrics
        for m in metrics:
            m.reset()
        for batch in val_data:
            data, label = batch_fn(batch) if batch_fn else batch
            out = self.net(data)
            loss = self.loss(out, label)
            self._update_metrics(metrics, label, out, loss)
        return {m.get()[0]: m.get()[1] for m in metrics}
