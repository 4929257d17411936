"""Evaluation metrics, from ``tpu_mx/metric.py``: ``EvalMetric``,
``Accuracy``, ``CrossEntropy``, ``Perplexity``, ``Loss`` and
``create``.

As in the reference, ``update(labels, preds)`` reads arrays (or tensors,
or numpy arrays) back to the host and accumulates in numpy: on the card
each update waits for the batch it reads.  The other metrics
(``TopKAccuracy``, ``F1``, ``MAE``, ``MSE``, ``RMSE``, ``MCC``,
``PearsonCorrelation``, ``NegativeLogLikelihood``, ``Composite``,
``CustomMetric``) stay queued (ROADMAP A17).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .base import MXNetError
from .ndarray.ndarray import NDArray

__all__ = ["EvalMetric", "Accuracy", "CrossEntropy", "Perplexity", "Loss",
           "create"]

_registry = {}


def _register(*names):
    def do(cls):
        for n in names:
            _registry[n] = cls
        return cls
    return do


def _as_np(x):
    if isinstance(x, NDArray):
        return x.asnumpy()
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy() if x.dtype == torch.bfloat16 \
            else x.detach().cpu().numpy()
    return np.asarray(x)


class EvalMetric:
    """Base: ``sum_metric / num_inst`` under ``name``."""

    def __init__(self, name, output_names=None, label_names=None):
        self.name = name
        self.output_names = output_names
        self.label_names = label_names
        self.reset()

    def reset(self):
        self.num_inst = 0
        self.sum_metric = 0.0

    def update(self, labels, preds):
        raise NotImplementedError

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, self.sum_metric / self.num_inst)

    def get_name_value(self):
        name, value = self.get()
        if not isinstance(name, list):
            name, value = [name], [value]
        return list(zip(name, value))

    @staticmethod
    def _listify(labels, preds):
        if isinstance(labels, (list, tuple)):
            return list(labels), list(preds)
        return [labels], [preds]


@_register("acc", "accuracy")
class Accuracy(EvalMetric):
    """The share of predictions (argmax over ``axis`` when ``preds`` has
    one more axis than ``labels``) equal to the labels."""

    def __init__(self, axis=1, name="accuracy", **kwargs):
        super().__init__(name, **kwargs)
        self.axis = axis

    def update(self, labels, preds):
        labels, preds = self._listify(labels, preds)
        for label, pred in zip(labels, preds):
            pred_np = _as_np(pred)
            label_np = _as_np(label).astype(np.int64)
            if pred_np.ndim > label_np.ndim:
                pred_np = pred_np.argmax(axis=self.axis)
            pred_np = pred_np.astype(np.int64)
            self.sum_metric += (pred_np.flat == label_np.flat).sum()
            self.num_inst += len(label_np.flat)


@_register("ce", "cross-entropy")
class CrossEntropy(EvalMetric):
    """Mean ``-log p[label]`` of probability rows ``preds``."""

    def __init__(self, eps=1e-12, name="cross-entropy", **kwargs):
        super().__init__(name, **kwargs)
        self.eps = eps

    def update(self, labels, preds):
        labels, preds = self._listify(labels, preds)
        for label, pred in zip(labels, preds):
            label_np = _as_np(label).astype(np.int64).flatten()
            pred_np = _as_np(pred).reshape(len(label_np), -1)
            prob = pred_np[np.arange(len(label_np)), label_np]
            self.sum_metric += (-np.log(prob + self.eps)).sum()
            self.num_inst += len(label_np)


@_register("perplexity")
class Perplexity(CrossEntropy):
    """``exp`` of the mean cross-entropy, ``ignore_label`` left out (the
    PTB metric)."""

    def __init__(self, ignore_label=None, axis=-1, name="perplexity",
                 **kwargs):
        super().__init__(name=name, **kwargs)
        self.ignore_label = ignore_label
        self.axis = axis

    def update(self, labels, preds):
        labels, preds = self._listify(labels, preds)
        for label, pred in zip(labels, preds):
            label_np = _as_np(label).astype(np.int64).flatten()
            pred_np = _as_np(pred).reshape(len(label_np), -1)
            prob = pred_np[np.arange(len(label_np)), label_np]
            if self.ignore_label is not None:
                prob = prob[label_np != self.ignore_label]
            self.sum_metric += (-np.log(np.maximum(prob, self.eps))).sum()
            self.num_inst += len(prob)

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, math.exp(self.sum_metric / self.num_inst))


@_register("loss")
class Loss(EvalMetric):
    """Mean of the loss values passed as ``preds``."""

    def __init__(self, name="loss", **kwargs):
        super().__init__(name, **kwargs)

    def update(self, _, preds):
        if not isinstance(preds, (list, tuple)):
            preds = [preds]
        for pred in preds:
            loss = _as_np(pred)
            self.sum_metric += loss.sum()
            self.num_inst += loss.size


def create(metric, *args, **kwargs):
    """A metric from an instance or a registered name (``"acc"``,
    ``"ce"``, ``"perplexity"``, ``"loss"``)."""
    if isinstance(metric, EvalMetric):
        return metric
    try:
        return _registry[metric.lower()](*args, **kwargs)
    except (KeyError, AttributeError):
        raise MXNetError(f"metric {metric!r} is not ported yet (ROADMAP "
                         f"A17); the port has {sorted(_registry)}") from None
