"""Evaluation metrics, from ``tpu_mx/metric.py``: ``EvalMetric``,
``Accuracy``, ``TopKAccuracy``, ``F1``, ``MCC``, ``MAE``, ``MSE``,
``RMSE``, ``CrossEntropy``, ``Perplexity``, ``NegativeLogLikelihood``,
``Loss``, ``PearsonCorrelation``, ``CompositeEvalMetric``,
``CustomMetric``/``np_fn``/``np_metric`` and ``create``.

As in the reference, ``update(labels, preds)`` reads arrays (or tensors,
or numpy arrays) back to the host and accumulates in numpy: on the card
each update waits for the batch it reads.  ``create`` takes an
instance, a registered name (the reference's names and aliases, in
``registry``, a :class:`~tpu_mx_torch.base.Registry`), a list (a
composite) or a function (a custom metric).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .base import MXNetError, Registry
from .ndarray.ndarray import NDArray

__all__ = ["EvalMetric", "Accuracy", "TopKAccuracy", "F1", "MCC", "MAE",
           "MSE", "RMSE", "CrossEntropy", "Perplexity",
           "NegativeLogLikelihood", "Loss", "PearsonCorrelation",
           "CompositeEvalMetric", "CustomMetric", "create", "np_fn",
           "np_metric"]

registry = Registry("metric")


def _register(name, *aliases):
    return registry.register(name=name, aliases=aliases)


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


@_register("top_k_accuracy", "topk")
class TopKAccuracy(EvalMetric):
    """The share of labels among each row's ``top_k`` highest scores."""

    def __init__(self, top_k=1, name="top_k_accuracy", **kwargs):
        super().__init__(f"{name}_{top_k}", **kwargs)
        self.top_k = top_k

    def update(self, labels, preds):
        labels, preds = self._listify(labels, preds)
        for label, pred in zip(labels, preds):
            pred_np = _as_np(pred)
            label_np = _as_np(label).astype(np.int64)
            topk_idx = np.argsort(-pred_np, axis=-1)[..., :self.top_k]
            self.sum_metric += (topk_idx == label_np[..., None]).any(-1).sum()
            self.num_inst += label_np.size


def _binary_preds(pred_np):
    """Class predictions: argmax over a score row, else ``p > 0.5``."""
    if pred_np.ndim > 1 and pred_np.shape[-1] > 1:
        return pred_np.reshape(-1, pred_np.shape[-1]).argmax(-1)
    return (pred_np.flatten() > 0.5).astype(np.int64)


@_register("f1")
class F1(EvalMetric):
    """Binary F1 over every update so far (``average`` is taken, as in
    the reference, and the counts are pooled)."""

    def __init__(self, name="f1", average="macro", **kwargs):
        super().__init__(name, **kwargs)
        self.average = average
        self.reset_stats()

    def reset_stats(self):
        self.tp = self.fp = self.fn = 0

    def reset(self):
        super().reset()
        self.reset_stats()

    def update(self, labels, preds):
        labels, preds = self._listify(labels, preds)
        for label, pred in zip(labels, preds):
            y = _as_np(label).astype(np.int64).flatten()
            p = _binary_preds(_as_np(pred))
            self.tp += int(((p == 1) & (y == 1)).sum())
            self.fp += int(((p == 1) & (y == 0)).sum())
            self.fn += int(((p == 0) & (y == 1)).sum())
            prec = self.tp / max(self.tp + self.fp, 1)
            rec = self.tp / max(self.tp + self.fn, 1)
            self.sum_metric = 2 * prec * rec / max(prec + rec, 1e-12)
            self.num_inst = 1


@_register("mcc")
class MCC(EvalMetric):
    """Matthews correlation coefficient of binary predictions, over
    every update so far."""

    def __init__(self, name="mcc", **kwargs):
        super().__init__(name, **kwargs)
        self.reset_stats()

    def reset_stats(self):
        self._tp = self._tn = self._fp = self._fn = 0.0

    def reset(self):
        super().reset()
        self.reset_stats()

    def update(self, labels, preds):
        labels, preds = self._listify(labels, preds)
        for label, pred in zip(labels, preds):
            y = _as_np(label).flatten().astype(np.int64)
            p = _binary_preds(_as_np(pred)).astype(np.int64)
            self._tp += float(((p == 1) & (y == 1)).sum())
            self._tn += float(((p == 0) & (y == 0)).sum())
            self._fp += float(((p == 1) & (y == 0)).sum())
            self._fn += float(((p == 0) & (y == 1)).sum())
        den = np.sqrt((self._tp + self._fp) * (self._tp + self._fn) *
                      (self._tn + self._fp) * (self._tn + self._fn))
        self.sum_metric = 0.0 if den == 0 else \
            (self._tp * self._tn - self._fp * self._fn) / den
        self.num_inst = 1


class _Regression(EvalMetric):
    """Mean over updates of ``_reduce(label - pred)``."""

    def update(self, labels, preds):
        labels, preds = self._listify(labels, preds)
        for label, pred in zip(labels, preds):
            self.sum_metric += self._reduce(_as_np(label) - _as_np(pred))
            self.num_inst += 1


@_register("mae")
class MAE(_Regression):
    def __init__(self, name="mae", **kwargs):
        super().__init__(name, **kwargs)

    @staticmethod
    def _reduce(d):
        return np.abs(d).mean()


@_register("mse")
class MSE(_Regression):
    def __init__(self, name="mse", **kwargs):
        super().__init__(name, **kwargs)

    @staticmethod
    def _reduce(d):
        return (d ** 2).mean()


@_register("rmse")
class RMSE(_Regression):
    def __init__(self, name="rmse", **kwargs):
        super().__init__(name, **kwargs)

    @staticmethod
    def _reduce(d):
        return math.sqrt((d ** 2).mean())


@_register("nll_loss", "nll-loss")
class NegativeLogLikelihood(EvalMetric):
    """Mean ``-log(p[label] + eps)`` of probability rows."""

    def __init__(self, eps=1e-12, name="nll-loss", **kwargs):
        super().__init__(name, **kwargs)
        self.eps = eps

    def update(self, labels, preds):
        labels, preds = self._listify(labels, preds)
        for label, pred in zip(labels, preds):
            y = _as_np(label).flatten().astype(np.int64)
            p = _as_np(pred).reshape(len(y), -1)
            self.sum_metric += float(-np.log(p[np.arange(len(y)), y]
                                             + self.eps).sum())
            self.num_inst += len(y)


@_register("pearsonr")
class PearsonCorrelation(EvalMetric):
    """Mean over updates of the Pearson correlation of labels and
    predictions."""

    def __init__(self, name="pearsonr", **kwargs):
        super().__init__(name, **kwargs)

    def update(self, labels, preds):
        labels, preds = self._listify(labels, preds)
        for label, pred in zip(labels, preds):
            self.sum_metric += float(np.corrcoef(
                _as_np(label).flatten(), _as_np(pred).flatten())[0, 1])
            self.num_inst += 1


class CompositeEvalMetric(EvalMetric):
    """Several metrics updated together; ``get`` gives their names and
    values as lists."""

    def __init__(self, metrics=None, name="composite", **kwargs):
        super().__init__(name, **kwargs)
        self.metrics = [create(m) for m in (metrics or [])]

    def add(self, metric):
        self.metrics.append(create(metric))

    def update(self, labels, preds):
        for m in self.metrics:
            m.update(labels, preds)

    def reset(self):
        for m in getattr(self, "metrics", []):
            m.reset()

    def get(self):
        names, values = [], []
        for m in self.metrics:
            n, v = m.get()
            names.append(n)
            values.append(v)
        return (names, values)


class CustomMetric(EvalMetric):
    """``feval(label, pred)`` on numpy arrays, a value per update or a
    ``(sum, count)`` pair."""

    def __init__(self, feval, name="custom", allow_extra_outputs=False,
                 **kwargs):
        super().__init__(name, **kwargs)
        self._feval = feval

    def update(self, labels, preds):
        labels, preds = self._listify(labels, preds)
        for label, pred in zip(labels, preds):
            v = self._feval(_as_np(label), _as_np(pred))
            if isinstance(v, tuple):
                self.sum_metric += v[0]
                self.num_inst += v[1]
            else:
                self.sum_metric += v
                self.num_inst += 1


def np_fn(numpy_feval, name=None, allow_extra_outputs=False):
    """A :class:`CustomMetric` over a numpy function."""
    return CustomMetric(numpy_feval, name or numpy_feval.__name__,
                        allow_extra_outputs)


np_metric = np_fn


def create(metric, *args, **kwargs):
    """A metric from an instance, a registered name (``"acc"``,
    ``"top_k_accuracy"``, ``"f1"``, ``"mcc"``, ``"mae"``, ``"mse"``,
    ``"rmse"``, ``"ce"``, ``"perplexity"``, ``"nll_loss"``, ``"loss"``,
    ``"pearsonr"``, ...), a list of them (a composite) or a function (a
    custom metric)."""
    if isinstance(metric, EvalMetric):
        return metric
    if isinstance(metric, list):
        return CompositeEvalMetric([create(m) for m in metric])
    if callable(metric):
        return CustomMetric(metric)
    try:
        cls = registry.get(metric)
    except (KeyError, AttributeError):
        raise MXNetError(f"metric {metric!r} is not registered; the port "
                         f"has {registry.keys()}") from None
    return cls(*args, **kwargs)
