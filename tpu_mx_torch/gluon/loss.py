"""Losses from ``tpu_mx/gluon/loss.py``: ``Loss``, ``SoftmaxCrossEntropyLoss``,
``HuberLoss`` and ``PassThrough``, as blocks (they take tensors, or
arrays through the imperative boundary of :class:`HybridBlock`).

A loss returns one value per example (the mean over every axis but
``batch_axis``); ``CompiledTrainStep`` takes the mean of that, and the
imperative loop's ``loss.backward()`` sums it, ``Trainer.step(batch)``
scaling by ``1/batch``.
"""
from __future__ import annotations

import torch

from ..ndarray import ops
from .block import HybridBlock

__all__ = ["Loss", "SoftmaxCrossEntropyLoss", "SoftmaxCELoss", "HuberLoss",
           "PassThrough"]


def _apply_weighting(loss, weight=None, sample_weight=None):
    if sample_weight is not None:
        loss = loss * sample_weight
    if weight is not None:
        loss = loss * weight
    return loss


class Loss(HybridBlock):
    """Base of the losses.  ``**kwargs`` are the reference's block
    arguments: ``prefix`` names the loss; ``params`` (a parameter dict
    to share) holds nothing a loss uses."""

    def __init__(self, weight, batch_axis, prefix=None, params=None):
        super().__init__(prefix, params)
        self._weight = weight
        self._batch_axis = batch_axis

    def _per_example(self, loss):
        axes = tuple(i for i in range(loss.dim()) if i != self._batch_axis)
        return loss.mean(dim=axes) if axes else loss

    def extra_repr(self):
        return f"batch_axis={self._batch_axis}, w={self._weight}"


class SoftmaxCrossEntropyLoss(Loss):
    """Log-softmax + pick: ``-log softmax(pred)[label]`` for sparse labels,
    ``-sum(log softmax(pred) · label)`` for dense ones.  With
    ``from_logits=True`` ``pred`` is taken as log-probabilities already
    and the log-softmax is skipped."""

    def __init__(self, axis=-1, sparse_label=True, from_logits=False,
                 weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._axis = axis
        self._sparse_label = sparse_label
        self._from_logits = from_logits

    def forward(self, pred, label, sample_weight=None):
        if not self._from_logits:
            pred = ops.log_softmax(pred, axis=self._axis)
        if self._sparse_label:
            loss = -ops.pick(pred, label, axis=self._axis)
        else:
            loss = -(pred * label.reshape(pred.shape)).sum(dim=self._axis)
        return self._per_example(_apply_weighting(loss, self._weight,
                                                  sample_weight))


SoftmaxCELoss = SoftmaxCrossEntropyLoss


class HuberLoss(Loss):
    """Smooth L1: ``|label - pred| - rho/2`` where that gap exceeds
    ``rho``, else ``gap² / (2·rho)``; ``label`` is reshaped like
    ``pred``."""

    def __init__(self, rho=1.0, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._rho = rho

    def forward(self, pred, label, sample_weight=None):
        gap = (label.reshape(pred.shape) - pred).abs()
        loss = torch.where(gap > self._rho, gap - 0.5 * self._rho,
                           (0.5 / self._rho) * gap.square())
        return self._per_example(_apply_weighting(loss, self._weight,
                                                  sample_weight))


class PassThrough(Loss):
    """Identity loss for nets whose first output is the objective; extra
    step arguments are ignored."""

    def __init__(self, **kwargs):
        super().__init__(weight=None, batch_axis=0, **kwargs)

    def forward(self, loss, *_ignored):
        return loss
