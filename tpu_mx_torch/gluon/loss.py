"""Losses from ``tpu_mx/gluon/loss.py``, as blocks (they take tensors,
or arrays through the imperative boundary of :class:`HybridBlock`):
``SoftmaxCrossEntropyLoss``, ``L2Loss``, ``L1Loss``,
``SigmoidBinaryCrossEntropyLoss``, ``KLDivLoss``, ``HuberLoss``,
``HingeLoss``, ``SquaredHingeLoss``, ``LogisticLoss``,
``PoissonNLLLoss``, ``TripletLoss``, ``CosineEmbeddingLoss`` and
``PassThrough``.

A loss returns one value per example (the mean over every axis but
``batch_axis``, as the reference's do; ``PoissonNLLLoss`` the mean of
all, ``TripletLoss`` and ``CosineEmbeddingLoss`` a value per row);
``CompiledTrainStep`` takes the mean of that, and the imperative loop's
``loss.backward()`` sums it, ``Trainer.step(batch)`` scaling by
``1/batch``.  ``sample_weight`` multiplies before the mean, then
``weight``.  ``CTCLoss`` is the reference's own recursion (not
``nd.ctc_loss``'s), and takes neither weight, as the reference's does
not.  Where the reference's losses call an operator of ``contrib.amp``'s
lists through ``F`` (``log_softmax``, ``log``, ``exp``, ``where``), the
port's call it through ``ops``, so amp casts them alike.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ndarray import ops
from .block import HybridBlock

__all__ = ["Loss", "L2Loss", "L1Loss", "PoissonNLLLoss",
           "SoftmaxCrossEntropyLoss", "SoftmaxCELoss",
           "SigmoidBinaryCrossEntropyLoss", "SigmoidBCELoss", "KLDivLoss",
           "HuberLoss", "HingeLoss", "SquaredHingeLoss", "LogisticLoss",
           "TripletLoss", "CTCLoss", "CosineEmbeddingLoss", "PassThrough"]


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
        loss = ops.where(gap > self._rho, gap - 0.5 * self._rho,
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


def _softrelu_tail(pred):
    """``relu(x) - x·label``'s stable companion: ``log(1 + e^-|x|)``."""
    return F.softplus(-pred.abs())


class L2Loss(Loss):
    """``weight/2 · (label - pred)²``."""

    def __init__(self, weight=1.0, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)

    def forward(self, pred, label, sample_weight=None):
        loss = (label.reshape(pred.shape) - pred).square()
        return self._per_example(_apply_weighting(loss, self._weight / 2,
                                                  sample_weight))


class L1Loss(Loss):
    """``|label - pred|``."""

    def __init__(self, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)

    def forward(self, pred, label, sample_weight=None):
        loss = (label.reshape(pred.shape) - pred).abs()
        return self._per_example(_apply_weighting(loss, self._weight,
                                                  sample_weight))


class SigmoidBinaryCrossEntropyLoss(Loss):
    """Binary cross-entropy of logits (the stable ``relu(x) - x·y +
    log(1 + e^-|x|)``), or of probabilities with ``from_sigmoid=True``
    (``-(y·log(p + 1e-12) + (1-y)·log(1 - p + 1e-12))``).
    ``pos_weight`` is taken and, as in the reference, unused."""

    def __init__(self, from_sigmoid=False, weight=None, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_sigmoid = from_sigmoid

    def forward(self, pred, label, sample_weight=None, pos_weight=None):
        label = label.reshape(pred.shape)
        if not self._from_sigmoid:
            loss = torch.relu(pred) - pred * label + _softrelu_tail(pred)
        else:
            eps = 1e-12
            loss = -(ops.log(pred + eps) * label
                     + ops.log(1.0 - pred + eps) * (1.0 - label))
        return self._per_example(_apply_weighting(loss, self._weight,
                                                  sample_weight))


SigmoidBCELoss = SigmoidBinaryCrossEntropyLoss


class KLDivLoss(Loss):
    """``label·(log(label + 1e-12) - pred)``, ``pred`` log-probabilities
    (or logits with ``from_logits=False``, log-softmaxed over
    ``axis``)."""

    def __init__(self, from_logits=True, axis=-1, weight=None, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_logits = from_logits
        self._axis = axis

    def forward(self, pred, label, sample_weight=None):
        if not self._from_logits:
            pred = ops.log_softmax(pred, axis=self._axis)
        loss = label * (ops.log(label + 1e-12) - pred)
        return self._per_example(_apply_weighting(loss, self._weight,
                                                  sample_weight))


class HingeLoss(Loss):
    """``relu(margin - pred·label)``, labels ±1."""

    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def _hinge(self, pred, label):
        return torch.relu(self._margin - pred * label.reshape(pred.shape))

    def forward(self, pred, label, sample_weight=None):
        return self._per_example(_apply_weighting(
            self._hinge(pred, label), self._weight, sample_weight))


class SquaredHingeLoss(HingeLoss):
    """``relu(margin - pred·label)²``."""

    def forward(self, pred, label, sample_weight=None):
        return self._per_example(_apply_weighting(
            self._hinge(pred, label).square(), self._weight, sample_weight))


class LogisticLoss(Loss):
    """Binary cross-entropy of logits with labels ±1
    (``label_format="signed"``) or 0/1 (``"binary"``)."""

    def __init__(self, weight=None, batch_axis=0, label_format="signed",
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._label_format = label_format

    def forward(self, pred, label, sample_weight=None):
        label = label.reshape(pred.shape)
        if self._label_format == "signed":
            label = (label + 1.0) / 2.0
        loss = torch.relu(pred) - pred * label + _softrelu_tail(pred)
        return self._per_example(_apply_weighting(loss, self._weight,
                                                  sample_weight))


class PoissonNLLLoss(Loss):
    """Poisson negative log-likelihood of the rate ``pred`` (its log with
    ``from_logits=True``): ``e^pred - label·pred`` or ``pred - label·
    log(pred + epsilon)``, with ``compute_full`` Stirling's term for
    ``log(label!)`` where ``label > 1``; the mean over everything."""

    def __init__(self, weight=None, from_logits=True, batch_axis=0,
                 compute_full=False, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_logits = from_logits
        self._compute_full = compute_full

    def forward(self, pred, label, sample_weight=None, epsilon=1e-08):
        label = label.reshape(pred.shape)
        if self._from_logits:
            loss = ops.exp(pred) - label * pred
        else:
            loss = pred - label * ops.log(pred + epsilon)
        if self._compute_full:
            stirling = label * ops.log(label + epsilon) - label + \
                0.5 * ops.log(2.0 * 3.14159265358979 * (label + epsilon))
            loss = loss + ops.where(label <= 1.0,
                                    torch.zeros_like(stirling), stirling)
        return _apply_weighting(loss, self._weight, sample_weight).mean()


class TripletLoss(Loss):
    """``relu(Σ (positive - pred)² - (negative - pred)² + margin)`` over
    every axis but the first."""

    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def forward(self, pred, positive, negative, sample_weight=None):
        positive = positive.reshape(pred.shape)
        negative = negative.reshape(pred.shape)
        axes = tuple(range(1, pred.dim()))
        loss = ((positive - pred).square() - (negative - pred).square()).sum(
            dim=axes) + self._margin
        return _apply_weighting(torch.relu(loss), self._weight,
                                sample_weight)


class CosineEmbeddingLoss(Loss):
    """``1 - cos(input1, input2)`` where ``label == 1``, else
    ``relu(cos - margin)``; the cosine over every axis but the first."""

    def __init__(self, weight=None, batch_axis=0, margin=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def forward(self, input1, input2, label, sample_weight=None):
        axes = tuple(range(1, input1.dim()))
        num = (input1 * input2).sum(dim=axes)
        den = input1.square().sum(dim=axes).sqrt() * \
            input2.square().sum(dim=axes).sqrt()
        cos = num / (den + 1e-12)
        label = label.reshape(cos.shape)
        loss = ops.where(label == 1, 1.0 - cos,
                         torch.relu(cos - self._margin))
        return _apply_weighting(loss, self._weight, sample_weight)


class CTCLoss(Loss):
    """Connectionist temporal classification, the reference's
    ``gluon.loss.CTCLoss`` recursion: ``pred`` in ``layout`` ``"NTC"`` or
    ``"TNC"`` (log-softmax in its own type), ``(N, L)`` labels with the
    blank at channel 0, every label ``L`` long unless ``label_lengths``
    says otherwise, the likelihood read at step ``pred_lengths - 1``
    (default the last).  Unlike ``nd.ctc_loss`` no state is masked and
    the log-sum is PyTorch's ``logaddexp``; ``weight`` and
    ``sample_weight`` are taken and, as in the reference, not applied.
    One value per sequence."""

    def __init__(self, layout="NTC", label_layout="NT", weight=None,
                 **kwargs):
        super().__init__(weight, 0, **kwargs)
        self._layout = layout

    def forward(self, pred, label, pred_lengths=None, label_lengths=None,
                sample_weight=None):
        from ..ndarray.ctc import alpha_recursion
        from ..ndarray.ops_tail import _take_along
        if self._layout == "NTC":
            pred = pred.transpose(0, 1)
        t_len, n, _ = pred.shape
        logp = F.log_softmax(pred, dim=-1)
        big_l = label.shape[1]
        ext = torch.zeros((n, 2 * big_l + 1), dtype=torch.long,
                          device=pred.device)
        ext[:, 1::2] = label.long()
        same_as_prev2 = torch.cat(
            [torch.ones((n, 2), dtype=torch.bool, device=pred.device),
             ext[:, 2:] == ext[:, :-2]], 1)
        emit = _take_along(logp, ext[None], 2)
        alphas = alpha_recursion(emit, ~same_as_prev2, None, torch.logaddexp)
        t_end = (pred_lengths.long() - 1 if pred_lengths is not None else
                 torch.full((n,), t_len - 1, device=pred.device)) % t_len
        rows = torch.arange(n, device=pred.device)
        alpha_end = alphas[t_end, rows]
        s_last = 2 * (label_lengths.long() if label_lengths is not None else
                      torch.full((n,), big_l, device=pred.device))
        return -torch.logaddexp(alpha_end[rows, s_last],
                                alpha_end[rows, (s_last - 1).clamp(min=0)])
