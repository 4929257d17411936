"""CTC loss, from ``tpu_mx/ndarray/ctc.py``: ``nd.ctc_loss``/``nd.CTCLoss``.

The reference's algorithm on tensors, batched over N: the alpha
(forward) recursion in float32 log space over the blank-interleaved
extended labels (``blank, l1, blank, l2, ..., blank``), one step of
PyTorch operators per time step, with the skip rule (a label may follow
the label two states back when neither is blank and they differ), the
states past a sequence's ``2·length + 1`` held at ``_NEG``, and the
likelihood read at each sequence's last step.  ``_NEG = -1e30`` and the
``m_safe`` clamp of :func:`_logsumexp2` are the reference's, so an
impossible alignment gives the reference's finite value (1e30), not
``inf``.  The gradient is autograd's through the loop (the beta
recursion, as the reference's vjp of its scan).

Layout: ``(T, N, C)`` activations (log-softmax applied here), ``(N, L)``
labels.  With ``blank_label="first"`` the blank is channel 0 and labels
are 1-based; with ``"last"`` it is channel ``C - 1``.  Without
``label_lengths`` a label ends at its first ``-1``, or at its first
``0`` when the blank is first.  ``F.ctc_loss`` differs at these edges
(``inf`` for an impossible alignment, no padding rules) and is not used.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .ops import _op

__all__ = ["CTCLoss", "ctc_loss"]

_NEG = -1e30


def _logsumexp2(a, b):
    m = torch.maximum(a, b)
    m_safe = torch.clamp(m, min=_NEG)
    return m_safe + torch.log(torch.exp(a - m_safe) + torch.exp(b - m_safe))


def _neg(n, s, like):
    return torch.full((n, s), _NEG, dtype=like.dtype, device=like.device)


def alpha_recursion(emit, can_skip, valid_s, combine):
    """The alphas of every step, ``(T, N, S)``: ``emit`` ``(T, N, S)``
    the extended labels' log-probabilities, ``can_skip`` ``(N, S)`` the
    skip rule, ``valid_s`` ``(N, S)`` (or None) the states in use, and
    ``combine(a, b)`` the log-sum of two states.  ``alpha_0`` is
    ``emit[0]`` on the first two states (the caller masks the second)."""
    t_len, n, s = emit.shape
    neg1, neg2 = _neg(n, 1, emit), _neg(n, 2, emit)
    alpha = torch.cat([emit[0, :, :2], _neg(n, s - 2, emit)], 1) \
        if s > 2 else emit[0]
    alphas = [alpha]
    for t in range(1, t_len):
        prev = torch.cat([neg1, alpha[:, :-1]], 1)
        prev2 = torch.where(can_skip, torch.cat([neg2, alpha[:, :-2]], 1),
                            _NEG)
        alpha = combine(combine(alpha, prev), prev2) + emit[t]
        if valid_s is not None:
            alpha = torch.where(valid_s, alpha, _NEG)
        alphas.append(alpha)
    return torch.stack(alphas)


def _ctc(acts, lab, in_lens, lab_lens, blank_label):
    t_len, n, c = acts.shape
    logp = F.log_softmax(acts.float(), dim=-1)
    lab = lab.long()
    blank = 0 if blank_label == "first" else c - 1
    big_l = lab.shape[1]
    s = 2 * big_l + 1
    ext = torch.full((n, s), blank, dtype=torch.long, device=acts.device)
    ext[:, 1::2] = lab.clamp(0, c - 1)
    pos = torch.arange(s, device=acts.device)
    valid_s = pos[None, :] < (2 * lab_lens + 1)[:, None]
    ext_m2 = torch.cat([torch.full((n, 2), -1, dtype=torch.long,
                                   device=acts.device), ext[:, :-2]], 1)
    can_skip = (ext != blank) & (ext != ext_m2)
    emit = torch.gather(logp, 2, ext[None].expand(t_len, n, s))
    # the second state of step 0 is a label only when there is one
    first = torch.ones((n, s), dtype=torch.bool, device=acts.device)
    first[:, 1] = lab_lens > 0
    emit = torch.cat([torch.where(first, emit[0], _NEG)[None], emit[1:]])
    alphas = alpha_recursion(emit, can_skip, valid_s, _logsumexp2)
    rows = torch.arange(n, device=acts.device)
    a_t = alphas[(in_lens - 1).clamp(0, t_len - 1), rows]
    end1 = a_t[rows, (2 * lab_lens).clamp(0, s - 1)]
    end2 = torch.where(lab_lens > 0,
                       a_t[rows, (2 * lab_lens - 1).clamp(0, s - 1)], _NEG)
    return -_logsumexp2(end1, end2)


@_op
def ctc_loss(data, label, data_lengths=None, label_lengths=None,
             use_data_lengths=False, use_label_lengths=False,
             blank_label="first", **kw):
    """``(T, N, C)`` activations and ``(N, L)`` labels to the ``(N,)``
    negative log-likelihoods (float32)."""
    t_len, n, _ = data.shape
    lab = label.long()
    in_lens = data_lengths.long() if use_data_lengths else \
        torch.full((n,), t_len, dtype=torch.long, device=data.device)
    if use_label_lengths:
        lab_lens = label_lengths.long()
    else:
        pad_end = (lab < 0) | ((lab == 0) if blank_label == "first"
                               else torch.zeros_like(lab, dtype=torch.bool))
        ends = torch.cat([pad_end, torch.ones((n, 1), dtype=torch.bool,
                                              device=data.device)], 1)
        lab_lens = torch.argmax(ends.to(torch.uint8), dim=1)
    return _ctc(data, lab, in_lens, lab_lens, blank_label)


CTCLoss = ctc_loss
