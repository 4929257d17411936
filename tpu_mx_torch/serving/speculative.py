"""Speculative decode, ``tpu_mx/serving/speculative.py``: draft cheap,
verify in one window.

A cheap **proposer** guesses each row's next ``K-1`` tokens, the model
verifies the whole ``(B, K)`` window in one decode step — one paged
kernel call per layer on a ``(B, K, H, D)`` query — and each row's
agreeing prefix is accepted.  Verification is greedy, so every emitted
token is the model's own argmax given the accepted prefix: the streams
are those of one-token decode whatever the proposer guesses; only the
number of decode steps changes.

The window uses the cache as a decode step does: ``reserve_window``
takes the ``K`` slots, the step writes every drafted position's K/V, and
the rejected tail is truncated (``PagedKVCache.truncate``).

Knob, resolved once per engine (``serve.decode_path``'s
``spec_window``): ``TPUMX_SPECULATIVE`` unset/``0``/``off`` — window 1
(off); ``1``/``on`` — :data:`DEFAULT_WINDOW`; an integer ``>= 2`` — that
window.  Anything else raises.
"""
from __future__ import annotations

import os

import torch

__all__ = ["DEFAULT_WINDOW", "resolve_spec_window", "SiblingProposer",
           "accept_prefix"]

_SPEC_ENV = "TPUMX_SPECULATIVE"

# the reference's default (its window sweep on the TPU); the paged
# kernel here takes windows up to 8
DEFAULT_WINDOW = 4


def resolve_spec_window():
    """The draft-window width ``TPUMX_SPECULATIVE`` asks for; 1 is off."""
    v = os.environ.get(_SPEC_ENV, "0").strip().lower()
    if v in ("", "0", "off", "no"):
        return 1
    if v in ("1", "on", "yes", "auto"):
        return DEFAULT_WINDOW
    try:
        n = int(v)
    except ValueError:
        raise ValueError(
            f"{_SPEC_ENV}={v!r} is not a recognized speculative setting "
            "— use 0 (off), 1 (default window) or an integer window "
            "width >= 2") from None
    if n < 2:
        raise ValueError(
            f"{_SPEC_ENV}={v!r}: an explicit window must be >= 2 "
            "(1-token windows are just decode; use 0/1 to toggle)")
    return n


class SiblingProposer:
    """The verify model's own weights without context: each draft step
    embeds only (token, position) and passes every layer's value row
    through as its attention output (a one-key softmax is the identity
    on ``v``), so a draft costs a few ``(B, E)`` products and no cache
    reads.  It runs on the model's device and chains its drafts there:
    nothing is read back to the host between them."""

    def __init__(self, model):
        self.model = model

    @torch.no_grad()
    def draft(self, last_tokens, positions, n):
        """``n`` greedy draft tokens per row: ``last_tokens`` ``(B,)``
        are the stream heads, ``positions`` ``(B,)`` their positions
        (host ints or device tensors).  Returns an int64 ``(B, n)``
        tensor on the model's device, draft ``j`` chained from draft
        ``j-1``; positions past the model's last clamp to it."""
        m = self.model
        cur = torch.as_tensor(last_tokens, device=m.device).long()
        pos = torch.as_tensor(positions, device=m.device).long()
        out = []
        for j in range(n):
            p = torch.clamp(pos + j, max=m.max_positions - 1)
            h = m._embed(cur, p)
            for i in range(m.num_layers):
                h = m.layer_combine(i, h, m._heads(h @ m.wv[i]))
            cur = (h @ m.w_out).argmax(dim=-1)
            out.append(cur)
        return torch.stack(out, dim=1)


def accept_prefix(draft_row, out_row):
    """How many DRAFTED tokens the verify step confirmed: the longest
    run of ``j = 1..K-1`` with ``draft_row[j] == out_row[j-1]``
    (``draft_row[0]`` is the stream head; ``out_row[j]`` is the model's
    argmax after ``draft_row[:j+1]``).  The step emits
    ``out_row[:accepted+1]``."""
    a = 0
    for j in range(1, len(draft_row)):
        if int(draft_row[j]) != int(out_row[j - 1]):
            break
        a += 1
    return a
