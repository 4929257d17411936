"""Framework-level errors of the PyTorch/CUDA port.

Copies of the reference's exception classes (``tpu_mx/base.py``,
``tpu_mx/supervisor.py``): the port never imports ``tpu_mx`` — doing so
would boot its distributed runtime and import jax — so the few classes
it needs live here under the same names.
"""
from __future__ import annotations

__all__ = ["MXNetError", "NumericDivergence"]


class MXNetError(RuntimeError):
    """Framework-level error (name kept for API familiarity with the reference)."""


class NumericDivergence(MXNetError):
    """Non-finite values where the computation must stay finite: the
    serving engine raises it when a step's logits health (max |logit|)
    is NaN or Inf."""
