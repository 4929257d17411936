"""Framework-level errors of the PyTorch/CUDA port.

Copies of the reference's exception classes (``tpu_mx/base.py``,
``tpu_mx/supervisor.py``): the port never imports ``tpu_mx`` — doing so
would boot its distributed runtime and import jax — so the few classes
it needs live here under the same names.
"""
from __future__ import annotations

__all__ = ["MXNetError", "NumericDivergence", "refuse_unported"]


class MXNetError(RuntimeError):
    """Framework-level error (name kept for API familiarity with the reference)."""


class NumericDivergence(MXNetError):
    """Non-finite values where the computation must stay finite: the
    serving engine raises it when a step's logits health (max |logit|)
    is NaN or Inf."""


def _is_default(value, default):
    if value is default:
        return True
    if type(value) is bool or type(default) is bool:
        return type(value) is type(default) and value == default
    if isinstance(value, (int, float)) and isinstance(default, (int, float)):
        return value == default
    return type(value) is type(default) and value == default


def refuse_unported(owner, item, **args):
    """Raise :class:`MXNetError` for the first of the reference's
    arguments that the port accepts but does not implement yet, if it is
    set to anything but the reference's default.  ``args`` maps each
    name to ``(value, default)``; ``item`` names the ROADMAP item that
    ports it."""
    for name, (value, default) in args.items():
        if not _is_default(value, default):
            raise MXNetError(f"{owner}({name}={value!r}) is not ported yet "
                             f"(ROADMAP {item})")
