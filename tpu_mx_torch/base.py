"""Framework-level errors of the PyTorch/CUDA port.

Copies of the reference's exception classes and module constants
(``logger``, ``string_types``, ``numeric_types``; ``tpu_mx/base.py``):
the port never imports ``tpu_mx`` — doing so would boot its distributed
runtime and import jax — so what it needs lives here under the same
names.  :class:`NumericDivergence` lives in
:mod:`tpu_mx_torch.supervisor`, as in the reference, and is re-exported
here.
"""
from __future__ import annotations

import logging
import numbers

__all__ = ["MXNetError", "NumericDivergence", "refuse_unported"]

logger = logging.getLogger("tpu_mx_torch")
string_types = (str,)
numeric_types = (numbers.Number,)


class MXNetError(RuntimeError):
    """Framework-level error (name kept for API familiarity with the reference)."""


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


def __getattr__(name):
    # supervisor.py imports this module: resolved at first use
    if name == "NumericDivergence":
        from .supervisor import NumericDivergence
        return NumericDivergence
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
