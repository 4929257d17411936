"""Elastic-resume errors: the ``WorkerFailure`` of ``tpu_mx/elastic.py``.

:class:`WorkerFailure` is the transient class a bounded restart can
survive (``supervisor.classify``); the watchdog's
:class:`~tpu_mx_torch.supervisor.WatchdogTimeout` subclasses it.  The
reference module's barrier, checkpoint and auto-resume plane is not
ported yet (ROADMAP A item 8).
"""
from __future__ import annotations

from .base import MXNetError

__all__ = ["WorkerFailure"]


class WorkerFailure(MXNetError):
    """A peer did not reach the barrier within the timeout (died or hung)."""
