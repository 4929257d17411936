"""Structured events: the flight-recorder subset the port calls.

A copy of the ring-buffer core of ``tpu_mx/tracing.py`` (stdlib only,
copied rather than imported): ``emit`` appends one event stamped with
the process-wide trace context (``set_context``) to a bounded ring that
``snapshot`` reads back.  Event names are the reference's
(``serve.prefill``, ``serve.decode``, ...).  The event catalog and its
payload validation, the black box and the profiler bridge are not
ported yet (ROADMAP queue A, runtime planes).
"""
from __future__ import annotations

import threading
import time
from collections import deque

__all__ = ["set_context", "emit", "snapshot", "reset"]

_lock = threading.Lock()
_ring = deque(maxlen=512)
_context = {"step": None, "generation": 0, "request": None}


def set_context(**fields):
    """Update the process-wide trace context (``step``, ``generation``,
    ``request``); every later event carries the values current at emit
    time."""
    unknown = set(fields) - set(_context)
    if unknown:
        raise ValueError(f"unknown trace-context field(s) {sorted(unknown)} "
                         f"(have: {sorted(_context)})")
    with _lock:
        _context.update(fields)


def emit(event, t0=None, t1=None, **payload):
    """Record one event; ``t0``/``t1`` (``time.perf_counter`` endpoints)
    add the interval as ``seconds`` to the payload.  Returns the record."""
    if t0 is not None and t1 is not None:
        payload.setdefault("seconds", t1 - t0)
    rec = {"event": event, "ts": time.time(), "data": payload}
    with _lock:
        rec.update(_context)
        _ring.append(rec)
    return rec


def snapshot(last=None):
    """The ring's events, oldest first (``last=N`` keeps the newest N)."""
    with _lock:
        events = list(_ring)
    return events if last is None else events[-int(last):]


def reset():
    """Drop every event and context override (test hook)."""
    with _lock:
        _ring.clear()
        _context.update(step=None, generation=0, request=None)
