"""Profiler API, from ``tpu_mx/profiler.py`` (the reference's
``mx.profiler``).

The reference-shaped API (``set_config``, ``set_state``, ``pause``,
``resume``, ``dump``, ``dumps``, ``scope``, ``record_span``, and the
``Task``/``Frame``/``Event``/``Counter``/``Marker`` objects) over two
recorders:

- the **host scope recorder**, the reference's: every scope, task,
  counter, marker and flight-recorder event (``tracing.emit`` mirrors
  each event here while the profiler records) becomes a chrome-trace
  event, and :func:`dumps` prints the per-scope aggregate table in the
  reference's format;
- the **device trace**, ``torch.profiler`` with the CPU and (on a card)
  CUDA activities, in place of ``jax.profiler``'s XLA trace: it starts
  with ``set_state('run')`` and stops with ``set_state('stop')``, and
  :func:`dump` merges its operators and kernels into the same
  chrome-trace file, so the port's kernels appear there by name
  (category ``kernel``) beside the host scopes.  Its times are placed on
  the host recorder's clock by the profiler's start.

Usage (the reference's)::

    mx.profiler.set_config(filename="profile.json")
    mx.profiler.set_state("run")
    ... work ...
    mx.profiler.set_state("stop")      # writes profile.json
    print(mx.profiler.dumps())
"""
from __future__ import annotations

import json
import os
import threading
import time

import torch

__all__ = ["set_config", "set_state", "pause", "resume", "dump", "dumps",
           "scope", "record_span", "Task", "Frame", "Event", "Counter",
           "Marker"]

_state = {
    "filename": "profile.json",
    "running": False,
    "paused": False,
    "profile_all": False,
}
_lock = threading.Lock()
# scope name -> [count, total_seconds, min_seconds, max_seconds]
_agg: dict[str, list] = {}
# chrome-trace events recorded host-side (scopes, markers, counters)
_events: list[dict] = []
# the device trace: the running torch.profiler session, its start on the
# host clock, and the events of the last finished session
_torch_prof = {"session": None, "t0": 0.0}
_device_events: list[dict] = []
_pid = os.getpid()


def set_config(filename="profile.json", profile_all=False,
               profile_symbolic=True, profile_imperative=True,
               profile_memory=False, profile_api=False,
               aggregate_stats=True, **kwargs):
    """Configure the profiler.  The mode arguments are the reference's;
    the device trace records every operator and kernel alike, so they
    gate nothing."""
    _state["filename"] = filename
    _state["profile_all"] = profile_all


def _start_device_trace():
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    session = torch.profiler.profile(activities=activities)
    session.__enter__()
    _torch_prof.update(session=session, t0=time.perf_counter())


def _stop_device_trace():
    """Stop the session and keep its operators and kernels as chrome-trace
    events on the host clock (kernels under category ``kernel``, with
    the device as ``pid``)."""
    session, _torch_prof["session"] = _torch_prof["session"], None
    if session is None:
        return
    session.__exit__(None, None, None)
    base_us = _torch_prof["t0"] * 1e6
    out = []
    for evt in session.events():
        device = str(getattr(evt, "device_type", "")).rsplit(".", 1)[-1]
        on_card = device == "CUDA"
        tr = evt.time_range
        out.append({"name": evt.name, "cat": "kernel" if on_card else "op",
                    "ph": "X", "ts": base_us + tr.start,
                    "dur": tr.end - tr.start,
                    "pid": f"cuda:{evt.device_index}" if on_card else _pid,
                    "tid": evt.thread})
    with _lock:
        _device_events[:] = out


def set_state(state="stop"):
    """``'run'`` starts profiling (the host recorder and the device
    trace); ``'stop'`` ends it and writes the chrome-trace JSON."""
    if state == "run":
        if _state["running"]:
            return
        with _lock:
            _events.clear()
            _agg.clear()
            _device_events.clear()
        _state["running"], _state["paused"] = True, False
        _start_device_trace()
    elif state == "stop":
        if not _state["running"]:
            return
        _state["running"] = False
        _stop_device_trace()
        dump()
    else:
        raise ValueError("state must be 'run' or 'stop'")


def pause():
    """Suspend host-side recording without ending the session."""
    _state["paused"] = True


def resume():
    _state["paused"] = False


def _recording():
    return _state["running"] and not _state["paused"]


def _record_scope(name, t0, t1, category="scope"):
    with _lock:
        st = _agg.setdefault(name, [0, 0.0, float("inf"), 0.0])
        dt = t1 - t0
        st[0] += 1
        st[1] += dt
        st[2] = min(st[2], dt)
        st[3] = max(st[3], dt)
        _events.append({"name": name, "cat": category, "ph": "X",
                        "ts": t0 * 1e6, "dur": dt * 1e6,
                        "pid": _pid, "tid": threading.get_ident()})


def record_span(name, t0, t1, category="telemetry"):
    """Merge an externally timed interval (``time.perf_counter``
    endpoints) into the chrome-trace events and the aggregate table (the
    flight recorder's bridge).  No-op unless the profiler is recording."""
    if _recording():
        _record_scope(name, t0, t1, category)


class scope:
    """Context manager: times a named region into the aggregate table and
    labels it in the device trace (``torch.profiler.record_function``)."""

    def __init__(self, name):
        self.name = name
        self._ann = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        if _recording() and _torch_prof["session"] is not None:
            self._ann = torch.profiler.record_function(self.name)
            self._ann.__enter__()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        if self._ann is not None:
            self._ann.__exit__(*exc)
            self._ann = None
        if _recording():
            _record_scope(self.name, self._t0, t1)
        return False


class Task:
    """Named task object (reference: profiler::ProfileTask)."""

    def __init__(self, name, domain=None):
        self.name = name
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self):
        if self._t0 is not None and _recording():
            _record_scope(self.name, self._t0, time.perf_counter(), "task")
        self._t0 = None


class Frame(Task):
    """Named frame (reference: profiler::ProfileFrame)."""


class Event(Task):
    """Named event (reference: profiler::ProfileEvent)."""


class Counter:
    """Named counter emitted into the chrome trace
    (reference: profiler::ProfileCounter)."""

    def __init__(self, name, domain=None, value=0):
        self.name = name
        self.value = value
        self._emit()

    def _emit(self):
        if _recording():
            with _lock:
                _events.append({"name": self.name, "ph": "C",
                                "ts": time.perf_counter() * 1e6, "pid": _pid,
                                "args": {self.name: self.value}})

    def set_value(self, value):
        self.value = value
        self._emit()

    def increment(self, delta=1):
        self.set_value(self.value + delta)

    def decrement(self, delta=1):
        self.set_value(self.value - delta)


class Marker:
    """Instant event (reference: profiler::ProfileMarker)."""

    def __init__(self, name, domain=None):
        self.name = name

    def mark(self, scope="process"):
        if _recording():
            with _lock:
                _events.append({"name": self.name, "ph": "i",
                                "ts": time.perf_counter() * 1e6, "pid": _pid,
                                "tid": threading.get_ident(),
                                "s": {"process": "p", "thread": "t",
                                      "global": "g"}.get(scope, "p")})


def dump(finished=True):
    """Write the host events and the last finished device trace's
    operators and kernels as one chrome://tracing JSON to the configured
    filename, through ``checkpoint.atomic_write`` (a crash mid-dump
    leaves the previous complete file)."""
    with _lock:
        events = list(_events) + list(_device_events)
    from .checkpoint import atomic_write
    with atomic_write(_state["filename"], "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)


def dumps(reset=False):
    """The aggregate per-scope statistics table as a string (reference:
    MXAggregateProfileStatsPrint)."""
    with _lock:
        rows = sorted(_agg.items(), key=lambda kv: -kv[1][1])
        if reset:
            _agg.clear()
    lines = ["%-40s %8s %12s %12s %12s %12s" %
             ("Name", "Calls", "Total(ms)", "Mean(ms)", "Min(ms)", "Max(ms)")]
    for name, (n, tot, mn, mx) in rows:
        lines.append("%-40s %8d %12.3f %12.3f %12.3f %12.3f" %
                     (name, n, tot * 1e3, tot / n * 1e3, mn * 1e3, mx * 1e3))
    return "\n".join(lines)


# the reference's deprecated aliases
def profiler_set_config(**kwargs):
    return set_config(**kwargs)


def profiler_set_state(state="stop"):
    return set_state(state)
