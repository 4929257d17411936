"""Deterministic fault injection for serving (``tpu_mx/contrib/chaos.py``).

Seedable injection points that make the serving recovery paths run, not
assumed — armed by tests with :func:`enable` or, for a whole process, by
the ``TPUMX_CHAOS`` environment variable (``configure_from_env``, which
``Server.run_until_idle`` calls)::

    TPUMX_CHAOS="kill9_at_decode_step=4" python serve.py

The serving knobs (each counted in ``chaos.injections{kind}`` and
emitted as a ``chaos.inject`` event when it fires):

- ``slow_decode_step=N``: the Nth decode step since arming blocks for
  ``slow_decode_seconds`` (default 3600) inside the server's watchdog
  thread — a wedged dispatch the server must turn into a classified
  engine restart.  One-shot.
- ``kill9_at_decode_step=N``: ``os._exit(137)`` inside the Nth decode
  step — a real process death; only the committed-token journal
  survives, and a new process must ``recover()`` every stream from it.
- ``restart_storm=K``: the next K decode steps each raise
  :class:`ChaosCrash` (classified transient): K back-to-back restarts.
- ``reject_storm=K``: the next K admissions are rejected with reason
  ``"reject_storm"``.
- ``nan_after=N`` (with ``nan_streak=K``): the Nth value routed through
  :func:`poison_loss` (a decode step's logits health) comes back NaN.
- ``flaky_recompute=K``: the next K shadow re-executions of a step
  (``parallel/integrity.py``'s ``ShadowAuditor``, the serving decode
  self-check) come back with one bit flipped: flaky hardware, which the
  bit-exact audit must catch as ``DataCorruption``.

``seed``, ``hard`` and ``match`` are taken as in the reference.  The
reference's file, training and fleet sites (torn writes, hangs of a
supervised step, preemption, the training bit flips) are not ported yet
(ROADMAP A item 8); their knobs in ``TPUMX_CHAOS`` are ignored with a
warning.
"""
from __future__ import annotations

import contextlib
import logging
import os
import random
import re
import threading
import time

from .. import telemetry as _telemetry
from .. import tracing as _tracing

__all__ = ["ChaosCrash", "enable", "active", "configure_from_env",
           "poison_loss", "maybe_slow_decode", "maybe_kill9_decode",
           "storm_restart", "forced_reject", "maybe_flaky_recompute"]

log = logging.getLogger(__name__)


def _count_injection(kind):
    """A fired fault lands in ``chaos.injections{kind}`` and on the
    flight-recorder timeline with the live trace context."""
    _telemetry.counter("chaos.injections", kind=kind).inc()
    _tracing.emit("chaos.inject", kind=kind)


class ChaosCrash(Exception):
    """Simulated process death (soft mode).  Deliberately not an
    ``OSError``; ``supervisor.classify`` calls it transient."""


class _Config:
    _KINDS = ("nan_after", "nan_streak", "slow_decode_step",
              "slow_decode_seconds", "reject_storm",
              "kill9_at_decode_step", "restart_storm", "flaky_recompute",
              "seed", "hard", "match")

    def __init__(self, nan_after=None, nan_streak=1, slow_decode_step=None,
                 slow_decode_seconds=3600.0, reject_storm=0,
                 kill9_at_decode_step=None, restart_storm=0,
                 flaky_recompute=0, seed=None, hard=False, match=None):
        if seed is None:
            seed = int(os.environ.get("TPUMX_CHAOS_SEED", "0"))
        self.nan_after = None if nan_after is None else int(nan_after)
        self.nan_streak = max(1, int(nan_streak))
        self.slow_decode_step = None if slow_decode_step is None \
            else int(slow_decode_step)
        self.slow_decode_seconds = float(slow_decode_seconds)
        self.reject_storm = int(reject_storm)
        self.kill9_at_decode_step = None if kill9_at_decode_step is None \
            else int(kill9_at_decode_step)
        self.restart_storm = int(restart_storm)
        self.flaky_recompute = int(flaky_recompute)
        self.seed = seed
        self.hard = bool(hard)
        self.match = match
        self.rng = random.Random(seed)
        self.lock = threading.Lock()
        # fire counters (under lock)
        self.losses_seen = 0         # losses observed while nan_after armed
        self.nans_fired = 0
        self.decode_steps_seen = 0   # decode steps while slow_decode armed
        self.slow_decodes = 0
        self.kill9_steps_seen = 0    # decode steps while kill9 armed
        self.storms_left = self.restart_storm
        self.storms_fired = 0        # back-to-back restarts provoked
        self.rejects_left = self.reject_storm
        self.rejects_forced = 0
        self.flaky_left = self.flaky_recompute
        self.flaky_fired = 0

    def __repr__(self):
        on = {k: getattr(self, k) for k in self._KINDS
              if getattr(self, k) not in (None, 0, False)}
        return f"ChaosConfig({on})"


_config = None
_env_parsed = False


def active():
    """The currently-enabled chaos config, or None (the common case)."""
    return _config


@contextlib.contextmanager
def enable(**kwargs):
    """Enable chaos for the dynamic extent of the with-block (tests).

    Nesting replaces the outer config for the inner block.  Yields the
    config object so tests can assert on fire counters
    (``cfg.crashes``, ``cfg.tears``, ``cfg.oserrors_fired``)."""
    global _config
    prev = _config
    cfg = _Config(**kwargs)
    _config = cfg
    try:
        yield cfg
    finally:
        _config = prev


def configure_from_env():
    """Arm chaos from ``TPUMX_CHAOS`` (comma/space-separated k=v pairs).

    A programmatic :func:`enable` always wins over the env, and the env
    is parsed at most once per process."""
    global _config, _env_parsed
    if _env_parsed or _config is not None:
        return _config
    _env_parsed = True
    spec = os.environ.get("TPUMX_CHAOS")
    if not spec:
        return None
    kwargs = {}
    for part in re.split(r"[,\s]+", spec.strip()):
        if not part:
            continue
        key, _, val = part.partition("=")
        if key not in _Config._KINDS:
            log.warning("TPUMX_CHAOS: unknown knob %r ignored "
                        "(known: %s)", key, ", ".join(_Config._KINDS))
            continue
        if key == "match":
            kwargs[key] = val
        elif key == "slow_decode_seconds":
            kwargs[key] = float(val)
        elif key == "hard":
            kwargs[key] = val in ("", "1", "true", "yes", "on")
        else:
            kwargs[key] = int(val)
    _config = _Config(**kwargs)
    log.warning("chaos armed from TPUMX_CHAOS: %r", _config)
    return _config


def poison_loss(value):
    """Return `value`, or NaN when the ``nan_after`` fault says this value
    is poisoned (the serving engine routes each decode step's logits
    health through here).  Counting starts when the fault is armed: the Nth loss
    seen *since arming* — and the next ``nan_streak - 1`` after it — come
    back NaN; the fault then disarms so recovery can converge."""
    cfg = _config
    if cfg is None or cfg.nan_after is None:
        return value
    with cfg.lock:
        if cfg.nan_after is None:
            return value
        cfg.losses_seen += 1
        if cfg.losses_seen >= cfg.nan_after:
            cfg.nans_fired += 1
            _count_injection("nan")
            if cfg.losses_seen >= cfg.nan_after + cfg.nan_streak - 1:
                cfg.nan_after = None  # streak complete: disarm
            return float("nan")
    return value


def maybe_slow_decode():
    """Block for ``slow_decode_seconds`` when the ``slow_decode_step``
    fault says this is the wedged decode step (the serving engine calls
    this at the top of every decode step, INSIDE the server's watchdog
    thread — the sleep simulates a stalled decode dispatch the server
    must convert into a classified engine restart with zero lost
    requests).  One-shot; counting starts when armed."""
    cfg = _config
    if cfg is None or cfg.slow_decode_step is None:
        return
    secs = None
    with cfg.lock:
        if cfg.slow_decode_step is None:
            return
        cfg.decode_steps_seen += 1
        if cfg.decode_steps_seen >= cfg.slow_decode_step:
            cfg.slow_decode_step = None  # one-shot: the retried step runs
            cfg.slow_decodes += 1
            _count_injection("slow_decode_step")
            secs = cfg.slow_decode_seconds
    if secs:
        log.warning("chaos: stalling this decode step for %.0fs "
                    "(slow_decode_step fired)", secs)
        time.sleep(secs)


def maybe_kill9_decode():
    """``os._exit(137)`` when ``kill9_at_decode_step`` says the Nth
    serving decode step since arming has arrived (the serving engine
    calls this at the top of every decode step, right after
    :func:`maybe_slow_decode`).  A TRUE mid-step process death — no
    exception, no emergency save, no atexit — for the cross-process
    journal-recovery proof (serving/journal.py): everything not
    already fsync'd is gone, exactly like a real kill −9."""
    cfg = _config
    if cfg is None or cfg.kill9_at_decode_step is None:
        return
    with cfg.lock:
        if cfg.kill9_at_decode_step is None:
            return
        cfg.kill9_steps_seen += 1
        if cfg.kill9_steps_seen < cfg.kill9_at_decode_step:
            return
        cfg.kill9_at_decode_step = None
        _count_injection("kill9_decode")
    log.warning("chaos: killing this process inside decode step %d "
                "(kill9_at_decode_step fired)", cfg.kill9_steps_seen)
    _telemetry.flush()   # the injection count must outlive the process
    os._exit(137)


def storm_restart():
    """Raise :class:`ChaosCrash` (classified transient — a guaranteed
    engine restart) once per serving decode step while the
    ``restart_storm`` budget lasts: K back-to-back restarts, the
    compounding shape the prefill-replay recovery path must keep flat.
    Decrementing budget like ``reject_storm``; the (K+1)th decode step
    runs clean so the storm drains."""
    cfg = _config
    if cfg is None or not cfg.restart_storm:
        return
    with cfg.lock:
        if cfg.storms_left <= 0:
            return
        cfg.storms_left -= 1
        cfg.storms_fired += 1
        _count_injection("restart_storm")
        n = cfg.storms_fired
    raise ChaosCrash(
        f"chaos: restart_storm fired ({n}/{cfg.restart_storm}) — "
        f"classified engine restart, every stream must replay in "
        f"one prefill")


def forced_reject():
    """True when the ``reject_storm`` fault says this admission must be
    rejected (the scheduler checks it before its real admission logic and
    rejects with reason ``"reject_storm"``).  Decrements the storm budget;
    returns False once exhausted so resubmitted requests get through."""
    cfg = _config
    if cfg is None or not cfg.reject_storm:
        return False
    with cfg.lock:
        if cfg.rejects_left > 0:
            cfg.rejects_left -= 1
            cfg.rejects_forced += 1
            _count_injection("reject_storm")
            return True
    return False


def maybe_flaky_recompute():
    """True when the ``flaky_recompute`` budget says this shadow
    re-execution must come back with other bits (the audit of
    ``parallel/integrity.py`` and the serving decode self-check call this
    on every re-execution).  The program is deterministic, so only a
    faulty chip makes two runs disagree: this simulates one.  A
    decrementing budget, as ``reject_storm``'s."""
    cfg = configure_from_env()
    if cfg is None or not cfg.flaky_recompute:
        return False
    with cfg.lock:
        if cfg.flaky_left > 0:
            cfg.flaky_left -= 1
            cfg.flaky_fired += 1
            _count_injection("flaky_recompute")
            return True
    return False
