"""Deterministic fault injection, from ``tpu_mx/contrib/chaos.py``.

Seedable injection points that make the recovery paths run, not
assumed — armed by tests with :func:`enable` or, for a whole process, by
the ``TPUMX_CHAOS`` environment variable (comma/space-separated
``knob=value`` pairs, the reference's knob names; parsed once, at the
first durability-layer operation or supervised run)::

    TPUMX_CHAOS="crash_at_step=6,hard=1,seed=0" python train.py

Every fault that fires is counted in ``chaos.injections{kind}`` and
emitted as a ``chaos.inject`` event.  The knobs:

- files (``checkpoint.atomic_write``; ``match=SUBSTR`` scopes them to
  paths holding SUBSTR): ``crash_after_bytes=N`` — the Nth byte written
  raises :class:`ChaosCrash` (``os._exit(137)`` with ``hard=1``),
  one-shot; ``torn_write=N`` — only the first N bytes reach the file but
  the write reports success; ``slow_io=S`` — each write sleeps a seeded
  [0, S) seconds; ``transient_oserror=K`` — the next K checked
  operations raise ``OSError`` (``checkpoint.retry``'s backoff);
- the barrier: ``kill_peer=1`` — ``elastic.barrier`` sees a dead peer;
- the supervised training step: ``nan_after=N`` (with ``nan_streak=K``)
  — the Nth observed loss comes back NaN (:func:`poison_loss`);
  ``hang_step=N`` — the Nth supervised step blocks ``hang_seconds``
  inside the watchdog thread, one-shot; ``crash_at_step=N`` — a crash
  right after the Nth supervised step commits (its capsule written),
  ``os._exit(137)`` with ``hard=1``, one-shot;
- the train step's training sites (``parallel/train_step.py``):
  ``slow_worker_rank=R``/``slow_worker_seconds=S`` — rank R sleeps S
  seconds in every step's ``data_wait`` phase; ``bitflip_grad_rank=R``,
  or ``bitflip_param_at_step=N`` with ``bitflip_rank=R`` — one seeded
  mantissa bit of rank R's committed parameters flips
  (:func:`maybe_bitflip`), one-shot;
- fleet knobs: ``preempt_worker_at_step=N``/``preempt_rank=R`` — a real
  SIGTERM at the Nth step of a fleet member (:func:`maybe_preempt`);
  ``partition_worker=K`` — :func:`partitioned` is true for member K;
- serving: ``slow_decode_step=N`` (``slow_decode_seconds``),
  ``kill9_at_decode_step=N``, ``restart_storm=K``, ``reject_storm=K``;
- ``flaky_recompute=K`` — the next K shadow re-executions of a step
  (``parallel/integrity.py``'s ``ShadowAuditor``, the serving decode
  self-check) come back with one bit flipped.

A rank the call does not name comes from ``TPUMX_FLEET_MEMBER``.
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
           "wrap_file", "maybe_oserror", "peer_killed", "poison_loss",
           "maybe_hang", "maybe_crash_step", "maybe_slow_decode",
           "maybe_kill9_decode", "storm_restart",
           "forced_reject", "maybe_preempt", "partitioned",
           "maybe_slow_worker", "maybe_bitflip", "maybe_flaky_recompute"]


def _count_injection(kind):
    """A fired fault lands in ``chaos.injections{kind}`` and on the
    flight-recorder timeline with the live trace context, so the
    injection and the recovery it provokes correlate in the black box."""
    _telemetry.counter("chaos.injections", kind=kind).inc()
    _tracing.emit("chaos.inject", kind=kind)

log = logging.getLogger(__name__)


class ChaosCrash(Exception):
    """Simulated process death mid-write (soft mode).

    Deliberately NOT an OSError: ``checkpoint.retry`` must never swallow a
    crash — a real kill would not be retried either.  ``atomic_write``
    recognizes it and leaves the partial tmp file on disk, exactly the
    debris a real crash leaves behind."""


class _Config:
    _KINDS = ("crash_after_bytes", "torn_write", "slow_io",
              "transient_oserror", "kill_peer", "nan_after", "nan_streak",
              "hang_step", "hang_seconds", "crash_at_step",
              "slow_decode_step", "slow_decode_seconds", "reject_storm",
              "kill9_at_decode_step", "restart_storm",
              "preempt_worker_at_step", "preempt_rank", "partition_worker",
              "slow_worker_rank", "slow_worker_seconds",
              "bitflip_grad_rank", "bitflip_param_at_step", "bitflip_rank",
              "flaky_recompute",
              "seed", "hard", "match")

    def __init__(self, crash_after_bytes=None, torn_write=None, slow_io=None,
                 transient_oserror=0, kill_peer=False, nan_after=None,
                 nan_streak=1, hang_step=None, hang_seconds=3600.0,
                 crash_at_step=None, slow_decode_step=None,
                 slow_decode_seconds=3600.0, reject_storm=0,
                 kill9_at_decode_step=None, restart_storm=0,
                 preempt_worker_at_step=None, preempt_rank=0,
                 partition_worker=None, slow_worker_rank=None,
                 slow_worker_seconds=1.0, bitflip_grad_rank=None,
                 bitflip_param_at_step=None, bitflip_rank=0,
                 flaky_recompute=0, seed=None,
                 hard=False, match=None):
        if seed is None:
            seed = int(os.environ.get("TPUMX_CHAOS_SEED", "0"))
        self.crash_after_bytes = crash_after_bytes
        self.torn_write = torn_write
        self.slow_io = slow_io
        self.transient_oserror = int(transient_oserror)
        self.kill_peer = bool(kill_peer)
        self.nan_after = None if nan_after is None else int(nan_after)
        self.nan_streak = max(1, int(nan_streak))
        self.hang_step = None if hang_step is None else int(hang_step)
        self.hang_seconds = float(hang_seconds)
        self.crash_at_step = None if crash_at_step is None \
            else int(crash_at_step)
        self.slow_decode_step = None if slow_decode_step is None \
            else int(slow_decode_step)
        self.slow_decode_seconds = float(slow_decode_seconds)
        self.reject_storm = int(reject_storm)
        self.kill9_at_decode_step = None if kill9_at_decode_step is None \
            else int(kill9_at_decode_step)
        self.restart_storm = int(restart_storm)
        self.preempt_worker_at_step = None if preempt_worker_at_step is None \
            else int(preempt_worker_at_step)
        self.preempt_rank = int(preempt_rank)
        self.partition_worker = None if partition_worker is None \
            else int(partition_worker)
        self.slow_worker_rank = None if slow_worker_rank is None \
            else int(slow_worker_rank)
        self.slow_worker_seconds = float(slow_worker_seconds)
        self.bitflip_grad_rank = None if bitflip_grad_rank is None \
            else int(bitflip_grad_rank)
        self.bitflip_param_at_step = None if bitflip_param_at_step is None \
            else int(bitflip_param_at_step)
        self.bitflip_rank = int(bitflip_rank)
        self.flaky_recompute = int(flaky_recompute)
        self.seed = seed
        self.hard = bool(hard)
        self.match = match
        self.rng = random.Random(seed)
        self.lock = threading.Lock()
        # mutable counters (under lock)
        self.bytes_written = 0       # cumulative across matched writes
        self.oserrors_left = self.transient_oserror
        self.crashes = 0             # how many times a fault actually fired
        self.tears = 0
        self.oserrors_fired = 0
        self.losses_seen = 0         # losses observed while nan_after armed
        self.steps_seen = 0          # steps observed while hang_step armed
        self.commits_seen = 0        # committed steps while crash_at_step armed
        self.nans_fired = 0
        self.hangs = 0
        self.step_crashes = 0
        self.decode_steps_seen = 0   # decode steps while slow_decode armed
        self.slow_decodes = 0
        self.kill9_steps_seen = 0    # decode steps while kill9 armed
        self.storms_left = self.restart_storm
        self.storms_fired = 0        # back-to-back restarts provoked
        self.rejects_left = self.reject_storm
        self.rejects_forced = 0
        self.fleet_steps_seen = 0    # fleet steps while preempt armed
        self.preempts = 0
        self.partitions = 0          # heartbeats suppressed by partition
        self.slow_worker_fires = 0   # per-step straggler delays injected
        self.bitflip_commits_seen = 0  # commits while bitflip_param armed
        self.bitflips = 0            # parameter bits actually flipped
        self.flaky_left = self.flaky_recompute
        self.flaky_fired = 0         # shadow recomputes perturbed

    def matches(self, path):
        return self.match is None or (path is not None
                                      and self.match in str(path))

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

    Called lazily by the first durability-layer operation; a programmatic
    `enable()` always wins over the env, and the env is parsed at most
    once per process."""
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
        elif key in ("slow_io", "hang_seconds", "slow_decode_seconds",
                     "slow_worker_seconds"):
            kwargs[key] = float(val)
        elif key in ("kill_peer", "hard"):
            kwargs[key] = val in ("", "1", "true", "yes", "on")
        else:
            kwargs[key] = int(val)
    _config = _Config(**kwargs)
    log.warning("chaos armed from TPUMX_CHAOS: %r", _config)
    return _config


# ---------------------------------------------------------------------------
# injection points (called by checkpoint.py and elastic.py)
# ---------------------------------------------------------------------------
class _ChaosFile:
    """File proxy that applies byte-level faults to .write().

    Wraps the *real* (innermost) file object: the durability layer's
    sha256-of-intended-bytes accounting sits above this wrapper, so a torn
    write records the digest the caller *meant* — which is exactly what
    lets manifest verification flag the tear."""

    def __init__(self, f, cfg, path):
        self._f = f
        self._cfg = cfg
        self._path = path

    def _partial(self, data, allowed):
        """First `allowed` BYTES of `data`, in the underlying file's type.
        Text mode: slice the utf-8 encoding so the fault boundary is a true
        byte offset even for multi-byte characters (a split character's
        partial bytes are dropped — the nearest char boundary at-or-before
        the cut, deterministic for a given payload)."""
        if isinstance(data, str):
            return data.encode("utf-8")[:allowed].decode("utf-8", "ignore")
        return data[:allowed]

    def write(self, data):
        cfg = self._cfg
        if isinstance(data, str):
            nbytes = len(data.encode("utf-8"))
        else:
            nbytes = memoryview(data).nbytes
        with cfg.lock:
            if cfg.slow_io:
                _count_injection("slow_io")
                time.sleep(cfg.rng.uniform(0.0, float(cfg.slow_io)))
            start = cfg.bytes_written
            if (cfg.crash_after_bytes is not None
                    and start + nbytes >= cfg.crash_after_bytes):
                allowed = max(0, cfg.crash_after_bytes - start)
                self._f.write(self._partial(data, allowed))
                self._f.flush()
                cfg.bytes_written += allowed
                cfg.crash_after_bytes = None  # one-shot: recovery may save
                cfg.crashes += 1
                _count_injection("crash")
                if cfg.hard:  # pragma: no cover - exercised via subprocess
                    os._exit(137)
                raise ChaosCrash(
                    f"chaos: simulated crash after {cfg.bytes_written} bytes "
                    f"into {self._path}")
            if cfg.torn_write is not None:
                allowed = max(0, cfg.torn_write - start)
                if allowed < nbytes:
                    cfg.tears += 1
                    _count_injection("torn_write")
                self._f.write(self._partial(data, allowed))
                # the caller is told the whole write landed — that is the tear
                cfg.bytes_written += nbytes
                return len(data)
            cfg.bytes_written += nbytes
        self._f.write(data)
        return len(data)

    def __getattr__(self, name):  # flush/fileno/close/seek/tell/...
        return getattr(self._f, name)


def wrap_file(f, path=None):
    """Wrap a writable file object with the active byte-level faults.

    Returns `f` unchanged when chaos is off, no byte-level fault is armed,
    or `path` does not match the config's ``match`` filter."""
    cfg = _config
    if cfg is None or not cfg.matches(path):
        return f
    if (cfg.crash_after_bytes is None and cfg.torn_write is None
            and not cfg.slow_io):
        return f
    return _ChaosFile(f, cfg, path)


def maybe_oserror(op="io", path=None):
    """Raise a transient OSError if the fault budget says so (else no-op)."""
    cfg = _config
    if cfg is None or not cfg.matches(path):
        return
    with cfg.lock:
        if cfg.oserrors_left > 0:
            cfg.oserrors_left -= 1
            cfg.oserrors_fired += 1
            _count_injection("transient_oserror")
            raise OSError(
                f"chaos: transient {op} failure on {path or '<fs>'} "
                f"({cfg.oserrors_left} more armed)")


def peer_killed():
    """True when `kill_peer` chaos is armed (elastic.barrier checks this)."""
    cfg = _config
    if cfg is not None and cfg.kill_peer:
        _count_injection("kill_peer")
        return True
    return False


def poison_loss(value):
    """Return `value`, or NaN when the ``nan_after`` fault says this loss is
    poisoned (the supervisor's numeric sentinel routes every observed loss
    through here).  Counting starts when the fault is armed: the Nth loss
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


def maybe_crash_step():
    """Raise :class:`ChaosCrash` after the Nth supervised step COMMITS —
    the supervisor calls this right after a step's update and its capsule
    write have both landed (``crash_at_step``).  Counting starts when the
    fault is armed; one-shot, so the recovered run completes.  With
    ``hard=1`` it is ``os._exit(137)`` — a true mid-epoch process death
    for the cross-process deterministic-resume proof."""
    cfg = _config
    if cfg is None or cfg.crash_at_step is None:
        return
    with cfg.lock:
        if cfg.crash_at_step is None:
            return
        cfg.commits_seen += 1
        if cfg.commits_seen < cfg.crash_at_step:
            return
        cfg.crash_at_step = None  # one-shot: the resumed run finishes
        cfg.step_crashes += 1
        _count_injection("crash_step")
        if cfg.hard:  # pragma: no cover - exercised via subprocess
            os._exit(137)
    raise ChaosCrash(
        "chaos: simulated process death after supervised step "
        f"{cfg.commits_seen} committed (crash_at_step fired) — resume "
        "must continue at the NEXT batch with the exact RNG stream")


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
    os._exit(137)  # pragma: no cover - exercised via subprocess


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


def maybe_hang():
    """Block for ``hang_seconds`` when the ``hang_step`` fault says this is
    the hung step (the supervisor calls this at the top of every supervised
    step, INSIDE the watchdog thread — the sleep simulates a stalled
    collective/compile the hung-step watchdog must convert into a
    ``WorkerFailure``).  One-shot; counting starts when armed."""
    cfg = _config
    if cfg is None or cfg.hang_step is None:
        return
    secs = None
    with cfg.lock:
        if cfg.hang_step is None:
            return
        cfg.steps_seen += 1
        if cfg.steps_seen >= cfg.hang_step:
            cfg.hang_step = None  # one-shot: the retried step runs clean
            cfg.hangs += 1
            _count_injection("hang")
            secs = cfg.hang_seconds
    if secs:
        log.warning("chaos: hanging this step for %.0fs (hang_step fired)",
                    secs)
        time.sleep(secs)


def maybe_preempt(rank):
    """SIGTERM this process when ``preempt_worker_at_step`` says the Nth
    fleet step has arrived and `rank` matches ``preempt_rank`` (the fleet
    runtime calls this at every step boundary with the worker's member
    rank).  A REAL signal, not an exception: the existing SIGTERM
    emergency-save path runs, the process dies, and the fleet supervisor
    must detect the loss, reshard the survivors, and restart the worker.
    Counting starts when armed; steps are counted only on the matching
    rank so ``preempt_worker_at_step=N`` means "rank ``preempt_rank``'s
    Nth step", whichever processes share the config.  One-shot."""
    cfg = configure_from_env()  # fleet workers may have no supervisor
    if cfg is None or cfg.preempt_worker_at_step is None:
        return
    with cfg.lock:
        if cfg.preempt_worker_at_step is None:
            return
        if rank is None or int(rank) != cfg.preempt_rank:
            return
        cfg.fleet_steps_seen += 1
        if cfg.fleet_steps_seen < cfg.preempt_worker_at_step:
            return
        cfg.preempt_worker_at_step = None  # one-shot: the restart survives
        cfg.preempts += 1
        _count_injection("preempt_worker")
    import signal
    log.warning("chaos: preempting rank %s at fleet step %d "
                "(preempt_worker_at_step fired)", rank, cfg.fleet_steps_seen)
    os.kill(os.getpid(), signal.SIGTERM)


def maybe_slow_worker(rank=None):
    """Sleep ``slow_worker_seconds`` when ``slow_worker_rank`` says this
    process is the injected straggler (the train step calls
    this at the top of every step, INSIDE its ``data_wait`` phase
    window — the delay lands in a measured phase so cross-rank
    attribution can name both the rank
    and the phase).  Deterministic and NOT one-shot: the windowed
    persistent-straggler detector keys on the delay repeating.  `rank`
    defaults to the ``TPUMX_FLEET_MEMBER`` env rank — fleet workers
    know their member slot before any Fleet object exists."""
    cfg = configure_from_env()  # fleet workers may have no supervisor
    if cfg is None or cfg.slow_worker_rank is None:
        return
    if rank is None:
        rank = os.environ.get("TPUMX_FLEET_MEMBER")
    if rank is None or int(rank) != cfg.slow_worker_rank:
        return
    with cfg.lock:
        if cfg.slow_worker_rank is None:
            return
        cfg.slow_worker_fires += 1
        _count_injection("slow_worker")
        secs = cfg.slow_worker_seconds
    time.sleep(secs)


def maybe_bitflip(rank=None):
    """Return the mantissa bit (0–22) to flip in this rank's parameter
    tree, or None.  The train step calls this right after each
    step COMMITS; a non-None return means one of the SDC knobs fired:

    - ``bitflip_grad_rank=R``: rank R's next committed update is
      corrupted (one-shot) — the flip lands immediately after the
      post-sync state the replicas are supposed to agree on, so the
      cross-replica fingerprint vote must name rank R.
    - ``bitflip_param_at_step=N`` (+ ``bitflip_rank``, default 0): the
      scheduled variant — fires after the matching rank's Nth committed
      step since arming (one-shot).

    The bit index is drawn from the seeded chaos RNG so a red run
    reproduces; `rank` defaults to the ``TPUMX_FLEET_MEMBER`` env rank
    like :func:`maybe_slow_worker`."""
    cfg = configure_from_env()  # fleet workers may have no supervisor
    if cfg is None or (cfg.bitflip_grad_rank is None
                       and cfg.bitflip_param_at_step is None):
        return None
    if rank is None:
        rank = os.environ.get("TPUMX_FLEET_MEMBER", 0)
    rank = int(rank)
    with cfg.lock:
        if cfg.bitflip_grad_rank is not None \
                and rank == cfg.bitflip_grad_rank:
            cfg.bitflip_grad_rank = None  # one-shot
            cfg.bitflips += 1
            _count_injection("bitflip_grad")
            return cfg.rng.randrange(23)
        if cfg.bitflip_param_at_step is not None \
                and rank == cfg.bitflip_rank:
            cfg.bitflip_commits_seen += 1
            if cfg.bitflip_commits_seen >= cfg.bitflip_param_at_step:
                cfg.bitflip_param_at_step = None  # one-shot
                cfg.bitflips += 1
                _count_injection("bitflip_param")
                return cfg.rng.randrange(23)
    return None


def maybe_flaky_recompute():
    """True when the ``flaky_recompute`` budget says this shadow
    recompute must come back with different bits (the sampled audit in
    parallel/integrity.py — and the serving decode self-check —
    call this on every recompute).  Flaky hardware by construction: the
    program is deterministic, so only a faulty chip can make two runs
    disagree, and that is exactly what the caller simulates when this
    returns True.  Decrementing budget like ``reject_storm``."""
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


def partitioned(rank):
    """True when the ``partition_worker`` fault says member `rank` is
    network-partitioned: the fleet runtime suppresses its heartbeat writes
    (the process stays alive — that is the point: lease expiry, not exit
    codes, must evict it).  Counted in ``injections{kind=partition_worker}``
    once, on the first suppressed beat; stays armed until the config is
    torn down so the zombie keeps missing beats."""
    cfg = configure_from_env()  # fleet workers may have no supervisor
    if cfg is None or cfg.partition_worker is None:
        return False
    if rank is None or int(rank) != cfg.partition_worker:
        return False
    with cfg.lock:
        if cfg.partition_worker is None:
            return False
        cfg.partitions += 1
        if cfg.partitions == 1:
            _count_injection("partition_worker")
    return True
