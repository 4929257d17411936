"""Flight recorder: step-scoped structured events and the crash black box.

A copy of ``tpu_mx/tracing.py`` (stdlib only at module level, so copied
rather than imported — importing ``tpu_mx`` would import jax):

- **Events** — :func:`emit` appends one record to a bounded ring buffer
  (:func:`snapshot` reads it back, :func:`stats` counts what overflow
  dropped).  Every event carries the process-wide trace context
  (:func:`set_context`: ``run_id``, ``epoch``, ``step``, ``generation``,
  ``request``) — process-global, not thread-local, so an event emitted
  on a watchdog thread still carries the step that hung — and a payload
  whose fields are declared, with their types, in :data:`KNOWN_EVENTS`
  (the reference's names and fields: the serving and supervisor events).
  An undeclared name or field raises at the call.
- **Black box** — :func:`dump_blackbox` persists the last events, a
  telemetry snapshot, the live context and an environment fingerprint
  (torch, CUDA, the card, ``nvcc``) as ``<prefix>-blackbox.json``
  through ``checkpoint.atomic_write``, in the reference's format
  (:data:`BLACKBOX_FORMAT`): the reference's ``validate_blackbox``
  accepts the port's boxes and :func:`validate_blackbox` the
  reference's.

- **Chrome trace** — while :mod:`~tpu_mx_torch.profiler` records, every
  event is mirrored into it through ``profiler.record_span`` (an
  interval when ``t0``/``t1`` are passed, a zero-length mark
  otherwise), named by the event and its categorical field
  (``train_step.phase:dispatch``), so the timeline sits beside the
  card's kernels in one trace.

``TPUMX_TRACING=0`` turns emission off.
"""
from __future__ import annotations

import functools
import json
import math
import os
import socket
import sys
import threading
import time
from collections import deque

__all__ = ["KNOWN_EVENTS", "BLACKBOX_FORMAT", "TRAIN_STEP_PHASES",
           "enabled", "configure", "emit", "set_context", "get_context",
           "snapshot", "stats", "reset", "validate_event",
           "blackbox_doc", "dump_blackbox", "blackbox_path",
           "validate_blackbox"]

BLACKBOX_FORMAT = "tpu_mx-blackbox-v1"

# The event-name catalog: name -> {payload field: type name}.  Payload
# fields are optional but typed; undeclared fields are rejected at emit.
KNOWN_EVENTS = {
    # the train step (parallel/train_step.py): its host-side phases, the
    # values of TRAIN_STEP_PHASES
    "train_step.phase": {"phase": "str", "seconds": "float"},
    # the durability layer (checkpoint.py, elastic.py)
    "checkpoint.save": {"prefix": "str", "epoch": "int", "seconds": "float"},
    "checkpoint.verify": {"prefix": "str", "epoch": "int", "status": "str"},
    "checkpoint.retry": {"attempt": "int", "error": "str"},
    "checkpoint.preemption": {"signum": "int", "save_ok": "bool"},
    "elastic.resume": {"resume_from": "int"},
    "elastic.epoch_skipped": {"epoch": "int", "reason": "str"},
    # self-healing (supervisor.py, serving/server.py): every watchdog
    # fire, sentinel skip, classification, recovery decision and black box
    "supervisor.watchdog_fire": {"name": "str", "deadline_seconds": "float"},
    "supervisor.sentinel_skip": {"loss": "float", "consecutive_bad": "int"},
    "supervisor.classify": {"kind": "str", "error": "str", "message": "str"},
    "supervisor.restart": {"n": "int", "backoff_seconds": "float",
                           "resume_epoch": "int"},
    "supervisor.rollback": {"n": "int", "resume_epoch": "int"},
    "supervisor.degrade": {"budget": "str", "error": "str"},
    "supervisor.blackbox": {"path": "str", "reason": "str"},
    # deterministic-resume capsules (resume.py)
    "resume.capsule_write": {"kind": "str", "epoch": "int", "step": "int"},
    "resume.capsule_restore": {"used": "str", "epoch": "int", "step": "int",
                               "gap": "int"},
    # fault injection (contrib/chaos.py): the injection and the recovery
    # it provokes share one timeline
    "chaos.inject": {"kind": "str"},
    # the serving request lifecycle (serving/).  admit/prefill/evict/
    # reject are stamped with the `request` context field around
    # per-request work; decode is batch-scoped and rides `step` and
    # `generation`.  `recovered`: the admission is a journal recovery.
    "serve.admit": {"request": "str", "prompt_tokens": "int",
                    "max_new_tokens": "int", "tenant": "str",
                    "recovered": "bool"},
    "serve.reject": {"request": "str", "reason": "str"},
    # `cached`: leading prompt tokens served from the shared-prefix
    # index; `replayed`: committed generated tokens this prefill
    # replayed (a restart, handoff or recover() in one prefill)
    "serve.prefill": {"request": "str", "tokens": "int", "seconds": "float",
                      "cached": "int", "replayed": "int"},
    "serve.decode": {"batch": "int", "tokens": "int", "seconds": "float"},
    "serve.evict": {"request": "str", "reason": "str", "generated": "int"},
    "serve.restart": {"n": "int", "reason": "str", "requeued": "int"},
    # once per engine (so once per generation): the decode arm, where
    # the pool lives, sharing, whether the step is one device program,
    # the speculative window and greedy/sampled decoding
    "serve.decode_path": {"path": "str", "storage": "str",
                          "sharing": "bool", "fused": "bool",
                          "spec_window": "int", "sampling": "str"},
    # an admission-stopping transition: kind=drain (quiesce to idle),
    # handoff (live sessions to a fresh generation, no restart budget
    # spent) or degrade (budget exhausted: queued work failed, the
    # running batch drained on one final generation)
    "serve.drain": {"kind": "str", "inflight": "int", "pending": "int"},
    # one shared-prefix pressure-relief pass
    "serve.prefix_evict": {"released": "int", "need": "int"},
    # a genuine CacheExhausted; `forensic` names the rolling
    # <prefix>-capacity.json record set ("" when unarmed)
    "serve.capacity_exhausted": {"need": "int", "free": "int",
                                 "holders": "int", "forensic": "str"},
    # per-request latency attribution (serving/timeline.py), once per
    # request at its end: the phase fields sum to the latency
    "serve.request_timeline": {
        "request": "str", "outcome": "str", "latency": "float",
        "ttft": "float", "queue_wait": "float", "prefill": "float",
        "decode_gap": "float", "restart_penalty": "float",
        "defer_stall": "float", "reject": "float",
        "tokens": "int", "requeues": "int", "defers": "int",
        "tenant": "str", "cached_tokens": "int"},
    # the corruption defense (parallel/integrity.py, supervisor.py): a
    # published cross-replica digest, one cohort vote (agree=False is the
    # verdict; `minority` the comma-joined voted-out ranks, "" for a
    # tie), the permanent eviction of a corrupt rank, one sampled
    # bit-exact re-execution of a step (surface=train|decode), and the
    # survivors' rollback to the last fingerprint-verified step
    "integrity.fingerprint": {"step": "int", "fp": "int", "rank": "int"},
    "integrity.vote": {"step": "int", "agree": "bool",
                       "majority_fp": "int", "minority": "str",
                       "world_size": "int"},
    "integrity.quarantine": {"rank": "int", "reason": "str",
                             "step": "int"},
    "integrity.shadow_audit": {"step": "int", "match": "bool",
                               "surface": "str"},
    "integrity.rollback": {"step": "int", "verified_step": "int",
                           "resume_epoch": "int"},
    # the fusion engine (fusion.py): one event per executed flush
    "fusion.flush": {"cause": "str", "ops": "int"},
    # kvstore payload integrity (kvstore.py): a pulled aggregate failed
    # its push-time checksum
    "kvstore.checksum_fail": {"key": "str"},
    # elastic fleet membership (parallel/fleet.py, tools/launch.py
    # --supervise): `fleet.epoch` records a generation advance (who is in
    # the world and why); join/leave/lost/rejoin are the per-member
    # lifecycle; `fleet.reshard` a world-size transition through the
    # load_state_dict seam (source=manifest after a fault, source=live
    # for a planned change); restart_worker/degrade are the launcher's
    # restart-budget decisions.  The fleet generation is a payload field;
    # the context's `generation` stays the supervisor's restore count.
    "fleet.epoch": {"generation": "int", "world_size": "int",
                    "reason": "str"},
    "fleet.join": {"member": "int", "generation": "int"},
    "fleet.leave": {"member": "int", "generation": "int", "reason": "str"},
    "fleet.lost": {"member": "int", "age_seconds": "float"},
    "fleet.rejoin": {"member": "int", "generation": "int"},
    "fleet.reshard": {"generation": "int", "from_world": "int",
                      "to_world": "int", "source": "str"},
    "fleet.restart_worker": {"member": "int", "n": "int",
                             "backoff_seconds": "float"},
    "fleet.degrade": {"world_size": "int", "reason": "str"},
    # the persistent-straggler detector's state flip (parallel/
    # fleet_obs.py): `rank` the straggler (-1: all clear), its mean
    # per-step excess over the fastest rank, the dominant slow phase and
    # the correlated steps the window judged
    "fleet.straggler": {"rank": "int", "excess_seconds": "float",
                        "phase": "str", "steps": "int"},
    # SLO breach transitions (serving/slo.py)
    "serve.slo": {"slo": "str", "breaching": "bool", "burn_rate": "float",
                  "estimate_seconds": "float", "attainment": "float",
                  "threshold_seconds": "float"},
}

_TYPES = {"str": str, "int": int, "float": (int, float), "bool": bool}

# the values of train_step.phase's `phase` field, the host-side stations
# of a step: on the port `dispatch` is the eager forward and backward
# enqueue and `optimizer_update` the update loop (parallel/train_step.py)
TRAIN_STEP_PHASES = ("data_wait", "recompile", "dispatch", "loss_readback",
                     "optimizer_update")

# reentrant: an emit may run inside another's dump (a black box emits
# its own record), and the SIGTERM preemption handler
# (checkpoint.PreemptionHandler) emits and dumps between two bytecodes of
# a frame that may itself be inside emit()
_lock = threading.RLock()
_DEFAULT_CAPACITY = 512
_ring: deque = deque(maxlen=_DEFAULT_CAPACITY)
_emitted = 0
_dropped = 0
_enabled = os.environ.get("TPUMX_TRACING", "1") != "0"

# the process-wide trace context every event is stamped with; run_id is
# an identifier, not a seed
_context = {
    "run_id": "%s-%d-%d" % (socket.gethostname(), os.getpid(),
                            int(time.time())),
    "epoch": None,
    "step": None,
    "generation": 0,
    "request": None,
    # fleet identity: this process's fleet rank and the membership
    # generation it adopted, stamped by parallel/fleet.py (None outside a
    # fleet).  `fleet_generation` is the membership epoch; `generation`
    # stays the supervisor's restore count.  parallel/fleet_obs.py
    # correlates ranks' events on (epoch, step, fleet_generation).
    "rank": None,
    "fleet_generation": None,
}


def enabled():
    """Whether emit() records anything (``TPUMX_TRACING=0`` disables)."""
    return _enabled


def configure(enabled=None, capacity=None):
    """Adjust the recorder: ``enabled`` toggles emission, ``capacity``
    re-sizes the ring (keeping the newest events).  Returns the live
    ``(enabled, capacity)`` pair."""
    global _enabled, _ring
    with _lock:
        if enabled is not None:
            _enabled = bool(enabled)
        if capacity is not None:
            capacity = int(capacity)
            if capacity < 1:
                raise ValueError("tracing capacity must be >= 1")
            _ring = deque(_ring, maxlen=capacity)
        return _enabled, _ring.maxlen


def set_context(**fields):
    """Update the process-wide trace context (``run_id``, ``epoch``,
    ``step``, ``generation``, ``request``).  The training loop owns the
    first four: the supervisor stamps epoch/step/generation around every
    supervised step; the serving engine stamps step/generation per engine
    step and ``request`` around per-request work.  Every event emitted
    anywhere in the process — including on the watchdog daemon thread —
    carries the values current at emit time."""
    unknown = set(fields) - set(_context)
    if unknown:
        raise ValueError(f"unknown trace-context field(s) {sorted(unknown)} "
                         f"(have: {sorted(_context)})")
    with _lock:
        _context.update(fields)


def get_context():
    """A copy of the live trace context."""
    with _lock:
        return dict(_context)


# non-finite floats are encoded as these strings: strict JSON has no
# NaN/Infinity token, and a black box MUST parse in jq/browsers/any
# spec-compliant reader — a NaN loss is exactly what a divergence box
# records, so the encoding is part of the schema, not an edge case
_NONFINITE = {"nan": float("nan"), "inf": float("inf"),
              "-inf": float("-inf")}


def _check_payload(event, payload, normalize=False):
    """Shared by emit() and validate_event(): every payload field must be
    declared for `event` in :data:`KNOWN_EVENTS` with a matching type.
    ``normalize=True`` (the emit path) additionally rewrites non-finite
    floats to their string encoding so every ring record is strict-JSON
    safe; the validate path accepts either spelling."""
    decl = KNOWN_EVENTS.get(event)
    if decl is None:
        raise ValueError(f"unknown event name {event!r} — not in "
                         "tracing.KNOWN_EVENTS (stable event names are an "
                         "API; register new events in the catalog + "
                         "docs/observability.md)")
    for k, v in payload.items():
        if k not in decl:
            raise ValueError(f"{event}: undeclared payload field {k!r} "
                             f"(declared: {sorted(decl)})")
        want = _TYPES[decl[k]]
        if decl[k] == "float" and isinstance(v, str) and v in _NONFINITE:
            continue  # the strict-JSON encoding of a non-finite float
        if not isinstance(v, want) or (decl[k] != "bool"
                                       and isinstance(v, bool)):
            raise ValueError(f"{event}: payload field {k!r} must be "
                             f"{decl[k]}, got {type(v).__name__} {v!r}")
        if normalize and decl[k] == "float" \
                and not math.isfinite(float(v)):
            payload[k] = "nan" if v != v else ("inf" if v > 0 else "-inf")
    return payload


def validate_event(rec):
    """Raise ValueError unless `rec` is a schema-valid event record:
    a known ``event`` name, numeric ``ts``, the four context fields
    (``run_id`` str; ``epoch``/``step`` int or None; ``generation``
    int), and a ``data`` payload whose fields are declared — with the
    declared types — in :data:`KNOWN_EVENTS` (non-finite floats appear
    as their string encodings ``"nan"``/``"inf"``/``"-inf"``)."""
    if not isinstance(rec, dict):
        raise ValueError(f"event is {type(rec).__name__}, not an object")
    name = rec.get("event")
    if name not in KNOWN_EVENTS:
        raise ValueError(f"unknown event name {name!r} — not in "
                         "tracing.KNOWN_EVENTS (stable event names are an "
                         "API; register new events in the catalog + "
                         "docs/observability.md)")
    if not isinstance(rec.get("ts"), (int, float)) \
            or isinstance(rec.get("ts"), bool):
        raise ValueError(f"{name}: missing numeric 'ts'")
    if not isinstance(rec.get("run_id"), str) or not rec.get("run_id"):
        raise ValueError(f"{name}: missing 'run_id'")
    for field in ("epoch", "step"):
        v = rec.get(field, "missing")
        if v is not None and (not isinstance(v, int) or isinstance(v, bool)):
            raise ValueError(f"{name}: {field!r} must be int or None, "
                             f"got {v!r}")
    if not isinstance(rec.get("generation"), int) \
            or isinstance(rec.get("generation"), bool):
        raise ValueError(f"{name}: missing int 'generation'")
    # `request` joined the context with the serving runtime; events
    # recorded by older builds simply lack the key (still valid)
    req = rec.get("request")
    if req is not None and not isinstance(req, str):
        raise ValueError(f"{name}: 'request' must be str or None, "
                         f"got {req!r}")
    # `rank`/`fleet_generation` are the reference's fleet stamps; a box
    # without them is valid
    for field in ("rank", "fleet_generation"):
        v = rec.get(field)
        if v is not None and (not isinstance(v, int)
                              or isinstance(v, bool)):
            raise ValueError(f"{name}: {field!r} must be int or None, "
                             f"got {v!r}")
    data = rec.get("data")
    if not isinstance(data, dict):
        raise ValueError(f"{name}: missing 'data' payload object")
    _check_payload(name, data)
    return rec


def emit(event, t0=None, t1=None, **payload):
    """Record one event into the ring buffer (no-op when disabled).

    ``payload`` fields must be declared in :data:`KNOWN_EVENTS` with
    matching types — a typo'd field or name raises immediately.
    ``t0``/``t1`` (``time.perf_counter`` endpoints) add the interval as
    ``seconds`` where the event declares it, and are the span the
    profiler records while it runs (a mark without them).  Returns the
    record (None when disabled)."""
    global _emitted, _dropped
    if not _enabled:
        return None
    decl = KNOWN_EVENTS.get(event)
    if t0 is not None and t1 is not None and decl and "seconds" in decl:
        payload.setdefault("seconds", t1 - t0)
    _check_payload(event, payload, normalize=True)
    rec = {"event": event, "ts": time.time(), "data": payload}
    with _lock:
        rec.update(_context)
        if len(_ring) == _ring.maxlen:
            _dropped += 1
        _emitted += 1
        _ring.append(rec)
    _merge_profiler(event, t0, t1, payload)
    return rec


def _merge_profiler(event, t0, t1, payload):
    """Mirror the event onto the profiler's chrome trace while it records:
    the span is named by the event and its categorical field
    (``train_step.phase:dispatch``, ``chaos.inject:hang``), so the phases
    of a step stay apart in the aggregate table."""
    profiler = sys.modules.get(__package__ + ".profiler") \
        if __package__ else None
    if profiler is None or not profiler._recording():
        return
    try:
        for key in ("phase", "kind", "cause"):
            v = payload.get(key)
            if isinstance(v, str):
                event = f"{event}:{v}"
                break
        if t0 is None or t1 is None:
            t0 = t1 = time.perf_counter()
        profiler.record_span(event, t0, t1, category="tracing")
    except Exception:
        pass  # a profiler torn down at exit must not break emission


def snapshot(last=None):
    """A consistent copy of the ring's events, oldest first (``last=N``
    keeps only the newest N)."""
    with _lock:
        events = list(_ring)
    if last is not None:
        events = events[-int(last):]
    return events


def stats():
    """``{emitted, dropped, capacity, size}`` — overflow is visible,
    never silent (a black box whose window missed the fault says so)."""
    with _lock:
        return {"emitted": _emitted, "dropped": _dropped,
                "capacity": _ring.maxlen, "size": len(_ring)}


def reset():
    """Drop every event and context override (test hook); keeps run_id."""
    global _emitted, _dropped
    with _lock:
        _ring.clear()
        _emitted = 0
        _dropped = 0
        _context.update(epoch=None, step=None, generation=0, request=None,
                        rank=None, fleet_generation=None)


# ---------------------------------------------------------------------------
# the black box
# ---------------------------------------------------------------------------
def blackbox_path(prefix):
    return f"{prefix}-blackbox.json"


@functools.lru_cache(maxsize=1)
def _nvcc():
    """The ``nvcc`` release line, or None where there is no ``nvcc`` (read
    once a process: a black box on the restart path must stay cheap)."""
    try:
        from .kernels import _build
        return _build.nvcc_version().strip().splitlines()[-1]
    except Exception:
        return None


def _environment_fingerprint():
    """Where this process ran: enough to reproduce and attribute, nothing
    secret — the host, the Python and torch versions, CUDA's, the card's
    name (only where this process already uses the card: a black box
    never initializes CUDA, so the launcher's stays off the card) and
    ``nvcc``'s release."""
    env = {k: v for k, v in sorted(os.environ.items())
           if k.startswith(("TPUMX_", "CUDA_", "PYTORCH_"))}
    torch = sys.modules.get("torch")
    cuda = getattr(getattr(torch, "version", None), "cuda", None)
    device = None
    if torch is not None and cuda is not None:
        try:
            if torch.cuda.is_initialized():
                device = torch.cuda.get_device_name(
                    torch.cuda.current_device())
        except Exception:
            device = None
    return {
        "hostname": socket.gethostname(),
        "pid": os.getpid(),
        "python": sys.version.split()[0],
        "platform": sys.platform,
        "argv": list(sys.argv),
        "cwd": os.getcwd(),
        "env": env,
        "torch": getattr(torch, "__version__", None),
        "cuda": cuda,
        "device": device,
        "nvcc": _nvcc() if cuda is not None else None,
    }


def blackbox_doc(reason="", last=None):
    """Assemble (not persist) the black-box document: format tag, the
    trigger ``reason``, live trace context, the last N events, ring
    stats, a full telemetry snapshot and the environment fingerprint."""
    from . import telemetry
    # ring overflow rides the box's own telemetry
    telemetry._refresh_bridge_gauges()
    tel = telemetry.snapshot()
    return {
        "format": BLACKBOX_FORMAT,
        "reason": str(reason),
        "wall_time": time.time(),
        "written_at": time.strftime("%Y-%m-%dT%H:%M:%S%z"),
        "context": get_context(),
        "stats": stats(),
        "events": snapshot(last=last),
        "telemetry": tel,
        "environment": _environment_fingerprint(),
    }


def dump_blackbox(prefix, reason="", last=None):
    """Persist the black box as ``<prefix>-blackbox.json`` through
    ``checkpoint.atomic_write`` (all-or-nothing: a crash mid-dump leaves
    the previous box, never a torn one) and return the path.

    The file is ROLLING — each dump overwrites the last — but the ring
    holds the full recent timeline, so the newest box still contains
    every earlier fault within the window (``stats.dropped`` says when
    the window was exceeded)."""
    path = blackbox_path(prefix)
    doc = blackbox_doc(reason=reason, last=last)
    try:
        # STRICT JSON: events are non-finite-safe by construction (emit
        # encodes NaN/Inf as strings), and a box that jq/browsers cannot
        # parse defeats the read-it-anywhere contract
        payload = json.dumps(doc, sort_keys=True, allow_nan=False)
    except ValueError:
        # a non-finite value outside the events (e.g. a telemetry
        # histogram that observed NaN): keep the box rather than lose
        # the post-mortem — python's reader accepts the NaN token
        payload = json.dumps(doc, sort_keys=True)
    from . import telemetry
    from .checkpoint import atomic_write
    with atomic_write(path, "w") as f:
        f.write(payload)
    telemetry.counter("tracing.blackbox_dumps").inc()
    emit("supervisor.blackbox", path=path, reason=str(reason))
    return path


def validate_blackbox(doc):
    """Raise ValueError unless `doc` is a schema-valid black box: the
    known format tag, a complete context object, schema-valid events
    (each individually checked against :data:`KNOWN_EVENTS`), list-typed
    telemetry, and the ring stats/environment objects."""
    if not isinstance(doc, dict):
        raise ValueError(f"black box is {type(doc).__name__}, not an object")
    if doc.get("format") != BLACKBOX_FORMAT:
        raise ValueError(f"unknown black-box format {doc.get('format')!r} "
                         f"(this build reads {BLACKBOX_FORMAT})")
    ctx = doc.get("context")
    if not isinstance(ctx, dict) or \
            not {"run_id", "epoch", "step", "generation"} <= set(ctx):
        raise ValueError("black box missing a complete 'context' object "
                         "(run_id/epoch/step/generation)")
    if not isinstance(doc.get("events"), list):
        raise ValueError("black box missing the 'events' list")
    for i, rec in enumerate(doc["events"]):
        try:
            validate_event(rec)
        except ValueError as e:
            raise ValueError(f"events[{i}]: {e}") from e
    if not isinstance(doc.get("telemetry"), list):
        raise ValueError("black box missing the 'telemetry' list")
    for field in ("stats", "environment"):
        if not isinstance(doc.get(field), dict):
            raise ValueError(f"black box missing the {field!r} object")
    if not isinstance(doc.get("wall_time"), (int, float)):
        raise ValueError("black box missing numeric 'wall_time'")
    return doc
