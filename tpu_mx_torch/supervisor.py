"""Self-healing primitives and the training supervisor, from
``tpu_mx/supervisor.py``.

- :func:`run_with_deadline` runs a call on a daemon thread and joins it
  with a timeout: a hung step or decode becomes a catchable
  :class:`WatchdogTimeout` instead of an eternal hang.  The thread
  enters the caller's current CUDA device first (the current device is
  per thread), and a ``grace_signal`` that moved during the call — a
  kernel build or the train step's first call in flight — grants one
  ``grace`` extension.
- :func:`classify` sorts a failure into ``"transient"`` (a bounded
  restart can survive it: ``OSError``, ``WorkerFailure``,
  :class:`~tpu_mx_torch.contrib.chaos.ChaosCrash`), ``"numeric"``
  (:class:`NumericDivergence`), ``"corruption"`` (:class:`DataCorruption`,
  ``parallel/integrity.py``) or ``"fatal"`` (everything else).  A CUDA
  error — PyTorch's ``RuntimeError``/``torch.AcceleratorError``, or a
  kernel's :class:`~tpu_mx_torch.base.MXNetError` — is fatal: a restart
  cannot heal a poisoned context, and no restart moves work to the CPU.
- :class:`NumericSentinel` watches every observed loss (and optional
  grad norm) for NaN/Inf and spikes: the first ``skip_limit``
  consecutive bad batches are skipped, one more raises
  :class:`NumericDivergence`, a rollback to the last verified checkpoint.
- :class:`Supervisor` drives the epochs: each step (:meth:`Supervisor.step`)
  runs under the watchdog, the chaos training sites and the sentinel;
  after each epoch ``save_fn`` commits the checkpoint; a failure is
  classified and recovered — a transient one restarts from the last
  verified checkpoint with jittered backoff, a numeric one or a
  corruption verdict rolls back, a self-corrupt rank exits — until a
  budget is exhausted, when the run degrades (one clean final save, the
  ``supervisor.degraded`` gauge) and returns a
  :class:`SupervisorResult`.  A capsule manager (``resume.py``) makes
  every restore land on the exact batch with the exact generator states;
  an ``IntegrityMonitor`` (``integrity=``) votes on fingerprints at
  every step boundary.

The sentinel reads the step's loss — on the card a 0-d CUDA tensor —
inside the watchdog thread: that read is the supervised step's one
device-to-host synchronization.  With an elastic fleet (``fleet=``) the
step boundary is also the membership quiesce point; ``for_module``
wires a Supervisor to a Module (``module.fit(supervised=)``).

Usage, around a ``CompiledTrainStep``::

    sup = supervisor.Supervisor(
        save_fn=lambda e: elastic.save_checkpoint(prefix, e, net=net,
                                                  capsule=mgr),
        restore_fn=lambda: elastic.auto_resume(prefix, net=net),
        capsule=resume.CapsuleManager(prefix, iters=[it], state=step,
                                      interval=2),
        deadline=60.0)
    def epoch_fn(epoch):
        if not sup.resume_step(epoch):
            it.reset()
        for batch in it:
            sup.step(lambda: step.step(*batch.data, *batch.label))
    result = sup.run(epoch_fn, begin_epoch=0, num_epoch=90)
"""
from __future__ import annotations

import logging
import math
import random
import threading
import time
from collections import deque

from .base import MXNetError
from . import telemetry as _telemetry
from . import tracing as _tracing
from .contrib.chaos import ChaosCrash
from .elastic import WorkerFailure

__all__ = ["Supervisor", "Supervise", "SupervisorResult", "NumericSentinel",
           "NumericDivergence", "DataCorruption", "WatchdogTimeout",
           "run_with_deadline", "classify", "TRANSIENT_EXCEPTIONS",
           "for_module"]

log = logging.getLogger(__name__)


class NumericDivergence(MXNetError):
    """Non-finite values where the computation must stay finite: the
    numeric sentinel gave up skipping (consecutive NaN/Inf losses or
    spikes past its budget: roll back to the last verified checkpoint),
    or a serving step's logits health (max |logit|) is NaN or Inf (a
    restart).  Classified ``"numeric"``."""


class DataCorruption(MXNetError):
    """Silent data corruption, caught loudly (``parallel/integrity.py``):
    a cross-replica fingerprint vote disagreed, or a shadow re-execution
    of a step on the same operands gave other bits.  Classified
    ``"corruption"``.  ``step`` and ``surface`` say where; ``minority``
    names the voted-out ranks and ``verified_step`` the newest step an
    all-agree vote proved (the rollback anchor); ``self_corrupt`` means
    this worker named itself — it exits, the survivors roll back."""

    def __init__(self, message, step=0, minority=(), verified_step=0,
                 surface="train", self_corrupt=False):
        super().__init__(message)
        self.step = int(step)
        self.minority = tuple(int(m) for m in minority)
        self.verified_step = int(verified_step)
        self.surface = str(surface)
        self.self_corrupt = bool(self_corrupt)


class WatchdogTimeout(WorkerFailure):
    """A supervised region overran its deadline (a hung step or decode, a
    stalled launch, a dead peer).  Subclasses ``WorkerFailure``:
    transient."""


# faults a bounded in-process restart can survive; ChaosCrash is the
# simulated process death
TRANSIENT_EXCEPTIONS = (OSError, ConnectionError, TimeoutError,
                        WorkerFailure, ChaosCrash)


def classify(exc, transient=TRANSIENT_EXCEPTIONS):
    """``"corruption"``, ``"numeric"``, ``"transient"`` or ``"fatal"``
    (module docstring).  The classification is the retry policy: a
    transient fault restarts, numeric divergence and a corruption
    verdict roll back (a serving engine restarts on both), and
    everything else — programming errors, CUDA errors,
    ``KeyboardInterrupt``/``SystemExit`` — propagates at once."""
    if isinstance(exc, DataCorruption):
        return "corruption"
    if isinstance(exc, NumericDivergence):
        return "numeric"
    if isinstance(exc, (KeyboardInterrupt, SystemExit, GeneratorExit)):
        return "fatal"
    if isinstance(exc, transient):
        return "transient"
    return "fatal"


def _recompile_count():
    """The global ``train_step.recompiles`` counter: the default grace
    signal (it moves when a train step builds its state at its first
    call)."""
    m = _telemetry.get("train_step.recompiles")
    return m.value if m is not None else 0


def _current_cuda_device():
    """The caller's current CUDA device index, or None (no card, or CUDA
    not initialised on this thread's process yet)."""
    import torch
    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return None
    return torch.cuda.current_device()


def run_with_deadline(fn, deadline, name="step", grace=0.0,
                      grace_signal=None, message=None):
    """Run ``fn()`` on a daemon thread and join with ``deadline`` seconds.

    Returns ``fn``'s result; ``fn``'s own exception is re-raised in the
    caller.  The thread runs on the caller's current CUDA device.  If
    the deadline expires, ``grace_signal`` (a zero-argument callable
    sampled before the call) is read again: when it moved, wait up to
    ``grace`` more seconds.  A true timeout increments
    ``supervisor.watchdog_fires``, emits ``supervisor.watchdog_fire``
    and raises :class:`WatchdogTimeout`, leaving the hung thread parked
    (it cannot be cancelled; it ends with its call or the process).

    ``deadline=None`` calls ``fn`` inline (watchdog off)."""
    if deadline is None:
        return fn()
    box = {}
    done = threading.Event()
    device = _current_cuda_device()

    def _run():
        try:
            if device is None:
                box["value"] = fn()
            else:
                import torch
                with torch.cuda.device(device):
                    box["value"] = fn()
        except BaseException as e:  # noqa: BLE001 — relayed to the caller
            box["error"] = e
        finally:
            done.set()

    sig0 = grace_signal() if grace_signal is not None else None
    t = threading.Thread(target=_run, daemon=True, name=f"watchdog-{name}")
    t.start()
    if not done.wait(deadline):
        in_grace = (grace and grace_signal is not None
                    and grace_signal() != sig0)
        if in_grace:
            log.warning("watchdog: %s past its %.1fs deadline with a kernel "
                        "build in flight — granting %.1fs grace", name,
                        deadline, grace)
        if not (in_grace and done.wait(grace)) and not done.is_set():
            _telemetry.counter("supervisor.watchdog_fires").inc()
            _tracing.emit("supervisor.watchdog_fire", name=str(name),
                          deadline_seconds=float(deadline))
            raise WatchdogTimeout(
                message or f"watchdog: {name} hung past its "
                f"{deadline:.1f}s deadline — treating the step as a dead "
                "worker")
    if "error" in box:
        raise box["error"]
    return box.get("value")


class NumericSentinel:
    """NaN/Inf + loss-spike + grad-norm detection with a bounded skip
    budget.

    ``observe(loss, grad_norm=None)`` returns ``"ok"``, ``"skip"`` (bad,
    but within the ``skip_limit`` consecutive-bad budget) or ``"diverge"``
    (budget exhausted — roll back).  Spike detection compares ``|loss|``
    against ``spike_factor ×`` the median of the last ``window`` good
    losses (off by default: pass ``spike_factor``); it needs ≥5 good
    samples of history before arming, so warmup noise never trips it.
    ``skip_limit=0`` escalates on the first bad batch."""

    def __init__(self, skip_limit=2, spike_factor=None, window=32,
                 max_grad_norm=None):
        self.skip_limit = int(skip_limit)
        self.spike_factor = spike_factor
        self.max_grad_norm = max_grad_norm
        self._recent = deque(maxlen=int(window))
        self._consecutive_bad = 0
        self.last_good = None

    def reset(self):
        """Forget history + the bad streak (after a rollback: the restored
        weights invalidate both)."""
        self._recent.clear()
        self._consecutive_bad = 0

    def state_dict(self):
        """The skip ledger — capsules carry it so a resumed run's spike baseline and
        bad-streak position match the uninterrupted run's."""
        return {"recent": [float(v) for v in self._recent],
                "consecutive_bad": int(self._consecutive_bad),
                "last_good": self.last_good}

    def load_state_dict(self, state):
        self._recent.clear()
        self._recent.extend(float(v) for v in state.get("recent", ()))
        self._consecutive_bad = int(state.get("consecutive_bad", 0))
        lg = state.get("last_good")
        self.last_good = None if lg is None else float(lg)

    def _why_bad(self, loss, grad_norm):
        if loss is not None and not math.isfinite(loss):
            return f"loss={loss}"
        if grad_norm is not None:
            if not math.isfinite(grad_norm):
                return f"grad_norm={grad_norm}"
            if self.max_grad_norm and grad_norm > self.max_grad_norm:
                return (f"grad_norm={grad_norm:.3g} > "
                        f"max_grad_norm={self.max_grad_norm:.3g}")
        if (loss is not None and self.spike_factor
                and len(self._recent) >= 5):
            baseline = sorted(abs(v) for v in self._recent)[
                len(self._recent) // 2]
            if baseline > 0 and abs(loss) > self.spike_factor * baseline:
                return (f"loss spike |{loss:.3g}| > {self.spike_factor:g}× "
                        f"median {baseline:.3g}")
        return None

    def observe(self, loss, grad_norm=None):
        why = self._why_bad(loss, grad_norm)
        if why is None:
            self._consecutive_bad = 0
            if loss is not None:
                self._recent.append(float(loss))
                self.last_good = float(loss)
            return "ok"
        self._consecutive_bad += 1
        if self._consecutive_bad > self.skip_limit:
            log.error("numeric sentinel: %s — %d consecutive bad batches "
                      "exceed skip_limit=%d, declaring divergence",
                      why, self._consecutive_bad, self.skip_limit)
            return "diverge"
        log.warning("numeric sentinel: %s — skipping batch (%d/%d of the "
                    "skip budget)", why, self._consecutive_bad,
                    self.skip_limit)
        return "skip"


def _observable(value):
    """The sentinel's observable from a step's return value: a
    ``(loss, grad_norm)`` float pair.  A scalar or array reduces by its
    mean (one NaN poisons the mean, as the sentinel needs); a 2-tuple is
    ``(loss, grad_norm)``; None or a non-numeric value turns the check
    off for that step."""
    grad_norm = None
    if isinstance(value, tuple) and len(value) == 2:
        value, gn = value
        grad_norm = _scalar(gn)
    return _scalar(value), grad_norm


def _scalar(value):
    if value is None:
        return None
    import numpy as np
    import torch
    if hasattr(value, "asnumpy"):      # NDArray (its host read)
        value = value.asnumpy()
    if isinstance(value, torch.Tensor):
        if value.numel() == 0 or value.is_complex():
            return None
        # the one device-to-host read of a supervised step
        return float(value.detach().to(torch.float64).mean())
    try:
        arr = np.asarray(value, dtype=np.float64)
    except (TypeError, ValueError):
        return None
    if arr.size == 0:
        return None
    return float(arr) if arr.size == 1 else float(np.mean(arr))


class SupervisorResult:
    """Structured exit status of a supervised run (``status`` is
    ``"completed"`` or ``"degraded"``; ``ok`` is the boolean view)."""

    def __init__(self, status, begin_epoch, num_epoch, last_epoch,
                 restarts, rollbacks, batches_skipped, watchdog_fires,
                 final_loss, reason=None):
        self.status = status
        self.begin_epoch = begin_epoch
        self.num_epoch = num_epoch
        self.last_epoch = last_epoch
        self.restarts = restarts
        self.rollbacks = rollbacks
        self.batches_skipped = batches_skipped
        self.watchdog_fires = watchdog_fires
        self.final_loss = final_loss
        self.reason = reason

    @property
    def ok(self):
        return self.status == "completed"

    def as_dict(self):
        return dict(self.__dict__)

    def __repr__(self):
        return f"SupervisorResult({self.as_dict()})"


class Supervisor:
    """The self-healing training loop driver.

    ``save_fn(epoch)`` must be a *durable* saver (manifest-committing, e.g.
    ``elastic.save_checkpoint``); it runs
    after every successful epoch and once more on degradation.
    ``restore_fn()`` must restore the newest verified checkpoint and
    return the epoch to resume FROM (``elastic.auto_resume``'s contract;
    0 = fresh).  Either may be None — recovery then re-enters the current
    epoch with whatever state is live (documented-lossy, but still turns
    hangs into bounded retries).

    ``deadline``/``compile_grace`` arm the hung-step watchdog (None = off).
    ``max_restarts``/``max_rollbacks`` bound the whole ``run()``;
    exhaustion degrades gracefully instead of looping forever.  See the
    module docstring for the failure classification.

    ``capsule`` (a ``resume.CapsuleManager``) makes recovery
    *deterministic*: every
    epoch save also commits a training-state capsule (RNG streams, data
    cursors, sentinel ledger) and, when the manager has a step interval,
    a rolling mid-epoch step capsule — restarts and rollbacks then resume
    at the exact batch with the exact RNG stream instead of re-feeding or
    skipping data.

    ``blackbox`` (a checkpoint prefix) arms the flight recorder's crash
    black box: every restart, rollback and degrade dumps the last-N-steps
    event timeline, a telemetry snapshot and an environment fingerprint
    to ``<prefix>-blackbox.json`` through ``checkpoint.atomic_write``.

    ``integrity`` (a ``parallel.integrity.IntegrityMonitor``) runs its
    ``on_committed_step`` at every step boundary: a disagreeing
    fingerprint vote raises ``DataCorruption`` there.

    ``fleet`` (a ``parallel.fleet.Fleet``): every step boundary runs the
    fleet's duty cycle (``on_step``: heartbeat, chaos preemption,
    membership check); a ``WorkerFailure`` while the membership epoch
    moved is classified ``membership`` — ack the epoch, restore onto the
    new world, ``note_reshard`` — without spending the restart budget;
    a rank that finds itself corrupt quarantines itself in the fleet."""

    def __init__(self, save_fn=None, restore_fn=None, *, deadline=None,
                 compile_grace=120.0, max_restarts=3, max_rollbacks=3,
                 skip_limit=2, spike_factor=None, window=32,
                 max_grad_norm=None, cooldown=0.0, backoff=0.5,
                 max_backoff=30.0, jitter=0.5, transient=None, resume=True,
                 seed=None, on_degraded=None, capsule=None, blackbox=None,
                 fleet=None, integrity=None):
        self.save_fn = save_fn
        self.restore_fn = restore_fn
        # the corruption defense (parallel/integrity.py): an
        # IntegrityMonitor whose
        # on_committed_step runs at every step boundary — publish the
        # step's device fingerprint on its K-step cadence, vote against
        # the cohort, and raise DataCorruption on disagreement (caught
        # and classified "corruption" below)
        self.integrity = integrity
        self.fleet = fleet
        # flight-recorder black box: a checkpoint
        # prefix; every recovery decision and degrade dumps the last-N-
        # steps timeline + telemetry snapshot to <prefix>-blackbox.json
        self.blackbox = blackbox
        self.deadline = deadline
        self.compile_grace = compile_grace
        self.max_restarts = int(max_restarts)
        self.max_rollbacks = None if max_rollbacks is None \
            else int(max_rollbacks)
        self.cooldown = float(cooldown)
        self.backoff = float(backoff)
        self.max_backoff = float(max_backoff)
        self.jitter = float(jitter)
        self.transient = tuple(transient) if transient \
            else TRANSIENT_EXCEPTIONS
        self.resume = bool(resume)
        self.on_degraded = on_degraded
        self._rng = random.Random(seed)
        self._sentinel = NumericSentinel(skip_limit=skip_limit,
                                         spike_factor=spike_factor,
                                         window=window,
                                         max_grad_norm=max_grad_norm)
        self._epoch = None
        self.restarts = 0
        self.rollbacks = 0
        self.corruptions = 0
        self.batches_skipped = 0
        self.watchdog_fires = 0
        self.steps = 0               # committed steps across the whole run
        self._step_in_epoch = 0      # committed steps in the current epoch
        self._pending_resume = None  # (epoch, step) armed by a capsule
        self.capsule = None
        if capsule is not None:
            self.attach_capsule(capsule)
        # bumped on every restore: step functions with side effects can
        # compare it across their own run to detect that a restore
        # superseded them while they ran on an abandoned watchdog thread
        # (CompiledTrainStep does this internally)
        self.generation = 0

    @property
    def sentinel(self):
        """The numeric sentinel (its ``state_dict`` is the skip ledger
        capsules carry)."""
        return self._sentinel

    @property
    def step_in_epoch(self):
        """Committed steps in the current epoch (the capsule loop cursor)."""
        return self._step_in_epoch

    def attach_capsule(self, manager):
        """Wire a ``resume.CapsuleManager`` to this supervisor (also sets
        the manager's back-reference); returns the manager."""
        self.capsule = manager
        manager.supervisor = self
        return manager

    def resume_step(self, epoch):
        """Steps of ``epoch`` already committed by a mid-epoch capsule
        restore (0 = start the epoch fresh).  Epoch functions use it to
        decide whether to ``reset()`` their data iterator: nonzero means
        the iterator was repositioned at the exact next batch and a reset
        would re-feed the epoch head."""
        pend = self._pending_resume
        if pend is not None and pend[0] == int(epoch):
            return pend[1]
        return 0

    # -- one supervised step ------------------------------------------------
    def step(self, fn, name=None):
        """Run one training step under the watchdog + chaos hooks + numeric
        sentinel; returns ``fn``'s value.

        ``fn``'s return feeds the sentinel: a scalar/array loss (arrays
        reduce via mean), optionally ``(loss, grad_norm)``; None skips the
        numeric check.  Chaos's ``hang_step`` fires inside the watchdog
        thread (before ``fn``), ``nan_after`` poisons the observed loss,
        and ``crash_at_step`` fires after the step commits.

        With a fleet attached, the step boundary is also the membership
        quiesce point: ``fleet.on_step()`` beats the heartbeat, fires a
        pending chaos preemption, and raises ``MembershipChange`` when
        the membership epoch moved, so a reshard happens between steps."""
        from .contrib import chaos

        # stamp the trace context BEFORE anything can fail: every event
        # this step emits — chaos injections, watchdog fires (on the
        # watchdog thread: the context is process-global by design),
        # phase timings, the classification — carries the in-flight
        # step's (epoch, step, generation) identity
        _tracing.set_context(epoch=self._epoch,
                             step=self._step_in_epoch + 1,
                             generation=self.generation)
        if self.fleet is not None:
            self.fleet.on_step()

        def call():
            chaos.maybe_hang()
            value = fn()
            # read the observable INSIDE the watchdog thread: CUDA work is
            # asynchronous, so fn() returning proves nothing — the loss's
            # device-to-host read below is where a stalled kernel blocks,
            # and it must block on the watchdog's thread
            t_read = time.perf_counter()
            obs = _observable(value)
            _tracing.emit("train_step.phase", t0=t_read,
                          t1=time.perf_counter(), phase="loss_readback")
            return value, obs

        try:
            value, (loss, grad_norm) = run_with_deadline(
                call, self.deadline,
                name=name or f"step@epoch{self._epoch}",
                grace=self.compile_grace or 0.0,
                grace_signal=_recompile_count)
        except WatchdogTimeout:
            self.watchdog_fires += 1
            raise
        if loss is not None:
            loss = chaos.poison_loss(loss)
            verdict = self._sentinel.observe(loss, grad_norm=grad_norm)
            if verdict == "skip":
                self.batches_skipped += 1
                _telemetry.counter("supervisor.batches_skipped").inc()
                _tracing.emit(
                    "supervisor.sentinel_skip", loss=float(loss),
                    consecutive_bad=int(self._sentinel._consecutive_bad))
            elif verdict == "diverge":
                raise NumericDivergence(
                    f"training diverged at epoch {self._epoch} "
                    f"(loss={loss}, grad_norm={grad_norm}) — rolling back "
                    "to the last verified checkpoint")
        # the step is committed (its batch consumed, its update — or
        # documented skip — applied): advance the loop cursor, let the
        # capsule snapshot the exact post-step state, and only THEN give
        # chaos its crash-after-commit point (crash_at_step), so a capsule
        # resume continues at the next batch, never re-feeding this one
        self._step_in_epoch += 1
        self.steps += 1
        # the integrity duty cycle runs BEFORE the capsule snapshot so a
        # verified-step advance from an all-agree vote rides this step's
        # capsule; a disagreeing vote raises DataCorruption right here, at
        # the step boundary
        if self.integrity is not None:
            self.integrity.on_committed_step(self.steps)
        if self.capsule is not None:
            self.capsule.on_step(self)
        chaos.maybe_crash_step()
        return value

    # -- the supervised loop ------------------------------------------------
    def run(self, epoch_fn, begin_epoch=0, num_epoch=1):
        """Drive ``epoch_fn(epoch)`` from ``begin_epoch`` to ``num_epoch``
        with recovery; returns a :class:`SupervisorResult`.

        ``epoch_fn`` runs one epoch, calling :meth:`step` per batch.  After
        each successful epoch ``save_fn(epoch)`` commits the checkpoint;
        failures from either are classified and recovered (or propagate,
        if fatal).  A recovered run re-enters at the epoch
        ``restore_fn()`` returns — the poisoned/interrupted epoch was
        never saved, so rollback always lands on the last *good* one."""
        from .contrib import chaos
        chaos.configure_from_env()  # arm TPUMX_CHAOS faults for the run
        epoch = int(begin_epoch)
        if self.resume and self.restore_fn is not None:
            resumed = int(self.restore_fn() or 0)
            if self.capsule is not None:
                # a step capsule (fresh process resuming a crashed one)
                # repositions RNG/data/train-state at the exact batch
                resumed = self.capsule.restore(self, resumed)
            if resumed > epoch:
                log.info("supervisor: resuming from checkpointed epoch %d "
                         "(requested begin_epoch=%d)", resumed, epoch)
            epoch = max(epoch, resumed)
        _telemetry.gauge("supervisor.degraded").set(0)
        while epoch < int(num_epoch):
            self._epoch = epoch
            self._step_in_epoch = self.resume_step(epoch)
            _tracing.set_context(epoch=epoch, step=self._step_in_epoch,
                                 generation=self.generation)
            try:
                epoch_fn(epoch)
                self._pending_resume = None
                if self.save_fn is not None:
                    self.save_fn(epoch)
                if self.capsule is not None:
                    self.capsule.on_epoch(epoch, self)
            except BaseException as e:  # noqa: BLE001 — classified below
                kind = classify(e, self.transient)
                if (kind == "transient" and self.fleet is not None
                        and isinstance(e, WorkerFailure)
                        and self.fleet.poll_changed()):
                    # a WorkerFailure while the membership epoch moved is
                    # a fleet event, not a fault (the step-boundary
                    # MembershipChange, or a dead peer's barrier): no
                    # restart budget spent — re-entry needs a fresh
                    # generation, so it cannot loop
                    kind = "membership"
                # the classification IS the supervisor's decision: it goes
                # on the timeline under the FAILING step's trace context
                # (the context advances only at the next step/epoch top,
                # so the restart/rollback events below — emitted after the
                # restore — still share it; that shared (epoch, step,
                # generation) is what lets the black box link
                # injection → detection → decision)
                _tracing.emit("supervisor.classify", kind=kind,
                              error=type(e).__name__,
                              message=str(e)[:300])
                if kind == "fatal":
                    log.error("supervisor: fatal %s at epoch %d — "
                              "propagating (programming errors are not "
                              "retried): %s", type(e).__name__, epoch, e)
                    raise
                if kind == "membership":
                    from .parallel.fleet import note_reshard
                    prev_world = self.fleet.acked_world_size
                    ep_rec = self.fleet.ack()
                    log.warning(
                        "supervisor: membership epoch %d (world size "
                        "%d -> %d, %s) — quiescing and resharding from "
                        "the last verified manifest",
                        ep_rec["generation"], prev_world,
                        ep_rec["world_size"], ep_rec.get("reason"))
                    # restore_fn rebuilds at fleet.shard()'s world size;
                    # the capsule re-partitions the data stream from its
                    # global cursor (capsule v2)
                    epoch = self._restore(epoch)
                    note_reshard(prev_world, ep_rec["world_size"],
                                 source="manifest",
                                 generation=ep_rec["generation"])
                    self._dump_blackbox(
                        f"membership epoch {ep_rec['generation']}: world "
                        f"{prev_world} -> {ep_rec['world_size']} "
                        f"({ep_rec.get('reason')}) — resharded, resuming "
                        f"epoch {epoch}")
                elif kind == "corruption":
                    self.corruptions += 1
                    _telemetry.counter("supervisor.corruptions").inc()
                    if getattr(e, "self_corrupt", False):
                        # THIS replica is the corrupt one (voted-out
                        # minority, or a self-attributed shadow-audit
                        # mismatch): quarantine the rank permanently — the
                        # fleet must never re-admit a flaky chip — and
                        # exit loudly.  No retry: re-running on bad
                        # silicon is how silent corruption spreads.
                        if self.fleet is not None \
                                and self.fleet.member is not None:
                            try:
                                self.fleet.quarantine(
                                    self.fleet.member,
                                    reason=str(e)[:300],
                                    step=getattr(e, "step", 0))
                            except Exception as qerr:  # noqa: BLE001
                                log.error("supervisor: quarantine record "
                                          "failed: %s", qerr)
                        log.error("supervisor: %s — this rank is "
                                  "quarantined, exiting", e)
                        self._dump_blackbox(
                            f"{type(e).__name__}: {e} — rank quarantined "
                            f"(self_corrupt)")
                        _telemetry.flush()
                        raise
                    # surviving majority: the corrupt peer's gradients
                    # reached every replica through sync, so the live
                    # state is suspect past the last VERIFIED step —
                    # numeric-style rollback (the step capsule holds the
                    # poisoned trajectory and is discarded)
                    self.rollbacks += 1
                    _telemetry.counter("supervisor.rollbacks").inc()
                    if self.max_rollbacks is not None \
                            and self.rollbacks > self.max_rollbacks:
                        return self._degrade(epoch, e, "rollbacks")
                    log.warning(
                        "supervisor: %s — rolling back to the last "
                        "verified checkpoint (fingerprint-verified step "
                        "%d)", e, getattr(e, "verified_step", 0))
                    self._sentinel.reset()
                    epoch = self._restore(epoch, kind="numeric")
                    _tracing.emit(
                        "integrity.rollback",
                        step=int(getattr(e, "step", 0)),
                        verified_step=int(getattr(e, "verified_step", 0)),
                        resume_epoch=int(epoch))
                    self._dump_blackbox(
                        f"{type(e).__name__}: {e} — corruption rollback "
                        f"{self.rollbacks}/{self.max_rollbacks} to epoch "
                        f"{epoch} (verified step "
                        f"{getattr(e, 'verified_step', 0)})")
                    if self.cooldown:
                        time.sleep(self.cooldown)
                elif kind == "numeric":
                    self.rollbacks += 1
                    _telemetry.counter("supervisor.rollbacks").inc()
                    if self.max_rollbacks is not None \
                            and self.rollbacks > self.max_rollbacks:
                        return self._degrade(epoch, e, "rollbacks")
                    log.warning("supervisor: %s — rollback %d/%s, cooldown "
                                "%.1fs", e, self.rollbacks,
                                self.max_rollbacks, self.cooldown)
                    self._sentinel.reset()
                    epoch = self._restore(epoch, kind="numeric")
                    _tracing.emit("supervisor.rollback", n=self.rollbacks,
                                  resume_epoch=int(epoch))
                    self._dump_blackbox(
                        f"{type(e).__name__}: {e} — rollback "
                        f"{self.rollbacks}/{self.max_rollbacks} to "
                        f"epoch {epoch}")
                    if self.cooldown:
                        time.sleep(self.cooldown)
                else:  # transient
                    self.restarts += 1
                    _telemetry.counter("supervisor.restarts").inc()
                    if self.restarts > self.max_restarts:
                        return self._degrade(epoch, e, "restarts")
                    sleep = min(self.max_backoff,
                                self.backoff * 2 ** (self.restarts - 1))
                    sleep *= 1.0 + self.jitter * self._rng.random()
                    log.warning("supervisor: transient %s at epoch %d — "
                                "restart %d/%d after %.2fs backoff: %s",
                                type(e).__name__, epoch, self.restarts,
                                self.max_restarts, sleep, e)
                    time.sleep(sleep)
                    epoch = self._restore(epoch)
                    _tracing.emit("supervisor.restart", n=self.restarts,
                                  backoff_seconds=float(sleep),
                                  resume_epoch=int(epoch))
                    self._dump_blackbox(
                        f"{type(e).__name__}: {e} — restart "
                        f"{self.restarts}/{self.max_restarts} from "
                        f"epoch {epoch}")
                _telemetry.flush()
            else:
                epoch += 1
                _telemetry.flush()
        return self._result("completed", begin_epoch, num_epoch,
                            int(num_epoch) - 1)

    def _restore(self, current, kind="transient"):
        """Re-enter at the last verified checkpoint; without a restore_fn,
        retry the current epoch on live state (lossy — documented).

        With a capsule manager, the restore is *deterministic*: a usable
        step capsule resumes at the exact batch (transient faults only —
        a numeric rollback discards it, since it holds the trajectory
        that diverged), an epoch capsule at the epoch boundary with the
        exact RNG stream."""
        self.generation += 1  # invalidate any watchdog-abandoned step
        self._pending_resume = None
        if self.restore_fn is None:
            log.warning("supervisor: no restore_fn — retrying epoch %d on "
                        "live (possibly mid-step) state", current)
            return current
        resume_from = int(self.restore_fn() or 0)
        if self.capsule is not None:
            resume_from = self.capsule.restore(
                self, resume_from, use_step=(kind != "numeric"))
        log.warning("supervisor: restored; resuming from epoch %d%s",
                    resume_from,
                    (f" at step {self._pending_resume[1]}"
                     if self._pending_resume else ""))
        return resume_from

    def _degrade(self, epoch, err, budget):
        """Recovery budget exhausted: one clean durable final save, degraded
        gauge up, structured status out — never an unbounded crash loop.

        A NUMERIC exhaustion must NOT save: the live weights just produced
        the divergence, and committing them would make the poisoned state
        the newest verified epoch — the next resume would land exactly
        there, defeating rollback-to-last-good.  The last good checkpoint
        is already durable; restore onto it instead so the process at
        least exits on sane state."""
        _telemetry.gauge("supervisor.degraded").set(1)
        log.error("supervisor: %s budget exhausted at epoch %d (%s: %s) — "
                  "entering degraded shutdown",
                  budget, epoch, type(err).__name__, err)
        _tracing.emit("supervisor.degrade", budget=budget,
                      error=f"{type(err).__name__}: {err}"[:300])
        if classify(err, self.transient) in ("numeric", "corruption"):
            # corruption exhaustion is numeric-shaped: the live weights
            # are suspect, committing them would crown poisoned state
            if self.restore_fn is not None:
                try:
                    self.restore_fn()
                except Exception as restore_err:  # noqa: BLE001
                    log.error("supervisor: degraded final restore failed: "
                              "%s", restore_err)
        elif self.save_fn is not None:
            try:
                self.save_fn(epoch)
            except Exception as save_err:  # noqa: BLE001 — best effort
                log.error("supervisor: degraded final save failed too: %s",
                          save_err)
        if self.on_degraded is not None:
            self.on_degraded(self, err)
        self._dump_blackbox(f"degraded: {budget} budget exhausted "
                            f"({type(err).__name__}: {err})")
        _telemetry.flush()
        return self._result("degraded", None, None, epoch,
                            reason=f"{budget} exhausted: "
                                   f"{type(err).__name__}: {err}")

    def _dump_blackbox(self, reason):
        """Persist the flight-recorder black box (no-op without a
        ``blackbox`` prefix).  A dump failure is logged, never raised —
        forensics must not mask the fault being recorded."""
        if not self.blackbox:
            return None
        try:
            return _tracing.dump_blackbox(self.blackbox, reason=reason)
        except Exception as dump_err:  # noqa: BLE001 — best effort
            log.warning("supervisor: black-box dump failed: %s", dump_err)
            return None

    def _result(self, status, begin_epoch, num_epoch, last_epoch,
                reason=None):
        return SupervisorResult(
            status, begin_epoch, num_epoch, last_epoch, self.restarts,
            self.rollbacks, self.batches_skipped, self.watchdog_fires,
            self._sentinel.last_good, reason=reason)


class Supervise:
    """Configuration for supervised training through the high-level APIs
    (``module.fit(..., supervised=Supervise(prefix="ck"))``, which
    :func:`for_module` turns into a :class:`Supervisor`).

    ``prefix`` names the durable checkpoint prefix rollback resumes from;
    ``keep_last`` applies retention after each save (never pruning the
    newest verified epoch); ``save_optimizer_states`` folds the optimizer
    ``.states`` into each epoch's manifest.  ``capsule=True`` (or a
    prebuilt ``resume.CapsuleManager``) makes recovery deterministic, and
    ``capsule_interval=N`` writes a mid-epoch step capsule every N
    committed batches.  Every other keyword passes through to
    :class:`Supervisor` (``deadline=``, ``max_restarts=``,
    ``skip_limit=``, ...)."""

    def __init__(self, prefix=None, keep_last=3, save_optimizer_states=False,
                 capsule=None, capsule_interval=0, **supervisor_kwargs):
        self.prefix = prefix
        self.keep_last = keep_last
        self.save_optimizer_states = bool(save_optimizer_states)
        self.capsule = capsule
        self.capsule_interval = int(capsule_interval)
        self.supervisor_kwargs = supervisor_kwargs


def for_module(module, config, train_data=None):
    """A :class:`Supervisor` wired to a Module's checkpoints: saves go
    through ``module.save_checkpoint`` (the manifest committed, then
    retention), rollback through ``elastic.auto_resume(module=...)``.
    ``BaseModule.fit(supervised=...)`` calls it with its training
    iterator, whose position a capsule-enabled config snapshots."""
    import os
    from . import checkpoint as _ckpt
    from . import elastic as _elastic
    if isinstance(config, dict):
        config = Supervise(**config)
    if config is True:
        config = Supervise()
    if not isinstance(config, Supervise):
        raise MXNetError(
            f"supervised= expects a supervisor.Supervise config (or a dict "
            f"of its kwargs), got {type(config).__name__}")
    if not config.prefix:
        raise MXNetError(
            "Supervise needs a checkpoint prefix: rollback-to-last-good "
            "is meaningless without a durable checkpoint to roll back to "
            "(pass supervised=Supervise(prefix='ck'))")
    sup_kwargs = dict(config.supervisor_kwargs)
    # the flight recorder rides the checkpoint prefix unless told not to
    # (blackbox=None through Supervise)
    sup_kwargs.setdefault("blackbox", config.prefix)
    sup = Supervisor(**sup_kwargs)
    if config.capsule or config.capsule_interval:
        from . import resume as _resume
        if hasattr(config.capsule, "restore"):  # a manager already built
            sup.attach_capsule(config.capsule)
        else:
            sup.attach_capsule(_resume.CapsuleManager(
                config.prefix,
                iters=[train_data] if train_data is not None else [],
                state=_resume.ModuleState(module),
                interval=config.capsule_interval))

    def save_fn(epoch):
        extra = []
        if sup.capsule is not None:
            # the capsule before the manifest's commit: it rides the
            # epoch's manifest and is verified with the checkpoint
            extra.append(sup.capsule.write_epoch_file(epoch, sup))
        module.save_checkpoint(
            config.prefix, epoch,
            save_optimizer_states=config.save_optimizer_states,
            extra_files=extra)
        if config.keep_last:
            _ckpt.apply_retention(config.prefix, config.keep_last,
                                  known_verified=epoch)

    def restore_fn():
        start = _elastic.auto_resume(config.prefix, module=module)
        if config.save_optimizer_states and start > 0:
            # the optimizer rolls back with the weights: diverged momentum
            # kept over restored weights would poison them again
            states = f"{config.prefix}-{start - 1:04d}.states"
            loader = getattr(module, "load_optimizer_states", None)
            if loader is not None and os.path.exists(states):
                loader(states)
        return start

    sup.save_fn = save_fn
    sup.restore_fn = restore_fn
    return sup
