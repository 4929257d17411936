"""Self-healing primitives: the serving half of ``tpu_mx/supervisor.py``.

- :func:`run_with_deadline` runs a call on a daemon thread and joins it
  with a timeout: a hung decode becomes a catchable
  :class:`WatchdogTimeout` instead of an eternal hang.  The thread
  enters the caller's current CUDA device first (the current device is
  per thread), and a ``grace_signal`` that moved during the call — a
  kernel build in flight — grants one ``grace`` extension.
- :func:`classify` sorts a failure into ``"transient"`` (a bounded
  restart can survive it: ``OSError``, ``WorkerFailure``,
  :class:`~tpu_mx_torch.contrib.chaos.ChaosCrash`), ``"numeric"``
  (:class:`NumericDivergence`), ``"corruption"`` (:class:`DataCorruption`:
  a bit-exact re-execution disagreed, ``parallel/integrity.py``) or
  ``"fatal"`` (everything else).  A
  CUDA error — PyTorch's ``RuntimeError``/``torch.AcceleratorError``, or
  a kernel's :class:`~tpu_mx_torch.base.MXNetError` — is fatal: a
  restart cannot heal a poisoned context, and the server never moves
  work to the CPU.

The reference module's training ``Supervisor``, ``NumericSentinel`` and
rollback plane are not ported yet (ROADMAP A item 8); a serving engine's
corruption is a restart, as in the reference's server.
"""
from __future__ import annotations

import logging
import threading

from .base import MXNetError
from . import telemetry as _telemetry
from . import tracing as _tracing
from .contrib.chaos import ChaosCrash
from .elastic import WorkerFailure

__all__ = ["NumericDivergence", "DataCorruption", "WatchdogTimeout",
           "run_with_deadline", "classify", "TRANSIENT_EXCEPTIONS"]

log = logging.getLogger(__name__)


class NumericDivergence(MXNetError):
    """Non-finite values where the computation must stay finite: the
    serving engine raises it when a step's logits health (max |logit|)
    is NaN or Inf.  Classified ``"numeric"``: a restart."""


class DataCorruption(MXNetError):
    """Silent data corruption, caught loudly (``parallel/integrity.py``):
    a shadow re-execution of a step on the same operands gave other bits.
    Classified ``"corruption"``.  ``step`` and ``surface`` say where;
    ``minority``/``verified_step`` are the reference's cross-replica vote
    fields (a vote is ROADMAP A item 8); ``self_corrupt`` means this worker
    named itself (the shadow audit has no one else to blame)."""

    def __init__(self, message, step=0, minority=(), verified_step=0,
                 surface="train", self_corrupt=False):
        super().__init__(message)
        self.step = int(step)
        self.minority = tuple(int(m) for m in minority)
        self.verified_step = int(verified_step)
        self.surface = str(surface)
        self.self_corrupt = bool(self_corrupt)


class WatchdogTimeout(WorkerFailure):
    """A supervised region overran its deadline (a hung decode, a stalled
    launch).  Subclasses ``WorkerFailure``: transient."""


# faults a bounded in-process restart can survive; ChaosCrash is the
# simulated process death
TRANSIENT_EXCEPTIONS = (OSError, ConnectionError, TimeoutError,
                        WorkerFailure, ChaosCrash)


def classify(exc, transient=TRANSIENT_EXCEPTIONS):
    """``"corruption"``, ``"numeric"``, ``"transient"`` or ``"fatal"``
    (module docstring).  The classification is the retry policy: a
    transient fault, numeric divergence and a serving engine's data
    corruption restart, and everything else — programming errors, CUDA
    errors, ``KeyboardInterrupt``/``SystemExit`` — propagates at once."""
    if isinstance(exc, DataCorruption):
        return "corruption"
    if isinstance(exc, NumericDivergence):
        return "numeric"
    if isinstance(exc, (KeyboardInterrupt, SystemExit, GeneratorExit)):
        return "fatal"
    if isinstance(exc, transient):
        return "transient"
    return "fatal"


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
