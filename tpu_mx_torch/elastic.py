"""Elastic resume, from ``tpu_mx/elastic.py``: the timeout barrier and
durable auto-resume.

1. **Failure detection** — :func:`barrier` between epochs: at world size
   1 it is a no-op; under ``torch.distributed`` (a process group
   initialised) it is the group's barrier joined with a deadline
   (``supervisor.run_with_deadline``), so a dead peer becomes a clean
   :class:`WorkerFailure` within the timeout instead of a hang.  The
   chaos ``kill_peer`` knob makes it raise at any world size.
2. **Recovery** — checkpoints carry epoch numbers
   (``prefix-0007.params``); :func:`latest_checkpoint` finds the newest
   *verified* one (its manifest, ``checkpoint.py``, checks every file's
   size and sha256), :func:`auto_resume` restores it into a net (and a
   ``gluon.Trainer``'s states) and returns the epoch to resume from, and
   :func:`save_checkpoint` writes an epoch atomically with its manifest
   last.  The files are the reference's: ``.params`` (either package's
   ``save_parameters``) and the trainer-state pickle, so a checkpoint
   written by the reference loads into the port with the same weights.

``barrier(fleet=)`` tags the rendezvous with an elastic fleet's
membership generation (:mod:`tpu_mx_torch.parallel.fleet`);
``auto_resume(module=)`` restores a Module from its ``mx.model``
checkpoint.
"""
from __future__ import annotations

import glob
import logging
import os
import re
import time as _time

from .base import MXNetError
from . import checkpoint as _ckpt
from . import telemetry as _telemetry
from . import tracing as _tracing
from .checkpoint import preemption_handler  # noqa: F401  (re-export)

__all__ = ["WorkerFailure", "barrier", "latest_checkpoint",
           "candidate_checkpoints", "auto_resume", "save_checkpoint",
           "preemption_handler"]

log = logging.getLogger(__name__)


class WorkerFailure(MXNetError):
    """A peer did not reach the barrier within the timeout (died or hung)."""


def barrier(tag="tpumx_elastic", timeout=60.0, generation=None, fleet=None):
    """Synchronize all processes; raise :class:`WorkerFailure` if the group
    does not converge within ``timeout`` seconds.  Single process: no-op.

    Call between epochs, so a dead rank turns into a clean, fast failure
    instead of a hang in the next collective.  The ``kill_peer`` chaos
    knob makes this raise deterministically.

    Elastic fleets: with ``fleet=`` (a ``parallel.fleet.Fleet``) the
    rendezvous is tagged with the membership epoch, ``tag@gen``, and a
    worker still holding an earlier generation raises
    :class:`WorkerFailure` here, before the collective, instead of
    pairing with (or wedging) the current cohort.  ``generation=`` alone
    (an int) just tags."""
    from .contrib import chaos
    chaos.configure_from_env()
    if chaos.peer_killed():
        raise WorkerFailure(
            f"barrier '{tag}': chaos kill_peer armed — simulating a dead "
            "peer. Restart the job with --resume to continue from the last "
            "checkpoint.")
    if fleet is not None:
        current = fleet.generation
        if generation is None:
            generation = fleet.acked_generation
        if int(generation) != int(current):
            raise WorkerFailure(
                f"barrier '{tag}': stale fleet generation {generation} "
                f"(the membership epoch is now {current}) — this worker "
                "belongs to a previous epoch and must reshard/rejoin "
                "before it may rendezvous with the current cohort")
    if generation is not None:
        tag = f"{tag}@{int(generation)}"
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()) \
            or dist.get_world_size() <= 1:
        return
    rank, world = dist.get_rank(), dist.get_world_size()
    from .supervisor import run_with_deadline
    try:
        run_with_deadline(
            dist.barrier, timeout, name=f"barrier-{tag}",
            message=(
                f"barrier '{tag}' timed out after {timeout:.0f}s: a worker "
                f"is dead or hung (rank {rank} of {world} reporting). "
                "Restart the job with --resume to continue from the last "
                "checkpoint."))
    except WorkerFailure:
        raise
    except Exception as e:
        raise WorkerFailure(f"barrier '{tag}' failed: {e}") from e


# ≥5-digit epochs are legal: the reference's %04d format *pads to* four
# digits, it does not cap at four (a 4h-step-checkpointing run passes
# epoch 10000 in under a month)
_EPOCH_RE = re.compile(r"-(\d{4,})\.params(\.npz)?$")


def _screened_checkpoints(prefix):
    """Yield `(epoch, params_path, status)` newest-first, integrity-screened
    (status is 'verified' or 'legacy' — corrupt epochs are skipped).

    Epochs whose manifest fails verification (torn/missing/corrupt files)
    are skipped with a warning naming the damage.  Manifest-less epochs are
    *legacy* (pre-durability writers) — accepted with a warning — UNLESS
    the prefix has manifested epochs and this one is newer than the newest
    of them: then it is almost certainly a save that died between the data
    rename and the manifest commit, and trusting it would resurrect exactly
    the torn-resume failure the manifest exists to prevent, so it is
    skipped.  In-flight `*.tmp.<pid>` debris from a crashed save never
    matches."""
    found = {}
    for path in glob.glob(f"{prefix}-*.params*"):
        m = _EPOCH_RE.search(path)
        if m:
            found.setdefault(int(m.group(1)), path)
    manifested = {e for e in found
                  if os.path.exists(_ckpt.manifest_path(prefix, e))}
    newest_manifested = max(manifested) if manifested else None
    for epoch in sorted(found, reverse=True):
        status, problems = _ckpt.verify_checkpoint(prefix, epoch)
        if status == "verified":
            yield epoch, found[epoch], status
        elif status == "legacy":
            if newest_manifested is not None and epoch > newest_manifested:
                _telemetry.counter("elastic.epochs_skipped_corrupt").inc()
                _tracing.emit("elastic.epoch_skipped", epoch=epoch,
                              reason="manifest-less newer than a "
                                     "manifested epoch (interrupted save)")
                log.warning(
                    "checkpoint epoch %d of %s has no manifest although "
                    "older epochs of this prefix do: treating it as a save "
                    "interrupted before its manifest commit — skipping",
                    epoch, prefix)
                continue
            _telemetry.counter("elastic.legacy_fallbacks").inc()
            log.warning(
                "checkpoint epoch %d of %s has no manifest (legacy "
                "writer or pre-durability save): accepting unverified",
                epoch, prefix)
            yield epoch, found[epoch], status
        else:
            _telemetry.counter("elastic.epochs_skipped_corrupt").inc()
            _tracing.emit("elastic.epoch_skipped", epoch=epoch,
                          reason="; ".join(problems)[:200])
            log.warning("skipping corrupt checkpoint epoch %d of %s: %s",
                        epoch, prefix, "; ".join(problems))


def candidate_checkpoints(prefix):
    """Yield `(epoch, params_path)` newest-first, integrity-screened
    (see `_screened_checkpoints` for the screening rules)."""
    for epoch, params, _status in _screened_checkpoints(prefix):
        yield epoch, params


def latest_checkpoint(prefix):
    """Newest *verified* `(epoch, params_path)` under the reference's
    checkpoint naming (`prefix-0007.params[.npz]`), or (None, None) if no
    loadable epoch exists.  Corrupt epochs (failed manifest verification)
    are skipped in favor of the next-newest good one."""
    for epoch, params in candidate_checkpoints(prefix):
        return epoch, params
    return (None, None)


def _states_loadable(states_path):
    """Full unpickle of a trainer .states file WITHOUT applying it — the
    pre-commit validation that prevents a half-restore (params loaded,
    then states blow up).  The trainer's own unpickler reads either
    package's file (no ``ml_dtypes`` needed)."""
    from .gluon.trainer import _StatesUnpickler
    with open(states_path, "rb") as f:
        _StatesUnpickler(f).load()


def auto_resume(prefix, net=None, module=None, trainer=None):
    """Restore the newest *loadable* checkpoint for a Gluon net (or a
    Module: its ``mx.model`` checkpoint) + optional Trainer states;
    returns the epoch to resume FROM (0 if fresh).

    The ``--resume`` contract: a restarted job calls this before the train
    loop and starts at the returned epoch.  An epoch is committed to only
    after (a) its manifest
    verifies — `_screened_checkpoints` — and (b) its `.states` file, when a
    trainer is passed, actually unpickles (pre-checked for *legacy* epochs;
    verified epochs' bytes are already sha256-proven, so the extra read is
    skipped); any failure falls back to the next-newest epoch instead of
    half-restoring or crashing.  If every candidate fails AFTER some
    attempt already mutated net/module/trainer state, an MXNetError is
    raised — returning 0 ('train fresh') over silently half-restored state
    would be the exact corruption this module exists to prevent."""
    mutated = False
    for epoch, params, status in _screened_checkpoints(prefix):
        _telemetry.counter("elastic.resume_attempts").inc()
        states = f"{prefix}-{epoch:04d}.states"
        have_states = os.path.exists(states)
        if trainer is not None and have_states and status == "legacy":
            try:
                _states_loadable(states)
            except Exception as e:
                log.warning(
                    "epoch %d: %s exists but does not unpickle (%s: %s) — "
                    "falling back a checkpoint instead of half-restoring",
                    epoch, states, type(e).__name__, e)
                continue
        try:
            if net is not None:
                net.load_parameters(params)
                mutated = True
            if module is not None:
                from .model import load_checkpoint
                _sym, arg, aux = load_checkpoint(prefix, epoch)
                module.set_params(arg, aux)
                mutated = True
        except Exception as e:
            log.warning("epoch %d: params failed to load (%s: %s) — "
                        "falling back a checkpoint", epoch,
                        type(e).__name__, e)
            continue
        if trainer is not None and have_states:
            try:
                trainer.load_states(states)
            except Exception as e:
                # unpickled fine but failed to APPLY (format drift, wrong
                # optimizer/param set): fall back — the next iteration's
                # param load overwrites the partial restore
                log.warning(
                    "epoch %d: %s unpickled but failed to apply "
                    "(%s: %s) — falling back a checkpoint", epoch, states,
                    type(e).__name__, e)
                continue
        _tracing.emit("elastic.resume", resume_from=epoch + 1)
        return epoch + 1
    if mutated:
        raise MXNetError(
            f"auto_resume({prefix!r}): every candidate epoch failed, and a "
            "failed attempt already modified net/module/trainer state — "
            "re-initialize before training fresh (state is a partial mix, "
            "not epoch-0)")
    return 0


def save_checkpoint(prefix, epoch, net=None, trainer=None, keep_last=None,
                    attempts=4, capsule=None):
    """Durable counterpart of `auto_resume`: write the epoch's params (and
    trainer states) atomically, commit the manifest LAST, then apply
    retention.

    Every write is atomic (tmp+fsync+rename) and wrapped in
    `checkpoint.retry` against transient filesystem errors; the manifest is
    the commit point, so a crash anywhere mid-save leaves the previous
    epoch as the newest *verified* checkpoint.  `keep_last=K` prunes older
    epochs (never the newest verified one).  Returns the params path.

    `capsule=` (a `resume.CapsuleManager`) additionally commits the
    epoch's training-state capsule — RNG streams + data-iterator cursors
    — INSIDE the manifest, so
    the capsule is size+sha256 verified with the checkpoint it belongs to.

    This helper is the Gluon (net/trainer) flow, and the natural
    `save_fn` for `preemption_handler`."""
    if net is None and trainer is None:
        raise MXNetError("save_checkpoint: pass net= and/or trainer=")
    t_save = _time.perf_counter()
    with _telemetry.span("checkpoint.save_seconds"):
        files = []
        params = f"{prefix}-{epoch:04d}.params"
        if net is not None:
            _ckpt.retry(lambda: net.save_parameters(params),
                        attempts=attempts)
            files.append(params)
        if trainer is not None:
            states = f"{prefix}-{epoch:04d}.states"
            _ckpt.retry(lambda: trainer.save_states(states),
                        attempts=attempts)
            files.append(states)
        if capsule is not None:
            files.append(_ckpt.retry(
                lambda: capsule.write_epoch_file(epoch), attempts=attempts))
        _ckpt.retry(lambda: _ckpt.write_manifest(prefix, epoch, files),
                    attempts=attempts)
        if keep_last:
            # the epoch just committed is verified by construction — skip
            # the full from-disk re-hash the newest-verified scan would
            # otherwise do
            _ckpt.apply_retention(prefix, keep_last, known_verified=epoch)
        _tracing.emit("checkpoint.save", t0=t_save, t1=_time.perf_counter(),
                      prefix=os.path.basename(str(prefix)),
                      epoch=int(epoch))
        return params
