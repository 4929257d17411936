"""Deterministic resume, from ``tpu_mx/resume.py``: versioned
training-state capsules.

Durable checkpoints (``checkpoint.py``) and the supervisor
(``supervisor.py``) make recovery survivable; a **capsule** makes it
reproducible.  A restart that restores only weights resets the port's
generators (``mx.random``: the dropout masks and the flash kernels'
dropout seeds are drawn from them), numpy's host state and every
iterator's shuffle and cursor, so the recovered run re-feeds or skips
batches and diverges.  A capsule snapshots the rest of the training
state, so a recovered run replays the one that died, batch for batch,
bit for bit.

Two capsule kinds, one JSON format (:data:`CAPSULE_FORMAT`, the
reference's, read by either package):

- **Epoch capsule** — ``prefix-NNNN.capsule.json``, written with each
  epoch's durable checkpoint and listed in its manifest (size and sha256
  verified like every other checkpoint file).  Restoring it resumes at
  the epoch boundary with the exact generator states and the exact
  next-epoch shuffle.
- **Step capsule** — a rolling ``prefix-step.capsule.json`` written every
  ``interval`` committed steps, with a ``.state`` sidecar holding the
  mid-epoch train state: ``CompiledTrainStep.state_dict()`` (weights,
  buffers, float32 masters, optimizer state, ``t``) moved to host numpy
  and pickled.  The sidecar is written first and its size and sha256
  ride the capsule (the commit point), so a crash between the two falls
  back to the epoch boundary.  Restoring it resumes at the exact batch.

What a capsule carries: ``random.get_state()`` (the port's generators
and numpy's global state), every registered iterator's ``state_dict()``,
the supervisor's loop cursor, the numeric sentinel's ledger and the
integrity monitor's fingerprint history.  The native image pipeline's
iterators have no ``state_dict`` and are refused at construction.

This build writes ``tpu_mx-capsule-v2`` and reads v1 and v2; with an
elastic fleet attached (``fleet=``) the ``world`` map records this
worker's rank and world size in the fleet's adopted epoch and that
generation.  ``ModuleState`` carries a Module's weights and optimizer
states in the step capsule's sidecar.

Telemetry: ``resume.capsules_written{kind}``,
``resume.capsule_restore_seconds`` and the ``resume.resume_step_gap``
gauge (batches a recovery could not replay exactly; 0 whenever a capsule
restored).
"""
from __future__ import annotations

import base64
import json
import logging
import os
import pickle
import time

import numpy as np
import torch

from .base import MXNetError
from . import checkpoint as _ckpt
from . import random as _random
from . import telemetry as _telemetry
from . import tracing as _tracing

__all__ = ["CAPSULE_FORMAT", "CAPSULE_FORMAT_V1", "CAPSULE_FORMATS",
           "CapsuleManager", "encode_state", "decode_state", "capsule_path",
           "step_capsule_path", "step_state_path", "read_capsule",
           "ModuleState"]

log = logging.getLogger(__name__)

CAPSULE_FORMAT_V1 = "tpu_mx-capsule-v1"
#: the format this build WRITES (v2: global-cursor data positions + world map)
CAPSULE_FORMAT = "tpu_mx-capsule-v2"
#: the formats this build READS (v1 restores on the same-world path only)
CAPSULE_FORMATS = (CAPSULE_FORMAT_V1, CAPSULE_FORMAT)


# ---------------------------------------------------------------------------
# JSON-safe state encoding
# ---------------------------------------------------------------------------
def encode_state(obj):
    """Deep-encode a state tree into JSON-safe values.  ndarrays become
    ``{"__ndarray__": {dtype, shape, data}}`` with a base64 payload of
    the raw bytes — the exact representation, not a repr."""
    if isinstance(obj, np.ndarray):
        return {"__ndarray__": {
            "dtype": str(obj.dtype), "shape": list(obj.shape),
            "data": base64.b64encode(
                np.ascontiguousarray(obj).tobytes()).decode("ascii")}}
    if isinstance(obj, np.generic):
        return obj.item()
    if isinstance(obj, (list, tuple)):
        return [encode_state(x) for x in obj]
    if isinstance(obj, dict):
        return {str(k): encode_state(v) for k, v in obj.items()}
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if hasattr(obj, "__array__"):
        return encode_state(np.asarray(obj))
    raise MXNetError(
        f"capsule cannot encode a {type(obj).__name__} — state_dict trees "
        "must contain only arrays, scalars, strings, lists and dicts")


def decode_state(obj):
    """Inverse of :func:`encode_state` (tuples come back as lists)."""
    if isinstance(obj, dict):
        nd = obj.get("__ndarray__")
        if nd is not None and set(obj) == {"__ndarray__"}:
            arr = np.frombuffer(base64.b64decode(nd["data"]),
                                dtype=np.dtype(nd["dtype"]))
            return arr.reshape(nd["shape"]).copy()
        return {k: decode_state(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [decode_state(v) for v in obj]
    return obj


def _np_tree(obj):
    """Tensor and ``NDArray`` leaves to host numpy, keeping the tree's
    structure: the step sidecar never pickles a live device tensor.  A
    bfloat16 tensor, which numpy cannot hold, is kept as its 16-bit
    words (``{"__bfloat16__": uint16 array}``)."""
    if isinstance(obj, dict):
        return {k: _np_tree(v) for k, v in obj.items()}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):  # namedtuple
        return type(obj)(*(_np_tree(v) for v in obj))
    if isinstance(obj, tuple):
        return tuple(_np_tree(v) for v in obj)
    if isinstance(obj, list):
        return [_np_tree(v) for v in obj]
    if hasattr(obj, "asnumpy"):
        return obj.asnumpy()
    if isinstance(obj, torch.Tensor):
        t = obj.detach().cpu()
        if t.dtype == torch.bfloat16:
            return {"__bfloat16__": t.view(torch.int16).numpy()
                    .view(np.uint16)}
        return t.numpy()
    return obj


def _torch_tree(obj):
    """numpy leaves to host tensors (the restore side of
    :func:`_np_tree`; ``load_state_dict`` moves them to its device)."""
    if isinstance(obj, dict):
        if set(obj) == {"__bfloat16__"}:
            return torch.from_numpy(obj["__bfloat16__"].view(np.int16)) \
                .view(torch.bfloat16)
        return {k: _torch_tree(v) for k, v in obj.items()}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(_torch_tree(v) for v in obj))
    if isinstance(obj, tuple):
        return tuple(_torch_tree(v) for v in obj)
    if isinstance(obj, list):
        return [_torch_tree(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return torch.from_numpy(obj)
    return obj


# ---------------------------------------------------------------------------
# paths
# ---------------------------------------------------------------------------
def capsule_path(prefix, epoch):
    return f"{prefix}-{int(epoch):04d}.capsule.json"


def step_capsule_path(prefix):
    return f"{prefix}-step.capsule.json"


def step_state_path(prefix):
    return f"{prefix}-step.capsule.state"


def read_capsule(path):
    """Parse a capsule file; returns the dict or None (missing/unreadable/
    unknown format — logged, never raised: a bad capsule degrades to the
    next-coarser recovery point, it must not kill the resume)."""
    try:
        with open(path, encoding="utf-8") as f:
            cap = json.load(f)
    except (OSError, ValueError) as e:
        if os.path.exists(path):
            log.warning("capsule %s unreadable (%s) — ignoring", path, e)
        return None
    if not isinstance(cap, dict) or cap.get("format") not in CAPSULE_FORMATS:
        log.warning("capsule %s has unknown format %r (this build reads "
                    "%s) — ignoring", path,
                    cap.get("format") if isinstance(cap, dict) else None,
                    "/".join(CAPSULE_FORMATS))
        return None
    return cap


# ---------------------------------------------------------------------------
# the manager
# ---------------------------------------------------------------------------
class CapsuleManager:
    """Snapshots and restores the non-weight training state.

    ``prefix`` — the checkpoint prefix capsules live next to (the epoch
    capsule rides that prefix's per-epoch manifest).
    ``iters`` — DataIters implementing ``state_dict``/``load_state_dict``
    whose position the capsule carries.
    ``state`` — optional object with ``state_dict()``/``load_state_dict()``
    (a ``parallel.CompiledTrainStep``) captured
    into the step capsule's sidecar so mid-epoch resume has mid-epoch
    weights; without it, step capsules are not usable for mid-epoch
    resume and recovery falls back to the epoch boundary.
    ``interval`` — committed steps between step capsules (0 = epoch
    capsules only).
    ``fleet`` — optional :class:`tpu_mx_torch.parallel.fleet.Fleet`; when
    set, the capsule's ``world`` map records this worker's (rank,
    num_workers) and the fleet generation it was captured under
    (otherwise the map is derived from the registered iterators' shard
    placement).

    Wire it to a supervisor with ``Supervisor(capsule=mgr)`` /
    ``sup.attach_capsule(mgr)``; the supervisor calls :meth:`on_step` /
    :meth:`on_epoch` / :meth:`restore` at the right points."""

    def __init__(self, prefix, iters=(), state=None, interval=0, fleet=None):
        if not prefix:
            raise MXNetError("CapsuleManager needs a checkpoint prefix")
        self.prefix = prefix
        self.iters = list(iters)
        self.state = state
        self.fleet = fleet
        self.interval = int(interval)
        self.supervisor = None     # back-ref set by Supervisor.attach_capsule
        self._written_epoch = None
        for it in self.iters:
            # fail fast, BEFORE any training: an iterator that cannot
            # snapshot (e.g. the native image pipeline) would otherwise
            # surface as a fatal NotImplementedError only at the first
            # epoch's capsule write, after a full epoch of work — with no
            # checkpoint committed for it
            try:
                it.state_dict()
            except NotImplementedError as e:
                raise MXNetError(
                    f"CapsuleManager: {type(it).__name__} cannot snapshot "
                    f"({e}) — deterministic resume needs state_dict "
                    "support on every registered iterator") from e

    # -- capture ------------------------------------------------------------
    def _world(self):
        """The (rank, num_workers, generation) this capsule is captured
        under — from the fleet when attached, else from the registered
        iterators' shard placement (unsharded pipelines record the static
        1-worker world)."""
        if self.fleet is not None:
            rank = 0
            try:
                rank = self.fleet.shard()[0]
            except MXNetError:
                pass  # controller-only handles have no member slot
            return {"num_workers": max(1, self.fleet.acked_world_size),
                    "rank": int(rank),
                    "generation": int(self.fleet.acked_generation)}
        n = max([int(getattr(it, "num_workers", 1))
                 for it in self.iters] or [1])
        ranks = [int(getattr(it, "rank", 0)) for it in self.iters
                 if int(getattr(it, "num_workers", 1)) == n]
        return {"num_workers": n, "rank": ranks[0] if ranks else 0,
                "generation": 0}

    def _sharded(self):
        return self._world()["num_workers"] > 1

    def _body(self, epoch, step, sup=None):
        sup = sup if sup is not None else self.supervisor
        body = {"format": CAPSULE_FORMAT,
                "epoch": int(epoch), "step": int(step),
                "wall_time": time.time(),
                "world": self._world(),
                "rng": encode_state(_random.get_state()),
                "iters": [encode_state(it.state_dict())
                          for it in self.iters]}
        if sup is not None:
            body["supervisor"] = encode_state({
                "steps": int(sup.steps),
                "batches_skipped": int(sup.batches_skipped),
                "sentinel": sup.sentinel.state_dict()})
            # the fingerprint history rides the capsule: after a
            # corruption rollback the survivors resume knowing which
            # step was last cross-replica VERIFIED, not merely saved
            if getattr(sup, "integrity", None) is not None:
                body["integrity"] = encode_state(
                    sup.integrity.state_dict())
        return body

    def write_epoch_file(self, epoch, sup=None):
        """Write the epoch capsule and return its path.  Cooperative
        callers (``elastic.save_checkpoint(capsule=)``) call this BEFORE
        the manifest commit and list the path in
        the manifest, so the capsule is verified with the checkpoint."""
        path = capsule_path(self.prefix, epoch)
        sup = sup if sup is not None else self.supervisor
        step = sup.step_in_epoch if sup is not None else 0
        body = self._body(epoch, step, sup)
        with _ckpt.atomic_write(path, "w") as f:
            f.write(json.dumps(body, sort_keys=True))
        self._written_epoch = int(epoch)
        _telemetry.counter("resume.capsules_written", kind="epoch").inc()
        _tracing.emit("resume.capsule_write", kind="epoch",
                      epoch=int(epoch), step=int(step))
        return path

    def on_epoch(self, epoch, sup=None):
        """Post-save hook (the supervisor calls it after ``save_fn``):
        write the epoch capsule if the saver didn't (folding it into the
        epoch's manifest), then retire the now-superseded step capsule."""
        if self._written_epoch != int(epoch):
            path = self.write_epoch_file(epoch, sup)
            _ckpt.update_manifest(self.prefix, epoch, [path])
        self._discard_step_capsule()

    def on_step(self, sup):
        """Per-committed-step hook: write the rolling step capsule every
        ``interval`` steps."""
        if self.interval and sup.step_in_epoch % self.interval == 0:
            self.write_step(sup)

    def write_step(self, sup=None):
        """Write the rolling step capsule (+ train-state sidecar when a
        ``state`` object is attached).  Sidecar first; its size+sha256
        ride the capsule, making the capsule the commit point of the
        pair."""
        sup = sup if sup is not None else self.supervisor
        epoch = sup._epoch if sup is not None else 0
        step = sup.step_in_epoch if sup is not None else 0
        body = self._body(epoch or 0, step, sup)
        if self.state is not None:
            spath = step_state_path(self.prefix)
            tree = _np_tree(self.state.state_dict())
            # streamed: the arrays' bytes go to the file (and its digest)
            # without a whole-payload copy in memory
            with _ckpt.atomic_write(spath) as f:
                pickle.dump(tree, f, protocol=pickle.HIGHEST_PROTOCOL)
            body["state_file"] = {"name": os.path.basename(spath),
                                  **_ckpt._file_entry(spath)}
        with _ckpt.atomic_write(step_capsule_path(self.prefix), "w") as f:
            f.write(json.dumps(body, sort_keys=True))
        _telemetry.counter("resume.capsules_written", kind="step").inc()
        _tracing.emit("resume.capsule_write", kind="step",
                      epoch=int(epoch or 0), step=int(step))

    def _discard_step_capsule(self):
        for p in (step_capsule_path(self.prefix),
                  step_state_path(self.prefix)):
            try:
                os.remove(p)
            except OSError:
                pass

    # -- restore ------------------------------------------------------------
    def _format_usable(self, cap):
        """Why-not string for a capsule's FORMAT, or None when usable.

        v1 capsules recorded data positions without a world map — a v1
        file from an old N-world run holds per-worker LOCAL cursors that
        cannot be re-partitioned, and the file alone cannot prove it was
        whole-stream.  So v1 restores only on the same-world unsharded
        path (where its fields mean exactly what they always meant);
        under a sharded pipeline it is refused and the caller surfaces
        the gap — never guesses."""
        if cap.get("format") != CAPSULE_FORMAT_V1:
            return None
        if self._sharded():
            return ("capsule v1 predates the global-cursor format — its "
                    "cursors cannot be re-partitioned across a world-size "
                    "change; resuming without it, gap surfaced")
        return None

    def _step_usable(self, cap, resume_from):
        """Why-not string, or None when the step capsule can resume the
        exact batch (readable format for this world, epoch not
        superseded, sidecar present and hash-verified)."""
        why = self._format_usable(cap)
        if why is not None:
            return why
        if self.state is None or cap.get("state_file") is None:
            return ("no train-state sidecar — mid-epoch weights "
                    "unavailable, resuming at the epoch boundary")
        if int(cap.get("epoch", -1)) < int(resume_from):
            return "stale (a newer epoch checkpoint supersedes it)"
        sf = cap["state_file"]
        spath = step_state_path(self.prefix)
        if not os.path.exists(spath):
            return "train-state sidecar missing"
        if os.path.getsize(spath) != int(sf.get("size", -1)) or \
                _ckpt.sha256_file(spath) != sf.get("sha256"):
            return "train-state sidecar torn/corrupt (size/sha mismatch)"
        return None

    def _apply(self, cap, sup):
        _random.set_state(decode_state(cap["rng"]))
        states = [decode_state(s) for s in cap.get("iters", [])]
        if len(states) != len(self.iters):
            raise MXNetError(
                f"capsule carries {len(states)} iterator state(s) but the "
                f"manager registers {len(self.iters)} — resume must "
                "reconstruct the same data pipeline")
        for it, s in zip(self.iters, states):
            it.load_state_dict(s)
        if sup is not None and "supervisor" in cap:
            s = decode_state(cap["supervisor"])
            sup.sentinel.load_state_dict(s.get("sentinel", {}))
            sup.batches_skipped = max(sup.batches_skipped,
                                      int(s.get("batches_skipped", 0)))
            sup.steps = max(sup.steps, int(s.get("steps", 0)))
        if sup is not None and "integrity" in cap \
                and getattr(sup, "integrity", None) is not None:
            sup.integrity.load_state_dict(decode_state(cap["integrity"]))

    def restore(self, sup=None, resume_from=0, use_step=True):
        """Called after the weights restore (``restore_fn`` /
        ``elastic.auto_resume``) landed on the newest verified epoch;
        returns the epoch to resume FROM.

        Preference order: usable step capsule (exact batch — restores RNG,
        iterators, sentinel ledger AND the mid-epoch train state from the
        sidecar, arming the supervisor's mid-epoch position) → epoch
        capsule (epoch boundary, exact RNG/shuffle; any mid-epoch progress
        is *replayed* deterministically, not lost) → nothing (weights-only
        resume; the ``resume.resume_step_gap`` gauge records the batches
        that can no longer be replayed exactly).

        ``use_step=False`` is the numeric-rollback path: the step capsule
        is *discarded* (it holds the state that produced the divergence)
        and the epoch capsule is deliberately NOT applied either — rewinding
        the RNG/shuffle would make the retry a bit-identical replay that
        provably re-diverges at the same step until the rollback budget
        degrades; leaving the live streams running re-randomizes the
        retried epoch (a fresh permutation still covers every sample),
        which is the only retry that can actually escape a deterministic
        divergence."""
        sup = sup if sup is not None else self.supervisor
        t0 = time.perf_counter()
        gap = 0
        out = int(resume_from)
        used = "none"
        resumed_step = 0
        try:
            if not use_step:
                used = "discarded"
                log.warning(
                    "numeric rollback: discarding the step capsule (it "
                    "holds the diverged trajectory) and keeping the live "
                    "RNG/shuffle streams — an exact replay would diverge "
                    "again at the same step")
                self._discard_step_capsule()
                return out
            step_cap = read_capsule(step_capsule_path(self.prefix))
            why = self._step_usable(step_cap, resume_from) \
                if step_cap is not None else None
            if step_cap is not None and why is None:
                self._apply(step_cap, sup)
                self.state.load_state_dict(
                    _load_sidecar(step_state_path(self.prefix)))
                out = int(step_cap["epoch"])
                used = "step"
                resumed_step = int(step_cap["step"])
                if sup is not None:
                    sup._pending_resume = (out, int(step_cap["step"]))
                log.info("capsule: resuming mid-epoch at epoch %d, step %d "
                         "(exact batch, exact RNG stream)",
                         out, int(step_cap["step"]))
            else:
                if step_cap is not None:
                    log.warning("step capsule unusable: %s", why)
                epoch_cap = read_capsule(
                    capsule_path(self.prefix, resume_from - 1)) \
                    if resume_from > 0 else None
                if epoch_cap is not None:
                    ewhy = self._format_usable(epoch_cap)
                    if ewhy is not None:
                        log.warning("epoch capsule unusable: %s", ewhy)
                        epoch_cap = None
                if epoch_cap is not None:
                    self._apply(epoch_cap, sup)
                    used = "epoch"
                    log.info("capsule: resuming at the epoch %d boundary "
                             "with the exact RNG stream", resume_from)
                elif step_cap is not None:
                    # no deterministic recovery point at all: the batches
                    # the dead run consumed past the last checkpoint are
                    # genuinely unreplayable — surface the gap
                    gap = int(step_cap.get("step", 0))
        finally:
            _telemetry.gauge("resume.resume_step_gap").set(gap)
            _telemetry.histogram("resume.capsule_restore_seconds").observe(
                time.perf_counter() - t0)
            _tracing.emit("resume.capsule_restore", used=used,
                          epoch=int(out), step=resumed_step, gap=int(gap))
        return out


def _load_sidecar(path):
    with open(path, "rb") as f:
        return _torch_tree(pickle.load(f))


class ModuleState:
    """``state_dict``/``load_state_dict`` over a bound Module (or
    BucketingModule), so that the step capsule's sidecar carries its
    weights and optimizer states through ``module.fit(supervised=)``
    (``CompiledTrainStep`` speaks the protocol itself)."""

    def __init__(self, module):
        self.module = module

    def _updater_holder(self):
        m = self.module
        if hasattr(m, "_updater_states"):
            return m
        return getattr(m, "_curr_module", None)  # a BucketingModule's

    def state_dict(self):
        arg, aux = self.module.get_params()
        sd = {"arg": {k: v.asnumpy() for k, v in arg.items()},
              "aux": {k: v.asnumpy() for k, v in aux.items()}}
        holder = self._updater_holder()
        if holder is not None and getattr(holder, "_updater_states", None):
            sd["updater_states"] = _np_tree(holder._updater_states)
        return sd

    def load_state_dict(self, sd):
        self.module.set_params(sd.get("arg") or None, sd.get("aux") or None,
                               force_init=True)
        upd = sd.get("updater_states")
        holder = self._updater_holder()
        if upd is not None and holder is not None:
            from .module.module import _to_device
            # in place: a BucketingModule's buckets share the one dict
            holder._updater_states.clear()
            holder._updater_states.update(
                _to_device(_torch_tree(upd), holder._exec._device))
