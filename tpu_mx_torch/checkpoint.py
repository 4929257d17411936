"""Durable checkpointing, from ``tpu_mx/checkpoint.py``: atomic writes,
manifests, verification, retention and the preemption hook.

Copied rather than imported (stdlib only; importing ``tpu_mx`` would
import jax), with the reference's on-disk format byte for byte, so a
manifest written by either package verifies in the other:

- :func:`atomic_write` — the bytes go to ``<path>.tmp.<pid>``, are
  flushed and fsync'd, then renamed over ``path`` (and the directory
  fsync'd): a death at any instant leaves the old complete file or
  ``*.tmp.*`` debris, never a torn destination.  The size and sha256 of
  the stream the caller meant to write are recorded, so a manifest can
  later tell a torn write (disk != intent).  The chaos harness's file
  faults (``contrib/chaos.py``: ``crash_after_bytes``, ``torn_write``,
  ``slow_io``, ``transient_oserror``) act below the digest.
- a per-checkpoint JSON **manifest** (``prefix-NNNN.manifest.json``,
  :data:`MANIFEST_FORMAT`: file table with sizes and sha256 digests, git
  HEAD, wall time) written last, as the commit point.
- :func:`verify_checkpoint` — the manifest against the files, naming the
  torn, missing or corrupt one.
- :func:`apply_retention` — keep the newest K epochs, never deleting the
  newest verified one.
- :func:`retry` — jittered exponential backoff for transient filesystem
  errors (a simulated crash is never retried).
- :func:`preemption_handler` — SIGTERM/SIGINT hooks that make one
  emergency save before exit.
"""
from __future__ import annotations

import collections
import contextlib
import glob
import hashlib
import json
import logging
import os
import random
import re
import signal
import socket
import subprocess
import sys
import threading
import time

from .base import MXNetError
from . import telemetry as _telemetry
from . import tracing as _tracing

__all__ = ["atomic_write", "retry", "sha256_file", "manifest_path",
           "write_manifest", "update_manifest", "read_manifest",
           "verify_checkpoint", "newest_verified_epoch", "list_epochs",
           "checkpoint_files", "apply_retention", "preemption_handler",
           "CheckpointCorrupt", "MANIFEST_FORMAT"]

log = logging.getLogger(__name__)

MANIFEST_FORMAT = "tpu_mx-manifest-v1"


class CheckpointCorrupt(MXNetError):
    """A checkpoint failed manifest verification (torn/missing/corrupt)."""


def _chaos():
    """The fault-injection module (lazy: env-armed chaos parses on first
    use)."""
    from .contrib import chaos
    chaos.configure_from_env()
    return chaos


# ---------------------------------------------------------------------------
# atomic_write
# ---------------------------------------------------------------------------
# abspath -> {"size": int, "sha256": hex} for the most recent atomic_write;
# manifest writers prefer this *intended* digest over re-hashing the disk
# file, which is what makes a torn write (disk != intent) detectable.
_intended = collections.OrderedDict()
_INTENDED_MAX = 256
_intended_lock = threading.Lock()


class _HashingFile:
    """Counts and sha256-hashes the bytes the caller writes (the *intent*),
    independent of what the chaos layer lets reach disk below it."""

    def __init__(self, f):
        self._f = f
        self.nbytes = 0
        self.sha = hashlib.sha256()
        self.seeked = False  # a seek invalidates linear stream hashing

    def write(self, data):
        buf = data.encode("utf-8") if isinstance(data, str) else data
        self.sha.update(buf)
        self.nbytes += memoryview(buf).nbytes
        return self._f.write(data)

    def seek(self, *a, **kw):
        self.seeked = True
        return self._f.seek(*a, **kw)

    def __getattr__(self, name):
        return getattr(self._f, name)


def _fsync_dir(dirname):
    """fsync the directory so the rename itself is durable (best effort —
    not every filesystem/platform supports opening a directory)."""
    try:
        fd = os.open(dirname or ".", os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


@contextlib.contextmanager
def atomic_write(path, mode="wb", fsync=True):
    """Crash-safe file write: all-or-nothing commit via tmp + rename.

    ::

        with atomic_write(fname) as f:
            f.write(payload)          # one-shot writes keep intent == stream

    Writes go to ``<path>.tmp.<pid>`` in the same directory (same
    filesystem, so the final ``os.replace`` is atomic); on clean exit the
    stream is flushed, fsync'd, renamed over ``path``, and the directory
    fsync'd.  On an ordinary exception the tmp is removed and the old
    ``path`` (if any) is untouched.  On a simulated crash
    (``chaos.ChaosCrash``) the tmp is *left behind*, exactly like a real
    kill — recovery code must (and does) ignore ``*.tmp.*`` debris.

    ``mode`` is ``"wb"`` or ``"w"`` (text, utf-8).  The intended size and
    sha256 of the written stream are recorded for :func:`write_manifest`;
    writers that seek (invalidating linear hashing) fall back to hashing
    the committed file from disk.
    """
    if mode not in ("wb", "w"):
        raise ValueError(f"atomic_write: mode must be 'wb' or 'w', got {mode}")
    t_start = time.perf_counter()
    chaos = _chaos()
    path = os.fspath(path)
    ap = os.path.abspath(path)
    dirname = os.path.dirname(ap)
    if dirname and not os.path.isdir(dirname):
        os.makedirs(dirname, exist_ok=True)
    chaos.maybe_oserror("open", path)
    tmp = f"{ap}.tmp.{os.getpid()}"
    raw = open(tmp, mode, encoding="utf-8" if mode == "w" else None)
    wrapper = _HashingFile(chaos.wrap_file(raw, path))
    try:
        yield wrapper
        raw.flush()
        if fsync:
            os.fsync(raw.fileno())
        raw.close()
        chaos.maybe_oserror("replace", path)
        info = {"size": wrapper.nbytes, "sha256": wrapper.sha.hexdigest()}
        if wrapper.seeked:
            info = {"size": os.path.getsize(tmp), "sha256": sha256_file(tmp)}
        os.replace(tmp, ap)
        if fsync:
            _fsync_dir(dirname)
        with _intended_lock:
            _intended[ap] = info
            while len(_intended) > _INTENDED_MAX:
                _intended.popitem(last=False)
        _telemetry.counter("checkpoint.atomic_writes").inc()
        # per-file commit latency; a whole checkpoint's is the
        # checkpoint.save_seconds span at the save call sites
        _telemetry.histogram("checkpoint.write_seconds").observe(
            time.perf_counter() - t_start)
    except BaseException as e:
        try:
            raw.close()
        except OSError:
            pass
        from .contrib.chaos import ChaosCrash
        if not isinstance(e, ChaosCrash):
            # ordinary failure: clean up; a (simulated) crash leaves debris
            try:
                os.remove(tmp)
            except OSError:
                pass
        raise


def sha256_file(path, chunk=1 << 20):
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            buf = f.read(chunk)
            if not buf:
                return h.hexdigest()
            h.update(buf)


# ---------------------------------------------------------------------------
# retry
# ---------------------------------------------------------------------------
def retry(fn, attempts=4, backoff=0.05, max_backoff=2.0, jitter=0.5,
          exceptions=(OSError,), seed=None):
    """Call ``fn()`` with jittered exponential backoff on transient errors.

    Retries only ``exceptions`` (default ``OSError`` — the transient
    filesystem class).  ``chaos.ChaosCrash`` is intentionally outside that
    set: a crash is not transient.  The jitter stream is seedable for
    deterministic tests; sleep durations are
    ``backoff * 2**k * (1 + jitter*U[0,1))`` capped at ``max_backoff``.
    Raises the last error after ``attempts`` tries."""
    rng = random.Random(seed)
    delay = float(backoff)
    for attempt in range(1, int(attempts) + 1):
        try:
            return fn()
        except exceptions as e:
            if attempt >= attempts:
                raise
            _telemetry.counter("checkpoint.retries").inc()
            _tracing.emit("checkpoint.retry", attempt=attempt,
                          error=f"{type(e).__name__}: {e}")
            sleep = delay * (1.0 + float(jitter) * rng.random())
            log.warning("retry %d/%d: %s: %s (backing off %.3fs)",
                        attempt, attempts, type(e).__name__, e, sleep)
            time.sleep(sleep)
            delay = min(delay * 2.0, float(max_backoff))


# ---------------------------------------------------------------------------
# manifests
# ---------------------------------------------------------------------------
_git_head_cache = None


def _git_head():
    global _git_head_cache
    if _git_head_cache is None:
        try:
            _git_head_cache = subprocess.run(
                ["git", "rev-parse", "HEAD"], capture_output=True, text=True,
                timeout=5,
                cwd=os.path.dirname(os.path.abspath(__file__)),
            ).stdout.strip() or "unknown"
        except (OSError, subprocess.SubprocessError):
            _git_head_cache = "unknown"
    return _git_head_cache


def manifest_path(prefix, epoch):
    return f"{prefix}-{int(epoch):04d}.manifest.json"


def _file_entry(path):
    ap = os.path.abspath(path)
    with _intended_lock:
        info = _intended.get(ap)
    if info is None:  # written outside atomic_write: trust the disk bytes
        info = {"size": os.path.getsize(ap), "sha256": sha256_file(ap)}
    return dict(info)


def write_manifest(prefix, epoch, files, extra=None):
    """Write ``prefix-NNNN.manifest.json`` over `files` — the COMMIT POINT.

    Call strictly after every data file of the checkpoint has been
    atomically committed; an epoch whose manifest is missing/unreadable/
    mismatched is treated as not-a-checkpoint by the elastic path.  Digests
    come from the recorded intent of each file's `atomic_write` (falling
    back to hashing disk for files written by other means)."""
    entries = {}
    for p in files:
        entries[os.path.basename(os.fspath(p))] = _file_entry(p)
    man = {
        "format": MANIFEST_FORMAT,
        "prefix": os.path.basename(os.fspath(prefix)),
        "epoch": int(epoch),
        "files": entries,
        "git_head": _git_head(),
        "wall_time": time.time(),
        "written_at": time.strftime("%Y-%m-%dT%H:%M:%S%z"),
        "host": socket.gethostname(),
        "pid": os.getpid(),
    }
    if extra:
        man.update(extra)
    with atomic_write(manifest_path(prefix, epoch), "w") as f:
        f.write(json.dumps(man, indent=1, sort_keys=True))
    _record_bytes_on_disk(man)
    return man


def _record_bytes_on_disk(man):
    """Publish the manifest's committed payload bytes as the
    ``checkpoint.bytes_on_disk`` gauge: each epoch's save stamps its
    total, so the telemetry timeline carries bytes on disk per epoch
    without a filesystem walk."""
    total = sum(int(e.get("size", 0)) for e in man.get("files", {}).values())
    _telemetry.gauge("checkpoint.bytes_on_disk").set(float(total))


def update_manifest(prefix, epoch, add_files, extra=None):
    """Add `add_files` to an existing manifest (atomic rewrite), or create
    one if the epoch has none yet — for multi-phase checkpoints where e.g.
    optimizer states land after the params commit."""
    mp = manifest_path(prefix, epoch)
    man = None
    if os.path.exists(mp):
        try:
            man = read_manifest(prefix, epoch)
        except (OSError, ValueError, CheckpointCorrupt):
            man = None  # unreadable: rebuild from scratch below
    if man is None:
        return write_manifest(prefix, epoch, add_files, extra=extra)
    for p in add_files:
        man["files"][os.path.basename(os.fspath(p))] = _file_entry(p)
    if extra:
        man.update(extra)
    man["wall_time"] = time.time()
    man["written_at"] = time.strftime("%Y-%m-%dT%H:%M:%S%z")
    with atomic_write(mp, "w") as f:
        f.write(json.dumps(man, indent=1, sort_keys=True))
    _record_bytes_on_disk(man)
    return man


def read_manifest(prefix, epoch):
    """Parse the epoch's manifest; raises CheckpointCorrupt if unreadable."""
    mp = manifest_path(prefix, epoch)
    try:
        with open(mp, encoding="utf-8") as f:
            man = json.load(f)
    except ValueError as e:
        raise CheckpointCorrupt(f"manifest {mp} unreadable: {e}") from e
    if not isinstance(man, dict) or "files" not in man:
        raise CheckpointCorrupt(f"manifest {mp} malformed (no file table)")
    return man


def verify_checkpoint(prefix, epoch):
    """Check epoch `epoch` of `prefix` against its manifest.

    Returns ``(status, problems)``:

    - ``("verified", [])`` — manifest present, every file exists with the
      recorded size and sha256;
    - ``("legacy", [])`` — no manifest but checkpoint files exist (written
      by a pre-durability writer): loadable, but unverifiable;
    - ``("corrupt", [...])`` — manifest unreadable, or a file is missing /
      torn (size mismatch) / content-corrupt (digest mismatch); each
      problem string names the offending file and the failure mode.
    """
    t_start = time.perf_counter()
    status, problems = _verify_checkpoint(prefix, epoch)
    _telemetry.histogram("checkpoint.verify_seconds").observe(
        time.perf_counter() - t_start)
    if status == "corrupt":
        _telemetry.counter("checkpoint.corrupt_detected").inc()
    _tracing.emit("checkpoint.verify", prefix=os.path.basename(str(prefix)),
                  epoch=int(epoch), status=status)
    return status, problems


def _verify_checkpoint(prefix, epoch):
    mp = manifest_path(prefix, epoch)
    if not os.path.exists(mp):
        legacy = [p for p in glob.glob(f"{prefix}-{int(epoch):04d}.*")
                  if ".tmp." not in p]
        if legacy:
            return "legacy", []
        return "corrupt", [f"epoch {epoch}: no manifest and no files"]
    try:
        man = read_manifest(prefix, epoch)
    except CheckpointCorrupt as e:
        return "corrupt", [str(e)]
    problems = []
    d = os.path.dirname(os.path.abspath(mp))
    for name, info in man["files"].items():
        p = os.path.join(d, name)
        if not os.path.exists(p):
            problems.append(f"{name}: missing")
            continue
        size = os.path.getsize(p)
        if size != info.get("size"):
            problems.append(
                f"{name}: torn/truncated write — size on disk {size} != "
                f"manifest {info.get('size')}")
            continue
        if sha256_file(p) != info.get("sha256"):
            problems.append(f"{name}: sha256 mismatch (corrupt content)")
    return ("verified" if not problems else "corrupt"), problems


def newest_verified_epoch(prefix):
    """Newest epoch of `prefix` whose manifest verifies, or None — the one
    recovery point retention and the training supervisor must preserve."""
    for e in reversed(list_epochs(prefix)):
        if verify_checkpoint(prefix, e)[0] == "verified":
            return e
    return None


# ---------------------------------------------------------------------------
# enumeration + retention
# ---------------------------------------------------------------------------
_EPOCH_FILE_RE = re.compile(
    r"-(\d{4,})\.(?:params(?:\.npz)?|states|manifest\.json)$")


def list_epochs(prefix):
    """Sorted epochs that have any checkpoint artifact under `prefix`."""
    epochs = set()
    for path in glob.glob(f"{prefix}-*"):
        if ".tmp." in path:
            continue
        m = _EPOCH_FILE_RE.search(path)
        if m:
            epochs.add(int(m.group(1)))
    return sorted(epochs)


def checkpoint_files(prefix, epoch):
    """Every file belonging to ONE epoch: manifest-listed files carrying
    this epoch's tag, the manifest itself, plus on-disk ``prefix-NNNN.*``
    strays.  Files shared across epochs (``prefix-symbol.json``) are
    excluded — retention must never delete them."""
    tag = f"-{int(epoch):04d}."
    found = set()
    mp = manifest_path(prefix, epoch)
    if os.path.exists(mp):
        found.add(mp)
        try:
            man = read_manifest(prefix, epoch)
            d = os.path.dirname(os.path.abspath(mp))
            for name in man["files"]:
                if tag in name and os.path.exists(os.path.join(d, name)):
                    found.add(os.path.join(d, name))
        except CheckpointCorrupt:
            pass
    for p in glob.glob(f"{prefix}{tag}*"):
        if ".tmp." not in p:
            found.add(p)
    return sorted(found)


def apply_retention(prefix, keep_last, known_verified=None):
    """Delete all but the newest `keep_last` epochs' files.

    The newest *verified* epoch is always kept even when it falls outside
    the window (if the newer epochs are all corrupt, deleting the last good
    one would leave nothing to resume from).  A caller that just committed
    an epoch passes it as `known_verified` to skip the full from-disk
    re-hash of files it wrote moments ago.  Returns the epochs removed."""
    if not keep_last or int(keep_last) < 1:
        return []
    epochs = list_epochs(prefix)
    if len(epochs) <= int(keep_last):
        return []
    keep = set(epochs[-int(keep_last):])
    if known_verified is not None and int(known_verified) >= epochs[-1]:
        keep.add(int(known_verified))  # newest epoch, verified by caller
    else:
        nv = newest_verified_epoch(prefix)
        if nv is not None:
            keep.add(nv)
    removed = []
    for e in epochs:
        if e in keep:
            continue
        for p in checkpoint_files(prefix, e):
            try:
                os.remove(p)
            except OSError:
                pass
        removed.append(e)
    if removed:
        log.info("retention(prefix=%s, keep_last=%s): removed epochs %s",
                 prefix, keep_last, removed)
    return removed


# ---------------------------------------------------------------------------
# preemption handling
# ---------------------------------------------------------------------------
class PreemptionHandler:
    """Installed SIGTERM/SIGINT hook: one emergency save, then exit.

    A preemption delivers SIGTERM with a grace window; the hook runs
    `save_fn` exactly once (reentrancy-guarded — a second signal during the
    save does not restart it), restores the previous handlers, and exits
    with the conventional ``128+signum`` unless ``exit=False`` (tests).
    Use :func:`preemption_handler` to construct; call ``uninstall()`` when
    the training loop exits normally."""

    def __init__(self, save_fn, signals, exit, exit_code,
                 blackbox_prefix=None):
        self._save_fn = save_fn
        self._signals = tuple(signals)
        self._exit = exit
        self._exit_code = exit_code
        self._blackbox_prefix = blackbox_prefix
        self._prev = {}
        self._lock = threading.Lock()
        self.triggered = False
        self.save_ok = None

    def install(self):
        for sig in self._signals:
            self._prev[sig] = signal.signal(sig, self._handle)
        return self

    def uninstall(self):
        for sig, prev in self._prev.items():
            try:
                signal.signal(sig, prev)
            except (ValueError, OSError):  # not main thread / torn down
                pass
        self._prev = {}

    def _handle(self, signum, frame):
        with self._lock:
            if self.triggered:
                return
            self.triggered = True
        log.warning("signal %d: writing emergency checkpoint before exit",
                    signum)
        try:
            self._save_fn()
            self.save_ok = True
        except BaseException:
            self.save_ok = False
            log.exception("emergency checkpoint failed; exiting anyway")
        _tracing.emit("checkpoint.preemption", signum=int(signum),
                      save_ok=bool(self.save_ok))
        if self._blackbox_prefix:
            # the preemption black box: what the run was doing when the
            # platform killed it (a dump failure must not eat the grace
            # window's remaining seconds — the emergency save landed)
            try:
                _tracing.dump_blackbox(
                    self._blackbox_prefix,
                    reason=f"preemption signal {signum} "
                           f"(emergency save_ok={self.save_ok})")
            except Exception:
                log.exception("preemption black-box dump failed")
        self.uninstall()
        if self._exit:
            code = self._exit_code if self._exit_code is not None \
                else 128 + signum
            sys.exit(code)


def preemption_handler(save_fn, signals=(signal.SIGTERM, signal.SIGINT),
                       exit=True, exit_code=None, blackbox_prefix=None):
    """Install SIGTERM/SIGINT hooks that run one emergency atomic save.

    ``save_fn`` should be a zero-arg durable saver, e.g.::

        handle = checkpoint.preemption_handler(
            lambda: elastic.save_checkpoint(prefix, epoch_box[0],
                                            net=net, trainer=trainer))

    ``blackbox_prefix=`` additionally dumps a flight-recorder black box
    (``<prefix>-blackbox.json``) after the
    emergency save, so a preempted run leaves its last-N-steps timeline
    behind, not just its weights.  Returns the installed
    :class:`PreemptionHandler` (``.uninstall()`` on clean shutdown;
    ``.triggered`` / ``.save_ok`` for inspection)."""
    return PreemptionHandler(save_fn, signals, exit, exit_code,
                             blackbox_prefix=blackbox_prefix).install()
