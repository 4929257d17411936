"""Durable file writes: the ``atomic_write`` of ``tpu_mx/checkpoint.py``.

The serving journal's compaction, the capacity forensic dumps and the
black box commit whole files through :func:`atomic_write`: the bytes go
to ``<path>.tmp.<pid>`` in the same directory, are flushed and fsync'd,
and only then renamed over ``path`` (and the directory fsync'd), so a
process killed at any instant leaves the previous complete file or tmp
debris, never a torn destination.  The reference module's manifests,
verification, retention and preemption hooks are the training
checkpoint plane, not ported yet (ROADMAP A item 8).
"""
from __future__ import annotations

import contextlib
import os
import time

from . import telemetry as _telemetry

__all__ = ["atomic_write"]


def _fsync_dir(dirname):
    """fsync the directory so the rename itself is durable (best effort:
    not every filesystem lets a directory be opened)."""
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
    """Crash-safe file write, all-or-nothing through tmp + rename::

        with atomic_write(fname, "w") as f:
            f.write(payload)

    ``mode`` is ``"wb"`` or ``"w"`` (text, utf-8).  On an exception the
    tmp file is removed and an existing ``path`` is left untouched."""
    if mode not in ("wb", "w"):
        raise ValueError(f"atomic_write: mode must be 'wb' or 'w', got {mode}")
    t_start = time.perf_counter()
    ap = os.path.abspath(os.fspath(path))
    dirname = os.path.dirname(ap)
    if dirname and not os.path.isdir(dirname):
        os.makedirs(dirname, exist_ok=True)
    tmp = f"{ap}.tmp.{os.getpid()}"
    raw = open(tmp, mode, encoding="utf-8" if mode == "w" else None)
    try:
        yield raw
        raw.flush()
        if fsync:
            os.fsync(raw.fileno())
        raw.close()
        os.replace(tmp, ap)
        if fsync:
            _fsync_dir(dirname)
        _telemetry.counter("checkpoint.atomic_writes").inc()
        _telemetry.histogram("checkpoint.write_seconds").observe(
            time.perf_counter() - t_start)
    except BaseException:
        try:
            raw.close()
        except OSError:
            pass
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise
