"""Engine control API, from ``tpu_mx/engine.py``.

The reference's dependency engine scheduled every NDArray mutation on
per-device thread pools; Python exposes ``bulk`` (op bulking) and the
engine's type.  In the port the "engine" is PyTorch's asynchronous
launch onto the card's current stream, plus the fusion segments of
:mod:`tpu_mx_torch.fusion`.

Inside a ``bulk(size)`` scope fusible imperative ops (elementwise,
broadcast, cast, the reduction tails, ``sgd_update``) are deferred onto
a pending segment and flushed as one unit at any barrier (a read of the
tensor, a non-fusible consumer, an autograd tape boundary, ``size`` ops,
the scope's exit): replayed eagerly on the CPU, and on the card as one
replay of a captured CUDA graph.  ``TPUMX_FUSION=0`` restores plain
eager dispatch exactly, ``TPUMX_FUSION=1`` fuses outside ``bulk`` scopes
too.  ``bulk_stats()`` gives the engine's counters.

The wait functions flush the pending segment, then synchronize the card.
"""
from __future__ import annotations

import contextlib
import os

from . import fusion as _fusion

__all__ = ["bulk", "set_bulk_size", "wait_for_all", "engine_type",
           "push_async", "push_sync", "bulk_stats", "reset_bulk_stats"]

try:
    _bulk_size = int(os.environ.get("MXNET_ENGINE_BULK_SIZE", "15"))
except ValueError:
    _bulk_size = 15


def engine_type():
    """Name of the active scheduler.  The reference names NaiveEngine/
    ThreadedEngine/ThreadedEnginePerDevice; here scheduling is PyTorch's
    asynchronous stream launch plus the lazy fusion segments."""
    return "TorchStreamDispatch"


def set_bulk_size(size):
    """Set the most ops a fused segment holds; returns the previous value.
    It applies to segments started after the call; a size <= 1 means no
    bulking."""
    global _bulk_size
    prev, _bulk_size = _bulk_size, int(size)
    return prev


@contextlib.contextmanager
def bulk(size):
    """Scope within which fusible imperative ops are bulked into lazily
    flushed segments of up to ``size`` ops.  Scope exit is a flush
    barrier.  ``size <= 1`` disables bulking for the scope, also under
    ``TPUMX_FUSION=1`` (the reference's MXNET_ENGINE_BULK_SIZE=0/1 escape
    hatch: op-by-op execution, e.g. to see a deferred error at its
    call)."""
    prev = set_bulk_size(size)
    fusing = int(size) > 1
    if fusing:
        _fusion.enter_scope()
    else:
        _fusion.enter_suppress()
    try:
        yield
    finally:
        if fusing:
            _fusion.exit_scope()  # flushes the pending segment
        else:
            _fusion.exit_suppress()
        set_bulk_size(prev)


def bulk_stats():
    """Engine bulking counters: ops_fused, segments_flushed, cache hits
    and misses, flush reasons.  Cumulative per process; reset with
    ``reset_bulk_stats()``."""
    out = dict(_fusion.stats)
    out["flush_reasons"] = dict(_fusion.stats["flush_reasons"])
    return out


def reset_bulk_stats():
    _fusion.reset_stats()


def wait_for_all():
    """Block until all issued computation has finished (the reference's
    ``Engine::WaitForAll``); a pending fused segment flushes first."""
    from .ndarray import waitall
    waitall()


def push_async(fn, read_arrays=(), write_arrays=(), name="external_op"):
    """External-op injection point (the reference's MXEnginePushAsync).

    There is no dependency engine to register with: the reads are waited
    for (``wait_to_read``), then ``fn(read_arrays, write_arrays)`` runs on
    the host thread and may rebind its outputs (``NDArray._rebind``)."""
    for a in read_arrays:
        wait = getattr(a, "wait_to_read", None)
        if wait is not None:
            wait()
    return fn(list(read_arrays), list(write_arrays))


push_sync = push_async  # dispatch is synchronous from Python's view
