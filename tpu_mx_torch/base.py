"""Framework-level errors of the PyTorch/CUDA port.

Copies of the reference's exception classes, module constants and
helpers (``logger``, ``string_types``, ``numeric_types``, ``check``,
``get_env``, ``Registry``; ``tpu_mx/base.py``):
the port never imports ``tpu_mx`` — doing so would boot its distributed
runtime and import jax — so what it needs lives here under the same
names.  :class:`NumericDivergence` lives in
:mod:`tpu_mx_torch.supervisor`, as in the reference, and is re-exported
here.
"""
from __future__ import annotations

import logging
import numbers
import os

__all__ = ["Registry", "MXNetError", "NumericDivergence", "check",
           "get_env", "refuse_unported", "dist_boot", "backend_for",
           "string_types", "numeric_types"]

logger = logging.getLogger("tpu_mx_torch")
string_types = (str,)
numeric_types = (numbers.Number,)


class MXNetError(RuntimeError):
    """Framework-level error (name kept for API familiarity with the reference)."""


def check(cond, msg="check failed"):
    """Raise :class:`MXNetError` with ``msg`` if ``cond`` is false (the
    reference's ``CHECK``)."""
    if not cond:
        raise MXNetError(msg)


def get_env(name, default=None, dtype=str):
    """Environment variable ``name`` as ``dtype`` (``bool`` reads
    ``1``/``true``/``yes``/``on``), or ``default`` when unset."""
    val = os.environ.get(name)
    if val is None:
        return default
    if dtype is bool:
        return val.lower() in ("1", "true", "yes", "on")
    return dtype(val)


class Registry:
    """A named registry of classes or factories with aliases, looked up
    without regard to case (the reference's ``base.Registry``, behind
    ``metric.create``)."""

    def __init__(self, name):
        self.name = name
        self._entries = {}

    def register(self, obj=None, *, name=None, aliases=()):
        """Register ``obj`` under its lower-cased ``__name__`` (or
        ``name``) and each of ``aliases``; usable bare or with
        arguments."""
        def add(o):
            for key in (name or o.__name__, *aliases):
                self._entries[key.lower()] = o
            return o
        return add(obj) if obj is not None else add

    def get(self, key):
        k = key.lower()
        if k not in self._entries:
            raise KeyError(f"{self.name} registry has no entry '{key}'. "
                           f"Known: {sorted(self._entries)}")
        return self._entries[k]

    def create(self, key, *args, **kwargs):
        return self.get(key)(*args, **kwargs)

    def __contains__(self, key):
        return key.lower() in self._entries

    def keys(self):
        return sorted(self._entries)


def _is_default(value, default):
    if value is default:
        return True
    if type(value) is bool or type(default) is bool:
        return type(value) is type(default) and value == default
    if isinstance(value, (int, float)) and isinstance(default, (int, float)):
        return value == default
    return type(value) is type(default) and value == default


def refuse_unported(owner, item, **args):
    """Raise :class:`MXNetError` for the first of the reference's
    arguments that the port accepts but does not implement yet, if it is
    set to anything but the reference's default.  ``args`` maps each
    name to ``(value, default)``; ``item`` names the ROADMAP item that
    ports it."""
    for name, (value, default) in args.items():
        if not _is_default(value, default):
            raise MXNetError(f"{owner}({name}={value!r}) is not ported yet "
                             f"(ROADMAP {item})")


#: seconds the launcher's rendezvous and each collective may wait
DIST_TIMEOUT_SECONDS = 300


def backend_for(device_type, ranks_per_card):
    """The collective backend, a pure function of where the ranks
    compute: ``"nccl"`` for CUDA ranks that own a card each, ``"gloo"``
    (host memory) for host processes and for ranks that share a card,
    which NCCL refuses."""
    return "nccl" if device_type == "cuda" and ranks_per_card == 1 \
        else "gloo"


def dist_boot():
    """Join the multi-process collective group from the launcher's
    environment (``tpu_mx_torch.tools.launch``: ``TPUMX_COORDINATOR``
    host:port of rank 0, ``TPUMX_NUM_PROC``, ``TPUMX_PROC_ID``), as the
    reference's ``dist_boot`` joins ``jax.distributed``.  The group is
    ``torch.distributed`` over ``gloo``, through host memory: the join
    comes at import, before a rank has chosen where it computes, and the
    group's own users (the ``dist_*`` kvstore, meshes of host ranks)
    hand it host tensors.  A mesh whose ranks compute on cards of their
    own makes its groups over :func:`backend_for` of their devices
    (``parallel.mesh``).  Each rank leaves the group at exit, so its
    threads are joined before the interpreter tears down (left to the
    teardown, a rank could abort there).  Returns True iff this process
    is in a group of that size."""
    import os
    coord = os.environ.get("TPUMX_COORDINATOR")
    if not coord:
        return False
    import atexit
    import datetime
    import torch.distributed as dist
    world = int(os.environ["TPUMX_NUM_PROC"])
    if dist.is_initialized():
        return dist.get_world_size() == world
    dist.init_process_group(
        "gloo", init_method=f"tcp://{coord}", world_size=world,
        rank=int(os.environ["TPUMX_PROC_ID"]),
        timeout=datetime.timedelta(seconds=DIST_TIMEOUT_SECONDS))
    atexit.register(_dist_shutdown)
    return True


def _dist_shutdown():
    """Leave the group at exit.  No barrier: a rank that exits on an
    error must not wait for peers still inside a collective."""
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()


def __getattr__(name):
    # supervisor.py imports this module: resolved at first use
    if name == "NumericDivergence":
        from .supervisor import NumericDivergence
        return NumericDivergence
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
