"""``mx.model``: checkpoints of a symbol and its parameters, from
``tpu_mx/model.py``: ``<prefix>-symbol.json`` beside
``<prefix>-NNNN.params`` (``nd.save``'s container, keys ``arg:<name>``
and ``aux:<name>``), the files the reference writes and reads.
"""
from __future__ import annotations

import os
import time

from .ndarray import ndarray as _nd
from .symbol import load as _sym_load

__all__ = ["save_checkpoint", "load_checkpoint", "BatchEndParam"]

from .module.module import BatchEndParam  # noqa: E402 — as the reference's


def save_checkpoint(prefix, epoch, symbol, arg_params, aux_params,
                    remove_amp_cast=True, extra_files=()):
    """Write the epoch's symbol and parameters, each atomically, and then
    commit its manifest (:mod:`tpu_mx_torch.checkpoint`) last: a crash
    part way leaves the previous epoch the newest verified one.

    ``extra_files``: sidecars already written (the epoch's training
    capsule) for the manifest to list before the commit."""
    from . import checkpoint as _ckpt
    from . import telemetry as _telemetry
    from . import tracing as _tracing
    t_save = time.perf_counter()
    with _telemetry.span("checkpoint.save_seconds"):
        extra = None
        if symbol is not None:
            sym_file = f"{prefix}-symbol.json"
            symbol.save(sym_file)
            # the symbol file is shared by every epoch and rewritten by
            # each save: listed in an epoch's manifest it would make every
            # older epoch corrupt when the symbol changed.  Its digest at
            # save time rides the manifest's unverified "shared" table.
            extra = {"shared": {os.path.basename(sym_file):
                                _ckpt._file_entry(sym_file)}}
        save_dict = {f"arg:{k}": v for k, v in (arg_params or {}).items()}
        save_dict.update({f"aux:{k}": v
                          for k, v in (aux_params or {}).items()})
        params = f"{prefix}-{epoch:04d}.params"
        _nd.save(params, save_dict)
        _ckpt.write_manifest(prefix, epoch, [params, *extra_files],
                             extra=extra)
    _tracing.emit("checkpoint.save", t0=t_save, t1=time.perf_counter(),
                  prefix=os.path.basename(str(prefix)), epoch=int(epoch))


def load_checkpoint(prefix, epoch):
    """``(symbol, arg_params, aux_params)`` of a checkpoint (either
    package's), the arrays on the current context."""
    symbol = _sym_load(f"{prefix}-symbol.json")
    arg_params, aux_params = {}, {}
    for k, v in _nd.load(f"{prefix}-{epoch:04d}.params").items():
        kind, name = k.split(":", 1)
        if kind == "arg":
            arg_params[name] = v
        elif kind == "aux":
            aux_params[name] = v
    return symbol, arg_params, aux_params
