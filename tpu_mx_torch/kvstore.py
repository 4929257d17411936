"""KVStore, the data-parallel communication facade, from
``tpu_mx/kvstore.py``.

- ``local`` / ``device`` / ``nccl``: in-process aggregation — ``push``
  sums the per-device list, ``pull`` hands the sum out;
- ``dist_sync`` and the other ``dist_*`` stores: one process a worker,
  joined into a ``torch.distributed`` group from the launcher's
  environment (``TPUMX_COORDINATOR`` / ``TPUMX_NUM_PROC`` /
  ``TPUMX_PROC_ID``; :func:`dist_init`, run at ``import tpu_mx_torch``).
  ``push`` gathers each key from every rank and sums the copies on the
  host in rank order, as the reference's ``_global_sum`` does.  The
  group's backend is ``gloo``, staged through host memory like the
  reference's allgather: two ranks may share one card, which NCCL
  refuses.  ``dist_async`` has ``dist_sync``'s semantics, as in the
  reference.  The group is the launch-time world; it is not re-formed
  when an elastic fleet's membership changes.

``set_optimizer`` applies the optimizer here (there is no server tier).
Every push records the checksum of the committed aggregate and every
pull checks it, so an aggregate corrupted in between raises
:class:`IntegrityError`.  The checksum is taken where the payload lies:
crc32 of its bytes on the host, as the reference's; on the card the sum
of its words, computed there (one reduction a key, no copy), and a pull
of many keys compares all of them in one host read.  A pull into the
array that already holds the aggregate hands nothing out and checks
nothing.
"""
from __future__ import annotations

import logging
import os
import pickle
import zlib

import torch

from .base import MXNetError
from .ndarray import NDArray
from .optimizer import Updater
from . import telemetry as _telemetry
from . import tracing as _tracing

__all__ = ["KVStore", "IntegrityError", "create", "dist_init"]


class IntegrityError(MXNetError):
    """A pulled aggregate no longer matches the checksum recorded when it
    was pushed: the payload was corrupted between the two ends of the
    sync seam."""


def _tensor(arr):
    return arr._data if isinstance(arr, NDArray) else torch.as_tensor(arr)


_WORDS = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def _payload_checksum(arr):
    """The payload's checksum, taken where it lies (None when it has
    none to read): on the host the crc32 of its exact bytes (an int); on
    the card the sum of its words as a 0-d int64 tensor there, which
    changes with any one word."""
    try:
        t = _tensor(arr).detach()
        if t.device.type == "cpu":
            t = t.contiguous().reshape(-1)
            return zlib.crc32(t.view(torch.uint8).numpy())
        return _word_sum(t)
    except Exception:  # noqa: BLE001 — never break push/pull on a checksum
        return None


def _word_sum(t):
    """The sum of ``t``'s words (its elements' bits as integers of their
    width, 64 bits past 8 bytes), a 0-d int64 tensor on its device: one
    reduction, no host read."""
    word = _WORDS.get(t.element_size())
    if word is None:        # wider elements: their 64-bit words
        return t.reshape(-1).view(torch.int64).sum()
    return t.view(word).sum(dtype=torch.int64)


def _mismatches(expects, actuals):
    """Indices where a pulled checksum differs from the pushed one; the
    card's are compared together, in one host read."""
    bad, on_card = [], []
    for i, (e, a) in enumerate(zip(expects, actuals)):
        if e is None or a is None:
            continue
        if isinstance(e, torch.Tensor) and isinstance(a, torch.Tensor):
            on_card.append(i)
        elif e != a:
            bad.append(i)
    if on_card:
        dev = expects[on_card[0]].device
        e = torch.stack([expects[i].to(dev) for i in on_card])
        a = torch.stack([actuals[i].to(dev) for i in on_card])
        bad += [i for i, ne in zip(on_card, (e != a).tolist()) if ne]
    return sorted(bad)


def _shown(checksum):
    if isinstance(checksum, torch.Tensor):
        return f"word sum={int(checksum)}"
    return f"crc32={checksum:#010x}"


def _nbytes(arr):
    """Payload size of an array, for the transfer counters."""
    try:
        t = _tensor(arr)
        return t.numel() * t.element_size()
    except Exception:  # noqa: BLE001
        return 0


def _group():
    """``torch.distributed`` when this process is in a group, else None."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist
    return None


def dist_init():
    """Join the launcher's collective group (``base.dist_boot``; ``import
    tpu_mx_torch`` already joins).  Returns whether this process is in
    it."""
    from .base import dist_boot
    return dist_boot()


class KVStore:
    def __init__(self, kind="local"):
        self.type = kind
        self._store = {}
        self._checksums = {}   # key -> checksum recorded at push commit
        self._updater = None
        self._optimizer = None
        self._compression = None
        self._is_dist = kind.startswith("dist")
        self._fleet_token = None
        self._rank, self._num_workers = 0, 1
        if self._is_dist:
            self._read_group()
            from .parallel import fleet as _fleet
            self._fleet_token = _fleet.generation_token()

    # -- identity -------------------------------------------------------------
    def _read_group(self):
        dist = _group()
        if dist is not None:
            self._rank, self._num_workers = dist.get_rank(), \
                dist.get_world_size()

    def _refresh_world(self):
        """Re-read rank and world size when the fleet's membership epoch
        moved (a token compare per access)."""
        if not self._is_dist:
            return
        from .parallel import fleet as _fleet
        token = _fleet.generation_token()
        if token == self._fleet_token:
            return
        self._fleet_token = token
        self._read_group()
        # while a fleet is live its epoch is the world-size authority (the
        # group is the static launch-time world)
        live = _fleet.live_world_size()
        if live:
            self._num_workers = int(live)

    @property
    def rank(self):
        self._refresh_world()
        return self._rank

    @property
    def num_workers(self):
        self._refresh_world()
        return self._num_workers

    # -- core API -------------------------------------------------------------
    def init(self, key, value):
        keys, values = self._normalize(key, value)
        for k, v in zip(keys, values):
            self._store[k] = v[0].copy() if isinstance(v, list) else v.copy()

    def push(self, key, value, priority=0):
        """Aggregate gradients: sum over the per-device list, compress
        (with error feedback) where set, then for a ``dist_*`` store the
        cross-process sum; with an updater, apply it to the stored value.
        The committed payload's checksum is recorded."""
        keys, values = self._normalize(key, value)
        pushes = nbytes = checksums = 0
        try:
            for k, v in zip(keys, values):
                self._check_inited(k)
                vlist = v if isinstance(v, list) else [v]
                pushes += 1
                nbytes += sum(_nbytes(x) for x in vlist)
                agg = vlist[0]
                for extra in vlist[1:]:
                    agg = agg + extra
                if self._compression is not None:
                    # keyed by id() of the aggregate, as the reference
                    # keys it
                    agg = self._compression.compress_decompress(agg)
                agg = self._global_sum(agg)
                if self._updater is not None:
                    self._updater(k, agg, self._store[k])
                    committed = self._store[k]
                else:
                    self._store[f"_pending_{k}"] = agg
                    committed = agg
                crc = _payload_checksum(committed)
                if crc is not None:
                    self._checksums[k] = crc
                    checksums += 1
        finally:
            # the counters move once a call, by what this call pushed
            _telemetry.counter("kvstore.pushes").inc(pushes)
            _telemetry.counter("kvstore.push_bytes").inc(nbytes)
            _telemetry.counter("kvstore.checksums").inc(checksums)

    def _global_sum(self, agg):
        """Cross-process sum: gather ``agg`` from every rank through host
        memory and add the copies in rank order (16-bit floats in
        float32), cast back to ``agg``'s type and device.  Every rank
        must push the same keys in the same order."""
        if not self._is_dist or self.num_workers <= 1:
            return agg
        if os.environ.get("TPUMX_STRICT_KVSTORE", "0") == "1":
            raise MXNetError(
                "eager dist KVStore push is the slow parity path "
                "(allgather-per-key + host reduce) and "
                "TPUMX_STRICT_KVSTORE=1 is set: move gradient reduction "
                "into the compiled step (parallel.CompiledTrainStep / "
                "Trainer without update_on_kvstore), or unset the flag to "
                "accept the degraded path")
        if not getattr(self, "_warned_eager_dist", False):
            self._warned_eager_dist = True
            logging.getLogger(__name__).warning(
                "dist KVStore eager push: allgather-per-key with a host-side "
                "reduce (W× reduce bytes, one collective per key). This is "
                "the parity/debug path — at scale the reduction belongs "
                "inside parallel.CompiledTrainStep (Trainer with "
                "update_on_kvstore on a dist_* store takes THIS slow path)")
        dist = _group()
        t = agg._data
        host = t.detach().cpu().contiguous()
        parts = [torch.empty_like(host) for _ in range(dist.get_world_size())]
        dist.all_gather(parts, host)
        wide = torch.float32 if host.dtype in (torch.float16,
                                               torch.bfloat16) \
            else host.dtype
        acc = parts[0].to(wide)
        for part in parts[1:]:
            acc = acc + part.to(wide)
        return NDArray(acc.to(t.dtype).to(t.device))

    def _check_inited(self, key):
        """Push or pull on a key nobody init'ed is a usage error."""
        if key not in self._store:
            raise MXNetError(
                f"key {key!r} not initialized; call kv.init first")

    def pull(self, key, out=None, priority=0, ignore_sparse=True):
        """Hand out the last push's aggregate (or, with an updater, the
        updated value) into ``out`` after checking its push-time
        checksum; a mismatch raises :class:`IntegrityError` and hands
        nothing out.  A list of keys is checked in one pass.  A key
        pulled into the very array that holds its aggregate (a one-copy
        store's push and pull of the same gradient, as ``Trainer`` does)
        hands nothing out, so nothing is read or checked for it."""
        keys, outs = self._normalize(key, out)
        srcs, handed = [], []
        for k, o in zip(keys, outs):
            self._check_inited(k)
            pending = self._store.pop(f"_pending_{k}", None)
            src = self._store[k] if pending is None else pending
            if self._updater is None and pending is not None:
                self._store[k] = pending
            srcs.append(src)
            handed.append(any(dst is not src for dst in
                              (o if isinstance(o, list) else [o])))
        expects = [self._checksums.get(k) if h else None
                   for k, h in zip(keys, handed)]
        actuals = [None if e is None else _payload_checksum(s)
                   for e, s in zip(expects, srcs)]
        bad = _mismatches(expects, actuals)
        if bad:
            i, k = bad[0], keys[bad[0]]
            _telemetry.counter("kvstore.checksum_failures").inc()
            _tracing.emit("kvstore.checksum_fail", key=str(k))
            raise IntegrityError(
                f"kvstore pull({k!r}): payload checksum mismatch "
                f"(pushed {_shown(expects[i])}, pulled "
                f"{_shown(actuals[i])}) — the aggregate was silently "
                "corrupted after its push committed; refusing to hand "
                "out poisoned bytes")
        nbytes = 0
        for o, src in zip(outs, srcs):
            olist = o if isinstance(o, list) else [o]
            nbytes += _nbytes(src) * len(olist)
            for dst in olist:
                if dst is not src:
                    src.copyto(dst)
        _telemetry.counter("kvstore.pulls").inc(len(keys))
        _telemetry.counter("kvstore.pull_bytes").inc(nbytes)

    def pushpull(self, key, value, out=None, priority=0):
        self.push(key, value, priority)
        self.pull(key, out if out is not None else value, priority)

    def row_sparse_pull(self, key, out=None, priority=0, row_ids=None):
        """The reference's: a dense ``out`` gets the whole value (the
        store's values are dense, ``row_ids`` selects nothing), and a
        ``RowSparseNDArray`` ``out`` is refused by ``copyto``
        (``TypeError``)."""
        self.pull(key, out, priority)

    # -- optimizer offload ----------------------------------------------------
    def set_optimizer(self, optimizer):
        """The optimizer runs here; it goes through pickle as the
        reference's did on its way to a server, so it must pickle."""
        self._optimizer = pickle.loads(pickle.dumps(optimizer))
        self._updater = Updater(self._optimizer)

    def set_updater(self, updater):
        self._updater = updater

    def set_gradient_compression(self, compression_params):
        from .contrib.compression import GradientCompression
        self._compression = GradientCompression(**compression_params)

    # -- persistence ----------------------------------------------------------
    def save_optimizer_states(self, fname, dump_optimizer=False):
        """Commit the updater's per-key states (numpy arrays, a bfloat16
        one as the reference writes it) through ``checkpoint.atomic_write``;
        with ``dump_optimizer=True`` the optimizer rides along in the
        ``kvstore-states-v2`` document."""
        from .checkpoint import atomic_write
        from .gluon.trainer import _to_file
        states = self._updater.get_states() if self._updater else {}
        states = {k: _to_file(s) for k, s in states.items()}
        if dump_optimizer:
            payload = {"__tpumx_format__": "kvstore-states-v2",
                       "states": states, "optimizer": self._optimizer}
        else:
            payload = states
        with atomic_write(fname) as f:
            f.write(pickle.dumps(payload))

    def load_optimizer_states(self, fname):
        """Read :meth:`save_optimizer_states`' file (either document);
        the states land on the stored values' devices."""
        from .gluon.trainer import _StatesUnpickler
        with open(fname, "rb") as f:
            payload = _StatesUnpickler(f).load()
        if isinstance(payload, dict) and \
                payload.get("__tpumx_format__") == "kvstore-states-v2":
            if payload["optimizer"] is not None:
                self._optimizer = payload["optimizer"]
                self._updater = Updater(self._optimizer)
            payload = payload["states"]
        if self._updater:
            self._updater.set_states(self._placed(payload))

    def _placed(self, states):
        from .gluon.trainer import _from_file
        out = {}
        for k, s in states.items():
            like = self._store[k]._data if k in self._store \
                else torch.empty(0)
            out[k] = _from_file(s, like)
        return out

    def barrier(self):
        if self._is_dist and _group() is not None:
            _group().barrier()

    def _barrier(self):
        self.barrier()

    @staticmethod
    def _normalize(key, value):
        if isinstance(key, (list, tuple)):
            return list(key), list(value)
        return [key], [value]

    def __repr__(self):
        return f"KVStore(type={self.type}, rank={self.rank}/{self.num_workers})"


def create(name="local"):
    """``mx.kv.create``: the reference's store types."""
    valid = {"local", "local_allreduce_cpu", "local_allreduce_device", "device",
             "nccl", "dist", "dist_sync", "dist_async", "dist_sync_device",
             "dist_async_device", "dist_device_sync", "horovod", "p3"}
    if name not in valid:
        raise MXNetError(f"unknown KVStore type {name}")
    return KVStore(name)
