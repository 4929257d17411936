"""Data iterators, from ``tpu_mx/io/io.py``: ``DataDesc``, ``DataBatch``,
the ``DataIter`` protocol, ``NDArrayIter``, ``ResizeIter``,
``MNISTIter``, ``CSVIter``, ``ImageRecordIter``, ``ImageDetRecordIter``,
``PrefetchingIter`` and ``DevicePrefetchIter``.

``NDArrayIter`` batches in-memory arrays with the reference's last-batch
handling (``pad`` wraps to the epoch's head and reports the overlap in
``getpad()``, ``discard`` drops a short tail, ``roll_over`` carries it
into the next epoch) and shuffles each epoch with
``np.random.RandomState(seed)``, or numpy's global state without a seed,
as the reference does: both packages yield the same batches from the
same seed.  Elastic sharding: ``batch_size`` is the global batch, one
cursor walks one global permutation and rank ``r`` of ``num_workers``
takes the ``r``-th contiguous ``batch_size/num_workers`` of each global
batch, so the global sequence is the same at every world size;
``set_shard`` re-partitions a live iterator, and a sharded state (v2)
loads into an iterator of another world size at the same global batch.
``MNISTIter`` and ``CSVIter`` are ``NDArrayIter``s over the files.
A batch's arrays are made on the current context.
``state_dict``/``load_state_dict`` snapshot the cursor, the epoch's
permutation and the shuffle stream.  ``LibSVMIter`` reads LibSVM text
into CSR batches (:mod:`tpu_mx_torch.ndarray.sparse`).

``ImageRecordIter`` reads JPEG records through the native pipeline
(:mod:`tpu_mx_torch.lib`: decode, resize, crop, mirror and batch on the
library's threads) or, for other records, ``round_batch=False``, or
``use_native=False``, through OpenCV on a thread pool, with the
reference's augmentation draws.  ``use_native=None`` warns and takes
the Python arm where the library cannot be built; ``use_native=True``
raises there.  ``output_dtype="uint8"`` leaves normalisation to the
consumer (``DevicePrefetchIter(normalize=...)`` on the card) and
``output_layout="NHWC"`` emits channels-last.  A native batch is
written into page-locked host memory when the iterator was made under
the card's context, and its arrays are tensors over those buffers.
``ImageDetRecordIter`` is the detection twin: ``(max_objects, 5)``
labels padded with -1, the native pipeline or
:class:`tpu_mx_torch.image.ImageDetIter`.

``PrefetchingIter`` runs wrapped iterators on a background thread
behind a queue of ``depth`` batches, with the reference's lifecycle:
stop-aware puts, so ``close()``, ``reset()`` and leaving a ``with``
block always join the thread; exhaustion and a worker's exception reach
the consumer; ``state_dict`` drains the worker and records the wrapped
iterators' epoch-start state and the batches delivered, and
``load_state_dict`` fast-forwards that many.  The worker runs under the
context the iterator was built in (``with mx.cpu():`` reaches it).
``DevicePrefetchIter`` stages each batch onto the card on that thread:
the wrapped iterators run on the host, each array is copied from pinned
memory on a side stream, normalized in float32 (``normalize=(mean,
std)`` along ``normalize_axis``) and then cast (``cast_data``); an event
on the side stream orders the consumer's stream after the copy, and
each staged tensor is ``record_stream``-ed to the consumer's stream, so
the caching allocator does not hand its memory out early.
"""
from __future__ import annotations

import copy as _copy
import gzip
import logging
import os
import queue
import struct
import threading
import warnings
from collections import namedtuple
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .. import device as _device
from ..base import MXNetError
from ..context import cpu, current_context
from ..ndarray.ndarray import NDArray, _torch_dtype, array

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter", "ResizeIter",
           "PrefetchingIter", "DevicePrefetchIter", "MNISTIter", "CSVIter",
           "ImageRecordIter", "ImageDetRecordIter"]

_logger = logging.getLogger(__name__)


def _check(cond, msg):
    if not cond:
        raise MXNetError(msg)


def _check_state(state, cls_name):
    got = state.get("iter") if isinstance(state, dict) else None
    if got != cls_name:
        raise MXNetError(f"load_state_dict: state was captured from "
                         f"{got!r}, not {cls_name!r}")


def _np_rng_tuple(state):
    """A numpy ``RandomState`` token (also after a JSON round trip) as the
    tuple ``set_state`` takes."""
    return (str(state[0]), np.asarray(state[1], dtype=np.uint32),
            int(state[2]), int(state[3]), float(state[4]))


def _batch_array(a):
    """A fresh host batch (numpy) as an array on the current context: the
    same memory on the host (float64 made float32, as ``nd.array``
    does), one copy to the card.  ``nd.array`` would copy on the host
    too, a copy torch splits over its thread pool, which a data
    pipeline's own threads and workers keep busy."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if t.dtype == torch.float64:
        t = t.float()
    dev = _device.resolve(current_context())
    return NDArray(t if dev.type == "cpu" else t.to(dev))


class DataDesc(namedtuple("DataDesc", ["name", "shape"])):
    """Name, shape, type and layout of one input."""

    def __new__(cls, name, shape, dtype=np.float32, layout="NCHW"):
        ret = super().__new__(cls, name, tuple(shape))
        ret.dtype = dtype
        ret.layout = layout
        return ret

    @staticmethod
    def get_batch_axis(layout):
        return 0 if not layout else layout.find("N")


class DataBatch:
    """One batch: lists of data and label arrays, and the padding."""

    def __init__(self, data, label=None, pad=0, index=None,
                 provide_data=None, provide_label=None):
        self.data = data
        self.label = label if label is not None else []
        self.pad = pad
        self.index = index
        self.provide_data = provide_data
        self.provide_label = provide_label


class DataIter:
    """The iterator protocol: ``reset``, ``next``, ``iter_next``,
    ``getdata``, ``getlabel``, ``getpad``, and the resume protocol
    (``state_dict``/``load_state_dict``)."""

    def __init__(self, batch_size=0):
        self.batch_size = batch_size

    def __iter__(self):
        return self

    def reset(self):
        pass

    def state_dict(self):
        raise NotImplementedError(
            f"{type(self).__name__} does not implement state_dict")

    def load_state_dict(self, state):
        raise NotImplementedError(
            f"{type(self).__name__} does not implement load_state_dict")

    def close(self):
        """Release background resources (the base holds none)."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def next(self):
        if self.iter_next():
            return DataBatch(self.getdata(), self.getlabel(),
                             pad=self.getpad(), index=self.getindex())
        raise StopIteration

    def __next__(self):
        return self.next()

    def iter_next(self):
        raise NotImplementedError

    def getdata(self):
        raise NotImplementedError

    def getlabel(self):
        raise NotImplementedError

    def getindex(self):
        return None

    def getpad(self):
        return 0

    @property
    def provide_data(self):
        raise NotImplementedError

    @property
    def provide_label(self):
        return []


def _pairs(data, default_name):
    """``data`` (an array, a list or a dict of arrays) as ``[(name,
    numpy array)]``."""
    if data is None:
        return []
    if isinstance(data, (np.ndarray, NDArray)):
        data = [(default_name, data)]
    elif isinstance(data, (list, tuple)):
        data = [(f"{default_name}_{i}" if i else default_name, d)
                for i, d in enumerate(data)]
    elif isinstance(data, dict):
        data = sorted(data.items())
    return [(k, v.asnumpy() if isinstance(v, NDArray) else np.asarray(v))
            for k, v in data]


class NDArrayIter(DataIter):
    """Batches over in-memory arrays (see the module's docstring)."""

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 last_batch_handle="pad", data_name="data",
                 label_name="softmax_label", seed=None, num_workers=1,
                 rank=0):
        super().__init__(batch_size)
        self.data = _pairs(data, data_name)
        self.label = _pairs(label, label_name)
        _check(self.data, "NDArrayIter needs at least one data array")
        self.num_data = self.data[0][1].shape[0]
        for k, v in self.data + self.label:
            _check(v.shape[0] == self.num_data,
                   f"array {k} first dim {v.shape[0]} != {self.num_data}")
        _check(last_batch_handle in ("pad", "discard", "roll_over"),
               f"bad last_batch_handle {last_batch_handle}")
        _check(self.num_data >= batch_size, "batch_size larger than dataset")
        self.shuffle = shuffle
        self.last_batch_handle = last_batch_handle
        self.global_batch_size = int(batch_size)
        self._rng = np.random.RandomState(seed) if seed is not None \
            else np.random
        self._leftover = None
        self._global_sel = None
        self.num_workers = 1
        self.rank = 0
        self.set_shard(rank, num_workers)
        self.reset()

    def set_shard(self, rank, num_workers):
        """Re-partition the live global stream: this rank now takes the
        ``rank``-th of ``num_workers`` slices of each global batch; the
        cursor, permutation and shuffle stream are unchanged."""
        num_workers, rank = int(num_workers), int(rank)
        _check(num_workers >= 1, "set_shard: num_workers must be >= 1")
        _check(0 <= rank < num_workers,
               f"set_shard: rank {rank} out of range for {num_workers}")
        _check(self.global_batch_size % num_workers == 0,
               f"set_shard: global batch {self.global_batch_size} not "
               f"divisible by num_workers {num_workers}")
        self.num_workers = num_workers
        self.rank = rank
        self.batch_size = self.global_batch_size // num_workers
        self._sel = None
        self._pad = 0

    @property
    def provide_data(self):
        return [DataDesc(k, (self.batch_size,) + v.shape[1:], v.dtype)
                for k, v in self.data]

    @property
    def provide_label(self):
        return [DataDesc(k, (self.batch_size,) + v.shape[1:], v.dtype)
                for k, v in self.label]

    def reset(self):
        epoch = np.arange(self.num_data)
        if self.shuffle:
            self._rng.shuffle(epoch)
        if self.last_batch_handle == "roll_over" \
                and self._leftover is not None:
            epoch = np.concatenate([self._leftover, epoch])
            self._leftover = None
        self.idx = epoch
        self.cursor = 0
        self._sel = None
        self._global_sel = None
        self._pad = 0

    def iter_next(self):
        n, gbs = len(self.idx), self.global_batch_size
        remaining = n - self.cursor
        if remaining <= 0:
            return False
        gpad = 0
        if remaining >= gbs:
            gsel = self.idx[self.cursor:self.cursor + gbs]
            self.cursor += gbs
        elif self.last_batch_handle == "discard":
            self.cursor = n
            return False
        elif self.last_batch_handle == "roll_over":
            self._leftover = self.idx[self.cursor:]
            self.cursor = n
            return False
        else:                       # pad: wrap to the epoch's head
            gpad = gbs - remaining
            gsel = np.concatenate([self.idx[self.cursor:], self.idx[:gpad]])
            self.cursor = n
        self._global_sel = gsel
        lb = self.batch_size
        lo = self.rank * lb
        self._sel = gsel[lo:lo + lb]
        # the wrapped ids are the global batch's tail: this rank's pad is
        # the part of that tail in its slice
        self._pad = max(0, min(lb, lo + lb - (gbs - gpad))) if gpad else 0
        return True

    def global_batch_ids(self):
        """The sample ids of the last global batch: the same on every
        rank of any world size at the same cursor."""
        return (None if self._global_sel is None
                else np.asarray(self._global_sel).copy())

    def state_dict(self):
        """Cursor, this epoch's permutation, the roll-over tail and the
        shuffle stream, in global sample space, taken between batches; a
        sharded iterator's state (version 2) adds its ``shard``."""
        state = {"iter": type(self).__name__,
                 "version": 1 if self.num_workers == 1 else 2,
                 "cursor": int(self.cursor),
                 "idx": np.asarray(self.idx).copy(),
                 "leftover": (None if self._leftover is None
                              else np.asarray(self._leftover).copy()),
                 "rng": self._rng.get_state()}
        if self.num_workers != 1:
            state["shard"] = {"num_workers": self.num_workers,
                              "rank": self.rank,
                              "global_batch": self.global_batch_size}
        return state

    def load_state_dict(self, state):
        """Take a captured global position; this iterator keeps its own
        ``(rank, num_workers)``.  A version-2 state must come from the
        same global batch; a version-1 state (no shard map) loads only
        into an unsharded iterator."""
        _check_state(state, type(self).__name__)
        shard = state.get("shard")
        if shard is not None:
            captured = int(shard.get("global_batch", -1))
            if captured != self.global_batch_size:
                raise MXNetError(
                    f"load_state_dict: state was captured at global batch "
                    f"{captured}, this iterator uses "
                    f"{self.global_batch_size}")
        elif self.num_workers != 1:
            raise MXNetError(
                "load_state_dict: a version-1 state has no shard map and "
                "may be one worker's local stream; it cannot be "
                f"re-partitioned to num_workers={self.num_workers} (load "
                "it unsharded, then set_shard)")
        self.idx = np.asarray(state["idx"], dtype=np.intp)
        self.cursor = int(state["cursor"])
        lo = state.get("leftover")
        self._leftover = None if lo is None else np.asarray(lo, dtype=np.intp)
        self._rng.set_state(_np_rng_tuple(state["rng"]))
        self._sel = None
        self._global_sel = None
        self._pad = 0

    def _take(self, arrs):
        return [array(v[self._sel]) for _, v in arrs]

    def getdata(self):
        return self._take(self.data)

    def getlabel(self):
        return self._take(self.label)

    def getpad(self):
        return self._pad


class ResizeIter(DataIter):
    """``data_iter`` cut or extended to exactly ``size`` batches an epoch
    (it is reset and read again when it runs out)."""

    def __init__(self, data_iter, size, reset_internal=True):
        super().__init__(data_iter.batch_size)
        self.data_iter = data_iter
        self.size = size
        self.reset_internal = reset_internal
        self.cur = 0
        self.current_batch = None

    @property
    def provide_data(self):
        return self.data_iter.provide_data

    @property
    def provide_label(self):
        return self.data_iter.provide_label

    def reset(self):
        self.cur = 0
        if self.reset_internal:
            self.data_iter.reset()

    def state_dict(self):
        return {"iter": "ResizeIter", "version": 1, "cur": int(self.cur),
                "internal": self.data_iter.state_dict()}

    def load_state_dict(self, state):
        _check_state(state, "ResizeIter")
        self.cur = int(state["cur"])
        self.data_iter.load_state_dict(state["internal"])
        self.current_batch = None

    def close(self):
        self.data_iter.close()

    def iter_next(self):
        if self.cur == self.size:
            return False
        try:
            self.current_batch = self.data_iter.next()
        except StopIteration:
            self.data_iter.reset()
            self.current_batch = self.data_iter.next()
        self.cur += 1
        return True

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getpad(self):
        return self.current_batch.pad


class PrefetchingIter(DataIter):
    """Wrapped iterator(s) run on a background thread behind a queue of
    ``depth`` batches (see the module's docstring)."""

    def __init__(self, iters, depth=2):
        if not isinstance(iters, (list, tuple)):
            iters = [iters]
        super().__init__(iters[0].batch_size)
        self.iters = iters
        self.depth = depth
        self._ctx = current_context()
        self._queue = None
        self._thread = None
        self._buffered = []      # drained but not yet delivered
        self._delivered = 0      # batches handed out this epoch
        self._exhausted = False
        self._epoch_state = self._capture_epoch_state()
        self._start()

    @property
    def provide_data(self):
        return sum([i.provide_data for i in self.iters], [])

    @property
    def provide_label(self):
        return sum([i.provide_label for i in self.iters], [])

    def _capture_epoch_state(self):
        try:
            return [it.state_dict() for it in self.iters]
        except NotImplementedError:
            return None

    def _worker_context(self):
        """The context the wrapped iterators run in."""
        return self._ctx

    def _start(self):
        self._queue = queue.Queue(maxsize=self.depth)
        self._stop = threading.Event()
        self._overflow = []
        stop, q, overflow = self._stop, self._queue, self._overflow

        def put(item):
            # a full queue never wedges the worker past a stop; an item
            # already produced is kept for _pause (the wrapped iterator
            # has moved past it)
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            overflow.append(item)
            return False

        def worker():
            try:
                with self._worker_context():
                    while not stop.is_set():
                        batches = [it.next() for it in self.iters]
                        if not put(self._transform(batches)):
                            return
            except StopIteration:
                put(None)
            except Exception as e:  # noqa: BLE001 — raised to the consumer
                put(e)

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def _transform(self, batches):
        """Run on the prefetch thread before a batch is queued."""
        return batches

    def _receive(self, item):
        """Run on the consumer's thread when a batch is handed out."""
        return item

    def _drain(self):
        if self._queue is None:
            return
        try:
            while True:
                self._buffered.append(self._queue.get_nowait())
        except queue.Empty:
            pass

    def _pause(self, timeout=None, detach=False):
        """Stop and join the prefetch thread, keeping the items it made
        in order; True once it is down.  On a timeout (a wrapped iterator
        blocked in ``next()``) ``detach`` abandons the daemon thread, which
        exits when the call returns."""
        import time
        t = self._thread
        if t is None:
            return True
        self._stop.set()
        deadline = None if timeout is None else time.time() + timeout
        while t.is_alive():
            self._drain()
            t.join(timeout=0.1)
            if deadline is not None and time.time() > deadline:
                _logger.warning("PrefetchingIter: the prefetch thread did "
                                "not stop within %.1fs%s", timeout,
                                " — abandoning it" if detach else "")
                if detach:
                    self._thread = self._queue = None
                return False
        self._drain()
        self._buffered.extend(self._overflow)
        self._overflow = []
        self._thread = self._queue = None
        return True

    def _pause_for_snapshot(self):
        if not self._pause(timeout=30.0):
            raise MXNetError("PrefetchingIter: the prefetch worker did not "
                             "stop within 30s; cannot snapshot or restore "
                             "while it may still advance the stream")

    def close(self):
        """Join the prefetch thread and close the wrapped iterators
        (idempotent; also on leaving a ``with`` block)."""
        self._pause(timeout=10.0, detach=True)
        self._buffered = []
        self._exhausted = True
        for it in self.iters:
            it.close()

    def __del__(self):
        try:
            self._pause(timeout=0.5)
        except BaseException:  # noqa: BLE001 — interpreter teardown
            pass

    def reset(self):
        self._pause(timeout=10.0, detach=True)
        self._buffered = []
        for it in self.iters:
            it.reset()
        self._delivered = 0
        self._exhausted = False
        self._epoch_state = self._capture_epoch_state()
        self._start()

    def state_dict(self):
        """The wrapped iterators' epoch-start state and the batches
        delivered (at an epoch's end, their current state); the worker
        restarts at the next ``iter_next``."""
        if self._epoch_state is None:
            raise NotImplementedError(
                "PrefetchingIter: the wrapped iterators do not implement "
                "state_dict")
        self._pause_for_snapshot()
        if self._exhausted and not self._buffered:
            return {"iter": type(self).__name__, "version": 1,
                    "delivered": 0, "exhausted": True,
                    "iters": [it.state_dict() for it in self.iters]}
        return {"iter": type(self).__name__, "version": 1,
                "delivered": int(self._delivered),
                "exhausted": bool(self._exhausted),
                "iters": _copy.deepcopy(self._epoch_state)}

    def load_state_dict(self, state):
        _check_state(state, type(self).__name__)
        self._pause_for_snapshot()
        self._buffered = []
        for it, s in zip(self.iters, state["iters"]):
            it.load_state_dict(s)
        self._epoch_state = _copy.deepcopy(state["iters"])
        delivered = int(state.get("delivered", 0))
        with self._worker_context():
            for _ in range(delivered):
                for it in self.iters:
                    it.next()
        self._delivered = delivered
        self._exhausted = bool(state.get("exhausted", False))

    def iter_next(self):
        if self._exhausted:
            return False
        if self._buffered:
            item = self._buffered.pop(0)
        else:
            if self._thread is None:
                self._start()
            item = self._queue.get()
        if item is None:
            self._exhausted = True
            return False
        if isinstance(item, Exception):
            self._exhausted = True
            self._pause(timeout=5.0)
            raise item
        self._batches = self._receive(item)
        self._delivered += 1
        return True

    def next(self):
        if not self.iter_next():
            raise StopIteration
        b = self._batches[0]
        if len(self._batches) > 1:
            return DataBatch(sum([x.data for x in self._batches], []),
                             sum([x.label for x in self._batches], []),
                             pad=b.pad, index=b.index)
        return b

    def getdata(self):
        return sum([x.data for x in self._batches], [])

    def getlabel(self):
        return sum([x.label for x in self._batches], [])

    def getpad(self):
        return self._batches[0].pad


class DevicePrefetchIter(PrefetchingIter):
    """Batches staged onto ``device`` (default: the current context, the
    card unless ``with mx.cpu():``) by the prefetch thread, the data
    normalized (``normalize=(mean, std)``, float32, along
    ``normalize_axis``) and then cast to ``cast_data``; labels are only
    moved.  See the module's docstring for the streams.

        it = mx.io.DevicePrefetchIter(train_iter, cast_data="bfloat16")
        for batch in it:        # batch.data on the card, bfloat16
            step.step(batch.data[0], batch.label[0])
    """

    def __init__(self, iters, depth=2, device=None, cast_data=None,
                 normalize=None, normalize_axis=-1):
        self._dev = _device.resolve(device)
        self._cast = _torch_dtype(cast_data)
        self._norm = None
        if normalize is not None:
            mean, std = normalize
            self._norm = (torch.as_tensor(np.asarray(mean, np.float32)),
                          torch.as_tensor(np.asarray(std, np.float32)),
                          int(normalize_axis))
        self._stream = torch.cuda.Stream(self._dev) \
            if self._dev.type == "cuda" else None
        super().__init__(iters, depth=depth)

    def _worker_context(self):
        # the wrapped iterators make host arrays; this thread moves them
        return cpu()

    def _place(self, arr, is_data):
        t = arr._data if isinstance(arr, NDArray) else torch.as_tensor(
            np.asarray(arr))
        if self._stream is not None and t.device.type == "cpu":
            t = t.pin_memory()
        t = t.to(self._dev, non_blocking=True)
        if is_data and self._norm is not None:
            mean, std, ax = self._norm
            shape = [1] * t.dim()
            shape[ax % t.dim()] = mean.numel()
            t = (t.float() - mean.to(self._dev).reshape(shape)) \
                / std.to(self._dev).reshape(shape)
        if is_data and self._cast is not None:
            t = t.to(self._cast)
        return t

    def _stage(self, batches):
        return [DataBatch([NDArray(self._place(d, True)) for d in b.data],
                          [NDArray(self._place(l, False)) for l in b.label],
                          pad=b.pad, index=b.index,
                          provide_data=getattr(b, "provide_data", None),
                          provide_label=getattr(b, "provide_label", None))
                for b in batches]

    def _transform(self, batches):
        if self._stream is None:
            return self._stage(batches), None
        with torch.cuda.stream(self._stream):
            staged = self._stage(batches)
            done = torch.cuda.Event()
            done.record(self._stream)
        return staged, done

    def _receive(self, item):
        staged, done = item
        if done is not None:
            consumer = torch.cuda.current_stream(self._dev)
            consumer.wait_event(done)
            for b in staged:
                for a in b.data + b.label:
                    a._data.record_stream(consumer)
        return staged


def _read_idx_ubyte(path):
    """An MNIST idx-ubyte file (``.gz`` or not) as a uint8 array."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        dims = [struct.unpack(">I", f.read(4))[0] for _ in range(ndim)]
        data = np.frombuffer(f.read(), dtype=np.uint8)
    return data.reshape(dims)


class MNISTIter(NDArrayIter):
    """MNIST's idx-ubyte files as ``(N, 1, 28, 28)`` float32 in [0, 1]
    (``flat``: ``(N, 784)``), shuffled with ``RandomState(seed)``, the
    short tail discarded."""

    def __init__(self, image, label, batch_size=128, shuffle=True,
                 flat=False, silent=True, seed=0, **kwargs):
        imgs = _read_idx_ubyte(image).astype(np.float32) / 255.0
        labels = _read_idx_ubyte(label).astype(np.float32)
        imgs = imgs.reshape(len(imgs), -1) if flat else imgs[:, None, :, :]
        super().__init__(imgs, labels, batch_size=batch_size,
                         shuffle=shuffle, last_batch_handle="discard",
                         data_name="data", label_name="softmax_label",
                         seed=seed)


class CSVIter(NDArrayIter):
    """Rows of ``data_csv`` reshaped to ``data_shape`` (labels from
    ``label_csv``, else zeros); ``round_batch`` pads the last batch,
    else it is discarded."""

    def __init__(self, data_csv, data_shape, label_csv=None,
                 label_shape=(1,), batch_size=128, round_batch=True,
                 **kwargs):
        data = np.loadtxt(data_csv, delimiter=",", dtype=np.float32, ndmin=2)
        data = data.reshape((-1,) + tuple(data_shape))
        if label_csv is not None:
            label = np.loadtxt(label_csv, delimiter=",", dtype=np.float32,
                               ndmin=2).reshape((-1,) + tuple(label_shape))
        else:
            label = np.zeros((len(data), 1), dtype=np.float32)
        super().__init__(data, label, batch_size=batch_size,
                         last_batch_handle="pad" if round_batch
                         else "discard")


class LibSVMIter(DataIter):
    """LibSVM text (lines of ``label idx:val idx:val ...``) in batches of
    CSR matrices on the current context, as the reference's; the labels
    may be LibSVM rows of their own (``label_libsvm``).  The file is
    parsed once into flat arrays (values, column indices, row offsets),
    and a batch is one or two slices of them (two where ``round_batch``
    wraps the last batch to the file's head)."""

    def __init__(self, data_libsvm, data_shape, batch_size,
                 label_libsvm=None, label_shape=(1,), round_batch=True,
                 **kwargs):
        super().__init__(batch_size)
        self._num_features = int(np.prod(data_shape))
        self._label_shape = tuple(label_shape)
        label_dim = int(np.prod(self._label_shape))
        self._values, self._cols, self._ptr, scalars = self._parse(
            data_libsvm)
        n = len(self._ptr) - 1
        if label_libsvm:
            lv, lc, lp, _ = self._parse(label_libsvm)
            if len(lp) - 1 != n:
                raise MXNetError("label_libsvm row count != data rows")
            labels = np.zeros((n, label_dim), np.float32)
            rows = np.repeat(np.arange(n), np.diff(lp))
            labels[rows, lc] = lv
            self._labels = labels
        elif label_dim > 1:
            self._labels = np.zeros((n, label_dim), np.float32)
            self._labels[:, 0] = scalars
        else:
            self._labels = scalars
        self.round_batch = round_batch
        self.reset()

    @staticmethod
    def _parse(path):
        """``(values float32, columns int32, row offsets int32, labels
        float32)`` of a LibSVM file."""
        values, cols, ptr, labels = [], [], [0], []
        with open(path) as f:
            for line in f:
                parts = line.split()
                if not parts:
                    continue
                labels.append(float(parts[0]))
                for p in parts[1:]:
                    k, v = p.split(":")
                    cols.append(int(k))
                    values.append(float(v))
                ptr.append(len(values))
        return (np.asarray(values, np.float32), np.asarray(cols, np.int32),
                np.asarray(ptr, np.int64), np.asarray(labels, np.float32))

    def reset(self):
        self._cursor = 0
        self._pad = 0

    def state_dict(self):
        return {"iter": "LibSVMIter", "version": 1,
                "cursor": int(self._cursor)}

    def load_state_dict(self, state):
        _check_state(state, "LibSVMIter")
        self._cursor = int(state["cursor"])
        self._pad = 0

    def iter_next(self):
        n = len(self._ptr) - 1
        if self._cursor >= n:
            return False
        end = self._cursor + self.batch_size
        self._pad = max(0, end - n)
        if self._pad and not self.round_batch:
            return False
        # the batch's rows (cursor + i) % n: at most two runs of rows
        runs, at, left = [], self._cursor, self.batch_size
        while left:
            take = min(left, n - at)
            runs.append((at, at + take))
            at, left = 0, left - take
        self._cursor = min(end, n)
        spans = [(int(self._ptr[a]), int(self._ptr[b])) for a, b in runs]
        values = np.concatenate([self._values[a:b] for a, b in spans])
        cols = np.concatenate([self._cols[a:b] for a, b in spans])
        indptr = self._ptr[runs[0][0]:runs[0][1] + 1] - spans[0][0]
        if len(runs) == 2:
            a, b = runs[1]
            indptr = np.concatenate([indptr, self._ptr[a + 1:b + 1]
                                     - spans[1][0] + indptr[-1]])
        indptr = indptr.astype(np.int32)
        from ..ndarray import sparse as _sparse
        self._data_batch = _sparse.csr_matrix(
            (values, cols, indptr), shape=(self.batch_size,
                                           self._num_features))
        lab = np.concatenate([self._labels[a:b] for a, b in runs])
        if lab.ndim > 1:
            lab = lab.reshape((self.batch_size,) + self._label_shape)
        self._label_batch = array(lab)
        return True

    @property
    def provide_data(self):
        return [DataDesc("data", (self.batch_size, self._num_features))]

    @property
    def provide_label(self):
        shp = (self.batch_size,) if int(np.prod(self._label_shape)) == 1 \
            else (self.batch_size,) + self._label_shape
        return [DataDesc("softmax_label", shp)]

    def getdata(self):
        return [self._data_batch]

    def getlabel(self):
        return [self._label_batch]

    def getpad(self):
        return self._pad


def _pin_batches():
    """Native batches go to page-locked memory when the current context
    is the card."""
    return current_context().kind == "gpu" and torch.cuda.is_available()


def _native_unavailable(what, e, use_native):
    """``use_native=True`` raises; None warns and takes the Python arm."""
    if use_native:
        raise e
    warnings.warn(f"native {what} unavailable ({e}); using the Python "
                  "pipeline")


class ImageRecordIter(DataIter):
    """JPEG records to batches of ``data_shape`` images with the
    reference's augmentations (``resize`` of the shorter side,
    ``rand_crop``, ``rand_mirror``, else a centre crop, then mean/std):
    see the module's docstring for the two arms."""

    def __init__(self, path_imgrec, data_shape, batch_size, path_imgidx=None,
                 label_width=1, shuffle=False, rand_crop=False,
                 rand_mirror=False, resize=-1, mean_r=0.0, mean_g=0.0,
                 mean_b=0.0, std_r=1.0, std_g=1.0, std_b=1.0,
                 preprocess_threads=4, prefetch_buffer=4, round_batch=True,
                 seed=0, use_native=None, output_dtype="float32",
                 output_layout="NCHW", **kwargs):
        super().__init__(batch_size)
        self.data_shape = tuple(data_shape)
        _check(len(self.data_shape) == 3, "data_shape must be (C,H,W)")
        _check(output_dtype in ("float32", "uint8"),
               "output_dtype must be float32|uint8")
        _check(output_layout in ("NCHW", "NHWC"),
               "output_layout must be NCHW|NHWC")
        self.output_dtype = output_dtype
        self.output_layout = output_layout
        self.label_width = label_width
        self.shuffle = shuffle
        self.rand_crop = rand_crop
        self.rand_mirror = rand_mirror
        self.resize = resize
        self.mean = np.array([mean_r, mean_g, mean_b], np.float32)
        self.std = np.array([std_r, std_g, std_b], np.float32)
        self.rng = np.random.RandomState(seed)
        self.round_batch = round_batch
        self._native = None
        native_ok = (round_batch and self.data_shape[0] == 3
                     and self._first_record_is_jpeg(path_imgrec))
        if use_native and not native_ok:
            raise MXNetError(
                "use_native=True requires JPEG records, round_batch=True "
                "and a 3-channel data_shape")
        if use_native is not False and native_ok:
            from ..lib import NativeBuildError
            try:
                from ..lib.recordio_cpp import NativeImagePipe
                self._native = NativeImagePipe(
                    path_imgrec, batch_size=batch_size,
                    data_shape=self.data_shape, resize=resize,
                    rand_crop=rand_crop, rand_mirror=rand_mirror,
                    mean=self.mean, std=self.std,
                    preprocess_threads=preprocess_threads,
                    prefetch_buffer=prefetch_buffer, shuffle=shuffle,
                    seed=seed, label_width=label_width,
                    output_dtype=output_dtype, output_layout=output_layout,
                    pin_memory=_pin_batches())
            except (NativeBuildError, OSError) as e:
                _native_unavailable("io", e, use_native)
        if self._native is not None:
            n = len(self._native)
            self._nat_batches = (n + batch_size - 1) // batch_size
            self._nat_pad = self._nat_batches * batch_size - n
            self._nat_seen = 0
            self._pad = 0
            return
        import cv2
        self._cv2 = cv2
        from ..recordio import MXIndexedRecordIO, MXRecordIO
        if path_imgidx and os.path.isfile(path_imgidx):
            self._rec = MXIndexedRecordIO(path_imgidx, path_imgrec, "r")
            self._order = list(self._rec.keys)
        else:
            # no index: one pass records the offsets (shuffle needs them)
            self._rec = MXRecordIO(path_imgrec, "r")
            self._offsets = []
            while True:
                pos = self._rec.tell()
                if self._rec.read() is None:
                    break
                self._offsets.append(pos)
            self._order = list(range(len(self._offsets)))
        self._pool = ThreadPoolExecutor(max_workers=preprocess_threads)
        self._prefetch = prefetch_buffer
        self.reset()

    @property
    def uses_native(self):
        """True when the native pipeline produces the batches."""
        return self._native is not None

    @property
    def provide_data(self):
        c, h, w = self.data_shape
        shp = (h, w, c) if self.output_layout == "NHWC" else (c, h, w)
        dt = np.uint8 if self.output_dtype == "uint8" else np.float32
        return [DataDesc("data", (self.batch_size,) + shp, dtype=dt,
                         layout="N" + self.output_layout[1:])]

    @property
    def provide_label(self):
        shp = (self.batch_size,) if self.label_width == 1 else (
            self.batch_size, self.label_width)
        return [DataDesc("softmax_label", shp)]

    @staticmethod
    def _first_record_is_jpeg(path, sample=8):
        """The first ``sample`` records' payloads start with JPEG's
        marker (the native pipeline decodes JPEG only)."""
        from ..recordio import MXRecordIO, unpack
        try:
            r = MXRecordIO(path, "r")
        except OSError:
            return False
        seen = 0
        try:
            for _ in range(sample):
                raw = r.read()
                if raw is None:
                    break
                _, payload = unpack(raw)
                if bytes(payload[:2]) != b"\xff\xd8":
                    return False
                seen += 1
        except (MXNetError, struct.error):
            return False
        finally:
            r.close()
        return seen > 0

    def reset(self):
        if self._native is not None:
            self._native.reset()
            self._nat_seen = 0
            self._pad = 0
            return
        if self.shuffle:
            self.rng.shuffle(self._order)
        self._cursor = 0
        self._pending = []

    def state_dict(self):
        """Cursor, shuffle permutation and augmentation stream (the Python
        arm only: the native pipeline keeps its cursors in its threads;
        pass ``use_native=False`` where resume must be exact)."""
        if self._native is not None:
            raise NotImplementedError(
                "ImageRecordIter: state_dict is unsupported on the native "
                "pipeline; pass use_native=False for deterministic resume")
        return {"iter": type(self).__name__, "version": 1,
                "cursor": int(self._cursor),
                "order": [int(i) for i in self._order],
                "rng": self.rng.get_state()}

    def load_state_dict(self, state):
        _check_state(state, type(self).__name__)
        if self._native is not None:
            raise NotImplementedError(
                "ImageRecordIter: load_state_dict is unsupported on the "
                "native pipeline; pass use_native=False")
        self._order = [int(i) for i in state["order"]]
        self._cursor = int(state["cursor"])
        self._pad = 0
        self._pending = []
        self.rng.set_state(_np_rng_tuple(state["rng"]))

    def close(self):
        """Shut down the decode pool and close the record file (the
        native pipeline keeps its threads for its lifetime)."""
        if self._native is not None:
            return
        pool = getattr(self, "_pool", None)
        if pool is not None:
            pool.shutdown(wait=True)
        rec = getattr(self, "_rec", None)
        if rec is not None:
            rec.close()

    def _read_raw(self, key):
        from ..recordio import MXIndexedRecordIO
        if isinstance(self._rec, MXIndexedRecordIO):
            return self._rec.read_idx(key)
        self._rec.record.seek(self._offsets[key])
        return self._rec.read()

    def _decode_one(self, raw, aug):
        # aug = (crop fraction y, crop fraction x, mirror), drawn on the
        # consumer's thread: RandomState is not thread-safe, and drawing
        # per batch there keeps a seeded run's draws in order
        from ..recordio import unpack
        cv2 = self._cv2
        fy, fx, mirror = aug
        header, img_bytes = unpack(raw)
        img = cv2.imdecode(np.frombuffer(img_bytes, np.uint8),
                           cv2.IMREAD_COLOR)
        _check(img is not None, "image decode failed")
        img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
        c, h, w = self.data_shape
        if self.resize > 0:
            scale = self.resize / min(img.shape[:2])
            img = cv2.resize(img, (max(w, int(round(img.shape[1] * scale))),
                                   max(h, int(round(img.shape[0] * scale)))))
        ih, iw = img.shape[:2]
        if ih < h or iw < w:
            img = cv2.resize(img, (max(w, iw), max(h, ih)))
            ih, iw = img.shape[:2]
        if self.rand_crop:
            y = int(fy * (ih - h + 1))
            x = int(fx * (iw - w + 1))
        else:
            y, x = (ih - h) // 2, (iw - w) // 2
        img = img[y:y + h, x:x + w]
        if mirror:
            img = img[:, ::-1]
        if self.output_dtype != "uint8":
            img = (img.astype(np.float32) - self.mean) / self.std
        label = header.label if self.label_width > 1 else float(
            np.asarray(header.label).ravel()[0])
        if self.output_layout == "NCHW":
            img = img.transpose(2, 0, 1)
        return np.ascontiguousarray(img), label

    def iter_next(self):
        if self._native is not None:
            out = self._native.next_batch()
            if out is None:
                return False
            self._data, self._label = out
            self._nat_seen += 1
            self._pad = self._nat_pad \
                if self._nat_seen == self._nat_batches else 0
            return True
        n = len(self._order)
        if self._cursor >= n:
            return False
        idxs = [self._order[(self._cursor + i) % n]
                for i in range(self.batch_size)]
        self._pad = max(0, self._cursor + self.batch_size - n)
        if self._pad and not self.round_batch:
            return False
        self._cursor += self.batch_size
        raws = [self._read_raw(i) for i in idxs]
        augs = [(self.rng.rand(), self.rng.rand(),
                 self.rand_mirror and self.rng.rand() < 0.5)
                for _ in idxs]
        decoded = list(self._pool.map(self._decode_one, raws, augs))
        self._data = np.stack([d for d, _ in decoded])
        self._label = np.asarray([lab for _, lab in decoded],
                                 dtype=np.float32)
        return True

    def getdata(self):
        return [_batch_array(self._data)]

    def getlabel(self):
        return [_batch_array(self._label)]

    def getpad(self):
        return self._pad


class ImageDetRecordIter(DataIter):
    """Detection records to ``(images, (B, max_objects, 5) labels)``:
    JPEG decode, the IoU-constrained random crop, mirror with the boxes,
    resize to ``data_shape``, batching.  The native pipeline, or with
    ``use_native=False`` (or where the library cannot be built and
    ``use_native`` is None) :class:`tpu_mx_torch.image.ImageDetIter`,
    which keeps the same labels but only the float32 NCHW output."""

    def __init__(self, path_imgrec, data_shape, batch_size, max_objects=None,
                 shuffle=False, rand_crop=0, rand_mirror=False,
                 mean_r=0.0, mean_g=0.0, mean_b=0.0, std_r=1.0, std_g=1.0,
                 std_b=1.0, min_object_covered=0.3, area_range=(0.3, 1.0),
                 aspect_ratio_range=(0.75, 1.33), max_attempts=20,
                 preprocess_threads=4, prefetch_buffer=4, seed=0,
                 use_native=None, output_dtype="float32",
                 output_layout="NCHW", **kwargs):
        super().__init__(batch_size)
        self.data_shape = tuple(data_shape)
        _check(len(self.data_shape) == 3, "data_shape must be (C,H,W)")
        _check(output_dtype in ("float32", "uint8"),
               "output_dtype must be float32|uint8")
        _check(output_layout in ("NCHW", "NHWC"),
               "output_layout must be NCHW|NHWC")
        plain = output_dtype == "float32" and output_layout == "NCHW"
        if not plain and use_native is False:
            raise MXNetError("output_dtype/output_layout variants need "
                             "the native pipeline (use_native=False set)")
        self.output_dtype = output_dtype
        self.output_layout = output_layout
        self.max_objects = max_objects or self._scan_max_objects(path_imgrec)
        self._pad = 0
        self._native = None
        if use_native is not False:
            from ..lib import NativeBuildError
            try:
                from ..lib.recordio_cpp import NativeDetPipe
                self._native = NativeDetPipe(
                    path_imgrec, batch_size=batch_size,
                    data_shape=self.data_shape,
                    max_objects=self.max_objects,
                    rand_crop=bool(rand_crop), rand_mirror=rand_mirror,
                    mean=(mean_r, mean_g, mean_b),
                    std=(std_r, std_g, std_b),
                    min_object_covered=min_object_covered,
                    area_range=area_range,
                    aspect_ratio_range=aspect_ratio_range,
                    max_attempts=max_attempts,
                    preprocess_threads=preprocess_threads,
                    prefetch_buffer=prefetch_buffer, shuffle=shuffle,
                    seed=seed, output_dtype=output_dtype,
                    output_layout=output_layout, pin_memory=_pin_batches())
            except (NativeBuildError, OSError) as e:
                _native_unavailable("det io", e, use_native or not plain)
        if self._native is not None:
            n = len(self._native)
            self._nat_batches = (n + batch_size - 1) // batch_size
            self._nat_pad = self._nat_batches * batch_size - n
            self._nat_seen = 0
            return
        from ..image.detection import ImageDetIter
        mean = std = None
        if mean_r or mean_g or mean_b:
            mean = np.array([mean_r, mean_g, mean_b], np.float32)
        if std_r != 1.0 or std_g != 1.0 or std_b != 1.0:
            std = np.array([std_r, std_g, std_b], np.float32)
        self._py = ImageDetIter(
            batch_size, self.data_shape, path_imgrec=path_imgrec,
            shuffle=shuffle, max_objects=self.max_objects,
            rand_crop=rand_crop, rand_mirror=rand_mirror, mean=mean,
            std=std, min_object_covered=min_object_covered,
            area_range=area_range, aspect_ratio_range=aspect_ratio_range,
            max_attempts=max_attempts, **kwargs)

    @property
    def uses_native(self):
        """True when the native pipeline produces the batches."""
        return self._native is not None

    @staticmethod
    def _scan_max_objects(path_imgrec):
        """The widest label block of the file, in boxes (headers only)."""
        from ..recordio import MXRecordIO, unpack
        widest = 1
        r = MXRecordIO(path_imgrec, "r")
        try:
            while True:
                raw = r.read()
                if raw is None:
                    break
                header, _ = unpack(raw)
                if header.flag:
                    widest = max(widest, int(header.flag) // 5)
        finally:
            r.close()
        return widest

    @property
    def provide_data(self):
        c, h, w = self.data_shape
        shp = (h, w, c) if self.output_layout == "NHWC" else (c, h, w)
        dt = np.uint8 if self.output_dtype == "uint8" else np.float32
        return [DataDesc("data", (self.batch_size,) + shp, dtype=dt,
                         layout="N" + self.output_layout[1:])]

    @property
    def provide_label(self):
        return [DataDesc("label", (self.batch_size, self.max_objects, 5))]

    def reset(self):
        if self._native is not None:
            self._native.reset()
            self._nat_seen = 0
            self._pad = 0
        else:
            self._py.reset()

    def iter_next(self):
        if self._native is not None:
            out = self._native.next_batch()
            if out is None:
                return False
            self._data, self._label = out
            self._nat_seen += 1
            self._pad = self._nat_pad \
                if self._nat_seen == self._nat_batches else 0
            return True
        try:
            batch = self._py.next()
        except StopIteration:
            return False
        self._data = batch.data[0].asnumpy()
        self._label = batch.label[0].asnumpy()
        self._pad = batch.pad or 0
        return True

    def getdata(self):
        return [_batch_array(self._data)]

    def getlabel(self):
        return [_batch_array(self._label)]

    def getpad(self):
        return self._pad
