"""Data iterators, from ``tpu_mx/io/io.py``: ``DataDesc``, ``DataBatch``,
the ``DataIter`` protocol, ``NDArrayIter``, ``PrefetchingIter`` and
``DevicePrefetchIter``.

``NDArrayIter`` batches in-memory arrays with the reference's last-batch
handling (``pad`` wraps to the epoch's head and reports the overlap in
``getpad()``, ``discard`` drops a short tail, ``roll_over`` carries it
into the next epoch) and shuffles each epoch with
``np.random.RandomState(seed)``, or numpy's global state without a seed,
as the reference does: both packages yield the same batches from the
same seed.  A batch's arrays are made with ``nd.array`` on the current
context.  ``state_dict``/``load_state_dict`` snapshot the cursor, the
epoch's permutation and the shuffle stream.  Elastic sharding
(``num_workers``/``rank``) is not ported yet (ROADMAP A14).  The other
iterators (``MNISTIter``, ``CSVIter``, ``ImageRecordIter``,
``ResizeIter``) stay queued there too.

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
import logging
import queue
import threading
from collections import namedtuple

import numpy as np
import torch

from .. import device as _device
from ..base import MXNetError, refuse_unported
from ..context import cpu, current_context
from ..ndarray.ndarray import NDArray, _torch_dtype, array

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter",
           "PrefetchingIter", "DevicePrefetchIter"]

_logger = logging.getLogger(__name__)


def _check(cond, msg):
    if not cond:
        raise MXNetError(msg)


def _check_state(state, cls_name):
    got = state.get("iter") if isinstance(state, dict) else None
    if got != cls_name:
        raise MXNetError(f"load_state_dict: state was captured from "
                         f"{got!r}, not {cls_name!r}")


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
        refuse_unported("NDArrayIter", "A14 (elastic sharding)",
                        num_workers=(num_workers, 1), rank=(rank, 0))
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
        self._rng = np.random.RandomState(seed) if seed is not None \
            else np.random
        self._leftover = None
        self._sel = None
        self._pad = 0
        self.reset()

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
        self._pad = 0

    def iter_next(self):
        n, bs = len(self.idx), self.batch_size
        remaining = n - self.cursor
        if remaining <= 0:
            return False
        pad = 0
        if remaining >= bs:
            sel = self.idx[self.cursor:self.cursor + bs]
            self.cursor += bs
        elif self.last_batch_handle == "discard":
            self.cursor = n
            return False
        elif self.last_batch_handle == "roll_over":
            self._leftover = self.idx[self.cursor:]
            self.cursor = n
            return False
        else:                       # pad: wrap to the epoch's head
            pad = bs - remaining
            sel = np.concatenate([self.idx[self.cursor:], self.idx[:pad]])
            self.cursor = n
        self._sel, self._pad = sel, pad
        return True

    def state_dict(self):
        """Cursor, this epoch's permutation, the roll-over tail and the
        shuffle stream, taken between batches."""
        return {"iter": type(self).__name__, "version": 1,
                "cursor": int(self.cursor), "idx": np.asarray(self.idx).copy(),
                "leftover": (None if self._leftover is None
                             else np.asarray(self._leftover).copy()),
                "rng": self._rng.get_state()}

    def load_state_dict(self, state):
        _check_state(state, type(self).__name__)
        self.idx = np.asarray(state["idx"], dtype=np.intp)
        self.cursor = int(state["cursor"])
        lo = state.get("leftover")
        self._leftover = None if lo is None else np.asarray(lo, dtype=np.intp)
        r = state["rng"]
        self._rng.set_state((str(r[0]), np.asarray(r[1], dtype=np.uint32),
                             int(r[2]), int(r[3]), float(r[4])))
        self._sel = None
        self._pad = 0

    def _take(self, arrs):
        return [array(v[self._sel]) for _, v in arrs]

    def getdata(self):
        return self._take(self.data)

    def getlabel(self):
        return self._take(self.label)

    def getpad(self):
        return self._pad


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
