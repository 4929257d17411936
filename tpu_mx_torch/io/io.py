"""Data iterators, from ``tpu_mx/io/io.py``: ``DataDesc``, ``DataBatch``,
the ``DataIter`` protocol and ``NDArrayIter``.

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
``PrefetchingIter``, ``ResizeIter``) stay queued there too.
"""
from __future__ import annotations

from collections import namedtuple

import numpy as np

from ..base import MXNetError, refuse_unported
from ..ndarray.ndarray import NDArray, array

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter"]


def _check(cond, msg):
    if not cond:
        raise MXNetError(msg)


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
        got = state.get("iter") if isinstance(state, dict) else None
        if got != type(self).__name__:
            raise MXNetError(f"load_state_dict: state was captured from "
                             f"{got!r}, not {type(self).__name__!r}")
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
