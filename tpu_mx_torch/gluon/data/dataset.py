"""Datasets, from ``tpu_mx/gluon/data/dataset.py``: ``Dataset`` (with
``filter``, ``shard``, ``take``, ``transform`` and ``transform_first``),
``SimpleDataset``, ``ArrayDataset`` (arrays are read to numpy) and
``RecordFileDataset`` (the raw records of an indexed RecordIO file)."""
from __future__ import annotations

from ...base import MXNetError
from ...ndarray import NDArray

__all__ = ["Dataset", "SimpleDataset", "ArrayDataset", "RecordFileDataset"]


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError

    def filter(self, fn):
        return SimpleDataset([s for s in self if fn(s)])

    def shard(self, num_shards, index):
        return SimpleDataset([self[i] for i in range(index, len(self), num_shards)])

    def take(self, count):
        return SimpleDataset([self[i] for i in range(min(count, len(self)))])

    def transform(self, fn, lazy=True):
        return _LazyTransformDataset(self, fn)

    def transform_first(self, fn, lazy=True):
        def first_fn(*sample):
            if len(sample) == 1:
                return fn(sample[0])
            return (fn(sample[0]),) + sample[1:]
        return self.transform(first_fn, lazy)


class _LazyTransformDataset(Dataset):
    def __init__(self, data, fn):
        self._data = data
        self._fn = fn

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        item = self._data[idx]
        if isinstance(item, tuple):
            return self._fn(*item)
        return self._fn(item)


class SimpleDataset(Dataset):
    def __init__(self, data):
        self._data = data

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        return self._data[idx]


class ArrayDataset(Dataset):
    """Samples zipped from arrays or datasets of one length."""

    def __init__(self, *args):
        if not args:
            raise MXNetError("ArrayDataset needs at least one array")
        self._length = len(args[0])
        self._data = []
        for a in args:
            if isinstance(a, NDArray):
                a = a.asnumpy()
            if len(a) != self._length:
                raise MXNetError("all arrays must have the same length")
            self._data.append(a)

    def __len__(self):
        return self._length

    def __getitem__(self, idx):
        if len(self._data) == 1:
            return self._data[0][idx]
        return tuple(d[idx] for d in self._data)


class RecordFileDataset(Dataset):
    """The records of an indexed RecordIO file (``filename`` and
    ``filename.idx``), as bytes."""

    def __init__(self, filename):
        from ...recordio import IndexedRecordIO
        self._record = IndexedRecordIO(filename + ".idx", filename, "r")

    def __len__(self):
        return len(self._record.keys)

    def __getitem__(self, idx):
        return self._record.read_idx(self._record.keys[idx])
