"""``mx.io``: the data-iterator protocol, ``NDArrayIter``, the file and
record iterators and the prefetching iterators (:mod:`.io`)."""
from .io import (CSVIter, DataBatch, DataDesc, DataIter, DevicePrefetchIter,
                 ImageDetRecordIter, ImageRecordIter, MNISTIter, NDArrayIter,
                 PrefetchingIter, ResizeIter)

__all__ = ["DataBatch", "DataDesc", "DataIter", "NDArrayIter", "ResizeIter",
           "PrefetchingIter", "DevicePrefetchIter", "MNISTIter", "CSVIter",
           "ImageRecordIter", "ImageDetRecordIter"]


def __getattr__(name):
    from . import io as _io
    return _io.__getattr__(name)
