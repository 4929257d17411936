"""``mx.io``: the data-iterator protocol, ``NDArrayIter``, the file and
record iterators (``LibSVMIter`` among them) and the prefetching
iterators (:mod:`.io`)."""
from .io import (CSVIter, DataBatch, DataDesc, DataIter, DevicePrefetchIter,
                 ImageDetRecordIter, ImageRecordIter, LibSVMIter, MNISTIter,
                 NDArrayIter, PrefetchingIter, ResizeIter)

__all__ = ["DataBatch", "DataDesc", "DataIter", "NDArrayIter", "ResizeIter",
           "PrefetchingIter", "DevicePrefetchIter", "MNISTIter", "CSVIter",
           "ImageRecordIter", "ImageDetRecordIter", "LibSVMIter"]
