"""``mx.io``: the data-iterator protocol, ``NDArrayIter`` and the
prefetching iterators (:mod:`.io`)."""
from .io import (DataBatch, DataDesc, DataIter, DevicePrefetchIter,
                 NDArrayIter, PrefetchingIter)

__all__ = ["DataBatch", "DataDesc", "DataIter", "NDArrayIter",
           "PrefetchingIter", "DevicePrefetchIter"]
