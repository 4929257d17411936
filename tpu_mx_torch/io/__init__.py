"""``mx.io``: the data-iterator protocol and ``NDArrayIter``
(:mod:`.io`)."""
from .io import DataBatch, DataDesc, DataIter, NDArrayIter

__all__ = ["DataBatch", "DataDesc", "DataIter", "NDArrayIter"]
