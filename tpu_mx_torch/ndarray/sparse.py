"""Sparse arrays, from ``tpu_mx/ndarray/sparse.py``: the ``row_sparse``
and ``csr`` storage types (``nd.sparse``).

The storage is compact: index and value tensors on the array's device
(int32 indices, as the reference's).  A sparse array is deliberately not
an :class:`~tpu_mx_torch.ndarray.NDArray`: the dense operators must not
take one and densify it behind the caller's back.

The operators are gathers and segment sums in PyTorch (``index_add_``,
``torch.unique``), as the reference's are gathers and
``jax.ops.segment_sum``; none is a kernel of the port.  ``dot`` of a CSR
matrix and a dense one sums each output row's products by
``index_add_``: on the card in the order its atomic adds land, so two
calls may differ in the last bits of a float32 sum (about n·2^-24 of the
row's sum of magnitudes for n terms).
"""
from __future__ import annotations

import numpy as np
import torch

from .. import device as _device
from ..context import current_context
from .ndarray import NDArray, _torch_dtype

__all__ = ["BaseSparseNDArray", "CSRNDArray", "RowSparseNDArray",
           "csr_matrix", "row_sparse_array", "zeros", "dot", "retain",
           "cast_storage", "elemwise_add", "tostype"]


class BaseSparseNDArray:
    """What the compressed formats share.  Not an ``NDArray`` subclass:
    the dense operators must not consume a compressed handle."""

    @property
    def stype(self):
        raise NotImplementedError

    @property
    def shape(self):
        return self._shape

    @property
    def dtype(self):
        return str(NDArray(self._values).dtype)

    @property
    def context(self):
        return NDArray(self._values).context

    ctx = context

    def asnumpy(self):
        return self.todense().asnumpy()

    def astype(self, dtype):
        out = self.copy()
        out._values = out._values.to(_torch_dtype(dtype))
        return out

    def wait_to_read(self):
        NDArray(self._values).wait_to_read()
        return self

    def __repr__(self):
        return "\n<%s %s @%s>" % (type(self).__name__, self._shape,
                                  self.context)


def _index(t, device=None):
    """An int32 index tensor from an array, tensor or sequence."""
    if isinstance(t, NDArray):
        t = t._data
    if not isinstance(t, torch.Tensor):
        t = torch.as_tensor(np.asarray(t))
    return t.to(device=device if device is not None else t.device,
                dtype=torch.int32)


class CSRNDArray(BaseSparseNDArray):
    """A compressed sparse row matrix (2-D): ``data``, ``indices`` and
    ``indptr`` in the reference's (and scipy's) layout."""

    def __init__(self, data, indices, indptr, shape):
        self._values = data._data if isinstance(data, NDArray) else data
        dev = self._values.device
        self._indices = _index(indices, dev)
        self._indptr = _index(indptr, dev)
        self._shape = tuple(int(s) for s in shape)
        if len(self._shape) != 2:
            raise ValueError("csr storage is 2-D only")

    @property
    def stype(self):
        return "csr"

    @property
    def data(self):
        return NDArray(self._values)

    @property
    def indices(self):
        return NDArray(self._indices)

    @property
    def indptr(self):
        return NDArray(self._indptr)

    @property
    def nnz(self):
        return int(self._values.shape[0])

    def copy(self):
        return CSRNDArray(self._values, self._indices, self._indptr,
                          self._shape)

    def _row_ids(self):
        """The row of each stored element (nnz of them), from indptr."""
        counts = (self._indptr[1:] - self._indptr[:-1]).long()
        return torch.repeat_interleave(
            torch.arange(self._shape[0], device=counts.device), counts,
            output_size=self.nnz)

    def todense(self):
        dense = torch.zeros(self._shape, dtype=self._values.dtype,
                            device=self._values.device)
        dense.index_put_((self._row_ids(), self._indices.long()),
                         self._values, accumulate=True)
        return NDArray(dense)

    def tostype(self, stype):
        if stype == "csr":
            return self
        if stype == "default":
            return self.todense()
        raise ValueError(f"cannot convert csr to {stype}")

    def slice(self, start, stop):
        """Rows ``[start, stop)``."""
        start, stop = int(start), int(stop)
        if not (0 <= start <= stop <= self._shape[0]):
            raise IndexError(
                f"csr slice [{start}:{stop}] out of bounds for "
                f"{self._shape[0]} rows")
        ptr = self._indptr[start:stop + 1]
        lo, hi = int(ptr[0]), int(ptr[-1])
        return CSRNDArray(self._values[lo:hi], self._indices[lo:hi],
                          ptr - ptr[0], (stop - start, self._shape[1]))


class RowSparseNDArray(BaseSparseNDArray):
    """Sparse along the first axis: ``(indices, values)`` with
    ``values[i]`` the whole row ``indices[i]``; the gradient type of
    embedding lookups."""

    def __init__(self, data, indices, shape):
        self._values = data._data if isinstance(data, NDArray) else data
        self._indices = _index(indices, self._values.device)
        self._shape = tuple(int(s) for s in shape)
        if self._values.shape[0] != self._indices.shape[0]:
            raise ValueError("row_sparse: len(data) != len(indices)")
        if tuple(self._values.shape[1:]) != self._shape[1:]:
            raise ValueError("row_sparse: row shape mismatch")

    @property
    def stype(self):
        return "row_sparse"

    @property
    def data(self):
        return NDArray(self._values)

    @property
    def indices(self):
        return NDArray(self._indices)

    def copy(self):
        return RowSparseNDArray(self._values, self._indices, self._shape)

    def todense(self):
        dense = torch.zeros(self._shape, dtype=self._values.dtype,
                            device=self._values.device)
        # added, not set: duplicate rows accumulate, as the reference's
        # conversion of an unmerged gradient does
        dense.index_add_(0, self._indices.long(), self._values)
        return NDArray(dense)

    def tostype(self, stype):
        if stype == "row_sparse":
            return self
        if stype == "default":
            return self.todense()
        raise ValueError(f"cannot convert row_sparse to {stype}")


# -- constructors -------------------------------------------------------------
def _tensor(x, ctx=None):
    """A tensor of ``x`` (an array, tensor or sequence), on ``ctx`` if given
    or else where it is (the current context for host data)."""
    if isinstance(x, NDArray):
        t = x._data
    elif isinstance(x, torch.Tensor):
        t = x
    else:
        a = np.asarray(x)
        t = torch.as_tensor(a if a.flags.c_contiguous else a.copy())
        if ctx is None:
            ctx = current_context()
    if ctx is not None:
        t = t.to(_device.resolve(ctx))
    return t


def _cast(t, dtype):
    return t if dtype is None else t.to(_torch_dtype(dtype))


def csr_matrix(arg1, shape=None, ctx=None, dtype=None):
    """``csr_matrix((data, indices, indptr), shape)``, or of a dense
    array."""
    if isinstance(arg1, tuple) and len(arg1) == 3:
        data, indices, indptr = (_tensor(a, ctx) for a in arg1)
        if shape is None:
            raise ValueError("shape is required for the 3-tuple form")
        return CSRNDArray(_cast(data, dtype), indices, indptr, shape)
    dense = _cast(_tensor(arg1, ctx), dtype)
    if dense.dim() != 2:
        raise ValueError("csr_matrix: dense input must be 2-D")
    mask = dense != 0
    indptr = torch.zeros(dense.shape[0] + 1, dtype=torch.int32,
                         device=dense.device)
    indptr[1:] = mask.sum(dim=1).cumsum(0)
    return CSRNDArray(dense[mask], mask.nonzero()[:, 1], indptr,
                      dense.shape)


def row_sparse_array(arg1, shape=None, ctx=None, dtype=None):
    """``row_sparse_array((data, indices), shape)``, or of a dense array."""
    if isinstance(arg1, tuple) and len(arg1) == 2:
        data, indices = (_tensor(a, ctx) for a in arg1)
        if shape is None:
            raise ValueError("shape is required for the 2-tuple form")
        return RowSparseNDArray(_cast(data, dtype), indices, shape)
    dense = _cast(_tensor(arg1, ctx), dtype)
    rows = (dense != 0).reshape(dense.shape[0], -1).any(dim=1).nonzero()[:, 0]
    return RowSparseNDArray(dense[rows], rows, dense.shape)


def zeros(stype, shape, ctx=None, dtype="float32"):
    dev = _device.resolve(ctx if ctx is not None else current_context())
    dt = _torch_dtype(dtype)
    shape = tuple(shape)
    if stype == "csr":
        return CSRNDArray(torch.zeros((0,), dtype=dt, device=dev),
                          torch.zeros((0,), dtype=torch.int32, device=dev),
                          torch.zeros((shape[0] + 1,), dtype=torch.int32,
                                      device=dev), shape)
    if stype == "row_sparse":
        return RowSparseNDArray(
            torch.zeros((0,) + shape[1:], dtype=dt, device=dev),
            torch.zeros((0,), dtype=torch.int32, device=dev), shape)
    if stype == "default":
        return NDArray(torch.zeros(shape, dtype=dt, device=dev))
    raise ValueError(f"unknown storage type {stype!r}")


# -- operators ----------------------------------------------------------------
def _segment_sum(values, segments, n):
    out = torch.zeros((n,) + tuple(values.shape[1:]), dtype=values.dtype,
                      device=values.device)
    return out.index_add_(0, segments.long(), values)


def dot(lhs, rhs, transpose_a=False, transpose_b=False):
    """``dot`` that takes a CSR operand: csr·dense and csrᵀ·dense (the
    two the reference optimizes) as a gather and a segment sum, and
    dense·csr as their transpose; two dense arrays go to ``nd.dot``."""
    if isinstance(lhs, CSRNDArray) and isinstance(rhs, NDArray):
        rows, cols = lhs._row_ids(), lhs._indices.long()
        vals = lhs._values
        mat = rhs._data.t() if transpose_b else rhs._data
        if not transpose_a:
            return NDArray(_segment_sum(vals[:, None] * mat[cols], rows,
                                        lhs._shape[0]))
        return NDArray(_segment_sum(vals[:, None] * mat[rows], cols,
                                    lhs._shape[1]))
    if isinstance(lhs, NDArray) and isinstance(rhs, CSRNDArray):
        mat = lhs._data.t() if transpose_a else lhs._data
        return NDArray(dot(rhs, NDArray(mat.t()),
                           transpose_a=not transpose_b)._data.t())
    if isinstance(lhs, NDArray) and isinstance(rhs, NDArray):
        from . import ops
        return ops.dot(lhs, rhs, transpose_a=transpose_a,
                       transpose_b=transpose_b)
    raise TypeError(f"sparse.dot: unsupported operands "
                    f"({type(lhs).__name__}, {type(rhs).__name__})")


def retain(rsp, indices):
    """The stored rows of ``rsp`` whose index is in ``indices``, in their
    stored order (the reference's ``sparse_retain``)."""
    if not isinstance(rsp, RowSparseNDArray):
        raise TypeError("retain expects a RowSparseNDArray")
    want = _index(indices, rsp._indices.device)
    kept = torch.isin(rsp._indices, want).nonzero()[:, 0]
    return RowSparseNDArray(rsp._values[kept], rsp._indices[kept],
                            rsp._shape)


def cast_storage(arr, stype):
    """Dense to sparse and back (the reference's ``cast_storage``)."""
    if isinstance(arr, BaseSparseNDArray):
        return arr.tostype(stype)
    if stype == "default":
        return arr
    if stype == "csr":
        return csr_matrix(arr)
    if stype == "row_sparse":
        return row_sparse_array(arr)
    raise ValueError(f"unknown storage type {stype}")


def elemwise_add(a, b):
    """row_sparse + row_sparse is row_sparse in canonical form (unique
    sorted indices, duplicates summed); anything else adds densely."""
    if isinstance(a, RowSparseNDArray) and isinstance(b, RowSparseNDArray):
        if a._shape != b._shape:
            raise ValueError("shape mismatch")
        idx = torch.cat([a._indices, b._indices])
        vals = torch.cat([a._values, b._values])
        uniq, inv = torch.unique(idx, sorted=True, return_inverse=True)
        return RowSparseNDArray(_segment_sum(vals, inv, uniq.shape[0]), uniq,
                                a._shape)
    return cast_storage(a, "default") + cast_storage(b, "default")


def tostype(arr, stype):
    return cast_storage(arr, stype)
