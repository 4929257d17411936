"""The ``linalg_*`` family of ``tpu_mx/ndarray/linalg_ops.py`` (the
reference's la_op), on tensors: triangular solve and product,
determinants, inverses, the diagonal and triangle packers, LQ and the
symmetric eigendecomposition.

Every operator works on the last two axes and broadcasts over the rest,
as the reference's does.  The solvers are ``torch.linalg``'s (LAPACK on
the host, cuSOLVER and cuBLAS on the card); the packers are index
writes and reads whose index lists are made on the host.  Gradients are
PyTorch's autograd through the same formulas (the reference's come from
``jax.vjp``).

The conventions are the reference's: ``trsm``/``trmm`` take
``transpose``, ``rightside``, ``lower`` and ``alpha``; ``slogdet``
returns ``(sign, log|det|)``; ``potri`` is the inverse of ``A·Aᵀ`` from
its lower Cholesky factor ``A`` (``Aᵀ·A`` for an upper one); the
triangle packers keep the reference's row-major order and its ``offset``
arithmetic; ``gelqf`` returns ``L`` with a non-negative diagonal and
``Q`` with its rows' signs fixed to match; ``syevd`` returns the
eigenvectors as rows beside ascending eigenvalues.

``torch.linalg`` has no bfloat16 or float16 solvers: a 16-bit input is
solved in float32 and the results are cast back to its type.  A float32
eigendecomposition on the card runs in float64 (:func:`eigh`).
"""
from __future__ import annotations

import numpy as np
import torch

from .ops import _op

__all__ = ["linalg_trsm", "linalg_trmm", "linalg_det", "linalg_slogdet",
           "linalg_inverse", "linalg_potri", "linalg_makediag",
           "linalg_extractdiag", "linalg_maketrian", "linalg_extracttrian",
           "linalg_gelqf", "linalg_syevd", "linalg_sumlogdiag"]

_HALF = (torch.float16, torch.bfloat16)


def _solved(fn, *tensors):
    """``fn`` on the tensors, in float32 for 16-bit ones; each result
    cast back to the first input's type."""
    dt = tensors[0].dtype
    if dt not in _HALF:
        return fn(*tensors)
    out = fn(*(t.float() for t in tensors))
    if isinstance(out, tuple):
        return tuple(o.to(dt) for o in out)
    return out.to(dt)


def linalg_trsm(A, B, transpose=False, rightside=False, lower=True, alpha=1.0,
                **kw):
    """Triangular solve: ``op(A)·X = alpha·B``, or ``X·op(A) = alpha·B``
    with ``rightside``; ``op`` transposes with ``transpose``.  Only the
    ``lower`` (or upper) triangle of ``A`` is read."""
    def f(a, b):
        tri = a.tril() if lower else a.triu()
        upper = not lower
        if transpose:
            tri, upper = tri.mT, lower
        return torch.linalg.solve_triangular(tri, alpha * b, upper=upper,
                                             left=not rightside)
    return _solved(f, A, B)


def linalg_trmm(A, B, transpose=False, rightside=False, lower=True, alpha=1.0,
                **kw):
    """Triangular product: ``alpha·op(tri(A))·B``, or ``alpha·B·op(tri(A))``
    with ``rightside``."""
    tri = A.tril() if lower else A.triu()
    if transpose:
        tri = tri.mT
    return alpha * (torch.matmul(B, tri) if rightside else
                    torch.matmul(tri, B))


def linalg_det(A, **kw):
    return _solved(torch.linalg.det, A)


def linalg_slogdet(A, **kw):
    """``(sign, log|det|)``."""
    return _solved(lambda a: tuple(torch.linalg.slogdet(a)), A)


def linalg_inverse(A, **kw):
    return _solved(torch.linalg.inv, A)


def linalg_potri(A, lower=True, **kw):
    """The inverse of the SPD matrix whose Cholesky factor is ``A``:
    ``(A·Aᵀ)⁻¹`` for a lower ``A``, ``(Aᵀ·A)⁻¹`` for an upper one (LAPACK
    ``potri``), as ``A⁻¹``'s product with its transpose."""
    def f(a):
        eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device) \
            .expand(a.shape)
        tri = a.tril() if lower else a.triu()
        inv_a = torch.linalg.solve_triangular(tri, eye, upper=not lower)
        return inv_a.mT @ inv_a if lower else inv_a @ inv_a.mT
    return _solved(f, A)


def linalg_makediag(A, offset=0, **kw):
    """Vectors → matrices with them on diagonal ``offset``."""
    return torch.diag_embed(A, offset=offset, dim1=-2, dim2=-1)


def linalg_extractdiag(A, offset=0, **kw):
    """Diagonal ``offset`` of each matrix."""
    return torch.diagonal(A, offset=offset, dim1=-2, dim2=-1)


def _tri_index(m, k, lower):
    return np.tril_indices(m, k=k) if lower else np.triu_indices(m, k=k)


def linalg_maketrian(A, offset=0, lower=True, **kw):
    """Packed vectors → triangular matrices, in the reference's packing:
    row-major over the triangle ``abs(offset)`` diagonals from the main
    one (below it when ``lower``, else above), the matrix ``n +
    abs(offset)`` wide for ``n(n+1)/2`` packed entries."""
    k = A.shape[-1]
    m = int((-1 + (1 + 8 * k) ** 0.5) / 2) + abs(offset)
    o = abs(offset)
    r, c = _tri_index(m, (-o if lower else o) if offset else 0, lower)
    if offset:
        keep = (r - c >= o) if lower else (c - r >= o)
        r, c = r[keep][:k], c[keep][:k]
    out = A.new_zeros(tuple(A.shape[:-1]) + (m, m))
    out[..., torch.from_numpy(r).to(A.device),
        torch.from_numpy(c).to(A.device)] = A
    return out


def linalg_extracttrian(A, offset=0, lower=True, **kw):
    """The triangle ``offset`` diagonals from the main one, packed
    row-major (the reference's index arithmetic: the lower triangle
    starts at diagonal ``-offset``, the upper at ``offset``)."""
    m = A.shape[-1]
    r, c = _tri_index(m, (-offset if lower else offset) if offset else 0,
                      lower)
    return A[..., torch.from_numpy(r).to(A.device),
             torch.from_numpy(c).to(A.device)]


def linalg_gelqf(A, **kw):
    """LQ factorization ``A = L·Q`` with orthonormal rows in ``Q``, as the
    transposed QR of ``Aᵀ``; ``L``'s diagonal made non-negative and
    ``Q``'s rows flipped to match.  Returns ``(L, Q)``."""
    def f(a):
        q, r = torch.linalg.qr(a.mT, mode="reduced")
        low, qt = r.mT, q.mT
        d = torch.sign(torch.diagonal(low, dim1=-2, dim2=-1))
        d = torch.where(d == 0, 1.0, d).to(a.dtype)
        return low * d[..., None, :], qt * d[..., :, None]
    return _solved(f, A)


def eigh(a, uplo="L"):
    """``torch.linalg.eigh``, a float32 matrix on the card solved in
    float64 and cast back: cuSOLVER's float32 eigensolver is far less
    accurate than LAPACK's (``chip_smoke.py``'s ``linalg_family`` group
    prints both errors against float64)."""
    if a.is_cuda and a.dtype == torch.float32:
        w, v = torch.linalg.eigh(a.double(), uplo)
        return w.float(), v.float()
    return torch.linalg.eigh(a, uplo)


def linalg_syevd(A, **kw):
    """Symmetric eigendecomposition ``A = Uᵀ·diag(λ)·U``: returns ``(U,
    λ)`` with the eigenvectors as the rows of ``U`` and ``λ``
    ascending."""
    def f(a):
        w, v = eigh(a)
        return v.mT, w
    return _solved(f, A)


def linalg_sumlogdiag(A, **kw):
    """``Σ log(diag(A))`` of each matrix."""
    return torch.log(torch.diagonal(A, dim1=-2, dim2=-1)).sum(-1)


# each operator with the imperative face of ndarray/ops.py: arrays in,
# arrays out; tensors in, tensors out
for _name in __all__:
    globals()[_name] = _op(globals()[_name])
del _name
