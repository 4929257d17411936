"""``mx.np.linalg``: numpy's linear algebra over ``torch.linalg`` (LAPACK
on the host, cuSOLVER on the card), through the operators' dispatch,
as ``tpu_mx/numpy/linalg.py`` has it over ``jax.numpy.linalg``.  The
argument names are numpy's (``axis``, ``keepdims``, ``UPLO``, ``rcond``,
``axes``, ``ind``); ``lstsq`` returns numpy's ``(x, residuals, rank,
singular values)``.  ``eigh``/``eigvalsh`` of float32 on the card run
in float64, as ``nd.linalg_syevd`` does."""
from __future__ import annotations

import numpy as _onp
import torch

from ..ndarray import ops as _ops
from ..ndarray.linalg_ops import eigh as _eigh
from . import _t


def _norm(x, ord=None, axis=None, keepdims=False):
    return torch.linalg.norm(x, ord, axis, bool(keepdims))


def _lstsq(a, b, rcond=None, **kw):
    res = torch.linalg.lstsq(a, b, rcond=rcond,
                             driver=None if a.is_cuda else "gelsd")
    return [res.solution, res.residuals, res.rank, res.singular_values]


_IMPL = {
    "cholesky": lambda a, **kw: torch.linalg.cholesky(a),
    "cond": lambda x, p=None: torch.linalg.cond(x, p),
    "det": torch.linalg.det,
    "eig": lambda a: list(torch.linalg.eig(a)),
    "eigh": lambda a, UPLO="L", **kw: list(_eigh(a, UPLO)),
    "eigvals": torch.linalg.eigvals,
    "eigvalsh": lambda a, UPLO="L", **kw: _eigh(a, UPLO)[0],
    "inv": torch.linalg.inv,
    "lstsq": _lstsq,
    "matrix_power": lambda a, n: torch.linalg.matrix_power(a, n),
    "matrix_rank": lambda M, rtol=None, hermitian=False, **kw:
        torch.linalg.matrix_rank(M, rtol=rtol, hermitian=hermitian),
    "multi_dot": lambda arrays, **kw: torch.linalg.multi_dot(
        [_t(a) for a in arrays]),
    "norm": _norm,
    "pinv": lambda a, rcond=None, hermitian=False, **kw: torch.linalg.pinv(
        a, rtol=rcond, hermitian=hermitian),
    "qr": lambda a, mode="reduced": list(torch.linalg.qr(a, mode)),
    "slogdet": lambda a: list(torch.linalg.slogdet(a)),
    "solve": torch.linalg.solve,
    "svd": lambda a, full_matrices=True, compute_uv=True, **kw:
        list(torch.linalg.svd(a, full_matrices)) if compute_uv
        else torch.linalg.svdvals(a),
    "tensorinv": lambda a, ind=2: torch.linalg.tensorinv(a, ind),
    "tensorsolve": lambda a, b, axes=None: torch.linalg.tensorsolve(
        a, b, axes),
}


def _wrap(name):
    impl = _IMPL[name]

    def op(*args, **kwargs):
        def f(*raw, **kw):
            return impl(*[_t(r) if isinstance(r, _onp.ndarray) else r
                          for r in raw], **kw)
        return _ops._apply(f, args, kwargs)

    op.__name__ = op.__qualname__ = name
    return op


_WRAPPED = sorted(_IMPL)
for _name in _WRAPPED:
    globals()[_name] = _wrap(_name)

__all__ = list(_WRAPPED)
