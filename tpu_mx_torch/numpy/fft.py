"""``mx.np.fft``: numpy's FFT routines over ``torch.fft`` (cuFFT on the
card), through the operators' dispatch, as ``tpu_mx/numpy/fft.py`` has
them over ``jax.numpy.fft``.  numpy's ``axis``/``axes`` are torch's
``dim``."""
from __future__ import annotations

import torch

from ..ndarray import ops as _ops
from . import _dev, _dt, _made, _t


def _wrap(name):
    tfn = getattr(torch.fft, name)

    def op(a, *args, **kwargs):
        for k in ("axis", "axes"):
            if k in kwargs:
                kwargs["dim"] = kwargs.pop(k)
        return _ops._apply(lambda x: tfn(_t(x), *args, **kwargs)
                           .resolve_conj(), (a,), {})

    op.__name__ = op.__qualname__ = name
    op.__doc__ = f"mx.np.fft.{name}: numpy.fft.{name} over torch.fft.{name}"
    return op


_WRAPPED = ["fft", "ifft", "fft2", "ifft2", "fftn", "ifftn", "rfft",
            "irfft", "rfft2", "irfft2", "rfftn", "irfftn", "hfft", "ihfft",
            "fftshift", "ifftshift"]
for _name in _WRAPPED:
    globals()[_name] = _wrap(_name)


def fftfreq(n, d=1.0, dtype=None, ctx=None):
    return _made(torch.fft.fftfreq(n, d, dtype=_dt(dtype)), ctx)


def rfftfreq(n, d=1.0, dtype=None, ctx=None):
    return _made(torch.fft.rfftfreq(n, d, dtype=_dt(dtype)), ctx)


__all__ = _WRAPPED + ["fftfreq", "rfftfreq"]
