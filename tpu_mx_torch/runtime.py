"""Runtime feature detection, from ``tpu_mx/runtime.py`` (the reference's
``mx.runtime``).

``feature_list()`` probes the port's own installation at the call, as
the reference probes its jax installation: PyTorch (``TORCH``), a CUDA
build of it (``CUDA``), a card (``GPU``), ``nvcc`` (``NVCC``), Triton
(``TRITON``), the kernels' libraries built for this source and compiler
(``KERNELS``: every ``csrc`` unit of :mod:`~tpu_mx_torch.kernels._build`
present in ``build/``), OpenCV (``OPENCV``), PIL (``PIL``), the native
record reader (``CPP_RECORDIO``) and the native JPEG pipe's library
built (``NATIVE_IO``), ``torch.distributed`` (``DIST_KVSTORE``),
bfloat16 on the device the port defaults to (``BF16``), int8 inference
(``INT8_QUANTIZATION``) and ``torch.profiler`` (``PROFILER``).  A probe
builds nothing.

``set_compilation_cache`` moves :mod:`~tpu_mx_torch.rtc`'s persistent
cubin cache; ``clear_compilation_cache`` drops the in-memory caches
(``rtc``'s loaded modules, the fusion engine's chains and graphs).
"""
from __future__ import annotations

import os
from pathlib import Path

__all__ = ["Feature", "Features", "feature_list", "fetch_sync"]


def fetch_sync(x):
    """Read ``x`` (an ``NDArray``, a tensor or anything numpy takes) back
    to the host and return it as a numpy array.  The device-to-host copy
    waits for the work that produced ``x``, and the stream runs in
    order, so a timing loop that fetches its last result (a scalar or a
    small slice) has waited for everything before it."""
    import numpy as np
    import torch
    from .ndarray.ndarray import NDArray
    if isinstance(x, torch.Tensor):
        x = NDArray(x.detach())
    if isinstance(x, NDArray):
        return x.asnumpy()      # float32 for bfloat16
    return np.asarray(x)


class Feature:
    def __init__(self, name, enabled):
        self.name = name
        self.enabled = bool(enabled)

    def __repr__(self):
        return "[%s: %s]" % ("✔" if self.enabled else "✖", self.name)


def _importable(name):
    try:
        __import__(name)
        return True
    except Exception:   # noqa: BLE001 — a broken install is a missing one
        return False


def _kernels_built():
    from .kernels import _build
    try:
        return all(_build._target(name)[1].exists()
                   for name in _build.SOURCES)
    except Exception:   # noqa: BLE001 — no nvcc: nothing can be built
        return False


def _native_io_built():
    from . import lib
    return any(p.name.startswith("libtpumx_io-") and p.suffix == ".so"
               for p in Path(lib._BUILD).glob("*.so"))


def _nvcc():
    from .kernels import _build
    try:
        _build.nvcc_path()
        return True
    except Exception:   # noqa: BLE001
        return False


def _probe():
    import torch
    gpu = torch.cuda.is_available()
    feats = {"TORCH": True, "CUDA": torch.version.cuda is not None,
             "GPU": gpu, "CPU": True, "NVCC": _nvcc(),
             "TRITON": _importable("triton"), "KERNELS": _kernels_built(),
             "OPENCV": _importable("cv2"), "PIL": _importable("PIL"),
             "CPP_RECORDIO": _importable("tpu_mx_torch.lib.recordio_cpp"),
             "NATIVE_IO": _native_io_built(),
             "DIST_KVSTORE": torch.distributed.is_available(),
             "BF16": torch.cuda.is_bf16_supported() if gpu else True,
             "INT8_QUANTIZATION": True,
             "PROFILER": _importable("torch.profiler")}
    return feats


class Features(dict):
    """``{name: Feature}``, like the reference's ``LibInfo`` wrapper."""

    def __init__(self):
        super().__init__({k: Feature(k, v) for k, v in _probe().items()})

    def is_enabled(self, name):
        feat = self.get(name.upper())
        return bool(feat and feat.enabled)

    def __repr__(self):
        return "[%s]" % ", ".join(map(str, self.values()))


def feature_list():
    """The features of this installation, probed now."""
    return list(Features().values())


def set_compilation_cache(directory, min_compile_time_secs=1.0):
    """Keep ``rtc``'s compiled cubins in ``directory`` (created at the
    first build) from now on.  ``min_compile_time_secs`` is taken for the
    reference's signature and ignored: every ``rtc`` build is cached.  The
    reference sets XLA's persistent cache the same way; the port's other
    compiled code (the kernels' libraries, the native pipe) lives under
    ``build/``."""
    from . import rtc
    rtc.RTC_DIR = Path(directory)


def enable_shared_compilation_cache():
    """The tools' shared cache, ``build/compile_cache`` beside the
    kernels' libraries, unless ``BENCH_COMPILE_CACHE`` is set to
    anything but ``1``.  Returns the directory, or None when disabled."""
    if os.environ.get("BENCH_COMPILE_CACHE", "1") != "1":
        return None
    from .kernels import _build
    directory = _build.BUILD_DIR.parent / "compile_cache"
    set_compilation_cache(directory)
    return str(directory)


def clear_compilation_cache():
    """Drop the in-memory caches: ``rtc``'s loaded modules and functions,
    and the fusion engine's chains and captured graphs.  The directory is
    left as it is."""
    from . import fusion, rtc
    with rtc._lock:
        rtc._modules.clear()
        rtc._functions.clear()
    fusion.clear_cache()
