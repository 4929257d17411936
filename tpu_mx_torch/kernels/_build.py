"""Build the port's CUDA kernels from ``tpu_mx_torch/csrc`` and load them.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by
``nvcc`` on its own into ``build/tpu_mx_torch/<name>-<hash>.so`` under
the checkout's root, then loaded with :mod:`ctypes` — no PyTorch headers
are compiled, which keeps a build to seconds.  ``<hash>`` covers the
source, the shared headers (``csrc/*.cuh``), the ``nvcc`` flags and the
``nvcc`` version, so an edited source rebuilds at its next use and an
unchanged one is loaded as it is.

Nothing here runs at import: a source is built at the first call of the
kernel that needs it (or all at once, in parallel, by :func:`build_all`).
Each C entry point returns ``cudaGetLastError()`` after its launch, and
:func:`check` turns a non-zero code into an :class:`MXNetError`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

from ..base import MXNetError

__all__ = ["SOURCES", "nvcc_path", "nvcc_version", "build", "build_all",
           "load", "check", "stream", "BUILD_DIR"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tpu_mx_torch"
SOURCES = ("paged_attention", "flash_attention_fwd", "flash_attention_bwd")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs = {}


def nvcc_path():
    """The ``nvcc`` on ``PATH``, else the one of PyTorch's CUDA home."""
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise MXNetError("nvcc not found (not on PATH, no CUDA_HOME): the "
                     "port's kernels are built from source at first use")


def nvcc_version():
    return subprocess.run([nvcc_path(), "--version"], capture_output=True,
                          text=True, check=True).stdout


def _target(name):
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()
                         + nvcc_version().encode()).hexdigest()[:16]
    return CSRC / f"{name}.cu", BUILD_DIR / f"{name}-{key}.so"


def _start(name):
    """Start ``nvcc`` for ``name`` unless its library is built; returns
    ``(out_path, process or None)``."""
    src, out = _target(name)
    if out.exists():
        return out, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}.so")
    proc = subprocess.Popen(
        [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return out, (proc, tmp)


def _finish(name, out, started):
    """Wait for a started build and publish its library atomically; the
    compiler's report (``-Xptxas -v``: registers, shared memory, spills)
    is kept beside it as ``<lib>.log``."""
    if started is None:
        return
    proc, tmp = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise MXNetError(f"nvcc failed for csrc/{name}.cu "
                         f"(exit {proc.returncode}):\n{log}")
    out.with_suffix(".log").write_text(log)
    os.replace(tmp, out)


def build(name):
    """Build ``csrc/<name>.cu`` if needed; returns the library path."""
    out, started = _start(name)
    _finish(name, out, started)
    return out


def build_all():
    """Build every source at once, one ``nvcc`` each, all started
    together; returns ``{name: library path}``."""
    started = {name: _start(name) for name in SOURCES}
    for name, (out, proc) in started.items():
        _finish(name, out, proc)
    return {name: out for name, (out, _) in started.items()}


def load(name):
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = _libs[name] = ctypes.CDLL(str(build(name)))
        return lib


def check(lib, code, what):
    """Raise if a C entry point of ``lib`` reported a CUDA error."""
    if code != 0:
        lib.tmx_error_string.restype = ctypes.c_char_p
        lib.tmx_error_string.argtypes = [ctypes.c_int]
        msg = lib.tmx_error_string(code).decode()
        raise MXNetError(f"{what}: CUDA error {code} ({msg}) at launch")


def stream(t):
    """The raw handle of the current CUDA stream of CUDA tensor ``t``'s
    device, for a C entry point (what ``torch.cuda.current_stream(
    t.device).cuda_stream`` returns, without building a Stream object on
    every launch)."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)
