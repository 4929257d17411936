"""The native data pipeline, from ``tpu_mx/lib/__init__.py``: the
repository's ``native/tpumx_io.cpp``, unchanged, built with ``g++`` at
first use.

The library goes to ``build/tpu_mx_torch/libtpumx_io-<key>.so`` beside
the package (``build/`` is not committed); ``<key>`` is a hash of the
source, the compiler's flags and ``g++ --version``, so a changed input
builds anew and an unchanged one is reused.  A build writes a temporary
file and renames it, under a file lock, so processes that start
together (test workers, data-parallel ranks) build once.

The source reads and writes JPEG through libjpeg.  Where the compiler
finds ``jpeglib.h`` the library links the system's ``-ljpeg``; a host
without the headers but with Pillow links the libjpeg-turbo that
Pillow's wheel carries, against the version-62 headers kept in
``jpeg_include/`` (its README says why that is sound).  A host with
neither raises :class:`NativeBuildError` naming what it lacks.
"""
from __future__ import annotations

import fcntl
import glob
import hashlib
import importlib.util
import os
import subprocess

_LIB_DIR = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.dirname(os.path.dirname(_LIB_DIR))
_SRC = os.path.join(_ROOT, "native", "tpumx_io.cpp")
_BUILD = os.path.join(_ROOT, "build", "tpu_mx_torch")
_JPEG_INCLUDE = os.path.join(_LIB_DIR, "jpeg_include")
_FLAGS = ["-O3", "-march=native", "-funroll-loops", "-std=c++17", "-shared",
          "-fPIC"]

__all__ = ["NativeBuildError", "ensure_built", "jpeg_link"]


class NativeBuildError(RuntimeError):
    pass


def _run(cmd, stdin=None, timeout=300):
    try:
        return subprocess.run(cmd, input=stdin, capture_output=True,
                              text=True, timeout=timeout)
    except FileNotFoundError as e:
        raise NativeBuildError(f"g++ not available: {e}") from e


def _system_jpeg():
    """True when the compiler finds ``jpeglib.h`` on its own path."""
    probe = _run(["g++", "-E", "-x", "c++", "-", "-o", os.devnull],
                 stdin="#include <cstdio>\n#include <jpeglib.h>\n", timeout=60)
    return probe.returncode == 0


def _pillow_libjpeg():
    """The libjpeg-turbo shared library of Pillow's wheel, or None."""
    spec = importlib.util.find_spec("PIL")
    if spec is None or not spec.submodule_search_locations:
        return None
    site = os.path.dirname(list(spec.submodule_search_locations)[0])
    found = sorted(glob.glob(os.path.join(site, "pillow.libs",
                                          "libjpeg-*.so*")))
    return found[0] if found else None


def jpeg_link():
    """``(what, flags)``: which libjpeg the library links and the
    compiler flags that link it (see the module's docstring)."""
    if _system_jpeg():
        return "system", ["-ljpeg"]
    lib = _pillow_libjpeg()
    if lib is not None:
        return f"pillow:{os.path.basename(lib)}", [
            "-I", _JPEG_INCLUDE, lib, "-Wl,-rpath," + os.path.dirname(lib)]
    raise NativeBuildError(
        "no libjpeg on this host: the compiler finds no jpeglib.h (install "
        "libjpeg's development files) and Pillow, whose wheel carries "
        "libjpeg-turbo, is not installed")


def ensure_built():
    """Build the library if this source, these flags and this compiler
    have not built it yet; returns its path."""
    if not os.path.isfile(_SRC):
        raise NativeBuildError(f"native source not found: {_SRC}")
    _, jpeg = jpeg_link()
    version = _run(["g++", "--version"], timeout=60).stdout
    key = hashlib.sha256()
    with open(_SRC, "rb") as f:
        key.update(f.read())
    key.update("\0".join(_FLAGS + jpeg + [version]).encode())
    so = os.path.join(_BUILD, f"libtpumx_io-{key.hexdigest()[:16]}.so")
    if os.path.isfile(so):
        return so
    os.makedirs(_BUILD, exist_ok=True)
    with open(so + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if os.path.isfile(so):
                return so
            tmp = f"{so}.build.{os.getpid()}"
            done = _run(["g++", *_FLAGS, _SRC, "-o", tmp, *jpeg,
                         "-lpthread"])
            try:
                if done.returncode != 0:
                    raise NativeBuildError(
                        f"native build failed:\n{done.stderr[-4000:]}")
                os.replace(tmp, so)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return so
