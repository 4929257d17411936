"""Runtime-compiled CUDA user kernels: the port of ``tpu_mx/rtc.py``.

The reference runs a user's kernel through ``pl.pallas_call``
(``PallasModule`` holds named kernel functions, ``get_kernel`` binds
static arguments, ``Kernel.launch`` allocates one output and runs the
kernel with the output after the inputs).  On the card the kernel
language is CUDA C, as in MXNet's ``CudaModule``, which the reference
was modelled on::

    src = r'''
    extern "C" __global__ void scale(const float* x, float* y, float alpha,
                                     int n) {
      int i = blockIdx.x * blockDim.x + threadIdx.x;
      if (i < n) y[i] = x[i] * alpha;
    }'''
    mod = rtc.CudaModule(src)
    k = mod.get_kernel("scale", alpha=3.0)
    y = k.launch((x,))            # x a CUDA tensor: y = x * 3

- :class:`CudaModule` holds source with one or more ``extern "C"
  __global__`` kernels; ``exports`` limits which names ``get_kernel``
  hands out.  ``get_kernel`` reads the kernel's parameter list from the
  source: pointers, and scalars of type ``float``, ``double``, ``int``,
  ``unsigned``, ``long long``/``int64_t`` or ``bool``.  A type it cannot
  pass, a static argument the kernel does not have or a scalar left
  unbound raises :class:`MXNetError` there.
- :meth:`Kernel.launch` fills the pointer parameters, in order, with the
  inputs and then the output, and each scalar parameter with the static
  argument of its name; a scalar ``n`` left unbound receives the
  output's element count.  ``block`` defaults to 256 threads and
  ``grid`` to ``ceil(n / block)``.  Inputs are contiguous CUDA tensors
  on one device; the kernel runs on that device's current stream and the
  output tensor is returned.  Each launch adds one to
  ``Kernel.launches``.  ``launch`` takes torch tensors and returns one,
  or takes :class:`~tpu_mx_torch.ndarray.NDArray` handles (any of the
  inputs) and returns an ``NDArray``, as the reference's does.
- The source is compiled at the first launch, not at construction, by
  ``nvcc -cubin`` for ``sm_90a`` into ``build/tpu_mx_torch/rtc/<sha256 of
  source, options and nvcc version>.cubin`` (reused while it exists); an
  ``nvcc`` failure raises :class:`MXNetError` with its log.  The cubin is
  loaded with ``libcuda.so.1``'s module API (``cuModuleLoadData``,
  through :mod:`ctypes`), once per (device, hash), and launched with
  ``cuLaunchKernel``; an error code it returns raises
  :class:`MXNetError` with ``cuGetErrorString``'s text.
- There is no CUDA-C interpreter on the host, so ``launch`` on CPU
  tensors raises (the reference runs its Pallas kernels in interpret
  mode there).
"""
from __future__ import annotations

import ctypes
import hashlib
import math
import os
import re
import subprocess
import threading

import torch

from .base import MXNetError
from .ndarray.ndarray import NDArray
from .kernels import _build

__all__ = ["CudaModule", "Kernel", "NVCC_FLAGS", "RTC_DIR"]

RTC_DIR = _build.BUILD_DIR / "rtc"
NVCC_FLAGS = ("-cubin", "-gencode", "arch=compute_90a,code=sm_90a",
              "-std=c++17", "-O3")

_SCALARS = {
    "float": ctypes.c_float, "double": ctypes.c_double,
    "int": ctypes.c_int32, "int32_t": ctypes.c_int32,
    "unsigned": ctypes.c_uint32, "unsigned int": ctypes.c_uint32,
    "uint32_t": ctypes.c_uint32, "long long": ctypes.c_int64,
    "long long int": ctypes.c_int64, "int64_t": ctypes.c_int64,
    "bool": ctypes.c_bool,
}
_QUALIFIERS = {"const", "volatile", "__restrict__", "__restrict", "restrict"}
_LAUNCH_BOUNDS = r"(?:__launch_bounds__\s*\([^)]*\)\s*)?"
_KERNEL = re.compile(r'extern\s+"C"\s+__global__\s+' + _LAUNCH_BOUNDS
                     + r"void\s+" + _LAUNCH_BOUNDS
                     + r"([A-Za-z_]\w*)\s*\(([^)]*)\)")
_COMMENTS = re.compile(r"//[^\n]*|/\*.*?\*/", re.S)

_lock = threading.Lock()
_cuda = None
_modules = {}     # (device index, hash) -> CUmodule
_functions = {}   # (device index, hash, kernel name) -> CUfunction


def _parse_params(kernel, decls):
    """``[(name, "pointer" | "scalar", ctypes type or None)]`` of one
    kernel's parameter list."""
    if decls.strip() in ("", "void"):
        return []
    params = []
    for decl in decls.split(","):
        toks = re.findall(r"[A-Za-z_]\w*|\*|&", decl)
        words = [t for t in toks[:-1] if t not in _QUALIFIERS]
        if not words:
            raise MXNetError(f"rtc: kernel {kernel!r}: cannot read the "
                             f"parameter {decl.strip()!r}")
        if "*" in words:
            params.append((toks[-1], "pointer", None))
            continue
        ctype = _SCALARS.get(" ".join(words))
        if ctype is None:
            raise MXNetError(
                f"rtc: kernel {kernel!r}: cannot pass the parameter "
                f"{decl.strip()!r}; pointers and the scalar types "
                f"{sorted(_SCALARS)} are taken")
        params.append((toks[-1], "scalar", ctype))
    return params


def _scalar(ctype, value, name):
    """``value`` as ``ctype``, refusing what the type cannot hold."""
    try:
        out = ctype(value)
    except TypeError as e:
        raise MXNetError(f"rtc: {name}={value!r} is not a "
                         f"{ctype.__name__}") from e
    if ctype not in (ctypes.c_float, ctypes.c_double, ctypes.c_bool) \
            and out.value != value:
        raise MXNetError(f"rtc: {name}={value!r} does not fit a "
                         f"{ctype.__name__}")
    return out


def _dims(x, what):
    dims = (x,) if isinstance(x, int) else tuple(x)
    if not 1 <= len(dims) <= 3 or any(not isinstance(d, int) or d < 0
                                      for d in dims):
        raise MXNetError(f"rtc: {what} must be an int or 1-3 ints, "
                         f"got {x!r}")
    return dims + (1,) * (3 - len(dims))


def _libcuda():
    """``libcuda.so.1`` with the entry points used here declared."""
    global _cuda
    if _cuda is None:
        lib = ctypes.CDLL("libcuda.so.1")
        p, i, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
        pp = ctypes.POINTER(p)
        for name, args in (
                ("cuGetErrorString", [i, ctypes.POINTER(ctypes.c_char_p)]),
                ("cuCtxGetCurrent", [pp]),
                ("cuCtxGetDevice", [ctypes.POINTER(i)]),
                ("cuModuleLoadData", [pp, ctypes.c_char_p]),
                ("cuModuleGetFunction", [pp, p, ctypes.c_char_p]),
                ("cuLaunchKernel", [p, u, u, u, u, u, u, u, p, pp, pp])):
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = args, i
        _cuda = lib
    return _cuda


def _check(code, what):
    if code != 0:
        msg = ctypes.c_char_p()
        _libcuda().cuGetErrorString(code, ctypes.byref(msg))
        text = msg.value.decode() if msg.value else "unknown error"
        raise MXNetError(f"rtc: {what}: CUDA error {code} ({text})")


def _require_context(device):
    """libcuda's calls act on the thread's current context: torch's
    primary context of ``device``, made current by touching the device
    through torch.  Raise if none is current, or another device's."""
    cu = _libcuda()
    ctx = ctypes.c_void_p()
    _check(cu.cuCtxGetCurrent(ctypes.byref(ctx)), "cuCtxGetCurrent")
    if not ctx.value:
        torch.cuda.synchronize(device)
        _check(cu.cuCtxGetCurrent(ctypes.byref(ctx)), "cuCtxGetCurrent")
    if not ctx.value:
        raise MXNetError(f"rtc: no CUDA context is current on this thread "
                         f"after touching {device} through torch")
    index = ctypes.c_int()
    _check(cu.cuCtxGetDevice(ctypes.byref(index)), "cuCtxGetDevice")
    if index.value != device.index:
        raise MXNetError(f"rtc: the current CUDA context is device "
                         f"{index.value}'s, not {device}'s")


class CudaModule:
    """CUDA C source holding ``extern "C" __global__`` kernels (the
    reference's ``PallasModule``, MXNet's ``CudaModule``).  ``exports``
    filters which names :meth:`get_kernel` hands out; ``options`` are
    extra ``nvcc`` flags (``-D...``, ``--use_fast_math``)."""

    def __init__(self, source, exports=None, options=()):
        self.source = source
        self.options = tuple(options)
        self._exports = set(exports) if exports is not None else None
        self._decls = {m.group(1): m.group(2) for m in
                       _KERNEL.finditer(_COMMENTS.sub("", source))}
        self._key = None

    @property
    def kernels(self):
        """The names of the kernels found in the source."""
        return sorted(self._decls)

    def get_kernel(self, name, **static_kwargs):
        """The kernel ``name`` with its scalar parameters bound by name
        from ``static_kwargs`` (``n`` may stay unbound: it then receives
        the output's element count at each launch)."""
        if name not in self._decls or (
                self._exports is not None and name not in self._exports):
            raise MXNetError(f"kernel {name!r} not found/exported "
                             f"(have: {self.kernels})")
        params = _parse_params(name, self._decls[name])
        scalars = {p: ctype for p, kind, ctype in params if kind == "scalar"}
        unknown = sorted(set(static_kwargs) - set(scalars))
        if unknown:
            raise MXNetError(f"rtc: kernel {name!r} has no scalar "
                             f"parameter {unknown} (its scalars: "
                             f"{sorted(scalars)})")
        missing = sorted(set(scalars) - set(static_kwargs) - {"n"})
        if missing:
            raise MXNetError(f"rtc: kernel {name!r}: scalar parameters "
                             f"{missing} are not bound")
        static = {p: _scalar(scalars[p], v, p)
                  for p, v in static_kwargs.items()}
        return Kernel(self, name, params, static)

    @property
    def key(self):
        """sha256 of the source, the ``nvcc`` flags and version."""
        if self._key is None:
            h = hashlib.sha256()
            for part in (self.source, " ".join(NVCC_FLAGS + self.options),
                         _build.nvcc_version()):
                h.update(part.encode() + b"\0")
            self._key = h.hexdigest()
        return self._key

    def cubin(self):
        """The path of the compiled module, built by ``nvcc`` if it is
        not there yet."""
        path = RTC_DIR / f"{self.key}.cubin"
        if path.exists():
            return path
        RTC_DIR.mkdir(parents=True, exist_ok=True)
        src = RTC_DIR / f"{self.key}.cu"
        src.write_text(self.source)
        tmp = RTC_DIR / f"{self.key}.tmp{os.getpid()}.cubin"
        run = subprocess.run([_build.nvcc_path(), *NVCC_FLAGS, *self.options,
                              "-o", str(tmp), str(src)],
                             capture_output=True, text=True)
        if run.returncode != 0:
            raise MXNetError(f"rtc: nvcc failed (exit {run.returncode}):\n"
                             f"{run.stdout}{run.stderr}")
        os.replace(tmp, path)
        return path

    def function(self, device, name):
        """The loaded ``CUfunction`` of kernel ``name`` on ``device`` (a
        CUDA ``torch.device`` whose context is current)."""
        fn = _functions.get((device.index, self.key, name))
        if fn is not None:     # the launch path: no file system access
            return fn
        path = self.cubin()
        with _lock:
            cu = _libcuda()
            mod = _modules.get((device.index, self.key))
            if mod is None:
                mod = ctypes.c_void_p()
                _check(cu.cuModuleLoadData(ctypes.byref(mod),
                                           path.read_bytes()),
                       "cuModuleLoadData")
                _modules[(device.index, self.key)] = mod
            fn = ctypes.c_void_p()
            _check(cu.cuModuleGetFunction(ctypes.byref(fn), mod,
                                          name.encode()),
                   f"cuModuleGetFunction({name})")
            _functions[(device.index, self.key, name)] = fn
            return fn


class Kernel:
    """A launchable kernel of a :class:`CudaModule` (the reference's
    ``Kernel``, MXNet's ``CudaKernel``).  ``params`` lists the kernel's
    ``(name, "pointer" | "scalar", ctypes type)`` parameters."""

    launches = 0

    def __init__(self, module, name, params, static):
        self.module = module
        self.name = name
        self.params = params
        self._static = static
        self._n_ptr = sum(kind == "pointer" for _, kind, _ in params)

    def launch(self, args, out_shape=None, out_dtype="float32", grid=None,
               block=None, shared_mem=0):
        """Allocate the output (``out_shape``, default the first input's
        shape; ``out_dtype`` a name or a ``torch.dtype``), run the kernel
        on the inputs' device and current stream with ``shared_mem``
        bytes of dynamic shared memory (at most 48 KB), and return the
        output: an ``NDArray`` when an input was one, else a tensor."""
        if isinstance(args, (torch.Tensor, NDArray)):
            args = (args,)
        args = tuple(args)
        if any(isinstance(a, NDArray) for a in args):
            return NDArray(self._launch(
                tuple(a._data.detach() if isinstance(a, NDArray) else a
                      for a in args), out_shape, out_dtype, grid, block,
                shared_mem))
        return self._launch(args, out_shape, out_dtype, grid, block,
                            shared_mem)

    def _launch(self, args, out_shape, out_dtype, grid, block, shared_mem):
        if not args or not all(isinstance(a, torch.Tensor) for a in args):
            raise MXNetError("rtc: launch takes a sequence of torch tensors "
                             "or NDArrays")
        dev = args[0].device
        if dev.type != "cuda":
            raise MXNetError(
                f"rtc: kernel {self.name!r} got tensors on {dev}: CUDA "
                "kernels run on the card, and there is no CUDA-C "
                "interpreter on the host")
        for a in args:
            if a.device != dev:
                raise MXNetError(f"rtc: inputs on {a.device} and {dev}: "
                                 "all inputs must be on one device")
            if not a.is_contiguous():
                raise MXNetError("rtc: inputs must be contiguous")
        if self._n_ptr != len(args) + 1:
            raise MXNetError(f"rtc: kernel {self.name!r} takes "
                             f"{self._n_ptr} pointers (inputs, then the "
                             f"output), got {len(args)} inputs")
        dtype = getattr(torch, out_dtype, None) \
            if isinstance(out_dtype, str) else out_dtype
        if not isinstance(dtype, torch.dtype):
            raise MXNetError(f"rtc: unknown out_dtype {out_dtype!r}")
        shape = tuple(args[0].shape) if out_shape is None \
            else tuple(out_shape)
        with torch.cuda.device(dev):
            out = torch.empty(shape, dtype=dtype, device=dev)
            n = out.numel()
            block = _dims(256 if block is None else block, "block")
            grid = _dims(math.ceil(n / block[0]) if grid is None else grid,
                         "grid")
            if n == 0 or 0 in grid:
                return out
            _require_context(dev)
            fn = self.module.function(dev, self.name)
            ptrs = iter(args + (out,))
            values = [ctypes.c_void_p(next(ptrs).data_ptr())
                      if kind == "pointer" else self._static[name]
                      if name in self._static else _scalar(ctype, n, name)
                      for name, kind, ctype in self.params]
            params = (ctypes.c_void_p * len(values))(
                *[ctypes.addressof(v) for v in values])
            stream = torch.cuda.current_stream(dev).cuda_stream
            _check(_libcuda().cuLaunchKernel(fn, *grid, *block,
                                            int(shared_mem), stream, params,
                                            None),
                   f"cuLaunchKernel({self.name})")
        Kernel.launches += 1
        return out

    __call__ = launch
