"""ctypes binding of the native data pipeline (``native/tpumx_io.cpp``),
from ``tpu_mx/lib/recordio_cpp.py``: ``NativeImagePipe``,
``NativeDetPipe`` and ``native_im2rec``, with the reference's arguments
and outputs.

A foreign call releases the interpreter lock, so the library's decode
threads run beside Python.  Each batch is written by the library into
fresh buffers that are torch tensors (``pin_memory=True`` allocates
them in page-locked memory, for a batch bound for the card); the pipe
hands back numpy views of them, and ``torch.from_numpy`` of a view is
the tensor again, without a copy.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import ensure_built

__all__ = ["NativeImagePipe", "NativeDetPipe", "native_im2rec"]

_lib = None


def _load():
    global _lib
    if _lib is None:
        path = ensure_built()
        lib = ctypes.CDLL(path)
        lib.tmx_det_pipe_create_v2.restype = ctypes.c_void_p
        lib.tmx_det_pipe_create_v2.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
            ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_uint64, ctypes.c_int, ctypes.c_int,
            ctypes.c_char_p, ctypes.c_int,
        ]
        lib.tmx_pipe_create_v2.restype = ctypes.c_void_p
        lib.tmx_pipe_create_v2.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_uint64,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_char_p,
            ctypes.c_int,
        ]
        lib.tmx_pipe_next.restype = ctypes.c_int
        lib.tmx_pipe_next.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_float)]
        lib.tmx_pipe_size.restype = ctypes.c_longlong
        lib.tmx_pipe_size.argtypes = [ctypes.c_void_p]
        lib.tmx_pipe_reset.restype = None
        lib.tmx_pipe_reset.argtypes = [ctypes.c_void_p]
        lib.tmx_pipe_error.restype = ctypes.c_char_p
        lib.tmx_pipe_error.argtypes = [ctypes.c_void_p]
        lib.tmx_pipe_destroy.restype = None
        lib.tmx_pipe_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
    return _lib


def _buffers(data_shape, dtype, label_shape, pin):
    """Fresh output buffers as tensors, and numpy views of them."""
    data = torch.empty(data_shape, dtype=dtype, pin_memory=pin)
    label = torch.empty(label_shape, dtype=torch.float32, pin_memory=pin)
    return data.numpy(), label.numpy()


class NativeImagePipe:
    """Threaded RecordIO -> JPEG decode -> augment -> NCHW (or NHWC)
    pipeline in C++."""

    def __init__(self, path_imgrec, batch_size, data_shape, resize=-1,
                 rand_crop=False, rand_mirror=False, mean=(0.0, 0.0, 0.0),
                 std=(1.0, 1.0, 1.0), preprocess_threads=4,
                 prefetch_buffer=4, shuffle=False, seed=0, label_width=1,
                 output_dtype="float32", output_layout="NCHW",
                 pin_memory=False):
        if output_dtype not in ("float32", "uint8"):
            raise ValueError(f"output_dtype must be float32|uint8, "
                             f"got {output_dtype!r}")
        if output_layout not in ("NCHW", "NHWC"):
            raise ValueError(f"output_layout must be NCHW|NHWC, "
                             f"got {output_layout!r}")
        lib = _load()
        c, h, w = data_shape
        mean_arr = (ctypes.c_float * 3)(*[float(m) for m in mean])
        std_arr = (ctypes.c_float * 3)(*[float(s) for s in std])
        err = ctypes.create_string_buffer(1024)
        self._u8 = output_dtype == "uint8"
        self._nhwc = output_layout == "NHWC"
        self._h = lib.tmx_pipe_create_v2(
            path_imgrec.encode(), batch_size, c, h, w,
            int(resize), int(bool(rand_crop)), int(bool(rand_mirror)),
            mean_arr, std_arr, int(preprocess_threads), int(prefetch_buffer),
            int(bool(shuffle)), int(seed), int(label_width),
            int(self._u8), int(self._nhwc), err, len(err))
        if not self._h:
            raise IOError("NativeImagePipe: %s" %
                          err.value.decode(errors="replace"))
        self._lib = lib
        self.batch_size = batch_size
        self.data_shape = tuple(data_shape)
        # the shape next_batch actually emits (NHWC reorders data_shape)
        self.out_shape = (h, w, c) if self._nhwc else (c, h, w)
        self.out_dtype = np.uint8 if self._u8 else np.float32
        self.label_width = label_width
        self.pin_memory = bool(pin_memory)

    def __len__(self):
        return int(self._lib.tmx_pipe_size(self._h))

    def next_batch(self):
        """``(data, label)`` as fresh arrays, or None at the epoch's end;
        the library writes them directly."""
        data, label = _buffers(
            (self.batch_size,) + self.out_shape,
            torch.uint8 if self._u8 else torch.float32,
            (self.batch_size, self.label_width), self.pin_memory)
        n = self._lib.tmx_pipe_next(
            self._h,
            data.ctypes.data_as(ctypes.c_void_p),
            label.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        if n < 0:
            raise IOError("NativeImagePipe: %s" %
                          self._lib.tmx_pipe_error(self._h).decode(
                              errors="replace"))
        if n == 0:
            return None
        return data, label[:, 0] if self.label_width == 1 else label

    def reset(self):
        self._lib.tmx_pipe_reset(self._h)

    def close(self):
        if getattr(self, "_h", None):
            self._lib.tmx_pipe_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class NativeDetPipe:
    """Threaded RecordIO -> JPEG decode -> box-aware augment -> (images,
    ``(max_objects, 5)`` labels) pipeline in C++: the labels are the
    fixed-width blocks, padded with -1, that ``MultiBoxTarget`` takes."""

    def __init__(self, path_imgrec, batch_size, data_shape, max_objects,
                 rand_crop=False, rand_mirror=False, mean=(0.0, 0.0, 0.0),
                 std=(1.0, 1.0, 1.0), min_object_covered=0.3,
                 area_range=(0.3, 1.0), aspect_ratio_range=(0.75, 1.33),
                 max_attempts=20, preprocess_threads=4, prefetch_buffer=4,
                 shuffle=False, seed=0, output_dtype="float32",
                 output_layout="NCHW", pin_memory=False):
        if output_dtype not in ("float32", "uint8"):
            raise ValueError(f"output_dtype must be float32|uint8, "
                             f"got {output_dtype!r}")
        if output_layout not in ("NCHW", "NHWC"):
            raise ValueError(f"output_layout must be NCHW|NHWC, "
                             f"got {output_layout!r}")
        lib = _load()
        c, h, w = data_shape
        mean_arr = (ctypes.c_float * 3)(*[float(m) for m in mean])
        std_arr = (ctypes.c_float * 3)(*[float(s) for s in std])
        err = ctypes.create_string_buffer(1024)
        self._u8 = output_dtype == "uint8"
        self._nhwc = output_layout == "NHWC"
        self._h = lib.tmx_det_pipe_create_v2(
            path_imgrec.encode(), batch_size, c, h, w, int(max_objects),
            int(bool(rand_crop)), int(bool(rand_mirror)), mean_arr, std_arr,
            float(min_object_covered), float(area_range[0]),
            float(area_range[1]), float(aspect_ratio_range[0]),
            float(aspect_ratio_range[1]), int(max_attempts),
            int(preprocess_threads), int(prefetch_buffer),
            int(bool(shuffle)), int(seed), int(self._u8), int(self._nhwc),
            err, len(err))
        if not self._h:
            raise IOError("NativeDetPipe: %s" %
                          err.value.decode(errors="replace"))
        self._lib = lib
        self.batch_size = batch_size
        self.data_shape = tuple(data_shape)
        self.out_shape = (h, w, c) if self._nhwc else (c, h, w)
        self.out_dtype = np.uint8 if self._u8 else np.float32
        self.max_objects = int(max_objects)
        self.pin_memory = bool(pin_memory)

    def __len__(self):
        return int(self._lib.tmx_pipe_size(self._h))

    def next_batch(self):
        """``(data, label)`` as fresh arrays, or None at the epoch's end."""
        data, label = _buffers(
            (self.batch_size,) + self.out_shape,
            torch.uint8 if self._u8 else torch.float32,
            (self.batch_size, self.max_objects, 5), self.pin_memory)
        n = self._lib.tmx_pipe_next(
            self._h,
            data.ctypes.data_as(ctypes.c_void_p),
            label.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        if n < 0:
            raise IOError("NativeDetPipe: %s" %
                          self._lib.tmx_pipe_error(self._h).decode(
                              errors="replace"))
        if n == 0:
            return None
        return data, label

    def reset(self):
        self._lib.tmx_pipe_reset(self._h)

    def close(self):
        if getattr(self, "_h", None):
            self._lib.tmx_pipe_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def native_im2rec(lst_path, root, out_prefix, resize=0, quality=95,
                  num_thread=4, upscale=False):
    """Parallel C++ dataset packer: a ``.lst`` file (``index\tlabel...\t
    path`` lines) to ``out_prefix.rec``/``.idx``, in the format every
    reader here reads.  ``resize=0`` stores the files' bytes;
    ``resize>0`` re-encodes with the shorter side at ``resize``
    (decode, bilinear, libjpeg at ``quality``; downscale only unless
    ``upscale``).  JPEG inputs only; unreadable ones are skipped with a
    note on stderr.  Returns the record count."""
    _load()
    if not hasattr(_lib, "_im2rec_ready"):
        _lib.tmx_im2rec.restype = ctypes.c_long
        _lib.tmx_im2rec.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_char_p, ctypes.c_int]
        _lib._im2rec_ready = True
    err = ctypes.create_string_buffer(1024)
    n = _lib.tmx_im2rec(str(lst_path).encode(), str(root).encode(),
                        str(out_prefix).encode(), int(resize), int(quality),
                        int(num_thread), int(bool(upscale)), err, len(err))
    if n < 0:
        raise RuntimeError(f"native im2rec failed: {err.value.decode()}")
    return int(n)
