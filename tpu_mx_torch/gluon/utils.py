"""``gluon.utils``, from ``tpu_mx/gluon/utils.py``: ``split_data``,
``split_and_load``, ``clip_global_norm``, ``check_sha1`` and
``download``."""
from __future__ import annotations

import hashlib
import math
import warnings

import torch

from ..ndarray import ops
from ..ndarray.ndarray import NDArray, array

__all__ = ["split_data", "split_and_load", "clip_global_norm", "check_sha1",
           "download"]


def split_data(data, num_slice, batch_axis=0, even_split=True):
    """``num_slice`` slices of ``data`` along ``batch_axis`` (the last
    takes the remainder unless ``even_split``, which requires none)."""
    size = data.shape[batch_axis]
    if even_split and size % num_slice != 0:
        raise ValueError(f"data size {size} not divisible by {num_slice} "
                         "slices")
    step = size // num_slice
    return [ops.slice_axis(data, axis=batch_axis, begin=i * step,
                           end=(i + 1) * step if i < num_slice - 1 else size)
            for i in range(num_slice)]


def split_and_load(data, ctx_list, batch_axis=0, even_split=True):
    """``data`` split into one slice per context of ``ctx_list``, each on
    its context."""
    if not isinstance(data, NDArray):
        data = array(data, ctx=ctx_list[0])
    if len(ctx_list) == 1:
        return [data.as_in_context(ctx_list[0])]
    slices = split_data(data, len(ctx_list), batch_axis, even_split)
    return [s.as_in_context(ctx) for s, ctx in zip(slices, ctx_list)]


def clip_global_norm(arrays, max_norm, check_isfinite=True):
    """Scale ``arrays`` in place so that their joint L2 norm (summed in
    float32) is at most ``max_norm``; returns the norm before scaling."""
    with torch.no_grad():
        total = torch.sqrt(sum(a._data.float().square().sum()
                               for a in arrays))
        norm = float(total)
    if check_isfinite and not math.isfinite(norm):
        warnings.warn("nan or inf in clip_global_norm", stacklevel=2)
    scale = max_norm / max(norm, max_norm)
    if scale < 1.0:
        with torch.no_grad():
            for a in arrays:
                a._data.mul_(scale)
    return norm


def check_sha1(filename, sha1_hash):
    """True iff the SHA-1 of the file's bytes is ``sha1_hash`` (hex)."""
    sha1 = hashlib.sha1()
    with open(filename, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            sha1.update(chunk)
    return sha1.hexdigest() == sha1_hash


def download(url, path=None, overwrite=False, sha1_hash=None, retries=5,
             verify_ssl=True):
    """Refused for every URL, as the reference refuses it: the port reads
    no network.  Place the file locally and pass its path instead."""
    raise RuntimeError(
        "download() requires network access, which the port does not "
        "use; place files locally and pass their path instead")
