"""The exact, JSON-safe state encoding of ``tpu_mx/resume.py``.

Copied rather than imported (importing ``tpu_mx`` would import jax):
:func:`encode_state` and :func:`decode_state`, which the serving
samplers use to capture a generator's state as data.  The rest of the
reference's resume plane (training capsules, the world map) is not
ported yet (ROADMAP A15).
"""
from __future__ import annotations

import base64

import numpy as np

from .base import MXNetError

__all__ = ["encode_state", "decode_state"]


def encode_state(obj):
    """Deep-encode a state tree into JSON-safe values.  ndarrays become
    ``{"__ndarray__": {dtype, shape, data}}`` with a base64 payload of
    the raw bytes — the exact representation, not a repr."""
    if isinstance(obj, np.ndarray):
        return {"__ndarray__": {
            "dtype": str(obj.dtype), "shape": list(obj.shape),
            "data": base64.b64encode(
                np.ascontiguousarray(obj).tobytes()).decode("ascii")}}
    if isinstance(obj, np.generic):
        return obj.item()
    if isinstance(obj, (list, tuple)):
        return [encode_state(x) for x in obj]
    if isinstance(obj, dict):
        return {str(k): encode_state(v) for k, v in obj.items()}
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if hasattr(obj, "__array__"):
        return encode_state(np.asarray(obj))
    raise MXNetError(
        f"capsule cannot encode a {type(obj).__name__} — state_dict trees "
        "must contain only arrays, scalars, strings, lists and dicts")


def decode_state(obj):
    """Inverse of :func:`encode_state` (tuples come back as lists)."""
    if isinstance(obj, dict):
        nd = obj.get("__ndarray__")
        if nd is not None and set(obj) == {"__ndarray__"}:
            arr = np.frombuffer(base64.b64decode(nd["data"]),
                                dtype=np.dtype(nd["dtype"]))
            return arr.reshape(nd["shape"]).copy()
        return {k: decode_state(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [decode_state(v) for v in obj]
    return obj
