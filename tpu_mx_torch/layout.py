"""Global conv data-layout switch, a copy of ``tpu_mx/layout.py``.

Every conv/pool constructor takes the reference's ``layout=`` argument;
passing None picks up the thread-local *default*, so a whole model (the
NCHW-written model zoo, for one) is built channels-last without editing
each constructor:

    with tpu_mx_torch.layout.default_layout("NHWC"):
        net = vision.resnet50_v1()
    # net now takes (N, H, W, C) input and runs channels-last end to end.

On the card channels-last is PyTorch's ``torch.channels_last`` memory
format: a layer given an ``(N, H, W, C)`` tensor permutes it to an
``(N, C, H, W)``-shaped view whose strides are channels-last (no copy),
and cuDNN runs its NHWC convolutions on it.  The rules below are the
reference's, kept identical (same names, same validation).
"""
from __future__ import annotations

import threading
from contextlib import contextmanager

_state = threading.local()

_CHANNELS_FIRST = {1: "NCW", 2: "NCHW", 3: "NCDHW"}
_CHANNELS_LAST = {1: "NWC", 2: "NHWC", 3: "NDHWC"}


def get_default_layout(ndim: int = 2) -> str:
    """Current default data layout for an ``ndim``-spatial-dim conv."""
    mode = getattr(_state, "mode", "channels_first")
    return (_CHANNELS_LAST if mode == "channels_last" else _CHANNELS_FIRST)[ndim]


_KNOWN = (set(_CHANNELS_FIRST.values()) | set(_CHANNELS_LAST.values())
          | {"channels_first", "channels_last"})


def is_channels_last(layout: str | None) -> bool:
    return layout is not None and layout.endswith("C")


def channel_axis() -> int:
    """Channel axis under the current layout mode (for concat, BatchNorm,
    any channel-wise op): 1 channels-first, -1 channels-last."""
    return -1 if getattr(_state, "mode", "channels_first") == "channels_last" \
        else 1


def bn_axis() -> int:
    """Default BatchNorm channel axis — alias of `channel_axis()`."""
    return channel_axis()


@contextmanager
def default_layout(layout: str):
    """Set the default conv/pool/BatchNorm layout for blocks built inside.

    ``layout`` is any MXNet layout string ("NHWC", "NCHW", "NWC", ...) or a
    Keras-style "channels_first"/"channels_last"; only the orientation is
    recorded.
    """
    if layout not in _KNOWN:
        raise ValueError(
            f"unknown layout {layout!r}; expected one of {sorted(_KNOWN)}")
    prev = getattr(_state, "mode", "channels_first")
    _state.mode = "channels_last" \
        if layout == "channels_last" or layout.endswith("C") \
        else "channels_first"
    try:
        yield
    finally:
        _state.mode = prev
