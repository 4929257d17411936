"""Where the port's tensors live: ``device=`` resolution.

Every entry point of the port (``TinyLM``, ``Server``, the kernel
wrappers) takes ``device=`` and defaults to ``"cuda"``; the models and
``CompiledTrainStep`` default to ``device=None``, the current context
(``gpu(0)`` outside ``with mx.cpu():``), as the reference's nets do; a
:class:`~tpu_mx_torch.context.Context` (``mx.gpu(0)``, ``mx.cpu()``) is
taken wherever a device is.  The port is
written for the card; with no card it raises :class:`MXNetError` rather
than carry on slowly on the host.  The CPU is only ever used when a
caller asks for it (``device="cpu"``), as the tests do — there each
kernel wrapper runs its plain PyTorch version.

Resolving a CUDA device also turns TF32 off for matrix products and
convolutions: the port serves in float32 exactly as the reference does,
and TF32 keeps only about three decimal digits of each operand.
"""
from __future__ import annotations

import torch

from .base import MXNetError
from .context import Context, current_context

__all__ = ["DEFAULT_DEVICE", "resolve", "of", "as_tensor"]

DEFAULT_DEVICE = "cuda"


def resolve(device=DEFAULT_DEVICE):
    """``device`` (a string, :class:`torch.device` or
    :class:`~tpu_mx_torch.context.Context`; None is the current context,
    ``gpu(0)`` outside a ``with``) as a :class:`torch.device`, checked:
    ``cuda`` needs a card, and only ``cuda`` and ``cpu`` are taken."""
    if device is None:
        device = current_context()
    dev = device.torch_device() if isinstance(device, Context) \
        else torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise MXNetError(
                f"device={str(device)!r}: no CUDA device is available — "
                "the port runs on the card; pass device='cpu' to run the "
                "plain PyTorch versions on the host")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise MXNetError(f"device={str(device)!r}: the port runs on 'cuda' "
                         "or 'cpu' only")
    return dev


def of(x, device=None):
    """Where a kernel wrapper runs for operand ``x``: ``device`` resolved,
    or with ``device=None`` the tensor ``x``'s own device (a CUDA tensor
    proves the card is there, so the per-call checks of :func:`resolve`
    are skipped) and the default for host data."""
    if device is None and isinstance(x, torch.Tensor) \
            and x.device.type in ("cuda", "cpu"):
        return x.device
    return resolve(DEFAULT_DEVICE if device is None else device)


def as_tensor(x, device, dtype=None):
    """``x`` as a tensor on ``device`` (a resolved :class:`torch.device`).
    Host data (numpy, lists) is copied over; a tensor already on another
    device raises instead of being moved silently — a hidden copy of a
    KV pool would cost more than the kernel it feeds."""
    if isinstance(x, torch.Tensor):
        if x.device.type != device.type:
            raise MXNetError(f"tensor on {x.device} passed where "
                             f"{device} was asked for")
        return x if dtype is None else x.to(dtype)
    return torch.as_tensor(x, dtype=dtype, device=device)
