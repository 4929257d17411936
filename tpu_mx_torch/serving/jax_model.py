"""The fused decode knob, from ``tpu_mx/serving/jax_model.py``.

``TPUMX_FUSED_DECODE`` chooses between the engine's two decode arms: the
host layer loop (``serving/engine.py``'s ``_host_step``: the model's
pieces interleaved with the cache's per-layer writes and decode
attention) and the fused step, the whole decode step on the device with
one copy in and one copy back (:meth:`TinyLM.decode_step
<tpu_mx_torch.serving.model.TinyLM.decode_step>`, the port's counterpart
of the reference's jitted ``JaxTinyLM`` program).  Unset, the port runs
the fused step (the reference's default is the host loop, chosen where
jax might be missing); an explicit value selects the reference's arm.
"""
from __future__ import annotations

import os

__all__ = ["fused_requested", "resolve_fused"]

_FUSED_ENV = "TPUMX_FUSED_DECODE"


def fused_requested():
    """Whether ``TPUMX_FUSED_DECODE`` asks for the fused step: ``0``/
    ``off``/``host`` no, ``1``/``on``/``auto``/``fused`` (and unset, the
    port's default) yes.  Unknown values raise, as for
    ``TPUMX_PAGED_DECODE``."""
    v = os.environ.get(_FUSED_ENV)
    if v is None:
        return True
    v = v.strip().lower()
    if v in ("", "0", "off", "no", "host"):
        return False
    if v in ("1", "on", "auto", "yes", "fused"):
        return True
    raise ValueError(
        f"{_FUSED_ENV}={v!r} is not a recognized decode arm — use 0 "
        "(host-resident forward) or 1 (whole-step fused device program)")


def resolve_fused(decode_kind, model):
    """Whether an engine runs the fused step: asked for, and the decode
    arm is paged (the fused step runs the paged arm; a dense engine takes
    the host loop, as in the reference).  Every port ``TinyLM`` runs
    the fused step, so the reference's weight check has nothing to
    refuse."""
    if not fused_requested():
        return False
    return decode_kind != "dense"
