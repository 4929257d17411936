"""Ulysses sequence parallelism, from ``tpu_mx/parallel/ulysses.py``:
all-to-all head-sharded attention.

Activations arrive sequence-split (each of the ``sp`` ranks holds
``T/sp`` positions of every head).  One tiled all-to-all per q/k/v
(:func:`~.collectives.all_to_all`, heads split, sequence concatenated)
re-splits them by head: each rank holds ``H/sp`` heads over the whole
sequence, runs :func:`~.ring_attention.local_flash_attention` on them —
on the card the hand-written flash forward, dq and dk/dv kernels,
through their ``autograd.Function`` — and one all-to-all brings the
output back to sequence-split.  Four activation-sized all-to-alls a
layer against the ring's ``sp`` k/v hops; it needs ``H % sp == 0``.

Dropout: the seed is folded with the rank's index along the q spec's
batch axis and along ``sp`` (the kernels' keep bit hashes the rank-local
row ``bh``), so head groups and batch shards draw their own masks.

Outside an SPMD region (:func:`~.collectives.spmd`) q/k/v are the
reference's global ``(B, H, T, D)`` arrays, the same on every rank, and
so is the result; inside one they are the rank's ``(B/dp, H, T/sp, D)``
blocks.  The bias is ``(B|1, H|1, T, T)`` whole (after the all-to-all a
rank attends over the whole sequence); a rank takes its head group's
slice when it carries heads.
"""
from __future__ import annotations

from . import collectives as _coll
from .mesh import P
from .ring_attention import (_count, _dropout_seed, _fold_axes, _sp_call,
                             _sp_spec, local_flash_attention)

__all__ = ["ulysses_attention", "set_sp_strategy", "get_sp_strategy"]

_SP_STRATEGY = "ring"  # module default: no head-divisibility constraint


def set_sp_strategy(strategy):
    """Select the sequence-parallel strategy (``"ring"`` or
    ``"ulysses"``) ``parallel.attention`` takes on a mesh with an ``sp``
    axis.  Returns the previous value."""
    global _SP_STRATEGY
    if strategy not in ("ring", "ulysses"):
        raise ValueError("sp strategy must be 'ring' or 'ulysses'")
    prev, _SP_STRATEGY = _SP_STRATEGY, strategy
    return prev


def get_sp_strategy():
    return _SP_STRATEGY


def _ulysses_body(q, k, v, valid, seed, bias, *, mesh, axis_name, causal,
                  rate, key_axes):
    """One rank: ``(B, H, Tb, D)`` blocks → ``(B, H/n, T, D)`` head
    groups → local attention → back."""
    n = mesh.axis_size(axis_name)
    my = mesh.axis_index(axis_name)
    qh, kh, vh = (_coll.all_to_all(x, mesh, axis_name, 1, 2)
                  for x in (q, k, v))
    if seed is not None:
        seed = _fold_axes(seed, mesh, key_axes + (axis_name,))
    if bias is not None and bias.shape[1] > 1:
        hn = bias.shape[1] // n
        bias = bias[:, my * hn:(my + 1) * hn]
    out = local_flash_attention(qh, kh, vh, causal=causal,
                                valid_length=valid,
                                dropout_rate=rate if seed is not None
                                else 0.0,
                                dropout_seed=seed, bias=bias)
    return _coll.all_to_all(out, mesh, axis_name, 2, 1)


def ulysses_attention(q, k, v, mesh, axis_name="sp", causal=False,
                      q_spec=None, valid_length=None, dropout_rate=0.0,
                      dropout_key=None, bias=None, batch_axes=("dp", "tp"),
                      dropout_seed=None):
    """All-to-all sequence-parallel attention, with
    :func:`~.ring_attention.ring_attention`'s contract; needs
    ``H % mesh.shape[axis_name] == 0`` (raises otherwise) and no split
    of the head axis."""
    dropout_seed = _dropout_seed(dropout_key, dropout_seed)
    present = lambda ax: ax in mesh.axis_names and mesh.shape[ax] > 1
    if not present(axis_name):
        return local_flash_attention(q, k, v, causal=causal,
                                     valid_length=valid_length,
                                     dropout_rate=dropout_rate,
                                     dropout_seed=dropout_seed, bias=bias)
    n = mesh.shape[axis_name]
    h = q.shape[1]
    if h % n:
        raise ValueError(f"ulysses_attention: heads ({h}) must divide by sp "
                         f"({n}); use ring attention for this model")
    spec = _sp_spec(mesh, axis_name, q_spec, batch_axes, present)
    if spec[1] is not None:
        raise ValueError(
            "ulysses_attention: the head axis cannot also be mesh-sharded "
            f"(spec {spec}); all-to-all re-shards heads over {axis_name}")
    rate = float(dropout_rate) if dropout_seed is not None else 0.0
    _count("ulysses", f"sp={n} shape={tuple(q.shape)} dtype={q.dtype}")
    bspec = None
    if bias is not None:
        bspec = P(spec[0] if bias.shape[0] > 1 else None, None, None, None)
    key_axes = tuple(ax for ax in (spec[0],) if ax is not None)

    def body(q, k, v, valid, seed, b):
        return _ulysses_body(q, k, v, valid, seed if rate > 0.0 else None, b,
                             mesh=mesh, axis_name=axis_name, causal=causal,
                             rate=rate, key_axes=key_axes)
    return _sp_call(body, q, k, v, mesh, spec, valid_length, dropout_seed,
                    bias, bspec)
