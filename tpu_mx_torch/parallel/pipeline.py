"""GPipe pipeline parallelism over a ``pp`` mesh axis, from
``tpu_mx/parallel/pipeline.py``.

Every ``pp`` rank runs the same program, as the reference's ``shard_map``
does: stage ``s`` holds slice ``s`` of parameters stacked on a leading
stage axis (:func:`stack_stage_params`), and over ``M + S - 1`` ticks
stage ``s`` computes microbatch ``t - s`` at tick ``t`` (stage 0 reads
the input queue, the others what the stage before sent them by
:func:`~.collectives.ppermute` at the previous tick; the first and last
``S - 1`` ticks are the bubble).  The last stage's outputs are summed
over ``pp`` (:func:`~.collectives.psum`, the other stages contributing
zeros), so every ``pp`` rank returns them.  The backward is autograd
through the same schedule: each ``ppermute`` sends its cotangent back a
stage.

``data_spec`` splits each microbatch's batch (``P("dp")``): a rank
computes its ``dp`` slice.  Outside an SPMD region (:func:`~.collectives.
spmd`) ``x`` and the result are global (the same on every rank: the
slice is taken, and the result gathered, over the spec's axes); inside
one they are the rank's slices.
"""
from __future__ import annotations

import torch

from . import collectives as _coll
from .mesh import spec_axes

__all__ = ["pipeline_apply", "stack_stage_params"]


def _tree_map(fn, *trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def stack_stage_params(per_stage_params):
    """``[params per stage]`` (dicts, lists or tuples of tensors, one
    structure) → one such structure whose leaves carry a leading stage
    axis."""
    return _tree_map(lambda *leaves: torch.stack(leaves), *per_stage_params)


def pipeline_apply(stage_fn, stacked_params, x, mesh, axis_name="pp",
                   num_microbatches=None, data_spec=None):
    """Run ``x`` through ``S = mesh.shape[axis_name]`` stages of
    ``stage_fn(params, x_mb) -> y_mb`` (activations keep their shape and
    dtype across stages), in ``num_microbatches`` (default ``S``)
    microbatches of ``x``'s batch (leading) axis.  ``stacked_params``:
    leaves with a leading stage axis of size ``S``.  ``data_spec``: the
    spec of one microbatch from its batch axis on (e.g. ``P("dp")``;
    default replicated).  Returns ``(B, ...)``."""
    s_count = mesh.shape[axis_name]
    m_count = num_microbatches or s_count
    b = x.shape[0]
    if b % m_count:
        raise ValueError(f"batch {b} not divisible into {m_count} "
                         "microbatches")
    xs = x.reshape((m_count, b // m_count) + tuple(x.shape[1:]))
    dspec = tuple(data_spec) if data_spec is not None else ()
    glob = _coll.current_spmd() is None
    if glob:
        for d, entry in enumerate(dspec):
            if mesh.axes_of(spec_axes(entry)):
                xs = _coll.scatter(xs, mesh, spec_axes(entry), d + 1)
    me = mesh.axis_index(axis_name)
    # a stage's slice: the stacked leaves' gradient comes back whole on
    # every rank (scatter) and, outside a region (inside one the train
    # step reduces it), summed over the batch's axes (copy_to)
    data_axes = tuple(a for entry in dspec for a in spec_axes(entry)) \
        if glob else ()
    params = _tree_map(
        lambda a: _coll.scatter(_coll.copy_to(a, mesh, data_axes), mesh,
                                axis_name, 0)[0], stacked_params)
    out = _pipeline_body(stage_fn, params, xs, mesh, axis_name, s_count,
                         m_count, me)
    if glob:
        for d in reversed(range(len(dspec))):
            if mesh.axes_of(spec_axes(dspec[d])):
                out = _coll.all_gather(out, mesh, spec_axes(dspec[d]), d + 1)
    return out.reshape((-1,) + tuple(out.shape[2:]))


def _pipeline_body(stage_fn, params, xs, mesh, axis_name, s_count, m_count,
                   me):
    """The GPipe schedule on one rank: ``xs`` ``(M, mb, ...)``, every
    microbatch present; returns the last stage's ``(M, mb, ...)``
    outputs on every rank of ``axis_name``.

    Each rank's autograd graph holds every tick (a stage's unused
    input and outputs enter it times zero, as the reference's ``where``
    does), so every rank runs every ``ppermute``'s backward, in the same
    order: the ranks' sends and receives pair up."""
    perm = [(i, (i + 1) % s_count) for i in range(s_count)]
    first = torch.tensor(me == 0, device=xs.device)
    last = 1.0 if me == s_count - 1 else 0.0
    state = torch.zeros_like(xs[0])
    outs = [None] * m_count
    for t in range(m_count + s_count - 1):
        inp = torch.where(first, xs[min(t, m_count - 1)], state)
        y = stage_fn(params, inp)
        m_out = t - (s_count - 1)
        if m_out >= 0:
            outs[m_out] = y * last
        if t < m_count + s_count - 2:
            state = _coll.ppermute(y, mesh, axis_name, perm)
    return _coll.psum(torch.stack(outs), mesh, axis_name)
