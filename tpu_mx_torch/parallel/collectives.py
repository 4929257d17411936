"""Collectives over a mesh's axes, differentiable: the ``lax`` collectives
the reference's ``shard_map`` bodies use, over ``torch.distributed``.

Each function takes a :class:`~.mesh.Mesh` and an axis name or a tuple
of names (axes of size 1 drop out, so a collective over them is the
identity) and runs over the process group of the ranks that differ only
along those axes (``Mesh.group``), members ordered by their index along
the axes, row-major in the given order (``axis_index``).  Every one is
an ``autograd.Function``:

- :func:`psum` / :func:`pmean`: the sum (mean) over the axes; backward
  passes the cotangent through (the sum is the same on every rank, so
  its cotangent is, and each rank's summand gets it whole);
- :func:`all_gather` (tiled along ``dim``); backward takes the rank's
  own slice of the cotangent;
- :func:`scatter`: the rank's own slice of a value that every rank
  holds whole; backward all-gathers the slices' cotangents, so the
  whole value's gradient is the same on every rank;
- :func:`copy_to`: the identity; backward sums the cotangents over the
  axes (a value every rank holds, read by rank-dependent work: Megatron's
  ``f``, :func:`psum` being its ``g``);
- :func:`all_to_all` (tiled: ``split_dim`` cut into as many blocks as
  ranks, block ``j`` to rank ``j``, received blocks concatenated along
  ``concat_dim``); backward is the all-to-all the other way;
- :func:`ppermute` with ``perm = [(src, dst), ...]`` in axis indices
  (a rank no pair sends to receives zeros); backward permutes the other
  way;
- :func:`take`: a rank's own rows of a parameter every rank holds whole
  (a Megatron column or row block, a group of experts); backward sums
  the rows' cotangents over the axes into the whole gradient;
- :func:`batch_sum`: the sum over the axes of each rank's partial of a
  statistic of the global batch that every rank then reads for its own
  rows (BatchNorm's sums, the MoE router's means); backward sums the
  cotangents over the axes too, so each rank's partial gets the
  gradient of every rank's use of the statistic.

:func:`axis_index` is the rank's index along the axes, an int.

**The backend** of a mesh's groups is a pure function of the device
type and the ranks a card holds (``base.backend_for``, which
``mesh.group_backend`` applies to the ranks' devices): ``nccl`` where
each rank owns a card, ``gloo`` otherwise (CPU processes, or ranks that
share one card, which NCCL refuses).  ``gloo`` moves host memory: a collective on CUDA tensors
over a ``gloo`` group is staged through the host at one place,
:func:`_host_staged`, which copies the operands to the host, runs the
collective there, and copies the results back to the operands' device.
The arithmetic around it stays on the device; the copy is counted in the
``mesh.host_staged_bytes`` counter and its wall time in the
``mesh.host_staged_seconds`` histogram.

**The SPMD region.**  Inside :func:`spmd` (the train step's forward and
backward on a mesh) every tensor a model sees is its rank's local block;
outside it, the functions of :mod:`.ring_attention`, :mod:`.ulysses` and
:mod:`.pipeline` take the reference's global arrays (the same value on
every rank) and return global arrays: they :func:`scatter` their
operands, run the per-rank body, and :func:`all_gather` the result.
The train step also names the region's ``batch_axes``, the axes its
batch is split over (:func:`batch_split`), and where the split is of
its rows and its sequence alone, those two dimensions' axes
(:func:`token_split`): a layer whose function reads statistics of the
whole batch reduces them over those axes (or, for statistics that
depend on the tokens' order, gathers them in the global order), so
that it computes what it computes on the global batch at world size 1.
The compressed per-shard reduction names none: each rank's statistics
stay its own, as the reference's per-shard program keeps them.
"""
from __future__ import annotations

import contextlib
import time

import torch

from .. import telemetry as _telemetry

__all__ = ["psum", "pmean", "all_gather", "scatter",
           "copy_to", "all_to_all", "ppermute", "take", "axis_index",
           "spmd", "current_spmd", "host_staged_stats", "split_over",
           "batch_sum", "batch_split", "token_split"]

# the (mesh, batch axes, token axes) of the enclosing spmd regions,
# innermost last
_SPMD = []


@contextlib.contextmanager
def spmd(mesh, batch_axes=(), token_axes=None):
    """Tensors inside are each rank's local block over ``mesh``;
    ``batch_axes``: the axes the batch is split over whose ranks'
    batch statistics are one global batch's (module docstring);
    ``token_axes``: ``(row axes, sequence axes)`` where the batch is
    split along its first two dimensions alone, else None."""
    _SPMD.append((mesh, tuple(batch_axes), token_axes))
    try:
        yield mesh
    finally:
        _SPMD.pop()


def current_spmd():
    """The mesh of the innermost :func:`spmd` region, or None."""
    return _SPMD[-1][0] if _SPMD else None


def batch_split():
    """``(mesh, axes, size, index)``: the innermost region's batch axes
    longer than 1, their number of ranks and this rank's index along
    them; ``(None, (), 1, 0)`` outside a region or where the batch is
    not split."""
    if not _SPMD:
        return None, (), 1, 0
    mesh, axes, _ = _SPMD[-1]
    axes = mesh.axes_of(axes) if axes else ()
    if not axes:
        return None, (), 1, 0
    return mesh, axes, mesh.axis_size(axes), mesh.axis_index(axes)


def token_split():
    """Where the innermost region's batch is split along its rows and
    its sequence alone: ``(mesh, axes, (row_blocks, row_index,
    seq_blocks, seq_index))``, ``axes`` the row axes then the sequence
    axes (longer than 1), so that a gather over them lists the ranks'
    blocks row block by row block, each by its sequence blocks; else
    None (no split, or one of another dimension)."""
    if not _SPMD or _SPMD[-1][2] is None:
        return None
    mesh = _SPMD[-1][0]
    rows, seq = (mesh.axes_of(a) if a else () for a in _SPMD[-1][2])
    if not rows + seq:
        return None
    return mesh, rows + seq, (mesh.axis_size(rows) if rows else 1,
                              mesh.axis_index(rows) if rows else 0,
                              mesh.axis_size(seq) if seq else 1,
                              mesh.axis_index(seq) if seq else 0)


def host_staged_stats():
    """``{"bytes", "seconds", "calls"}`` staged through the host so far
    in this process (the telemetry metrics' running totals)."""
    nbytes = _telemetry.get("mesh.host_staged_bytes")
    secs = _telemetry.get("mesh.host_staged_seconds")
    return {"bytes": nbytes.value if nbytes else 0,
            "seconds": secs.sum if secs else 0.0,
            "calls": secs.count if secs else 0}


def _dist():
    import torch.distributed as dist
    return dist


def _host_staged(group, tensors, run):
    """Run ``run(tensors)`` (a collective that fills or returns tensors)
    with CUDA operands staged through host memory when ``group`` is a
    ``gloo`` group; returns ``run``'s results on the operands' device."""
    dist = _dist()
    dev = tensors[0].device
    if dev.type != "cuda" or dist.get_backend(group) != "gloo":
        return run(tensors)
    t0 = time.perf_counter()
    host = [t.detach().to("cpu") for t in tensors]
    out = [t.to(dev, non_blocking=False) for t in run(host)]
    dt = time.perf_counter() - t0
    nbytes = sum(t.numel() * t.element_size() for t in host) \
        + sum(t.numel() * t.element_size() for t in out)
    _telemetry.counter("mesh.host_staged_bytes").inc(nbytes)
    _telemetry.histogram("mesh.host_staged_seconds").observe(dt)
    return out


# -- the raw collectives (no autograd) ----------------------------------------
def _reduce(x, mesh, axes):
    group, members = mesh.group(axes)
    if len(members) == 1:
        return x.clone()

    def run(ts):
        t = ts[0].contiguous().clone()
        _dist().all_reduce(t, group=group)
        return [t]
    return _host_staged(group, [x], run)[0]


def _gather(x, mesh, axes, dim):
    group, members = mesh.group(axes)
    if len(members) == 1:
        return x.clone()
    dist = _dist()
    order = sorted(members)          # a group's ranks are in rank order

    def run(ts):
        t = ts[0].contiguous()
        outs = [torch.empty_like(t) for _ in members]
        dist.all_gather(outs, t, group=group)
        return outs
    pieces = _host_staged(group, [x], run)
    by_rank = dict(zip(order, pieces))
    return torch.cat([by_rank[r] for r in members], dim=dim)


def _take(x, mesh, axes, dim):
    n = mesh.axis_size(axes)
    if n == 1:
        return x
    if x.shape[dim] % n:
        raise ValueError(f"dimension {dim} of size {x.shape[dim]} does not "
                         f"split over {n} ranks of {axes}")
    return x.chunk(n, dim)[mesh.axis_index(axes)]


def _all_to_all(x, mesh, axes, split_dim, concat_dim):
    group, members = mesh.group(axes)
    n = len(members)
    if n == 1:
        return x.clone()
    if x.shape[split_dim] % n:
        raise ValueError(f"all_to_all: dimension {split_dim} of size "
                         f"{x.shape[split_dim]} does not split over {n} "
                         "ranks")
    dist = _dist()
    order = sorted(members)
    blocks = x.chunk(n, split_dim)           # block j goes to members[j]
    by_rank = {r: b for r, b in zip(members, blocks)}
    send = torch.stack([by_rank[r].contiguous() for r in order])

    def run(ts):
        out = torch.empty_like(ts[0])
        dist.all_to_all_single(out, ts[0].contiguous(), group=group)
        return [out]
    recv = _host_staged(group, [send], run)[0]
    got = dict(zip(order, recv.unbind(0)))
    return torch.cat([got[r] for r in members], dim=concat_dim)


def _ppermute(x, mesh, axes, perm):
    group, members = mesh.group(axes)
    if len(members) == 1:
        src = dict((d, s) for s, d in perm)
        return x.clone() if src.get(0) == 0 else torch.zeros_like(x)
    dist = _dist()
    me = mesh.axis_index(axes)
    dst = [d for s, d in perm if s == me]
    src = [s for s, d in perm if d == me]

    def run(ts):
        t = ts[0].contiguous()
        out = torch.zeros_like(t)
        reqs = [dist.isend(t, members[d], group=group) for d in dst]
        reqs += [dist.irecv(out, members[s], group=group) for s in src]
        for req in reqs:
            req.wait()
        return [out]
    return _host_staged(group, [x], run)[0]


# -- the differentiable collectives -------------------------------------------
class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        return _reduce(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _reduce(g, ctx.mesh, ctx.axes), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return _gather(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return _take(g, ctx.mesh, ctx.axes, ctx.dim).contiguous(), None, \
            None, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return _take(x, mesh, axes, dim).clone()

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.mesh, ctx.axes, ctx.dim), None, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, split_dim, concat_dim):
        ctx.args = (mesh, axes, split_dim, concat_dim)
        return _all_to_all(x, mesh, axes, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axes, split_dim, concat_dim = ctx.args
        return _all_to_all(g, mesh, axes, concat_dim, split_dim), None, \
            None, None, None


class _Ppermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, perm):
        ctx.args = (mesh, axes, perm)
        return _ppermute(x, mesh, axes, perm)

    @staticmethod
    def backward(ctx, g):
        mesh, axes, perm = ctx.args
        return _ppermute(g, mesh, axes, [(d, s) for s, d in perm]), None, \
            None, None


class _Take(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, mesh, axes, dim, index):
        ctx.args = (mesh, axes, dim, index, w.shape)
        return w.index_select(dim, index)

    @staticmethod
    def backward(ctx, g):
        mesh, axes, dim, index, shape = ctx.args
        full = g.new_zeros(shape).index_add_(dim, index, g)
        return _reduce(full, mesh, axes), None, None, None, None


def take(w, mesh, axes, dim, index):
    """The rows ``index`` of ``w`` along ``dim``, where ``w`` is a
    parameter every rank holds whole and each rank of ``axes`` reads its
    own, disjoint rows; backward sums the rows' cotangents over the
    axes, so every rank gets the whole, equal gradient of ``w``."""
    return _Take.apply(w, mesh, mesh.axes_of(axes), dim,
                       torch.as_tensor(index, device=w.device))


def psum(x, mesh, axes):
    return _Psum.apply(x, mesh, mesh.axes_of(axes))


def pmean(x, mesh, axes):
    return psum(x, mesh, axes) / mesh.axis_size(axes)


def batch_sum(x, mesh, axes):
    """The sum over ``axes`` of each rank's partial ``x`` of a global-batch
    statistic: all-reduced forward and, through :func:`copy_to`, its
    cotangent all-reduced backward (each rank's loss reads the sum)."""
    return psum(copy_to(x, mesh, axes), mesh, axes)


def copy_to(x, mesh, axes):
    return _CopyTo.apply(x, mesh, mesh.axes_of(axes))


def all_gather(x, mesh, axes, dim=0):
    return _AllGather.apply(x, mesh, mesh.axes_of(axes), dim % x.dim())


def scatter(x, mesh, axes, dim=0):
    return _Scatter.apply(x, mesh, mesh.axes_of(axes), dim % x.dim())


def all_to_all(x, mesh, axes, split_dim, concat_dim):
    return _AllToAll.apply(x, mesh, mesh.axes_of(axes), split_dim % x.dim(),
                           concat_dim % x.dim())


def ppermute(x, mesh, axes, perm):
    return _Ppermute.apply(x, mesh, mesh.axes_of(axes),
                           tuple((int(s), int(d)) for s, d in perm))


def axis_index(mesh, axes):
    return mesh.axis_index(axes)


def scatter_spec(x, mesh, spec):
    """The rank's local block of ``x`` (a global value every rank holds)
    under ``spec``: :func:`scatter` along each dimension the spec
    splits."""
    from .mesh import spec_axes
    for d, entry in enumerate(spec):
        if mesh.axes_of(spec_axes(entry)):
            x = scatter(x, mesh, spec_axes(entry), d)
    return x


def gather_spec(x, mesh, spec):
    """The global value of local blocks laid out by ``spec``: the inverse
    of :func:`scatter_spec`."""
    from .mesh import spec_axes
    for d in reversed(range(len(spec))):
        if mesh.axes_of(spec_axes(spec[d])):
            x = all_gather(x, mesh, spec_axes(spec[d]), d)
    return x


def split_over(axis):
    """``(mesh, size, index)`` of the SPMD region's ``axis`` when the
    region's mesh has it longer than 1, else ``(None, 1, 0)``: how a
    model's layer splits its work."""
    mesh = current_spmd()
    if mesh is None or mesh.shape.get(axis, 1) == 1:
        return None, 1, 0
    return mesh, mesh.shape[axis], mesh.axis_index(axis)
