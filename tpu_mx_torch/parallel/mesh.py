"""Device meshes, from ``tpu_mx/parallel/mesh.py``, over
``torch.distributed``.

The reference builds a ``jax.sharding.Mesh`` over every device and names
its axes (``dp``, ``fsdp``, ``tp``, ``sp``, ``pp``, ``ep``); sharding
rules and data specs are ``PartitionSpec``s over those names.  The port
runs one process a device: a mesh is a grid of **ranks** of the
``torch.distributed`` group (``base.dist_boot`` joins it from the
launcher's environment, or a test spawns its own), and each rank works
on the device of its current context.

- ``make_mesh({axis: size}, devices=None)``: ``devices`` are the ranks
  to use (default every rank of the group, in rank order); sizes of -1
  are inferred (at most one), and the sizes must multiply to the number
  of ranks.  Without a process group the mesh is this process alone:
  every axis of size 1 (``devices`` may then name the one device), and a
  mesh whose axes multiply above 1 raises ``MXNetError`` naming the
  missing group.
- :class:`Mesh` keeps the ranks' grid (``ranks``, ``shape``,
  ``axis_names``), this rank's coordinates (``coords``) and, for every
  set of its axes longer than 1, the process group of the ranks that
  differ only along them (:meth:`Mesh.group`): the collectives of
  :mod:`.collectives` run over those, over :func:`group_backend` of
  where the mesh's ranks compute (``backend``: ``gloo`` unless every
  rank computes on a card of its own).  ``device_mesh`` is the same grid
  as a ``torch.distributed.device_mesh.DeviceMesh`` whose
  ``mesh_dim_names`` are the axis names (made at first use, by every
  rank), for ``DTensor``: :meth:`NamedSharding.placements` maps a spec
  to ``Shard(dim)`` on the mesh dims it names and ``Replicate()``
  elsewhere, and :func:`distribute` places a tensor so.
- ``hybrid_mesh(ici, dcn)``: the reference's ICI×DCN product, each
  axis of size ``ici[a]·dcn.get(a, 1)``.

:class:`P` is the port's ``PartitionSpec``: a tuple of axis names (or
None, or a tuple of names), equal to another spec, or to a plain tuple,
with the same axes, as jax's is.
"""
from __future__ import annotations

import collections
import itertools
import socket

import numpy as np

from .. import device as _device
from ..base import MXNetError, backend_for
from ..context import current_context

__all__ = ["make_mesh", "Mesh", "NamedSharding", "P", "local_mesh",
           "hybrid_mesh", "distribute", "group_backend"]


class P(tuple):
    """``PartitionSpec(*axes)``: per array dimension, the mesh axis (or
    axes, or None) it is split over."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self):
        return "PartitionSpec(" + ", ".join(map(repr, self)) + ")"

    def __reduce__(self):
        return (P, tuple(self))


def spec_axes(entry):
    """The axis names of one spec entry (None, a name, or a tuple)."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def _dist():
    import torch.distributed as dist
    return dist if dist.is_available() and dist.is_initialized() else None


def group_backend(placements):
    """The backend of a mesh's groups (``base.backend_for``) from where
    its ranks compute: ``placements`` holds each rank's ``(host,
    device)`` (``"cpu"``, ``"cuda:0"``, ...).  NCCL only for CUDA ranks
    no two of which share a card of one host; ``gloo`` otherwise."""
    kinds = {dev.partition(":")[0] for _, dev in placements}
    if kinds != {"cuda"}:
        return backend_for("cpu", len(placements))
    per_card = collections.Counter(placements)
    return backend_for("cuda", max(per_card.values()))


def _placement(device):
    """``(host, device)`` of this rank, the card's index made explicit."""
    if device.type == "cuda" and device.index is None:
        import torch
        device = torch.device("cuda", torch.cuda.current_device())
    return socket.gethostname(), str(device)


class Mesh:
    """A named grid of ranks: ``axis_names``, ``shape`` (``{name: size}``),
    ``ranks`` (an int array of that shape, made from ``devices``, the
    reference's name for the grid, which reads it back too), ``size``,
    this rank's ``coords`` (``{name: index}``, None when the rank is
    outside the mesh) and ``device`` (the device this rank computes
    on)."""

    def __init__(self, devices, axis_names, device=None, axis_types=None):
        self.ranks = np.asarray(devices, dtype=np.int64)
        self.axis_names = tuple(axis_names)
        self.axis_types = axis_types
        if self.ranks.ndim != len(self.axis_names):
            raise ValueError(f"mesh of {self.ranks.ndim} dimensions named "
                             f"{self.axis_names}")
        self.shape = dict(zip(self.axis_names, self.ranks.shape))
        self.device = _device.resolve(current_context()) if device is None \
            else _device.resolve(device)
        dist = _dist()
        self.rank = dist.get_rank() if dist is not None else 0
        where = np.argwhere(self.ranks == self.rank)
        self.coords = (dict(zip(self.axis_names, map(int, where[0])))
                       if len(where) else None)
        self._groups = {}
        self._device_mesh = None
        self.backend = "gloo"
        if dist is not None and self.size > 1:
            self._make_groups(dist)

    @property
    def devices(self):
        return self.ranks

    @property
    def size(self):
        return int(self.ranks.size)

    def _make_groups(self, dist):
        """One process group per set of axes longer than 1 and per
        coordinate of the other axes.  ``new_group`` is collective over
        the whole job, so every rank makes every group, in one order, and
        first gathers every rank's placement to choose their backend."""
        placements = [None] * dist.get_world_size()
        dist.all_gather_object(placements, _placement(self.device))
        self.backend = group_backend(
            [tuple(placements[r]) for r in self.ranks.flat])
        if self.backend == "nccl" and self.device.index is not None:
            import torch
            torch.cuda.set_device(self.device)    # NCCL's communicator
        long_axes = [a for a in self.axis_names if self.shape[a] > 1]
        for n in range(1, len(long_axes) + 1):
            for axes in itertools.combinations(long_axes, n):
                dims = [self.axis_names.index(a) for a in axes]
                rest = [d for d in range(len(self.axis_names))
                        if d not in dims]
                grid = np.transpose(self.ranks, rest + dims).reshape(
                    -1, int(np.prod([self.ranks.shape[d] for d in dims])))
                for members in grid:
                    members = [int(r) for r in members]
                    g = dist.new_group(members, backend=self.backend)
                    if self.rank in members:
                        self._groups[axes] = (g, members)

    def axes_of(self, axes):
        """``axes`` (a name or a tuple of names) as the tuple of the named
        axes longer than 1, in the given order; unknown names raise."""
        axes = spec_axes(axes)
        for a in axes:
            if a not in self.shape:
                raise ValueError(f"axis {a!r} is not in mesh "
                                 f"{self.axis_names}")
        return tuple(a for a in axes if self.shape[a] > 1)

    def axis_size(self, axes):
        return int(np.prod([self.shape[a] for a in self.axes_of(axes)]))

    def axis_index(self, axes):
        """This rank's index along ``axes``, row-major in the given
        order (``lax.axis_index`` of a tuple of axes)."""
        idx = 0
        for a in self.axes_of(axes):
            idx = idx * self.shape[a] + self.coords[a]
        return idx

    def group(self, axes):
        """``(process_group, members)`` over ``axes`` (names longer than
        1): the group, and its members' ranks in the order of their index
        along ``axes`` (:meth:`axis_index`)."""
        axes = self.axes_of(axes)
        if not axes:
            return None, [self.rank]
        if self.coords is None:
            raise MXNetError(f"rank {self.rank} is not in mesh {self}")
        key = tuple(a for a in self.axis_names if a in axes)
        g, members = self._groups[key]
        order = {}
        for r in members:
            c = dict(zip(self.axis_names,
                         map(int, np.argwhere(self.ranks == r)[0])))
            i = 0
            for a in axes:
                i = i * self.shape[a] + c[a]
            order[i] = r
        return g, [order[i] for i in range(len(members))]

    @property
    def device_mesh(self):
        """The grid as a ``DeviceMesh`` named by the axes (made at the
        first read, which every rank makes)."""
        if self._device_mesh is None:
            import torch
            from torch.distributed.device_mesh import DeviceMesh
            self._device_mesh = DeviceMesh(
                self.device.type, torch.as_tensor(self.ranks),
                mesh_dim_names=self.axis_names)
        return self._device_mesh

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __repr__(self):
        return f"Mesh({self.shape!r}, device={self.device})"


class NamedSharding:
    """A spec over a mesh (``jax.sharding.NamedSharding``)."""

    def __init__(self, mesh, spec):
        self.mesh, self.spec = mesh, spec

    def placements(self):
        """The spec as ``DTensor`` placements, one per mesh dim:
        ``Shard(d)`` where array dim ``d`` is split over the mesh dim
        (one array dim a mesh dim), ``Replicate()`` elsewhere."""
        from torch.distributed.tensor import Replicate, Shard
        out = [Replicate()] * len(self.mesh.axis_names)
        for d, entry in enumerate(self.spec):
            for a in spec_axes(entry):
                out[self.mesh.axis_names.index(a)] = Shard(d)
        return out

    def __repr__(self):
        return f"NamedSharding(mesh={self.mesh!r}, spec={self.spec!r})"


def distribute(tensor, sharding):
    """``tensor`` (the same global value on every rank) as a ``DTensor``
    laid out by ``sharding`` (a :class:`NamedSharding`)."""
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(tensor, sharding.mesh.device_mesh,
                             sharding.placements())


def make_mesh(axis_sizes=None, devices=None):
    """A :class:`Mesh` from ``{axis: size}`` (sizes of -1 are inferred, at
    most one).  ``devices``: the ranks to use (default every rank of the
    process group); without a group, the one device of this process
    (default the current context's)."""
    dist = _dist()
    device = None
    if dist is None:
        if devices is not None and len(devices) == 1 and \
                not isinstance(devices[0], (int, np.integer)):
            device = devices[0]
        ranks = [0] if devices is None else list(range(len(devices)))
    else:
        world = dist.get_world_size()
        if devices is None:
            ranks = list(range(world))
        elif all(isinstance(d, (int, np.integer)) for d in devices):
            ranks = [int(d) for d in devices]
            bad = [r for r in ranks if not 0 <= r < world]
            if bad or len(set(ranks)) != len(ranks):
                raise ValueError(f"devices {ranks}: ranks must be distinct "
                                 f"ranks of the group of {world}")
        elif len(devices) == 1:
            ranks, device = [dist.get_rank()], devices[0]
        else:
            raise ValueError("devices: a list of ranks of the process group")
    n = len(ranks)
    if axis_sizes is None:
        axis_sizes = {"dp": n}
    names = list(axis_sizes)
    sizes = list(axis_sizes.values())
    if sizes.count(-1) > 1:
        raise ValueError("at most one axis size may be -1")
    known = int(np.prod([s for s in sizes if s != -1]))
    if -1 in sizes:
        if n % known:
            raise ValueError(f"{n} devices not divisible by {known}")
        sizes[sizes.index(-1)] = n // known
    total = int(np.prod(sizes))
    if dist is None and total > 1:
        raise MXNetError(
            f"mesh {dict(zip(names, sizes))} spans {total} ranks and this "
            "process is in no process group: start the ranks through "
            "tpu_mx_torch.tools.launch (or torch.distributed."
            "init_process_group) first")
    if total != n:
        raise ValueError(f"mesh {dict(zip(names, sizes))} needs {total} "
                         f"devices, have {n}")
    return Mesh(np.asarray(ranks).reshape(sizes), axis_names=tuple(names),
                device=device)


def local_mesh(**axis_sizes):
    return make_mesh(axis_sizes or None)


def hybrid_mesh(ici_axes, dcn_axes=None):
    """The reference's multi-slice mesh (ICI within a slice, DCN across):
    each axis ``ici[a]·dcn.get(a, 1)`` ranks long, the DCN factor the
    outer one (rank-major), as ``create_hybrid_device_mesh`` lays it."""
    dcn_axes = dcn_axes or {}
    unknown = set(dcn_axes) - set(ici_axes)
    if unknown:
        raise ValueError(f"dcn axes {sorted(unknown)} not present in ici_axes")
    return make_mesh({n: ici_axes[n] * dcn_axes.get(n, 1) for n in ici_axes})
