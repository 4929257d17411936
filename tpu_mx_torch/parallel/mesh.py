"""Device meshes, from ``tpu_mx/parallel/mesh.py``, at world size 1.

The reference builds a ``jax.sharding.Mesh`` over every device and names
its axes (``dp``, ``fsdp``, ``tp``, ``sp``, ``pp``, ``ep``); sharding
rules and data specs are ``PartitionSpec``s over those names.  The port
runs on one device in one process: a mesh whose axes multiply to 1 is
accepted (every axis of size 1, so a spec over it places nothing), and
an axis above 1 raises ``MXNetError`` naming ROADMAP A item 9 (the
multi-device paths), as does a list of more than one device.

:class:`P` is the port's ``PartitionSpec``: a tuple of axis names (or
None, or a tuple of names), equal to another spec, or to a plain tuple,
with the same axes, as jax's is.
"""
from __future__ import annotations

import numpy as np

from .. import device as _device
from ..base import MXNetError
from ..context import current_context

__all__ = ["make_mesh", "Mesh", "NamedSharding", "P", "local_mesh",
           "hybrid_mesh"]


class P(tuple):
    """``PartitionSpec(*axes)``: per array dimension, the mesh axis (or
    axes, or None) it is split over."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self):
        return "PartitionSpec(" + ", ".join(map(repr, self)) + ")"

    def __reduce__(self):
        return (P, tuple(self))


class Mesh:
    """A named grid of devices (here one): ``axis_names``, ``shape``
    (``{name: size}``), ``devices`` (an array of that shape), ``size``."""

    def __init__(self, devices, axis_names, axis_types=None):
        self.devices = np.asarray(devices, dtype=object)
        self.axis_names = tuple(axis_names)
        self.axis_types = axis_types
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"mesh of {self.devices.ndim} dimensions named "
                             f"{self.axis_names}")
        self.shape = dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self):
        return int(self.devices.size)

    @property
    def device(self):
        """The one device of the mesh."""
        return self.devices.reshape(-1)[0]

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __repr__(self):
        return f"Mesh({self.shape!r}, device={self.device})"


class NamedSharding:
    """A spec over a mesh (``jax.sharding.NamedSharding``); at world size 1
    it places the array whole on the mesh's device."""

    def __init__(self, mesh, spec):
        self.mesh, self.spec = mesh, spec

    def __repr__(self):
        return f"NamedSharding(mesh={self.mesh!r}, spec={self.spec!r})"


def _refuse(sizes):
    raise MXNetError(f"mesh {sizes} spans more than one device; the port's "
                     "multi-device paths are not ported yet (ROADMAP A item "
                     "9): on one process every mesh axis has size 1")


def make_mesh(axis_sizes=None, devices=None):
    """A :class:`Mesh` from ``{axis: size}`` (sizes of -1 are inferred, at
    most one); ``devices`` defaults to the current context's device.
    Every size must come to 1."""
    devices = [_device.resolve(current_context())] if devices is None \
        else [_device.resolve(d) for d in devices]
    n = len(devices)
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
    if n > 1 or any(s > 1 for s in sizes):
        _refuse(dict(zip(names, sizes)))
    total = int(np.prod(sizes))
    if total != n:
        raise ValueError(f"mesh {dict(zip(names, sizes))} needs {total} "
                         f"devices, have {n}")
    arr = np.empty(len(devices), dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(sizes), axis_names=tuple(names))


def local_mesh(**axis_sizes):
    return make_mesh(axis_sizes or None)


def hybrid_mesh(ici_axes, dcn_axes=None):
    """The reference's multi-slice mesh (ICI within a slice, DCN across):
    at world size 1 every factor is 1, so it is :func:`make_mesh` of the
    per-axis products."""
    dcn_axes = dcn_axes or {}
    unknown = set(dcn_axes) - set(ici_axes)
    if unknown:
        raise ValueError(f"dcn axes {sorted(unknown)} not present in ici_axes")
    return make_mesh({n: ici_axes[n] * dcn_axes.get(n, 1) for n in ici_axes})
