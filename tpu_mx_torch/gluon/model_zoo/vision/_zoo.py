"""What the vision families of the port share: the device they are built
on, ``from_numpy`` and the refusal of pretrained weights.

A family is built with its layers' input sizes left to the first
forward (``in_channels=0``, as in the reference), so a net holds no
tensor until ``initialize()`` and a forward (or ``load_numpy``/
``load_parameters``, which take the arrays' shapes).  ``device`` (a
string, :class:`torch.device` or Context; None is the current context)
is where the net's tensors are drawn: the layers are built under its
context.
"""
from __future__ import annotations

import contextlib

from .... import device as _device
from .... import layout as _layout
from ....base import MXNetError
from ....context import cpu, gpu
from ...block import HybridBlock, as_dtype, load_numpy

__all__ = ["ZooNet", "building", "refuse_pretrained"]


@contextlib.contextmanager
def building(device):
    """The context of ``device`` (None: the current one), for the
    layers built inside."""
    if device is None:
        yield
        return
    dev = _device.resolve(device)
    with (gpu(dev.index or 0) if dev.type == "cuda" else cpu()):
        yield


def refuse_pretrained(name, pretrained):
    if pretrained:
        raise MXNetError(f"{name}(pretrained=True): no pretrained weights "
                         "(nothing is downloaded)")


class ZooNet(HybridBlock):
    """A family's net: ``output(features(x))``, built on ``device`` in
    ``dtype`` (a deferred tensor is drawn in it)."""

    def _finish(self, dtype):
        if as_dtype(dtype) != as_dtype("float32"):
            self.cast(dtype)

    def forward(self, x):
        return self.output(self.features(x))

    @classmethod
    def from_numpy(cls, params, *args, layout=None, device=None, **kwargs):
        """The port's net computing the reference's function: built as
        ``cls(*args, **kwargs)`` (under ``default_layout(layout)`` when
        ``layout`` is given) on ``device``, then every parameter and
        running statistic set from ``params``, the reference's
        ``collect_params()`` as numpy arrays in its order
        (``gluon.block.load_numpy``)."""
        scope = _layout.default_layout(layout) if layout \
            else contextlib.nullcontext()
        with scope:
            net = cls(*args, device=device, **kwargs)
        with building(device):
            return load_numpy(net, params)
