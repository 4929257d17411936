"""``mx.monitor``, from ``tpu_mx/monitor.py``: per-layer output statistics
for debugging.

:meth:`Monitor.install` registers a forward hook on a Gluon block and on
every block under it (through plain container modules too, such as a
model's layer list), named ``<root>.<child key>...`` (the root by its
class name, lower-cased).  Between :meth:`tic` and :meth:`toc` of every
``interval``-th batch, each hooked block whose name matches ``pattern``
records ``stat_func`` of each output it returns (``mean |x|`` by
default) as ``(batch, name, stat)``.  A block's output is an array at
the imperative boundary and a tensor inside its parent's forward; both
are read back to the host as numpy for ``stat_func``, so a monitored
batch waits for the card once per recorded output.
"""
from __future__ import annotations

import re

import numpy as np
import torch

from .ndarray.ndarray import NDArray
from .runtime import fetch_sync

__all__ = ["Monitor"]


def _default_stat(arr):
    return float(np.abs(arr).mean())


class Monitor:
    def __init__(self, interval, stat_func=None, pattern=".*", sort=False):
        self.interval = max(1, int(interval))
        self.stat_func = stat_func or _default_stat
        self.re = re.compile(pattern)
        self.sort = sort
        self.step = 0
        self.activated = False
        self.queue = []  # (step, name, stat)
        self._handles = []

    # -- installation ------------------------------------------------------
    def install(self, block, root_name=None):
        """Register forward hooks on ``block`` and every block under it."""
        def make_hook(name):
            def hook(blk, inputs, output):
                if not self.activated:
                    return
                outs = output if isinstance(output, (list, tuple)) \
                    else (output,)
                for i, o in enumerate(outs):
                    if isinstance(o, (NDArray, torch.Tensor)):
                        key = name if len(outs) == 1 else f"{name}_output{i}"
                        if self.re.match(key):
                            self.queue.append(
                                (self.step, key, self.stat_func(fetch_sync(o))))
            return hook

        root = root_name or type(block).__name__.lower()
        for name, child in self._walk(block, root):
            self._handles.append(child.register_forward_hook(
                make_hook(name)))
        return self

    def uninstall(self):
        """Remove every hook this monitor registered."""
        for handle in self._handles:
            handle.detach()
        self._handles = []

    def _walk(self, block, prefix, hook=True):
        """``(name, block)`` of the blocks under ``block``; a plain
        container module (a model's layer list) is walked through, named
        but not hooked."""
        from .gluon.block import Block
        if hook:
            yield prefix, block
        for key, child in block.named_children():
            yield from self._walk(child, f"{prefix}.{key}",
                                  isinstance(child, Block))

    # -- the per-batch protocol ----------------------------------------------
    def tic(self):
        """Start collecting for this batch if it is an interval batch."""
        if self.step % self.interval == 0:
            self.activated = True
            self.queue = []
        self.step += 1

    def toc(self):
        """Stop collecting and return the batch's ``(step, name, stat)``s."""
        if not self.activated:
            return []
        self.activated = False
        res = sorted(self.queue, key=lambda t: t[1]) if self.sort \
            else list(self.queue)
        self.queue = []
        return res

    def toc_print(self):
        for step, name, stat in self.toc():
            print("Batch: %7d %30s %s" % (step, name, stat))
