"""Gluon ``Trainer``, from ``tpu_mx/gluon/trainer.py``.

``Trainer(net.collect_params(), "sgd", {"learning_rate": 0.05})`` holds
the :class:`~tpu_mx_torch.gluon.Parameter` handles, not their tensors, so
it can be built before a deferred net's first forward.  ``step(batch)``
sets the optimizer's ``rescale_grad`` to ``1/batch`` (the loss's
per-example values were summed by ``backward()``), reduces the gradients
across workers (a no-op at world size 1, the only one ported) and
updates every parameter with ``grad_req != "null"`` in place, under
``torch.no_grad()``: with ``multi_precision`` a float16/bfloat16
parameter is the cast of a float32 master kept in its state.  The
update is one eager loop over the parameters; a fused multi-tensor
update is open work (ROADMAP A5).
"""
from __future__ import annotations

import torch

from .. import optimizer as _opt
from ..base import MXNetError, refuse_unported

__all__ = ["Trainer"]

_LOCAL_KVSTORES = (None, False, "", "local", "device")


def _to_device(state, device):
    if isinstance(state, torch.Tensor):
        return state.to(device)
    if isinstance(state, (tuple, list)):
        return tuple(_to_device(s, device) for s in state)
    return state


def _to_host(state):
    if isinstance(state, torch.Tensor):
        return state.detach().cpu()
    if isinstance(state, (tuple, list)):
        return tuple(_to_host(s) for s in state)
    return state


class Trainer:
    """Applies an optimizer to a set of parameters (the reference's
    ``gluon.Trainer``).  ``kvstore`` other than a local one
    (``"device"``, ``"local"``, None) is not ported yet (ROADMAP A15)."""

    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device", compression_params=None,
                 update_on_kvstore=None, fuse_update=True):
        if kvstore not in _LOCAL_KVSTORES:
            raise MXNetError(f"Trainer(kvstore={kvstore!r}) is not ported "
                             "yet (ROADMAP A15: kvstore.py over "
                             "torch.distributed)")
        refuse_unported("Trainer", "A15",
                        compression_params=(compression_params, None),
                        update_on_kvstore=(update_on_kvstore, None))
        if hasattr(params, "values"):
            params = list(params.values())
        self._params = [p for p in params if p.grad_req != "null"]
        self._optimizer = _opt.create(optimizer, **(optimizer_params or {})) \
            if isinstance(optimizer, str) else optimizer
        self._optimizer.param_dict = dict(enumerate(self._params))
        self._states = [None] * len(self._params)
        self._states_inited = [False] * len(self._params)

    @property
    def learning_rate(self):
        """The optimizer's ``lr``, or with an ``lr_scheduler`` its rate at
        the current update count, as the reference reads it."""
        sched = self._optimizer.lr_scheduler
        return sched(self._optimizer.num_update) if sched \
            else self._optimizer.lr

    @property
    def optimizer(self):
        return self._optimizer

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    def _check_initialized(self):
        for p in self._params:
            if p._tensor() is None:
                raise MXNetError(
                    f"Parameter {p.name} is not initialized; call "
                    "initialize() and run a forward pass before step()")

    def step(self, batch_size, ignore_stale_grad=False):
        """Rescale the gradients by ``1/batch_size``, reduce them and
        update every parameter."""
        self._check_initialized()
        self._optimizer.rescale_grad = 1.0 / batch_size
        self.allreduce_grads()
        self.update(batch_size, ignore_stale_grad)

    def allreduce_grads(self):
        """Sum the gradients across workers: nothing to do on one."""

    def update(self, batch_size, ignore_stale_grad=False):
        """Apply the optimizer to every parameter (after
        :meth:`allreduce_grads`)."""
        self._check_initialized()
        opt = self._optimizer
        for i, p in enumerate(self._params):
            weight = p.data()
            if not self._states_inited[i]:
                self._states[i] = opt.create_state_multi_precision(i, weight)
                self._states_inited[i] = True
            self._states[i] = opt.update_multi_precision(i, weight, p.grad,
                                                         self._states[i])

    def save_states(self, fname):
        """The optimizer's state and update counts, in the port's own
        file format (``torch.save`` of host tensors)."""
        torch.save({"states": [_to_host(s) for s in self._states],
                    "states_inited": list(self._states_inited),
                    "num_update": self._optimizer.num_update,
                    "index_update_count":
                        dict(self._optimizer._index_update_count)}, fname)

    def load_states(self, fname):
        payload = torch.load(fname, map_location="cpu", weights_only=True)
        self._check_initialized()
        self._states = [_to_device(s, p._tensor().device)
                        for s, p in zip(payload["states"], self._params)]
        self._states_inited = list(payload["states_inited"])
        self._optimizer.num_update = payload["num_update"]
        self._optimizer._index_update_count = \
            dict(payload["index_update_count"])
