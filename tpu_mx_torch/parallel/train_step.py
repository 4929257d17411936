"""The train step of ``tpu_mx/parallel/train_step.py``, on one device.

``CompiledTrainStep(net, loss_fn, optimizer).step(*batch)`` runs the
forward, the loss, the backward and the optimizer update, with the
reference's contract:

- the trailing ``n_loss_args`` batch arguments go to the loss, the rest
  to the network; ``None`` arguments pass through (``valid_length``);
- the objective is the mean of the loss's per-example values;
- with ``optimizer.multi_precision``, every float16/bfloat16 parameter
  has a float32 master: the update runs in master space and the forward
  weight is a cast of the master; the optimizer's state is float32;
- ``accum_steps=K``: every K-th call applies the update with the mean of
  the last K microbatch gradients (accumulated in float32);
- the step counter ``t`` starts at 1 for the first applied update;
- the network's buffers (BatchNorm's running statistics, the
  reference's ``grad_req="null"`` parameters) are step state: they
  change in the forward of every call, every microbatch included, and
  ``state_dict``/``load_state_dict`` snapshot and restore them beside
  the weights, masters, optimizer state and ``t`` (masters and
  optimizer state exist for the differentiable parameters only);
- telemetry: ``train_step.steps``, ``train_step.recompiles`` (counted
  once, when the step builds its state at its first call),
  ``train_step.seconds`` and ``train_step.examples_per_sec`` (host time
  of the call, which returns before the card has finished unless the
  caller reads the loss).

The name is the reference's; in the port the step is **eager PyTorch**
(no capture into one program yet: CUDA-graph capture is open work,
ROADMAP).  Not ported yet: the mesh, sharding rules and data specs,
gradient compression, the SDC fingerprint, checkpoint save/load, the
``deadline`` watchdog and chaos injection.
"""
from __future__ import annotations

import logging
import time

import torch

from .. import device as _device
from .. import telemetry as _telemetry
from ..base import MXNetError, refuse_unported

__all__ = ["CompiledTrainStep"]

_logger = logging.getLogger(__name__)

_LOW_PRECISION = (torch.float16, torch.bfloat16)


class CompiledTrainStep:
    """One train step over a network on one device.

    net         — a :class:`torch.nn.Module` (e.g. ``models.BERTModel``)
                  whose parameters all live on ``device``
    loss_fn     — a loss module (``gluon.loss``), per-example values
    optimizer   — a port optimizer (its ``update_core`` is applied)
    device      — where the step runs, ``"cuda"`` by default; a network
                  on another device raises
    n_loss_args — how many trailing ``step()`` arguments go to the loss
    accum_steps — gradient accumulation, as in the reference

    ``donate`` is accepted and ignored: buffer donation is a JAX
    compilation option with no PyTorch meaning.  ``rules``,
    ``data_specs`` and ``gradient_compression`` must keep their
    defaults (None): the mesh and compression are not ported yet.
    """

    def __init__(self, net, loss_fn, optimizer, mesh=None, rules=None,
                 data_specs=None, donate=True, n_loss_args=1,
                 gradient_compression=None, accum_steps=1, device="cuda"):
        refuse_unported("CompiledTrainStep", "A8", rules=(rules, None),
                        data_specs=(data_specs, None),
                        gradient_compression=(gradient_compression, None))
        if mesh is not None:
            raise MXNetError("CompiledTrainStep: the mesh (and its sharding "
                             "rules, data specs and gradient compression) "
                             "is not ported yet (ROADMAP A8: the port's "
                             "step runs on one device)")
        if n_loss_args < 1:
            raise ValueError("n_loss_args must be >= 1 (the label)")
        if accum_steps < 1:
            raise ValueError("accum_steps must be >= 1")
        self.device = _device.resolve(device)
        self.net, self.loss_fn, self.optimizer = net, loss_fn, optimizer
        self._params = dict(net.named_parameters())
        if not self._params:
            raise ValueError("net has no parameters")
        foreign = sorted({str(p.device) for p in (*self._params.values(),
                                                  *net.buffers())
                          if p.device.type != self.device.type})
        if foreign:
            raise MXNetError(f"CompiledTrainStep(device={str(device)!r}): "
                             f"the net's parameters live on {foreign}")
        self._diff_keys = [k for k, p in self._params.items()
                           if p.requires_grad and p.is_floating_point()]
        self._n_loss_args = n_loss_args
        self._accum = int(accum_steps)
        self._micro = 0
        self._gacc = None
        self._t = 0
        self._build_count = 0
        self.masters = {}
        self.opt_states = {}

    # -- state ----------------------------------------------------------------
    def _build(self):
        """Masters, optimizer state and accumulation buffers, at the
        first step (the reference builds its program there)."""
        self._build_count += 1
        _telemetry.counter("train_step.recompiles").inc()
        mp = getattr(self.optimizer, "multi_precision", False)
        with torch.no_grad():
            self.masters = {k: self._params[k].detach().float().clone()
                            for k in self._diff_keys
                            if mp and self._params[k].dtype in _LOW_PRECISION}
            self.opt_states = {
                k: self.optimizer.create_state(
                    i, self.masters.get(k, self._params[k].detach()))
                for i, k in enumerate(self._diff_keys)}
        if self._accum > 1:
            self._gacc = {k: torch.zeros(self._params[k].shape,
                                         dtype=torch.float32,
                                         device=self.device)
                          for k in self._diff_keys}

    @property
    def recompiles(self):
        """How many times this step built its state (once)."""
        return self._build_count

    # -- the step ---------------------------------------------------------------
    def step(self, *batch, lr=None, deadline=None, compile_grace=120.0):
        """Run one step; ``batch = (*data_args, *loss_args)`` as tensors on
        the step's device or host arrays (copied there).  Returns the
        loss, a 0-d float32 tensor on the device (no host sync).
        ``deadline``/``compile_grace`` (the reference's watchdog) must
        keep their defaults: not ported yet."""
        refuse_unported("CompiledTrainStep.step", "A8",
                        deadline=(deadline, None),
                        compile_grace=(compile_grace, 120.0))
        t_start = time.perf_counter()
        if self._build_count == 0:
            self._build()
        batch = tuple(None if b is None else _device.as_tensor(b, self.device)
                      for b in batch)
        n = self._n_loss_args
        data_args, loss_args = batch[:-n], batch[-n:]
        diff = [self._params[k] for k in self._diff_keys]
        self.net.train()
        out = self.net(*data_args)
        if isinstance(out, (tuple, list)):
            _logger.warning("CompiledTrainStep: net returned %d outputs; "
                            "training on output[0]", len(out))
            out = out[0]
        loss = self.loss_fn(out, *loss_args).float().mean()
        grads = torch.autograd.grad(loss, diff, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(diff, grads)]
        loss = loss.detach()
        with torch.no_grad():
            if self._accum > 1:
                k = self._accum
                if self._micro < k - 1:
                    for key, g in zip(self._diff_keys, grads):
                        self._gacc[key] += g.float() / k
                    self._micro += 1
                    self._record_step(batch, t_start)
                    return loss
                grads = [g.float() / k + self._gacc[key]
                         for key, g in zip(self._diff_keys, grads)]
                for buf in self._gacc.values():
                    buf.zero_()
                self._micro = 0
            t_next = self._t + 1
            self._apply(grads, self.optimizer.lr if lr is None else lr,
                        t_next)
            self._t = t_next
        self._record_step(batch, t_start)
        return loss

    def _apply(self, grads, lr, t):
        opt, wd = self.optimizer, self.optimizer.wd
        for key, g in zip(self._diff_keys, grads):
            p = self._params[key]
            if key in self.masters:
                # update in float32 master space; the weight is its cast
                w, s = opt.update_core(self.masters[key], g.float(),
                                       self.opt_states[key], lr, wd, t)
                self.masters[key] = w
            else:
                w, s = opt.update_core(p.detach(), g.to(p.dtype),
                                       self.opt_states[key], lr, wd, t)
            p.copy_(w.to(p.dtype))
            self.opt_states[key] = s

    @staticmethod
    def _record_step(batch, t_start):
        dt = time.perf_counter() - t_start
        _telemetry.counter("train_step.steps").inc()
        _telemetry.histogram("train_step.seconds").observe(dt)
        n = next((b.shape[0] for b in batch
                  if b is not None and b.dim()), None)
        if n and dt > 0:
            _telemetry.gauge("train_step.examples_per_sec").set(n / dt)

    # -- snapshots --------------------------------------------------------------
    def _values(self):
        """The parameters and, read now (``cast`` replaces them), the
        buffers of the net, by name."""
        return {**self._params, **dict(self.net.named_buffers())}

    def state_dict(self):
        """Copies of the weights and buffers (``values``), masters,
        optimizer state and ``t``."""
        clone = lambda x: x.detach().clone()
        return {"values": {k: clone(p) for k, p in self._values().items()},
                "masters": {k: clone(v) for k, v in self.masters.items()},
                "opt_states": {k: tuple(clone(x) for x in s)
                               if isinstance(s, tuple) else s
                               for k, s in self.opt_states.items()},
                "t": self._t}

    def load_state_dict(self, sd):
        """Restore a :meth:`state_dict` snapshot; in-flight gradient
        accumulation is dropped (it was taken against other weights)."""
        if self._build_count == 0:
            self._build()
        values = self._values()
        with torch.no_grad():
            for k, v in sd["values"].items():
                values[k].copy_(v)
            self.masters = {k: v.detach().clone().to(self.device)
                            for k, v in sd["masters"].items()}
            self.opt_states = {
                k: tuple(x.detach().clone().to(self.device) for x in s)
                if isinstance(s, tuple) else s
                for k, s in sd["opt_states"].items()}
            self._t = int(sd["t"])
            self._micro = 0
            if self._gacc is not None:
                for buf in self._gacc.values():
                    buf.zero_()
