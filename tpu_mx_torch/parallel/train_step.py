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
- the step counter ``t`` starts at 1 for the first applied update; its
  learning rate is ``optimizer.lr_scheduler(t)`` with a scheduler, else
  ``optimizer.lr`` (or the call's ``lr=``);
- a batch of arrays (``NDArray``, as a ``DevicePrefetchIter`` yields)
  gives the loss as an array, a batch of tensors as a tensor;
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

- a net that returns several outputs trains on the first (a warning
  says so unless the loss is ``PassThrough``): an MoE net's aux loss is
  folded into its objective in ``forward``, as the reference's examples
  do;
- ``fingerprint()``: the digest of the post-update parameters and
  buffers (``parallel.integrity.device_fingerprint``'s bits, keyed by
  structural name) of the last applied update, computed on the device
  at each update and read at the call (``TPUMX_FINGERPRINT=0`` turns it
  off: None);
- ``save_checkpoint``/``load_checkpoint``: the reference's protocol (a
  ``<path>.commit.json`` marker written atomically after the state, a
  marker-less path skipped for the next of ``fallback_paths``, the
  reference's error when none restores) over the port's own bytes: one
  ``torch.save`` file of the state and the states of the generators the
  net draws from, so a loaded step continues bit for bit;
- ``step(deadline=)``: the step and its loss's readback under
  ``supervisor.run_with_deadline``; a restore during an abandoned step
  makes that step drop its update;
- the flight recorder's ``train_step.phase`` events, the stations of
  ``tracing.TRAIN_STEP_PHASES`` in the reference's order: ``data_wait``
  (the batch onto the device), ``recompile`` (the first call's build of
  the masters and optimizer state), ``dispatch`` (the eager forward,
  loss and backward enqueued on the device), ``optimizer_update`` (the
  update loop over the parameters) and ``loss_readback`` (the loss's
  device-to-host read, inside the deadline's thread or the
  supervisor's);
- the chaos training sites: ``slow_worker_rank`` sleeps inside
  ``data_wait``, and ``bitflip_param_at_step``/``bitflip_grad_rank``
  flip one bit of the committed parameters after the step's
  fingerprint (:meth:`CompiledTrainStep._apply_bitflip`).

The name is the reference's; in the port the step is **eager PyTorch**
(no capture into one program yet: CUDA-graph capture is open work,
ROADMAP).

**Over a mesh** (``parallel.make_mesh`` of more than one rank; every
rank builds the same net from the same seed and calls ``step`` with the
same global batch):

- each batch argument is cut to the rank's block by its data spec
  (``data_specs``, default ``P("dp")`` on every argument; axes absent
  from the mesh are dropped); the forward and backward run on the
  blocks inside :func:`~.collectives.spmd`, where a model that splits
  its work over ``tp``, ``sp`` or ``ep`` (BERT's Megatron layers, ring
  and Ulysses attention, ``MoEFFN``'s experts) gives every rank the
  whole, equal gradient of each parameter it reads;
- the objective is the mean over the data axes (the axes the specs
  split the batch over) of each rank's mean loss, the gradients are
  averaged over the data axes in one all-reduce a dtype, and so are the
  network's floating buffers (BatchNorm's running statistics) after
  every forward;
- the weights stay whole on every rank.  With an elementwise optimizer
  (``elementwise_update``: SGD, Adam, ...) the float32 masters and the
  optimizer state of a parameter whose spec splits it (``rules``:
  ``bert_sharding_rules``, :func:`fsdp_rules`, ``moe_sharding_rules``)
  are the rank's block of that spec: each rank updates its block and
  the blocks are all-gathered into the weight (ZeRO's layout).  A
  per-tensor optimizer (LAMB's trust ratio) updates whole tensors and
  keeps whole state;
- ``gradient_compression`` (``2bit``/``int8``/``fp8``; a ``dp`` axis
  above 1, replicated parameters and a batch split over ``dp`` only, as
  the reference refuses otherwise): each rank quantizes its gradient
  with its own error feedback (``efs``, kept per rank and not
  checkpointed) and the dequantized values are summed over ``dp``;
  under ``accum_steps`` the microbatch gradients accumulate per rank
  and are compressed once per applied update;
- ``state_dict``/``save_checkpoint`` hold whole tensors (rank 0 writes
  the file), so a checkpoint loads onto any other mesh or none.

Inside the step's SPMD region the batch's axes are named
(``collectives.spmd(batch_axes=, token_axes=)``): ``BatchNorm`` reduces
its batch statistics over them and an ``MoEFFN`` routes the global batch
(its capacity, slots and load-balance term), as the reference's mesh
program computes them on the global batch; under
``gradient_compression`` both keep each rank's own, as the reference's
per-shard program does.
"""
from __future__ import annotations

import json
from contextlib import nullcontext as _nullcontext
import logging
import os
import re
import threading
import time

import numpy as np
import torch

from .. import autograd
from .. import device as _device
from .. import telemetry as _telemetry
from .. import tracing as _tracing
from ..base import MXNetError
from ..contrib import chaos as _chaos
from ..ndarray.ndarray import NDArray
from ..ndarray.traced import host_readable
from . import collectives as _coll
from .integrity import fold_sums, leaf_word_sum
from .mesh import Mesh, NamedSharding, P, spec_axes

__all__ = ["CompiledTrainStep", "fsdp_rules", "sharding_for", "apply_rules"]

_logger = logging.getLogger(__name__)

_LOW_PRECISION = (torch.float16, torch.bfloat16)
# the explicit mantissa bits of each type a master is cast to
_MANTISSA_BITS = {torch.float16: 10, torch.bfloat16: 7}

CHECKPOINT_FORMAT = "tpu_mx_torch-step-v1"


def _fingerprint_on():
    """``TPUMX_FINGERPRINT`` gates the state fingerprint (default on)."""
    return os.environ.get("TPUMX_FINGERPRINT", "1").lower() \
        not in ("0", "false", "off")


def apply_rules(name, shape, rules, mesh):
    """First matching (regex → PartitionSpec) rule wins; axes not in the mesh
    are dropped from the spec; default replicated."""
    if rules:
        for pattern, spec in rules:
            if re.search(pattern, name):
                cleaned = tuple(
                    (ax if (ax is not None and ax in mesh.axis_names) else None)
                    for ax in spec) if mesh is not None else ()
                # drop trailing Nones beyond rank
                cleaned = cleaned[:len(shape)]
                return P(*cleaned)
    return P()


def sharding_for(mesh, spec):
    return NamedSharding(mesh, spec) if mesh is not None else None


def fsdp_rules(params, axis="dp", min_size=1024, axis_size=None):
    """ZeRO-3/FSDP-style rules, the reference's: every parameter of at
    least ``min_size`` elements split over ``axis`` along its largest
    dimension divisible by ``axis_size`` (any largest one with None);
    the rest replicated.  ``params`` maps names to arrays or shapes'
    holders."""
    rules = []
    for name, v in params.items():
        shape = tuple(v.shape)
        if not shape or int(np.prod(shape)) < min_size:
            continue
        dims = sorted(range(len(shape)), key=lambda d: -shape[d])
        dim = None
        for d in dims:  # largest divisible axis; ties -> earliest
            if axis_size is None or shape[d] % axis_size == 0:
                dim = d
                break
        if dim is None:
            continue  # no divisible axis: leave replicated
        spec = [None] * len(shape)
        spec[dim] = axis
        rules.append((f"^{re.escape(name)}$", P(*spec)))
    return rules


def _to_device(state, device):
    """A copy of an optimizer state (a tensor, a tuple of tensors, or
    None) on ``device``."""
    if isinstance(state, tuple):
        return tuple(_to_device(x, device) for x in state)
    if isinstance(state, torch.Tensor):
        return state.detach().clone().to(device)
    return state


def _spec_axes_in(spec, mesh):
    """Per dimension of ``spec``, its axes that the mesh has and that are
    longer than 1."""
    return [tuple(a for a in spec_axes(e)
                  if a in mesh.shape and mesh.shape[a] > 1) for e in spec]


def _block(t, spec, mesh):
    """The rank's block of ``t`` (the same on every rank) under
    ``spec``."""
    for d, axes in enumerate(_spec_axes_in(spec, mesh)):
        if axes:
            t = t.chunk(mesh.axis_size(axes), d)[mesh.axis_index(axes)]
    return t


def _whole(t, spec, mesh):
    """The whole tensor of the ranks' ``spec`` blocks (no autograd)."""
    axes = _spec_axes_in(spec, mesh)
    for d in reversed(range(len(axes))):
        if axes[d]:
            t = _coll._gather(t, mesh, axes[d], d)
    return t


def _state_map(fn, state):
    if isinstance(state, tuple):
        return tuple(_state_map(fn, x) for x in state)
    return fn(state) if isinstance(state, torch.Tensor) else state


def _mean_over(tensors, mesh, axes):
    """Each tensor averaged over ``axes``: one all-reduce per dtype of
    the tensors flattened together."""
    n = mesh.axis_size(axes)
    if n == 1:
        return list(tensors)
    out = list(tensors)
    by_dtype = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        flat = _coll._reduce(flat, mesh, axes) / n
        for i, piece in zip(idx, flat.split([tensors[i].numel()
                                             for i in idx])):
            out[i] = piece.view(tensors[i].shape)
    return out


class CompiledTrainStep:
    """One train step over a network on one device, or on each rank of a
    mesh (module docstring).

    net         — a :class:`torch.nn.Module` (e.g. ``models.BERTModel``)
                  whose parameters all live on ``device``
    loss_fn     — a loss module (``gluon.loss``), per-example values
    optimizer   — a port optimizer (its ``update_core`` is applied)
    device      — where the step runs; None (the default) is the current
                  context (``gpu(0)`` outside ``with mx.cpu():``); a network
                  on another device raises
    n_loss_args — how many trailing ``step()`` arguments go to the loss
    accum_steps — gradient accumulation, as in the reference

    mesh        — None or a ``parallel.make_mesh`` mesh
    rules       — ``[(regex, P)]``: each parameter's spec is
                  :func:`apply_rules` of its key in ``collect_params()``
                  (``specs``)
    data_specs  — the batch arguments' specs (default ``P("dp")`` each)
    gradient_compression — None or ``{"type": "2bit"|"int8"|"fp8",
                  "threshold": t}`` (the compressed ``dp`` reduction)

    ``donate`` is accepted and ignored: buffer donation is a JAX
    compilation option with no PyTorch meaning.
    """

    def __init__(self, net, loss_fn, optimizer, mesh=None, rules=None,
                 data_specs=None, donate=True, n_loss_args=1,
                 gradient_compression=None, accum_steps=1, device=None):
        if mesh is not None and not isinstance(mesh, Mesh):
            raise MXNetError("CompiledTrainStep: mesh must be a "
                             f"parallel.make_mesh Mesh, not {type(mesh)}")
        if mesh is not None and mesh.size > 1 and mesh.coords is None:
            raise MXNetError(f"CompiledTrainStep: rank {mesh.rank} is not "
                             f"in the mesh {mesh}")
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
        self.mesh = mesh
        self._multi = mesh is not None and mesh.size > 1
        self._rules = rules
        self.specs = {k: apply_rules(k, p.shape, rules, mesh)
                      for k, p in self._values().items()}
        self._data_specs = data_specs
        # parameters whose masters and optimizer state are the rank's
        # block of their spec (an elementwise optimizer; module docstring)
        self._shard_keys = set()
        if self._multi and getattr(optimizer, "elementwise_update", False):
            self._shard_keys = {k for k in self._diff_keys
                                if any(_spec_axes_in(self.specs[k], mesh))}
        self._compression = None
        self.efs = {}
        if gradient_compression:
            ctype = gradient_compression.get("type", "2bit")
            if ctype not in ("2bit", "int8", "fp8"):
                raise ValueError(f"unsupported compression type {ctype!r} "
                                 "(have: 2bit, int8, fp8)")
            if mesh is None or "dp" not in mesh.axis_names or \
                    mesh.shape["dp"] < 2:
                raise ValueError(
                    "gradient_compression needs a mesh with a dp axis >1 "
                    "(it compresses the dp gradient reduction)")
            sharded = [k for k in self._diff_keys
                       if any(ax is not None for ax in self.specs[k])]
            if sharded:
                raise ValueError(
                    "gradient_compression supports pure-DP (replicated) "
                    f"params; these are sharded: {sharded[:3]}...")
            bad_axes = {a for spec in (data_specs or ()) for e in spec
                        for a in spec_axes(e) if a != "dp"}
            if bad_axes:
                raise ValueError(
                    "gradient_compression reduces over 'dp' only, but "
                    f"data_specs shard the batch over {sorted(bad_axes)}")
            self._compression = dict(gradient_compression, type=ctype)
        self._n_loss_args = n_loss_args
        self._accum = int(accum_steps)
        self._micro = 0
        self._gacc = None
        self._t = 0
        self._build_count = 0
        self.masters = {}
        self.opt_states = {}
        self._last_fp = None
        # a restore bumps the generation; a step abandoned by its watchdog
        # drops its update when it finds the generation moved
        self._state_lock = threading.Lock()
        self._generation = 0
        self._pending = None     # (thread, path, t, errors) of a save

    # -- state ----------------------------------------------------------------
    def _build(self):
        """Masters, optimizer state and accumulation buffers, at the
        first step (the reference builds its program there)."""
        self._build_count += 1
        _telemetry.counter("train_step.recompiles").inc()
        mp = getattr(self.optimizer, "multi_precision", False)
        with torch.no_grad():
            self.masters = {k: self._own(k, self._params[k].detach().float())
                            .clone() for k in self._diff_keys
                            if mp and self._params[k].dtype in _LOW_PRECISION}
            self.opt_states = {
                k: self.optimizer.create_state(
                    i, self.masters.get(k, self._own(
                        k, self._params[k].detach())))
                for i, k in enumerate(self._diff_keys)}
            if self._compression:
                self.efs = {k: torch.zeros(self._params[k].shape,
                                           dtype=torch.float32,
                                           device=self.device)
                            for k in self._diff_keys}
        if self._accum > 1:
            self._gacc = {k: torch.zeros(self._params[k].shape,
                                         dtype=torch.float32,
                                         device=self.device)
                          for k in self._diff_keys}

    def place(self):
        """Lay the train state out on the mesh: the masters and optimizer
        state, each split parameter's as the rank's block of its spec
        (the reference device_puts them onto their shardings).  The first
        step places it if nothing has; the weights stay whole."""
        if self._build_count == 0:
            self._build()

    def _own(self, key, t):
        """``t`` (a whole tensor of parameter ``key``'s shape) as this
        rank keeps its master and optimizer state: its spec block for a
        sharded key, whole otherwise."""
        return _block(t, self.specs[key], self.mesh) \
            if key in self._shard_keys else t

    def _whole_state(self, key, t):
        return _whole(t, self.specs[key], self.mesh) \
            if key in self._shard_keys else t

    @property
    def recompiles(self):
        """How many times this step built its state (once)."""
        return self._build_count

    def _data_axes(self, n_batch):
        """The mesh axes (longer than 1) the batch is split over."""
        specs = self._batch_specs(n_batch)
        return tuple(a for a in self.mesh.axis_names
                     if any(a in ax for spec in specs
                            for ax in _spec_axes_in(spec, self.mesh)))

    def _batch_region(self, n_batch):
        """``(batch axes, token axes)`` of the step's SPMD region
        (``collectives.spmd``): the axes over which a layer's batch
        statistics are the global batch's, and ``(row axes, sequence
        axes)`` where every split argument is split along its first two
        dimensions alone, each by one set of axes for all (in the spec's
        order, the order of the blocks); none under the compressed
        per-shard reduction."""
        if self._compression:
            return (), None
        split = [_spec_axes_in(spec, self.mesh)
                 for spec in self._batch_specs(n_batch)]
        dims = [{axes[d] for axes in split if len(axes) > d and axes[d]}
                for d in (0, 1)]
        tokens = None
        if all(len(d) <= 1 for d in dims) and not any(
                a for axes in split for a in axes[2:]):
            tokens = tuple(next(iter(d)) if d else () for d in dims)
        return self._data_axes(n_batch), tokens

    def _batch_specs(self, n_batch):
        specs = self._data_specs or tuple(P("dp") for _ in range(n_batch))
        if len(specs) != n_batch:
            raise ValueError(f"data_specs has {len(specs)} specs for a batch "
                             f"of {n_batch} arguments")
        return specs

    # -- the step ---------------------------------------------------------------
    def fingerprint(self):
        """The last applied update's post-update parameter digest as a
        Python int (the reference's uint32), or None before the first
        applied update or with ``TPUMX_FINGERPRINT=0``."""
        if not _fingerprint_on() or self._last_fp is None:
            return None
        return int(self._last_fp)

    def step(self, *batch, lr=None, deadline=None, compile_grace=120.0):
        """Run one step; ``batch = (*data_args, *loss_args)`` as tensors on
        the step's device or host arrays (copied there).  Returns the
        loss, a 0-d float32 tensor on the device (no host sync); an
        array (``NDArray``, which ``np.asarray(loss._data)`` reads by a
        host copy) for a batch of arrays.

        ``deadline=`` runs the step and its loss's readback on a watchdog
        thread joined with the deadline (``supervisor.run_with_deadline``):
        a step that stalls raises ``WatchdogTimeout``; the first step,
        which builds the state, gets ``compile_grace`` more seconds."""
        if deadline is None:
            return self._step(batch, lr)
        from ..supervisor import run_with_deadline
        gen0 = self._generation

        def call():
            loss = self._step(batch, lr, expect_gen=gen0)
            t = loss._data if isinstance(loss, NDArray) else loss
            # the step's work completes INSIDE the watchdog thread: a
            # stalled kernel parks here
            t_read = time.perf_counter()
            if t.is_cuda:
                torch.cuda.current_stream(t.device).synchronize()
            _tracing.emit("train_step.phase", t0=t_read,
                          t1=time.perf_counter(), phase="loss_readback")
            return loss

        count0 = self._build_count
        return run_with_deadline(
            call, deadline, name="train_step", grace=compile_grace or 0.0,
            grace_signal=lambda: self._build_count - count0,
            message=f"train_step hung past its {deadline:.1f}s deadline "
                    "(stalled device); restart from the last checkpoint")

    def _step(self, batch, lr, expect_gen=None):
        if expect_gen is None:
            expect_gen = self._generation
        t_start = time.perf_counter()
        # a chaos straggler's delay lands inside the data_wait phase
        _chaos.maybe_slow_worker()
        arrays = any(isinstance(b, NDArray) for b in batch)
        batch = tuple(None if b is None else _device.as_tensor(
            b._data if isinstance(b, NDArray) else b, self.device)
            for b in batch)
        t_data = time.perf_counter()
        _tracing.emit("train_step.phase", t0=t_start, t1=t_data,
                      phase="data_wait")
        if self._build_count == 0:
            self._build()
            _tracing.emit("train_step.phase", t0=t_data,
                          t1=time.perf_counter(), phase="recompile")
        t_disp = time.perf_counter()
        n = self._n_loss_args
        data_axes = ()
        region = _nullcontext()
        if self._multi:
            data_axes = self._data_axes(len(batch))
            region = _coll.spmd(self.mesh, *self._batch_region(len(batch)))
            batch = tuple(None if b is None else _block(b, spec, self.mesh)
                          for b, spec in zip(batch,
                                             self._batch_specs(len(batch))))
        data_args, loss_args = batch[:-n], batch[-n:]
        diff = [self._params[k] for k in self._diff_keys]
        self.net.train()
        with region:
            loss, grads = self._forward_backward(data_args, loss_args, diff)
        if self._multi:
            with torch.no_grad():
                loss = _mean_over([loss], self.mesh, data_axes)[0]
                bufs = [b for b in self.net.buffers()
                        if b.is_floating_point()]
                for b, v in zip(bufs, _mean_over(bufs, self.mesh,
                                                 data_axes)):
                    b.copy_(v)
        t_done = time.perf_counter()
        _tracing.emit("train_step.phase", t0=t_disp, t1=t_done,
                      phase="dispatch")
        with torch.no_grad():
            if self._accum > 1:
                k = self._accum
                if self._micro < k - 1:
                    for key, g in zip(self._diff_keys, grads):
                        self._gacc[key] += g.float() / k
                    self._micro += 1
                    self._record_step(batch, t_start)
                    return NDArray(host_readable(loss)) if arrays else loss
                grads = [g.float() / k + self._gacc[key]
                         for key, g in zip(self._diff_keys, grads)]
                for buf in self._gacc.values():
                    buf.zero_()
                self._micro = 0
            if self._compression:
                grads = self._compressed_reduce(grads)
            elif self._multi:
                grads = _mean_over(grads, self.mesh, data_axes)
            t_next = self._t + 1
            if lr is None:
                sched = self.optimizer.lr_scheduler
                lr = sched(t_next) if sched else self.optimizer.lr
            with self._state_lock:
                if self._stale(expect_gen):
                    return NDArray(host_readable(loss)) if arrays else loss
                self._apply(grads, lr, t_next)
                self._t = t_next
                self._last_fp = self._digest() if _fingerprint_on() \
                    else None
        _tracing.emit("train_step.phase", t0=t_done,
                      t1=time.perf_counter(), phase="optimizer_update")
        # chaos corruption: one bit of the COMMITTED state flips after this
        # step's fingerprint, silent until the next published one
        bit = _chaos.maybe_bitflip()
        if bit is not None:
            self._apply_bitflip(bit)
        self._record_step(batch, t_start)
        return NDArray(host_readable(loss)) if arrays else loss

    def _forward_backward(self, data_args, loss_args, diff):
        """The mean loss of the (rank's) batch and the gradients of the
        differentiable parameters (zeros for one the loss does not
        read)."""
        with autograd._trace_scope():
            out = self.net(*data_args)
        if isinstance(out, (tuple, list)):
            from ..gluon.loss import PassThrough
            if not isinstance(self.loss_fn, PassThrough):
                _logger.warning(
                    "CompiledTrainStep: net returned %d outputs; training on "
                    "output[0] and DROPPING the rest (an MoE aux loss would "
                    "be lost — fold extra terms into the objective in "
                    "forward() and use gluon.loss.PassThrough)", len(out))
            out = out[0]
        loss = self.loss_fn(out, *loss_args).float().mean()
        grads = torch.autograd.grad(loss, diff, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(diff, grads)]
        return loss.detach(), grads

    def _compressed_reduce(self, grads):
        """The compressed ``dp`` reduction: each rank quantizes its
        (accumulated) gradient with its error feedback and the
        dequantized values are averaged over ``dp``."""
        from ..contrib.compression import (quantize_2bit_core,
                                           quantize_fp8_core,
                                           quantize_int8_core)
        ctype = self._compression["type"]
        threshold = float(self._compression.get("threshold", 0.5))
        deq = []
        for key, g in zip(self._diff_keys, grads):
            g = g.float()
            ef = self.efs[key]
            if ctype == "2bit":
                d, new_ef = quantize_2bit_core(g, ef, threshold)
            elif ctype == "fp8":
                d, new_ef = quantize_fp8_core(g, ef)
            else:
                d, new_ef = quantize_int8_core(g, ef)
            self.efs[key] = new_ef
            deq.append(d)
        return _mean_over(deq, self.mesh, ("dp",))

    def _apply_bitflip(self, bit):
        """Flip one bit of element 0 of the first differentiable
        parameter: the chaos ``bitflip_param_at_step`` /
        ``bitflip_grad_rank`` payload.  A float32 parameter flips mantissa
        bit ``bit`` (0–22), any other without a master bit ``bit % 8`` of
        its first byte, as in the reference.  A mixed-precision parameter
        flips its float32 master, which every update casts the weight
        from (a flip of the weight alone would heal at the next update),
        in the mantissa bits the weight's type keeps, so the weight the
        replicas' fingerprints compare changes with it."""
        key = self._diff_keys[0]
        p = self._params[key]
        with self._state_lock, torch.no_grad():
            master = self.masters.get(key)
            target = p if master is None else master
            head = target.view(-1)[:1]
            if target.dtype == torch.float32:
                if master is not None:
                    kept = _MANTISSA_BITS[p.dtype]
                    bit = 23 - kept + int(bit) % kept
                head.view(torch.int32).bitwise_xor_(1 << int(bit) % 32)
            else:
                head.view(torch.uint8)[:1].bitwise_xor_(1 << int(bit) % 8)
            if master is not None:
                p.view(-1)[:1].copy_(head.to(p.dtype))
        _logger.debug("train_step: chaos bit-flip applied to %r bit %d (%s)",
                      key, int(bit), "master" if master is not None
                      else "value")

    def _digest(self):
        """The post-update digest as a 0-d device tensor: the reference's
        fold over the values keyed by structural name (sorted, as jax
        orders a dict), which every instance of a network shares (the
        reference's per-instance names would order two instances
        differently)."""
        values = self._values()
        return fold_sums([leaf_word_sum(values[k]) for k in sorted(values)])

    def _stale(self, expect_gen):
        """True when the state was restored while this step ran past its
        watchdog deadline (call with ``_state_lock`` held)."""
        if expect_gen is not None and self._generation != expect_gen:
            _logger.warning(
                "train_step: discarding a stale step result — the train "
                "state was restored while this step ran past its watchdog "
                "deadline")
            return True
        return False

    def sync_to_net(self):
        """The reference copies its compiled state back into the net's
        parameters here; the port's step updates them in place, so there
        is nothing to copy."""

    def sync_from_net(self):
        """Take the net's parameters as the step's weights again (the
        rollback after the net was restored from a checkpoint): the
        float32 masters are re-derived from them and in-flight gradient
        accumulation is dropped.  The step trains the net's own tensors,
        so the weights need no copy; the optimizer state is kept, as in
        the reference."""
        if self._build_count == 0:
            return
        with self._state_lock, torch.no_grad():
            self._generation += 1
            self.masters = {k: self._own(k, self._params[k].detach()
                                         .float()).clone()
                            for k in self.masters}
            self._reset_accumulation()

    def _apply(self, grads, lr, t):
        opt, wd = self.optimizer, self.optimizer.wd
        for key, g in zip(self._diff_keys, grads):
            p = self._params[key]
            g = self._own(key, g)
            if key in self.masters:
                # update in float32 master space; the weight is its cast
                w, s = opt.update_core(self.masters[key], g.float(),
                                       self.opt_states[key], lr, wd, t)
                self.masters[key] = w
            else:
                w, s = opt.update_core(self._own(key, p.detach()),
                                       g.to(p.dtype), self.opt_states[key],
                                       lr, wd, t)
            p.copy_(self._whole_state(key, w.to(p.dtype)))
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
        whole = lambda k: lambda x: self._whole_state(k, x.detach()).clone()
        return {"values": {k: clone(p) for k, p in self._values().items()},
                "masters": {k: whole(k)(v) for k, v in self.masters.items()},
                "opt_states": {k: _state_map(whole(k), s)
                               for k, s in self.opt_states.items()},
                "t": self._t}

    def load_state_dict(self, sd):
        """Restore a :meth:`state_dict` snapshot; in-flight gradient
        accumulation is dropped (it was taken against other weights)."""
        if self._build_count == 0:
            self._build()
        values = self._values()
        with self._state_lock, torch.no_grad():
            self._generation += 1   # an abandoned step drops its update
            for k, v in sd["values"].items():
                values[k].copy_(v)
            own = lambda k: lambda x: self._own(k, x.to(self.device))
            self.masters = {k: own(k)(v.detach()).clone()
                            for k, v in sd["masters"].items()}
            self.opt_states = {k: _to_device(_state_map(own(k), s),
                                             self.device)
                               for k, s in sd["opt_states"].items()}
            self._t = int(sd["t"])
            self._reset_accumulation()

    def _reset_accumulation(self):
        self._micro = 0
        if self._gacc is not None:
            for buf in self._gacc.values():
                buf.zero_()

    # -- checkpoints ------------------------------------------------------------
    def _generators(self):
        from ..gluon.block import _segment_generators
        return _segment_generators(self.net, ())

    def save_checkpoint(self, path, block=True):
        """Write the train state (weights and buffers, masters, optimizer
        state, ``t``) and the states of the generators the net draws from
        to the file ``path``, then its ``<path>.commit.json`` marker
        atomically.  ``block=False`` returns once the state is copied to
        the host and writes on a thread; :meth:`wait_for_checkpoint` (or
        any later save or load) waits for it and stamps its marker."""
        self.wait_for_checkpoint()
        cpu = lambda x: x.detach().to("cpu", copy=True)
        sd = self.state_dict()
        state = {"format": CHECKPOINT_FORMAT, "t": int(sd["t"]),
                 "values": {k: cpu(v) for k, v in sd["values"].items()},
                 "masters": {k: cpu(v) for k, v in sd["masters"].items()},
                 "opt_states": {k: tuple(cpu(x) for x in s)
                                if isinstance(s, tuple) else s
                                for k, s in sd["opt_states"].items()},
                 "generators": [g.get_state() for g in self._generators()]}
        ap = os.path.abspath(str(path))
        errors = []
        if self._multi and self.mesh.rank != self.mesh.ranks.flat[0]:
            return          # the mesh's first rank writes the whole state

        def write():
            from ..checkpoint import atomic_write
            try:
                with atomic_write(ap, "wb") as f:
                    torch.save(state, f)
            except BaseException as e:  # noqa: BLE001 — raised at the wait
                errors.append(e)

        if block:
            write()
            if errors:
                raise errors[0]
            self._write_commit_marker(ap, state["t"])
            return
        thread = threading.Thread(target=write, daemon=True,
                                  name="train_step-checkpoint")
        thread.start()
        self._pending = (thread, ap, state["t"], errors)

    @staticmethod
    def commit_marker_path(path):
        return os.path.abspath(str(path)) + ".commit.json"

    def _write_commit_marker(self, path, saved_t):
        from ..checkpoint import atomic_write
        with atomic_write(self.commit_marker_path(path), "w") as f:
            f.write(json.dumps({"format": CHECKPOINT_FORMAT + "-commit",
                                "path": os.path.basename(path),
                                "t": saved_t, "wall_time": time.time()}))

    def wait_for_checkpoint(self):
        """Block until an in-flight async save has written its file, then
        stamp its commit marker; a failed write raises here, unstamped."""
        pending, self._pending = self._pending, None
        if pending is not None:
            thread, path, saved_t, errors = pending
            thread.join()
            if errors:
                raise errors[0]
            self._write_commit_marker(path, saved_t)

    def load_checkpoint(self, path, fallback_paths=()):
        """Restore a :meth:`save_checkpoint` file, the generators' states
        included.  A path without its commit marker is skipped while
        ``fallback_paths`` (older checkpoints, newest first) remain, and
        tried (with a warning) as the last resort; a path that fails to
        restore falls back too.  Returns the path restored; raises
        ``MXNetError`` when none restores."""
        self.wait_for_checkpoint()
        if self._multi:
            # every rank reads the file the first rank wrote: wait for it
            _coll._reduce(torch.zeros(1, device=self.device), self.mesh,
                          self.mesh.axis_names)
        candidates = [os.path.abspath(str(p))
                      for p in (path, *tuple(fallback_paths))]
        errors = []
        for i, ap in enumerate(candidates):
            last_resort = i == len(candidates) - 1
            if not os.path.exists(ap):
                errors.append(f"{ap}: does not exist")
                continue
            if not os.path.exists(self.commit_marker_path(ap)):
                if not last_resort:
                    _logger.warning(
                        "checkpoint %s has no commit marker (interrupted "
                        "or pre-durability save): falling back", ap)
                    errors.append(f"{ap}: no commit marker")
                    continue
                _logger.warning(
                    "checkpoint %s has no commit marker: attempting "
                    "unverified restore (legacy/last resort)", ap)
            try:
                state = torch.load(ap, map_location="cpu",
                                   weights_only=True)
                if state.get("format") != CHECKPOINT_FORMAT:
                    raise ValueError(f"not a {CHECKPOINT_FORMAT} file")
                gens = self._generators()
                if len(state["generators"]) != len(gens):
                    raise ValueError(f"{len(state['generators'])} generator "
                                     f"states for {len(gens)} generators")
                self.load_state_dict(state)
            except Exception as e:  # noqa: BLE001 — falls back, then raises
                _logger.warning("checkpoint %s failed to restore (%s: %s)%s",
                                ap, type(e).__name__, e,
                                "" if last_resort else " — falling back")
                errors.append(f"{ap}: {type(e).__name__}: {e}")
                continue
            for g, s in zip(gens, state["generators"]):
                g.set_state(s)
            return ap
        raise MXNetError("load_checkpoint: no restorable checkpoint among "
                         + "; ".join(errors))
