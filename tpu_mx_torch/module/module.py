"""``mx.module``: the symbolic training API, from
``tpu_mx/module/module.py``: ``Module`` (bind, init_params,
init_optimizer, forward, backward, update, fit, score, predict,
checkpoints) and ``BucketingModule`` (the symbolic PTB path: one
executor a bucket, all sharing the default bucket's parameter arrays).

A module runs one :class:`~tpu_mx_torch.symbol.Executor` on its first
context.  Given a list of contexts, the reference shards the batch over
a one-axis mesh and replicates the parameters, one program whose
gradients are the whole batch's; the port computes the same whole-batch
gradients on the list's first context (so the same results, up to the
order of the float32 sums).  A batch of another size than the bound one
runs as it is: the executor has no compiled program to reshape.
"""
from __future__ import annotations

import logging
import pickle
import time

import torch

from .. import initializer as _init_mod
from .. import metric as _metric_mod
from .. import optimizer as _opt_mod
from .. import random as _random
from ..base import MXNetError
from ..context import current_context
from ..io.io import DataDesc
from ..ndarray import NDArray, array
from ..ndarray import ndarray as _nd_mod
from ..symbol import Symbol

__all__ = ["BaseModule", "Module", "BucketingModule"]


def _as_descs(shapes):
    out = []
    for s in shapes or []:
        out.append(s if isinstance(s, DataDesc)
                   else DataDesc(s[0], tuple(s[1])))
    return out


def _metric(m):
    if isinstance(m, _metric_mod.EvalMetric):
        return m
    return _metric_mod.create(m)


def _unpadded(arrays, pad):
    """The arrays without their last ``pad`` rows (a padded batch's)."""
    return [NDArray(a._data[:a.shape[0] - pad]) if isinstance(a, NDArray)
            else NDArray(torch.as_tensor(a)[:len(a) - pad]) for a in arrays]


class BaseModule:
    """The loop the modules share: ``fit``, ``score``, ``predict``,
    ``forward_backward``."""

    def __init__(self, logger=logging):
        self.logger = logger
        self.binded = False
        self.params_initialized = False
        self.optimizer_initialized = False

    def install_monitor(self, monitor):
        """Take ``monitor`` (an ``mx.monitor.Monitor``) and hook nothing,
        as the reference's module does: its executors run whole graphs,
        with no block to hook, so ``fit(monitor=)``'s ``tic``/
        ``toc_print`` each batch record and print nothing.  A
        :class:`~tpu_mx_torch.monitor.Monitor` collects from Gluon blocks
        (``Monitor.install(block)``)."""

    def forward_backward(self, data_batch):
        self.forward(data_batch, is_train=True)
        self.backward()

    def score(self, eval_data, eval_metric, num_batch=None, reset=True,
              epoch=0, batch_end_callback=None):
        eval_metric = _metric(eval_metric)
        eval_metric.reset()
        if reset:
            eval_data.reset()
        for nbatch, batch in enumerate(eval_data):
            if num_batch is not None and nbatch >= num_batch:
                break
            self.forward(batch, is_train=False)
            if batch.pad:
                # the wrapped-around rows are not samples
                eval_metric.update(_unpadded(batch.label, batch.pad),
                                   _unpadded(self.get_outputs(), batch.pad))
            else:
                self.update_metric(eval_metric, batch.label)
            if batch_end_callback is not None:
                for cb in _as_list(batch_end_callback):
                    cb(BatchEndParam(epoch, nbatch, eval_metric, locals()))
        return eval_metric.get_name_value()

    def predict(self, eval_data, num_batch=None, merge_batches=True,
                reset=True):
        if reset:
            eval_data.reset()
        outputs = []
        for nbatch, batch in enumerate(eval_data):
            if num_batch is not None and nbatch >= num_batch:
                break
            self.forward(batch, is_train=False)
            outs = [o.copy() for o in self.get_outputs()]
            if batch.pad:
                outs = _unpadded(outs, batch.pad)
            outputs.append(outs)
        if not merge_batches:
            return outputs
        n_out = len(outputs[0]) if outputs else 0
        merged = [_nd_mod.concatenate([b[i] for b in outputs], axis=0)
                  for i in range(n_out)]
        return merged[0] if n_out == 1 else merged

    def fit(self, train_data, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None, kvstore="local",
            optimizer="sgd", optimizer_params=(("learning_rate", 0.01),),
            eval_end_callback=None, eval_batch_end_callback=None,
            initializer=None, arg_params=None, aux_params=None,
            allow_missing=False, force_rebind=False, force_init=False,
            begin_epoch=0, num_epoch=None, validation_metric=None,
            monitor=None, supervised=None):
        """The reference's training loop.  ``supervised=`` (a
        ``supervisor.Supervise``, or a dict of its arguments) runs it
        under a :class:`~tpu_mx_torch.supervisor.Supervisor`: every epoch
        commits a checkpoint under its prefix, each batch runs under the
        watchdog and the numeric sentinel (the mean of the first output,
        read back before ``update``), and faults restart or roll back to
        the last verified checkpoint.  Returns the run's
        ``SupervisorResult`` then, else None."""
        assert num_epoch is not None, "num_epoch must be specified"
        initializer = initializer or _init_mod.Uniform(0.01)
        self.bind(data_shapes=train_data.provide_data,
                  label_shapes=train_data.provide_label,
                  for_training=True, force_rebind=force_rebind)
        if monitor is not None:
            self.install_monitor(monitor)
        self.init_params(initializer=initializer, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init)
        self.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                            optimizer_params=optimizer_params)
        eval_metric = _metric(eval_metric)
        validation_metric = (_metric(validation_metric)
                             if validation_metric is not None else eval_metric)

        def one_batch(data_batch):
            self.forward_backward(data_batch)
            self.update()

        def sentinel_batch(data_batch, sup):
            gen = sup.generation
            self.forward_backward(data_batch)
            # the sentinel's observable, checked before update(): a
            # poisoned batch never reaches the weights, and a batch the
            # watchdog abandoned (the generation moved on) is dropped
            obs = float(self.get_outputs()[0]._data.double().mean())
            if obs == obs and abs(obs) != float("inf") \
                    and gen == sup.generation:
                self.update()
            return obs

        def run_epoch(epoch, sup=None):
            tic = time.time()
            eval_metric.reset()
            if sup is None or not sup.resume_step(epoch):
                # a mid-epoch capsule restore put train_data at the next
                # batch: a reset would feed the epoch's head again
                train_data.reset()
            for nbatch, data_batch in enumerate(train_data):
                if monitor is not None:
                    monitor.tic()
                if sup is None:
                    one_batch(data_batch)
                else:
                    sup.step(lambda: sentinel_batch(data_batch, sup))
                self.update_metric(eval_metric, data_batch.label)
                if monitor is not None:
                    monitor.toc_print()
                if batch_end_callback is not None:
                    for cb in _as_list(batch_end_callback):
                        cb(BatchEndParam(epoch, nbatch, eval_metric,
                                         locals()))
            for name, val in eval_metric.get_name_value():
                self.logger.info("Epoch[%d] Train-%s=%f", epoch, name, val)
            self.logger.info("Epoch[%d] Time cost=%.3f", epoch,
                             time.time() - tic)
            if epoch_end_callback is not None:
                arg_p, aux_p = self.get_params()
                for cb in _as_list(epoch_end_callback):
                    cb(epoch, self.symbol, arg_p, aux_p)
            if eval_data is not None:
                res = self.score(eval_data, validation_metric, epoch=epoch,
                                 batch_end_callback=eval_batch_end_callback)
                for name, val in res:
                    self.logger.info("Epoch[%d] Validation-%s=%f", epoch,
                                     name, val)

        if supervised is None:
            for epoch in range(begin_epoch, num_epoch):
                run_epoch(epoch)
            return None
        from .. import supervisor as _supervisor
        sup = _supervisor.for_module(self, supervised, train_data=train_data)
        return sup.run(lambda epoch: run_epoch(epoch, sup=sup),
                       begin_epoch=begin_epoch, num_epoch=num_epoch)


def _as_list(x):
    return x if isinstance(x, (list, tuple)) else [x]


class BatchEndParam:
    def __init__(self, epoch, nbatch, eval_metric, locals_=None):
        self.epoch = epoch
        self.nbatch = nbatch
        self.eval_metric = eval_metric
        self.locals = locals_


class Module(BaseModule):
    """A module of one symbol."""

    def __init__(self, symbol, data_names=("data",),
                 label_names=("softmax_label",), logger=logging,
                 context=None, work_load_list=None, fixed_param_names=None,
                 state_names=None):
        super().__init__(logger)
        if not isinstance(symbol, Symbol):
            raise MXNetError("Module requires a Symbol")
        self._symbol = symbol
        self._data_names = list(data_names)
        self._label_names = list(label_names or [])
        ctxs = context if context is not None else [current_context()]
        self._contexts = list(ctxs) if isinstance(ctxs, (list, tuple)) \
            else [ctxs]
        self._fixed_param_names = set(fixed_param_names or [])
        self._param_names = [n for n in symbol.list_arguments()
                             if n not in self._data_names
                             and n not in self._label_names]
        self._aux_names = symbol.list_auxiliary_states()
        self._exec = None
        self._optimizer = None
        self._updater_states = {}
        self._data_shapes = None
        self._label_shapes = None

    @property
    def symbol(self):
        return self._symbol

    @property
    def data_names(self):
        return list(self._data_names)

    @property
    def label_names(self):
        return list(self._label_names)

    @property
    def output_names(self):
        return self._symbol.list_outputs()

    @property
    def data_shapes(self):
        return self._data_shapes

    @property
    def label_shapes(self):
        return self._label_shapes

    @property
    def output_shapes(self):
        if not self.binded:
            raise MXNetError("module not bound")
        shapes = {d.name: d.shape for d in
                  (self._data_shapes or []) + (self._label_shapes or [])}
        _, out_shapes, _ = self._symbol.infer_shape(**shapes)
        return list(zip(self.output_names, out_shapes))

    # -- bind -----------------------------------------------------------------
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        if self.binded and not force_rebind:
            return
        self._data_shapes = _as_descs(data_shapes)
        self._label_shapes = _as_descs(label_shapes)
        shapes = {d.name: d.shape
                  for d in self._data_shapes + self._label_shapes}
        req = {}
        for n in self._symbol.list_arguments():
            if n in self._data_names:
                req[n] = "write" if inputs_need_grad else "null"
            elif n in self._label_names or n in self._fixed_param_names:
                req[n] = "null"
            else:
                req[n] = grad_req if for_training else "null"
        ex = self._symbol.simple_bind(self._contexts[0], grad_req=req,
                                      **shapes)
        if shared_module is not None and shared_module._exec is not None:
            # the default bucket's arrays themselves: an update of one is
            # an update of every bucket's
            for n in self._param_names:
                if n in shared_module._exec.arg_dict:
                    ex.arg_dict[n] = shared_module._exec.arg_dict[n]
            for n in self._aux_names:
                if n in shared_module._exec.aux_dict:
                    ex.aux_dict[n] = shared_module._exec.aux_dict[n]
        self._exec = ex
        self.binded = True
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad

    # -- parameters -----------------------------------------------------------
    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False,
                    allow_extra=False):
        if self.params_initialized and not force_init:
            return
        if not self.binded:
            raise MXNetError("call bind before init_params")
        initializer = initializer or _init_mod.Uniform(0.01)
        preloaded = getattr(self, "_preloaded", None)
        if preloaded is not None and arg_params is None:
            arg_params, aux_params = preloaded
        dev = self._exec._device

        def sample(n, shape):
            if isinstance(initializer, _init_mod.Initializer):
                return initializer(n, tuple(shape), torch.float32,
                                   _random.generator(dev))
            return initializer(n, shape)

        for n in self._param_names:
            if arg_params and n in arg_params:
                self._set_param(self._exec.arg_dict, n, arg_params[n])
            else:
                if arg_params is not None and not allow_missing:
                    raise MXNetError(f"missing parameter '{n}' "
                                     "(pass allow_missing=True to initialize)")
                self._set_param(self._exec.arg_dict, n,
                                sample(n, self._exec.arg_dict[n].shape))
        for n in self._aux_names:
            if aux_params and n in aux_params:
                self._set_param(self._exec.aux_dict, n, aux_params[n])
            else:
                if aux_params is not None and not allow_missing:
                    raise MXNetError(f"missing aux state '{n}' "
                                     "(pass allow_missing=True to initialize)")
                self._set_param(self._exec.aux_dict, n,
                                sample(n, self._exec.aux_dict[n].shape))
        self.params_initialized = True

    def _set_param(self, d, name, value):
        """Write ``value`` (an array, tensor or numpy array) into ``d``'s
        array ``name`` (rebinding it, so shared handles see it)."""
        if isinstance(value, NDArray):
            t = value._data.detach()
        elif isinstance(value, torch.Tensor):
            t = value.detach()
        else:
            t = array(value, ctx=self._contexts[0])._data
        if name in d:
            old = d[name]._data
            d[name]._rebind(t.to(device=old.device, dtype=old.dtype,
                                 copy=True))
        else:
            d[name] = NDArray(t.to(self._exec._device, copy=True))

    def get_params(self):
        arg = {n: self._exec.arg_dict[n].copy() for n in self._param_names}
        aux = {n: self._exec.aux_dict[n].copy() for n in self._aux_names}
        return arg, aux

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True, allow_extra=False):
        self.init_params(initializer=None, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init, allow_extra=allow_extra)

    # -- optimizer ------------------------------------------------------------
    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        if self.optimizer_initialized and not force_init:
            return
        if isinstance(optimizer, _opt_mod.Optimizer):
            self._optimizer = optimizer
        else:
            self._optimizer = _opt_mod.create(optimizer,
                                              **dict(optimizer_params))
        # lr_mult/wd_mult by name need the index -> name map
        idx2name = dict(enumerate(self._param_names))
        if getattr(self._optimizer, "idx2name", None):
            self._optimizer.idx2name.update(idx2name)
        else:
            self._optimizer.idx2name = idx2name
        self._updater_states = {}
        for i, n in enumerate(self._param_names):
            self._updater_states[n] = \
                self._optimizer.create_state_multi_precision(
                    i, self._exec.arg_dict[n])
        preload = getattr(self, "_preload_opt", None)
        if preload is not None:
            self.load_optimizer_states(preload)
            self._preload_opt = None
        self.optimizer_initialized = True

    # -- a step ---------------------------------------------------------------
    def forward(self, data_batch, is_train=None):
        if not self.binded or not self.params_initialized:
            raise MXNetError("bind and init_params before forward")
        if is_train is None:
            is_train = self.for_training
        ctx = self._contexts[0]
        own = lambda a: a.as_in_context(ctx) if isinstance(a, NDArray) \
            else array(a, ctx=ctx)
        feeds = dict(zip(self._data_names, map(own, data_batch.data)))
        if data_batch.label:
            feeds.update(zip(self._label_names,
                             map(own, data_batch.label)))
        self._exec.forward(is_train=is_train, **feeds)

    def backward(self, out_grads=None):
        self._exec.backward(out_grads=out_grads)

    def update(self):
        if not self.optimizer_initialized:
            raise MXNetError("init_optimizer before update")
        for i, n in enumerate(self._param_names):
            g = self._exec.grad_dict.get(n)
            if g is None:
                continue
            self._updater_states[n] = self._optimizer.update_multi_precision(
                i, self._exec.arg_dict[n], g, self._updater_states[n])

    def get_outputs(self, merge_multi_context=True):
        return list(self._exec.outputs)

    def get_input_grads(self, merge_multi_context=True):
        if not self.inputs_need_grad:
            raise MXNetError("bind with inputs_need_grad=True first")
        return [self._exec.grad_dict[n] for n in self._data_names]

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        eval_metric.update(labels, self.get_outputs())

    # -- checkpoints ----------------------------------------------------------
    def save_checkpoint(self, prefix, epoch, save_optimizer_states=False,
                        extra_files=()):
        """``extra_files``: sidecars already written (a training capsule)
        for the epoch's manifest to list and verify."""
        from ..model import save_checkpoint
        arg, aux = self.get_params()
        save_checkpoint(prefix, epoch, self._symbol, arg, aux,
                        extra_files=extra_files)
        if save_optimizer_states:
            from ..checkpoint import update_manifest
            states = f"{prefix}-{epoch:04d}.states"
            self.save_optimizer_states(states)
            # into the epoch's committed manifest: verified with it
            update_manifest(prefix, epoch, [states])

    @staticmethod
    def load(prefix, epoch, load_optimizer_states=False, **kwargs):
        from ..model import load_checkpoint
        sym, arg, aux = load_checkpoint(prefix, epoch)
        mod = Module(sym, **kwargs)
        mod._preloaded = (arg, aux)
        mod._preload_opt = (f"{prefix}-{epoch:04d}.states"
                            if load_optimizer_states else None)
        return mod

    def save_optimizer_states(self, fname):
        """The optimizer's states as the reference pickles them: a dict by
        parameter name of trees of numpy arrays."""
        from ..checkpoint import atomic_write
        from ..resume import _np_tree
        with atomic_write(fname) as f:
            f.write(pickle.dumps(_np_tree(self._updater_states)))

    def load_optimizer_states(self, fname):
        from ..resume import _torch_tree
        with open(fname, "rb") as f:
            states = _torch_tree(pickle.load(f))
        dev = self._exec._device
        self._updater_states = {n: _to_device(s, dev)
                                for n, s in states.items()}


def _to_device(tree, dev):
    if isinstance(tree, torch.Tensor):
        return tree.to(dev)
    if isinstance(tree, tuple):
        return tuple(_to_device(v, dev) for v in tree)
    if isinstance(tree, list):
        return [_to_device(v, dev) for v in tree]
    return tree


class BucketingModule(BaseModule):
    """One executor a bucket, the parameters the default bucket's arrays
    themselves, so that an update is seen by every bucket (the symbolic
    variable-length path)."""

    def __init__(self, sym_gen, default_bucket_key=None, logger=logging,
                 context=None, fixed_param_names=None, state_names=None):
        super().__init__(logger)
        self._sym_gen = sym_gen
        self._default_bucket_key = default_bucket_key
        self._context = context
        self._fixed_param_names = fixed_param_names
        self._buckets = {}
        self._curr_module = None
        self._curr_bucket_key = None

    @property
    def symbol(self):
        return self._curr_module.symbol

    def _gen_module(self, bucket_key):
        sym, data_names, label_names = self._sym_gen(bucket_key)
        return Module(sym, data_names=data_names, label_names=label_names,
                      logger=self.logger, context=self._context,
                      fixed_param_names=self._fixed_param_names)

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, **kwargs):
        if self.binded and not force_rebind:
            return
        self._buckets = {}   # old buckets hold the old arrays
        mod = self._gen_module(self._default_bucket_key)
        mod.bind(data_shapes, label_shapes, for_training, inputs_need_grad)
        self._buckets[self._default_bucket_key] = mod
        self._curr_module = mod
        self._curr_bucket_key = self._default_bucket_key
        self.binded = True
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad

    def switch_bucket(self, bucket_key, data_shapes, label_shapes=None):
        """``data_shapes``/``label_shapes`` may be bare shapes: they are
        paired with the new bucket's own input names."""
        if bucket_key not in self._buckets:
            default = self._buckets[self._default_bucket_key]
            mod = self._gen_module(bucket_key)
            if data_shapes and not isinstance(data_shapes[0], DataDesc) \
                    and not isinstance(data_shapes[0][0], str):
                data_shapes = list(zip(mod.data_names, data_shapes))
                if label_shapes:
                    label_shapes = list(zip(mod.label_names, label_shapes))
            mod.bind(data_shapes, label_shapes, self.for_training,
                     self.inputs_need_grad, shared_module=default)
            extra = [n for n in mod._param_names
                     if n not in default._exec.arg_dict]
            if extra:
                raise MXNetError(
                    f"bucket {bucket_key!r} introduces parameters {extra} "
                    "absent from the default bucket — all parameters must "
                    "exist in the default bucket's symbol for sharing")
            mod.params_initialized = default.params_initialized
            mod._optimizer = default._optimizer
            mod._updater_states = default._updater_states
            mod.optimizer_initialized = default.optimizer_initialized
            self._buckets[bucket_key] = mod
        self._curr_module = self._buckets[bucket_key]
        self._curr_bucket_key = bucket_key

    def init_params(self, **kwargs):
        self._curr_module.init_params(**kwargs)
        self.params_initialized = True

    def init_optimizer(self, **kwargs):
        self._curr_module.init_optimizer(**kwargs)
        for mod in self._buckets.values():
            mod._optimizer = self._curr_module._optimizer
            mod._updater_states = self._curr_module._updater_states
            mod.optimizer_initialized = True
        self.optimizer_initialized = True

    def forward(self, data_batch, is_train=None):
        key = getattr(data_batch, "bucket_key", self._default_bucket_key)
        if key != self._curr_bucket_key:
            self.switch_bucket(
                key, [tuple(d.shape) for d in data_batch.data],
                [tuple(d.shape) for d in data_batch.label]
                if data_batch.label else None)
        self._curr_module.forward(data_batch, is_train=is_train)

    def backward(self, out_grads=None):
        self._curr_module.backward(out_grads)

    def update(self):
        # every bucket holds the one _updater_states dict, which
        # Module.update changes in place
        self._curr_module.update()

    def get_outputs(self, merge_multi_context=True):
        return self._curr_module.get_outputs()

    def get_params(self):
        return self._curr_module.get_params()

    def set_params(self, arg_params, aux_params, **kwargs):
        self._curr_module.set_params(arg_params, aux_params, **kwargs)
        self.params_initialized = True

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        self._curr_module.update_metric(eval_metric, labels)

    def save_checkpoint(self, prefix, epoch, save_optimizer_states=False,
                        extra_files=()):
        self._curr_module.save_checkpoint(prefix, epoch,
                                          save_optimizer_states,
                                          extra_files=extra_files)
