"""Gluon ``Trainer``, from ``tpu_mx/gluon/trainer.py``.

``Trainer(net.collect_params(), "sgd", {"learning_rate": 0.05})`` holds
the :class:`~tpu_mx_torch.gluon.Parameter` handles, not their tensors, so
it can be built before a deferred net's first forward.  ``step(batch)``
sets the optimizer's ``rescale_grad`` to ``1/batch`` (the loss's
per-example values were summed by ``backward()``), pushes the gradients
to the kvstore and pulls the aggregates back into them (``kvstore="device"``,
the default, sums one copy and checks its checksum; a ``dist_*`` store sums
across the launcher's workers; ``compression_params`` compresses the
push; None skips the store), and updates every parameter with
``grad_req != "null"`` in place, under ``torch.no_grad()``: with
``multi_precision`` a float16/bfloat16 parameter is the cast of a
float32 master kept in its state.  ``update_on_kvstore`` is kept and, as
in the reference, changes nothing: the update runs here.  The
update is one eager loop over the parameters; a fused multi-tensor
update is open work (ROADMAP A5).
"""
from __future__ import annotations

import contextlib
import importlib
import pickle

import numpy as np
import torch

from .. import optimizer as _opt
from ..base import MXNetError
from ..kvstore import create as _kv_create

__all__ = ["Trainer"]


class _Bf16Type:
    """Pickles as ``ml_dtypes.bfloat16`` (the numpy type of the
    reference's bfloat16 arrays) without importing ``ml_dtypes``: the
    reader looks the type up when it loads the file."""

    def __reduce__(self):
        return getattr, (_MlDtypes(), "bfloat16")


class _MlDtypes:
    def __reduce__(self):
        return importlib.import_module, ("ml_dtypes",)


class _Bf16Array:
    """A bfloat16 tensor, pickled as the reference's numpy array of
    ``ml_dtypes.bfloat16``: ``numpy.ndarray(shape, bfloat16, raw)``."""

    def __init__(self, t):
        self.shape = tuple(t.shape)
        self.raw = t.contiguous().view(torch.int16).numpy().tobytes()

    def __reduce__(self):
        return np.ndarray, (self.shape, _Bf16Type(), self.raw)


class _Bf16Marker:
    """What the reader takes ``ml_dtypes.bfloat16`` (the module's type,
    and the numpy dtype built from it) for; numpy's pickle sets a dtype's
    state, which it ignores."""

    bfloat16 = None             # the stand-in module's attribute: itself

    def __setstate__(self, state):
        pass


_BF16 = _Bf16Marker()
_Bf16Marker.bfloat16 = _BF16


def _bf16_tensor(shape, raw):
    words = np.frombuffer(raw, np.int16).reshape(shape)
    return torch.from_numpy(words.copy()).view(torch.bfloat16)


class _Array:
    """An array of the file, rebuilt by numpy's ``__setstate__`` protocol:
    a bfloat16 one as a bfloat16 tensor, any other as a numpy array."""

    def __init__(self, *args):
        self.value = None

    def __setstate__(self, state):
        _, shape, dtype, _, raw = state
        if dtype is _BF16:
            self.value = _bf16_tensor(shape, raw)
        else:
            a = np.empty(0)
            a.__setstate__(state)
            self.value = a


class _StatesUnpickler(pickle.Unpickler):
    """Reads either package's states file with or without ``ml_dtypes``:
    the reference's numpy pickles (``_reconstruct`` then the array's
    state) and the port's ``numpy.ndarray(shape, bfloat16, raw)``."""

    def find_class(self, module, name):
        if module.split(".")[0] == "ml_dtypes" and name == "bfloat16":
            return _BF16
        if module in ("numpy._core.multiarray", "numpy.core.multiarray") \
                and name == "_reconstruct":
            return _Array
        if module == "numpy" and name == "dtype":
            return lambda obj, *a: obj if obj is _BF16 else np.dtype(obj, *a)
        if module == "numpy" and name == "ndarray":
            return lambda *a: _bf16_tensor(a[0], a[2]) \
                if len(a) == 3 and a[1] is _BF16 else np.ndarray(*a)
        if module == "importlib" and name == "import_module":
            return lambda mod: _BF16 if mod == "ml_dtypes" \
                else importlib.import_module(mod)
        return super().find_class(module, name)


_LOW_PRECISION = (torch.float16, torch.bfloat16)


def _has_pure_core(cls):
    """The optimizer overrides ``update_core`` and neither ``update`` nor
    ``update_multi_precision``: the reference's test for its fused
    step."""
    base = _opt.Optimizer
    return cls.update_core is not base.update_core \
        and cls.update is base.update \
        and cls.update_multi_precision is base.update_multi_precision


class _WideLowPrecision(torch.overrides.TorchFunctionMode):
    """The reference's fused step is one XLA program, and XLA lets a
    value keep more precision than its type: a float16/bfloat16 result
    that the next operation converts to float32 is not rounded in
    between.  Under this mode each low-precision result is still the
    rounded tensor, and its float32 value is kept beside it (a cast down
    keeps its source); an operation that promotes a low-precision
    operand to float32 reads the kept value instead.  Operations among
    low-precision tensors see the rounded values, as XLA's do."""

    def __init__(self):
        super().__init__()
        self._wide = {}

    def _kept(self, t):
        got = self._wide.get(id(t))
        return got[1] if got is not None and got[0] is t else None

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not isinstance(out, torch.Tensor) or not out.is_floating_point():
            return out
        floats = [a for a in args if isinstance(a, torch.Tensor)
                  and a.is_floating_point()]
        if out.dtype in _LOW_PRECISION:
            if len(floats) == 1 and floats[0].dtype == torch.float32:
                wide = floats[0]                        # a cast down
            elif floats and all(a.dtype == out.dtype for a in floats):
                wide = func(*[a.float() if isinstance(a, torch.Tensor)
                              and a.is_floating_point() else a
                              for a in args], **kwargs)
            else:
                return out
            if isinstance(wide, torch.Tensor) \
                    and wide.dtype == torch.float32:
                self._wide[id(out)] = (out, wide)
            return out
        if out.dtype == torch.float32 and any(
                self._kept(a) is not None for a in floats):
            out = func(*[self._kept(a) if isinstance(a, torch.Tensor)
                         and self._kept(a) is not None else a
                         for a in args], **kwargs)
        return out


def _leaves(state):
    """The tensors of a state tree."""
    if isinstance(state, torch.Tensor):
        return [state]
    if isinstance(state, (tuple, list)):
        return [t for s in state for t in _leaves(s)]
    return []


def _shaped_like(new, old):
    """A state tree ``new`` with each tensor in the shape of its
    counterpart in ``old`` (a 0-d state broadcast to ``(1,)`` by the
    fused step's scalars)."""
    if isinstance(new, torch.Tensor):
        return new.reshape(old.shape)
    if isinstance(new, (tuple, list)):
        return type(new)(_shaped_like(n, o) for n, o in zip(new, old))
    return new


def _to_file(state):
    """A state tree with its tensors as the reference's numpy arrays."""
    if isinstance(state, torch.Tensor):
        t = state.detach().cpu()
        return _Bf16Array(t) if t.dtype == torch.bfloat16 else t.numpy()
    if isinstance(state, (tuple, list)):
        return type(state)(_to_file(s) for s in state)
    return state


def _from_file(state, like):
    """A read state tree as tensors on ``like``'s device, each laid out
    as ``like`` where its shape is ``like``'s."""
    if isinstance(state, _Array):
        state = state.value
    if isinstance(state, np.ndarray):
        state = torch.from_numpy(np.array(state))
    if isinstance(state, torch.Tensor):
        if state.shape == like.shape:
            return torch.empty_like(like, dtype=state.dtype).copy_(state)
        return state.to(like.device)
    if isinstance(state, (tuple, list)):
        return tuple(_from_file(s, like) for s in state)
    return state


class Trainer:
    """Applies an optimizer to a set of parameters through a kvstore (the
    reference's ``gluon.Trainer``): ``kvstore`` is a store type
    (``mx.kv.create``), a ``KVStore`` or None."""

    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device", compression_params=None,
                 update_on_kvstore=None, fuse_update=True):
        if hasattr(params, "values"):
            params = list(params.values())
        self._params = [p for p in params if p.grad_req != "null"]
        self._optimizer = _opt.create(optimizer, **(optimizer_params or {})) \
            if isinstance(optimizer, str) else optimizer
        self._optimizer.param_dict = dict(enumerate(self._params))
        self._states = [None] * len(self._params)
        self._states_inited = [False] * len(self._params)
        self._kvstore = _kv_create(kvstore) \
            if isinstance(kvstore, str) and kvstore else kvstore
        self._compression_params = compression_params
        if compression_params and self._kvstore:
            self._kvstore.set_gradient_compression(compression_params)
        self._update_on_kvstore = update_on_kvstore
        self._kv_initialized = False
        self._scale = 1.0
        self._fuse_update = fuse_update

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

    def _init_kvstore(self):
        if self._kvstore:
            for i, p in enumerate(self._params):
                self._kvstore.init(i, p.data())
        self._kv_initialized = True

    def step(self, batch_size, ignore_stale_grad=False):
        """Rescale the gradients by ``1/batch_size``, reduce them and
        update every parameter."""
        self._check_initialized()
        if not self._kv_initialized:
            self._init_kvstore()
        self._optimizer.rescale_grad = self._scale / batch_size
        self.allreduce_grads()
        self.update(batch_size, ignore_stale_grad)

    def allreduce_grads(self):
        """Push every gradient to the kvstore and pull the aggregates back
        into the parameters' gradients: one push and one pull of all the
        keys, so the store checks them together."""
        if not self._kvstore:
            return
        keys = list(range(len(self._params)))
        grads = [p.grad for p in self._params]
        self._kvstore.push(keys, grads)
        self._kvstore.pull(keys, grads)

    def update(self, batch_size, ignore_stale_grad=False):
        """Apply the optimizer to every parameter (after
        :meth:`allreduce_grads`): the fused step or one call per
        parameter, as the module's docstring says."""
        self._check_initialized()
        opt = self._optimizer
        for i, p in enumerate(self._params):
            if not self._states_inited[i]:
                self._states[i] = opt.create_state_multi_precision(
                    i, p.data())
                self._states_inited[i] = True
        if self._fuse_update and _has_pure_core(type(opt)) \
                and len(self._params) > 1:
            self._update_fused()
            return
        for i, p in enumerate(self._params):
            self._states[i] = opt.update_multi_precision(i, p.data(), p.grad,
                                                         self._states[i])

    def _update_fused(self):
        """The reference's fused step (``tpu_mx/gluon/trainer.py``
        ``_update_fused``) as one eager loop.  ``lr``, ``wd`` and ``t``
        are shape-``(1,)`` float32 tensors: a 0-d tensor would not
        promote a bfloat16 operand in torch, a dimensioned one does, as
        jax's float32 0-d array does.  They reach each device in one copy
        a step.  The results take back the shapes of the weight and state
        they replace."""
        opt = self._optimizer
        n = len(self._params)
        for i in range(n):
            opt._update_count(i)
        rows = torch.tensor([[opt._get_lr(i), opt._get_wd(i),
                              opt._index_update_count[i]] for i in range(n)],
                            dtype=torch.float32)
        scalars = {}
        with torch.no_grad():
            for i, p in enumerate(self._params):
                w = p.data()._data
                if w.device not in scalars:
                    scalars[w.device] = rows.to(w.device)
                row = scalars[w.device][i]
                lr, wd, t = row[0:1], row[1:2], row[2:3]
                grad = p.grad._data
                state = self._states[i]
                if opt.multi_precision and w.dtype in _LOW_PRECISION:
                    master, inner = state
                    new_master, new_inner = opt.update_core(
                        master, grad.float(), inner, lr, wd, t)
                    new_master = new_master.reshape(master.shape)
                    w.copy_(new_master)
                    self._states[i] = (new_master,
                                       _shaped_like(new_inner, inner))
                    continue
                low = w.dtype in _LOW_PRECISION or any(
                    s.dtype in _LOW_PRECISION for s in _leaves(state))
                with _WideLowPrecision() if low else contextlib.nullcontext():
                    new_w, new_state = opt.update_core(w, grad, state, lr,
                                                       wd, t)
                w.copy_(new_w.reshape(w.shape))
                self._states[i] = _shaped_like(new_state, state)

    def save_states(self, fname):
        """The optimizer's state and update counts in the reference's
        file: a pickled dict of ``states`` (a tree of numpy arrays, a
        bfloat16 one as an ``ml_dtypes.bfloat16`` array), ``states_inited``,
        ``num_update`` and ``index_update_count``, committed whole
        through ``checkpoint.atomic_write``.  Either package reads the
        other's."""
        from ..checkpoint import atomic_write
        payload = {"states": [_to_file(s) for s in self._states],
                   "states_inited": list(self._states_inited),
                   "num_update": self._optimizer.num_update,
                   "index_update_count":
                       dict(self._optimizer._index_update_count)}
        with atomic_write(fname) as f:
            f.write(pickle.dumps(payload))

    def load_states(self, fname):
        """Read a :meth:`save_states` file of either package (no
        ``ml_dtypes`` needed) onto the parameters' devices."""
        with open(fname, "rb") as f:
            payload = _StatesUnpickler(f).load()
        self._check_initialized()
        self._states = [_from_file(s, p._tensor())
                        for s, p in zip(payload["states"], self._params)]
        self._states_inited = list(payload["states_inited"])
        self._optimizer.num_update = payload["num_update"]
        self._optimizer._index_update_count = \
            dict(payload["index_update_count"])
