"""Gluon ``Block`` / ``HybridBlock``, from ``tpu_mx/gluon/block.py``.

The port's blocks are :class:`torch.nn.Module`s.  A trainable tensor is
a :class:`torch.nn.Parameter`; a running statistic (BatchNorm's
``running_mean``/``running_var``, the reference's ``grad_req="null"``
parameters) is a buffer; :class:`~tpu_mx_torch.gluon.parameter.Parameter`
is the reference's handle onto either, and what a declared slot's
attribute (``net.weight``) gives outside a forward, as in the
reference; inside a forward it gives the tensor.  A layer declares each tensor
with :meth:`Block._declare`: its reference name and shape, its own
initializer and, where the port stores it in another order (a
channels-last convolution's weight), the axes that take the reference's
array to it.  A tensor whose shape is known is drawn at construction
(with the layer's initializer, or the reference's default
``Uniform(0.07)``); one with an unknown input size (``in_units=0``) is
drawn at the first forward, after ``initialize()``.

Calling a block with :class:`~tpu_mx_torch.ndarray.NDArray` arguments is
the imperative boundary: a :class:`HybridBlock` unwraps them, sets every
module's training mode from ``autograd.is_training()``, runs its forward
on tensors under ``torch.set_grad_enabled(autograd.is_recording())`` and
wraps what it returns.  Called with tensors (inside another block, or by
``CompiledTrainStep``) it is a plain ``nn.Module`` call.  A
:class:`Block` (a ``forward`` written on arrays) passes its arguments on
as they are.

Parameters carry the reference's per-instance names (``dense0_weight``).
``collect_params()`` lists them in the reference's order (each block's
own parameters, then its own running statistics, then its children in
the order they were added, depth first), keyed by structural name
(``0.weight``, as the port's earlier slices keyed it; a parameter is
found by its name too).  ``save_parameters`` writes the reference's
``.npz`` container under the reference's keys (the attribute paths of
its ``_collect_params_with_prefix``, which are the structural names),
each array in the reference's shape (a channels-last convolution's
weight ``(O, kh, kw, I)``), so a ``.params`` file crosses between the
packages both ways.

``hybridize()`` keeps the reference's observable contract (the flag; the
first call resolves deferred shapes; the results are those of the
unhybridized forward) and runs the same eager forward: capture into a
CUDA graph is open work (ROADMAP A8), and ``optimize_for`` refuses by
name.  ``HybridBlock.export`` writes the predict-mode forward through
``torch.export`` (a ``.pt2`` program beside the reference's ``.params``
container), and ``SymbolBlock.imports`` runs it.
"""
from __future__ import annotations

import contextlib
import functools
import threading

import numpy as np
import torch
from torch import nn

from .. import autograd
from .. import device as _device
from .. import initializer as _init
from .. import random as _random
from ..base import MXNetError, refuse_unported
from ..context import current_context
from ..ndarray.ndarray import NDArray
from ..ndarray.ops import _holds_array, _unwrap, _wrap
from ..ndarray.traced import TracedArray, plain, traced
from .parameter import Parameter, ParameterDict, _incomplete

__all__ = ["Block", "HybridBlock", "SymbolBlock", "HookHandle", "as_dtype",
           "default_generator", "load_numpy", "resolve_remat_policy",
           "REMAT_POLICIES"]

_DTYPES = {"float32": torch.float32, "float16": torch.float16,
           "bfloat16": torch.bfloat16, "float64": torch.float64}

_NAME_COUNTER = {}
_NAME_LOCK = threading.Lock()


def _gen_prefix(hint):
    """The reference's per-instance prefix: ``dense0_``, ``dense1_``..."""
    with _NAME_LOCK:
        idx = _NAME_COUNTER.get(hint, 0)
        _NAME_COUNTER[hint] = idx + 1
    return f"{hint}{idx}_"


def as_dtype(dtype):
    """A :class:`torch.dtype` from a reference dtype name or a dtype."""
    return _DTYPES[dtype] if isinstance(dtype, str) else dtype


def default_generator(generator):
    """``generator``, or with None the process's generator for the
    current context's device (:func:`tpu_mx_torch.random.generator`; the
    card unless ``with mx.cpu():``), which raises without a card."""
    if generator is not None:
        return generator
    return _random.generator(_device.resolve(current_context()))


def _reg_params(owner):
    """``owner``'s ``{leaf: Parameter}``, made on first use for a plain
    ``nn.Module``."""
    reg = owner.__dict__.get("_reg_params")
    if reg is None:
        reg = owner.__dict__["_reg_params"] = {}
    return reg


def _prefix_of(owner):
    prefix = owner.__dict__.get("_prefix")
    if prefix is None:
        prefix = owner.__dict__["_prefix"] = _gen_prefix(
            type(owner).__name__.lower())
    return prefix


def _wrap_slot(owner, leaf, t, aux):
    """A :class:`Parameter` over a tensor a plain module registered."""
    p = Parameter(_prefix_of(owner) + leaf,
                  grad_req="write" if t.requires_grad else "null",
                  shape=tuple(t.shape), dtype=t.dtype)
    p._owner, p._leaf, p._aux = owner, leaf, aux
    if not aux:
        autograd._register(p._nd())
    _reg_params(owner)[leaf] = p
    return p


def _slots(module):
    """``(structural name, Parameter)`` for every slot of ``module``
    (deferred ones included), in the reference's order, each tensor
    once."""
    seen = set()
    for path, owner in module.named_modules():
        reg = _reg_params(owner)
        for aux, slots in ((False, owner._parameters), (True, owner._buffers)):
            for leaf, t in list(slots.items()):
                p = reg.get(leaf)
                if p is None:
                    if t is None:
                        continue
                    p = _wrap_slot(owner, leaf, t, aux)
                key = id(t) if t is not None else id(p)
                if key in seen:
                    continue
                seen.add(key)
                yield (f"{path}.{leaf}" if path else leaf), p


def load_numpy(module, params):
    """Set every parameter and running statistic of ``module`` from
    ``params``, the reference's ``collect_params()`` as numpy arrays in
    the reference's (structural) order.  Reference names carry
    per-instance prefixes (``conv2d3_weight``), so the i-th array goes to
    the i-th slot of the module (deferred ones included: they take the
    array's shape), after checking that its name ends in the slot's name
    and that the shapes agree: every array is consumed once and every
    slot is set.  A tensor the port stores in another order (a
    channels-last convolution's weight, the reference's ``(O, kh, kw,
    I)``) takes the array transposed."""
    ours = list(_slots(module))
    theirs = list(params.items())
    if len(ours) != len(theirs):
        raise MXNetError(f"from_numpy: {len(theirs)} arrays for "
                         f"{len(ours)} parameters")
    with torch.no_grad():
        for (name, p), (ref, arr) in zip(ours, theirs):
            leaf = p._leaf
            if not (ref == leaf or ref.endswith(("_" + leaf, "." + leaf))):
                raise MXNetError(f"from_numpy: array {ref!r} does not "
                                 f"match parameter {name!r}")
            arr = np.array(arr, dtype=np.float32)
            t = p._tensor()
            if t is None:
                p.set_data(arr)
                continue
            if p._axes is not None and arr.ndim == len(p._axes):
                arr = arr.transpose(p._axes)
            if tuple(arr.shape) != tuple(t.shape):
                raise MXNetError(f"from_numpy: {ref!r} has shape "
                                 f"{arr.shape}, {name!r} wants "
                                 f"{tuple(t.shape)}")
            t.copy_(torch.from_numpy(arr))
    return module


# -- remat ------------------------------------------------------------------
#: The policies of ``jax.checkpoint_policies`` the port maps onto
#: selective checkpointing: which outputs of a remat segment are kept.
#: "Products" are cuBLAS's (``mm``/``addmm``, and the batched
#: ``bmm``/``baddbmm``) and the flash forward's; a product with no batch
#: dimensions is a 2-D ``mm``/``addmm`` (a dense layer's).
REMAT_POLICIES = ("everything_saveable", "nothing_saveable", "dots_saveable",
                  "checkpoint_dots", "dots_with_no_batch_dims_saveable",
                  "checkpoint_dots_with_no_batch_dims")


def _named_policy(name):
    """The policy function of one of :data:`REMAT_POLICIES`: a
    selective-checkpoint policy ``(ctx, op, *args, **kwargs)``."""
    saved = []

    def policy(ctx, op, *args, **kwargs):
        from torch.utils.checkpoint import CheckpointPolicy
        if name == "everything_saveable":
            return CheckpointPolicy.MUST_SAVE
        if not saved and name != "nothing_saveable":
            saved.append(_saved_ops(name))
        return CheckpointPolicy.MUST_SAVE if saved and op in saved[0] \
            else CheckpointPolicy.PREFER_RECOMPUTE
    policy.__name__ = policy.__qualname__ = name
    return policy


# jax's policy factories: each takes names (or policies) and returns a
# policy.  The port's layers tag no value with a checkpoint name, so a
# name-keyed policy keeps no named value; an offloaded value is kept on
# the card.
def save_only_these_names(*names_which_can_be_saved):
    return _POLICIES["nothing_saveable"]


def save_any_names_but_these(*names_not_to_save):
    return _POLICIES["nothing_saveable"]


def save_anything_except_these_names(*names_not_to_save):
    return _POLICIES["everything_saveable"]


def save_and_offload_only_these_names(*, names_which_can_be_saved,
                                      names_which_can_be_offloaded,
                                      offload_src, offload_dst):
    return _POLICIES["nothing_saveable"]


def save_from_both_policies(policy_1, policy_2):
    def policy(ctx, op, *args, **kwargs):
        from torch.utils.checkpoint import CheckpointPolicy
        keep = (policy_1(ctx, op, *args, **kwargs),
                policy_2(ctx, op, *args, **kwargs))
        return CheckpointPolicy.MUST_SAVE \
            if CheckpointPolicy.MUST_SAVE in keep \
            else CheckpointPolicy.PREFER_RECOMPUTE
    return policy


def offload_dot_with_no_batch_dims(offload_src, offload_dst):
    return _POLICIES["dots_with_no_batch_dims_saveable"]


_POLICIES = {n: _named_policy(n) for n in REMAT_POLICIES}
_FACTORIES = {f.__name__: f for f in (
    save_only_these_names, save_any_names_but_these,
    save_anything_except_these_names, save_and_offload_only_these_names,
    save_from_both_policies, offload_dot_with_no_batch_dims)}


def resolve_remat_policy(policy):
    """``BERTModel(remat_policy=)``'s resolution, the reference's: None or
    a callable pass through, a name of ``jax.checkpoint_policies`` gives
    the port's entry of that name (a policy of :data:`REMAT_POLICIES`, or
    one of the factories, which is what jax gives too), another name
    raises the reference's ``ValueError``."""
    if policy is None or not isinstance(policy, str):
        return policy
    found = _POLICIES.get(policy) or _FACTORIES.get(policy)
    if found is None:
        raise ValueError(f"unknown remat policy {policy!r}; see "
                         f"jax.checkpoint_policies for valid names")
    return found


def _saved_ops(name):
    aten = torch.ops.aten
    if name in ("dots_with_no_batch_dims_saveable",
                "checkpoint_dots_with_no_batch_dims"):
        return {aten.mm.default, aten.addmm.default}
    from ..kernels.flash_attention import flash_forward_op
    return {aten.mm.default, aten.addmm.default, aten.bmm.default,
            aten.baddbmm.default, flash_forward_op()}


def _context_fn(policy):
    """The ``context_fn`` of ``torch.utils.checkpoint`` for a segment's
    policy (None: recompute everything).  What jax cannot call as a
    policy raises jax's ``TypeError`` here, when the segment first
    records a gradient (in the reference, when the step is traced): a
    string (``HybridBlock.remat`` hands the policy on unresolved) and an
    uncalled factory (jax calls it with a product's parameters)."""
    if isinstance(policy, str):
        raise TypeError("'str' object is not callable")
    if any(policy is f for f in _FACTORIES.values()):
        raise TypeError(f"{policy.__name__}() got an unexpected keyword "
                        "argument 'dimension_numbers'")
    if policy is None or policy is _POLICIES["nothing_saveable"]:
        return None
    from torch.utils.checkpoint import create_selective_checkpoint_contexts
    return functools.partial(create_selective_checkpoint_contexts, policy)


def _segment_generators(block, args):
    """The generators the layers of ``block`` draw from: each module's
    ``_generator``, and for one left None the process's generator of the
    inputs' device."""
    gens, default = [], False
    for m in block.modules():
        g = m.__dict__.get("_generator", False)
        if isinstance(g, torch.Generator):
            if all(g is not h for h in gens):
                gens.append(g)
        elif g is None:
            default = True
    if default:
        dev = next((a.device for a in args if isinstance(a, torch.Tensor)),
                   None)
        if dev is not None:
            g = _random.generator(dev)
            if all(g is not h for h in gens):
                gens.append(g)
    return gens


def _checkpointed(block, args, kwargs):
    """``block``'s forward as a ``torch.utils.checkpoint`` segment whose
    recomputation replays the segment's draws and leaves no trace: each
    generator is set back to its state at the segment's entry for the
    recomputation and restored afterwards (``preserve_rng_state`` covers
    PyTorch's default generators only), and the running statistics the
    recomputation moves again (BatchNorm's) are restored too."""
    from torch.utils.checkpoint import checkpoint
    gens = _segment_generators(block, args)
    bufs = list(block.buffers())
    entry = [g.get_state() for g in gens]
    first = [True]

    def run(*a):
        if first[0]:
            first[0] = False
            return nn.Module.__call__(block, *a, **kwargs)
        now = [g.get_state() for g in gens]
        held = [b.detach().clone() for b in bufs]
        for g, s in zip(gens, entry):
            g.set_state(s)
        try:
            return nn.Module.__call__(block, *a, **kwargs)
        finally:
            for g, s in zip(gens, now):
                g.set_state(s)
            with torch.no_grad():
                for b, h in zip(bufs, held):
                    b.copy_(h)

    ctx_fn = _context_fn(block._remat_policy)
    extra = {} if ctx_fn is None else {"context_fn": ctx_fn}
    return checkpoint(run, *args, use_reentrant=False, **extra)


class HookHandle:
    """Removable handle of a forward hook (``detach``/``remove``)."""

    def __init__(self, hooks_list, hook):
        self._hooks, self._hook = hooks_list, hook

    def detach(self):
        if self._hooks is not None and self._hook in self._hooks:
            self._hooks.remove(self._hook)
        self._hooks = None

    remove = detach

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.detach()


class Block(nn.Module):
    """Define-by-run block: a subclass writes ``forward`` on arrays (or
    tensors) and gets the reference's Gluon surface: a per-instance
    ``prefix``, ``params``, ``collect_params``, ``initialize``, ``cast``,
    ``save_parameters``/``load_parameters``, forward hooks."""

    def __init__(self, prefix=None, params=None):
        super().__init__()
        self._prefix = prefix if prefix is not None else \
            _gen_prefix(type(self).__name__.lower())
        self._params = ParameterDict(self._prefix, shared=params)
        self._reg_params = {}
        self._deferred = []
        self._fwd_hooks = []
        self._fwd_pre_hooks = []
        self._active = False

    def __getattr__(self, name):
        # nn.Module keeps parameters and buffers out of __dict__, so their
        # reads land here.  Outside a forward a declared slot answers with
        # its Parameter handle (``net.weight.data()``), as the reference's
        # attribute does; inside one, the tensor (the built-in layers read
        # their slots from ``_parameters``/``_buffers`` and skip this)
        if not autograd._STATE.functional:
            p = self.__dict__.get("_reg_params", {}).get(name)
            if p is not None:
                return p
        return nn.Module.__getattr__(self, name)

    def __setattr__(self, name, value):
        if isinstance(value, Parameter):
            self.__dict__.get("_reg_params", {})[name] = value
            value._bind(self, name)
            if value._tensor() is None:
                self._deferred.append(value)
            object.__setattr__(self, name, value)
        else:
            super().__setattr__(name, value)

    def _declare(self, leaf, shape, init, dtype, generator, *, aux=False,
                 grad=True, axes=None):
        """Register parameter (or, with ``aux``, running statistic)
        ``leaf`` of the reference's ``shape``, drawn by ``init`` (None:
        the default) from ``generator`` in ``dtype`` now, or at the first
        forward where ``shape`` has a 0 (an input size to infer).
        ``axes`` permutes the draw into the port's order (a view: a
        channels-last weight keeps its channels-last strides)."""
        stored = tuple(shape) if axes is None else \
            tuple(shape[a] for a in axes)
        p = Parameter(self._prefix + leaf,
                      grad_req="null" if aux or not grad else "write",
                      shape=stored, dtype=dtype, init=init,
                      allow_deferred_init=True)
        p._bind(self, leaf, aux, None if axes is None else tuple(axes))
        self._reg_params[leaf] = p
        self._params._params[p.name] = p
        if _incomplete(shape):
            self._deferred.append(p)
            return p
        data = _init.create(init)(p.name, tuple(shape), dtype, generator)
        p._set_tensor(data if axes is None else data.permute(axes))
        return p

    # -- names ----------------------------------------------------------------
    @property
    def prefix(self):
        return self._prefix

    @property
    def name(self):
        return self._prefix.rstrip("_")

    @property
    def params(self):
        """This block's own parameters (not its children's)."""
        return self._params

    def collect_params(self, select=None):
        """Every parameter of this block and its children as one
        :class:`ParameterDict`, in the reference's order, keyed by
        structural name (``0.weight``) and found by its name
        (``dense0_weight``) too; ``select`` (a regular expression) keeps
        the parameters whose names it matches, as in the reference."""
        import re
        ret = ParameterDict(self._prefix)
        pat = re.compile(select) if select is not None else None
        for key, p in _slots(self):
            if pat is None or pat.match(p.name):
                ret._add(key, p)
        return ret

    # -- parameters -----------------------------------------------------------
    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False, generator=None):
        """Draw every parameter and running statistic: each with its own
        initializer if it was given one (a layer's
        ``weight_initializer``, ``"zeros"`` for biases, ...), else with
        ``init`` (a name such as ``"xavier"``, an initializer, or None for
        ``Uniform(0.07)``), as the reference's ``initialize(init)`` does.
        Tensors that exist are drawn again in place, at the reference's
        shapes (a fan is the reference's); deferred ones record ``init``
        and are drawn at the first forward.  Draws come from
        ``generator`` (default: the process's generator for each
        tensor's device; a generator is also taken in ``ctx``'s place).
        With ``ctx`` the block moves to that device first."""
        if isinstance(ctx, torch.Generator):
            generator, ctx = ctx, None
        if ctx is not None:
            self.to(_device.resolve(ctx))
        self.collect_params().initialize(init, ctx, verbose, force_reinit,
                                         generator)
        return self

    def cast(self, dtype):
        """Cast every floating parameter and running statistic to
        ``dtype`` (``"bfloat16"`` or a :class:`torch.dtype`), as the
        reference's ``Block.cast`` does; memory formats are kept, and a
        deferred parameter is drawn in ``dtype``."""
        dt = as_dtype(dtype)
        for _, p in _slots(self):
            if p._tensor() is None:
                p._dtype = dt
        return self.to(dt)

    def name_scope(self):
        """A no-op scope, as in the reference (names come from each
        block's own prefix)."""
        return contextlib.nullcontext(self)

    def apply_fn(self, fn):
        """``fn`` on every child, depth first, then on this block (the
        reference's ``apply``; ``nn.Module.apply`` does the same)."""
        return self.apply(fn)

    def _collect_params_with_prefix(self, prefix=""):
        """``{key: Parameter}`` under the reference's keys: each block's
        attribute path, dot-joined (``features.0.weight``)."""
        pre = prefix + "." if prefix else ""
        return {pre + k: p for k, p in _slots(self)}

    def save_parameters(self, filename):
        """Every initialized tensor under its reference key
        (``features.0.weight``), in the reference's shape and
        container."""
        from ..ndarray.ndarray import save as nd_save
        nd_save(filename, {k: p._ref_view() for k, p in
                           self._collect_params_with_prefix().items()
                           if p._tensor() is not None})

    def load_parameters(self, filename, ctx=None, allow_missing=False,
                        ignore_extra=False, cast_dtype=False):
        """Set the tensors from a :meth:`save_parameters` file of either
        package, each cast to its parameter's type (``cast_dtype`` is
        taken and, as in the reference, changes nothing); a missing or
        extra name, or a shape that does not match, raises."""
        from ..ndarray.ndarray import load as nd_load
        if ctx is None:
            t = next((p._tensor() for _, p in _slots(self)
                      if p._tensor() is not None), None)
            ctx = t.device if t is not None else None
        loaded = nd_load(filename, ctx=ctx)
        params = self._collect_params_with_prefix()
        for k, p in params.items():
            if k in loaded:
                p.set_data(loaded[k])
            elif not allow_missing:
                raise MXNetError(f"Parameter {k} missing in {filename}")
        extra = set(loaded) - set(params)
        if extra and not ignore_extra:
            raise MXNetError(f"Extra params in file: {sorted(extra)}")

    save_params = save_parameters
    load_params = load_parameters

    # -- calls ----------------------------------------------------------------
    def register_child(self, block, name=None):
        """Add ``block`` as a child under ``name`` (default: the count of
        children so far), as the reference's ``Sequential`` does."""
        self.add_module(name or str(len(self._modules)), block)

    def summary(self, *inputs):
        """Run a forward on ``inputs`` and return the reference's one-line
        summary, ``"<class>: params=<count>"``."""
        self(*inputs)
        n = sum(int(np.prod(p.shape))
                for p in self.collect_params().values() if p.shape)
        return f"{type(self).__name__}: params={n}"

    def register_forward_hook(self, hook):
        """``hook(block, args, out)`` after each call, with what the
        caller passed and got."""
        self._fwd_hooks.append(hook)
        return HookHandle(self._fwd_hooks, hook)

    def register_forward_pre_hook(self, hook):
        """``hook(block, args)`` before each call."""
        self._fwd_pre_hooks.append(hook)
        return HookHandle(self._fwd_pre_hooks, hook)

    def _run(self, args, kwargs):
        return nn.Module.__call__(self, *args, **kwargs)

    def __call__(self, *args, **kwargs):
        for hook in self._fwd_pre_hooks:
            hook(self, args)
        out = self._run(args, kwargs)
        for hook in self._fwd_hooks:
            hook(self, args, out)
        return out

    def hybridize(self, active=True, **kwargs):
        """Set the hybridize flag of this block and every block under it
        (the port runs the same eager forward either way)."""
        for m in self.modules():
            if isinstance(m, Block):
                m._active = active

    def _resolve_deferred(self, args):
        """Infer and draw this block's deferred parameters from the
        first forward's inputs."""
        pending = [p for p in self._deferred if p._tensor() is None]
        if pending:
            if any(p._shape_incomplete() for p in pending):
                self.infer_shape(*args)
            tensors = [a for a in args if isinstance(a, torch.Tensor)]
            dev = tensors[0].device if tensors else \
                _device.resolve(current_context())
            for p in pending:
                p._finish_deferred_init(dev)
        self._deferred = []

    def infer_shape(self, *args):
        """Give this block's deferred parameters their shapes from
        example inputs (layers override it with their rule).  A block
        whose own parameters are deferred and that has no rule raises;
        otherwise one predict-mode forward finalizes the children."""
        own = [p.name for p in self._reg_params.values()
               if p._tensor() is None and p._shape_incomplete()]
        if own:
            raise MXNetError(
                f"{type(self).__name__} has deferred-shape parameters {own} "
                "but no infer_shape override; declare full shapes "
                "(in_units/in_channels/...) or override "
                "infer_shape(self, *args) with the block's shape rule")
        with autograd.predict_mode(), torch.no_grad():
            self(*args)

    def finalize_shapes(self, *args):
        """Draw every deferred parameter with one predict-mode forward
        over example inputs (nothing when every shape is known)."""
        if any(p._tensor() is None for p in self.collect_params().values()):
            with autograd.predict_mode(), torch.no_grad():
                self(*args)
        return self

    def optimize_for(self, *args, **kwargs):
        raise MXNetError("HybridBlock.optimize_for is not ported yet "
                         "(ROADMAP A8: hybridize runs the eager forward)")


class HybridBlock(Block):
    """Base of the port's layers, models and losses, and of user blocks
    written as ``hybrid_forward(self, F, x, **params)`` with ``F`` the
    port's ``nd`` namespace (its operators take and return tensors
    inside the forward; ``params`` are this block's own tensors by
    attribute name).  ``hybrid_forward`` gets its arguments and
    parameters as :class:`~tpu_mx_torch.ndarray.traced.TracedArray`s,
    tensors with the methods of the jax arrays the reference's traced
    path hands it (``mask.astype("float32")``), and its caller gets
    plain tensors back."""

    _remat = False
    _remat_policy = None

    def remat(self, active=True, policy=None):
        """Recompute this block's forward in the backward instead of
        keeping its activations (``torch.utils.checkpoint``), whenever it
        runs with gradients enabled; ``policy`` keeps some outputs (a
        selective-checkpoint policy function, such as
        ``resolve_remat_policy("dots_saveable")``).  As in the reference,
        the policy is kept as given: a name (a string) is not resolved
        here, and the first gradient-recording forward of the segment
        raises jax's ``TypeError`` for it.  The
        recomputation replays the draws of every generator the block's
        layers hold (dropout masks, the flash kernels' dropout seeds),
        so the gradient is the one without remat.  Returns self."""
        self._remat = bool(active)
        self._remat_policy = policy
        return self

    def _run(self, args, kwargs):
        if not kwargs and args and not autograd._STATE.functional and all(
                isinstance(a, (NDArray, torch.Tensor, np.ndarray))
                for a in args):
            # the input shapes and types of an outermost call, for export
            # (read without a fusion flush)
            self.__dict__["_last_input_avals"] = [
                (tuple(a.shape), a.dtype) for a in args]
        if self._active and not kwargs and not autograd._STATE.traced \
                and self._ready():
            # the reference's cached (traced) call: its children run
            # inside the same trace
            with autograd._trace_scope():
                return self._run_call(args, kwargs)
        return self._run_call(args, kwargs)

    def _ready(self):
        """Every parameter drawn (the reference traces a hybridized
        block's call from then on; until then it runs eagerly)."""
        if not self.__dict__.get("_all_drawn"):
            self.__dict__["_all_drawn"] = all(
                p._tensor() is not None
                for p in self.collect_params().values())
        return self.__dict__["_all_drawn"]

    def _run_call(self, args, kwargs):
        if _holds_array(args) or _holds_array(kwargs.values()):
            with torch.set_grad_enabled(autograd.is_recording()):
                self.train(autograd.is_training())
                return _wrap(self._run_tensors(
                    [_unwrap(a) for a in args],
                    {k: _unwrap(v) for k, v in kwargs.items()}))
        if any(type(a) is TracedArray for a in args) \
                or any(type(v) is TracedArray for v in kwargs.values()):
            # called from a hybrid_forward: run plain, answer in kind
            return traced(self._run_tensors(plain(list(args)), {
                k: plain(v) for k, v in kwargs.items()}))
        return self._run_tensors(args, kwargs)

    def _run_tensors(self, args, kwargs):
        if self._deferred:
            self._resolve_deferred(args)
        autograd._STATE.functional += 1
        try:
            if self._remat and torch.is_grad_enabled():
                return _checkpointed(self, args, kwargs)
            return nn.Module.__call__(self, *args, **kwargs)
        finally:
            autograd._STATE.functional -= 1

    def forward(self, *args, **kwargs):
        from .. import ndarray as F
        params = {leaf: p._tensor() for leaf, p in self._reg_params.items()}
        return plain(self.hybrid_forward(F, *traced(list(args)),
                                         **traced(params),
                                         **traced(kwargs)))

    def hybrid_forward(self, F, *args, **kwargs):
        raise NotImplementedError

    def hybridize(self, active=True, static_alloc=False, static_shape=False,
                  inline_limit=None, backend=None, **kwargs):
        """The flag only (see the module docstring): ``static_alloc``,
        ``static_shape`` and ``inline_limit`` tune the reference's traced
        program and have no meaning for the eager forward."""
        refuse_unported("HybridBlock.hybridize", "A8", backend=(backend, None))
        super().hybridize(active)

    def export(self, path, epoch=0, example_inputs=None):
        """Write the block's predict-mode forward as a program and its
        parameters:

        - ``{path}-symbol.json``: ``format`` (``"tpu_mx_torch-export-v1"``),
          ``name``, ``params``, ``inputs`` (shape and dtype of each) and
          ``artifact``, as the reference's, and ``axes``: the parameters
          the port stores in another order than the reference's shape
          (``param_file``'s arrays are permuted by them at import);
        - ``{path}-{epoch:04d}.params.npz``: the parameters under the
          reference's keys, in its ``nd.save`` container and shapes;
        - ``{path}-{epoch:04d}.pt2``: the program, ``torch.export``'s
          ``ExportedProgram`` of the forward at these input shapes (the
          flash attention forward stays one call of its operator,
          ``tpu_mx_torch_flash::fwd``, which runs the kernel);

        then the epoch's manifest over the two per-epoch files
        (:func:`tpu_mx_torch.checkpoint.write_manifest`).  The input
        shapes are ``example_inputs``' or the last call's; with neither,
        or when ``torch.export`` cannot trace the forward, it raises
        :class:`MXNetError` (no other program is written in its place).
        Load it with :meth:`SymbolBlock.imports`."""
        import io as _io
        import json
        import os
        from ..checkpoint import atomic_write, write_manifest
        from ..ndarray.ndarray import save as nd_save
        params = {k: p for k, p in self._collect_params_with_prefix().items()
                  if p._tensor() is not None}
        if example_inputs is not None:
            examples = [_unwrap(a) if isinstance(a, NDArray)
                        else torch.as_tensor(a) for a in example_inputs]
            avals = [(tuple(a.shape), _dtype_name(a.dtype))
                     for a in examples]
        elif self.__dict__.get("_last_input_avals") is not None:
            avals = [(s, _dtype_name(d)) for s, d in self._last_input_avals]
            examples = None
        else:
            raise MXNetError(
                "export() needs input shapes: call the block once (after "
                "hybridize()) or pass example_inputs=")
        dev = next((p._tensor().device for p in params.values()), None) \
            or _device.resolve(current_context())
        if examples is None:
            examples = [torch.zeros(s, dtype=getattr(torch, d)) for s, d
                        in avals]
        examples = tuple(a.to(dev) for a in examples)
        modes = {m: m.training for m in self.modules()}
        try:
            self.train(False)
            with autograd.predict_mode(), torch.no_grad():
                program = torch.export.export(_Predict(self), examples,
                                              strict=False)
        except Exception as e:  # noqa: BLE001 — refused, with the reason
            raise MXNetError(f"export: torch.export cannot trace "
                             f"{type(self).__name__}'s forward: "
                             f"{type(e).__name__}: {e}") from e
        finally:
            for m, training in modes.items():
                m.train(training)
        nd_save(f"{path}-{epoch:04d}.params.npz",
                {k: p._ref_view() for k, p in params.items()})
        buf = _io.BytesIO()
        torch.export.save(program, buf)
        art = f"{path}-{epoch:04d}.pt2"
        with atomic_write(art) as f:
            f.write(buf.getbuffer())
        with atomic_write(f"{path}-symbol.json", "w") as f:
            f.write(json.dumps({
                "format": EXPORT_FORMAT,
                "name": self.name,
                "params": sorted(params),
                "inputs": [{"shape": list(s), "dtype": d} for s, d in avals],
                "artifact": os.path.basename(art),
                "axes": {k: list(p._axes) for k, p in params.items()
                         if p._axes is not None}}))
        # the manifest lists the per-epoch files only: the symbol file is
        # rewritten by every export, so listing it would make every older
        # epoch corrupt
        write_manifest(path, epoch, [f"{path}-{epoch:04d}.params.npz", art])


EXPORT_FORMAT = "tpu_mx_torch-export-v1"


def _dtype_name(dtype):
    """The name of an element type: numpy's, or torch's where numpy has
    none (``bfloat16``)."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).replace("torch.", "")
    return np.dtype(dtype).name


class _Predict(nn.Module):
    """The module ``torch.export`` traces: the block's forward on tensors,
    its outputs as tensors."""

    def __init__(self, net):
        super().__init__()
        self.net = net

    def forward(self, *inputs):
        return plain(self.net(*inputs))


class SymbolBlock(HybridBlock):
    """A block over a program: :meth:`imports` builds one from an
    :meth:`HybridBlock.export`, whose forward runs the exported
    program."""

    def __init__(self, fn, params=None, prefix=None):
        super().__init__(prefix=prefix)
        self._fn = fn

    def hybrid_forward(self, F, *args, **params):
        return self._fn(*args)

    def __call__(self, *args):
        return self._fn(*args)

    @staticmethod
    def imports(symbol_file, input_names=None, param_file=None, ctx=None):
        """The block of an :meth:`HybridBlock.export`: its forward runs the
        ``.pt2`` program with ``param_file``'s parameters, on the device
        the program was exported on (or ``ctx``'s), and equals the
        exporting block's predict-mode forward bit for bit on the same
        device.  Another format (the reference's StableHLO among them) is
        refused by name."""
        import json
        import os
        from ..kernels import flash_attention  # noqa: F401 — its operator
        from ..ndarray.ndarray import load as nd_load
        with open(symbol_file) as f:
            manifest = json.load(f)
        fmt = manifest.get("format")
        if fmt != EXPORT_FORMAT:
            raise MXNetError(
                f"SymbolBlock.imports: unsupported export format {fmt!r} in "
                f"{symbol_file} (this package reads {EXPORT_FORMAT!r})")
        if param_file is None:
            raise MXNetError("param_file is required")
        art = os.path.join(os.path.dirname(symbol_file) or ".",
                           manifest["artifact"])
        with open(art, "rb") as f:
            program = torch.export.load(f)
        gm = program.module()
        if ctx is not None:
            gm.to(_device.resolve(ctx))
        state = dict(gm.named_parameters())
        state.update(gm.named_buffers())
        axes = manifest.get("axes", {})
        with torch.no_grad():
            for k, v in nd_load(param_file, ctx="cpu").items():
                t = v._data
                if k in axes:
                    t = t.permute(axes[k])
                dst = state[f"net.{k}"]
                dst.copy_(t.to(dst.dtype))

        def fn(*inputs):
            out = gm(*[_unwrap(a) if isinstance(a, NDArray) else a
                       for a in inputs])
            return _wrap(out) if any(isinstance(a, NDArray)
                                     for a in inputs) else out

        blk = SymbolBlock(fn)
        blk._export_manifest = manifest
        return blk
