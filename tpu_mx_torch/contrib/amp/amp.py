"""Automatic mixed precision, from ``tpu_mx/contrib/amp/amp.py``.

:func:`init` replaces the operators of :mod:`.lists` in the port's
``nd`` namespaces (``tpu_mx_torch.ndarray.ops`` and the
``tpu_mx_torch.ndarray`` package, the two the reference patches) by
wrappers that cast their floating arguments, arrays and tensors alike:
the products (``FullyConnected``, ``Convolution``, ``dot``, ...) to the
target dtype (bfloat16 by default), the sensitive operators
(``softmax``, ``LayerNorm``, ``exp``, ...) to float32, and ``concat``,
``stack``, ``add_n`` and ``where`` to the widest floating dtype among
their arguments.  The patch reaches exactly the calls that read those
names from the namespaces at the call, as the reference's does:

- Gluon's layers and the port's models (``ops.FullyConnected`` in
  ``Dense`` and BERT, ``ops.Convolution``, ``ops.LayerNorm``, ...), and
  a ``hybrid_forward``'s ``F``;
- the imperative ``nd.*`` calls, under ``engine.bulk()`` too (the casts
  join the pending segment as ``cast`` operators);
- not ``mx.sym``'s executors, whose operator table was filled from the
  namespaces at import (as the reference's ``_SYM_OPS`` was), nor
  ``npx``'s aliases, bound at import.

So a float32 BERT-base under ``amp.init()`` and :func:`convert_model`
runs its products in bfloat16, and its attention gets bfloat16 q/k/v:
the flash kernels' bfloat16 ``wgmma`` route on the card.  Under
``init("float16")`` q/k/v are float16, which both packages' gates send
to the dense attention arm.

``target_dtype="float16"`` gets the reference's dynamic loss scaling
(:class:`LossScaler`: halve on overflow and skip the step, double after
``scale_window`` clean steps); bfloat16 has float32's exponent range and
its scale stays 1.  :func:`_deinit` restores every patched name (the
reference's test hook; call it in a ``finally``).

    amp.init()                       # patch the namespaces, bfloat16
    amp.init_trainer(trainer)        # attach a LossScaler
    with amp.scale_loss(loss, trainer) as scaled:
        scaled.backward()
    trainer.step(batch)              # unscale and the overflow skip inside
"""
from __future__ import annotations

import contextlib
import functools
import inspect
import warnings

import torch

from ...ndarray.ndarray import NDArray
from . import lists

__all__ = ["init", "init_trainer", "scale_loss", "unscale", "convert_model",
           "LossScaler"]

_amp_state = {
    "initialized": False,
    "target_dtype": None,
    "originals": {},   # op name -> original function
}

_FLOATS = {torch.float32: "float32", torch.float16: "float16",
           torch.bfloat16: "bfloat16"}
_TORCH = {v: k for k, v in _FLOATS.items()}


def _dtype_of(x):
    """The floating dtype name of an array or tensor argument (an array's
    without flushing a pending fusion segment), else None."""
    if isinstance(x, NDArray):
        return _FLOATS.get(x._meta().dtype)
    if isinstance(x, torch.Tensor):
        return _FLOATS.get(x.dtype)
    return None


def _cast_arg(x, dtype):
    """``x`` cast to ``dtype`` if it is a floating array or tensor of
    another floating dtype (``astype`` for an array, differentiable
    ``.to`` for a tensor), else ``x`` itself."""
    have = _dtype_of(x)
    if have is None or have == dtype:
        return x
    if isinstance(x, NDArray):
        return x.astype(dtype)
    return x.to(_TORCH[dtype])


def _cast_all(args, kwargs, dtype):
    """Cast tensor-valued positionals AND keywords (the argument style
    must not change what amp does)."""
    return ([_cast_arg(a, dtype) for a in args],
            {k: _cast_arg(v, dtype) for k, v in kwargs.items()})


def _wrap(fn, dtype):
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        args, kwargs = _cast_all(args, kwargs, dtype)
        return fn(*args, **kwargs)
    wrapper.__amp_wrapped__ = True
    return wrapper


def _widest_wrap(fn):
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        floats = [d for d in (_dtype_of(a)
                              for a in list(args) + list(kwargs.values()))
                  if d is not None]
        if floats:
            widest = "float32" if "float32" in floats else \
                ("bfloat16" if "bfloat16" in floats else "float16")
            args, kwargs = _cast_all(args, kwargs, widest)
        return fn(*args, **kwargs)
    wrapper.__amp_wrapped__ = True
    return wrapper


def _namespaces():
    from ... import ndarray as nd_pkg
    from ...ndarray import ops as ops_mod
    return (ops_mod, nd_pkg)


def _conditional_wrap(fn, cond_param, cond_values):
    """Cast the inputs to float32 only when ``cond_param``, given by
    position or by keyword, is one of ``cond_values``; otherwise leave
    the call as it is."""
    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        sig = None

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        value = kwargs.get(cond_param)
        if value is None and sig is not None:
            try:
                value = sig.bind_partial(*args, **kwargs).arguments.get(
                    cond_param)
            except TypeError:
                pass
        if value in cond_values:
            args, kwargs = _cast_all(args, kwargs, "float32")
        return fn(*args, **kwargs)
    wrapper.__amp_wrapped__ = True
    return wrapper


def init(target_dtype="bfloat16", target_precision_ops=None,
         conditional_fp32_ops=None, fp32_ops=None):
    """Patch the ``nd`` namespaces with the cast wrappers (see the
    module's docstring).  ``conditional_fp32_ops`` is a list of ``(op
    name, parameter name, values)``: the operator runs in float32 only
    when that parameter is one of ``values``.  A second call warns when
    its dtype differs and changes nothing."""
    if _amp_state["initialized"]:
        if target_dtype != _amp_state["target_dtype"]:
            warnings.warn(
                "amp.init() already ran with target_dtype=%r; the new "
                "request for %r is ignored (call _deinit() first to "
                "re-initialize)" % (_amp_state["target_dtype"], target_dtype))
        return
    if target_dtype not in ("bfloat16", "float16"):
        raise ValueError("target_dtype must be 'bfloat16' or 'float16', got %r"
                         % (target_dtype,))
    target_ops = list(target_precision_ops or lists.TARGET_DTYPE_OPS)
    fp32 = list(fp32_ops or lists.FP32_OPS)
    _amp_state["target_dtype"] = target_dtype
    namespaces = _namespaces()

    def _patch(name, make_wrapper):
        fn = getattr(namespaces[0], name, None)
        if fn is None or getattr(fn, "__amp_wrapped__", False):
            return
        _amp_state["originals"][name] = fn
        wrapped = make_wrapper(fn)
        for ns in namespaces:
            if getattr(ns, name, None) is fn:
                setattr(ns, name, wrapped)

    for name, dtype in [(n, target_dtype) for n in target_ops] + \
                       [(n, "float32") for n in fp32]:
        _patch(name, lambda fn, d=dtype: _wrap(fn, d))
    for name, cond_param, cond_values in (conditional_fp32_ops or ()):
        _patch(name, lambda fn, p=cond_param, v=tuple(cond_values):
               _conditional_wrap(fn, p, v))
    for name in lists.WIDEST_TYPE_CASTS:
        _patch(name, _widest_wrap)
    _amp_state["initialized"] = True


def _deinit():
    """Undo :func:`init`: every patched name gets its function back."""
    namespaces = _namespaces()
    for name, fn in _amp_state["originals"].items():
        for ns in namespaces:
            if getattr(ns, name, None) is not fn and hasattr(ns, name):
                setattr(ns, name, fn)
    _amp_state["originals"].clear()
    _amp_state["initialized"] = False
    _amp_state["target_dtype"] = None


def _grads(params):
    """The gradient tensors of ``params`` (those that have one)."""
    out = []
    for p in params:
        try:
            g = p.grad
        except Exception:   # noqa: BLE001 — a parameter without a gradient
            continue
        if g is None:
            continue
        out.append(g._data if isinstance(g, NDArray) else g)
    return out


def _check_and_unscale(grads, inv_scale):
    """Multiply ``grads`` by ``inv_scale`` in place and return a one-element
    float32 tensor on the first gradient's device that is nonzero iff any
    of them holds an inf or a NaN, with a few foreach launches a (device,
    dtype) group and no host read.  float16/32/64 groups go through
    ``torch._amp_foreach_non_finite_check_and_unscale_``; its CUDA kernel
    takes no bfloat16, so a bfloat16 group is scaled by ``_foreach_mul_``
    and checked by two foreach reductions: max|x| is not finite iff an
    element is inf (or NaN), sum|x| is NaN iff an element is NaN (exact:
    neither flags a finite gradient)."""
    groups = {}
    for g in grads:
        groups.setdefault(g.device, {}).setdefault(g.dtype, []).append(g)
    flags = []
    with torch.no_grad():
        for dev, by_dtype in groups.items():
            found = torch.zeros(1, dtype=torch.float32, device=dev)
            inv = torch.full((1,), inv_scale, dtype=torch.float32,
                             device=dev)
            for dtype, group in by_dtype.items():
                if dtype != torch.bfloat16:
                    torch._amp_foreach_non_finite_check_and_unscale_(
                        group, found, inv)
                    continue
                if inv_scale != 1.0:
                    torch._foreach_mul_(group, inv_scale)
                peak = torch.stack(torch._foreach_norm(group, float("inf")))
                total = torch.stack(torch._foreach_norm(group, 1))
                found.add_(~torch.isfinite(peak).all()
                           | torch.isnan(total).any())
            flags.append(found)
    first = flags[0]
    for f in flags[1:]:
        first = first + f.to(first.device)
    return first


class LossScaler:
    """Dynamic loss scaler: doubles the scale every ``scale_window``
    overflow-free steps and halves it on an overflow.  For bfloat16 the
    scale is pinned at 1 (float32's exponent range: nothing to rescue)."""

    #: device-to-host reads :meth:`has_overflow` has made (one a call)
    host_reads = 0

    def __init__(self, init_scale=2.0 ** 16, scale_factor=2.0,
                 scale_window=2000, target_dtype="float16"):
        self._static = target_dtype == "bfloat16"
        self.loss_scale = 1.0 if self._static else float(init_scale)
        self.scale_factor = scale_factor
        self.scale_window = scale_window
        self._unskipped = 0

    def has_overflow(self, params):
        """True iff any gradient holds an inf or a NaN: a few fused foreach
        launches a (device, dtype) group (:func:`_check_and_unscale` with a
        scale of 1, which leaves every gradient's bits as they are) and a
        single device-to-host read whatever the parameter count."""
        grads = _grads(params)
        if not grads:
            return False
        found = _check_and_unscale(grads, 1.0)
        LossScaler.host_reads += 1
        return bool(found.item())

    def update_scale(self, overflow):
        if self._static:
            return
        if overflow:
            self.loss_scale = max(self.loss_scale / self.scale_factor, 1.0)
            self._unskipped = 0
        else:
            self._unskipped += 1
            if self._unskipped >= self.scale_window:
                self.loss_scale *= self.scale_factor
                self._unskipped = 0


def init_trainer(trainer):
    """Attach a :class:`LossScaler` to ``trainer`` and wrap its
    ``update`` so that an overflowed step is skipped (the weights and
    the optimizer's state untouched) with a warning."""
    if getattr(trainer, "_amp_loss_scaler", None) is not None:
        return
    scaler = LossScaler(target_dtype=_amp_state["target_dtype"] or "bfloat16")
    trainer._amp_loss_scaler = scaler
    orig_update = trainer.update

    @functools.wraps(orig_update)
    def update(batch_size, ignore_stale_grad=False):
        overflow = not scaler._static and scaler.has_overflow(trainer._params)
        scaler.update_scale(overflow)
        trainer._scale = 1.0 / scaler.loss_scale
        if overflow:
            warnings.warn("AMP: gradient overflow, skipping step "
                          "(loss scale -> %g)" % scaler.loss_scale)
            return
        orig_update(batch_size, ignore_stale_grad)

    trainer.update = update
    trainer._scale = 1.0 / scaler.loss_scale


@contextlib.contextmanager
def scale_loss(loss, trainer):
    """Yield ``loss * loss_scale`` (a list for a list); ``trainer.step``
    divides the gradients back by the scale (``trainer._scale``)."""
    if getattr(trainer, "_amp_loss_scaler", None) is None:
        init_trainer(trainer)
    scaler = trainer._amp_loss_scaler
    trainer._scale = 1.0 / scaler.loss_scale
    if scaler.loss_scale == 1.0:
        yield loss
        return
    # the product must join the loss's graph: turn recording on in place
    # (re-entering record() here would start a fresh scope)
    from ... import autograd as _ag
    prev = _ag._STATE.recording
    _ag._STATE.recording = True
    try:
        if isinstance(loss, (list, tuple)):
            scaled = [l * scaler.loss_scale for l in loss]
        else:
            scaled = loss * scaler.loss_scale
    finally:
        _ag._STATE.recording = prev
    yield scaled


def unscale(trainer):
    """Divide the gradients by the current loss scale in place."""
    scaler = getattr(trainer, "_amp_loss_scaler", None)
    if scaler is None or scaler.loss_scale == 1.0:
        return
    grads = _grads(trainer._params)
    if grads:
        _check_and_unscale(grads, 1.0 / scaler.loss_scale)
    trainer._scale = 1.0


def convert_model(net, target_dtype=None, excluded_sym_names=(),
                  cast_optional_params=False):
    """Cast a Gluon net's parameters and running statistics to the amp
    dtype, keeping the normalization layers (a class name with
    ``Norm``) and every block whose child key or name is in
    ``excluded_sym_names`` (with all it holds) in float32 with their
    original values."""
    target_dtype = target_dtype or _amp_state["target_dtype"] or "bfloat16"
    if cast_optional_params:
        warnings.warn("cast_optional_params is accepted for API parity but "
                      "has no effect: optional (aux) params follow the same "
                      "cast/exclusion rules as regular ones here")
    excluded = set(excluded_sym_names)

    def _excluded_blocks(block, name):
        if "Norm" in type(block).__name__ or name in excluded or \
                getattr(block, "name", None) in excluded:
            yield block
            return
        # every module under it: a model's layer lists are containers
        for key, child in block.named_children():
            yield from _excluded_blocks(child, str(key))

    def tensors(block):
        return {**dict(block.named_parameters()),
                **dict(block.named_buffers())}

    def cast(block, dtype):
        return block.cast(dtype) if hasattr(block, "cast") \
            else block.to(getattr(torch, dtype))

    # the excluded tensors' values, taken before the net-wide cast
    kept = [(b, {k: t.detach().clone() for k, t in tensors(b).items()})
            for b in _excluded_blocks(net, "")]
    net.cast(target_dtype)
    with torch.no_grad():
        for block, saved in kept:
            cast(block, "float32")
            now = tensors(block)     # the cast replaced the buffers
            for k, orig in saved.items():
                now[k].copy_(orig)
    return net
