"""The raw optimizer update operators of ``tpu_mx/ndarray/optimizer_ops.py``
(the reference's ``mx.nd.*_update`` surface).

Each operator computes one optimizer's update with the reference's
formula (upstream MXNet 1.x: ``adam_update`` and ``adamw_update`` do not
bias-correct; the Python optimizer pre-scales the rate):

- given arrays, the state arrays (``mom``, ``mean``, ``var``, ``n``,
  ``z``, ...) are rebound in place, each in its own dtype, and the new
  weight goes to ``out`` (returned; ``out=weight`` is the in-place idiom)
  or to a fresh array;
- given tensors, the operator returns the raw ``(new_weight,
  *new_states)``, as the reference's do inside a traced forward;
- no operator records a gradient.

The ``multi_*`` operators take the reference's interleaved argument
lists (``[w0, g0, mom0, w1, g1, mom1, ...]``) with per-weight ``lrs`` and
``wds``; the ``preloaded_multi_*`` ones take ``lrs`` and ``wds`` as the
last two arrays.  The port's optimizers keep their own update cores.
"""
from __future__ import annotations

import torch

from .ndarray import NDArray

__all__ = [
    "sgd_mom_update", "mp_sgd_update", "mp_sgd_mom_update", "adam_update",
    "nag_mom_update", "mp_nag_mom_update", "rmsprop_update",
    "rmspropalex_update", "ftrl_update", "ftml_update", "signsgd_update",
    "signum_update", "lamb_update_phase1", "lamb_update_phase2",
    "adamw_update", "mp_adamw_update",
    "multi_sgd_update", "multi_sgd_mom_update", "multi_mp_sgd_update",
    "multi_mp_sgd_mom_update", "preloaded_multi_sgd_update",
    "preloaded_multi_sgd_mom_update", "preloaded_multi_mp_sgd_update",
    "preloaded_multi_mp_sgd_mom_update",
]


def _prep(grad, rescale_grad, clip_gradient):
    g = grad * rescale_grad
    if clip_gradient is not None and clip_gradient > 0:
        g = torch.clamp(g, -clip_gradient, clip_gradient)
    return g


def _cg(clip_gradient):
    return clip_gradient if clip_gradient and clip_gradient > 0 else None


def _raw(a):
    return a._data if isinstance(a, NDArray) else a


def _run(core, args):
    """``core`` over the unwrapped ``args`` without a gradient; arrays
    back (one, or a list) when any argument is an array, else the raw
    result."""
    with torch.no_grad():
        res = core(*[_raw(a) for a in args])
    if not any(isinstance(a, NDArray) for a in args):
        return res
    if isinstance(res, (list, tuple)):
        return [NDArray(r) for r in res]
    return NDArray(res)


def _finish(res, states, out):
    """``res = (new_weight, *new_states)``: rebind the states in place,
    deliver the weight to ``out`` (or a fresh array); raw results (tensor
    arguments) come back as the tuple."""
    if not isinstance(res, (list, tuple)):
        return res
    if not isinstance(res[0], NDArray):
        return tuple(res)
    new_w, new_states = res[0], res[1:]
    for s, ns in zip(states, new_states):
        s._rebind(ns._data.to(s._data.dtype))
    if out is not None:
        out._rebind(new_w._data.to(out._data.dtype))
        return out
    return new_w


def _single(res, out):
    """One result (no state): into ``out`` when given."""
    if isinstance(res, NDArray) and out is not None:
        out._rebind(res._data.to(out._data.dtype))
        return out
    return res


# -- the SGD family ---------------------------------------------------------------
def sgd_mom_update(weight, grad, mom, lr, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1, lazy_update=True,
                   out=None, **kw):
    """mom = momentum·mom − lr·(g + wd·w);  w += mom."""
    cg = _cg(clip_gradient)

    def core(w, g, m):
        gp = _prep(g, rescale_grad, cg)
        new_m = momentum * m - lr * (gp + wd * w)
        return w + new_m, new_m

    return _finish(_run(core, [weight, grad, mom]), [mom], out)


def mp_sgd_update(weight, grad, weight32, lr, wd=0.0, rescale_grad=1.0,
                  clip_gradient=-1, lazy_update=True, out=None, **kw):
    """Mixed-precision SGD: the float32 master is updated, the weight is
    its cast."""
    cg = _cg(clip_gradient)

    def core(w, g, w32):
        gp = _prep(g.float(), rescale_grad, cg)
        new_w32 = w32 - lr * (gp + wd * w32)
        return new_w32.to(w.dtype), new_w32

    return _finish(_run(core, [weight, grad, weight32]), [weight32], out)


def mp_sgd_mom_update(weight, grad, mom, weight32, lr, momentum=0.0,
                      wd=0.0, rescale_grad=1.0, clip_gradient=-1,
                      lazy_update=True, out=None, **kw):
    cg = _cg(clip_gradient)

    def core(w, g, m, w32):
        gp = _prep(g.float(), rescale_grad, cg)
        new_m = momentum * m - lr * (gp + wd * w32)
        new_w32 = w32 + new_m
        return new_w32.to(w.dtype), new_m, new_w32

    return _finish(_run(core, [weight, grad, mom, weight32]),
                   [mom, weight32], out)


def nag_mom_update(weight, grad, mom, lr, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1, out=None, **kw):
    """Nesterov momentum: mom = momentum·mom + (g + wd·w);
    w −= lr·(g + wd·w + momentum·mom)."""
    cg = _cg(clip_gradient)

    def core(w, g, m):
        gp = _prep(g, rescale_grad, cg) + wd * w
        new_m = momentum * m + gp
        return w - lr * (gp + momentum * new_m), new_m

    return _finish(_run(core, [weight, grad, mom]), [mom], out)


def mp_nag_mom_update(weight, grad, mom, weight32, lr, momentum=0.0,
                      wd=0.0, rescale_grad=1.0, clip_gradient=-1,
                      out=None, **kw):
    cg = _cg(clip_gradient)

    def core(w, g, m, w32):
        gp = _prep(g.float(), rescale_grad, cg) + wd * w32
        new_m = momentum * m + gp
        new_w32 = w32 - lr * (gp + momentum * new_m)
        return new_w32.to(w.dtype), new_m, new_w32

    return _finish(_run(core, [weight, grad, mom, weight32]),
                   [mom, weight32], out)


# -- Adam / AdamW / LAMB ----------------------------------------------------------
def adam_update(weight, grad, mean, var, lr, beta1=0.9, beta2=0.999,
                epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_gradient=-1,
                lazy_update=True, out=None, **kw):
    """Upstream adam_update: no bias correction."""
    cg = _cg(clip_gradient)

    def core(w, g, m, v):
        gp = _prep(g, rescale_grad, cg) + wd * w
        new_m = beta1 * m + (1 - beta1) * gp
        new_v = beta2 * v + (1 - beta2) * torch.square(gp)
        return (w - lr * new_m / (torch.sqrt(new_v) + epsilon),
                new_m, new_v)

    return _finish(_run(core, [weight, grad, mean, var]), [mean, var], out)


def adamw_update(weight, grad, mean, var, rescale_grad, lr, beta1=0.9,
                 beta2=0.999, epsilon=1e-8, wd=0.0, eta=1.0,
                 clip_gradient=-1, out=None, **kw):
    """AdamW with decoupled weight decay: w −= eta·(lr·m/(√v+ε) + wd·w);
    no bias correction; ``rescale_grad`` a scalar or an array."""
    cg = _cg(clip_gradient)

    def core(w, g, m, v, rs):
        gp = g * rs
        if cg is not None:
            gp = torch.clamp(gp, -cg, cg)
        new_m = beta1 * m + (1 - beta1) * gp
        new_v = beta2 * v + (1 - beta2) * torch.square(gp)
        new_w = w - eta * (lr * new_m / (torch.sqrt(new_v) + epsilon)
                           + wd * w)
        return new_w, new_m, new_v

    return _finish(_run(core, [weight, grad, mean, var, rescale_grad]),
                   [mean, var], out)


def mp_adamw_update(weight, grad, mean, var, weight32, rescale_grad, lr,
                    beta1=0.9, beta2=0.999, epsilon=1e-8, wd=0.0, eta=1.0,
                    clip_gradient=-1, out=None, **kw):
    cg = _cg(clip_gradient)

    def core(w, g, m, v, w32, rs):
        gp = g.float() * rs
        if cg is not None:
            gp = torch.clamp(gp, -cg, cg)
        new_m = beta1 * m + (1 - beta1) * gp
        new_v = beta2 * v + (1 - beta2) * torch.square(gp)
        new_w32 = w32 - eta * (lr * new_m / (torch.sqrt(new_v) + epsilon)
                               + wd * w32)
        return new_w32.to(w.dtype), new_m, new_v, new_w32

    return _finish(_run(core, [weight, grad, mean, var, weight32,
                               rescale_grad]), [mean, var, weight32], out)


def lamb_update_phase1(weight, grad, mean, var, beta1=0.9, beta2=0.999,
                       epsilon=1e-6, t=1, bias_correction=True, wd=0.0,
                       rescale_grad=1.0, clip_gradient=-1, **kw):
    """LAMB phase 1: the raw update direction g' = m̂/(√v̂+ε) + wd·w;
    mean/var rebound in place."""
    cg = _cg(clip_gradient)

    def core(w, g, m, v):
        gp = _prep(g, rescale_grad, cg)
        new_m = beta1 * m + (1 - beta1) * gp
        new_v = beta2 * v + (1 - beta2) * torch.square(gp)
        mhat, vhat = new_m, new_v
        if bias_correction:
            mhat = new_m / (1 - beta1 ** t)
            vhat = new_v / (1 - beta2 ** t)
        return mhat / (torch.sqrt(vhat) + epsilon) + wd * w, new_m, new_v

    res = _run(core, [weight, grad, mean, var])
    if isinstance(res, list):
        mean._rebind(res[1]._data)
        var._rebind(res[2]._data)
        return res[0]
    return res


def lamb_update_phase2(weight, g, r1, r2, lr, lower_bound=-1.0,
                       upper_bound=-1.0, out=None, **kw):
    """LAMB phase 2: w −= lr·(r1/r2)·g with r1 = ‖w‖ clipped into
    [lower_bound, upper_bound] (where positive) and r2 = ‖g‖; ratio 1
    where either is 0."""

    def core(w, gg, r1v, r2v):
        r1c = r1v
        if lower_bound > 0:
            r1c = torch.clamp(r1c, min=lower_bound)
        if upper_bound > 0:
            r1c = torch.clamp(r1c, max=upper_bound)
        ratio = torch.where((r1c > 0) & (r2v > 0), r1c / r2v,
                            torch.ones_like(r1c))
        return w - lr * ratio * gg

    return _single(_run(core, [weight, g, r1, r2]), out)


# -- RMSProp / Ftrl / FTML --------------------------------------------------------
def rmsprop_update(weight, grad, n, lr, gamma1=0.95, epsilon=1e-8, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1, clip_weights=-1,
                   out=None, **kw):
    """Tieleman & Hinton RMSProp (non-centered)."""
    cg = _cg(clip_gradient)

    def core(w, g, nn):
        gp = _prep(g, rescale_grad, cg) + wd * w
        new_n = gamma1 * nn + (1 - gamma1) * torch.square(gp)
        new_w = w - lr * gp / (torch.sqrt(new_n) + epsilon)
        if clip_weights and clip_weights > 0:
            new_w = torch.clamp(new_w, -clip_weights, clip_weights)
        return new_w, new_n

    return _finish(_run(core, [weight, grad, n]), [n], out)


def rmspropalex_update(weight, grad, n, g, delta, lr, gamma1=0.95,
                       gamma2=0.9, epsilon=1e-8, wd=0.0, rescale_grad=1.0,
                       clip_gradient=-1, clip_weights=-1, out=None, **kw):
    """Graves' centered RMSProp: tracks the gradient's mean too; the
    update goes through the momentum buffer ``delta``."""
    cg = _cg(clip_gradient)

    def core(w, gr, nn, gm, d):
        gp = _prep(gr, rescale_grad, cg) + wd * w
        new_n = gamma1 * nn + (1 - gamma1) * torch.square(gp)
        new_g = gamma1 * gm + (1 - gamma1) * gp
        new_d = gamma2 * d - lr * gp / torch.sqrt(
            new_n - torch.square(new_g) + epsilon)
        new_w = w + new_d
        if clip_weights and clip_weights > 0:
            new_w = torch.clamp(new_w, -clip_weights, clip_weights)
        return new_w, new_n, new_g, new_d

    return _finish(_run(core, [weight, grad, n, g, delta]), [n, g, delta],
                   out)


def ftrl_update(weight, grad, z, n, lr, lamda1=0.01, beta=1.0, wd=0.0,
                rescale_grad=1.0, clip_gradient=-1, out=None, **kw):
    """FTRL-proximal (McMahan et al.)."""
    cg = _cg(clip_gradient)

    def core(w, g, zz, nn):
        gp = _prep(g, rescale_grad, cg)
        new_z = zz + gp - (torch.sqrt(nn + torch.square(gp))
                           - torch.sqrt(nn)) / lr * w
        new_n = nn + torch.square(gp)
        new_w = torch.where(
            torch.abs(new_z) > lamda1,
            (torch.sign(new_z) * lamda1 - new_z) /
            ((beta + torch.sqrt(new_n)) / lr + wd),
            torch.zeros_like(new_z))
        return new_w, new_z, new_n

    return _finish(_run(core, [weight, grad, z, n]), [z, n], out)


def ftml_update(weight, grad, d, v, z, lr, t, beta1=0.6, beta2=0.999,
                epsilon=1e-8, wd=0.0, rescale_grad=1.0,
                clip_grad=-1, out=None, **kw):
    """FTML (Zheng & Kwok 2017)."""
    cg = _cg(clip_grad)

    def core(w, g, dd, vv, zz):
        gp = _prep(g, rescale_grad, cg) + wd * w
        new_v = beta2 * vv + (1 - beta2) * torch.square(gp)
        d_t = (1 - beta1 ** t) / lr * (
            torch.sqrt(new_v / (1 - beta2 ** t)) + epsilon)
        sigma = d_t - beta1 * dd
        new_z = beta1 * zz + (1 - beta1) * gp - sigma * w
        return -new_z / d_t, d_t, new_v, new_z

    return _finish(_run(core, [weight, grad, d, v, z]), [d, v, z], out)


# -- sign-based -------------------------------------------------------------------
def signsgd_update(weight, grad, lr, wd=0.0, rescale_grad=1.0,
                   clip_gradient=-1, out=None, **kw):
    """signSGD: w = (1−lr·wd)·w − lr·sign(g)."""
    cg = _cg(clip_gradient)

    def core(w, g):
        gp = _prep(g, rescale_grad, cg)
        return (1 - lr * wd) * w - lr * torch.sign(gp)

    return _single(_run(core, [weight, grad]), out)


def signum_update(weight, grad, mom, lr, momentum=0.9, wd=0.0,
                  rescale_grad=1.0, clip_gradient=-1, wd_lh=0.0, out=None,
                  **kw):
    """Signum: the sign of the momentum buffer; ``wd`` folded into the
    gradient, ``wd_lh`` applied decoupled."""
    cg = _cg(clip_gradient)

    def core(w, g, m):
        gp = _prep(g, rescale_grad, cg)
        new_m = momentum * m - (1 - momentum) * (gp + wd * w)
        return (1 - lr * wd_lh) * w + lr * torch.sign(new_m), new_m

    return _finish(_run(core, [weight, grad, mom]), [mom], out)


# -- multi-tensor updates ---------------------------------------------------------
def _check_out(out, n, name):
    """``out`` is None or a length-``n`` sequence (a bare array only for
    ``n == 1``), checked before any state is rebound."""
    if out is None:
        return None
    if isinstance(out, NDArray):
        if n != 1:
            raise ValueError(f"{name}: out must be a sequence of "
                             f"{n} NDArrays (got a single NDArray)")
        return [out]
    out = list(out)
    if len(out) != n:
        raise ValueError(f"{name}: out has {len(out)} entries for "
                         f"{n} weights")
    return out


def _deliver(res, tensors, group, n, state_slots, out):
    """The multi operators' epilogue: raw results come back as they are;
    otherwise states are rebound in place and weights delivered to
    ``out`` or returned fresh."""
    if not isinstance(res, (list, tuple)) or not res or \
            not isinstance(res[0], NDArray):
        return res
    per = 1 + len(state_slots)
    results = []
    for i in range(n):
        new_w = res[i * per]
        new_states = res[i * per + 1:(i + 1) * per]
        for slot, ns in zip(state_slots, new_states):
            s = tensors[i * group + slot]
            s._rebind(ns._data.to(s._data.dtype))
        if out is not None:
            out[i]._rebind(new_w._data.to(out[i]._data.dtype))
            results.append(out[i])
        else:
            results.append(new_w)
    return results


def _multi_update(data, group, per_weight, name, num_weights, out,
                  state_slots):
    n = num_weights
    if len(data) != n * group:
        raise ValueError(f"{name}: expected {n * group} tensors "
                         f"({group} per weight), got {len(data)}")
    out = _check_out(out, n, name)

    def fn(*raw):
        outs = []
        for i in range(n):
            outs.extend(per_weight(i, *raw[i * group:(i + 1) * group]))
        return tuple(outs)

    return _deliver(_run(fn, list(data)), data, group, n, state_slots, out)


def _lrs_wds(kw, n):
    lrs = kw.get("lrs", kw.get("lr"))
    wds = kw.get("wds", kw.get("wd", 0.0))
    if lrs is None:
        raise ValueError("multi update ops need lrs=(...)")
    lrs = [float(lrs)] * n if not isinstance(lrs, (list, tuple)) else \
        [float(v) for v in lrs]
    wds = [float(wds)] * n if not isinstance(wds, (list, tuple)) else \
        [float(v) for v in wds]
    if len(lrs) != n or len(wds) != n:
        raise ValueError(f"lrs/wds must have one entry per weight "
                         f"({n}): got {len(lrs)}/{len(wds)}")
    return lrs, wds


def multi_sgd_update(*data, num_weights=None, rescale_grad=1.0,
                     clip_gradient=-1, out=None, **kw):
    """Interleaved [w0, g0, w1, g1, …] SGD."""
    n = num_weights or len(data) // 2
    lrs, wds = _lrs_wds(kw, n)
    cg = _cg(clip_gradient)

    def per_weight(i, w, g):
        gp = _prep(g, rescale_grad, cg)
        return (w - lrs[i] * (gp + wds[i] * w),)

    return _multi_update(data, 2, per_weight, "multi_sgd_update", n, out,
                         state_slots=())


def multi_sgd_mom_update(*data, num_weights=None, momentum=0.0,
                         rescale_grad=1.0, clip_gradient=-1, out=None,
                         **kw):
    """Interleaved [w0, g0, mom0, …] momentum SGD; moms rebound."""
    n = num_weights or len(data) // 3
    lrs, wds = _lrs_wds(kw, n)
    cg = _cg(clip_gradient)

    def per_weight(i, w, g, m):
        gp = _prep(g, rescale_grad, cg)
        new_m = momentum * m - lrs[i] * (gp + wds[i] * w)
        return (w + new_m, new_m)

    return _multi_update(data, 3, per_weight, "multi_sgd_mom_update", n,
                         out, state_slots=(2,))


def multi_mp_sgd_update(*data, num_weights=None, rescale_grad=1.0,
                        clip_gradient=-1, out=None, **kw):
    """Interleaved [w0, g0, w32_0, …] mixed-precision SGD."""
    n = num_weights or len(data) // 3
    lrs, wds = _lrs_wds(kw, n)
    cg = _cg(clip_gradient)

    def per_weight(i, w, g, w32):
        gp = _prep(g.float(), rescale_grad, cg)
        new_w32 = w32 - lrs[i] * (gp + wds[i] * w32)
        return (new_w32.to(w.dtype), new_w32)

    return _multi_update(data, 3, per_weight, "multi_mp_sgd_update", n,
                         out, state_slots=(2,))


def multi_mp_sgd_mom_update(*data, num_weights=None, momentum=0.0,
                            rescale_grad=1.0, clip_gradient=-1, out=None,
                            **kw):
    """Interleaved [w0, g0, mom0, w32_0, …] mixed-precision momentum
    SGD."""
    n = num_weights or len(data) // 4
    lrs, wds = _lrs_wds(kw, n)
    cg = _cg(clip_gradient)

    def per_weight(i, w, g, m, w32):
        gp = _prep(g.float(), rescale_grad, cg)
        new_m = momentum * m - lrs[i] * (gp + wds[i] * w32)
        new_w32 = w32 + new_m
        return (new_w32.to(w.dtype), new_m, new_w32)

    return _multi_update(data, 4, per_weight, "multi_mp_sgd_mom_update",
                         n, out, state_slots=(2, 3))


def _preloaded(data, group, num_weights, name, body, out, state_slots):
    """The ``preloaded_*`` variants: per-weight lrs and wds ride as the
    last two arrays."""
    n = num_weights or (len(data) - 2) // group
    if len(data) != n * group + 2:
        raise ValueError(f"{name}: expected {n * group} tensors + lrs + "
                         f"wds, got {len(data)}")
    tensors, lrs, wds = data[:-2], data[-2], data[-1]
    out = _check_out(out, n, name)

    def fn(*raw):
        *groups_flat, raw_lrs, raw_wds = raw
        outs = []
        for i in range(n):
            outs.extend(body(i, raw_lrs[i], raw_wds[i],
                             *groups_flat[i * group:(i + 1) * group]))
        return tuple(outs)

    return _deliver(_run(fn, list(tensors) + [lrs, wds]), tensors, group,
                    n, state_slots, out)


def preloaded_multi_sgd_update(*data, num_weights=None, rescale_grad=1.0,
                               clip_gradient=-1, out=None, **kw):
    cg = _cg(clip_gradient)

    def body(i, lr, wd, w, g):
        gp = _prep(g, rescale_grad, cg)
        return (w - lr * (gp + wd * w),)

    return _preloaded(data, 2, num_weights, "preloaded_multi_sgd_update",
                      body, out, state_slots=())


def preloaded_multi_sgd_mom_update(*data, num_weights=None, momentum=0.0,
                                   rescale_grad=1.0, clip_gradient=-1,
                                   out=None, **kw):
    cg = _cg(clip_gradient)

    def body(i, lr, wd, w, g, m):
        gp = _prep(g, rescale_grad, cg)
        new_m = momentum * m - lr * (gp + wd * w)
        return (w + new_m, new_m)

    return _preloaded(data, 3, num_weights,
                      "preloaded_multi_sgd_mom_update", body, out,
                      state_slots=(2,))


def preloaded_multi_mp_sgd_update(*data, num_weights=None,
                                  rescale_grad=1.0, clip_gradient=-1,
                                  out=None, **kw):
    cg = _cg(clip_gradient)

    def body(i, lr, wd, w, g, w32):
        gp = _prep(g.float(), rescale_grad, cg)
        new_w32 = w32 - lr * (gp + wd * w32)
        return (new_w32.to(w.dtype), new_w32)

    return _preloaded(data, 3, num_weights,
                      "preloaded_multi_mp_sgd_update", body, out,
                      state_slots=(2,))


def preloaded_multi_mp_sgd_mom_update(*data, num_weights=None,
                                      momentum=0.0, rescale_grad=1.0,
                                      clip_gradient=-1, out=None, **kw):
    cg = _cg(clip_gradient)

    def body(i, lr, wd, w, g, m, w32):
        gp = _prep(g.float(), rescale_grad, cg)
        new_m = momentum * m - lr * (gp + wd * w32)
        new_w32 = w32 + new_m
        return (new_w32.to(w.dtype), new_m, new_w32)

    return _preloaded(data, 4, num_weights,
                      "preloaded_multi_mp_sgd_mom_update", body, out,
                      state_slots=(2, 3))
