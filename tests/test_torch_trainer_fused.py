"""Fault C19, on the CPU: ``gluon.Trainer``'s fused update.

The reference's ``Trainer.update`` takes a fused branch when
``fuse_update`` is set, the optimizer overrides ``update_core`` only,
and there is more than one parameter: one jitted program that passes
each parameter's learning rate, weight decay and count as float32
arrays, so jax promotes a bfloat16 weight or state combined with them
to float32 and rounds each new weight once.  The port's fused branch
does the same in one eager loop.

Both packages hold the same bfloat16 ``Dense(16, in_units=32)`` (weight
and bias) and get the same bfloat16 gradients written into their
gradient buffers, three steps in a row, on the fused path and on the
per-parameter path, for each of the 16 optimizers with an
``update_core``.  Each state's dtype must be the reference's; float32
states agree to ``RTOL`` of their largest magnitude (XLA contracts a
product and a sum into one fused multiply-add where eager torch rounds
the product: a few float32 steps, large only beside elements near zero)
and bfloat16 ones (and the weights) to one bfloat16 step.  ``SGLD`` draws its noise from another generator than the
reference's key stream (the port's optimizer module says so), so only
its states' dtypes are compared.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import tpu_mx as jmx

import tpu_mx_torch as mx

RTOL = 1e-6
STEPS = 3

# Every hyperparameter (and one minus it) is a bfloat16 value: jax
# rounds a Python scalar to bfloat16 before it meets a bfloat16 array,
# torch computes the product in float32 first, so an inexact rate would
# part the two packages on either path before the promotion under test.
LR, WD, MOM, B1, B2, EPS = 2.0 ** -3, 2.0 ** -10, 0.875, 0.875, 0.9375, \
    2.0 ** -20
OPTIMIZERS = {
    "sgd": {"learning_rate": LR, "momentum": MOM, "wd": WD},
    "lbsgd": {"learning_rate": LR, "momentum": MOM, "wd": WD,
              "eta": 2.0 ** -3, "epsilon": EPS},
    "nag": {"learning_rate": LR, "momentum": MOM, "wd": WD},
    "adam": {"learning_rate": LR / 8, "beta1": B1, "beta2": B2,
             "epsilon": EPS, "wd": WD},
    "adamw": {"learning_rate": LR / 8, "beta1": B1, "beta2": B2,
              "epsilon": EPS, "wd": WD},
    "rmsprop": {"learning_rate": LR / 8, "gamma1": B1, "epsilon": EPS,
                "wd": WD},
    "adagrad": {"learning_rate": LR, "eps": EPS, "wd": WD},
    "adadelta": {"rho": B1, "epsilon": 2.0 ** -16, "wd": WD},
    "ftrl": {"learning_rate": LR, "lamda1": 2.0 ** -7, "wd": WD},
    "signum": {"learning_rate": LR / 8, "momentum": MOM, "wd_lh": WD},
    "lamb": {"learning_rate": LR / 8, "beta1": B1, "beta2": B2,
             "epsilon": EPS, "wd": WD},
    "dcasgd": {"learning_rate": LR, "momentum": MOM, "lamda": 2.0 ** -5,
               "wd": WD},
    "sgld": {"learning_rate": LR / 8},
    "adamax": {"learning_rate": LR / 8, "beta1": B1, "beta2": B2},
    "nadam": {"learning_rate": LR / 8, "beta1": B1, "beta2": B2,
              "epsilon": EPS},
    "ftml": {"learning_rate": LR / 8, "beta1": 0.625, "beta2": B2,
             "epsilon": EPS},
}


@pytest.fixture(autouse=True)
def _host():
    with mx.cpu():
        yield


def _bf16_grid(a):
    """float32 values that bfloat16 holds exactly."""
    return torch.from_numpy(np.asarray(a, np.float32)).bfloat16().float() \
        .numpy()


def _inputs():
    rng = np.random.RandomState(7)
    w = _bf16_grid(rng.randn(16, 32) * 0.2)
    b = _bf16_grid(rng.randn(16) * 0.2)
    grads = [(_bf16_grid(rng.randn(16, 32)), _bf16_grid(rng.randn(16)))
             for _ in range(STEPS)]
    return (w, b), grads


def _run(pkg, name, fuse):
    (w, b), grads = _inputs()
    net = pkg.gluon.nn.Dense(16, in_units=32)
    net.initialize()
    net.weight.set_data(pkg.nd.array(w))
    net.bias.set_data(pkg.nd.array(b))
    net.cast("bfloat16")
    params = list(net.collect_params().values())
    trainer = pkg.gluon.Trainer(net.collect_params(), name,
                                dict(OPTIMIZERS[name]), fuse_update=fuse)
    for gw, gb in grads:
        for p, g in zip(params, (gw, gb)):
            if pkg is mx:
                p.grad._data.copy_(torch.from_numpy(g))
            else:
                p.grad._rebind(jnp.asarray(g, jnp.bfloat16))
        trainer.step(1)
    weights = [p.data().astype("float32").asnumpy() for p in params]
    return weights, trainer._states


def _leaves(state):
    if state is None:
        return []
    if isinstance(state, (tuple, list)):
        return [x for s in state for x in _leaves(s)]
    return [state]


def _dtype(x):
    return str(x.dtype).replace("torch.", "")


def _numpy(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _ulp(x):
    """One bfloat16 step at each of ``x``'s magnitudes."""
    mag = np.maximum(np.abs(x), 2.0 ** -126)
    return 2.0 ** (np.floor(np.log2(mag)) - 7)


@pytest.mark.parametrize("fuse", [True, False], ids=["fused", "per_param"])
@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_states_and_weights_equal_the_references(name, fuse):
    want_w, want_s = _run(jmx, name, fuse)
    got_w, got_s = _run(mx, name, fuse)
    for got, want in zip(got_s, want_s):
        g, w = _leaves(got), _leaves(want)
        assert [_dtype(x) for x in g] == [_dtype(x) for x in w]
        if name == "sgld":
            continue
        for a, r in zip(g, w):
            f32 = _dtype(r) == "float32"
            a, r = _numpy(a), _numpy(r)
            tol = RTOL * np.abs(r).max() if f32 else _ulp(r)
            assert np.all(np.abs(a - r) <= tol), np.abs(a - r).max()
    if name == "sgld":
        return
    for g, w in zip(got_w, want_w):
        assert np.all(np.abs(g - w) <= _ulp(w)), np.abs(g - w).max()


def test_the_fused_branch_is_the_references_choice():
    from tpu_mx_torch.gluon import trainer as tr
    for name in OPTIMIZERS:
        cls = type(mx.optimizer.create(name))
        ref = type(jmx.optimizer.create(name))
        ref_pure = ref.update_core is not jmx.optimizer.Optimizer.update_core \
            and ref.update is jmx.optimizer.Optimizer.update \
            and ref.update_multi_precision is \
            jmx.optimizer.Optimizer.update_multi_precision
        assert tr._has_pure_core(cls) == ref_pure, name
