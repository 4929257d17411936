"""The port's optimizers and learning-rate schedulers against the
reference, on the CPU.

Every optimizer of ``optimizer`` (the 13 this slice adds, and SGD, Adam
and LAMB) runs three ``update_core`` steps from the same weight,
gradients and fresh state in both packages, each at two settings:
weights and every state tensor within 1e-5 relative after each step
(LBSGD and DCASGD keep history, so three steps, not one).  SGLD's noise
comes from a ``torch.Generator`` in the port and from the reference's
key stream: its deterministic part is held (each package's own noise,
re-drawn, taken away) and the port's noise by its moments.  The four
schedulers are held call by call; ``Optimizer(lr_scheduler=)``,
``Trainer`` and ``CompiledTrainStep`` follow one step by step, as the
reference's do.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_mx as mx
from tpu_mx import autograd as jag
from tpu_mx import gluon as jgluon
from tpu_mx import nd as jnd
from tpu_mx.optimizer import lr_scheduler as jsched
from tpu_mx.parallel import CompiledTrainStep as JCompiledTrainStep

import tpu_mx_torch as tmx
from tpu_mx_torch import autograd, gluon, nd, optimizer
from tpu_mx_torch.gluon.block import load_numpy
from tpu_mx_torch.optimizer import lr_scheduler as sched
from tpu_mx_torch.parallel import CompiledTrainStep

OPT_TOL = 1e-5


@pytest.fixture(autouse=True)
def _host():
    with tmx.cpu():
        yield


def _normal(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _close(got, want, tol=OPT_TOL, msg=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, msg
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * max(1.0, np.abs(want).max()),
                               err_msg=msg)


def _flat(state):
    if state is None:
        return []
    if isinstance(state, (tuple, list)):
        return [x for s in state for x in _flat(s)]
    return [np.asarray(state.numpy() if isinstance(state, torch.Tensor)
                       else state, np.float64)]


OPTIMIZERS = [
    ("sgd", dict(momentum=0.9, wd=1e-3)),
    ("sgd", dict(clip_gradient=0.5, rescale_grad=0.5)),
    ("adam", dict(wd=1e-3)),
    ("lamb", dict(wd=1e-2, lower_bound=0.1, upper_bound=10.0)),
    ("lbsgd", dict(momentum=0.9, wd=1e-3, warmup_epochs=1,
                   updates_per_epoch=2)),
    ("lbsgd", dict(warmup_strategy="none", eta=0.01)),
    ("nag", dict(momentum=0.9, wd=1e-3)),
    ("nag", dict(momentum=0.0)),
    ("adamw", dict(wd=1e-2)),
    ("adamw", dict(beta1=0.8, clip_gradient=0.3)),
    ("rmsprop", dict(wd=1e-3)),
    ("rmsprop", dict(centered=True, gamma2=0.8)),
    ("adagrad", dict(wd=1e-3)),
    ("adagrad", dict(eps=1e-4, rescale_grad=2.0)),
    ("adadelta", dict(wd=1e-3)),
    ("adadelta", dict(rho=0.5, epsilon=1e-3)),
    ("ftrl", dict(wd=1e-3)),
    ("ftrl", dict(lamda1=0.5, beta=2)),
    ("signum", dict(wd_lh=1e-2)),
    ("signum", dict(momentum=0.0)),
    ("dcasgd", dict(momentum=0.9, wd=1e-3)),
    ("dcasgd", dict(lamda=0.5)),
    ("adamax", dict(wd=1e-3)),
    ("adamax", dict(beta1=0.5, clip_gradient=0.2)),
    ("nadam", dict(wd=1e-3)),
    ("nadam", dict(schedule_decay=0.1)),
    ("ftml", dict(wd=1e-3)),
    ("ftml", dict(beta1=0.9)),
]


@pytest.mark.parametrize("case", OPTIMIZERS,
                         ids=[f"{c[0]}{i}" for i, c in enumerate(OPTIMIZERS)])
def test_three_update_core_steps_match_the_reference(case):
    name, kw = case
    jopt = mx.optimizer.create(name, learning_rate=0.05, **kw)
    opt = optimizer.create(name, learning_rate=0.05, **kw)
    w0 = _normal(5, 7)
    jw, tw = jnp.asarray(w0), torch.from_numpy(w0.copy())
    jstate = jopt.create_state(0, jnd.array(w0))
    tstate = opt.create_state(0, tw)
    for t in (1, 2, 3):
        g = _normal(5, 7, seed=t)
        lr, wd = 0.05 * t, opt.wd
        jw, jstate = jopt.update_core(jw, jnp.asarray(g), jstate, lr, wd, t)
        tw, tstate = opt.update_core(tw, torch.from_numpy(g), tstate, lr,
                                     wd, t)
        _close(tw.numpy(), np.asarray(jw), msg=f"{name} weight, step {t}")
        ours, theirs = _flat(tstate), _flat(jstate)
        assert len(ours) == len(theirs)
        for i, (a, b) in enumerate(zip(ours, theirs)):
            _close(a, b, msg=f"{name} state {i}, step {t}")


def test_sgld_deterministic_part_and_noise_moments():
    lr, shape = 0.04, (300, 350)
    w0, g0 = _normal(*shape), _normal(*shape, seed=1)
    opt = optimizer.create("sgld", learning_rate=lr,
                           generator=torch.Generator().manual_seed(5))
    twin = torch.Generator().manual_seed(5)
    jopt = mx.optimizer.create("sgld", learning_rate=lr)
    tw, jw = torch.from_numpy(w0.copy()), jnp.asarray(w0)
    noise = []
    for t in (1, 2, 3):
        tw, _ = opt.update_core(tw, torch.from_numpy(g0), None, lr, 0.0, t)
        jw, _ = jopt.update_core(jw, jnp.asarray(g0), None, lr, 0.0, t)
        n = torch.randn(shape, generator=twin).numpy()
        jn = np.asarray(jax.random.normal(jax.random.fold_in(
            jax.random.PRNGKey(0), jnp.asarray(t, jnp.int32)), shape,
            jnp.float32))
        noise.append(n)
        if t == 1:
            _close(tw.numpy() - math.sqrt(lr) * n,
                   np.asarray(jw) - math.sqrt(lr) * jn)
    drift = w0 - 3 * 0.5 * lr * g0
    _close(tw.numpy() - math.sqrt(lr) * sum(noise), drift, tol=1e-5)
    port_noise = (tw.numpy() - drift) / math.sqrt(lr)
    assert abs(port_noise.mean()) < 0.02
    assert abs(port_noise.std() - math.sqrt(3)) < 0.02


def test_multi_precision_runs_on_a_float32_master():
    """A bfloat16 weight's update runs on its float32 master, as the
    reference's does, for an optimizer with weight-typed state."""
    for name in ("nag", "rmsprop", "adamax"):
        opt = optimizer.create(name, learning_rate=0.1,
                               multi_precision=True)
        jopt = mx.optimizer.create(name, learning_rate=0.1,
                                   multi_precision=True)
        w0 = _normal(4, 6)
        tw = nd.array(w0, dtype="bfloat16")
        jw = jnd.cast(jnd.array(w0), "bfloat16")
        ts = opt.create_state_multi_precision(0, tw)
        js = jopt.create_state_multi_precision(0, jw)
        for t in range(3):
            g = _normal(4, 6, seed=t)
            ts = opt.update_multi_precision(0, tw, nd.array(g), ts)
            js = jopt.update_multi_precision(0, jw, jnd.array(g), js)
        _close(ts[0].numpy(), np.asarray(js[0]), msg=name)
        assert tw.dtype == torch.bfloat16


SCHEDULERS = [
    ("FactorScheduler", dict(step=3, factor=0.5, stop_factor_lr=1e-3)),
    ("FactorScheduler", dict(step=2, factor=0.9, warmup_steps=4,
                             warmup_begin_lr=0.01)),
    ("MultiFactorScheduler", dict(step=[2, 5, 9], factor=0.3)),
    ("MultiFactorScheduler", dict(step=[4, 6], factor=0.5, warmup_steps=3,
                                  warmup_mode="constant")),
    ("PolyScheduler", dict(max_update=12, pwr=2, final_lr=0.01)),
    ("PolyScheduler", dict(max_update=10, warmup_steps=3)),
    ("CosineScheduler", dict(max_update=12, final_lr=0.02)),
    ("CosineScheduler", dict(max_update=10, warmup_steps=2,
                             warmup_begin_lr=0.05)),
]


@pytest.mark.parametrize("case", SCHEDULERS,
                         ids=[f"{c[0]}{i}" for i, c in enumerate(SCHEDULERS)])
def test_scheduler_matches_the_reference_call_by_call(case):
    name, kw = case
    ours = getattr(sched, name)(base_lr=0.4, **kw)
    theirs = getattr(jsched, name)(base_lr=0.4, **kw)
    for n in range(16):
        assert ours(n) == pytest.approx(theirs(n), rel=1e-12), n


def _dense_pair(seed=0):
    jnet = jgluon.nn.Dense(3, in_units=4)
    np.random.seed(seed)
    jnet.initialize(init="xavier")
    net = gluon.nn.Dense(3, in_units=4)
    load_numpy(net, {k: np.array(p.data()._data)
                     for k, p in jnet.collect_params().items()})
    return jnet, net


@pytest.mark.parametrize("name", ["FactorScheduler", "MultiFactorScheduler",
                                  "PolyScheduler", "CosineScheduler"])
def test_trainer_and_compiled_step_follow_a_scheduler(name):
    kw = {"FactorScheduler": dict(step=1, factor=0.5),
          "MultiFactorScheduler": dict(step=[1, 2], factor=0.3),
          "PolyScheduler": dict(max_update=4),
          "CosineScheduler": dict(max_update=4)}[name]
    x, y = _normal(6, 4), _normal(6, 3, seed=1)
    # Trainer
    jnet, net = _dense_pair()
    jtr = jgluon.Trainer(jnet.collect_params(), "sgd", {
        "learning_rate": 0.2, "lr_scheduler": getattr(jsched, name)(**kw)})
    tr = gluon.Trainer(net.collect_params(), "sgd", {
        "learning_rate": 0.2, "lr_scheduler": getattr(sched, name)(**kw)})
    for _ in range(4):
        with jag.record():
            jl = jgluon.loss.L2Loss()(jnet(jnd.array(x)), jnd.array(y))
        jl.backward()
        jtr.step(6)
        with autograd.record():
            tl = gluon.loss.L2Loss()(net(nd.array(x)), nd.array(y))
        tl.backward()
        tr.step(6)
        assert tr.learning_rate == pytest.approx(jtr.learning_rate)
        _close(net.weight.data().asnumpy(), jnet.weight.data().asnumpy())
    # CompiledTrainStep: the t-th update at sched(t)
    jnet, net = _dense_pair()
    jstep = JCompiledTrainStep(jnet, jgluon.loss.L2Loss(),
                               mx.optimizer.create(
                                   "sgd", learning_rate=0.2,
                                   lr_scheduler=getattr(jsched, name)(**kw)))
    calls = []

    class Recorded(getattr(sched, name)):
        def __call__(self, num_update):
            calls.append(num_update)
            return super().__call__(num_update)

    step = CompiledTrainStep(net, gluon.loss.L2Loss(), optimizer.create(
        "sgd", learning_rate=0.2, lr_scheduler=Recorded(**kw)))
    for t in range(1, 5):
        jstep.step(jnd.array(x), jnd.array(y))
        step.step(torch.from_numpy(x), torch.from_numpy(y))
        _close(net.weight.detach().numpy(),
               np.asarray(jstep.values[jnet.weight.name]), msg=f"step {t}")
    assert calls == [1, 2, 3, 4]
