"""The port's training supervisor against the JAX reference, on the CPU.

``supervisor.py``'s training half: the numeric sentinel, the supervised
step (watchdog, chaos sites, the loss's read) and ``Supervisor.run``'s
recovery ladder.  The same pure-Python epoch function, under the same
scripted faults (transient, numeric, fatal, exhausted restarts, the
rollback budget, corruption, a hung step), gives the same
``SupervisorResult`` (wall times aside) and the same counters in both
packages.  The port's train step emits the flight recorder's phases in
the reference's order.  A job hard-killed after a committed step, and one
preempted by SIGTERM, resume in fresh processes with losses and weights
bit-equal to the uninterrupted run's (a tiny BERT, ``chip_smoke.py``'s
supervised job, which the card runs at full width).
"""
import os
import sys
import threading

import numpy as np
import pytest
import torch

import tpu_mx as jmx
from tpu_mx import gluon as jgluon
from tpu_mx import nd as jnd
from tpu_mx import supervisor as jsup
from tpu_mx import telemetry as jtelemetry
from tpu_mx import tracing as jtracing
from tpu_mx.contrib import chaos as jchaos
from tpu_mx.gluon import nn as jnn
from tpu_mx.parallel import CompiledTrainStep as JStep

import tpu_mx_torch as mx
from tpu_mx_torch import gluon, optimizer, supervisor, telemetry, tracing
from tpu_mx_torch.base import MXNetError
from tpu_mx_torch.contrib import chaos
from tpu_mx_torch.gluon import nn
from tpu_mx_torch.parallel import CompiledTrainStep

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402

PACKAGES = {"port": (supervisor, chaos, torch.tensor),
            "ref": (jsup, jchaos, np.float32)}


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    monkeypatch.delenv("TPUMX_CHAOS", raising=False)
    for mod in (tracing, telemetry, jtracing, jtelemetry):
        mod.reset()
    yield
    for mod in (tracing, telemetry, jtracing, jtelemetry):
        mod.reset()


SENTINEL_CASES = [
    (dict(skip_limit=2), [1.0, float("nan"), 1.1, float("inf"),
                          float("nan"), float("nan"), 0.9]),
    (dict(skip_limit=0), [1.0, 2.0, float("nan")]),
    (dict(skip_limit=1, spike_factor=3.0, window=8),
     [1.0, 1.1, 0.9, 1.05, 1.0, 0.95, 5.0, 1.0, 4.0, 4.0, 1.0]),
    (dict(skip_limit=1, max_grad_norm=10.0),
     [(1.0, 5.0), (1.0, 50.0), (1.0, float("nan")), (1.0, 2.0),
      (None, 3.0), (1.0, None)]),
]


@pytest.mark.parametrize("kw,seq", SENTINEL_CASES)
def test_the_sentinel_decides_as_the_reference(kw, seq):
    port, ref = supervisor.NumericSentinel(**kw), jsup.NumericSentinel(**kw)
    for x in seq:
        loss, gn = x if isinstance(x, tuple) else (x, None)
        assert port.observe(loss, grad_norm=gn) == \
            ref.observe(loss, grad_norm=gn), x
        assert port.state_dict() == ref.state_dict()
    state = port.state_dict()
    again = supervisor.NumericSentinel(**kw)
    again.load_state_dict(state)
    assert again.state_dict() == state
    port.reset()
    ref.reset()
    assert port.state_dict() == ref.state_dict()


def _script(pkg, scenario):
    """Run ``scenario`` through ``pkg``'s Supervisor: a pure-Python epoch
    function of 3 steps (losses from a fixed table, returned as the
    package's scalar), saves and restores recorded.  Returns the result
    (or the exception's type and message), the saves, the restores and
    the supervisor's counters."""
    sup_mod, ch, scalar = PACKAGES[pkg]
    saved, restored, attempts = [], [], {}
    faults = {
        "transient": {(1, 0): OSError("disk hiccup")},
        "exhausted_restarts": {(1, i): OSError("down") for i in range(9)},
        "numeric_budget": {(1, i): sup_mod.NumericDivergence("bad")
                           for i in range(9)},
        "fatal": {(1, 0): TypeError("bug")},
        "corruption": {(1, 0): sup_mod.DataCorruption(
            "vote", step=5, minority=(1,), verified_step=4)},
        "self_corrupt": {(1, 0): sup_mod.DataCorruption(
            "vote", step=5, minority=(0,), self_corrupt=True)},
        "watchdog": {}, "nan": {}, "clean": {},
    }[scenario]
    kw = dict(backoff=0.0, seed=3, max_restarts=2, max_rollbacks=1,
              skip_limit=1)
    if scenario == "watchdog":
        kw["deadline"] = 0.3
    sup = sup_mod.Supervisor(**kw)

    def save_fn(epoch):
        saved.append(epoch)

    def restore_fn():
        restored.append(len(saved))
        return saved[-1] + 1 if saved else 0

    sup.save_fn, sup.restore_fn = save_fn, restore_fn

    def epoch_fn(epoch):
        n = attempts.get(epoch, 0)
        attempts[epoch] = n + 1
        for i in range(3):
            loss = 1.0 + 0.1 * epoch - 0.01 * i
            sup.step(lambda loss=loss: scalar(loss))
            if (epoch, n) in faults and i == 1:
                raise faults[(epoch, n)]

    arms = {"nan": dict(nan_after=5, nan_streak=2),
            "watchdog": dict(hang_step=4, hang_seconds=2.0)}
    with ch.enable(**arms.get(scenario, {})):
        try:
            res = sup.run(epoch_fn, begin_epoch=0, num_epoch=3).as_dict()
        except Exception as e:  # noqa: BLE001 — compared across packages
            res = (type(e).__name__, str(e))
    # a hung step's abandoned thread wakes after hang_seconds and finishes
    # its step: let it end here, not inside a later test's timeline
    for t in threading.enumerate():
        if t.name.startswith("watchdog-"):
            t.join(10.0)
    counters = (sup.restarts, sup.rollbacks, sup.corruptions,
                sup.batches_skipped, sup.watchdog_fires, sup.steps,
                sup.generation, sup.sentinel.state_dict())
    return res, saved, restored, attempts, counters


SCENARIOS = ["clean", "transient", "exhausted_restarts", "numeric_budget",
             "fatal", "corruption", "self_corrupt", "nan", "watchdog"]


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_the_recovery_ladder_is_the_references(scenario):
    port = _script("port", scenario)
    ref = _script("ref", scenario)
    assert port == ref
    names = ("supervisor.restarts", "supervisor.rollbacks",
             "supervisor.corruptions", "supervisor.batches_skipped",
             "supervisor.watchdog_fires", "supervisor.degraded")
    got = [getattr(telemetry.get(n), "value", None) for n in names]
    want = [getattr(jtelemetry.get(n), "value", None) for n in names]
    assert got == want
    kinds = [e["data"]["kind"] for e in tracing.snapshot()
             if e["event"] == "supervisor.classify"]
    assert kinds == [e["data"]["kind"] for e in jtracing.snapshot()
                     if e["event"] == "supervisor.classify"]
    expected_status = {"exhausted_restarts": "degraded",
                       "numeric_budget": "degraded"}
    if scenario in ("fatal", "self_corrupt"):
        assert isinstance(port[0], tuple)
    else:
        assert port[0]["status"] == expected_status.get(scenario,
                                                        "completed")


def test_the_step_reads_a_tensor_loss_once_and_refuses_a_fleet(tmp_path):
    sup = supervisor.Supervisor()
    for value, want in ((torch.tensor(2.5), 2.5),
                        (torch.tensor([1.0, 3.0]), 2.0),
                        ((torch.tensor(1.0), torch.tensor(4.0)), 1.0),
                        (None, None)):
        assert supervisor._observable(value)[0] == want
    assert sup.step(lambda: torch.tensor(1.5)).item() == 1.5
    assert sup.steps == 1
    # a fleet's duty cycle runs at the step boundary, and a step under a
    # moved membership epoch is refused (MembershipChange)
    from tpu_mx_torch.parallel import fleet
    f = fleet.Fleet(tmp_path / "fleet", member=0, controller=True)
    f.advance(world=[0])
    f.join()
    try:
        fsup = supervisor.Supervisor(fleet=f)
        beat = f.members()[0]["beat"]
        assert fsup.step(lambda: torch.tensor(0.5)).item() == 0.5
        assert f.members()[0]["beat"] == beat + 1 and fsup.steps == 1
        f.advance(world=[0, 1], reason="scale-up")
        with pytest.raises(fleet.MembershipChange, match="generation 1 -> 2"):
            fsup.step(lambda: torch.tensor(0.5))
        assert fsup.steps == 1
    finally:
        fleet._live_world = None
        telemetry.set_fleet_identity(rank=None, generation=None)
        tracing.reset()
    # ported since: the Module surfaces (tests/test_torch_module.py runs
    # them through fit(supervised=))
    from tpu_mx_torch import resume
    assert callable(supervisor.for_module) and callable(resume.ModuleState)
    with pytest.raises(MXNetError, match="checkpoint prefix"):
        supervisor.for_module(object(), {})
    with pytest.raises(jmx.MXNetError, match="checkpoint prefix"):
        jsup.for_module(object(), {})
    cfg = supervisor.Supervise(prefix="ck", capsule_interval=2,
                               deadline=5.0)
    ref = jsup.Supervise(prefix="ck", capsule_interval=2, deadline=5.0)
    assert vars(cfg) == vars(ref)
    assert supervisor.TRANSIENT_EXCEPTIONS[:3] == \
        jsup.TRANSIENT_EXCEPTIONS[:3]


def _phases(tr):
    return [e["data"]["phase"] for e in tr.snapshot()
            if e["event"] == "train_step.phase"]


def test_the_steps_phases_are_the_references_in_order():
    assert tracing.TRAIN_STEP_PHASES == jtracing.TRAIN_STEP_PHASES
    x = np.random.RandomState(0).rand(4, 4).astype(np.float32)
    y = np.zeros((4, 2), np.float32)
    jnet = jnn.Dense(2, in_units=4)
    jnet.initialize()
    jstep = JStep(jnet, jgluon.loss.L2Loss(),
                  jmx.optimizer.create("sgd", learning_rate=0.1))
    with mx.cpu():
        net = nn.Dense(2, in_units=4)
        net.initialize()
    step = CompiledTrainStep(net, gluon.loss.L2Loss(),
                             optimizer.create("sgd", learning_rate=0.1),
                             device="cpu")
    for s, tr, sup_mod, args in (
            (step, tracing, supervisor, (torch.from_numpy(x),
                                         torch.from_numpy(y))),
            (jstep, jtracing, jsup, (jnd.array(x), jnd.array(y)))):
        sup = sup_mod.Supervisor()
        for _ in range(2):
            sup.step(lambda: s.step(*args))
        s.step(*args, deadline=30.0)
    assert _phases(tracing) == _phases(jtracing) == [
        "data_wait", "recompile", "dispatch", "optimizer_update",
        "loss_readback", "data_wait", "dispatch", "optimizer_update",
        "loss_readback", "data_wait", "dispatch", "optimizer_update",
        "loss_readback"]


def test_a_killed_and_a_preempted_job_resume_bit_for_bit(tmp_path):
    """``chip_smoke.py``'s supervised job at a tiny BERT on the CPU: run
    A uninterrupted (2 epochs of 4 steps, a step capsule every 2); run B
    hard-killed (``crash_at_step=6,hard=1``: exit 137) and resumed by a
    fresh process C at epoch 1 step 3; run D sent SIGTERM after step 3
    (one emergency capsule, exit 143) and resumed at step 4.  The
    resumed losses, final fingerprint and every weight are A's bit for
    bit, and every epoch's manifest verifies."""
    cfg = dict(num_layers=2, units=32, hidden_size=64, num_heads=2,
               vocab_size=60, max_length=16, dropout=0.1)
    spec = dict(device="cpu", cfg=cfg, dtype="float32", batch=4, seq=16,
                masked=3, valid=[8, 16], interval=2, save_values=True)
    runs = chip_smoke.supervised_runs(spec, str(tmp_path), timeout=240)
    checks = chip_smoke.supervised_resume_checks(
        runs, chip_smoke.SUP_CRASH_STEP, chip_smoke.SUP_PREEMPT_STEP,
        chip_smoke.SUP_STEPS)
    assert all(checks.values()), (checks, {k: r["stderr"][-600:]
                                           for k, r in runs.items()})
    want = np.load(str(tmp_path / "A.json") + ".npz")
    for name in ("C", "D_resume"):
        got = np.load(str(tmp_path / f"{name}.json") + ".npz")
        assert want.files == got.files
        for k in want.files:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
