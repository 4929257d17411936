"""The port's resume capsules against the JAX reference, on the CPU.

``resume.py``'s ``CapsuleManager``: the epoch capsule and the rolling
step capsule with its train-state sidecar.  The same job (a Dense net, a
seeded shuffling ``NDArrayIter``, a supervisor) writes capsules with the
same keys and format strings, the same iterator state and supervisor
ledger, and each package reads the other's capsule.  The restore takes
the same recovery point in both for the same files: the step capsule,
the epoch capsule when the sidecar is torn, nothing on a numeric
rollback.  A bfloat16 step's sidecar (values, float32 masters, optimizer
state) comes back bit for bit.
"""
import json
import os

import numpy as np
import pytest
import torch

import tpu_mx as jmx
from tpu_mx import gluon as jgluon
from tpu_mx import resume as jresume
from tpu_mx import supervisor as jsup
from tpu_mx import telemetry as jtelemetry
from tpu_mx import tracing as jtracing
from tpu_mx.gluon import nn as jnn
from tpu_mx.parallel import CompiledTrainStep as JStep

import tpu_mx_torch as mx
from tpu_mx_torch import gluon, optimizer, resume, supervisor, telemetry
from tpu_mx_torch import tracing
from tpu_mx_torch.base import MXNetError
from tpu_mx_torch.gluon import nn
from tpu_mx_torch.parallel import CompiledTrainStep

X = np.random.RandomState(0).rand(16, 4).astype(np.float32)
Y = (X.sum(1) > 2).astype(np.float32)


@pytest.fixture(autouse=True)
def _fresh():
    for mod in (tracing, telemetry, jtracing, jtelemetry):
        mod.reset()
    yield
    for mod in (tracing, telemetry, jtracing, jtelemetry):
        mod.reset()


W = np.random.RandomState(2).uniform(-0.5, 0.5, (2, 4)).astype(np.float32)
B = np.array([0.1, -0.1], np.float32)


def _job(pkg, prefix, interval=2):
    """A Dense net's step (the same weights in both packages), a
    shuffling iterator over 16 samples (batch 4), a capsule manager and a
    supervisor, in ``pkg``."""
    if pkg == "port":
        with mx.cpu():
            net = nn.Dense(2, in_units=4)
            net.initialize()
            net.weight.set_data(mx.nd.array(W))
            net.bias.set_data(mx.nd.array(B))
            it = mx.io.NDArrayIter(X, Y, batch_size=4, shuffle=True,
                                   last_batch_handle="discard", seed=11)
        step = CompiledTrainStep(net, gluon.loss.SoftmaxCrossEntropyLoss(),
                                 optimizer.create("sgd", learning_rate=0.1,
                                                  momentum=0.9),
                                 device="cpu")
        res, sup_mod = resume, supervisor
    else:
        net = jnn.Dense(2, in_units=4)
        net.initialize()
        net.weight.set_data(jmx.nd.array(W))
        net.bias.set_data(jmx.nd.array(B))
        it = jmx.io.NDArrayIter(X, Y, batch_size=4, shuffle=True,
                                last_batch_handle="discard", seed=11)
        step = JStep(net, jgluon.loss.SoftmaxCrossEntropyLoss(),
                     jmx.optimizer.create("sgd", learning_rate=0.1,
                                          momentum=0.9))
        res, sup_mod = jresume, jsup
    mgr = res.CapsuleManager(prefix, iters=[it], state=step,
                             interval=interval)
    sup = sup_mod.Supervisor(capsule=mgr, backoff=0.0)
    return dict(step=step, it=it, mgr=mgr, sup=sup, res=res)


def _advance(job, n, epoch=0):
    """``n`` supervised steps from the iterator's head (the supervisor's
    cursor inside ``epoch``)."""
    job["sup"]._epoch = epoch
    job["sup"]._step_in_epoch = 0
    job["it"].reset()
    ctx = mx.cpu() if job["res"] is resume else _null()
    with ctx:
        for _ in range(n):
            b = next(job["it"])
            job["sup"].step(lambda b=b: job["step"].step(b.data[0],
                                                         b.label[0]))


class _null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def _strip(cap):
    """A capsule without what differs by design: the wall time and the
    RNG token (the port's generators, the reference's jax key)."""
    return {k: v for k, v in cap.items() if k not in ("wall_time", "rng")}


def test_the_capsules_are_the_references(tmp_path):
    jobs = {pkg: _job(pkg, str(tmp_path / pkg)) for pkg in ("port", "ref")}
    caps, steps = {}, {}
    for pkg, job in jobs.items():
        _advance(job, 3)
        path = job["mgr"].write_epoch_file(0)
        with open(path) as f:
            caps[pkg] = json.load(f)
        job["mgr"].write_step()
        with open(job["res"].step_capsule_path(job["mgr"].prefix)) as f:
            steps[pkg] = json.load(f)
    assert resume.CAPSULE_FORMAT == jresume.CAPSULE_FORMAT
    assert resume.CAPSULE_FORMATS == jresume.CAPSULE_FORMATS
    assert resume.CAPSULE_FORMAT_V1 == jresume.CAPSULE_FORMAT_V1
    for got in (caps, steps):
        assert set(got["port"]) == set(got["ref"])
        port, ref = _strip(got["port"]), _strip(got["ref"])
        # the iterator's state: same cursor, permutation and shuffle stream
        assert resume.decode_state(port.pop("iters")) == \
            [_np_equal(s) for s in jresume.decode_state(ref.pop("iters"))]
        sf_port, sf_ref = port.pop("state_file", None), \
            ref.pop("state_file", None)
        assert (sf_port is None) == (sf_ref is None)
        if sf_port is not None:
            assert set(sf_port) == set(sf_ref) == {"name", "size",
                                                   "sha256"}
            assert sf_port["name"].split("-", 1)[1] == \
                sf_ref["name"].split("-", 1)[1]
        assert port == ref
    assert caps["port"]["step"] == steps["port"]["step"] == 3
    # each package reads the other's capsules
    for pkg, job in jobs.items():
        for reader in (resume, jresume):
            for path in (resume.capsule_path(job["mgr"].prefix, 0),
                         resume.step_capsule_path(job["mgr"].prefix)):
                cap = reader.read_capsule(path)
                assert cap is not None and cap["format"] == \
                    resume.CAPSULE_FORMAT
    assert resume.capsule_path("p", 7) == jresume.capsule_path("p", 7)
    assert resume.step_capsule_path("p") == jresume.step_capsule_path("p")
    assert resume.step_state_path("p") == jresume.step_state_path("p")


class _np_equal:
    """Compares a decoded state tree by value (numpy arrays and lists
    alike)."""

    def __init__(self, tree):
        self.tree = tree

    def __eq__(self, other):
        return _same(self.tree, other)


def _same(a, b):
    if isinstance(a, dict):
        return isinstance(b, dict) and set(a) == set(b) and all(
            _same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)) or isinstance(b, (list, tuple)):
        if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
            return np.array_equal(np.asarray(a), np.asarray(b))
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return np.array_equal(np.asarray(a), np.asarray(b))
    return a == b


def _restore_case(pkg, tmp_path, case):
    job = _job(pkg, str(tmp_path / f"{pkg}-{case}"))
    mgr, res = job["mgr"], job["res"]
    if case != "nothing":
        _advance(job, 4)
        mgr.write_epoch_file(0)
        _advance(job, 2, epoch=1)
        mgr.write_step()
    if case == "torn_sidecar":
        with open(res.step_state_path(mgr.prefix), "r+b") as f:
            f.truncate(10)
    if case == "stale_step":
        return mgr.restore(job["sup"], resume_from=2, use_step=True), None
    out = mgr.restore(job["sup"], resume_from=1 if case != "nothing" else 0,
                      use_step=case != "numeric")
    return out, job["sup"].resume_step(0), job["it"].state_dict()["cursor"]


@pytest.mark.parametrize("case", ["step", "torn_sidecar", "numeric",
                                  "nothing", "stale_step"])
def test_the_restore_takes_the_references_recovery_point(tmp_path, case):
    got = {}
    for pkg, tr, tel in (("port", tracing, telemetry),
                         ("ref", jtracing, jtelemetry)):
        result = _restore_case(pkg, tmp_path, case)
        restore = [e["data"] for e in tr.snapshot()
                   if e["event"] == "resume.capsule_restore"][-1]
        got[pkg] = (result, restore,
                    tel.get("resume.resume_step_gap").value)
    assert got["port"] == got["ref"]
    assert got["port"][1]["used"] == {
        "step": "step", "torn_sidecar": "epoch", "numeric": "discarded",
        "nothing": "none", "stale_step": "none"}[case]


def test_a_bfloat16_sidecar_comes_back_bit_for_bit(tmp_path):
    with mx.cpu():
        net = nn.Dense(3, in_units=5)
        net.initialize()
        net.cast("bfloat16")
    opt = optimizer.create("lamb", learning_rate=0.01, multi_precision=True)
    step = CompiledTrainStep(net, gluon.loss.L2Loss(), opt, device="cpu")
    x = torch.from_numpy(np.random.RandomState(1).rand(4, 5)
                         .astype(np.float32)).bfloat16()
    y = torch.zeros(4, 3, dtype=torch.bfloat16)
    for _ in range(2):
        step.step(x, y)
    prefix = str(tmp_path / "bf")
    mgr = resume.CapsuleManager(prefix, state=step, interval=1)
    mgr.write_step()
    before = step.state_dict()
    step.step(x, y)                      # move on, then restore
    assert mgr.restore(resume_from=0) == 0
    after = step.state_dict()
    for part in ("values", "masters"):
        for k, v in before[part].items():
            assert after[part][k].dtype == v.dtype
            assert torch.equal(after[part][k].view(torch.int16)
                               if v.dtype == torch.bfloat16
                               else after[part][k], v.view(torch.int16)
                               if v.dtype == torch.bfloat16 else v), k
    for k, s in before["opt_states"].items():
        for a, b in zip(after["opt_states"][k], s):
            assert torch.equal(a, b)
    assert after["t"] == before["t"] == 2


def test_the_manager_refuses_what_it_cannot_carry(tmp_path):
    # a fleet it now carries: the world map is the adopted epoch's
    from tpu_mx_torch import telemetry, tracing
    from tpu_mx_torch.parallel import fleet
    f = fleet.Fleet(tmp_path / "fl", member=1, controller=True)
    f.advance(world=[0, 1])
    f.join()
    try:
        mgr = resume.CapsuleManager(str(tmp_path / "f"), fleet=f)
        assert mgr._world() == {"num_workers": 2, "rank": 1,
                                "generation": 1}
    finally:
        fleet._live_world = None
        telemetry.set_fleet_identity(rank=None, generation=None)
        tracing.reset()
    with pytest.raises(MXNetError, match="checkpoint prefix"):
        resume.CapsuleManager("")

    class NoState:
        def state_dict(self):
            raise NotImplementedError("native pipe")
    with pytest.raises(MXNetError, match="cannot snapshot"):
        resume.CapsuleManager(str(tmp_path / "g"), iters=[NoState()])
    with pytest.raises(MXNetError, match="cannot encode"):
        resume.encode_state(object())
    tree = {"a": np.arange(6, dtype=np.float16).reshape(2, 3), "b": [1, 2.5],
            "c": {"d": None, "e": "s"}}
    back = resume.decode_state(json.loads(json.dumps(
        resume.encode_state(tree))))
    assert json.dumps(resume.encode_state(tree)) == \
        json.dumps(jresume.encode_state(tree))
    np.testing.assert_array_equal(back["a"], tree["a"])
    assert back["a"].dtype == np.float16
    assert os.path.basename(resume.step_state_path(str(tmp_path / "g"))) \
        == "g-step.capsule.state"
