"""Elastic fleet membership in the port (``tpu_mx_torch/parallel/fleet.py``)
on the CPU: the reference's membership tests (``tests/test_fleet.py``)
through the port, both packages reading a fleet directory the other
wrote, the reference's ``tools/fleet_report.py`` (unedited) rendering a
fleet black box the port wrote, ``reshard_live`` bit-exact at world size
1, the ``fleet=`` wiring of the supervisor, the capsules and the kvstore,
and the port's launcher (``python -m tpu_mx_torch.tools.launch``) as a
supervising controller.  The kill-and-rejoin proof is ``slow``, as the
reference's is; ``chip_smoke.py``'s ``fleet`` phase runs it on the card.
"""
import json
import os
import signal
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

from tpu_mx import telemetry as jtelemetry
from tpu_mx import tracing as jtracing
from tpu_mx.parallel import fleet as jfleet
from tpu_mx.parallel import fleet_obs as jfleet_obs

import tpu_mx_torch as mx
from tpu_mx_torch import elastic, gluon, nd, resume, supervisor, telemetry
from tpu_mx_torch import tracing
from tpu_mx_torch.contrib import chaos
from tpu_mx_torch.io import NDArrayIter
from tpu_mx_torch.parallel import fleet as fleet_mod
from tpu_mx_torch.parallel import fleet_obs
from tpu_mx_torch.parallel.fleet import Fleet, MembershipChange
from tpu_mx_torch.tools import launch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean_fleet_state():
    """A fleet observation is process-global (the kvstore's world, the
    telemetry and trace identity stamps): drop it after every test."""
    with mx.cpu():
        yield
    for fl, tel, tr in ((fleet_mod, telemetry, tracing),
                        (jfleet, jtelemetry, jtracing)):
        fl._live_world = None
        tel.set_fleet_identity(rank=None, generation=None)
        tr.reset()


def _cval(name, **labels):
    m = telemetry.get(name, **labels)
    return 0 if m is None else m.value


# -- the membership-epoch protocol ---------------------------------------------
def test_membership_epoch_lifecycle(tmp_path):
    """Launch -> lose a worker (lease expiry) -> quiesce -> reshard ->
    rejoin at the next epoch: the whole protocol on one store."""
    root = tmp_path / "fleet"
    f0 = Fleet(root, member=0, controller=True, lease=0.2)
    assert f0.generation == 0 and f0.world() == []
    ep = f0.advance(world=[0, 1], reason="launch")
    assert ep["generation"] == 1 and ep["world"] == [0, 1]
    assert f0.lost() == []              # worker 1 pending, not lost
    f0.join()
    assert f0.acked_generation == 1 and f0.shard() == (0, 2)
    assert telemetry.fleet_identity() == (0, 1)
    assert tracing.get_context()["fleet_generation"] == 1
    f1 = Fleet(root, member=1, lease=0.2)
    f1.join()
    assert f1.shard() == (1, 2)
    assert sorted(f0.live()) == [0, 1]

    time.sleep(0.3)                     # worker 1 goes silent
    f0.heartbeat()
    assert f0.lost() == [1]
    ep = f0.reconcile()
    assert ep["generation"] == 2 and ep["world"] == [0]
    with pytest.raises(MembershipChange) as ei:
        f0.check()
    assert ei.value.generation == 2 and ei.value.world_size == 1
    assert isinstance(ei.value, elastic.WorkerFailure)
    f0.ack()
    assert f0.shard() == (0, 1)
    f0.check()

    f1.join()                           # back: pending until the next epoch
    assert f1.acked_generation == 1
    assert f0.joiners() == [1]
    ep = f0.reconcile()
    assert ep["generation"] == 3 and ep["world"] == [0, 1]
    assert ep["reason"] == "rejoin"
    f1.await_admission(timeout=5)
    assert f1.acked_generation == 3 and f1.shard() == (1, 2)
    with pytest.raises(MembershipChange):
        f0.on_step()
    f0.ack()
    assert f0.shard() == (0, 2)
    kinds = [e["event"] for e in tracing.snapshot()]
    for want in ("fleet.epoch", "fleet.join", "fleet.lost", "fleet.rejoin"):
        assert want in kinds


def test_fleet_handle_misuse_from_env_and_clean_leave(tmp_path):
    f = Fleet(tmp_path / "f", controller=True)
    with pytest.raises(ValueError):
        f.join()
    with pytest.raises(elastic.WorkerFailure):
        f.ack()
    w = Fleet(tmp_path / "f", member=3)
    w.join()
    with pytest.raises(elastic.WorkerFailure):
        w.shard()
    env = {fleet_mod.ENV_DIR: str(tmp_path / "fl"),
           fleet_mod.ENV_MEMBER: "2", fleet_mod.ENV_LEASE: "3.5"}
    f = Fleet.from_env(env)
    assert (f.member, f.lease) == (2, 3.5)
    assert Fleet.from_env({}) is None
    # a clean leaver withdraws its record: pending, not lost
    root = tmp_path / "g"
    f0 = Fleet(root, member=0, controller=True, lease=0.2)
    f0.advance(world=[0, 1])
    f0.join()
    f1 = Fleet(root, member=1, lease=0.2)
    f1.join()
    f1.leave()
    time.sleep(0.25)
    f0.heartbeat()
    assert f0.lost() == [] and f0.reconcile() is None


def test_barrier_tags_and_refuses_a_stale_generation(tmp_path):
    f = Fleet(tmp_path / "f", member=0, controller=True, lease=5.0)
    f.advance(world=[0], reason="launch")
    f.join()
    assert f.barrier_tag("grads") == "grads@1"
    elastic.barrier("grads", fleet=f)
    f.advance(world=[0, 1], reason="scale-up")
    with pytest.raises(elastic.WorkerFailure,
                       match="stale fleet generation 1"):
        elastic.barrier("grads", fleet=f)
    f.ack()
    assert f.barrier_tag("grads") == "grads@2"
    elastic.barrier("grads", fleet=f)


def test_quarantine_is_permanent(tmp_path):
    root = tmp_path / "f"
    ctl = Fleet(root, controller=True, lease=5.0)
    ctl.advance(world=[0, 1])
    w1 = Fleet(root, member=1, lease=5.0)
    w1.join()
    rec = ctl.quarantine(1, reason="bit flip", step=7)
    assert rec["member"] == 1 and ctl.is_quarantined(1)
    assert ctl.world() == [0] and ctl.read_epoch()["reason"] == "quarantine"
    w1.heartbeat()                      # a zombie still beating
    assert ctl.reconcile() is None or 1 not in ctl.world()
    with pytest.raises(elastic.WorkerFailure, match="quarantined"):
        ctl.admit(1)
    assert 1 not in ctl.world() and _cval("integrity.quarantined") >= 1


# -- capsules, the kvstore and the chaos knobs ----------------------------------
_X = np.arange(64, dtype=np.float32).reshape(64, 1)


def _iter(num_workers=1, rank=0):
    return NDArrayIter(_X, batch_size=8, shuffle=True, seed=5,
                       last_batch_handle="discard",
                       num_workers=num_workers, rank=rank)


def test_capsule_v2_records_the_world(tmp_path):
    it = _iter(2, 0)
    mgr = resume.CapsuleManager(str(tmp_path / "run"), iters=[it])
    cap = resume.read_capsule(mgr.write_epoch_file(3))
    assert cap["format"] == resume.CAPSULE_FORMAT
    assert cap["world"] == {"num_workers": 2, "rank": 0, "generation": 0}
    f = Fleet(tmp_path / "fl", member=1, controller=True, lease=5.0)
    f.advance(world=[0, 1])
    f.join()
    mgr = resume.CapsuleManager(str(tmp_path / "run2"), iters=[it], fleet=f)
    cap = resume.read_capsule(mgr.write_epoch_file(0))
    assert cap["world"] == {"num_workers": 2, "rank": 1, "generation": 1}


def test_kvstore_world_follows_the_membership_epoch(tmp_path):
    kv = mx.kvstore.create("dist_sync")
    assert kv.num_workers == 1
    f = Fleet(tmp_path / "fl", member=0, controller=True, lease=5.0)
    f.advance(world=[0, 1, 2, 3])
    f.join()
    assert kv.num_workers == 4
    f.advance(world=[0, 1])
    f.ack()
    assert kv.num_workers == 2
    fleet_mod._live_world = None
    assert mx.kvstore.create("dist_sync").num_workers == 1


def test_chaos_partition_and_preempt(tmp_path):
    f = Fleet(tmp_path / "f", member=1, controller=True, lease=5.0)
    f.advance(world=[1])
    f.join()
    beat0 = f.members()[1]["beat"]
    with chaos.enable(partition_worker=1):
        assert chaos.partitioned(1) and not chaos.partitioned(0)
        f.heartbeat()                   # dropped: the absence is the fault
        assert f.members()[1]["beat"] == beat0
    f.heartbeat()
    assert f.members()[1]["beat"] == beat0 + 1
    fired = []
    prev = signal.signal(signal.SIGTERM, lambda s, _f: fired.append(s))
    try:
        with chaos.enable(preempt_worker_at_step=2, preempt_rank=2) as cfg:
            chaos.maybe_preempt(2)
            chaos.maybe_preempt(0)
            assert not fired
            chaos.maybe_preempt(2)
            time.sleep(0.05)
            assert fired == [signal.SIGTERM] and cfg.preempts == 1
    finally:
        signal.signal(signal.SIGTERM, prev)


# -- the supervisor -------------------------------------------------------------
def test_supervisor_classifies_membership_not_fault(tmp_path):
    """A peer dies mid-collective: the step raises a plain WorkerFailure,
    the lease expires, and the supervisor reshards through restore_fn
    under the new world without spending its restart budget."""
    root = tmp_path / "fleet"
    f0 = Fleet(root, member=0, controller=True, lease=0.15)
    f0.advance(world=[0, 1], reason="launch")
    f0.join()
    Fleet(root, member=1, lease=0.15).join()   # never beats again
    reshards0 = _cval("fleet.reshards")
    worlds = []

    def restore_fn():
        worlds.append(f0.acked_world_size)
        return 0

    state = {"attempt": 0}

    def one_step():
        state["attempt"] += 1
        if state["attempt"] == 1:
            time.sleep(0.4)
            f0.heartbeat()
            raise elastic.WorkerFailure("barrier 'grads@1' timed out")
        return 0.25

    sup = supervisor.Supervisor(None, restore_fn, fleet=f0, max_restarts=0,
                                resume=False, backoff=0.0)

    def epoch_fn(_epoch):
        for _ in range(2):
            sup.step(one_step)

    res = sup.run(epoch_fn, num_epoch=1)
    assert res.status == "completed" and res.restarts == 0
    assert worlds == [1]
    assert f0.acked_generation == 2 and f0.acked_world_size == 1
    assert _cval("fleet.reshards") == reshards0 + 1
    reshard = [e for e in tracing.snapshot() if e["event"] == "fleet.reshard"]
    assert reshard[-1]["data"] == {"generation": 2, "from_world": 2,
                                   "to_world": 1, "source": "manifest"}


def test_a_self_corrupt_rank_quarantines_itself(tmp_path):
    from tpu_mx_torch.parallel.integrity import DataCorruption
    root = tmp_path / "fleet"
    f = Fleet(root, member=1, controller=True, lease=5.0)
    f.advance(world=[0, 1])
    f.join()

    def epoch_fn(_epoch):
        e = DataCorruption("voted out at step 3")
        e.self_corrupt, e.step = True, 3
        raise e

    sup = supervisor.Supervisor(None, lambda: 0, fleet=f, resume=False)
    with pytest.raises(DataCorruption):
        sup.run(epoch_fn, num_epoch=1)
    q = f.quarantined()
    assert list(q) == [1] and q[1]["step"] == 3
    assert f.world() == [0]


# -- the reshard seam -----------------------------------------------------------
def _step():
    from tpu_mx_torch import optimizer
    from tpu_mx_torch.parallel import CompiledTrainStep
    mx.random.seed(123)
    net = gluon.nn.HybridSequential()
    net.add(gluon.nn.Dense(8, in_units=4, activation="relu"),
            gluon.nn.Dense(2, in_units=8))
    net.initialize()
    net(nd.ones((1, 4)))
    return CompiledTrainStep(net, gluon.loss.SoftmaxCrossEntropyLoss(),
                             optimizer.create("sgd", learning_rate=0.1,
                                              momentum=0.9), device="cpu")


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in sorted(tree, key=str) for t in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v)]
    return []


def test_reshard_live_round_trips_bit_exact_at_world_one():
    rng = np.random.RandomState(7)
    x = torch.from_numpy(rng.rand(8, 4).astype(np.float32))
    y = torch.from_numpy(rng.randint(0, 2, (8,)).astype(np.float32))
    step = _step()
    for _ in range(3):
        step.step(x, y)                   # momentum buffers move off zero
    ref = [t.clone() for t in _leaves(step.state_dict())]
    reshards0 = _cval("fleet.reshards")
    one = fleet_mod.reshard_live(step, _step, from_world=1, to_world=1)
    back = fleet_mod.reshard_live(one, _step, from_world=1, to_world=1)
    assert _cval("fleet.reshards") == reshards0 + 2
    got = _leaves(back.state_dict())
    assert len(got) == len(ref) > 4
    for a, b in zip(ref, got):
        assert torch.equal(a, b)
    # the two steps continue identically
    la, lb = float(step.step(x, y)), float(back.step(x, y))
    assert la == lb
    # a mesh above one rank needs the ranks' process group (the reshard
    # onto two ranks: tests/test_torch_mesh_train.py)
    from tpu_mx_torch.parallel import make_mesh
    with pytest.raises(mx.MXNetError, match="no process group"):
        fleet_mod.reshard_live(step, lambda: make_mesh({"dp": 2}),
                               from_world=1, to_world=2)


# -- each package reads the other's fleet directory -----------------------------
def _write_fleet(fl, root):
    ctl = fl.Fleet(root, controller=True, lease=30.0)
    ctl.advance(world=[0, 1, 2], reason="launch")
    for m in (0, 1, 2):
        fl.Fleet(root, member=m, lease=30.0).join()
    ctl.evict(2, reason="exit=143")
    ctl.quarantine(1, reason="vote", step=4)
    return ctl


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_each_package_reads_the_others_fleet_directory(tmp_path, writer):
    w, r = (fleet_mod, jfleet) if writer == "port" else (jfleet, fleet_mod)
    root = tmp_path / "fleet"
    _write_fleet(w, root)
    reader = r.Fleet(root, controller=True, lease=30.0)
    same = w.Fleet(root, controller=True, lease=30.0)
    assert reader.read_epoch() == same.read_epoch()
    assert reader.generation == 3 and reader.world() == [0]
    assert sorted(reader.members()) == [0] == sorted(same.members())
    assert reader.quarantined() == same.quarantined()
    assert reader.is_quarantined(1) and not reader.is_quarantined(0)
    assert set(json.loads((root / "gen.json").read_text())) == {
        "format", "generation", "world", "world_size", "reason",
        "wall_time"}
    # and the reader carries on the same store: admit 2, a worker adopts
    reader.admit(2)
    rw = r.Fleet(root, member=2, lease=30.0)
    rw.join()
    assert rw.shard() == (1, 2) and same.generation == 4


def _port_fleet_blackbox(tmp_path):
    """Ship two port ranks (rank 1 straggling), aggregate, dump."""
    root = tmp_path / "fleet"
    ctl = Fleet(root, controller=True, lease=5.0)
    ctl.advance(world=[0, 1], reason="launch")
    for rank in (0, 1):
        telemetry.reset()
        tracing.reset()
        w = Fleet(root, member=rank, lease=5.0)
        w.join()
        telemetry.counter("train_step.steps").inc(10 + rank)
        for s in range(6):
            tracing.set_context(epoch=0, step=s)
            for ph, sec in (("data_wait", 0.01 + (0.25 if rank else 0.0)),
                            ("dispatch", 0.005)):
                tracing.emit("train_step.phase", phase=ph, seconds=sec)
        fleet_obs.ObsShipper(w).ship(force=True)
        w.leave()
    telemetry.reset()
    tracing.reset()
    agg = fleet_obs.FleetAggregator(ctl)
    return ctl, fleet_obs.dump_fleet_blackbox(ctl.root, reason="test",
                                              aggregator=agg)


@pytest.mark.parametrize("tool", ["reference", "port"])
def test_fleet_report_renders_a_black_box_the_port_wrote(tmp_path, tool):
    """The reference's tools/fleet_report.py (unedited, no jax) and the
    port's (no torch) render and validate the port's fleet black box."""
    _, path = _port_fleet_blackbox(tmp_path)
    script = os.path.join(REPO, "tools", "fleet_report.py") \
        if tool == "reference" else \
        os.path.join(REPO, "tpu_mx_torch", "tools", "fleet_report.py")
    probe = ("import runpy, sys; sys.argv = [%r, %r, '--validate']; "
             "code = 0\ntry:\n    runpy.run_path(%r, run_name='__main__')\n"
             "except SystemExit as e:\n    code = e.code\n"
             "assert 'torch' not in sys.modules and 'jax' not in "
             "sys.modules, sorted(m for m in sys.modules if m in "
             "('torch', 'jax'))\nsys.exit(code)" % (script, path, script))
    r = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                       text=True, timeout=120, cwd=str(tmp_path))
    assert r.returncode == 0, r.stdout + r.stderr
    assert "slowest=rank 1" in r.stdout and "data_wait" in r.stdout
    assert "aggregation identity holds" in r.stdout
    doc = json.loads(open(path).read())
    jfleet_obs.validate_fleet_section(doc, telemetry=jtelemetry)
    jtracing.validate_blackbox(doc)


# -- the launcher ---------------------------------------------------------------
def test_launcher_pieces():
    import random as _random
    rng = _random.Random(0)
    for attempt in range(1, 5):
        lo = 0.5 * 2 ** (attempt - 1) * 0.5
        hi = 0.5 * 2 ** (attempt - 1) * 1.5
        for _ in range(20):
            assert lo <= launch.restart_backoff(0.5, attempt, rng) < hi
    env = launch.worker_env("h:1", 3, 2, ["A=b"])
    assert env == {"TPUMX_COORDINATOR": "h:1", "TPUMX_NUM_PROC": "3",
                   "TPUMX_PROC_ID": "2", "A": "b"}
    cmds = launch.build_ssh_commands(["h0", "h1"], 3, "h0:9", ["python", "t"])
    assert [h for h, _ in cmds] == ["h0", "h1", "h0"]
    assert "TPUMX_PROC_ID=2" in cmds[2][1][-1]
    assert not launch.cuda_context_created()


_FLEET_WORKER = textwrap.dedent("""
    import os, sys, time
    for k in ("TPUMX_COORDINATOR", "TPUMX_NUM_PROC", "TPUMX_PROC_ID"):
        os.environ.pop(k, None)       # the fleet protocol alone
    from tpu_mx_torch.parallel.fleet import Fleet, MembershipChange
    f = Fleet.from_env()
    f.join()
    f.await_admission(timeout=30)
    end = time.monotonic() + 1.5
    steps = 0
    while time.monotonic() < end:
        try:
            f.on_step()
        except MembershipChange:
            f.ack()
        steps += 1
        time.sleep(0.05)
    with open(os.path.join(sys.argv[1], f"done-{f.member}"), "w") as fh:
        fh.write(str(steps))
    f.leave()
""")


def test_supervised_launch_of_two_workers(tmp_path):
    worker = tmp_path / "worker.py"
    worker.write_text(_FLEET_WORKER)
    fdir = tmp_path / "fleet"
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run(
        [sys.executable, "-m", "tpu_mx_torch.tools.launch", "--supervise",
         "-n", "2", "--fleet-dir", str(fdir), "--lease", "5.0",
         sys.executable, str(worker), str(tmp_path)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    for m in (0, 1):
        assert int((tmp_path / f"done-{m}").read_text()) > 5
    gen = json.loads((fdir / "gen.json").read_text())
    assert gen["world"] == [0, 1] and gen["format"] == "tpu_mx-fleet-v1"
    box = json.loads((fdir / "fleet-blackbox.json").read_text())
    fleet_obs.validate_fleet_section(box, telemetry=telemetry)
    assert sorted(box["fleet"]["ranks"]) == ["0", "1"]


_CHURN_WORKER = textwrap.dedent("""
    import json, os, pickle, sys, time
    root = os.environ["TPUMX_TEST_ROOT"]
    member = int(os.environ["TPUMX_FLEET_MEMBER"])
    with open(os.path.join(root, f"started-{member}.log"), "a") as fh:
        fh.write(str(os.getpid()) + "\\n")
    for k in ("TPUMX_COORDINATOR", "TPUMX_NUM_PROC", "TPUMX_PROC_ID"):
        os.environ.pop(k, None)
    import numpy as np
    import tpu_mx_torch as mx
    from tpu_mx_torch import checkpoint as ckpt
    from tpu_mx_torch.io import NDArrayIter
    from tpu_mx_torch.elastic import WorkerFailure
    from tpu_mx_torch.parallel.fleet import Fleet, MembershipChange

    f = Fleet.from_env()
    f.join()
    f.await_admission(timeout=60)
    sync = time.monotonic() + 10
    for m in f.world():
        if m == f.member:
            continue
        while m not in f.live() and time.monotonic() < sync:
            f.heartbeat()
            time.sleep(0.05)
    r, w = f.shard()
    with mx.cpu():
        X = np.arange(64, dtype=np.float32).reshape(64, 1)
        it = NDArrayIter(X, batch_size=8, shuffle=True, seed=5,
                         last_batch_handle="discard")
        spath = os.path.join(root, "stream.pkl")
        step = 0
        if os.path.exists(spath):
            with open(spath, "rb") as fh:
                pub = pickle.load(fh)
            it.load_state_dict(pub["state"])
            step = pub["step"]
        it.set_shard(r, w)
        target = max(16, step + 8)
        post_rejoin = 0
        led = open(os.path.join(root, f"ledger-{member}-{os.getpid()}.jsonl"),
                   "a", buffering=1)
        pace = 0.25 if member == 0 else 0.05
        deadline = time.monotonic() + 90
        while time.monotonic() < deadline:
            try:
                f.on_step()
            except MembershipChange:
                f.ack()
                try:
                    r, w = f.shard()
                except WorkerFailure:
                    f.join()
                    f.await_admission(timeout=60)
                    r, w = f.shard()
                    if os.path.exists(spath):
                        with open(spath, "rb") as fh:
                            pub = pickle.load(fh)
                        it.load_state_dict(pub["state"])
                        step = pub["step"]
                it.set_shard(r, w)
                led.write(json.dumps({"membership": True, "step": step,
                                      "gen": f.acked_generation,
                                      "world": w}) + "\\n")
                continue
            if member == 0:
                if step >= target and f.acked_generation >= 3 \\
                        and post_rejoin >= 3:
                    break
                if step >= 48:
                    break
            elif step >= target:
                break
            if not it.iter_next():
                it.reset()
                assert it.iter_next()
            step += 1
            if member == 0 and f.acked_generation >= 3:
                post_rejoin += 1
            led.write(json.dumps(
                {"step": step, "gen": f.acked_generation, "rank": r,
                 "world": w, "gids": [int(v) for v in it.global_batch_ids()],
                 "mine": [int(v) for v in
                          it.getdata()[0].asnumpy().ravel()]}) + "\\n")
            if r == 0:
                with ckpt.atomic_write(spath, mode="wb") as fh:
                    pickle.dump({"step": step, "state": it.state_dict()}, fh)
            time.sleep(pace)
    f.leave()
    led.close()
""")


def _read_jsonl(path):
    with open(path) as fh:
        return [json.loads(line) for line in fh if line.strip()]


@pytest.mark.slow
def test_supervised_fleet_kill_and_rejoin(tmp_path):
    """The reference's churn proof through the port's launcher: chaos
    SIGTERMs rank 1, the launcher evicts it (dp 2 -> 1), restarts it and
    admits it again (1 -> 2), and every rank's sample-id ledger equals the
    uninterrupted oracle's."""
    root = tmp_path / "run"
    root.mkdir()
    fdir = str(tmp_path / "fleet")
    worker = tmp_path / "worker.py"
    worker.write_text(_CHURN_WORKER)
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run(
        [sys.executable, "-m", "tpu_mx_torch.tools.launch", "--supervise",
         "-n", "2", "--fleet-dir", fdir, "--max-restarts", "2",
         "--backoff", "3.0", "--lease", "2.0", "--join-timeout", "60",
         "--env", f"TPUMX_TEST_ROOT={root}",
         "--env", "TPUMX_CHAOS=preempt_worker_at_step=3,preempt_rank=1",
         sys.executable, str(worker)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-4000:]
    pids1 = (root / "started-1.log").read_text().split()
    assert len(pids1) == 2
    oracle = {}
    it = _iter()
    for s in range(1, 65):
        if not it.iter_next():
            it.reset()
            it.iter_next()
        oracle[s] = [int(v) for v in it.global_batch_ids()]
    rows0 = []
    for p in root.glob("ledger-0-*.jsonl"):
        rows0 += _read_jsonl(p)
    steps0 = sorted((row for row in rows0 if "gids" in row),
                    key=lambda row: row["step"])
    hi = steps0[-1]["step"]
    assert [row["step"] for row in steps0] == list(range(1, hi + 1))
    for row in steps0:
        assert row["gids"] == oracle[row["step"]]
    worlds = [row["world"] for row in steps0]
    assert worlds[0] == 2 and 1 in worlds and worlds[-1] == 2
    second = [row for row in _read_jsonl(root / f"ledger-1-{pids1[1]}.jsonl")
              if "gids" in row]
    assert len(second) >= 4
    for row in second:
        assert row["gen"] >= 3 and row["world"] == 2 and row["rank"] == 1
        assert row["gids"] == oracle[row["step"]]
        assert row["mine"] == oracle[row["step"]][4:]
    gen = json.loads(open(os.path.join(fdir, "gen.json")).read())
    assert gen["world"] == [0, 1] and gen["generation"] >= 3


# chip_smoke.py's fleet worker with a stand-in training step whose first
# call outlasts the lease, as the card's first step can (ROADMAP C28)
_COLD_START_WORKER = textwrap.dedent("""
    import json, os, sys, time
    spec = json.loads(sys.argv[1])
    spec["t0"] = time.time()
    for k in ("TPUMX_COORDINATOR", "TPUMX_NUM_PROC", "TPUMX_PROC_ID"):
        os.environ.pop(k, None)
    sys.path.insert(0, spec["repo"])
    import chip_smoke
    import tpu_mx_torch as mx
    calls = []

    def train(rank, world):
        time.sleep(spec["cold_seconds"] if not calls else 0.01)
        calls.append([rank, world])
        return 1.0
    with mx.cpu():
        sys.exit(chip_smoke.fleet_worker(spec, train))
""")


def test_fleet_worker_pays_its_cold_first_step_before_it_joins(tmp_path):
    """ROADMAP C28: on the card a worker's first training step pays the
    one-time start-up (the flash kernels' first load, cuBLAS, the
    optimizer's state), 1.5-2.5 s beside a second worker on an H100; in
    ``chip_smoke.py``'s fleet phase it ran after the join, between two
    renewals of the lease, and in one whole run outlasted the 4 s lease
    of both workers at once (both evicted, world size 0, exit 1).  The
    phase's worker makes that call before it joins, where no lease runs
    yet: here a first step of 3 s against a 2 s lease loses no member."""
    root = tmp_path / "run"
    root.mkdir()
    worker = tmp_path / "worker.py"
    worker.write_text(_COLD_START_WORKER)
    spec = dict(root=str(root), mode="straggler", repo=REPO,
                cold_seconds=3.0)
    r = subprocess.run(
        [sys.executable, "-m", "tpu_mx_torch.tools.launch", "--supervise",
         "-n", "2", "--fleet-dir", str(tmp_path / "fleet"), "--lease", "2.0",
         sys.executable, str(worker), json.dumps(spec)],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
        text=True, timeout=180)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "lost" not in r.stderr, r.stderr[-3000:]
    for member in (0, 1):
        ledgers = list(root.glob(f"ledger-{member}-*.jsonl"))
        assert len(ledgers) == 1               # never evicted, never restarted
        rows = _read_jsonl(ledgers[0])
        steps = [row["step"] for row in rows if "gids" in row]
        # member 1 may start at rank 0's published cursor, a late joiner
        first = 1 if member == 0 else steps[0]
        assert steps == list(range(first, 15))
        assert {row["world"] for row in rows if "gids" in row} == {2}
        assert rows[-1]["lease"] == 2.0
        assert rows[-1]["max_beat_gap_ms"] < 2000.0
