"""The port's checkpoint plane against the JAX reference, on the CPU.

``checkpoint.py`` (manifests, verification, retention, retry, the
preemption hook), ``elastic.py`` (the barrier, ``latest_checkpoint``,
``auto_resume``, ``save_checkpoint``) and ``contrib/chaos.py``'s file
and training sites.  A manifest written by either package verifies in
the other; the same torn or corrupt fixture gives the same newest
checkpoint; retention keeps the same epochs; a checkpoint the
reference's ``elastic.save_checkpoint`` writes resumes into the port with
the same weights bit for bit, and its trainer's states with them.
"""
import json
import os
import signal

import numpy as np
import pytest

from tpu_mx import checkpoint as jckpt
from tpu_mx import elastic as jelastic
from tpu_mx import gluon as jgluon
from tpu_mx import nd as jnd
from tpu_mx import autograd as jautograd
from tpu_mx import telemetry as jtelemetry
from tpu_mx import tracing as jtracing
from tpu_mx.contrib import chaos as jchaos
from tpu_mx.gluon import nn as jnn

import tpu_mx_torch as mx
from tpu_mx_torch import checkpoint, elastic, gluon, telemetry, tracing
from tpu_mx_torch.base import MXNetError
from tpu_mx_torch.contrib import chaos
from tpu_mx_torch.gluon import nn

PAIRS = [("port", checkpoint, elastic, chaos),
         ("ref", jckpt, jelastic, jchaos)]


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    monkeypatch.delenv("TPUMX_CHAOS", raising=False)
    for mod in (tracing, telemetry, jtracing, jtelemetry):
        mod.reset()
    yield
    for mod in (tracing, telemetry, jtracing, jtelemetry):
        mod.reset()


def _write(path, payload, ckpt):
    with ckpt.atomic_write(path) as f:
        f.write(payload)


def _epoch(ckpt, prefix, epoch, seed):
    """One epoch's files (``.params`` and ``.states``) through
    ``atomic_write``, then its manifest."""
    rng = np.random.RandomState(seed)
    files = []
    for ext in ("params", "states"):
        p = f"{prefix}-{epoch:04d}.{ext}"
        _write(p, rng.bytes(257 + 31 * epoch), ckpt)
        files.append(p)
    return ckpt.write_manifest(prefix, epoch, files)


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_a_manifest_verifies_in_either_package(tmp_path, writer):
    ckpt = checkpoint if writer == "port" else jckpt
    prefix = str(tmp_path / "m")
    man = _epoch(ckpt, prefix, 3, seed=0)
    assert man["format"] == checkpoint.MANIFEST_FORMAT == \
        jckpt.MANIFEST_FORMAT
    for reader in (checkpoint, jckpt):
        assert reader.verify_checkpoint(prefix, 3) == ("verified", [])
        assert reader.read_manifest(prefix, 3)["files"] == man["files"]
        assert reader.list_epochs(prefix) == [3]
        assert reader.newest_verified_epoch(prefix) == 3
    keys = set(json.loads(open(checkpoint.manifest_path(prefix, 3))
                          .read()))
    assert keys == {"format", "prefix", "epoch", "files", "git_head",
                    "wall_time", "written_at", "host", "pid"}
    # update_manifest adds a file in both packages' format
    extra = f"{prefix}-0003.capsule.json"
    _write(extra, b"{}", ckpt)
    ckpt.update_manifest(prefix, 3, [extra])
    for reader in (checkpoint, jckpt):
        assert reader.verify_checkpoint(prefix, 3)[0] == "verified"
        assert reader.checkpoint_files(prefix, 3) == sorted(
            [checkpoint.manifest_path(prefix, 3), extra,
             f"{prefix}-0003.params", f"{prefix}-0003.states"])


def _damaged(tmp_path, name, ckpt):
    """Epochs 0-5: 1 torn (short file), 3 corrupt (a flipped byte), 4 a
    missing file, 5 manifest-less (an interrupted save), 0 and 2 whole."""
    prefix = str(tmp_path / name)
    for e in range(5):
        _epoch(ckpt, prefix, e, seed=e)
    with open(f"{prefix}-0001.params", "r+b") as f:
        f.truncate(100)
    with open(f"{prefix}-0003.states", "r+b") as f:
        b = bytearray(f.read())
        b[7] ^= 1
        f.seek(0)
        f.write(b)
    os.remove(f"{prefix}-0004.states")
    _write(f"{prefix}-0005.params", b"legacy", ckpt)
    return prefix


def test_the_same_damage_gives_the_same_newest_checkpoint(tmp_path):
    got = {}
    for name, ckpt, el, _ in PAIRS:
        prefix = _damaged(tmp_path, name, ckpt)
        statuses = [ckpt.verify_checkpoint(prefix, e)
                    for e in range(6)]
        latest = el.latest_checkpoint(prefix)
        got[name] = ([s for s, _ in statuses],
                     [[p.split(":")[0].split("-", 1)[1] for p in probs]
                      for _, probs in statuses],
                     (latest[0],
                      os.path.basename(latest[1]).split("-", 1)[1]),
                     [e for e, _ in el.candidate_checkpoints(prefix)],
                     ckpt.newest_verified_epoch(prefix))
    assert got["port"] == got["ref"]
    assert got["port"][0] == ["verified", "corrupt", "verified", "corrupt",
                              "corrupt", "legacy"]
    assert got["port"][2] == (2, "0002.params")
    # telemetry: the same skips counted
    for name in ("elastic.epochs_skipped_corrupt",
                 "checkpoint.corrupt_detected"):
        assert telemetry.get(name).value == jtelemetry.get(name).value


@pytest.mark.parametrize("keep", [1, 2, 4])
def test_retention_keeps_the_same_epochs(tmp_path, keep):
    kept = {}
    for name, ckpt, _, _ in PAIRS:
        prefix = _damaged(tmp_path, name, ckpt)
        removed = ckpt.apply_retention(prefix, keep)
        kept[name] = (removed, ckpt.list_epochs(prefix),
                      sorted(os.path.basename(p).split("-", 1)[1] for p in
                             os.listdir(tmp_path) if p.startswith(name)))
    assert kept["port"] == kept["ref"]
    # the newest verified epoch (2) survives any window
    assert 2 in kept["port"][1]


def _dense_pair(seed=0):
    """The same two-layer Dense net in both packages (the reference's
    weights copied into the port's), each with a momentum-SGD trainer
    that has taken one step."""
    rng = np.random.RandomState(seed)
    x = rng.rand(6, 4).astype(np.float32)
    y = rng.rand(6, 2).astype(np.float32)
    jnet = jnn.HybridSequential()
    jnet.add(jnn.Dense(8, in_units=4, activation="relu"),
             jnn.Dense(2, in_units=8))
    jnet.initialize()
    jtrainer = jgluon.Trainer(jnet.collect_params(), "sgd",
                              {"learning_rate": 0.1, "momentum": 0.9})
    with jautograd.record():
        loss = jgluon.loss.L2Loss()(jnet(jnd.array(x)), jnd.array(y))
    loss.backward()
    jtrainer.step(6)
    with mx.cpu():
        net = nn.HybridSequential()
        net.add(nn.Dense(8, in_units=4, activation="relu"),
                nn.Dense(2, in_units=8))
        net.initialize()
        trainer = gluon.Trainer(net.collect_params(), "sgd",
                                {"learning_rate": 0.1, "momentum": 0.9})
        with mx.autograd.record():
            loss = gluon.loss.L2Loss()(net(mx.nd.array(x)), mx.nd.array(y))
        loss.backward()
        trainer.step(6)
    return jnet, jtrainer, net, trainer


def test_a_reference_checkpoint_resumes_into_the_port(tmp_path):
    """The reference's ``elastic.save_checkpoint`` (params, trainer
    states, manifest), then the port's ``auto_resume``: the weights are
    the reference's bit for bit, the momentum too, and the epoch to
    resume from is the reference's."""
    jnet, jtrainer, net, trainer = _dense_pair()
    prefix = str(tmp_path / "x")
    jelastic.save_checkpoint(prefix, 0, net=jnet, trainer=jtrainer)
    jelastic.save_checkpoint(prefix, 1, net=jnet, trainer=jtrainer,
                             keep_last=1)
    assert jckpt.list_epochs(prefix) == [1]
    with mx.cpu():
        got = elastic.auto_resume(prefix, net=net, trainer=trainer)
    assert got == jelastic.auto_resume(prefix, net=jnet) == 2
    # the same parameters in the same order (the per-instance names count
    # blocks made before in each package, so they are not compared)
    want = {k: np.asarray(p.data()._data)
            for k, p in jnet.collect_params().items()}
    have = [p.data().asnumpy() for p in net.collect_params().values()]
    assert len(want) == len(have) == 4
    for (k, w), h in zip(want.items(), have):
        assert w.dtype == h.dtype == np.float32
        np.testing.assert_array_equal(h, w, err_msg=k)
    for js, ps in zip(jtrainer._states, trainer._states):
        np.testing.assert_array_equal(np.asarray(ps._data if hasattr(
            ps, "_data") else ps), np.asarray(js))
    # and back: the port's save resumes into the reference
    with mx.cpu():
        elastic.save_checkpoint(prefix, 2, net=net, trainer=trainer)
    assert jckpt.verify_checkpoint(prefix, 2) == ("verified", [])
    assert jelastic.auto_resume(prefix, net=jnet, trainer=jtrainer) == 3


def test_auto_resume_falls_back_and_refuses_a_half_restore(tmp_path):
    jnet, jtrainer, net, trainer = _dense_pair()
    prefix = str(tmp_path / "y")
    with mx.cpu():
        elastic.save_checkpoint(prefix, 0, net=net, trainer=trainer)
        elastic.save_checkpoint(prefix, 1, net=net, trainer=trainer)
        # epoch 1's params torn: the manifest skips it, epoch 0 restores
        with open(f"{prefix}-0001.params", "r+b") as f:
            f.truncate(64)
        assert elastic.auto_resume(prefix, net=net, trainer=trainer) == 1
        # a net's checkpoint holds no symbol: a Module restores none of
        # its epochs and nothing was changed, so both packages train fresh
        assert elastic.auto_resume(prefix, module=object()) == 0
        assert jelastic.auto_resume(prefix, module=object()) == 0
        with pytest.raises(MXNetError, match="net= and/or trainer="):
            elastic.save_checkpoint(prefix, 2)
    assert elastic.auto_resume(str(tmp_path / "none"), net=net) == 0


@pytest.mark.parametrize("fault", ["crash_after_bytes", "torn_write",
                                   "transient_oserror"])
def test_the_chaos_file_faults_act_alike(tmp_path, fault):
    """A crash mid-write leaves the old file and tmp debris; a torn write
    commits a short file the manifest then calls torn; a transient error
    is retried by ``checkpoint.retry``."""
    out = {}
    for name, ckpt, _, ch in PAIRS:
        prefix = str(tmp_path / name)
        _epoch(ckpt, prefix, 0, seed=1)
        p = f"{prefix}-0001.params"
        kw = {"crash_after_bytes": dict(crash_after_bytes=100),
              "torn_write": dict(torn_write=100),
              "transient_oserror": dict(transient_oserror=2)}[fault]
        with ch.enable(match=".params", seed=3, **kw) as cfg:
            try:
                ckpt.retry(lambda: _write(p, b"z" * 300, ckpt), seed=0,
                           backoff=0.0)
                ckpt.write_manifest(prefix, 1, [p])
                err = None
            except ch.ChaosCrash:
                err = "crash"
        debris = sorted(x.split(".tmp.")[0][len(name):]
                        for x in os.listdir(tmp_path)
                        if x.startswith(name) and ".tmp." in x)
        status = ckpt.verify_checkpoint(prefix, 1)
        out[name] = (err, debris, status[0],
                     [x.split(":")[1].split("—")[0].strip()
                      for x in status[1]],
                     os.path.getsize(p) if os.path.exists(p) else None,
                     cfg.crashes, cfg.tears, cfg.oserrors_fired,
                     ckpt.newest_verified_epoch(prefix))
    assert out["port"] == out["ref"]
    assert {"crash_after_bytes": "crash", "torn_write": None,
            "transient_oserror": None}[fault] == out["port"][0]
    assert telemetry.get("chaos.injections", kind={
        "crash_after_bytes": "crash", "torn_write": "torn_write",
        "transient_oserror": "transient_oserror"}[fault]).value >= 1


def test_retry_backs_off_and_never_retries_a_crash():
    for ckpt, ch in ((checkpoint, chaos), (jckpt, jchaos)):
        calls = []

        def flaky():
            calls.append(1)
            if len(calls) < 3:
                raise OSError("transient")
            return "ok"
        assert ckpt.retry(flaky, attempts=4, backoff=0.0, seed=0) == "ok"
        assert len(calls) == 3
        with pytest.raises(OSError):
            ckpt.retry(lambda: (_ for _ in ()).throw(OSError("x")),
                       attempts=2, backoff=0.0)

        def crash():
            calls.append(1)
            raise ch.ChaosCrash("dead")
        calls.clear()
        with pytest.raises(ch.ChaosCrash):
            ckpt.retry(crash, backoff=0.0)
        assert len(calls) == 1
    assert telemetry.get("checkpoint.retries").value == \
        jtelemetry.get("checkpoint.retries").value == 3


def test_the_preemption_handler_saves_once_and_is_reentrant(tmp_path):
    """SIGTERM runs the save once (a second signal during it is ignored),
    records the event and a black box, restores the prior handler."""
    for ckpt, tr in ((checkpoint, tracing), (jckpt, jtracing)):
        saves = []

        def save():
            saves.append(1)
            os.kill(os.getpid(), signal.SIGTERM)   # a second signal
            tr.emit("chaos.inject", kind="nested")
        prev = signal.getsignal(signal.SIGTERM)
        handler = ckpt.preemption_handler(
            save, exit=False, blackbox_prefix=str(tmp_path / "bb"))
        os.kill(os.getpid(), signal.SIGTERM)
        assert handler.triggered and handler.save_ok
        assert saves == [1]
        assert signal.getsignal(signal.SIGTERM) is prev
        events = [e["event"] for e in tr.snapshot()]
        assert "checkpoint.preemption" in events
        assert os.path.exists(str(tmp_path / "bb") + "-blackbox.json")


def test_the_barrier_at_world_size_one(tmp_path):
    from tpu_mx.parallel import fleet as jfleet
    from tpu_mx_torch.parallel import fleet
    for el, ch, fl in ((elastic, chaos, fleet), (jelastic, jchaos, jfleet)):
        assert el.barrier("t", timeout=1.0) is None
        with ch.enable(kill_peer=True):
            with pytest.raises(el.WorkerFailure, match="kill_peer"):
                el.barrier("t", timeout=1.0)
        # fleet=: a stale membership generation raises before any wait
        root = tmp_path / fl.__name__
        ctl = fl.Fleet(root, controller=True)
        ctl.advance(world=[0])
        try:
            assert el.barrier("t", timeout=1.0, fleet=ctl) is None
            fl.Fleet(root, controller=True).advance(world=[0, 1])
            with pytest.raises(el.WorkerFailure,
                               match="stale fleet generation 1"):
                el.barrier("t", timeout=1.0, fleet=ctl)
        finally:
            fl._live_world = None


CHAOS_SPECS = [
    "crash_after_bytes=100,match=.params,seed=7",
    "torn_write=4096 slow_io=0.5 transient_oserror=3",
    "kill_peer=1,nan_after=5,nan_streak=3",
    "hang_step=2,hang_seconds=0.25,crash_at_step=6,hard=1,seed=0",
    "preempt_worker_at_step=3,preempt_rank=1,partition_worker=2",
    "slow_worker_rank=1,slow_worker_seconds=0.1,bitflip_grad_rank=2",
    "bitflip_param_at_step=3,bitflip_rank=2,flaky_recompute=2,"
    "bogus_knob=1",
    "slow_decode_step=3,slow_decode_seconds=2,kill9_at_decode_step=4,"
    "restart_storm=2,reject_storm=1",
]


def _parsed(ch, spec, monkeypatch):
    monkeypatch.setenv("TPUMX_CHAOS", spec)
    monkeypatch.setattr(ch, "_config", None)
    monkeypatch.setattr(ch, "_env_parsed", False)
    cfg = ch.configure_from_env()
    return {k: v for k, v in vars(cfg).items() if k not in ("rng", "lock")}


@pytest.mark.parametrize("spec", CHAOS_SPECS)
def test_tpumx_chaos_strings_parse_alike(spec, monkeypatch):
    assert _parsed(chaos, spec, monkeypatch) == \
        _parsed(jchaos, spec, monkeypatch)
    assert chaos._Config._KINDS == jchaos._Config._KINDS


def test_the_training_chaos_sites_fire_alike(monkeypatch):
    """``maybe_crash_step``, ``maybe_hang``, ``maybe_bitflip``,
    ``maybe_slow_worker``, ``maybe_preempt`` and ``partitioned`` count and
    fire at the same calls, drawing the same bits."""
    monkeypatch.delenv("TPUMX_FLEET_MEMBER", raising=False)
    fired = {}
    for name, _, _, ch in PAIRS:
        log = []
        with ch.enable(crash_at_step=3, hang_step=2, hang_seconds=0.0,
                       bitflip_param_at_step=2, bitflip_rank=1,
                       slow_worker_rank=1, slow_worker_seconds=0.0,
                       partition_worker=2, seed=5) as cfg:
            for i in range(4):
                ch.maybe_hang()
                try:
                    ch.maybe_crash_step()
                    log.append("ok")
                except ch.ChaosCrash:
                    log.append("crash")
                log.append(ch.maybe_bitflip(rank=1))
                log.append(ch.maybe_bitflip(rank=0))
                ch.maybe_slow_worker(rank=1)
                log.append(ch.partitioned(2))
            log.append((cfg.hangs, cfg.step_crashes, cfg.bitflips,
                        cfg.slow_worker_fires, cfg.partitions))
        with ch.enable(bitflip_grad_rank=0, seed=9):
            log.append(ch.maybe_bitflip())   # rank 0 by default
            log.append(ch.maybe_bitflip())
        fired[name] = log
    assert fired["port"] == fired["ref"]
    assert "crash" in fired["port"]


_BARRIER_CHILD = r"""
import os, sys
import torch.distributed as dist
from tpu_mx_torch import elastic
rank, port = int(sys.argv[1]), sys.argv[2]
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        rank=rank, world_size=2)
elastic.barrier("first", timeout=60.0)             # both arrive
out = "joined"
if rank == 0:                                       # rank 1 never comes
    try:
        elastic.barrier("second", timeout=1.0)
        out += " second"
    except elastic.WorkerFailure as e:
        out += " failure:" + ("timed out" in str(e) and "rank 0 of 2" in str(e)
                              and "yes" or str(e))
else:                                               # alive, not arriving
    import time
    time.sleep(4.0)
print(out, flush=True)
os._exit(0)
"""


def test_the_barrier_over_a_process_group(tmp_path):
    """Two processes in a gloo group: the barrier joins them; when one
    stays away (alive, hung), the other gets ``WorkerFailure`` at the
    deadline."""
    import socket
    import subprocess
    import sys
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = str(s.getsockname()[1])
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = [subprocess.Popen([sys.executable, "-c", _BARRIER_CHILD,
                               str(r), port], cwd=repo, text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for r in (0, 1)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    assert outs[0][0].split() == ["joined", "failure:yes"], outs
    assert outs[1][0].split() == ["joined"], outs
