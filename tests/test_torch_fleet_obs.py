"""The port's fleet observability (``tpu_mx_torch/parallel/fleet_obs.py``)
against the reference's on the same input files, on the CPU, and the
port's event and metric catalogs against the reference's.

The port ships two ranks' snapshots (one rank straggling in
``data_wait``) and an integrity directory into one fleet directory; each
package's ``read_obs_dir``, ``merge_streams``, ``correlate_steps``,
``StragglerDetector``, ``read_integrity_dir`` and ``FleetAggregator``
then read the same files, and their outputs must be equal.  Each
package's ``validate_fleet_section`` accepts the other's black box.
"""
import json
import os
import time

import pytest

from tpu_mx import telemetry as jtelemetry
from tpu_mx import tracing as jtracing
from tpu_mx.parallel import fleet as jfleet
from tpu_mx.parallel import fleet_obs as jobs

from tpu_mx_torch import telemetry, tracing
from tpu_mx_torch.contrib import chaos
from tpu_mx_torch.parallel import fleet as fleet_mod
from tpu_mx_torch.parallel import fleet_obs as obs
from tpu_mx_torch.parallel.fleet import Fleet

PORT_ONLY_METRICS = {"rnn.arm", "serve.forensic_dump_failures",
                     "serve.prefill_attention", "mesh.host_staged_bytes",
                     "mesh.host_staged_seconds"}


@pytest.fixture(autouse=True)
def _clean_registries():
    for tel, tr in ((telemetry, tracing), (jtelemetry, jtracing)):
        tel.reset()
        tr.reset()
    yield
    for fl, tel, tr in ((fleet_mod, telemetry, tracing),
                        (jfleet, jtelemetry, jtracing)):
        fl._live_world = None
        tel.set_fleet_identity(rank=None, generation=None)
        tel.reset()
        tr.reset()


def test_the_catalogs_equal_the_references():
    assert set(tracing.KNOWN_EVENTS) == set(jtracing.KNOWN_EVENTS)
    for name, fields in jtracing.KNOWN_EVENTS.items():
        assert tracing.KNOWN_EVENTS[name] == fields, name
    port, ref = set(telemetry.KNOWN_METRICS), set(jtelemetry.KNOWN_METRICS)
    assert ref <= port and port - ref == PORT_ONLY_METRICS
    for prefix in ("fusion.", "kvstore.", "fleet."):
        assert {m for m in port if m.startswith(prefix)} == \
            {m for m in ref if m.startswith(prefix)}, prefix
    assert tracing.get_context().keys() == jtracing.get_context().keys()


def _ship_run(tmp_path, slow_rank=1, steps=8):
    """Two port workers ship their snapshots; rank ``slow_rank``'s
    ``data_wait`` carries 0.25 s more; a fingerprint vote history and a
    quarantine record sit beside them."""
    root = tmp_path / "fleet"
    ctl = Fleet(root, controller=True, lease=5.0)
    ctl.advance(world=[0, 1], reason="launch")
    for rank in (0, 1):
        telemetry.reset()
        tracing.reset()
        w = Fleet(root, member=rank, lease=5.0)
        w.join()
        w.await_admission(timeout=10)
        telemetry.counter("train_step.steps").inc(10 + rank)
        telemetry.counter("fleet.heartbeats").inc(3)
        h = telemetry.histogram("train_step.seconds")
        for v in (0.01, 0.02 + rank, 0.3):
            h.observe(v)
        telemetry.gauge("fleet.membership_epoch").set(1)
        for s in range(steps):
            tracing.set_context(epoch=0, step=s)
            for ph, sec in (("data_wait",
                             0.01 + (0.25 if rank == slow_rank else 0.0)),
                            ("dispatch", 0.005), ("loss_readback", 0.002)):
                tracing.emit("train_step.phase", phase=ph, seconds=sec)
        obs.ObsShipper(w).ship(force=True)
    integ = root / obs.INTEGRITY_DIR
    integ.mkdir()
    for rank, fp in ((0, 0x1234), (1, 0x1234)):
        (integ / f"fp-{rank}.json").write_text(json.dumps(
            {"rank": rank, "step": 4, "fp": fp, "generation": 1}))
        (integ / f"votes-{rank}.jsonl").write_text(json.dumps(
            {"step": 4, "agree": True, "majority_fp": 0x1234,
             "minority": [], "absent": []}) + "\n")
    telemetry.reset()
    tracing.reset()
    return root


def _strip_wall(res):
    res = dict(res)
    res.pop("wall_time", None)
    return json.loads(json.dumps(res, sort_keys=True, default=str))


def test_every_reader_equals_the_references_on_the_same_files(tmp_path):
    root = str(_ship_run(tmp_path))
    streams, docs = obs.read_obs_dir(root)
    jstreams, jdocs = jobs.read_obs_dir(root)
    assert streams == jstreams and docs == jdocs
    assert sorted(streams) == [0, 1]
    for gen in (None, 1, 2):
        assert obs.merge_streams(streams, generation=gen) == \
            jobs.merge_streams(streams, generation=gen)
    events = {r: d["events"] for r, d in docs.items()}
    corr = obs.correlate_steps(events)
    assert corr == jobs.correlate_steps(events)
    assert len(corr) == 8 and {c["slowest_rank"] for c in corr} == {1}
    assert {c["dominant_phase"] for c in corr} == {"data_wait"}
    for gen in (1, 2):
        assert obs.correlate_steps(events, generation=gen) == \
            jobs.correlate_steps(events, generation=gen)
    det = obs.StragglerDetector(window=8, frac=0.5, min_steps=4)
    jdet = jobs.StragglerDetector(window=8, frac=0.5, min_steps=4)
    sig = det.update(corr)
    assert sig == jdet.update(corr)
    assert sig["straggling"] and sig["rank"] == 1
    assert obs.read_integrity_dir(root) == jobs.read_integrity_dir(root)
    merged, info = obs.merge_streams(streams, generation=1)
    steps = [r for r in merged if r["name"] == "train_step.steps"][0]
    assert steps["value"] == 21 and steps["per_rank"] == {"0": 10, "1": 11}


def test_the_aggregators_agree_and_validate_each_others_black_box(tmp_path):
    root = _ship_run(tmp_path)
    res = obs.FleetAggregator(Fleet(root, controller=True)).poll(force=True)
    jres = jobs.FleetAggregator(jfleet.Fleet(root, controller=True)) \
        .poll(force=True)
    assert _strip_wall(res) == _strip_wall(jres)
    assert res["signal"]["rank"] == 1
    ctl = Fleet(root, controller=True)
    path = obs.dump_fleet_blackbox(str(root), reason="port dump", fleet=ctl)
    assert path == obs.fleet_blackbox_path(str(root))
    doc = json.loads(open(path).read())
    obs.validate_fleet_section(doc, telemetry=telemetry)
    jobs.validate_fleet_section(doc, telemetry=jtelemetry)
    jpath = jobs.dump_fleet_blackbox(str(root), reason="reference dump",
                                     fleet=jfleet.Fleet(root,
                                                        controller=True))
    jdoc = json.loads(open(jpath).read())
    obs.validate_fleet_section(jdoc, telemetry=telemetry)
    tracing.validate_blackbox(jdoc)
    assert jdoc["fleet"]["straggler_signal"] == \
        doc["fleet"]["straggler_signal"]
    bad = json.loads(json.dumps(doc))
    for rec in bad["fleet"]["aggregate"]:
        if rec["type"] == "counter":
            rec["value"] += 1
            break
    with pytest.raises(ValueError, match="identity"):
        obs.validate_fleet_section(bad)


def test_stale_generation_and_missing_rank(tmp_path):
    root = _ship_run(tmp_path)
    streams, _ = obs.read_obs_dir(str(root))
    merged, info = obs.merge_streams(streams, generation=2)
    assert merged == [] and info == jobs.merge_streams(streams,
                                                       generation=2)[1]
    os.remove(root / obs.OBS_DIR / "rank-1.jsonl")
    streams, _ = obs.read_obs_dir(str(root))
    merged, info = obs.merge_streams(streams, generation=1)
    assert (merged, info) == jobs.merge_streams(streams, generation=1)
    assert sorted(streams) == [0]


def test_chaos_slow_worker_fires_inside_data_wait_of_the_step(monkeypatch):
    """The train step's data_wait holds the injected delay (the phase the
    attribution names)."""
    import torch
    import tpu_mx_torch as mx
    from tpu_mx_torch import gluon, optimizer
    from tpu_mx_torch.parallel import CompiledTrainStep
    with mx.cpu():
        net = gluon.nn.Dense(2, in_units=3)
        net.initialize()
    step = CompiledTrainStep(net, gluon.loss.L2Loss(),
                             optimizer.create("sgd", learning_rate=0.1),
                             device="cpu")
    x, y = torch.ones(4, 3), torch.zeros(4, 2)
    monkeypatch.setenv("TPUMX_FLEET_MEMBER", "0")   # the worker's rank
    with chaos.enable(slow_worker_rank=0, slow_worker_seconds=0.2) as cfg:
        t0 = time.perf_counter()
        step.step(x, y)
        assert time.perf_counter() - t0 >= 0.2
        assert cfg.slow_worker_fires == 1
    waits = [e["data"]["seconds"] for e in tracing.snapshot()
             if e["event"] == "train_step.phase"
             and e["data"]["phase"] == "data_wait"]
    assert waits and waits[-1] >= 0.2
