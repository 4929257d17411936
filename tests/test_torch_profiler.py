"""The port's profiler and the rest of its telemetry against the JAX
reference, on the CPU.

``profiler.py``: the same scopes, tasks and bridged events under a fixed
clock give the same ``dumps()`` table and the same host chrome-trace
events; ``dump()`` adds ``torch.profiler``'s operators (on the card its
kernels) to the file.  ``telemetry.py``: ``exposition()`` gives the same
Prometheus text for the same metrics, ``KNOWN_METRICS`` holds the
reference's names, the fleet identity stamps records alike, and
``host.rss_bytes`` rides every export.  ``tracing.py``:
``TRAIN_STEP_PHASES`` and the training events are the reference's.
"""
import json
import itertools

import pytest
import torch

from tpu_mx import profiler as jprofiler
from tpu_mx import telemetry as jtelemetry
from tpu_mx import tracing as jtracing

import tpu_mx_torch as mx
from tpu_mx_torch import profiler, telemetry, tracing


@pytest.fixture(autouse=True)
def _fresh():
    for mod in (tracing, telemetry, jtracing, jtelemetry):
        mod.reset()
    yield
    for mod in (tracing, telemetry, jtracing, jtelemetry):
        mod.reset()
    profiler.set_state("stop")
    jprofiler._state["running"] = False


def _record(prof, tr, monkeypatch):
    """The same session in ``prof`` under a fixed clock (ticks of 1.5 ms
    from 100 s): scopes, a task, a frame, a span, a counter, a marker and
    two flight-recorder events."""
    clock = itertools.count()
    monkeypatch.setattr(prof.time, "perf_counter",
                        lambda: 100.0 + 0.0015 * next(clock))
    monkeypatch.setattr(tr.time, "perf_counter",
                        lambda: 100.0 + 0.0015 * next(clock))
    for _ in range(3):
        with prof.scope("forward"):
            pass
    with prof.scope("backward"):
        with prof.scope("inner"):
            pass
    task = prof.Task("load")
    task.start()
    task.stop()
    prof.Frame("frame").start()
    prof.record_span("external", 100.0, 100.25)
    counter = prof.Counter("items", value=3)
    counter.increment(2)
    prof.Marker("mark").mark("thread")
    prof.pause()
    with prof.scope("paused"):
        pass
    prof.resume()
    tr.emit("train_step.phase", t0=100.0, t1=100.002, phase="dispatch")
    tr.emit("chaos.inject", kind="hang")


def _host_events(path):
    with open(path) as f:
        doc = json.load(f)
    assert doc["displayTimeUnit"] == "ms"
    return [{k: v for k, v in e.items() if k not in ("pid", "tid")}
            for e in doc["traceEvents"] if e.get("cat") not in ("op",
                                                                "kernel")]


def test_the_host_recorder_is_the_references(tmp_path, monkeypatch):
    profiler.set_config(filename=str(tmp_path / "port.json"))
    jprofiler.set_config(filename=str(tmp_path / "ref.json"))
    profiler.set_state("run")
    # the reference's session without its XLA device trace
    jprofiler._events.clear()
    jprofiler._agg.clear()
    jprofiler._state.update(running=True, paused=False)
    _record(profiler, tracing, monkeypatch)
    _record(jprofiler, jtracing, monkeypatch)
    table = profiler.dumps()
    assert table == jprofiler.dumps()
    assert "train_step.phase:dispatch" in table
    assert "chaos.inject:hang" in table
    assert "paused" not in table
    profiler.set_state("stop")
    jprofiler._state["running"] = False
    jprofiler.dump()
    assert _host_events(tmp_path / "port.json") == \
        _host_events(tmp_path / "ref.json")
    assert profiler.dumps(reset=True) == jprofiler.dumps(reset=True)
    assert profiler.dumps() == jprofiler.dumps()


def test_dump_merges_the_device_trace(tmp_path):
    """``torch.profiler`` runs between ``set_state('run')`` and
    ``'stop'``: the file holds its operators beside the host scopes (on
    the card, the kernels under category ``kernel``)."""
    path = tmp_path / "trace.json"
    profiler.set_config(filename=str(path), profile_all=True)
    profiler.set_state("run")
    with profiler.scope("matmul_scope"):
        a = torch.ones(8, 8)
        (a @ a).sum()
    profiler.set_state("stop")
    doc = json.loads(path.read_text())
    names = [e["name"] for e in doc["traceEvents"]]
    cats = {e.get("cat") for e in doc["traceEvents"]}
    assert "aten::mm" in names and "matmul_scope" in names
    assert {"scope", "op"} <= cats
    host = [e for e in doc["traceEvents"] if e["name"] == "matmul_scope"
            and e.get("cat") == "scope"][0]
    ops = [e for e in doc["traceEvents"] if e["name"] == "aten::mm"][0]
    # the device trace sits on the host recorder's clock
    assert host["ts"] - 1e6 <= ops["ts"] <= host["ts"] + host["dur"] + 1e6
    # a second session starts empty; a stop without a run is a no-op
    profiler.set_state("run")
    profiler.set_state("stop")
    assert profiler.dumps().count("\n") == 0
    profiler.set_state("stop")
    with pytest.raises(ValueError):
        profiler.set_state("bogus")
    assert profiler.profiler_set_state is not None and \
        profiler.profiler_set_config is not None


def _metrics(tel):
    tel.counter("supervisor.restarts").inc(2)
    tel.counter("chaos.injections", kind='torn"write').inc()
    tel.gauge("resume.resume_step_gap").set(0)
    tel.gauge("integrity.verified_step").set(4.5)
    h = tel.histogram("checkpoint.write_seconds")
    for v in (0.002, 0.04, 2.0):
        h.observe(v)
    tel.histogram("fusion.segment_ops",
                  buckets=tel.SEGMENT_OPS_BUCKETS, unit="ops").observe(3)


def test_exposition_is_the_references():
    _metrics(telemetry)
    _metrics(jtelemetry)
    text = telemetry.exposition()
    assert text == jtelemetry.exposition()
    assert "tpumx_supervisor_restarts_total 2" in text
    assert 'kind="torn\\"write"' in text
    assert telemetry.ATTRIBUTION_TOLERANCE == \
        jtelemetry.ATTRIBUTION_TOLERANCE
    assert telemetry.SEGMENT_OPS_BUCKETS == jtelemetry.SEGMENT_OPS_BUCKETS


def test_the_catalog_and_the_fleet_stamp_are_the_references():
    assert jtelemetry.KNOWN_METRICS <= telemetry.KNOWN_METRICS
    assert telemetry.KNOWN_METRICS - jtelemetry.KNOWN_METRICS == {
        "rnn.arm", "serve.prefill_attention", "serve.forensic_dump_failures",
        "mesh.host_staged_bytes", "mesh.host_staged_seconds"}
    for tel in (telemetry, jtelemetry):
        tel.set_fleet_identity(rank=3, generation=7)
        tel.counter("supervisor.rollbacks").inc()
        assert tel.fleet_identity() == (3, 7)
        tel.set_fleet_identity(generation=None)
        assert tel.fleet_identity() == (3, None)
    recs = [sorted(r.items()) for r in telemetry.snapshot()]
    jrecs = [sorted(r.items()) for r in jtelemetry.snapshot()]
    strip = lambda rs: [[kv for kv in r if kv[0] not in ("ts",)]
                        for r in rs]
    assert strip(recs) == strip(jrecs)
    assert all(dict(r)["rank"] == 3 for r in recs)
    telemetry.reset()
    assert telemetry.fleet_identity() == (None, None)


def test_host_rss_rides_every_export(tmp_path):
    telemetry.counter("train_step.steps").inc()
    recs = telemetry.flush(str(tmp_path / "t.jsonl"))
    rss = [r for r in recs if r["name"] == "host.rss_bytes"]
    assert rss and rss[0]["value"] > 1 << 20
    for r in recs:
        telemetry.validate_record(r)
        jtelemetry.validate_record(r)


def test_the_training_events_and_phases_are_the_references():
    assert tracing.TRAIN_STEP_PHASES == jtracing.TRAIN_STEP_PHASES
    for name in ("train_step.phase", "checkpoint.save", "checkpoint.verify",
                 "checkpoint.retry", "checkpoint.preemption",
                 "elastic.resume", "elastic.epoch_skipped",
                 "supervisor.sentinel_skip", "supervisor.restart",
                 "supervisor.rollback", "supervisor.degrade",
                 "resume.capsule_write", "resume.capsule_restore",
                 "integrity.fingerprint", "integrity.vote",
                 "integrity.quarantine", "integrity.rollback"):
        assert tracing.KNOWN_EVENTS[name] == jtracing.KNOWN_EVENTS[name]
    rec = tracing.emit("train_step.phase", t0=1.0, t1=1.25,
                       phase="data_wait")
    jtracing.validate_event(rec)
    assert rec["data"]["seconds"] == 0.25
    assert mx.profiler is profiler
