"""The port's serving planes against the JAX reference, on the CPU.

The windowed telemetry and the live SLO monitor (``telemetry.py``,
``serving/slo.py``), the capacity ledger with its exhaustion forensics
(``serving/accounting.py``, ``serving/kv_cache.py``), the flight
recorder's black box (``tracing.py``) and the static-batching baseline
(``serving/scheduler.py``).  The same observations, traffic and seeds
go through both packages; what one package writes (telemetry records,
events, black boxes, forensic documents) the other's validators accept.
At a small size: TinyLM vocabulary 64, width 64, 2 heads, 2 layers.
"""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from tpu_mx import telemetry as jtelemetry
from tpu_mx import tracing as jtracing
from tpu_mx.serving import PagedKVCache as JCache
from tpu_mx.serving import SLO as JSLO
from tpu_mx.serving import Server as JServer
from tpu_mx.serving import SLOMonitor as JSLOMonitor
from tpu_mx.serving import StaticBatchingScheduler as JStatic
from tpu_mx.serving import TinyLM as JTinyLM
from tpu_mx.serving import validate_forensic_doc as j_validate_forensic_doc

from tpu_mx_torch import telemetry, tracing
from tpu_mx_torch.base import MXNetError
from tpu_mx_torch.contrib import chaos
from tpu_mx_torch.serving import (SLO, BlockAllocator, CacheExhausted,
                                  ContinuousBatchingScheduler, PagedKVCache,
                                  Request, Server, SLOMonitor,
                                  StaticBatchingScheduler, TinyLM,
                                  validate_forensic_doc)
from tpu_mx_torch.serving.accounting import INDEX_TENANT, UNATTRIBUTED
from tpu_mx_torch.serving.slo import NO_DATA

SMALL = dict(vocab_size=64, embed_dim=64, num_heads=2, num_layers=2)
PROMPTS = ([5, 6, 7], [9, 2], [1] * 7, [3, 14, 15, 9, 2, 6, 5, 3, 5] * 2)


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    for name in ("TPUMX_SPECULATIVE", "TPUMX_PREFIX_SHARING",
                 "TPUMX_PAGED_DECODE", "TPUMX_FUSED_DECODE", "TPUMX_CHAOS"):
        monkeypatch.delenv(name, raising=False)
    for mod in (tracing, telemetry, jtracing, jtelemetry):
        mod.reset()
    yield
    for mod in (tracing, telemetry, jtracing, jtelemetry):
        mod.reset()


def port_server(**kw):
    kw.setdefault("num_blocks", 64)
    kw.setdefault("max_batch", 4)
    return Server(TinyLM(**SMALL, seed=0, device="cpu"), device="cpu", **kw)


def ref_server(**kw):
    kw.setdefault("num_blocks", 64)
    kw.setdefault("max_batch", 4)
    return JServer(JTinyLM(**SMALL, seed=0), **kw)


def streams(srv, prompts=PROMPTS, max_new=8, tenants=None):
    reqs = [srv.submit(p, max_new, request_id=f"r{i}",
                       tenant=None if tenants is None else tenants[i])
            for i, p in enumerate(prompts)]
    srv.run_until_idle()
    assert all(r.state == "done" for r in reqs)
    return [list(r.tokens) for r in reqs]


def kv(rng, n, layers=2, heads=2, dim=4):
    k = rng.rand(layers, n, heads, dim).astype(np.float32)
    return k, (k * 0.5).astype(np.float32)


def assert_identity(alloc):
    report = alloc.audit()
    assert report["used_blocks"] == alloc.used
    total = sum(t["bytes_amortized"] for t in report["tenants"].values())
    assert total == pytest.approx(report["used_bytes"], abs=1e-6)
    return report


# ---------------------------------------------------------------------------
# telemetry windows and the SLO grammar
# ---------------------------------------------------------------------------
SPECS = ["itl_p99 < 50ms", "ttft_p99 < 500ms", "itl_p50 < 2s",
         "serve.phase_seconds_p95 < 300us", "ttft_p99.9 < 1.5s"]


@pytest.mark.parametrize("spec", SPECS)
def test_slo_specs_parse_as_the_reference_does(spec):
    assert telemetry.parse_slo_spec(spec) == jtelemetry.parse_slo_spec(spec)
    s, js = SLO.parse(spec), JSLO.parse(spec)
    assert (s.name, s.metric, s.quantile, s.threshold_seconds,
            s.objective) == (js.name, js.metric, js.quantile,
                             js.threshold_seconds, js.objective)


@pytest.mark.parametrize("spec", ["itl < 50ms", "itl_p99 < 50", "p99 < 1s",
                                  "itl_p100 < 1s", "itl_p0 < 1ms"])
def test_bad_slo_specs_are_refused_as_by_the_reference(spec):
    for mod in (telemetry, jtelemetry):
        with pytest.raises(ValueError):
            mod.parse_slo_spec(spec)


def test_slo_monitor_validates_as_the_reference_does():
    with pytest.raises(ValueError):
        SLO("m", quantile=1.5, threshold_seconds=0.1)
    with pytest.raises(ValueError, match="duplicate"):
        SLOMonitor(("itl_p99 < 50ms", "itl_p99 < 60ms"))
    with pytest.raises(ValueError, match="window"):
        SLOMonitor(windows=())


def _observe_both(samples, name="serve.itl_seconds", **labels):
    for mod in (telemetry, jtelemetry):
        h = mod.histogram(name, **labels)
        for x in samples:
            h.observe(x)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_window_quantiles_and_fractions_equal_the_reference(seed):
    rng = np.random.RandomState(seed)
    samples = np.exp(rng.uniform(np.log(1e-4), np.log(2.0), 500))
    samples[::37] = float("nan")        # dropped visibly, never bucketed
    _observe_both(samples)
    h, jh = (m.get("serve.itl_seconds") for m in (telemetry, jtelemetry))
    assert h.buckets == jh.buckets and h.counts == jh.counts
    assert h.dropped_nonfinite == jh.dropped_nonfinite > 0
    for q in (0.5, 0.9, 0.99, 0.999):
        assert h.window_quantile(q) == jh.window_quantile(q)
        assert h.quantile(q) == jh.quantile(q)
    for t in (1e-3, 0.05, 0.5):
        assert h.window_fraction_le(t, window=10.0) == \
            jh.window_fraction_le(t, window=10.0)
    recs = telemetry.snapshot()
    for rec in recs:
        telemetry.validate_record(rec)
        jtelemetry.validate_record(rec)
    for rec in jtelemetry.snapshot():
        telemetry.validate_record(rec)


def test_counter_windows_and_flush_records(tmp_path):
    c = telemetry.counter("serve.decode_steps")
    c.inc(3)
    assert c.window_delta() == 3 and c.window_rate() > 0
    path = tmp_path / "m.jsonl"
    telemetry.histogram("serve.ttft_seconds").observe(0.01)
    telemetry.flush(str(path))
    telemetry.flush(str(path), final=True)
    lines = path.read_text().splitlines()
    names = [json.loads(line)["name"] for line in lines]
    assert names.count("serve.decode_steps") == 2
    for line in lines:
        rec = json.loads(line)
        telemetry.validate_record(rec)
        jtelemetry.validate_record(rec)


@pytest.mark.parametrize("bad_share", [0.0, 0.03, 0.5])
def test_slo_evaluate_equals_the_reference(bad_share):
    """The same observations in both registries: the monitors' signals
    (estimates, attainment, burn rates, breach flags, per-tenant burn)
    are equal."""
    n = 1000
    bad = int(n * bad_share)
    samples = [0.005] * (n - bad) + [0.2] * bad
    _observe_both(samples)
    _observe_both(samples[: n // 2], tenant="acme")
    _observe_both([0.2] * 50, tenant="other")
    specs = ("itl_p99 < 50ms", "ttft_p99 < 500ms")
    mon = SLOMonitor(specs, windows=(5.0, 30.0))
    jmon = JSLOMonitor(specs, windows=(5.0, 30.0))
    got, want = mon.refresh(force=True), jmon.refresh(force=True)
    assert got == want
    assert got["breaching"] == (bad_share > 0.01)
    assert got["breaching_tenants"] == ["other"]
    assert telemetry.get("serve.slo_breaching", slo="itl_p99").value == \
        jtelemetry.get("serve.slo_breaching", slo="itl_p99").value
    assert telemetry.get("serve.slo_estimate_seconds",
                         slo="ttft_p99").value == NO_DATA
    evs = [e for e in tracing.snapshot() if e["event"] == "serve.slo"]
    jevs = [e for e in jtracing.snapshot() if e["event"] == "serve.slo"]
    assert [e["data"] for e in evs] == [e["data"] for e in jevs]
    for e in evs:
        tracing.validate_event(e)
        jtracing.validate_event(e)
    mon.refresh(force=True)
    assert len([e for e in tracing.snapshot()
                if e["event"] == "serve.slo"]) == len(evs)


def test_slo_breach_clears_when_the_window_expires(monkeypatch):
    clock = [2000.0]
    monkeypatch.setattr(telemetry, "_monotonic", lambda: clock[0])
    h = telemetry.histogram("serve.itl_seconds")
    for _ in range(10):
        h.observe(0.5)
    mon = SLOMonitor(("itl_p99 < 50ms",), windows=(10.0, 60.0))
    assert mon.refresh(force=True)["breaching"]
    clock[0] += 120.0
    assert not mon.refresh(force=True)["breaching"]
    evs = [e for e in tracing.snapshot() if e["event"] == "serve.slo"]
    assert [e["data"]["breaching"] for e in evs] == [True, False]
    assert telemetry.get("serve.slo_estimate_seconds",
                         slo="itl_p99").value == NO_DATA


def test_breaching_tenant_gets_the_slo_boost():
    sched = ContinuousBatchingScheduler(max_batch=1, max_tokens=10 ** 6,
                                        tenants={"a": {"weight": 1.0},
                                                 "b": {"weight": 1.0}},
                                        slo_boost=4.0)
    sched.slo_signal = {"slos": {"itl_p99": {"tenants": {
        "b": {"breaching": True}, "a": {"breaching": False}}}}}
    assert sched._breaching_tenants() == {"b"}
    assert sched._effective_weight("b", {"b"}) == 4.0
    assert sched._effective_weight("a", {"b"}) == 1.0
    # the boosted tenant is charged a quarter of the virtual time
    for t in ("a", "b", "a", "b"):
        sched.submit(Request([1] * 8, 8, tenant=t))
    order = []
    while not sched.idle():
        (req,) = sched.take_prefills()
        order.append(req.tenant)
        sched.mark_running(req)
        sched.finish(req)
    assert order[:3] == ["a", "b", "b"]


@pytest.mark.parametrize("slo", [True, ("itl_p99 < 30s", "ttft_p99 < 30s"),
                                 "itl_p99 < 30s"])
def test_server_slo_signal_is_finite_and_reaches_the_scheduler(slo):
    srv = port_server(slo=slo)
    assert isinstance(srv.slo, SLOMonitor)
    streams(srv)
    sig = srv.slo_signal
    assert sig is not None and srv.scheduler.slo_signal is sig
    assert np.isfinite(sig["max_burn_rate"])
    est = telemetry.get("serve.slo_estimate_seconds", slo="itl_p99").value
    assert est > 0 and np.isfinite(est)
    assert telemetry.get("serve.ttft_seconds").count == len(PROMPTS)
    for rec in telemetry.snapshot():
        jtelemetry.validate_record(rec)


def test_server_slo_off_and_junk():
    assert port_server(slo=False).slo_signal is None
    with pytest.raises(TypeError):
        port_server(slo=3.5)


def test_ttft_is_observed_once_per_request_across_a_restart():
    srv = port_server(backoff=0.0)
    with chaos.enable(nan_after=4):
        reqs = [srv.submit([1, 2, 3], 6) for _ in range(4)]
        srv.run_until_idle()
    assert srv.restarts == 1 and all(r.state == "done" for r in reqs)
    h = telemetry.get("serve.ttft_seconds")
    assert h.count == len(reqs)
    assert h.max == pytest.approx(max(r.ttft for r in reqs), rel=1e-6)


# ---------------------------------------------------------------------------
# the capacity ledger
# ---------------------------------------------------------------------------
def test_misattributed_free_is_loud_and_mutates_nothing():
    a = BlockAllocator(8)
    ids = a.alloc(2, holder="seq:a")
    with pytest.raises(MXNetError, match="does not hold"):
        a.free(ids, holder="seq:b")
    assert a.refcount(ids[0]) == 1
    assert_identity(a)
    a.free(ids, holder="seq:a")
    assert a.audit()["used_blocks"] == 0


def test_unattributed_callers_stay_ledgered():
    a = BlockAllocator(8, block_bytes=64)
    ids = a.alloc(3)
    a.incref(ids[:1])
    report = assert_identity(a)
    assert set(report["tenants"]) == {UNATTRIBUTED}
    assert report["tenants"][UNATTRIBUTED]["bytes_amortized"] == 3 * 64
    a.free(ids[:1])
    a.free(ids)
    assert a.audit()["used_blocks"] == 0


def _ledger_walk(cache, rng, to):
    """Share, pin, commit, fork, copy-on-write and pressure on one cache;
    the ledger's views after each step."""
    tokens = list(range(1, 13))
    views = []

    def snap():
        rep = cache.audit() if hasattr(cache, "audit") else None
        tenants = {t: (d["blocks"], d["refs"], d["holders"],
                       d["bytes_amortized"], d["bytes_exclusive"])
                   for t, d in rep["tenants"].items()}
        views.append((rep["used_blocks"], rep["total_refs"], tenants))

    k, v = kv(rng, 12)
    cache.prefill("s0", to(k), to(v), tokens=tokens, tenant="alpha")
    snap()
    plan = cache.match_prefix(tokens + [99], tenant="beta")
    assert plan.tokens_matched == 12
    snap()
    ks, vs = kv(rng, 1)
    cache.commit_prefill("s1", plan, to(ks), to(vs), tokens + [99],
                         tenant="beta")
    snap()
    cache.fork("s1", "s1-fork")
    snap()
    cache.reserve("s1-fork")
    snap()
    k2, v2 = kv(rng, 12)
    try:
        cache.prefill("s2", to(k2), to(v2), tenant="gamma")
    except CacheExhausted:
        pass
    snap()
    for sid in ("s0", "s1", "s1-fork", "s2"):
        cache.free_sequence(sid)
    cache.drop_prefix_cache()
    snap()
    return views


def test_cache_attribution_equals_the_reference():
    """Share, plan pins, the commit handoff, fork, copy-on-write and a
    pressure eviction on one cache in each package: the per-tenant
    blocks, references and bytes agree at every step, the identity holds
    throughout, and a drained cache holds nothing."""
    cache = PagedKVCache(2, 2, 4, block_size=4, num_blocks=12,
                         share_prefix=True, device="cpu")
    jcache = JCache(2, 2, 4, block_size=4, num_blocks=12, share_prefix=True)
    assert cache.allocator.ledger.block_bytes == \
        jcache.allocator.ledger.block_bytes
    got = _ledger_walk(cache, np.random.RandomState(3), torch.from_numpy)
    want = _ledger_walk(jcache, np.random.RandomState(3), lambda x: x)
    assert got == want
    assert got[0][2]["alpha"][3] == 1.5 * cache.allocator.ledger.block_bytes
    assert INDEX_TENANT in got[0][2]
    assert got[-1] == (0, 0, {})
    assert not cache.allocator.refcounts()


def test_forensic_record_on_exhaustion_is_valid_under_both_validators(
        tmp_path):
    """An undersized pool exhausts under two tenants' traffic: each
    exhaustion leaves a record naming every live holder, the rolling
    document validates under both packages, the flight recorder names
    the file, and the ledger ends empty."""
    prefix = str(tmp_path / "cap")
    srv = port_server(num_blocks=6, block_size=4, max_tokens=10 ** 6,
                      blackbox=prefix, prefix_sharing=True,
                      tenants={"a": {"weight": 1.0}, "b": {"weight": 1.0}})
    reqs = [srv.submit([1, 2, 3, 4, 5, 6, 7], 8,
                       tenant="a" if i % 2 else "b") for i in range(5)]
    srv.run_until_idle()
    assert all(r.state == "done" and len(r.tokens) == 8 for r in reqs)
    recs = srv.engine.cache.forensic_records()
    exh = [r for r in recs if r["kind"] == "exhaustion"]
    assert exh
    for rec in exh:
        assert sum(h["blocks"] for h in rec["holders"]) == \
            rec["pool"]["total_refs"]
        assert {h["tenant"] for h in rec["holders"]
                if h["kind"] == "sequence"} <= {"a", "b"}
    path = prefix + "-capacity.json"
    assert srv.engine.cache.flush_forensics() == path
    doc = json.loads(Path(path).read_text())
    validate_forensic_doc(doc)
    j_validate_forensic_doc(doc)
    assert len(doc["records"]) == len(recs)
    evs = [e for e in tracing.snapshot()
           if e["event"] == "serve.capacity_exhausted"]
    assert evs and evs[-1]["data"]["forensic"] == path
    srv.engine.cache.drop_prefix_cache()
    rep = srv.engine.cache.audit()
    assert rep["used_blocks"] == 0 and not rep["tenants"]


def test_reference_forensic_doc_is_valid_under_the_port(tmp_path):
    jcache = JCache(2, 2, 4, block_size=4, num_blocks=2, share_prefix=False,
                    forensics=str(tmp_path / "ref"))
    rng = np.random.RandomState(0)
    jcache.prefill("s0", *kv(rng, 8))
    with pytest.raises(Exception):
        jcache.prefill("s1", *kv(rng, 8))
    doc = json.loads(Path(jcache.flush_forensics()).read_text())
    validate_forensic_doc(doc)
    doc["records"][0]["pool"]["total_refs"] += 1
    with pytest.raises(ValueError, match="100% of live holders"):
        validate_forensic_doc(doc)


def test_unarmed_cache_records_forensics_in_memory_only(tmp_path):
    cache = PagedKVCache(2, 2, 4, block_size=4, num_blocks=2,
                         share_prefix=False, device="cpu")
    rng = np.random.RandomState(0)
    cache.prefill("s0", *map(torch.from_numpy, kv(rng, 8)))
    with pytest.raises(CacheExhausted):
        cache.prefill("s1", *map(torch.from_numpy, kv(rng, 8)))
    recs = cache.forensic_records()
    assert recs and recs[-1]["kind"] == "exhaustion"
    assert cache.flush_forensics() is None
    assert not list(tmp_path.iterdir())


def test_capacity_signal_gates_admission_until_blocks_free():
    sched = ContinuousBatchingScheduler(max_batch=4, max_tokens=10 ** 6)
    sched.submit(Request([1] * 16, 4))
    sched.capacity_signal = {"block_size": 4, "free_blocks": 1,
                             "reclaimable_blocks": 1}
    assert sched.take_prefills() == [] and sched.queue_depth() == 1
    sched.capacity_signal = {"block_size": 4, "free_blocks": 3,
                             "reclaimable_blocks": 1}
    assert len(sched.take_prefills()) == 1
    sched2 = ContinuousBatchingScheduler(max_batch=4, max_tokens=10 ** 6)
    sched2.submit(Request([1] * 16, 4))
    assert len(sched2.take_prefills()) == 1


def test_server_publishes_capacity_signal_and_pool_gauges():
    srv = port_server(num_blocks=32, block_size=4,
                      tenants={"acme": {"weight": 1.0}})
    srv.submit([1, 2, 3, 4, 5], 3, tenant="acme")
    srv.run_until_idle()
    sig = srv.capacity_signal
    assert sig is not None and sig["num_blocks"] == 32
    assert sig["free_blocks"] + sig["used_blocks"] == 32
    assert srv.scheduler.capacity_signal is sig
    used = telemetry.get("serve.pool_used_bytes").value
    total = sum(m.value for labels, m in telemetry.series("serve.pool_bytes")
                if labels.get("kind") == "amortized")
    assert total == pytest.approx(used)
    am = telemetry.get("serve.pool_bytes", tenant="acme", kind="amortized")
    assert am is not None and am.value == 0.0


def test_the_audit_holds_at_every_step_of_shared_tenant_traffic():
    srv = port_server(num_blocks=24, block_size=4, prefix_sharing=True,
                      tenants={"a": {"weight": 1.0}, "b": {"weight": 2.0}})
    system = list(range(1, 13))
    reqs = [srv.submit(system + [20 + i], 6, tenant="ab"[i % 2])
            for i in range(6)]
    cache = srv.engine.cache
    while not srv.scheduler.idle():
        srv.step()
        rep = assert_identity(cache.allocator)
        per = {t: d["bytes_amortized"] for t, d in rep["tenants"].items()}
        assert sum(per.values()) == pytest.approx(
            cache.allocator.used * cache.allocator.ledger.block_bytes)
    assert all(r.state == "done" for r in reqs)


# ---------------------------------------------------------------------------
# the black box
# ---------------------------------------------------------------------------
def test_restart_black_box_is_valid_under_both_packages(tmp_path):
    box = str(tmp_path / "bb")
    srv = port_server(backoff=0.0, blackbox=box, slo=True)
    reqs = [srv.submit(p, 8) for p in PROMPTS]
    srv.step()
    with chaos.enable(restart_storm=1):
        srv.run_until_idle()
    assert all(r.state == "done" for r in reqs)
    doc = json.loads(Path(tracing.blackbox_path(box)).read_text())
    tracing.validate_blackbox(doc)
    jtracing.validate_blackbox(doc)
    assert doc["format"] == jtracing.BLACKBOX_FORMAT
    names = {e["event"] for e in doc["events"]}
    assert {"chaos.inject", "serve.restart", "serve.admit",
            "serve.prefill", "serve.decode"} <= names
    tel = {r["name"] for r in doc["telemetry"]}
    assert "serve.slo_burn_rate" in tel
    assert doc["context"]["generation"] == 1
    assert telemetry.get("tracing.blackbox_dumps").value == 1


def test_reference_black_box_is_valid_under_the_port(tmp_path):
    jtracing.emit("serve.restart", n=1, reason="probe", requeued=0)
    path = jtracing.dump_blackbox(str(tmp_path / "ref"), reason="probe")
    doc = json.loads(Path(path).read_text())
    tracing.validate_blackbox(doc)
    doc["events"][0]["data"]["undeclared"] = 1
    with pytest.raises(ValueError, match="undeclared"):
        tracing.validate_blackbox(doc)


def test_events_are_checked_against_the_catalog():
    with pytest.raises(ValueError, match="unknown event"):
        tracing.emit("serve.nonsense")
    with pytest.raises(ValueError, match="undeclared"):
        tracing.emit("serve.restart", n=1, why="x")
    with pytest.raises(ValueError, match="must be int"):
        tracing.emit("serve.restart", n="one")
    rec = tracing.emit("serve.slo", burn_rate=float("nan"))
    assert rec["data"]["burn_rate"] == "nan"
    jtracing.validate_event(rec)
    tracing.configure(capacity=2)
    for i in range(3):
        tracing.emit("serve.restart", n=i)
    assert tracing.stats()["dropped"] >= 1
    tracing.configure(capacity=512)


# ---------------------------------------------------------------------------
# static batching, the baseline
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("sampling", ["greedy", "top_k:40"])
def test_static_batching_streams_equal_the_reference_and_continuous(
        sampling):
    kw = dict(sampling=sampling, sampling_seed=3)
    got = streams(port_server(scheduler=StaticBatchingScheduler(max_batch=2),
                              **kw))
    want = streams(ref_server(scheduler=JStatic(max_batch=2), **kw))
    cont = streams(port_server(max_batch=2, **kw))
    assert got == want == cont


def test_static_batching_waits_for_the_whole_batch():
    srv = port_server(scheduler=StaticBatchingScheduler(max_batch=2))
    reqs = [srv.submit([1, 2, 3], n) for n in (3, 8, 3)]
    srv.step()
    assert [r.state for r in reqs] == ["running", "running", "queued"]
    while not reqs[1].done:
        srv.step()
        # the short request stays as padding until the batch drains; the
        # third waits for the whole batch
        assert reqs[2].state == "queued" or reqs[1].done
    assert reqs[0].done and len(reqs[0].tokens) == 3
    srv.run_until_idle()
    assert all(r.state == "done" for r in reqs)
    assert srv.engine.cache.audit()["used_blocks"] == 0


def test_static_batching_padding_slots_are_preempted_first():
    """On a pool too small for the batch, the finished members (padding)
    give their blocks up first and are dropped from the books, never
    requeued; every stream equals the reference's."""
    def run(server):
        reqs = [server.submit([1, 2, 3, 4], n, request_id=f"r{i}")
                for i, n in enumerate((2, 12, 12))]
        server.run_until_idle()
        return [list(r.tokens) for r in reqs], [r.requeues for r in reqs]

    got = run(port_server(scheduler=StaticBatchingScheduler(max_batch=3),
                          num_blocks=9, block_size=4))
    want = run(ref_server(scheduler=JStatic(max_batch=3), num_blocks=9,
                          block_size=4))
    assert got == want
    assert got[1][0] == 0
