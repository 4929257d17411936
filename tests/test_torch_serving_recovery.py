"""The port's serving recovery plane against the JAX reference, on the CPU.

The committed-token journal (``serving/journal.py``: durability, never
guessing, compaction, one format for both packages), the classified
restart ladder (``supervisor.py``: the watchdog, ``classify``, restart
storms, the legacy prompt-replay arm, degrade), ``recover()`` after a
real kill -9 in another process, and ``drain``/``handoff``.  At a small
size: TinyLM vocabulary 64, width 64, 2 heads, 2 layers, the same seed
in both packages.  On the CPU every arm of the port is a plain version,
so streams are compared exactly: each recovered, restarted or migrated
stream equals the uninterrupted run's and the reference's, greedy and
``top_k``.
"""
import json
import os
import subprocess
import sys
import textwrap
import threading
import time
from pathlib import Path

import pytest

from tpu_mx import supervisor as jsupervisor
from tpu_mx import telemetry as jtelemetry
from tpu_mx import tracing as jtracing
from tpu_mx.contrib import chaos as jchaos
from tpu_mx.serving import Server as JServer
from tpu_mx.serving import TinyLM as JTinyLM
from tpu_mx.serving import journal as jjournal

from tpu_mx_torch import supervisor, telemetry, tracing
from tpu_mx_torch.base import MXNetError
from tpu_mx_torch.contrib import chaos
from tpu_mx_torch.elastic import WorkerFailure
from tpu_mx_torch.kernels import _build
from tpu_mx_torch.serving import (AdmissionReject, Request, Server, TinyLM)
from tpu_mx_torch.serving import journal as journal_mod
from tpu_mx_torch.serving.journal import TokenJournal, journal_path
from tpu_mx_torch.supervisor import NumericDivergence, WatchdogTimeout

ROOT = Path(__file__).resolve().parent.parent
SMALL = dict(vocab_size=64, embed_dim=64, num_heads=2, num_layers=2)
PROMPTS = ([1, 2, 3], [1, 2, 4], [7, 8])
SAMPLINGS = ("greedy", "top_k:40")


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    for name in ("TPUMX_SPECULATIVE", "TPUMX_PREFIX_SHARING",
                 "TPUMX_PAGED_DECODE", "TPUMX_FUSED_DECODE", "TPUMX_CHAOS",
                 "TPUMX_PREFILL_REPLAY"):
        monkeypatch.delenv(name, raising=False)
    for mod in (tracing, telemetry, jtracing, jtelemetry):
        mod.reset()
    yield
    for mod in (tracing, telemetry, jtracing, jtelemetry):
        mod.reset()


def port_server(**kw):
    kw.setdefault("num_blocks", 256)
    return Server(TinyLM(**SMALL, seed=0, device="cpu"), device="cpu", **kw)


def ref_server(**kw):
    kw.setdefault("num_blocks", 256)
    return JServer(JTinyLM(**SMALL, seed=0), **kw)


def submit_all(srv, prompts=PROMPTS, max_new=10):
    return [srv.submit(p, max_new, request_id=f"r{i}")
            for i, p in enumerate(prompts)]


def clean_streams(make, prompts=PROMPTS, max_new=10, **kw):
    """The uninterrupted run every recovery path must equal."""
    srv = make(**kw)
    reqs = submit_all(srv, prompts, max_new)
    srv.run_until_idle()
    assert all(r.state == "done" for r in reqs)
    return [list(r.tokens) for r in reqs]


def counter_value(name, **labels):
    c = telemetry.get(name, **labels)
    return 0 if c is None else c.value


def storm_streams(make, chaos_mod, sampling, replay=True, storm=3,
                  steps_before=2):
    """``storm`` back-to-back classified restarts mid-decode."""
    srv = make(max_restarts=5, backoff=0.0, sampling=sampling,
               sampling_seed=11, replay=replay)
    reqs = submit_all(srv)
    for _ in range(steps_before):
        srv.step()
    with chaos_mod.enable(restart_storm=storm) as cfg:
        srv.run_until_idle()
    assert cfg.storms_fired == storm and srv.restarts == storm
    return [list(r.tokens) for r in reqs], reqs


# ---------------------------------------------------------------------------
# the journal file: durability and never-guess recovery
# ---------------------------------------------------------------------------
def _journal_with_traffic(prefix, n_tokens=4):
    j = TokenJournal(prefix)
    req = Request([1, 2, 3], 8, request_id="r1")
    j.begin(req)
    for t in range(n_tokens):
        req.tokens.append(10 + t)
        j.commit_token(req, 10 + t)
    j.flush()
    return j, req


def test_journal_roundtrip_and_end_retires(tmp_path):
    j, req = _journal_with_traffic(str(tmp_path / "j"))
    e = journal_mod.load(j.path)["r1"]
    assert e["prompt"] == [1, 2, 3] and e["max_new"] == 8
    assert e["tokens"] == [10, 11, 12, 13]
    assert not e["ended"] and not e["fallback"]
    j.end(req, "length")
    j.flush()
    assert journal_mod.load(j.path)["r1"]["ended"]
    assert jjournal.load(j.path)["r1"]["ended"]
    j.close()


def test_journal_compact_drops_retired_keeps_live(tmp_path):
    j, req = _journal_with_traffic(str(tmp_path / "j"))
    done = Request([9], 1, request_id="done")
    j.begin(done)
    done.tokens.append(5)
    j.commit_token(done, 5)
    j.end(done, "length")
    j.flush()
    assert j.compact() == 1
    entries = journal_mod.load(j.path)
    assert set(entries) == {"r1"}
    assert entries["r1"]["tokens"] == [10, 11, 12, 13]
    # the compacted file is a journal that takes appends
    req.tokens.append(14)
    j.commit_token(req, 14)
    j.flush()
    assert journal_mod.load(j.path)["r1"]["tokens"][-1] == 14
    assert not list(tmp_path.glob("*.tmp.*"))     # atomic_write's tmp is gone
    j.close()


def test_journal_torn_final_line_dropped_loudly(tmp_path):
    j, _ = _journal_with_traffic(str(tmp_path / "j"))
    j.close()
    with open(j.path, "a", encoding="utf-8") as f:
        f.write('{"op":"token","request":"r1","i":4,"tok')
    for load in (journal_mod.load, jjournal.load):
        e = load(j.path)["r1"]
        assert e["tokens"] == [10, 11, 12, 13] and not e["fallback"]


def test_journal_midfile_corruption_degrades_all_unfinished(tmp_path):
    j, _ = _journal_with_traffic(str(tmp_path / "j"))
    j.close()
    lines = Path(j.path).read_text(encoding="utf-8").splitlines()
    lines[2] = "NOT JSON"
    Path(j.path).write_text("\n".join(lines) + "\n", encoding="utf-8")
    for load in (journal_mod.load, jjournal.load):
        e = load(j.path)["r1"]
        assert e["fallback"] and e["tokens"] == []


def test_journal_token_index_gap_degrades_that_stream(tmp_path):
    j, _ = _journal_with_traffic(str(tmp_path / "j"))
    j.close()
    with open(j.path, "a", encoding="utf-8") as f:
        f.write('{"op":"token","request":"r1","i":9,"token":3,'
                '"rng":null}\n')
    for load in (journal_mod.load, jjournal.load):
        e = load(j.path)["r1"]
        assert e["fallback"] and e["tokens"] == []


def test_journal_unknown_format_header_refuses(tmp_path):
    p = tmp_path / "weird-journal.jsonl"
    p.write_text('{"format":"somebody-elses-v9"}\n')
    with pytest.raises(MXNetError, match="refusing to guess"):
        journal_mod.load(str(p))


@pytest.mark.parametrize("sampling", SAMPLINGS)
@pytest.mark.parametrize("writer", ["port", "reference"])
def test_journal_loads_in_the_other_package(tmp_path, writer, sampling):
    """A journal written by one package's server loads in the other's
    ``journal.load`` with the same entries (prompts, tokens, sampler
    capsules), and the other package's ``recover()`` finishes the
    streams as the writer's own uninterrupted run does."""
    prefix = str(tmp_path / writer)
    kw = dict(sampling=sampling, sampling_seed=7)
    make, other = ((port_server, ref_server) if writer == "port"
                   else (ref_server, port_server))
    want = clean_streams(make, max_new=12, **kw)
    srv = make(journal=prefix, **kw)
    submit_all(srv, max_new=12)
    for _ in range(5):
        srv.step()
    path = journal_path(prefix)
    assert path == jjournal.journal_path(prefix)
    mine, theirs = journal_mod.load(path), jjournal.load(path)
    assert mine == theirs and len(mine) == len(PROMPTS)
    assert all(e["tokens"] and not e["ended"] for e in mine.values())
    successor = other(journal=prefix, **kw)
    handles = successor.recover()
    successor.run_until_idle()
    assert [list(handles[f"r{i}"].tokens)
            for i in range(len(PROMPTS))] == want


# ---------------------------------------------------------------------------
# the classified restart ladder
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("sharing", [False, True])
@pytest.mark.parametrize("sampling", SAMPLINGS)
def test_restart_storm_streams_equal_clean_run_and_reference(
        sharing, sampling, monkeypatch):
    """Three back-to-back classified restarts (``restart_storm``)
    mid-decode: every stream equals the uninterrupted run's and the
    reference's under the same storm; the ledger replays in one prefill,
    nothing is re-decoded."""
    monkeypatch.setenv("TPUMX_PREFIX_SHARING", "1" if sharing else "0")
    want = clean_streams(port_server, sampling=sampling, sampling_seed=11)
    got, reqs = storm_streams(port_server, chaos, sampling)
    ref, _ = storm_streams(ref_server, jchaos, sampling)
    assert got == want == ref
    assert all(r.requeues >= 1 for r in reqs)
    assert counter_value("serve.redecode_tokens") == 0
    assert counter_value("serve.engine_restarts") == 3


def test_restart_recovery_is_one_prefill_no_redecode():
    srv = port_server(max_restarts=3, backoff=0.0)
    reqs = submit_all(srv, max_new=12)
    for _ in range(5):
        srv.step()
    committed = {r.id: len(r.tokens) for r in reqs}
    assert all(n >= 4 for n in committed.values())
    with chaos.enable(restart_storm=1):
        srv.run_until_idle()
    assert srv.restarts == 1 and srv.generation == 1
    assert counter_value("serve.replay_requests") == len(reqs)
    assert counter_value("serve.replay_tokens") == sum(committed.values())
    assert counter_value("serve.redecode_tokens") == 0
    replays = [e for e in tracing.snapshot()
               if e["event"] == "serve.prefill" and e["data"]["replayed"]]
    assert sorted(e["data"]["replayed"] for e in replays) == \
        sorted(committed.values())
    assert all(e["generation"] == 1 for e in replays)


@pytest.mark.parametrize("sampling", SAMPLINGS)
def test_legacy_prompt_replay_arm_redecodes_and_equals_reference(sampling):
    """``replay=False``: a restart discards the ledgers; the catch-up
    re-decodes are counted and charged to ``restart_penalty``, and the
    re-rolled streams (a sampler rewinds to its first state) equal the
    clean run's and the reference's legacy arm's."""
    want = clean_streams(port_server, sampling=sampling, sampling_seed=11)
    srv = port_server(max_restarts=3, backoff=0.0, replay=False,
                      sampling=sampling, sampling_seed=11)
    reqs = submit_all(srv)
    for _ in range(5):
        srv.step()
    committed = sum(len(r.tokens) for r in reqs)
    assert committed > 0
    with chaos.enable(restart_storm=1):
        srv.run_until_idle()
    ref, _ = storm_streams(ref_server, jchaos, sampling, replay=False,
                           storm=1, steps_before=5)
    assert [list(r.tokens) for r in reqs] == want == ref
    assert counter_value("serve.redecode_tokens") == committed
    assert counter_value("serve.replay_tokens") == 0
    for r in reqs:
        assert r.timeline.phases.get("restart_penalty", 0.0) > 0.0


def test_replay_rides_the_prefix_cache_across_a_restart():
    template = list(range(1, 17))
    prompts = [template + [50 + i] for i in range(3)]
    srv = port_server(max_restarts=3, backoff=0.0, prefix_sharing=True)
    reqs = submit_all(srv, prompts, max_new=8)
    for _ in range(3):
        srv.step()
    with chaos.enable(restart_storm=1):
        srv.run_until_idle()
    assert all(r.state == "done" for r in reqs)
    st = srv.engine.cache.prefix_stats()
    assert st["hits"] > 0 and st["cached_tokens"] > 0, st


def test_watchdog_fires_once_restarts_and_dumps_a_valid_black_box(
        tmp_path):
    """``deadline=`` with a wedged decode (``slow_decode_step``): one
    ``WatchdogTimeout``, one classified restart to generation 1, every
    stream as the clean run's, and a black box that the port's and the
    reference's ``validate_blackbox`` accept; the zombie step ends on
    its own and touches only the discarded engine."""
    want = clean_streams(port_server)
    box = str(tmp_path / "wd")
    srv = port_server(deadline=0.3, backoff=0.0, blackbox=box)
    reqs = submit_all(srv)
    srv.step()
    old = srv.engine
    with chaos.enable(slow_decode_step=2, slow_decode_seconds=0.8) as cfg:
        srv.run_until_idle()
    assert cfg.slow_decodes == 1
    assert srv.restarts == 1 and srv.generation == 1 and srv.engine is not old
    assert telemetry.get("supervisor.watchdog_fires").value == 1
    assert [list(r.tokens) for r in reqs] == want
    restart = [e for e in tracing.snapshot()
               if e["event"] == "serve.restart"]
    assert len(restart) == 1 and "WatchdogTimeout" in \
        restart[0]["data"]["reason"]
    doc = json.loads(Path(tracing.blackbox_path(box)).read_text())
    tracing.validate_blackbox(doc)
    jtracing.validate_blackbox(doc)
    assert "serving engine restart 1/3" in doc["reason"]
    env = doc["environment"]
    assert env["torch"] and "jax" not in env
    # the zombie wakes, decodes on the discarded engine and ends
    zombies = [t for t in threading.enumerate()
               if t.name.startswith("watchdog-")]
    for t in zombies:
        t.join(timeout=5.0)
    assert not any(t.is_alive() for t in zombies)


def test_restart_budget_exhausted_degrades_loudly(tmp_path):
    """``max_restarts=0``: the first fault degrades — queued requests
    fail loudly, the running batch drains on one final generation, and
    an idle degraded server refuses to step."""
    srv = port_server(max_restarts=0, backoff=0.0, max_batch=2,
                      journal=str(tmp_path / "dg"))
    reqs = submit_all(srv, max_new=6)
    srv.step()
    running = [r for r in reqs if r.state == "running"]
    queued = [r for r in reqs if r.state == "queued"]
    assert len(running) == 2 and len(queued) == 1
    with chaos.enable(restart_storm=1):
        srv.run_until_idle()
    assert srv.degraded and srv.generation == 1
    assert all(r.state == "failed" and "degraded" in r.finish_reason
               for r in queued)
    assert all(r.state == "done" and len(r.tokens) == 6 for r in running)
    with pytest.raises(AdmissionReject) as e:
        srv.submit([1], 2)
    assert e.value.reason == "degraded"
    with pytest.raises(MXNetError, match="degraded"):
        srv.step()
    ended = journal_mod.load(journal_path(str(tmp_path / "dg")))
    assert all(e["ended"] for e in ended.values())


def test_second_fault_in_the_degraded_drain_fails_the_rest():
    srv = port_server(max_restarts=0, backoff=0.0)
    reqs = submit_all(srv)
    srv.step()
    with chaos.enable(restart_storm=2):
        srv.run_until_idle()
    assert srv.degraded
    assert all(r.state == "failed" for r in reqs)


def test_a_fatal_fault_propagates_without_a_restart(monkeypatch):
    """A CUDA-style error is fatal: it reaches the caller, the restart
    budget is untouched and the request is not lost."""
    srv = port_server()
    req = srv.submit([1, 2, 3], 4)

    def boom(r):
        raise RuntimeError("CUDA error: an illegal memory access was "
                           "encountered")
    monkeypatch.setattr(srv.engine, "prefill", boom)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        srv.step()
    assert srv.restarts == 0 and srv.generation == 0
    assert req.state == "queued" and srv.scheduler.queue_depth() == 1


# (exception, the port's class, the reference's twin)
CLASSIFY_CASES = [
    ("oserror", lambda: OSError("io"), lambda: OSError("io")),
    ("timeout", lambda: TimeoutError(), lambda: TimeoutError()),
    ("connection", lambda: ConnectionError(), lambda: ConnectionError()),
    ("watchdog", lambda: WatchdogTimeout("hung"),
     lambda: jsupervisor.WatchdogTimeout("hung")),
    ("worker", lambda: WorkerFailure("peer"),
     lambda: jsupervisor.WorkerFailure("peer")),
    ("chaos_crash", lambda: chaos.ChaosCrash("x"),
     lambda: jchaos.ChaosCrash("x")),
    ("numeric", lambda: NumericDivergence("nan"),
     lambda: jsupervisor.NumericDivergence("nan")),
    ("cuda_runtime_error", lambda: RuntimeError("CUDA error: misaligned"),
     lambda: RuntimeError("CUDA error: misaligned")),
    ("kernel_mxnet_error", lambda: MXNetError("CUDA error 700 at launch"),
     lambda: jsupervisor.MXNetError("x")),
    ("type_error", lambda: TypeError("bug"), lambda: TypeError("bug")),
    ("interrupt", lambda: KeyboardInterrupt(), lambda: KeyboardInterrupt()),
]


@pytest.mark.parametrize("case", CLASSIFY_CASES, ids=lambda c: c[0])
def test_classify_sorts_as_the_reference_does(case):
    _, port_exc, ref_exc = case
    got = supervisor.classify(port_exc())
    assert got == jsupervisor.classify(ref_exc())
    assert got in ("transient", "numeric", "fatal")


def test_a_kernel_library_that_fails_to_load_is_fatal(monkeypatch, tmp_path):
    """A ``dlopen`` that fails (an ``OSError``, which ``classify`` calls
    transient) surfaces as ``MXNetError``: fatal, never retried."""
    junk = tmp_path / "not-a-library.so"
    junk.write_text("not ELF")
    monkeypatch.setattr(_build, "build", lambda name: junk)
    monkeypatch.delitem(_build._libs, "paged_attention", raising=False)
    with pytest.raises(MXNetError, match="could not be built or loaded") \
            as e:
        _build.load("paged_attention")
    assert supervisor.classify(e.value) == "fatal"
    assert "paged_attention" not in _build._libs


def test_run_with_deadline_relays_results_errors_and_grace():
    assert supervisor.run_with_deadline(lambda: 5, None) == 5
    assert supervisor.run_with_deadline(lambda: 6, 1.0) == 6
    with pytest.raises(ValueError, match="inner"):
        supervisor.run_with_deadline(
            lambda: (_ for _ in ()).throw(ValueError("inner")), 1.0)
    moved = iter(range(100))
    assert supervisor.run_with_deadline(
        lambda: time.sleep(0.2) or 7, 0.05, grace=2.0,
        grace_signal=lambda: next(moved)) == 7
    with pytest.raises(WatchdogTimeout):
        supervisor.run_with_deadline(lambda: time.sleep(0.5), 0.05)
    assert telemetry.get("supervisor.watchdog_fires").value == 1


def test_sampling_runs_on_the_stepping_thread_only():
    """With the watchdog armed, prefill and decode run on daemon
    threads; a journaled RNG advances only on the caller's thread."""
    kw = dict(sampling="top_k:40", sampling_seed=3)
    want = clean_streams(port_server, max_new=8, **kw)
    srv = port_server(deadline=30.0, **kw)
    reqs = submit_all(srv, max_new=8)
    threads = set()
    for r in reqs:
        orig = r.sampler.sample

        def spy(logits, _orig=orig):
            threads.add(threading.current_thread())
            return _orig(logits)
        r.sampler.sample = spy
    srv.run_until_idle()
    assert threads == {threading.main_thread()}
    assert [list(r.tokens) for r in reqs] == want


# ---------------------------------------------------------------------------
# recover(): the journal in a new server
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("sampling", SAMPLINGS)
def test_journal_recover_resumes_equal_to_clean_and_reference(tmp_path,
                                                              sampling):
    kw = dict(sampling=sampling, sampling_seed=7)
    want = clean_streams(port_server, max_new=12, **kw)
    assert want == clean_streams(ref_server, max_new=12, **kw)
    prefix = str(tmp_path / "jr")
    srv = port_server(journal=prefix, **kw)
    reqs = submit_all(srv, max_new=12)
    for _ in range(6):
        srv.step()
    mid = {r.id: list(r.tokens) for r in reqs}
    assert all(mid.values())
    srv2 = port_server(journal=prefix, **kw)
    handles = srv2.recover()
    assert {rid: list(h.tokens) for rid, h in handles.items()} == mid
    admits = [e for e in tracing.snapshot() if e["event"] == "serve.admit"
              and e["data"].get("recovered")]
    assert len(admits) == len(PROMPTS)
    srv2.run_until_idle()
    assert [list(handles[f"r{i}"].tokens)
            for i in range(len(PROMPTS))] == want
    again = port_server(journal=prefix, **kw).recover()
    assert not again or all(h.state == "done" for h in again.values())


def test_recover_bypasses_admission_gates(tmp_path):
    prefix = str(tmp_path / "full")
    prompts = [[1, 2, 3 + i] for i in range(6)]
    want = clean_streams(port_server, prompts, max_new=8)
    srv = port_server(journal=prefix)
    reqs = submit_all(srv, prompts, max_new=8)
    for _ in range(3):
        srv.step()
    assert all(r.tokens for r in reqs)
    srv2 = port_server(journal=prefix, max_pending=2)
    handles = srv2.recover()
    assert len(handles) == 6
    srv2.run_until_idle()
    assert [list(handles[f"r{i}"].tokens) for i in range(6)] == want


def test_rejected_submit_journal_entry_is_retired(tmp_path):
    prefix = str(tmp_path / "rej")
    srv = port_server(journal=prefix, max_pending=1)
    srv.submit([1, 2, 3], 8, request_id="kept")
    with pytest.raises(AdmissionReject) as e:
        srv.submit([4, 5, 6], 8, request_id="bounced")
    assert e.value.reason == "queue_full"
    entries = journal_mod.load(journal_path(prefix))
    assert entries["bounced"]["ended"] and not entries["kept"]["ended"]
    srv2 = port_server(journal=prefix, max_pending=1)
    handles = srv2.recover()
    assert set(handles) == {"kept"}
    srv2.run_until_idle()
    assert handles["kept"].state == "done"


@pytest.mark.parametrize("sampling", SAMPLINGS)
def test_legacy_arm_requeue_keeps_journal_indices_consistent(tmp_path,
                                                             sampling):
    prefix = str(tmp_path / "legacy")
    srv = port_server(journal=prefix, replay=False, max_restarts=3,
                      backoff=0.0, sampling=sampling, sampling_seed=9)
    reqs = submit_all(srv)
    for _ in range(4):
        srv.step()
    with chaos.enable(restart_storm=1):
        srv.step()
    for _ in range(3):
        srv.step()
    entries = journal_mod.load(journal_path(prefix))
    for i, r in enumerate(reqs):
        e = entries[f"r{i}"]
        assert not e["fallback"]
        assert e["tokens"] == list(r.tokens)[:len(e["tokens"])]
    srv.run_until_idle()
    entries = journal_mod.load(journal_path(prefix))
    assert all(e["ended"] and not e["fallback"] for e in entries.values())


def test_recover_without_journal_is_loud():
    with pytest.raises(MXNetError, match="journal"):
        port_server(num_blocks=64).recover()


def test_recover_from_corrupt_journal_falls_back_to_prompt(tmp_path):
    want = clean_streams(port_server, [[1, 2, 3]], max_new=8)
    prefix = str(tmp_path / "jr")
    srv = port_server(journal=prefix)
    srv.submit([1, 2, 3], 8, request_id="r0")
    for _ in range(4):
        srv.step()
    path = journal_path(prefix)
    lines = Path(path).read_text(encoding="utf-8").splitlines()
    lines[2] = '{"op":'
    Path(path).write_text("\n".join(lines) + "\n", encoding="utf-8")
    srv2 = port_server(journal=prefix)
    handles = srv2.recover()
    assert list(handles["r0"].tokens) == []
    assert counter_value("serve.replay_fallbacks") == 1
    srv2.run_until_idle()
    assert list(handles["r0"].tokens) == want[0]


KILL9_CHILD = textwrap.dedent("""\
    import os, sys
    os.environ["TPUMX_CHAOS"] = "kill9_at_decode_step=4"
    sys.path.insert(0, sys.argv[2])
    from tpu_mx_torch.serving import Server, TinyLM
    model = TinyLM(vocab_size=64, embed_dim=64, num_heads=2, num_layers=2,
                   seed=0, device="cpu")
    srv = Server(model, num_blocks=256, journal=sys.argv[1], device="cpu")
    for i, p in enumerate([[1, 2, 3], [1, 2, 4], [7, 8]]):
        srv.submit(p, 12, request_id=f"r{i}")
    srv.run_until_idle()   # dies inside decode step 4: os._exit(137)
    print("SHOULD NOT REACH HERE")
""")


def test_kill9_cross_process_recovery_zero_lost_tokens(tmp_path):
    """A real ``os._exit(137)`` inside a decode step of a port server in
    another process, then ``recover()`` here: every stream resumes at the
    dead process's fsync'd ledger and ends equal to the uninterrupted
    run and the reference's — nothing lost, duplicated or re-yielded."""
    prefix = str(tmp_path / "k9")
    env = {k: v for k, v in os.environ.items() if k != "TPUMX_CHAOS"}
    proc = subprocess.run([sys.executable, "-c", KILL9_CHILD, prefix,
                           str(ROOT)], capture_output=True, text=True,
                          timeout=300, env=env, cwd=str(tmp_path))
    assert proc.returncode == 137, (proc.returncode, proc.stderr[-2000:])
    assert "SHOULD NOT REACH HERE" not in proc.stdout
    entries = journal_mod.load(journal_path(prefix))
    assert len(entries) == 3 and not any(e["fallback"]
                                         for e in entries.values())
    survivors = {rid: e["tokens"] for rid, e in entries.items()}
    assert any(survivors.values())
    want = clean_streams(port_server, max_new=12)
    assert want == clean_streams(ref_server, max_new=12)
    srv = port_server(journal=prefix)
    handles = srv.recover()
    assert {rid: list(h.tokens) for rid, h in handles.items()} == survivors
    yielded = {rid: [] for rid in handles}
    while not srv.scheduler.idle():
        before = {rid: len(h.tokens) for rid, h in handles.items()}
        srv.step()
        for rid, h in handles.items():
            yielded[rid] += h.tokens[before[rid]:]
    for i in range(3):
        rid = f"r{i}"
        got = list(handles[rid].tokens)
        assert got == want[i]
        assert survivors[rid] + yielded[rid] == got   # nothing re-yielded
    assert counter_value("serve.redecode_tokens") == 0
    assert counter_value("serve.replay_requests") == sum(
        1 for t in survivors.values() if t)


# ---------------------------------------------------------------------------
# drain and handoff: planned maintenance, no client-visible failure
# ---------------------------------------------------------------------------
def test_drain_quiesces_closes_admission_and_reopens():
    want = clean_streams(port_server)
    srv = port_server()
    reqs = submit_all(srv)
    srv.step()
    srv.drain()
    assert [list(r.tokens) for r in reqs] == want
    assert all(r.state == "done" for r in reqs)
    with pytest.raises(AdmissionReject) as e:
        srv.submit([1], 2)
    assert e.value.reason == "draining"
    evs = [ev for ev in tracing.snapshot() if ev["event"] == "serve.drain"]
    assert evs and evs[0]["data"]["kind"] == "drain"
    srv.resume_admission()
    late = srv.submit([1], 2)
    srv.run_until_idle()
    assert late.state == "done"


@pytest.mark.parametrize("sampling", SAMPLINGS)
def test_handoff_migrates_live_sessions_equal_to_reference(sampling):
    kw = dict(sampling=sampling, sampling_seed=5)
    want = clean_streams(port_server, **kw)
    ref = ref_server(**kw)
    ref_reqs = submit_all(ref)
    srv = port_server(**kw)
    reqs = submit_all(srv)
    for _ in range(3):
        srv.step()
        ref.step()
    before = [list(r.tokens) for r in reqs]
    assert any(before)
    assert srv.handoff() == ref.handoff() == len(reqs)
    assert srv.generation == 1 and srv.restarts == 0
    for r, b in zip(reqs, before):
        assert list(r.tokens)[:len(b)] == b
    srv.run_until_idle()
    ref.run_until_idle()
    assert [list(r.tokens) for r in reqs] == want == \
        [list(r.tokens) for r in ref_reqs]
    evs, jevs = ([ev["data"] for ev in mod.snapshot()
                  if ev["event"] == "serve.drain"]
                 for mod in (tracing, jtracing))
    # the migrated sessions wait in the queue for their replay prefill
    assert evs == jevs == [{"kind": "handoff", "inflight": len(reqs),
                            "pending": len(reqs)}]


def test_handoff_under_journal_keeps_the_ledger_durable(tmp_path):
    prefix = str(tmp_path / "ho")
    srv = port_server(journal=prefix)
    req = srv.submit([1, 2, 3], 10, request_id="r0")
    for _ in range(4):
        srv.step()
    srv.handoff()
    assert journal_mod.load(journal_path(prefix))["r0"]["tokens"] == \
        list(req.tokens)
    srv.run_until_idle()
    assert req.state == "done"


def test_stream_yields_each_token_once_across_a_restart():
    want = clean_streams(port_server, [[1, 2, 3]], max_new=10)
    srv = port_server(max_restarts=2, backoff=0.0)
    out = []
    with chaos.enable(restart_storm=1):
        for tok in srv.stream([1, 2, 3], 10, request_id="r0"):
            out.append(tok)
    assert out == want[0] and srv.restarts == 1


def test_forced_reject_storm_rejects_with_its_reason():
    srv, ref = port_server(), ref_server()
    for s, mod in ((srv, chaos), (ref, jchaos)):
        with mod.enable(reject_storm=2) as cfg:
            for _ in range(2):
                with pytest.raises(Exception) as e:
                    s.submit([1, 2], 2)
                assert e.value.reason == "reject_storm"
            s.submit([1, 2], 2)
        assert cfg.rejects_forced == 2
    assert telemetry.get("chaos.injections", kind="reject_storm").value == 2


def test_chaos_is_armed_from_the_environment(monkeypatch):
    monkeypatch.setattr(chaos, "_config", None)
    monkeypatch.setattr(chaos, "_env_parsed", False)
    monkeypatch.setenv("TPUMX_CHAOS", "restart_storm=2,nan_streak=3,"
                       "hang_step=4")
    cfg = chaos.configure_from_env()
    assert cfg.restart_storm == 2 and cfg.nan_streak == 3
    assert chaos.configure_from_env() is cfg     # parsed once


def test_poisoned_decode_health_is_a_numeric_restart():
    want = clean_streams(port_server)
    srv = port_server(backoff=0.0)
    reqs = submit_all(srv)
    with chaos.enable(nan_after=3) as cfg:
        srv.run_until_idle()
    assert cfg.nans_fired == 1 and srv.restarts == 1
    assert "NumericDivergence" in [e for e in tracing.snapshot()
                                   if e["event"] == "serve.restart"][0][
                                       "data"]["reason"]
    assert [list(r.tokens) for r in reqs] == want
