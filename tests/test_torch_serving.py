"""The PyTorch/CUDA port's serving path against the JAX reference.

Small sizes (vocabulary 64, width 32, 2 heads, 2 layers) on the CPU,
where the port's kernel wrappers run their plain PyTorch versions.  The
same seed gives both packages the same TinyLM weights, so greedy token
streams are compared exactly.
"""
import threading

import numpy as np
import pytest
import torch

from tpu_mx.serving import PagedKVCache as JCache
from tpu_mx.serving import Server as JServer
from tpu_mx.serving import TinyLM as JTinyLM

from tpu_mx_torch import tracing
from tpu_mx_torch.base import MXNetError, NumericDivergence
from tpu_mx_torch.serving import (AdmissionReject, BlockAllocator,
                                  CacheExhausted, ContinuousBatchingScheduler,
                                  PagedKVCache, Request, Server, TinyLM)

SMALL = dict(vocab_size=64, embed_dim=32, num_heads=2, num_layers=2)
PROMPTS = ([5, 6, 7], [9, 2], [1] * 7, [3, 14, 15, 9, 2, 6, 5, 3, 5] * 2)


@pytest.fixture(autouse=True)
def _fresh_recorder():
    tracing.reset()
    yield
    tracing.reset()


def port_model(seed=0, **kw):
    return TinyLM(**{**SMALL, **kw}, seed=seed, device="cpu")


def _streams(server, prompts=PROMPTS, max_new_tokens=8):
    reqs = [server.submit(p, max_new_tokens=max_new_tokens) for p in prompts]
    server.run_until_idle()
    assert all(r.state == "done" for r in reqs)
    return [r.tokens for r in reqs]


# ---------------------------------------------------------------------------
# weights and the model forward
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 3])
def test_same_seed_same_weights_as_reference(seed):
    ref = JTinyLM(**SMALL, seed=seed)
    drawn = port_model(seed)
    carried = TinyLM.from_numpy(ref.tok_emb, ref.pos_emb, ref.layers,
                                ref.w_out, num_heads=SMALL["num_heads"],
                                device="cpu")
    for m in (drawn, carried):
        assert np.array_equal(m.tok_emb.numpy(), ref.tok_emb)
        assert np.array_equal(m.pos_emb.numpy(), ref.pos_emb)
        assert np.array_equal(m.w_out.numpy(), ref.w_out)
        for i, lay in enumerate(ref.layers):
            for n in ("wq", "wk", "wv", "wo"):
                assert np.array_equal(getattr(m, n)[i].numpy(), lay[n])
    tok, pos, layers, w_out = drawn.to_numpy()
    assert np.array_equal(layers[1]["wo"], ref.layers[1]["wo"])


@pytest.mark.parametrize("seed", [0, 3])
def test_prefill_matches_reference(seed):
    ref = JTinyLM(**SMALL, seed=seed)
    model = port_model(seed)
    tokens = np.random.RandomState(seed).randint(0, 64, size=23)
    k, v, logits = ref.prefill(tokens)
    k2, v2, logits2 = model.prefill(tokens)
    np.testing.assert_allclose(logits2.numpy(), logits, atol=1e-5, rtol=0)
    np.testing.assert_allclose(k2.numpy(), k, atol=1e-5, rtol=0)
    np.testing.assert_allclose(v2.numpy(), v, atol=1e-5, rtol=0)


def test_decode_step_writes_the_pool_and_matches_prefill():
    """One decode step after a prefill of L tokens gives the same greedy
    token as a prefill of L+1 tokens, and writes the new K/V where
    window_slots says."""
    model = port_model()
    cache = PagedKVCache(2, 2, 16, block_size=4, num_blocks=16,
                         device="cpu")
    prompt = [4, 8, 15, 16, 23]
    k, v, logits = model.prefill(prompt)
    cache.prefill("a", k, v)
    nxt = int(logits.argmax())
    cache.reserve_window("a", 1)
    tables, lengths = cache.batch_tables(["a"])
    bids, offs = cache.window_slots(["a"], 1)
    toks, drafts, health, last = model.decode_step(
        cache, [nxt], lengths - 1, tables, lengths, bids, offs)
    assert toks.shape == (1, 1) and drafts.shape == (1, 0) and last is None
    k_full, _, logits_full = model.prefill(prompt + [nxt])
    assert toks[0, 0] == int(logits_full.argmax())
    assert health == pytest.approx(float(logits_full.abs().max()),
                                   abs=1e-5)
    kp, _ = cache.pool(1)
    np.testing.assert_allclose(kp[bids[0, 0], offs[0, 0]].numpy(),
                               k_full[1, -1].numpy(), atol=1e-5)


# ---------------------------------------------------------------------------
# allocator and cache
# ---------------------------------------------------------------------------
def test_allocator_exhaustion_is_all_or_nothing_backpressure():
    a = BlockAllocator(4)
    got = a.alloc(3)
    assert len(got) == 3 and a.available == 1
    with pytest.raises(CacheExhausted):
        a.alloc(2)
    assert a.available == 1
    a.free(got)
    assert a.alloc(1) == [got[-1]]          # LIFO: last freed first
    report = a.audit()
    assert {k: report[k] for k in ("num_blocks", "used_blocks",
                                   "free_blocks", "total_refs")} == {
        "num_blocks": 4, "used_blocks": 1, "free_blocks": 3,
        "total_refs": 1}
    # the ledger's view of the same block: one unattributed reference
    assert [(h["id"], h["blocks"]) for h in report["holders"]] == [
        ("_anon", 1)] and report["used_bytes"] == a.ledger.block_bytes


def test_allocator_double_free_is_loud():
    a = BlockAllocator(4)
    got = a.alloc(2)
    a.free(got)
    with pytest.raises(MXNetError, match="double free"):
        a.free(got[:1])
    a.audit()


def test_allocator_concurrent_alloc_free_keeps_the_partition():
    a = BlockAllocator(64)
    errors = []

    def worker():
        try:
            for _ in range(200):
                try:
                    ids = a.alloc(3)
                except CacheExhausted:
                    continue
                a.free(ids)
        except Exception as e:  # noqa: BLE001 — surfaced below
            errors.append(e)

    threads = [threading.Thread(target=worker) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads) and not errors
    assert a.audit()["used_blocks"] == 0


def _kv(length, layers=2, heads=2, dim=16, seed=0):
    rng = np.random.RandomState(seed)
    return (torch.from_numpy(rng.randn(layers, length, heads, dim)
                             .astype(np.float32)),
            torch.from_numpy(rng.randn(layers, length, heads, dim)
                             .astype(np.float32)))


def test_batch_tables_buckets_and_contents_match_reference():
    """The same prefills/appends/frees on both caches give the same
    block tables, lengths and NB buckets (pow2 up to 4, then x4)."""
    port = PagedKVCache(2, 2, 16, block_size=4, num_blocks=64,
                        device="cpu")
    ref = JCache(2, 2, 16, block_size=4, num_blocks=64)
    for i, length in enumerate((3, 9, 14, 30, 5)):
        k, v = _kv(length, seed=i)
        port.prefill(f"s{i}", k, v)
        ref.prefill(f"s{i}", k.numpy(), v.numpy())
    for step in range(6):
        for s in ("s0", "s2", "s4"):
            port.reserve_window(s, 1)
            ref.reserve_window(s, 1)
        if step == 2:
            port.free_sequence("s1")
            ref.free_sequence("s1")
        for ids in (["s0"], ["s0", "s2"], ["s0", "s2", "s3", "s4"]):
            t1, l1 = port.batch_tables(ids)
            t2, l2 = ref.batch_tables(ids)
            assert np.array_equal(t1, t2) and np.array_equal(l1, l2)
            nb = t1.shape[1]
            assert nb in (1, 2, 4) or nb % 4 == 0
        port.audit()
    b1, o1 = port.window_slots(["s0", "s4"], 2)
    b2, o2 = ref.window_slots(["s0", "s4"], 2)
    assert np.array_equal(b1, b2) and np.array_equal(o1, o2)


def test_prefill_fills_blocks_and_truncate_frees_tail():
    cache = PagedKVCache(2, 2, 16, block_size=4, num_blocks=8,
                         device="cpu")
    k, v = _kv(6)
    cache.prefill("a", k, v)
    table = cache.block_table("a")
    assert len(table) == 2 and cache.blocks_for(6) == 2
    kp, vp = cache.pool(1)
    got = kp[table].reshape(-1, 2, 16)[:6]
    assert torch.equal(got, k[1])
    assert cache.reserve_window("a", 3) == [6, 7, 8]
    assert len(cache.block_table("a")) == 3
    cache.truncate("a", 7)
    assert cache.length("a") == 7 and len(cache.block_table("a")) == 2
    assert cache.audit()["used_blocks"] == 2
    with pytest.raises(MXNetError, match="already cached"):
        cache.prefill("a", k, v)
    with pytest.raises(CacheExhausted):
        cache.prefill("b", *_kv(40))
    assert cache.free_sequence("a") == 2
    report = cache.audit()
    assert {k: report[k] for k in ("num_blocks", "used_blocks",
                                   "free_blocks", "total_refs",
                                   "sequences", "index_refs")} == {
        "num_blocks": 8, "used_blocks": 0, "free_blocks": 8,
        "total_refs": 0, "sequences": 0, "index_refs": 0}
    assert report["holders"] == [] and report["tenants"] == {}


def test_bf16_pool_serves_close_to_the_f32_pool():
    """The pool's storage type is a cache option; the math stays f32."""
    model = port_model()
    f32 = Server(model, num_blocks=64, max_batch=4, device="cpu")
    bf16 = Server(model, num_blocks=64, max_batch=4, device="cpu",
                  dtype=torch.bfloat16)
    assert bf16.engine.cache.k_pool.dtype == torch.bfloat16
    a = _streams(f32, PROMPTS[:2], 4)
    b = _streams(bf16, PROMPTS[:2], 4)
    assert [len(x) for x in b] == [4, 4] and a[0][0] == b[0][0]


# ---------------------------------------------------------------------------
# the whole slice: Server streams against the reference Server
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arm", ["default", "paged-kernel-fused"])
def test_server_streams_equal_reference(monkeypatch, arm):
    if arm == "default":
        monkeypatch.delenv("TPUMX_PAGED_DECODE", raising=False)
        monkeypatch.delenv("TPUMX_FUSED_DECODE", raising=False)
    else:
        monkeypatch.setenv("TPUMX_PAGED_DECODE", "kernel")
        monkeypatch.setenv("TPUMX_FUSED_DECODE", "1")
    ref = JServer(JTinyLM(**SMALL, seed=0), num_blocks=64, max_batch=4)
    want = _streams(ref)
    got = _streams(Server(port_model(), num_blocks=64, max_batch=4,
                          device="cpu"))
    assert got == want


def test_serving_counters_match_reference():
    """The port counts under the reference's metric names: the same
    tokens and decode steps for the same run, and one paged-attention
    call per layer per decode step."""
    from tpu_mx import telemetry as jtel
    from tpu_mx_torch import telemetry as tel
    jtel.reset()
    tel.reset()
    _streams(JServer(JTinyLM(**SMALL, seed=0), num_blocks=64, max_batch=4))
    _streams(Server(port_model(), num_blocks=64, max_batch=4, device="cpu"))
    for name in ("serve.generated_tokens", "serve.decode_steps"):
        assert tel.get(name).value == jtel.get(name).value > 0, name
    assert tel.get("serve.decode_attention", kind="paged").value == \
        SMALL["num_layers"] * tel.get("serve.decode_steps").value


def test_preemption_on_a_tiny_pool_completes_with_the_same_streams():
    """A pool too small for the whole batch preempts (requeue, replay
    prefill of prompt + committed tokens) and still produces exactly the
    streams of a roomy pool."""
    want = _streams(Server(port_model(), num_blocks=64, max_batch=4,
                           device="cpu"), max_new_tokens=10)
    srv = Server(port_model(), num_blocks=9, block_size=4, max_batch=4,
                 device="cpu")
    reqs = [srv.submit(p, max_new_tokens=10) for p in PROMPTS]
    srv.run_until_idle()
    assert [r.tokens for r in reqs] == want
    assert sum(r.requeues for r in reqs) > 0
    assert any(e["event"] == "serve.evict"
               and e["data"]["reason"] == "preempted"
               for e in tracing.snapshot())
    assert srv.engine.cache.audit()["used_blocks"] == 0


def test_stream_yields_the_run_tokens():
    want = _streams(Server(port_model(), num_blocks=64, device="cpu"),
                    PROMPTS[:1], 6)[0]
    srv = Server(port_model(), num_blocks=64, device="cpu")
    assert list(srv.stream(PROMPTS[0], max_new_tokens=6)) == want


def test_eos_finishes_early():
    first = _streams(Server(port_model(), num_blocks=64, device="cpu"),
                     PROMPTS[:1], 6)[0]
    eos = first[2]
    srv = Server(port_model(), num_blocks=64, device="cpu", eos_id=eos)
    req = srv.submit(PROMPTS[0], max_new_tokens=6)
    srv.run_until_idle()
    assert req.tokens == first[:first.index(eos) + 1]
    assert req.finish_reason == "eos"


def test_admission_rejects_with_reasons():
    srv = Server(port_model(), num_blocks=4, block_size=4, max_pending=1,
                 device="cpu")
    with pytest.raises(AdmissionReject) as e:
        srv.submit([1] * 10, max_new_tokens=10)    # 5 blocks > pool of 4
    assert e.value.reason == "request_too_large"
    srv.submit([1, 2], max_new_tokens=2)
    with pytest.raises(AdmissionReject) as e:
        srv.submit([1, 2], max_new_tokens=2)
    assert e.value.reason == "queue_full"


def test_tenant_quota_and_weighted_pick():
    sched = ContinuousBatchingScheduler(
        max_batch=1, tenants={"a": {"max_inflight": 1},
                              "b": {"weight": 4.0}})
    sched.submit(Request([1], 4, tenant="a"))
    with pytest.raises(AdmissionReject) as e:
        sched.submit(Request([1], 4, tenant="a"))
    assert e.value.reason == "tenant_quota"
    b = sched.submit(Request([1], 4, tenant="b"))
    first = sched.take_prefills()
    assert len(first) == 1
    sched.mark_running(first[0])
    assert sched.take_prefills() == []              # batch of one is full
    sched.finish(first[0])
    second = sched.take_prefills()
    assert {first[0].tenant, second[0].tenant} == {"a", "b"}
    assert b in first + second


def test_unported_options_and_devices_are_refused_loudly():
    model = port_model()
    with pytest.raises(MXNetError, match="sampling spec"):
        Server(model, sampling="nucleus:0.9", device="cpu")
    if not torch.cuda.is_available():
        # the default device is the card: a CPU model cannot be served
        # there, and without a card the server refuses to start at all
        with pytest.raises(MXNetError, match="no CUDA device"):
            Server(model)
        with pytest.raises(MXNetError, match="no CUDA device"):
            PagedKVCache(2, 2, 16)


def test_non_finite_logits_raise_and_lose_no_request():
    model = port_model()
    model.w_out[0, 0] = float("nan")
    srv = Server(model, num_blocks=64, backoff=0.0, device="cpu")
    req = srv.submit(PROMPTS[0], max_new_tokens=4)
    with pytest.raises(NumericDivergence):
        srv.engine.prefill(req)
    # the server classifies it (numeric) and restarts the engine with the
    # request back in the queue, as the reference's does
    srv.step()
    assert srv.restarts == 1 and srv.generation == 1
    assert req.state == "queued" and srv.scheduler.queue_depth() == 1
    assert srv.engine.cache.audit()["used_blocks"] == 0


def test_request_timeline_phases_sum_to_latency():
    srv = Server(port_model(), num_blocks=64, device="cpu")
    req = srv.submit(PROMPTS[0], max_new_tokens=5)
    srv.run_until_idle()
    tl = req.timeline
    assert tl.outcome == "done" and tl.tokens == 5
    assert tl.total == pytest.approx(tl.ended_at - tl.t0, rel=1e-9)
    assert set(tl.phases) <= {"queue_wait", "prefill", "decode_gap"}
