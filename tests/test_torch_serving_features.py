"""The port's serving decode features against the JAX reference, on the CPU.

Top-k sampling (``serving/sampling.py``), speculative decoding
(``serving/speculative.py``, the paged kernel's ``(B, K)`` window) and
shared-prefix KV reuse (``serving/prefix_cache.py`` and the refcounted
``kv_cache.py``), at a small size: TinyLM vocabulary 64, width 32, 2
heads, 2 layers, block 8, with the same weights in both packages (the
same seed; ``TinyLM.from_numpy`` carries them too).  Streams are
compared exactly: on the CPU every arm of the port is a plain version.
"""
import numpy as np
import pytest
import torch

from tpu_mx.serving import Server as JServer
from tpu_mx.serving import TinyLM as JTinyLM
from tpu_mx.serving import sampling as jsampling
from tpu_mx.serving.speculative import SiblingProposer as JSiblingProposer

from tpu_mx_torch import telemetry, tracing
from tpu_mx_torch.base import MXNetError
from tpu_mx_torch.serving import (BlockAllocator, CacheExhausted, EngineCore,
                                  PagedKVCache, Request, Server, TinyLM)
from tpu_mx_torch.serving.prefix_cache import prefix_sharing_enabled
from tpu_mx_torch.serving.sampling import (GreedySampler, TopKSampler,
                                           fold_seed, make_sampler,
                                           parse_sampling)
from tpu_mx_torch.serving.speculative import (DEFAULT_WINDOW, SiblingProposer,
                                              accept_prefix,
                                              resolve_spec_window)

SMALL = dict(vocab_size=64, embed_dim=32, num_heads=2, num_layers=2)
PROMPTS = ([5, 6, 7], [9, 2], [1] * 7, [3, 14, 15, 9, 2, 6, 5, 3, 5] * 2)
SUFFIX_ATOL = 1e-6      # suffix prefill vs full prefill: float32 sums


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for name in ("TPUMX_SPECULATIVE", "TPUMX_PREFIX_SHARING",
                 "TPUMX_PAGED_DECODE", "TPUMX_FUSED_DECODE"):
        monkeypatch.delenv(name, raising=False)
    tracing.reset()
    telemetry.reset()
    yield
    tracing.reset()
    telemetry.reset()


def port_model(seed=0, **kw):
    return TinyLM(**{**SMALL, **kw}, seed=seed, device="cpu")


def ref_model(seed=0, **kw):
    return JTinyLM(**{**SMALL, **kw}, seed=seed)


def streams(server, prompts=PROMPTS, max_new_tokens=8, prefix="r"):
    reqs = [server.submit(p, max_new_tokens=max_new_tokens,
                          request_id=f"{prefix}{i}")
            for i, p in enumerate(prompts)]
    server.run_until_idle()
    assert all(r.state == "done" for r in reqs)
    return [r.tokens for r in reqs]


def port_server(model=None, **kw):
    kw.setdefault("num_blocks", 64)
    kw.setdefault("max_batch", 4)
    return Server(model or port_model(), device="cpu", **kw)


def ref_server(model=None, **kw):
    kw.setdefault("num_blocks", 64)
    kw.setdefault("max_batch", 4)
    return JServer(model or ref_model(), **kw)


def kv(rng, n, layers=2, heads=2, dim=4):
    k = torch.from_numpy(rng.rand(layers, n, heads, dim).astype(np.float32))
    return k, k * 0.5


def shared_cache(**kw):
    kw.setdefault("block_size", 4)
    kw.setdefault("num_blocks", 32)
    return PagedKVCache(2, 2, 4, share_prefix=True, device="cpu", **kw)


# ---------------------------------------------------------------------------
# samplers
# ---------------------------------------------------------------------------
def test_parse_sampling_specs_and_rejects():
    for spec in ("greedy", "", None, "top_k:8", " top_k:1 "):
        assert parse_sampling(spec) == jsampling.parse_sampling(spec)
    for bad in ("top_k", "top_k:0", "top_k:x", "nucleus:0.9"):
        with pytest.raises(MXNetError):
            parse_sampling(bad)


def test_fold_seed_equals_the_reference():
    for seed, rid in ((7, "r1"), (7, "r2"), (8, "r1"), (0, "req-000012")):
        assert fold_seed(seed, rid) == jsampling.fold_seed(seed, rid)
    assert fold_seed(7, "r1") != fold_seed(7, "r2")
    assert fold_seed(7, "r1") != fold_seed(8, "r1")


def test_top_k_sampler_is_bit_equal_to_the_reference_and_resumes():
    logits = np.random.RandomState(3).randn(64).astype(np.float32)
    ours, theirs = TopKSampler(8, seed=123), jsampling.TopKSampler(8, 123)
    first = [ours.sample(logits) for _ in range(20)]
    assert first == [theirs.sample(logits) for _ in range(20)]
    capsule = ours.state_dict()
    assert capsule == theirs.state_dict()
    rest = [ours.sample(logits) for _ in range(5)]
    # a fresh sampler loaded from the capsule (either package's) goes on
    # with the same draws
    for loader in (TopKSampler(8, seed=0), jsampling.TopKSampler(8, 0)):
        loader.load_state_dict(capsule)
        assert [loader.sample(logits) for _ in range(5)] == rest
    ours.reset()
    assert [ours.sample(logits) for _ in range(20)] == first
    with pytest.raises(MXNetError):
        TopKSampler(4, seed=0).load_state_dict(capsule)
    with pytest.raises(MXNetError):
        TopKSampler(0)
    assert make_sampler("greedy", None, 0) is None
    assert GreedySampler().sample(logits) == int(np.argmax(logits))


def test_top_k_streams_equal_the_reference_and_stay_in_the_top_k():
    want = streams(ref_server(sampling="top_k:8", sampling_seed=7))
    srv = port_server(sampling="top_k:8", sampling_seed=7)
    got = streams(srv)
    assert got == want
    assert got == streams(port_server(sampling="top_k:8", sampling_seed=7))
    assert got != streams(port_server(sampling="top_k:8", sampling_seed=8))
    # the engine pins speculation off for a sampling server
    assert srv.engine.spec_window == 1 and not srv.engine.greedy
    # every sampled token is among the 8 largest logits of its step
    model = port_model()
    for prompt, toks in zip(PROMPTS, got):
        for i, t in enumerate(toks):
            logits = model.prefill(list(prompt) + toks[:i])[2].numpy()
            assert t in np.argsort(logits)[-8:]


def test_top_k_with_speculation_asked_still_samples_one_token_a_step(
        monkeypatch):
    monkeypatch.setenv("TPUMX_SPECULATIVE", "4")
    want = streams(ref_server(sampling="top_k:4", sampling_seed=3))
    srv = port_server(sampling="top_k:4", sampling_seed=3)
    assert streams(srv) == want
    path = [e for e in tracing.snapshot()
            if e["event"] == "serve.decode_path"][-1]["data"]
    assert path["spec_window"] == 1 and path["sampling"] == "sampled"


# ---------------------------------------------------------------------------
# speculative decoding
# ---------------------------------------------------------------------------
def test_resolve_spec_window_env(monkeypatch):
    for off in ("", "0", "off", "no"):
        monkeypatch.setenv("TPUMX_SPECULATIVE", off)
        assert resolve_spec_window() == 1
    for on in ("1", "on", "yes", "auto"):
        monkeypatch.setenv("TPUMX_SPECULATIVE", on)
        assert resolve_spec_window() == DEFAULT_WINDOW
    monkeypatch.setenv("TPUMX_SPECULATIVE", "6")
    assert resolve_spec_window() == 6
    for bad in ("fast", "-2"):
        monkeypatch.setenv("TPUMX_SPECULATIVE", bad)
        with pytest.raises(ValueError, match="TPUMX_SPECULATIVE"):
            resolve_spec_window()


def test_accept_prefix_protocol():
    draft = np.array([7, 3, 5, 9])
    assert accept_prefix(draft, np.array([3, 5, 9, 2])) == 3
    assert accept_prefix(draft, np.array([3, 5, 1, 2])) == 2
    assert accept_prefix(draft, np.array([3, 1, 9, 2])) == 1
    assert accept_prefix(draft, np.array([1, 5, 9, 2])) == 0
    assert accept_prefix(draft, np.array([3, 1, 9, 9])) == 1
    assert accept_prefix(np.array([7]), np.array([4])) == 0


@pytest.mark.parametrize("spec", ["1", "3", "8"])
def test_spec_on_off_streams_equal_each_other_and_the_reference(monkeypatch,
                                                                spec):
    want = streams(ref_server())
    assert streams(port_server()) == want
    monkeypatch.setenv("TPUMX_SPECULATIVE", spec)
    srv = port_server()
    assert srv.engine.spec_window == (DEFAULT_WINDOW if spec == "1"
                                      else int(spec))
    assert streams(srv) == want
    assert streams(ref_server()) == want
    ratio = telemetry.get("serve.spec_accept_ratio")
    assert ratio is not None and 0.0 <= ratio.value <= 1.0
    assert telemetry.get("serve.spec_drafted").value > 0
    # every decode step ran the paged arm once a layer, on the window
    assert telemetry.get("serve.decode_attention", kind="paged").value == \
        SMALL["num_layers"] * telemetry.get("serve.decode_steps").value
    assert srv.engine.cache.audit()["used_blocks"] == 0


def test_spec_counters_match_the_reference_run(monkeypatch):
    from tpu_mx import telemetry as jtel
    monkeypatch.setenv("TPUMX_SPECULATIVE", "4")
    jtel.reset()
    streams(ref_server())
    streams(port_server())
    for name in ("serve.spec_drafted", "serve.generated_tokens",
                 "serve.decode_steps"):
        assert telemetry.get(name).value == jtel.get(name).value, name
    assert telemetry.get("serve.spec_accept_ratio").value == \
        jtel.get("serve.spec_accept_ratio").value


def test_full_window_rejection_truncates_exactly(monkeypatch):
    want = streams(port_server(), PROMPTS[:1], 6)[0]
    bad = next(t for t in range(64) if t not in want)
    monkeypatch.setenv("TPUMX_SPECULATIVE", "4")
    eng = EngineCore(port_model(), block_size=4, num_blocks=64)

    class AlwaysWrong:
        def draft(self, last_tokens, positions, n):
            return np.full((len(last_tokens), n), bad, np.int64)

    eng.proposer = AlwaysWrong()
    req = Request(PROMPTS[0], max_new_tokens=6, request_id="r")
    first, cached = eng.prefill(req)
    assert cached == 0
    got = [first]
    base = eng.cache.length(req.id)
    for step in range(5):
        res, pre = eng.decode([(req, got[-1])])
        assert not pre and len(res[req.id]) == 1
        got.extend(res[req.id])
        assert eng.cache.length(req.id) == base + step + 1
    assert got == want
    assert telemetry.get("serve.spec_drafted").value == 3 * 5
    assert telemetry.get("serve.spec_accept_ratio").value == 0.0
    assert telemetry.get("serve.spec_accepted") is None
    eng.evict(req)
    assert eng.cache.audit()["used_blocks"] == 0


def test_an_oracle_proposer_is_accepted_whole(monkeypatch):
    """A proposer that drafts the known stream: every window is
    accepted, the stream is unchanged, and it takes about a quarter of
    the decode steps."""
    prompt, n = PROMPTS[3], 12
    want = streams(port_server(), [prompt], n)[0]
    seq = list(prompt) + want
    steps_off = telemetry.get("serve.decode_steps").value
    monkeypatch.setenv("TPUMX_SPECULATIVE", "4")
    srv = port_server()

    class Oracle:
        def draft(self, last_tokens, positions, k):
            pos = torch.as_tensor(positions).tolist()
            return np.array([[seq[min(p + 1 + j, len(seq) - 1)]
                              for j in range(k)] for p in pos], np.int64)

    srv.engine.proposer = Oracle()
    assert streams(srv, [prompt], n)[0] == want
    steps_on = telemetry.get("serve.decode_steps").value - steps_off
    assert steps_off == n - 1 and steps_on == -(-(n - 1) // 4)
    assert telemetry.get("serve.spec_accept_ratio").value > 0.9


def test_eos_inside_an_accepted_draft(monkeypatch):
    want = streams(port_server(), PROMPTS[:1], 8)[0]
    eos = want[4]
    want_eos = streams(port_server(eos_id=eos), PROMPTS[:1], 8)[0]
    assert len(want_eos) < 8
    monkeypatch.setenv("TPUMX_SPECULATIVE", "4")
    srv = port_server(eos_id=eos)
    seq = list(PROMPTS[0]) + want

    class Oracle:
        def draft(self, last_tokens, positions, k):
            return np.array([[seq[min(p + 1 + j, len(seq) - 1)]
                              for j in range(k)]
                             for p in torch.as_tensor(positions).tolist()])

    srv.engine.proposer = Oracle()
    assert streams(srv, PROMPTS[:1], 8)[0] == want_eos
    assert streams(ref_server(eos_id=eos), PROMPTS[:1], 8)[0] == want_eos


def test_window_exhaustion_is_still_backpressure(monkeypatch):
    prompts = [[1, 2, 3]] * 5
    want = streams(port_server(), prompts, 6)
    monkeypatch.setenv("TPUMX_SPECULATIVE", "4")
    srv = port_server(num_blocks=6, block_size=2, max_tokens=1000)
    assert streams(srv, prompts, 6) == want
    assert srv.engine.cache.audit()["used_blocks"] == 0


def test_window_stays_inside_max_positions(monkeypatch):
    monkeypatch.setenv("TPUMX_SPECULATIVE", "4")
    model = port_model(max_positions=16)
    want = streams(Server(port_model(max_positions=16), device="cpu",
                          num_blocks=16), [[3] * 10], 6)
    srv = Server(model, device="cpu", num_blocks=16)
    assert streams(srv, [[3] * 10], 6) == want      # positions 10..15


def test_sibling_proposer_is_deterministic_on_the_device_and_drafts_as_the_reference():
    ref = ref_model()
    model = TinyLM.from_numpy(ref.tok_emb, ref.pos_emb, ref.layers,
                              ref.w_out, num_heads=SMALL["num_heads"],
                              device="cpu")
    last = np.array([3, 9, 61], np.int64)
    pos = np.array([5, 2, 40], np.int64)
    a = SiblingProposer(model).draft(torch.as_tensor(last),
                                     torch.as_tensor(pos), 3)
    assert isinstance(a, torch.Tensor) and a.shape == (3, 3)
    assert torch.equal(a, SiblingProposer(model).draft(last, pos, 3))
    assert np.array_equal(a.numpy(), JSiblingProposer(ref).draft(last, pos,
                                                                 3))
    top = np.array([model.max_positions - 1], np.int64)
    SiblingProposer(model).draft(np.array([1]), top, 3)   # clamps


# ---------------------------------------------------------------------------
# shared prefixes: allocator, cache, engine
# ---------------------------------------------------------------------------
def test_refcount_share_free_roundtrip():
    a = BlockAllocator(4)
    ids = a.alloc(2)
    a.incref(ids)
    assert all(a.refcount(b) == 2 for b in ids)
    a.free(ids)
    assert a.used == 2 and a.available == 2
    a.free(ids)
    assert a.used == 0 and a.available == 4 and a.refcounts() == {}
    with pytest.raises(MXNetError):
        a.free(ids)                    # double free
    with pytest.raises(MXNetError):
        a.incref(ids)                  # resurrecting a freed block
    with pytest.raises(MXNetError):
        a.incref([99])                 # foreign id
    assert a.audit()["total_refs"] == 0


def test_match_caps_at_the_final_token_and_shares_physical_blocks():
    cache = shared_cache()
    rng = np.random.RandomState(2)
    toks = list(range(8))
    k, v = kv(rng, 8)
    cache.prefill("a", k, v, tokens=toks)
    plan = cache.match_prefix(toks)
    assert plan is not None and plan.tokens_matched == 4
    assert plan.blocks == cache.block_table("a")[:1]
    kp, vp = cache.gather_plan(plan)
    assert torch.equal(kp, k[:, :4]) and torch.equal(vp, v[:, :4])
    cache.commit_prefill("b", plan, k[:, 4:], v[:, 4:], toks)
    assert cache.block_table("b")[0] == cache.block_table("a")[0]
    assert torch.equal(cache.gather("b", 1)[0], k[1])
    plan = cache.match_prefix(toks + [9, 9])
    assert plan.tokens_matched == 8
    cache.abandon_plan(plan)
    with pytest.raises(MXNetError):
        cache.abandon_plan(plan)       # a plan is consumed once
    plan = cache.match_prefix([0, 1, 2, 3, 7, 7, 7, 7, 7])
    assert plan.tokens_matched == 4
    cache.abandon_plan(plan)
    assert cache.match_prefix([5, 5, 5, 5, 5]) is None
    report = cache.audit()
    assert report["index_refs"] == 2 and report["sequences"] == 2
    cache.free_sequence("a")
    cache.free_sequence("b")
    assert cache.drop_prefix_cache() == 2
    assert cache.allocator.refcounts() == {}


def test_fork_then_divergent_append_copies_on_write():
    cache = shared_cache()
    k, v = kv(np.random.RandomState(0), 6)
    cache.prefill("p", k, v)
    cache.fork("p", "c")
    assert cache.block_table("p") == cache.block_table("c")
    before = cache.gather("p", 1)[0].clone()
    assert cache.reserve("c") == 6
    assert cache.block_table("c")[-1] != cache.block_table("p")[-1]
    bids, offs = cache.window_slots(["c"], 1)
    cache.k_pool[1, bids[0, 0], offs[0, 0]] = 9.0
    assert torch.equal(cache.gather("p", 1)[0], before)
    child = cache.gather("c", 1)[0]
    assert torch.all(child[6] == 9.0) and torch.equal(child[:6], before)
    assert cache.prefix_stats()["cow_copies"] == 1
    cache.free_sequence("p")
    cache.free_sequence("c")
    assert cache.allocator.used == 0


def test_pressure_evicts_index_blocks_but_backpressure_stands():
    cache = PagedKVCache(2, 2, 4, block_size=4, num_blocks=4,
                         share_prefix=True, device="cpu")
    rng = np.random.RandomState(3)
    k, v = kv(rng, 8)
    cache.prefill("a", k, v, tokens=list(range(8)))
    cache.free_sequence("a")
    assert cache.allocator.used == 2                   # the index keeps them
    k3, v3 = kv(rng, 12)
    cache.prefill("b", k3, v3, tokens=list(range(20, 32)))
    assert cache.prefix_stats()["evictions"] >= 1
    with pytest.raises(CacheExhausted):
        cache.prefill("c", *kv(rng, 8))
    assert not cache.has_sequence("c")
    cache.audit()


def test_commit_failure_releases_the_pins_and_fresh_blocks():
    cache = shared_cache(num_blocks=16)
    toks = list(range(9))
    k, v = kv(np.random.RandomState(20), 9)
    cache.prefill("a", k, v, tokens=toks)
    plan = cache.match_prefix(toks)
    with pytest.raises(ValueError):
        cache.commit_prefill("b", plan, k[:, :2, :1], v[:, :2, :1], toks)
    assert not cache.has_sequence("b")
    cache.free_sequence("a")
    cache.drop_prefix_cache()
    assert cache.allocator.refcounts() == {}


def test_sharing_refuses_a_lossy_pool():
    with pytest.raises(ValueError, match="float32"):
        PagedKVCache(2, 2, 4, dtype=torch.bfloat16, share_prefix=True,
                     device="cpu")
    PagedKVCache(2, 2, 4, dtype=torch.bfloat16, share_prefix=False,
                 device="cpu")


def test_prefix_sharing_env(monkeypatch):
    for off in ("", "0", "off", "false"):
        monkeypatch.setenv("TPUMX_PREFIX_SHARING", off)
        assert not prefix_sharing_enabled()
    for on in ("1", "on", "true", "share"):
        monkeypatch.setenv("TPUMX_PREFIX_SHARING", on)
        assert prefix_sharing_enabled()
    monkeypatch.setenv("TPUMX_PREFIX_SHARING", "maybe")
    with pytest.raises(ValueError, match="TPUMX_PREFIX_SHARING"):
        prefix_sharing_enabled()


def test_prefill_suffix_equals_the_full_prefill():
    model = port_model(seed=5)
    tokens = list(np.random.RandomState(6).randint(1, 60, size=21))
    k, v, logits = model.prefill(tokens)
    k2, v2, logits2 = model.prefill_suffix(tokens[16:], 16, k[:, :16],
                                           v[:, :16])
    torch.testing.assert_close(logits2, logits, rtol=0, atol=SUFFIX_ATOL)
    torch.testing.assert_close(k2, k[:, 16:], rtol=0, atol=SUFFIX_ATOL)
    torch.testing.assert_close(v2, v[:, 16:], rtol=0, atol=SUFFIX_ATOL)
    kinds = {kind: telemetry.get("serve.prefill_attention", kind=kind)
             for kind in ("flash", "dense")}
    assert kinds["flash"].value == kinds["dense"].value == SMALL["num_layers"]
    ref = ref_model(seed=5)
    rk, rv, rlog = ref.prefill(tokens)
    want = ref.prefill_suffix(tokens[16:], 16, rk[:, :16], rv[:, :16])[2]
    np.testing.assert_allclose(logits2.numpy(), want, rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="empty suffix"):
        model.prefill_suffix([], 16, k[:, :16], v[:, :16])


@pytest.mark.parametrize("spec", ["0", "4"])
def test_sharing_on_off_streams_equal_the_reference(monkeypatch, spec):
    monkeypatch.setenv("TPUMX_SPECULATIVE", spec)
    tpl = list(np.random.RandomState(6).randint(1, 60, size=20))
    prompts = [tpl + [i + 1, i + 2] for i in range(6)] + [tpl[:11]]

    def run(make, share):
        srv = make(model=None, num_blocks=256, block_size=8,
                   prefix_sharing=share)
        got = streams(srv, prompts, 8, prefix="q")
        stats = srv.engine.cache.prefix_stats()
        srv.engine.cache.drop_prefix_cache()
        assert srv.engine.cache.allocator.refcounts() == {}
        return got, stats

    on, stats = run(port_server, True)
    off, _ = run(port_server, False)
    want, ref_stats = run(ref_server, True)
    assert on == off == want
    assert stats["hits"] == ref_stats["hits"] >= 6
    assert stats["prefill_bytes_saved"] > 0
    assert stats["cached_tokens"] == ref_stats["cached_tokens"]
    prefills = [e["data"]["cached"] for e in tracing.snapshot()
                if e["event"] == "serve.prefill"]
    assert prefills.count(0) == 1 + len(prompts)     # first on, every off
    dense = telemetry.get("serve.prefill_attention", kind="dense").value
    assert dense == SMALL["num_layers"] * stats["hits"]


def test_preemption_never_corrupts_a_shared_prefix():
    tpl = list(np.random.RandomState(8).randint(1, 60, size=17))
    prompts = [tpl + [1], tpl + [2], tpl + [3]]

    def run(num_blocks):
        srv = port_server(port_model(seed=7), num_blocks=num_blocks,
                          block_size=8, max_batch=3, prefix_sharing=True)
        reqs = [srv.submit(p, max_new_tokens=12) for p in prompts]
        srv.run_until_idle()
        assert all(r.state == "done" for r in reqs)
        cache = srv.engine.cache
        cache.audit()
        cache.drop_prefix_cache()
        assert cache.allocator.refcounts() == {}
        return [r.tokens for r in reqs], sum(r.requeues for r in reqs)

    roomy, r0 = run(256)
    tight, r1 = run(7)
    assert r0 == 0 and r1 > 0
    assert tight == roomy
    want = JServer(ref_model(seed=7), num_blocks=7, block_size=8,
                   max_batch=3, prefix_sharing=True)
    jreqs = [want.submit(p, max_new_tokens=12) for p in prompts]
    want.run_until_idle()
    assert [r.tokens for r in jreqs] == roomy


def test_victim_selection_prefers_the_blocks_it_can_free():
    """Of two equal-weight candidates, the one holding more blocks of its
    own goes, though it is the older: freeing shared blocks returns no
    memory."""
    eng = EngineCore(port_model(seed=9), block_size=4, num_blocks=7,
                     share_prefix=True)
    tpl = [1, 2, 3, 4, 5, 6, 7, 8]
    items = []
    for name, prompt in (("a", tpl + [3, 3, 3, 3]),
                         ("b", list(range(50, 62))), ("c", tpl + [2])):
        r = Request(prompt, 8, request_id=name)
        first, _ = eng.prefill(r)
        items.append((r, first))
    eng.cache.drop_prefix_cache()
    # a: 3 blocks (2 shared with c); b: 3 of its own; c: 1 of its own —
    # the pool is full and a's reservation must evict one of b and c
    assert eng.cache.allocator.available == 0
    assert [eng.cache.exclusive_blocks(n) for n in "abc"] == [1, 3, 1]
    _, pre = eng.decode(items)
    assert [r.id for r in pre] == ["b"]
    eng.cache.audit()


def test_cached_prefill_attribution_on_the_timeline():
    tpl = list(np.random.RandomState(11).randint(1, 60, size=18))
    srv = port_server(port_model(seed=10), num_blocks=128, block_size=8,
                      max_batch=2, prefix_sharing=True)
    a = srv.submit(tpl + [1], max_new_tokens=3)
    srv.run_until_idle()
    b = srv.submit(tpl + [2], max_new_tokens=3)
    srv.run_until_idle()
    assert a.timeline.cached_tokens == 0 and b.timeline.cached_tokens == 16
    evs = {e["data"]["request"]: e["data"] for e in tracing.snapshot()
           if e["event"] == "serve.request_timeline"}
    assert evs[b.id]["cached_tokens"] == 16
    assert telemetry.get("serve.prefix_hit_ratio").value > 0
    path = [e for e in tracing.snapshot()
            if e["event"] == "serve.decode_path"][-1]["data"]
    assert path["sharing"] is True and path["spec_window"] == 1 \
        and path["sampling"] == "greedy"
