"""Serving's decode arms against the JAX reference, on the CPU.

``TPUMX_PAGED_DECODE`` (``0`` dense-gather, ``1`` paged, ``kernel`` the
paged kernel alone) and ``TPUMX_FUSED_DECODE`` (``0`` the host layer
loop, ``1`` the whole-step fused arm), with speculation off and at a
window of 4: every combination serves the same greedy streams as the
reference ``Server`` under the same environment, and counts
``serve.decode_attention`` under the reference's kind names.  Unset, the
port's knobs take the paged fused arm (the reference's take its dense
host loop): the streams are the same.  The host loop's pieces are held
to the reference's: the cache writes and gathers bit for bit, the model
pieces to float32 rounding (1e-5).  The decode self-check
(``TPUMX_SELF_CHECK``) audits the steps the reference's schedule
samples, finds no mismatch on a clean run, and a chaos
``flaky_recompute`` is caught as ``DataCorruption`` in both packages;
the server restarts and the streams stay whole.
"""
import numpy as np
import pytest
import torch

from tpu_mx import telemetry as jtel
from tpu_mx.contrib import chaos as jchaos
from tpu_mx.parallel import integrity as jint
from tpu_mx.serving import PagedKVCache as JCache
from tpu_mx.serving import Server as JServer
from tpu_mx.serving import TinyLM as JTinyLM
from tpu_mx.serving import attention as jattn
from tpu_mx.serving import jax_model as jjm

from tpu_mx_torch import supervisor, telemetry, tracing
from tpu_mx_torch.contrib import chaos
from tpu_mx_torch.parallel import integrity
from tpu_mx_torch.serving import PagedKVCache, Server, TinyLM
from tpu_mx_torch.serving import attention as sattn
from tpu_mx_torch.serving import jax_model

SMALL = dict(vocab_size=64, embed_dim=32, num_heads=2, num_layers=2)
PROMPTS = ([5, 6, 7], [9, 2], [1] * 7, [3, 14, 15, 9, 2, 6, 5, 3, 5] * 2)
KNOBS = ("TPUMX_PAGED_DECODE", "TPUMX_FUSED_DECODE", "TPUMX_SPECULATIVE",
         "TPUMX_SELF_CHECK", "TPUMX_SELF_CHECK_SEED", "TPUMX_PREFIX_SHARING",
         "TPUMX_CHAOS")
TOL = 1e-5


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for name in KNOBS:
        monkeypatch.delenv(name, raising=False)
    tracing.reset()
    telemetry.reset()
    jtel.reset()
    yield
    tracing.reset()
    telemetry.reset()


def _streams(srv, prompts=PROMPTS, new=8):
    reqs = [srv.submit(p, max_new_tokens=new, request_id=f"r{i}")
            for i, p in enumerate(prompts)]
    srv.run_until_idle()
    assert all(r.state == "done" for r in reqs)
    return [r.tokens for r in reqs]


def _port(**kw):
    return Server(TinyLM(**SMALL, seed=0, device="cpu"), num_blocks=64,
                  max_batch=4, device="cpu", backoff=0.0, **kw)


def _ref(**kw):
    return JServer(JTinyLM(**SMALL, seed=0), num_blocks=64, max_batch=4,
                   **kw)


def _count(tel, kind):
    m = tel.get("serve.decode_attention", kind=kind)
    return 0 if m is None else m.value


# ---------------------------------------------------------------------------
# the knobs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("value,kind", [
    ("0", "dense"), ("", "dense"), ("off", "dense"), ("dense", "dense"),
    ("1", "paged"), ("auto", "paged"), ("xla", "paged"), ("on", "paged"),
    ("kernel", "paged-kernel"), ("interpret", "paged-kernel"),
    (" Kernel ", "paged-kernel")])
def test_decode_path_takes_the_references_values(monkeypatch, value, kind):
    monkeypatch.setenv("TPUMX_PAGED_DECODE", value)
    assert sattn.decode_path() == jattn.decode_path() == kind
    assert sattn.resolve_decode_path() == kind


@pytest.mark.parametrize("value,fused", [
    ("0", False), ("off", False), ("host", False), ("", False),
    ("1", True), ("on", True), ("auto", True), ("fused", True)])
def test_fused_requested_takes_the_references_values(monkeypatch, value,
                                                     fused):
    monkeypatch.setenv("TPUMX_FUSED_DECODE", value)
    assert jax_model.fused_requested() == jjm.fused_requested() == fused
    assert jax_model.resolve_fused("dense", None) is False
    assert jax_model.resolve_fused("paged", None) is fused
    assert jax_model.resolve_fused("paged-kernel", None) is fused


@pytest.mark.parametrize("env,value", [("TPUMX_PAGED_DECODE", "kernal"),
                                       ("TPUMX_FUSED_DECODE", "maybe")])
def test_unknown_values_raise_the_references_error(monkeypatch, env, value):
    monkeypatch.setenv(env, value)
    port, ref = ((sattn.decode_path, jattn.decode_path)
                 if env == "TPUMX_PAGED_DECODE"
                 else (jax_model.fused_requested, jjm.fused_requested))
    with pytest.raises(ValueError) as want:
        ref()
    with pytest.raises(ValueError) as got:
        port()
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match=env):
        _port()


def test_unset_the_port_decodes_paged_and_fused():
    """The one divergence: the reference's unset knobs take its dense
    host loop, the port's its paged fused arm; the streams agree."""
    assert sattn.decode_path() == "paged" and jattn.decode_path() == "dense"
    assert jax_model.fused_requested() and not jjm.fused_requested()
    srv = _port()
    assert (srv.engine.decode_kind, srv.engine.fused) == ("paged", True)
    assert _streams(srv) == _streams(_ref())
    ev = [e["data"] for e in tracing.snapshot()
          if e["event"] == "serve.decode_path"][-1]
    assert (ev["path"], ev["fused"], ev["storage"]) == ("paged", True,
                                                        "host")


# ---------------------------------------------------------------------------
# every arm: streams and counts against the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("spec", ["0", "4"])
@pytest.mark.parametrize("fused", ["0", "1"])
@pytest.mark.parametrize("paged", ["0", "1", "kernel"])
def test_every_arm_serves_the_references_streams(monkeypatch, paged, fused,
                                                 spec):
    monkeypatch.setenv("TPUMX_PAGED_DECODE", paged)
    monkeypatch.setenv("TPUMX_FUSED_DECODE", fused)
    monkeypatch.setenv("TPUMX_SPECULATIVE", spec)
    jsrv = _ref()
    want = _streams(jsrv)
    srv = _port()
    kind = {"0": "dense", "1": "paged", "kernel": "paged-kernel"}[paged]
    on_fused = fused == "1" and kind != "dense"
    assert srv.engine.decode_kind == jsrv.engine.decode_kind == kind
    assert srv.engine.fused == jsrv.engine.fused == on_fused
    assert srv.engine.spec_window == (4 if spec == "4" else 1)
    assert _streams(srv) == want
    steps = telemetry.get("serve.decode_steps").value
    assert steps == jtel.get("serve.decode_steps").value > 0
    layers = SMALL["num_layers"]
    # one decode attention a layer a step, under the arm's kind
    assert _count(telemetry, kind) == layers * steps
    for other in {"dense", "paged", "paged-kernel"} - {kind}:
        assert _count(telemetry, other) == 0
    if on_fused:
        # the reference's fused program has no decode_attention call
        assert _count(jtel, kind) == 0
        assert telemetry.get("serve.fused_steps").value == \
            jtel.get("serve.fused_steps").value == steps
    else:
        assert _count(jtel, kind) == layers * steps
        assert telemetry.get("serve.fused_steps") is None
    # nothing crosses a host/device boundary on the CPU
    assert telemetry.get("serve.host_crossings") is None
    assert telemetry.get("serve.host_crossings_per_token").value == 0
    ev = [e["data"] for e in tracing.snapshot()
          if e["event"] == "serve.decode_path"][-1]
    assert (ev["path"], ev["fused"]) == (kind, on_fused)


def test_the_host_loop_at_head_dim_80_takes_the_dense_gather(monkeypatch):
    """``paged`` where the kernel has no instance takes the dense gather
    and counts it ``dense``; ``kernel`` runs the kernel's plain version
    on the CPU and counts ``paged-kernel``."""
    kw = dict(vocab_size=64, embed_dim=160, num_heads=2, num_layers=2)
    monkeypatch.setenv("TPUMX_FUSED_DECODE", "0")
    got = {}
    for paged in ("1", "kernel"):
        monkeypatch.setenv("TPUMX_PAGED_DECODE", paged)
        telemetry.reset()
        srv = Server(TinyLM(**kw, seed=0, device="cpu"), num_blocks=64,
                     device="cpu")
        got[paged] = _streams(srv, PROMPTS[:2], 5)
        steps = telemetry.get("serve.decode_steps").value
        kind = "dense" if paged == "1" else "paged-kernel"
        assert _count(telemetry, kind) == 2 * steps
    monkeypatch.setenv("TPUMX_PAGED_DECODE", "1")
    assert got["1"] == got["kernel"] == _streams(
        JServer(JTinyLM(**kw, seed=0), num_blocks=64), PROMPTS[:2], 5)


# ---------------------------------------------------------------------------
# the host loop's pieces
# ---------------------------------------------------------------------------
def _caches():
    geo = dict(num_layers=2, num_heads=2, head_dim=4, block_size=4,
               num_blocks=16)
    ref, port = JCache(**geo), PagedKVCache(**geo, device="cpu")
    rng = np.random.RandomState(4)
    for sid, length in (("a", 6), ("b", 3), ("c", 9)):
        k, v = (rng.randn(2, length, 2, 4).astype(np.float32)
                for _ in range(2))
        ref.prefill(sid, k, v)
        port.prefill(sid, torch.from_numpy(k), torch.from_numpy(v))
    return ref, port, rng


def _pools_equal(ref, port):
    assert np.array_equal(port.k_pool.numpy(), ref.k_blocks)
    assert np.array_equal(port.v_pool.numpy(), ref.v_blocks)


def test_cache_writes_and_gathers_are_the_references():
    ref, port, rng = _caches()
    ids = ["a", "b", "c"]
    for c in (ref, port):
        for s in ids:
            c.reserve_window(s, 1)
    k, v = (rng.randn(3, 2, 4).astype(np.float32) for _ in range(2))
    ref.write_batch(ids, 1, k, v)
    port.write_batch(ids, 1, torch.from_numpy(k), torch.from_numpy(v))
    _pools_equal(ref, port)
    for c in (ref, port):
        c.reserve_window("b", 1)
    k1, v1 = (rng.randn(2, 4).astype(np.float32) for _ in range(2))
    ref.write("b", 0, k1, v1)
    port.write("b", 0, torch.from_numpy(k1), torch.from_numpy(v1))
    _pools_equal(ref, port)
    for c in (ref, port):
        for s in ids:
            c.reserve_window(s, 3)
    kw, vw = (rng.randn(3, 3, 2, 4).astype(np.float32) for _ in range(2))
    ref.write_window(ids, 0, kw, vw)
    port.write_window(ids, 0, torch.from_numpy(kw), torch.from_numpy(vw))
    _pools_equal(ref, port)
    for layer in (0, 1):
        jk, jv, jl = ref.gather_batch(ids, layer)
        k, v, lens = port.gather_batch(ids, layer)
        assert np.array_equal(k.numpy(), jk) and np.array_equal(v.numpy(),
                                                                jv)
        assert lens.dtype == torch.int32 and lens.tolist() == jl.tolist()


def test_pools_and_adopt_pools():
    _, port, _ = _caches()
    kps, vps = port.pools()
    assert len(kps) == len(vps) == 2
    assert kps[1].data_ptr() == port.k_pool[1].data_ptr()
    port.adopt_pools(kps, vps)                  # the same views: no copy
    new = [torch.full_like(kps[0], 2.0), kps[1]]
    port.adopt_pools(new, vps)
    assert (port.k_pool[0] == 2.0).all() and kps[0].data_ptr() == \
        port.k_pool[0].data_ptr()
    with pytest.raises(ValueError, match="adopt_pools"):
        port.adopt_pools(kps[:1], vps)


def test_model_pieces_are_the_references():
    ref = JTinyLM(**SMALL, seed=0)
    port = TinyLM(**SMALL, seed=0, device="cpu")
    tokens, pos = np.array([5, 70, 3]), np.array([0, 4, 9])
    h, jh = port.embed(tokens, pos), ref.embed(tokens, pos)
    np.testing.assert_allclose(h.numpy(), jh, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(
        port.embed(torch.from_numpy(tokens), pos).numpy(), jh, rtol=TOL,
        atol=TOL)
    for i in range(SMALL["num_layers"]):
        for a, b in zip(port.layer_qkv(i, h), ref.layer_qkv(i, jh)):
            np.testing.assert_allclose(a.numpy(), b, rtol=TOL, atol=TOL)
        attn = np.random.RandomState(i).randn(3, 2, 16).astype(np.float32)
        h = port.layer_combine(i, h, torch.from_numpy(attn))
        jh = ref.layer_combine(i, jh, attn)
        np.testing.assert_allclose(h.numpy(), jh, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(port.logits(h).numpy(), ref.logits(jh),
                               rtol=TOL, atol=TOL)
    with pytest.raises(ValueError, match="max_positions"):
        port.embed([1], [port.max_positions])


def test_dense_decode_attention_takes_the_references_operands():
    rng = np.random.RandomState(2)
    q = rng.randn(3, 2, 8).astype(np.float32)
    k, v = (rng.randn(3, 12, 2, 8).astype(np.float32) for _ in range(2))
    lens = np.array([12, 5, 1], np.int32)
    want = jattn.dense_decode_attention(q, k, v, lens)
    got = sattn.dense_decode_attention(torch.from_numpy(q),
                                       torch.from_numpy(k),
                                       torch.from_numpy(v),
                                       torch.from_numpy(lens))
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


# ---------------------------------------------------------------------------
# the decode self-check
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed,rate", [(0, 0.3), (7, 0.05), (12345, 0.5)])
def test_sampled_audits_the_references_indices(seed, rate):
    want = [i for i in range(4000) if jint.sampled(seed, i, rate)]
    got = [i for i in range(4000) if integrity.sampled(seed, i, rate)]
    assert got == want and 0 < len(got) < 4000
    assert integrity.ShadowAuditor(rate, seed).should_audit(got[0])
    assert integrity._mix64(seed) == jint._mix64(seed)


def test_bits_equal_and_perturb_are_the_references():
    a = np.arange(6, dtype=np.float32).reshape(2, 3)
    for x, y in ((a, a.copy()), (a, a.astype(np.float64)), ((a, 3), (a, 3)),
                 (a, integrity._perturb(a)), (7, 7), (None, None),
                 ([a], [a, a])):
        assert integrity.bits_equal(x, y) == jint.bits_equal(x, y)
    t = torch.from_numpy(a)
    assert integrity.bits_equal(t, t.clone())
    assert not integrity.bits_equal(t, integrity._perturb(t))
    assert np.array_equal(integrity._perturb(a), jint._perturb(a))
    assert integrity._perturb(5) == jint._perturb(5)


def test_a_flaky_recompute_is_data_corruption_in_both():
    out = np.array([[3, 9], [1, 4]], np.int64)
    for integ, ch in ((jint, jchaos), (integrity, chaos)):
        aud = integ.ShadowAuditor(rate=1.0, seed=0, surface="decode")
        assert aud.audit(out, lambda: out.copy(), step=0)
        with ch.enable(flaky_recompute=1):
            with pytest.raises(integ.DataCorruption) as e:
                aud.audit(out, lambda: out.copy(), step=1)
        assert e.value.self_corrupt and e.value.surface == "decode"
        assert (aud.audits, aud.mismatches) == (2, 1)
    assert supervisor.classify(e.value) == "corruption"


@pytest.mark.parametrize("fused", ["0", "1"])
def test_the_self_check_finds_nothing_on_a_clean_run(monkeypatch, fused):
    monkeypatch.setenv("TPUMX_FUSED_DECODE", fused)
    want = _streams(_port())
    telemetry.reset()
    monkeypatch.setenv("TPUMX_SELF_CHECK", "1.0")
    assert _streams(_port()) == want
    steps = telemetry.get("serve.decode_steps").value
    assert telemetry.get("integrity.self_checks").value == steps
    assert telemetry.get("integrity.shadow_audits").value == steps
    assert telemetry.get("integrity.self_check_mismatches") is None
    # the sampled cadence: the reference's schedule
    telemetry.reset()
    monkeypatch.setenv("TPUMX_SELF_CHECK", "0.5")
    monkeypatch.setenv("TPUMX_SELF_CHECK_SEED", "3")
    assert _streams(_port()) == want
    steps = telemetry.get("serve.decode_steps").value
    assert telemetry.get("integrity.self_checks").value == sum(
        jint.sampled(3, i, 0.5) for i in range(steps))


@pytest.mark.parametrize("fused", ["0", "1"])
def test_a_flaky_recompute_restarts_the_server_and_the_streams_hold(
        monkeypatch, fused):
    monkeypatch.setenv("TPUMX_FUSED_DECODE", fused)
    monkeypatch.setenv("TPUMX_SPECULATIVE", "4")
    want = _streams(_port())
    telemetry.reset()
    monkeypatch.setenv("TPUMX_SELF_CHECK", "1.0")
    srv = _port()
    with chaos.enable(flaky_recompute=1) as cfg:
        assert _streams(srv) == want
    assert cfg.flaky_fired == 1 and srv.restarts == 1
    assert telemetry.get("integrity.self_check_mismatches").value == 1
    restarts = [e["data"] for e in tracing.snapshot()
                if e["event"] == "serve.restart"]
    assert len(restarts) == 1 and "DataCorruption" in restarts[0]["reason"]
