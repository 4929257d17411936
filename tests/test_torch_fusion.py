"""The port's fusion engine (``tpu_mx_torch/fusion.py``, ``engine.bulk``)
against its own eager dispatch and the JAX reference, on the CPU.

A fused segment replays the eager ops in order (on the card, one
captured CUDA graph of the same kernels), so forward AND backward are
bit-equal to the port's eager for every chain of the reference's
``tests/test_fusion.py``, the FMA chain and the ``sgd_update`` sweep
included (the reference's XLA fusion contracts those).  The port agrees
with the reference's eager within 2 float32 ulps: of each output's
largest magnitude, and for gradients of the larger of that and 1, the
scale of the chains' terms (inputs lie in [-2, 2]; log_softmax's
gradient 0.5·(1 - n·p) cancels from terms of 0.5 to values of 0.04,
where the two packages' eager backward formulas part by 23 ulps of the
result and under one of the terms).  The reference's own
fused backward is 1 ulp off its eager under jax 0.9, so the port is held
to the reference's eager, not to its fused backward.

Every flush cause, cache hits across scalar values, scalar spelling in
the keys, the deferred error, the ``TPUMX_FUSION`` modes and the bulk
size are covered, and ``engine``'s surface and counters beside the
reference's.
"""
import numpy as np
import pytest
import torch

import tpu_mx as jmx
from tpu_mx import autograd as jag
from tpu_mx import engine as jengine
from tpu_mx import fusion as jfusion
from tpu_mx import nd as jnd

import tpu_mx_torch as mx
from tpu_mx_torch import autograd, engine, fusion, nd, telemetry, tracing

ULPS = 2


@pytest.fixture(autouse=True)
def _host_and_clean_stats():
    fusion.reset_stats()
    jfusion.reset_stats()
    with mx.cpu():
        yield
    # no segment may outlive a test: every test ends in reads
    assert fusion.pending_ops() == 0


def _np_x(shape=(8, 8), lo=-2.0, hi=2.0):
    n = int(np.prod(shape))
    return np.linspace(lo, hi, n).reshape(shape).astype(np.float32)


def _x(shape=(8, 8), lo=-2.0, hi=2.0, F=None):
    return (F or nd).array(_np_x(shape, lo, hi), dtype="float32")


def _chains(F):
    b8 = F.array(np.linspace(0.1, 1.1, 8).astype(np.float32))
    return {
        "unary": lambda v: F.tanh(F.sin(F.exp(v * 0.25))),
        "scalar_mix": lambda v: (F.sqrt(F.abs(v / 1.7)) * 3).clip(0.05,
                                                                   1.5),
        "broadcast": lambda v: F.cos(v * b8),
        "cast": lambda v: F.cast(F.cast(F.relu(v), "float16"), "float32"),
        "compare_where": lambda v: F.where(v > 0.0, F.sigmoid(v), -v) / 2.0,
        "reduce_tail": lambda v: F.square(v).mean(axis=1) / 1.3,
        "softmax": lambda v: F.log_softmax(v * 0.5, axis=-1),
        "sum_all": lambda v: (F.exp(v * 0.1) / 2.5).sum(),
    }


def _fma(F):
    """The reference's FMA chain (``test_fma_chain_matches_jit_ground_
    truth``): a multiply feeding an add, three times."""
    b16 = F.array(np.linspace(0.1, 1.1, 16).astype(np.float32))

    def chain(v):
        for _ in range(3):
            v = F.tanh(v * 1.0009 + b16)
        return v
    return chain


NAMES = sorted(_chains(jnd))


def _near(got, want, floor=0.0):
    """Within ``ULPS`` float32 ulps of the larger of the tensor's largest
    magnitude and ``floor``."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    bound = ULPS * np.spacing(np.float32(max(np.abs(want).max(), floor)))
    assert np.abs(got.astype(np.float64) - want).max() <= bound


def _ref_eager(name):
    """The reference's eager forward and gradient of chain ``name``."""
    x = _x(F=jnd)
    x.attach_grad()
    with jag.record():
        y = _chains(jnd)[name](x)
        loss = y.sum()
    loss.backward()
    return y.asnumpy(), x.grad.asnumpy()


def _port(name, bulked):
    x = _x()
    x.attach_grad()
    with autograd.record():
        if bulked:
            with engine.bulk(64):
                y = _chains(nd)[name](x)
                loss = y.sum()
        else:
            y = _chains(nd)[name](x)
            loss = y.sum()
    loss.backward()
    return y.asnumpy(), x.grad.asnumpy()


@pytest.mark.parametrize("name", NAMES)
def test_fused_forward_is_eager_bit_for_bit_and_near_the_reference(name):
    chain = _chains(nd)[name]
    eager = chain(_x()).asnumpy()
    with engine.bulk(64):
        fused = chain(_x()).asnumpy()
    np.testing.assert_array_equal(fused, eager)
    assert engine.bulk_stats()["segments_flushed"] >= 1
    want = _chains(jnd)[name](_x(F=jnd)).asnumpy()
    _near(fused, want)


@pytest.mark.parametrize("name", NAMES)
def test_fused_backward_is_eager_bit_for_bit_and_near_the_reference(name):
    ey, eg = _port(name, bulked=False)
    fy, fg = _port(name, bulked=True)
    np.testing.assert_array_equal(fy, ey)
    np.testing.assert_array_equal(fg, eg)
    ry, rg = _ref_eager(name)
    _near(fy, ry)
    _near(fg, rg, floor=1.0)


def test_the_fma_chain_is_eager_bit_for_bit():
    """XLA contracts this chain into FMAs inside its fused loop (the
    reference's one documented divergence); the port's replay runs the
    eager kernels, so it stays bit-equal to eager, forward and backward.
    Against the reference's eager it is held to the reference's own
    tolerance for this chain (its tanh is another approximation)."""
    def run(bulked):
        x = _x((16, 16))
        x.attach_grad()
        with autograd.record():
            with engine.bulk(64 if bulked else 1):
                y = _fma(nd)(x)
                loss = y.sum()
        loss.backward()
        return y.asnumpy(), x.grad.asnumpy()
    (ey, eg), (fy, fg) = run(False), run(True)
    np.testing.assert_array_equal(fy, ey)
    np.testing.assert_array_equal(fg, eg)
    want = _fma(jnd)(_x((16, 16), F=jnd)).asnumpy()
    np.testing.assert_allclose(fy, want, rtol=1e-5, atol=1e-6)


def test_a_flushed_segment_is_one_tape_node():
    x = _x()
    x.attach_grad()
    with autograd.record():
        with engine.bulk(64):
            y = nd.tanh(nd.sin(x) * 0.5) + 1.0
        t = y._data
    assert type(t.grad_fn).__name__ == "_SegmentFunctionBackward"
    # one node over the leaf: the eager chain would stack four
    assert [type(f).__name__ for f, _ in t.grad_fn.next_functions
            if f is not None] == ["AccumulateGrad"]


def test_cache_hit_on_second_call_and_across_scalar_values():
    x = _x()
    with engine.bulk(64):
        a = nd.tanh(nd.sin(x) * 0.5).asnumpy()
    misses = fusion.stats["cache_misses"]
    with engine.bulk(64):
        b = nd.tanh(nd.sin(x) * 0.5).asnumpy()
    with engine.bulk(64):
        c = nd.tanh(nd.sin(x) * 0.25).asnumpy()
    assert fusion.stats["cache_misses"] == misses
    assert fusion.stats["cache_hits"] >= 2
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(c, nd.tanh(nd.sin(x) * 0.25).asnumpy())
    st = fusion.cache_stats()
    assert set(st) == set(jfusion.cache_stats())
    assert st["programs"] >= 1 and st["hits"] >= 2


def test_scalar_spelling_keys_apart():
    """clip(x, 0, 1) and clip(x, 0.0, 1.0) are equal Python values that
    promote differently: the chain key tells them apart."""
    xi = nd.array(np.arange(-2, 3, dtype=np.int32))
    with engine.bulk(4):
        a = nd.clip(xi, 0, 1)
        a.wait_to_read()
    with engine.bulk(4):
        b = nd.clip(xi, 0.0, 1.0)
        b.wait_to_read()
    assert fusion.stats["cache_misses"] == 2
    for got, lo, hi in ((a, 0, 1), (b, 0.0, 1.0)):
        want = nd.clip(xi, lo, hi)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got.asnumpy(), want.asnumpy())
    key = nd.clip._fuse  # the plan's key carries the scalar's type
    assert key(xi, 0, 1)[0] != key(xi, 0.0, 1.0)[0]


@pytest.mark.parametrize("cause", [
    "asnumpy", "wait_to_read", "nonfusible_consumer", "scope_exit",
    "waitall", "tape_boundary", "backward", "suppress_scope"])
def test_every_flush_cause_realizes_and_is_counted(cause):
    x = _x()
    want = {"asnumpy": "read_barrier", "wait_to_read": "read_barrier",
            "nonfusible_consumer": "read_barrier",
            "scope_exit": "scope_exit", "waitall": "waitall",
            "tape_boundary": "tape_boundary", "backward": "backward",
            "suppress_scope": "suppress_scope"}[cause]
    if cause == "backward":
        x.attach_grad()
        with autograd.record():
            with engine.bulk(64):
                y = nd.tanh(x) * 2.0
                assert y._lazy is not None
                y.backward()
                assert y._lazy is None
        xe = _x()
        xe.attach_grad()
        with autograd.record():
            ye = nd.tanh(xe) * 2.0
        ye.backward()
        np.testing.assert_array_equal(x.grad.asnumpy(), xe.grad.asnumpy())
    else:
        with engine.bulk(64):
            y = nd.relu(x)
            assert y._lazy is not None and fusion.pending_ops() == 1
            if cause == "asnumpy":
                y.asnumpy()
            elif cause == "wait_to_read":
                y.wait_to_read()
            elif cause == "nonfusible_consumer":
                z = nd.dot(y, y)
            elif cause == "waitall":
                nd.waitall()
            elif cause == "tape_boundary":
                with autograd.record():
                    assert y._lazy is None
            elif cause == "suppress_scope":
                with engine.bulk(1):
                    assert y._lazy is None
            if cause != "scope_exit":
                assert y._lazy is None and fusion.pending_ops() == 0
        assert y._lazy is None
        if cause == "nonfusible_consumer":
            np.testing.assert_array_equal(
                z.asnumpy(), nd.dot(nd.relu(x), nd.relu(x)).asnumpy())
    assert fusion.stats["flush_reasons"].get(want, 0) >= 1


def test_bulk_size_flushes_and_counts_like_the_reference():
    def run(F, eng, fus):
        fus.reset_stats()
        x = _x(F=F)
        with eng.bulk(4):
            y = x
            for _ in range(12):
                y = F.sin(y)
            out = y.asnumpy()
        st = eng.bulk_stats()
        return out, st
    out, st = run(nd, engine, fusion)
    ref_out, ref_st = run(jnd, jengine, jfusion)
    assert st["flush_reasons"].get("bulk_size", 0) >= 3
    assert st == ref_st
    eager = _x()
    for _ in range(12):
        eager = nd.sin(eager)
    np.testing.assert_array_equal(out, eager.asnumpy())
    _near(out, ref_out)


def test_lazy_metadata_answers_without_flushing():
    x = _x()
    with engine.bulk(64):
        y = nd.sin(x).sum(axis=0)
        assert y.shape == (8,) and y.dtype == np.float32
        assert y.ndim == 1 and y.size == 8
        assert y.context == mx.cpu()
        h = nd.cast(x, "bfloat16")
        assert h.dtype == torch.bfloat16
        assert y._lazy is not None and h._lazy is not None
        y.asnumpy()
        h.asnumpy()


def test_mixed_fused_and_eager_autograd():
    def run(bulked):
        x = _x()
        x.attach_grad()
        with autograd.record():
            h = nd.dot(x, x)          # eager (non-fusible) producer
            if bulked:
                with engine.bulk(64):
                    h = nd.tanh(h * 0.01)
                    h = h + 0.5
            else:
                h = nd.tanh(h * 0.01)
                h = h + 0.5
            loss = nd.dot(h, h).sum()  # eager consumer
        loss.backward()
        return x.grad.asnumpy()
    np.testing.assert_array_equal(run(False), run(True))


@pytest.mark.parametrize("case", ["grad_req_add", "blockgrad",
                                  "nondiff_sgd_update", "nondiff_head",
                                  "shared_tensor_handles"])
def test_gradients_through_segments_match_eager(case):
    def run(bulked):
        def ctx():
            return engine.bulk(64 if bulked else 1)
        if case == "grad_req_add":
            x = _x()
            x.attach_grad(grad_req="add")
            for _ in range(2):
                with autograd.record():
                    with ctx():
                        loss = (nd.sigmoid(x) * 3.0).sum()
                loss.backward()
            return [x.grad.asnumpy()]
        if case == "shared_tensor_handles":
            a = _x()
            d = a.detach()
            a.attach_grad()
            d.attach_grad()
            with autograd.record():
                with ctx():
                    loss = (nd.sin(a) * nd.exp(d)).sum()
            loss.backward()
            return [a.grad.asnumpy(), d.grad.asnumpy()]
        x = _x()
        x.attach_grad()
        if case == "nondiff_head":
            with autograd.record():
                seed = nd.sin(x).sum()
            seed.backward()
        with autograd.record():
            with ctx():
                if case == "blockgrad":
                    loss = (nd.BlockGrad(nd.exp(x)) * nd.sin(x)).sum()
                elif case == "nondiff_sgd_update":
                    new_w = nd.sgd_update(x, x * 0.1, lr=0.5)
                    loss = (new_w * nd.sin(x)).sum()
                else:
                    loss = nd.zeros_like(nd.exp(x)).sum()
        loss.backward()
        return [x.grad.asnumpy()]
    for e, f in zip(run(False), run(True)):
        np.testing.assert_array_equal(e, f)
        assert np.abs(f).max() > 0


def test_integer_outputs_are_not_taped():
    x = _x()
    x.attach_grad()
    with autograd.record():
        with engine.bulk(64):
            idx = nd.cast(nd.abs(x) * 2.0, "int32")
            s = nd.sin(x).sum()
    assert idx.dtype == np.int32 and not idx._data.requires_grad
    s.backward()
    np.testing.assert_array_equal(x.grad.asnumpy(),
                                  nd.cos(_x()).asnumpy())


def test_dead_segments_never_run():
    x = _x()
    with engine.bulk(64):
        nd.exp(x)
        nd.sin(x)
    assert fusion.stats["segments_dead"] >= 1
    assert fusion.stats["segments_flushed"] == 0


def test_inplace_rebind_and_out_realize_at_once():
    x = _x()
    ref = x.copy()
    ref += 2.0
    ref = nd.sin(ref).asnumpy()
    with engine.bulk(64):
        y = x.copy()
        y += 2.0
        assert y._lazy is None
        out = nd.sin(y).asnumpy()
        tgt = nd.zeros((8, 8))
        res = nd.exp(x, out=tgt)
        assert res is tgt and tgt._lazy is None
    np.testing.assert_array_equal(ref, out)
    np.testing.assert_array_equal(tgt.asnumpy(), nd.exp(x).asnumpy())


@pytest.mark.parametrize("mode", ["0", "1", "bulk1", "bulk1_over_1"])
def test_the_env_modes_and_the_op_by_op_escape(monkeypatch, mode):
    x = _x()
    if mode == "0":
        monkeypatch.setenv("TPUMX_FUSION", "0")
        with engine.bulk(64):
            y = nd.sin(x)
            assert y._lazy is None and fusion.stats["ops_fused"] == 0
    elif mode == "1":
        monkeypatch.setenv("TPUMX_FUSION", "1")
        y = nd.tanh(nd.sin(x))            # no bulk scope needed
        assert y._lazy is not None and fusion.enabled()
        out = y.asnumpy()
        monkeypatch.delenv("TPUMX_FUSION")
        np.testing.assert_array_equal(out, nd.tanh(nd.sin(x)).asnumpy())
    elif mode == "bulk1":
        with engine.bulk(1):
            y = nd.sin(x)
            assert y._lazy is None
    else:
        monkeypatch.setenv("TPUMX_FUSION", "1")
        with engine.bulk(1):
            y = nd.sin(x)
            assert y._lazy is None
        z = nd.sin(x)
        assert z._lazy is not None        # always-on resumes outside
        z.asnumpy()
    assert fusion.enabled() == (mode == "bulk1_over_1")


def test_bulk_restores_size_and_sizes_segments():
    prev = engine.set_bulk_size(7)
    try:
        with engine.bulk(31):
            assert engine._bulk_size == 31
        assert engine.set_bulk_size(7) == 7
    finally:
        engine.set_bulk_size(prev)
    with engine.bulk(3):
        y = _x()
        for _ in range(2):
            y = nd.sin(y)
        assert fusion.pending_ops() == 2
        y = nd.sin(y)                 # the third op fills the segment
        assert fusion.pending_ops() == 0 and y._lazy is None


def test_deferred_error_names_the_segment():
    x = _x((4, 4))
    b = nd.array(np.zeros((5,), np.float32))
    with pytest.raises(RuntimeError, match="fused op segment") as ei:
        with engine.bulk(64):
            y = nd.sin(x) + b         # invalid broadcast, raised at flush
            y.asnumpy()
    assert "sin -> add" in str(ei.value)


def test_record_scope_is_a_tape_boundary():
    x = _x()
    x.attach_grad()
    with engine.bulk(64):
        pre = nd.sin(x)               # issued while not recording
        with autograd.record():
            assert pre._lazy is None
            loss = (pre * nd.exp(x)).sum()
        loss.backward()
    xe = _x()
    xe.attach_grad()
    pre_e = nd.sin(xe)
    with autograd.record():
        loss_e = (pre_e * nd.exp(xe)).sum()
    loss_e.backward()
    np.testing.assert_array_equal(x.grad.asnumpy(), xe.grad.asnumpy())


def test_sgd_update_sweep_fuses_bit_for_bit():
    """The reference's contract here is a contraction tolerance (XLA
    fuses wd*w into an FMA); the port's replay is eager's exactly."""
    rng = np.random.RandomState(0)
    ws = [rng.rand(4, 4).astype(np.float32) for _ in range(3)]
    gs = [rng.rand(4, 4).astype(np.float32) for _ in range(3)]
    eager = [nd.sgd_update(nd.array(w), nd.array(g), lr=0.1,
                           wd=0.01).asnumpy() for w, g in zip(ws, gs)]
    with engine.bulk(64):
        outs = [nd.sgd_update(nd.array(w), nd.array(g), lr=0.1, wd=0.01)
                for w, g in zip(ws, gs)]
        assert fusion.stats["ops_fused"] >= 3 and fusion.pending_ops() == 3
        outs = [o.asnumpy() for o in outs]
    for e, o in zip(eager, outs):
        np.testing.assert_array_equal(e, o)
    ref = [jnd.sgd_update(jnd.array(w), jnd.array(g), lr=0.1,
                          wd=0.01).asnumpy() for w, g in zip(ws, gs)]
    for r, o in zip(ref, outs):
        _near(o, r)


def test_a_learning_rate_that_moves_every_step_under_bulk():
    """A schedule that changes lr each step: each fused step is eager's
    bit for bit.  ``sgd_update``'s lr is in its fuse key, as in the
    reference, so each new value is a new chain and a value seen before
    is a hit."""
    fusion.clear_cache()
    rng = np.random.RandomState(3)
    w0 = rng.rand(4, 4).astype(np.float32)
    g = rng.rand(4, 4).astype(np.float32)
    w_eager, w_fused = nd.array(w0), nd.array(w0)
    misses = fusion.stats["cache_misses"]
    for epoch in range(2):
        for step in range(6):
            lr = 0.1 / (1 + step)
            w_eager = nd.sgd_update(w_eager, nd.array(g), lr=lr, wd=0.01)
            with engine.bulk(64):
                w_fused = nd.sgd_update(w_fused, nd.array(g), lr=lr,
                                        wd=0.01)
            np.testing.assert_array_equal(w_fused.asnumpy(),
                                          w_eager.asnumpy())
        assert fusion.stats["cache_misses"] == misses + 6
    assert fusion.stats["cache_hits"] >= 6


def test_the_graph_cache_is_bounded_by_count_and_bytes(monkeypatch):
    """The card's graph cache drops its least recently used graphs past
    either bound; a graph alone above the byte bound stays until the
    next one comes.  (Stand-ins with the byte count a captured graph
    reports: the CPU captures none.)"""
    class Held:
        def __init__(self, nbytes):
            self.nbytes = nbytes

    fusion.clear_cache()
    monkeypatch.setattr(fusion, "GRAPH_CACHE_SIZE", 3)
    monkeypatch.setattr(fusion, "GRAPH_CACHE_BYTES", 100)
    gone = fusion.graph_stats()["evictions"]
    with fusion._graph_lock:
        for key, n in enumerate((40, 40, 10)):
            fusion._cache_put(key, Held(n))
        assert list(fusion._GRAPHS) == [0, 1, 2]
        fusion._cache_put(3, Held(30))       # 120 bytes: 0 goes
        assert list(fusion._GRAPHS) == [1, 2, 3]
        fusion._cache_put(4, Held(5))        # 4 graphs: 1 goes
        assert list(fusion._GRAPHS) == [2, 3, 4]
        fusion._cache_put(5, Held(500))      # alone above the bound
        assert list(fusion._GRAPHS) == [5]
    st = fusion.graph_stats()
    assert (st["graphs"], st["bytes"], st["capacity"],
            st["capacity_bytes"]) == (1, 500, 3, 100)
    assert st["evictions"] == gone + 5
    fusion.clear_cache()
    assert fusion.graph_stats()["bytes"] == 0


def test_unrepresentable_arguments_run_eagerly_and_are_counted():
    x = _x()
    before = telemetry.get("fusion.eager_fallbacks")
    before = 0 if before is None else before.value
    with engine.bulk(64):
        y = nd.add(x, np.float32(1.5))    # a numpy scalar: eager
        assert y._lazy is None
    after = telemetry.get("fusion.eager_fallbacks").value
    assert after == before + 1
    np.testing.assert_array_equal(y.asnumpy(), _np_x() + np.float32(1.5))


def test_flush_telemetry_and_trace_event():
    tracing.reset()
    x = _x()
    with engine.bulk(64):
        nd.tanh(nd.sin(x)).asnumpy()
    ev = [e for e in tracing.snapshot() if e["event"] == "fusion.flush"]
    assert ev and ev[-1]["data"] == {"cause": "read_barrier", "ops": 2}
    tracing.validate_event(ev[-1])
    m = telemetry.get("fusion.flush_cause", cause="read_barrier")
    assert m is not None and m.value >= 1


def test_engine_surface_matches_the_reference():
    assert sorted(engine.__all__) == sorted(jengine.__all__)
    assert engine.engine_type() == "TorchStreamDispatch"
    x = _x()
    got = engine.push_async(lambda r, w: r[0].asnumpy().sum(),
                            read_arrays=[x])
    assert got == pytest.approx(float(_np_x().sum()))
    with engine.bulk(64):
        y = nd.sin(x)
        engine.wait_for_all()
        assert y._lazy is None
    assert set(engine.bulk_stats()) == set(jengine.bulk_stats())
    engine.reset_bulk_stats()
    assert engine.bulk_stats()["ops_fused"] == 0
    assert mx.engine is engine and mx.fusion is fusion
