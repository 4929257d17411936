"""The port's kvstore (``tpu_mx_torch/kvstore.py``), gradient compression
and ``Trainer``'s kvstore arguments against the JAX reference, on the
CPU; and one real two-process ``dist_sync`` run over ``gloo``, started by
the port's launcher.

Push/pull math and the updater are exact (float32 sums of a few terms);
the compressed round trips are held to the reference at 1e-6 relative
(the cores' float32 arithmetic, as their own tests hold them); three
``Trainer`` steps through each kvstore argument match the reference's
at the imperative tests' tolerance (losses 1e-4 relative), and equal
the port's own run without a kvstore bit for bit where the store only
sums one copy.
"""
import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import tpu_mx as jmx
from tpu_mx import nd as jnd

import tpu_mx_torch as mx
from tpu_mx_torch import autograd, gluon, kvstore, nd, optimizer, telemetry
from tpu_mx_torch.base import MXNetError
from tpu_mx_torch.contrib.compression import GradientCompression

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _host():
    with mx.cpu():
        yield


def _arr(F, a):
    return F.array(np.asarray(a, np.float32))


@pytest.mark.parametrize("kind", ["local", "device", "nccl"])
def test_push_pull_math_matches_the_reference(kind):
    """The reference's nightly pattern: known values in, exact sums out;
    a pull without a push returns the stored value."""
    outs = []
    for F, kv_mod in ((nd, mx.kv), (jnd, jmx.kv)):
        kv = kv_mod.create(kind)
        kv.init(3, F.ones((2, 2)))
        kv.push(3, [F.ones((2, 2)) * i for i in range(4)])   # sum = 6
        out = F.zeros((2, 2))
        kv.pull(3, out)
        again = F.zeros((2, 2))
        kv.pull(3, again)
        kv.init([5, 6], [F.ones((3,)), F.zeros((3,))])
        kv.pushpull([5, 6], [F.ones((3,)) * 2, F.ones((3,)) * 4])
        o5, o6 = F.zeros((3,)), F.zeros((3,))
        kv.pull([5, 6], [o5, o6])
        outs.append([a.asnumpy() for a in (out, again, o5, o6)])
        assert (kv.rank, kv.num_workers) == (0, 1)
        assert repr(kv) == f"KVStore(type={kind}, rank=0/1)"
    for got, want in zip(*outs):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(outs[0][0], np.full((2, 2), 6.0))


def test_store_errors_and_types():
    kv = mx.kv.create("local")
    with pytest.raises(MXNetError, match="not initialized"):
        kv.push("w", nd.ones((2,)))
    with pytest.raises(MXNetError, match="unknown KVStore type"):
        mx.kv.create("bogus")
    assert kvstore.dist_init() is False       # no launcher environment
    for name in ("dist_sync", "dist_async", "dist_device_sync"):
        kv = mx.kv.create(name)
        assert (kv.type, kv.rank, kv.num_workers) == (name, 0, 1)
        kv.barrier()                          # no group: nothing to wait on
    assert mx.kvstore is kvstore and mx.kv is kvstore


def test_the_updater_applies_the_optimizer_on_push():
    rng = np.random.RandomState(0)
    w0 = rng.randn(4, 3).astype(np.float32)
    grads = [rng.randn(4, 3).astype(np.float32) for _ in range(3)]
    outs = []
    for F, pkg in ((nd, mx), (jnd, jmx)):
        kv = pkg.kv.create("device")
        kv.init("w", F.array(w0))
        kv.set_optimizer(pkg.optimizer.create("sgd", learning_rate=0.1,
                                              momentum=0.9))
        got = []
        for g in grads:
            kv.push("w", [F.array(g), F.array(g * 0.5)])
            out = F.zeros((4, 3))
            kv.pull("w", out)
            got.append(out.asnumpy())
        outs.append(got)
    for a, b in zip(*outs):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
    # set_updater takes any callable (index, grad, weight)
    kv = mx.kv.create("local")
    kv.init(0, nd.zeros((2,)))
    seen = []
    kv.set_updater(lambda k, g, w: seen.append((k, g.asnumpy().tolist())))
    kv.push(0, nd.ones((2,)))
    assert seen == [(0, [1.0, 1.0])]


def test_a_tampered_aggregate_raises_integrity_error():
    kv = mx.kv.create("device")
    kv.init("g", nd.zeros((4,)))
    kv.push("g", nd.ones((4,)))
    kv._store["_pending_g"]._data[1] = 5.0   # corrupted after the push
    before = telemetry.get("kvstore.checksum_failures")
    before = 0 if before is None else before.value
    with pytest.raises(kvstore.IntegrityError, match="checksum mismatch"):
        kv.pull("g", nd.zeros((4,)))
    assert telemetry.get("kvstore.checksum_failures").value == before + 1
    assert issubclass(kvstore.IntegrityError, MXNetError)
    # an untampered push/pull of a bfloat16 payload verifies its raw bytes
    kv.init("h", nd.zeros((3,), dtype="bfloat16"))
    kv.push("h", nd.array(np.array([1.5, -2.0, 0.25], np.float32),
                          dtype="bfloat16"))
    out = nd.zeros((3,), dtype="bfloat16")
    kv.pull("h", out)
    np.testing.assert_array_equal(out.asnumpy(), [1.5, -2.0, 0.25])


def test_a_pull_of_many_keys_checks_them_together():
    """One pull of a key list checks every key before it hands anything
    out; the first corrupted key is named."""
    kv = mx.kv.create("device")
    keys = ["a", "b", "c"]
    for k in keys:
        kv.init(k, nd.zeros((3,)))
    kv.push(keys, [nd.ones((3,)) * (i + 1) for i in range(3)])
    kv._store["_pending_b"]._data[0] = -1.0
    outs = [nd.zeros((3,)) for _ in keys]
    with pytest.raises(kvstore.IntegrityError, match="pull\\('b'\\)"):
        kv.pull(keys, outs)
    for o in outs:
        np.testing.assert_array_equal(o.asnumpy(), 0.0)
    kv.push(keys, [nd.ones((3,)) * (i + 1) for i in range(3)])
    kv.pull(keys, outs)
    for i, o in enumerate(outs):
        np.testing.assert_array_equal(o.asnumpy(), i + 1.0)


def test_a_pull_into_the_aggregate_itself_reads_nothing(monkeypatch):
    """A one-copy store's aggregate is the pushed array; pulled back into
    that same array nothing is handed out, so no checksum is read (the
    Trainer's step needs no host read), while a pull into another array
    is checked."""
    kv = mx.kv.create("device")
    kv.init(0, nd.zeros((3,)))
    g = nd.ones((3,))
    kv.push(0, g)
    reads = []
    real = kvstore._payload_checksum
    monkeypatch.setattr(kvstore, "_payload_checksum",
                        lambda a: reads.append(a) or real(a))
    kv.pull(0, g)
    assert reads == []
    np.testing.assert_array_equal(g.asnumpy(), 1.0)
    kv.push(0, g)
    assert len(reads) == 1                    # the push's own checksum
    out = nd.zeros((3,))
    kv.pull(0, out)
    assert len(reads) == 2
    np.testing.assert_array_equal(out.asnumpy(), 1.0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16, torch.float64, torch.int8,
                                   torch.int64, torch.bool])
def test_the_card_checksum_is_a_word_sum_that_sees_one_word(dtype):
    """The checksum a payload on the card gets, here on host tensors: a
    0-d int64 word sum that moves with any one element; the card's
    checksums are compared together."""
    t = (torch.arange(24) % 3).to(dtype).reshape(4, 6)
    s = kvstore._word_sum(t)
    assert s.dtype == torch.int64 and s.dim() == 0
    assert kvstore._word_sum(t.clone()) == s
    assert kvstore._word_sum(t.t()) == s          # a strided view too
    u = t.clone()
    u[1, 2] = (not bool(u[1, 2])) if dtype == torch.bool else u[1, 2] + 1
    assert kvstore._word_sum(u) != s
    assert kvstore._mismatches(
        [s, 7, None, s], [s, 8, kvstore._word_sum(u),
                          kvstore._word_sum(u)]) == [1, 3]


def test_trainer_reads_the_store_once_a_step():
    """The Trainer pushes every gradient in one call and pulls them in
    one, so the store checks all keys in one pass a step."""
    net = gluon.nn.Dense(3, in_units=4)
    net.initialize()
    tr = gluon.Trainer(net.collect_params(), "sgd", {"learning_rate": 0.1})
    calls = []
    for name in ("push", "pull"):
        real = getattr(tr._kvstore, name)

        def spy(key, *a, _real=real, _name=name, **kw):
            calls.append((_name, list(key)))
            return _real(key, *a, **kw)
        setattr(tr._kvstore, name, spy)
    x = nd.array(np.ones((2, 4), np.float32))
    for _ in range(2):
        with autograd.record():
            loss = net(x).sum()
        loss.backward()
        tr.step(2)
    assert calls == [("push", [0, 1]), ("pull", [0, 1])] * 2


@pytest.mark.parametrize("dump_optimizer", [False, True])
def test_optimizer_states_round_trip(tmp_path, dump_optimizer):
    rng = np.random.RandomState(1)
    w0 = rng.randn(5).astype(np.float32)

    def store(opt=True):
        kv = mx.kv.create("device")
        kv.init(0, nd.array(w0))
        if opt:
            kv.set_optimizer(optimizer.create("adam", learning_rate=0.01))
        return kv

    kv = store()
    for _ in range(2):
        kv.push(0, nd.array(rng.randn(5).astype(np.float32)))
    f = str(tmp_path / "kv.states")
    kv.save_optimizer_states(f, dump_optimizer=dump_optimizer)
    payload = pickle.loads(open(f, "rb").read())
    if dump_optimizer:
        assert payload["__tpumx_format__"] == "kvstore-states-v2"
        assert set(payload) == {"__tpumx_format__", "states", "optimizer"}
    mean, var = (payload["states"] if dump_optimizer else payload)[0]
    assert isinstance(mean, np.ndarray) and mean.shape == (5,)
    fresh = store(opt=not dump_optimizer)
    fresh.load_optimizer_states(f)
    assert fresh._optimizer is not None
    for a, b in zip(kv._updater.get_states()[0],
                    fresh._updater.get_states()[0]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kind", ["2bit", "int8", "fp8"])
def test_gradient_compression_round_trips_as_the_reference(kind):
    """The first call (a zero residual) and calls under a ``key`` (the
    residual carried) equal the reference's; without a key the residual
    is keyed by id() of the pushed array, as the reference keys it (a
    quirk: see ROADMAP C)."""
    rng = np.random.RandomState(2)
    gs = [rng.randn(64).astype(np.float32) for _ in range(3)]
    outs = []
    for F, comp in ((nd, GradientCompression(kind, threshold=0.5)),
                    (jnd, jmx.contrib.compression.GradientCompression(
                        kind, threshold=0.5))):
        got = [comp.compress_decompress(F.array(gs[0])).asnumpy()]
        got += [comp.compress_decompress(F.array(g), key="k").asnumpy()
                for g in gs]
        outs.append(got)
        assert comp.get_params() == {"type": kind, "threshold": 0.5}
    for a, b in zip(*outs):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
    raw = GradientCompression(kind).compress_decompress(torch.ones(3))
    assert isinstance(raw, torch.Tensor)
    with pytest.raises(ValueError, match="unsupported compression"):
        GradientCompression("1bit")


def test_push_with_compression_feeds_back_per_key():
    kv = mx.kv.create("device")
    kv.set_gradient_compression({"type": "2bit", "threshold": 0.5})
    kv.init(0, nd.zeros((4,)))
    kv.push(0, nd.array(np.array([0.3, -0.6, 0.9, 0.1], np.float32)))
    out = nd.zeros((4,))
    kv.pull(0, out)
    np.testing.assert_array_equal(out.asnumpy(), [0.0, -0.5, 0.5, 0.0])


def _dense_net(pkg):
    n = pkg.gluon.nn
    net = n.HybridSequential()
    net.add(n.Dense(16, activation="tanh", in_units=8),
            n.Dense(4, in_units=16))
    return net


def _trainer_run(pkg, kv_args, steps=3):
    rng = np.random.RandomState(9)
    weights = [(rng.randn(*s) * 0.3).astype(np.float32)
               for s in ((16, 8), (16,), (4, 16), (4,))]
    net = _dense_net(pkg)
    net.initialize()
    for p, w in zip(net.collect_params().values(), weights):
        p.set_data(pkg.nd.array(w))
    trainer = pkg.gluon.Trainer(net.collect_params(), "sgd",
                                {"learning_rate": 0.1, "momentum": 0.9},
                                **kv_args)
    x = pkg.nd.array(rng.randn(6, 8).astype(np.float32))
    y = pkg.nd.array(rng.randn(6, 4).astype(np.float32))
    losses = []
    for _ in range(steps):
        with pkg.autograd.record():
            loss = ((net(x) - y) ** 2).sum(axis=1)
        loss.backward()
        trainer.step(6)
        losses.append(float(loss.mean().asscalar()))
    return losses, [p.data().asnumpy()
                    for p in net.collect_params().values()]


KV_ARGS = {"none": {"kvstore": None},
           "device": {},
           "local": {"kvstore": "local"},
           "update_on_kvstore": {"kvstore": "device",
                                 "update_on_kvstore": True},
           "compression_2bit": {"compression_params": {"type": "2bit",
                                                       "threshold": 0.05}},
           "store_object": {"kvstore": "store"}}


@pytest.mark.parametrize("case", list(KV_ARGS))
def test_three_trainer_steps_with_each_kvstore_argument(case):
    def args(pkg):
        a = dict(KV_ARGS[case])
        if a.get("kvstore") == "store":
            a["kvstore"] = pkg.kv.create("device")
        return a
    got, got_w = _trainer_run(mx, args(mx))
    want, want_w = _trainer_run(jmx, args(jmx))
    np.testing.assert_allclose(got, want, rtol=1e-4)
    for g, w in zip(got_w, want_w):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5)
    if case != "compression_2bit":
        plain, plain_w = _trainer_run(mx, {"kvstore": None})
        assert got == plain
        for g, w in zip(got_w, plain_w):
            np.testing.assert_array_equal(g, w)
    else:
        assert got[-1] < got[0]


_DIST_WORKER = textwrap.dedent("""
    import json, os, sys
    import numpy as np
    import tpu_mx_torch as mx            # joins the gloo group
    import torch.distributed as dist
    from tpu_mx_torch import autograd, gluon, nd
    from tpu_mx_torch.parallel import integrity

    out = {"in_group": dist.is_initialized(),
           "backend": dist.get_backend(),
           "dist_init": mx.kvstore.dist_init()}
    with mx.cpu():
        kv = mx.kv.create("dist_sync")
        rank, world = kv.rank, kv.num_workers
        out.update(rank=rank, world=world)
        shapes = [(4, 3), (7,), (2, 2, 2)]
        for k, s in enumerate(shapes):
            kv.init(k, nd.ones(s))
            # the reference's known values: rank r pushes (r + 1) * ones
            kv.push(k, [nd.ones(s) * (rank + 1), nd.ones(s)])
        got = []
        for k, s in enumerate(shapes):
            o = nd.zeros(s)
            kv.pull(k, o)
            got.append(o.asnumpy().tolist())
        out["sums"] = got
        kv.barrier()
        # three Trainer steps over dist_sync: each rank has its own shard
        rng = np.random.RandomState(9)
        net = gluon.nn.Dense(4, in_units=8)
        net.initialize()
        for p, w in zip(net.collect_params().values(),
                        ((rng.randn(4, 8) * 0.3).astype(np.float32),
                         np.zeros(4, np.float32))):
            p.set_data(nd.array(w))
        tr = gluon.Trainer(net.collect_params(), "sgd",
                           {"learning_rate": 0.1}, kvstore="dist_sync")
        data = np.random.RandomState(100 + rank)
        fps = []
        for _ in range(3):
            x = nd.array(data.randn(6, 8).astype(np.float32))
            with autograd.record():
                loss = (net(x) ** 2).sum(axis=1)
            loss.backward()
            tr.step(6)
            fps.append(int(integrity.device_fingerprint(
                [p.data()._data for p in net.collect_params().values()])))
        out["fingerprints"] = fps
        os.environ["TPUMX_STRICT_KVSTORE"] = "1"
        try:
            kv.push(0, nd.ones((4, 3)))
            out["strict"] = "no raise"
        except mx.MXNetError as e:
            out["strict"] = str(e)[:40]
    with open(os.path.join(sys.argv[1], f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
""")


def test_two_process_dist_sync_over_gloo_through_the_launcher(tmp_path):
    worker = tmp_path / "worker.py"
    worker.write_text(_DIST_WORKER)
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("TPUMX_COORDINATOR", None)
    r = subprocess.run(
        [sys.executable, "-m", "tpu_mx_torch.tools.launch", "-n", "2",
         sys.executable, str(worker), str(tmp_path)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stderr[-4000:]
    import json
    res = [json.loads((tmp_path / f"rank{i}.json").read_text())
           for i in range(2)]
    for i, o in enumerate(res):
        assert o["in_group"] and o["backend"] == "gloo" and o["dist_init"]
        assert (o["rank"], o["world"]) == (i, 2)
        # rank 0 pushes 1+1, rank 1 pushes 2+1: the sum is 5 everywhere
        for s in o["sums"]:
            assert np.all(np.asarray(s) == 5.0)
        assert o["strict"].startswith("eager dist KVStore push")
    assert res[0]["fingerprints"] == res[1]["fingerprints"]
    assert len(set(res[0]["fingerprints"])) == 3     # the weights moved
