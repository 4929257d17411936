"""``Trainer.save_states``/``load_states`` in the reference's file format,
on the CPU.

Each package reads the other's file: a trainer takes one step, saves its
states, takes a second step; a fresh trainer of the other package over
the step-1 weights loads the file and takes the same second step.  The
two second steps agree to ``RTOL`` (the float32 masters of a
multi-precision run too; its bfloat16 weights to one bfloat16 step) for
SGD with momentum, Adam and LAMB with bfloat16 multi-precision, and for
Signum on bfloat16 weights, whose momentum is itself bfloat16.  The
port's read of a reference file with a bfloat16 state, and its write of
one, run in a subprocess where ``ml_dtypes`` cannot be imported.
"""
import inspect
import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import tpu_mx as jmx

import tpu_mx_torch as mx

RTOL = 1e-6
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

OPTIMIZERS = {
    "sgd_momentum": ("sgd", {"learning_rate": 0.1, "momentum": 0.9,
                             "wd": 1e-3}, "float32"),
    "adam": ("adam", {"learning_rate": 0.01, "wd": 1e-3}, "float32"),
    "lamb_bf16_multi_precision": ("lamb", {"learning_rate": 0.01,
                                           "multi_precision": True},
                                  "bfloat16"),
    "signum_bf16_state": ("signum", {"learning_rate": 0.01,
                                     "momentum": 0.9}, "bfloat16"),
}


@pytest.fixture(autouse=True)
def _host():
    with mx.cpu():
        yield


def _weights(seed=3):
    rng = np.random.RandomState(seed)
    # multiples of 1/64: exact in bfloat16
    return [np.round(rng.randn(*s) * 0.3 * 64) / 64
            for s in ((6, 5), (3, 6))]


def _data():
    rng = np.random.RandomState(4)
    return rng.randn(4, 5).astype(np.float32), \
        rng.randn(4, 3).astype(np.float32)


def _net(pkg, dtype, weights):
    n = pkg.gluon.nn
    net = n.HybridSequential()
    net.add(n.Dense(6, in_units=5, use_bias=False),
            n.Dense(3, in_units=6, use_bias=False))
    net.initialize()
    for p, w in zip(net.collect_params().values(), weights):
        p.set_data(pkg.nd.array(np.asarray(w, np.float32)))
    if dtype != "float32":
        net.cast(dtype)
    return net


def _step(pkg, net, trainer, dtype):
    x, w = _data()
    with pkg.autograd.record():
        out = net(pkg.nd.array(x).astype(dtype)).astype("float32")
        loss = (out * pkg.nd.array(w)).sum(axis=1)
    loss.backward()
    trainer.step(4)


def _params(net):
    return [p.data().astype("float32").asnumpy()
            for p in net.collect_params().values()]


def _masters(trainer):
    out = []
    for s in trainer._states:
        if isinstance(s, tuple) and not isinstance(s[0], tuple) \
                and s[0] is not None and len(s) == 2 \
                and getattr(s[0], "ndim", 0) == 2:
            out.append(np.asarray(s[0] if not torch.is_tensor(s[0])
                                  else s[0].float().numpy(), np.float32))
    return out


def _two_steps(pkg, case, tmp_path, tag):
    name, params, dtype = OPTIMIZERS[case]
    net = _net(pkg, dtype, _weights())
    trainer = pkg.gluon.Trainer(net.collect_params(), name, dict(params))
    _step(pkg, net, trainer, dtype)
    path = str(tmp_path / f"{tag}.states")
    trainer.save_states(path)
    w1 = _params(net)
    _step(pkg, net, trainer, dtype)
    return path, w1, _params(net), trainer


def _resume(pkg, case, path, w1):
    name, params, dtype = OPTIMIZERS[case]
    net = _net(pkg, dtype, w1)
    trainer = pkg.gluon.Trainer(net.collect_params(), name, dict(params))
    trainer.load_states(path)
    _step(pkg, net, trainer, dtype)
    return _params(net), trainer


def _agree(got, want, dtype):
    for g, w in zip(got, want):
        if dtype == "bfloat16":
            np.testing.assert_allclose(g, w, rtol=2 ** -7,
                                       atol=2 ** -7 * np.abs(w).max())
        else:
            np.testing.assert_allclose(g, w, rtol=RTOL,
                                       atol=RTOL * np.abs(w).max())


@pytest.mark.parametrize("case", list(OPTIMIZERS))
def test_each_package_resumes_from_the_others_states(case, tmp_path):
    dtype = OPTIMIZERS[case][2]
    ref_path, ref_w1, ref_w2, ref_tr = _two_steps(jmx, case, tmp_path, "ref")
    port_path, port_w1, port_w2, port_tr = _two_steps(mx, case, tmp_path,
                                                      "port")
    got, tr = _resume(mx, case, ref_path, ref_w1)
    _agree(got, ref_w2, dtype)
    for g, w in zip(_masters(tr), _masters(ref_tr)):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=RTOL * abs(w).max())
    assert tr.optimizer.num_update == ref_tr.optimizer.num_update == 2
    got, tr = _resume(jmx, case, port_path, port_w1)
    _agree(got, port_w2, dtype)
    for g, w in zip(_masters(tr), _masters(port_tr)):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=RTOL * abs(w).max())


def test_the_file_is_the_references_pickle(tmp_path):
    _, _, _, tr = _two_steps(mx, "lamb_bf16_multi_precision", tmp_path, "p")
    with open(tmp_path / "p.states", "rb") as f:
        payload = pickle.load(f)          # ml_dtypes is importable here
    assert set(payload) == {"states", "states_inited", "num_update",
                            "index_update_count"}
    master, (mean, var) = payload["states"][0]
    assert master.dtype == np.float32 and mean.shape == (6, 5)
    assert payload["index_update_count"] == {0: 1, 1: 1}


def test_bfloat16_states_cross_without_ml_dtypes(tmp_path):
    case = "signum_bf16_state"
    ref_path, ref_w1, ref_w2, _ = _two_steps(jmx, case, tmp_path, "ref")
    with open(ref_path, "rb") as f:
        assert b"ml_dtypes" in f.read()
    out = str(tmp_path / "port.states")
    # the helpers' source, run in a process with no jax and no ml_dtypes
    helpers = "".join(inspect.getsource(f) for f in (_data, _net, _step,
                                                    _params, _resume))
    script = textwrap.dedent(f"""
        import sys
        sys.modules["ml_dtypes"] = None
        sys.path.insert(0, {ROOT!r})
        import numpy as np, torch
        import tpu_mx_torch as mx
        OPTIMIZERS = {OPTIMIZERS!r}
    """) + helpers + textwrap.dedent(f"""
        w1 = [np.asarray(w, np.float32) for w in {[w.tolist()
                                                   for w in ref_w1]!r}]
        with mx.cpu():
            got, tr = _resume(mx, {case!r}, {ref_path!r}, w1)
            assert tr._states[0].dtype == torch.bfloat16
            tr.save_states({out!r})
        np.save({str(tmp_path / "got.npy")!r}, got[0])
        assert "jax" not in sys.modules and "ml_dtypes" not in [
            m for m in sys.modules if sys.modules[m] is not None]
    """)
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    subprocess.run([sys.executable, "-c", script], check=True, env=env,
                   cwd=str(tmp_path), timeout=300)
    _agree([np.load(tmp_path / "got.npy")], ref_w2[:1], "bfloat16")
    # the reference reads the port's bfloat16 state as its own type
    net = _net(jmx, "bfloat16", ref_w2)
    trainer = jmx.gluon.Trainer(net.collect_params(), "signum",
                                dict(OPTIMIZERS[case][1]))
    trainer.load_states(out)
    assert str(trainer._states[0].dtype) == "bfloat16"
