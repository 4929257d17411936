"""The port's ``mx.monitor`` and ``mx.viz`` against the reference's, on the
CPU: each test of ``tests/test_monitor.py`` and the monitor cases of
``tests/test_aux.py``, with the reference's Gluon net beside the port's
on the same weights, and ``print_summary``/``plot_network``
(``tests/test_symbol.py``'s case, which ``test_torch_symbol.py`` leaves
to this file) over both packages' ``mx.sym``.

Tolerances: the recorded names, batches and the printed tables are
equal; each statistic within 1e-6 relative (the same float32 layers'
outputs, reduced on the host in numpy).
"""
import numpy as np
import pytest
import torch

import tpu_mx as jmx
from tpu_mx.monitor import Monitor as JMonitor

import tpu_mx_torch as mx
from tpu_mx_torch import nd
from tpu_mx_torch.gluon import nn
from tpu_mx_torch.gluon.block import load_numpy
from tpu_mx_torch.monitor import Monitor


@pytest.fixture(autouse=True)
def _host():
    with mx.cpu():
        yield


def _nets(hybrid=True, act=True):
    """The reference's two-Dense net and the port's, one weight set."""
    nets = []
    for m in (jmx, mx):
        net = m.gluon.nn.HybridSequential() if hybrid \
            else m.gluon.nn.Sequential()
        net.add(m.gluon.nn.Dense(8, in_units=4,
                                 activation="relu" if act else None),
                m.gluon.nn.Dense(2, in_units=8))
        net.initialize()
        nets.append(net)
    load_numpy(nets[1], {k: p.data().asnumpy()
                         for k, p in nets[0].collect_params().items()})
    return nets


X = np.random.RandomState(0).rand(2, 4).astype(np.float32)


def _both(run, **monitor_kw):
    """``run(m, net, monitor)`` for each package; the monitors' results."""
    out = []
    for m, net, cls in zip((jmx, mx), _nets(), (JMonitor, Monitor)):
        mon = cls(**monitor_kw).install(net)
        out.append(run(m, net, mon))
    return out


def _one_batch(m, net, mon):
    mon.tic()
    net(m.nd.array(X))
    return mon.toc()


def _same(ref, got):
    assert [(s, n) for s, n, _ in got] == [(s, n) for s, n, _ in ref]
    np.testing.assert_allclose([v for *_, v in got], [v for *_, v in ref],
                               rtol=1e-6)


def test_monitor_collects_layer_stats():
    ref, got = _both(_one_batch, interval=1)
    _same(ref, got)
    names = {n for _, n, _ in got}
    assert {"hybridsequential", "hybridsequential.0",
            "hybridsequential.1"} <= names
    assert all(step == 1 and isinstance(v, float) and v >= 0
               for step, _, v in got)


def test_monitor_default_stat_is_mean_abs():
    net = _nets()[1]
    mon = Monitor(interval=1, pattern="hybridsequential$").install(net)
    mon.tic()
    out = net(nd.array(X))
    res = mon.toc()
    assert len(res) == 1
    assert res[0][2] == pytest.approx(float(np.abs(out.asnumpy()).mean()),
                                      rel=1e-6)


def test_monitor_interval_gating():
    def run(m, net, mon):
        seen = []
        for _ in range(4):
            mon.tic()
            net(m.nd.array(X))
            seen.append(bool(mon.toc()))
        return seen
    ref, got = _both(run, interval=2)
    assert got == ref == [True, False, True, False]


@pytest.mark.parametrize("kw", [{"pattern": r".*\.0$"},
                                {"sort": True},
                                {"pattern": "nomatch_.*"},
                                {"stat_func": lambda a: float(a.max()),
                                 "pattern": "hybridsequential$"}],
                         ids=["pattern", "sort", "nomatch", "stat_func"])
def test_monitor_options_match_the_reference(kw):
    ref, got = _both(_one_batch, interval=1, **kw)
    _same(ref, got)
    if "sort" in kw:
        assert [n for _, n, _ in got] == sorted(n for _, n, _ in got)
    if kw.get("pattern") == "nomatch_.*":
        assert got == []


def test_monitor_uninstall_detaches_every_hook():
    net = _nets()[1]
    mon = Monitor(interval=1).install(net)
    mon.install(net)      # a second install: duplicated hooks until removed
    mon.tic()
    net(nd.array(X))
    assert len(mon.toc()) == 8     # root, two Dense, the act: twice
    mon.uninstall()
    assert mon._handles == []
    assert not [h for blk in net.modules() for h in
                getattr(blk, "_fwd_hooks", ())]
    mon.tic()
    net(nd.array(X))
    assert mon.toc() == []


def test_monitor_toc_without_tic_is_empty():
    mon = Monitor(interval=1).install(_nets()[1])
    assert mon.toc() == []


def test_toc_print_matches_the_reference(capsys):
    printed = []
    for m, net, cls in zip((jmx, mx), _nets(), (JMonitor, Monitor)):
        mon = cls(interval=1, pattern="hybridsequential$").install(net)
        mon.tic()
        net(m.nd.array(X))
        mon.toc_print()
        printed.append(capsys.readouterr().out)
    assert "hybridsequential" in printed[1] and "Batch" in printed[1]
    ref_val = float(printed[0].split()[-1])
    got_val = float(printed[1].split()[-1])
    assert printed[1].rsplit(" ", 1)[0] == printed[0].rsplit(" ", 1)[0]
    assert got_val == pytest.approx(ref_val, rel=1e-6)


def test_monitor_records_an_imperative_sequential_and_a_bfloat16_net():
    """The aux case (a ``Sequential``, interval 2) and a net cast to
    bfloat16: tensor outputs inside a forward are read back as float."""
    net = _nets(hybrid=False)[1]
    mon = Monitor(interval=2, pattern=".*").install(net)
    seen = []
    for _ in range(4):
        mon.tic()
        net(nd.array(X))
        seen.append(mon.toc())
    assert seen[0] and seen[2] and seen[1] == [] and seen[3] == []
    net.cast("bfloat16")
    mon.tic()
    mon.tic()
    net(nd.array(X).astype("bfloat16"))
    res = mon.toc()
    assert res and all(np.isfinite(v) for *_, v in res)
    mon.uninstall()


def _summary_sym(m):
    data = m.sym.Variable("data")
    fc1 = m.sym.FullyConnected(data, num_hidden=16, name="fc1")
    act = m.sym.Activation(fc1, act_type="relu", name="relu1")
    fc2 = m.sym.FullyConnected(act, num_hidden=4, name="fc2")
    return m.sym.softmax(fc2, name="softmax")


def _conv_sym(m):
    data = m.sym.Variable("data")
    c = m.sym.Convolution(data, kernel=(3, 3), num_filter=8, name="conv")
    b = m.sym.BatchNorm(c, name="bn")
    p = m.sym.Pooling(b, global_pool=True, kernel=(1, 1), pool_type="avg",
                      name="gap")
    return m.sym.FullyConnected(m.sym.Flatten(p, name="fl"), num_hidden=3,
                                name="head")


@pytest.mark.parametrize("build,shape", [
    (_summary_sym, {"data": (2, 8)}), (_conv_sym, {"data": (2, 3, 9, 9)}),
    (_summary_sym, None)], ids=["mlp", "conv_bn", "no_shape"])
def test_print_summary_matches_the_reference(capsys, build, shape):
    out = []
    for m in (jmx, mx):
        total = m.viz.print_summary(build(m), shape=shape)
        out.append((total, capsys.readouterr().out))
    assert out[1] == out[0]
    if build is _summary_sym and shape:
        assert out[1][0] == 16 * 8 + 16 + 4 * 16 + 4
        assert f"Total params: {out[1][0]}" in out[1][1]
    assert mx.visualization.print_summary is mx.viz.print_summary


def test_plot_network_without_graphviz_raises_as_the_reference(monkeypatch):
    import sys
    monkeypatch.setitem(sys.modules, "graphviz", None)   # not installed
    for m in (jmx, mx):
        with pytest.raises(m.MXNetError, match="print_summary"):
            m.viz.plot_network(_summary_sym(m))


def test_plot_network_draws_the_graph_with_a_graphviz_module(monkeypatch):
    """With a ``graphviz`` module present, a box per node and an edge per
    input, as the reference draws (a stand-in module records them)."""
    import sys
    import types
    drawn = {"nodes": [], "edges": []}

    class Digraph:
        def __init__(self, name, format):
            self.name, self.format = name, format

        def node(self, name, label, **attrs):
            drawn["nodes"].append((name, label))

        def edge(self, a, b):
            drawn["edges"].append((a, b))
    monkeypatch.setitem(sys.modules, "graphviz",
                        types.SimpleNamespace(Digraph=Digraph))
    got = {}
    for m in (jmx, mx):
        drawn["nodes"], drawn["edges"] = [], []
        dot = m.viz.plot_network(_summary_sym(m), title="t",
                                 save_format="png")
        got[m.__name__] = (dot.name, dot.format, list(drawn["nodes"]),
                           list(drawn["edges"]))
    assert got["tpu_mx_torch"] == got["tpu_mx"]
    assert ("fc1", "fc1\nFullyConnected") in got["tpu_mx_torch"][2]
    assert ("fc1", "relu1") in got["tpu_mx_torch"][3]


def test_monitor_on_a_tensor_forward_of_a_model():
    """A port block called with tensors (the models' own path) is
    monitored too: every layer's output is a tensor."""
    net = nn.HybridSequential()
    net.add(nn.Dense(3, in_units=4, generator=torch.Generator()),
            nn.Activation("tanh"))
    mon = Monitor(interval=1).install(net)
    mon.tic()
    y = net(torch.ones(2, 4))
    res = mon.toc()
    assert [n for _, n, _ in res] == ["hybridsequential.0",
                                      "hybridsequential.1",
                                      "hybridsequential"]
    assert res[-1][2] == pytest.approx(float(y.abs().mean()), rel=1e-6)
