"""The port's ``mx.sym`` and its executors against the reference's, on the
CPU: each test of ``tests/test_symbol.py`` with the reference beside it
on the same seeded inputs (``print_summary``/``plot_network`` are held
in ``tests/test_torch_monitor_viz.py``, ``util.np_scope`` in
``tests/test_torch_runtime_utils.py``), and the symbol JSON of each
package loaded by the other.

Tolerances: listings, shapes, JSON and attributes are equal; outputs
and gradients of the same float32 graph on the same weights within
1e-5 relative (the operators' sums in PyTorch's order against XLA's).
"""
import json

import numpy as np
import pytest

import tpu_mx as jmx

import tpu_mx_torch as mx
from tpu_mx_torch import gluon

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def _host():
    with mx.cpu():
        yield


def _mlp(m):
    data = m.sym.Variable("data")
    fc1 = m.sym.FullyConnected(data, num_hidden=16, name="fc1")
    act = m.sym.Activation(fc1, act_type="relu", name="relu1")
    fc2 = m.sym.FullyConnected(act, num_hidden=4, name="fc2")
    return m.sym.SoftmaxOutput(fc2, m.sym.Variable("softmax_label"),
                               name="softmax")


def _conv_bn(m):
    d = m.sym.var("data")
    c = m.sym.Convolution(d, kernel=(3, 3), num_filter=8, pad=(1, 1),
                          name="conv0")
    b = m.sym.BatchNorm(c, name="bn0")
    return b, m.sym.FullyConnected(m.sym.flatten(b, name="flat"),
                                   num_hidden=10, name="fc")


def _feed(ex, values):
    for k, v in values.items():
        ex.arg_dict[k][:] = v


def _mlp_values(seed, batch=8):
    rng = np.random.RandomState(seed)
    return {"data": rng.randn(batch, 20).astype("float32"),
            "fc1_weight": rng.randn(16, 20).astype("float32") * 0.1,
            "fc1_bias": rng.randn(16).astype("float32") * 0.1,
            "fc2_weight": rng.randn(4, 16).astype("float32") * 0.1,
            "fc2_bias": rng.randn(4).astype("float32") * 0.1,
            "softmax_label": rng.randint(0, 4, (batch,)).astype("float32")}


def test_compose_and_listing():
    out, ref = _mlp(mx), _mlp(jmx)
    assert out.list_arguments() == ref.list_arguments() == [
        "data", "fc1_weight", "fc1_bias", "fc2_weight", "fc2_bias",
        "softmax_label"]
    assert out.list_outputs() == ref.list_outputs() == ["softmax_output"]
    assert out.list_auxiliary_states() == ref.list_auxiliary_states() == []
    assert out.list_inputs() == ref.list_inputs()
    assert out.name == ref.name == "softmax"


def test_infer_shape():
    got = _mlp(mx).infer_shape(data=(8, 20), softmax_label=(8,))
    assert got == _mlp(jmx).infer_shape(data=(8, 20), softmax_label=(8,))
    assert got[0] == [(8, 20), (16, 20), (16,), (4, 16), (4,), (8,)]
    assert got[1] == [(8, 4)] and got[2] == []
    assert _mlp(mx).infer_type(data=np.float32) == \
        _mlp(jmx).infer_type(data=np.float32)


def test_infer_shape_conv_bn_and_partial():
    (b, f), (jb, jf) = _conv_bn(mx), _conv_bn(jmx)
    assert b.list_auxiliary_states() == jb.list_auxiliary_states() == \
        ["bn0_moving_mean", "bn0_moving_var"]
    got = f.infer_shape(data=(4, 3, 28, 28))
    assert got == jf.infer_shape(data=(4, 3, 28, 28))
    assert got[0][1] == (8, 3, 3, 3) and got[2] == [(8,), (8,)]
    assert got[1] == [(4, 10)]
    assert f.infer_shape_partial() == jf.infer_shape_partial()
    with pytest.raises(mx.MXNetError, match="missing shapes"):
        f.infer_shape()
    with pytest.raises(jmx.MXNetError, match="missing shapes"):
        jf.infer_shape()


def test_variable_shape_attr():
    for m in (mx, jmx):
        d = m.sym.var("data", shape=(2, 5), dtype="float32", lr_mult=2)
        y = m.sym.FullyConnected(d, num_hidden=3, name="fc")
        assert y.infer_shape()[1] == [(2, 3)]
        assert d.attr("__lr_mult__") == "2"
        assert d.list_attr() == {"__shape__": "(2, 5)",
                                 "__dtype__": "float32", "__lr_mult__": "2"}


def _run_mlp(m, grad_req="write", seed=0):
    out = _mlp(m)
    ex = out.simple_bind(m.cpu(), grad_req=grad_req, data=(8, 20),
                         softmax_label=(8,))
    _feed(ex, _mlp_values(seed))
    (y,) = ex.forward(is_train=True)
    ex.backward()
    return ex, y


def test_executor_forward_backward():
    ex, y = _run_mlp(mx)
    jex, jy = _run_mlp(jmx)
    np.testing.assert_allclose(y.asnumpy(), jy.asnumpy(), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(y.asnumpy().sum(axis=1), np.ones(8),
                               rtol=RTOL)
    assert sorted(ex.grad_dict) == sorted(jex.grad_dict)
    for n in ex.grad_dict:
        np.testing.assert_allclose(ex.grad_dict[n].asnumpy(),
                                   jex.grad_dict[n].asnumpy(), rtol=RTOL,
                                   atol=ATOL, err_msg=n)
    p = y.asnumpy()
    oh = np.eye(4)[ex.arg_dict["softmax_label"].asnumpy().astype(int)]
    np.testing.assert_allclose(ex.grad_dict["fc2_bias"].asnumpy(),
                               (p - oh).sum(axis=0), rtol=1e-4, atol=1e-5)
    assert all(a is ex.arg_dict[n] for a, n in
               zip(ex.arg_arrays, ex._symbol.list_arguments()))
    assert len(ex.grad_arrays) == len(jex.grad_arrays) == 6


def test_grad_req_add_and_null():
    grads = {}
    for m in (mx, jmx):
        out = _mlp(m)
        req = {n: "write" for n in out.list_arguments()}
        req["data"] = "null"
        req["fc1_weight"] = "add"
        ex = out.simple_bind(m.cpu(), grad_req=req, data=(8, 20),
                             softmax_label=(8,))
        _feed(ex, _mlp_values(1))
        ex.forward(is_train=True)
        ex.backward()
        g1 = ex.grad_dict["fc1_weight"].asnumpy().copy()
        w1 = ex.grad_dict["fc2_weight"].asnumpy().copy()
        ex.forward(is_train=True)
        ex.backward()
        np.testing.assert_allclose(ex.grad_dict["fc1_weight"].asnumpy(),
                                   2 * g1, rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(ex.grad_dict["fc2_weight"].asnumpy(), w1,
                                   rtol=1e-6)
        assert "data" not in ex.grad_dict
        grads[m] = ex.grad_dict["fc1_weight"].asnumpy()
    np.testing.assert_allclose(grads[mx], grads[jmx], rtol=RTOL, atol=ATOL)
    with pytest.raises(mx.MXNetError, match="before forward"):
        _mlp(mx).simple_bind(mx.cpu(), data=(2, 20),
                             softmax_label=(2,)).backward()


def test_backward_after_a_prediction_and_head_gradients():
    for m in (mx, jmx):
        a = m.sym.var("a")
        y = m.sym.Group([a * a, a * 3.0])
        ex = y.simple_bind(m.cpu(), a=(3,))
        ex.arg_dict["a"][:] = np.array([1.0, 2.0, -1.0], "float32")
        ex.forward(is_train=False)
        ex.backward(out_grads=[m.nd.array(np.array([1, 0, 2], "float32")),
                               m.nd.array(np.array([1, 1, 1], "float32"))])
        np.testing.assert_allclose(ex.grad_dict["a"].asnumpy(),
                                   [5.0, 3.0, -1.0], rtol=1e-6)


def test_operator_overloading():
    outs = {}
    for m in (mx, jmx):
        a, b = m.sym.var("a"), m.sym.var("b")
        c = (a + b) * 2.0 - a / 2.0 + (3.0 - b) + 1.0 / (a + 1.0) \
            + (a ** 2.0) * (-b) + (a == b)
        ex = c.simple_bind(m.cpu(), a=(3,), b=(3,))
        ex.arg_dict["a"][:] = np.array([1.0, 2.0, 3.0], "float32")
        ex.arg_dict["b"][:] = np.array([4.0, 2.0, 6.0], "float32")
        outs[m] = ex.forward()[0].asnumpy()
    np.testing.assert_allclose(outs[mx], outs[jmx], rtol=1e-6)
    assert (mx.sym.var("a") + 1.0).list_outputs()[0].startswith(
        "plus_scalar")


def test_group_and_getitem():
    for m in (mx, jmx):
        a = m.sym.var("a")
        g = m.sym.Group([a * 2.0, a + 1.0])
        assert len(g.list_outputs()) == 2 and len(g) == 2
        assert g.name == "group"
        ex = g.simple_bind(m.cpu(), a=(2,))
        ex.arg_dict["a"][:] = np.array([1.0, 2.0], "float32")
        y1, y2 = ex.forward()
        np.testing.assert_allclose(y1.asnumpy(), [2.0, 4.0])
        np.testing.assert_allclose(y2.asnumpy(), [2.0, 3.0])
        assert [s.name for s in g] == [s.name for s in g]
        with pytest.raises(m.MXNetError, match="no node"):
            g["nothing"]


def test_multi_output_split():
    outs = {}
    for m in (mx, jmx):
        a = m.sym.var("a")
        parts = m.sym.split(a, num_outputs=2, axis=1, name="sp")
        assert parts.list_outputs() == ["sp_output0", "sp_output1"]
        ex = parts[1].simple_bind(m.cpu(), a=(2, 4))
        ex.arg_dict["a"][:] = np.arange(8).reshape(2, 4).astype("float32")
        outs[m] = ex.forward()[0].asnumpy()
        sc = m.sym.SliceChannel(a, num_outputs=4, axis=1, name="sc")
        assert len(sc) == 4
    np.testing.assert_array_equal(outs[mx], [[2, 3], [6, 7]])
    np.testing.assert_array_equal(outs[mx], outs[jmx])


def test_json_roundtrip(tmp_path):
    out = _mlp(mx)
    path = str(tmp_path / "sym.json")
    out.save(path)
    loaded = mx.sym.load(path)
    assert loaded.list_arguments() == out.list_arguments()
    assert loaded.list_outputs() == out.list_outputs()
    ex = loaded.simple_bind(mx.cpu(), data=(4, 20), softmax_label=(4,))
    assert ex.forward()[0].shape == (4, 4)
    # the same graph, named the same, is the same JSON in both packages
    assert out.tojson() == _mlp(jmx).tojson()
    (_, f), (_, jf) = _conv_bn(mx), _conv_bn(jmx)
    assert f.tojson() == jf.tojson()


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_json_crosses_between_the_packages(tmp_path, writer):
    """A symbol saved by either package loads in the other and computes
    the same outputs and gradients."""
    src, dst = (mx, jmx) if writer == "port" else (jmx, mx)
    (_, f) = _conv_bn(src)
    s = src.sym.Group([f, src.sym.split(src.sym.var("x"), num_outputs=2,
                                        axis=1, name="sp")[0] * 2.0])
    path = str(tmp_path / "cross.json")
    s.save(path)
    loaded = dst.sym.load(path)
    assert loaded.list_arguments() == s.list_arguments()
    assert loaded.list_auxiliary_states() == s.list_auxiliary_states()
    assert loaded.list_outputs() == s.list_outputs()
    assert loaded.tojson() == s.tojson()
    rng = np.random.RandomState(2)
    shapes = dict(data=(2, 3, 6, 6), x=(2, 4))
    arg_shapes, _, aux_shapes = s.infer_shape(**shapes)
    args = {n: rng.randn(*sh).astype("float32") * 0.2
            for n, sh in zip(s.list_arguments(), arg_shapes)}
    auxs = {n: rng.rand(*sh).astype("float32") + 0.5
            for n, sh in zip(s.list_auxiliary_states(), aux_shapes)}
    outs, grads = {}, {}
    for m, sym in ((src, s), (dst, loaded)):
        ex = sym.bind(m.cpu(), args={k: m.nd.array(v) for k, v in
                                     args.items()},
                      aux_states={k: m.nd.array(v) for k, v in auxs.items()})
        outs[m] = [o.asnumpy() for o in ex.forward(is_train=True)]
        ex.backward()
        grads[m] = {n: g.asnumpy() for n, g in ex.grad_dict.items()}
    for a, b in zip(outs[mx], outs[jmx]):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)
    # conv0_bias feeds a training BatchNorm, which cancels it: its true
    # gradient is 0 and both packages give float32 noise of ~1e-5 there
    for n in grads[mx]:
        np.testing.assert_allclose(grads[mx][n], grads[jmx][n], rtol=1e-4,
                                   atol=1e-4 if n == "conv0_bias" else 1e-5,
                                   err_msg=n)


def test_batchnorm_aux_states_stay_as_bound():
    """Neither package's executor updates a moving statistic: training
    forwards normalize by the batch, predictions by aux_dict, and aux_dict
    is left as it was."""
    rng = np.random.RandomState(3)
    x = rng.randn(4, 3, 5, 5).astype("float32")
    mean = rng.randn(8).astype("float32")
    var = rng.rand(8).astype("float32") + 0.5
    res = {}
    for m in (mx, jmx):
        b, _ = _conv_bn(m)
        ex = b.simple_bind(m.cpu(), data=x.shape)
        ex.arg_dict["data"][:] = x
        ex.arg_dict["conv0_weight"][:] = rng.randn(8, 3, 3, 3).astype(
            "float32") * 0.1 if m is mx else res["w"]
        res["w"] = ex.arg_dict["conv0_weight"].asnumpy()
        ex.arg_dict["bn0_gamma"][:] = 1.0
        ex.aux_dict["bn0_moving_mean"][:] = mean
        ex.aux_dict["bn0_moving_var"][:] = var
        train = ex.forward(is_train=True)[0].asnumpy()
        pred = ex.forward(is_train=False)[0].asnumpy()
        np.testing.assert_array_equal(ex.aux_dict["bn0_moving_mean"]
                                      .asnumpy(), mean)
        np.testing.assert_array_equal(ex.aux_dict["bn0_moving_var"]
                                      .asnumpy(), var)
        assert len(ex.aux_arrays) == 2
        res[m] = (train, pred)
    for a, b in zip(res[mx], res[jmx]):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)


def test_eval():
    for m in (mx, jmx):
        a = m.sym.var("a")
        (out,) = (a * 3.0).eval(a=m.nd.array([1.0, 2.0]))
        np.testing.assert_allclose(out.asnumpy(), [3.0, 6.0])


def test_get_internals():
    for m in (mx, jmx):
        internals = _mlp(m).get_internals()
        assert "fc1_output" in internals.list_outputs()
        ex = internals["fc1"].simple_bind(m.cpu(), data=(2, 20))
        assert ex.forward()[0].shape == (2, 16)
    assert _mlp(mx).get_internals().list_outputs() == \
        _mlp(jmx).get_internals().list_outputs()
    assert _mlp(mx).get_output(0).name == "softmax"


def test_attrs():
    for m in (mx, jmx):
        a = m.sym.var("a", shape=(2, 2))
        y = m.sym.FullyConnected(a, num_hidden=2, name="fc",
                                 attr={"__ctx_group__": "dev1"})
        assert y.attr("__ctx_group__") == "dev1"
        assert "fc" in y.attr_dict()
        assert y.list_attr() == {"__ctx_group__": "dev1"}


def test_regression_outputs():
    rng = np.random.RandomState(2)
    x = rng.randn(4, 3).astype("float32")
    t = rng.randn(4, 3).astype("float32")
    for m in (mx, jmx):
        out = m.sym.LinearRegressionOutput(m.sym.var("data"),
                                           m.sym.var("label"), name="lro")
        ex = out.simple_bind(m.cpu(), data=(4, 3), label=(4, 3))
        ex.arg_dict["data"][:] = x
        ex.arg_dict["label"][:] = t
        np.testing.assert_allclose(ex.forward(is_train=True)[0].asnumpy(), x,
                                   rtol=1e-6)
        ex.backward()
        np.testing.assert_allclose(ex.grad_dict["data"].asnumpy(),
                                   (x - t) / 4, rtol=1e-5, atol=1e-6)


def test_attr_scope_and_name_prefix():
    for m in (mx, jmx):
        with m.AttrScope(ctx_group="dev1", lr_mult="0.1"):
            a = m.sym.Variable("a")
            fc = m.sym.FullyConnected(a, num_hidden=4)
        assert fc.attr("ctx_group") == "dev1"
        assert fc.attr("lr_mult") == "0.1"
        assert a.attr("ctx_group") == "dev1"
        wname = [k for k in fc.list_arguments() if k.endswith("_weight")][0]
        assert fc.attr_dict().get(wname, {}).get("ctx_group") == "dev1"
        with m.AttrScope(ctx_group="dev1"):
            with m.AttrScope(ctx_group="dev2"):
                fc2 = m.sym.FullyConnected(m.sym.Variable("b"), num_hidden=2)
        assert fc2.attr("ctx_group") == "dev2"
        assert m.sym.FullyConnected(m.sym.Variable("c"),
                                    num_hidden=2).attr("ctx_group") is None
        with m.name.Prefix("stage1_"):
            s = m.sym.Activation(m.sym.Variable("x"), act_type="relu")
            named = m.sym.Activation(m.sym.Variable("y"), act_type="relu",
                                     name="mine")
        assert s.name.startswith("stage1_activation")
        assert named.name == "stage1_mine"
        with m.name.NameManager():
            assert m.sym.Activation(m.sym.var("z"),
                                    act_type="relu").name == "activation0"
    from tpu_mx_torch import attribute
    with mx.AttrScope(k="v"):
        assert attribute.current_attrs() == {"k": "v"}
    assert attribute.current_attrs() == {}


@pytest.mark.parametrize("op,kwargs,shape", [
    ("mish", {}, (3, 4)),
    ("log_sigmoid", {}, (3, 4)),
    ("hard_swish", {}, (3, 4)),
    ("LRN", {"nsize": 3}, (1, 4, 3, 3)),
    ("im2col", {"kernel": (2, 2)}, (1, 2, 4, 4)),
    ("Flatten", {}, (2, 3, 4)),
    ("Cast", {"dtype": "float16"}, (2, 3)),
    ("Reshape", {"shape": (6, -1)}, (2, 3, 4)),
])
def test_new_ops_nd_sym_parity(op, kwargs, shape):
    """A stub computes what its operator does imperatively, in both
    packages, and the two packages agree."""
    x = np.random.RandomState(0).rand(*shape).astype(np.float32)
    outs = []
    for m in (mx, jmx):
        nd_name = {"Flatten": "flatten", "Cast": "cast",
                   "Reshape": "reshape"}.get(op, op)
        nd_out = getattr(m.nd, nd_name)(m.nd.array(x), **kwargs).asnumpy()
        sym = getattr(m.sym, op)(m.sym.Variable("data"), **kwargs)
        ex = sym.simple_bind(m.cpu(), data=shape)
        ex.arg_dict["data"][:] = x
        (y,) = ex.forward()
        np.testing.assert_allclose(y.asnumpy(), nd_out, rtol=1e-5, atol=1e-6)
        outs.append(y.asnumpy())
    np.testing.assert_allclose(outs[0], outs[1], rtol=1e-5, atol=1e-6)


def test_the_stub_table_is_the_references():
    skip = {"Symbol", "Variable", "var", "Group", "load", "load_json",
            "Executor", "contrib"}
    names = lambda m: {n for n in m.sym.__all__ if n not in skip}
    assert names(mx) == names(jmx)
    assert sorted(vars(mx.sym.contrib)) == sorted(vars(jmx.sym.contrib))
    with pytest.raises(mx.MXNetError, match="duplicate"):
        mx.sym.FullyConnected(mx.sym.var("d"), data=mx.sym.var("e"),
                              num_hidden=2)
    fc = mx.sym.FullyConnected(mx.sym.var("d"), num_hidden=2, no_bias=True,
                               name="nb")
    assert fc.list_arguments() == ["d", "nb_weight"]
    assert mx.sym.Concat(mx.sym.var("p"), mx.sym.var("q"),
                         name="cc").list_arguments() == ["p", "q"]


def test_attr_scope_survives_json_roundtrip(tmp_path):
    for m in (mx, jmx):
        with m.AttrScope(ctx_group="dev1"):
            s = m.sym.FullyConnected(m.sym.Variable("x"), num_hidden=4,
                                     name="fc")
        f = str(tmp_path / "s.json")
        s.save(f)
        s2 = m.sym.load(f)
        assert s2.attr("ctx_group") == "dev1"
        wname = [k for k in s2.list_arguments() if k.endswith("_weight")][0]
        assert s2.attr_dict().get(wname, {}).get("ctx_group") == "dev1"


def test_symbol_v1_aliases_bind_with_auto_params():
    x = np.random.RandomState(5).rand(1, 3, 8, 8).astype(np.float32)
    for m in (mx, jmx):
        data = m.sym.Variable("data")
        s = m.sym.Convolution_v1(data, kernel=(3, 3), num_filter=4)
        ex = s.simple_bind(m.cpu(), data=(1, 3, 8, 8))
        assert ex.forward(is_train=False, data=x)[0].shape == (1, 4, 6, 6)
        b = m.sym.BatchNorm_v1(data)
        ex2 = b.simple_bind(m.cpu(), data=(1, 3, 8, 8))
        assert ex2.forward(is_train=False, data=x)[0].shape == (1, 3, 8, 8)
        with pytest.raises(m.MXNetError, match="unknown input"):
            ex2.forward(nothing=x)


def test_executor_copy_params_and_reshape():
    vals = _mlp_values(4)
    for m in (mx, jmx):
        ex = _mlp(m).simple_bind(m.cpu(), data=(8, 20), softmax_label=(8,))
        ex.copy_params_from({k: m.nd.array(v) for k, v in vals.items()})
        with pytest.raises(m.MXNetError, match="unknown argument"):
            ex.copy_params_from({"nothing": m.nd.array(vals["fc1_bias"])})
        ex.copy_params_from({"nothing": vals["fc1_bias"]},
                            allow_extra_params=True)
        small = ex.reshape(data=(3, 20), softmax_label=(3,))
        assert small.arg_dict["fc1_weight"] is ex.arg_dict["fc1_weight"]
        small.arg_dict["data"][:] = vals["data"][:3]
        y = small.forward()[0].asnumpy()
        assert y.shape == (3, 4)
        np.testing.assert_allclose(y, ex.forward()[0].asnumpy()[:3],
                                   rtol=1e-5, atol=1e-6)


def test_get_symbol_and_parameter_var_are_refused_as_in_the_reference():
    x = mx.nd.array(np.ones(2, np.float32))
    with pytest.raises(NotImplementedError):
        mx.autograd.get_symbol(x)
    with pytest.raises(NotImplementedError):
        jmx.autograd.get_symbol(jmx.nd.array(np.ones(2, np.float32)))
    with pytest.raises(NotImplementedError):
        gluon.Parameter("w", shape=(2,)).var()
    with pytest.raises(NotImplementedError):
        jmx.gluon.Parameter("w", shape=(2,)).var()


def test_executor_module_reexports_and_json_layout():
    from tpu_mx_torch.executor import Executor
    assert Executor is mx.sym.Executor
    g = json.loads(_mlp(mx).tojson())
    fc1 = [n for n in g["nodes"] if n["name"] == "fc1"][0]
    assert json.loads(fc1["attrs"]["__input_names__"]) == \
        ["data", "weight", "bias"]
    assert g["attrs"] == {"tpu_mx_version": "0.1"}
