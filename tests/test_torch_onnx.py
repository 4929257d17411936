"""The port's ``contrib.onnx`` (and its ``_protobuf`` codec) against the
reference's, on the CPU: each test of ``tests/test_onnx.py`` with files
crossing both ways.  For each graph, built with the same names in both
packages' ``mx.sym`` over the same seeded parameters:

- the two exporters write the same bytes (the writer is the same node
  for node, and the symbol graphs are the same key for key);
- each package imports its own file and the other's, and the imported
  graph's outputs on the same input equal the original's;
- ``get_model_metadata`` agrees.

Tolerances: bytes and metadata equal; outputs within 1e-5 relative and
1e-6 absolute (float32 convolutions and products in PyTorch's order
against XLA's).
"""
import numpy as np
import pytest

import tpu_mx as jmx
from tpu_mx.contrib import _protobuf as jpb
from tpu_mx.contrib import onnx as jonnx

import tpu_mx_torch as mx
from tpu_mx_torch.contrib import _protobuf as pb
from tpu_mx_torch.contrib import onnx as ponnx

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def _host():
    with mx.cpu():
        yield


def test_protobuf_roundtrip():
    for lib in (pb, jpb):
        m = (lib.Msg().int(1, 8).bytes(2, "hello").float(3, 2.5)
             .ints(4, [3, -1, 7]).bytes(5, lib.Msg().int(1, 42)))
        f = lib.decode(m.tobytes())
        assert f[1] == [8] and f[2] == [b"hello"]
        assert abs(f[3][0] - 2.5) < 1e-7
        assert lib.decode_packed_ints(f[4]) == [3, -1, 7]
        assert lib.decode(f[5][0])[1] == [42]
    assert m.tobytes() == (pb.Msg().int(1, 8).bytes(2, "hello").float(3, 2.5)
                           .ints(4, [3, -1, 7]).bytes(5, pb.Msg().int(1, 42))
                           .tobytes())
    assert pb.varint(-1) == jpb.varint(-1) and len(pb.varint(-1)) == 10
    assert pb.zigzag_ok() is False


def _convnet(S):
    x = S.Variable("data")
    c1 = S.Convolution(x, kernel=(3, 3), num_filter=8, pad=(1, 1), name="c1")
    b1 = S.BatchNorm(c1, fix_gamma=False, name="bn1")
    a1 = S.Activation(b1, act_type="relu", name="a1")
    p1 = S.Pooling(a1, kernel=(2, 2), stride=(2, 2), pool_type="max",
                   name="p1")
    c2 = S.Convolution(p1, kernel=(1, 1), num_filter=4, no_bias=True,
                       name="c2")
    g = S.Pooling(c2, global_pool=True, kernel=(1, 1), pool_type="avg",
                  name="g")
    fc = S.FullyConnected(S.Flatten(g, name="f"), num_hidden=10, name="fc")
    return S.softmax(fc, name="out")


def _residual(S):
    x = S.Variable("data")
    c1 = S.Convolution(x, kernel=(3, 3), num_filter=4, pad=(1, 1), name="r1")
    c2 = S.Convolution(x, kernel=(1, 1), num_filter=4, name="r2")
    added = S.broadcast_add(c1, c2, name="add")
    cat = S.Concat(added, c1, dim=1, name="cat")
    return S.LeakyReLU(cat, slope=0.1, name="lrelu")


def _resnet_stem(S):
    x = S.Variable("data")
    y = S.Convolution(x, kernel=(7, 7), stride=(2, 2), pad=(3, 3),
                      num_filter=8, no_bias=True, name="conv0")
    y = S.BatchNorm(y, fix_gamma=True, name="bn0")
    y = S.Activation(y, act_type="relu", name="relu0")
    y = S.Pooling(y, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                  pool_type="max", name="pool0")
    res = y
    y = S.Convolution(y, kernel=(3, 3), pad=(1, 1), num_filter=8,
                      no_bias=True, name="rb_c1")
    y = S.BatchNorm(y, fix_gamma=False, name="rb_bn1")
    y = S.Activation(y, act_type="relu", name="rb_a1")
    y = S.Convolution(y, kernel=(3, 3), pad=(1, 1), num_filter=8,
                      no_bias=True, name="rb_c2")
    y = S.BatchNorm(y, fix_gamma=False, name="rb_bn2")
    y = S.Activation(S.broadcast_add(y, res, name="rb_add"),
                     act_type="relu", name="rb_out")
    y = S.Pooling(y, global_pool=True, kernel=(1, 1), pool_type="avg",
                  name="gap")
    return S.FullyConnected(S.Flatten(y, name="fl"), num_hidden=10,
                            name="head")


def _op_mix(S):
    """The rest of the converters: reshape, transpose, average pooling
    with and without padding counted, softrelu/sigmoid/tanh, the
    broadcast arithmetic, add_n, dropout, a non-flattening FC."""
    x = S.Variable("data")
    y = S.Pooling(x, kernel=(3, 3), stride=(1, 1), pad=(1, 1),
                  pool_type="avg", count_include_pad=False, name="ap")
    y = S.Activation(y, act_type="softrelu", name="sr")
    z = S.Pooling(x, kernel=(3, 3), stride=(1, 1), pad=(1, 1),
                  pool_type="avg", name="ap2")
    z = S.Activation(z, act_type="sigmoid", name="sg")
    w = S.broadcast_mul(S.broadcast_sub(y, z, name="sub"), z, name="mul")
    w = S.broadcast_div(w, S.Activation(z, act_type="tanh", name="th"),
                        name="div")
    w = S.add_n(w, y, z, name="sum")
    w = S.Dropout(w, p=0.25, name="do")
    w = S.reshape(w, shape=(2, 3, 25), name="rs")
    w = S.transpose(w, axes=(0, 2, 1), name="tp")
    return S.FullyConnected(w, num_hidden=4, flatten=False, name="fcnf")


def _mlp_embedding(S):
    tok = S.Variable("tokens")
    emb = S.Embedding(tok, input_dim=20, output_dim=8, name="emb")
    fc1 = S.FullyConnected(S.Flatten(emb, name="fl"), num_hidden=16,
                           name="fc1")
    act = S.Activation(fc1, act_type="tanh", name="act")
    drop = S.Dropout(act, p=0.3, name="drop")
    return S.FullyConnected(drop, num_hidden=4, name="fc2")


GRAPHS = {"convnet": (_convnet, "data", (2, 3, 16, 16)),
          "residual": (_residual, "data", (1, 2, 8, 8)),
          "resnet_stem": (_resnet_stem, "data", (2, 3, 32, 32)),
          "op_mix": (_op_mix, "data", (2, 3, 5, 5)),
          "mlp_embedding": (_mlp_embedding, "tokens", (3, 4))}


def _params(sym, name, shape, seed=0):
    rng = np.random.RandomState(seed)
    arg_shapes, _, aux_shapes = sym.infer_shape(**{name: shape})
    params = {}
    for n, shp in zip(sym.list_arguments(), arg_shapes):
        if n != name:
            params[n] = rng.uniform(-0.3, 0.3, shp).astype(np.float32)
    for n, shp in zip(sym.list_auxiliary_states(), aux_shapes):
        params[n] = (rng.uniform(0.5, 1.5, shp) if "var" in n
                     else rng.uniform(-0.1, 0.1, shp)).astype(np.float32)
    return params


def _data(name, shape):
    rng = np.random.RandomState(7)
    if name == "tokens":
        return rng.randint(0, 20, shape).astype(np.int32)
    return rng.rand(*shape).astype(np.float32)


def _run(m, sym, params, name, data):
    feeds = {name: m.nd.array(data)}
    feeds.update({k: m.nd.array(np.asarray(v.asnumpy() if hasattr(
        v, "asnumpy") else v)) for k, v in params.items()})
    return sym.eval(**feeds)[0].asnumpy()


def _export(lib, sym, params, name, shape, path):
    kw = {"input_dtypes": {name: "int32"}} if name == "tokens" else {}
    return lib.export_model(sym, params, {name: shape}, str(path), **kw)


@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_both_exporters_write_the_same_bytes_and_cross(graph, tmp_path):
    build, name, shape = GRAPHS[graph]
    jsym, psym = build(jmx.sym), build(mx.sym)
    assert psym.tojson() == jsym.tojson()
    params = _params(jsym, name, shape)
    data = _data(name, shape)
    want = _run(jmx, jsym, params, name, data)
    np.testing.assert_allclose(_run(mx, psym, params, name, data), want,
                               rtol=RTOL, atol=ATOL)
    files = {"ref": _export(jonnx, jsym, params, name, shape,
                            tmp_path / "ref.onnx"),
             "port": _export(ponnx, psym, {k: mx.nd.array(v)
                                           for k, v in params.items()},
                             name, shape, tmp_path / "port.onnx")}
    blobs = {k: open(p, "rb").read() for k, p in files.items()}
    assert blobs["port"] == blobs["ref"]
    assert ponnx.get_model_metadata(files["ref"]) == \
        jonnx.get_model_metadata(files["port"])
    for writer, path in files.items():
        for m, lib in ((jmx, jonnx), (mx, ponnx)):
            sym2, arg2, aux2 = lib.import_model(path)
            back = {**arg2, **aux2}
            # fix_gamma's gamma is written as a constant of ones
            assert {k for k in set(back) ^ set(params)
                    if not k.startswith("_onnx_fixed_gamma")} <= \
                {k for k in params if k.endswith("gamma")}
            np.testing.assert_allclose(_run(m, sym2, back, name, data), want,
                                       rtol=RTOL, atol=ATOL,
                                       err_msg=f"{writer} file, "
                                       f"{m.__name__} importer")


def test_imported_batchnorm_statistics_are_aux_params(tmp_path):
    sym = _convnet(mx.sym)
    params = _params(sym, "data", (2, 3, 16, 16))
    path = ponnx.export_model(sym, params, [(2, 3, 16, 16)],
                              str(tmp_path / "n.onnx"))
    sym2, arg2, aux2 = ponnx.import_model(path)
    _, jarg2, jaux2 = jonnx.import_model(path)
    assert sorted(aux2) == sorted(jaux2) == ["bn1_moving_mean",
                                             "bn1_moving_var"]
    assert sorted(arg2) == sorted(jarg2)
    assert isinstance(arg2["c1_weight"], mx.nd.NDArray)
    assert ponnx.get_model_metadata(path) == {
        "input_tensor_data": ["data"], "output_tensor_data": ["out_output"]}


def test_int_inputs_are_declared_in_their_dtype(tmp_path):
    sym = _mlp_embedding(mx.sym)
    params = _params(sym, "tokens", (3, 4))
    path = _export(ponnx, sym, params, "tokens", (3, 4), tmp_path / "t.onnx")
    with open(path, "rb") as f:
        graph = pb.decode(pb.decode(f.read())[7][0])
    vi = pb.decode(graph[11][0])
    ttype = pb.decode(pb.decode(vi[2][0])[1][0])
    assert ttype[1][0] == 6, "tokens input must be declared int32"


def test_bfloat16_parameters_are_written_as_float32(tmp_path):
    import torch
    sym = _residual(mx.sym)
    params = _params(sym, "data", (1, 2, 8, 8))
    bf = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in
          params.items()}
    path = ponnx.export_model(sym, bf, [(1, 2, 8, 8)], str(tmp_path / "b.onnx"))
    _, arg2, _ = jonnx.import_model(path)
    for k, v in bf.items():
        np.testing.assert_array_equal(arg2[k].asnumpy(), v.float().numpy())


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_onnx_export_refuses_what_the_reference_refuses(pkg, tmp_path):
    m, lib = (jmx, jonnx) if pkg == "ref" else (mx, ponnx)
    x = m.sym.Variable("data")
    with pytest.raises(m.base.MXNetError, match="unsupported"):
        lib.export_model(m.sym.sort(x, name="s"), {}, [(4, 4)],
                         str(tmp_path / "x.onnx"))
    with pytest.raises(m.base.MXNetError, match="missing input shapes"):
        lib.export_model(m.sym.relu(x, name="r"), {}, None,
                         str(tmp_path / "y.onnx"))
    with pytest.raises(m.base.MXNetError, match="act_type"):
        lib.export_model(m.sym.Activation(x, act_type="softsign2", name="a"),
                         {}, [(4, 4)], str(tmp_path / "z.onnx"))
