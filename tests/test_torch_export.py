"""``HybridBlock.export`` and ``SymbolBlock.imports`` of the port, on the
CPU: each test of ``tests/test_export.py`` against the reference's eager
forward on the same parameters (no test pays for ``jax.export``), the
reference's files refused by name, and a thin BERT carried through.

The port writes ``{path}-symbol.json`` (format
``"tpu_mx_torch-export-v1"``), ``{path}-{epoch:04d}.params.npz`` (the
reference's keys and container) and ``{path}-{epoch:04d}.pt2`` (a
``torch.export`` program), committed by a manifest.

Tolerances: the imported program against the exporting block: bit for
bit; against the reference's eager forward on the same weights: 1e-5
relative (float32 sums in another order).
"""
import json
import os

import numpy as np
import pytest
import torch

import tpu_mx as jmx
from tpu_mx import nd as jnd

import tpu_mx_torch as mx
from tpu_mx_torch import autograd, checkpoint, gluon, layout, nd
from tpu_mx_torch.gluon import SymbolBlock, nn

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def _host():
    torch.backends.mkldnn.enabled = False
    with mx.cpu():
        yield


def _small_net(m):
    net = m.gluon.nn.HybridSequential()
    net.add(m.gluon.nn.Conv2D(8, 3, padding=1, in_channels=3,
                              activation="relu"))
    net.add(m.gluon.nn.BatchNorm())
    net.add(m.gluon.nn.GlobalAvgPool2D())
    net.add(m.gluon.nn.Flatten())
    net.add(m.gluon.nn.Dense(5))
    return net


def _pair(tmp_path, x):
    """A reference net and a port net with its parameters (through the
    reference's ``.params`` file), both called once on ``x``."""
    ref = _small_net(jmx)
    ref.initialize(init="xavier")
    ref(jnd.array(x))
    f = str(tmp_path / "ref.params")
    ref.save_parameters(f)
    net = _small_net(mx)
    net.initialize(init="xavier")
    net(nd.array(x))
    net.load_parameters(f)
    return ref, net


def test_export_roundtrip_bit_identical(tmp_path):
    x = np.random.RandomState(0).rand(2, 3, 8, 8).astype(np.float32)
    ref, net = _pair(tmp_path, x)
    net.hybridize()
    y_ref = net(nd.array(x))   # the last call's shapes are exported
    prefix = str(tmp_path / "model")
    net.export(prefix, epoch=3)
    for suffix in ("-symbol.json", "-0003.params.npz", "-0003.pt2"):
        assert os.path.exists(prefix + suffix)
    manifest = json.load(open(prefix + "-symbol.json"))
    assert manifest["format"] == "tpu_mx_torch-export-v1"
    assert manifest["inputs"] == [{"shape": [2, 3, 8, 8],
                                   "dtype": "float32"}]
    assert manifest["artifact"] == "model-0003.pt2"
    assert manifest["name"] == net.name
    assert manifest["params"] == sorted(ref._collect_params_with_prefix())
    assert checkpoint.verify_checkpoint(prefix, 3)[0] == "verified"
    blk = SymbolBlock.imports(prefix + "-symbol.json", ["data"],
                              prefix + "-0003.params.npz")
    y = blk(nd.array(x))
    np.testing.assert_array_equal(y.asnumpy(), y_ref.asnumpy())
    want = ref(jnd.array(x)).asnumpy()
    np.testing.assert_allclose(y.asnumpy(), want, rtol=RTOL, atol=ATOL)
    # the parameters file is the reference's: its nd.load reads it
    loaded = jnd.load(prefix + "-0003.params.npz")
    assert sorted(loaded) == manifest["params"]
    for k, p in ref._collect_params_with_prefix().items():
        np.testing.assert_array_equal(loaded[k].asnumpy(),
                                      p.data().asnumpy())


def test_export_with_example_inputs_no_prior_call(tmp_path):
    x = np.random.RandomState(1).rand(1, 3, 6, 6).astype(np.float32)
    ref, net = _pair(tmp_path, x)
    net.__dict__.pop("_last_input_avals", None)
    prefix = str(tmp_path / "m2")
    net.export(prefix, epoch=0, example_inputs=[nd.array(x)])
    blk = SymbolBlock.imports(prefix + "-symbol.json", ["data"],
                              prefix + "-0000.params.npz")
    with autograd.predict_mode():
        mine = net(nd.array(x)).asnumpy()
    np.testing.assert_array_equal(blk(nd.array(x)).asnumpy(), mine)
    np.testing.assert_allclose(blk(nd.array(x)).asnumpy(),
                               ref(jnd.array(x)).asnumpy(), rtol=RTOL,
                               atol=ATOL)
    # tensors in, tensors out
    assert isinstance(blk(torch.from_numpy(x)), torch.Tensor)


def test_export_without_shapes_raises(tmp_path):
    for m in (mx, jmx):
        net = _small_net(m)
        net.initialize(init="xavier")
        with pytest.raises(m.MXNetError, match="input shapes"):
            net.export(str(tmp_path / m.__name__ / "m3"))
    assert not os.path.exists(tmp_path / "tpu_mx_torch")


def test_imports_rejects_bad_format(tmp_path):
    p = tmp_path / "bad-symbol.json"
    p.write_text(json.dumps({"format": "mxnet-json-v1"}))
    with pytest.raises(mx.MXNetError, match="mxnet-json-v1"):
        SymbolBlock.imports(str(p), ["data"], "unused")
    with pytest.raises(jmx.MXNetError):
        jmx.gluon.SymbolBlock.imports(str(p), ["data"], "unused")
    # the reference's own export format is refused by name too
    p.write_text(json.dumps({"format": "tpu_mx-stablehlo-v1",
                             "artifact": "x.stablehlo"}))
    with pytest.raises(mx.MXNetError, match="tpu_mx-stablehlo-v1"):
        SymbolBlock.imports(str(p), ["data"], "unused")


def test_export_refuses_a_forward_it_cannot_trace(tmp_path):
    class Branchy(gluon.HybridBlock):
        def hybrid_forward(self, F, x):
            if float(x.sum()) > 0:   # a value read back: not traceable
                return x * 2
            return x

    blk = Branchy()
    with pytest.raises(mx.MXNetError, match="torch.export cannot trace"):
        blk.export(str(tmp_path / "branchy"),
                   example_inputs=[nd.array(np.ones((2, 2), np.float32))])
    assert not os.listdir(tmp_path)   # nothing written in its place


def test_export_channels_last_weights_and_imports_other_params(tmp_path):
    """A channels-last net stores its convolution weight in another order
    than the reference's shape: the file holds the reference's shape, the
    import permutes it back, and a file of other weights changes the
    imported forward accordingly."""
    x = np.random.RandomState(2).rand(2, 8, 8, 3).astype(np.float32)
    with layout.default_layout("NHWC"):
        net = nn.HybridSequential()
        net.add(nn.Conv2D(4, 3, padding=1, in_channels=3), nn.Flatten(),
                nn.Dense(3, in_units=256))
    net.initialize(init="xavier")
    y0 = net(nd.array(x))
    prefix = str(tmp_path / "nhwc")
    net.export(prefix)
    manifest = json.load(open(prefix + "-symbol.json"))
    assert manifest["axes"]
    blk = SymbolBlock.imports(prefix + "-symbol.json", ["data"],
                              prefix + "-0000.params.npz")
    np.testing.assert_array_equal(blk(nd.array(x)).asnumpy(), y0.asnumpy())
    params = dict(nd.load(prefix + "-0000.params.npz"))
    params = {k: v * 2 if k.endswith("weight") else v
              for k, v in params.items()}
    nd.save(str(tmp_path / "other.params.npz"), params)
    net.load_parameters(str(tmp_path / "other.params.npz"))
    with autograd.predict_mode():
        want = net(nd.array(x)).asnumpy()
    other = SymbolBlock.imports(prefix + "-symbol.json", ["data"],
                                str(tmp_path / "other.params.npz"))
    np.testing.assert_array_equal(other(nd.array(x)).asnumpy(), want)


def test_export_a_thin_bert_bit_identical(tmp_path):
    from tpu_mx_torch.models.bert import BERTModel, bert_base_config
    cfg = bert_base_config(vocab_size=100, max_len=32)
    cfg.update(num_layers=2, units=32, hidden_size=64, num_heads=2)
    net = BERTModel(cfg, device="cpu",
                    generator=torch.Generator().manual_seed(0))
    rng = np.random.RandomState(0)
    b, t = 3, 32
    inputs = [nd.array(rng.randint(4, 100, (b, t)).astype(np.int32)),
              nd.array(np.zeros((b, t), np.int32)),
              nd.array(np.array([32, 17, 9], np.int32)),
              nd.array(np.stack([rng.choice(t, 5, replace=False)
                                 for _ in range(b)]).astype(np.int32))]
    with autograd.predict_mode():
        want = net(*inputs).asnumpy()
    prefix = str(tmp_path / "bert")
    net.export(prefix, epoch=1)
    blk = SymbolBlock.imports(prefix + "-symbol.json", None,
                              prefix + "-0001.params.npz")
    np.testing.assert_array_equal(blk(*inputs).asnumpy(), want)
    assert blk._export_manifest["inputs"][2] == {"shape": [3],
                                                 "dtype": "int32"}
