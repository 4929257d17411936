"""Weight interchange, the prefetching iterators and the reference's
ImageNet example on the port, on the CPU.

- ``nd.save``/``nd.load`` write and read the reference's container (an
  ``.npz`` with ``__layout__`` and one ``.npy`` a name, ``arr_{i}`` for
  a list) in both directions; a bfloat16 array goes in as its raw bits
  under ``'<V2'``, byte for byte what the reference writes.
- A zoo network's ``.params`` (a thin ``VGG`` with BatchNorm: its
  convolutions, running statistics and dense layers) crosses both ways:
  the reference's ``save_parameters`` into the port's
  ``load_parameters`` and back, in float32 and bfloat16, and the
  forwards agree.
- ``PrefetchingIter``/``DevicePrefetchIter`` (``device="cpu"``) against
  the wrapped iterator and the reference's prefetcher.
- ``examples/image_classification/train_imagenet.py --smoke``, unedited,
  runs on the port through a ``sys.modules`` alias on the CPU context.
"""
import runpy
import sys
import zipfile
from pathlib import Path

import numpy as np
import pytest
import torch

import tpu_mx as jmx
from tpu_mx import autograd as jag
from tpu_mx import io as jio
from tpu_mx import layout as jlayout
from tpu_mx import nd as jnd
from tpu_mx.gluon.model_zoo import vision as jvision

import tpu_mx_torch as tmx
from tpu_mx_torch import io, layout, nd
from tpu_mx_torch.base import MXNetError
from tpu_mx_torch.gluon import ParameterDict
from tpu_mx_torch.gluon.model_zoo import vision

ROOT = Path(__file__).resolve().parent.parent
LOGITS_TOL = 2e-4   # test_torch_resnet.py: a net's f32 logits
BF16_TOL = 2e-2     # test_torch_resnet.py: bf16, relative to max|ref|


@pytest.fixture(autouse=True)
def _host(monkeypatch):
    monkeypatch.setenv("TPUMX_HOST_INIT", "1")
    monkeypatch.setattr(torch.backends.mkldnn, "enabled", False)
    with tmx.cpu():
        yield


def _normal(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _members(path):
    with zipfile.ZipFile(path) as z:
        return {n: z.read(n) for n in z.namelist()}


def _bits(a):
    """The raw 16 bits of a bfloat16 array of either package."""
    if isinstance(a, nd.NDArray):
        return a._data.view(torch.int16).numpy()
    return np.asarray(a._data).view(np.int16)


# -- nd.save / nd.load -------------------------------------------------------------
@pytest.mark.parametrize("layout_", ["list", "dict"])
def test_float32_arrays_cross_both_ways(tmp_path, layout_):
    arrays = [_normal(2, 3), _normal(4, seed=1), np.arange(6).reshape(2, 3)
              .astype(np.int32)]
    keys = ["a", "b.weight", "c"]
    pack = (lambda mod: [mod.array(a, dtype=a.dtype) for a in arrays]) \
        if layout_ == "list" else \
        (lambda mod: {k: mod.array(a, dtype=a.dtype)
                      for k, a in zip(keys, arrays)})
    jnd.save(str(tmp_path / "ref"), pack(jnd))
    nd.save(str(tmp_path / "port"), pack(nd))
    assert _members(tmp_path / "ref") == _members(tmp_path / "port")
    for reader in (nd.load, jnd.load):
        for f in ("ref", "port"):
            got = reader(str(tmp_path / f))
            items = got if layout_ == "list" else [got[k] for k in keys]
            assert isinstance(got, list if layout_ == "list" else dict)
            for a, g in zip(arrays, items):
                np.testing.assert_array_equal(g.asnumpy(), a)


def test_bfloat16_goes_in_as_raw_v2_words_byte_for_byte(tmp_path):
    a = _normal(3, 5)
    jnd.save(str(tmp_path / "ref"), {"w": jnd.cast(jnd.array(a), "bfloat16")})
    nd.save(str(tmp_path / "port"), {"w": nd.array(a, dtype="bfloat16")})
    ref, port = _members(tmp_path / "ref"), _members(tmp_path / "port")
    assert ref == port
    assert b"'descr': '<V2'" in port["w.npy"]
    got = nd.load(str(tmp_path / "ref"))["w"]
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        _bits(got), _bits(jnd.cast(jnd.array(a), "bfloat16")))


def test_the_references_own_load_refuses_its_bfloat16_members(tmp_path):
    """Pinned (ROADMAP C, red on the reference side): the reference's
    ``nd.load`` hands the ``'<V2'`` member to ``jnp.asarray``, which
    refuses a void dtype; the port reads it back as bfloat16."""
    f = str(tmp_path / "ref")
    jnd.save(f, [jnd.cast(jnd.array(_normal(2)), "bfloat16")])
    with pytest.raises(TypeError, match="V2"):
        jnd.load(f)
    assert nd.load(f)[0].dtype == torch.bfloat16


def test_load_finds_the_npz_suffix_and_writes_atomically(tmp_path):
    base = tmp_path / "arrays"
    nd.save(str(base) + ".npz", [nd.array(_normal(2))])
    np.testing.assert_array_equal(nd.load(str(base))[0].asnumpy(),
                                  _normal(2))
    assert not list(tmp_path.glob("*.tmp.*"))


def test_parameter_dict_saves_in_the_reference_container(tmp_path):
    pd = ParameterDict("blk_")
    pd.get("w", shape=(2, 3), init="ones").initialize()
    pd.save(str(tmp_path / "p"), strip_prefix="blk_")
    got = jnd.load(str(tmp_path / "p"))
    np.testing.assert_array_equal(got["w"].asnumpy(), np.ones((2, 3)))


# -- a zoo network's .params ------------------------------------------------------
THIN_VGG = ([1, 1], [4, 8])     # convolutions, BatchNorms, dense layers


def _ref_net(lay, x):
    with jlayout.default_layout(lay):
        net = jvision.VGG(*THIN_VGG, classes=10, batch_norm=True)
    np.random.seed(0)
    net.initialize(init="xavier")
    with jag.record():          # moves the running statistics off 0 and 1
        net(jnd.array(x))
    return net


def _port_net(lay):
    with layout.default_layout(lay):
        net = vision.VGG(*THIN_VGG, classes=10, batch_norm=True)
    net.initialize()
    return net


@pytest.mark.parametrize("lay", ["NCHW", "NHWC"])
def test_zoo_params_cross_both_ways_in_float32(tmp_path, lay):
    x = _normal(2, 3, 16, 16) if lay == "NCHW" else _normal(2, 16, 16, 3)
    jnet = _ref_net(lay, x)
    ref_file, port_file = str(tmp_path / "ref.params"), \
        str(tmp_path / "port.params")
    jnet.save_parameters(ref_file)
    net = _port_net(lay)
    net.load_parameters(ref_file)          # deferred: takes the shapes
    want = jnet(jnd.array(x)).asnumpy()
    got = net(nd.array(x)).asnumpy()
    np.testing.assert_allclose(got, want, rtol=LOGITS_TOL,
                               atol=LOGITS_TOL * np.abs(want).max())
    net.save_parameters(port_file)
    assert set(_members(port_file)) == set(_members(ref_file))
    assert _members(port_file) == _members(ref_file)   # same arrays, bytes
    back = _ref_net(lay, x)
    back.load_parameters(port_file)
    np.testing.assert_array_equal(back(jnd.array(x)).asnumpy(), want)
    keys = set(jnet._collect_params_with_prefix())
    assert set(net._collect_params_with_prefix()) == keys
    assert {"features.0.weight", "features.1.running_var",
            "output.weight"} <= keys


@pytest.mark.parametrize("lay", ["NCHW", "NHWC"])
def test_zoo_params_cross_both_ways_in_bfloat16(tmp_path, lay):
    x = _normal(2, 3, 16, 16) if lay == "NCHW" else _normal(2, 16, 16, 3)
    jnet = _ref_net(lay, x)
    jnet.cast("bfloat16")
    ref_file, port_file = str(tmp_path / "ref.params"), \
        str(tmp_path / "port.params")
    jnet.save_parameters(ref_file)
    net = _port_net(lay)
    net(nd.array(x))                      # shapes, then bfloat16
    net.cast("bfloat16")
    net.load_parameters(ref_file)
    for (k, p), jp in zip(net._collect_params_with_prefix().items(),
                          jnet._collect_params_with_prefix().values()):
        assert p.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            p._ref_view().contiguous().view(torch.int16).numpy(),
            _bits(jp.data()), err_msg=k)
    xb = nd.array(x, dtype="bfloat16")
    want = jnet(jnd.cast(jnd.array(x), "bfloat16")).asnumpy()
    got = net(xb).asnumpy()
    np.testing.assert_allclose(got, want, rtol=BF16_TOL,
                               atol=BF16_TOL * np.abs(want).max())
    net.save_parameters(port_file)
    assert _members(port_file) == _members(ref_file)


# -- prefetching iterators ----------------------------------------------------------
def _source(mod, n=20, batch=4, shuffle=False, seed=None):
    x = np.random.RandomState(0).rand(n, 5, 5, 3).astype(np.float32) * 255
    y = np.arange(n).astype(np.float32)
    return mod.NDArrayIter(x, y, batch_size=batch, shuffle=shuffle,
                           seed=seed, last_batch_handle="discard")


def _drain(it):
    return [(b.data[0].asnumpy(), b.label[0].asnumpy()) for b in it]


def test_prefetching_iter_yields_the_wrapped_batches_and_resets():
    want = _drain(_source(io))
    with io.PrefetchingIter(_source(io), depth=3) as it:
        for _ in range(2):
            got = _drain(it)
            assert len(got) == len(want) == 5
            for (a, b), (c, d) in zip(got, want):
                np.testing.assert_array_equal(a, c)
                np.testing.assert_array_equal(b, d)
            assert not it.iter_next()      # exhausted stays exhausted
            it.reset()
    assert it._thread is None


def test_prefetching_iter_resumes_from_its_state():
    it = io.PrefetchingIter(_source(io, shuffle=True, seed=3))
    first = [it.next() for _ in range(2)]
    state = it.state_dict()
    rest = _drain(it)
    again = io.PrefetchingIter(_source(io, shuffle=True, seed=3))
    again.load_state_dict(state)
    for (a, b), (c, d) in zip(_drain(again), rest):
        np.testing.assert_array_equal(a, c)
    assert len(first) == 2 and len(rest) == 3
    it.close()
    again.close()
    with pytest.raises(MXNetError, match="captured from"):
        again.load_state_dict({"iter": "NDArrayIter"})


def test_a_worker_error_reaches_the_consumer():
    class Broken(io.DataIter):
        batch_size = 1

        def next(self):
            raise ValueError("disk gone")

    it = io.PrefetchingIter(Broken())
    with pytest.raises(ValueError, match="disk gone"):
        it.next()
    assert not it.iter_next()


def test_device_prefetch_normalizes_in_float32_then_casts_as_the_reference():
    norm = dict(normalize=((123.68, 116.78, 103.94), (58.39, 57.12, 57.37)),
                normalize_axis=-1)
    ref = jio.DevicePrefetchIter(_source(jio), cast_data="bfloat16", **norm)
    port = io.DevicePrefetchIter(_source(io), device="cpu",
                                 cast_data="bfloat16", **norm)
    got, want = list(port), list(ref)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert g.data[0].dtype == torch.bfloat16
        assert g.data[0]._data.device.type == "cpu"
        np.testing.assert_array_equal(_bits(g.data[0]), _bits(w.data[0]))
        np.testing.assert_array_equal(g.label[0].asnumpy(),
                                      w.label[0].asnumpy())
        assert g.label[0].dtype == np.float32
    port.close()
    ref.close()


def test_device_prefetch_defaults_to_the_current_context():
    it = io.DevicePrefetchIter(_source(io))
    assert it._dev.type == "cpu"
    it.close()


# -- the reference's ImageNet example ------------------------------------------------
def test_the_imagenet_example_trains_on_the_port_through_a_module_alias(
        monkeypatch, capsys):
    """``train_imagenet.py --smoke`` unedited (ResNet-18 v1, 100 classes,
    batch 8 of 64x64, bfloat16 with float32 masters, two steps through
    ``CompiledTrainStep`` fed by ``DevicePrefetchIter``), with
    ``tpu_mx`` mapped to the port, on the CPU context."""
    import tpu_mx_torch.gluon.model_zoo
    import tpu_mx_torch.layout
    import tpu_mx_torch.parallel
    for name, mod in (("tpu_mx", tmx), ("tpu_mx.gluon", tmx.gluon),
                      ("tpu_mx.gluon.model_zoo", tmx.gluon.model_zoo),
                      ("tpu_mx.gluon.model_zoo.vision",
                       tmx.gluon.model_zoo.vision),
                      ("tpu_mx.parallel", tmx.parallel),
                      ("tpu_mx.layout", tmx.layout)):
        monkeypatch.setitem(sys.modules, name, mod)
    monkeypatch.setattr(sys, "argv", ["train_imagenet.py", "--smoke"])
    runpy.run_path(str(ROOT / "examples" / "image_classification" /
                       "train_imagenet.py"), run_name="__main__")
    out = capsys.readouterr().out
    assert "epoch 0: loss" in out and "img/s" in out
    loss = float(out.split("epoch 0: loss")[1].split()[0])
    assert np.isfinite(loss)
    assert jmx.gluon is not tmx.gluon
