"""The port's ``mx.runtime``, ``mx.libinfo``, ``mx.test_utils``, ``mx.util``,
the registries (``base.Registry``, ``check``, ``get_env``,
``metric.registry``) and ``gluon.utils.check_sha1``/``download``
against the reference's, on the CPU: the ``runtime`` cases of
``tests/test_aux.py``, ``util.np_scope`` (``tests/test_symbol.py``'s
case, which ``test_torch_symbol.py`` leaves to this file), and each
helper beside the reference's on the same seeded inputs.  ``download``
is tried with a ``file://`` URL only: both packages refuse it.

Tolerances: names, flags, registry keys and errors are equal; the test
kit's checks reach the same verdicts; float32 results within 1e-5
relative.
"""
import hashlib
import os

import numpy as np
import pytest
import torch

import tpu_mx as jmx

import tpu_mx_torch as mx
from tpu_mx_torch import autograd, nd


@pytest.fixture(autouse=True)
def _host():
    with mx.cpu():
        yield


# -- runtime, libinfo -----------------------------------------------------
PORT_FEATURES = {"TORCH", "CUDA", "GPU", "CPU", "NVCC", "TRITON", "KERNELS",
                 "OPENCV", "PIL", "CPP_RECORDIO", "NATIVE_IO",
                 "DIST_KVSTORE", "BF16", "INT8_QUANTIZATION", "PROFILER"}


def test_runtime_feature_list():
    feats = mx.runtime.feature_list()
    assert {f.name for f in feats} == PORT_FEATURES
    assert all(isinstance(f, mx.runtime.Feature) for f in feats)
    features = mx.runtime.Features()
    on = {k for k, f in features.items() if f.enabled}
    assert {"TORCH", "CPU", "PROFILER", "INT8_QUANTIZATION"} <= on
    assert features.is_enabled("torch") and not features.is_enabled("JAX")
    assert features.is_enabled("GPU") == torch.cuda.is_available()
    assert features.is_enabled("DIST_KVSTORE") == \
        torch.distributed.is_available()
    # the names both packages probe the same way
    jfeat = jmx.runtime.Features()
    for name in ("CPU", "OPENCV", "PIL", "INT8_QUANTIZATION", "PROFILER"):
        assert features.is_enabled(name) == jfeat.is_enabled(name), name
    assert repr(mx.runtime.Feature("X", True)) == \
        repr(jmx.runtime.Feature("X", True))
    assert repr(features).startswith("[[")


def test_kernels_feature_follows_the_built_libraries(monkeypatch, tmp_path):
    from tpu_mx_torch.kernels import _build
    monkeypatch.setattr(_build, "nvcc_version", lambda: "nvcc 12.9\n")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    assert not mx.runtime.Features().is_enabled("KERNELS")
    for name in _build.SOURCES:
        _build._target(name)[1].write_bytes(b"")
    assert mx.runtime.Features().is_enabled("KERNELS")


@pytest.mark.parametrize("value", [
    np.arange(6, dtype=np.float32).reshape(2, 3), [1.5, 2.5]])
def test_fetch_sync_reads_back_to_the_host(value):
    want = jmx.runtime.fetch_sync(np.asarray(value))
    for x in (nd.array(np.asarray(value)), torch.tensor(np.asarray(value)),
              value):
        got = mx.runtime.fetch_sync(x)
        assert isinstance(got, np.ndarray)
        np.testing.assert_array_equal(got, want)
    bf = mx.runtime.fetch_sync(torch.tensor([1.0, 2.0], dtype=torch.bfloat16))
    np.testing.assert_array_equal(bf, [1.0, 2.0])


def test_set_compilation_cache_moves_rtcs_directory(tmp_path):
    from tpu_mx_torch import rtc
    old = rtc.RTC_DIR
    try:
        mx.runtime.set_compilation_cache(tmp_path / "c", 2.5)
        assert rtc.RTC_DIR == tmp_path / "c"
        mod = rtc.CudaModule('extern "C" __global__ void k(float* y, int n)'
                             ' { }')
        assert mod.get_kernel("k").name == "k"
    finally:
        rtc.RTC_DIR = old


@pytest.mark.parametrize("env,enabled", [("0", False), ("1", True),
                                         (None, True)])
def test_enable_shared_compilation_cache(monkeypatch, env, enabled):
    from tpu_mx_torch import rtc
    from tpu_mx_torch.kernels import _build
    if env is None:
        monkeypatch.delenv("BENCH_COMPILE_CACHE", raising=False)
    else:
        monkeypatch.setenv("BENCH_COMPILE_CACHE", env)
    old = rtc.RTC_DIR
    try:
        got = mx.runtime.enable_shared_compilation_cache()
        if enabled:
            assert got == str(_build.BUILD_DIR.parent / "compile_cache")
            assert rtc.RTC_DIR == _build.BUILD_DIR.parent / "compile_cache"
            # under the repository's git-ignored build/
            assert os.path.basename(os.path.dirname(got)) == "build"
        else:
            assert got is None and rtc.RTC_DIR == old
    finally:
        rtc.RTC_DIR = old


def test_clear_compilation_cache_drops_the_in_memory_caches(tmp_path):
    from tpu_mx_torch import engine, fusion, rtc
    x = nd.array(np.ones((3, 3), np.float32))
    with engine.bulk(8):
        y = nd.tanh(x * 2.0)
    y.asnumpy()
    assert fusion.cache_stats()["programs"] > 0
    rtc._modules[(0, "k")] = object()
    rtc._functions[(0, "k", "f")] = object()
    (tmp_path / "keep.cubin").write_bytes(b"x")
    old = rtc.RTC_DIR
    rtc.RTC_DIR = tmp_path
    try:
        mx.runtime.clear_compilation_cache()
    finally:
        rtc.RTC_DIR = old
    assert not rtc._modules and not rtc._functions
    assert fusion.cache_stats()["programs"] == 0
    assert fusion.graph_stats()["graphs"] == 0
    assert (tmp_path / "keep.cubin").exists()


def test_libinfo_features_are_probed_lazily():
    from tpu_mx_torch import libinfo
    assert "features" not in vars(libinfo)
    names = {f.name for f in libinfo.features}
    assert names == PORT_FEATURES
    assert libinfo.__version__ == mx.__version__ == jmx.__version__
    assert libinfo.Features is mx.runtime.Features
    with pytest.raises(AttributeError):
        libinfo.nothing


# -- test_utils -------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float16", "float32", "float64",
                                   "int32"])
def test_default_tols_are_the_references(dtype):
    a = np.zeros(3, dtype)
    assert mx.test_utils.default_tols(a) == jmx.test_utils.default_tols(a)
    assert mx.test_utils.default_tols(nd.array(a)) == \
        jmx.test_utils.default_tols(jmx.nd.array(a))
    assert mx.test_utils.default_tols(
        torch.zeros(2, dtype=torch.bfloat16)) == (1e-2, 1e-2)


def test_assert_almost_equal_and_almost_equal():
    a = np.array([1.0, 2.0], np.float32)
    for tu, m in ((mx.test_utils, mx), (jmx.test_utils, jmx)):
        tu.assert_almost_equal(m.nd.array(a), a * (1 + 5e-5))
        assert tu.almost_equal(a, a * (1 + 5e-5))
        assert not tu.almost_equal(a, a * 1.01)
        with pytest.raises(AssertionError, match="x vs y"):
            tu.assert_almost_equal(a, a + 1, names=("x", "y"))
        assert tu.same(m.nd.array(a), a)
        tu.assert_exception(lambda: 1 / 0, ZeroDivisionError)
        with pytest.raises(AssertionError, match="did not raise"):
            tu.assert_exception(lambda: 1, ZeroDivisionError)


def test_rand_helpers_draw_from_the_seeded_host_generator():
    mx.random.seed(5)
    jmx.random.seed(5)
    got = mx.test_utils.rand_ndarray((3, 4), dtype="float32", low=-2,
                                     high=2)
    assert got.shape == (3, 4) and got.dtype == np.float32
    assert got.context == mx.cpu()
    assert ((got.asnumpy() >= -2) & (got.asnumpy() < 2)).all()
    s2, s3 = mx.test_utils.rand_shape_2d(5, 6), \
        mx.test_utils.rand_shape_3d(2, 3, 4)
    assert len(s2) == 2 and all(1 <= v <= w for v, w in zip(s2, (5, 6)))
    assert len(s3) == 3 and all(1 <= v <= w for v, w in zip(s3, (2, 3, 4)))
    mx.test_utils.set_default_context(mx.cpu(0))
    try:
        assert mx.test_utils.default_context() == mx.cpu(0)
    finally:
        mx.test_utils.set_default_context(None)


def test_check_numeric_gradient_as_the_reference():
    x = np.random.RandomState(0).rand(2, 3).astype(np.float32) + 0.5
    w = np.random.RandomState(1).rand(3, 2).astype(np.float32)
    for tu, m in ((mx.test_utils, mx), (jmx.test_utils, jmx)):
        tu.check_numeric_gradient(
            lambda a: m.nd.tanh(m.nd.dot(a[0], a[1])) * m.nd.log(a[0]).sum(),
            [x.copy(), w.copy()])
        with pytest.raises(AssertionError, match="gradient mismatch"):
            tu.check_numeric_gradient(
                lambda a: m.nd.BlockGrad(a[0] * a[0]) + a[0], [x.copy()])


def test_check_consistency_defaults_to_the_host_and_a_card():
    x = np.random.RandomState(2).rand(3, 4).astype(np.float32)
    res = mx.test_utils.check_consistency(
        lambda a: nd.softmax(nd.FullyConnected(a[0], a[1], num_hidden=2,
                                               no_bias=True)),
        [x, np.random.RandomState(3).rand(2, 4).astype(np.float32)])
    assert len(res) == 1 + mx.context.num_gpus()
    ref = jmx.test_utils.check_consistency(
        lambda a: jmx.nd.softmax(jmx.nd.FullyConnected(
            a[0], a[1], num_hidden=2, no_bias=True)),
        [x, np.random.RandomState(3).rand(2, 4).astype(np.float32)],
        ctx_list=[jmx.cpu(0)])
    np.testing.assert_allclose(res[0][0], ref[0][0], rtol=1e-5)
    for g, rg in zip(res[0][1], ref[0][1]):
        np.testing.assert_allclose(g, rg, rtol=1e-5, atol=1e-7)
    two = mx.test_utils.check_consistency(lambda a: a[0] * 3.0, [x],
                                          ctx_list=[mx.cpu(0), mx.cpu(0)],
                                          grad=False)
    assert len(two) == 2 and two[1][1] == []


def test_list_gpus():
    assert mx.test_utils.list_gpus() == list(range(torch.cuda.device_count()))


def _sym(m):
    return m.sym.tanh(m.sym.FullyConnected(m.sym.var("data"), num_hidden=3,
                                           name="fc"))


def test_check_symbolic_forward_and_backward_as_the_reference():
    rng = np.random.RandomState(4)
    inputs = [rng.rand(2, 5).astype(np.float32),
              rng.rand(3, 5).astype(np.float32),
              rng.rand(3).astype(np.float32)]
    head = [rng.rand(2, 3).astype(np.float32)]
    y = np.tanh(inputs[0] @ inputs[1].T + inputs[2])
    gy = head[0] * (1 - y ** 2)
    want = [gy @ inputs[1], gy.T @ inputs[0], gy.sum(0)]
    for tu, m in ((mx.test_utils, mx), (jmx.test_utils, jmx)):
        outs = tu.check_symbolic_forward(_sym(m), inputs, [y], rtol=1e-5,
                                         atol=1e-6)
        assert len(outs) == 1
        grads = tu.check_symbolic_backward(_sym(m), inputs, head, want,
                                           rtol=1e-5, atol=1e-6)
        assert len(grads) == 3
        with pytest.raises(AssertionError):
            tu.check_symbolic_forward(_sym(m), inputs, [y + 1.0])
        tu.check_symbolic_backward(_sym(m), inputs, head, [None, None,
                                                           want[2]],
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("check", ["forward", "backward"])
def test_check_symbolic_binds_on_the_current_context(check):
    """The executor binds on the current context: the CPU under ``with
    mx.cpu():`` (this file's fixture), the card under ``with mx.gpu(0):``,
    which raises ``MXNetError`` on a host without one."""
    rng = np.random.RandomState(5)
    inputs = [rng.rand(2, 5).astype(np.float32),
              rng.rand(3, 5).astype(np.float32),
              rng.rand(3).astype(np.float32)]
    y = np.tanh(inputs[0] @ inputs[1].T + inputs[2])
    tu = mx.test_utils

    def run():
        if check == "forward":
            return tu.check_symbolic_forward(_sym(mx), inputs, [y],
                                             rtol=1e-5, atol=1e-6)
        return tu.check_symbolic_backward(_sym(mx), inputs, [np.ones_like(y)],
                                          [None, None, None])

    assert all(o.context == mx.cpu() for o in run())
    with mx.gpu(0):
        if torch.cuda.is_available():
            assert all(o.context == mx.gpu(0) for o in run())
        else:
            with pytest.raises(mx.MXNetError):
                run()


# -- util ----------------------------------------------------------------------
def test_util_np_scope():
    util = mx.util
    assert not util.is_np_array()
    with util.np_array():
        assert util.is_np_array() and util.is_np_shape()
    assert not util.is_np_array()

    @util.use_np
    def inner():
        return util.is_np_array()
    assert inner() is True and not util.is_np_array()
    for deco in (util.use_np_array, util.use_np_shape):
        assert deco(inner)() is True
    with util.np_shape(False):
        assert not util.is_np_array()
    assert mx.lr_scheduler is not None and hasattr(mx.lr_scheduler,
                                                   "FactorScheduler")


def test_use_np_on_a_block_class_keeps_it_a_class():
    seen = []

    @mx.util.use_np
    class Net(mx.gluon.HybridBlock):
        def forward(self, x):
            seen.append(mx.util.is_np_array())
            return x * 2

    assert isinstance(Net, type) and issubclass(Net, mx.gluon.HybridBlock)
    out = Net()(nd.ones((2,)))
    assert seen == [True] and not mx.util.is_np_array()
    np.testing.assert_array_equal(out.asnumpy(), [2, 2])


def test_util_getenv_setenv(monkeypatch):
    monkeypatch.delenv("TPUMX_UTIL_PROBE", raising=False)
    for util in (mx.util, jmx.util):
        assert util.getenv("TPUMX_UTIL_PROBE") is None
        util.setenv("TPUMX_UTIL_PROBE", 42)
        assert util.getenv("TPUMX_UTIL_PROBE") == 42
        util.setenv("TPUMX_UTIL_PROBE", "on")
        assert util.getenv("TPUMX_UTIL_PROBE") == "on"
        monkeypatch.delenv("TPUMX_UTIL_PROBE")


# -- registries, check, get_env ---------------------------------------------
def test_registry_as_the_reference():
    for base in (mx.base, jmx.base):
        reg = base.Registry("thing")

        @reg.register
        class Alpha:
            def __init__(self, v=1):
                self.v = v

        @reg.register(name="b2", aliases=("Beta", "bb"))
        class Beta:
            pass
        assert reg.keys() == ["alpha", "b2", "bb", "beta"]
        assert "ALPHA" in reg and "gamma" not in reg
        assert reg.get("Bb") is Beta
        assert reg.create("alpha", v=3).v == 3
        with pytest.raises(KeyError, match="thing registry has no entry"):
            reg.get("gamma")


def test_check_and_get_env(monkeypatch):
    for base in (mx.base, jmx.base):
        base.check(True)
        with pytest.raises(base.MXNetError, match="bad"):
            base.check(False, "bad")
        monkeypatch.setenv("TPUMX_PROBE", "7")
        assert base.get_env("TPUMX_PROBE", dtype=int) == 7
        monkeypatch.setenv("TPUMX_PROBE", "Yes")
        assert base.get_env("TPUMX_PROBE", dtype=bool) is True
        monkeypatch.delenv("TPUMX_PROBE")
        assert base.get_env("TPUMX_PROBE", default=3.5) == 3.5


def test_metric_registry_is_the_references_and_create_reads_it():
    assert mx.metric.registry.keys() == jmx.metric.registry.keys()
    for key in mx.metric.registry.keys():
        assert type(mx.metric.create(key)).__name__ == \
            type(jmx.metric.create(key)).__name__, key
    assert isinstance(mx.metric.registry, mx.base.Registry)

    @mx.metric.registry.register(name="probe_metric")
    class Probe(mx.metric.EvalMetric):
        def __init__(self):
            super().__init__("probe")
    try:
        assert isinstance(mx.metric.create("PROBE_METRIC"), Probe)
    finally:
        mx.metric.registry._entries.pop("probe_metric")
    with pytest.raises(mx.MXNetError, match="not registered"):
        mx.metric.create("bleu")


# -- gluon.utils ---------------------------------------------------------
def test_check_sha1(tmp_path):
    p = tmp_path / "blob.bin"
    data = np.random.RandomState(0).bytes(3 << 20)
    p.write_bytes(data)
    digest = hashlib.sha1(data).hexdigest()
    for utils in (mx.gluon.utils, jmx.gluon.utils):
        assert utils.check_sha1(str(p), digest)
        assert not utils.check_sha1(str(p), "0" * 40)


def test_download_refuses_a_file_url_as_the_reference(tmp_path):
    src = tmp_path / "w.txt"
    src.write_text("weights")
    url = src.as_uri()
    for utils in (mx.gluon.utils, jmx.gluon.utils):
        with pytest.raises(RuntimeError, match="network access"):
            utils.download(url, path=str(tmp_path / "out.txt"))
    assert not (tmp_path / "out.txt").exists()
