"""Faults C17 and C18, on the CPU.

C17: the reference's public module names and class members that the
port lacked.  A walker goes over every module the two packages share
and lists each public name the reference defines there (a function,
class or constant of that module) and each public member of a class
both define, that the port does not have.  Every such absence must be
in ``ALLOWED``, which gives its reason: a jax-only mechanism, or a name
an open ROADMAP A item ports (the item is named).  The members C17
added are then held to the reference by behaviour.

C18: ``nd.random.normal`` with an array ``loc``/``scale`` broadcasts,
as the reference's does.
"""
import importlib
import inspect
import pkgutil

import numpy as np
import pytest
import torch

import tpu_mx as jmx
from tpu_mx import nd as jnd

import tpu_mx_torch as mx
from tpu_mx_torch import gluon, nd

JAX = "jax-only: "


ALLOWED = {
    ("tpu_mx_torch.context", "Context.jax_device"):
        JAX + "the jax Device of a context; the port's is torch_device",
    ("tpu_mx_torch.parallel.train_step", "CompiledTrainStep.aot_compiled"):
        JAX + "the step's ahead-of-time compiled XLA program",
    ("tpu_mx_torch.initializer", "Initializer.device_sample"):
        JAX + "a draw from a jax PRNG key on the device; the port draws "
        "from torch.Generators",
    ("tpu_mx_torch.random", "KeyHolder"): JAX + "the PRNG key stream",
    ("tpu_mx_torch.random", "key_scope"): JAX + "the PRNG key stream",
    ("tpu_mx_torch.random", "take_key"): JAX + "the PRNG key stream",
    ("tpu_mx_torch.rtc", "PallasModule"):
        JAX + "Pallas kernels; the port's user kernels are CUDA C "
        "(CudaModule)",
    ("tpu_mx_torch.kernels.flash_attention", "MAX_BLOCK_ELEMS"):
        JAX + "the Pallas kernels' VMEM tile cap",
    ("tpu_mx_torch.kernels.flash_attention", "supported"):
        JAX + "the TPU kernels' shape gate; the port's is card_dense_arm",
    ("tpu_mx_torch.kernels.paged_attention", "supported"):
        JAX + "the TPU kernel's shape gate; the port's is in the wrapper",
    ("tpu_mx_torch.gluon.parameter", "param_substitution"):
        JAX + "swaps raw jax values into a hybridize trace; the port's "
        "hybridize runs the eager forward",
    ("tpu_mx_torch.gluon.rnn.rnn_layer", "rnn_fused_core"):
        JAX + "the scan core keyed by a PRNG key; the port's recurrence is "
        "ndarray.rnn_op.recurrence",
    ("tpu_mx_torch.serving.jax_model", "JaxTinyLM"):
        JAX + "the jitted whole-step decode program; the port's fused arm "
        "is TinyLM.decode_step",
}


def _public(rm, name, value):
    """A public name the reference defines in module ``rm``: a function or
    class of that module, or a constant (not an imported module, not a
    ``__future__`` feature, not another module's function)."""
    if name.startswith("_") or inspect.ismodule(value) \
            or type(value).__module__ == "__future__":
        return False
    mod = getattr(value, "__module__", None)
    return not (callable(value) and mod is not None and mod != rm.__name__)


def _absences():
    out = []
    for info in pkgutil.walk_packages(mx.__path__, "tpu_mx_torch."):
        ref = "tpu_mx" + info.name[len("tpu_mx_torch"):]
        try:
            pm = importlib.import_module(info.name)
            rm = importlib.import_module(ref)
        except ModuleNotFoundError:
            continue                    # no counterpart (device, _build)
        for name, r in sorted(vars(rm).items()):
            if not _public(rm, name, r):
                continue
            if not hasattr(pm, name):
                out.append((info.name, name))
                continue
            p = getattr(pm, name)
            if inspect.isclass(r) and inspect.isclass(p):
                out += [(info.name, f"{name}.{a}") for a in sorted(vars(r))
                        if not a.startswith("_")
                        and inspect.getattr_static(p, a, None) is None]
    return out


def test_every_reference_member_is_in_the_port_or_allowed_with_a_reason():
    missing = _absences()
    assert not [m for m in missing if m not in ALLOWED], \
        [m for m in missing if m not in ALLOWED]
    # the allow-list holds nothing the port has since taken
    assert not set(ALLOWED) - set(missing), set(ALLOWED) - set(missing)
    assert all(r.startswith(JAX) or "ROADMAP A item" in r
               for r in ALLOWED.values())


# -- the members C17 added, held to the reference -----------------------------
@pytest.fixture(autouse=True)
def _host():
    with mx.cpu():
        yield


X = np.random.RandomState(0).uniform(0.2, 3.0, (3, 4)).astype(np.float32)


@pytest.mark.parametrize("method,args", [
    ("log1p", ()), ("expm1", ()), ("log10", ()), ("log2", ()),
    ("reciprocal", ()), ("rint", ()), ("rsqrt", ()), ("cbrt", ()),
    ("sort", ()), ("argsort", ()), ("topk", ()), ("diag", ()),
    ("slice", ((0, 1), (2, 3))), ("slice_like", ("like",)),
    ("pad", ("constant", (0, 0, 1, 2)))])
def test_ndarray_method_matches_the_references(method, args):
    def call(ndm):
        a = ndm.array(X)
        resolved = [ndm.array(X[:2, :3]) if v == "like" else v
                    for v in args]
        if method == "pad":
            return getattr(a, method)(mode=args[0], pad_width=args[1])
        return getattr(a, method)(*resolved)
    got, want = call(nd).asnumpy(), call(jnd).asnumpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_ndarray_handle_dlpack_and_storage_type():
    a = nd.array(X)
    assert a.handle is a._data and a.as_nd_ndarray() is a
    assert a.tostype("default") is a
    for stype in ("row_sparse", "csr"):
        got, want = a.tostype(stype), jnd.array(X).tostype(stype)
        assert got.stype == want.stype == stype
        np.testing.assert_array_equal(got.asnumpy(), want.asnumpy())
    with pytest.raises(ValueError, match="unknown storage type"):
        a.tostype("dense")
    with pytest.raises(ValueError, match="unknown storage type"):
        jnd.array(X).tostype("dense")
    back = torch.utils.dlpack.from_dlpack(a.to_dlpack_for_read())
    assert back.data_ptr() == a._data.data_ptr()
    assert a.to_dlpack_for_write is not None


def test_register_child_and_summary_match_the_references():
    class RefPair(jmx.gluon.Block):
        def __init__(self):
            super().__init__()
            self.register_child(jmx.gluon.nn.Dense(3, in_units=4))
            self.register_child(jmx.gluon.nn.Dense(2, in_units=3), "head")

        def forward(self, x):
            for child in self._children.values():
                x = child(x)
            return x

    class Pair(gluon.Block):
        def __init__(self):
            super().__init__()
            self.register_child(gluon.nn.Dense(3, in_units=4))
            self.register_child(gluon.nn.Dense(2, in_units=3), "head")

        def forward(self, x):
            for child in self.children():
                x = child(x)
            return x

    ref, port = RefPair(), Pair()
    ref.initialize()
    port.initialize()
    assert [n for n, _ in port.named_children()] == \
        list(ref._children) == ["0", "head"]
    assert port.summary(nd.array(X)) == "Pair: params=23"
    assert ref.summary(jnd.array(X)) == "RefPair: params=23"
    assert len(port.collect_params()) == 4


@pytest.mark.parametrize("how", ["index", "name", "param_dict_wins"])
def test_lr_and_wd_multipliers_by_index_and_name(how):
    def rates(pkg):
        kw = {"learning_rate": 0.1, "wd": 0.01}
        if how == "name":
            kw["param_idx2name"] = {0: "w0", 1: "w1"}
        opt = pkg.optimizer.create("sgd", **kw)
        key = (lambda i: f"w{i}") if how == "name" else (lambda i: i)
        opt.set_lr_mult({key(0): 0.5})
        opt.set_wd_mult({key(1): 3.0})
        if how == "param_dict_wins":
            p = pkg.gluon.Parameter("w", shape=(2,))
            p.lr_mult, p.wd_mult = 2.0, 4.0
            opt.param_dict = {0: p, 1: p}
        return [(opt._get_lr(i), opt._get_wd(i)) for i in range(3)]
    got, want = rates(mx), rates(jmx)
    np.testing.assert_allclose(got, want, rtol=1e-12)
    if how != "param_dict_wins":
        assert got[0][0] == pytest.approx(0.05) and \
            got[1][1] == pytest.approx(0.03)


def test_sync_from_net_rederives_the_masters_and_drops_accumulation():
    from tpu_mx_torch import optimizer
    from tpu_mx_torch.parallel import CompiledTrainStep
    net = gluon.nn.Dense(2, in_units=3)
    net.initialize()
    net.cast("bfloat16")
    step = CompiledTrainStep(net, gluon.loss.L2Loss(),
                             optimizer.create("sgd", learning_rate=0.1,
                                              multi_precision=True),
                             device="cpu", accum_steps=2)
    x = torch.randn(4, 3, generator=torch.Generator().manual_seed(0)) \
        .bfloat16()
    y = torch.zeros(4, 2)
    step.sync_from_net()                  # before the first step: nothing
    step.step(x, y)
    assert step._micro == 1
    w = net.weight.data()._data
    with torch.no_grad():
        w.copy_(torch.full_like(w, 0.25))    # the net restored elsewhere
    step.sync_from_net()
    key = next(k for k in step.masters if k.endswith("weight"))
    assert step._micro == 0 and (step.masters[key] == 0.25).all()
    assert all((b == 0).all() for b in step._gacc.values())


def test_cache_stats_and_tenancy_members_match_the_references():
    from tpu_mx.serving import kv_cache as jkv
    from tpu_mx.serving import tenancy as jten
    from tpu_mx_torch.serving import kv_cache, tenancy
    ref = jkv.PagedKVCache(num_layers=1, num_heads=2, head_dim=4,
                           block_size=4, num_blocks=8)
    port = kv_cache.PagedKVCache(num_layers=1, num_heads=2, head_dim=4,
                                 block_size=4, num_blocks=8, device="cpu")
    k = np.zeros((1, 6, 2, 4), np.float32)
    for cache, kv in ((ref, k), (port, torch.from_numpy(k))):
        assert cache.num_sequences() == 0
        cache.prefill("a", kv, kv)
        cache.prefill("b", kv[:, :3], kv[:, :3])
    assert port.num_sequences() == ref.num_sequences() == 2
    assert port.stats() == ref.stats()
    table = {"t1": {"weight": 2.0}, "t2": {}}
    assert tenancy.TenantTable.coerce(table).configured() == \
        jten.TenantTable.coerce(table).configured() == ["t1", "t2"]
    for i in range(tenancy.TENANT_LABEL_CAP + 1):
        tenancy.label_for(f"x{i}")
    assert tenancy.label_for("late") == tenancy.OVERFLOW_LABEL
    tenancy.reset_label_registry()
    assert tenancy.label_for("late") == "late"
    tenancy.reset_label_registry()


# -- C18 ----------------------------------------------------------------------
def test_normal_broadcasts_array_loc_and_scale():
    loc = np.arange(6, dtype=np.float32).reshape(2, 3)
    want = jnd.random.normal(loc=jnd.array(loc), scale=1.0, shape=(2, 3))
    got = nd.random.normal(loc=nd.array(loc), scale=1.0, shape=(2, 3))
    assert got.shape == want.shape == (2, 3)
    assert str(got.dtype) == str(want.dtype) == "float32"
    scale = nd.array(np.asarray([[0.0], [1.0]], np.float32))
    s = nd.random.normal(loc=0.0, scale=scale, shape=(2, 3)).asnumpy()
    assert (s[0] == 0).all() and (s[1] != 0).all()


def test_normal_with_zero_scale_returns_loc_exactly():
    loc = np.random.RandomState(1).randn(2, 3).astype(np.float32)
    for ndm in (nd, jnd):
        got = ndm.random.normal(loc=ndm.array(loc), scale=0.0,
                                shape=(2, 3)).asnumpy()
        np.testing.assert_array_equal(got, loc)
    got = nd.normal(loc=nd.array(loc), scale=nd.zeros((2, 3)),
                    shape=(2, 3)).asnumpy()
    np.testing.assert_array_equal(got, loc)
