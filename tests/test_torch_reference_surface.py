"""The port's imperative surface against the reference: faults C8–C16.

On the CPU, at small sizes, inputs made with numpy from a seed and fed
to both packages:

- C13: the models and ``CompiledTrainStep`` follow the current context
  (``device=None``), as the ``nd.*`` operators and Gluon layers do;
- C8: ``out=`` of the elementwise operators writes into the array and
  returns it;
- C9: ``nd.Dropout`` on arrays reads ``autograd.is_training()`` and takes
  ``mode=`` and ``axes=``;
- C11: every parameter of every public function and class of each
  module pair is in the port, or in one allow-list below with a reason;
- C10: the detection operators and ``nd.RNN`` take arrays, and the
  reference's ``examples/ssd/train.py --smoke`` runs on the port through
  a module alias;
- C12: a layer's ``weight`` (``bias``, ``gamma``, ...) is the Gluon
  ``Parameter`` handle outside a forward;
- C15: a user's ``hybrid_forward`` gets arrays with the methods of the
  jax arrays the reference's traced path hands it (``astype``, ``size``,
  axis reductions, ...), and a loss written with them trains as the
  reference's does;
- C16: ``models.bert`` has the reference's ``bert_sharding_rules`` and
  ``bert_data_specs``, and ``examples/bert/pretrain.py`` and
  ``examples/moe/train_moe_lm.py`` run on the port through a module
  alias;
- ``examples/quantization/quantize_cnn.py`` and
  ``examples/estimator/train.py`` (``--smoke``) run on the port through a
  module alias, each with its own assertions.
"""
import importlib
import inspect
import math
import pkgutil
import runpy
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import tpu_mx as jmx
from tpu_mx import autograd as jag
from tpu_mx import gluon as jgluon
from tpu_mx import nd as jnd
from tpu_mx.ndarray.rnn_op import rnn_param_size as j_rnn_param_size

import tpu_mx_torch as mx
from tpu_mx_torch import autograd, gluon, nd, optimizer, serving
from tpu_mx_torch.base import MXNetError

ROOT = Path(__file__).resolve().parent.parent
CPU = mx.cpu()
OP_RTOL = 1e-5


@pytest.fixture(autouse=True)
def _host():
    torch.backends.mkldnn.enabled = False
    with CPU:
        yield


def _normal(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _close(got, want, rtol=OP_RTOL, msg=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, msg
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(1.0, np.abs(want).max()),
                               err_msg=msg)


# ---------------------------------------------------------------------------
# C13: the models follow the current context
# ---------------------------------------------------------------------------
BERT_CFG = dict(num_layers=1, units=16, hidden_size=32, num_heads=2,
                vocab_size=20, max_length=8, dropout=0.0)


def _bert():
    from tpu_mx_torch.models import BERTModel
    return BERTModel(BERT_CFG)


def _rnn_model():
    from tpu_mx_torch.models import RNNModel
    return RNNModel("lstm", 20, 8, 8, 1, dropout=0.0)


def _ssd():
    from tpu_mx_torch.models.ssd import SSD
    return SSD(3, sizes=[[0.2, 0.35], [0.5, 0.7]], ratios=[[1, 2, 0.5]] * 2,
               base_filters=(8, 16))


def _resnet_factory():
    from tpu_mx_torch.gluon.model_zoo import vision
    return vision.resnet18_v1(classes=4)


def _resnet_v2():
    from tpu_mx_torch.gluon.model_zoo import vision
    return vision.ResNetV2(vision.BasicBlockV2, [1, 1, 1, 1],
                           [8, 8, 16, 32, 64], classes=4)


def _train_step():
    from tpu_mx_torch.parallel import CompiledTrainStep
    net = gluon.nn.Dense(3, in_units=4)
    step = CompiledTrainStep(net, gluon.loss.HuberLoss(),
                             optimizer.create("sgd", learning_rate=0.1))
    assert step.device.type == "cpu"
    return net


@pytest.mark.parametrize("build", [_bert, _rnn_model, _ssd, _resnet_factory,
                                   _resnet_v2, _train_step],
                         ids=lambda f: f.__name__.strip("_"))
def test_models_build_in_the_current_context(build):
    net = build()
    devices = {p.device.type for p in net.parameters()}
    assert devices == {"cpu"}


def test_bert_from_numpy_takes_the_current_context():
    from tpu_mx_torch.models import BERTModel
    net = _bert()
    params = {p.name: p.data().asnumpy() for p in
              net.collect_params().values()}
    again = BERTModel.from_numpy(params, BERT_CFG)
    assert {p.device.type for p in again.parameters()} == {"cpu"}


# ---------------------------------------------------------------------------
# C8: out= writes into the array
# ---------------------------------------------------------------------------
def _imperative_lists():
    spec = importlib.util.spec_from_file_location(
        "_imperative_cases", ROOT / "tests" / "test_torch_imperative.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.UNARY


UNARY = _imperative_lists()
BINARY = ["add", "subtract", "multiply", "divide", "mod", "power",
          "maximum", "minimum", "hypot", "equal", "not_equal", "greater",
          "greater_equal", "lesser", "lesser_equal", "broadcast_add",
          "broadcast_mul", "elemwise_sub", "broadcast_div"]


@pytest.mark.parametrize("name", sorted(UNARY) + BINARY)
def test_out_writes_the_result_into_the_array(name):
    if name in UNARY:
        args = [UNARY[name]]
    else:
        args = [np.abs(_normal(3, 4, seed=1)) + 0.5, _normal(3, 4, seed=2)]
    want = jnd.zeros(args[0].shape)
    r = getattr(jnd, name)(*[jnd.array(a) for a in args], out=want)
    assert r is want
    got = nd.zeros(args[0].shape)
    before = got
    r = getattr(nd, name)(*[nd.array(a) for a in args], out=got)
    assert r is got is before
    _close(got.asnumpy(), want.asnumpy(), msg=name)


def test_out_keeps_an_attached_leaf_a_leaf():
    x = nd.array(_normal(3, 4))
    y = nd.zeros((3, 4))
    y.attach_grad()
    nd.exp(x, out=y)
    with autograd.record():
        z = (y * 2).sum()
    z.backward()
    _close(y.grad.asnumpy(), np.full((3, 4), 2.0))


# ---------------------------------------------------------------------------
# C9: nd.Dropout on arrays
# ---------------------------------------------------------------------------
def test_dropout_outside_training_is_the_identity_as_in_the_reference():
    for pkg in (nd, jnd):
        assert float(pkg.Dropout(pkg.ones((4, 4)), 0.5).sum().asscalar()) \
            == 16.0
    with autograd.record(train_mode=False):
        assert float(nd.Dropout(nd.ones((4, 4)), 0.5).sum().asscalar()) \
            == 16.0
    x = nd.ones((64, 64))
    for kept in (nd.Dropout(x, 0.5, mode="always"),
                 _recorded_dropout(x)):
        share = float((kept != 0).mean().asscalar())
        assert 0.4 < share < 0.6
        vals = kept.asnumpy()
        assert set(np.unique(vals)) <= {0.0, 2.0}
    ref = jnd.Dropout(jnd.ones((64, 64)), 0.5, mode="always").asnumpy()
    assert set(np.unique(ref)) == {0.0, 2.0}


def _recorded_dropout(x):
    with autograd.record():
        return nd.Dropout(x, 0.5)


def test_dropout_axes_share_one_draw_along_them():
    y = nd.Dropout(nd.ones((8, 32)), 0.5, mode="always", axes=(0,)).asnumpy()
    assert (y == y[:1]).all() and 0 < (y[0] != 0).mean() < 1
    ref = jnd.Dropout(jnd.ones((8, 32)), 0.5, mode="always",
                      axes=(0,)).asnumpy()
    assert (ref == ref[:1]).all()
    layer = gluon.nn.Dropout(0.5, axes=(1,))
    with autograd.record():
        z = layer(nd.ones((16, 8))).asnumpy()
    assert (z == z[:, :1]).all() and 0 < (z[:, 0] != 0).mean() < 1


# ---------------------------------------------------------------------------
# C11: every reference parameter is in the port, or allowed by name
# ---------------------------------------------------------------------------
# (port module, callable's qualified name, parameter) -> why it is absent
ALLOWED = {
    ("tpu_mx_torch.rtc", "Kernel", "fn"):
        "the reference's kernel is a Pallas function; the port's is CUDA C "
        "source compiled by nvcc (the Kernel holds its module and name)",
    ("tpu_mx_torch.rtc", "Kernel", "static_kwargs"):
        "Pallas static arguments; the port's scalars are get_kernel's",
    ("tpu_mx_torch.rtc", "Kernel.launch", "in_specs"):
        "Pallas BlockSpecs; a CUDA launch takes a grid and a block",
    ("tpu_mx_torch.rtc", "Kernel.launch", "out_specs"):
        "Pallas BlockSpecs; a CUDA launch takes a grid and a block",
    ("tpu_mx_torch.rtc", "Kernel.launch", "interpret"):
        "Pallas interpret mode; a CUDA kernel has no interpreter",
}


def _module_pairs():
    for info in pkgutil.walk_packages(mx.__path__, "tpu_mx_torch."):
        name = info.name
        ref = "tpu_mx" + name[len("tpu_mx_torch"):]
        try:
            yield importlib.import_module(name), importlib.import_module(ref)
        except ModuleNotFoundError:
            continue                    # no counterpart (device, _build)


def _params(fn):
    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return None
    return [p for p in sig.parameters.values()
            if p.kind not in (p.VAR_POSITIONAL, p.VAR_KEYWORD)]


def _forwarded(method):
    """An ``NDArray`` method form's parameters are its operator's."""
    if getattr(method, "__qualname__", "").startswith("_method."):
        from tpu_mx_torch.ndarray import ops
        return _params(getattr(ops, method.__name__))[1:]
    return None


def _pairs_of(pm, rm):
    for name in sorted(vars(pm)):
        p, r = getattr(pm, name), getattr(rm, name, None)
        if name.startswith("_") or r is None or not callable(p) \
                or not callable(r) \
                or getattr(p, "__module__", None) != pm.__name__:
            continue
        yield name, p, r
        if inspect.isclass(p) and inspect.isclass(r):
            for attr in sorted(vars(p)):
                pa, ra = vars(p)[attr], inspect.getattr_static(r, attr, None)
                if attr.startswith("_") or ra is None \
                        or not callable(pa) or not callable(ra):
                    continue
                yield f"{name}.{attr}", getattr(p, attr), getattr(r, attr)


def _missing():
    out = []
    for pm, rm in _module_pairs():
        for qual, p, r in _pairs_of(pm, rm):
            want = _params(r)
            have = _forwarded(p)
            if have is None:
                have = _params(p)
            if want is None or have is None:
                continue
            names = {q.name for q in have}
            out += [(pm.__name__, qual, q.name) for q in want
                    if q.name not in names and q.name != "self"]
    return out


def test_every_reference_parameter_is_in_the_port_or_allowed_by_name():
    missing = _missing()
    assert not [m for m in missing if m not in ALLOWED], \
        [m for m in missing if m not in ALLOWED]
    # the allow-list holds nothing the port has since taken
    assert not set(ALLOWED) - set(missing), set(ALLOWED) - set(missing)


# each argument C11 found dropped: its default is taken, and another value
# is implemented (a check) or refused by name
def _scheduled(opt):
    """``lr_scheduler`` took effect: it starts from the optimizer's rate
    and gives the rate of each update count (a ``Trainer``'s
    ``learning_rate`` reads it)."""
    trainer, opt = (opt, opt.optimizer) if hasattr(opt, "optimizer") \
        else (None, opt)
    if opt.lr_scheduler.base_lr != opt.lr or opt.lr != 0.4:
        return False
    rates = []
    for opt.num_update in (1, 3, 5):
        rates.append(opt._get_lr(0))
    return rates == [0.4, 0.2, 0.1] and \
        (trainer is None or trainer.learning_rate == 0.1)


C11_CASES = [
    ("optimizer", lambda v: optimizer.create("sgd", learning_rate=0.4,
                                             lr_scheduler=v), _scheduled,
     optimizer.lr_scheduler.FactorScheduler(step=2, factor=0.5)),
    ("optimizer", lambda v: optimizer.create("sgd", param_idx2name=v),
     lambda o: o.idx2name == {0: "w"}, {0: "w"}),
    # taken and read by nothing, as the reference takes it (A item 10)
    ("optimizer", lambda v: optimizer.create("sgd", sym=v),
     lambda o: (o.lr, o.wd, o.rescale_grad, o.lr_mult, o.wd_mult)
     == (0.01, 0.0, 1.0, {}, {}), object()),
    ("optimizer", lambda v: optimizer.create("sgd", begin_num_update=v),
     lambda o: o.num_update == 5, 5),
    ("trainer", lambda v: gluon.Trainer(gluon.nn.Dense(2, in_units=2)
                                        .collect_params(), "sgd",
                                        {"learning_rate": 0.4,
                                         "lr_scheduler": v}), _scheduled,
     optimizer.lr_scheduler.FactorScheduler(step=2, factor=0.5)),
    ("embedding", lambda v: nd.Embedding(nd.array([1.0, 0.0]),
                                         nd.ones((3, 2)), input_dim=v,
                                         output_dim=2, sparse_grad=True),
     lambda y: y.shape == (2, 2), 3),
    ("layernorm", lambda v: nd.LayerNorm(nd.array(_normal(2, 3, 4)),
                                         axis=v),
     lambda y: abs(float(y.mean(axis=1).abs().max().asscalar())) < 1e-5, 1),
    ("zeros_like", lambda v: nd.zeros_like(a=nd.ones(v)),
     lambda y: y.shape == (2,), (2,)),
    ("initializer", lambda v: mx.initializer.create("xavier", magnitude=v),
     lambda i: i.magnitude == 2, 2),
    ("attention", lambda v: mx.parallel.attention(
        torch.ones((1, 2, 4, 16)), torch.ones((1, 2, 4, 16)),
        torch.ones((1, 2, 4, 16)), dropout_rate=0.5,
        dropout_key=v), lambda y: y.shape == (1, 2, 4, 16),
     torch.tensor([3], dtype=torch.int32)),
    ("block_bytes", lambda v: serving.BlockAllocator(4, block_bytes=v),
     lambda a: a.ledger.block_bytes == 64
     and a.capacity_snapshot()["block_bytes"] == 64, 64),
    ("slo_boost", lambda v: serving.ContinuousBatchingScheduler(
        slo_boost=v), lambda s: s.slo_boost == 3.0
     and s._effective_weight("t", {"t"}) == 3.0, 3.0),
    ("bert_moe", lambda v: mx.models.bert.BERTEncoder(
        1, 8, 16, 2, 10, 8, moe_every=v, generator=torch.Generator()),
     lambda e: isinstance(e.layers[0], mx.models.bert.MoETransformerLayer),
     1),
    ("histogram", lambda v: mx.telemetry.histogram("t.x", buckets=v),
     lambda h: h.buckets == (0.1, 1.0), (0.1, 1.0)),
]


@pytest.mark.parametrize("case", C11_CASES, ids=[c[0] + str(i) for i, c in
                                                 enumerate(C11_CASES)])
def test_dropped_argument_is_taken_then_implemented_or_refused(case):
    _, call, check, value = case
    if check is None:
        with pytest.raises(MXNetError, match="ROADMAP"):
            call(value)
    else:
        out = call(value)
        if out is not None:
            assert check(out)


# ---------------------------------------------------------------------------
# C10: the detection operators and nd.RNN take arrays
# ---------------------------------------------------------------------------
def _boxes(rng, n, lo=0.0, hi=0.8):
    xy = rng.uniform(lo, hi, (n, 2))
    wh = rng.uniform(0.05, 0.3, (n, 2))
    return np.concatenate([xy, np.minimum(xy + wh, 1.0)], 1).astype(
        np.float32)


def _contrib_cases():
    rng = np.random.RandomState(4)
    a, b = _boxes(rng, 12).reshape(2, 6, 4), _boxes(rng, 8).reshape(2, 4, 4)
    n = 12
    rows = np.concatenate([rng.randint(0, 3, (2, n, 1)), rng.rand(2, n, 1),
                           _boxes(rng, 2 * n).reshape(2, n, 4)],
                          -1).astype(np.float32)
    anc = _boxes(rng, 20, 0.1, 0.7)[None]
    lab = np.array([[[0, 0.1, 0.1, 0.4, 0.4], [2, 0.5, 0.5, 0.9, 0.8],
                     [-1, -1, -1, -1, -1]]], np.float32)
    pred = rng.randn(1, 3, 20).astype(np.float32)
    prob = np.exp(pred) / np.exp(pred).sum(1, keepdims=True)
    loc = (rng.randn(1, 80) * 0.5).astype(np.float32)
    s = np.round(rng.rand(2, 5, 4), 1).astype(np.float32)
    return [
        ("box_iou", (a, b), dict(format="corner")),
        ("box_nms", (rows,), dict(overlap_thresh=0.5, coord_start=2,
                                  score_index=1)),
        ("MultiBoxPrior", (np.zeros((1, 3, 5, 7), np.float32),),
         dict(sizes=(0.5, 0.25), ratios=(1, 2))),
        ("MultiBoxTarget", (anc, lab, pred),
         dict(overlap_threshold=0.5, negative_mining_ratio=3.0)),
        ("MultiBoxDetection", (prob, loc, anc), dict(threshold=0.2)),
        ("bipartite_matching", (s,), dict(threshold=0.3)),
    ]


@pytest.mark.parametrize("case", _contrib_cases(), ids=lambda c: c[0])
def test_detection_operator_takes_arrays_and_holds_to_the_reference(case):
    name, args, kw = case
    want = getattr(jnd.contrib, name)(*[jnd.array(x) for x in args], **kw)
    got = getattr(nd.contrib, name)(*[nd.array(x) for x in args], **kw)
    wants = want if isinstance(want, (list, tuple)) else [want]
    gots = got if isinstance(got, (list, tuple)) else [got]
    assert len(gots) == len(wants)
    for g, w in zip(gots, wants):
        assert isinstance(g, nd.NDArray)
        _close(g.asnumpy(), w.asnumpy(), msg=name)


def test_rnn_operator_takes_arrays_and_holds_to_the_reference():
    rng = np.random.RandomState(0)
    size = j_rnn_param_size("lstm", 4, 6, 2, False)
    x = rng.rand(5, 3, 4).astype(np.float32)
    params = (rng.randn(size) * 0.4).astype(np.float32)
    h0, c0 = ((rng.randn(2, 3, 6) * 0.5).astype(np.float32)
              for _ in range(2))
    kw = dict(state_size=6, num_layers=2, mode="lstm", state_outputs=True)
    want = jnd.RNN(*[jnd.array(a) for a in (x, params, h0, c0)], **kw)
    got = nd.RNN(*[nd.array(a) for a in (x, params, h0, c0)], **kw)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert isinstance(g, nd.NDArray)
        _close(g.asnumpy(), w.asnumpy())


def test_the_ssd_example_trains_on_the_port_through_a_module_alias(
        monkeypatch, capsys):
    """``examples/ssd/train.py --smoke`` unedited, with ``tpu_mx`` mapped
    to the port: it trains (past the targets at :120), asserts its loss
    fell and decodes a detection."""
    import tpu_mx_torch.models
    import tpu_mx_torch.models.ssd
    for name, mod in (("tpu_mx", mx), ("tpu_mx.models", mx.models),
                      ("tpu_mx.models.ssd", mx.models.ssd)):
        monkeypatch.setitem(sys.modules, name, mod)
    monkeypatch.setattr(sys, "argv", ["train.py", "--smoke"])
    runpy.run_path(str(ROOT / "examples" / "ssd" / "train.py"),
                   run_name="__main__")
    out = capsys.readouterr().out
    assert "epoch 1: loss" in out and "detections: (1, " in out


# ---------------------------------------------------------------------------
# C12: a layer's weight is its Parameter handle
# ---------------------------------------------------------------------------
def _layers(pkg):
    g = pkg.gluon.nn
    return {
        "dense": (lambda: g.Dense(3, in_units=4), ("weight", "bias"),
                  _normal(2, 4, seed=1)),
        "conv2d": (lambda: g.Conv2D(3, 3, in_channels=2, padding=1),
                   ("weight", "bias"), _normal(1, 2, 5, 5, seed=2)),
        "batchnorm": (lambda: g.BatchNorm(in_channels=3),
                      ("gamma", "beta"), _normal(4, 3, 2, 2, seed=3)),
        "embedding": (lambda: g.Embedding(6, 4), ("weight",),
                      np.array([[1, 5], [0, 3]], np.float32)),
        "layernorm": (lambda: g.LayerNorm(in_channels=5), ("gamma", "beta"),
                      _normal(3, 5, seed=4)),
    }


class _Pkg:
    def __init__(self, gluon_, nd_, autograd_):
        self.gluon, self.nd, self.autograd = gluon_, nd_, autograd_


@pytest.mark.parametrize("kind", ["dense", "conv2d", "batchnorm",
                                  "embedding", "layernorm"])
def test_weight_is_the_parameter_handle_as_in_the_reference(kind):
    results = []
    for pkg in (_Pkg(jgluon, jnd, jag), _Pkg(gluon, nd, autograd)):
        build, leaves, x = _layers(pkg)[kind]
        net = build()
        net.initialize()
        for i, leaf in enumerate(leaves):
            w = getattr(net, leaf)
            w.set_data(pkg.nd.array(_normal(*w.shape, seed=10 + i)))
        with pkg.autograd.record():
            y = net(pkg.nd.array(x))
            loss = (y * y).sum()
        loss.backward()
        results.append({leaf: (getattr(net, leaf).data().asnumpy(),
                               getattr(net, leaf).grad.asnumpy(),
                               getattr(net, leaf).name)
                        for leaf in leaves})
    ref, port = results
    for leaf in ref:
        _close(port[leaf][0], ref[leaf][0], msg=f"{kind}.{leaf} data")
        _close(port[leaf][1], ref[leaf][1], 1e-4, msg=f"{kind}.{leaf} grad")
        assert port[leaf][2].split("_")[-1] == ref[leaf][2].split("_")[-1]


def test_the_forward_reads_tensors_and_the_handle_stands_for_the_slot():
    net = gluon.nn.Dense(3, in_units=4)
    net.initialize()
    w = net.weight
    assert isinstance(w, gluon.Parameter)
    assert w is net.collect_params()[net.prefix + "weight"]
    assert w.data()._data is net._parameters["weight"]
    assert isinstance(net(torch.ones((2, 4))), torch.Tensor)
    w.set_data(np.ones((3, 4), np.float32))
    assert torch.equal(net._parameters["weight"].detach(),
                       torch.ones((3, 4)))

    class Probe(gluon.HybridBlock):
        """A user block whose forward reads a child's weight."""

        def __init__(self):
            super().__init__()
            self.inner = gluon.nn.Dense(2, in_units=3)

        def forward(self, x):
            assert isinstance(self.inner.weight, torch.Tensor)
            return self.inner(x)

    probe = Probe()
    probe.initialize()
    assert math.isfinite(float(probe(torch.ones((1, 3))).sum()))
    assert isinstance(probe.inner.weight, gluon.Parameter)


# ---------------------------------------------------------------------------
# C15: hybrid_forward gets arrays with jax's array methods
# ---------------------------------------------------------------------------
def _mlm_loss_cls(gluon_pkg):
    """``examples/bert/pretrain.py``'s loss, written for either package."""
    class MLMLoss(gluon_pkg.loss.Loss):
        def __init__(self, **kwargs):
            super().__init__(weight=None, batch_axis=0, **kwargs)
            self._ce = gluon_pkg.loss.SoftmaxCrossEntropyLoss()

        def hybrid_forward(self, F, logits, labels):
            vocab = logits.shape[-1]
            flat_logits = F.reshape(logits, shape=(-1, vocab))
            flat_labels = F.reshape(labels, shape=(-1,))
            mask = flat_labels >= 0
            safe = F.where(mask, flat_labels, F.zeros_like(flat_labels))
            ce = self._ce(flat_logits, safe)
            ce = F.where(mask, ce, F.zeros_like(ce))
            return F.sum(ce) / F.maximum(F.sum(mask.astype("float32")), 1.0)
    return MLMLoss


def test_a_loss_calling_astype_trains_as_the_references():
    from tpu_mx.parallel import CompiledTrainStep as JStep
    rng = np.random.RandomState(0)
    w = (rng.randn(10, 6) * 0.3).astype(np.float32)
    b = (rng.randn(10) * 0.1).astype(np.float32)
    x = rng.randn(3, 5, 6).astype(np.float32)
    labels = np.where(rng.rand(3, 5) < 0.4, rng.randint(0, 10, (3, 5)),
                      -1).astype(np.float32)
    ref = jgluon.nn.Dense(10, in_units=6, flatten=False)
    ref.initialize()
    ref.weight.set_data(jnd.array(w))
    ref.bias.set_data(jnd.array(b))
    port = gluon.nn.Dense(10, in_units=6, flatten=False)
    port.weight.set_data(nd.array(w))
    port.bias.set_data(nd.array(b))
    jstep = JStep(ref, _mlm_loss_cls(jgluon)(),
                  jmx.optimizer.create("sgd", learning_rate=0.5))
    pstep = mx.parallel.CompiledTrainStep(
        port, _mlm_loss_cls(gluon)(),
        optimizer.create("sgd", learning_rate=0.5))
    for _ in range(2):
        want = float(jstep.step(jnd.array(x), jnd.array(labels)).asnumpy())
        got = float(pstep.step(torch.from_numpy(x),
                               torch.from_numpy(labels)))
        assert abs(got - want) <= OP_RTOL * abs(want)
    jstep.sync_to_net()
    _close(port.weight.data().asnumpy(), ref.weight.data().asnumpy())
    _close(port.bias.data().asnumpy(), ref.bias.data().asnumpy())


def _jax_methods():
    import jax.numpy as jnp
    idx = np.array([2, 0])
    return [
        ("astype", lambda a: a.astype("float32") * 2),
        ("astype_int", lambda a: (a > 0).astype("int32") + 1),
        ("size", lambda a: a * a.size),
        ("T", lambda a: a.T),
        ("transpose", lambda a: a.transpose(2, 0, 1)),
        ("transpose_tuple", lambda a: a.transpose((1, 0, 2))),
        ("sum_axis", lambda a: a.sum(axis=1, keepdims=True)),
        ("sum_axes", lambda a: a.sum(axis=(0, 2))),
        ("mean", lambda a: a.mean()),
        ("max_axis", lambda a: a.max(axis=-1)),
        ("min_keep", lambda a: a.min(axis=0, keepdims=True)),
        ("argmax", lambda a: a.argmax(axis=1) * 1.0),
        ("std", lambda a: a.std(axis=2)),
        ("var", lambda a: a.var()),
        ("prod_axes", lambda a: a.prod(axis=(1, 2))),
        ("cumsum_flat", lambda a: a.cumsum()),
        ("cumsum_axis", lambda a: a.cumsum(axis=1)),
        ("repeat", lambda a: a.repeat(2, axis=1)),
        ("repeat_flat", lambda a: a.repeat(3)),
        ("take", lambda a: a.take(jnp.asarray(idx) if isinstance(
            a, jnp.ndarray) else torch.from_numpy(idx), axis=2)),
        ("sort", lambda a: a.sort(axis=1)),
        ("ptp", lambda a: a.ptp(axis=0)),
        ("copy", lambda a: a.copy() + 1),
        ("at_set", lambda a: a.at[0, 1].set(5.0)),
        ("at_add", lambda a: a.at[:, 0].add(1.0)),
        ("all_any", lambda a: (a > -3).all(axis=1).astype("float32")
         + (a > 1).any(axis=0).sum()),
        ("nonzero", lambda a: a.reshape(-1)[(a.reshape(-1) > 0).nonzero()
                                            [0]]),
        ("dot", lambda a: a[0].dot(a[1].T)),
    ]


@pytest.mark.parametrize("name,fn", _jax_methods(),
                         ids=[n for n, _ in _jax_methods()])
def test_hybrid_forward_arrays_have_the_jax_methods(name, fn):
    import jax.numpy as jnp

    class Probe(gluon.block.HybridBlock):
        def hybrid_forward(self, F, x):
            return fn(x)

    x = _normal(2, 3, 4, seed=5)
    want = np.asarray(fn(jnp.asarray(x)))
    got = Probe()(torch.from_numpy(x))
    assert type(got) is torch.Tensor         # the caller gets a tensor
    _close(got.numpy(), want, msg=name)


def test_blocks_called_from_hybrid_forward_run_plain_and_answer_in_kind():
    seen = []

    class Inner(gluon.block.HybridBlock):
        def forward(self, x):
            seen.append(type(x))
            return x * 2

    class Outer(gluon.block.HybridBlock):
        def __init__(self):
            super().__init__()
            self.inner = Inner()

        def hybrid_forward(self, F, x):
            y = self.inner(x)
            return y.astype("float32").sum(axis=0)

    out = Outer()(torch.ones(3, 2))
    assert seen == [torch.Tensor] and type(out) is torch.Tensor
    assert out.tolist() == [6.0, 6.0]


# ---------------------------------------------------------------------------
# C16: the BERT rules, and the BERT and MoE examples through the alias
# ---------------------------------------------------------------------------
def test_the_bert_rules_and_specs_are_the_references():
    from tpu_mx.models import bert as jbert
    from tpu_mx_torch.models.bert import bert_data_specs, bert_sharding_rules
    got, want = bert_sharding_rules(), jbert.bert_sharding_rules()
    assert len(got) == len(want)
    for (gr, gs), (wr, ws) in zip(got, want):
        assert gr == wr and gs == ws and tuple(gs) == tuple(ws)
    assert all(g == w for g, w in zip(bert_data_specs(),
                                      jbert.bert_data_specs()))


def _alias_port(monkeypatch):
    import tpu_mx_torch.gluon.block
    import tpu_mx_torch.gluon.nn
    import tpu_mx_torch.models.bert
    import tpu_mx_torch.parallel
    for name, mod in (("tpu_mx", mx), ("tpu_mx.gluon", mx.gluon),
                      ("tpu_mx.gluon.nn", mx.gluon.nn),
                      ("tpu_mx.gluon.block", mx.gluon.block),
                      ("tpu_mx.models", mx.models),
                      ("tpu_mx.models.bert", mx.models.bert),
                      ("tpu_mx.parallel", mx.parallel)):
        monkeypatch.setitem(sys.modules, name, mod)


def test_the_bert_example_trains_on_the_port_through_a_module_alias(
        monkeypatch, capsys):
    """``examples/bert/pretrain.py --smoke`` unedited (2 layers, units
    128, seq 128, batch 8, 10 LAMB steps in bfloat16): its own assertion
    that the loss falls holds."""
    _alias_port(monkeypatch)
    monkeypatch.setattr(sys, "argv", ["pretrain.py", "--smoke"])
    runpy.run_path(str(ROOT / "examples" / "bert" / "pretrain.py"),
                   run_name="__main__")
    out = capsys.readouterr().out
    assert "seq/s" in out and "->" in out


def test_the_moe_example_trains_on_the_port_through_a_module_alias(
        monkeypatch, capsys):
    """``examples/moe/train_moe_lm.py --smoke`` unedited (4 experts,
    top-2, 40 Adam steps): it reads each loss as
    ``np.asarray(l._data)`` and asserts the loss falls."""
    _alias_port(monkeypatch)
    monkeypatch.setattr(sys, "argv", ["train_moe_lm.py", "--smoke"])
    runpy.run_path(str(ROOT / "examples" / "moe" / "train_moe_lm.py"),
                   run_name="__main__")
    out = capsys.readouterr().out
    assert "single device" in out


# ---------------------------------------------------------------------------
# the quantization and estimator examples through the alias
# ---------------------------------------------------------------------------
def _alias(monkeypatch, *names):
    import importlib
    monkeypatch.setitem(sys.modules, "tpu_mx", mx)
    for n in names:
        monkeypatch.setitem(sys.modules, "tpu_mx." + n,
                            importlib.import_module("tpu_mx_torch." + n))


def test_the_quantization_example_runs_on_the_port_through_a_module_alias(
        monkeypatch, capsys):
    """``examples/quantization/quantize_cnn.py --smoke`` unedited (30
    Adam steps, 4 calibration batches, ``quantize_net`` of its two convs
    and two Dense layers): its own check that int8 accuracy is within 2%
    of float32 passes."""
    _alias(monkeypatch, "gluon", "gluon.nn", "contrib",
           "contrib.quantization")
    monkeypatch.setattr(sys, "argv", ["quantize_cnn.py", "--smoke"])
    # one intra-op thread: with oneDNN off, the example's native
    # convolution backward spins on its idle threads when the suite's
    # workers share the cores (10 s alone, ~600 s among them)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        runpy.run_path(str(ROOT / "examples" / "quantization" /
                           "quantize_cnn.py"), run_name="__main__")
    finally:
        torch.set_num_threads(threads)
    out = capsys.readouterr().out
    assert "PASSED" in out and "int8/float argmax agreement" in out


def test_the_estimator_example_runs_on_the_port_through_a_module_alias(
        monkeypatch, capsys):
    """``examples/estimator/train.py --smoke`` unedited (512 samples, two
    forked DataLoader workers, the Estimator with logging, best
    checkpointing and early stopping): its asserts hold (loss < 0.45,
    accuracy > 0.8, a ``best`` checkpoint)."""
    _alias(monkeypatch, "gluon", "gluon.nn", "gluon.data", "gluon.contrib",
           "gluon.contrib.estimator")
    monkeypatch.setattr(sys, "argv", ["train.py", "--smoke"])
    runpy.run_path(str(ROOT / "examples" / "estimator" / "train.py"),
                   run_name="__main__")
    out = capsys.readouterr().out
    assert "eval loss" in out and "model-best.params" in out
