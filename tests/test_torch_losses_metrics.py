"""The port's losses and metrics against the reference, on the CPU.

Each loss of ``gluon.loss`` on the same numpy inputs in both packages:
its values (with and without ``sample_weight``, at another
``batch_axis``, through each option) and the gradient of every input,
at ``OP_TOL`` of ``test_torch_resnet.py``, ``CTCLoss`` among them
(``test_torch_ctc.py`` holds its options).  Each metric of ``metric`` updated with the same batches in both
packages: its name and value, exact to 1e-6; ``create`` of every
registered name, a list and a function.
"""
import numpy as np
import pytest
import torch

from tpu_mx import autograd as jag
from tpu_mx import metric as jmetric
from tpu_mx import nd as jnd
from tpu_mx.gluon import loss as jloss

import tpu_mx_torch as tmx
from tpu_mx_torch import autograd, metric, nd
from tpu_mx_torch.base import MXNetError
from tpu_mx_torch.gluon import loss

OP_TOL = 1e-5       # test_torch_resnet.py: one f32 operator
METRIC_TOL = 1e-6


@pytest.fixture(autouse=True)
def _host():
    with tmx.cpu():
        yield


def _normal(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _close(got, want, tol=OP_TOL, msg=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, msg
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * max(1.0, np.abs(want).max()),
                               err_msg=msg)


def _loss_case(name, kw, inputs, call_kw=None):
    """``gluon.loss.<name>(**kw)`` of both packages on ``inputs``: the
    values, and the gradients of every input."""
    call_kw = call_kw or {}
    jin = [jnd.array(a) for a in inputs]
    tin = [nd.array(a) for a in inputs]
    for a in jin + tin:
        a.attach_grad()
    jkw = {k: jnd.array(v) for k, v in call_kw.items()}
    tkw = {k: nd.array(v) for k, v in call_kw.items()}
    with jag.record():
        jy = getattr(jloss, name)(**kw)(*jin, **jkw)
    with autograd.record():
        ty = getattr(loss, name)(**kw)(*tin, **tkw)
    _close(ty.asnumpy(), jy.asnumpy(), msg=name)
    jy.backward()
    ty.backward()
    for i, (j, t) in enumerate(zip(jin, tin)):
        _close(t.grad.asnumpy(), j.grad.asnumpy(), msg=f"{name} grad {i}")


PRED = _normal(4, 3, seed=1)
LABEL = _normal(4, 3, seed=2)
SIGNS = np.sign(_normal(4, 3, seed=3)).astype(np.float32)
BITS = (SIGNS > 0).astype(np.float32)
PROB = 1 / (1 + np.exp(-PRED))
WEIGHT = np.abs(_normal(4, 1, seed=4))
LOGP = np.log(np.exp(PRED) / np.exp(PRED).sum(1, keepdims=True))
DIST = np.exp(LABEL) / np.exp(LABEL).sum(1, keepdims=True)
COUNTS = np.abs(np.round(_normal(4, 3, seed=5) * 3)).astype(np.float32)

CASES = [
    ("L2Loss", {}, (PRED, LABEL), None),
    ("L2Loss", dict(weight=0.5, batch_axis=1), (PRED, LABEL), None),
    ("L2Loss", {}, (PRED, LABEL), dict(sample_weight=WEIGHT)),
    ("L1Loss", {}, (PRED, LABEL), None),
    ("L1Loss", dict(weight=2.0), (PRED, LABEL), dict(sample_weight=WEIGHT)),
    ("SigmoidBinaryCrossEntropyLoss", {}, (PRED * 4, BITS), None),
    ("SigmoidBinaryCrossEntropyLoss", dict(from_sigmoid=True),
     (PROB, BITS), dict(sample_weight=WEIGHT)),
    ("SigmoidBCELoss", dict(batch_axis=1), (PRED, BITS), None),
    ("KLDivLoss", {}, (LOGP, DIST), None),
    ("KLDivLoss", dict(from_logits=False, axis=1), (PRED, DIST),
     dict(sample_weight=WEIGHT)),
    ("HingeLoss", {}, (PRED, SIGNS), None),
    ("HingeLoss", dict(margin=0.5, weight=3.0), (PRED, SIGNS),
     dict(sample_weight=WEIGHT)),
    ("SquaredHingeLoss", {}, (PRED, SIGNS), None),
    ("SquaredHingeLoss", dict(margin=2.0, batch_axis=1), (PRED, SIGNS),
     None),
    ("LogisticLoss", {}, (PRED, SIGNS), None),
    ("LogisticLoss", dict(label_format="binary"), (PRED, BITS),
     dict(sample_weight=WEIGHT)),
    ("PoissonNLLLoss", {}, (PRED, COUNTS), None),
    ("PoissonNLLLoss", dict(from_logits=False, compute_full=True),
     (np.abs(PRED) + 0.1, COUNTS), dict(sample_weight=WEIGHT)),
    ("TripletLoss", {}, (PRED, LABEL, _normal(4, 3, seed=6)), None),
    ("TripletLoss", dict(margin=0.3), (PRED, LABEL, _normal(4, 3, seed=6)),
     dict(sample_weight=WEIGHT[:, 0])),
    ("CosineEmbeddingLoss", {}, (PRED, LABEL, SIGNS[:, 0]), None),
    ("CosineEmbeddingLoss", dict(margin=0.2), (PRED, LABEL, SIGNS[:, 0]),
     dict(sample_weight=WEIGHT[:, 0])),
    ("HuberLoss", dict(rho=0.5), (PRED, LABEL), dict(sample_weight=WEIGHT)),
    ("SoftmaxCrossEntropyLoss", dict(sparse_label=False), (PRED, DIST),
     None),
]


@pytest.mark.parametrize("case", CASES,
                         ids=[f"{c[0]}{i}" for i, c in enumerate(CASES)])
def test_loss_matches_the_reference(case):
    name, kw, inputs, call_kw = case
    _loss_case(name, kw, inputs, call_kw)


def test_ctc_loss_is_refused_by_name():
    # refused until the slice that ported ndarray/ctc.py; now the loss and
    # its gradient are the reference's
    pred = _normal(3, 7, 5)
    label = np.asarray([[1, 2], [4, 4], [3, 1]], np.float32)
    got, want = [], []
    for ndm, ag, mod, out in ((jnd, jag, jloss, want),
                              (nd, autograd, loss, got)):
        x = ndm.array(pred)
        x.attach_grad()
        with ag.record():
            y = mod.CTCLoss()(x, ndm.array(label))
        y.backward()
        out += [y.asnumpy(), x.grad.asnumpy()]
    for g, w in zip(got, want):
        _close(g, w)


# -- metrics ---------------------------------------------------------------------
def _batches(kind, seed=0):
    rng = np.random.RandomState(seed)
    for _ in range(3):
        if kind == "class":
            yield rng.randint(0, 4, 8).astype(np.float32), \
                rng.rand(8, 4).astype(np.float32)
        elif kind == "binary":
            yield rng.randint(0, 2, 8).astype(np.float32), \
                rng.rand(8).astype(np.float32)
        elif kind == "binary2":
            yield rng.randint(0, 2, 8).astype(np.float32), \
                rng.rand(8, 2).astype(np.float32)
        elif kind == "prob":
            p = rng.rand(8, 5).astype(np.float32)
            yield rng.randint(0, 5, 8).astype(np.float32), \
                p / p.sum(1, keepdims=True)
        else:
            yield rng.randn(8, 2).astype(np.float32), \
                rng.randn(8, 2).astype(np.float32)


def _feed(ref, port, kind, as_list=False):
    for label, pred in _batches(kind):
        if as_list:
            ref.update([jnd.array(label)], [jnd.array(pred)])
            port.update([nd.array(label)], [nd.array(pred)])
        else:
            ref.update(jnd.array(label), jnd.array(pred))
            port.update(nd.array(label), nd.array(pred))
    (rn, rv), (pn, pv) = ref.get(), port.get()
    assert pn == rn
    np.testing.assert_allclose(np.asarray(pv, np.float64),
                               np.asarray(rv, np.float64), rtol=METRIC_TOL,
                               atol=METRIC_TOL)
    ref.reset()
    port.reset()
    np.testing.assert_array_equal(np.isnan(port.get()[1]),
                                  np.isnan(ref.get()[1]))


METRICS = [
    ("TopKAccuracy", dict(top_k=2), "class"),
    ("TopKAccuracy", dict(top_k=3), "class"),
    ("F1", {}, "binary"),
    ("F1", {}, "binary2"),
    ("MCC", {}, "binary"),
    ("MCC", {}, "binary2"),
    ("MAE", {}, "reg"),
    ("MSE", {}, "reg"),
    ("RMSE", {}, "reg"),
    ("NegativeLogLikelihood", {}, "prob"),
    ("PearsonCorrelation", {}, "reg"),
    ("Accuracy", {}, "class"),
    ("CrossEntropy", {}, "prob"),
    ("Perplexity", {}, "prob"),
]


@pytest.mark.parametrize("case", METRICS,
                         ids=[f"{c[0]}{i}" for i, c in enumerate(METRICS)])
def test_metric_matches_the_reference(case):
    name, kw, kind = case
    _feed(getattr(jmetric, name)(**kw), getattr(metric, name)(**kw), kind)
    _feed(getattr(jmetric, name)(**kw), getattr(metric, name)(**kw), kind,
          as_list=True)


REGISTERED = ["acc", "accuracy", "top_k_accuracy", "topk", "f1", "mcc",
              "mae", "mse", "rmse", "ce", "cross-entropy", "perplexity",
              "nll_loss", "nll-loss", "loss", "pearsonr"]


@pytest.mark.parametrize("name", REGISTERED)
def test_create_builds_every_registered_name_as_the_reference(name):
    ref, port = jmetric.create(name), metric.create(name)
    assert type(port).__name__ == type(ref).__name__
    assert port.name == ref.name
    kind = {"top_k_accuracy": "class", "topk": "class", "acc": "class",
            "accuracy": "class", "f1": "binary", "mcc": "binary",
            "ce": "prob", "cross-entropy": "prob", "perplexity": "prob",
            "nll_loss": "prob", "nll-loss": "prob"}.get(name, "reg")
    _feed(ref, port, kind)


def test_composite_custom_and_np_fn_follow_the_reference():
    def mean_gap(label, pred):
        return float(np.abs(label - pred).mean())

    for make in (lambda m: m.create(["mae", "rmse"]),
                 lambda m: m.CompositeEvalMetric(["mse", m.MAE()]),
                 lambda m: m.create(mean_gap),
                 lambda m: m.np_fn(mean_gap),
                 lambda m: m.np_metric(mean_gap, name="gap"),
                 lambda m: m.CustomMetric(lambda l, p: (float(
                     np.abs(l - p).sum()), l.size), name="pair")):
        _feed(make(jmetric), make(metric), "reg")
    comp = metric.CompositeEvalMetric()
    comp.add("mae")
    comp.add(metric.MSE())
    assert [m.name for m in comp.metrics] == ["mae", "mse"]
    assert comp.get_name_value()[0][0] == "mae"
    with pytest.raises(MXNetError, match="not registered"):
        metric.create("bleu")


def test_metrics_read_tensors_and_bfloat16():
    label = torch.tensor([1.0, 0.0, 1.0])
    pred = torch.tensor([[0.2, 0.8], [0.9, 0.1], [0.6, 0.4]],
                        dtype=torch.bfloat16)
    m = metric.create("top_k_accuracy", top_k=1)
    m.update(label, pred)
    assert m.get() == ("top_k_accuracy_1", 2 / 3)
