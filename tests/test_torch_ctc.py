"""CTC against the JAX reference, on the CPU: ``nd.ctc_loss`` (both blank
conventions, both padding rules, explicit lengths, an impossible
alignment, the gradient) and ``gluon.loss.CTCLoss`` (``NTC``/``TNC``,
prediction and label lengths, the gradient).  Inputs are made with numpy
from a seed; losses and gradients are held to ``RTOL`` of their largest
entry (float32 log-space sums over T steps).  ``F.ctc_loss`` is an
oracle for the ordinary cases only.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tpu_mx import autograd as jag
from tpu_mx import nd as jnd
from tpu_mx.gluon import loss as jloss

import tpu_mx_torch as mx
from tpu_mx_torch import autograd, nd
from tpu_mx_torch.gluon import loss

RTOL = 1e-5
T, N, C = 12, 4, 6


@pytest.fixture(autouse=True)
def _host():
    with mx.cpu():
        yield


def _acts(t=T, n=N, c=C, seed=0):
    return np.random.RandomState(seed).randn(t, n, c).astype(np.float32)


def _close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=RTOL * np.abs(want).max(), err_msg=what)


def _both(fn_ref, fn_port, arrays, grad=True):
    """The loss and the first array's gradient in each package."""
    out = []
    for ndm, ag, fn in ((jnd, jag, fn_ref), (nd, autograd, fn_port)):
        arrs = [ndm.array(a) for a in arrays]
        arrs[0].attach_grad()
        with ag.record():
            y = fn(*arrs)
        if grad:
            y.backward(ndm.array(np.linspace(0.5, 1.5, y.shape[0],
                                             dtype=np.float32)))
        out.append((y.asnumpy(), arrs[0].grad.asnumpy()))
    return out


# labels: blank "first" pads with 0 (or -1); blank "last" pads with -1
FIRST_ZERO = np.asarray([[1, 2, 2, 0], [3, 0, 0, 0], [5, 4, 3, 2],
                         [1, 1, 0, 0]], np.float32)
FIRST_MINUS = np.where(FIRST_ZERO == 0, -1, FIRST_ZERO).astype(np.float32)
LAST_MINUS = np.where(FIRST_ZERO == 0, -1, FIRST_ZERO - 1).astype(
    np.float32)

CASES = [
    ("first-zero-padding", FIRST_ZERO, dict()),
    ("first-minus-padding", FIRST_MINUS, dict()),
    ("last-minus-padding", LAST_MINUS, dict(blank_label="last")),
    ("last-zero-is-a-label", np.where(LAST_MINUS < 0, 0, LAST_MINUS)
     .astype(np.float32), dict(blank_label="last")),
]


@pytest.mark.parametrize("labels,kw", [c[1:] for c in CASES],
                         ids=[c[0] for c in CASES])
def test_ctc_loss_and_gradient_match_the_reference(labels, kw):
    (ly, gy), (lp, gp) = _both(
        lambda a, b: jnd.ctc_loss(a, b, **kw),
        lambda a, b: nd.ctc_loss(a, b, **kw), [_acts(), labels])
    _close(lp, ly, "loss")
    _close(gp, gy, "gradient")


def test_ctc_loss_with_data_and_label_lengths():
    dl = np.asarray([12, 7, 10, 5], np.float32)
    ll = np.asarray([2, 1, 4, 2], np.float32)
    kw = dict(use_data_lengths=True, use_label_lengths=True)
    (ly, gy), (lp, gp) = _both(
        lambda a, b, c, d: jnd.ctc_loss(a, b, c, d, **kw),
        lambda a, b, c, d: nd.ctc_loss(a, b, c, d, **kw),
        [_acts(), FIRST_ZERO, dl, ll])
    _close(lp, ly, "loss")
    _close(gp, gy, "gradient")
    # steps past a sequence's length take no gradient
    assert not gp[7:, 1].any() and not gp[5:, 3].any()


def test_an_impossible_alignment_gives_the_references_finite_value():
    # "1 1 1" needs 5 steps (a blank between repeats); 3 are given
    labels = np.asarray([[1, 1, 1], [2, 3, 0]], np.float32)
    acts = _acts(t=3, n=2)
    want = jnd.ctc_loss(jnd.array(acts), jnd.array(labels)).asnumpy()
    got = nd.ctc_loss(nd.array(acts), nd.array(labels)).asnumpy()
    assert np.isfinite(want).all() and want[0] >= 1e29
    np.testing.assert_array_equal(got[0], want[0])
    _close(got[1:], want[1:], "possible row")


def test_ctc_loss_agrees_with_torch_on_ordinary_cases():
    acts = torch.from_numpy(_acts())
    lens = torch.tensor([3, 1, 4, 2])
    want = F.ctc_loss(F.log_softmax(acts, -1), torch.from_numpy(
        FIRST_ZERO).long(), torch.full((N,), T), lens, blank=0,
        reduction="none")
    got = nd.ctc_loss(acts, torch.from_numpy(FIRST_ZERO))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("layout", ["NTC", "TNC"])
def test_ctc_block_matches_the_reference(layout):
    acts = _acts()
    if layout == "NTC":
        acts = acts.transpose(1, 0, 2).copy()
    labels = np.asarray([[1, 2, 2], [3, 4, 1], [5, 4, 3], [1, 1, 2]],
                        np.float32)
    (ly, gy), (lp, gp) = _both(jloss.CTCLoss(layout=layout),
                               loss.CTCLoss(layout=layout), [acts, labels])
    _close(lp, ly, "loss")
    _close(gp, gy, "gradient")


def test_ctc_block_with_prediction_and_label_lengths():
    acts = _acts().transpose(1, 0, 2).copy()
    labels = np.asarray([[1, 2, 2], [3, 4, 1], [5, 4, 3], [1, 1, 2]],
                        np.float32)
    pl = np.asarray([12, 9, 8, 10], np.float32)
    ll = np.asarray([3, 1, 2, 3], np.float32)
    (ly, gy), (lp, gp) = _both(
        lambda a, b, c, d: jloss.CTCLoss()(a, b, c, d),
        lambda a, b, c, d: loss.CTCLoss()(a, b, c, d),
        [acts, labels, pl, ll])
    _close(lp, ly, "loss")
    _close(gp, gy, "gradient")
