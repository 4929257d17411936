"""The port's ``nd.*_update`` operators against the reference's
(``tpu_mx/ndarray/optimizer_ops.py`` and ``ops.py``'s ``sgd_update``).

On the CPU, each of the 25 operators gets the same numpy inputs from a
seed in both packages, as arrays with ``out=`` where the operator takes
it: the returned values, the weights delivered to ``out`` and every
state array rebound in place agree to 1e-6; with tensors the port
returns the raw ``(new_weight, *new_states)`` with the same values and
changes no input.  The ``multi_*`` argument checks raise as the
reference's do.
"""
import numpy as np
import pytest
import torch

from tpu_mx import nd as jnd

import tpu_mx_torch as mx
from tpu_mx_torch import nd

RTOL = 1e-6

# name, roles of the positional arrays, keyword arguments, out= taken
#   w weight, g gradient, s a state, p a positive state, r a (1,) scalar
SGD = dict(lr=0.1, wd=0.01, rescale_grad=0.5, clip_gradient=0.3)
MOM = dict(SGD, momentum=0.9)
ADAM = dict(lr=0.01, beta1=0.9, beta2=0.99, epsilon=1e-8, wd=0.1,
            clip_gradient=0.8)
MULTI = dict(lrs=(0.1, 0.05), wds=(0.01, 0.0), rescale_grad=0.7,
             clip_gradient=1.5, num_weights=2)
CASES = [
    ("sgd_update", "wg", SGD, True),
    ("sgd_mom_update", "wgs", MOM, True),
    ("mp_sgd_update", "wgw", SGD, True),
    ("mp_sgd_mom_update", "wgsw", MOM, True),
    ("nag_mom_update", "wgs", MOM, True),
    ("mp_nag_mom_update", "wgsw", MOM, True),
    ("adam_update", "wgsp", ADAM, True),
    ("adamw_update", "wgsp", dict(ADAM, rescale_grad=0.5, eta=0.7), True),
    ("mp_adamw_update", "wgspw", dict(ADAM, rescale_grad=0.5, eta=0.7),
     True),
    ("lamb_update_phase1", "wgsp",
     dict(beta1=0.9, beta2=0.99, epsilon=1e-6, t=3, wd=0.01,
          rescale_grad=0.5, clip_gradient=0.9), False),
    ("lamb_update_phase2", "wgrr",
     dict(lr=0.01, lower_bound=0.5, upper_bound=3.0), True),
    ("rmsprop_update", "wgp",
     dict(lr=0.01, gamma1=0.9, wd=0.01, clip_weights=0.8), True),
    ("rmspropalex_update", "wgpss",
     dict(lr=0.01, gamma1=0.9, gamma2=0.8, wd=0.01), True),
    ("ftrl_update", "wgsp", dict(lr=0.1, lamda1=0.01, beta=1.0, wd=0.01),
     True),
    ("ftml_update", "wgppS", dict(lr=0.1, t=2, wd=0.01, clip_grad=0.7),
     True),
    ("signsgd_update", "wg", dict(lr=0.1, wd=0.01), True),
    ("signum_update", "wgs", dict(lr=0.1, momentum=0.9, wd=0.01,
                                  wd_lh=0.02), True),
    ("multi_sgd_update", "wgwg", MULTI, True),
    ("multi_sgd_mom_update", "wgswgs", dict(MULTI, momentum=0.9), True),
    ("multi_mp_sgd_update", "wgwwgw", MULTI, True),
    ("multi_mp_sgd_mom_update", "wgswwgsw", dict(MULTI, momentum=0.9),
     True),
    ("preloaded_multi_sgd_update", "wgwgLD",
     dict(rescale_grad=0.7, clip_gradient=1.5, num_weights=2), True),
    ("preloaded_multi_sgd_mom_update", "wgswgsLD",
     dict(momentum=0.9, rescale_grad=0.7, num_weights=2), True),
    ("preloaded_multi_mp_sgd_update", "wgwwgwLD",
     dict(rescale_grad=0.7, num_weights=2), True),
    ("preloaded_multi_mp_sgd_mom_update", "wgswwgswLD",
     dict(momentum=0.9, rescale_grad=0.7, num_weights=2), True),
]


@pytest.fixture(autouse=True)
def _host():
    with mx.cpu():
        yield


def _inputs(roles, seed):
    rng = np.random.RandomState(seed)
    out = []
    for r in roles:
        if r in "wgs":
            out.append(rng.randn(4, 3).astype(np.float32))
        elif r == "S":
            out.append((rng.randn(4, 3) * 0.1).astype(np.float32))
        elif r == "p":
            out.append((np.abs(rng.randn(4, 3)) + 0.5).astype(np.float32))
        elif r == "r":
            out.append((np.abs(rng.randn(1)) + 0.5).astype(np.float32))
        elif r == "L":
            out.append(np.array([0.1, 0.05], np.float32))
        elif r == "D":
            out.append(np.array([0.01, 0.0], np.float32))
    return out


def _out_slots(name, roles):
    """Which positional arrays are the weights (``out=`` targets)."""
    if name.startswith(("multi", "preloaded")):
        group = {"sgd_update": 2, "sgd_mom_update": 3, "mp_sgd_update": 3,
                 "mp_sgd_mom_update": 4}[name.split("multi_")[1]]
        n = 2
        return [i * group for i in range(n)]
    return [0]


@pytest.mark.parametrize("name,roles,kw,takes_out", CASES,
                         ids=[c[0] for c in CASES])
def test_operator_holds_to_the_reference(name, roles, kw, takes_out):
    arrays = _inputs(roles, seed=len(name))
    want_in = [jnd.array(a) for a in arrays]
    got_in = [nd.array(a) for a in arrays]
    slots = _out_slots(name, roles)
    multi = name.startswith(("multi", "preloaded"))
    kw_ref, kw_port = dict(kw), dict(kw)
    if takes_out:
        kw_ref["out"] = [want_in[i] for i in slots] if multi \
            else want_in[slots[0]]
        kw_port["out"] = [got_in[i] for i in slots] if multi \
            else got_in[slots[0]]
    want = getattr(jnd, name)(*want_in, **kw_ref)
    got = getattr(nd, name)(*got_in, **kw_port)
    want = want if isinstance(want, list) else [want]
    got = got if isinstance(got, list) else [got]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert isinstance(g, nd.NDArray)
        np.testing.assert_allclose(g.asnumpy(), w.asnumpy(), rtol=RTOL,
                                   atol=RTOL)
    if takes_out:
        for i in slots:
            assert any(g is got_in[i] for g in got)
    for i, (g, w) in enumerate(zip(got_in, want_in)):
        np.testing.assert_allclose(g.asnumpy(), w.asnumpy(), rtol=RTOL,
                                   atol=RTOL, err_msg=f"input {i}")
    # tensors: the raw results, no input changed
    tensors = [torch.from_numpy(a.copy()) for a in arrays]
    raw = getattr(nd, name)(*tensors, **kw)
    raw = raw if isinstance(raw, tuple) else (raw,)
    assert all(torch.equal(t, torch.from_numpy(a))
               for t, a in zip(tensors, arrays))
    firsts = raw[::len(raw) // len(got)] if multi else raw[:1]
    for r, g in zip(firsts, got):
        np.testing.assert_allclose(r.numpy(), g.asnumpy(), rtol=RTOL,
                                   atol=RTOL)


def test_the_multi_operators_check_their_arguments():
    w, g = nd.array(np.ones(3, np.float32)), nd.array(np.ones(3, np.float32))
    with pytest.raises(ValueError, match="expected 4 tensors"):
        nd.multi_sgd_update(w, g, w, lrs=(0.1, 0.1), num_weights=2)
    with pytest.raises(ValueError, match="need lrs"):
        nd.multi_sgd_update(w, g, num_weights=1)
    with pytest.raises(ValueError, match="single NDArray"):
        nd.multi_sgd_update(w, g, w, g, lrs=(0.1, 0.1), num_weights=2, out=w)
    with pytest.raises(ValueError, match="one entry per weight"):
        nd.multi_sgd_update(w, g, w, g, lrs=(0.1,), num_weights=2)


def test_the_update_operators_are_exported_as_the_references():
    names = [c[0] for c in CASES]
    assert len(names) == 25
    for n in names:
        assert callable(getattr(jnd, n)) and callable(getattr(nd, n))
