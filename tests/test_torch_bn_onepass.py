"""``TPUMX_BN_ONEPASS``: the port's BatchNorm against the reference's in
both forms, on the CPU.

The reference reads the variable in every forward: ``"1"`` (the
default) is the one-pass float32 ``Σx, Σx²`` form, anything else the
two-pass form (``mean``, then ``mean((x - mean)²)`` in the input's
dtype, the normalization unfolded).  At a large mean and a small spread
the one-pass variance cancels: the two-pass form is the one that stays
near a float64 oracle there, in both packages.

Each case feeds the same numpy input, weights and head gradient to both
packages and compares the output, the running statistics and the
gradients of the input, gamma and beta.
"""
import numpy as np
import pytest
import torch

from tpu_mx import autograd, nd
from tpu_mx.gluon import nn as jnn

from tpu_mx_torch.gluon import nn
from tpu_mx_torch.gluon.block import load_numpy

# relative to max|ref| of each quantity: f32 at the large-mean input,
# whose mean/spread of 200 scales the two packages' rounding of the
# centred values; bf16 (one ulp 2^-8) summed over 200 products for the
# parameter gradients
F32_TOL = 5e-5
BF16_TOL = 3e-2
ORACLE_TOL = 1e-3   # the two-pass form against float64, relative

C = 4
INPUTS = {
    # the large-mean probe: mean 20, spread 0.1
    "large_mean": lambda rng: 20.0 + 0.1 * rng.randn(8, C, 5, 5),
    "plain": lambda rng: 2.0 * rng.randn(8, C, 5, 5) + 1.0,
}


def _params():
    rng = np.random.RandomState(3)
    return {"gamma": rng.uniform(0.5, 1.5, C), "beta": rng.randn(C) * 0.2,
            "running_mean": rng.randn(C) * 0.1,
            "running_var": rng.uniform(0.5, 1.5, C)}


def _ref_run(x, head, dtype):
    jbn = jnn.BatchNorm(axis=1, in_channels=C)
    jbn.initialize()
    params = _params()
    for k, p in jbn.collect_params().items():
        leaf = next(n for n in params if k.endswith(n))
        p.set_data(nd.array(params[leaf].astype(np.float32)))
    if dtype == "bfloat16":
        jbn.cast("bfloat16")
    jx = nd.cast(nd.array(x.astype(np.float32)), dtype)
    jx.attach_grad()
    with autograd.record():
        y = jbn(jx)
        loss = (nd.cast(y, "float32") * nd.array(head)).sum()
    loss.backward()
    f = lambda a: np.asarray(a._data, np.float32)
    return {"out": f(y), "running_mean": f(jbn.running_mean.data()),
            "running_var": f(jbn.running_var.data()), "dx": f(jx.grad),
            "dgamma": f(jbn.gamma.grad), "dbeta": f(jbn.beta.grad)}


def _port_run(x, head, dtype):
    bn = nn.BatchNorm(axis=1, in_channels=C, generator=torch.Generator())
    load_numpy(bn, {k: v.astype(np.float32) for k, v in _params().items()})
    dt = getattr(torch, dtype)
    bn.to(dt)
    bn.train()
    tx = torch.tensor(x.astype(np.float32)).to(dt).requires_grad_()
    y = bn(tx)
    (y.float() * torch.tensor(head)).sum().backward()
    f = lambda t: t.detach().float().numpy()
    return {"out": f(y), "running_mean": f(bn._buffers["running_mean"]),
            "running_var": f(bn._buffers["running_var"]), "dx": f(tx.grad),
            "dgamma": f(bn._parameters["gamma"].grad),
            "dbeta": f(bn._parameters["beta"].grad)}


# the one-pass form at the large-mean input is the cancellation itself:
# both packages are ~1e-2 off float64 there, each in its own rounding
@pytest.mark.parametrize("onepass,case", [("0", "large_mean"),
                                          ("0", "plain"), ("1", "plain")])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batchnorm_matches_the_reference_in_both_forms(monkeypatch, onepass,
                                                       case, dtype):
    monkeypatch.setenv("TPUMX_BN_ONEPASS", onepass)
    rng = np.random.RandomState(11)
    x = INPUTS[case](rng)
    head = rng.randn(*x.shape).astype(np.float32)
    ref = _ref_run(x, head, dtype)
    out = _port_run(x, head, dtype)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    for key, r in ref.items():
        scale = max(np.abs(r).max(), 1e-6)
        np.testing.assert_allclose(out[key], r, rtol=0, atol=tol * scale,
                                   err_msg=key)


def _oracle(x, head):
    """The training forward and backward in float64."""
    p = _params()
    red = (0, 2, 3)
    mean = x.mean(red, keepdims=True)
    var = ((x - mean) ** 2).mean(red, keepdims=True)
    inv = 1.0 / np.sqrt(var + 1e-5)
    g = p["gamma"].reshape(1, C, 1, 1)
    xhat = (x - mean) * inv
    out = xhat * g + p["beta"].reshape(1, C, 1, 1)
    n = x.size / C
    dxhat = head * g
    dx = inv / n * (n * dxhat - dxhat.sum(red, keepdims=True)
                    - xhat * (dxhat * xhat).sum(red, keepdims=True))
    return out, dx


def test_two_pass_form_holds_the_large_mean_input_to_float64(monkeypatch):
    """The probe's case: under ``TPUMX_BN_ONEPASS=0`` the port's float32
    output and input gradient stay near float64, as the reference's do;
    the one-pass form is far off at this input."""
    rng = np.random.RandomState(11)
    x = INPUTS["large_mean"](rng)
    head = rng.randn(*x.shape).astype(np.float32)
    want_out, want_dx = _oracle(x, head.astype(np.float64))

    def err(got, want):
        return np.abs(got - want).max() / np.abs(want).max()

    monkeypatch.setenv("TPUMX_BN_ONEPASS", "0")
    two = _port_run(x, head, "float32")
    assert err(two["out"], want_out) < ORACLE_TOL
    assert err(two["dx"], want_dx) < ORACLE_TOL
    monkeypatch.setenv("TPUMX_BN_ONEPASS", "1")
    one = _port_run(x, head, "float32")
    assert err(one["out"], want_out) > 10 * err(two["out"], want_out)


def test_the_variable_is_read_on_every_call(monkeypatch):
    """One module, the variable flipped between calls: each call takes
    the form the variable names at that call."""
    rng = np.random.RandomState(5)
    x = INPUTS["large_mean"](rng).astype(np.float32)
    bn = nn.BatchNorm(axis=1, in_channels=C, generator=torch.Generator())
    bn.train()
    outs = {}
    for flag in ("1", "0", "1"):
        monkeypatch.setenv("TPUMX_BN_ONEPASS", flag)
        outs.setdefault(flag, []).append(bn(torch.tensor(x)).detach())
    assert torch.equal(outs["1"][0], outs["1"][1])
    assert not torch.equal(outs["1"][0], outs["0"][0])
