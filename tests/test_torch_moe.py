"""The port's mixture-of-experts layers against the reference's
(``tpu_mx/parallel/moe.py``, ``tpu_mx/models/bert.py``'s MoE layers).

On the CPU, inputs made with numpy from a seed and fed to both packages:

- ``_moe_forward``: the routing exactly (which tokens are dropped and
  which slot each token takes, read from the reference's own ``(S, E,
  C)`` dispatch tensor), values and the aux term to 1e-5, gradients to
  1e-4, for top-1 and top-2 with and without drops;
- ``MoEFFN`` from the reference's parameters; dropped tokens give zero;
  the top-1 router gets a task gradient; a small regression trains;
- a 2-layer ``BERTModel(moe_every=1)`` through three
  ``CompiledTrainStep`` LAMB steps (loss 1e-4 relative, weights 1e-4).
"""
import math
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import tpu_mx as jmx
import tpu_mx.parallel.moe as jmoe
from tpu_mx import gluon as jgluon
from tpu_mx import nd as jnd

import tpu_mx_torch as mx
from tpu_mx_torch import gluon, optimizer
from tpu_mx_torch.gluon.block import HybridBlock, load_numpy
from tpu_mx_torch.models import BERTModel
from tpu_mx_torch.parallel import CompiledTrainStep, MoEFFN, moe
from tpu_mx_torch.parallel import moe_sharding_rules

VALUE_RTOL = 1e-5
GRAD_RTOL = 1e-4
STEP_RTOL = 1e-4


@pytest.fixture(autouse=True)
def _host():
    with mx.cpu():
        yield


def _close(got, want, rtol, msg=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, msg
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(1.0, np.abs(want).max()),
                               err_msg=msg)


def _weights(rng, s, u, h, e):
    f = lambda *shape, k=1.0: (rng.randn(*shape) * k).astype(np.float32)
    return (f(s, u), f(e, u), f(e, h, u, k=0.3), f(e, h, k=0.1),
            f(e, u, h, k=0.3), f(e, u, k=0.1))


def _reference(arrays, top_k, capacity):
    """The reference's ``(y, aux)`` and its ``(S, E, C)`` dispatch and
    combine tensors, read from its ``sec,su->ecu`` einsum."""
    seen = {}

    def einsum(spec, *ops, **kw):
        if spec == "sec,su->ecu":
            seen["dispatch"] = np.asarray(ops[0])
        if spec == "sec,ecu->su":
            seen["combine"] = np.asarray(ops[0])
        return jnp.einsum(spec, *ops, **kw)

    proxy = types.SimpleNamespace(**{k: getattr(jnp, k) for k in dir(jnp)
                                     if not k.startswith("__")})
    proxy.einsum = einsum
    saved, jmoe.jnp = jmoe.jnp, proxy
    try:
        y, aux = jmoe._moe_forward(
            *map(jnp.asarray, arrays), top_k=top_k, capacity=capacity,
            act=lambda v: jax.nn.gelu(v, approximate=False))
    finally:
        jmoe.jnp = saved
    return np.asarray(y), float(aux), seen["dispatch"], seen["combine"]


CASES = [(1, 1.25), (2, 1.25), (1, 0.3), (2, 0.4)]


@pytest.mark.parametrize("top_k,cf", CASES,
                         ids=[f"top{k}_cf{c}" for k, c in CASES])
def test_moe_forward_routes_exactly_and_holds_values(top_k, cf):
    rng = np.random.RandomState(top_k * 10 + int(cf * 10))
    s, u, h, e = 48, 8, 16, 4
    arrays = _weights(rng, s, u, h, e)
    cap = max(1, math.ceil(cf * s * top_k / e))
    y_ref, aux_ref, disp_ref, comb_ref = _reference(arrays, top_k, cap)
    t = [torch.from_numpy(a) for a in arrays]
    y, aux = moe._moe_forward(*t, top_k=top_k, capacity=cap,
                              act=torch.nn.functional.gelu)
    probs = torch.softmax(t[0] @ t[1].t(), dim=-1)
    experts, slots, kept, gates = moe.moe_route(probs, top_k, cap)
    disp = np.zeros((s, e, cap), bool)
    comb = np.zeros((s, e, cap), np.float32)
    for i, sl, k, g in zip(experts, slots, kept, gates):
        for tok in np.flatnonzero(k.numpy()):
            disp[tok, int(i[tok]), int(sl[tok])] = True
            comb[tok, int(i[tok]), int(sl[tok])] = float(g[tok])
    np.testing.assert_array_equal(disp, disp_ref.astype(bool))
    _close(comb, comb_ref, VALUE_RTOL)
    _close(y.numpy(), y_ref, VALUE_RTOL)
    assert abs(float(aux) - aux_ref) <= VALUE_RTOL * abs(aux_ref)
    if cf < 1:
        assert not disp.any(axis=(1, 2)).all()   # some tokens dropped


@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_forward_gradients_hold_to_the_reference(top_k):
    rng = np.random.RandomState(7 + top_k)
    s, u, h, e = 24, 8, 16, 4
    arrays = _weights(rng, s, u, h, e)
    cap = max(1, math.ceil(0.75 * s * top_k / e))
    c = rng.randn(s, u).astype(np.float32)
    act = lambda v: jax.nn.gelu(v, approximate=False)

    def ref_loss(*a):
        y, aux = jmoe._moe_forward(*a, top_k=top_k, capacity=cap, act=act)
        return jnp.sum(y * c) + 0.5 * aux

    want = jax.grad(ref_loss, argnums=tuple(range(6)))(
        *map(jnp.asarray, arrays))
    t = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    y, aux = moe._moe_forward(*t, top_k=top_k, capacity=cap,
                              act=torch.nn.functional.gelu)
    (y * torch.from_numpy(c)).sum().add(0.5 * aux).backward()
    for name, a, w in zip(("x", "gate", "w1", "b1", "w2", "b2"), t, want):
        _close(a.grad.numpy(), np.asarray(w), GRAD_RTOL, name)


def _ref_layer(top_k, cf, seed, u=8, h=16, e=4):
    np.random.seed(seed)
    layer = jmoe.MoEFFN(u, h, e, top_k=top_k, capacity_factor=cf)
    layer.initialize(init="xavier")
    return layer


def _port_layer(ref, top_k, cf, u=8, h=16, e=4):
    params = {k: p.data().asnumpy() for k, p in ref.collect_params().items()}
    return load_numpy(MoEFFN(u, h, e, top_k=top_k, capacity_factor=cf,
                             generator=torch.Generator()), params)


@pytest.mark.parametrize("top_k", [1, 2])
def test_moeffn_block_holds_to_the_reference(top_k):
    ref = _ref_layer(top_k, 1.25, seed=top_k)
    port = _port_layer(ref, top_k, 1.25)
    x = np.random.RandomState(3).randn(3, 5, 8).astype(np.float32)
    y_ref, aux_ref = ref(jnd.array(x))
    y, aux = port(torch.from_numpy(x))
    assert y.shape == (3, 5, 8)
    _close(y.detach().numpy(), y_ref.asnumpy(), VALUE_RTOL)
    assert abs(float(aux.detach()) - float(aux_ref.asnumpy())) <= 1e-5
    assert float(aux.detach()) >= 0.99
    assert port.capacity(15) == max(1, math.ceil(1.25 * 15 * top_k / 4))


def test_moe_capacity_drops_tokens():
    """capacity_factor -> 0 forces drops: dropped tokens give zero."""
    rng = np.random.RandomState(1)
    layer = MoEFFN(4, 8, 2, top_k=1, capacity_factor=0.1,
                   generator=torch.Generator().manual_seed(1))
    layer.initialize(init="xavier", generator=torch.Generator())
    y, _ = layer(torch.from_numpy(rng.randn(16, 4).astype(np.float32)))
    yn = y.detach().abs().sum(-1).numpy()
    # capacity = ceil(0.1 * 16 / 2) = 1 slot/expert -> at most 2 pass
    assert (yn > 1e-6).sum() <= 2, yn


def test_moe_top1_router_gets_task_gradient():
    rng = np.random.RandomState(4)
    layer = MoEFFN(8, 16, 4, top_k=1, generator=torch.Generator())
    layer.initialize(init="xavier", generator=torch.Generator())
    y, aux = layer(torch.from_numpy(rng.randn(10, 8).astype(np.float32)))
    (y * y).sum().backward()
    assert float(layer.gate_weight.grad.abs().max()) > 1e-5


def test_moe_grads_flow_and_trains():
    """Gate and expert weights get gradients; a small regression's loss
    falls through ``CompiledTrainStep`` (batch dims fold)."""
    rng = np.random.RandomState(2)
    b, t, u = 4, 6, 8

    class Net(HybridBlock):
        def __init__(self):
            super().__init__()
            self.moe = MoEFFN(u, 16, 4, top_k=2,
                              generator=torch.Generator().manual_seed(2))

        def forward(self, x, target):
            y, aux = self.moe(x)
            return ((y - target) ** 2).mean() + 0.01 * aux

    net = Net()
    net.initialize(init="xavier", generator=torch.Generator())
    x = torch.from_numpy(rng.randn(b, t, u).astype(np.float32))
    tg = torch.from_numpy((rng.randn(b, t, u) * 0.1).astype(np.float32))
    step = CompiledTrainStep(net, gluon.loss.PassThrough(),
                             optimizer.create("adam", learning_rate=3e-3))
    dummy = torch.zeros(1)
    losses = [float(step.step(x, tg, dummy)) for _ in range(25)]
    assert losses[-1] < losses[0] * 0.9, losses
    assert all(np.isfinite(losses))


def test_moe_sharding_rules_are_the_references():
    got, want = moe_sharding_rules(), jmoe.moe_sharding_rules()
    assert [r for r, _ in got] == [r for r, _ in want]
    assert [tuple(s) for _, s in got] == [tuple(s) for _, s in want]


# -- the MoE BERT ----------------------------------------------------------------
CFG = dict(num_layers=2, units=16, hidden_size=32, num_heads=2,
           vocab_size=40, max_length=8, dropout=0.0)


def test_bert_moe_contract():
    net = BERTModel(CFG, moe_every=2, moe_experts=4, moe_top_k=2,
                    generator=torch.Generator())
    tokens = torch.randint(4, 40, (2, 8), generator=torch.Generator())
    logits, aux = net(tokens, torch.zeros_like(tokens))
    assert logits.shape == (2, 8, 40) and float(aux) > 0
    kinds = [type(m).__name__ for m in net.encoder.layers]
    assert kinds == ["TransformerLayer", "MoETransformerLayer"]
    out = BERTModel(CFG, generator=torch.Generator())(tokens,
                                                       torch.zeros_like(tokens))
    assert isinstance(out, torch.Tensor)
    with pytest.raises(ValueError, match="places no MoE layer"):
        BERTModel(CFG, moe_every=3, generator=torch.Generator())


class _PortTrain(HybridBlock):
    """Loss in forward: the step keeps a net's first output only, so the
    aux term folds into the objective before it returns."""

    def __init__(self, bert):
        super().__init__()
        self.bert = bert
        self._ce = gluon.loss.SoftmaxCrossEntropyLoss()

    def forward(self, tokens, types_, labels):
        logits, aux = self.bert(tokens, types_)
        v = logits.shape[-1]
        ce = self._ce(logits.reshape(-1, v), labels.reshape(-1)).mean()
        return ce + 0.01 * aux


def _ref_train_cls():
    class RefTrain(jgluon.block.HybridBlock):
        def __init__(self, bert, **kw):
            super().__init__(**kw)
            self.bert = bert
            self._ce = jgluon.loss.SoftmaxCrossEntropyLoss()

        def forward(self, tokens, types_, labels):
            logits, aux = self.bert(tokens, types_)
            v = logits.shape[-1]
            ce = jnd.mean(self._ce(jnd.reshape(logits, shape=(-1, v)),
                                   jnd.reshape(labels, shape=(-1,))))
            return ce + 0.01 * aux
    return RefTrain


def test_moe_bert_three_lamb_steps_hold_to_the_reference():
    from tpu_mx.models.bert import BERTModel as JBERT
    from tpu_mx.parallel import CompiledTrainStep as JStep
    np.random.seed(5)
    ref = JBERT(CFG, moe_every=1, moe_experts=4, moe_top_k=2)
    ref.initialize()
    rng = np.random.RandomState(0)
    tokens = rng.randint(4, 40, (4, 8)).astype(np.int32)
    types_ = np.zeros((4, 8), np.int32)
    labels = rng.randint(4, 40, (4, 8)).astype(np.float32)
    ref(jnd.array(tokens), jnd.array(types_))
    params = {k: p.data().asnumpy() for k, p in ref.collect_params().items()}
    port = BERTModel.from_numpy(params, CFG, moe_every=1, moe_experts=4,
                                moe_top_k=2, device="cpu")
    dummy = np.zeros((1,), np.float32)
    jstep = JStep(_ref_train_cls()(ref), jgluon.loss.PassThrough(),
                  jmx.optimizer.create("lamb", learning_rate=1e-3))
    pstep = CompiledTrainStep(_PortTrain(port), gluon.loss.PassThrough(),
                              optimizer.create("lamb", learning_rate=1e-3))
    batch = (tokens, types_, labels, dummy)
    want = [float(jstep.step(*map(jnd.array, batch)).asnumpy())
            for _ in range(3)]
    got = [float(pstep.step(*map(torch.from_numpy, batch)))
           for _ in range(3)]
    _close(got, want, STEP_RTOL)
    jstep.sync_to_net()
    for (name, p), r in zip(port.named_parameters(),
                            ref.collect_params().values()):
        _close(p.detach().numpy(), r.data().asnumpy(), STEP_RTOL, name)
