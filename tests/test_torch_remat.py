"""``HybridBlock.remat`` and ``BERTModel(remat=, remat_policy=)`` against
the reference (``tpu_mx/gluon/block.py``'s ``remat``,
``tpu_mx/models/bert.py``'s remat policies).

On the CPU: remat changes memory and recomputation, never the numbers.
With dropout 0.1 (masks and attention-dropout seeds drawn from the
model's explicit generator) the loss and every gradient are bit-equal to
the run without remat, for every policy name the port maps, dense and
MoE; the generators end where they end without remat; BatchNorm's
running statistics move once.  The segment really recomputes (a layer's
forward runs twice), a dots policy keeps the products (fewer ``mm``s
and no second flash forward in the backward), and the reference's
errors hold.  The gradients of a remat BERT hold to the reference's
(1e-4).
"""
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import tpu_mx as jmx
from tpu_mx import nd as jnd

import tpu_mx_torch as mx
from tpu_mx_torch.gluon import nn
from tpu_mx_torch.gluon.block import (HybridBlock, REMAT_POLICIES,
                                      resolve_remat_policy)
from tpu_mx_torch.kernels import flash_attention as fa
from tpu_mx_torch.models import BERTModel
from tpu_mx_torch.models.bert import SelfAttention

GRAD_RTOL = 1e-4
CFG = dict(num_layers=2, units=32, hidden_size=64, num_heads=2,
           vocab_size=50, max_length=16, dropout=0.1)


@pytest.fixture(autouse=True)
def _host():
    with mx.cpu():
        yield


def _bert_run(remat, policy=None, moe_every=0, cfg=CFG):
    gen = torch.Generator().manual_seed(0)
    net = BERTModel(cfg, remat=remat, remat_policy=policy,
                    moe_every=moe_every, moe_experts=4, device="cpu",
                    generator=gen)
    net.train()
    tokens = torch.randint(0, cfg["vocab_size"], (2, 16),
                           generator=torch.Generator().manual_seed(1))
    out = net(tokens, torch.zeros_like(tokens), torch.tensor([16, 11]))
    loss = out[0].square().mean() + out[1] if moe_every \
        else out.square().mean()
    grads = torch.autograd.grad(loss, list(net.parameters()))
    return loss.detach(), grads, gen.get_state()


@pytest.mark.parametrize("moe_every", [0, 1], ids=["dense", "moe"])
@pytest.mark.parametrize("policy", (None,) + REMAT_POLICIES)
def test_remat_gradients_equal_under_dropout(policy, moe_every):
    loss0, g0, state0 = _bert_run(False, moe_every=moe_every)
    loss1, g1, state1 = _bert_run(True, policy, moe_every=moe_every)
    assert torch.equal(loss0, loss1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))
    assert torch.equal(state0, state1)


def test_remat_recomputes_each_layer():
    calls = []
    hook = lambda m, a, o: calls.append(1)
    for remat, want in ((False, 2), (True, 4)):
        calls.clear()
        gen = torch.Generator().manual_seed(0)
        net = BERTModel(CFG, remat=remat, device="cpu", generator=gen)
        for m in net.modules():
            if isinstance(m, SelfAttention):
                m.register_forward_hook(hook)
        tokens = torch.randint(0, 50, (2, 16), generator=gen)
        net(tokens, torch.zeros_like(tokens)).sum().backward()
        assert len(calls) == want


class _CountMM(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
            self.n += 1
        return func(*args, **(kwargs or {}))


def test_dots_policy_keeps_the_products():
    counts = {}
    for policy in ("nothing_saveable", "dots_saveable"):
        net = BERTModel(CFG, remat=True, remat_policy=policy, device="cpu",
                        generator=torch.Generator().manual_seed(0))
        tokens = torch.randint(0, 50, (2, 16),
                               generator=torch.Generator().manual_seed(1))
        loss = net(tokens, torch.zeros_like(tokens)).square().mean()
        with _CountMM() as mode:
            loss.backward()
        counts[policy] = mode.n
    assert counts["dots_saveable"] < counts["nothing_saveable"]


class _FlashBlock(HybridBlock):
    def forward(self, q, k, v):
        return fa.flash_attention(q, k, v, dropout_rate=0.1,
                                  dropout_seed=torch.tensor([7],
                                                            dtype=torch.int32))


@pytest.mark.parametrize("policy,launches", [(None, 2), ("dots_saveable", 1),
                                             ("everything_saveable", 1),
                                             ("dots_with_no_batch_dims_"
                                              "saveable", 2)])
def test_the_flash_forward_is_kept_as_a_product(policy, launches,
                                                monkeypatch):
    seen = []
    real = fa._forward
    monkeypatch.setattr(fa, "_forward",
                        lambda *a, **k: seen.append(1) or real(*a, **k))
    rng = np.random.RandomState(0)
    q, k, v = (torch.from_numpy(rng.randn(2, 16, 16).astype(np.float32))
               .requires_grad_(True) for _ in range(3))
    block = _FlashBlock().remat(policy=resolve_remat_policy(policy))
    out = block(q, k, v)
    grads = torch.autograd.grad(out.square().sum(), (q, k, v))
    assert len(seen) == launches
    plain = _FlashBlock()(q, k, v)
    want = torch.autograd.grad(plain.square().sum(), (q, k, v))
    assert all(torch.equal(a, b) for a, b in zip(grads, want))


def _bn_net(remat):
    net = nn.HybridSequential()
    for i in range(2):
        blk = nn.HybridSequential()
        blk.add(nn.Dense(16, in_units=16, generator=torch.Generator()
                         .manual_seed(i)))
        blk.add(nn.BatchNorm(in_channels=16))
        blk.add(nn.Activation("relu"))
        blk.add(nn.Dropout(0.1, generator=torch.Generator().manual_seed(9)))
        if remat:
            blk.remat()
        net.add(blk)
    net.train()
    return net


def test_remat_sequential_with_batchnorm_matches_and_moves_stats_once():
    x = torch.from_numpy(np.random.RandomState(0).randn(4, 16)
                         .astype(np.float32)).requires_grad_(True)
    runs = []
    for remat in (False, True):
        net = _bn_net(remat)
        loss = net(x).square().sum()
        grads = torch.autograd.grad(loss, [x] + list(net.parameters()))
        stats = [b.clone() for b in net.buffers()]
        runs.append((loss.detach(), grads, stats))
    (l0, g0, s0), (l1, g1, s1) = runs
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))
    assert all(torch.equal(a, b) for a, b in zip(s0, s1))
    assert not torch.equal(s1[0], torch.zeros_like(s1[0]))


_FACTORY_NAMES = ("save_only_these_names", "save_any_names_but_these",
                  "save_anything_except_these_names",
                  "save_and_offload_only_these_names",
                  "save_from_both_policies",
                  "offload_dot_with_no_batch_dims")


class _SquareLoss(HybridBlock):
    def forward(self, pred, label):
        return pred.float().square().mean(dim=(1, 2))


class _JSquareLoss(jmx.gluon.loss.Loss):
    def __init__(self):
        super().__init__(None, 0)

    def hybrid_forward(self, F, pred, label):
        return (pred.astype("float32") ** 2).mean(axis=(1, 2))


def test_policy_errors_are_the_references():
    with pytest.raises(ValueError, match="remat policy"):
        BERTModel(CFG, remat=True, remat_policy="bogus_policy",
                  device="cpu", generator=torch.Generator())
    with pytest.raises(ValueError, match="remat=True"):
        BERTModel(CFG, remat=False, remat_policy="dots_saveable",
                  device="cpu", generator=torch.Generator())
    from tpu_mx.models.bert import BERTModel as JBERT
    from tpu_mx.parallel import CompiledTrainStep as JStep
    from tpu_mx_torch import optimizer
    from tpu_mx_torch.parallel import CompiledTrainStep
    with pytest.raises(ValueError, match="remat policy"):
        JBERT(dict(CFG, num_layers=1), remat=True,
              remat_policy="bogus_policy")
    # jax's policy factories (fault C20): the name constructs and the
    # eager forward runs in both packages; the first training step raises
    # jax's TypeError, the port's with the reference's message
    cfg = dict(CFG, num_layers=1)
    toks = np.random.RandomState(0).randint(4, 50, (2, 16)).astype(np.int32)
    zeros = np.zeros((2, 16), np.int32)
    for name in _FACTORY_NAMES:
        message = (f"{name}() got an unexpected keyword argument "
                   "'dimension_numbers'")
        net = BERTModel(cfg, remat=True, remat_policy=name, device="cpu",
                        generator=torch.Generator().manual_seed(0))
        assert net(mx.nd.array(toks), mx.nd.array(zeros)).shape == \
            (2, 16, 50)
        step = CompiledTrainStep(net, _SquareLoss(),
                                 optimizer.create("sgd", learning_rate=0.1),
                                 device="cpu")
        with pytest.raises(TypeError) as got:
            step.step(torch.from_numpy(toks), torch.from_numpy(zeros),
                      torch.zeros(2))
        assert str(got.value) == message
        jmx.random.seed(0)
        jnet = JBERT(cfg, remat=True, remat_policy=name)
        jnet.initialize(init="xavier")
        assert jnet(jnd.array(toks), jnd.array(zeros)).shape == (2, 16, 50)
        jstep = JStep(jnet, _JSquareLoss(),
                      jmx.optimizer.create("sgd", learning_rate=0.1))
        with pytest.raises(TypeError) as want:
            jstep.step(jnd.array(toks), jnd.array(zeros), jnd.zeros((2,)))
        assert str(want.value) == message


@pytest.mark.parametrize("policy", ["dots_saveable", "bogus"])
def test_block_remat_hands_a_name_on_unresolved_as_the_reference(policy):
    """``HybridBlock.remat(policy=<str>)`` keeps the string, as the
    reference's does (it hands it to ``jax.checkpoint``): the eager
    forward runs and the first training step raises jax's TypeError."""
    from tpu_mx.gluon import nn as jnn
    from tpu_mx.parallel import CompiledTrainStep as JStep
    from tpu_mx_torch import gluon, optimizer
    from tpu_mx_torch.parallel import CompiledTrainStep
    x = np.ones((2, 4), np.float32)
    nets = []
    for pkg_nn in (nn, jnn):
        net = pkg_nn.HybridSequential()
        dense = pkg_nn.Dense(4, in_units=4)
        dense.remat(policy=policy)
        net.add(dense, pkg_nn.Dense(2, in_units=4))
        net.initialize()
        nets.append(net)
    assert nets[0](mx.nd.array(x)).shape == (2, 2)
    assert nets[1](jnd.array(x)).shape == (2, 2)
    step = CompiledTrainStep(nets[0], gluon.loss.L2Loss(),
                             optimizer.create("sgd", learning_rate=0.1),
                             device="cpu")
    with pytest.raises(TypeError, match="'str' object is not callable"):
        step.step(torch.from_numpy(x), torch.zeros(2, 2))
    jstep = JStep(nets[1], jmx.gluon.loss.L2Loss(),
                  jmx.optimizer.create("sgd", learning_rate=0.1))
    with pytest.raises(TypeError, match="'str' object is not callable"):
        jstep.step(jnd.array(x), jnd.zeros((2, 2)))


@pytest.mark.parametrize("policy", [None, "dots_saveable"])
def test_remat_bert_gradients_hold_to_the_reference(policy):
    import jax
    from tpu_mx.models.bert import BERTModel as JBERT
    cfg = dict(CFG, dropout=0.0)
    jmx.random.seed(0)
    np.random.seed(0)
    ref = JBERT(cfg, remat=True, remat_policy=policy)
    ref.initialize(init="xavier")
    toks = np.random.RandomState(0).randint(4, 50, (2, 16)).astype(np.int32)
    types_ = np.zeros((2, 16), np.int32)
    ref(jnd.array(toks), jnd.array(types_))
    keys = list(ref.collect_params().keys())
    params = {k: ref.collect_params()[k].data()._data for k in keys}

    def loss(pm):
        out, _ = ref._functional_call(pm, jax.random.PRNGKey(0), False,
                                      (jnd.array(toks), jnd.array(types_)))
        return (out.astype("float32") ** 2).mean()

    want = jax.grad(loss)(params)
    port = BERTModel.from_numpy({k: np.asarray(v) for k, v in
                                 params.items()}, cfg, remat=True,
                                remat_policy=policy, device="cpu")
    port.eval()
    out = port(torch.from_numpy(toks), torch.from_numpy(types_))
    got = torch.autograd.grad(out.square().mean(), list(port.parameters()))
    for k, g in zip(keys, got):
        w = np.asarray(want[k], np.float64)
        np.testing.assert_allclose(g.numpy(), w, rtol=GRAD_RTOL,
                                   atol=GRAD_RTOL * max(1e-3,
                                                        np.abs(w).max()),
                                   err_msg=k)
