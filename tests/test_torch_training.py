"""The port's BERT training slice against the JAX reference, on the CPU.

Inputs are made with numpy from a seed and fed to both packages; the
reference's weights are carried into the port with
``BERTModel.from_numpy``.  Both run at a small size (2 layers, width 64)
and dropout 0: the reference's dropout masks come from ``jax.random``
and cannot be reproduced, so dropout is held by the kernel tests instead
(``tests/test_torch_kernels.py``, and on the card ``chip_smoke.py``).
"""
import numpy as np
import pytest
import torch

import tpu_mx as mx
from tpu_mx import gluon, nd
from tpu_mx.models.bert import BERTModel as JBERTModel
from tpu_mx.optimizer.optimizer import LAMB as JLAMB
from tpu_mx.parallel import CompiledTrainStep as JCompiledTrainStep

from tpu_mx_torch import initializer, optimizer, random, telemetry
from tpu_mx_torch.base import MXNetError
from tpu_mx_torch.gluon import loss as tloss
from tpu_mx_torch.models import BERTModel, MLMLoss, bert_base_config
from tpu_mx_torch.parallel import CompiledTrainStep

B, T, M = 2, 32, 5


def _cfg():
    cfg = bert_base_config(vocab_size=100, max_len=64)
    cfg.update(num_layers=2, units=64, hidden_size=128, num_heads=4,
               dropout=0.0)
    return cfg


def _batch(seed=0, batch=B):
    rng = np.random.RandomState(seed)
    tokens = rng.randint(4, 100, (batch, T)).astype(np.int32)
    types = rng.randint(0, 2, (batch, T)).astype(np.int32)
    valid = rng.randint(M + 1, T + 1, batch).astype(np.int32)
    valid[0] = T
    pos = np.stack([rng.choice(n, M, replace=False)
                    for n in valid]).astype(np.int32)
    labels = np.take_along_axis(tokens, pos, axis=1)
    return tokens, types, valid, pos, labels


class JMLMLoss(gluon.loss.Loss):
    """The reference benchmark's loss (``bench.py::_bert_once``)."""

    def __init__(self, **kw):
        super().__init__(weight=None, batch_axis=0, **kw)
        self._ce = gluon.loss.SoftmaxCrossEntropyLoss()

    def hybrid_forward(self, F, logits, labels):
        vocab = logits.shape[-1]
        return F.mean(self._ce(F.reshape(logits, shape=(-1, vocab)),
                               F.reshape(labels, shape=(-1,))))


def _pair(dtype="float32", seed=0):
    """The reference model and the port's, with the same weights."""
    mx.random.seed(seed)
    jnet = JBERTModel(_cfg(), dtype=dtype)
    jnet.initialize()
    params = {k: np.asarray(p.data()._data)
              for k, p in jnet.collect_params().items()}
    return jnet, BERTModel.from_numpy(params, _cfg(), dtype=dtype,
                                      device="cpu")


def _nd(batch):
    return [nd.array(x) for x in batch]


def test_mlm_logits_match_the_reference():
    jnet, net = _pair()
    tokens, types, valid, pos, _ = _batch()
    ref = jnet(*_nd((tokens, types, valid, pos))).asnumpy()
    net.eval()
    with torch.no_grad():
        got = net(*(torch.from_numpy(x) for x in (tokens, types, valid,
                                                   pos))).numpy()
    assert got.shape == (B, M, 100) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
    # without masked positions: every position's logits
    ref_all = jnet(*_nd((tokens, types, valid))).asnumpy()
    with torch.no_grad():
        got_all = net(torch.from_numpy(tokens), torch.from_numpy(types),
                      torch.from_numpy(valid)).numpy()
    np.testing.assert_allclose(got_all, ref_all, rtol=1e-4, atol=1e-4)


def test_three_lamb_steps_match_the_reference():
    jnet, net = _pair()
    batch = _batch()
    jstep = JCompiledTrainStep(jnet, JMLMLoss(), mx.optimizer.create(
        "lamb", learning_rate=1e-3, wd=0.01))
    step = CompiledTrainStep(net, MLMLoss(), optimizer.create(
        "lamb", learning_rate=1e-3, wd=0.01), device="cpu")
    for _ in range(3):
        want = float(jstep.step(*_nd(batch)).asnumpy())
        got = float(step.step(*batch))
        assert abs(got - want) <= 1e-5 * abs(want)
    names = list(jnet.collect_params().keys())   # structural order
    for (name, p), ref_name in zip(net.named_parameters(), names):
        np.testing.assert_allclose(p.detach().numpy(),
                                   np.asarray(jstep.values[ref_name]),
                                   rtol=1e-4, atol=1e-4, err_msg=name)


def test_bf16_first_loss_matches_the_reference():
    jnet, net = _pair(dtype="bfloat16")
    assert all(p.dtype == torch.bfloat16 for p in net.parameters())
    batch = _batch(1)
    jstep = JCompiledTrainStep(jnet, JMLMLoss(), mx.optimizer.create(
        "lamb", learning_rate=1e-4, multi_precision=True))
    step = CompiledTrainStep(net, MLMLoss(), optimizer.create(
        "lamb", learning_rate=1e-4, multi_precision=True), device="cpu")
    want = float(jstep.step(*_nd(batch)).asnumpy())
    got = float(step.step(*batch))
    assert abs(got - want) <= 2e-2 * abs(want)
    # f32 masters, f32 LAMB state, the weight a cast of its master
    assert set(step.masters) == {n for n, _ in net.named_parameters()}
    for name, p in net.named_parameters():
        assert step.masters[name].dtype == torch.float32
        assert all(s.dtype == torch.float32 for s in step.opt_states[name])
        assert torch.equal(p.detach(), step.masters[name].to(torch.bfloat16))


def _lamb_case(seed, zero_weight=False):
    rng = np.random.RandomState(seed)
    w = rng.randn(6, 5).astype(np.float32)
    if zero_weight:
        w[:] = 0
    g = rng.randn(6, 5).astype(np.float32)
    m = (0.1 * rng.randn(6, 5)).astype(np.float32)
    v = np.abs(0.1 * rng.randn(6, 5)).astype(np.float32)
    return w, g, m, v


@pytest.mark.parametrize("zero_weight", [False, True])
@pytest.mark.parametrize("bias_correction", [True, False])
def test_lamb_update_core_matches_the_reference(bias_correction,
                                                zero_weight):
    kw = dict(learning_rate=0.01, bias_correction=bias_correction,
              rescale_grad=0.5, clip_gradient=1.0, lower_bound=1e-3,
              upper_bound=10.0)
    w, g, m, v = _lamb_case(3, zero_weight)
    jw, (jm, jv) = JLAMB(**kw).update_core(w, g, (m, v), 0.01, 0.1, 3)
    tw, (tm, tv) = optimizer.create("lamb", **kw).update_core(
        *(torch.from_numpy(x) for x in (w, g)),
        (torch.from_numpy(m), torch.from_numpy(v)), 0.01, 0.1, 3)
    for got, want in ((tw, jw), (tm, jm), (tv, jv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("sparse", [True, False])
def test_softmax_cross_entropy_matches_the_reference(sparse):
    rng = np.random.RandomState(4)
    pred = rng.randn(6, 3, 10).astype(np.float32)
    if sparse:
        label = rng.randint(0, 10, (6, 3)).astype(np.int32)
    else:
        label = rng.rand(6, 3, 10).astype(np.float32)
    weight = rng.rand(6, 3).astype(np.float32)
    want = gluon.loss.SoftmaxCrossEntropyLoss(sparse_label=sparse)(
        nd.array(pred), nd.array(label), nd.array(weight)).asnumpy()
    got = tloss.SoftmaxCrossEntropyLoss(sparse_label=sparse)(
        torch.from_numpy(pred), torch.from_numpy(label),
        torch.from_numpy(weight))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    assert tloss.PassThrough()(torch.ones(2), 5) is not None


def _port_step(net, **kw):
    return CompiledTrainStep(net, MLMLoss(), optimizer.create(
        "lamb", learning_rate=1e-3, wd=0.01), device="cpu", **kw)


def _fresh(seed=5):
    return BERTModel(_cfg(), device="cpu",
                     generator=torch.Generator().manual_seed(seed))


def test_accumulating_two_half_batches_equals_one_whole_step():
    whole = _batch(6, batch=4)
    halves = [tuple(x[i:i + 2] for x in whole) for i in (0, 2)]
    a, b = _fresh(), _fresh()
    _port_step(a).step(*whole)
    acc = _port_step(b, accum_steps=2)
    acc.step(*halves[0])
    assert acc._t == 0                       # no update on the microbatch
    acc.step(*halves[1])
    assert acc._t == 1
    for (name, pa), (_, pb) in zip(a.named_parameters(),
                                   b.named_parameters()):
        torch.testing.assert_close(pa, pb, rtol=1e-5, atol=1e-5, msg=name)


def test_state_dict_round_trip_resumes_the_same_losses():
    batches = [_batch(s) for s in (7, 8, 9)]
    step = _port_step(_fresh())
    step.step(*batches[0])
    snap = step.state_dict()
    first = [float(step.step(*b)) for b in batches[1:]]
    step.load_state_dict(snap)
    assert step.state_dict()["t"] == 1
    again = [float(step.step(*b)) for b in batches[1:]]
    assert first == again


def test_step_counts_its_telemetry_and_passes_none_through():
    telemetry.reset()
    step = _port_step(_fresh())
    tokens, types, _, pos, labels = _batch(10)
    for _ in range(2):
        loss = step.step(tokens, types, None, pos, labels)
    assert loss.dim() == 0 and torch.isfinite(loss)
    assert telemetry.get("train_step.steps").value == 2
    assert telemetry.get("train_step.recompiles").value == 1
    assert telemetry.get("train_step.examples_per_sec").value > 0
    assert step.recompiles == 1


def test_dropout_draws_come_from_the_explicit_generator():
    cfg = dict(_cfg(), dropout=0.1)
    batch = [torch.from_numpy(x) for x in _batch(11)[:4]]
    outs = []
    for _ in range(2):
        gen = torch.Generator().manual_seed(3)
        net = BERTModel(cfg, device="cpu", generator=gen)
        net.train()
        torch.manual_seed(0)          # the global RNG must not matter
        a = net(*batch)
        torch.manual_seed(1)
        outs.append((a, net(*batch)))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])
    assert not torch.equal(outs[0][0], outs[0][1])   # fresh masks a call
    net.eval()
    assert torch.equal(net(*batch), net(*batch))


def test_random_generators_and_seeds():
    g = random.generator("cpu")
    assert g is random.generator("cpu")
    random.seed(42)
    a = random.take_seed(g)
    random.seed(42)
    assert torch.equal(a, random.take_seed(g))
    assert a.shape == (1,) and a.dtype == torch.int32


def test_initializer_follows_the_reference_name_convention():
    net = _fresh()
    for name, p in net.named_parameters():
        if name.endswith(("bias", "beta")):
            assert torch.all(p == 0), name
        elif name.endswith("gamma"):
            assert torch.all(p == 1), name
        else:
            assert p.abs().max() <= 0.07 and p.std() > 0.03, name
    with pytest.raises(ValueError, match="registry"):
        initializer.create("kaiming")


def test_from_numpy_consumes_every_array_once():
    jnet, _ = _pair()
    params = {k: np.asarray(p.data()._data)
              for k, p in jnet.collect_params().items()}
    items = list(params.items())
    with pytest.raises(MXNetError, match="arrays for"):
        BERTModel.from_numpy(dict(items[:-1]), _cfg(), device="cpu")
    swapped = dict(items[:1] + items[2:3] + items[1:2] + items[3:])
    with pytest.raises(MXNetError, match="does not match"):
        BERTModel.from_numpy(swapped, _cfg(), device="cpu")
    bad = dict(params)
    key = items[1][0]
    bad[key] = bad[key][:-1]
    with pytest.raises(MXNetError, match="shape"):
        BERTModel.from_numpy(bad, _cfg(), device="cpu")


def test_bert_refuses_what_is_not_ported():
    from tpu_mx_torch.parallel import make_mesh
    # a policy factory's name constructs and its first step raises jax's
    # TypeError, in both packages (fault C20)
    cfg = dict(_cfg(), num_layers=1)
    batch = _batch()
    step = CompiledTrainStep(
        BERTModel(cfg, device="cpu", remat=True,
                  remat_policy="save_only_these_names"),
        MLMLoss(), optimizer.create("lamb"), device="cpu")
    with pytest.raises(TypeError, match="save_only_these_names\\(\\) got an "
                       "unexpected keyword argument 'dimension_numbers'"):
        step.step(*batch)
    mx.random.seed(0)
    jnet = JBERTModel(cfg, remat=True, remat_policy="save_only_these_names")
    jnet.initialize()
    jstep = JCompiledTrainStep(jnet, JMLMLoss(), mx.optimizer.create("lamb"))
    with pytest.raises(TypeError, match="save_only_these_names\\(\\) got an "
                       "unexpected keyword argument 'dimension_numbers'"):
        jstep.step(*_nd(batch))
    # a mesh above one rank needs the ranks' process group, and a mesh is
    # a parallel.make_mesh Mesh (the multi-rank step: test_torch_mesh_train)
    with pytest.raises(MXNetError, match="no process group"):
        make_mesh({"dp": 2, "tp": 1}, devices=["cpu"])
    with pytest.raises(MXNetError, match="make_mesh Mesh"):
        CompiledTrainStep(_fresh(), MLMLoss(), optimizer.create("lamb"),
                          mesh=object(), device="cpu")
