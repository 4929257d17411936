"""``CompiledTrainStep`` over a mesh of 4 ``gloo`` ranks on the CPU:
data, tensor, sequence and expert parallelism, FSDP, the compressed
reduction, accumulation, the resharding checkpoint, ``reshard_live``
and ``dryrun_multichip``, held to the reference.

The ranks are one pool of 4 spawned processes for the file
(``test_torch_mesh.RankPool``); the rank functions import no jax.  The
data-parallel step and the compressed reduction are held to the
reference's own mesh program (a dp=4 mesh of its virtual CPU devices);
the tensor-, sequence- and expert-parallel steps, FSDP and the BERT
steps to the reference's one-device step on the same weights and
batch, which its own tests hold its mesh programs to.

Tolerances: losses 1e-5 relative (f32; the mesh reassociates the batch
and head sums), weights 1e-4 (the reference's BERT parity tolerance),
2e-4 / 2e-5 for the Dense nets' weights (its own dp-vs-one-device
tolerance), compressed runs 1e-3 relative of the loss (a quantization
bucket edge can flip one value between two f32 reassociations).
"""
import numpy as np
import pytest
import torch

from test_torch_mesh import RankPool

LOSS_RTOL = 1e-5
W_TOL = 1e-4
WORLD = 4


@pytest.fixture(scope="module")
def pool():
    p = RankPool(WORLD)
    yield p
    p.close()


def _np(t):
    return t.detach().float().numpy().copy()


# -- Dense nets: the reference's and the port's, one set of weights ------------
def _dense_params(widths, seed):
    rng = np.random.RandomState(seed)
    out = {}
    for i, (a, b) in enumerate(zip(widths[:-1], widths[1:])):
        out[f"dense{i}_weight"] = (rng.randn(b, a) * 0.3).astype(np.float32)
        out[f"dense{i}_bias"] = (rng.randn(b) * 0.1).astype(np.float32)
    return out


def _port_dense(params, act="relu"):
    from tpu_mx_torch.gluon import nn
    from tpu_mx_torch.gluon.block import load_numpy
    ws = [v for k, v in params.items() if k.endswith("weight")]
    net = nn.HybridSequential()
    for i, w in enumerate(ws):
        last = i == len(ws) - 1
        net.add(nn.Dense(w.shape[0], in_units=w.shape[1],
                         activation=None if last else act,
                         generator=torch.Generator()))
    load_numpy(net, params)
    return net


def _ref_dense(params, act="relu"):
    from tpu_mx import nd
    from tpu_mx.gluon import nn as jnn
    ws = [v for k, v in params.items() if k.endswith("weight")]
    net = jnn.HybridSequential()
    for i, w in enumerate(ws):
        last = i == len(ws) - 1
        net.add(jnn.Dense(w.shape[0], in_units=w.shape[1],
                          activation=None if last else act))
    net.initialize()
    net(nd.ones((1, ws[0].shape[1])))
    for (k, p), v in zip(net.collect_params().items(), params.values()):
        p.set_data(nd.array(v))
    return net


def _xy(seed, n, d, classes):
    rng = np.random.RandomState(seed)
    return (rng.rand(n, d).astype(np.float32),
            rng.randint(0, classes, (n,)).astype(np.float32))


def _ref_losses(params, batches, mesh_axes=None, rules=None, opt=None,
                act="relu", **kw):
    """The reference's step on ``batches``: losses and final weights."""
    import tpu_mx as mx
    from tpu_mx import gluon, nd
    from tpu_mx.parallel import CompiledTrainStep as JStep
    mesh = None
    if mesh_axes:
        import jax
        from tpu_mx.parallel import make_mesh as jmake
        n = int(np.prod(list(mesh_axes.values())))
        mesh = jmake(mesh_axes, devices=jax.devices()[:n])
    net = _ref_dense(params, act)
    name, args = opt or ("sgd", {"learning_rate": 0.1, "momentum": 0.9})
    step = JStep(net, gluon.loss.SoftmaxCrossEntropyLoss(),
                 mx.optimizer.create(name, **args), mesh=mesh, rules=rules,
                 **kw)
    losses = [float(np.asarray(step.step(nd.array(x), nd.array(y))._data))
              for x, y in batches]
    step.sync_to_net()
    return losses, [p.data().asnumpy()
                    for p in net.collect_params().values()]


def _rank_dense(params, batches, axes, rules=None, opt=None, act="relu",
                kw=None):
    from tpu_mx_torch import optimizer
    from tpu_mx_torch.gluon import loss as gloss
    from tpu_mx_torch.parallel import CompiledTrainStep, make_mesh
    mesh = make_mesh(axes) if axes else None
    net = _port_dense(params, act)
    name, args = opt or ("sgd", {"learning_rate": 0.1, "momentum": 0.9})
    step = CompiledTrainStep(net, gloss.SoftmaxCrossEntropyLoss(),
                             optimizer.create(name, **args), mesh=mesh,
                             rules=rules, device="cpu", **(kw or {}))
    shapes = lambda: {k: tuple(s.shape) for k, s in step.opt_states.items()
                      if isinstance(s, torch.Tensor)}
    step.place()
    placed = shapes()
    losses = [float(step.step(torch.tensor(x), torch.tensor(y)))
              for x, y in batches]
    return {"losses": losses, "weights": [_np(p) for p in net.parameters()],
            "placed_shapes": placed, "state_shapes": shapes()}


def _assert_dense(got, want, wtol=(2e-4, 2e-5)):
    losses, weights = want
    np.testing.assert_allclose(got["losses"], losses, rtol=LOSS_RTOL)
    for a, b in zip(got["weights"], weights):
        np.testing.assert_allclose(a, b, rtol=wtol[0], atol=wtol[1])


def test_dp_step_matches_the_references_dp_mesh(pool):
    """The reference's dp test at its shapes (8 examples, Dense 16-4,
    SGD with momentum, 3 steps) on dp=4: the reference's dp=4 program and
    the port's 4 ranks."""
    params = _dense_params((8, 16, 4), 3)
    x, y = _xy(0, 8, 8, 4)
    batches = [(x, y)] * 3
    want = _ref_losses(params, batches, {"dp": 4})
    for got in pool.run(_rank_dense, params, batches, {"dp": 4}):
        _assert_dense(got, want)
    one = _ref_losses(params, batches)           # and the one-device step
    np.testing.assert_allclose(want[0], one[0], rtol=LOSS_RTOL)


def test_tp_rules_match_the_one_device_step(pool):
    """Megatron-style rules on a Dense stack over dp=2 x tp=2 (the
    reference's test_tp_sharded_dense_matches): the losses of the
    unsharded step; the masters and momentum of the split weights are
    the ranks' blocks."""
    from tpu_mx_torch.parallel import P
    params = _dense_params((16, 32, 8), 5)
    x = np.random.RandomState(2).rand(8, 16).astype(np.float32)
    batches = [(x, np.zeros(8, np.float32))] * 2
    rules = [(r"^0\.weight$", P("tp", None)), (r"^0\.bias$", P("tp"))]
    want = _ref_losses(params, batches, opt=("sgd", {"learning_rate": 0.1}))
    for got in pool.run(_rank_dense, params, batches, {"dp": 2, "tp": 2},
                        rules, ("sgd", {"learning_rate": 0.1,
                                        "momentum": 0.9})):
        np.testing.assert_allclose(got["losses"][0], want[0][0],
                                   rtol=LOSS_RTOL)
        assert got["state_shapes"]["0.weight"] == (16, 16)
        assert got["state_shapes"]["1.weight"] == (8, 32)
        assert got["placed_shapes"] == got["state_shapes"]   # place()
    got = pool.run(_rank_dense, params, batches, {"dp": 2, "tp": 2}, rules,
                   ("sgd", {"learning_rate": 0.1}))
    for g in got:
        _assert_dense(g, want)


def test_fsdp_rules_match_the_replicated_step(pool):
    """fsdp_rules over dp=4 (the reference's test at its shapes): the
    losses and weights of the reference's one-device step; every large
    parameter's momentum is the rank's quarter."""
    from tpu_mx_torch.parallel import fsdp_rules
    params = _dense_params((16, 64, 4), 31)
    batches = [_xy(0, 16, 16, 4)] * 4
    shapes = {"0.weight": (64, 16), "0.bias": (64,), "1.weight": (4, 64),
              "1.bias": (4,)}
    rules = fsdp_rules({k: np.zeros(s) for k, s in shapes.items()},
                       min_size=256, axis_size=4)
    assert [r[0] for r in rules] == [r"^0\.weight$", r"^1\.weight$"]
    want = _ref_losses(params, batches)
    for got in pool.run(_rank_dense, params, batches, {"dp": 4}, rules):
        _assert_dense(got, want)
        assert got["state_shapes"] == {"0.weight": (16, 16),
                                       "0.bias": (64,),
                                       "1.weight": (4, 16), "1.bias": (4,)}


@pytest.mark.parametrize("ctype", ["2bit", "int8", "fp8"])
def test_compressed_reduction_matches_the_references_mesh(pool, ctype):
    """The reference's compressed in-step reduction at its shapes (16
    examples, Dense 8-16-4, SGD 0.1, threshold 0.05) on dp=4, 6 steps:
    the port's ranks quantize their own gradients with their own error
    feedback as the reference's devices do."""
    params = _dense_params((8, 16, 4), 5)
    batches = [_xy(2, 16, 8, 4)] * 6
    comp = {"type": ctype, "threshold": 0.05}
    opt = ("sgd", {"learning_rate": 0.1})
    want = _ref_losses(params, batches, {"dp": 4}, opt=opt,
                       gradient_compression=comp)
    plain = _ref_losses(params, batches, opt=opt)
    assert want[0][-1] < want[0][0]
    for got in pool.run(_rank_dense, params, batches, {"dp": 4}, None, opt,
                        "relu", {"gradient_compression": comp}):
        np.testing.assert_allclose(got["losses"], want[0], rtol=1e-3)
        assert abs(got["losses"][-1] - plain[0][-1]) < 0.35 * plain[0][0]


def _rank_compression_refusals():
    from tpu_mx_torch import optimizer
    from tpu_mx_torch.gluon import loss as gloss
    from tpu_mx_torch.parallel import CompiledTrainStep, P, make_mesh
    net = _port_dense(_dense_params((8, 8), 0))
    loss, opt = gloss.SoftmaxCrossEntropyLoss(), optimizer.create("sgd")
    cases = [(None, None, None, {"type": "2bit"}),
             ({"dp": 2, "tp": 2}, [("weight", P("tp", None))], None,
              {"type": "2bit"}),
             ({"dp": 4}, None, None, {"type": "4bit"}),
             ({"dp": 2, "sp": 2}, None, (P(("dp", "sp")), P(("dp", "sp"))),
              {"type": "int8"})]
    out = []
    for axes, rules, specs, comp in cases:
        try:
            CompiledTrainStep(net, loss, opt, device="cpu", rules=rules,
                              mesh=make_mesh(axes) if axes else None,
                              data_specs=specs, gradient_compression=comp)
            out.append("no raise")
        except ValueError as e:
            out.append(str(e))
    return out


def test_compression_refuses_what_the_reference_refuses(pool):
    for msgs in pool.run(_rank_compression_refusals):
        for msg, want in zip(msgs, ["mesh", "pure-DP", "type", "'dp' only"]):
            assert want in msg, msgs


def _rank_compress_once():
    """accum_steps=2 + int8 compression against int8 compression of the
    two microbatches' concatenation (the reference's equivalence), on
    dp=4: the microbatch step moves no weight, the applied update is the
    concatenation's, and the combined mode learns."""
    from tpu_mx_torch import optimizer
    from tpu_mx_torch.gluon import loss as gloss
    from tpu_mx_torch.parallel import CompiledTrainStep, make_mesh
    mesh = make_mesh({"dp": 4})
    params = _dense_params((8, 16, 4), 21)
    rng = np.random.RandomState(0)
    x1, x2 = (torch.tensor(rng.rand(8, 8).astype(np.float32))
              for _ in range(2))
    y1, y2 = (torch.tensor(rng.randint(0, 4, (8,)).astype(np.float32))
              for _ in range(2))

    def make(accum):
        net = _port_dense(params, "tanh")
        return net, CompiledTrainStep(
            net, gloss.SoftmaxCrossEntropyLoss(),
            optimizer.create("sgd", learning_rate=0.1), mesh=mesh,
            gradient_compression={"type": "int8"}, accum_steps=accum,
            device="cpu")
    weights = lambda net: [_np(p) for p in net.parameters()]
    net_a, a = make(1)
    a.step(torch.cat([x1, x2]), torch.cat([y1, y2]))
    net_b, b = make(2)
    w0 = weights(net_b)
    b.step(x1, y1)
    mid = weights(net_b)
    b.step(x2, y2)
    out = {"a": weights(net_a), "b": weights(net_b), "w0": w0, "mid": mid}
    losses = []
    for _ in range(6):
        b.step(x1, y1)
        losses.append(float(b.step(x2, y2)))
    out["losses"] = losses
    return out


def test_compressed_accumulation_compresses_once_per_update(pool):
    for o in pool.run(_rank_compress_once):
        for v0, vm in zip(o["w0"], o["mid"]):
            np.testing.assert_array_equal(v0, vm)
        for va, vb in zip(o["a"], o["b"]):
            np.testing.assert_allclose(va, vb, rtol=1e-3, atol=1e-4)
        assert o["losses"][-1] < o["losses"][0]


def _rank_accumulation():
    """accum_steps=3 on dp=2 x tp=2 (a rule splitting the first weight)
    == one step on the three microbatches' concatenation at world size
    one; and Adam with accumulation learns on the mesh."""
    from tpu_mx_torch import optimizer
    from tpu_mx_torch.gluon import loss as gloss
    from tpu_mx_torch.parallel import CompiledTrainStep, P, make_mesh
    params = _dense_params((6, 16, 3), 9)
    rng = np.random.RandomState(4)
    micro = [(torch.tensor(rng.rand(4, 6).astype(np.float32)),
              torch.tensor(rng.randint(0, 3, (4,)).astype(np.float32)))
             for _ in range(3)]
    mesh = make_mesh({"dp": 2, "tp": 2})
    out = {}
    for name, kw, batches in (
            ("accum", dict(mesh=mesh, accum_steps=3,
                           rules=[(r"^0\.weight$", P("tp", None))]), micro),
            ("big", {}, [(torch.cat([m[0] for m in micro]),
                          torch.cat([m[1] for m in micro]))])):
        net = _port_dense(params, "tanh")
        step = CompiledTrainStep(
            net, gloss.SoftmaxCrossEntropyLoss(),
            optimizer.create("sgd", learning_rate=0.1, momentum=0.9),
            device="cpu", **kw)
        for x, y in batches:
            step.step(x, y)
        out[name] = ([_np(p) for p in net.parameters()], step._t)
    net = _port_dense(params, "relu")
    step = CompiledTrainStep(net, gloss.SoftmaxCrossEntropyLoss(),
                             optimizer.create("adam", learning_rate=3e-3),
                             mesh=make_mesh({"dp": 4}), accum_steps=2,
                             device="cpu")
    x = torch.tensor(np.random.RandomState(0).rand(8, 6).astype(np.float32))
    y = torch.tensor(np.random.RandomState(1).randint(0, 3, (8,))
                     .astype(np.float32))
    out["learn"] = [float(step.step(x, y)) for _ in range(20)]
    out["learn_t"] = step._t
    return out


def test_accumulation_on_a_mesh_matches_the_big_batch(pool):
    for o in pool.run(_rank_accumulation):
        (wa, ta), (wb, tb) = o["accum"], o["big"]
        assert ta == tb == 1
        for a, b in zip(wa, wb):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
        assert o["learn_t"] == 10 and o["learn"][-1] < o["learn"][0]


def _rank_checkpoint(path):
    """Save on dp=2 x tp=2 with rules splitting both weights, load onto
    dp=4 (replicated): the next step's loss is the one the first mesh
    takes (the reference's dp2 x tp4 -> dp8 test, on 4 ranks)."""
    from tpu_mx_torch import optimizer
    from tpu_mx_torch.gluon import loss as gloss
    from tpu_mx_torch.parallel import CompiledTrainStep, P, make_mesh
    params = _dense_params((8, 16, 4), 11)
    x = torch.tensor(np.random.RandomState(1).rand(8, 8).astype(np.float32))
    y = torch.tensor([0, 1, 2, 3, 0, 1, 2, 3], dtype=torch.float32)

    def make(mesh, rules):
        return CompiledTrainStep(
            _port_dense(params), gloss.SoftmaxCrossEntropyLoss(),
            optimizer.create("sgd", learning_rate=0.1, momentum=0.9),
            mesh=mesh, rules=rules, device="cpu")
    a = make(make_mesh({"dp": 2, "tp": 2}),
             [(r"^0\.weight$", P("tp", None)), (r"^1\.weight$",
                                                P(None, "tp"))])
    a.step(x, y)
    a.step(x, y)
    a.save_checkpoint(path)
    ref = float(a.step(x, y))
    b = make(make_mesh({"dp": 4}), None)
    b.step(x, y)                      # moves the state: the load replaces it
    b.load_checkpoint(path)
    return {"t": b._t, "ref": ref, "loss": float(b.step(x, y))}


def test_checkpoint_saved_on_one_mesh_loads_onto_another(pool, tmp_path):
    path = str(tmp_path / "ck")
    for o in pool.run(_rank_checkpoint, path):
        assert o["t"] == 2
        assert abs(o["loss"] - o["ref"]) < 1e-6, o
    # and onto one process: the file holds whole tensors
    from tpu_mx_torch import optimizer
    from tpu_mx_torch.gluon import loss as gloss
    from tpu_mx_torch.parallel import CompiledTrainStep
    step = CompiledTrainStep(_port_dense(_dense_params((8, 16, 4), 11)),
                             gloss.SoftmaxCrossEntropyLoss(),
                             optimizer.create("sgd", learning_rate=0.1,
                                              momentum=0.9), device="cpu")
    step.load_checkpoint(path)
    x = torch.tensor(np.random.RandomState(1).rand(8, 8).astype(np.float32))
    y = torch.tensor([0, 1, 2, 3, 0, 1, 2, 3], dtype=torch.float32)
    assert abs(float(step.step(x, y)) - o["ref"]) < 1e-5


def _rank_reshard_live():
    """A one-process step resharded live onto two ranks (dp=2 on ranks 0
    and 1; ranks 2 and 3 keep theirs): the state carries over whole and
    the next loss is the one-process step's."""
    from tpu_mx_torch import optimizer
    from tpu_mx_torch.gluon import loss as gloss
    from tpu_mx_torch.parallel import CompiledTrainStep, fleet, make_mesh
    params = _dense_params((4, 8, 2), 7)
    rng = np.random.RandomState(7)
    x = torch.tensor(rng.rand(8, 4).astype(np.float32))
    y = torch.tensor(rng.randint(0, 2, (8,)).astype(np.float32))

    def make(mesh=None):
        return CompiledTrainStep(
            _port_dense(params), gloss.SoftmaxCrossEntropyLoss(),
            optimizer.create("sgd", learning_rate=0.1, momentum=0.9),
            mesh=mesh, device="cpu")
    one = make()
    for _ in range(3):
        one.step(x, y)
    mesh = make_mesh({"dp": 2}, devices=[0, 1])     # every rank makes it
    if mesh.coords is None:
        return None
    two = fleet.reshard_live(one, lambda: make(mesh), from_world=1,
                             to_world=2)
    same = all(torch.equal(a, b) for a, b in
               zip(one.state_dict()["values"].values(),
                   two.state_dict()["values"].values()))
    return {"same": same, "t": two._t, "one": float(one.step(x, y)),
            "two": float(two.step(x, y))}


def test_reshard_live_onto_two_ranks(pool):
    res = pool.run(_rank_reshard_live)
    assert res[2] is None and res[3] is None
    for o in res[:2]:
        assert o["same"] and o["t"] == 3
        assert abs(o["one"] - o["two"]) < 1e-6


# -- BERT on dp x sp x tp -------------------------------------------------------
def _bert_cfg():
    from tpu_mx_torch.models.bert import bert_base_config
    cfg = bert_base_config(vocab_size=100, max_len=64)
    cfg.update(num_layers=2, units=64, hidden_size=128, num_heads=4,
               dropout=0.0)
    return cfg


def _bert_batch():
    rng = np.random.RandomState(0)
    tokens = rng.randint(4, 100, (4, 32)).astype(np.int64)
    types = rng.randint(0, 2, (4, 32)).astype(np.int64)
    valid = np.array([32, 20, 9, 27], np.int64)
    labels = rng.randint(0, 100, (4, 32)).astype(np.float32)
    return tokens, types, valid, labels


BERT_CASES = {
    # name: (mesh axes, rules, sp strategy)
    "dp1_sp2_tp2_ring": ({"dp": 1, "sp": 2, "tp": 2}, True, "ring"),
    "dp2_sp2_ulysses": ({"dp": 2, "sp": 2}, False, "ulysses"),
    "dp2_tp2": ({"dp": 2, "tp": 2}, True, "ring"),
    "sp4_ring": ({"sp": 4}, False, "ring"),
}


def _rank_bert(params, case):
    from tpu_mx_torch import optimizer
    from tpu_mx_torch.gluon import loss as gloss
    from tpu_mx_torch.models.bert import (BERTModel, bert_sharding_rules)
    from tpu_mx_torch.parallel import (CompiledTrainStep, P, dispatch_counts,
                                       make_mesh, set_sp_strategy)
    axes, rules, strategy = BERT_CASES[case]
    mesh = make_mesh(axes)
    net = BERTModel.from_numpy(params, _bert_cfg(), device="cpu", mesh=mesh)
    specs = (P("dp", "sp"), P("dp", "sp"), P("dp"), P("dp", "sp"))
    step = CompiledTrainStep(
        net, gloss.SoftmaxCrossEntropyLoss(),
        optimizer.create("lamb", learning_rate=1e-3, wd=0.01), mesh=mesh,
        rules=bert_sharding_rules() if rules else None, data_specs=specs,
        device="cpu")
    prev = set_sp_strategy(strategy)
    before = dict(dispatch_counts)
    try:
        losses = [float(step.step(*(torch.tensor(a) for a in _bert_batch())))
                  for _ in range(2)]
    finally:
        set_sp_strategy(prev)
    return {"losses": losses, "weights": [_np(p) for p in net.parameters()],
            "arms": {k: dispatch_counts[k] - before[k]
                     for k in dispatch_counts}}


@pytest.fixture(scope="module")
def bert_reference():
    """The reference's one-device BERT: its weights, and its two LAMB
    steps' losses and weights."""
    import tpu_mx as mx
    from tpu_mx import gluon, nd
    from tpu_mx.models.bert import BERTModel as JBERT
    from tpu_mx.parallel import CompiledTrainStep as JStep
    mx.random.seed(0)
    jnet = JBERT(_bert_cfg())
    jnet.initialize()
    params = {k: np.asarray(p.data()._data)
              for k, p in jnet.collect_params().items()}
    step = JStep(jnet, gluon.loss.SoftmaxCrossEntropyLoss(),
                 mx.optimizer.create("lamb", learning_rate=1e-3, wd=0.01))
    tokens, types, valid, labels = _bert_batch()
    batch = [nd.array(tokens.astype(np.int32)),
             nd.array(types.astype(np.int32)),
             nd.array(valid.astype(np.int32)), nd.array(labels)]
    losses = [float(np.asarray(step.step(*batch)._data)) for _ in range(2)]
    weights = [np.asarray(step.values[k]) for k in params]
    return params, losses, weights


@pytest.mark.parametrize("case", sorted(BERT_CASES))
def test_bert_step_on_a_mesh_matches_the_one_device_step(pool, case,
                                                         bert_reference):
    params, losses, weights = bert_reference
    axes, _, strategy = BERT_CASES[case]
    for got in pool.run(_rank_bert, params, case):
        np.testing.assert_allclose(got["losses"], losses, rtol=LOSS_RTOL)
        for a, b in zip(got["weights"], weights):
            np.testing.assert_allclose(a, b, rtol=W_TOL, atol=W_TOL)
        if axes.get("sp", 1) > 1:
            arm = "ulysses" if strategy == "ulysses" else "ring"
            assert got["arms"][arm] >= 1, got["arms"]


# -- experts over ep -------------------------------------------------------------
def _moe_params():
    import math
    rng = np.random.RandomState(3)
    u, h, e = 8, 16, 4
    lim = lambda fan_in, fan_out: math.sqrt(6.0 / (fan_in + fan_out))
    return {"gate_weight": rng.uniform(-lim(u, e), lim(u, e), (e, u)),
            "expert_w1": rng.uniform(-0.3, 0.3, (e, h, u)),
            "expert_b1": np.zeros((e, h)),
            "expert_w2": rng.uniform(-0.3, 0.3, (e, u, h)),
            "expert_b2": np.zeros((e, u))}


def _moe_data():
    rng = np.random.RandomState(3)
    return (rng.randn(8, 4, 8).astype(np.float32),
            (rng.randn(8, 4, 8) * 0.1).astype(np.float32))


def _rank_moe(ep, top_k):
    from tpu_mx_torch import optimizer
    from tpu_mx_torch.gluon import loss as gloss
    from tpu_mx_torch.parallel import (CompiledTrainStep, MoEFFN, P,
                                       make_mesh, moe_sharding_rules)

    class Net(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.moe = MoEFFN(8, 16, 4, top_k=top_k,
                              generator=torch.Generator())

        def forward(self, x, target):
            y, aux = self.moe(x)
            return ((y - target) ** 2).mean() + 0.01 * aux

    net = Net()
    with torch.no_grad():
        for k, v in _moe_params().items():
            net.moe._parameters[k].copy_(torch.tensor(v))
    mesh = make_mesh({"ep": ep}, devices=list(range(ep)))
    if mesh.coords is None:
        return None
    step = CompiledTrainStep(net, gloss.PassThrough(),
                             optimizer.create("sgd", learning_rate=0.1),
                             mesh=mesh, rules=moe_sharding_rules(),
                             data_specs=(P("dp"), P("dp"), P()),
                             device="cpu")
    x, t = (torch.tensor(a) for a in _moe_data())
    return [float(step.step(x, t, torch.zeros(1))) for _ in range(5)]


@pytest.mark.parametrize("ep,top_k", [(2, 1), (4, 2)])
def test_moe_experts_over_ep_match_the_one_device_layer(pool, ep, top_k):
    """The reference's ep test's layer and data (8 x 4 tokens of 8 units,
    4 experts, SGD 0.1, 5 steps) with the experts split over ep: the
    losses of the reference's one-device step."""
    import tpu_mx as mx
    from tpu_mx import gluon, nd
    from tpu_mx.gluon.block import HybridBlock
    from tpu_mx.parallel import CompiledTrainStep as JStep
    from tpu_mx.parallel import MoEFFN as JMoE

    class JNet(HybridBlock):
        def __init__(self, **kw):
            super().__init__(**kw)
            self.moe = JMoE(8, 16, 4, top_k=top_k)

        def forward(self, x, target):
            y, aux = self.moe(x)
            return nd.mean(nd.square(y - target)) + 0.01 * aux

    x, t = _moe_data()
    net = JNet()
    net.initialize()
    net(nd.array(x), nd.array(t))
    for (k, p), v in zip(net.collect_params().items(),
                         _moe_params().values()):
        p.set_data(nd.array(v.astype(np.float32)))
    step = JStep(net, gluon.loss.PassThrough(),
                 mx.optimizer.create("sgd", learning_rate=0.1))
    want = [float(np.asarray(step.step(nd.array(x), nd.array(t),
                                       nd.array(np.zeros(1, np.float32)))
                             ._data).ravel()[0]) for _ in range(5)]
    res = pool.run(_rank_moe, ep, top_k)
    for got in res[:ep]:
        np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)


# -- C22, C23: batch statistics of the global batch under dp -------------------------
# dp=2 on ranks 0 and 1 of the pool (ranks 2 and 3 sit the mesh out):
# BatchNorm's statistics and the MoE routing of the two ranks' batches
# are the global batch's, as in the reference's dp=2 mesh program.
DP2 = {"dp": 2}


def _bn_params(seed):
    rng = np.random.RandomState(seed)
    return {"dense0_weight": (rng.randn(16, 8) * 0.3).astype(np.float32),
            "dense0_bias": (rng.randn(16) * 0.1).astype(np.float32),
            "batchnorm0_gamma": (1 + rng.randn(16) * 0.1).astype(np.float32),
            "batchnorm0_beta": (rng.randn(16) * 0.1).astype(np.float32),
            "batchnorm0_running_mean": np.zeros(16, np.float32),
            "batchnorm0_running_var": np.ones(16, np.float32),
            "dense1_weight": (rng.randn(4, 16) * 0.3).astype(np.float32),
            "dense1_bias": (rng.randn(4) * 0.1).astype(np.float32)}


def _bn_batches():
    """Two ranks' halves whose statistics differ: the second half is
    shifted and scaled, so per-rank and global normalization part."""
    x, y = _xy(7, 8, 8, 4)
    x[4:] = x[4:] * 3.0 + 1.5
    return [(x, y)] * 3


def _ref_bn_step(params, batches, mesh_axes, sync=False):
    """The reference's Dense-BatchNorm-Dense step (``sync``: its
    ``gluon.contrib.nn.SyncBatchNorm`` in BatchNorm's place): losses, and
    its parameters and running statistics after the steps."""
    import jax
    import tpu_mx as mx
    from tpu_mx import gluon, nd
    from tpu_mx.gluon import nn as jnn
    from tpu_mx.gluon.contrib import nn as jcnn
    from tpu_mx.parallel import CompiledTrainStep as JStep
    from tpu_mx.parallel import make_mesh as jmake
    net = jnn.HybridSequential()
    norm = jcnn.SyncBatchNorm(in_channels=16, num_devices=2) if sync \
        else jnn.BatchNorm(in_channels=16)
    net.add(jnn.Dense(16, in_units=8), norm,
            jnn.Activation("relu"), jnn.Dense(4, in_units=16))
    net.initialize()
    net(nd.ones((2, 8)))
    for p, v in zip(net.collect_params().values(), params.values()):
        p.set_data(nd.array(v))
    n = int(np.prod(list(mesh_axes.values())))
    step = JStep(net, gluon.loss.SoftmaxCrossEntropyLoss(),
                 mx.optimizer.create("sgd", learning_rate=0.1, momentum=0.9),
                 mesh=jmake(mesh_axes, devices=jax.devices()[:n]))
    losses = [float(np.asarray(step.step(nd.array(x), nd.array(y))._data))
              for x, y in batches]
    step.sync_to_net()
    return losses, [p.data().asnumpy()
                    for p in net.collect_params().values()]


def _rank_bn_step(params, batches, onepass, sync=False):
    import os
    from tpu_mx_torch import optimizer
    from tpu_mx_torch.gluon import loss as gloss
    from tpu_mx_torch.gluon import nn
    from tpu_mx_torch.gluon.block import load_numpy
    from tpu_mx_torch.gluon.contrib import nn as cnn
    from tpu_mx_torch.parallel import CompiledTrainStep, make_mesh
    mesh = make_mesh(DP2, devices=[0, 1])
    if mesh.coords is None:
        return None
    norm = cnn.SyncBatchNorm(in_channels=16, num_devices=2,
                             generator=torch.Generator()) if sync \
        else nn.BatchNorm(in_channels=16, generator=torch.Generator())
    net = nn.HybridSequential()
    net.add(nn.Dense(16, in_units=8, generator=torch.Generator()), norm,
            nn.Activation("relu"),
            nn.Dense(4, in_units=16, generator=torch.Generator()))
    load_numpy(net, params)
    step = CompiledTrainStep(net, gloss.SoftmaxCrossEntropyLoss(),
                             optimizer.create("sgd", learning_rate=0.1,
                                              momentum=0.9),
                             mesh=mesh, device="cpu")
    old = os.environ.get("TPUMX_BN_ONEPASS")
    os.environ["TPUMX_BN_ONEPASS"] = onepass
    try:
        losses = [float(step.step(torch.tensor(x), torch.tensor(y)))
                  for x, y in batches]
    finally:
        if old is None:
            os.environ.pop("TPUMX_BN_ONEPASS")
        else:
            os.environ["TPUMX_BN_ONEPASS"] = old
    # the reference's order: dense0, gamma, beta, the running statistics,
    # dense1
    ps = [_np(p) for p in net.parameters()]
    stats = [_np(net[1]._buffers[k]) for k in ("running_mean",
                                                 "running_var")]
    return {"losses": losses, "values": ps[:4] + stats + ps[4:]}


@pytest.mark.parametrize("onepass", ["1", "0"])
def test_batchnorm_under_dp_normalizes_the_global_batch(pool, monkeypatch,
                                                        onepass):
    """C22: a Dense-BatchNorm net on dp=2 (both ``TPUMX_BN_ONEPASS``
    forms) against the reference's dp=2 mesh program: the losses, the
    weights after three momentum-SGD steps (the input gradient through
    the statistics) and the running statistics are the global batch's."""
    monkeypatch.setenv("TPUMX_BN_ONEPASS", onepass)
    params = _bn_params(11)
    batches = _bn_batches()
    want = _ref_bn_step(params, batches, DP2)
    got = pool.run(_rank_bn_step, params, batches, onepass)
    for g in got[:2]:
        np.testing.assert_allclose(g["losses"], want[0], rtol=LOSS_RTOL)
        for a, b in zip(g["values"], want[1]):
            np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-5)
    assert got[2] is None and got[3] is None


def test_sync_batchnorm_under_dp_normalizes_the_global_batch(pool):
    """``gluon.contrib.nn.SyncBatchNorm`` (``tests/test_contrib_layers.py``'s
    global-statistics property) on dp=2 against the reference's
    SyncBatchNorm in its dp=2 mesh program, and against one device: the
    two halves of the batch differ in scale and shift, so per-rank
    statistics would part from the global batch's."""
    params = _bn_params(13)
    batches = _bn_batches()
    want = _ref_bn_step(params, batches, DP2, sync=True)
    one = _ref_bn_step(params, batches, {"dp": 1}, sync=True)
    got = pool.run(_rank_bn_step, params, batches, "1", True)
    np.testing.assert_allclose(want[0], one[0], rtol=LOSS_RTOL)
    for g in got[:2]:
        np.testing.assert_allclose(g["losses"], want[0], rtol=LOSS_RTOL)
        for a, b in zip(g["values"], want[1]):
            np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-5)
    assert got[2] is None and got[3] is None


# the load-balance term weighs as much as the task here, so that its
# gradient (through the global mean_prob) moves the losses measurably
MOE_DP_AUX = 0.5


def _ref_moe_mesh(top_k, cf, axes=DP2, spec=("dp",)):
    import jax
    import tpu_mx as mx
    from tpu_mx import gluon, nd
    from tpu_mx.gluon.block import HybridBlock
    from tpu_mx.parallel import CompiledTrainStep as JStep
    from tpu_mx.parallel import MoEFFN as JMoE
    from tpu_mx.parallel import P as JP
    from tpu_mx.parallel import make_mesh as jmake

    class JNet(HybridBlock):
        def __init__(self, **kw):
            super().__init__(**kw)
            self.moe = JMoE(8, 16, 4, top_k=top_k, capacity_factor=cf)

        def forward(self, x, target):
            y, aux = self.moe(x)
            return nd.mean(nd.square(y - target)) + MOE_DP_AUX * aux

    x, t = _moe_data()
    net = JNet()
    net.initialize()
    net(nd.array(x), nd.array(t))
    for p, v in zip(net.collect_params().values(), _moe_params().values()):
        p.set_data(nd.array(v.astype(np.float32)))
    n = int(np.prod(list(axes.values())))
    step = JStep(net, gluon.loss.PassThrough(),
                 mx.optimizer.create("sgd", learning_rate=0.1),
                 mesh=jmake(axes, devices=jax.devices()[:n]),
                 data_specs=(JP(*spec), JP(*spec), JP()))
    return [float(np.asarray(step.step(nd.array(x), nd.array(t),
                                       nd.array(np.zeros(1, np.float32)))
                             ._data).ravel()[0]) for _ in range(5)]


def _rank_moe_mesh(top_k, cf, axes=DP2, spec=("dp",)):
    from tpu_mx_torch import optimizer
    from tpu_mx_torch.gluon import loss as gloss
    from tpu_mx_torch.parallel import CompiledTrainStep, MoEFFN, P, make_mesh

    class Net(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.moe = MoEFFN(8, 16, 4, top_k=top_k, capacity_factor=cf,
                              generator=torch.Generator())

        def forward(self, x, target):
            y, aux = self.moe(x)
            return ((y - target) ** 2).mean() + MOE_DP_AUX * aux

    n = int(np.prod(list(axes.values())))
    mesh = make_mesh(axes, devices=list(range(n)))
    if mesh.coords is None:
        return None
    net = Net()
    with torch.no_grad():
        for k, v in _moe_params().items():
            net.moe._parameters[k].copy_(torch.tensor(v))
    step = CompiledTrainStep(net, gloss.PassThrough(),
                             optimizer.create("sgd", learning_rate=0.1),
                             mesh=mesh, data_specs=(P(*spec), P(*spec), P()),
                             device="cpu")
    x, t = (torch.tensor(a) for a in _moe_data())
    return [float(step.step(x, t, torch.zeros(1))) for _ in range(5)]


@pytest.mark.parametrize("top_k,cf", [(1, 1.0), (2, 0.75)])
def test_moe_under_dp_routes_the_global_batch(pool, top_k, cf):
    """C23: an ``MoEFFN`` net on dp=2 whose capacity drops tokens
    (``capacity_factor`` <= 1) against the reference's dp=2 mesh program:
    the global capacity, slots and load-balance term give its losses over
    five SGD steps, which per-rank routing does not."""
    want = _ref_moe_mesh(top_k, cf)
    got = pool.run(_rank_moe_mesh, top_k, cf)
    for g in got[:2]:
        np.testing.assert_allclose(g, want, rtol=LOSS_RTOL)
    assert got[2] is None and got[3] is None


def _rank_moe_other_split():
    from tpu_mx_torch.base import MXNetError
    try:
        _rank_moe_mesh(1, 1.0, spec=(None, None, "dp"))
    except MXNetError as e:
        return str(e)
    return None


def test_moe_refuses_a_batch_split_of_another_dimension(pool):
    """A batch split over dp along a dimension other than its rows and
    its sequence (here the features) raises by name instead of routing
    each rank's tokens with its own capacity, slots and load-balance
    term, which the reference's mesh program does not do."""
    got = pool.run(_rank_moe_other_split)
    for msg in got[:2]:
        assert msg is not None and "MoEFFN" in msg \
            and "rows and its sequence" in msg
    assert got[2] is None and got[3] is None


@pytest.mark.parametrize("axes,top_k", [({"dp": 1, "sp": 2}, 1),
                                        ({"dp": 2, "sp": 2}, 2)])
def test_moe_under_sp_routes_the_global_batch(pool, axes, top_k):
    """C24: the same net with its tokens split along the sequence (sp=2;
    and dp=2 x sp=2 on the four ranks) against the reference's mesh
    program at those axes: the global token order interleaves the ranks'
    rows, and the slots follow it."""
    spec = ("dp", "sp")
    cf = 1.0 if top_k == 1 else 0.75
    want = _ref_moe_mesh(top_k, cf, axes, spec)
    got = pool.run(_rank_moe_mesh, top_k, cf, axes, spec)
    n = int(np.prod(list(axes.values())))
    for g in got[:n]:
        np.testing.assert_allclose(g, want, rtol=LOSS_RTOL)
    assert all(g is None for g in got[n:])


# -- the dry run -------------------------------------------------------------------
def _rank_dryrun():
    from tpu_mx_torch.tools.dryrun_multichip import dryrun_multichip
    return dryrun_multichip(4, device="cpu")


def test_dryrun_multichip_on_four_ranks(pool):
    res = pool.run(_rank_dryrun)
    for losses in res:
        assert set(losses) == {"bert", "pipeline", "fsdp", "compressed",
                               "ulysses", "moe"}
        assert all(np.isfinite(v) for v in losses.values())
        assert losses == res[0]               # every rank computed the same
