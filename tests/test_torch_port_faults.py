"""Faults of the port against the reference, each pinned by a test.

On the CPU, at small sizes, with inputs made from a seed with numpy:

- the dense arm for shapes the kernels do not instantiate (head dims
  outside 16/32/64/128, float16), chosen by a pure function of shape,
  dtype and device and counted under the names the reference counts its
  arms by; on the card only where the reference's own gate goes dense
  too (a shape its kernel takes is refused by name there);
- ``random.seed``/``get_state``/``set_state``: the reference's seed
  contract (numpy seeded too, the prior token returned, bit-exact
  restore through a JSON round trip);
- ``SoftmaxCrossEntropyLoss(from_logits=)`` and the losses' block
  arguments;
- the reference's constructor and entry-point arguments: each accepted
  (every argument once refused by name has since been ported, the last,
  ``Optimizer(sym=)``, as the reference takes it: read by nothing).

The card side of the dense arm is in ``tests/test_torch_cuda.py``.
"""
import importlib
import inspect
import json
import os
import tempfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_mx as mx
from tpu_mx import gluon, nd
from tpu_mx import telemetry as jtel
from tpu_mx.kernels import flash_attention as jfa
from tpu_mx.serving import Server as JServer
from tpu_mx.serving import TinyLM as JTinyLM

from tpu_mx_torch import random as prandom
from tpu_mx_torch import telemetry as tel
from tpu_mx_torch import tracing
from tpu_mx_torch.gluon import loss as tloss
from tpu_mx_torch.kernels import flash_attention as fa
from tpu_mx_torch.kernels import paged_attention as pa
ra = importlib.import_module("tpu_mx_torch.parallel.ring_attention")
from tpu_mx_torch.serving import attention as sattn
from tpu_mx_torch.serving import Server, TinyLM

jra = importlib.import_module("tpu_mx.parallel.ring_attention")
# each arm of the port's dispatch_counts by its name in the reference's
REFERENCE_ARMS = {"flash_kernel": "pallas_flash", "dense": "xla_dense",
                  "ring": "ring", "ulysses": "ulysses"}
# a journal prefix in a directory of its own (the journal opens its file)
_JOURNAL = os.path.join(tempfile.mkdtemp(prefix="port-faults-"), "serve")
_JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
        torch.float16: jnp.float16}


# ---------------------------------------------------------------------------
# C1: a dense arm for shapes the kernels do not instantiate
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("device,d,dtype,arm", [
    ("cuda", 64, torch.float32, "flash_kernel"),
    ("cuda", 128, torch.bfloat16, "flash_kernel"),
    ("cuda", 16, torch.float32, "flash_kernel"),
    ("cuda", 80, torch.float32, "dense"),
    ("cuda", 96, torch.bfloat16, "dense"),
    ("cuda", 64, torch.float16, "dense"),
    ("cuda", 192, torch.float32, "flash_kernel"),
    ("cuda", 256, torch.bfloat16, "flash_kernel"),
    ("cuda", 320, torch.float32, "flash_kernel"),    # the runtime-D
    ("cuda", 384, torch.bfloat16, "flash_kernel"),   # instances
    ("cuda", 192, torch.float16, "dense"),
    ("cpu", 64, torch.float32, "dense"),
    ("cpu", 80, torch.float16, "dense"),
    ("cpu", 192, torch.float32, "dense"),
])
def test_attention_arm_is_a_function_of_shape_and_dtype(device, d, dtype,
                                                        arm):
    """Head dims of 320 and more take the runtime-D instances on the
    card, as the reference's gate takes them to its kernel."""
    for _ in range(2):                                   # no state
        assert ra.attention_arm(device, d, dtype) == arm
    assert fa.kernel_takes(d, dtype) == (
        (d in fa.HEAD_DIMS or fa.runtime_d(d)) and dtype != torch.float16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("d", [48, 64, 80, 96, 128, 192, 256, 320])
def test_attention_arm_on_the_card_names_the_reference_arm(d, dtype):
    """At a T the reference's kernel tiles (T % 128 == 0), the arm the
    port takes on the card is, under the reference's name, the arm the
    reference's gate ``supported()`` picks on its chip, head dims of 320
    and more included (the runtime-D instances): never the dense arm in
    the kernel's place.  (The port also instantiates head dims 16 and
    32, which the reference sends dense.)"""
    want = "pallas_flash" if jfa.supported((2, 2, 128, d), _JDT[dtype],
                                           kv_len=128) else "xla_dense"
    got = REFERENCE_ARMS[ra.attention_arm("cuda", d, dtype)]
    assert got == want
    assert set(REFERENCE_ARMS.values()) <= set(jra.dispatch_counts)
    assert set(REFERENCE_ARMS) == set(ra.dispatch_counts)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
@pytest.mark.parametrize("d", [80, 96, 192])
def test_cpu_dense_arm_counts_and_matches_the_reference(d, dtype):
    """Off the kernels' shapes both packages take their dense arm, count
    it (``dense`` / ``xla_dense``) and agree."""
    rng = np.random.RandomState(d)
    q, k, v = (rng.randn(2, 2, 24, d).astype(np.float32) for _ in range(3))
    vl = np.array([24, 11], np.int32)
    j_before = jra.dispatch_counts["xla_dense"]
    want = np.asarray(jra.local_flash_attention(
        jnp.asarray(q, _JDT[dtype]), jnp.asarray(k, _JDT[dtype]),
        jnp.asarray(v, _JDT[dtype]), causal=True, valid_length=vl),
        np.float32)
    before = dict(ra.dispatch_counts)
    t = lambda x: torch.from_numpy(x).to(dtype)
    got = ra.local_flash_attention(t(q), t(k), t(v), causal=True,
                                   valid_length=torch.from_numpy(vl))
    assert got.dtype == dtype
    tol = 1e-5 if dtype == torch.float32 else 2e-3
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)
    # each package counts a new signature once, under its dense name
    assert ra.dispatch_counts["flash_kernel"] == before["flash_kernel"]
    assert jra.dispatch_counts["xla_dense"] >= j_before
    again = dict(ra.dispatch_counts)
    ra.local_flash_attention(t(q), t(k), t(v), causal=True,
                             valid_length=torch.from_numpy(vl))
    assert ra.dispatch_counts == again


# the arm on the card (the reference's kernel gate -- a head dim that is
# a multiple of 64, a float32 or bfloat16 query -- takes the decode, and
# so does the port's kernel, at 320 and more its runtime-D instance); on
# the CPU a decode the kernel does not take is dense
@pytest.mark.parametrize("d,q_dtype,pool,window,arm", [
    (128, torch.float32, torch.float32, 1, "paged"),
    (16, torch.float32, torch.bfloat16, 8, "paged"),
    (80, torch.float32, torch.float32, 1, "dense"),
    (96, torch.float32, torch.bfloat16, 1, "dense"),
    (64, torch.float32, torch.float16, 1, "paged"),
    (64, torch.float16, torch.float32, 1, "dense"),
    (64, torch.float32, torch.float32, 9, "paged"),
    (192, torch.float32, torch.float32, 1, "paged"),
    (256, torch.bfloat16, torch.bfloat16, 1, "paged"),
    (256, torch.float32, torch.float32, 12, "paged"),
    (320, torch.float32, torch.float32, 1, "paged"),
    (320, torch.bfloat16, torch.float16, 12, "paged"),
])
def test_decode_arm_is_a_function_of_shape_and_dtype(d, q_dtype, pool,
                                                     window, arm):
    assert sattn.decode_arm(d, q_dtype, pool, window) == arm
    assert sattn.decode_arm(d, q_dtype, pool, window, "cpu") == arm
    assert pa.kernel_takes(d, q_dtype, pool, window) == (arm == "paged")


@pytest.mark.parametrize("d,dtype,arm", [
    (128, torch.float32, "flash"), (64, torch.bfloat16, "flash"),
    (80, torch.float32, "dense"), (64, torch.float16, "dense"),
    (192, torch.float32, "flash"), (256, torch.bfloat16, "flash"),
    (320, torch.float32, "flash"), (384, torch.bfloat16, "flash")])
def test_prefill_arm_is_a_function_of_shape_and_dtype(d, dtype, arm):
    assert sattn.prefill_arm(d, dtype) == arm
    assert sattn.prefill_arm(d, dtype, "cpu") == arm


def test_dense_decode_arm_equals_the_paged_plain_version():
    """The dense-gather decode and the paged walk compute one function,
    single token and window, on padded, scattered tables."""
    rng = np.random.RandomState(5)
    b, h, d, bs, nb = 3, 2, 16, 4, 5
    kp, vp = (torch.from_numpy(rng.randn(20, bs, h, d).astype(np.float32))
              for _ in range(2))
    tables = torch.from_numpy(rng.permutation(20)[:b * nb]
                              .reshape(b, nb).astype(np.int32))
    lens = torch.tensor([17, 4, 9], dtype=torch.int32)
    # the padded gather of the tables, as PagedKVCache.gather_batch makes it
    kd, vd = (p[tables.long()].reshape(b, nb * bs, h, d) for p in (kp, vp))
    for tq in (1, 3):
        q = torch.from_numpy(rng.randn(b, tq, h, d).astype(np.float32))
        want = pa.paged_attention_plain(q, kp, vp, tables, lens, d ** -0.5)
        got = sattn.dense_attention(q, kd, vd, lengths=lens, causal=True)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        got = sattn._dense_on_tables(q, kp, vp, tables, lens)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    got = sattn.dense_decode_attention(q[:, 0], kd, vd, lens)
    want = pa.paged_attention_plain(q[:, :1], kp, vp, tables, lens,
                                    d ** -0.5)[:, 0]
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("embed_dim,num_heads,kind,env", [
    (160, 2, "dense", "0"),     # D=80: no kernel instance, both dense
    (384, 2, "paged", "1"),     # D=192: both on their paged arm
    (640, 2, "paged", "1"),     # D=320: both paged (the runtime-D one)
    (32, 2, "paged", "1"),      # D=16: both on their paged arm
])
def test_serving_counts_the_decode_arm_the_reference_counts(
        embed_dim, num_heads, kind, env, monkeypatch):
    """The same request through both packages: the same stream, and the
    decode steps counted under the same ``serve.decode_attention`` kind
    (the reference's arm chosen by its ``TPUMX_PAGED_DECODE`` knob, the
    port's by the head dim)."""
    monkeypatch.setenv("TPUMX_PAGED_DECODE", env)
    small = dict(vocab_size=64, embed_dim=embed_dim, num_heads=num_heads,
                 num_layers=2)
    prompt, new = [5, 6, 7, 9, 2, 11], 6
    jtel.reset()
    tel.reset()
    tracing.reset()
    jsrv = JServer(JTinyLM(**small, seed=0), num_blocks=32, block_size=4)
    jreq = jsrv.submit(prompt, max_new_tokens=new)
    jsrv.run_until_idle()
    srv = Server(TinyLM(**small, seed=0, device="cpu"), num_blocks=32,
                 block_size=4, device="cpu")
    req = srv.submit(prompt, max_new_tokens=new)
    srv.run_until_idle()
    assert req.tokens == jreq.tokens
    steps = tel.get("serve.decode_steps").value
    assert steps == jtel.get("serve.decode_steps").value > 0
    assert tel.get("serve.decode_attention", kind=kind).value == \
        jtel.get("serve.decode_attention", kind=kind).value == 2 * steps
    other = {"dense": "paged", "paged": "dense"}[kind]
    assert tel.get("serve.decode_attention", kind=other) is None
    prefill_kind = "dense" if kind == "dense" else "flash"
    assert tel.get("serve.prefill_attention", kind=prefill_kind).value > 0
    path = [e["data"]["path"] for e in tracing.snapshot()
            if e["event"] == "serve.decode_path"]
    assert path == [kind]


# ---------------------------------------------------------------------------
# C2: the reference's seed contract
# ---------------------------------------------------------------------------
def test_seed_seeds_numpy_as_the_reference_does():
    outer = np.random.get_state()
    try:
        for s in (7, 2 ** 40 + 3, -5):
            mx.random.seed(s)
            want = np.random.rand(4)
            prandom.seed(s)
            assert np.array_equal(np.random.rand(4), want)
    finally:
        np.random.set_state(outer)


def test_seed_returns_the_prior_token_and_state_round_trips():
    """save, draw, restore, draw: the same draws, on numpy's global
    state and on every generator handed out, also after JSON."""
    outer = np.random.get_state()
    try:
        g = prandom.generator("cpu")
        prandom.seed(11)
        torch.rand(3, generator=g)
        tok = prandom.get_state()
        first = (np.random.rand(5), torch.rand(5, generator=g))
        prandom.set_state(tok)
        prior = prandom.seed(12, ctx="all")
        assert prior == tok
        assert not np.array_equal(np.random.rand(5), first[0])
        # restore, draw: the same draws, from the token seed() returned
        # too, and after a JSON round trip
        for state in (tok, json.loads(json.dumps(tok)), prior):
            prandom.set_state(state)
            assert np.array_equal(np.random.rand(5), first[0])
            assert torch.equal(torch.rand(5, generator=g), first[1])
        assert inspect.signature(prandom.seed).parameters["ctx"].default \
            == inspect.signature(mx.random.seed).parameters["ctx"].default
    finally:
        np.random.set_state(outer)


# ---------------------------------------------------------------------------
# C3: SoftmaxCrossEntropyLoss(from_logits=) and the losses' kwargs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("sparse", [True, False])
@pytest.mark.parametrize("from_logits", [False, True])
def test_softmax_cross_entropy_from_logits_matches_the_reference(
        from_logits, sparse):
    rng = np.random.RandomState(6)
    pred = rng.randn(5, 4, 7).astype(np.float32)
    if from_logits:     # log-probabilities, as a caller would pass them
        pred = pred - np.log(np.exp(pred).sum(-1, keepdims=True))
    label = (rng.randint(0, 7, (5, 4)).astype(np.int32) if sparse
             else rng.rand(5, 4, 7).astype(np.float32))
    want = gluon.loss.SoftmaxCrossEntropyLoss(
        sparse_label=sparse, from_logits=from_logits, prefix="ce_")(
        nd.array(pred), nd.array(label)).asnumpy()
    loss = tloss.SoftmaxCrossEntropyLoss(sparse_label=sparse,
                                         from_logits=from_logits,
                                         prefix="ce_")
    got = loss(torch.from_numpy(pred), torch.from_numpy(label))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    assert loss.prefix == "ce_"
    if from_logits:     # the log-softmax is skipped, not applied twice
        raw = tloss.SoftmaxCrossEntropyLoss(from_logits=True,
                                            sparse_label=sparse)(
            torch.from_numpy(pred * 3), torch.from_numpy(label))
        np.testing.assert_allclose(raw.numpy(), 3 * got.numpy(), rtol=1e-5)
    tloss.PassThrough(prefix="p_")
    tloss.Loss(None, 0, params=None)


# ---------------------------------------------------------------------------
# C4: the reference's arguments, accepted (once refused by name)
# ---------------------------------------------------------------------------
def _bert_cfg():
    from tpu_mx_torch.models import bert_base_config
    cfg = bert_base_config(vocab_size=20, max_len=16)
    cfg.update(num_layers=1, units=16, hidden_size=32, num_heads=2,
               dropout=0.0)
    return cfg


def _bert(**kw):
    from tpu_mx_torch.models import BERTModel
    return BERTModel(_bert_cfg(), device="cpu",
                     generator=torch.Generator().manual_seed(0), **kw)


def _train_step(**kw):
    from tpu_mx_torch import optimizer
    from tpu_mx_torch.models import MLMLoss
    from tpu_mx_torch.parallel import CompiledTrainStep
    return CompiledTrainStep(_bert(), MLMLoss(),
                             optimizer.create("lamb", learning_rate=1e-4),
                             device="cpu", **kw)


def _step(**kw):
    rng = np.random.RandomState(0)
    tokens = rng.randint(4, 20, (1, 8)).astype(np.int32)
    batch = (tokens, np.zeros_like(tokens), np.array([8], np.int32),
             np.array([[1, 3]], np.int32), tokens[:, [1, 3]])
    return _train_step().step(*batch, **kw)


def _tiny():
    return TinyLM(vocab_size=16, embed_dim=8, num_heads=2, num_layers=1,
                  device="cpu")


def _server(**kw):
    return Server(_tiny(), num_blocks=8, device="cpu", **kw)


def _engine(**kw):
    from tpu_mx_torch.serving import EngineCore
    return EngineCore(_tiny(), num_blocks=8, **kw)


def _cache(**kw):
    from tpu_mx_torch.serving import PagedKVCache
    return PagedKVCache(1, 2, 4, num_blocks=4, device="cpu", **kw)


def _flash(**kw):
    q = torch.zeros((1, 4, 16))
    return fa.flash_attention(q, q, q, **kw)


def _mha(**kw):
    q = torch.zeros((1, 1, 4, 16))
    return fa.mha_flash_attention(q, q, q, **kw)


def _bert_moe(**kw):
    return _bert(moe_every=1, **kw)


def _iter(**kw):
    from tpu_mx_torch import io
    return io.NDArrayIter(np.zeros((4, 2), np.float32), batch_size=2, **kw)


def _iter_sharded(**kw):
    return _iter(num_workers=2, **kw)


def _trainer(**kw):
    from tpu_mx_torch import gluon as pgluon
    net = pgluon.nn.Dense(2, in_units=2, generator=torch.Generator())
    return pgluon.Trainer(net.collect_params(), "sgd", **kw)


def _optimizer(**kw):
    from tpu_mx_torch import optimizer
    return optimizer.Optimizer(**kw)


def _reference(name):
    from tpu_mx.models.bert import BERTModel
    from tpu_mx.parallel import CompiledTrainStep
    from tpu_mx.serving import EngineCore, PagedKVCache
    return {"BERTModel": BERTModel, "BERTModel(moe_every=1)": BERTModel,
            "CompiledTrainStep": CompiledTrainStep,
            "CompiledTrainStep.step": CompiledTrainStep.step,
            "Server": JServer, "EngineCore": EngineCore,
            "PagedKVCache": PagedKVCache,
            "flash_attention": jfa.flash_attention,
            "mha_flash_attention": jfa.mha_flash_attention,
            "NDArrayIter": mx.io.NDArrayIter,
            "NDArrayIter(num_workers=2)": mx.io.NDArrayIter,
            "Trainer": gluon.Trainer,
            "Optimizer": mx.optimizer.Optimizer}[name]


_PORT = {"BERTModel": _bert, "BERTModel(moe_every=1)": _bert_moe,
         "CompiledTrainStep": _train_step,
         "CompiledTrainStep.step": _step, "Server": _server,
         "EngineCore": _engine, "PagedKVCache": _cache,
         "flash_attention": _flash, "mha_flash_attention": _mha,
         "NDArrayIter": _iter, "NDArrayIter(num_workers=2)": _iter_sharded,
         "Trainer": _trainer, "Optimizer": _optimizer}

# arguments refused until their feature was ported, each with a check
# that the given value took effect
_ACCEPTED = [
    ("Server", "prefix_sharing", True,
     lambda srv: srv.engine.cache.prefix is not None),
    ("Server", "sampling_seed", 3,
     lambda srv: srv._sampling_seed == 3),
    ("EngineCore", "share_prefix", True,
     lambda eng: eng.cache.prefix is not None),
    ("EngineCore", "greedy", False,
     lambda eng: not eng.greedy and eng.spec_window == 1),
    ("PagedKVCache", "share_prefix", True,
     lambda cache: cache.prefix is not None),
    # the serving robustness and recovery planes
    ("Server", "deadline", 1.0, lambda srv: srv.deadline == 1.0),
    ("Server", "max_restarts", 0, lambda srv: srv.max_restarts == 0),
    ("Server", "backoff", 0.5, lambda srv: srv.backoff == 0.5),
    ("Server", "blackbox", "box",
     lambda srv: srv.blackbox == "box"
     and srv.engine.cache._forensics_path == "box-capacity.json"),
    ("Server", "slo", True, lambda srv: srv.slo is not None
     and srv.slo_signal is not None),
    ("Server", "journal", _JOURNAL,
     lambda srv: srv.journal is not None
     and srv.journal.path == f"{_JOURNAL}-journal.jsonl"),
    ("Server", "replay", False, lambda srv: srv.replay is False),
    ("EngineCore", "forensics", "box",
     lambda eng: eng.cache._forensics_path == "box-capacity.json"),
    ("EngineCore", "warm_batch", 4, lambda eng: eng.warm_batch == 4),
    ("PagedKVCache", "forensics", "box",
     lambda cache: cache._forensics_path == "box-capacity.json"),
    # the rest of the BERT step
    ("BERTModel(moe_every=1)", "moe_experts", 4,
     lambda net: net.encoder.layers[0].moe._E == 4),
    ("BERTModel(moe_every=1)", "moe_top_k", 1,
     lambda net: net.encoder.layers[0].moe._k == 1),
    ("CompiledTrainStep", "rules", [(r"qkv_weight$", ("tp", None))],
     lambda step: step._rules is not None),
    ("CompiledTrainStep", "data_specs", (("dp",),),
     lambda step: step._data_specs == (("dp",),)),
    # the name-keyed multipliers
    ("Optimizer", "param_idx2name", {0: "w"},
     lambda opt: opt.idx2name == {0: "w"}),
    # elastic sharding
    ("NDArrayIter", "num_workers", 2,
     lambda it: it.num_workers == 2 and it.batch_size == 1),
    ("NDArrayIter(num_workers=2)", "rank", 1,
     lambda it: it.rank == 1 and it.iter_next() and list(it._sel) == [1]),
    # the kvstore
    ("Trainer", "compression_params", {"type": "2bit"},
     lambda tr: tr._kvstore._compression is not None
     and tr._kvstore._compression.type == "2bit"),
    ("Trainer", "update_on_kvstore", True,
     lambda tr: tr._update_on_kvstore is True),
]
# arguments accepted at any value and ignored: with no torch meaning, or
# read by nothing in the reference either (``Optimizer(sym=)``)
_IGNORED = [
    ("Optimizer", "sym", "net"),
    ("CompiledTrainStep", "donate", False),
    ("PagedKVCache", "storage", "device"),
    ("flash_attention", "block_q", 64), ("flash_attention", "block_k", 32),
    ("mha_flash_attention", "block_q", 64),
    ("mha_flash_attention", "block_k", 32),
]


def _same_default(entry, arg):
    ref = inspect.signature(_reference(entry)).parameters
    port = inspect.signature(_port_callable(entry)).parameters
    assert arg in ref, f"the reference's {entry} no longer takes {arg}"
    assert arg in port, f"the port's {entry} does not take {arg}"
    assert port[arg].default == ref[arg].default
    return ref[arg].default


def _port_callable(entry):
    from tpu_mx_torch import gluon as pgluon
    from tpu_mx_torch import io, optimizer
    from tpu_mx_torch.models import BERTModel
    from tpu_mx_torch.parallel import CompiledTrainStep
    from tpu_mx_torch.serving import EngineCore, PagedKVCache
    return {"BERTModel": BERTModel, "BERTModel(moe_every=1)": BERTModel,
            "CompiledTrainStep": CompiledTrainStep,
            "CompiledTrainStep.step": CompiledTrainStep.step,
            "Server": Server, "EngineCore": EngineCore,
            "PagedKVCache": PagedKVCache,
            "flash_attention": fa.flash_attention,
            "mha_flash_attention": fa.mha_flash_attention,
            "NDArrayIter": io.NDArrayIter,
            "NDArrayIter(num_workers=2)": io.NDArrayIter,
            "Trainer": pgluon.Trainer,
            "Optimizer": optimizer.Optimizer}[entry]


@pytest.mark.parametrize("entry,arg,value,took", _ACCEPTED,
                         ids=[f"{e}-{a}" for e, a, _, _ in _ACCEPTED])
def test_reference_argument_once_refused_is_accepted(entry, arg, value,
                                                      took):
    default = _same_default(entry, arg)
    assert not took(_PORT[entry](**{arg: default}))
    assert took(_PORT[entry](**{arg: value}))


@pytest.mark.parametrize("entry,arg,value", _IGNORED,
                         ids=[f"{e}-{a}" for e, a, _ in _IGNORED])
def test_reference_argument_without_a_torch_meaning_is_ignored(entry, arg,
                                                               value):
    default = _same_default(entry, arg)
    _PORT[entry](**{arg: default})
    _PORT[entry](**{arg: value})


def _hyper(opt):
    return (opt.lr, opt.wd, opt.rescale_grad, opt.clip_gradient,
            opt.begin_num_update, opt.multi_precision, dict(opt.lr_mult),
            dict(opt.wd_mult), dict(opt.idx2name))


@pytest.mark.parametrize("sym", ["net", "symbol"])
def test_optimizer_takes_sym_and_ignores_it_as_the_reference_does(sym):
    """``Optimizer(sym=)`` constructs in both packages (the port refused
    it until the graph API was ported), and the optimizer built with it
    has the learning rate, weight decay and multipliers of the one built
    without it, in each package, and the reference's."""
    from tpu_mx_torch import optimizer as popt
    from tpu_mx_torch import symbol as psym
    import tpu_mx.symbol as jsym
    kw = dict(learning_rate=0.3, wd=1e-3, rescale_grad=0.5,
              param_idx2name={0: "fc_weight", 1: "fc_bias"})
    got = {}
    for name, opt_mod, sym_mod in (("port", popt, psym),
                                   ("ref", mx.optimizer, jsym)):
        s = "net" if sym == "net" else sym_mod.FullyConnected(
            sym_mod.var("data"), num_hidden=2, name="fc")
        with_sym = opt_mod.Optimizer(sym=s, **kw)
        without = opt_mod.Optimizer(**kw)
        for o in (with_sym, without):
            o.set_lr_mult({"fc_weight": 2.0})
            o.set_wd_mult({"fc_bias": 0.0})
        assert _hyper(with_sym) == _hyper(without)
        got[name] = _hyper(with_sym)
    assert got["port"] == got["ref"]


def _serve_series(snapshot):
    return {(r["name"], json.dumps(r.get("labels"), sort_keys=True)):
            r["value"] for r in snapshot if r["name"].startswith("serve.")}


def test_engine_warm_up_leaves_the_serve_metrics_untouched(monkeypatch):
    """C29: the engine's warm-up (on the card, one prefill and one decode
    step on a scratch cache) is not serving work.  The reference's
    warm-up (its fused arm's bucket compiles) records no ``serve.*``
    metric; the port's ``_warm``, called here directly on a CPU engine,
    adds to none of them either (the kernel wrappers' own counters do
    count its launches on the card)."""
    monkeypatch.setenv("TPUMX_PAGED_DECODE", "paged")
    monkeypatch.setenv("TPUMX_FUSED_DECODE", "1")
    jtel.reset()
    ref = JServer(JTinyLM(vocab_size=16, embed_dim=8, num_heads=2,
                          num_layers=1, seed=0), num_blocks=8)
    assert ref.engine.fused and ref.engine.jax_model is not None
    assert _serve_series(jtel.snapshot()) == {}
    monkeypatch.delenv("TPUMX_FUSED_DECODE")
    for kind in ("dense", "paged"):
        monkeypatch.setenv("TPUMX_PAGED_DECODE", kind)
        tel.reset()
        eng = _engine()
        tel.counter("serve.decode_steps").inc(3)
        tel.counter("serve.decode_attention", kind=kind).inc(2)
        before = _serve_series(tel.snapshot())
        eng._warm(2)
        assert _serve_series(tel.snapshot()) == before
        assert eng.cache.audit()["used_blocks"] == 0
    # outside the warm-up the same calls count as before
    srv = _server()
    srv.submit([1, 2, 3], max_new_tokens=2)
    srv.run_until_idle()
    after = _serve_series(tel.snapshot())
    assert sum(v for (n, _), v in after.items()
               if n == "serve.decode_attention") > 2
