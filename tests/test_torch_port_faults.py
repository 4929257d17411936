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
- the reference's constructor and entry-point arguments: accepted, and
  refused by name (``MXNetError``) when set to what the port does not do.

The card side of the dense arm is in ``tests/test_torch_cuda.py``.
"""
import importlib
import inspect
import json

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
from tpu_mx_torch.base import MXNetError
from tpu_mx_torch.gluon import loss as tloss
from tpu_mx_torch.kernels import flash_attention as fa
from tpu_mx_torch.kernels import paged_attention as pa
from tpu_mx_torch.parallel import ring_attention as ra
from tpu_mx_torch.serving import attention as sattn
from tpu_mx_torch.serving import Server, TinyLM

jra = importlib.import_module("tpu_mx.parallel.ring_attention")
# each arm of the port's dispatch_counts by its name in the reference's
REFERENCE_ARMS = {"flash_kernel": "pallas_flash", "dense": "xla_dense"}
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
    ("cuda", 192, torch.float32, None),      # the reference's kernel
    ("cuda", 256, torch.bfloat16, None),     # takes these: no dense arm
    ("cuda", 192, torch.float16, "dense"),
    ("cpu", 64, torch.float32, "dense"),
    ("cpu", 80, torch.float16, "dense"),
    ("cpu", 192, torch.float32, "dense"),
])
def test_attention_arm_is_a_function_of_shape_and_dtype(device, d, dtype,
                                                        arm):
    """``None``: the card refuses the shape by name rather than put the
    plain version in its kernel's place."""
    for _ in range(2):                                   # no state
        if arm is None:
            with pytest.raises(MXNetError, match="ROADMAP B item 8"):
                ra.attention_arm(device, d, dtype)
        else:
            assert ra.attention_arm(device, d, dtype) == arm
    assert fa.kernel_takes(d, dtype) == (d in fa.HEAD_DIMS
                                         and dtype != torch.float16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("d", [48, 64, 80, 96, 128, 192, 256])
def test_attention_arm_on_the_card_names_the_reference_arm(d, dtype):
    """At a T the reference's kernel tiles (T % 128 == 0), the arm the
    port takes on the card is, under the reference's name, the arm the
    reference's gate ``supported()`` picks on its chip, or, where that
    is its kernel and the port has no instance (head dims 192, 256), a
    refusal: never the dense arm in the kernel's place.  (The port also
    instantiates head dims 16 and 32, which the reference sends dense.)"""
    want = "pallas_flash" if jfa.supported((2, 2, 128, d), _JDT[dtype],
                                           kv_len=128) else "xla_dense"
    if want == "pallas_flash" and d not in fa.HEAD_DIMS:
        with pytest.raises(MXNetError, match="no kernel instance"):
            ra.attention_arm("cuda", d, dtype)
        return
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


# the arm on the card (None: refused by name, the reference's kernel gate
# -- a head dim that is a multiple of 64, a float32 or bfloat16 query --
# takes the decode); on the CPU a refused decode takes the dense arm
@pytest.mark.parametrize("d,q_dtype,pool,window,arm", [
    (128, torch.float32, torch.float32, 1, "paged"),
    (16, torch.float32, torch.bfloat16, 8, "paged"),
    (80, torch.float32, torch.float32, 1, "dense"),
    (96, torch.float32, torch.bfloat16, 1, "dense"),
    (64, torch.float32, torch.float16, 1, None),
    (64, torch.float16, torch.float32, 1, "dense"),
    (64, torch.float32, torch.float32, 9, None),
    (192, torch.float32, torch.float32, 1, None),
    (256, torch.bfloat16, torch.bfloat16, 1, None),
])
def test_decode_arm_is_a_function_of_shape_and_dtype(d, q_dtype, pool,
                                                     window, arm):
    if arm is None:
        with pytest.raises(MXNetError, match="ROADMAP B item 8"):
            sattn.decode_arm(d, q_dtype, pool, window)
    else:
        assert sattn.decode_arm(d, q_dtype, pool, window) == arm
    assert sattn.decode_arm(d, q_dtype, pool, window, "cpu") == (
        arm or "dense")
    assert pa.kernel_takes(d, q_dtype, pool, window) == (arm == "paged")


@pytest.mark.parametrize("d,dtype,arm", [
    (128, torch.float32, "flash"), (64, torch.bfloat16, "flash"),
    (80, torch.float32, "dense"), (64, torch.float16, "dense"),
    (192, torch.float32, None), (256, torch.bfloat16, None)])
def test_prefill_arm_is_a_function_of_shape_and_dtype(d, dtype, arm):
    if arm is None:
        with pytest.raises(MXNetError, match="ROADMAP B item 8"):
            sattn.prefill_arm(d, dtype)
    else:
        assert sattn.prefill_arm(d, dtype) == arm
    assert sattn.prefill_arm(d, dtype, "cpu") == (arm or "dense")


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
    for tq in (1, 3):
        q = torch.from_numpy(rng.randn(b, tq, h, d).astype(np.float32))
        want = pa.paged_attention_plain(q, kp, vp, tables, lens, d ** -0.5)
        got = sattn.dense_decode_attention(q, kp, vp, tables, lens)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    got = sattn.dense_decode_attention(q[:, 0], kp, vp, tables, lens)
    want = pa.paged_attention_plain(q[:, :1], kp, vp, tables, lens,
                                    d ** -0.5)[:, 0]
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("embed_dim,num_heads,kind,env", [
    (160, 2, "dense", "0"),     # D=80: no kernel instance, both dense
    (384, 2, "dense", "0"),     # D=192: no instance, dense on the CPU
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
# C4: the reference's arguments, accepted and refused by name
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


def _reference(name):
    from tpu_mx.models.bert import BERTModel
    from tpu_mx.parallel import CompiledTrainStep
    from tpu_mx.serving import EngineCore, PagedKVCache
    return {"BERTModel": BERTModel, "CompiledTrainStep": CompiledTrainStep,
            "CompiledTrainStep.step": CompiledTrainStep.step,
            "Server": JServer, "EngineCore": EngineCore,
            "PagedKVCache": PagedKVCache,
            "flash_attention": jfa.flash_attention,
            "mha_flash_attention": jfa.mha_flash_attention}[name]


_PORT = {"BERTModel": _bert, "CompiledTrainStep": _train_step,
         "CompiledTrainStep.step": _step, "Server": _server,
         "EngineCore": _engine, "PagedKVCache": _cache,
         "flash_attention": _flash, "mha_flash_attention": _mha}

# (entry point, argument, a value other than the reference's default)
_REFUSED = [
    ("BERTModel", "moe_experts", 4), ("BERTModel", "moe_top_k", 1),
    ("CompiledTrainStep", "rules", {"w": None}),
    ("CompiledTrainStep", "data_specs", ("dp",)),
    ("CompiledTrainStep", "gradient_compression", {"type": "2bit"}),
    ("CompiledTrainStep.step", "deadline", 5.0),
    ("CompiledTrainStep.step", "compile_grace", 1.0),
    ("Server", "deadline", 1.0), ("Server", "max_restarts", 0),
    ("Server", "backoff", 0.5), ("Server", "blackbox", "box"),
    ("Server", "slo", True), ("Server", "prefix_sharing", True),
    ("Server", "journal", "journal.log"), ("Server", "sampling_seed", 3),
    ("Server", "replay", "journal.log"),
    ("EngineCore", "share_prefix", True), ("EngineCore", "forensics", True),
    ("EngineCore", "warm_batch", 4), ("EngineCore", "greedy", False),
    ("PagedKVCache", "share_prefix", True),
    ("PagedKVCache", "forensics", True),
]
# arguments with no torch meaning: accepted at any value and ignored
_IGNORED = [
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
    from tpu_mx_torch.models import BERTModel
    from tpu_mx_torch.parallel import CompiledTrainStep
    from tpu_mx_torch.serving import EngineCore, PagedKVCache
    return {"BERTModel": BERTModel, "CompiledTrainStep": CompiledTrainStep,
            "CompiledTrainStep.step": CompiledTrainStep.step,
            "Server": Server, "EngineCore": EngineCore,
            "PagedKVCache": PagedKVCache,
            "flash_attention": fa.flash_attention,
            "mha_flash_attention": fa.mha_flash_attention}[entry]


@pytest.mark.parametrize("entry,arg,value", _REFUSED,
                         ids=[f"{e}-{a}" for e, a, _ in _REFUSED])
def test_reference_argument_is_refused_by_name(entry, arg, value):
    default = _same_default(entry, arg)
    _PORT[entry](**{arg: default})                 # the default is taken
    with pytest.raises(MXNetError, match=rf"{arg}=.*ROADMAP"):
        _PORT[entry](**{arg: value})


@pytest.mark.parametrize("entry,arg,value", _IGNORED,
                         ids=[f"{e}-{a}" for e, a, _ in _IGNORED])
def test_reference_argument_without_a_torch_meaning_is_ignored(entry, arg,
                                                               value):
    default = _same_default(entry, arg)
    _PORT[entry](**{arg: default})
    _PORT[entry](**{arg: value})
