"""The rest of ``CompiledTrainStep`` against the reference
(``tpu_mx/parallel/train_step.py``, ``integrity.py``, ``mesh.py``,
``contrib/compression.py``).

On the CPU, inputs made with numpy from a seed:

- ``save_checkpoint``/``load_checkpoint``: a fresh step that loads a
  checkpoint continues bit for bit as the saved one (dropout 0.1, bf16
  with float32 masters); async saves stamp their marker at
  ``wait_for_checkpoint``, where a failed write raises unstamped; a path
  without its marker is skipped for the
  next fallback; no usable path raises the reference's error;
- ``fingerprint()`` (over the values keyed by structural name) and
  ``device_fingerprint`` equal the reference's digest of the same
  arrays exactly, and one flipped bit changes it;
  ``TPUMX_FINGERPRINT=0`` gives None;
- ``step(deadline=)`` returns the step's loss, and a stalled step raises
  ``WatchdogTimeout`` and drops its update;
- ``make_mesh``/``P`` at world size 1, ``apply_rules``, ``fsdp_rules``,
  the step's specs under ``bert_sharding_rules`` and the reference's
  ``gradient_compression`` error; the three quantizer cores to 1e-6.
"""
import os
import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from tpu_mx.contrib import compression as jcomp
from tpu_mx.parallel import integrity as jint
from tpu_mx.parallel import train_step as jts
from tpu_mx.models import bert as jbert

import tpu_mx_torch as mx
from tpu_mx_torch import optimizer
from tpu_mx_torch.base import MXNetError
from tpu_mx_torch.contrib import compression as pcomp
from tpu_mx_torch.models import BERTModel, MLMLoss
from tpu_mx_torch.models.bert import bert_data_specs, bert_sharding_rules
from tpu_mx_torch.parallel import (CompiledTrainStep, P, apply_rules,
                                   fsdp_rules, hybrid_mesh, local_mesh,
                                   make_mesh, sharding_for)
from tpu_mx_torch.parallel import integrity as pint
from tpu_mx_torch.supervisor import WatchdogTimeout

CFG = dict(num_layers=2, units=32, hidden_size=64, num_heads=2,
           vocab_size=50, max_length=16, dropout=0.1)


@pytest.fixture(autouse=True)
def _host():
    with mx.cpu():
        yield


def _batch(seed=0, n=4, t=16, m=3):
    rng = np.random.RandomState(seed)
    tokens = rng.randint(4, 50, (n, t)).astype(np.int32)
    valid = np.array([16, 12, 9, 16][:n], np.int32)
    pos = np.stack([rng.choice(v, m, replace=False) for v in valid])
    labels = np.take_along_axis(tokens, pos, 1)
    return tuple(torch.from_numpy(a) for a in
                 (tokens, np.zeros_like(tokens), valid, pos.astype(np.int32),
                  labels))


def _step(dtype="bfloat16"):
    net = BERTModel(CFG, dtype=dtype, device="cpu",
                    generator=torch.Generator().manual_seed(3))
    opt = optimizer.create("lamb", learning_rate=1e-3, multi_precision=True)
    return CompiledTrainStep(net, MLMLoss(), opt)


# -- checkpoints ------------------------------------------------------------------
def test_a_loaded_step_continues_bit_for_bit(tmp_path):
    a = _step()
    for i in range(2):
        a.step(*_batch(i))
    path = tmp_path / "ck"
    a.save_checkpoint(path)
    assert os.path.exists(a.commit_marker_path(path))
    b = _step()
    b.step(*_batch(9))                     # other state, to be replaced
    assert b.load_checkpoint(path) == str(path)
    for i in (2, 3):
        la, lb = a.step(*_batch(i)), b.step(*_batch(i))
        assert torch.equal(la, lb)
        assert a.fingerprint() == b.fingerprint() is not None
    for (n, p), q in zip(a.net.named_parameters(), b.net.parameters()):
        assert torch.equal(p, q), n
    assert all(torch.equal(a.masters[k], b.masters[k]) for k in a.masters)
    assert a._t == b._t == 4


def test_async_save_stamps_its_marker_when_waited_for(tmp_path,
                                                      monkeypatch):
    a = _step("float32")
    a.step(*_batch())
    path = tmp_path / "async"
    a.save_checkpoint(path, block=False)
    a.step(*_batch(1))                     # training goes on
    a.wait_for_checkpoint()
    assert os.path.exists(a.commit_marker_path(path))
    b = _step("float32")
    b.load_checkpoint(path)
    assert b._t == 1
    # a write that fails raises at the wait and stamps no marker
    def full_disk(*args, **kwargs):
        raise OSError("no space left on device")

    monkeypatch.setattr(torch, "save", full_disk)
    a.save_checkpoint(tmp_path / "bad", block=False)
    with pytest.raises(OSError, match="no space"):
        a.wait_for_checkpoint()
    assert not os.path.exists(a.commit_marker_path(tmp_path / "bad"))
    assert not os.path.exists(tmp_path / "bad")


def test_a_marker_less_path_falls_back_and_none_raises(tmp_path):
    a = _step("float32")
    a.step(*_batch())
    old, new = tmp_path / "old", tmp_path / "new"
    a.save_checkpoint(old)
    a.step(*_batch(1))
    a.save_checkpoint(new)
    os.remove(a.commit_marker_path(new))   # an interrupted save
    b = _step("float32")
    assert b.load_checkpoint(new, fallback_paths=[old]) == str(old)
    assert b._t == 1
    # the last resort is tried without its marker
    c = _step("float32")
    assert c.load_checkpoint(new) == str(new) and c._t == 2
    (tmp_path / "junk").write_bytes(b"not a checkpoint")
    with pytest.raises(MXNetError, match="no restorable checkpoint among"):
        c.load_checkpoint(tmp_path / "missing",
                          fallback_paths=[tmp_path / "junk"])


# -- fingerprints -----------------------------------------------------------------
def _tree(rng):
    return {"w": rng.randn(6, 5).astype(np.float32),
            "a": [rng.randn(9).astype(np.float32) * 1e3,
                  np.arange(-7, 7, dtype=np.int32)],
            "h": rng.randn(13).astype(np.float16),
            "m": rng.rand(5) > 0.5,
            "d": rng.randn(4)}


def _torch_tree(tree):
    return {k: [torch.from_numpy(x) for x in v] if isinstance(v, list)
            else torch.from_numpy(v) for k, v in tree.items()}


def test_device_fingerprint_is_the_references_bit_for_bit():
    rng = np.random.RandomState(0)
    tree = _tree(rng)
    bf = rng.randn(11).astype(np.float32)
    ref_tree = {k: v for k, v in tree.items() if k != "d"}
    ref_tree["b"] = jnp.asarray(bf, dtype=jnp.bfloat16)
    port_tree = _torch_tree({k: v for k, v in tree.items() if k != "d"})
    port_tree["b"] = torch.from_numpy(bf).bfloat16()
    want = int(jint.device_fingerprint(ref_tree))
    assert int(pint.device_fingerprint(port_tree)) == want
    # one flipped bit in any leaf changes it
    flipped = dict(port_tree, b=port_tree["b"].clone())
    flipped["b"].view(torch.int16)[3] ^= 1 << 9
    assert int(pint.device_fingerprint(flipped)) != want
    # float64 (host fold of the reference's formula)
    d = tree["d"].view(np.uint64)
    words = (d & 0xFFFFFFFF) ^ (d >> np.uint64(32))
    want64 = (2166136261 * 16777619 + int(words.sum()) % (1 << 32)) \
        % (1 << 32)
    assert int(pint.device_fingerprint(torch.from_numpy(tree["d"]))) \
        == want64


def test_host_fingerprint_is_the_references():
    rng = np.random.RandomState(1)
    value = [rng.randn(4).astype(np.float32), (np.arange(3), None), 7]
    assert pint.host_fingerprint(value) == jint.host_fingerprint(value)
    bf = torch.from_numpy(rng.randn(5).astype(np.float32)).bfloat16()
    words = bf.view(torch.int16).numpy().view(np.uint16)
    assert pint.host_fingerprint([bf]) == jint.host_fingerprint([words])


def test_the_steps_fingerprint_is_the_reference_digest_of_its_values(
        monkeypatch):
    a = _step()
    assert a.fingerprint() is None
    a.step(*_batch())
    values = {k: p.data()._data.detach()
              for k, p in a.net.collect_params().items()}
    ref_tree = {k: jnp.asarray(v.float().numpy()).astype(jnp.bfloat16)
                if v.dtype == torch.bfloat16 else jnp.asarray(v.numpy())
                for k, v in values.items()}
    assert a.fingerprint() == int(jint.device_fingerprint(ref_tree))
    before = a.fingerprint()
    with torch.no_grad():
        w = next(a.net.parameters())
        w.view(torch.int16).view(-1)[0] ^= 1
    a.step(*_batch(1))
    assert a.fingerprint() != before
    monkeypatch.setenv("TPUMX_FINGERPRINT", "0")
    a.step(*_batch(2))
    assert a.fingerprint() is None


# -- the watchdog -------------------------------------------------------------------
def test_deadline_returns_the_loss():
    a, b = _step("float32"), _step("float32")
    want = b.step(*_batch())
    got = a.step(*_batch(), deadline=60.0)
    assert torch.equal(got, want)


def test_a_stalled_step_raises_and_drops_its_update():
    a = _step("float32")
    a.step(*_batch())
    gate = threading.Event()
    forward = a.net.forward

    def stalled(*args, **kwargs):
        gate.wait(30)
        return forward(*args, **kwargs)

    a.net.forward = stalled
    before = [p.detach().clone() for p in a.net.parameters()]
    with pytest.raises(WatchdogTimeout):
        a.step(*_batch(1), deadline=0.2, compile_grace=0.0)
    sd = a.state_dict()
    a.load_state_dict(sd)                  # a restore: the zombie is stale
    gate.set()
    for _ in range(100):
        if a._t == 1 and not any(t.name == "watchdog-train_step"
                                 for t in threading.enumerate()):
            break
        threading.Event().wait(0.05)
    assert a._t == 1
    assert all(torch.equal(p, q) for p, q in zip(a.net.parameters(), before))


# -- the mesh at world size 1 --------------------------------------------------------
def test_make_mesh_at_world_size_one():
    mesh = make_mesh({"dp": 1, "tp": -1})
    assert mesh.axis_names == ("dp", "tp") and mesh.shape == {"dp": 1,
                                                              "tp": 1}
    assert mesh.size == 1 and str(mesh.device) == "cpu"
    assert local_mesh(dp=1).shape == {"dp": 1}
    assert hybrid_mesh({"dp": 1}, {"dp": 1}).shape == {"dp": 1}
    # above one rank a mesh needs the ranks' process group
    with pytest.raises(MXNetError, match="no process group"):
        make_mesh({"dp": 2})
    with pytest.raises(MXNetError, match="no process group"):
        make_mesh({"dp": 1, "tp": 4})
    with pytest.raises(ValueError, match="at most one axis"):
        make_mesh({"dp": -1, "tp": -1})
    assert P("tp", None) == jbert.P("tp", None) and P() == ()
    assert repr(P("dp", None)) == "PartitionSpec('dp', None)"
    assert sharding_for(None, P()) is None
    assert sharding_for(mesh, P("dp")).spec == P("dp")


def test_the_rules_are_the_references():
    assert [(r, tuple(s)) for r, s in bert_sharding_rules()] == \
        [(r, tuple(s)) for r, s in jbert.bert_sharding_rules()]
    assert [tuple(s) for s in bert_data_specs()] == \
        [tuple(s) for s in jbert.bert_data_specs()]
    mesh = make_mesh({"dp": 1, "tp": 1})

    class _RefMesh:
        axis_names = ("dp", "tp")

    shapes = {"l.qkv_weight": (96, 32), "l.ffn1_bias": (64,),
              "ln_gamma": (32,)}
    rules = bert_sharding_rules()
    ref_rules = jbert.bert_sharding_rules()
    for name, shape in shapes.items():
        assert tuple(apply_rules(name, shape, rules, mesh)) == \
            tuple(jts.apply_rules(name, shape, ref_rules, _RefMesh()))
    params = {"a": np.zeros((64, 48)), "b": np.zeros((30, 50)),
              "c": np.zeros((8,))}
    got = fsdp_rules(params, axis_size=4)
    want = jts.fsdp_rules(params, axis_size=4)
    assert [(r, tuple(s)) for r, s in got] == \
        [(r, tuple(s)) for r, s in want]


def test_the_step_takes_a_world_size_one_mesh_and_rules():
    net = BERTModel(dict(CFG, dropout=0.0), device="cpu",
                    mesh=make_mesh({"dp": 1, "tp": 1}),
                    generator=torch.Generator().manual_seed(3))
    mesh = make_mesh({"dp": 1, "tp": 1})
    step = CompiledTrainStep(net, MLMLoss(), optimizer.create(
        "lamb", learning_rate=1e-3), mesh=mesh, rules=bert_sharding_rules(),
        data_specs=bert_data_specs())
    specs = {k.split(".")[-1]: tuple(s) for k, s in step.specs.items()}
    assert specs["qkv_weight"] == ("tp", None)
    assert specs["attnout_weight"] == (None, "tp")
    assert specs["mlm_bias"] == ()
    fsdp = CompiledTrainStep(net, MLMLoss(), optimizer.create("lamb"),
                             mesh=make_mesh({"dp": 1}), rules=fsdp_rules(
                                 net.collect_params(), min_size=1))
    assert all(tuple(s) and "dp" in tuple(s) for s in fsdp.specs.values())
    plain = CompiledTrainStep(
        BERTModel(dict(CFG, dropout=0.0), device="cpu",
                  generator=torch.Generator().manual_seed(3)),
        MLMLoss(), optimizer.create("lamb", learning_rate=1e-3))
    assert torch.equal(step.step(*_batch()), plain.step(*_batch()))


def test_gradient_compression_raises_where_the_reference_raises():
    net = BERTModel(CFG, device="cpu", generator=torch.Generator())
    opt = optimizer.create("sgd", learning_rate=0.1)
    for gc, msg in (({"type": "3bit"}, "unsupported compression type"),
                    ({"type": "2bit"}, "needs a mesh with a dp axis >1")):
        with pytest.raises(ValueError, match=msg):
            CompiledTrainStep(net, MLMLoss(), opt, gradient_compression=gc)
        with pytest.raises(ValueError, match=msg):
            _ref_compression_error(gc)
    with pytest.raises(ValueError, match="needs a mesh"):
        CompiledTrainStep(net, MLMLoss(), opt, mesh=make_mesh({"dp": 1}),
                          gradient_compression={"type": "int8"})


def _ref_compression_error(gc):
    """The reference step's check, on a one-parameter net."""
    import tpu_mx as jmx
    from tpu_mx import gluon as jgluon
    from tpu_mx import nd as jnd
    net = jgluon.nn.Dense(2, in_units=2)
    net.initialize()
    net(jnd.zeros((1, 2)))
    jts.CompiledTrainStep(net, jgluon.loss.L2Loss(),
                          jmx.optimizer.create("sgd", learning_rate=0.1),
                          gradient_compression=gc)


@pytest.mark.parametrize("kind", ["2bit", "int8", "fp8"])
def test_quantizer_cores_hold_to_the_reference(kind):
    rng = np.random.RandomState(4)
    g = rng.randn(257).astype(np.float32)
    r = (rng.randn(257) * 0.1).astype(np.float32)
    if kind == "2bit":
        want = jcomp.quantize_2bit_core(jnp.asarray(g), jnp.asarray(r), 0.5)
        got = pcomp.quantize_2bit_core(torch.from_numpy(g),
                                       torch.from_numpy(r), 0.5)
    else:
        want = getattr(jcomp, f"quantize_{kind}_core")(jnp.asarray(g),
                                                        jnp.asarray(r))
        got = getattr(pcomp, f"quantize_{kind}_core")(torch.from_numpy(g),
                                                       torch.from_numpy(r))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-6)
