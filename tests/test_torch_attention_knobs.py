"""``TPUMX_ATTENTION`` and ``TPUMX_DENSE_MAX_KV`` in the port's attention
dispatch, against the reference, on the CPU.

Both packages read and check the two knobs on every call: a bad mode
raises the reference's ``ValueError`` text in both.  Off the card every
mode takes the dense arm in both, and the outputs agree (1e-5, float32
rounding).  The card's choice is a pure function of the mode and the
key length (``attention_arm``): ``dense`` pins the dense arm, ``flash``
the kernels (the dense arm, with a warning, where no instance exists),
``auto`` the dense arm at a key length of at most
``TPUMX_DENSE_MAX_KV``; a deliberate dense choice does not warn, and
``dispatch_counts`` counts each distinct signature once.
"""
import importlib
import logging

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_mx_torch.base import MXNetError
ra = importlib.import_module("tpu_mx_torch.parallel.ring_attention")

jra = importlib.import_module("tpu_mx.parallel.ring_attention")
TOL = 1e-5


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.delenv("TPUMX_ATTENTION", raising=False)
    monkeypatch.delenv("TPUMX_DENSE_MAX_KV", raising=False)


def _qkv(b=2, h=2, t=24, d=16, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, h, t, d).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("bad", ["Flash", "xla", "", "pallas"])
def test_a_bad_mode_raises_the_references_error(monkeypatch, bad):
    monkeypatch.setenv("TPUMX_ATTENTION", bad)
    q, k, v = _qkv()
    with pytest.raises(ValueError) as want:
        jra.local_flash_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v))
    with pytest.raises(ValueError) as got:
        ra.local_flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v))
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="auto|dense|flash"):
        ra.attention_mode()
    with pytest.raises(ValueError, match="TPUMX_ATTENTION"):
        ra.attention_arm("cuda", 64, torch.float32, mode=bad)


@pytest.mark.parametrize("mode", [None, "auto", "dense", "flash"])
def test_every_mode_is_dense_on_the_cpu_and_matches_the_reference(
        monkeypatch, mode):
    if mode is not None:
        monkeypatch.setenv("TPUMX_ATTENTION", mode)
    q, k, v = _qkv(seed=3)
    vl = np.array([24, 13], np.int32)
    want = np.asarray(jra.local_flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        valid_length=vl))
    before = dict(ra.dispatch_counts)
    got = ra.local_flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), causal=True,
                                   valid_length=torch.from_numpy(vl))
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    assert ra.dispatch_counts["flash_kernel"] == before["flash_kernel"]
    for kv_len in (1, 512, 10 ** 6):
        assert ra.attention_arm("cpu", 64, torch.float32, mode,
                                kv_len) == "dense"


@pytest.mark.parametrize("max_kv,kv_len,arm", [
    ("512", 128, "dense"), ("512", 512, "dense"), ("512", 513,
                                                   "flash_kernel"),
    ("0", 1, "flash_kernel"), ("2048", 2048, "dense"),
    ("-1", 1, "flash_kernel")])
def test_auto_takes_the_dense_arm_up_to_dense_max_kv(monkeypatch, max_kv,
                                                     kv_len, arm):
    monkeypatch.setenv("TPUMX_DENSE_MAX_KV", max_kv)
    for d, dtype in ((64, torch.bfloat16), (128, torch.float32)):
        assert ra.attention_arm("cuda", d, dtype, "auto", kv_len) == arm
        assert ra.attention_arm("cuda", d, dtype, None, kv_len) == arm
        # the pinned modes ignore the threshold
        assert ra.attention_arm("cuda", d, dtype, "flash",
                                kv_len) == "flash_kernel"
        assert ra.attention_arm("cuda", d, dtype, "dense", kv_len) == "dense"


def test_the_default_threshold_is_the_measured_one():
    d = ra.DENSE_MAX_KV_DEFAULT
    assert isinstance(d, int) and d >= 0
    assert ra._dense_max_kv() == d
    assert ra.attention_arm("cuda", 64, torch.bfloat16, "auto",
                            d + 1) == "flash_kernel"
    if d:
        assert ra.attention_arm("cuda", 64, torch.bfloat16, "auto",
                                d) == "dense"
    # no key length: the threshold is not applied (the shape decides)
    assert ra.attention_arm("cuda", 64, torch.bfloat16) == "flash_kernel"


def test_a_bad_dense_max_kv_raises(monkeypatch):
    monkeypatch.setenv("TPUMX_DENSE_MAX_KV", "lots")
    with pytest.raises(ValueError, match="TPUMX_DENSE_MAX_KV"):
        ra.attention_arm("cuda", 64, torch.float32, "auto", 128)
    # off the card neither package compares, so neither reads it
    q, k, v = _qkv()
    want = np.asarray(jra.local_flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    got = ra.local_flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v))
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    # a pinned mode does not compare, so does not read it
    assert ra.attention_arm("cuda", 64, torch.float32, "flash",
                            128) == "flash_kernel"


@pytest.mark.parametrize("d,dtype,mode,arm,deliberate", [
    (64, torch.float32, "dense", "dense", True),
    (192, torch.float32, "dense", "dense", True),   # no instance: chosen
    (80, torch.float32, "flash", "dense", False),   # no instance: warned
    (80, torch.float32, "auto", "dense", False),
    (64, torch.float16, "flash", "dense", False),
    (128, torch.bfloat16, "flash", "flash_kernel", False),
])
def test_a_deliberate_dense_choice_is_told_apart(d, dtype, mode, arm,
                                                 deliberate):
    """The warning is for a dense arm the shape forced, not for one the
    mode asked for (the reference's ``warn=want_flash``)."""
    assert ra._choose("cuda", d, dtype, mode, 4096) == (arm, deliberate)


@pytest.mark.parametrize("d,refused", [(192, False), (256, False),
                                       (320, False), (384, False),
                                       (80, True)])
def test_flash_or_auto_refuse_a_shape_without_an_instance(d, refused):
    """Head dims 192 and 256 have instances, and 320 and more the
    runtime-D ones: whichever mode asks for the kernel gets it.  A head
    dim the reference's gate sends dense (80) takes the dense arm."""
    for mode in ("flash", "auto"):
        want = "dense" if refused else "flash_kernel"
        assert ra.attention_arm("cuda", d, torch.float32, mode,
                                4096) == want


def test_each_signature_counts_once_and_a_chosen_dense_does_not_warn(
        monkeypatch, caplog):
    q, k, v = (torch.from_numpy(x) for x in _qkv(t=40, seed=5))
    caplog.set_level(logging.INFO, logger=ra.__name__)
    for mode in ("dense", "auto", "flash"):
        monkeypatch.setenv("TPUMX_ATTENTION", mode)
        before = dict(ra.dispatch_counts)
        ra.local_flash_attention(q, k, v)
        first = dict(ra.dispatch_counts)
        ra.local_flash_attention(q, k, v)
        assert ra.dispatch_counts == first
        assert first["dense"] - before["dense"] in (0, 1)
    assert not [r for r in caplog.records if r.levelno >= logging.WARNING]
    # a new key length is a new signature
    before = ra.dispatch_counts["dense"]
    ra.local_flash_attention(q, k[:, :, :37], v[:, :, :37])
    assert ra.dispatch_counts["dense"] == before + 1
