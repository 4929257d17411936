"""Head dims of 320 and more (any multiple of 64, which the reference's
flash and paged gates take): the port's plain twins of the flash and
paged kernels against the reference's interpret-mode kernels, the units
the wrappers load for them (the runtime-D instances,
``csrc/*_dn.cu``), and a TinyLM with heads of 320 carried over from the
reference.

Inputs are made with numpy from a seed and fed to both packages; on the
CPU the port's wrappers run their plain versions.  The runtime-D CUDA
instances themselves are held to these plain versions on the card by
``chip_smoke.py`` (its kernel and ``wide_heads`` phases).  Tolerances are
those of ``tests/test_torch_wide_heads.py``: float32 on both sides, the
reference's own (2e-5 forward, 1e-4 for the backward's longer sums; the
bias path's 2e-4 / 3e-4 with its extra operand); a bfloat16 window is
compared after one bfloat16 rounding of the output (2^-8 of its scale).
"""
import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_mx.kernels import flash_attention as jfa
from tpu_mx.kernels import paged_attention as jpa
from tpu_mx.serving import TinyLM as JTinyLM

from tpu_mx_torch.kernels import _build
from tpu_mx_torch.kernels import flash_attention as fa
from tpu_mx_torch.kernels import paged_attention as pa
from tpu_mx_torch.serving import TinyLM

BH, T = 2, 128
F32_TOL = 2e-5
HUGE = (320, 384, 512)


def _qkv(seed, d, n=3):
    rng = np.random.RandomState(seed)
    return [rng.randn(BH, T, d).astype(np.float32) for _ in range(n)]


def _valid(seed):
    return np.random.RandomState(seed).randint(T // 2, T + 1, BH) \
        .astype(np.int32)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", HUGE)
def test_huge_flash_forward_matches_jax_kernel(d, causal):
    """The forward at T=128, BH=2 with ragged ``kv_valid``: output and
    lse of the plain twin against the interpret-mode kernel and float64."""
    q, k, v = _qkv(d, d)
    valid = _valid(d + 1)
    ref = np.asarray(jfa.flash_attention(q, k, v, causal=causal,
                                         kv_valid=valid))
    out, lse = fa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), causal=causal,
                                  kv_valid=torch.from_numpy(valid),
                                  return_lse=True)
    assert out.shape == (BH, T, d)
    np.testing.assert_allclose(out.numpy(), ref, rtol=F32_TOL, atol=F32_TOL)
    s = np.einsum("btd,bkd->btk", q.astype(np.float64), k) / math.sqrt(d)
    keep = np.arange(T)[None, None, :] < valid[:, None, None]
    if causal:
        keep = keep & np.tril(np.ones((T, T), bool))[None]
    s = np.where(keep, s, -np.inf)
    m = s.max(-1, keepdims=True)
    want = (m + np.log(np.exp(s - m).sum(-1, keepdims=True)))[..., 0]
    np.testing.assert_allclose(lse.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("d", HUGE)
def test_huge_flash_backward_matches_jax_vjp(d):
    """dq, dk, dv of the plain backward (the flash formulas from the
    saved lse) against ``jax.vjp`` of the interpret-mode kernels, causal
    with ragged ``kv_valid``."""
    q, k, v, do = _qkv(d + 2, d, 4)
    valid = _valid(d + 3)
    scale = 1.0 / math.sqrt(d)
    _, vjp = jax.vjp(lambda a, b, c: jfa.flash_attention(
        a, b, c, causal=True, kv_valid=valid), q, k, v)
    want = [np.asarray(g) for g in vjp(do)]
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    kv = torch.from_numpy(valid)
    out, lse = fa.flash_attention_plain(tq, tk, tv, scale, True, kv)
    got = fa.flash_attention_bwd_plain(tq, tk, tv, tdo, lse,
                                       fa.flash_attention_delta(tdo, out),
                                       scale, True, kv)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("d", [320, 512])
def test_huge_flash_bias_and_its_gradient_match_jax(d):
    """A per-head bias ``(1, H, T, T)`` with ``valid_length``: the
    forward and every gradient (d_bias included) of the port's bias path
    against ``jax.vjp`` of the reference's interpret-mode kernels."""
    b, h = 1, 2
    rng = np.random.RandomState(d)
    q, k, v, do = (rng.randn(b, h, T, d).astype(np.float32)
                   for _ in range(4))
    bias = rng.randn(1, h, T, T).astype(np.float32)
    valid = np.array([97], np.int32)
    f = lambda a, c, e, g: jfa.mha_flash_attention(
        a, c, e, causal=True, valid_length=valid, bias=g, block_q=64,
        block_k=64)
    ref, vjp = jax.vjp(f, q, k, v, bias)
    want = [np.asarray(g) for g in vjp(do)]
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v, bias)]
    out = fa.mha_flash_attention(*leaves[:3], causal=True, bias=leaves[3],
                                 valid_length=torch.from_numpy(valid))
    out.backward(torch.from_numpy(do))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               rtol=2e-4, atol=2e-5)
    for x, w, name in zip(leaves, want, ("q", "k", "v", "bias")):
        np.testing.assert_allclose(x.grad.numpy(), w, rtol=3e-4, atol=3e-5,
                                   err_msg=f"d{name}")


def _paged_case(seed, d, tq, h=2, bs=16, nblocks=24):
    """Three rows of 13-70 tokens over fragmented, 0-padded tables."""
    rng = np.random.RandomState(seed)
    lens = np.array([tq + 1, 37, 70], np.int32)
    nb = -(-int(lens.max()) // bs)
    perm = rng.permutation(nblocks)
    tables = np.zeros((3, nb), np.int32)
    at = 0
    for i, n in enumerate(lens):
        used = -(-int(n) // bs)
        tables[i, :used] = perm[at:at + used]
        at += used
    kp, vp = (rng.randn(nblocks, bs, h, d).astype(np.float32)
              for _ in range(2))
    q = rng.randn(3, tq, h, d).astype(np.float32)
    return q, kp, vp, tables, lens


@pytest.mark.parametrize("tq,q_dtype,pool_dtype", [
    (12, "float32", "float32"),      # a speculative window of 12
    (1, "bfloat16", "float32"),      # bfloat16 queries, output in bf16
    (1, "float32", "float16"),       # a float16 pool
    (12, "bfloat16", "float16"),     # all three
])
@pytest.mark.parametrize("d", [320, 512])
def test_huge_paged_plain_matches_jax_reference(d, tq, q_dtype, pool_dtype):
    """The port's paged walk against the reference's
    ``paged_attention_reference`` on the same (rounded) operands."""
    q, kp, vp, tables, lens = _paged_case(tq + d, d, tq)
    jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16,
          "float16": jnp.float16}
    td = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}
    ref = jpa.paged_attention_reference(
        jnp.asarray(q, jd[q_dtype]), jnp.asarray(kp, jd[pool_dtype]),
        jnp.asarray(vp, jd[pool_dtype]), tables, lens)
    t = lambda x, dt: torch.from_numpy(x).to(td[dt])
    got = pa.paged_attention(t(q, q_dtype), t(kp, pool_dtype),
                             t(vp, pool_dtype), torch.from_numpy(tables),
                             torch.from_numpy(lens), device="cpu")
    assert got.dtype == td[q_dtype] and ref.dtype == jd[q_dtype]
    assert got.shape == q.shape
    want = np.asarray(ref.astype(jnp.float32))
    tol = F32_TOL if q_dtype == "float32" else 2 ** -8
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("d", [320, 384, 448, 512, 1024, 4096])
def test_every_multiple_of_64_above_256_has_an_instance(d):
    """What the reference's gates take (a head dim that is a multiple of
    64, float32 or bfloat16 queries) the port's kernels take, through the
    runtime-D instances; other head dims and float16 queries stay off."""
    for dtype, jdtype in ((torch.float32, jnp.float32),
                          (torch.bfloat16, jnp.bfloat16)):
        assert fa.kernel_takes(d, dtype) and fa.runtime_d(d)
        assert jfa.supported((1, 1, 128, d), jdtype)
        for pool in (torch.float32, torch.bfloat16, torch.float16):
            assert pa.kernel_takes(d, dtype, pool, window=12)
    assert not fa.kernel_takes(d, torch.float16)
    assert not fa.kernel_takes(d + 32, torch.float32)
    assert not pa.kernel_takes(d + 32, torch.float32, torch.float32)


@pytest.mark.parametrize("d,flash_unit,paged_unit", [
    (64, "{}", "paged_attention"),
    (128, "{}_d128", "paged_attention"),
    (256, "{}_d256", "paged_attention"),
    (320, "{}_dn", "paged_attention_dn"),
    (1024, "{}_dn", "paged_attention_dn"),
])
def test_the_wrappers_load_the_runtime_d_units_above_256(
        monkeypatch, d, flash_unit, paged_unit):
    """The library each wrapper loads for a head dim (no build here: the
    loader records the unit asked for)."""
    asked = []

    def load(unit):
        asked.append(unit)
        return types.SimpleNamespace(
            tmx_flash_attention_fwd=types.SimpleNamespace(),
            tmx_flash_attention_bwd_dq=types.SimpleNamespace(),
            tmx_flash_attention_bwd_dkv=types.SimpleNamespace(),
            tmx_paged_attention=types.SimpleNamespace())
    monkeypatch.setattr(_build, "load", load)
    monkeypatch.setattr(fa, "_libs", {})
    monkeypatch.setattr(pa, "_libs", {})
    for name in ("flash_attention_fwd", "flash_attention_bwd"):
        fa._lib(name, d)
    pa._kernel_lib(d)
    assert asked == [flash_unit.format("flash_attention_fwd"),
                     flash_unit.format("flash_attention_bwd"), paged_unit]
    assert set(asked) <= set(_build.SOURCES)


def test_tinylm_with_heads_of_320_carries_over_and_prefills_alike():
    """A TinyLM of 4 heads of 320 from the reference's weights: the same
    weights, and the prefill's logits, keys and values of the reference's
    model (the flash plain twin at D=320 inside)."""
    ref = JTinyLM(vocab_size=64, embed_dim=1280, num_heads=4, num_layers=2,
                  seed=5)
    model = TinyLM.from_numpy(ref.tok_emb, ref.pos_emb, ref.layers,
                              ref.w_out, num_heads=4, device="cpu")
    assert model.head_dim == 320
    for i, lay in enumerate(ref.layers):
        for n in ("wq", "wk", "wv", "wo"):
            assert np.array_equal(getattr(model, n)[i].numpy(), lay[n])
    tokens = np.random.RandomState(5).randint(0, 64, size=29)
    k, v, logits = ref.prefill(tokens)
    k2, v2, logits2 = model.prefill(tokens)
    np.testing.assert_allclose(logits2.numpy(), logits, atol=1e-4, rtol=0)
    np.testing.assert_allclose(k2.numpy(), k, atol=1e-5, rtol=0)
    np.testing.assert_allclose(v2.numpy(), v, atol=1e-5, rtol=0)
