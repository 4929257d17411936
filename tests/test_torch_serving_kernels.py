"""CPU models of the serving path's two Hopper kernels, held to the reference.

- The float32 flash forward runs on the tensor cores in split precision
  (3xTF32): every operand ``x`` becomes ``hi = rna_tf32(x)`` and
  ``lo = rna_tf32(x - hi)``, and a product is ``a_hi·b_hi + a_hi·b_lo +
  a_lo·b_hi`` accumulated in float32.  :func:`f32tc_model` repeats that
  arithmetic (rounding through ``.view(torch.int32)``, the kernel's own
  bit manipulation) with the kernel's online softmax over 32-key tiles,
  and is held to the reference's interpret-mode ``_fwd`` within the card's
  1e-4 for ``out`` and ``lse``.  A one-pass TF32 model fails that
  tolerance, so the test can tell the two apart.
- The paged decode kernel is split over the keys (flash-decoding).
  :func:`split_k_model` repeats its partition (splits of 64 keys, the
  ``(m, l, acc)`` of each, ``(-1e30, 0)`` for a split past a row's
  length) and its merge, and is held to
  ``tpu_mx.kernels.paged_attention.paged_attention_reference`` within
  1e-5.

Inputs are made with numpy from a seed.  The kernels themselves are
checked against their plain versions on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_mx.kernels import flash_attention as jfa
from tpu_mx.kernels import paged_attention as jpa

from tpu_mx_torch.kernels import flash_attention as fa

NEG_INF = -1e30
TOL = 1e-4           # the card's kernel-vs-plain tolerance, float32
F32_KEY_TILE = 32    # kF32Keys in csrc/flash_attention_fwd.cu
SPLIT_KEYS = 64      # kSplitKeys in csrc/paged_attention.cu


# ---------------------------------------------------------------------------
# the float32 forward: 3xTF32
# ---------------------------------------------------------------------------
def tf32_rna(x):
    """``x`` rounded to TF32 (10 mantissa bits), to nearest with ties away
    from zero: the low 13 bits of the bit pattern rounded on the
    magnitude, as the kernel does it."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_tf32(x):
    """The kernel's split: ``hi`` rounded to nearest, and ``lo``, the
    exact ``x - hi`` rounded the same way."""
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def mm_3xtf32(a, b):
    """``a @ b`` as the kernel's three TF32 products, float32 sums."""
    ah, al = split_tf32(a)
    bh, bl = split_tf32(b)
    return al @ bh + ah @ bl + ah @ bh


def mm_1xtf32(a, b):
    """One TF32 pass: what the serving gates forbid."""
    return tf32_rna(a) @ tf32_rna(b)


def f32tc_model(q, k, v, scale, causal=False, kv_valid=None, bias=None,
                mm=mm_3xtf32):
    """The float32 tensor-core forward's arithmetic: ``(out, lse)`` of
    ``(BH, T, D)`` float32 inputs, an online softmax over 32-key tiles
    with the products done by ``mm``.  Masked scores are -1e30 (or -inf
    under a bias, as in the kernel)."""
    bh, t, d = q.shape
    tk = k.shape[1]
    masked = -math.inf if bias is not None else NEG_INF
    valid = torch.full((bh,), tk) if kv_valid is None \
        else torch.as_tensor(kv_valid).long().clamp(0, tk)
    qi = torch.arange(t).reshape(1, t, 1)
    m = torch.full((bh, t, 1), NEG_INF)
    l = torch.zeros((bh, t, 1))
    acc = torch.zeros((bh, t, d))
    for k0 in range(0, tk, F32_KEY_TILE):
        kn = min(F32_KEY_TILE, tk - k0)
        ki = torch.arange(k0, k0 + kn).reshape(1, 1, kn)
        ok = (ki < valid.reshape(bh, 1, 1)).expand(bh, t, kn)
        if causal:
            ok = ok & (ki <= qi)
        s = mm(q, k[:, k0:k0 + kn].transpose(1, 2)) * scale
        if bias is not None:
            s = s + bias[:, :, k0:k0 + kn]
        s = torch.where(ok, s, masked)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + mm(p, v[:, k0:k0 + kn])
        m = m_new
    out = acc / l.clamp_min(1e-30)
    lse = (m + torch.log(l.clamp_min(1e-30)))[..., 0]
    return out, lse


def _f32_case(seed, t, d, kv, biased):
    rng = np.random.RandomState(seed)
    bh = 3
    q, k, v = (rng.randn(bh, t, d).astype(np.float32) * 1.5
               for _ in range(3))
    valid = np.array([t, max(1, t // 3), max(1, t - 5)][:bh], np.int32) \
        if kv else None
    bias = rng.randn(bh, t, t).astype(np.float32) if biased else None
    return q, k, v, valid, bias


def _reference_fwd(q, k, v, valid, bias, scale, causal):
    """The reference's interpret-mode forward kernel, one block of T rows
    and keys (its blocks must tile T exactly): ``(out, lse)``."""
    t = q.shape[1]
    out, lse = jfa._fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        None if valid is None else jnp.asarray(valid),
                        None, None if bias is None else jnp.asarray(bias),
                        scale, causal, 0.0, t, t)
    return np.asarray(out), np.asarray(lse)[..., 0]


@pytest.mark.parametrize("biased", [False, True], ids=["no-bias", "bias"])
@pytest.mark.parametrize("kv", [False, True], ids=["all-keys", "kv_valid"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("t", [1, 77, 128, 700])
def test_3xtf32_model_matches_the_reference_kernel(t, causal, kv, biased):
    d = 64
    q, k, v, valid, bias = _f32_case(t + 7 * causal + 3 * kv, t, d, kv,
                                     biased)
    scale = d ** -0.5
    ref, ref_lse = _reference_fwd(q, k, v, valid, bias, scale, causal)
    out, lse = f32tc_model(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), scale, causal, valid,
                           None if bias is None else torch.from_numpy(bias))
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=TOL)
    np.testing.assert_allclose(lse.numpy(), ref_lse, rtol=0, atol=TOL)


def test_one_tf32_pass_fails_the_tolerance_at_t700():
    """The tolerance tells the designs apart: at T=700 a single TF32 pass
    misses the reference by more than 1e-4 where 3xTF32 stays inside."""
    d = 128
    q, k, v, _, _ = _f32_case(700, 700, d, False, False)
    scale = d ** -0.5
    ref, ref_lse = _reference_fwd(q, k, v, None, None, scale, True)
    t = lambda x: torch.from_numpy(x)
    errs = {}
    for name, mm in (("3x", mm_3xtf32), ("1x", mm_1xtf32)):
        out, lse = f32tc_model(t(q), t(k), t(v), scale, True, mm=mm)
        errs[name] = max(float(np.abs(out.numpy() - ref).max()),
                         float(np.abs(lse.numpy() - ref_lse).max()))
    assert errs["3x"] <= TOL < errs["1x"], errs


def test_tf32_rounding_is_nearest_ties_away():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11,
                      -(1.0 + 2 ** -11), 1.0 + 2 ** -12, 3.0e-39])
    got = tf32_rna(x)
    want = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 * 2 ** -10,
                         -(1.0 + 2 ** -10), 1.0, 3.0e-39])
    assert torch.equal(got[:5], want[:5])
    assert (got.view(torch.int32) & 0x1FFF == 0).all()
    x = torch.tensor([math.pi, -1.0 / 3.0, 7.0e-3])
    hi, lo = split_tf32(x)
    assert ((hi.view(torch.int32) | lo.view(torch.int32)) & 0x1FFF == 0).all()
    # |x - hi| <= 2^-11 |x|, and lo rounds it to within 2^-11 of itself
    assert ((hi.double() + lo.double() - x.double()).abs()
            <= 2 ** -22 * x.double().abs()).all()


def test_3xtf32_model_is_the_plain_forward_on_exact_inputs():
    """On TF32-exact inputs with power-of-two sums the split products are
    exact, so the model and the float32 plain version agree to float32
    rounding of the softmax alone."""
    rng = np.random.RandomState(3)
    q, k, v = (torch.from_numpy(rng.randint(-4, 5, (2, 40, 16))
                                .astype(np.float32) / 4) for _ in range(3))
    out, lse = f32tc_model(q, k, v, 0.25, causal=True)
    ref, ref_lse = fa.flash_attention_plain(q, k, v, 0.25, causal=True)
    torch.testing.assert_close(out, ref, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(lse, ref_lse, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# paged decode: split over the keys, then merged
# ---------------------------------------------------------------------------
def split_k_model(q, k_pool, v_pool, tables, lengths, scale):
    """The split kernel's partition and merge: row b's keys
    ``[0, min(length, NB*BS))`` cut into ``S = ceil(NB*BS / 64)`` splits of
    64 keys; each split's ``(m, l, acc)`` over its admitted keys (query
    ``t`` admits positions ``< length - (Tq - 1 - t)``), ``(-1e30, 0)``
    and no acc for a split that starts past the row's keys; then ``M =
    max m_s``, ``L = sum l_s e^(m_s - M)``, ``out = sum acc_s e^(m_s - M)
    / L`` over the splits with ``l_s > 0``.  Returns ``(out, m, l)``,
    ``m``/``l`` of shape ``(B, S, Tq, H)``."""
    b, tq, h, d = q.shape
    bs, nb = k_pool.shape[1], tables.shape[1]
    splits = -(-nb * bs // SPLIT_KEYS)
    m = torch.full((b, splits, tq, h), NEG_INF)
    l = torch.zeros((b, splits, tq, h))
    acc = torch.zeros((b, splits, tq, h, d))
    for r in range(b):
        kv_end = min(int(lengths[r]), nb * bs)
        for s in range(splits):
            start = s * SPLIT_KEYS
            if start >= kv_end:
                continue              # (-1e30, 0): nothing of the row
            pos = torch.arange(start, min(start + SPLIT_KEYS, kv_end))
            blk = tables[r, pos // bs].long()
            keys = k_pool[blk, pos % bs].float()          # (n, H, D)
            vals = v_pool[blk, pos % bs].float()
            sc = torch.einsum("thd,nhd->thn", q[r].float(), keys) * scale
            limit = int(lengths[r]) - (tq - 1) + torch.arange(tq)
            ok = pos[None, None, :] < limit[:, None, None]
            sc = torch.where(ok, sc, NEG_INF)
            ms = sc.amax(-1)
            p = torch.where(ok, torch.exp(sc - ms[..., None]), 0.0)
            m[r, s], l[r, s] = ms, p.sum(-1)
            acc[r, s] = torch.einsum("thn,nhd->thd", p, vals)
    live = l > 0
    big = torch.where(live, m, NEG_INF).amax(1, keepdim=True)
    f = torch.where(live, torch.exp(m - big), 0.0)
    den = (l * f).sum(1)
    num = (torch.where(live[..., None], acc, 0.0) * f[..., None]).sum(1)
    return num / den.clamp_min(1e-30)[..., None], m, l


def _split_case(seed, tq, bs, nb, lengths, pool_dtype):
    rng = np.random.RandomState(seed)
    b, h, d = len(lengths), 2, 16
    n = b * nb + 1
    kp = rng.randn(n, bs, h, d).astype(np.float32)
    vp = rng.randn(n, bs, h, d).astype(np.float32)
    tables = np.zeros((b, nb), np.int32)       # padded with block 0
    perm = rng.permutation(n - 1) + 1
    for r, length in enumerate(lengths):
        own = min(-(-length // bs), nb)
        tables[r, :own] = perm[r * nb:r * nb + own]
    q = rng.randn(b, tq, h, d).astype(np.float32)
    lens = np.asarray(lengths, np.int32)
    if pool_dtype == "bfloat16":     # the same rounded values on both sides
        kp = torch.from_numpy(kp).to(torch.bfloat16).float().numpy()
        vp = torch.from_numpy(vp).to(torch.bfloat16).float().numpy()
    return q, kp, vp, tables, lens


@pytest.mark.parametrize("pool_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tq", [1, 4, 8])
@pytest.mark.parametrize("bs,nb", [(16, 12), (4, 40), (48, 3)])
def test_split_k_model_matches_the_reference(bs, nb, tq, pool_dtype):
    """Ragged lengths from Tq up to NB*BS (splits wholly past a row's
    length, a row in one split, a row filling the table)."""
    top = nb * bs
    lengths = [tq, max(tq, 37), top // 2 + 3, top, max(tq, SPLIT_KEYS),
               SPLIT_KEYS + 1]
    q, kp, vp, tables, lens = _split_case(bs * nb + tq, tq, bs, nb, lengths,
                                          pool_dtype)
    scale = q.shape[-1] ** -0.5
    want = np.asarray(jpa.paged_attention_reference(q, kp, vp, tables, lens,
                                                    scale))
    t = torch.from_numpy
    store = torch.bfloat16 if pool_dtype == "bfloat16" else torch.float32
    got, m, l = split_k_model(t(q), t(kp).to(store), t(vp).to(store),
                              t(tables), t(lens), scale)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    # splits past a row's keys hold (-1e30, 0)
    splits = m.shape[1]
    for r, length in enumerate(lengths):
        first_empty = -(-min(length, nb * bs) // SPLIT_KEYS)
        assert (m[r, first_empty:] == NEG_INF).all()
        assert (l[r, first_empty:] == 0).all()
        assert first_empty <= splits


def test_split_k_model_with_one_live_split_has_no_nan():
    """Every split but the first is empty for every row: the merge
    reads only the live one, and nothing turns into NaN."""
    q, kp, vp, tables, lens = _split_case(5, 1, 16, 40, [1, 5, 64, 2],
                                          "float32")
    scale = 0.25
    got, m, l = split_k_model(*(torch.from_numpy(x) for x in
                                (q, kp, vp, tables, lens)), scale)
    assert m.shape[1] == 10 and (l[:, 1:] == 0).all()
    assert torch.isfinite(got).all()
    want = np.asarray(jpa.paged_attention_reference(q, kp, vp, tables, lens,
                                                    scale))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
