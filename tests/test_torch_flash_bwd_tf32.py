"""A CPU model of the float32 flash backward kernels, held to the reference.

The float32 dq and dk/dv kernels (``csrc/flash_attention_bwd.cu``,
``flash_dq_tf32x3_kernel`` and ``flash_dkv_tf32x3_kernel``) run on the
tensor cores in split precision (3xTF32): every operand ``x`` becomes
``hi = rna_tf32(x)`` and ``lo = rna_tf32(x - hi)``, and a product is
``a_hi·b_hi + a_hi·b_lo + a_lo·b_hi`` accumulated in float32.
:func:`bwd_model` repeats that arithmetic (rounding through
``.view(torch.int32)``, the kernels' own bit manipulation) with their
tiling: dq over key tiles, dk/dv over query tiles, of 32 rows (16 at head
dim 128).  It is held to the reference's interpret-mode ``_bwd`` within
the card's 1e-4 for dq, dk, dv and ``d_bias``; with dropout (the TPU's
keep bits cannot be drawn off the TPU) to the port's plain backward on
the port's keep mask.  A one-pass TF32 model fails that tolerance, so the
test tells the two apart, and at large scores the model stays within the
bounds of its arithmetic against float64.

Inputs are made with numpy from a seed.  The kernels themselves are
checked against their plain versions on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_mx.kernels import flash_attention as jfa

from tpu_mx_torch.kernels import flash_attention as fa

TOL = 1e-4           # the card's kernel-vs-plain tolerance, float32


def tile_rows(d):
    """Rows of a streamed tile (``tf_tile<D>`` in the kernels)."""
    return 16 if d >= 128 else 32


def tf32_rna(x):
    """``x`` rounded to TF32 (10 mantissa bits), to nearest with ties away
    from zero: the low 13 bits of the bit pattern rounded on the
    magnitude, as the kernels do it."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def mm_3xtf32(a, b):
    """``a @ b`` as the kernels' three TF32 products, float32 sums."""
    ah = tf32_rna(a)
    al = tf32_rna(a - ah)
    bh = tf32_rna(b)
    bl = tf32_rna(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def mm_1xtf32(a, b):
    """One TF32 pass: what the float32 gates forbid."""
    return tf32_rna(a) @ tf32_rna(b)


def _masks(bh, q_idx, k_idx, causal, valid, rate, seed):
    """(score mask, keep mask or None) over query indices ``q_idx`` and
    key indices ``k_idx`` (1-d int64 tensors)."""
    qi, ki = q_idx.reshape(1, -1, 1), k_idx.reshape(1, 1, -1)
    ok = ki < valid.reshape(bh, 1, 1)
    if causal:
        ok = ok & (ki <= qi)
    keep = None if rate == 0.0 else fa.dropout_keep_mask(
        seed, torch.arange(bh).reshape(bh, 1, 1), qi, ki, rate)
    return ok.expand(bh, len(q_idx), len(k_idx)), keep


def bwd_model(q, k, v, do, lse, delta, scale, causal=False, kv_valid=None,
              rate=0.0, seed=None, bias=None, mm=mm_3xtf32):
    """The float32 backward kernels' arithmetic: ``(dq, dk, dv, d_bias)``
    of ``(BH, T, D)`` float32 inputs with the caller's ``lse`` and
    ``delta`` (``(BH, T)``), products by ``mm``.  dq runs over key tiles
    (``P = exp(s·scale + bias − lse)``, ``d_bias = P∘(z/(1−r)·dP − δ)``,
    ``dQ += (d_bias·scale)·K``), dk/dv over query tiles of the transposed
    scores (``dV += (z/(1−r)·P)ᵀ·dO``, ``dK += dSᵀ·Q``), each tile's
    products accumulated into float32 sums."""
    bh, t, d = q.shape
    tk = k.shape[1]
    tile = tile_rows(d)
    valid = torch.full((bh,), tk) if kv_valid is None \
        else torch.as_tensor(kv_valid).long().clamp(0, tk)
    inv = 1.0 / (1.0 - rate) if rate > 0.0 else 1.0
    lse3, delta3 = lse[..., None], delta[..., None]
    qs = torch.arange(t)

    dq = torch.zeros((bh, t, d))
    d_bias = torch.zeros((bh, t, tk))
    for k0 in range(0, tk, tile):
        ks = torch.arange(k0, min(k0 + tile, tk))
        ok, keep = _masks(bh, qs, ks, causal, valid, rate, seed)
        x = mm(q, k[:, ks].transpose(1, 2)) * scale
        if bias is not None:
            x = x + bias[:, :, ks]
        p = torch.where(ok, torch.exp(x - lse3), 0.0)
        g = mm(do, v[:, ks].transpose(1, 2))
        if keep is not None:
            g = torch.where(keep, g * inv, 0.0)
        db = p * (g - delta3)
        d_bias[:, :, ks] = db
        dq = dq + mm(db * scale, k[:, ks])

    dk = torch.zeros((bh, tk, d))
    dv = torch.zeros((bh, tk, d))
    ks = torch.arange(tk)
    for q0 in range(0, t, tile):
        rows = torch.arange(q0, min(q0 + tile, t))
        ok, keep = _masks(bh, rows, ks, causal, valid, rate, seed)
        st = mm(k, q[:, rows].transpose(1, 2)).transpose(1, 2) * scale
        if bias is not None:
            st = st + bias[:, rows]
        p = torch.where(ok, torch.exp(st - lse3[:, rows]), 0.0)
        g = mm(v, do[:, rows].transpose(1, 2)).transpose(1, 2)
        pd = p
        if keep is not None:
            pd = torch.where(keep, p * inv, 0.0)
            g = torch.where(keep, g * inv, 0.0)
        ds = p * (g - delta3[:, rows]) * scale
        dv = dv + mm(pd.transpose(1, 2), do[:, rows])
        dk = dk + mm(ds.transpose(1, 2), q[:, rows])
    return dq, dk, dv, d_bias


def _case(seed, t, d, kv, biased):
    rng = np.random.RandomState(seed)
    bh = 3
    q, k, v, do = (rng.randn(bh, t, d).astype(np.float32) for _ in range(4))
    valid = np.array([t, max(1, t // 3), max(1, t - 5)], np.int32) \
        if kv else None
    bias = rng.randn(bh, t, t).astype(np.float32) if biased else None
    return q, k, v, do, valid, bias


def _reference(q, k, v, do, valid, bias, scale, causal):
    """The reference's interpret-mode forward and backward kernels, one
    block of T rows and keys (their blocks must tile T exactly): ``(lse,
    delta, (dq, dk, dv, d_bias))``, delta = rowsum(dO·out) as ``_bwd``
    computes it."""
    t = q.shape[1]
    j = lambda x: None if x is None else jnp.asarray(x)
    out, lse = jfa._fwd(j(q), j(k), j(v), j(valid), None, j(bias), scale,
                        causal, 0.0, t, t)
    grads = jfa._bwd(scale, causal, 0.0, t, t,
                     (j(q), j(k), j(v), j(valid), None, j(bias), out, lse),
                     j(do))
    delta = (np.asarray(do, np.float32) * np.asarray(out)).sum(-1)
    return (np.asarray(lse)[..., 0], delta,
            [None if g is None else np.asarray(g)
             for g in (grads[0], grads[1], grads[2], grads[5])])


def _torch(*xs):
    return [None if x is None else torch.from_numpy(np.array(x))
            for x in xs]


@pytest.mark.parametrize("biased", [False, True], ids=["no-bias", "bias"])
@pytest.mark.parametrize("kv", [False, True], ids=["all-keys", "kv_valid"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("t,d", [(37, 16), (96, 64), (160, 128)])
def test_3xtf32_backward_model_matches_the_reference_kernels(t, d, causal,
                                                              kv, biased):
    """dq, dk, dv (and d_bias) of the model against the reference's
    interpret-mode ``_bwd`` on the same lse and delta, within 1e-4."""
    q, k, v, do, valid, bias = _case(t + d + 7 * causal + 3 * kv, t, d, kv,
                                     biased)
    scale = d ** -0.5
    lse, delta, want = _reference(q, k, v, do, valid, bias, scale, causal)
    got = bwd_model(*_torch(q, k, v, do, lse, delta), scale, causal,
                    None if valid is None else torch.from_numpy(valid),
                    bias=None if bias is None else torch.from_numpy(bias))
    for name, g, w in zip(("dq", "dk", "dv", "d_bias"), got, want):
        if w is None:
            continue
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=TOL,
                                   err_msg=name)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("t,d", [(37, 16), (96, 64), (160, 128)])
def test_3xtf32_backward_model_with_dropout_matches_plain(t, d, causal):
    """Dropout 0.1 with the port's keep mask (the reference's TPU mask
    cannot be drawn off the TPU), and a bias: the model against the
    port's float32 plain backward on the same mask, lse and delta."""
    q, k, v, do, valid, bias = _case(t * d + causal, t, d, True, True)
    q, k, v, do, kv, bias = _torch(q, k, v, do, valid, bias)
    scale, rate = d ** -0.5, 0.1
    seed = torch.tensor([t + d], dtype=torch.int32)
    out, lse = fa.flash_attention_plain(q, k, v, scale, causal, kv, rate,
                                        seed, bias)
    delta = fa.flash_attention_delta(do, out)
    want = fa.flash_attention_bwd_plain(q, k, v, do, lse, delta, scale,
                                        causal, kv, rate, seed, bias)
    got = bwd_model(q, k, v, do, lse, delta, scale, causal, kv, rate, seed,
                    bias)
    for name, g, w in zip(("dq", "dk", "dv", "d_bias"), got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=TOL, msg=name)


def test_one_tf32_pass_fails_the_backward_tolerance():
    """The tolerance tells the designs apart: a single TF32 pass misses
    the reference's dq, dk and dv by more than 1e-4 where 3xTF32 stays
    inside."""
    t, d = 160, 128
    q, k, v, do, _, _ = _case(5, t, d, False, False)
    scale = d ** -0.5
    lse, delta, want = _reference(q, k, v, do, None, None, scale, True)
    errs = {}
    for name, mm in (("3x", mm_3xtf32), ("1x", mm_1xtf32)):
        got = bwd_model(*_torch(q, k, v, do, lse, delta), scale, True, mm=mm)
        errs[name] = [float(np.abs(g.numpy() - w).max())
                      for g, w in zip(got[:3], want[:3])]
    assert max(errs["3x"]) <= TOL < min(errs["1x"]), errs


def test_3xtf32_backward_model_at_large_scores_holds_to_float64():
    """Large scores (|q.k| up to ~400 at scale 1) magnify the rounding of
    the operands: the model stays within the bounds of its arithmetic
    (``fa.f32_bwd_error_bounds``, which the card's kernels are held to)
    of float64 everywhere, and one TF32 pass is at least 50 times further
    off."""
    rng = np.random.RandomState(9)
    q, k = (torch.from_numpy(rng.randn(2, 96, 128).astype(np.float32) * 3)
            for _ in range(2))
    v, do = (torch.from_numpy(rng.randn(2, 96, 128).astype(np.float32))
             for _ in range(2))
    exact, bounds, lse, delta = fa.f32_bwd_error_bounds(q, k, v, do)
    lse, delta = lse.float(), delta.float()
    for mm in (mm_3xtf32, mm_1xtf32):
        got = bwd_model(q, k, v, do, lse, delta, 1.0, mm=mm)[:3]
        errs = [(g.double() - e).abs() for g, e in zip(got, exact)]
        if mm is mm_3xtf32:
            worst = [float(e.max()) for e in errs]
            for name, e, b in zip(("dq", "dk", "dv"), errs, bounds):
                assert bool((e <= b).all()), (name, float((e - b).max()))
        else:
            for name, e, w in zip(("dq", "dk", "dv"), errs, worst):
                assert float(e.max()) >= 50 * w, (name, float(e.max()), w)


def test_tf32_rounding_is_nearest_ties_away():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11,
                      -(1.0 + 2 ** -11), 1.0 + 2 ** -12])
    want = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 * 2 ** -10,
                         -(1.0 + 2 ** -10), 1.0])
    assert torch.equal(tf32_rna(x), want)


def test_3xtf32_backward_model_is_the_plain_backward_on_exact_inputs():
    """On TF32-exact inputs with power-of-two sums the split products are
    exact, so the model and the float32 plain backward agree to float32
    rounding of the elementwise steps alone."""
    rng = np.random.RandomState(3)
    q, k, v, do = (torch.from_numpy(rng.randint(-4, 5, (2, 40, 16))
                                    .astype(np.float32) / 4)
                   for _ in range(4))
    out, lse = fa.flash_attention_plain(q, k, v, 0.25, causal=True)
    delta = fa.flash_attention_delta(do, out)
    want = fa.flash_attention_bwd_plain(q, k, v, do, lse, delta, 0.25,
                                        causal=True)
    got = bwd_model(q, k, v, do, lse, delta, 0.25, causal=True)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6)
