"""The PyTorch/CUDA port's kernel twins against the JAX reference kernels.

Inputs are made with numpy from a seed and fed to both packages.  On the
CPU each port wrapper runs its plain PyTorch version; the JAX side runs
its Pallas kernels in interpret mode (as tests/test_kernels.py does) and
its XLA/dense references.  The CUDA kernels themselves are checked on
the card by tests/test_torch_cuda.py and chip_smoke.py.
"""
import importlib
import math

import numpy as np
import pytest
import torch

from tpu_mx.kernels import flash_attention as jfa
from tpu_mx.kernels import paged_attention as jpa
from tpu_mx.serving.attention import dense_attention as j_dense

from tpu_mx_torch.base import MXNetError
from tpu_mx_torch.kernels import flash_attention as fa
from tpu_mx_torch.kernels import paged_attention as pa
from tpu_mx_torch.serving.attention import dense_attention

# float32 on both sides, different summation order (the JAX kernel
# test's own tolerance, tests/test_kernels.py)
F32_TOL = 2e-5


def _paged_case(seed=0, nblocks=24, bs=4, h=2, d=8, tq=1,
                specs=((10, (7, 2, 9)), (3, (5,)), (16, (11, 1, 4, 8)))):
    """Fragmented tables, ragged lengths, rows 0-padded to a shared NB."""
    rng = np.random.RandomState(seed)
    kp = rng.randn(nblocks, bs, h, d).astype(np.float32)
    vp = rng.randn(nblocks, bs, h, d).astype(np.float32)
    b = len(specs)
    nb = max(len(t) for _, t in specs)
    tables = np.zeros((b, nb), np.int32)
    lens = np.zeros(b, np.int32)
    for i, (length, tab) in enumerate(specs):
        tables[i, :len(tab)] = tab
        lens[i] = length
    q = rng.randn(b, tq, h, d).astype(np.float32)
    return q, kp, vp, tables, lens


def _port_paged(q, kp, vp, tables, lens, pool_dtype=torch.float32):
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x))
    out = pa.paged_attention(t(q), t(kp).to(pool_dtype),
                             t(vp).to(pool_dtype), t(tables), t(lens),
                             device="cpu")
    return out.numpy()


@pytest.mark.parametrize("tq", [1, 3])
@pytest.mark.parametrize("arm", ["kernel", "xla"])
def test_paged_plain_matches_jax(tq, arm):
    q, kp, vp, tables, lens = _paged_case(tq=tq)
    fn = jpa.paged_attention if arm == "kernel" \
        else jpa.paged_attention_reference
    ref = np.asarray(fn(q, kp, vp, tables, lens))
    got = _port_paged(q, kp, vp, tables, lens)
    assert got.shape == q.shape
    np.testing.assert_allclose(got, ref, rtol=F32_TOL, atol=F32_TOL)


def test_paged_window_of_four_matches_jax_reference():
    """Tq = 4 (the min length of the case is raised to 4)."""
    q, kp, vp, tables, lens = _paged_case(
        tq=4, specs=((10, (7, 2, 9)), (4, (5,)), (16, (11, 1, 4, 8))))
    ref = np.asarray(jpa.paged_attention_reference(q, kp, vp, tables, lens))
    got = _port_paged(q, kp, vp, tables, lens)
    np.testing.assert_allclose(got, ref, rtol=F32_TOL, atol=F32_TOL)


def test_paged_three_d_query_is_the_single_token_window():
    q, kp, vp, tables, lens = _paged_case()
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x))
    out3 = pa.paged_attention(t(q[:, 0]), t(kp), t(vp), t(tables), t(lens))
    out4 = pa.paged_attention(t(q), t(kp), t(vp), t(tables), t(lens))
    assert out3.shape == (q.shape[0],) + q.shape[2:]
    assert torch.equal(out3, out4[:, 0])
    ref = np.asarray(jpa.paged_attention(q[:, 0], kp, vp, tables, lens))
    np.testing.assert_allclose(out3.numpy(), ref, rtol=F32_TOL,
                               atol=F32_TOL)


def test_paged_padding_blocks_cannot_leak():
    """Table entries past a row's real blocks (0-padding) and slots past
    its length must be exactly invisible: poisoning them moves no bit."""
    q, kp, vp, tables, lens = _paged_case()
    base = _port_paged(q, kp, vp, tables, lens)
    kp2, vp2 = kp.copy(), vp.copy()
    kp2[0] = 1e9          # block 0 backs every padded table entry
    vp2[0] = -1e9
    kp2[9, 2:] = 1e9      # row 0: length 10 ends 2 slots into block 9
    vp2[9, 2:] = -1e9
    kp2[5, 3:] = 1e9      # row 1: length 3 ends inside block 5
    vp2[5, 3:] = -1e9
    again = _port_paged(q, kp2, vp2, tables, lens)
    np.testing.assert_array_equal(base, again)
    ref = np.asarray(jpa.paged_attention(q, kp2, vp2, tables, lens))
    np.testing.assert_allclose(again, ref, rtol=F32_TOL, atol=F32_TOL)


def test_paged_bf16_pool():
    """Both packages round the pool to bfloat16 and upcast it to float32
    for the math, so they agree at the float32 tolerance; against the
    float32 pool the bf16 rounding (8 mantissa bits) moves outputs of
    unit scale by up to ~1e-2."""
    import jax.numpy as jnp
    q, kp, vp, tables, lens = _paged_case()
    got = _port_paged(q, kp, vp, tables, lens, pool_dtype=torch.bfloat16)
    ref = np.asarray(jpa.paged_attention(
        q, jnp.asarray(kp, jnp.bfloat16), jnp.asarray(vp, jnp.bfloat16),
        tables, lens))
    np.testing.assert_allclose(got, ref, rtol=F32_TOL, atol=F32_TOL)
    f32 = _port_paged(q, kp, vp, tables, lens)
    np.testing.assert_allclose(got, f32, rtol=2e-2, atol=2e-2)


def test_paged_rejects_mismatched_operands():
    q, kp, vp, tables, lens = _paged_case()
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x))
    with pytest.raises(ValueError, match="pools"):
        pa.paged_attention(t(q), t(kp), t(vp[:, :2]), t(tables), t(lens))
    with pytest.raises(ValueError, match="lengths"):
        pa.paged_attention(t(q), t(kp), t(vp), t(tables), t(lens[:2]))
    with pytest.raises(ValueError, match="q must be"):
        pa.paged_attention(t(q[0, 0]), t(kp), t(vp), t(tables), t(lens))


def _qkv(seed, bh, t, d, tk=None):
    rng = np.random.RandomState(seed)
    tk = t if tk is None else tk
    return (rng.randn(bh, t, d).astype(np.float32),
            rng.randn(bh, tk, d).astype(np.float32),
            rng.randn(bh, tk, d).astype(np.float32))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("t", [128, 256])
def test_flash_plain_matches_jax_flash(t, causal):
    q, k, v = _qkv(t, 2, t, 16)
    ref = np.asarray(jfa.flash_attention(q, k, v, causal=causal))
    out, lse = fa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), causal=causal,
                                  return_lse=True)
    np.testing.assert_allclose(out.numpy(), ref, rtol=F32_TOL, atol=F32_TOL)
    # lse: the log of the softmax denominator, checked in float64
    s = np.einsum("btd,bkd->btk", q.astype(np.float64), k) / math.sqrt(16)
    if causal:
        s = np.where(np.tril(np.ones((t, t), bool)), s, -np.inf)
    m = s.max(-1, keepdims=True)
    want = (m + np.log(np.exp(s - m).sum(-1, keepdims=True)))[..., 0]
    np.testing.assert_allclose(lse.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("t", [37, 100])
def test_flash_plain_matches_jax_dense_at_ragged_t(t):
    """T that the TPU kernel's T % 128 gate refuses: held to the
    reference's dense serving attention (B=1, heads on the H axis)."""
    h, d = 3, 16
    q, k, v = _qkv(t, h, t, d)
    ref = np.asarray(j_dense(q.transpose(1, 0, 2)[None],
                             k.transpose(1, 0, 2)[None],
                             v.transpose(1, 0, 2)[None], causal=True))[0]
    out = fa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), causal=True)
    np.testing.assert_allclose(out.numpy().transpose(1, 0, 2), ref,
                               rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_port_dense_attention_matches_jax(causal):
    rng = np.random.RandomState(5)
    q = rng.randn(3, 4, 2, 8).astype(np.float32)
    k = rng.randn(3, 9, 2, 8).astype(np.float32)
    v = rng.randn(3, 9, 2, 8).astype(np.float32)
    lens = np.array([9, 5, 4], np.int32)
    ref = np.asarray(j_dense(q, k, v, lengths=lens, causal=causal))
    got = dense_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), lengths=lens, causal=causal)
    np.testing.assert_allclose(got.numpy(), ref, rtol=F32_TOL, atol=F32_TOL)


def test_wrappers_without_a_card_raise_instead_of_falling_back():
    """``device="cuda"`` (the default for host data) with no card is an
    MXNetError, never a silent run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the kernels run there")
    q, kp, vp, tables, lens = _paged_case()
    with pytest.raises(MXNetError, match="no CUDA device"):
        pa.paged_attention(q, kp, vp, tables, lens)
    qq, kk, vv = _qkv(0, 2, 32, 16)
    with pytest.raises(MXNetError, match="no CUDA device"):
        fa.flash_attention(qq, kk, vv)
    assert pa.paged_attention.launches == 0
    assert fa.flash_attention.launches == 0


def test_cpu_tensors_never_count_as_kernel_launches():
    before = (pa.paged_attention.launches, fa.flash_attention.launches)
    _port_paged(*_paged_case())
    q, k, v = _qkv(1, 2, 64, 16)
    fa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                       torch.from_numpy(v), causal=True)
    assert (pa.paged_attention.launches,
            fa.flash_attention.launches) == before


# ----------------------------------------------------------------------------
# the flash kernels' training options: kv_valid, the backward, dropout
# ----------------------------------------------------------------------------
def _valid(seed, bh, t):
    return np.random.RandomState(seed).randint(1, t + 1, bh).astype(np.int32)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("t", [128, 256])
def test_flash_plain_with_kv_valid_matches_jax_flash(t, causal):
    q, k, v = _qkv(t + 1, 3, t, 64)
    valid = _valid(t, 3, t)
    ref = np.asarray(jfa.flash_attention(q, k, v, causal=causal,
                                         kv_valid=valid))
    out = fa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), causal=causal,
                             kv_valid=torch.from_numpy(valid))
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=F32_TOL,
                               atol=F32_TOL)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("t", [128, 256])
def test_flash_plain_backward_matches_jax_vjp(t, causal):
    """dq, dk, dv of the port's plain backward (the flash formulas from
    the saved lse) against ``jax.vjp`` of the interpret-mode kernels."""
    import jax
    q, k, v = _qkv(t + 2, 3, t, 64)
    do = np.random.RandomState(t).randn(3, t, 64).astype(np.float32)
    valid = _valid(t + 3, 3, t)
    _, vjp = jax.vjp(lambda a, b, c: jfa.flash_attention(
        a, b, c, causal=causal, kv_valid=valid), q, k, v)
    want = [np.asarray(g) for g in vjp(do)]
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    kv = torch.from_numpy(valid)
    out, lse = fa.flash_attention_plain(tq, tk, tv, 0.125, causal, kv)
    tdo = torch.from_numpy(do)
    got = fa.flash_attention_bwd_plain(tq, tk, tv, tdo, lse,
                                       fa.flash_attention_delta(tdo, out),
                                       0.125, causal, kv)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-4)


def _dense_with_mask(q, k, v, scale, valid, keep, rate):
    """softmax attention with the key-padding mask, then inverted dropout
    with a materialized keep mask: the function autograd differentiates."""
    t, tk = q.shape[1], k.shape[1]
    ok = torch.arange(tk)[None, None, :] < valid.long()[:, None, None]
    s = (q @ k.transpose(1, 2) * scale).masked_fill(~ok, -1e30)
    p = torch.softmax(s, dim=-1)
    p = torch.where(keep, p / (1 - rate), 0.0)
    return p @ v


def _keep(seed, bh, t, tk, rate):
    return fa.dropout_keep_mask(seed, torch.arange(bh).reshape(bh, 1, 1),
                                torch.arange(t).reshape(1, t, 1),
                                torch.arange(tk).reshape(1, 1, tk), rate)


def test_flash_dropout_backward_is_autograd_of_the_dense_formula():
    """With a fixed seed, the plain forward and backward equal the dense
    formula and its torch.autograd gradients under the same mask."""
    bh, t, d, rate = 3, 96, 32, 0.2
    q, k, v = (torch.from_numpy(x).double() for x in _qkv(11, bh, t, d))
    do = torch.from_numpy(np.random.RandomState(12).randn(bh, t, d))
    valid = torch.tensor([96, 40, 65], dtype=torch.int32)
    seed = torch.tensor([-123456], dtype=torch.int32)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    ref = _dense_with_mask(*leaves, d ** -0.5, valid,
                           _keep(seed, bh, t, t, rate), rate)
    ref.backward(do)
    out, lse = fa.flash_attention_plain(q, k, v, d ** -0.5, False, valid,
                                        rate, seed)
    got = fa.flash_attention_bwd_plain(q, k, v, do, lse,
                                       fa.flash_attention_delta(do, out),
                                       d ** -0.5, False, valid, rate, seed)
    # float32 math in the plain versions, float64 in the oracle
    np.testing.assert_allclose(out.numpy(), ref.detach().numpy(),
                               rtol=1e-5, atol=1e-5)
    for g, leaf in zip(got, leaves):
        np.testing.assert_allclose(g.numpy(), leaf.grad.numpy(), rtol=1e-5,
                                   atol=1e-5)


def test_flash_dropout_mask_does_not_depend_on_the_tiling():
    bh, t, d, rate = 2, 200, 16, 0.3
    q, k, v = (torch.from_numpy(x) for x in _qkv(13, bh, t, d))
    do = torch.from_numpy(np.random.RandomState(14).randn(bh, t, d)
                          .astype(np.float32))
    seed = torch.tensor([99], dtype=torch.int32)
    runs = []
    for block_q in (7, 64, 200):
        out, lse = fa.flash_attention_plain(q, k, v, 0.25, True, None, rate,
                                            seed, block_q=block_q)
        grads = fa.flash_attention_bwd_plain(
            q, k, v, do, lse, fa.flash_attention_delta(do, out), 0.25, True,
            None, rate, seed, block_q=block_q)
        runs.append((out, lse) + grads)
    for other in runs[1:]:
        for a, b in zip(runs[0], other):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    # the mask of a block of rows is the same bits as those rows of the
    # whole mask
    whole = _keep(seed, bh, t, t, rate)
    rows = fa.dropout_keep_mask(seed, torch.arange(bh).reshape(bh, 1, 1),
                                torch.arange(50, 57).reshape(1, 7, 1),
                                torch.arange(t).reshape(1, 1, t), rate)
    assert torch.equal(rows, whole[:, 50:57])


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_flash_dropout_keep_rate(rate):
    keep = _keep(torch.tensor([7], dtype=torch.int32), 16, 256, 256, rate)
    assert abs(keep.float().mean().item() - (1 - rate)) < 0.01


def test_flash_dropout_mask_hash_matches_its_word_arithmetic():
    """The int64 tensor arithmetic equals the 32-bit formula computed with
    Python integers (the kernels' uint32 arithmetic)."""
    m = 0xFFFFFFFF

    def fmix(h):
        h ^= h >> 16
        h = (h * 0x85EBCA6B) & m
        h ^= h >> 13
        h = (h * 0xC2B2AE35) & m
        return h ^ (h >> 16)

    seed, rate = -5, 0.25
    for bh, qi, ki in ((0, 0, 0), (383, 511, 511), (7, 3, 100000),
                       (65535, 70000, 9)):
        row = fmix((seed & m) ^ fmix((bh + 0x9E3779B9) & m))
        qkey = fmix(row ^ ((qi * 0x85EBCA77) & m))
        bits = fmix(qkey ^ ((ki * 0xC2B2AE3D) & m))
        got = fa.dropout_keep_mask(torch.tensor([seed], dtype=torch.int32),
                                   torch.tensor(bh), torch.tensor(qi),
                                   torch.tensor(ki), rate)
        assert bool(got) == (bits >= int(rate * 2 ** 32))


def test_flash_autograd_function_on_the_cpu_runs_the_plain_backward():
    bh, t, d = 2, 70, 16
    q, k, v = (torch.from_numpy(x) for x in _qkv(15, bh, t, d))
    do = torch.from_numpy(np.random.RandomState(16).randn(bh, t, d)
                          .astype(np.float32))
    valid = torch.tensor([70, 33], dtype=torch.int32)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    before = (fa.flash_attention_bwd_dq.launches,
              fa.flash_attention_bwd_dkv.launches)
    out = fa.flash_attention(*leaves, kv_valid=valid, dropout_rate=0.1,
                             dropout_seed=5)
    out.backward(do)
    seed = torch.tensor([5], dtype=torch.int32)
    ref, lse = fa.flash_attention_plain(q, k, v, 0.25, False, valid, 0.1,
                                        seed)
    want = fa.flash_attention_bwd_plain(q, k, v, do, lse,
                                        fa.flash_attention_delta(do, ref),
                                        0.25, False, valid, 0.1, seed)
    assert torch.equal(out.detach(), ref)
    for leaf, w in zip(leaves, want):
        assert torch.equal(leaf.grad, w)
    assert (fa.flash_attention_bwd_dq.launches,
            fa.flash_attention_bwd_dkv.launches) == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_tensors_never_count_a_kernel_route(dtype):
    """The plain backward, in either type, with and without ``d_bias``,
    counts no launch and no route of the dq (or dk/dv) kernel: routes are
    what a C entry point reports, and CPU tensors reach none."""
    bh, t, d = 2, 40, 16
    q, k, v, do = (torch.from_numpy(x).to(dtype)
                   for x in _qkv(17, bh, t, d) + (
                       np.random.RandomState(18).randn(bh, t, d)
                       .astype(np.float32),))
    bias = torch.from_numpy(np.random.RandomState(19).randn(1, t, t)
                            .astype(np.float32))
    wrappers = (fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv)
    before = [(w.launches, dict(w.routes)) for w in wrappers]
    out, lse = fa.flash_attention_plain(q, k, v, 0.25, bias=bias)
    args = (q, k, v, do, lse, fa.flash_attention_delta(do, out), 0.25)
    dq = fa.flash_attention_bwd_dq(*args)
    dq_b, d_bias = fa.flash_attention_bwd_dq(*args, bias=bias,
                                             want_d_bias=True)
    fa.flash_attention_bwd_dkv(*args)
    assert dq.dtype == dq_b.dtype == dtype and d_bias.shape == (bh, t, t)
    assert [(w.launches, w.routes) for w in wrappers] == before


def test_flash_rejects_bad_dropout_arguments():
    q, k, v = (torch.from_numpy(x) for x in _qkv(17, 1, 8, 16))
    with pytest.raises(ValueError, match="dropout_rate"):
        fa.flash_attention(q, k, v, dropout_rate=1.0, dropout_seed=1)
    with pytest.raises(ValueError, match="dropout_seed"):
        fa.flash_attention(q, k, v, dropout_rate=0.1)


@pytest.mark.parametrize("causal", [False, True])
def test_mha_flash_matches_jax_mha_with_valid_length(causal):
    rng = np.random.RandomState(18)
    q, k, v = (rng.randn(2, 3, 128, 64).astype(np.float32) for _ in range(3))
    vl = np.array([128, 50], np.int32)
    ref = np.asarray(jfa.mha_flash_attention(q, k, v, causal=causal,
                                             valid_length=vl))
    got = fa.mha_flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), causal=causal,
                                 valid_length=torch.from_numpy(vl))
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=F32_TOL,
                               atol=F32_TOL)


def test_cpu_attention_arm_is_the_kernels_function():
    """``parallel.attention`` on the CPU (the dense arm, autograd) and the
    flash plain versions (explicit backward) compute the same function,
    dropout mask included — so a model trained on the CPU and on the card
    sees the same masks."""
    from tpu_mx_torch.parallel import ring_attention as ra
    rng = np.random.RandomState(19)
    q, k, v = (torch.from_numpy(rng.randn(2, 2, 40, 16).astype(np.float32))
               for _ in range(3))
    do = torch.from_numpy(rng.randn(2, 2, 40, 16).astype(np.float32))
    vl = torch.tensor([40, 23], dtype=torch.int32)
    seed = torch.tensor([77], dtype=torch.int32)
    grads = []
    for fn in (ra.attention, fa.mha_flash_attention):
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        out = fn(*leaves, valid_length=vl, dropout_rate=0.1,
                 dropout_seed=seed)
        out.backward(do)
        grads.append([out.detach()] + [x.grad for x in leaves])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


class _SpMesh:
    axis_names = ("dp", "sp")
    shape = {"dp": 1, "sp": 2}


def test_attention_refuses_what_is_not_ported():
    """Sequence parallelism over an ``sp`` mesh axis still raises; the
    additive bias, once refused here, is now taken (a zero bias changes
    nothing)."""
    from tpu_mx_torch.parallel import attention
    q = torch.from_numpy(np.random.RandomState(20).randn(1, 1, 8, 16)
                         .astype(np.float32))
    with pytest.raises(MXNetError, match="A16"):
        attention(q, q, q, mesh=_SpMesh())
    for strategy in ("ring", "ulysses"):
        with pytest.raises(MXNetError, match="A16"):
            attention(q, q, q, mesh=_SpMesh(), sp_strategy=strategy)
    out = attention(q, q, q, bias=torch.zeros((1, 1, 8, 8)))
    assert torch.equal(out, attention(q, q, q))


def test_attention_checks_sp_strategy_on_every_call():
    """An unknown ``sp_strategy`` is a ValueError with no mesh at all, as
    in the reference; the known ones take the local path."""
    import jax.numpy as jnp
    jra = importlib.import_module("tpu_mx.parallel.ring_attention")
    from tpu_mx_torch.parallel import attention
    q = np.random.RandomState(21).randn(1, 2, 8, 16).astype(np.float32)
    tq = torch.from_numpy(q)
    with pytest.raises(ValueError, match="sp_strategy"):
        attention(tq, tq, tq, sp_strategy="rnig")
    with pytest.raises(ValueError, match="sp_strategy"):
        jra.attention(jnp.asarray(q), jnp.asarray(q), jnp.asarray(q),
                      sp_strategy="rnig")
    for strategy in (None, "ring", "ulysses"):
        assert torch.equal(attention(tq, tq, tq, sp_strategy=strategy),
                           attention(tq, tq, tq))


# ----------------------------------------------------------------------------
# the additive bias and its gradient d_bias
# ----------------------------------------------------------------------------
BIAS_B, BIAS_H, BIAS_T, BIAS_D = 2, 2, 128, 32
BIAS_SHAPES = [(BIAS_B, BIAS_H, BIAS_T, BIAS_T),   # one plane per row
               (1, BIAS_H, BIAS_T, BIAS_T),        # per head: bias_groups=H
               (1, 1, BIAS_T, BIAS_T),             # one shared plane
               (1, BIAS_H, 1, BIAS_T)]             # ALiBi: expanded
BIAS_VALID = np.array([BIAS_T, 77], np.int32)


def _bias_case(seed, bias_shape):
    rng = np.random.RandomState(seed)
    q, k, v, do = (rng.randn(BIAS_B, BIAS_H, BIAS_T, BIAS_D)
                   .astype(np.float32) for _ in range(4))
    return q, k, v, do, rng.randn(*bias_shape).astype(np.float32)


def _jax_mha_vjp(q, k, v, do, bias, causal, valid):
    """The reference's interpret-mode kernels and ``jax.vjp`` of them."""
    import jax
    f = lambda a, b, c, e: jfa.mha_flash_attention(
        a, b, c, causal=causal, valid_length=valid, bias=e, block_q=64,
        block_k=64)
    out, vjp = jax.vjp(f, q, k, v, bias)
    return np.asarray(out), [np.asarray(g) for g in vjp(do)]


def _port_mha_grads(fn, q, k, v, do, bias, causal, valid, **kw):
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v, bias)]
    out = fn(*leaves[:3], causal=causal, bias=leaves[3],
             valid_length=None if valid is None else torch.from_numpy(valid),
             **kw)
    out.backward(torch.from_numpy(do))
    return out.detach().numpy(), [x.grad.numpy() for x in leaves]


def _assert_bias_parity(got, want):
    """The reference's own tolerances (tests/test_kernels.py)."""
    (out, grads), (ref, ref_grads) = got, want
    np.testing.assert_allclose(out, ref, rtol=2e-4, atol=2e-5)
    for g, w, name in zip(grads, ref_grads, ("q", "k", "v", "bias")):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, rtol=3e-4, atol=3e-5,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("causal,valid", [(False, None), (False, BIAS_VALID),
                                          (True, BIAS_VALID)],
                         ids=["plain", "valid", "causal-valid"])
@pytest.mark.parametrize("bias_shape", BIAS_SHAPES,
                         ids=["per-row", "per-head", "shared", "alibi"])
def test_flash_bias_forward_and_gradients_match_jax(bias_shape, causal,
                                                    valid):
    """Forward, dq, dk, dv and d_bias of the port's plain bias path
    (autograd through ``FlashAttentionFunction``) against the reference's
    interpret-mode kernels, on the same numpy inputs."""
    q, k, v, do, bias = _bias_case(len(bias_shape) + bias_shape[0]
                                   + bias_shape[2], bias_shape)
    want = _jax_mha_vjp(q, k, v, do, bias, causal, valid)
    got = _port_mha_grads(fa.mha_flash_attention, q, k, v, do, bias, causal,
                          valid)
    _assert_bias_parity(got, want)


def test_flash_bias_with_minus_inf_entries_and_rows():
    """-inf bias entries get probability 0; a row whose bias is -inf
    everywhere gets out = 0 and zero gradients — as in the reference."""
    q, k, v, do, bias = _bias_case(22, (1, BIAS_H, BIAS_T, BIAS_T))
    bias[0, 0, :, ::3] = -np.inf
    bias[0, 1, 5] = -np.inf
    want = _jax_mha_vjp(q, k, v, do, bias, False, None)
    got = _port_mha_grads(fa.mha_flash_attention, q, k, v, do, bias, False,
                          None)
    _assert_bias_parity(got, want)
    out, (dq, _, _, db) = got
    assert np.all(out[:, 1, 5] == 0) and np.all(dq[:, 1, 5] == 0)
    assert np.all(db[0, 0, :, ::3] == 0) and np.all(db[0, 1, 5] == 0)
    assert all(np.isfinite(g).all() for g in got[1])


def test_flash_bias_groups_match_jax():
    """``(G, T, Tk)`` with ``bias_groups=G``: row ``bh`` reads plane
    ``bh % G``; the gradient sums the rows that share a plane."""
    import jax
    rng = np.random.RandomState(23)
    q, k, v, do = (rng.randn(4, BIAS_T, BIAS_D).astype(np.float32)
                   for _ in range(4))
    bias = rng.randn(2, BIAS_T, BIAS_T).astype(np.float32)
    f = lambda a, b, c, e: jfa.flash_attention(a, b, c, bias=e, bias_groups=2,
                                               block_q=64, block_k=64)
    ref, vjp = jax.vjp(f, q, k, v, bias)
    want = (np.asarray(ref), [np.asarray(g) for g in vjp(do)])
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v, bias)]
    out = fa.flash_attention(*leaves[:3], bias=leaves[3], bias_groups=2)
    out.backward(torch.from_numpy(do))
    _assert_bias_parity((out.detach().numpy(),
                         [x.grad.numpy() for x in leaves]), want)


def test_flash_bias_refusals_match_the_reference():
    import jax.numpy as jnp
    t = BIAS_T
    q = torch.ones((4, t, BIAS_D))
    jq = jnp.ones((4, t, BIAS_D), jnp.float32)
    for shape, match in (((3, t, t), "bias shape"), ((2, t, t), "ambiguous"),
                         ((4, t, 64), "bias shape"), ((t, t), "bias shape")):
        with pytest.raises(ValueError, match=match):
            fa.flash_attention(q, q, q, bias=torch.ones(shape))
        with pytest.raises(ValueError, match=match):
            jfa.flash_attention(jq, jq, jq, bias=jnp.ones(shape))
    with pytest.raises(ValueError, match="bias_groups"):   # 3 does not
        fa.flash_attention(q, q, q, bias=torch.ones((3, t, t)),   # divide 4
                           bias_groups=3)
    q4 = q.reshape(2, 2, t, BIAS_D)
    with pytest.raises(ValueError, match="bias shape"):
        fa.mha_flash_attention(q4, q4, q4, bias=torch.ones((3, 2, t, t)))


def test_flash_plain_backward_returns_the_unreduced_d_bias():
    """The plain backward's fourth result is ``(BH, T, Tk)`` float32 with
    zeros wherever the score is masked; ``reduce_d_bias`` sums it to the
    bias's layout and dtype."""
    bh, t, d = 4, 70, 16
    q, k, v = (torch.from_numpy(x) for x in _qkv(24, bh, t, d))
    do = torch.from_numpy(np.random.RandomState(25).randn(bh, t, d)
                          .astype(np.float32))
    valid = torch.tensor([70, 33, 1, 64], dtype=torch.int32)
    bias = torch.from_numpy(np.random.RandomState(26).randn(2, t, t)
                            .astype(np.float32))
    out, lse = fa.flash_attention_plain(q, k, v, 0.25, True, valid,
                                        bias=bias)
    grads = fa.flash_attention_bwd_plain(q, k, v, do, lse,
                                         fa.flash_attention_delta(do, out),
                                         0.25, True, valid, bias=bias)
    db = grads[3]
    assert db.shape == (bh, t, t) and db.dtype == torch.float32
    upper = torch.ones((t, t), dtype=torch.bool).triu(1)
    assert torch.all(db[:, upper] == 0)
    for row, n in enumerate(valid.tolist()):
        assert torch.all(db[row, :, n:] == 0)
    red = fa.reduce_d_bias(db, bias.to(torch.bfloat16))
    assert red.dtype == torch.bfloat16 and red.shape == bias.shape
    # rows 0 and 2 read plane 0, rows 1 and 3 plane 1
    torch.testing.assert_close(red.float(), (db[:2] + db[2:])
                               .to(torch.bfloat16).float())
    assert fa.reduce_d_bias(db, bias[:1]).shape == (1, t, t)


@pytest.mark.parametrize("bias_shape", BIAS_SHAPES,
                         ids=["per-row", "per-head", "shared", "alibi"])
def test_cpu_attention_with_bias_matches_jax_local_attention(bias_shape):
    """``parallel.attention(bias=)`` on the CPU (the dense arm) against
    the reference's CPU ``local_flash_attention(bias=)`` (its XLA dense
    arm), forward and ``jax.vjp``."""
    import jax
    jra = importlib.import_module("tpu_mx.parallel.ring_attention")
    from tpu_mx_torch.parallel import attention
    q, k, v, do, bias = _bias_case(27, bias_shape)
    f = lambda a, b, c, e: jra.local_flash_attention(
        a, b, c, causal=True, valid_length=BIAS_VALID, bias=e)
    ref, vjp = jax.vjp(f, q, k, v, bias)
    want = (np.asarray(ref), [np.asarray(g) for g in vjp(do)])
    got = _port_mha_grads(attention, q, k, v, do, bias, True, BIAS_VALID)
    _assert_bias_parity(got, want)


# ----------------------------------------------------------------------------
# the bf16 tensor-core kernels' rounding, modelled on the CPU
# ----------------------------------------------------------------------------
TC_KEY_TILE = 64   # keys of the forward kernel's K/V tile
TC_REL = 2e-2      # x max|ref|: the card's bf16 tolerance (chip_smoke.py)


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _tc_masks(bh, t, k0, kn, causal, valid, rate, seed):
    qi = torch.arange(t).reshape(1, t, 1)
    ki = torch.arange(k0, k0 + kn).reshape(1, 1, kn)
    ok = (ki < torch.from_numpy(valid).long().reshape(bh, 1, 1)) \
        .expand(bh, t, kn)
    if causal:
        ok = ok & (ki <= qi)
    keep = None if rate == 0.0 else fa.dropout_keep_mask(
        seed, torch.arange(bh).reshape(bh, 1, 1), qi, ki, rate)
    return ok, keep


def _tc_model(q, k, v, do, scale, causal, valid, rate=0.0, seed=None,
              bias=None, lse_delta=None):
    """The bf16 tensor-core kernels' arithmetic in float32 torch: bf16 q,
    k, v, dO; float32 scores and statistics (an online softmax over key
    tiles, as the forward runs it); P rounded to bf16 before P·V, P and
    dS rounded to bf16 before Pᵀ·dO, dSᵀ·Q and dS·K, dS after its
    ``* scale`` as the dq and dk/dv kernels round it; float32 sums over
    keys and queries.  The backward reads ``lse_delta`` (``(BH, T)``
    each) where given, as the backward kernels read their caller's, else
    the model forward's.  Returns ``(out, dq, dk, dv)``, out in bf16 as
    the kernel writes it."""
    bh, t, d = q.shape
    tk = k.shape[1]
    masked = -math.inf if bias is not None else fa.NEG_INF
    m = torch.full((bh, t, 1), fa.NEG_INF)
    l = torch.zeros((bh, t, 1))
    acc = torch.zeros((bh, t, d))
    for k0 in range(0, tk, TC_KEY_TILE):
        kn = min(TC_KEY_TILE, tk - k0)
        ok, keep = _tc_masks(bh, t, k0, kn, causal, valid, rate, seed)
        s = q @ k[:, k0:k0 + kn].transpose(1, 2) * scale
        if bias is not None:
            s = s + bias[:, :, k0:k0 + kn]
        s = torch.where(ok, s, masked)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        if keep is not None:
            p = torch.where(keep, p / (1 - rate), 0.0)
        acc = acc * alpha + _bf16(p) @ v[:, k0:k0 + kn]
        m = m_new
    out = _bf16(acc / l.clamp_min(1e-30))
    lse = m + torch.log(l.clamp_min(1e-30))

    delta = (do * out).sum(-1, keepdim=True)
    if lse_delta is not None:
        lse, delta = (x[..., None] for x in lse_delta)
    ok, keep = _tc_masks(bh, t, 0, tk, causal, valid, rate, seed)
    s = q @ k.transpose(1, 2) * scale
    if bias is not None:
        s = s + bias
    p = torch.where(ok, torch.exp(s - lse), 0.0)
    dp = do @ v.transpose(1, 2)
    pd, g = p, dp
    if keep is not None:
        pd = torch.where(keep, p / (1 - rate), 0.0)
        g = torch.where(keep, dp / (1 - rate), 0.0)
    ds = _bf16(p * (g - delta) * scale)
    dq = ds @ k
    dv = _bf16(pd).transpose(1, 2) @ do
    dk = ds.transpose(1, 2) @ q
    return out, dq, dk, dv


def _tc_case(seed, t, d, bias):
    rng = np.random.RandomState(seed)
    q, k, v, do = (_bf16(torch.from_numpy(rng.randn(4, t, d)
                                          .astype(np.float32)))
                   for _ in range(4))
    valid = np.array([t, 1, t // 2 + 3, min(65, t)], np.int32)
    b = None if not bias else torch.from_numpy(
        rng.randn(2, t, t).astype(np.float32))   # per head: H=2, B=2
    return q, k, v, do, valid, b


def _assert_within(got, want, names):
    for g, w, name in zip(got, want, names):
        w = np.asarray(w, np.float32)
        tol = TC_REL * float(np.abs(w).max())
        np.testing.assert_allclose(np.asarray(g, np.float32), w, rtol=0,
                                   atol=tol, err_msg=name)


@pytest.mark.parametrize("bias", [False, True], ids=["no-bias", "per-head"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("t", [77, 200])
def test_tc_rounding_model_matches_jax_vjp(t, d, causal, bias):
    """The bf16 tensor-core kernels' rounding (P and dS in bf16 before the
    products) stays within the card's tolerance of the reference's
    interpret-mode kernels and ``jax.vjp`` of them, on the same
    bf16-rounded inputs: out, dq, dk and dv within 2e-2·max|ref|."""
    import jax
    q, k, v, do, valid, b = _tc_case(t + d + causal, t, d, bias)
    scale = d ** -0.5
    kw = dict(causal=causal, kv_valid=valid)
    if b is not None:
        kw.update(bias=b.numpy(), bias_groups=2)
    ref, vjp = jax.vjp(lambda a, c, e: jfa.flash_attention(a, c, e, **kw),
                       q.numpy(), k.numpy(), v.numpy())
    ref_dq, ref_dk, ref_dv = vjp(do.numpy())
    bias_rows = None if b is None else b.repeat(2, 1, 1)
    got = _tc_model(q, k, v, do, scale, causal, valid, bias=bias_rows)
    _assert_within(got, (ref, ref_dq, ref_dk, ref_dv),
                   ("out", "dq", "dk", "dv"))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("t", [77, 200])
def test_tc_rounding_model_with_dropout_matches_plain(t, d, causal):
    """Dropout 0.1 with the port's keep mask (the reference's TPU mask
    cannot be drawn off the TPU): the rounding model against the port's
    float32 plain forward and backward, within 2e-2·max|ref|; the model's
    backward reads the plain forward's lse and delta, as the kernels are
    held against the plain versions on the card."""
    q, k, v, do, valid, _ = _tc_case(t * d + causal, t, d, False)
    scale, rate = d ** -0.5, 0.1
    seed = torch.tensor([t + d], dtype=torch.int32)
    kv = torch.from_numpy(valid)
    ref, lse = fa.flash_attention_plain(q, k, v, scale, causal, kv, rate,
                                        seed)
    delta = fa.flash_attention_delta(do, ref)
    ref_dq, ref_dk, ref_dv = fa.flash_attention_bwd_plain(
        q, k, v, do, lse, delta, scale, causal, kv, rate, seed)
    got = _tc_model(q, k, v, do, scale, causal, valid, rate, seed,
                    lse_delta=(lse, delta))
    _assert_within(got, (ref, ref_dq, ref_dk, ref_dv),
                   ("out", "dq", "dk", "dv"))
