"""The PyTorch/CUDA port's kernel twins against the JAX reference kernels.

Inputs are made with numpy from a seed and fed to both packages.  On the
CPU each port wrapper runs its plain PyTorch version; the JAX side runs
its Pallas kernels in interpret mode (as tests/test_kernels.py does) and
its XLA/dense references.  The CUDA kernels themselves are checked on
the card by tests/test_torch_cuda.py and chip_smoke.py.
"""
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
