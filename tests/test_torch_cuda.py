"""The port's CUDA kernels on the card, against their plain versions, and
the ResNet, PTB LSTM and SSD slices and the imperative surface on the
card against the CPU.

Needs a CUDA card and ``nvcc``; every test here is marked ``cuda`` and
skips without a card.  The file imports neither jax nor ``tpu_mx``, so
it also runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""
import json
import math

import numpy as np
import pytest
import torch

from tpu_mx_torch import rtc
from tpu_mx_torch.base import MXNetError
from tpu_mx_torch.kernels import flash_attention as fa
from tpu_mx_torch.kernels import paged_attention as pa
from tpu_mx_torch.serving import attention as sattn

pytestmark = pytest.mark.cuda

# float32 math in kernel and plain version alike; only the order of the
# sums differs
TOL = 1e-4


@pytest.fixture(autouse=True)
def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False


def _paged(seed=0, bs=16, h=4, d=64, tq=1, pool=torch.float32,
           lengths=(37, 9, 130, 16)):
    g = torch.Generator().manual_seed(seed)
    b = len(lengths)
    nblk = [-(-x // bs) for x in lengths]
    nb = max(nblk) + 3                       # padded tail, block 0
    perm = torch.randperm(64, generator=g) + 1
    tables = torch.zeros((b, nb), dtype=torch.int32)
    at = 0
    for i, k in enumerate(nblk):
        tables[i, :k] = perm[at:at + k]
        at += k
    kp = torch.randn((80, bs, h, d), generator=g).to(pool)
    vp = torch.randn((80, bs, h, d), generator=g).to(pool)
    q = torch.randn((b, tq, h, d), generator=g)   # lengths >= Tq (contract)
    lens = torch.tensor(lengths, dtype=torch.int32)
    return [x.cuda() for x in (q, kp, vp, tables, lens)]


@pytest.mark.parametrize("pool", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tq", [1, 4, 8])
@pytest.mark.parametrize("d", [16, 128])
def test_paged_kernel_matches_plain(d, tq, pool):
    q, kp, vp, tab, lens = _paged(d=d, tq=tq, pool=pool)
    before = pa.paged_attention.launches
    out = pa.paged_attention(q, kp, vp, tab, lens)
    ref = pa.paged_attention_plain(q, kp, vp, tab, lens,
                                   1 / math.sqrt(d))
    torch.cuda.synchronize()
    assert pa.paged_attention.launches == before + 1
    torch.testing.assert_close(out, ref, rtol=TOL, atol=TOL)


def test_paged_kernel_padding_blocks_cannot_leak():
    q, kp, vp, tab, lens = _paged()
    base = pa.paged_attention(q, kp, vp, tab, lens)
    kp2, vp2 = kp.clone(), vp.clone()
    kp2[0] = 1e9                         # block 0 backs the padded tail
    vp2[0] = -1e9
    last = tab[0, 2].item()              # row 0: 37 tokens end in its 3rd block
    kp2[last, 5:] = 1e9
    vp2[last, 5:] = -1e9
    again = pa.paged_attention(q, kp2, vp2, tab, lens)
    assert torch.equal(base, again)


def test_paged_kernel_stops_at_the_table_end():
    """A length past the table's NB*BS slots walks the NB entries and
    no further, as the plain version does."""
    q, kp, vp, tab, lens = _paged()
    lens = torch.full_like(lens, tab.shape[1] * 16 + 40)
    out = pa.paged_attention(q, kp, vp, tab, lens)
    ref = pa.paged_attention_plain(q, kp, vp, tab, lens, 1 / 8)
    torch.testing.assert_close(out, ref, rtol=TOL, atol=TOL)


def test_paged_kernel_refuses_what_it_does_not_take():
    """What ``kernel_takes`` says no to, the wrapper refuses by name: a
    head dim outside the instances and a float16 query (any window is
    taken, in chunks of ``WINDOW_CHUNK`` rows)."""
    q, kp, vp, tab, lens = _paged(d=64)
    assert not pa.kernel_takes(48, torch.float32, torch.float32)
    with pytest.raises(MXNetError, match="head_dim"):
        pa.paged_attention(q[..., :48].contiguous(), kp[..., :48],
                           vp[..., :48], tab, lens)
    assert not pa.kernel_takes(64, torch.float16, torch.float32)
    with pytest.raises(MXNetError, match="float32 or bfloat16"):
        pa.paged_attention(q.half(), kp, vp, tab, lens)


def test_paged_kernel_takes_a_window_of_nine():
    """A window of 9 rows runs as two chunks (8 + 1) and matches the
    plain version."""
    assert pa.kernel_takes(64, torch.float32, torch.float32, window=9)
    q, kp, vp, tab, lens = _paged(d=64, tq=9)
    before = pa.paged_attention.launches
    out = pa.paged_attention(q, kp, vp, tab, lens)
    ref = pa.paged_attention_plain(q, kp, vp, tab, lens, 1 / 8)
    torch.cuda.synchronize()
    assert pa.paged_attention.launches == before + 1
    torch.testing.assert_close(out, ref, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("t", [1, 63, 64, 65, 300])
@pytest.mark.parametrize("d", [32, 128])
def test_flash_kernel_matches_plain(d, t, causal):
    g = torch.Generator().manual_seed(t)
    q, k, v = (torch.randn((6, t, d), generator=g).cuda() for _ in range(3))
    before = fa.flash_attention.launches
    out, lse = fa.flash_attention(q, k, v, causal=causal, return_lse=True)
    ref, ref_lse = fa.flash_attention_plain(q, k, v, 1 / math.sqrt(d),
                                            causal=causal)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    torch.testing.assert_close(out, ref, rtol=TOL, atol=TOL)
    torch.testing.assert_close(lse, ref_lse, rtol=TOL, atol=TOL)


def test_flash_kernel_refuses_float16():
    q = torch.zeros((2, 64, 64), device="cuda", dtype=torch.float16)
    with pytest.raises(MXNetError, match="float32 or bfloat16"):
        fa.flash_attention(q, q, q)


def _flash_case(seed, bh, t, d, dtype, tk=None):
    g = torch.Generator().manual_seed(seed)
    tk = t if tk is None else tk
    q = torch.randn((bh, t, d), generator=g)
    k, v = (torch.randn((bh, tk, d), generator=g) for _ in range(2))
    do = torch.randn((bh, t, d), generator=g)
    valid = torch.randint(1, tk + 1, (bh,), generator=g, dtype=torch.int32)
    return [x.to("cuda", dt) for x, dt in
            ((q, dtype), (k, dtype), (v, dtype), (do, dtype),
             (valid, torch.int32))]


def _tol(dtype, ref):
    # float32: the kernels and the plain versions differ only in the order
    # of their float32 sums; bfloat16: both read the same rounded inputs
    # but round their outputs once each
    return TOL if dtype == torch.float32 else 2e-2 * float(ref.abs().max())


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,d", [(77, 64), (128, 32), (200, 128)])
def test_flash_forward_and_backward_kernels_match_plain(t, d, dtype, causal,
                                                        rate):
    """kv_valid ragged over the rows, dropout on and off, both types: the
    forward, dq and dk/dv kernels against the plain forward and the plain
    backward with the same seed."""
    q, k, v, do, valid = _flash_case(t + d, 6, t, d, dtype)
    seed = torch.tensor([1234 + t], dtype=torch.int32, device="cuda")
    scale = 1 / math.sqrt(d)
    opts = dict(causal=causal, kv_valid=valid, dropout_rate=rate,
                dropout_seed=seed)
    counts = (fa.flash_attention.launches, fa.flash_attention_bwd_dq.launches,
              fa.flash_attention_bwd_dkv.launches)
    out, lse = fa.flash_attention(q, k, v, return_lse=True, **opts)
    ref, ref_lse = fa.flash_attention_plain(q, k, v, scale, causal, valid,
                                            rate, seed)
    delta = fa.flash_attention_delta(do, ref)
    args = (q, k, v, do, ref_lse, delta, scale, causal, valid, rate, seed)
    dq = fa.flash_attention_bwd_dq(*args)
    dk, dv = fa.flash_attention_bwd_dkv(*args)
    want = fa.flash_attention_bwd_plain(*args)
    torch.cuda.synchronize()
    assert (fa.flash_attention.launches, fa.flash_attention_bwd_dq.launches,
            fa.flash_attention_bwd_dkv.launches) == tuple(c + 1 for c in
                                                          counts)
    torch.testing.assert_close(lse, ref_lse, rtol=TOL, atol=TOL)
    for got, exp in zip((out, dq, dk, dv), (ref,) + want):
        tol = _tol(dtype, exp)
        torch.testing.assert_close(got.float(), exp.float(), rtol=0,
                                   atol=tol)


def test_flash_backward_zeroes_keys_past_kv_valid():
    """dk/dv rows of keys past kv_valid — whole tiles and a partial one —
    come out exactly 0 although the outputs start uninitialized."""
    q, k, v, do, _ = _flash_case(3, 4, 300, 64, torch.float32)
    valid = torch.tensor([300, 1, 64, 130], dtype=torch.int32, device="cuda")
    for _ in range(2):   # the second run reuses the first's memory
        out, lse = fa.flash_attention(q, k, v, kv_valid=valid,
                                      return_lse=True)
        args = (q, k, v, do, lse, fa.flash_attention_delta(do, out),
                0.125, False, valid, 0.0, None)
        dk, dv = fa.flash_attention_bwd_dkv(*args)
    for row, n in enumerate(valid.tolist()):
        assert torch.all(dk[row, n:] == 0) and torch.all(dv[row, n:] == 0)
        assert torch.all(dv[row, :n].abs().sum(-1) > 0)


def test_flash_dropout_mask_is_the_plain_mask_bit_for_bit():
    """The forward kernel's keep mask, read out through its output: with
    q = 0 every valid probability is 1/T, and V one-hot over a chunk of
    D keys puts each kept key's scaled probability in its own output
    column, so ``out > 0`` is the mask.  It equals
    :func:`dropout_keep_mask`, and its keep rate is 1 - rate."""
    bh, t, d, rate = 16, 256, 64, 0.1
    seed = torch.tensor([-7], dtype=torch.int32, device="cuda")
    q = torch.zeros((bh, t, d), device="cuda")
    got = torch.empty((bh, t, t), dtype=torch.bool, device="cuda")
    for c in range(t // d):
        v = torch.zeros((bh, t, d), device="cuda")
        v[:, c * d:(c + 1) * d] = torch.eye(d, device="cuda")
        out = fa.flash_attention(q, q, v, dropout_rate=rate,
                                 dropout_seed=seed)
        got[:, :, c * d:(c + 1) * d] = out > 0
    ar = lambda n, shape: torch.arange(n, device="cuda").reshape(shape)
    want = fa.dropout_keep_mask(seed, ar(bh, (bh, 1, 1)), ar(t, (1, t, 1)),
                                ar(t, (1, 1, t)), rate)
    assert torch.equal(got, want)
    assert abs(want.float().mean().item() - (1 - rate)) < 0.005


def test_flash_autograd_function_runs_the_backward_kernels():
    q, k, v, do, valid = _flash_case(5, 4, 96, 64, torch.bfloat16)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    before = (fa.flash_attention_bwd_dq.launches,
              fa.flash_attention_bwd_dkv.launches)
    out = fa.mha_flash_attention(*(x.reshape(2, 2, 96, 64) for x in leaves),
                                 valid_length=valid[::2], dropout_rate=0.1,
                                 dropout_seed=3)
    out.backward(do.reshape(2, 2, 96, 64))
    assert (fa.flash_attention_bwd_dq.launches,
            fa.flash_attention_bwd_dkv.launches) == (before[0] + 1,
                                                     before[1] + 1)
    kv = valid[::2].repeat_interleave(2)
    seed = torch.tensor([3], dtype=torch.int32, device="cuda")
    ref, lse = fa.flash_attention_plain(q, k, v, 0.125, False, kv, 0.1, seed)
    want = fa.flash_attention_bwd_plain(
        q, k, v, do, lse, fa.flash_attention_delta(do, ref), 0.125, False,
        kv, 0.1, seed)
    for leaf, exp in zip(leaves, want):
        torch.testing.assert_close(leaf.grad.float(), exp.float(), rtol=0,
                                   atol=_tol(torch.bfloat16, exp))


def test_cpu_and_card_serve_the_same_stream():
    from tpu_mx_torch.serving import Server, TinyLM
    kw = dict(vocab_size=64, embed_dim=256, num_heads=2, num_layers=2,
              seed=0)
    streams = []
    for dev in ("cpu", "cuda"):
        srv = Server(TinyLM(**kw, device=dev), num_blocks=64, device=dev)
        reqs = [srv.submit(p, max_new_tokens=8)
                for p in ([5, 6, 7], list(range(40)))]
        srv.run_until_idle()
        streams.append([r.tokens for r in reqs])
    assert streams[0] == streams[1]
    np.testing.assert_array_equal(np.asarray(streams[0]).shape, (2, 8))


def test_bert_train_step_on_the_card_matches_the_cpu():
    """Two LAMB steps of a small BERT in float32 with valid lengths: the
    card (flash kernels) and the CPU (dense plain version) agree."""
    from tpu_mx_torch import optimizer
    from tpu_mx_torch.models import BERTModel, MLMLoss
    from tpu_mx_torch.parallel import CompiledTrainStep
    cfg = dict(num_layers=2, units=128, hidden_size=256, num_heads=2,
               vocab_size=300, max_length=128, dropout=0.0)
    cpu = BERTModel(cfg, device="cpu",
                    generator=torch.Generator().manual_seed(0))
    gpu = BERTModel.from_numpy(
        {n: p.detach().numpy() for n, p in cpu.named_parameters()}, cfg)
    g = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, 300, (3, 100), generator=g)
    valid = torch.tensor([100, 61, 7])
    pos = torch.stack([torch.randperm(int(n), generator=g)[:5]
                       for n in valid])
    batch = (tokens, torch.zeros_like(tokens), valid, pos,
             torch.gather(tokens, 1, pos))
    losses = []
    for net, dev in ((cpu, "cpu"), (gpu, "cuda")):
        step = CompiledTrainStep(net, MLMLoss(), optimizer.create(
            "lamb", learning_rate=1e-3), device=dev)
        losses.append([float(step.step(*(x.to(dev) for x in batch)))
                       for _ in range(2)])
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-5)
    for (name, a), (_, b) in zip(cpu.named_parameters(),
                                 gpu.named_parameters()):
        torch.testing.assert_close(b.detach().cpu(), a.detach(), rtol=1e-4,
                                   atol=1e-4, msg=name)


# ---------------------------------------------------------------------------
# the bf16 tensor-core instances (forward, dq, dk/dv) and the routes by dtype
# ---------------------------------------------------------------------------
def _tc_tol(ref):
    # the kernels round P and dS to bf16 before their products, the plain
    # versions do not; dk of a row with a single valid key is a float32
    # cancellation (p = 1, dP = delta) of ~1e-6, hence the absolute floor
    return 2e-2 * float(ref.abs().max()) + 1e-4


def _tc_run(t, d, causal, valid, rate=0.0, bias=None, planes=None):
    q, k, v, do, _ = _flash_case(7 * t + d, len(valid), t, d, torch.bfloat16)
    kv = torch.tensor(valid, dtype=torch.int32, device="cuda")
    seed = torch.tensor([31 + t], dtype=torch.int32, device="cuda")
    scale = 1 / math.sqrt(d)
    wrappers = (fa.flash_attention, fa.flash_attention_bwd_dq,
                fa.flash_attention_bwd_dkv)
    before = [dict(w.routes) for w in wrappers]
    out, lse = fa.flash_attention(q, k, v, causal=causal, kv_valid=kv,
                                  dropout_rate=rate, dropout_seed=seed,
                                  bias=bias, bias_groups=planes,
                                  return_lse=True)
    seed = seed if rate else None
    ref, ref_lse = fa.flash_attention_plain(q, k, v, scale, causal, kv, rate,
                                            seed, bias)
    args = (q, k, v, do, ref_lse, fa.flash_attention_delta(do, ref), scale,
            causal, kv, rate, seed, bias)
    dq = fa.flash_attention_bwd_dq(*args, want_d_bias=bias is not None)
    dk, dv = fa.flash_attention_bwd_dkv(*args)
    want = fa.flash_attention_bwd_plain(*args)
    torch.cuda.synchronize()
    for wrapper, was in zip(wrappers, before):
        assert wrapper.routes == dict(was, wgmma=was["wgmma"] + 1)
    torch.testing.assert_close(lse, ref_lse, rtol=TOL, atol=TOL)
    got = [(out, ref), (dk, want[1]), (dv, want[2])]
    if bias is None:
        got.append((dq, want[0]))
    else:    # d_bias: float32, before the rounding of dS
        got += [(dq[0], want[0]), (dq[1], want[3])]
    for g, exp in got:
        torch.testing.assert_close(g.float(), exp.float(), rtol=0,
                                   atol=_tc_tol(exp))
    return out, dk, dv


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("t", [1, 63, 65, 129, 700])
def test_tc_forward_and_dkv_match_plain(t, d, causal):
    """The bf16 wgmma forward, dq and dk/dv against the float32 plain
    versions over ragged T (tiles of 64 and 128 keys cut anywhere) and
    every head dim, with kv_valid holding a full row, a row of 1 key and a
    partial tile; dk/dv rows past kv_valid come out exactly 0."""
    valid = [t, 1, max(1, (2 * t) // 3)]
    _, dk, dv = _tc_run(t, d, causal, valid)
    for row, n in enumerate(valid):
        assert torch.all(dk[row, n:] == 0) and torch.all(dv[row, n:] == 0)


@pytest.mark.parametrize("t,d,causal", [(129, 32, False), (700, 128, True),
                                        (200, 16, True)])
def test_tc_kernels_with_dropout_match_plain(t, d, causal):
    _tc_run(t, d, causal, [t, 1, t // 2, 65], rate=0.1)


@pytest.mark.parametrize("planes,bias_dtype", [
    (4, torch.float32), (1, torch.bfloat16), (2, torch.float16)])
@pytest.mark.parametrize("t,d,causal", [(129, 32, False), (700, 128, True),
                                        (256, 64, False)])
def test_tc_kernels_with_every_bias_layout_match_plain(t, d, causal, planes,
                                                       bias_dtype):
    """A plane per row, one shared plane and one per head (G=2), in float32,
    bfloat16 and float16, with dropout.  The kernels copy the bias tile in
    16-byte chunks where its rows start 16-byte aligned (T=256 in every
    type, T=700 in float32) and element by element elsewhere."""
    bias = _bias(t + planes, planes, t, t, bias_dtype)
    _tc_run(t, d, causal, [t, 1, t // 2, 65], rate=0.1, bias=bias,
            planes=planes)


def test_routes_follow_the_dtype():
    """bf16 runs the tensor-core forward, dq and dk/dv; float32 the
    split-precision tensor-core forward, dq and dk/dv, as the C entry
    points report."""
    wrappers = (fa.flash_attention, fa.flash_attention_bwd_dq,
                fa.flash_attention_bwd_dkv)
    for dtype, routes in ((torch.bfloat16, ("wgmma",) * 3),
                          (torch.float32, ("tf32x3",) * 3)):
        q, k, v, do, valid = _flash_case(2, 2, 96, 64, dtype)
        before = [dict(w.routes) for w in wrappers]
        out, lse = fa.flash_attention(q, k, v, kv_valid=valid,
                                      return_lse=True)
        args = (q, k, v, do, lse, fa.flash_attention_delta(do, out), 0.125,
                False, valid)
        fa.flash_attention_bwd_dq(*args)
        fa.flash_attention_bwd_dkv(*args)
        for wrapper, was, route in zip(wrappers, before, routes):
            assert wrapper.routes == dict(was, **{route: was[route] + 1})


def test_tc_kernels_refuse_unaligned_bf16():
    """The tensor-core kernels copy 16-byte chunks: a bf16 view that does
    not start 16-byte aligned is refused, not run on another kernel."""
    base = torch.zeros(2 * 64 * 64 + 1, dtype=torch.bfloat16, device="cuda")
    q = base[1:].view(2, 64, 64)
    before = fa.flash_attention.launches
    with pytest.raises(MXNetError, match="16-byte aligned"):
        fa.flash_attention(q, q, q)
    assert fa.flash_attention.launches == before
    lse = torch.zeros((2, 64), device="cuda")
    before = (fa.flash_attention_bwd_dq.launches,
              dict(fa.flash_attention_bwd_dq.routes))
    with pytest.raises(MXNetError, match="16-byte aligned"):
        fa.flash_attention_bwd_dq(q, q, q, q, lse, lse, 0.125)
    assert (fa.flash_attention_bwd_dq.launches,
            fa.flash_attention_bwd_dq.routes) == before


# ---------------------------------------------------------------------------
# the additive bias and d_bias
# ---------------------------------------------------------------------------
def _bias(seed, planes, t, tk, dtype):
    g = torch.Generator().manual_seed(seed)
    return torch.randn((planes, t, tk), generator=g).to("cuda", dtype)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("planes,bias_dtype", [
    (6, torch.float32), (1, torch.float32), (3, torch.bfloat16),
    (6, torch.float16)])
@pytest.mark.parametrize("t,d", [(77, 64), (200, 128)])
def test_flash_bias_kernels_match_plain(t, d, planes, bias_dtype, dtype,
                                        causal, rate):
    """The three kernels with a bias of 6 (per row), 1 (shared) or 3
    (groups) planes, in float32, bfloat16 or float16, against the plain
    forward and backward: out, lse, dq, dk, dv and the unreduced
    d_bias."""
    q, k, v, do, valid = _flash_case(t + d + planes, 6, t, d, dtype)
    bias = _bias(t + planes, planes, t, t, bias_dtype)
    seed = torch.tensor([99 + t], dtype=torch.int32, device="cuda")
    scale = 1 / math.sqrt(d)
    out, lse = fa.flash_attention(q, k, v, causal=causal, kv_valid=valid,
                                  dropout_rate=rate, dropout_seed=seed,
                                  bias=bias, bias_groups=planes,
                                  return_lse=True)
    ref, ref_lse = fa.flash_attention_plain(q, k, v, scale, causal, valid,
                                            rate, seed, bias)
    delta = fa.flash_attention_delta(do, ref)
    args = (q, k, v, do, ref_lse, delta, scale, causal, valid, rate, seed,
            bias)
    dq, db = fa.flash_attention_bwd_dq(*args, want_d_bias=True)
    dk, dv = fa.flash_attention_bwd_dkv(*args)
    want = fa.flash_attention_bwd_plain(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(lse, ref_lse, rtol=TOL, atol=TOL)
    for got, exp in zip((out, dq, dk, dv), (ref,) + want[:3]):
        torch.testing.assert_close(got.float(), exp.float(), rtol=0,
                                   atol=_tol(dtype, exp))
    assert db.dtype == torch.float32 and db.shape == (6, t, t)
    torch.testing.assert_close(db, want[3], rtol=0, atol=_tol(dtype, want[3]))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_d_bias_is_written_everywhere_on_poisoned_memory(dtype, causal):
    """d_bias comes from torch.empty: the dq kernels (3xTF32 and wgmma)
    write every element — masked columns, key tiles past kv_valid
    and above the diagonal that they never visit get 0 — over memory a
    previous call filled with NaN."""
    t = 300
    q, k, v, do, _ = _flash_case(8, 4, t, 64, dtype)
    valid = torch.tensor([t, 1, 64, 130], dtype=torch.int32, device="cuda")
    bias = _bias(9, 1, t, t, torch.float32)
    out, lse = fa.flash_attention(q, k, v, causal=causal, kv_valid=valid,
                                  bias=bias, return_lse=True)
    args = (q, k, v, do, lse, fa.flash_attention_delta(do, out), 0.125,
            causal, valid, 0.0, None, bias)
    poison = torch.full((4, t, t), float("nan"), device="cuda")
    at = poison.data_ptr()
    del poison
    _, db = fa.flash_attention_bwd_dq(*args, want_d_bias=True)
    torch.cuda.synchronize()
    assert db.data_ptr() == at          # the poisoned block, reused
    assert torch.isfinite(db).all()
    for row, n in enumerate(valid.tolist()):
        assert torch.all(db[row, :, n:] == 0)
        assert torch.any(db[row, :, :n] != 0)
    if causal:
        assert torch.all(db[:, torch.ones((t, t), dtype=torch.bool,
                                          device="cuda").triu(1)] == 0)
    want = fa.flash_attention_bwd_plain(*args)[3]
    torch.testing.assert_close(db, want, rtol=TOL, atol=_tol(dtype, want))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_minus_inf_bias_gives_zero_rows_not_nans(dtype):
    """-inf bias entries get p = 0; a row that is -inf everywhere gets
    out = 0 and zero gradients, in the kernels (3xTF32 and wgmma) as in
    the plain versions."""
    q, k, v, do, valid = _flash_case(10, 2, 96, 32, dtype)
    bias = torch.zeros((2, 96, 96), device="cuda")
    bias[:, :, ::3] = -math.inf
    bias[1, 5] = -math.inf
    for causal, kv in ((False, None), (True, valid)):
        out, lse = fa.flash_attention(q, k, v, causal=causal, kv_valid=kv,
                                      bias=bias, return_lse=True)
        ref, ref_lse = fa.flash_attention_plain(q, k, v, 32 ** -0.5, causal,
                                                kv, bias=bias)
        args = (q, k, v, do, lse, fa.flash_attention_delta(do, out),
                32 ** -0.5, causal, kv, 0.0, None, bias)
        dq, db = fa.flash_attention_bwd_dq(*args, want_d_bias=True)
        dk, dv = fa.flash_attention_bwd_dkv(*args)
        want = fa.flash_attention_bwd_plain(*args)
        torch.cuda.synchronize()
        for got, exp in zip((out, lse, dq, dk, dv, db), (ref, ref_lse) + want):
            assert torch.isfinite(got).all()
            atol = TOL if got is lse else _tol(dtype, exp)
            torch.testing.assert_close(got.float(), exp.float(), rtol=TOL,
                                       atol=atol)
        assert torch.all(out[1, 5] == 0) and torch.all(dq[1, 5] == 0)
        assert torch.all(db[:, :, ::3] == 0) and torch.all(db[1, 5] == 0)


@pytest.mark.parametrize("bias_shape", [(2, 3, 80, 80), (1, 3, 80, 80),
                                        (1, 1, 80, 80), (1, 3, 1, 80)])
def test_flash_bias_autograd_on_the_card_matches_the_cpu(bias_shape):
    """``mha_flash_attention(bias=)`` with gradients for q, k, v and the
    bias: the card's kernels and the CPU's plain versions agree, for the
    per-row, per-head, shared and ALiBi layouts."""
    g = torch.Generator().manual_seed(sum(bias_shape))
    q, k, v, do = (torch.randn((2, 3, 80, 32), generator=g) for _ in range(4))
    bias = torch.randn(bias_shape, generator=g)
    valid = torch.tensor([80, 41])
    grads = []
    for dev in ("cpu", "cuda"):
        leaves = [x.to(dev, copy=True).requires_grad_()
                  for x in (q, k, v, bias)]
        before = fa.flash_attention_bwd_dq.launches
        out = fa.mha_flash_attention(*leaves[:3], causal=True,
                                     valid_length=valid.to(dev),
                                     bias=leaves[3])
        out.backward(do.to(dev))
        assert fa.flash_attention_bwd_dq.launches == before + (dev == "cuda")
        grads.append([out.detach().cpu()] + [x.grad.cpu() for x in leaves])
    for a, b in zip(*grads):
        assert a.shape == b.shape
        torch.testing.assert_close(b, a, rtol=TOL, atol=TOL)


# ---------------------------------------------------------------------------
# rtc: runtime-compiled CUDA user kernels
# ---------------------------------------------------------------------------
RTC_SOURCE = r'''
extern "C" __global__ void scale(const float* __restrict__ x,
                                 float* __restrict__ y, float alpha, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) y[i] = x[i] * alpha;
}

extern "C" __global__ void __launch_bounds__(256)
addmul(const float* a, const float* b, float* o, long long n) {
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i < n) o[i] = a[i] * b[i] + a[i];
}
'''


def test_rtc_scale_and_addmul_on_the_card():
    """``scale`` is ``x * 3.0`` bit for bit; ``addmul`` is ``a * b + a``
    within 1e-6 of the terms (nvcc may contract it to one FMA)."""
    mod = rtc.CudaModule(RTC_SOURCE)
    g = torch.Generator().manual_seed(0)
    x, a, b = (torch.randn(1_000_003, generator=g).cuda() for _ in range(3))
    before = rtc.Kernel.launches
    y = mod.get_kernel("scale", alpha=3.0).launch((x,))
    y2 = mod.get_kernel("scale", alpha=3.0)(x, block=128,
                                            grid=-(-x.numel() // 128))
    o = mod.get_kernel("addmul")((a, b))
    torch.cuda.synchronize()
    assert rtc.Kernel.launches == before + 3
    assert torch.equal(y, x * 3.0) and torch.equal(y2, y)
    assert torch.all((o - (a * b + a)).abs()
                     <= 1e-6 * ((a * b).abs() + a.abs()))
    two_d = mod.get_kernel("scale", alpha=-1.0).launch(
        (x[:1_000_000].reshape(1000, 1000),))
    assert two_d.shape == (1000, 1000)
    assert torch.equal(two_d, -x[:1_000_000].reshape(1000, 1000))


def test_rtc_nvcc_error_carries_its_log():
    mod = rtc.CudaModule('extern "C" __global__ void bad(const float* x, '
                         'float* y, int n) { y[0] = undefined_name; }')
    with pytest.raises(MXNetError, match="undefined_name"):
        mod.get_kernel("bad").launch((torch.ones(4, device="cuda"),))


def test_rtc_same_source_is_built_once_and_loaded_once():
    dev = torch.device("cuda", torch.cuda.current_device())
    first = rtc.CudaModule(RTC_SOURCE)
    first.get_kernel("scale", alpha=2.0)(torch.ones(8, device="cuda"))
    path = first.cubin()
    stamp = path.stat().st_mtime_ns
    second = rtc.CudaModule(RTC_SOURCE)
    y = second.get_kernel("scale", alpha=2.0)(torch.ones(8, device="cuda"))
    assert second.cubin() == path and path.stat().st_mtime_ns == stamp
    assert second.function(dev, "scale").value == \
        first.function(dev, "scale").value
    assert torch.equal(y, torch.full((8,), 2.0, device="cuda"))
    other = rtc.CudaModule(RTC_SOURCE, options=("-DUNUSED=1",))
    assert other.cubin() != path


def test_rtc_launch_refuses_what_it_cannot_pass():
    mod = rtc.CudaModule(RTC_SOURCE)
    k = mod.get_kernel("scale", alpha=1.0)
    x = torch.ones((8, 8), device="cuda")
    with pytest.raises(MXNetError, match="contiguous"):
        k((x.t(),))
    with pytest.raises(MXNetError, match="takes 2 pointers"):
        k((x, x))
    with pytest.raises(MXNetError, match="out_dtype"):
        k((x,), out_dtype="float33")
    with pytest.raises(MXNetError, match="not found/exported"):
        mod.get_kernel("scal")


# ---------------------------------------------------------------------------
# the float32 forward on the tensor cores (3xTF32)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("t,tk", [(1, 1), (33, 33), (64, 64), (65, 65),
                                  (700, 700), (40, 77)])
def test_f32_forward_matches_plain_at_every_head_dim(t, tk, d, causal):
    """Every float32 forward runs the 3xTF32 kernel and stays within the
    float32 tolerance of the plain version (ragged T, Tk != T, kv_valid
    with an empty row)."""
    g = torch.Generator().manual_seed(t * d + causal)
    bh = 3
    q = torch.randn((bh, t, d), generator=g).cuda()
    k, v = (torch.randn((bh, tk, d), generator=g).cuda() for _ in range(2))
    kv = torch.tensor([tk, 0, (tk + 1) // 2], dtype=torch.int32,
                      device="cuda")
    before = dict(fa.flash_attention.routes)
    out, lse = fa.flash_attention(q, k, v, causal=causal, kv_valid=kv,
                                  return_lse=True)
    ref, ref_lse = fa.flash_attention_plain(q, k, v, 1 / math.sqrt(d),
                                            causal, kv)
    torch.cuda.synchronize()
    assert fa.flash_attention.routes == dict(
        before, tf32x3=before["tf32x3"] + 1)
    torch.testing.assert_close(out, ref, rtol=TOL, atol=TOL)
    torch.testing.assert_close(lse, ref_lse, rtol=TOL, atol=TOL)


def test_f32_forward_is_not_one_tf32_pass():
    """Large scores (|q.k| up to ~400 at scale 1) magnify the rounding of
    the operands.  The kernel is held to a float64 reference within the
    bounds of its arithmetic, with S the largest sum |q_i||k_i| of a
    score, D the head dim and Tk the keys:

    - a product a*b kept as a_hi*b_hi + a_hi*b_lo + a_lo*b_hi, with
      hi = rna_tf32(x) and lo = rna_tf32(x - hi), is off by at most
      |a_lo b_lo| + |a_hi||b - b_hi - b_lo| + |b_hi||a - a_hi - a_lo|,
      under 3 * 2^-22 |a b|: a score by 3 * 2^-22 S;
    - its 3 D / 8 float32 accumulations on the tensor cores (truncated:
      a whole unit in the last place, not half) each lose at most
      2^-23 of a partial sum no larger than S;
    - the softmax's float32 sum over Tk keys adds Tk * 2^-23 to the lse,
      which is thus within e_s + Tk * 2^-23, e_s the score bound;
    - a score error of e_s moves the probabilities by at most 2 e_s in
      sum, hence the output by 2 e_s max|v|; P V adds its own split and
      3 Tk / 8 accumulations and the normalizer's Tk * 2^-23, times
      max|v|.

    One TF32 pass (q, k and v rounded to 10 mantissa bits) must err at
    least 50 times more than the kernel, so the test tells the two
    apart."""
    g = torch.Generator().manual_seed(9)
    q = (torch.randn((2, 96, 128), generator=g) * 3).cuda()
    k = (torch.randn((2, 96, 128), generator=g) * 3).cuda()
    v = torch.randn((2, 96, 128), generator=g).cuda()
    d, tk = q.shape[-1], k.shape[1]
    s = q.double() @ k.double().transpose(1, 2)
    exact = (torch.softmax(s, -1) @ v.double(), torch.logsumexp(s, -1))
    tf32 = lambda x: ((x.view(torch.int32) + 0x1000) & -0x2000) \
        .view(torch.float32)
    err = lambda got: [float((a.double() - b).abs().max())
                       for a, b in zip(got, exact)]
    kernel = err(fa.flash_attention(q, k, v, scale=1.0, return_lse=True))
    one_pass = err(fa.flash_attention_plain(tf32(q), tf32(k), tf32(v), 1.0))
    big = float((q.abs() @ k.abs().transpose(1, 2)).max())
    e_s = (3 * 2 ** -22 + 3 * d / 8 * 2 ** -23) * big
    e_pv = 3 * 2 ** -22 + 3 * tk / 8 * 2 ** -23 + tk * 2 ** -23
    bounds = ((2 * e_s + e_pv) * float(v.abs().max()), e_s + tk * 2 ** -23)
    for name, e_kernel, bound_, e_one in zip(("out", "lse"), kernel, bounds,
                                             one_pass):
        assert e_kernel <= bound_, (name, e_kernel, bound_)
        assert e_one >= 50 * e_kernel, (name, e_one, e_kernel)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("bias_dtype", [None, torch.float32, torch.bfloat16,
                                        torch.float16])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("t,tk", [(1, 1), (65, 65), (96, 96), (700, 700),
                                  (40, 77)])
def test_f32_backward_matches_plain_at_every_head_dim(t, tk, d, bias_dtype,
                                                      causal, rate):
    """Every float32 dq and dk/dv runs the 3xTF32 kernels and stays within
    the float32 tolerance of the plain backward: ragged T, Tk != T,
    kv_valid with an empty row, dropout, a bias of 3 planes (one per row)
    in float32 and float16 or of 1 (shared) in bfloat16, and its d_bias.
    Every launch reports the tf32x3 route."""
    g = torch.Generator().manual_seed(t * d + tk + causal)
    bh = 3
    q, do = (torch.randn((bh, t, d), generator=g).cuda() for _ in range(2))
    k, v = (torch.randn((bh, tk, d), generator=g).cuda() for _ in range(2))
    kv = torch.tensor([tk, 0, (tk + 1) // 2], dtype=torch.int32,
                      device="cuda")
    bias = None if bias_dtype is None else _bias(
        t + d, 1 if bias_dtype == torch.bfloat16 else bh, t, tk, bias_dtype)
    seed = torch.tensor([t + tk + d], dtype=torch.int32, device="cuda")
    scale = 1 / math.sqrt(d)
    ref, lse = fa.flash_attention_plain(q, k, v, scale, causal, kv, rate,
                                        seed, bias)
    args = (q, k, v, do, lse, fa.flash_attention_delta(do, ref), scale,
            causal, kv, rate, seed, bias)
    wrappers = (fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv)
    before = [dict(w.routes) for w in wrappers]
    dq = fa.flash_attention_bwd_dq(*args, want_d_bias=bias is not None)
    dk, dv = fa.flash_attention_bwd_dkv(*args)
    want = fa.flash_attention_bwd_plain(*args)
    torch.cuda.synchronize()
    for wrapper, was in zip(wrappers, before):
        assert wrapper.routes == dict(was, tf32x3=was["tf32x3"] + 1)
    got = (dq, dk, dv) if bias is None else (dq[0], dk, dv, dq[1])
    assert len(got) == len(want)
    for name, a, b in zip(("dq", "dk", "dv", "d_bias"), got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=TOL, msg=name)
    for row, n in enumerate(kv.tolist()):
        assert torch.all(dk[row, n:] == 0) and torch.all(dv[row, n:] == 0)


def test_f32_forward_refuses_unaligned_operands():
    base = torch.zeros(2 * 64 * 64 + 1, device="cuda")
    q = base[1:].view(2, 64, 64)
    before = fa.flash_attention.launches
    with pytest.raises(MXNetError, match="16-byte aligned"):
        fa.flash_attention(q, q, q)
    assert fa.flash_attention.launches == before


# ---------------------------------------------------------------------------
# paged decode split over the keys
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("pool", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bs", [1, 4, 16, 48])
def test_paged_kernel_splits_at_every_block_size(bs, pool):
    """Splits of 64 keys over pool blocks of any size: rows whose keys
    end inside the first split (every other split empty), rows spanning
    many splits, and a padded table tail."""
    lengths = (4, 300, 65, 64)
    g = torch.Generator().manual_seed(bs)
    nblk = [-(-x // bs) for x in lengths]
    n = sum(nblk) + 1
    tables = torch.zeros((len(lengths), max(nblk) + 2), dtype=torch.int32)
    perm = torch.randperm(n - 1, generator=g) + 1
    at = 0
    for i, k in enumerate(nblk):
        tables[i, :k] = perm[at:at + k]
        at += k
    kp, vp = (torch.randn((n, bs, 2, 64), generator=g).to("cuda", pool)
              for _ in range(2))
    q = torch.randn((len(lengths), 4, 2, 64), generator=g).cuda()
    tab = tables.cuda()
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    before = pa.paged_attention.routes["split_k"]
    out = pa.paged_attention(q, kp, vp, tab, lens)
    ref = pa.paged_attention_plain(q, kp, vp, tab, lens, 1 / 8)
    torch.cuda.synchronize()
    assert pa.paged_attention.routes == {"split_k": before + 1}
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out, ref, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("tq", [1, 4])
def test_paged_kernel_replays_in_a_cuda_graph(tq):
    """The kernel reads nothing back to the host: captured once in a CUDA
    graph, it replays with the lengths and the tables' contents changed
    in place and matches the plain version on the new operands."""
    q, kp, vp, tab, lens = _paged(seed=3, d=128, tq=tq,
                                  lengths=(37, 9, 130, 16))
    pa.paged_attention(q, kp, vp, tab, lens)          # build, warm up
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    before = pa.paged_attention.launches
    with torch.cuda.graph(graph):
        out = pa.paged_attention(q, kp, vp, tab, lens)
    assert pa.paged_attention.launches == before + 1
    for new_lens in ((100, 33, 7, 61), (4, 130, 130, 17)):
        lens.copy_(torch.tensor(new_lens, dtype=torch.int32))
        tab.copy_(torch.roll(tab, 1, dims=0))
        graph.replay()
        torch.cuda.synchronize()
        ref = pa.paged_attention_plain(q, kp, vp, tab, lens, 128 ** -0.5)
        torch.testing.assert_close(out, ref, rtol=TOL, atol=TOL)


# ---------------------------------------------------------------------------
# the dense arm for shapes the kernels do not instantiate
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("d,dtype", [(80, torch.float32), (96, torch.float32),
                                     (64, torch.float16)])
def test_attention_dense_arm_on_the_card_matches_the_cpu(d, dtype, caplog):
    from tpu_mx_torch.parallel import attention, dispatch_counts
    g = torch.Generator().manual_seed(d)
    q, k, v, do = (torch.randn((2, 3, 50, d), generator=g).to(dtype)
                   for _ in range(4))
    vl = torch.tensor([50, 21], dtype=torch.int32)
    outs = []
    for dev in ("cpu", "cuda"):
        leaves = [x.detach().to(dev).requires_grad_() for x in (q, k, v)]
        launches = fa.flash_attention.launches
        out = attention(*leaves, causal=True, valid_length=vl.to(dev))
        out.backward(do.to(dev))
        assert fa.flash_attention.launches == launches    # no kernel
        outs.append([x.detach().float().cpu()
                     for x in [out] + [x.grad for x in leaves]])
    assert dispatch_counts["dense"] > 0
    # the card's dense arm is a slow path, and says so as the reference's
    assert any("dense O(T^2) arm on the card" in r.getMessage()
               for r in caplog.records if r.levelname == "WARNING")
    tol = 1e-4 if dtype == torch.float32 else 2e-3
    for a, b in zip(*outs):
        torch.testing.assert_close(b, a, rtol=tol, atol=tol)


@pytest.mark.parametrize("d", [320, 384])
def test_card_refuses_head_dims_the_reference_kernel_takes(d):
    """The reference's kernel takes these head dims, and so do the port's
    runtime-D instances: ``attention`` and the serving prefill launch the
    flash kernel on the card (no dense arm), within float32's tolerance
    of the plain version."""
    from tpu_mx_torch.parallel import attention
    q = torch.randn((1, 2, 128, d), device="cuda")
    launches = fa.flash_attention.launches
    out = attention(q, q, q)
    qs = q[0].transpose(0, 1)
    pre = sattn.prefill_attention(qs, qs, qs)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == launches + 2
    ref, _ = fa.flash_attention_plain(q[0], q[0], q[0], 1.0 / math.sqrt(d))
    torch.testing.assert_close(out[0], ref, rtol=1e-4, atol=1e-4)
    assert pre.shape == qs.shape and bool(torch.isfinite(pre).all())


# the kernel phase's tolerances (chip_smoke.py): float32 kernels (3xTF32)
# against the float32 plain version; bf16 outputs, each rounded once,
# within BF16_REL of the largest magnitude of the plain version's
FLASH_ATOL, BF16_REL = 1e-4, 2e-2


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [320, 448, 576, 1024, 2048, 4096, 4608])
def test_split_d_forward_and_dkv_match_their_twins(d, dtype):
    """The runtime-D forward and dk/dv (the split-D design: D over the
    warpgroups of a cluster, the score products summed from slices)
    against the plain twins: causal, ragged kv_valid, dropout 0.1 and a
    bias (one plane a row in bf16, shared in float32).  D = 320 and 448 give
    uneven slices, 2048 the largest cluster (float32 dk/dv: two passes),
    4096 bf16 dk/dv in two passes (float32 in four), 4608 the forward in
    two passes; bf16 runs on wgmma."""
    bh, t = (3, 200) if d < 2048 else (2, 136)
    g = torch.Generator().manual_seed(d)
    q, k, v, do = (torch.randn((bh, t, d), generator=g).to("cuda", dtype)
                   for _ in range(4))
    valid = torch.tensor([t, t // 2 + 7, t - 61][:bh], dtype=torch.int32,
                         device="cuda")
    seed = torch.tensor([d + 11], dtype=torch.int32, device="cuda")
    planes = bh if dtype == torch.bfloat16 else 1
    bias = torch.randn((planes, t, t), generator=g).to("cuda", dtype)
    scale = 1.0 / math.sqrt(d)
    opts = dict(causal=True, kv_valid=valid, dropout_rate=0.1,
                dropout_seed=seed, bias=bias)
    routes = dict(fa.flash_attention.routes), \
        dict(fa.flash_attention_bwd_dkv.routes)
    out, lse = fa.flash_attention(q, k, v, return_lse=True, **opts)
    ref, ref_lse = fa.flash_attention_plain(q, k, v, scale, True, valid,
                                            0.1, seed, bias)
    delta = fa.flash_attention_delta(do, ref)
    args = (q, k, v, do, ref_lse, delta, scale, True, valid, 0.1, seed, bias)
    dk, dv = fa.flash_attention_bwd_dkv(*args)
    want = fa.flash_attention_bwd_plain(*args)
    torch.cuda.synchronize()
    route = "tf32x3" if dtype == torch.float32 else "wgmma"
    assert fa.flash_attention.routes[route] == routes[0][route] + 1
    assert fa.flash_attention_bwd_dkv.routes[route] == routes[1][route] + 1

    def close(got, ref_t):
        atol = FLASH_ATOL if dtype == torch.float32 else \
            BF16_REL * float(ref_t.abs().max())
        err = float((got.float() - ref_t.float()).abs().max())
        assert err <= atol, (err, atol)
    close(out, ref)
    torch.testing.assert_close(lse, ref_lse, rtol=0, atol=FLASH_ATOL)
    close(dk, want[1])
    close(dv, want[2])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kernel", ["fwd", "dkv"])
def test_runtime_d_split_is_the_kernels_own(kernel, dtype):
    """The split each runtime-D library launches with (its split_d,
    slice_of and grid, queried) is runtime_d_split's, at every multiple
    of 64 from 320 to 4608: the host-side rule the CPU tests check is
    the kernels' own."""
    for d in range(320, 4609, 64):
        for rows, bh in ((1, 1), (700, 3), (2048, 65535)):
            assert fa.kernel_split(d, kernel, dtype, rows, bh) == \
                fa.runtime_d_split(d, kernel, dtype, rows, bh), (d, rows)


def test_serving_at_head_dim_80_takes_the_dense_arms_on_the_card():
    from tpu_mx_torch import telemetry
    from tpu_mx_torch.serving import Server, TinyLM
    kw = dict(vocab_size=64, embed_dim=320, num_heads=4, num_layers=2,
              seed=0)
    streams = []
    for dev in ("cpu", "cuda"):
        telemetry.reset()
        flash, paged = fa.flash_attention.launches, pa.paged_attention.launches
        srv = Server(TinyLM(**kw, device=dev), num_blocks=64, device=dev)
        req = srv.submit(list(range(3, 40)), max_new_tokens=8)
        srv.run_until_idle()
        streams.append(req.tokens)
        assert (fa.flash_attention.launches, pa.paged_attention.launches) \
            == (flash, paged)
        assert telemetry.get("serve.decode_attention", kind="dense").value \
            == 2 * telemetry.get("serve.decode_steps").value
    assert streams[0] == streams[1]


def test_serving_features_on_the_card_launch_their_kernels(monkeypatch):
    """Shared prefixes (suffixes dense, full prefills on the flash
    kernel), speculative decoding (the paged kernel at Tq=4 every step)
    and top-k, at head dim 64, against the same server on the CPU."""
    from tpu_mx_torch import telemetry
    from tpu_mx_torch.serving import Server, TinyLM
    kw = dict(vocab_size=64, embed_dim=256, num_heads=4, num_layers=2,
              seed=0)
    tpl = list(range(3, 35))
    prompts = [tpl + [i, i + 1] for i in range(4)]

    def run(dev, **opts):
        telemetry.reset()
        srv = Server(TinyLM(**kw, device=dev), num_blocks=64, block_size=8,
                     device=dev, **opts)
        # the kernel counters count the engine's warm-up launches too:
        # count from here, the serving work alone
        pa.paged_attention.windows = {}
        reqs = [srv.submit(p, max_new_tokens=6, request_id=f"c{i}")
                for i, p in enumerate(prompts)]
        srv.run_until_idle()
        srv.engine.cache.drop_prefix_cache()
        assert srv.engine.cache.allocator.refcounts() == {}
        return [r.tokens for r in reqs]

    for opts in ({"prefix_sharing": True}, {"sampling": "top_k:5"}):
        flash = fa.flash_attention.launches
        assert run("cuda", **opts) == run("cpu", **opts)
        assert fa.flash_attention.launches > flash
    assert telemetry.get("serve.prefill_attention", kind="dense") is None
    run("cuda", prefix_sharing=True)
    assert telemetry.get("serve.prefill_attention", kind="dense").value \
        == 2 * 3
    monkeypatch.setenv("TPUMX_SPECULATIVE", "4")
    card = run("cuda")
    steps = telemetry.get("serve.decode_steps").value
    assert pa.paged_attention.windows == {4: 2 * steps}
    assert card == run("cpu")


# -- the ResNet slice on the card -------------------------------------------------
def _thin_resnet(block, device, params=None):
    from tpu_mx_torch import layout
    from tpu_mx_torch.gluon.model_zoo import vision
    cls = {"basic": vision.BasicBlockV1,
           "bottleneck": vision.BottleneckV1}[block]
    args = (cls, [1, 1, 1, 1], [8, 16, 32, 64, 128])
    if params is not None:
        return vision.ResNetV1.from_numpy(params, *args, classes=10,
                                          stem="s2d", layout="NHWC",
                                          device=device)
    gen = torch.Generator(device=device).manual_seed(0)
    with layout.default_layout("NHWC"):
        net = vision.ResNetV1(*args, classes=10, stem="s2d", device=device,
                              generator=gen)
    return net.initialize("xavier", gen)


def _sgd_step(net, device, learning_rate=0.1, **kw):
    from tpu_mx_torch import optimizer
    from tpu_mx_torch.gluon import loss
    from tpu_mx_torch.parallel import CompiledTrainStep
    return CompiledTrainStep(net, loss.SoftmaxCrossEntropyLoss(),
                             optimizer.create("sgd",
                                              learning_rate=learning_rate,
                                              momentum=0.9, wd=1e-4, **kw),
                             device=device)


@pytest.mark.parametrize("block", ["basic", "bottleneck"])
def test_thin_resnet_step_on_the_card_matches_the_cpu(block, monkeypatch):
    """Three float32 SGD steps of a thin channels-last ResNetV1 on the
    card and on the CPU from one weight set: losses within 1e-4, every
    weight's and running statistic's change within 1e-2 in norm; a conv
    bias in front of a BatchNorm gets no gradient in exact arithmetic,
    so its change is rounding, held within 1e-5 absolute.  Batch 8:
    there float32 keeps to float64 within 2e-5 in the losses."""
    # the CPU's oneDNN channels-last 1x1 stride-2 backward corrupts
    # memory at some small shapes (torch 2.13); use the native one
    monkeypatch.setattr(torch.backends.mkldnn, "enabled", False)
    cpu = _thin_resnet(block, "cpu")
    before = {n: t.detach().clone() for n, t in cpu.collect_params().items()}
    gpu = _thin_resnet(block, "cuda", params={
        n: (t.permute(0, 2, 3, 1) if t.dim() == 4 else t).numpy()
        for n, t in before.items()})
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.rand(8, 64, 64, 3).astype(np.float32))
    label = torch.from_numpy(rng.randint(0, 10, 8).astype(np.float32))
    losses = []
    for net, dev in ((cpu, "cpu"), (gpu, "cuda")):
        step = _sgd_step(net, dev)
        losses.append([float(step.step(x.to(dev), label.to(dev)))
                       for _ in range(3)])
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-4)
    on_card = gpu.collect_params()
    for n, t in cpu.collect_params().items():
        d_cpu = t.detach() - before[n]
        d_gpu = on_card[n].detach().cpu() - before[n]
        assert float((d_gpu - d_cpu).norm()) \
            <= 1e-2 * float(d_cpu.norm()) + 1e-5, n


def test_resnet_activations_and_weights_stay_channels_last_on_the_card():
    """Every convolution of a channels-last net sees and returns
    channels-last tensors, and its weight keeps channels-last strides
    through a bf16 step with float32 masters."""
    from tpu_mx_torch.gluon import nn
    net = _thin_resnet("bottleneck", "cuda").cast("bfloat16")
    convs = [m for m in net.modules() if isinstance(m, nn.Conv2D)]
    seen = []
    hooks = [c.register_forward_hook(lambda m, args, out: seen.append((
        args[0].permute(0, 3, 1, 2).is_contiguous(
            memory_format=torch.channels_last),
        out.permute(0, 3, 1, 2).is_contiguous(
            memory_format=torch.channels_last)))) for c in convs]
    step = _sgd_step(net, "cuda", multi_precision=True)
    x = torch.rand((4, 64, 64, 3), device="cuda").to(torch.bfloat16)
    step.step(x, torch.tensor([1.0, 2.0, 3.0, 4.0], device="cuda"))
    for h in hooks:
        h.remove()
    assert len(seen) == len(convs) and all(a and b for a, b in seen)
    for c in convs:
        assert c.weight.is_contiguous(memory_format=torch.channels_last)
    assert all(m.is_contiguous(memory_format=torch.channels_last)
               for m in step.masters.values() if m.dim() == 4)


def test_bf16_resnet18_step_at_64_is_finite_and_falls():
    """The reference benchmark's smoke net (ResNet-18, 100 classes,
    64x64): five bf16 SGD steps on one batch, losses finite and falling.
    lr 0.01: at the recipe's 0.1 five steps on one small batch oscillate,
    in float32 on the CPU as well."""
    from tpu_mx_torch import layout
    from tpu_mx_torch.gluon.model_zoo import vision
    gen = torch.Generator(device="cuda").manual_seed(0)
    with layout.default_layout("NHWC"):
        net = vision.resnet18_v1(classes=100, stem="s2d", generator=gen)
    net.initialize("xavier", gen).cast("bfloat16")
    step = _sgd_step(net, "cuda", learning_rate=0.01, multi_precision=True)
    x = torch.rand((16, 64, 64, 3), generator=gen, device="cuda") \
        .to(torch.bfloat16)
    label = torch.randint(0, 100, (16,), generator=gen, device="cuda").float()
    losses = [float(step.step(x, label)) for _ in range(5)]
    assert all(math.isfinite(v) for v in losses)
    assert losses[-1] < losses[0]


# -- the PTB LSTM slice on the card ------------------------------------------------
def _rnn_case(mode, layers, bi, dtype, seed=0, t=7, n=5, i=12, h=16):
    from tpu_mx_torch.ndarray import rnn_op
    g = torch.Generator().manual_seed(seed)
    d = 2 if bi else 1
    size = rnn_op.rnn_param_size(mode, i, h, layers, bi)
    ws = rnn_op.unpack(torch.randn(size, generator=g) * 0.3, mode, i, h,
                       layers, bi)
    x = torch.rand((t, n, i), generator=g)
    st = [torch.randn((layers * d, n, h), generator=g) * 0.5
          for _ in range(2 if mode == "lstm" else 1)]
    return [x.to("cuda", dtype) for x in (x, *st, *ws)], len(st)


def _rnn_run(mode, layers, bi, arm, tensors, ns):
    """out, hN and the gradients of x and the weights, by ``arm``."""
    from tpu_mx_torch.ndarray import rnn_op
    leaves = [t.detach().clone().requires_grad_()
              for t in (tensors[0], *tensors[1 + ns:])]
    out, h, _ = rnn_op.recurrence(mode, leaves[0], tensors[1:1 + ns],
                                  leaves[1:], layers, bi, arm=arm)
    loss = out.float().square().sum() + h.float().sum()
    return [out, h, *torch.autograd.grad(loss, leaves)]


def _within(results, ref, share):
    for a, b in zip(results, ref):
        a, b = a.float(), b.float()
        torch.testing.assert_close(a, b, rtol=0, atol=share * max(
            1.0, float(b.abs().max())))


@pytest.mark.parametrize("mode,layers,bi", [
    ("lstm", 2, False), ("lstm", 1, True), ("gru", 2, True),
    ("rnn_tanh", 2, False), ("rnn_relu", 1, True)])
def test_fused_arm_matches_the_scan_arm_on_the_card(mode, layers, bi):
    """float32: the fused arm (cuDNN's RNN: ATen takes cuDNN for float32
    and bfloat16 alike) against the plain scan arm on the same card,
    outputs and gradients within 1e-4 of max(1, max|ref|) (both IEEE:
    ``device.resolve`` turns TF32 off)."""
    from tpu_mx_torch import device as tdevice
    tdevice.resolve("cuda")
    tensors, ns = _rnn_case(mode, layers, bi, torch.float32)
    for dtype in (torch.float32, torch.bfloat16):
        assert torch.cudnn_is_acceptable(torch.empty(1, dtype=dtype,
                                                     device="cuda"))
    _within(_rnn_run(mode, layers, bi, "fused", tensors, ns),
            _rnn_run(mode, layers, bi, "scan", tensors, ns), 1e-4)


@pytest.mark.parametrize("mode,layers,bi", [("lstm", 2, False),
                                            ("gru", 2, True)])
def test_bf16_arms_stay_near_float32_on_the_card(mode, layers, bi):
    """bfloat16: both arms (the fused one on cuDNN) round each step's
    state to bfloat16; each is held to the float32 scan of
    the same (bfloat16-valued) inputs within 2e-2 of max(1, max|ref|),
    outputs and gradients (on the CPU: 7.1e-3 and 1.35e-2 at most)."""
    tensors, ns = _rnn_case(mode, layers, bi, torch.bfloat16)
    ref = _rnn_run(mode, layers, bi, "scan", [t.float() for t in tensors],
                   ns)
    for arm in ("scan", "fused"):
        _within(_rnn_run(mode, layers, bi, arm, tensors, ns), ref, 2e-2)


def _flat_ce():
    """The word-LM benchmark's loss: ``(T·N, V)`` logits upcast to
    float32, softmax cross-entropy."""
    from tpu_mx_torch.gluon import loss as tloss

    class FlatCE(tloss.Loss):
        def __init__(self):
            super().__init__(weight=None, batch_axis=0)
            self._ce = tloss.SoftmaxCrossEntropyLoss()

        def forward(self, logits, labels):
            return self._ce(logits.reshape(-1, logits.shape[-1]).float(),
                            labels.reshape(-1))
    return FlatCE()


def test_thin_lstm_lm_step_on_the_card_matches_the_cpu():
    """Three float32 SGD steps (lr 1.0, the recipe's) of a thin 2-layer
    LSTM word-LM through ``CompiledTrainStep`` on the card (the fused
    arm, cuDNN) and on the CPU (the scan arm) from one weight set:
    logits within 2e-4, losses within 1e-4, each tensor's change within
    1e-2 in norm."""
    from tpu_mx_torch import optimizer, telemetry
    from tpu_mx_torch.models import RNNModel
    from tpu_mx_torch.parallel import CompiledTrainStep

    cfg = dict(vocab_size=100, num_embed=24, num_hidden=24, num_layers=2,
               dropout=0.0)
    cpu = RNNModel("lstm", device="cpu",
                   generator=torch.Generator().manual_seed(0), **cfg)
    cpu.initialize("xavier", torch.Generator().manual_seed(1))
    before = {n: t.detach().clone() for n, t in cpu.collect_params().items()}
    gpu = RNNModel.from_numpy({n: t.numpy() for n, t in before.items()},
                              "lstm", device="cuda", **cfg)
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randint(0, 100, (10, 6)).astype(np.float32))
    y = torch.from_numpy(rng.randint(0, 100, (60,)).astype(np.float32))
    with torch.no_grad():
        logits = [n.eval()(x.to(d)).cpu() for n, d in ((cpu, "cpu"),
                                                        (gpu, "cuda"))]
    torch.testing.assert_close(logits[1], logits[0], rtol=0, atol=2e-4)
    fused = telemetry.counter("rnn.arm", kind="fused").value
    losses = []
    for net, dev in ((cpu, "cpu"), (gpu, "cuda")):
        step = CompiledTrainStep(net, _flat_ce(), optimizer.create(
            "sgd", learning_rate=1.0), device=dev)
        losses.append([float(step.step(x.to(dev), y.to(dev)))
                       for _ in range(3)])
    assert telemetry.counter("rnn.arm", kind="fused").value == fused + 3
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-4)
    on_card = gpu.collect_params()
    for n, t in cpu.collect_params().items():
        d_cpu = t.detach() - before[n]
        d_gpu = on_card[n].detach().cpu() - before[n]
        assert float((d_gpu - d_cpu).norm()) <= 1e-2 * float(d_cpu.norm()), n


def test_bf16_lstm_lm_losses_fall_on_the_card():
    """A thin bf16 LSTM word-LM (f32 masters, SGD lr 1.0): six steps on
    one batch, losses finite and falling, every parameter bfloat16."""
    from tpu_mx_torch import optimizer
    from tpu_mx_torch.models import RNNModel
    from tpu_mx_torch.parallel import CompiledTrainStep
    gen = torch.Generator(device="cuda").manual_seed(0)
    net = RNNModel("lstm", 500, 64, 64, 2, dropout=0.0, generator=gen)
    net.initialize("xavier", gen).cast("bfloat16")
    step = CompiledTrainStep(
        net, _flat_ce(),
        optimizer.create("sgd", learning_rate=1.0, multi_precision=True))
    x = torch.randint(0, 500, (20, 32), generator=gen, device="cuda").float()
    y = torch.randint(0, 500, (640,), generator=gen, device="cuda").float()
    losses = [float(step.step(x, y)) for _ in range(6)]
    assert all(math.isfinite(v) for v in losses)
    assert losses[-1] < losses[0]
    assert all(p.dtype == torch.bfloat16 for p in net.parameters())


# -- the SSD slice ------------------------------------------------------------------
def test_pick_takes_ignore_labels_on_the_card():
    """Indices -1 (the last class) and out of range (NaN, no gradient)
    neither raise nor assert on the card, and match the CPU."""
    from tpu_mx_torch.ndarray import ops
    x = torch.randn(6, 5, generator=torch.Generator().manual_seed(0))
    idx = torch.tensor([-1.0, 0.0, 4.0, 5.0, -5.0, -6.0])
    out = {}
    for dev in ("cpu", "cuda"):
        xd = x.to(dev, copy=True).requires_grad_()
        y = ops.pick(xd, idx.to(dev))
        torch.where(torch.isnan(y), 0.0, y * 2).sum().backward()
        out[dev] = (y.detach().cpu(), xd.grad.cpu())
    torch.cuda.synchronize()
    assert torch.isnan(out["cuda"][0]).tolist() == [False] * 3 + [True, False,
                                                                  True]
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], equal_nan=True)
    torch.testing.assert_close(out["cuda"][1], out["cpu"][1])


def _ssd_target_case():
    """A shared best anchor, a padded row after a valid one and class
    scores rounded through bf16 (tied hardness)."""
    anc = torch.tensor([[[0.0, 0.0, 0.2, 0.2], [0.3, 0.3, 0.6, 0.6],
                         [0.7, 0.7, 0.9, 0.9]]])
    g = torch.Generator().manual_seed(3)
    p = torch.rand(60, 2, 2, generator=g).sort(1).values
    anc = torch.cat([anc, p.transpose(1, 2).reshape(1, 60, 4)], 1)
    lab = torch.full((4, 3, 5), -1.0)
    lab[:, 0] = torch.tensor([0, 0.25, 0.25, 0.55, 0.7])
    lab[:, 1] = torch.tensor([2, 0.3, 0.3, 0.62, 0.6])
    lab[1, 1] = -1                                  # padded after a valid
    lab[2, 2] = torch.tensor([1, 0.1, 0.1, 0.4, 0.45])
    pred = (torch.randn(4, 4, 63, generator=g) * 2).round() / 2
    return anc, lab, pred.bfloat16().float()


@pytest.mark.parametrize("mining", [-1.0, 3.0])
def test_multibox_target_on_the_card_equals_the_cpu(mining):
    """Equal masks and class targets, location targets within 1e-6, and
    no host synchronization on the card."""
    from tpu_mx_torch.ndarray import contrib
    kw = dict(negative_mining_ratio=mining, minimum_negative_samples=4)
    case = _ssd_target_case()
    cpu = contrib.MultiBoxTarget(*case, **kw)
    args = [t.cuda() for t in case]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        card = contrib.MultiBoxTarget(*args, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    card = [t.cpu() for t in card]
    torch.testing.assert_close(card[0], cpu[0], rtol=0, atol=1e-6)
    assert torch.equal(card[1], cpu[1])
    assert torch.equal(card[2], cpu[2])
    assert cpu[2][0, 1] == 3.0                 # the later box's write stands


def _ssd_train_block(net):
    from tpu_mx_torch.gluon import loss
    from tpu_mx_torch.gluon.block import HybridBlock
    from tpu_mx_torch.models import SSDTrainingTargets

    class SSDTrain(HybridBlock):
        def __init__(self):
            super().__init__()
            self.net = net
            self._targets = SSDTrainingTargets()
            self._cls = loss.SoftmaxCrossEntropyLoss()
            self._box = loss.HuberLoss()

        def forward(self, x, labels):
            anchors, cls_preds, box_preds = (t.float() for t in self.net(x))
            with torch.no_grad():
                loc_t, loc_m, cls_t = self._targets(anchors, labels,
                                                    cls_preds)
            return self._cls(cls_preds, cls_t) + \
                self._box(box_preds * loc_m, loc_t * loc_m)
    return SSDTrain()


_SSD_SMOKE = dict(num_classes=3, sizes=[[0.2, 0.35], [0.5, 0.7]],
                  ratios=[[1, 2, 0.5]] * 2, base_filters=(8, 16))


def _ssd_batch(batch, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.uniform(0, 0.1, (batch, 3, 64, 64)).astype(np.float32)
    labels = np.full((batch, 2, 5), -1.0, np.float32)
    for b in range(batch):
        x0, y0 = rng.uniform(0.05, 0.5, 2)
        labels[b, 0] = [rng.randint(0, 3), x0, y0, x0 + 0.3, y0 + 0.3]
    return torch.from_numpy(x), torch.from_numpy(labels)


def test_thin_ssd_step_on_the_card_matches_the_cpu(monkeypatch):
    """Three float32 SGD steps of the benchmark's SSD objective on the
    smoke SSD, card against CPU from one weight set: heads within 2e-4,
    losses within 1e-4."""
    from tpu_mx_torch import optimizer
    from tpu_mx_torch.gluon import loss
    from tpu_mx_torch.models import SSD
    from tpu_mx_torch.parallel import CompiledTrainStep
    monkeypatch.setattr(torch.backends.mkldnn, "enabled", False)
    cpu = SSD(device="cpu", generator=torch.Generator().manual_seed(0),
              **_SSD_SMOKE)
    cpu.initialize("xavier", torch.Generator().manual_seed(1))
    gpu = SSD.from_numpy({n: t.detach().numpy()
                          for n, t in cpu.collect_params().items()},
                         device="cuda", **_SSD_SMOKE)
    assert gpu.cls_heads[0].weight.is_contiguous(
        memory_format=torch.channels_last)
    x, labels = _ssd_batch(4)
    with torch.no_grad():
        heads = [[t.cpu() for t in n.eval()(x.to(d))]
                 for n, d in ((cpu, "cpu"), (gpu, "cuda"))]
    for a, b in zip(*heads):
        torch.testing.assert_close(b, a, rtol=0, atol=2e-4)
    losses = []
    for net, dev in ((cpu, "cpu"), (gpu, "cuda")):
        step = CompiledTrainStep(_ssd_train_block(net), loss.PassThrough(),
                                 optimizer.create("sgd", learning_rate=0.01,
                                                  momentum=0.9, wd=5e-4),
                                 device=dev)
        losses.append([float(step.step(x.to(dev), labels.to(dev),
                                        torch.zeros(1, device=dev)))
                       for _ in range(3)])
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-4)


def test_bf16_ssd_losses_fall_on_the_card():
    """The smoke SSD in bf16 (f32 masters, momentum SGD): six steps on
    one batch, losses finite and falling, every parameter bfloat16, and
    ``detect`` gives finite kept rows."""
    from tpu_mx_torch import optimizer
    from tpu_mx_torch.gluon import loss
    from tpu_mx_torch.models import SSD
    from tpu_mx_torch.parallel import CompiledTrainStep
    gen = torch.Generator(device="cuda").manual_seed(0)
    net = SSD(device="cuda", generator=gen, **_SSD_SMOKE)
    net.initialize("xavier", gen).cast("bfloat16")
    step = CompiledTrainStep(
        _ssd_train_block(net), loss.PassThrough(),
        optimizer.create("sgd", learning_rate=0.01, momentum=0.9, wd=5e-4,
                         multi_precision=True), device="cuda")
    x, labels = _ssd_batch(8, seed=1)
    x, labels = x.cuda().bfloat16(), labels.cuda()
    losses = [float(step.step(x, labels, torch.zeros(1, device="cuda")))
              for _ in range(6)]
    assert all(math.isfinite(v) for v in losses)
    assert losses[-1] < losses[0]
    assert all(p.dtype == torch.bfloat16 for p in net.parameters())
    det = net.detect(x[:2])
    kept = det[det[..., 0] >= 0]
    assert det.shape == (2, 1280, 6) and kept.shape[0] > 0
    assert bool(torch.isfinite(kept).all())


# -- the imperative surface on the card ---------------------------------------
def _mnist(n=32, seed=0):
    rng = np.random.RandomState(seed)
    y = rng.randint(0, 10, n)
    x = rng.rand(n, 1, 28, 28).astype(np.float32) * 0.1
    for i, lbl in enumerate(y):
        x[i, 0, lbl * 2:lbl * 2 + 4, 4:24] += 0.9
    return x, y.astype(np.float32)


def test_arrays_default_to_the_card_and_take_gradients_there():
    from tpu_mx_torch import autograd, gpu, nd
    x = nd.array(np.arange(6, dtype=np.float32).reshape(2, 3))
    assert x.context == gpu(0) and x._data.is_cuda
    assert nd.zeros((2,)).context == gpu(0)
    x.attach_grad()
    with autograd.record():
        y = (nd.exp(x) * 2).sum()
    y.backward()
    np.testing.assert_allclose(x.grad.asnumpy(), 2 * np.exp(x.asnumpy()),
                               rtol=1e-6)
    assert nd.random.uniform(shape=(4,)).context == gpu(0)


def test_imperative_lenet_steps_on_the_card_match_the_cpu():
    import tpu_mx_torch as mx
    from tpu_mx_torch import autograd, gluon, nd
    from tpu_mx_torch.models.lenet import lenet
    torch.backends.cudnn.allow_tf32 = False
    x, y = _mnist()
    runs, start = {}, None
    for ctx in (mx.cpu(), mx.gpu(0)):
        with ctx:
            net = lenet(10)
            net.initialize(init="xavier")
            net(nd.array(x[:2]))
            params = net.collect_params()
            if start is None:
                start = {k: p.data().asnumpy() for k, p in params.items()}
            else:
                for k, p in params.items():
                    p.set_data(start[k])
            trainer = gluon.Trainer(params, "sgd", {"learning_rate": 0.05,
                                                    "momentum": 0.9})
            loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
            losses = []
            for _ in range(3):
                with autograd.record():
                    loss = loss_fn(net(nd.array(x)), nd.array(y))
                loss.backward()
                trainer.step(len(x))
                losses.append(float(loss.mean().asscalar()))
            runs[ctx.kind] = (losses, {k: p.data().asnumpy()
                                       for k, p in params.items()})
    np.testing.assert_allclose(runs["gpu"][0], runs["cpu"][0], rtol=1e-4)
    for k, w in runs["cpu"][1].items():
        d_cpu, d_gpu = w - start[k], runs["gpu"][1][k] - start[k]
        assert np.linalg.norm(d_gpu - d_cpu) <= 1e-2 * np.linalg.norm(d_cpu)


def test_imperative_bert_step_runs_the_flash_kernels():
    from tpu_mx_torch import autograd, gluon, nd
    from tpu_mx_torch.models import BERTModel, MLMLoss, bert_base_config
    cfg = dict(bert_base_config(vocab_size=1000, max_len=128),
               num_layers=2, units=128, hidden_size=256, num_heads=2)
    net = BERTModel(cfg, dtype="bfloat16", device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(0))
    trainer = gluon.Trainer(net.collect_params(), "lamb",
                            {"learning_rate": 1e-3, "multi_precision": True})
    rng = np.random.RandomState(0)
    tokens = rng.randint(4, 1000, (4, 128)).astype(np.int32)
    valid = np.array([128, 100, 77, 128], np.int32)
    pos = np.stack([rng.choice(n, 19, replace=False)
                    for n in valid]).astype(np.int32)
    labels = np.take_along_axis(tokens, pos, axis=1)
    args = [nd.array(a) for a in (tokens, np.zeros_like(tokens), valid, pos)]
    before = (fa.flash_attention.launches, fa.flash_attention_bwd_dq.launches,
              fa.flash_attention_bwd_dkv.launches)
    with autograd.record():
        loss = MLMLoss()(net(*args), nd.array(labels))
    loss.backward()
    trainer.step(4)
    after = (fa.flash_attention.launches, fa.flash_attention_bwd_dq.launches,
             fa.flash_attention_bwd_dkv.launches)
    assert [a - b for a, b in zip(after, before)] == [2, 2, 2]
    assert np.isfinite(loss.asnumpy()).all()
    p = next(iter(net.collect_params().values()))
    assert p.dtype == torch.bfloat16 and p.grad._data.is_cuda


def test_rtc_launch_takes_arrays_on_the_card():
    from tpu_mx_torch import nd
    mod = rtc.CudaModule('extern "C" __global__ void scale(const float* x, '
                         'float* y, float alpha, int n) { int i = '
                         'blockIdx.x * blockDim.x + threadIdx.x; '
                         'if (i < n) y[i] = x[i] * alpha; }')
    x = nd.array(np.random.RandomState(0).randn(1000).astype(np.float32))
    y = mod.get_kernel("scale", alpha=3.0).launch((x,))
    assert isinstance(y, nd.NDArray) and y._data.is_cuda
    assert torch.equal(y._data, x._data * 3.0)


# ---------------------------------------------------------------------------
# serving's recovery plane on the card
# ---------------------------------------------------------------------------
def test_engine_warm_batch_launches_both_kernels_at_construction():
    from tpu_mx_torch.serving import EngineCore, TinyLM
    model = TinyLM(vocab_size=64, embed_dim=256, num_heads=2, num_layers=2,
                   device="cuda")
    fa.flash_attention.launches = pa.paged_attention.launches = 0
    eng = EngineCore(model, num_blocks=64, warm_batch=4)
    torch.cuda.synchronize()
    assert eng.warmed and eng.warm_batch == 4
    assert fa.flash_attention.launches == 2
    assert pa.paged_attention.launches == 2
    assert eng.cache.audit()["used_blocks"] == 0


def test_watchdog_restart_on_the_card_keeps_the_streams(tmp_path):
    from tpu_mx_torch import tracing
    from tpu_mx_torch.contrib import chaos
    from tpu_mx_torch.serving import Server, TinyLM
    model = TinyLM(vocab_size=64, embed_dim=256, num_heads=2, num_layers=2,
                   device="cuda")
    prompts = ([1, 2, 3], [4, 5, 6, 7], [8] * 20)

    def run(**kw):
        srv = Server(model, num_blocks=64, backoff=0.0, **kw)
        reqs = [srv.submit(p, 8, request_id=f"r{i}")
                for i, p in enumerate(prompts)]
        srv.step()
        with chaos.enable(slow_decode_step=1, slow_decode_seconds=1.0):
            srv.run_until_idle()
        return srv, [list(r.tokens) for r in reqs]

    clean = Server(model, num_blocks=64)
    want = [clean.submit(p, 8, request_id=f"r{i}")
            for i, p in enumerate(prompts)]
    clean.run_until_idle()
    srv, got = run(deadline=0.5, blackbox=str(tmp_path / "bb"))
    assert srv.restarts == 1 and srv.generation == 1
    assert len(got) == 3 and all(len(t) == 8 for t in got)
    tracing.validate_blackbox(json.loads(
        (tmp_path / "bb-blackbox.json").read_text()))
    assert got[0][:1] == want[0].tokens[:1]


# -- the vision zoo's data and weights on the card --------------------------------
def test_device_prefetch_orders_the_consumer_after_its_side_stream_copy():
    """``DevicePrefetchIter`` copies each batch from pinned memory on a
    side stream; the consumer's stream waits on its event, so reading
    the batch right away sees the whole copy, normalized in float32 and
    then cast, and each tensor is held for the consumer's stream."""
    from tpu_mx_torch import io
    from tpu_mx_torch.context import cpu
    x = np.random.RandomState(0).rand(64, 32, 32, 3).astype(np.float32) * 255
    y = np.arange(64).astype(np.float32)
    with cpu():
        src = io.NDArrayIter(x, y, batch_size=16)
    mean, std = (123.68, 116.78, 103.94), (58.39, 57.12, 57.37)
    it = io.DevicePrefetchIter(src, depth=2, cast_data="bfloat16",
                               normalize=(mean, std))
    assert it._dev.type == "cuda" and it._stream is not None
    for i, batch in enumerate(it):
        d = batch.data[0]._data
        assert d.device.type == "cuda" and d.dtype == torch.bfloat16
        torch.cuda._sleep(10_000_000)        # keep the consumer's stream busy
        want = ((torch.from_numpy(x[16 * i:16 * (i + 1)]) -
                 torch.tensor(mean)) / torch.tensor(std)).to(torch.bfloat16)
        assert torch.equal(d.cpu(), want)
        assert torch.equal(batch.label[0]._data.cpu(),
                           torch.from_numpy(y[16 * i:16 * (i + 1)]))
    assert i == 3
    it.close()


def test_bf16_zoo_params_from_the_card_load_bit_equal_on_the_cpu(tmp_path):
    from tpu_mx_torch import layout, nd
    from tpu_mx_torch.context import cpu
    from tpu_mx_torch.gluon.model_zoo import vision
    with layout.default_layout("NHWC"):
        net = vision.mobilenet_v2_0_25(classes=10)
    net.initialize("xavier")
    net(nd.array(np.zeros((2, 64, 64, 3), np.float32)))
    net.cast("bfloat16")
    f = str(tmp_path / "net.params")
    net.save_parameters(f)
    with cpu(), layout.default_layout("NHWC"):
        host = vision.mobilenet_v2_0_25(classes=10)
        host.initialize()
        host.load_parameters(f)
    for (k, a), b in zip(net._collect_params_with_prefix().items(),
                         host._collect_params_with_prefix().values()):
        assert b.dtype == torch.bfloat16, k
        assert torch.equal(a._ref_view().cpu(), b._ref_view()), k


@pytest.mark.parametrize("count_include_pad", [True, False])
@pytest.mark.parametrize("stride", [1, 2])
def test_padded_average_pool_gradient_on_the_card_equals_the_cpu(
        stride, count_include_pad):
    """PyTorch's CUDA average-pool backward of a channels-last input with
    padding is wrong (torch 2.11); the port's ``Pooling`` pads a copy, so
    Inception's ``AvgPool2D(3, 1, 1)`` trains alike on the card."""
    from tpu_mx_torch.ndarray import ops
    x = torch.randn((2, 9, 11, 16), generator=torch.Generator().manual_seed(0))
    w = torch.randn((2, (9 + 2 - 3) // stride + 1, (11 + 2 - 3) // stride + 1,
                     16), generator=torch.Generator().manual_seed(1))
    grads = []
    for dev in ("cpu", "cuda"):
        xi = x.to(dev).requires_grad_()
        y = ops.Pooling(xi, kernel=(3, 3), pool_type="avg", stride=(stride,) * 2,
                        pad=(1, 1), count_include_pad=count_include_pad,
                        layout="NHWC")
        (g,) = torch.autograd.grad(y, xi, w.to(dev))
        grads.append(g.cpu())
    assert torch.allclose(grads[1], grads[0], rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# int8 products and the decode arms on the card
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("m,k,n", [(3, 147, 64), (401, 576, 64),
                                   (17, 4608, 512)])
def test_int8_matmul_on_the_card_is_the_cpus_exactly(m, k, n):
    from tpu_mx_torch.ndarray import quantized_ops as qops
    g = torch.Generator().manual_seed(m)
    a = torch.randint(-127, 128, (m, k), generator=g, dtype=torch.int8)
    b = torch.randint(-127, 128, (n, k), generator=g, dtype=torch.int8)
    got = qops.int8_matmul(a.cuda(), b.cuda())
    assert got.dtype == torch.int32 and got.shape == (m, n)
    assert torch.equal(got.cpu(), qops.int8_matmul(a, b))


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
def test_quantized_conv_on_the_card_is_the_cpus_exactly(layout):
    from tpu_mx_torch.ndarray import quantized_ops as qops
    g = torch.Generator().manual_seed(3)
    shape = (2, 16, 9, 9) if layout == "NCHW" else (2, 9, 9, 16)
    wshape = (24, 8, 3, 3) if layout == "NCHW" else (24, 3, 3, 8)
    x = torch.randint(-127, 128, shape, generator=g, dtype=torch.int8)
    w = torch.randint(-127, 128, wshape, generator=g, dtype=torch.int8)
    kw = dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), num_group=2,
              num_filter=24, layout=layout)
    got = qops.quantized_conv(x.cuda(), w.cuda(), None, -1.0, 1.0, -1.0,
                              1.0, **kw)[0]
    want = qops.quantized_conv(x, w, None, -1.0, 1.0, -1.0, 1.0, **kw)[0]
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("paged,fused", [("0", "0"), ("1", "0"),
                                         ("kernel", "1"), ("1", "1")])
def test_every_decode_arm_on_the_card_serves_the_cpus_streams(
        monkeypatch, paged, fused):
    from tpu_mx_torch import telemetry
    from tpu_mx_torch.serving import Server, TinyLM
    monkeypatch.setenv("TPUMX_PAGED_DECODE", paged)
    monkeypatch.setenv("TPUMX_FUSED_DECODE", fused)
    monkeypatch.setenv("TPUMX_SELF_CHECK", "1.0")
    kw = dict(vocab_size=64, embed_dim=256, num_heads=2, num_layers=2,
              seed=0)
    streams = []
    for dev in ("cpu", "cuda"):
        telemetry.reset()
        launches = pa.paged_attention.launches
        srv = Server(TinyLM(**kw, device=dev), num_blocks=64, device=dev)
        req = srv.submit(list(range(3, 40)), max_new_tokens=8)
        srv.run_until_idle()
        streams.append(req.tokens)
        assert telemetry.get("integrity.self_check_mismatches") is None
        if dev == "cuda":
            ran = pa.paged_attention.launches - launches
            assert (ran == 0) == (paged == "0")
    assert streams[0] == streams[1]


def test_float32_syevd_on_the_card_is_as_accurate_as_the_hosts():
    """``nd.linalg_syevd`` and ``mx.np.linalg.eigh`` of float32 on the
    card solve in float64 (cuSOLVER's float32 eigensolver is far less
    accurate): the eigenvalues within 1e-5·max|λ| of float64, the
    reconstruction within n·eps·max|λ|."""
    import tpu_mx_torch as mx
    from tpu_mx_torch import nd
    g = torch.Generator(device="cuda").manual_seed(1)
    a = torch.randn((4, 512, 512), generator=g, device="cuda")
    a = (a + a.mT) / 2
    w64 = torch.linalg.eigvalsh(a.double())
    u, lam = nd.linalg_syevd(a)
    scale = float(w64.abs().max())
    assert lam.dtype == u.dtype == torch.float32
    assert float((lam.double() - w64).abs().max()) <= 1e-5 * scale
    rec = u.mT @ (lam[..., None] * u)
    assert float((rec - a).abs().max()) <= 512 * 1.2e-7 * scale
    w, _ = mx.np.linalg.eigh(a)
    assert float((w.double() - w64).abs().max()) <= 1e-5 * scale


@pytest.mark.parametrize("d", [192, 256])
def test_f32_wide_backward_holds_the_twin_within_tol(d):
    """The float32 dq, dk, dv and d_bias at the wide head dims within TOL
    of the plain twin on the same inputs (ROADMAP B item 8c: the score
    products summed a k-step apart): a per-row float32 bias, causal,
    ragged valid lengths, dropout 0.1, T = 136 (a partial tile)."""
    g = torch.Generator().manual_seed(d)
    b, h, t = 2, 2, 136
    bh, scale, rate = b * h, 1.0 / math.sqrt(d), 0.1
    q, k, v, do = (torch.randn((bh, t, d), generator=g).cuda()
                   for _ in range(4))
    bias = torch.randn((bh, t, t), generator=g).cuda()
    kv = torch.randint(t // 2, t + 1, (b,), generator=g,
                       dtype=torch.int32).repeat_interleave(h).cuda()
    seed = torch.tensor([20261018], dtype=torch.int32, device="cuda")
    ref, lse = fa.flash_attention_plain(q, k, v, scale, True, kv, rate, seed,
                                        bias)
    args = (q, k, v, do, lse, fa.flash_attention_delta(do, ref), scale,
            True, kv, rate, seed, bias)
    dq, d_bias = fa.flash_attention_bwd_dq(*args, want_d_bias=True)
    dk, dv = fa.flash_attention_bwd_dkv(*args)
    want = fa.flash_attention_bwd_plain(*args)
    for name, got, w in zip(("dq", "dk", "dv", "d_bias"),
                            (dq, dk, dv, d_bias), want):
        err = float((got - w).abs().max())
        assert err <= TOL, (name, err)
