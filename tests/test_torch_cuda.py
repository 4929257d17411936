"""The port's CUDA kernels on the card, against their plain versions.

Needs a CUDA card and ``nvcc``; every test here is marked ``cuda`` and
skips without a card.  The file imports neither jax nor ``tpu_mx``, so
it also runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""
import math

import numpy as np
import pytest
import torch

from tpu_mx_torch.base import MXNetError
from tpu_mx_torch.kernels import flash_attention as fa
from tpu_mx_torch.kernels import paged_attention as pa

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
    q, kp, vp, tab, lens = _paged(d=64)
    with pytest.raises(MXNetError, match="head_dim"):
        pa.paged_attention(q[..., :48].contiguous(), kp[..., :48],
                           vp[..., :48], tab, lens)
    with pytest.raises(MXNetError, match="window"):
        pa.paged_attention(torch.zeros((4, 9, 4, 64), device="cuda"),
                           kp, vp, tab, torch.full_like(lens, 200))


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


def test_flash_kernel_refuses_bf16():
    q = torch.zeros((2, 64, 64), device="cuda", dtype=torch.bfloat16)
    with pytest.raises(MXNetError, match="float32"):
        fa.flash_attention(q, q, q)


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
