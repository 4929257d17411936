#!/usr/bin/env python3
"""Time the attention kernels of this tree against other trees', on one card.

    python3 torch_flash_ab.py OTHER_TREE [OTHER_TREE ...] [--rounds N]

An OTHER_TREE is another checkout of the repository (for example the
parent commit, unpacked with ``git archive``).  Each tree's kernels are
built and timed in a fresh process, the trees in turns (for each other
tree: other, this, this, other; N rounds), so all of them see the same
card in the same call.  Timed, by CUDA events (median of 50 after 5 warm-ups),
through each tree's public wrappers: ``<name>`` with the wrapper's host
path in the window, ``<name>_queued`` with each call queued behind a
~1 ms sleep of the card, so that the window holds the device time alone:

- the forward at the serving prefill's shapes: BH=32, D=128, causal,
  float32, T = 128, 700, 2048, with a digest of its output
  (``fwd_serve_T<n>_sha``: trees whose kernels compute the same bits
  print the same digest);
- paged decode at the serving decode's shape: B=8, H=32, D=128, BS=16,
  lengths 100-800 over a 1024-block pool, Tq = 1 and 4, float32 and
  bfloat16 pools (``paged_Tq<n>_<pool>``);
- where the tree has them, the forward, dq and dk/dv at BERT's training
  shape: BH=384, T=512, D=64, bf16, ``kv_valid`` over 384-512, dropout
  0.1; and the forward, dq (with ``d_bias``) and dk/dv there with a
  per-head float32 bias (12 planes of 512 x 512, ``*_bias``);
- the float32 dq and dk/dv (``dq_f32_*``, ``dkv_f32_*``) at BERT's shape
  (float32, the same ``kv_valid``, dropout 0.1: ``*_bert``) and at
  BH=32, T=700, D=128, causal, ``kv_valid`` over 350-700, dropout 0.1
  (``*_t700``).

Prints one JSON line per run (``tree`` is ``this`` or the other tree's
path as given) and the card's ``name, power.limit``.
Needs one CUDA card.
"""
import argparse
import json
import os
import subprocess
import sys

CHILD = r'''
import hashlib, json, statistics, torch
from tpu_mx_torch.kernels import flash_attention as fa
from tpu_mx_torch.kernels import paged_attention as pa

def cuda_ms(fn, reps=50, warm=5, queued=False):
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        if queued:
            torch.cuda._sleep(2_000_000)   # ~1 ms: the launch is queued first
        a.record(); fn(); b.record(); b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)

res = {}
def timed(name, fn):
    res[name] = cuda_ms(fn)
    res[name + "_queued"] = cuda_ms(fn, queued=True)

g = torch.Generator().manual_seed(0)
for t in (128, 700, 2048):
    q, k, v = (torch.randn((32, t, 128), generator=g).cuda()
               for _ in range(3))
    timed(f"fwd_serve_T{t}", lambda: fa.flash_attention(q, k, v, causal=True))
    res[f"fwd_serve_T{t}_sha"] = hashlib.sha256(fa.flash_attention(
        q, k, v, causal=True).cpu().numpy().tobytes()).hexdigest()[:16]
b, h, d, bs, n = 8, 32, 128, 16, 1024
for tq in (1, 4):
    for pool in (torch.float32, torch.bfloat16):
        lens = torch.randint(100, 801, (b,), generator=g, dtype=torch.int32)
        nblk = [-(-int(x) // bs) for x in lens]
        perm = torch.randperm(n, generator=g)
        tab = torch.zeros((b, -(-max(nblk) // 4) * 4), dtype=torch.int32)
        at = 0
        for i, c in enumerate(nblk):
            tab[i, :c] = perm[at:at + c]
            at += c
        kp, vp = (torch.randn((n, bs, h, d), generator=g).to("cuda", pool)
                  for _ in range(2))
        q = torch.randn((b, tq, h, d), generator=g).cuda()
        tab, lens = tab.cuda(), lens.cuda()
        timed(f"paged_Tq{tq}_{str(pool).split('.')[-1]}",
              lambda: pa.paged_attention(q, kp, vp, tab, lens))
        del kp, vp
if hasattr(fa, "flash_attention_bwd_dq"):
    bh, t, d = 384, 512, 64
    q, k, v, do = (torch.randn((bh, t, d), generator=g)
                   .to("cuda", torch.bfloat16) for _ in range(4))
    kv = torch.randint(384, 513, (32,), generator=g, dtype=torch.int32) \
        .repeat_interleave(12).cuda()
    seed = torch.tensor([5], dtype=torch.int32, device="cuda")
    opts = dict(kv_valid=kv, dropout_rate=0.1, dropout_seed=seed)
    out, lse = fa.flash_attention(q, k, v, return_lse=True, **opts)
    args = (q, k, v, do, lse, fa.flash_attention_delta(do, out), 0.125,
            False, kv, 0.1, seed)
    timed("fwd_bert",
          lambda: fa.flash_attention(q, k, v, return_lse=True, **opts))
    timed("dq_bert", lambda: fa.flash_attention_bwd_dq(*args))
    timed("dkv_bert", lambda: fa.flash_attention_bwd_dkv(*args))
if hasattr(fa, "reduce_d_bias"):
    bias = torch.randn((12, t, t), generator=g).cuda()
    timed("fwd_bert_bias", lambda: fa.flash_attention(
        q, k, v, return_lse=True, bias=bias, bias_groups=12, **opts))
    timed("dq_bert_bias", lambda: fa.flash_attention_bwd_dq(
        *args, bias, want_d_bias=True))
    timed("dkv_bert_bias", lambda: fa.flash_attention_bwd_dkv(*args, bias))
if hasattr(fa, "flash_attention_bwd_dq"):
    for key, bh, t, d, causal, kv in (
            ("bert", 384, 512, 64, False, kv),
            ("t700", 32, 700, 128, True, torch.randint(
                350, 701, (32,), generator=g, dtype=torch.int32).cuda())):
        q, k, v, do = (torch.randn((bh, t, d), generator=g).cuda()
                       for _ in range(4))
        opts = dict(causal=causal, kv_valid=kv, dropout_rate=0.1,
                    dropout_seed=seed)
        out, lse = fa.flash_attention(q, k, v, return_lse=True, **opts)
        args = (q, k, v, do, lse, fa.flash_attention_delta(do, out),
                d ** -0.5, causal, kv, 0.1, seed)
        timed(f"dq_f32_{key}", lambda: fa.flash_attention_bwd_dq(*args))
        timed(f"dkv_f32_{key}", lambda: fa.flash_attention_bwd_dkv(*args))
print(json.dumps(res))
'''


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("others", nargs="+", help="paths of the other trees")
    ap.add_argument("--rounds", type=int, default=1)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_flash_ab: no CUDA device available", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    here = os.path.dirname(os.path.abspath(__file__))
    for _ in range(args.rounds):
        for other in args.others:
            for side in (other, "this", "this", other):
                cwd = here if side == "this" else os.path.abspath(side)
                run = subprocess.run([sys.executable, "-c", CHILD], cwd=cwd,
                                     capture_output=True, text=True)
                if run.returncode:
                    print(run.stderr[-3000:], file=sys.stderr)
                    return 1
                print(json.dumps({"tree": side, **json.loads(
                    run.stdout.strip().splitlines()[-1])}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
