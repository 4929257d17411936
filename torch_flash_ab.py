#!/usr/bin/env python3
"""Time the flash kernels of this tree against another tree's, on one card.

    python3 torch_flash_ab.py OTHER_TREE [--rounds N]

OTHER_TREE is another checkout of the repository (for example the parent
commit, unpacked with ``git archive``).  Each tree's kernels are built
and timed in a fresh process, the trees in turns (other, this, this,
other, ... N rounds of two pairs), so both sides see the same card in
the same call.  Timed, by CUDA events (median of 50 after 5 warm-ups),
through each tree's public wrappers:

- the forward at the serving prefill's shapes: BH=32, D=128, causal,
  float32, T = 128, 700, 2048;
- where the tree has them, the forward, dq and dk/dv at BERT's training
  shape: BH=384, T=512, D=64, bf16, ``kv_valid`` over 384-512, dropout
  0.1.

Prints one JSON line per run and the card's ``name, power.limit``.
Needs one CUDA card.
"""
import argparse
import json
import os
import subprocess
import sys

CHILD = r'''
import json, statistics, torch
from tpu_mx_torch.kernels import flash_attention as fa

def cuda_ms(fn, reps=50, warm=5):
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record(); fn(); b.record(); b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)

g = torch.Generator().manual_seed(0)
res = {}
for t in (128, 700, 2048):
    q, k, v = (torch.randn((32, t, 128), generator=g).cuda()
               for _ in range(3))
    res[f"fwd_serve_T{t}"] = cuda_ms(
        lambda: fa.flash_attention(q, k, v, causal=True))
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
    res["fwd_bert"] = cuda_ms(
        lambda: fa.flash_attention(q, k, v, return_lse=True, **opts))
    res["dq_bert"] = cuda_ms(lambda: fa.flash_attention_bwd_dq(*args))
    res["dkv_bert"] = cuda_ms(lambda: fa.flash_attention_bwd_dkv(*args))
print(json.dumps(res))
'''


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", help="path of the other tree")
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
    trees = {"other": os.path.abspath(args.other), "this": here}
    for _ in range(args.rounds):
        for side in ("other", "this", "this", "other"):
            run = subprocess.run([sys.executable, "-c", CHILD],
                                 cwd=trees[side], capture_output=True,
                                 text=True)
            if run.returncode:
                print(run.stderr[-3000:], file=sys.stderr)
                return 1
            print(json.dumps({"tree": side, **json.loads(
                run.stdout.strip().splitlines()[-1])}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
