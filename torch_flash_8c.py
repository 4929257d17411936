#!/usr/bin/env python3
"""Measure the float32 flash backward's distance from float64 at the wide
head dims (D = 192 and 256), in this tree and in other trees, on one card.

    python3 torch_flash_8c.py [OTHER_TREE ...] [--out FILE]

An OTHER_TREE is another checkout of the repository (for example the
parent commit, unpacked with ``git archive``).  Each tree runs in a fresh
process, in the order other, this, this, other for each other tree (this
alone without one), and builds its own D = 192 and 256 kernels.  Each run
appends one JSON record (``tree``: ``this`` or the path as given) to
``--out`` (default ``torch_flash_8c.jsonl``) and prints its summary (the
distances in ``attribution`` and of the grid's ``d_bias``, the ``ms``,
the registers and spills).  A record holds:

- ``ptxas``: the compiler's registers and spills of the float32 dq and
  dk/dv instances (``flash_attention_bwd_d{128,192,256}``);
- ``attribution``: which product carries the distance.  At B=2 H=2 T=136
  (a partial tile), causal, ragged valid lengths, dropout 0.1 and a
  float32 per-row bias, q, k, v and dO are drawn from N(0, 1); in the
  variant ``s_exact`` q and k are rounded to multiples of 1/32 in
  [-3, 3], so that every product and partial sum of S = QK^T is exact in
  float32 whatever the order and the accumulator's rounding (the values
  need 7 bits, the sums at most 22); in ``dp_exact`` dO and V are, so
  dP = dO V^T is exact; in ``both_exact`` all four.  Kernel and plain
  twin are fed the float64 witness's lse and delta (chip_smoke.py's
  ``attention64``), and each one's largest distance from the witness is
  recorded per output (``kernel_vs_f64``, ``plain_vs_f64``);
- ``grid``: chip_smoke.py's ``wide_bias_case`` for every float32 case of
  the wide bias grid (D = 192, 256 x float32, bf16, float16 bias x four
  layouts), each from a generator seeded by its index, so that every
  tree sees the same inputs: the distance from the twin per output, the
  tolerance, and the witness's ``kernel_vs_f64`` / ``plain_vs_f64``;
- ``ms``: the device time (CUDA events, each launch queued behind a ~1 ms
  sleep of the card) of the float32 dq and dk/dv (no bias, no dropout) at
  chip_smoke.py's wide training shape, BH=64 T=700 causal with ragged
  valid lengths, D = 192 and 256, and at BH=32 T=700 D=128 (the
  narrower instances, built from the same source).

Then the card's ``name, power.limit``.  Needs one CUDA card.
"""
import argparse
import json
import os
import subprocess
import sys

CHILD = r'''
import json, math, sys, torch
import chip_smoke as cs
from tpu_mx_torch.kernels import _build
from tpu_mx_torch.kernels import flash_attention as fa

res = {}
names = ("flash_attention_fwd_d192", "flash_attention_fwd_d256",
         "flash_attention_bwd_d192", "flash_attention_bwd_d256",
         "flash_attention_fwd_d128", "flash_attention_bwd_d128")
started = {n: _build._start(n) for n in names}
ptxas = {}
for n, (out, proc) in started.items():
    _build._finish(n, out, proc)
    if n.startswith("flash_attention_bwd"):
        kernel, lines = None, []
        for line in out.with_suffix(".log").read_text().splitlines():
            if "Compiling entry function" in line:
                kernel = line.split("'")[1]
            elif kernel and "tf32x3" in kernel and (
                    "registers" in line or "spill" in line):
                lines.append(f"{kernel[:40]}: {line.strip()}")
        ptxas[n] = lines
res["ptxas"] = ptxas

def variant_inputs(gen, d, variant):
    b, h, t = cs.WIDE_GRID_B, cs.WIDE_GRID_H, cs.WIDE_GRID_T
    x = [torch.randn((b, h, t, d), generator=gen) for _ in range(4)]
    grid = lambda y: (y * 32).round().clamp(-96, 96) / 32
    if variant in ("s_exact", "both_exact"):
        x[0], x[1] = grid(x[0]), grid(x[1])
    if variant in ("dp_exact", "both_exact"):
        x[2], x[3] = grid(x[2]), grid(x[3])
    return [y.cuda() for y in x]

def attribution(d, variant, seed):
    gen = torch.Generator().manual_seed(seed)
    b, h, t = cs.WIDE_GRID_B, cs.WIDE_GRID_H, cs.WIDE_GRID_T
    bh, rate, scale = b * h, 0.1, 1.0 / math.sqrt(d)
    q, k, v, do = variant_inputs(gen, d, variant)
    kb = torch.randn((bh, t, t), generator=gen).cuda()
    rows = torch.randint(t // 2, t + 1, (b,), generator=gen).tolist()
    kv = torch.tensor(rows, dtype=torch.int32).repeat_interleave(h).cuda()
    sd = torch.randint(0, 2 ** 31 - 1, (1,), generator=gen,
                       dtype=torch.int32).cuda()
    f = lambda y: y.reshape(bh, t, d)
    qf, kf, vf, dof = (f(y) for y in (q, k, v, do))
    ex = cs.attention64(torch, fa, qf, kf, vf, dof, kb, kv, rate, sd, scale)
    fed = (qf, kf, vf, dof, ex["lse"].float(), ex["delta"].float(), scale,
           True, kv, rate, sd, kb)
    kq, kdb = fa.flash_attention_bwd_dq(*fed, want_d_bias=True)
    kk, kvv = fa.flash_attention_bwd_dkv(*fed)
    pw = fa.flash_attention_bwd_plain(*fed)
    out = {}
    for n, kx, px in (("dq", kq, pw[0]), ("dk", kk, pw[1]),
                      ("dv", kvv, pw[2]), ("d_bias", kdb, pw[3])):
        out[n] = dict(
            kernel_vs_f64=float((kx.double() - ex[n]).abs().max()),
            plain_vs_f64=float((px.double() - ex[n]).abs().max()),
            kernel_vs_plain=float((kx.double() - px.double()).abs().max()))
    return out

res["attribution"] = {
    f"D={d} {v}": attribution(d, v, 24 + d)
    for d in (256, 192)
    for v in ("random", "s_exact", "dp_exact", "both_exact")}

grid = []
i = 0
for d in (192, 256):
    for bd in (torch.float32, torch.bfloat16, torch.float16):
        for layout in cs.WIDE_GRID_LAYOUTS:
            gen = torch.Generator().manual_seed(1000 + i)
            i += 1
            r = cs.wide_bias_case(torch, fa, gen, torch.float32, d, bd,
                                  layout)
            grid.append(dict(
                d=d, bias_dtype=r["bias_dtype"], layout=layout, ok=r["ok"],
                vs_twin={n: r["max_abs_err"][n] for n in
                         ("dq", "dk", "dv", "d_bias")},
                on_atol={n: r["max_abs_err"][n] <= r["atol"][n] for n in
                         ("dq", "dk", "dv", "d_bias")},
                witness={n: [w["kernel_vs_f64"], w["plain_vs_f64"]]
                         for n, w in r["witness"].items()}))
res["grid"] = grid
res["grid_all_on_atol"] = all(all(c["on_atol"].values()) for c in grid)

ms = {}
gen = torch.Generator().manual_seed(7)
for d in (256, 192, 128):
    t, bh = 700, cs.WIDE_BATCH * cs.WIDE_HEADS if d > 128 else 32
    q, k, v, do = (torch.randn((bh, t, d), generator=gen).cuda()
                   for _ in range(4))
    valid = torch.randint(t // 2, t + 1, (bh,), generator=gen,
                          dtype=torch.int32).cuda()
    o, lse = fa.flash_attention(q, k, v, return_lse=True, causal=True,
                                kv_valid=valid)
    args = (q, k, v, do, lse, fa.flash_attention_delta(do, o),
            1.0 / math.sqrt(d), True, valid, 0.0, None, None)
    ms[f"dq_f32_d{d}"] = cs.cuda_ms(
        torch, lambda: fa.flash_attention_bwd_dq(*args), queued=True)
    ms[f"dkv_f32_d{d}"] = cs.cuda_ms(
        torch, lambda: fa.flash_attention_bwd_dkv(*args), queued=True)
res["ms"] = ms
print("RESULT " + json.dumps(res))
'''


def run(tree, label, out):
    env = dict(os.environ, PYTHONPATH=tree)
    proc = subprocess.run([sys.executable, "-c", CHILD], cwd=tree, env=env,
                          capture_output=True, text=True)
    if proc.returncode != 0:
        sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-8000:])
        raise SystemExit(f"{label}: exit {proc.returncode}")
    line = [x for x in proc.stdout.splitlines() if x.startswith("RESULT ")]
    res = dict(tree=label, **json.loads(line[-1][len("RESULT "):]))
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with open(out, "a") as f:
        f.write(json.dumps(res) + "\n")
    # the line printed: the summary (the whole record is in the file)
    fmt = lambda w: [float(f"{x:.3e}") for x in w]
    print(json.dumps(dict(
        tree=label, ms=res["ms"], grid_all_on_atol=res["grid_all_on_atol"],
        spills=sorted({x.split(": ", 1)[1] for v in res["ptxas"].values()
                       for x in v if "spill" in x}),
        registers=sorted({int(x.split("Used ")[1].split()[0])
                          for v in res["ptxas"].values() for x in v
                          if "Used " in x}),
        attribution={k: {n: fmt((w["kernel_vs_f64"], w["plain_vs_f64"]))
                         for n, w in v.items()}
                     for k, v in res["attribution"].items()},
        grid=[[c["d"], c["bias_dtype"], c["layout"],
               fmt([c["vs_twin"]["d_bias"]] + c["witness"]["d_bias"])]
              for c in res["grid"]])), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("others", nargs="*")
    ap.add_argument("--out", default="torch_flash_8c.jsonl")
    args = ap.parse_args()
    here = os.path.dirname(os.path.abspath(__file__))
    order = [(here, "this")] if not args.others else []
    for other in args.others:
        path = os.path.abspath(other)
        order += [(path, other), (here, "this"), (here, "this"),
                  (path, other)]
    for tree, label in order:
        run(tree, label, os.path.abspath(args.out))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())


if __name__ == "__main__":
    main()
