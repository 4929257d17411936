#!/usr/bin/env python3
"""The ``rtc`` launch's host path, this checkout against another.

    python3 torch_rtc_ab.py OTHER_TREE [--rounds N]

Times the reference's ``scale`` kernel (CUDA C through each tree's
``tpu_mx_torch.rtc``, 2**26 float32 elements, alpha 3.0) and
``torch.mul`` on the same input, each run in a fresh process in
``OTHER_TREE`` (a checkout of another commit, for example ``git archive
<commit> | tar -x -C build/parent``) and in this checkout in turns:
other, this, this, other, repeated N times (default 2).  One timing code
for both trees (this file's ``RUN``): the device time alone (``ms``,
queued behind a ~1 ms sleep of the card), the time with the launch's
host path in the CUDA-event window (``ms_with_host``), and the host
microseconds a launch takes to enqueue (``host_us``, 200 launches back
to back on the host clock).  Prints one line a run and then one JSON
object with every run by tree and the card's name and power limit.
Compare two trees only inside one call of this script.  Needs one CUDA
card; each run compiles the kernel with ``nvcc``.
"""
import argparse
import json
import os
import subprocess
import sys

RUN = r'''
import json, statistics, time
import torch
from tpu_mx_torch import rtc

SRC = """
extern "C" __global__ void scale(const float* __restrict__ x,
                                 float* __restrict__ y, float alpha, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) y[i] = x[i] * alpha;
}"""


def cuda_ms(fn, queued, reps=20, warm=3):
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if queued:
            torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_us(fn, n=200):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / n * 1e6


gen = torch.Generator(device="cuda").manual_seed(4)
x = torch.randn(1 << 26, device="cuda", generator=gen)
buf = torch.empty_like(x)
k = rtc.CudaModule(SRC).get_kernel("scale", alpha=3.0)
if not torch.equal(k.launch((x,)), x * 3.0):
    raise SystemExit("rtc scale is not x * 3.0 bit for bit")
out = {}
for name, fn in (("rtc", lambda: k.launch((x,))),
                 ("mul", lambda: torch.mul(x, 3.0, out=buf))):
    out[name] = {"ms": cuda_ms(fn, True), "ms_with_host": cuda_ms(fn, False),
                 "host_us": host_us(fn)}
print("RESULT " + json.dumps(out), flush=True)
'''


def rtc_run(tree):
    """One fresh process's timings in ``tree``."""
    out = subprocess.run([sys.executable, "-c", RUN], cwd=tree,
                         capture_output=True, text=True, check=False)
    for line in out.stdout.splitlines():
        if line.startswith("RESULT ") and out.returncode == 0:
            return json.loads(line[len("RESULT "):])
    raise SystemExit(f"torch_rtc_ab: {tree} failed:\n"
                     f"{out.stdout[-2000:]}{out.stderr[-2000:]}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    trees = {"other": os.path.abspath(args.other),
             "this": os.path.dirname(os.path.abspath(__file__))}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    runs = {"other": [], "this": []}
    for name in ("other", "this", "this", "other") * args.rounds:
        runs[name].append(rtc_run(trees[name]))
        print(name, json.dumps(runs[name][-1]), flush=True)
    print(json.dumps({"card": smi, "trees": trees, "runs": runs}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
