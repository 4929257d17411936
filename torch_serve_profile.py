#!/usr/bin/env python3
"""Where the port's serving time goes on the card: a torch.profiler trace.

    python3 torch_serve_profile.py [--out DIR]

Serves the traffic of ``chip_smoke.py``'s serve phase (the same model,
width and prompts) and profiles two windows separately: the first engine
step, which prefills all 8 prompts and decodes once, and the steps
after it, which only decode.  For each window it prints one JSON line:
the host wall time, the summed device time of every kernel (one stream,
so the sum is the device's busy time), the idle share ``1 - busy/wall``,
and the kernels with the most device time.  The profiler's own host
cost lengthens the wall time, so the idle share it reports is an upper
bound on the unprofiled run's.  The Chrome traces go to
``DIR`` (default ``build/profile/``, git-ignored).  Needs one CUDA card.
"""
import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

import chip_smoke


def window(torch, name, fn, out_dir, top=12):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        steps = fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side rows only: a CPU op's row repeats its kernels' time
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    prof.export_chrome_trace(os.path.join(out_dir, f"serve_{name}.json"))
    print(json.dumps({
        "window": name, "steps": steps, "wall_ms": wall_ms,
        "device_busy_ms": busy_ms, "idle_share": 1 - busy_ms / wall_ms,
        "kernels": [{"name": e.key[:80], "calls": e.count,
                     "device_ms": e.self_device_time_total / 1e3}
                    for e in kernels[:top]]}), flush=True)
    if busy_ms <= 0:
        raise SystemExit(f"profile window {name}: no device time recorded")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join("build", "profile"))
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_serve_profile: no CUDA device available",
              file=sys.stderr)
        return 2
    from tpu_mx_torch.serving import Server, TinyLM
    os.makedirs(args.out, exist_ok=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    srv = Server(TinyLM(**chip_smoke.SERVE, device="cuda"), max_batch=8,
                 block_size=16, num_blocks=1024)
    rng = np.random.RandomState(1)
    prompts = [rng.randint(0, chip_smoke.SERVE["vocab_size"], size=n).tolist()
               for n in chip_smoke.PROMPT_LENS]
    srv.submit(prompts[0][:16], max_new_tokens=2)      # warm-up
    srv.run_until_idle()
    reqs = [srv.submit(p, max_new_tokens=chip_smoke.NEW_TOKENS)
            for p in prompts]
    window(torch, "prefill_step", lambda: int(srv.step()), args.out)
    window(torch, "decode_steps", srv.run_until_idle, args.out)
    if not all(r.state == "done" for r in reqs):
        raise SystemExit("torch_serve_profile: a request did not finish")
    return 0


if __name__ == "__main__":
    sys.exit(main())
