#!/usr/bin/env python3
"""Build and drive the PyTorch/CUDA port (tpu_mx_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA card, PyTorch built for CUDA and ``nvcc``; it imports
nothing of jax or of the reference package ``tpu_mx``.  Phases, one JSON
line each:

1. ``env``     — card name and power limit (``nvidia-smi``), CUDA and
                 ``nvcc`` versions;
2. ``build``   — the kernels are built from ``tpu_mx_torch/csrc`` (one
                 ``nvcc`` per source, all started together), with each
                 kernel's register and shared-memory report;
3. ``kernel``  — each CUDA kernel against its plain PyTorch version on
                 the card, at the serving path's shapes: max abs error
                 and its tolerance, median ms by CUDA events, the plain
                 version's ms, one PyTorch library call's ms where one
                 computes the same function, and the least time the card
                 could take (bytes over 3.35 TB/s or operations over the
                 67 TFLOP/s float32 rate, whichever is larger);
4. ``serve``   — the serving path at TinyLM width 4096 (32 heads of
                 128, vocabulary 32000 — Llama-2-7B's attention width),
                 depth cut to 4 layers: 8 requests through
                 ``Server.run_until_idle()``, launch counts proving both
                 kernels ran, and request 0 held against the port on the
                 CPU (plain versions, same weights).

Then the card's ``name, power.limit`` line, one ``{"kernels": [...]}``
line, and last ``{"ok": true, "device": {...}}``.  Exits non-zero, and
prints no result, if any phase fails or there is no card.
"""
import json
import math
import statistics
import subprocess
import sys
import time
import traceback

import numpy as np

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
F32_FLOP_PER_S = 67e12         # H100 SXM float32 outside the tensor cores

PAGED_ATOL = 1e-4   # f32 math in both; only the summation order differs
FLASH_ATOL = 1e-4   # f32 FFMA kernel vs the f32 (non-TF32) plain matmuls
LOGITS_ATOL = 2e-4  # 4 layers of f32 on card vs host BLAS, |logit| ~ 1
NEAR_TIE = 1e-3     # a greedy split is accepted only at a top-2 gap below

SERVE = dict(vocab_size=32000, embed_dim=4096, num_heads=32, num_layers=4,
             max_positions=4096, seed=0)
PROMPT_LENS = (77, 150, 233, 310, 401, 499, 587, 700)
NEW_TOKENS = 32


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def smi_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps=20, warm=3):
    """Median milliseconds of ``fn`` by CUDA events."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_build(ctx):
    from tpu_mx_torch.kernels import _build
    t0 = time.perf_counter()
    libs = _build.build_all()
    secs = time.perf_counter() - t0
    report = {}
    for name, lib in libs.items():
        log = lib.with_suffix(".log")
        lines = log.read_text().splitlines() if log.exists() else []
        report[name] = [l.strip() for l in lines
                        if "registers" in l or "spill" in l]
    emit("build", ok=True, seconds=secs, ptxas=report)


def paged_case(torch, gen, tq, pool_dtype):
    """B=8 ragged rows of 100-800 tokens, H=32, D=128, BS=16, tables
    scattered over a 1024-block pool and padded to the cache's bucket."""
    b, h, d, bs, n = 8, 32, 128, 16, 1024
    lengths = torch.randint(100, 801, (b,), generator=gen)
    nblk = [-(-int(x) // bs) for x in lengths]
    nbpad = -(-max(nblk) // 4) * 4
    perm = torch.randperm(n, generator=gen).tolist()
    tables = torch.zeros((b, nbpad), dtype=torch.int32)
    at = 0
    for i, k in enumerate(nblk):
        tables[i, :k] = torch.tensor(perm[at:at + k])
        at += k
    dev = "cuda"
    kp = torch.randn((n, bs, h, d), generator=gen).to(dev, pool_dtype)
    vp = torch.randn((n, bs, h, d), generator=gen).to(dev, pool_dtype)
    q = torch.randn((b, tq, h, d), generator=gen).to(dev)
    return q, kp, vp, tables.to(dev), lengths.to(dev, torch.int32), nblk


def phase_kernels(ctx):
    import torch
    from tpu_mx_torch.kernels import flash_attention as fa
    from tpu_mx_torch.kernels import paged_attention as pa
    gen = torch.Generator().manual_seed(0)
    entries = {}
    worst = {"paged_attention": 0.0, "flash_attention_fwd": 0.0}

    for tq in (1, 4):
        for dtype in (torch.float32, torch.bfloat16):
            q, kp, vp, tab, lens, nblk = paged_case(torch, gen, tq, dtype)
            scale = 1.0 / math.sqrt(q.shape[-1])
            out = pa.paged_attention(q, kp, vp, tab, lens)
            ref = pa.paged_attention_plain(q, kp, vp, tab, lens, scale)
            torch.cuda.synchronize()
            err = float((out - ref).abs().max())
            ok = math.isfinite(err) and err <= PAGED_ATOL
            ms = cuda_ms(torch, lambda: pa.paged_attention(
                q, kp, vp, tab, lens))
            plain_ms = cuda_ms(torch, lambda: pa.paged_attention_plain(
                q, kp, vp, tab, lens, scale), reps=5)
            h, d = q.shape[2], q.shape[3]
            kv_bytes = sum(nblk) * 16 * h * d * 2 * kp.element_size()
            nbytes = (kv_bytes + 2 * q.numel() * 4 + tab.numel() * 4
                      + lens.numel() * 4)
            flops = 4 * int(lens.sum()) * h * d * tq
            b_ms, b_by = bound(nbytes, flops)
            shape = (f"B=8 Tq={tq} H=32 D=128 BS=16 pool="
                     f"{str(dtype).split('.')[-1]} lengths="
                     f"{lens.tolist()}")
            emit("kernel", name="paged_attention", shape=shape,
                 max_abs_err=err, atol=PAGED_ATOL, ok=ok, ms=ms,
                 plain_ms=plain_ms, library_ms=None, bound_ms=b_ms,
                 bound_by=b_by)
            worst["paged_attention"] = max(worst["paged_attention"], err)
            if not ok:
                ctx["failures"].append(f"paged_attention {shape}: err {err}")
            if tq == 1 and dtype == torch.float32:
                entries["paged_attention"] = dict(
                    shape=shape, ms=ms, plain_ms=plain_ms, library_ms=None,
                    bound_ms=b_ms, bound_by=b_by)

    bh, d = 32, 128
    for t in (128, 700, 2048):
        q, k, v = (torch.randn((bh, t, d), generator=gen).cuda()
                   for _ in range(3))
        scale = 1.0 / math.sqrt(d)
        out, lse = fa.flash_attention(q, k, v, causal=True, return_lse=True)
        ref, ref_lse = fa.flash_attention_plain(q, k, v, scale, causal=True)
        torch.cuda.synchronize()
        err = float(max((out - ref).abs().max(), (lse - ref_lse).abs().max()))
        ok = math.isfinite(err) and err <= FLASH_ATOL
        ms = cuda_ms(torch, lambda: fa.flash_attention(q, k, v, causal=True))
        plain_ms = cuda_ms(torch, lambda: fa.flash_attention_plain(
            q, k, v, scale, causal=True), reps=5)
        q4, k4, v4 = (x.view(1, bh, t, d) for x in (q, k, v))
        lib_ms = cuda_ms(torch, lambda: torch.nn.functional.
                         scaled_dot_product_attention(q4, k4, v4,
                                                      is_causal=True))
        nbytes = 4 * bh * t * d * 4 + bh * t * 4
        flops = 2 * t * (t + 1) * d * bh
        b_ms, b_by = bound(nbytes, flops)
        shape = f"BH=32 T={t} D=128 causal f32"
        emit("kernel", name="flash_attention_fwd", shape=shape,
             max_abs_err=err, atol=FLASH_ATOL, ok=ok, ms=ms,
             plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
             bound_by=b_by)
        worst["flash_attention_fwd"] = max(worst["flash_attention_fwd"], err)
        if not ok:
            ctx["failures"].append(f"flash_attention_fwd {shape}: err {err}")
        if t == 700:
            entries["flash_attention_fwd"] = dict(
                shape=shape, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=b_ms, bound_by=b_by)
    for name, e in entries.items():
        e["max_abs_err"] = worst[name]
    ctx["kernels"] = entries
    emit("kernels", held=sorted(entries))


def top2_gap(logits):
    top = np.sort(np.asarray(logits, np.float64))[-2:]
    return float(top[1] - top[0])


def phase_serve(ctx):
    import torch
    from tpu_mx_torch import tracing
    from tpu_mx_torch.kernels import flash_attention as fa
    from tpu_mx_torch.kernels import paged_attention as pa
    from tpu_mx_torch.serving import Server, TinyLM

    t0 = time.perf_counter()
    model = TinyLM(**SERVE, device="cuda")
    setup_s = time.perf_counter() - t0
    srv = Server(model, max_batch=8, block_size=16, num_blocks=1024)
    rng = np.random.RandomState(1)
    prompts = [rng.randint(0, SERVE["vocab_size"], size=n).tolist()
               for n in PROMPT_LENS]
    # warm-up request (cuBLAS handles, kernel libraries) before counting
    srv.submit(prompts[0][:16], max_new_tokens=2)
    srv.run_until_idle()

    fa.flash_attention.launches = 0
    pa.paged_attention.launches = 0
    tracing.reset()
    reqs = [srv.submit(p, max_new_tokens=NEW_TOKENS) for p in prompts]
    t1 = time.perf_counter()
    steps = srv.run_until_idle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    flash_n = fa.flash_attention.launches
    paged_n = pa.paged_attention.launches
    ctx["launches"] = {"flash_attention_fwd": flash_n,
                       "paged_attention": paged_n}

    events = tracing.snapshot()
    prefill_s = [e["data"]["seconds"] for e in events
                 if e["event"] == "serve.prefill"]
    decode_s = [e["data"]["seconds"] for e in events
                if e["event"] == "serve.decode"]
    layers = SERVE["num_layers"]
    checks = {
        "all_done": all(r.state == "done" and len(r.tokens) == NEW_TOKENS
                        for r in reqs),
        "flash_launches": flash_n == layers * len(prefill_s),
        "paged_launches": paged_n == layers * len(decode_s),
        "both_ran": flash_n > 0 and paged_n > 0,
    }

    # request 0 against the port on the CPU: same weights, plain versions
    cpu = TinyLM.from_numpy(*model.to_numpy(), num_heads=SERVE["num_heads"],
                            device="cpu")
    logits_gpu = model.prefill(prompts[0])[2].cpu()
    logits_cpu = cpu.prefill(prompts[0])[2]
    logits_err = float((logits_gpu - logits_cpu).abs().max())
    checks["prefill_logits"] = logits_err <= LOGITS_ATOL
    ref = Server(cpu, max_batch=1, block_size=16, num_blocks=64,
                 device="cpu")
    r_cpu = ref.submit(prompts[0], max_new_tokens=NEW_TOKENS)
    ref.run_until_idle()
    got, want = reqs[0].tokens, r_cpu.tokens
    split = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b),
                 None)
    gap = None
    if split is not None:
        gap = top2_gap(cpu.prefill(prompts[0] + want[:split])[2])
        checks["stream_near_tie"] = gap <= NEAR_TIE
    emit("serve", ok=all(checks.values()), checks=checks,
         model={**SERVE, "block_size": 16, "num_blocks": 1024},
         prompts=list(PROMPT_LENS), new_tokens=NEW_TOKENS,
         setup_seconds=setup_s, steps=steps, wall_seconds=wall,
         tokens_per_sec=sum(len(r.tokens) for r in reqs) / wall,
         prefills=len(prefill_s), decode_steps=len(decode_s),
         prefill_ms=[s * 1e3 for s in prefill_s],
         decode_step_ms_median=statistics.median(decode_s) * 1e3,
         decode_step_ms_max=max(decode_s) * 1e3,
         launches=ctx["launches"], prefill_logits_max_abs_err=logits_err,
         logits_atol=LOGITS_ATOL, stream_equal=split is None,
         stream_split_at=split, top2_gap_at_split=gap, near_tie=NEAR_TIE,
         card=ctx["smi"])
    for name, ok in checks.items():
        if not ok:
            ctx["failures"].append(f"serve check {name} failed")


def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    try:
        from tpu_mx_torch.kernels import _build
    except ImportError as e:
        print(f"chip_smoke: the tpu_mx_torch package is missing ({e})",
              file=sys.stderr)
        return 2
    ctx = {"failures": [], "smi": smi_line()}
    emit("env", card=ctx["smi"], torch=torch.__version__,
         cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvcc=_build.nvcc_version().strip()
         .splitlines()[-1])
    for name, fn in (("build", phase_build), ("kernels", phase_kernels),
                     ("serve", phase_serve)):
        try:
            fn(ctx)
        except Exception as e:  # noqa: BLE001 — reported, and the run fails
            traceback.print_exc()
            emit(name, ok=False, error=f"{type(e).__name__}: {e}"[:2000])
            ctx["failures"].append(f"phase {name}: {type(e).__name__}")
            if name == "build":
                break
    if ctx["failures"] or "kernels" not in ctx or "launches" not in ctx:
        print(f"chip_smoke: FAILED: {ctx['failures']}", file=sys.stderr)
        return 1
    kernels = []
    for name, source, replaces in (
            ("flash_attention_fwd", "tpu_mx_torch/csrc/flash_attention_fwd.cu",
             "tpu_mx/kernels/flash_attention.py:263"),
            ("paged_attention", "tpu_mx_torch/csrc/paged_attention.cu",
             "tpu_mx/kernels/paged_attention.py:223")):
        e = ctx["kernels"][name]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces,
                        "launches": ctx["launches"][name],
                        "max_abs_err": e["max_abs_err"], "ms": e["ms"],
                        "plain_ms": e["plain_ms"], "bound_ms": e["bound_ms"],
                        "bound_by": e["bound_by"],
                        "library_ms": e["library_ms"], "shape": e["shape"]})
    print(ctx["smi"], flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
