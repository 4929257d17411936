#!/usr/bin/env python3
"""Where the port's training step spends its time: a torch.profiler trace.

    python3 torch_train_profile.py [--model bert|resnet50|lstm|ssd|lenet]
                                   [--out DIR] [--steps N]

Builds the training configuration of one of ``chip_smoke.py``'s phases:
``bert`` (the default) that of ``train`` (BERT-base in bf16, dropout
0.1, LAMB with f32 masters, batch 32 x 512 with ragged valid lengths),
``resnet50`` that of ``resnet_train`` (ResNet-50 v1 with the
space-to-depth stem, channels-last, bf16, momentum SGD with f32
masters, batch 256 of 224x224 images, cuDNN autotuning on), ``lstm``
that of ``lstm_train`` (the PTB word-level LSTM LM, 2 x 650, vocabulary
10k, bptt 35, bf16, SGD lr 1.0 with f32 masters, batch 2048), ``ssd``
that of ``ssd_train`` (SSD-512 with the VGG16-reduced backbone at
512x512, bf16, channels-last, the benchmark's objective with its target
generation, momentum SGD with f32 masters, batch 128).  Runs one
warm-up step, then profiles N steps (default 2), each ending in a host
read of its loss.  Prints one JSON line: the host wall time, the
device's busy time (the union of the kernels' intervals: cuDNN's RNN
runs kernels on several streams at once), the kernels' summed time, the
idle share ``1 - busy/wall``, device launches a step, the
device time by group (BERT: the three flash kernels, matrix products,
the rest; ResNet: cuDNN's convolutions, reductions, matrix products,
the rest; LSTM: the recurrence's own kernels, reductions and softmax,
matrix products, the rest: elementwise and copies; SSD: cuDNN's
convolutions, reductions, the rest) and the kernels with the most device
time.  For SSD the device time of two named ranges is split out too:
``ssd.targets`` (``MultiBoxTarget``, the target generation) and
``ssd.optimizer`` (the SGD update of every parameter).
``lenet`` profiles one epoch (64 steps) of ``mnist_train``'s imperative
loop (``examples/mnist/train_mnist.py``'s recipe: ``lenet(10)``, SGD with
momentum, batch 128 of the example's synthetic images, after one
warm-up epoch) instead of N steps, and splits the wall time by the
loop's named parts: ``lenet.data`` (``NDArrayIter``), ``lenet.forward``
(the ``Block`` calls and the loss under ``autograd.record()``),
``lenet.backward``, ``lenet.trainer`` (``Trainer.step``) and
``lenet.metric`` (``metric.Accuracy.update``, which reads the batch
back), each with its host time and the device time of the kernels it
launched (the backward's kernels are launched by autograd's own thread
and fall outside ``lenet.backward``); it also prints the host time the
imperative boundary adds to a forward.
The profiler's host cost lengthens the wall time, so the idle share is
an upper bound on the unprofiled run's.  The Chrome trace goes to
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

# kernel-name fragments of each group (the flash kernels are the port's
# bf16 wgmma or float32 3xTF32 instances; the matrix products are
# cuBLAS's: nvjet, xmma and CUTLASS kernels)
MATMUL = ("matmul", ("gemm", "nvjet", "xmma", "cutlass", "cublas"))
GROUPS = {
    "bert": (("flash_fwd", ("flash_fwd_tc_kernel", "flash_fwd_tf32x3_kernel")),
             ("flash_dq", ("flash_dq_tc_kernel", "flash_dq_tf32x3_kernel")),
             ("flash_dkv", ("flash_dkv_tc_kernel",
                            "flash_dkv_tf32x3_kernel")),
             MATMUL),
    # cuDNN's convolution kernels (implicit GEMMs named fprop/dgrad/wgrad,
    # cuDNN's CUTLASS instances) before the matrix-product names they
    # share; BatchNorm's statistics are PyTorch's reduction kernels
    "resnet50": (("conv", ("fprop", "dgrad", "wgrad", "conv", "cudnn")),
                 ("reduce", ("reduce_kernel", "norm_kernel")),
                 MATMUL),
    # cuDNN's RNN kernels (RNN_blockPersist_*, LSTM_elementWise_*) or, on
    # ATen's own route, its fused gate kernels (lstm_cell_forward, ...);
    # the loss's log-softmax and the gradient sums are reductions
    "lstm": (("recurrence", ("lstm", "gru", "rnn")),
             ("reduce", ("reduce_kernel", "softmax", "norm_kernel")),
             MATMUL),
    "ssd": chip_smoke.SSD_GROUPS,
    # cuDNN's convolutions, then the rest (elementwise, pooling, the SGD
    # updates, copies)
    "lenet": (("conv", ("fprop", "dgrad", "wgrad", "conv", "cudnn")),
              ("reduce", ("reduce_kernel", "softmax", "norm_kernel")),
              MATMUL),
}
# the SSD step's named ranges (record_function), by what they wrap
SSD_RANGES = ("ssd.targets", "ssd.optimizer")
# the imperative LeNet loop's parts (chip_smoke.mnist_epoch)
LENET_RANGES = ("lenet.data", "lenet.forward", "lenet.backward",
                "lenet.trainer", "lenet.metric")


def group_of(name, groups):
    low = name.lower()
    for group, keys in groups:
        if any(k in low for k in keys):
            return group
    return "other"


def bert_step(torch):
    from tpu_mx_torch import optimizer
    from tpu_mx_torch.models import BERTModel, MLMLoss, bert_base_config
    from tpu_mx_torch.parallel import CompiledTrainStep

    cfg = bert_base_config(max_len=chip_smoke.TRAIN_SEQ)
    rng = np.random.RandomState(0)
    lo, hi = chip_smoke.TRAIN_VALID
    valid = rng.randint(lo, hi + 1, chip_smoke.TRAIN_BATCH)
    batch = chip_smoke.bert_batch(cfg, chip_smoke.TRAIN_BATCH,
                                  chip_smoke.TRAIN_SEQ,
                                  chip_smoke.TRAIN_MASKED, valid, rng)
    batch = tuple(torch.from_numpy(x).cuda() for x in batch)
    net = BERTModel(cfg, dtype="bfloat16", device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(0))
    step = CompiledTrainStep(net, MLMLoss(), optimizer.create(
        "lamb", learning_rate=1e-4, multi_precision=True))
    return step, batch


def resnet50_step(torch):
    from tpu_mx_torch import layout, optimizer
    from tpu_mx_torch.gluon import loss
    from tpu_mx_torch.gluon.model_zoo import vision
    from tpu_mx_torch.parallel import CompiledTrainStep

    torch.backends.cudnn.benchmark = True
    batch, size = chip_smoke.RESNET_BATCHES[0], chip_smoke.RESNET_SIZE
    gen = torch.Generator(device="cuda").manual_seed(0)
    with layout.default_layout("NHWC"):
        net = vision.resnet50_v1(classes=chip_smoke.RESNET_CLASSES,
                                 stem="s2d", generator=gen)
    net.initialize("xavier", gen).cast("bfloat16")
    step = CompiledTrainStep(net, loss.SoftmaxCrossEntropyLoss(),
                             optimizer.create("sgd", learning_rate=0.1,
                                              momentum=0.9, wd=1e-4,
                                              multi_precision=True))
    data = torch.rand((batch, size, size, 3), generator=gen,
                      device="cuda").to(torch.bfloat16)
    label = torch.randint(0, chip_smoke.RESNET_CLASSES, (batch,),
                          generator=gen, device="cuda").float()
    return step, (data, label)


def lstm_step(torch):
    from tpu_mx_torch import optimizer
    from tpu_mx_torch.models import RNNModel
    from tpu_mx_torch.parallel import CompiledTrainStep

    batch, bptt = chip_smoke.LSTM_BATCHES[0], chip_smoke.LSTM_BPTT
    vocab = chip_smoke.LSTM_CFG["vocab_size"]
    gen = torch.Generator(device="cuda").manual_seed(0)
    net = RNNModel(generator=gen, **chip_smoke.LSTM_CFG)
    net.initialize("xavier", gen).cast("bfloat16")
    step = CompiledTrainStep(net, chip_smoke.flat_ce(), optimizer.create(
        "sgd", learning_rate=1.0, multi_precision=True))
    rng = np.random.RandomState(0)
    x = rng.randint(0, vocab, (bptt, batch)).astype(np.float32)
    y = rng.randint(0, vocab, (bptt * batch,)).astype(np.float32)
    return step, tuple(torch.from_numpy(a).cuda() for a in (x, y))


def ssd_step(torch):
    from torch.profiler import record_function
    from tpu_mx_torch import optimizer
    from tpu_mx_torch.gluon import loss
    from tpu_mx_torch.models import ssd_512
    from tpu_mx_torch.ndarray import contrib
    from tpu_mx_torch.parallel import CompiledTrainStep

    torch.backends.cudnn.benchmark = True
    batch, size = chip_smoke.SSD_BATCHES[0], chip_smoke.SSD_SIZE
    gen = torch.Generator(device="cuda").manual_seed(0)
    net = ssd_512(chip_smoke.SSD_CLASSES, backbone="vgg16_reduced",
                  device="cuda", generator=gen)
    wrapper = chip_smoke.ssd_train_block(net)
    wrapper.initialize("xavier", gen).cast("bfloat16")
    step = CompiledTrainStep(wrapper, loss.PassThrough(), optimizer.create(
        "sgd", learning_rate=0.01, momentum=0.9, wd=5e-4,
        multi_precision=True), device="cuda")

    def named(name, fn):
        def run(*args, **kwargs):
            with record_function(name):
                return fn(*args, **kwargs)
        return run
    contrib.MultiBoxTarget = named("ssd.targets", contrib.MultiBoxTarget)
    step._apply = named("ssd.optimizer", step._apply)
    data = (torch.rand((batch, 3, size, size), generator=gen,
                       device="cuda") * 0.1).to(torch.bfloat16)
    labels = torch.from_numpy(chip_smoke.ssd_labels(
        batch, chip_smoke.SSD_CLASSES)).cuda()
    return step, (data, labels, torch.zeros(1, device="cuda"))


def lenet_epoch(torch, args, profile, activities):
    """One profiled epoch of the imperative LeNet loop; prints its JSON
    line."""
    x, y = chip_smoke.mnist_data()
    net, trainer, loss_fn, it = chip_smoke.mnist_recipe(x, y)
    chip_smoke.mnist_epoch(torch, net, trainer, loss_fn, it)   # warm-up
    with profile(activities=activities) as prof:
        acc, n, step_ms, wall = chip_smoke.mnist_epoch(
            torch, net, trainer, loss_fn, it, ranges=True)
    steps = len(step_ms)
    wall_ms = wall * 1e3
    busy_ms = chip_smoke.device_busy_ms(torch, prof, LENET_RANGES)
    events = prof.key_averages()
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0
               and e.key not in LENET_RANGES]
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    ranges = {e.key: {"host_ms": e.cpu_time_total / 1e3 / steps,
                      "device_ms": e.device_time_total / 1e3 / steps,
                      "calls": e.count / steps}
              for e in events if e.key in LENET_RANGES
              and e.device_type == torch.autograd.DeviceType.CPU}
    groups = {}
    for e in kernels:
        g = groups.setdefault(group_of(e.key, GROUPS["lenet"]),
                              {"device_ms": 0.0, "calls": 0})
        g["device_ms"] += e.self_device_time_total / 1e3 / steps
        g["calls"] += e.count / steps
    prof.export_chrome_trace(os.path.join(args.out, "lenet_epoch.json"))
    boundary = chip_smoke.boundary_us(torch, net, x[:chip_smoke.MNIST_BATCH])
    print(json.dumps({
        "model": "lenet", "window": f"1 epoch, {steps} steps of "
                                    f"{chip_smoke.MNIST_BATCH}",
        "train_accuracy": acc, "images": n, "wall_ms": wall_ms,
        "step_ms_median": chip_smoke.statistics.median(step_ms),
        "images_per_sec": n / wall, "device_busy_ms": busy_ms,
        "idle_share": 1 - busy_ms / wall_ms,
        "launches_per_step": sum(e.count for e in kernels) / steps,
        "ranges_per_step": ranges,
        "ranges_host_share": {k: v["host_ms"] * steps / wall_ms
                              for k, v in ranges.items()},
        "per_step": groups,
        "boundary_host_us": dict(boundary,
                                 extra=boundary["nd"] - boundary["tensor"]),
        "kernels": [{"name": e.key[:80], "calls": e.count,
                     "device_ms": e.self_device_time_total / 1e3}
                    for e in kernels[:15]]}), flush=True)
    if busy_ms <= 0:
        raise SystemExit("torch_train_profile: no device time recorded")
    return 0


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", choices=sorted(GROUPS), default="bert")
    ap.add_argument("--out", default=os.path.join("build", "profile"))
    ap.add_argument("--steps", type=int, default=2)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_train_profile: no CUDA device available",
              file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(args.out, exist_ok=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    if args.model == "lenet":
        return lenet_epoch(torch, args, profile, activities)
    step, batch = {"bert": bert_step, "resnet50": resnet50_step,
                   "lstm": lstm_step, "ssd": ssd_step}[args.model](torch)
    float(step.step(*batch))                              # warm-up
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        losses = [float(step.step(*batch)) for _ in range(args.steps)]
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side rows only: a CPU op's row repeats its kernels' time, and
    # a named range's device-side span repeats its kernels' too
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0 and e.key not in SSD_RANGES]
    ranges = {e.key: e.device_time_total / 1e3 / args.steps
              for e in prof.key_averages()
              if e.key in SSD_RANGES
              and e.device_type == torch.autograd.DeviceType.CPU}
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    kernel_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    busy_ms = chip_smoke.device_busy_ms(torch, prof, SSD_RANGES)
    groups = {}
    for e in kernels:
        g = groups.setdefault(group_of(e.key, GROUPS[args.model]),
                              {"device_ms": 0.0, "calls": 0})
        g["device_ms"] += e.self_device_time_total / 1e3
        g["calls"] += e.count
    prof.export_chrome_trace(os.path.join(args.out,
                                          f"{args.model}_train_steps.json"))
    print(json.dumps({
        "model": args.model, "window": f"{args.steps} train steps",
        "losses": losses, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "kernel_ms": kernel_ms,
        "idle_share": 1 - busy_ms / wall_ms,
        "launches_per_step": sum(e.count for e in kernels) / args.steps,
        "per_step": {k: {"device_ms": v["device_ms"] / args.steps,
                         "calls": v["calls"] / args.steps}
                     for k, v in sorted(groups.items())},
        "ranges_per_step_device_ms": ranges,
        "kernels": [{"name": e.key[:80], "calls": e.count,
                     "device_ms": e.self_device_time_total / 1e3}
                    for e in kernels[:15]]}), flush=True)
    if busy_ms <= 0:
        raise SystemExit("torch_train_profile: no device time recorded")
    return 0


if __name__ == "__main__":
    sys.exit(main())
