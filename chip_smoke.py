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
                 kernel's register and spill report and its counts of
                 ``HGMMA`` (wgmma) and ``HMMA`` (mma.sync) tensor-core
                 instructions in ``cuobjdump --dump-sass``: the bf16
                 forward, dq and dk/dv instances (``*_tc_kernel``) must
                 have HGMMA, the float32 forward, dq and dk/dv instances
                 (``*_tf32x3_kernel``) HMMA, and both spill nothing; the
                 paged instances have neither.  For the float32
                 instances, the instruction mix of their SASS
                 (``f32_mix``: all instructions, HMMA, TF32 splits);
3. ``kernel``  — each CUDA kernel against its plain PyTorch version on
                 the card: paged decode and the flash forward at the
                 serving path's shapes; the flash forward, dq and dk/dv
                 at BERT's training shapes (bf16, ragged ``kv_valid``,
                 dropout 0 and 0.1; float32, dropout 0.1) and at one
                 float32 causal shape.
                 Max abs error and its tolerance, median ms by CUDA
                 events (the window holds the wrapper's host path too;
                 the serving and BERT-shape kernels also queued behind a
                 ~1 ms sleep of the card, ``ms_queued``: the device time
                 alone, with SDPA's beside the serving forwards), the
                 plain version's ms, one PyTorch library call's ms where
                 one computes the same function, and the least time the
                 card could take (bytes over 3.35 TB/s or operations
                 over the 989 TFLOP/s bf16 tensor-core rate; for float32
                 inputs three TF32 products over 495 TFLOP/s, with the
                 67 TFLOP/s FFMA bound beside it; whichever of bytes and
                 operations is larger), the achieved TFLOP/s and
                 bound_ms / ms, and the route the C entry points
                 reported for the timed calls (``wgmma`` or ``tf32x3``;
                 ``split_k`` for paged decode).
                 The float32 forward and backward at large scores are
                 held to float64 within the bounds of their
                 split-precision arithmetic (``f32_precision``,
                 ``f32_bwd_precision``), and the forward kernel's
                 dropout mask is read out and held bit for bit against
                 the plain mask;
4. ``serve``   — the serving path at TinyLM width 4096 (32 heads of
                 128, vocabulary 32000 — Llama-2-7B's attention width),
                 depth cut to 4 layers: 8 requests through
                 ``Server.run_until_idle()``, launch counts proving both
                 kernels ran (every prefill on the ``tf32x3`` route,
                 every decode on ``split_k``), and
                 request 0 held against the port on the CPU (plain
                 versions, same weights);
   ``serve_features`` — the serving decode features at the same width
                 (``max_batch=8``, block 16, 1024 blocks).  (a) Prefix
                 sharing: 8 requests share a 512-token system prompt and
                 each adds its own 64-256-token tail (32 new tokens
                 each), sharing off and on in turns, twice: prefill ms
                 per request, the peak of blocks held, the index's hits
                 and bytes saved, flash launches and
                 ``serve.prefill_attention{kind}``; sharing on must hit
                 at least 7 times, hold fewer blocks and launch the
                 flash forward less, run its suffixes dense and its full
                 prefills ``tf32x3``, and leave no reference after
                 ``drop_prefix_cache()``.  (b) Speculative decoding:
                 ``serve``'s 8 prompts with ``TPUMX_SPECULATIVE`` off,
                 at 4, and at 4 with a proposer that drafts the known
                 stream (every window accepted): decode steps, tokens/s,
                 median step ms, the accept ratio, and every spec-on
                 step's paged launches at ``Tq=4`` on ``split_k``.
                 (c) Top-k: ``sampling="top_k:40"``, seed 7, twice:
                 equal streams, every token within its step's top 40,
                 and a sampler's ``state_dict`` resuming its stream.
                 Every stream equals the feature-off stream or splits
                 only where the logits' top two are within ``NEAR_TIE``;
5. ``train_parity`` — one ``CompiledTrainStep`` LAMB step of BERT-base
                 (12 layers, float32, dropout 0, batch 2 x 128) on the
                 card and on the CPU from the same weights: losses and
                 per-tensor weight updates agree (the float32 flash
                 kernels, ``tf32x3``, on the card);
6. ``train``   — the training slice at full width: BERT-base in bf16
                 with dropout 0.1, the benchmark's MLM loss and LAMB
                 (f32 masters), batch 32 x 512 with ragged valid
                 lengths, 1 warm-up and 5 timed steps; launch counts
                 prove the flash forward, dq and dk/dv ran 12 times a
                 step (all three on the ``wgmma`` route the C entry
                 points report) and the paged kernel not at all;
   ``train_f32`` — the same step in float32 (``BERTModel(dtype=
                 "float32")``, LAMB, dropout 0.1, batch 32 x 512; running
                 out of memory fails the phase), 1 warm-up and 3 timed
                 steps: step ms, sequences/s, peak memory; launch
                 counts prove the flash forward, dq and dk/dv ran 12
                 times a step, all three on ``tf32x3``, and the paged
                 kernel not at all; losses finite;
7. ``resnet_parity`` — thin ResNetV1s (one block a stage; BasicBlock
                 and Bottleneck, the classic and the space-to-depth
                 stems; channels-last, float32) built on the card and on
                 the CPU from one weight set: logits (eval mode) within
                 2e-4, then three momentum-SGD steps through
                 ``CompiledTrainStep`` whose losses agree within 1e-4
                 and whose every weight and running statistic moves
                 alike within 1e-2 in norm (a tensor that gets no
                 gradient, a conv bias in front of a BatchNorm, within
                 1e-5 absolute);
8. ``resnet_train`` — the reference benchmark's ResNet-50 recipe
                 (``bench.py::_resnet_once``) at full width:
                 ``resnet50_v1(classes=1000, stem="s2d")`` built
                 channels-last, Xavier, cast to bfloat16, softmax
                 cross-entropy, SGD (lr 0.1, momentum 0.9, wd 1e-4,
                 f32 masters) through ``CompiledTrainStep``, batch 256
                 (128, said so, if 256 runs out of memory) of 224x224x3
                 bfloat16 images, 1 warm-up and 5 timed steps (cuDNN
                 autotuning on); step ms, images/s, peak memory and
                 achieved TFLOP/s at 24.54 GFLOP an image against the
                 989 TFLOP/s bf16 peak; checks that the losses are
                 finite and fall, that the first convolution's input and
                 weight are channels-last, and that no kernel of the
                 port launched (the path is cuDNN, cuBLAS and PyTorch's
                 own kernels);
9. ``lstm_parity`` — thin word-LMs (vocabulary 200, 2 layers of 32,
                 float32: ``RNNModel`` LSTM and GRU, and an embedding →
                 bidirectional LSTM → decoder net) built on the card and
                 on the CPU from one weight set: logits (eval mode)
                 within 2e-4, then three SGD steps (lr 1.0, the
                 benchmark's ``FlatCE`` loss) through
                 ``CompiledTrainStep`` whose losses agree within 1e-4
                 and whose every tensor moves alike within 1e-2 in norm.
                 This holds the ``fused`` arm of the recurrence (cuDNN's
                 RNN, ``rnn.arm{kind="fused"}``) against the ``scan``
                 arm (plain PyTorch, the CPU's).  Also what cuDNN's copy
                 of the separate weights into one buffer costs: the
                 fused float32 forward of the full-width LSTM at batch
                 512 against ``torch.nn.LSTM`` on its packed buffer, and
                 that cuDNN warns of the copy;
10. ``lstm_train`` — the reference benchmark's PTB LSTM recipe
                 (``bench.py::_lstm_once``) at full width: ``RNNModel``
                 2 x 650, vocabulary 10k, Xavier, cast to bfloat16,
                 ``FlatCE``, SGD lr 1.0 with f32 masters through
                 ``CompiledTrainStep``, bptt 35 at batch 2048 (1024, then
                 512, said so, if it runs out of memory), float32 token
                 ids from ``np.random.RandomState(0)``; 1 warm-up, one
                 profiled step (the kernels that ran, the device's busy
                 time) and 5 timed steps; step ms, tokens/s, peak
                 memory and achieved TFLOP/s at 79.6 MFLOP a token
                 against the 989 TFLOP/s bf16 peak; checks that the
                 losses are finite and fall, that every step took the
                 ``fused`` arm on cuDNN's RNN kernels, and that no
                 kernel of the port launched; then the same run on the
                 plain ``scan`` arm (its step ms beside the fused arm's;
                 its losses within 2e-2 of the fused arm's);
11. ``ssd_parity`` — SSDs in float32 built on the card and on the CPU
                 from one weight set: the benchmark's smoke SSD (heads
                 and anchors within 2e-4 of max(1, |out|),
                 ``MultiBoxDetection`` on the same inputs within 1e-6,
                 three momentum-SGD steps of the benchmark's objective
                 whose losses agree within 1e-4) and the VGG16-reduced
                 SSD-512 at 64x64 (heads); ``MultiBoxTarget`` at the
                 full width's shape (the VGG16-reduced net's 24,564
                 anchors at 512x512, the benchmark's labels at batch
                 128, bf16-rounded scores so that hardness values tie):
                 masks and class targets equal, location targets within
                 1e-6; and SSD-300's 8,732 anchors from one 300x300
                 forward (ceil-mode pools, 75 -> 38);
12. ``ssd_train`` — the reference benchmark's SSD recipe
                 (``bench.py::_ssd_once``) at full width:
                 ``ssd_512(20, backbone="vgg16_reduced")``, Xavier, cast
                 to bfloat16, channels-last, the objective (softmax CE
                 on ``MultiBoxTarget``'s classes with 3:1 mining, Huber
                 on the masked boxes), SGD (lr 0.01, momentum 0.9, wd
                 5e-4, f32 masters), batch 128 (64, then 32, said so, if
                 it runs out of memory) of 512x512 images, 1 warm-up,
                 one profiled step (busy time, idle share, device time
                 by kernel group) and 5 timed steps (cuDNN autotuning
                 on); step ms, images/s, peak memory and achieved
                 TFLOP/s at 537.2 GFLOP an image against the 989 TFLOP/s
                 bf16 peak; ``MultiBoxTarget``'s ms alone on the batch's
                 heads and one ``detect`` at batch 8 (CUDA events);
                 checks 24,564 anchors, finite falling losses, bf16
                 weights, channels-last, ``detect``'s shape (8, 24564,
                 6) with finite kept rows, and that no kernel of the
                 port launched;
13. ``imperative_parity`` — the imperative surface (``NDArray``,
                 ``autograd.record()``, deferred shapes, ``Trainer``) on
                 the card against the CPU, float32: LeNet and an MLP with
                 BatchNorm (logits within 2e-4, three momentum-SGD steps
                 whose losses agree within 1e-4 and whose every tensor
                 moves alike within 1e-2 in norm); and a 2-layer BERT at
                 BERT-base's width, one LAMB step through
                 ``autograd.record()``/``Trainer`` against
                 ``CompiledTrainStep`` on the card from the same weights;
14. ``mnist_train`` — ``examples/mnist/train_mnist.py``'s recipe through
                 the imperative surface: ``lenet(10)`` with no input
                 sizes, Xavier, ``Trainer`` (SGD lr 0.05, momentum 0.9)
                 built before the first forward, softmax cross-entropy,
                 the example's synthetic 8192 images in a shuffled
                 ``NDArrayIter`` at batch 128, ``metric.Accuracy`` on
                 every batch; 3 epochs imperatively, then a fresh net
                 ``hybridize()``d for 3 more, each ending in the
                 example's final train accuracy (> 0.9); images/s per
                 epoch, step ms, peak memory, ``memory_allocated`` over
                 100 steps (flat: no graph kept alive), a profiled
                 fourth epoch (device busy time, idle share, launches a
                 step), the host time the imperative boundary adds to a
                 forward, and that no kernel of the port launched;
15. ``bert_imperative`` — one BERT-base step at the ``train`` phase's
                 width (bf16, dropout 0.1, batch 32 x 512, ragged valid
                 lengths) written imperatively: ``with autograd.record():
                 loss = MLMLoss()(net(...), labels)``,
                 ``loss.backward()``, ``Trainer("lamb", multi_precision)
                 .step(32)``; 1 warm-up and 5 timed steps in turns with
                 ``CompiledTrainStep``'s from the same weights; launch
                 counts prove the flash forward, dq and dk/dv ran 12
                 times a step on the ``wgmma`` route;
16. ``attention_bias`` — ``parallel.attention(..., bias=)`` forward and
                 backward at BERT-base's attention width (B=32, H=12,
                 T=512, D=64, bf16, ragged ``valid_length``, dropout
                 0.1) for four float32 bias layouts: per head
                 (1,12,512,512), per row (32,12,512,512), shared
                 (1,1,512,512) and ALiBi (1,12,1,512); and one float32
                 causal case (BH=32, T=700, D=128, bias (1,32,700,700)).
                 Launch counts prove the three flash kernels ran with
                 the bias (bf16 on the ``wgmma`` route, the float32 case's
                 three on ``tf32x3``); each
                 kernel is held against its plain version
                 (out, lse, dq, dk, dv, the reduced d_bias), d_bias is
                 checked to be written everywhere over NaN-filled
                 memory, and ms with and without the bias, the bound,
                 the plain version's ms and SDPA's with the bias as a
                 float mask are recorded;
17. ``rtc``    — the reference's rtc test kernels (``scale``, ``addmul``)
                 as CUDA source compiled at run time by
                 ``tpu_mx_torch.rtc`` and run on 2**26 float32 elements:
                 ``scale`` equals ``x * 3.0`` bit for bit, ``addmul``
                 equals ``a * b + a`` within 1e-6 of ``|a*b| + |a|``
                 (nvcc may contract it to one FMA), and ``scale``
                 launched on an ``NDArray`` returns one, bit-equal too;
                 nvcc's log reaches the error of bad source.

Then the card's ``name, power.limit`` line, one ``{"kernels": [...]}``
line, and last ``{"ok": true, "device": {...}}``.  Exits non-zero, and
prints no result, if any phase fails or there is no card.
"""
import gc
import json
import math
import re
import statistics
import subprocess
import sys
import time
import traceback

import numpy as np

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
F32_FLOP_PER_S = 67e12         # H100 SXM float32 outside the tensor cores
TF32_FLOP_PER_S = 495e12       # H100 SXM TF32 tensor cores, dense
BF16_FLOP_PER_S = 989e12       # H100 SXM bf16 tensor cores, dense
TF32_PASSES = 3                # the float32 kernels' split-precision products

PAGED_ATOL = 1e-4   # f32 math in both; only the summation order differs
FLASH_ATOL = 1e-4   # f32 kernels (3xTF32: ~2^-21 a product) vs the f32
                    # (non-TF32) plain matmuls
BF16_REL = 2e-2     # bf16 operands: x max|ref| (outputs rounded once each)
LOSS_RTOL = 1e-4    # BERT-base f32 loss, card vs host (summation order)
UPDATE_RTOL = 1e-2  # per-tensor LAMB update, relative in norm
LOGITS_ATOL = 2e-4  # 4 layers of f32 on card vs host BLAS, |logit| ~ 1
NEAR_TIE = 1e-3     # a greedy split is accepted only at a top-2 gap below

SERVE = dict(vocab_size=32000, embed_dim=4096, num_heads=32, num_layers=4,
             max_positions=4096, seed=0)
PROMPT_LENS = (77, 150, 233, 310, 401, 499, 587, 700)
NEW_TOKENS = 32
SHARE_SYSTEM = 512               # the shared system prompt: 32 blocks of 16
SHARE_TAILS = (64, 256)          # each request's own tail, drawn in range
SPEC_WINDOW = 4                  # TPUMX_SPECULATIVE in the spec-on runs
TOP_K, TOP_K_SEED = 40, 7
SERVE_FWD_T = (128, 700, 2048)   # the serving forward's timed prompt lengths
SERVE_FWD_ENTRY = 700            # the one in the kernels line

# the training slice: the reference benchmark's seq-512 BERT leg
TRAIN_BATCH, TRAIN_SEQ, TRAIN_MASKED = 32, 512, 76   # 15% of 512 masked
TRAIN_VALID = (384, 512)
TRAIN_STEPS = 5
TRAIN_F32_BATCH, TRAIN_F32_STEPS = 32, 3
FLASH_KERNELS = ("flash_attention_fwd", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv")
# the route each flash kernel takes per dtype, as the C entry points report
BF16_ROUTES = dict.fromkeys(FLASH_KERNELS, "wgmma")
F32_ROUTES = dict.fromkeys(FLASH_KERNELS, "tf32x3")

# the bias phase: BERT-base's attention width, four float32 bias layouts
BIAS_LAYOUTS = (("per_head", (1, 12, 512, 512)),
                ("per_row", (TRAIN_BATCH, 12, 512, 512)),
                ("shared", (1, 1, 512, 512)),
                ("alibi", (1, 12, 1, 512)))

# the ResNet slice: thin nets for parity, then the benchmark's recipe
RESNET_THIN = {"basic": [8, 8, 16, 32, 64],
               "bottleneck": [8, 16, 32, 64, 128]}
# batch 8 at 64x64: there float32 on the CPU keeps to float64 within
# 1.6e-5 in the losses over the three steps, in all four nets; at batch
# 4 the classic-stem Bottleneck net's third loss moves 8.4e-3 between
# the two (its max pools' near ties), beyond any float32 agreement
RESNET_PARITY_BATCH, RESNET_PARITY_SIZE, RESNET_PARITY_STEPS = 8, 64, 3
# the conv biases in front of a BatchNorm get no gradient in exact
# arithmetic (the norm removes any per-channel shift): their change is
# rounding, <= 3.4e-7 in norm at these shapes; the smallest real change
# of a tensor is 0.033
RESNET_UPDATE_ATOL = 1e-5
RESNET_BATCHES = (256, 128)     # the reference's ladder, bench.py:490
RESNET_SIZE, RESNET_CLASSES, RESNET_STEPS = 224, 1000, 5
RESNET50_TRAIN_FLOPS_PER_IMG = 24.54e9   # bench.py:74: 3 x 2 x 4.09 GMAC

# the PTB LSTM slice: thin word-LMs for parity, then the benchmark's recipe
LSTM_THIN = dict(vocab_size=200, num_embed=32, num_hidden=32, num_layers=2)
LSTM_PARITY_BPTT, LSTM_PARITY_BATCH, LSTM_PARITY_STEPS = 12, 8, 3
LSTM_PARITY_LR = 1.0                          # the recipe's
LSTM_CFG = dict(mode="lstm", vocab_size=10000, num_embed=650,
                num_hidden=650, num_layers=2, dropout=0.0)
LSTM_BATCHES = (2048, 1024, 512)    # the reference's ladder, bench.py:749
LSTM_BPTT, LSTM_STEPS = 35, 5
LSTM_FLOPS_PER_TOKEN = 79.6e6       # BASELINE.md:43: 26.5 MFLOP fwd x 3

# the SSD slice: thin SSDs for parity, then the benchmark's recipe
SSD_THIN = dict(num_classes=3, sizes=[[0.2, 0.35], [0.5, 0.7]],
                ratios=[[1, 2, 0.5]] * 2, base_filters=(8, 16))
SSD_PARITY_BATCH, SSD_PARITY_SIZE, SSD_PARITY_STEPS = 4, 64, 3
SSD_HEAD_RTOL = 2e-4    # f32 convolutions, card vs host, x max(1, |out|)
SSD_LOC_ATOL = 1e-6     # the targets' float32 arithmetic, card vs host
SSD_CLASSES, SSD_SIZE, SSD_STEPS = 20, 512, 5
SSD_BATCHES = (128, 64, 32)     # the reference's ladder, bench.py:834
SSD_ANCHORS = 24564     # maps 64/32/16/8/4/2/1, 4/6/6/6/6/4/4 a position
SSD_DETECT_BATCH = 8
# 3 x 179.1 GFLOP: the forward of VGG16-reduced SSD-512 at 512x512 is
# 89.54 GMAC, counted from the layer shapes of the reference's model
SSD512_TRAIN_FLOPS_PER_IMG = 537.2e9
# device-time groups of a step by kernel name: cuDNN's convolutions
# (implicit GEMMs, cuDNN's CUTLASS instances), reductions (BatchNorm's
# statistics, the L2 norm, the losses), the rest (elementwise work,
# copies, pooling, the target generation, the optimizer)
SSD_GROUPS = (("conv", ("fprop", "dgrad", "wgrad", "conv", "cudnn",
                        "xmma", "cutlass", "nvjet", "gemm")),
              ("reduce", ("reduce_kernel", "softmax", "norm_kernel")))

# the imperative surface: examples/mnist/train_mnist.py's recipe
MNIST_N, MNIST_BATCH, MNIST_EPOCHS, MNIST_LR = 8192, 128, 3, 0.05
MNIST_MIN_ACC = 0.9         # the example's own assert (train_mnist.py:85)
# memory_allocated over 100 steps: one step's saved activations are ~17 MB
# (conv1's and tanh's 5.9 MB each at batch 128), so a graph kept alive
# a step would pass this at once; the allocator's own churn is < 1 MB
MNIST_MEM_SLACK = 4 << 20
IMPERATIVE_PARITY_BATCH = 16

RTC_N = 1 << 26     # float32 elements: 256 MB an operand
RTC_SOURCE = r'''
extern "C" __global__ void scale(const float* __restrict__ x,
                                 float* __restrict__ y, float alpha, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) y[i] = x[i] * alpha;
}

extern "C" __global__ void addmul(const float* __restrict__ a,
                                  const float* __restrict__ b,
                                  float* __restrict__ o, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) o[i] = a[i] * b[i] + a[i];
}
'''


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def smi_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps=20, warm=3, queued=False):
    """Median milliseconds of ``fn`` by CUDA events.  With ``queued``
    the card first sleeps ~1 ms, so that ``fn``'s launches are queued
    before the start event runs and its host path stays out of the
    window (for kernels shorter than the host's launch path)."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if queued:
            torch.cuda._sleep(2_000_000)      # cycles: ~1 ms at 1.98 GHz
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(nbytes, flops, flop_rate=F32_FLOP_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flop_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def rates(flops, ms, bound_ms):
    """Achieved TFLOP/s and the share of the bound (bound_ms / ms)."""
    return dict(tflops=flops / (ms * 1e-3) / 1e12, bound_over_ms=bound_ms / ms)


def demangle(names):
    """Kernel names as ``cu++filt`` prints them, without the namespace."""
    from tpu_mx_torch.kernels import _build
    tool = _build.nvcc_path()[:-len("nvcc")] + "cu++filt"
    out = subprocess.run([tool, *names], capture_output=True, text=True,
                         check=True).stdout.splitlines()
    return [n.split("(anonymous namespace)::")[-1] for n in out]


SASS_OP = re.compile(r"/\*[0-9a-f]{4,}\*/\s+[@A-Z]")


def mma_counts(lib):
    """``{kernel: [HGMMA, HMMA, instructions, TF32 masks]}``: the numbers
    of wgmma and mma.sync tensor-core instructions in the library's SASS
    (``cuobjdump --dump-sass``), of all its instructions, and of the
    ``& 0xffffe000`` masks (or ``& ~0x1fff``) of the float32 kernels' TF32
    splits (nvcc keeps one such mask a split)."""
    from tpu_mx_torch.kernels import _build
    tool = _build.nvcc_path()[:-len("nvcc")] + "cuobjdump"
    sass = subprocess.run([tool, "--dump-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    names, counts = [], []
    for line in sass.splitlines():
        if "Function : " in line:
            names.append(line.split("Function : ")[1].strip())
            counts.append([0, 0, 0, 0])
        elif names and SASS_OP.search(line):
            c = counts[-1]
            c[0] += "HGMMA" in line
            c[1] += "HMMA" in line and "HGMMA" not in line
            c[2] += 1
            c[3] += "0xffffe000" in line or "0x1fff," in line
    return dict(zip(demangle(names), counts)) if names else {}


def tensor_core_kind(kernel):
    """Which tensor-core instruction an instance must hold: 0 HGMMA (the
    bf16 ``*_tc_kernel``s), 1 HMMA (the float32 ``*_tf32x3_kernel``s),
    None neither."""
    if "_tc_kernel" in kernel:
        return 0
    if "_tf32x3_kernel" in kernel:
        return 1
    return None


def phase_build(ctx):
    """Build every source; report ptxas's registers and spills per kernel
    and the HGMMA and HMMA counts per kernel.  The bf16 forward, dq and
    dk/dv instances (``*_tc_kernel``) must hold HGMMA instructions, the
    float32 forward, dq and dk/dv instances (``*_tf32x3_kernel``) HMMA,
    and neither may spill; every other kernel (paged) holds neither."""
    from tpu_mx_torch.kernels import _build
    t0 = time.perf_counter()
    libs = _build.build_all()
    secs = time.perf_counter() - t0
    report, mma, mix, wrong = {}, {}, {}, []
    for name, lib in libs.items():
        log = lib.with_suffix(".log")
        lines = log.read_text().splitlines() if log.exists() else []
        entries, kernel = [], None
        for line in lines:
            if "Compiling entry function" in line:
                kernel = line.split("'")[1]
            elif kernel and ("registers" in line or "spill" in line):
                entries.append((kernel, line.strip()))
        pretty = dict(zip(sorted({k for k, _ in entries}),
                          demangle(sorted({k for k, _ in entries}))))
        report[name] = [f"{pretty[k]}: {l}" for k, l in entries]
        counts = mma_counts(lib)
        mma[name] = {"hgmma_total": sum(c[0] for c in counts.values()),
                     "hmma_total": sum(c[1] for c in counts.values()),
                     "kernels": {k: c[:2] for k, c in counts.items()}}
        # the float32 kernels' instruction mix: their TF32 splits (one
        # mask each in the SASS; 3 to 5 instructions a split) beside the
        # HMMA, in the unrolled body of one tile
        for kernel, c in counts.items():
            if tensor_core_kind(kernel) == 1:
                short = re.sub(r"void |<unnamed>::|tmx_flash::", "",
                               kernel[:kernel.index(">(") + 1])
                mix[short] = dict(
                    instructions=c[2], hmma=c[1], splits=c[3],
                    split_share=[3 * c[3] / c[2], 5 * c[3] / c[2]],
                    hmma_share=c[1] / c[2])
        for kernel, c in counts.items():
            kind = tensor_core_kind(kernel)
            if [n > 0 for n in c[:2]] != [kind == 0, kind == 1]:
                wrong.append(f"{kernel}: {c[0]} HGMMA, {c[1]} HMMA")
        for kernel, line in entries:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if tensor_core_kind(pretty[kernel]) is not None and m and \
                    m.group(1, 2) != ("0", "0"):
                wrong.append(f"{pretty[kernel]}: {line}")
    ok = not wrong
    emit("build", ok=ok, seconds=secs, ptxas=report, mma=mma,
         mma_wrong=wrong, f32_mix=mix)
    if not ok:
        ctx["failures"].append(f"build: tensor-core instructions where not "
                               f"expected or missing, or a tensor-core "
                               f"kernel spills: {wrong[:4]}")


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
            before = dict(pa.paged_attention.routes)
            out = pa.paged_attention(q, kp, vp, tab, lens)
            route = "+".join(r for r, n in pa.paged_attention.routes.items()
                             if n > before[r]) or "none"
            ref = pa.paged_attention_plain(q, kp, vp, tab, lens, scale)
            torch.cuda.synchronize()
            err = float((out - ref).abs().max())
            ok = math.isfinite(err) and err <= PAGED_ATOL
            call = lambda: pa.paged_attention(q, kp, vp, tab, lens)
            ms = cuda_ms(torch, call)
            ms_queued = cuda_ms(torch, call, queued=True)
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
            rec = dict(shape=shape, ms=ms, ms_queued=ms_queued,
                       plain_ms=plain_ms, library_ms=None, bound_ms=b_ms,
                       bound_by=b_by, math_route=route,
                       **rates(flops, ms, b_ms))
            emit("kernel", name="paged_attention", max_abs_err=err,
                 atol=PAGED_ATOL, ok=ok, **rec)
            worst["paged_attention"] = max(worst["paged_attention"], err)
            if not ok:
                ctx["failures"].append(f"paged_attention {shape}: err {err}")
            if tq == 1 and dtype == torch.float32:
                entries["paged_attention"] = rec
            if tq == 4 and dtype == torch.float32:
                ctx["paged_tq4"] = rec

    bh, d = 32, 128
    for t in SERVE_FWD_T:
        q, k, v = (torch.randn((bh, t, d), generator=gen).cuda()
                   for _ in range(3))
        scale = 1.0 / math.sqrt(d)
        out, lse = fa.flash_attention(q, k, v, causal=True, return_lse=True)
        ref, ref_lse = fa.flash_attention_plain(q, k, v, scale, causal=True)
        torch.cuda.synchronize()
        err = float(max((out - ref).abs().max(), (lse - ref_lse).abs().max()))
        ok = math.isfinite(err) and err <= FLASH_ATOL
        before = routes_of(fa)
        call = lambda: fa.flash_attention(q, k, v, causal=True)
        ms = cuda_ms(torch, call)
        ms_queued = cuda_ms(torch, call, queued=True)
        route = route_since(fa, "flash_attention_fwd", before)
        plain_ms = cuda_ms(torch, lambda: fa.flash_attention_plain(
            q, k, v, scale, causal=True), reps=5)
        q4, k4, v4 = (x.view(1, bh, t, d) for x in (q, k, v))
        sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(
            q4, k4, v4, is_causal=True)
        lib_ms = cuda_ms(torch, sdpa)
        lib_queued = cuda_ms(torch, sdpa, queued=True)
        nbytes = 4 * bh * t * d * 4 + bh * t * 4
        flops = 2 * t * (t + 1) * d * bh
        b_ms, b_by = bound(nbytes, TF32_PASSES * flops, TF32_FLOP_PER_S)
        ffma_ms, ffma_by = bound(nbytes, flops)
        shape = f"BH=32 T={t} D=128 causal f32"
        rec = dict(shape=shape, ms=ms, ms_queued=ms_queued,
                   plain_ms=plain_ms, library_ms=lib_ms,
                   library_ms_queued=lib_queued, bound_ms=b_ms,
                   bound_by=b_by, bound_ms_ffma=ffma_ms,
                   bound_by_ffma=ffma_by, math_route=route,
                   **rates(flops, ms, b_ms))
        emit("kernel", name="flash_attention_fwd", max_abs_err=err,
             atol=FLASH_ATOL, ok=ok, **rec)
        worst["flash_attention_fwd"] = max(worst["flash_attention_fwd"], err)
        if not ok or route != "tf32x3":
            ctx["failures"].append(f"flash_attention_fwd {shape}: err {err}, "
                                   f"route {route}")
        if t == SERVE_FWD_ENTRY:
            ctx["serve_fwd"] = rec
    flash_f32_precision(torch, fa, ctx)
    flash_f32_bwd_precision(torch, fa, ctx)
    flash_train_kernels(torch, fa, gen, ctx, entries, worst)
    flash_mask_bits(torch, fa, ctx)
    for name, e in entries.items():
        e["max_abs_err"] = worst[name]
    ctx["kernels"] = entries
    emit("kernels", held=sorted(entries))


def flash_f32_precision(torch, fa, ctx):
    """The float32 forward at large scores (|q.k| up to ~400 at scale 1)
    against float64: within the bounds of its arithmetic (derived in
    ``tests/test_torch_cuda.py::test_f32_forward_is_not_one_tf32_pass``,
    the same inputs), and one TF32 pass at least 50 times further off."""
    gen = torch.Generator().manual_seed(9)
    q, k = ((torch.randn((2, 96, 128), generator=gen) * 3).cuda()
            for _ in range(2))
    v = torch.randn((2, 96, 128), generator=gen).cuda()
    d, tk = q.shape[-1], k.shape[1]
    s = q.double() @ k.double().transpose(1, 2)
    exact = (torch.softmax(s, -1) @ v.double(), torch.logsumexp(s, -1))
    tf32 = lambda x: ((x.view(torch.int32) + 0x1000) & -0x2000) \
        .view(torch.float32)
    err = lambda got: [float((a.double() - b).abs().max())
                       for a, b in zip(got, exact)]
    kernel = err(fa.flash_attention(q, k, v, scale=1.0, return_lse=True))
    one_pass = err(fa.flash_attention_plain(tf32(q), tf32(k), tf32(v), 1.0))
    plain = err(fa.flash_attention_plain(q, k, v, 1.0))
    big = float((q.abs() @ k.abs().transpose(1, 2)).max())
    e_s = (3 * 2 ** -22 + 3 * d / 8 * 2 ** -23) * big
    e_pv = 3 * 2 ** -22 + 3 * tk / 8 * 2 ** -23 + tk * 2 ** -23
    bounds = [(2 * e_s + e_pv) * float(v.abs().max()), e_s + tk * 2 ** -23]
    ok = all(e <= b and o >= 50 * e
             for e, b, o in zip(kernel, bounds, one_pass))
    emit("f32_precision", ok=ok, shape="BH=2 T=96 D=128 f32 scale 1",
         error_out_lse=kernel, bound_out_lse=bounds,
         one_pass_out_lse=one_pass, plain_f32_out_lse=plain)
    if not ok:
        ctx["failures"].append(f"f32 forward precision: {kernel} against "
                               f"bounds {bounds}, one pass {one_pass}")


def flash_f32_bwd_precision(torch, fa, ctx):
    """The float32 dq and dk/dv at large scores (|q.k| up to ~400 at scale
    1) against float64, fed the float64 lse and delta: within
    ``fa.f32_bwd_error_bounds`` everywhere, and the plain backward on q, k, v
    and dO rounded to TF32 (one TF32 pass) at least 50 times further
    off."""
    gen = torch.Generator().manual_seed(9)
    q, k = ((torch.randn((2, 96, 128), generator=gen) * 3).cuda()
            for _ in range(2))
    v, do = (torch.randn((2, 96, 128), generator=gen).cuda()
             for _ in range(2))
    exact, bounds, lse, delta = fa.f32_bwd_error_bounds(q, k, v, do)
    tf32 = lambda x: ((x.view(torch.int32) + 0x1000) & -0x2000) \
        .view(torch.float32)
    args = (lse.float(), delta.float(), 1.0)
    kernel = (fa.flash_attention_bwd_dq(q, k, v, do, *args),
              *fa.flash_attention_bwd_dkv(q, k, v, do, *args))
    one_pass = fa.flash_attention_bwd_plain(tf32(q), tf32(k), tf32(v),
                                            tf32(do), *args)
    err = lambda got: [(a.double() - b).abs() for a, b in zip(got, exact)]
    e_kernel, e_one = err(kernel), err(one_pass)
    within = [bool((e <= b).all()) for e, b in zip(e_kernel, bounds)]
    worst = [float(e.max()) for e in e_kernel]
    one = [float(e.max()) for e in e_one]
    ok = all(within) and all(o >= 50 * w for o, w in zip(one, worst))
    emit("f32_bwd_precision", ok=ok, shape="BH=2 T=96 D=128 f32 scale 1",
         error_dq_dk_dv=worst, within_bounds=within,
         bound_dq_dk_dv=[float(b.max()) for b in bounds],
         one_pass_dq_dk_dv=one)
    if not ok:
        ctx["failures"].append(f"f32 backward precision: {worst}, within "
                               f"{within}, one pass {one}")


def tc_work(flops, f32):
    """(operations, rate) of a flash kernel's bound: the float32 kernels'
    three TF32 products on the tensor cores, else bf16."""
    return (TF32_PASSES * flops, TF32_FLOP_PER_S) if f32 else \
        (flops, BF16_FLOP_PER_S)


def flash_work(bh, t, d, causal, valid, elt):
    """(operations per product, bytes of (q or dO), of the valid k/v rows,
    of the float32 per-row vectors) of one flash call: the work these
    inputs need — keys past kv_valid and above the diagonal are none."""
    if causal:
        pairs = sum(sum(min(i + 1, n) for i in range(t)) for n in valid)
    else:
        pairs = t * sum(valid)
    return 2 * pairs * d, bh * t * d * elt, sum(valid) * d * elt, bh * t * 4


# the wrapper of each flash kernel; its C entry point reports the kernel
# it launched
ROUTED = {"flash_attention_fwd": "flash_attention",
          "flash_attention_bwd_dq": "flash_attention_bwd_dq",
          "flash_attention_bwd_dkv": "flash_attention_bwd_dkv"}


def routes_of(fa):
    """Copies of the route counts of the wrappers that report one."""
    return {name: dict(getattr(fa, w).routes) for name, w in ROUTED.items()}


def route_since(fa, name, before):
    """The routes (``wgmma``, ``tf32x3``, joined by ``+`` if both) that the
    C entry point reported for ``name``'s launches since ``before``."""
    now = getattr(fa, ROUTED[name]).routes
    return "+".join(r for r in now if now[r] > before[name][r]) or \
        "none"


def flash_case(torch, fa, gen, bh, t, d, dtype, causal, rate, valid):
    """The forward, dq and dk/dv kernels against the plain forward and
    backward at one shape; returns one record per kernel."""
    dev = "cuda"
    q, k, v, do = (torch.randn((bh, t, d), generator=gen).to(dev, dtype)
                   for _ in range(4))
    kv = torch.tensor(valid, dtype=torch.int32, device=dev)
    seed = torch.randint(0, 2 ** 31 - 1, (1,), generator=gen,
                         dtype=torch.int32).to(dev)
    scale = 1.0 / math.sqrt(d)
    opts = dict(causal=causal, kv_valid=kv, dropout_rate=rate,
                dropout_seed=seed)
    out, lse = fa.flash_attention(q, k, v, return_lse=True, **opts)
    ref, ref_lse = fa.flash_attention_plain(q, k, v, scale, causal, kv,
                                            rate, seed)
    delta = fa.flash_attention_delta(do, ref)
    args = (q, k, v, do, ref_lse, delta, scale, causal, kv, rate, seed)
    dq = fa.flash_attention_bwd_dq(*args)
    dk, dv = fa.flash_attention_bwd_dkv(*args)
    want = fa.flash_attention_bwd_plain(*args)
    torch.cuda.synchronize()

    f32 = dtype == torch.float32
    tol = lambda ref_t: FLASH_ATOL if f32 else \
        BF16_REL * float(ref_t.abs().max())
    err = lambda a, b: float((a.float() - b.float()).abs().max())
    lse_err = err(lse, ref_lse)   # float32 in both: the float32 tolerance
    checks = {
        "flash_attention_fwd": (err(out, ref), tol(ref),
                                lse_err <= FLASH_ATOL),
        "flash_attention_bwd_dq": (err(dq, want[0]), tol(want[0]), True),
        "flash_attention_bwd_dkv": (max(err(dk, want[1]), err(dv, want[2])),
                                    min(tol(want[1]), tol(want[2])), True),
    }

    calls = {"flash_attention_fwd": lambda: fa.flash_attention(
                 q, k, v, return_lse=True, **opts),
             "flash_attention_bwd_dq": lambda: fa.flash_attention_bwd_dq(
                 *args),
             "flash_attention_bwd_dkv": lambda: fa.flash_attention_bwd_dkv(
                 *args)}
    before = routes_of(fa)
    ms = {name: cuda_ms(torch, call) for name, call in calls.items()}
    queued = {name: cuda_ms(torch, call, queued=True)
              for name, call in calls.items()}
    routes = {name: route_since(fa, name, before) for name in calls}
    plain_fwd = cuda_ms(torch, lambda: fa.flash_attention_plain(
        q, k, v, scale, causal, kv, rate, seed), reps=5, warm=1)
    plain_bwd = cuda_ms(torch, lambda: fa.flash_attention_bwd_plain(*args),
                        reps=5, warm=1)

    # the library yardstick: SDPA with a boolean key mask, no dropout
    sdpa = torch.nn.functional.scaled_dot_product_attention
    mask = torch.arange(t, device=dev)[None, :] < kv[:, None].long()
    mask = mask[None, :, None, :]                          # (1, BH, 1, T)
    if causal:
        mask = mask & torch.ones((t, t), dtype=torch.bool,
                                 device=dev).tril()[None, None]
    q4, k4, v4, do4 = (x.view(1, bh, t, d) for x in (q, k, v, do))
    lib_fwd = cuda_ms(torch, lambda: sdpa(q4, k4, v4, attn_mask=mask))
    leaves = [x.detach().requires_grad_() for x in (q4, k4, v4)]
    lib_out = sdpa(*leaves, attn_mask=mask)
    lib_bwd = cuda_ms(torch, lambda: torch.autograd.grad(
        lib_out, leaves, do4, retain_graph=True))
    lib_both = cuda_ms(torch, lambda: torch.autograd.grad(
        sdpa(*leaves, attn_mask=mask), leaves, do4))
    del lib_out

    elt = q.element_size()
    fpm, qb, kvb, rowb = flash_work(bh, t, d, causal, valid, elt)
    flops = {"flash_attention_fwd": 2 * fpm, "flash_attention_bwd_dq": 3 * fpm,
             "flash_attention_bwd_dkv": 4 * fpm}
    nbytes = {"flash_attention_fwd": 2 * qb + 2 * kvb + rowb + 4 * bh,
              "flash_attention_bwd_dq": 3 * qb + 2 * kvb + 2 * rowb + 4 * bh,
              "flash_attention_bwd_dkv": 2 * qb + 2 * kvb + 2 * rowb
              + 2 * bh * t * d * elt + 4 * bh}
    bounds = {n: bound(nbytes[n], *tc_work(flops[n], f32)) for n in flops}
    shape = (f"BH={bh} T={t} D={d} {str(dtype).split('.')[-1]} "
             f"{'causal' if causal else 'non-causal'} kv_valid "
             f"{min(valid)}-{max(valid)} dropout {rate}")
    recs = {}
    for name in FLASH_KERNELS:
        e, atol, also = checks[name]
        b_ms, b_by = bounds[name]
        fwd = name == "flash_attention_fwd"
        recs[name] = dict(
            shape=shape, max_abs_err=e, atol=atol,
            ok=(math.isfinite(e) and e <= atol and also and routes[name]
                == (F32_ROUTES if f32 else BF16_ROUTES)[name]),
            ms=ms[name],
            ms_queued=queued[name],
            plain_ms=plain_fwd if fwd else plain_bwd,
            library_ms=lib_fwd if fwd else lib_bwd,
            library_fwd_bwd_ms=lib_both, bound_ms=b_ms, bound_by=b_by,
            math_route=routes[name],
            **rates(flops[name], ms[name], b_ms))
        if f32:   # the same work at the FFMA rate, beside the bound
            recs[name]["bound_ms_ffma"], recs[name]["bound_by_ffma"] = bound(
                nbytes[name], flops[name])
    recs["flash_attention_fwd"]["lse_max_abs_err"] = lse_err
    return recs


ENTRY_KEYS = ("shape", "ms", "ms_queued", "plain_ms", "library_ms",
              "bound_ms", "bound_by", "tflops", "bound_over_ms", "math_route")


def flash_train_kernels(torch, fa, gen, ctx, entries, worst):
    """BERT's shapes (BH = 32 x 12, T = 512, D = 64, bf16, kv_valid per
    batch row over 384-512, dropout 0 and 0.1), a float32 causal case
    with kv_valid (BH = 32, T = 700, D = 128, dropout 0 and 0.1) and
    BERT's shape in float32 (dropout 0.1), the ``train_f32`` step's."""
    b, h = TRAIN_BATCH, 12
    rows = torch.randint(TRAIN_VALID[0], TRAIN_VALID[1] + 1, (b,),
                         generator=gen).repeat_interleave(h).tolist()
    f32_valid = torch.randint(350, 701, (32,), generator=gen).tolist()
    f32 = {}
    for key, dtype, bh, t, d, causal, valid, rates in (
            ("bf16", torch.bfloat16, b * h, TRAIN_SEQ, 64, False, rows,
             (0.0, 0.1)),
            ("t700", torch.float32, 32, 700, 128, True, f32_valid, (0.0, 0.1)),
            ("bert", torch.float32, b * h, TRAIN_SEQ, 64, False, rows,
             (0.1,))):
        for rate in rates:
            recs = flash_case(torch, fa, gen, bh, t, d, dtype, causal, rate,
                              valid)
            for name, r in recs.items():
                emit("kernel", name=name, launches_per_train_step=12, **r)
                if not r["ok"]:
                    ctx["failures"].append(f"{name} {r['shape']}: err "
                                           f"{r['max_abs_err']}")
                worst[name] = max(worst.get(name, 0.0), r["max_abs_err"])
                if rate == 0:
                    continue
                if key == "bf16":
                    entries[name] = {k: r[k] for k in ENTRY_KEYS}
                else:
                    f32.setdefault(name, {})[key] = {k: r[k] for k in (
                        ENTRY_KEYS + ("max_abs_err", "bound_ms_ffma",
                                      "bound_by_ffma"))}
            torch.cuda.empty_cache()
    ctx["f32_kernels"] = f32


def flash_mask_bits(torch, fa, ctx):
    """The forward kernel's dropout mask, read out through its output at
    BERT's shape, against ``dropout_keep_mask`` bit for bit, and its keep
    rate: with q = 0 every probability is 1/T, and V one-hot over a chunk
    of D keys puts each kept key in its own output column."""
    bh, t, d, rate = TRAIN_BATCH * 12, TRAIN_SEQ, 64, 0.1
    dev = "cuda"
    seed = torch.tensor([20261016], dtype=torch.int32, device=dev)
    q = torch.zeros((bh, t, d), dtype=torch.bfloat16, device=dev)
    ar = lambda lo, hi, shape: torch.arange(lo, hi, device=dev).reshape(shape)
    mismatched = kept = 0
    for c in range(t // d):
        v = torch.zeros((bh, t, d), dtype=torch.bfloat16, device=dev)
        v[:, c * d:(c + 1) * d] = torch.eye(d, device=dev)
        got = fa.flash_attention(q, q, v, dropout_rate=rate,
                                 dropout_seed=seed) > 0
        want = fa.dropout_keep_mask(seed, ar(0, bh, (bh, 1, 1)),
                                    ar(0, t, (1, t, 1)),
                                    ar(c * d, (c + 1) * d, (1, 1, d)), rate)
        mismatched += int((got != want).sum())
        kept += int(want.sum())
    draws = bh * t * t
    keep_rate = kept / draws
    ok = mismatched == 0 and abs(keep_rate - (1 - rate)) <= 0.005
    emit("dropout_mask", ok=ok, shape=f"BH={bh} T={t} bf16", rate=rate,
         draws=draws, mismatched_bits=mismatched, keep_rate=keep_rate,
         keep_rate_tolerance=0.005)
    if not ok:
        ctx["failures"].append(f"dropout mask: {mismatched} bits differ, "
                               f"keep rate {keep_rate}")


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
    fa.flash_attention.routes = fa.route_counts()
    pa.paged_attention.launches = 0
    pa.paged_attention.routes = dict.fromkeys(pa.ROUTES, 0)
    tracing.reset()
    reqs = [srv.submit(p, max_new_tokens=NEW_TOKENS) for p in prompts]
    t1 = time.perf_counter()
    steps = srv.run_until_idle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    flash_n = fa.flash_attention.launches
    paged_n = pa.paged_attention.launches
    prefill_routes = dict(fa.flash_attention.routes)
    ctx["decode_routes"] = decode_routes = dict(pa.paged_attention.routes)
    ctx["launches"] = {"flash_attention_fwd": flash_n,
                       "paged_attention": paged_n}
    ctx["serve_model"], ctx["serve_prompts"] = model, prompts

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
        # every prefill ran the float32 forward on the tensor cores
        "prefill_tf32x3": prefill_routes == dict(
            fa.route_counts(), tf32x3=flash_n),
        # and every decode step the paged kernel split over the keys
        "decode_split_k": decode_routes == {"split_k": paged_n},
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
         launches=ctx["launches"], prefill_routes=prefill_routes,
         decode_routes=decode_routes,
         prefill_logits_max_abs_err=logits_err,
         logits_atol=LOGITS_ATOL, stream_equal=split is None,
         stream_split_at=split, top2_gap_at_split=gap, near_tie=NEAR_TIE,
         card=ctx["smi"])
    for name, ok in checks.items():
        if not ok:
            ctx["failures"].append(f"serve check {name} failed")


def stream_splits(model, prompts, got, want):
    """Where each pair of greedy streams first differs (None: equal), and
    the top-2 logit gap of ``want``'s prefix there (the card's own
    full-prefill logits)."""
    out = []
    for p, g, w in zip(prompts, got, want):
        split = next((i for i, (a, b) in enumerate(zip(g, w)) if a != b),
                     None)
        if split is None and len(g) != len(w):
            split = min(len(g), len(w))
        gap = None if split is None else \
            top2_gap(model.prefill(list(p) + w[:split])[2].cpu())
        out.append((split, gap))
    return out


def splits_ok(splits):
    return all(s is None or g <= NEAR_TIE for s, g in splits)


def serve_run(torch, srv, prompts, new_tokens, track=None):
    """Drive ``srv`` over ``prompts`` from counts at 0: the streams, the
    wall seconds, the kernels' launch counts and routes, the prefill and
    decode events, and the peak of blocks held (read each step)."""
    from tpu_mx_torch import telemetry, tracing
    from tpu_mx_torch.kernels import flash_attention as fa
    from tpu_mx_torch.kernels import paged_attention as pa
    reset_port_kernel_launches()
    fa.flash_attention.routes = fa.route_counts()
    pa.paged_attention.routes = dict.fromkeys(pa.ROUTES, 0)
    pa.paged_attention.windows = {}
    tracing.reset()
    telemetry.reset()
    reqs = [srv.submit(p, max_new_tokens=new_tokens, request_id=f"f{i}")
            for i, p in enumerate(prompts)]
    if track is not None:
        track(reqs)
    cache = srv.engine.cache
    peak = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while not srv.scheduler.idle():
        srv.step()
        peak = max(peak, cache.allocator.used)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    events = tracing.snapshot()
    prefills = [e["data"] for e in events if e["event"] == "serve.prefill"]
    decode_s = [e["data"]["seconds"] for e in events
                if e["event"] == "serve.decode"]
    kinds = {k: (telemetry.get("serve.prefill_attention", kind=k).value
                 if telemetry.get("serve.prefill_attention", kind=k)
                 else 0) for k in ("flash", "dense")}
    ratio = telemetry.get("serve.spec_accept_ratio")
    return dict(
        streams=[r.tokens for r in reqs],
        done=all(r.state == "done" and len(r.tokens) == new_tokens
                 for r in reqs),
        wall_seconds=wall,
        tokens_per_sec=sum(len(r.tokens) for r in reqs) / wall,
        launches=port_kernel_launches(),
        flash_routes=dict(fa.flash_attention.routes),
        paged_routes=dict(pa.paged_attention.routes),
        paged_windows=dict(pa.paged_attention.windows),
        prefill_ms=[d["seconds"] * 1e3 for d in prefills],
        cached=[d["cached"] for d in prefills],
        decode_steps=len(decode_s),
        decode_step_ms_median=statistics.median(decode_s) * 1e3
        if decode_s else None,
        prefill_attention=kinds, peak_blocks=peak,
        accept_ratio=ratio.value if ratio is not None else None)


def _record(run):
    """A run's numbers for the phase's line (its streams left out)."""
    return {k: v for k, v in run.items() if k != "streams"}


def window_logits_diff(torch, model, prompt, stream, k=SPEC_WINDOW):
    """Max |logit| difference between one Tq=``k`` verify step over
    ``stream[:k]`` and ``k`` one-token steps over the same tokens, both
    after one prefill of ``prompt``: the last position's logits."""
    from tpu_mx_torch.serving import PagedKVCache

    class Given:
        def draft(self, last_tokens, positions, n):
            return torch.tensor([stream[1:n + 1]], device=model.device)

    out = []
    for steps in ([k], [1] * k):
        cache = PagedKVCache(model.num_layers, model.num_heads,
                             model.head_dim, num_blocks=128,
                             device=model.device)
        kv = model.prefill(prompt)
        cache.prefill("a", kv[0], kv[1])
        done = 0
        for w in steps:
            cache.reserve_window("a", w)
            tables, lengths = cache.batch_tables(["a"])
            bids, offs = cache.window_slots(["a"], w)
            logits = model.decode_step(
                cache, [stream[done]], lengths - w, tables, lengths, bids,
                offs, proposer=Given(), want_logits=True)[3]
            done += w
        out.append(logits)
    return float(np.abs(out[0] - out[1]).max())


class OracleProposer:
    """Drafts the known greedy stream: the token each position held in a
    reference run (the 8 requests' positions do not overlap)."""

    def __init__(self, prompts, streams):
        self.at = {}
        for p, s in zip(prompts, streams):
            seq = list(p) + list(s)
            for pos in range(len(p), len(seq)):
                assert pos not in self.at, "overlapping positions"
                self.at[pos] = seq[pos]

    def draft(self, last_tokens, positions, n):
        pos = positions.tolist()
        return np.array([[self.at.get(p + 1 + j, 0) for j in range(n)]
                         for p in pos], np.int64)


def phase_serve_features(ctx):
    import os
    import torch
    from tpu_mx_torch.serving import Server, TinyLM
    from tpu_mx_torch.serving.sampling import TopKSampler

    model = ctx.pop("serve_model", None) or TinyLM(**SERVE, device="cuda")
    prompts = ctx.pop("serve_prompts", None)
    if prompts is None:
        rng = np.random.RandomState(1)
        prompts = [rng.randint(0, SERVE["vocab_size"], size=n).tolist()
                   for n in PROMPT_LENS]
    layers = SERVE["num_layers"]
    kw = dict(max_batch=8, block_size=16, num_blocks=1024)
    checks, launches = {}, dict.fromkeys(port_kernel_launches(), 0)

    def count(run):
        for k, n in run["launches"].items():
            launches[k] += n

    # (a) shared-prefix KV reuse: sharing off and on, in turns, twice
    rng = np.random.RandomState(2)
    system = rng.randint(0, SERVE["vocab_size"], SHARE_SYSTEM).tolist()
    shared = [system + rng.randint(0, SERVE["vocab_size"], n).tolist()
              for n in rng.randint(SHARE_TAILS[0], SHARE_TAILS[1] + 1, 8)]
    share = {False: [], True: []}
    for on in (False, True, False, True):
        srv = Server(model, prefix_sharing=on, **kw)
        run = serve_run(torch, srv, shared, NEW_TOKENS)
        stats = srv.engine.cache.prefix_stats()
        srv.engine.cache.drop_prefix_cache()
        run.update(hits=stats.get("hits", 0),
                   prefill_bytes_saved=stats["prefill_bytes_saved"],
                   refcounts_after_drop=len(
                       srv.engine.cache.allocator.refcounts()))
        share[on].append(run)
        count(run)
        del srv
    off = share[False][0]
    # the card's suffix prefill (dense) against its full one (tf32x3)
    kv = model.prefill(system)
    suffix = model.prefill_suffix(shared[1][SHARE_SYSTEM:], SHARE_SYSTEM,
                                  kv[0], kv[1])[2]
    share_logits_err = float(
        (model.prefill(shared[1])[2] - suffix).abs().max())
    del kv
    share_splits = [stream_splits(model, shared, r["streams"], off["streams"])
                    for r in share[False][1:] + share[True]]
    checks.update(
        share_done=all(r["done"] for r in share[False] + share[True]),
        share_hits=all(r["hits"] >= len(shared) - 1 for r in share[True]),
        share_fewer_blocks=all(r["peak_blocks"] < off["peak_blocks"]
                               for r in share[True]),
        share_fewer_flash=all(
            r["launches"]["flash_attention_fwd"]
            < off["launches"]["flash_attention_fwd"] for r in share[True]),
        share_suffix_dense=all(
            r["prefill_attention"]["dense"] == layers * r["hits"]
            for r in share[True]),
        share_full_tf32x3=all(
            r["flash_routes"].get("tf32x3") == r["launches"][
                "flash_attention_fwd"] > 0
            for r in share[False] + share[True]),
        share_refs_dropped=all(r["refcounts_after_drop"] == 0
                               for r in share[False] + share[True]),
        share_streams=all(splits_ok(s) for s in share_splits))

    # (b) speculative decoding: off, at 4, and at 4 with an oracle
    prior = os.environ.get("TPUMX_SPECULATIVE")
    spec = {}
    try:
        for name, window in (("off", "0"), ("on", str(SPEC_WINDOW)),
                             ("oracle", str(SPEC_WINDOW))):
            os.environ["TPUMX_SPECULATIVE"] = window
            srv = Server(model, **kw)
            if name == "oracle":
                srv.engine.proposer = OracleProposer(
                    prompts, spec["off"]["streams"])
            spec[name] = serve_run(torch, srv, prompts, NEW_TOKENS)
            count(spec[name])
            del srv
    finally:
        if prior is None:
            os.environ.pop("TPUMX_SPECULATIVE", None)
        else:
            os.environ["TPUMX_SPECULATIVE"] = prior
    spec_splits = {n: stream_splits(model, prompts, spec[n]["streams"],
                                    spec["off"]["streams"])
                   for n in ("on", "oracle")}
    spec_logits_err = window_logits_diff(torch, model, prompts[0],
                                         spec["off"]["streams"][0])
    checks.update(
        spec_done=all(r["done"] for r in spec.values()),
        spec_tq4_split_k=all(
            spec[n]["paged_windows"] == {
                SPEC_WINDOW: layers * spec[n]["decode_steps"]}
            and spec[n]["paged_routes"] == {
                "split_k": spec[n]["launches"]["paged_attention"]}
            and spec[n]["decode_steps"] > 0 for n in ("on", "oracle")),
        spec_off_tq1=spec["off"]["paged_windows"] == {
            1: layers * spec["off"]["decode_steps"]},
        spec_streams=all(splits_ok(s) for s in spec_splits.values()),
        spec_oracle_quarter=spec["oracle"]["decode_steps"]
        <= -(-spec["off"]["decode_steps"] // SPEC_WINDOW) + 1)

    # (c) top-k sampling: two servers with one seed; request 0's sampler
    # is checked token by token and its state captured mid-stream
    topk, seen = [], {"outside_top_k": 0, "sample_ms": 0.0}
    trace = {"logits": [], "tokens": [], "state": None}

    def track(reqs):
        for r in reqs:
            sampler, draw = r.sampler, r.sampler.sample

            def sample(logits, sampler=sampler, draw=draw,
                       first=r is reqs[0]):
                if first and len(trace["tokens"]) == NEW_TOKENS // 2:
                    trace["state"] = sampler.state_dict()
                t0 = time.perf_counter()
                tok = draw(logits)
                seen["sample_ms"] += (time.perf_counter() - t0) * 1e3
                top = np.argpartition(np.asarray(logits), -TOP_K)[-TOP_K:]
                seen["outside_top_k"] += int(tok not in top)
                if first:
                    trace["logits"].append(np.array(logits))
                    trace["tokens"].append(tok)
                return tok
            sampler.sample = sample

    for i in range(2):
        srv = Server(model, sampling=f"top_k:{TOP_K}",
                     sampling_seed=TOP_K_SEED, **kw)
        topk.append(serve_run(torch, srv, prompts, NEW_TOKENS,
                              track=track if i == 0 else None))
        count(topk[-1])
        del srv
    resumed = TopKSampler(TOP_K, seed=0)
    half = NEW_TOKENS // 2
    resumed.load_state_dict(trace["state"])
    checks.update(
        topk_done=all(r["done"] for r in topk),
        topk_equal=topk[0]["streams"] == topk[1]["streams"],
        topk_in_top_k=seen["outside_top_k"] == 0,
        topk_state_resumes=[resumed.sample(x) for x in
                            trace["logits"][half:]]
        == trace["tokens"][half:] == topk[0]["streams"][0][half:])

    ctx["serve_features_launches"] = launches
    ctx["serve_features_tq4"] = spec["on"]["paged_windows"].get(SPEC_WINDOW,
                                                                0)
    emit("serve_features", ok=all(checks.values()), checks=checks,
         model={**SERVE, **kw}, new_tokens=NEW_TOKENS,
         sharing={"system_tokens": SHARE_SYSTEM,
                  "prompt_lens": [len(p) for p in shared],
                  "off": [_record(r) for r in share[False]],
                  "on": [_record(r) for r in share[True]],
                  "splits": share_splits,
                  "suffix_logits_max_abs_diff": share_logits_err},
         speculative={"window": SPEC_WINDOW,
                      **{n: _record(r) for n, r in spec.items()},
                      "splits": spec_splits,
                      "window_logits_max_abs_diff": spec_logits_err},
         top_k={"k": TOP_K, "seed": TOP_K_SEED,
                "runs": [_record(r) for r in topk],
                "greedy_tokens_per_sec": spec["off"]["tokens_per_sec"],
                "greedy_step_ms_median": spec["off"][
                    "decode_step_ms_median"],
                "host_sample_ms_per_step": seen["sample_ms"]
                / max(1, topk[0]["decode_steps"] + 1)},
         launches=launches, card=ctx["smi"])
    for name, ok in checks.items():
        if not ok:
            ctx["failures"].append(f"serve_features check {name} failed")


def bert_batch(cfg, batch, seq, n_masked, valid, rng):
    """Tokens, token types, valid lengths, masked positions (inside each
    row's valid length) and their labels, as the benchmark draws them."""
    tokens = rng.randint(4, cfg["vocab_size"], (batch, seq)).astype(np.int32)
    types = np.zeros((batch, seq), np.int32)
    valid = np.asarray(valid, np.int32)
    positions = np.stack([rng.choice(n, n_masked, replace=False)
                          for n in valid]).astype(np.int32)
    labels = np.take_along_axis(tokens, positions, axis=1)
    return tokens, types, valid, positions, labels


def phase_train_parity(ctx):
    """One LAMB step of BERT-base (12 layers, full width, float32, dropout
    0) on the card and on the CPU from the same weights."""
    import torch
    from tpu_mx_torch import optimizer
    from tpu_mx_torch.models import BERTModel, MLMLoss, bert_base_config
    from tpu_mx_torch.parallel import CompiledTrainStep

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dict(bert_base_config(max_len=512), dropout=0.0)
    t0 = time.perf_counter()
    cpu = BERTModel(cfg, device="cpu",
                    generator=torch.Generator().manual_seed(0))
    gpu = BERTModel.from_numpy(
        {n: p.detach().numpy() for n, p in cpu.named_parameters()}, cfg,
        device="cuda")
    before = {n: p.detach().clone() for n, p in cpu.named_parameters()}
    batch = bert_batch(cfg, 2, 128, 19, (128, 97), np.random.RandomState(2))
    losses = {}
    for name, net, dev in (("cpu", cpu, "cpu"), ("cuda", gpu, "cuda")):
        opt = optimizer.create("lamb", learning_rate=1e-4)
        step = CompiledTrainStep(net, MLMLoss(), opt, device=dev)
        losses[name] = float(step.step(*batch))
    loss_rel = abs(losses["cuda"] - losses["cpu"]) / abs(losses["cpu"])
    worst, worst_name = 0.0, None
    params_gpu = dict(gpu.named_parameters())
    for n, p in cpu.named_parameters():
        d_cpu = p.detach() - before[n]
        d_gpu = params_gpu[n].detach().cpu() - before[n]
        rel = float((d_gpu - d_cpu).norm() / d_cpu.norm().clamp_min(1e-30))
        if rel > worst:
            worst, worst_name = rel, n
    checks = {"loss": loss_rel <= LOSS_RTOL, "updates": worst <= UPDATE_RTOL,
              "finite": math.isfinite(losses["cuda"])}
    emit("train_parity", ok=all(checks.values()), checks=checks,
         config={**cfg, "dtype": "float32", "batch": 2, "seq": 128,
                 "valid_length": [128, 97], "masked": 19},
         losses=losses, loss_rel_err=loss_rel, loss_rtol=LOSS_RTOL,
         worst_update_rel_err=worst, worst_update_param=worst_name,
         update_rtol=UPDATE_RTOL, seconds=time.perf_counter() - t0)
    for name, ok in checks.items():
        if not ok:
            ctx["failures"].append(f"train_parity check {name} failed")
    del cpu, gpu
    torch.cuda.empty_cache()


def bert_train_run(torch, dtype, n, steps):
    """BERT-base at full width (dropout 0.1) in ``dtype``, the benchmark's
    MLM loss and LAMB (float32 masters for bfloat16) through
    ``CompiledTrainStep`` at batch ``n`` x 512 with ragged valid lengths:
    1 warm-up and ``steps`` timed steps; the port's launch counts and the
    flash wrappers' routes over the timed steps."""
    from tpu_mx_torch import optimizer
    from tpu_mx_torch.kernels import flash_attention as fa
    from tpu_mx_torch.models import BERTModel, MLMLoss, bert_base_config
    from tpu_mx_torch.parallel import CompiledTrainStep

    cfg = bert_base_config(max_len=TRAIN_SEQ)
    rng = np.random.RandomState(0)
    valid = rng.randint(TRAIN_VALID[0], TRAIN_VALID[1] + 1, n)
    batch = bert_batch(cfg, n, TRAIN_SEQ, TRAIN_MASKED, valid, rng)
    batch = tuple(torch.from_numpy(x).cuda() for x in batch)
    t0 = time.perf_counter()
    net = BERTModel(cfg, dtype=dtype, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(0))
    opt = optimizer.create("lamb", learning_rate=1e-4,
                           multi_precision=dtype == "bfloat16")
    step = CompiledTrainStep(net, MLMLoss(), opt)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    losses = [float(step.step(*batch))]          # warm-up
    torch.cuda.reset_peak_memory_stats()
    reset_port_kernel_launches()
    wrappers = (fa.flash_attention, fa.flash_attention_bwd_dq,
                fa.flash_attention_bwd_dkv)
    for c in wrappers:
        c.routes = fa.route_counts()
    step_ms = []
    for _ in range(steps):
        t1 = time.perf_counter()
        losses.append(float(step.step(*batch)))  # ends in a host read
        step_ms.append((time.perf_counter() - t1) * 1e3)
    return dict(
        cfg=cfg, batch=dict(batch=n, seq=TRAIN_SEQ, masked=TRAIN_MASKED,
                            valid_length=[int(x) for x in valid]),
        setup_s=setup_s, losses=losses, step_ms=step_ms,
        peak=torch.cuda.max_memory_allocated(),
        launches=port_kernel_launches(),
        routes={name: dict(c.routes) for name, c in zip(FLASH_KERNELS,
                                                        wrappers)})


def emit_train(ctx, phase, run, dtype, optimizer, checks, **extra):
    """One training phase's line; its failed checks join the failures."""
    med = statistics.median(run["step_ms"])
    emit(phase, ok=all(checks.values()), checks=checks,
         model={**run["cfg"], "dtype": dtype}, batch=run["batch"],
         optimizer=optimizer, setup_seconds=run["setup_s"],
         losses=run["losses"], step_ms=run["step_ms"], step_ms_median=med,
         seq_per_sec=run["batch"]["batch"] / med * 1e3,
         peak_memory_bytes=run["peak"], launches=run["launches"],
         launches_per_step={k: n / len(run["step_ms"])
                            for k, n in run["launches"].items()},
         routes=run["routes"], card=ctx["smi"], **extra)
    for name, ok in checks.items():
        if not ok:
            ctx["failures"].append(f"{phase} check {name} failed")


def flash_route_check(fa, routes, route, launches):
    """Each flash kernel ran ``launches`` times, all on ``route``."""
    return all(r == dict(fa.route_counts(), **{route: launches})
               for r in routes.values())


def phase_train(ctx):
    """The training slice at full width: BERT-base bf16, dropout 0.1,
    MLM loss, LAMB with f32 masters, batch 32 x 512, on the card."""
    import torch
    from tpu_mx_torch.kernels import flash_attention as fa

    run = bert_train_run(torch, "bfloat16", TRAIN_BATCH, TRAIN_STEPS)
    launches, losses = run["launches"], run["losses"]
    ctx["train_launches"], ctx["train_routes"] = launches, run["routes"]
    per_run = run["cfg"]["num_layers"] * TRAIN_STEPS
    checks = {
        # the bf16 step's three flash kernels ran on the tensor cores only
        "wgmma_routes": flash_route_check(fa, run["routes"], "wgmma",
                                          per_run),
        "finite": all(math.isfinite(x) for x in losses),
        "loss_falls": losses[-1] < losses[0],
        "flash_launches": all(launches[k] == per_run for k in FLASH_KERNELS),
        "paged_idle": launches["paged_attention"] == 0,
    }
    emit_train(ctx, "train", run, "bfloat16", "lamb lr=1e-4 multi_precision",
               checks)


def phase_train_f32(ctx):
    """The training slice in float32: ``train``'s BERT-base step with
    float32 weights and activations (the flash kernels on ``tf32x3``),
    batch 32 x 512, 1 warm-up and 3 timed steps."""
    import torch
    from tpu_mx_torch.kernels import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False   # float32 products
    run = bert_train_run(torch, "float32", TRAIN_F32_BATCH, TRAIN_F32_STEPS)
    launches, losses = run["launches"], run["losses"]
    ctx["train_f32_launches"] = launches
    ctx["train_f32_routes"] = run["routes"]
    per_run = run["cfg"]["num_layers"] * TRAIN_F32_STEPS
    checks = {
        # the float32 step's three flash kernels ran on 3xTF32 only
        "tf32x3_routes": flash_route_check(fa, run["routes"], "tf32x3",
                                           per_run),
        "finite": all(math.isfinite(x) for x in losses),
        "flash_launches": all(launches[k] == per_run for k in FLASH_KERNELS),
        "paged_idle": launches["paged_attention"] == 0,
        "rtc_idle": launches["rtc"] == 0,
    }
    emit_train(ctx, "train_f32", run, "float32", "lamb lr=1e-4", checks)
    gc.collect()
    torch.cuda.empty_cache()


def resnet_thin(block, stem, device, generator=None, params=None):
    """A thin channels-last ResNetV1: Xavier-drawn from ``generator``, or
    set from ``params`` (the reference's layout, conv weights OHWI)."""
    from tpu_mx_torch import layout
    from tpu_mx_torch.gluon.model_zoo import vision
    cls = vision.BasicBlockV1 if block == "basic" else vision.BottleneckV1
    args = (cls, [1, 1, 1, 1], RESNET_THIN[block])
    if params is not None:
        return vision.ResNetV1.from_numpy(params, *args, classes=10,
                                          stem=stem, layout="NHWC",
                                          device=device)
    with layout.default_layout("NHWC"):
        net = vision.ResNetV1(*args, classes=10, stem=stem, device=device,
                              generator=generator)
    return net.initialize("xavier", generator)


def phase_resnet_parity(ctx):
    """Thin channels-last ResNetV1s on the card against the CPU (float32):
    logits, then three SGD steps' losses, weights and running stats."""
    import torch

    # PyTorch's oneDNN CPU convolution corrupts memory in the backward of
    # a channels-last 1x1 stride-2 convolution at some small shapes (a
    # segmentation fault, seen with torch 2.13 on the CPU); the host's
    # half runs PyTorch's native CPU convolutions instead
    prior = torch.backends.mkldnn.enabled
    torch.backends.mkldnn.enabled = False
    try:
        resnet_parity_cases(ctx, torch)
    finally:
        torch.backends.mkldnn.enabled = prior


def resnet_parity_cases(ctx, torch):
    from tpu_mx_torch import optimizer
    from tpu_mx_torch.gluon import loss
    from tpu_mx_torch.parallel import CompiledTrainStep

    t0 = time.perf_counter()
    rng = np.random.RandomState(3)
    x = rng.rand(RESNET_PARITY_BATCH, RESNET_PARITY_SIZE, RESNET_PARITY_SIZE,
                 3).astype(np.float32)
    label = rng.randint(0, 10, RESNET_PARITY_BATCH).astype(np.float32)
    cases, checks = {}, {}
    for block in RESNET_THIN:
        for stem in ("classic", "s2d"):
            cpu = resnet_thin(block, stem, "cpu",
                              torch.Generator().manual_seed(0))
            params = {n: (t.permute(0, 2, 3, 1) if t.dim() == 4 else t)
                      .detach().numpy()
                      for n, t in cpu.collect_params().items()}
            gpu = resnet_thin(block, stem, "cuda", params=params)
            nets = {"cpu": cpu, "cuda": gpu}
            with torch.no_grad():
                logits = {d: n.eval()(torch.from_numpy(x).to(d)).cpu()
                          for d, n in nets.items()}
            logits_err = float((logits["cuda"] - logits["cpu"]).abs().max())
            before = {n: t.detach().clone()
                      for n, t in cpu.collect_params().items()}
            losses = {}
            for dev, net in nets.items():
                step = CompiledTrainStep(
                    net, loss.SoftmaxCrossEntropyLoss(),
                    optimizer.create("sgd", learning_rate=0.1, momentum=0.9,
                                     wd=1e-4), device=dev)
                data = torch.from_numpy(x).to(dev)
                lab = torch.from_numpy(label).to(dev)
                losses[dev] = [float(step.step(data, lab))
                               for _ in range(RESNET_PARITY_STEPS)]
            loss_rel = max(abs(a - b) / abs(b) for a, b in
                           zip(losses["cuda"], losses["cpu"]))
            worst, worst_name, no_grad_diff, no_grad = 0.0, None, 0.0, 0
            on_card = gpu.collect_params()
            for n, t in cpu.collect_params().items():
                d_cpu = t.detach() - before[n]
                d_gpu = on_card[n].detach().cpu() - before[n]
                diff, size = float((d_gpu - d_cpu).norm()), \
                    float(d_cpu.norm())
                if size <= RESNET_UPDATE_ATOL:
                    no_grad += 1
                    no_grad_diff = max(no_grad_diff, diff)
                elif diff / size > worst:
                    worst, worst_name = diff / size, n
            name = f"{block}_{stem}"
            cases[name] = dict(logits_max_abs_err=logits_err, losses=losses,
                               loss_rel_err=loss_rel,
                               worst_update_rel_err=worst,
                               worst_update_tensor=worst_name,
                               unmoved_tensors=no_grad,
                               unmoved_max_abs_diff=no_grad_diff)
            checks[f"{name}_logits"] = logits_err <= LOGITS_ATOL
            checks[f"{name}_loss"] = loss_rel <= LOSS_RTOL
            checks[f"{name}_updates"] = worst <= UPDATE_RTOL \
                and no_grad_diff <= RESNET_UPDATE_ATOL
            checks[f"{name}_finite"] = all(map(math.isfinite,
                                               losses["cuda"]))
    ctx["resnet_parity"] = cases
    emit("resnet_parity", ok=all(checks.values()), checks=checks,
         config=dict(layers=[1, 1, 1, 1], channels=RESNET_THIN,
                     layout="NHWC", dtype="float32",
                     batch=RESNET_PARITY_BATCH, size=RESNET_PARITY_SIZE,
                     steps=RESNET_PARITY_STEPS,
                     optimizer="sgd lr=0.1 momentum=0.9 wd=1e-4"),
         cases=cases, logits_atol=LOGITS_ATOL, loss_rtol=LOSS_RTOL,
         update_rtol=UPDATE_RTOL, update_atol=RESNET_UPDATE_ATOL,
         seconds=time.perf_counter() - t0)
    for name, ok in checks.items():
        if not ok:
            ctx["failures"].append(f"resnet_parity check {name} failed")


def port_kernel_launches():
    """The port's kernels' launch counters, by name (one count each)."""
    from tpu_mx_torch import rtc
    from tpu_mx_torch.kernels import flash_attention as fa
    from tpu_mx_torch.kernels import paged_attention as pa
    return {"flash_attention_fwd": fa.flash_attention.launches,
            "flash_attention_bwd_dq": fa.flash_attention_bwd_dq.launches,
            "flash_attention_bwd_dkv": fa.flash_attention_bwd_dkv.launches,
            "paged_attention": pa.paged_attention.launches,
            "rtc": rtc.Kernel.launches}


def reset_port_kernel_launches():
    from tpu_mx_torch import rtc
    from tpu_mx_torch.kernels import flash_attention as fa
    from tpu_mx_torch.kernels import paged_attention as pa
    for c in (fa.flash_attention, fa.flash_attention_bwd_dq,
              fa.flash_attention_bwd_dkv, pa.paged_attention, rtc.Kernel):
        c.launches = 0


def resnet_train_run(torch, batch):
    """The recipe at ``batch``: setup, 1 warm-up and the timed steps."""
    from tpu_mx_torch import layout, optimizer
    from tpu_mx_torch.gluon import loss
    from tpu_mx_torch.gluon.model_zoo import vision
    from tpu_mx_torch.parallel import CompiledTrainStep

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    with layout.default_layout("NHWC"):
        net = vision.resnet50_v1(classes=RESNET_CLASSES, stem="s2d",
                                 generator=gen)
    net.initialize("xavier", gen)
    net.cast("bfloat16")
    step = CompiledTrainStep(net, loss.SoftmaxCrossEntropyLoss(),
                             optimizer.create("sgd", learning_rate=0.1,
                                              momentum=0.9, wd=1e-4,
                                              multi_precision=True))
    data = torch.rand((batch, RESNET_SIZE, RESNET_SIZE, 3), generator=gen,
                      device="cuda").to(torch.bfloat16)
    label = torch.randint(0, RESNET_CLASSES, (batch,), generator=gen,
                          device="cuda").float()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    first = net.features[0].conv
    seen = {"weight": first.weight.is_contiguous(
        memory_format=torch.channels_last)}
    hook = first.register_forward_pre_hook(lambda m, args: seen.update(
        input=args[0].permute(0, 3, 1, 2).is_contiguous(
            memory_format=torch.channels_last)))
    t1 = time.perf_counter()
    losses = [float(step.step(data, label))]     # warm-up: cuDNN autotunes
    warmup_ms = (time.perf_counter() - t1) * 1e3
    hook.remove()
    torch.cuda.reset_peak_memory_stats()
    reset_port_kernel_launches()
    step_ms = []
    for _ in range(RESNET_STEPS):
        t1 = time.perf_counter()
        losses.append(float(step.step(data, label)))   # ends in a host read
        step_ms.append((time.perf_counter() - t1) * 1e3)
    launches = port_kernel_launches()
    return dict(batch=batch, losses=losses, step_ms=step_ms,
                warmup_ms=warmup_ms, setup_seconds=setup_s,
                peak_memory_bytes=torch.cuda.max_memory_allocated(),
                channels_last=seen, launches=launches,
                weight_dtype=str(first.weight.dtype),
                running_var_dtype=str(net.features[0].bn.running_var.dtype))


def phase_resnet_train(ctx):
    """ResNet-50 v1 (s2d stem, channels-last, bf16, momentum SGD with f32
    masters) at 224x224, batch 256, the reference benchmark's recipe."""
    import torch

    prior = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True
    fallback = []
    try:
        for batch in RESNET_BATCHES:
            try:
                rec = resnet_train_run(torch, batch)
                break
            except torch.cuda.OutOfMemoryError as e:
                fallback.append(f"batch {batch}: {str(e)[:200]}")
            torch.cuda.empty_cache()
        else:
            raise RuntimeError(f"resnet_train: every batch ran out of "
                               f"memory: {fallback}")
    finally:
        torch.backends.cudnn.benchmark = prior
    torch.cuda.empty_cache()
    med = statistics.median(rec["step_ms"])
    flops = RESNET50_TRAIN_FLOPS_PER_IMG * rec["batch"]
    tflops = flops / (med * 1e-3) / 1e12
    losses = rec["losses"]
    checks = {
        "finite": all(map(math.isfinite, losses)),
        "loss_falls": losses[-1] < losses[0],
        "first_conv_input_channels_last": rec["channels_last"].get("input",
                                                                   False),
        "first_conv_weight_channels_last": rec["channels_last"]["weight"],
        "no_port_kernel_launched": not any(rec["launches"].values()),
        "bf16_running_statistics": rec["running_var_dtype"]
        == "torch.bfloat16",
    }
    ctx["resnet_launches"] = rec["launches"]
    ctx["resnet_step_ms"] = med
    emit("resnet_train", ok=all(checks.values()), checks=checks,
         model=dict(factory="resnet50_v1", classes=RESNET_CLASSES,
                    stem="s2d", layout="NHWC", dtype="bfloat16",
                    init="xavier"),
         optimizer="sgd lr=0.1 momentum=0.9 wd=1e-4 multi_precision",
         batch=rec["batch"], batch_fallback=fallback, size=RESNET_SIZE,
         reduced={"steps": f"1 warm-up + {RESNET_STEPS} timed (the "
                           "reference's recipe: 3 + 30)"},
         cudnn_benchmark=True, setup_seconds=rec["setup_seconds"],
         warmup_ms=rec["warmup_ms"], losses=losses, step_ms=rec["step_ms"],
         step_ms_median=med, images_per_sec=rec["batch"] / med * 1e3,
         peak_memory_bytes=rec["peak_memory_bytes"],
         flops_per_image=RESNET50_TRAIN_FLOPS_PER_IMG,
         achieved_tflops=tflops, peak_tflops=BF16_FLOP_PER_S / 1e12,
         share_of_peak=tflops * 1e12 / BF16_FLOP_PER_S,
         launches=rec["launches"], channels_last=rec["channels_last"],
         card=ctx["smi"])
    for name, ok in checks.items():
        if not ok:
            ctx["failures"].append(f"resnet_train check {name} failed")


# -- the PTB LSTM slice ---------------------------------------------------------
def flat_ce():
    """The reference benchmark's word-LM loss (``bench.py::_lstm_once``):
    the ``(T, N, V)`` logits reshaped to ``(T·N, V)`` and upcast to
    float32, then softmax cross-entropy."""
    from tpu_mx_torch.gluon import loss

    class FlatCE(loss.Loss):
        def __init__(self):
            super().__init__(weight=None, batch_axis=0)
            self._ce = loss.SoftmaxCrossEntropyLoss()

        def forward(self, logits, labels):
            return self._ce(logits.reshape(-1, logits.shape[-1]).float(),
                            labels.reshape(-1))
    return FlatCE()


def lstm_thin(kind, device, generator=None, params=None):
    """A thin word-LM on ``device``: ``RNNModel`` (``"lstm"``, ``"gru"``)
    or, for ``"bi_lstm"``, embedding → bidirectional 2-layer LSTM →
    decoder.  Xavier-drawn from ``generator``, or set from ``params``
    (numpy, the reference's order)."""
    import torch
    from tpu_mx_torch import device as _device
    from tpu_mx_torch.gluon import nn, rnn
    from tpu_mx_torch.gluon.block import load_numpy
    from tpu_mx_torch.models import RNNModel

    _device.resolve(device)          # TF32 off on the card
    cfg = LSTM_THIN
    gen = generator if generator is not None else torch.Generator(
        device=device)
    if kind == "bi_lstm":
        net = nn.HybridSequential()
        net.add(nn.Embedding(cfg["vocab_size"], cfg["num_embed"],
                             generator=gen),
                rnn.LSTM(cfg["num_hidden"], cfg["num_layers"],
                         bidirectional=True, input_size=cfg["num_embed"],
                         generator=gen),
                nn.Dense(cfg["vocab_size"], flatten=False,
                         in_units=2 * cfg["num_hidden"], generator=gen))
    else:
        net = RNNModel(kind, dropout=0.0, device=device, generator=gen,
                       **cfg)
    if params is not None:
        return load_numpy(net, params)
    return net.initialize("xavier", gen)


def phase_lstm_parity(ctx):
    """Thin LSTM, GRU and bidirectional word-LMs (float32) on the card
    (the ``fused`` arm: cuDNN) against the CPU (the ``scan`` arm) from
    one weight set: logits, then three SGD steps' losses and per-tensor
    changes.  Also the cost of cuDNN's copy of the separate weights into
    one buffer, at full width."""
    import torch
    from tpu_mx_torch import optimizer
    from tpu_mx_torch.ndarray import rnn_op
    from tpu_mx_torch.parallel import CompiledTrainStep

    t0 = time.perf_counter()
    rng = np.random.RandomState(4)
    v = LSTM_THIN["vocab_size"]
    x = rng.randint(0, v, (LSTM_PARITY_BPTT, LSTM_PARITY_BATCH)) \
        .astype(np.float32)
    y = rng.randint(0, v, (LSTM_PARITY_BPTT * LSTM_PARITY_BATCH,)) \
        .astype(np.float32)
    cases, checks, arms = {}, {}, {}
    for kind in ("lstm", "gru", "bi_lstm"):
        cpu = lstm_thin(kind, "cpu", torch.Generator().manual_seed(0))
        params = {n: t.detach().numpy()
                  for n, t in cpu.collect_params().items()}
        gpu = lstm_thin(kind, "cuda", params=params)
        nets = {"cpu": cpu, "cuda": gpu}
        with torch.no_grad():
            logits = {d: n.eval()(torch.from_numpy(x).to(d)).cpu()
                      for d, n in nets.items()}
        logits_err = float((logits["cuda"] - logits["cpu"]).abs().max())
        before = {n: t.detach().clone()
                  for n, t in cpu.collect_params().items()}
        losses = {}
        for dev, net in nets.items():
            step = CompiledTrainStep(net, flat_ce(), optimizer.create(
                "sgd", learning_rate=LSTM_PARITY_LR), device=dev)
            counts = arm_counts()
            data, lab = (torch.from_numpy(a).to(dev) for a in (x, y))
            losses[dev] = [float(step.step(data, lab))
                           for _ in range(LSTM_PARITY_STEPS)]
            arms[f"{kind}_{dev}"] = {k: n - counts[k]
                                     for k, n in arm_counts().items() if n
                                     - counts[k]}
        loss_rel = max(abs(a - b) / abs(b) for a, b in
                       zip(losses["cuda"], losses["cpu"]))
        worst, worst_name = 0.0, None
        on_card = gpu.collect_params()
        for n, t in cpu.collect_params().items():
            d_cpu = t.detach() - before[n]
            d_gpu = on_card[n].detach().cpu() - before[n]
            rel = float((d_gpu - d_cpu).norm() / d_cpu.norm())
            if rel > worst:
                worst, worst_name = rel, n
        cases[kind] = dict(logits_max_abs_err=logits_err, losses=losses,
                           loss_rel_err=loss_rel, worst_update_rel_err=worst,
                           worst_update_tensor=worst_name)
        checks[f"{kind}_logits"] = logits_err <= LOGITS_ATOL
        checks[f"{kind}_loss"] = loss_rel <= LOSS_RTOL
        checks[f"{kind}_updates"] = worst <= UPDATE_RTOL
        checks[f"{kind}_finite"] = all(map(math.isfinite, losses["cuda"]))
        checks[f"{kind}_arms"] = \
            set(arms[f"{kind}_cpu"]) == {"scan"} and \
            set(arms[f"{kind}_cuda"]) == {"fused"}
    copy = cudnn_weight_copy(torch, rnn_op)
    checks["cudnn_copies_separate_weights"] = copy["warned"]
    emit("lstm_parity", ok=all(checks.values()), checks=checks,
         config=dict(LSTM_THIN, dtype="float32", bptt=LSTM_PARITY_BPTT,
                     batch=LSTM_PARITY_BATCH, steps=LSTM_PARITY_STEPS,
                     optimizer=f"sgd lr={LSTM_PARITY_LR}", loss="FlatCE"),
         cases=cases, arms=arms,
         logits_atol=LOGITS_ATOL, loss_rtol=LOSS_RTOL,
         update_rtol=UPDATE_RTOL, weight_copy=copy, card=ctx["smi"],
         seconds=time.perf_counter() - t0)
    for name, ok in checks.items():
        if not ok:
            ctx["failures"].append(f"lstm_parity check {name} failed")


def arm_counts():
    from tpu_mx_torch import telemetry
    from tpu_mx_torch.ndarray import rnn_op
    return {k: telemetry.counter("rnn.arm", kind=k).value
            for k in rnn_op.ARMS}


def cudnn_weight_copy(torch, rnn_op):
    """What cuDNN's copy of the separate weights costs: the port's fused
    call (float32, the full-width LSTM, forward) against the same call
    on one packed buffer (``torch.nn.LSTM`` after
    ``flatten_parameters()``, its library form), and whether cuDNN
    warned that it copies."""
    import warnings
    e, h, n = LSTM_CFG["num_embed"], LSTM_CFG["num_hidden"], \
        LSTM_BATCHES[-1]
    layers = LSTM_CFG["num_layers"]
    gen = torch.Generator(device="cuda").manual_seed(5)
    lib = torch.nn.LSTM(e, h, layers, device="cuda")
    with torch.no_grad():
        for p in lib.parameters():
            p.copy_(torch.rand(p.shape, generator=gen, device="cuda") * 0.08
                    - 0.04)
    lib.flatten_parameters()
    weights = [p.detach().clone() for p in lib.parameters()]
    x = torch.randn((LSTM_BPTT, n, e), generator=gen, device="cuda")
    st = [torch.zeros((layers, n, h), device="cuda") for _ in range(2)]
    with torch.no_grad(), warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        ours = rnn_op.recurrence("lstm", x, st, weights, layers,
                                 arm="fused")[0]
        ref = lib(x, tuple(st))[0]
        ms = cuda_ms(torch, lambda: rnn_op.recurrence(
            "lstm", x, st, weights, layers, arm="fused"), reps=10)
        lib_ms = cuda_ms(torch, lambda: lib(x, tuple(st)), reps=10)
        copy_ms = cuda_ms(torch, lambda: torch.cat(
            [w.reshape(-1) for w in weights]), reps=10)
    warned = [str(w.message)[:160] for w in caught
              if "contiguous chunk" in str(w.message)]
    return dict(shape=[LSTM_BPTT, n, e], layers=layers, ms=ms,
                packed_ms=lib_ms, cat_ms=copy_ms,
                max_abs_err=float((ours - ref).abs().max()),
                warned=bool(warned), warning=warned[:1])


def device_busy_ms(torch, prof, ranges=()):
    """Milliseconds in which at least one kernel ran, from a profile's
    kernel intervals (cuDNN's RNN runs kernels on several streams at
    once, so the kernels' summed time exceeds the busy time).  The
    device-side spans of named ``ranges`` (``record_function``) cover
    their kernels and the gaps between them, and are left out."""
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.name not in ranges)
    busy, end = 0.0, None
    for start, stop in spans:
        if end is None or start > end:
            busy, end = busy + stop - start, stop
        elif stop > end:
            busy, end = busy + stop - end, stop
    return busy / 1e3


def lstm_train_run(torch, batch, arm=None):
    """The recipe at ``batch``: setup, 1 warm-up, one profiled step (the
    kernels that ran) and the timed steps.  ``arm`` replaces the rule's
    choice of arm for this run (the ``scan`` arm's time beside the
    ``fused`` one's, as a kernel's plain version beside it)."""
    from unittest import mock
    from tpu_mx_torch.ndarray import rnn_op

    if arm is None:
        return lstm_train_steps(torch, batch)
    with mock.patch.object(rnn_op, "rnn_arm", lambda *args: arm):
        return lstm_train_steps(torch, batch)


def lstm_train_steps(torch, batch):
    from torch.profiler import ProfilerActivity, profile
    from tpu_mx_torch import optimizer
    from tpu_mx_torch.models import RNNModel
    from tpu_mx_torch.parallel import CompiledTrainStep

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    net = RNNModel(generator=gen, **LSTM_CFG)
    net.initialize("xavier", gen)
    net.cast("bfloat16")
    step = CompiledTrainStep(net, flat_ce(), optimizer.create(
        "sgd", learning_rate=1.0, multi_precision=True))
    rng = np.random.RandomState(0)
    v = LSTM_CFG["vocab_size"]
    x = torch.from_numpy(rng.randint(0, v, (LSTM_BPTT, batch))
                         .astype(np.float32)).cuda()
    y = torch.from_numpy(rng.randint(0, v, (LSTM_BPTT * batch,))
                         .astype(np.float32)).cuda()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    losses = [float(step.step(x, y))]               # warm-up
    warmup_ms = (time.perf_counter() - t1) * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        losses.append(float(step.step(x, y)))
        profiled_ms = (time.perf_counter() - t1) * 1e3
    kernels = sorted(((e.key, e.count, e.self_device_time_total / 1e3)
                      for e in prof.key_averages()
                      if e.self_device_time_total > 0),
                     key=lambda k: -k[2])
    busy_ms = device_busy_ms(torch, prof)
    torch.cuda.reset_peak_memory_stats()
    reset_port_kernel_launches()
    counts = arm_counts()
    step_ms = []
    for _ in range(LSTM_STEPS):
        t1 = time.perf_counter()
        losses.append(float(step.step(x, y)))         # ends in a host read
        step_ms.append((time.perf_counter() - t1) * 1e3)
    launches = port_kernel_launches()
    arms = {k: n - counts[k] for k, n in arm_counts().items()}
    return dict(batch=batch, losses=losses, step_ms=step_ms,
                warmup_ms=warmup_ms, setup_seconds=setup_s,
                peak_memory_bytes=torch.cuda.max_memory_allocated(),
                launches=launches, arms=arms, kernels=kernels,
                busy_ms=busy_ms, profiled_ms=profiled_ms, weight_dtype=str(net.rnn.l0_i2h_weight.dtype))


def phase_lstm_train(ctx):
    """The PTB word-level LSTM LM of the reference benchmark
    (``bench.py::_lstm_once``) at full width: 2 x 650, vocabulary 10k,
    bptt 35, bf16, SGD lr 1.0 with f32 masters, batch 2048."""
    import torch
    from tpu_mx_torch.ndarray import rnn_op

    fallback = []
    for batch in LSTM_BATCHES:
        try:
            rec = lstm_train_run(torch, batch)
            break
        except torch.cuda.OutOfMemoryError as e:
            fallback.append(f"batch {batch}: {str(e)[:200]}")
        torch.cuda.empty_cache()
    else:
        raise RuntimeError(f"lstm_train: every batch ran out of memory: "
                           f"{fallback}")
    torch.cuda.empty_cache()
    scan = lstm_train_run(torch, rec["batch"], arm="scan")
    torch.cuda.empty_cache()
    med = statistics.median(rec["step_ms"])
    scan_med = statistics.median(scan["step_ms"])
    tokens = LSTM_BPTT * rec["batch"]
    flops = LSTM_FLOPS_PER_TOKEN * tokens
    tflops = flops / (med * 1e-3) / 1e12
    losses = rec["losses"]
    probe = torch.empty(1, dtype=torch.bfloat16, device="cuda")
    # cuDNN's RNN kernels: elemWiseRNNcell, LSTM_elementWise_*,
    # GENERIC_elementWise_*, RNN_blockPersist_* (the products inside are
    # cuDNN's GEMMs)
    cudnn_rnn = [k[0] for k in rec["kernels"]
                 if re.search(r"RNN|LSTM|elementWise", k[0])]
    checks = {
        "finite": all(map(math.isfinite, losses)),
        "loss_falls": losses[-1] < losses[0],
        "no_port_kernel_launched": not any(rec["launches"].values()),
        "fused_arm_every_step": rec["arms"] == dict(
            dict.fromkeys(rnn_op.ARMS, 0), fused=LSTM_STEPS),
        # the fused arm's bf16 recurrence runs on cuDNN's RNN kernels
        "cudnn_route": torch.cudnn_is_acceptable(probe) and bool(cudnn_rnn),
        "bf16_weights": rec["weight_dtype"] == "torch.bfloat16",
        # the plain scan arm at full width computes the same losses
        "scan_arm_losses": scan["arms"]["scan"] == LSTM_STEPS and all(
            abs(a - b) <= BF16_REL * abs(b)
            for a, b in zip(scan["losses"], losses)),
    }
    ctx["lstm_launches"] = rec["launches"]
    emit("lstm_train", ok=all(checks.values()), checks=checks,
         model=dict(LSTM_CFG, dtype="bfloat16", init="xavier"),
         optimizer="sgd lr=1.0 multi_precision", loss="FlatCE",
         batch=rec["batch"], batch_fallback=fallback, bptt=LSTM_BPTT,
         reduced={"steps": f"1 warm-up + {LSTM_STEPS} timed (the "
                           "reference's recipe: 3 + 20 x 3)"},
         arm="fused", route="cudnn",
         cudnn_is_acceptable_bf16=torch.cudnn_is_acceptable(probe),
         cudnn_rnn_kernels=[n[:90] for n in cudnn_rnn],
         setup_seconds=rec["setup_seconds"], warmup_ms=rec["warmup_ms"],
         losses=losses, step_ms=rec["step_ms"], step_ms_median=med,
         tokens_per_sec=tokens / med * 1e3,
         peak_memory_bytes=rec["peak_memory_bytes"],
         flops_per_token=LSTM_FLOPS_PER_TOKEN, achieved_tflops=tflops,
         peak_tflops=BF16_FLOP_PER_S / 1e12,
         share_of_peak=tflops * 1e12 / BF16_FLOP_PER_S,
         launches=rec["launches"], arms=rec["arms"],
         scan_arm=dict(step_ms=scan["step_ms"], step_ms_median=scan_med,
                       over_fused=scan_med / med, losses=scan["losses"],
                       peak_memory_bytes=scan["peak_memory_bytes"],
                       profiled_busy_ms=scan["busy_ms"],
                       profiled_launches=sum(k[1] for k in scan["kernels"])),
         profiled_step=dict(wall_ms=rec["profiled_ms"],
                            busy_ms=rec["busy_ms"],
                            idle_share=1 - rec["busy_ms"]
                            / rec["profiled_ms"],
                            kernel_ms=sum(k[2] for k in rec["kernels"]),
                            kernels=len(rec["kernels"]),
                            launches=sum(k[1] for k in rec["kernels"]),
                            top=[dict(name=k[0][:90], calls=k[1],
                                      device_ms=k[2])
                                 for k in rec["kernels"][:12]]),
         card=ctx["smi"])
    for name, ok in checks.items():
        if not ok:
            ctx["failures"].append(f"lstm_train check {name} failed")


# -- the SSD slice --------------------------------------------------------------
def ssd_train_block(net):
    """The reference benchmark's SSD objective (``bench.py::_ssd_once``'s
    ``SSDTrain``): ``forward(x, labels)`` runs the net, casts the anchors
    and both heads to float32, makes the targets without a gradient
    (``SSDTrainingTargets``: matching and 3:1 hard-negative mining) and
    returns softmax cross-entropy on the classes plus Huber on the masked
    boxes, per image."""
    import torch
    from tpu_mx_torch.gluon import loss
    from tpu_mx_torch.gluon.block import HybridBlock
    from tpu_mx_torch.models import SSDTrainingTargets

    class SSDTrain(HybridBlock):
        def __init__(self, ssd_net):
            super().__init__()
            self.net = ssd_net
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
    return SSDTrain(net)


def ssd_labels(batch, classes, seed=0):
    """``bench.py::_ssd_once``'s labels from ``np.random.RandomState``:
    one box an image, then a row of -1 padding."""
    rng = np.random.RandomState(seed)
    labels = np.full((batch, 2, 5), -1.0, np.float32)
    for b in range(batch):
        cls = rng.randint(0, classes)
        x0, y0 = rng.uniform(0.05, 0.5, 2)
        labels[b, 0] = [cls, x0, y0, min(x0 + 0.3, 0.95),
                        min(y0 + 0.3, 0.95)]
    return labels


def ssd_thin(kind, device, generator=None, params=None):
    """``"compact"``: the benchmark's smoke SSD (3 classes, two scales,
    base filters 8 and 16); ``"vgg"``: ``ssd_512(20,
    backbone="vgg16_reduced")`` at full width.  Xavier-drawn from
    ``generator``, or set from ``params`` (numpy, the reference's
    order)."""
    import torch
    from tpu_mx_torch.models import SSD, ssd_512

    kw = dict(SSD_THIN) if kind == "compact" else dict(
        num_classes=SSD_CLASSES, backbone="vgg16_reduced")
    make = SSD if kind == "compact" else ssd_512
    gen = generator if generator is not None else torch.Generator(
        device=device)
    net = make(device=device, generator=gen, **kw)
    if params is not None:
        from tpu_mx_torch.gluon.block import load_numpy
        return load_numpy(net, params)
    return net.initialize("xavier", gen)


def phase_ssd_parity(ctx):
    """SSDs in float32 on the card against the CPU from one weight set:
    the heads and anchors (the smoke SSD, and the full-width VGG16-reduced
    SSD-512 at 64x64), ``MultiBoxTarget`` at the full-width shape,
    ``MultiBoxDetection``, three SGD steps of the benchmark's objective,
    and SSD-300's 8732 anchors from one 300x300 forward."""
    import torch
    from tpu_mx_torch import optimizer
    from tpu_mx_torch.gluon import loss
    from tpu_mx_torch.models import SSDTrainingTargets, ssd_300
    from tpu_mx_torch.ndarray import contrib
    from tpu_mx_torch.parallel import CompiledTrainStep

    prior = torch.backends.mkldnn.enabled
    torch.backends.mkldnn.enabled = False      # as in resnet_parity
    t0 = time.perf_counter()
    rng = np.random.RandomState(5)
    x = rng.uniform(0, 0.1, (SSD_PARITY_BATCH, 3, SSD_PARITY_SIZE,
                             SSD_PARITY_SIZE)).astype(np.float32)
    labels = ssd_labels(SSD_PARITY_BATCH, SSD_THIN["num_classes"])
    cases, checks = {}, {}
    try:
        for kind in ("compact", "vgg"):
            cpu = ssd_thin(kind, "cpu", torch.Generator().manual_seed(0))
            params = {n: t.detach().numpy()
                      for n, t in cpu.collect_params().items()}
            gpu = ssd_thin(kind, "cuda", params=params)
            nets = {"cpu": cpu, "cuda": gpu}
            with torch.no_grad():
                outs = {d: [t.cpu() for t in n.eval()(
                    torch.from_numpy(x).to(d))] for d, n in nets.items()}
            errs = {name: float((g - c).abs().max() / max(1.0, float(
                c.abs().max()))) for name, g, c in zip(
                ("anchors", "cls_preds", "box_preds"), outs["cuda"],
                outs["cpu"])}
            case = dict(head_rel_err=errs, anchors=outs["cpu"][0].shape[1],
                        channels_last=gpu.cls_heads[0].weight.is_contiguous(
                            memory_format=torch.channels_last))
            checks[f"{kind}_heads"] = max(errs.values()) <= SSD_HEAD_RTOL
            checks[f"{kind}_channels_last"] = case["channels_last"]
            if kind == "compact":
                # detection from the same decoded inputs on both devices
                prob = torch.softmax(outs["cpu"][1], -1).transpose(1, 2)
                dets = {d: contrib.MultiBoxDetection(
                    prob.to(d), outs["cpu"][2].to(d), outs["cpu"][0].to(d),
                    nms_threshold=0.45, nms_topk=400).cpu()
                    for d in ("cpu", "cuda")}
                case["detection_max_abs_err"] = float(
                    (dets["cuda"] - dets["cpu"]).abs().max())
                case["detections_kept"] = int((dets["cpu"][..., 0]
                                               >= 0).sum())
                checks["detection"] = case["detection_max_abs_err"] \
                    <= SSD_LOC_ATOL and torch.equal(dets["cuda"][..., 0],
                                                    dets["cpu"][..., 0])
                losses = {}
                for dev, net in nets.items():
                    step = CompiledTrainStep(
                        ssd_train_block(net), loss.PassThrough(),
                        optimizer.create("sgd", learning_rate=0.01,
                                         momentum=0.9, wd=5e-4),
                        device=dev)
                    args = [torch.from_numpy(a).to(dev) for a in
                            (x, labels, np.zeros(1, np.float32))]
                    losses[dev] = [float(step.step(*args))
                                   for _ in range(SSD_PARITY_STEPS)]
                case["losses"] = losses
                case["loss_rel_err"] = max(
                    abs(a - b) / abs(b) for a, b in zip(losses["cuda"],
                                                        losses["cpu"]))
                checks["loss"] = case["loss_rel_err"] <= LOSS_RTOL
                checks["finite"] = all(map(math.isfinite, losses["cuda"]))
                checks["loss_falls"] = losses["cuda"][-1] \
                    < losses["cuda"][0]
            cases[kind] = case
        # MultiBoxTarget at the full-width shape: the anchors of the
        # VGG16-reduced SSD-512 at 512x512 (24,564), the benchmark's labels
        # at batch 128, bf16-rounded class scores (tied hardness values)
        with torch.no_grad():
            anchors = gpu(torch.zeros((1, 3, SSD_SIZE, SSD_SIZE),
                                      device="cuda"))[0].cpu()
        del gpu, nets
        labels = torch.from_numpy(ssd_labels(SSD_BATCHES[0], SSD_CLASSES))
        scores = torch.randn((SSD_BATCHES[0], anchors.shape[1],
                              SSD_CLASSES + 1),
                             generator=torch.Generator().manual_seed(1)) \
            .bfloat16().float()
        targets = SSDTrainingTargets()
        got = {d: [t.cpu() for t in targets(anchors.to(d), labels.to(d),
                                             scores.to(d))]
               for d in ("cpu", "cuda")}
        loc_err = float((got["cuda"][0] - got["cpu"][0]).abs().max())
        cls_t = got["cpu"][2]
        cases["multibox_target"] = dict(
            batch=SSD_BATCHES[0], anchors=anchors.shape[1],
            loc_max_abs_err=loc_err,
            positives=int((cls_t > 0).sum()), negatives=int(
                (cls_t == 0).sum()), ignored=int((cls_t == -1).sum()))
        checks["target_anchor_count"] = anchors.shape[1] == SSD_ANCHORS
        checks["target_loc"] = loc_err <= SSD_LOC_ATOL
        checks["target_mask_equal"] = torch.equal(got["cuda"][1],
                                                  got["cpu"][1])
        checks["target_cls_equal"] = torch.equal(got["cuda"][2], cls_t)
        # SSD-300's canonical pyramid, from one forward on the card
        net300 = ssd_300(SSD_CLASSES, backbone="vgg16_reduced",
                         device="cuda",
                         generator=torch.Generator(device="cuda"))
        with torch.no_grad():
            a300, c300, _ = net300.eval()(torch.rand(
                (1, 3, 300, 300), generator=torch.Generator(
                    device="cuda").manual_seed(2), device="cuda"))
        cases["ssd_300"] = dict(anchors=a300.shape[1])
        checks["ssd_300_anchors"] = a300.shape[1] == 8732 and \
            bool(torch.isfinite(c300).all())
        del net300
    finally:
        torch.backends.mkldnn.enabled = prior
    torch.cuda.empty_cache()
    emit("ssd_parity", ok=all(checks.values()), checks=checks,
         config=dict(compact=SSD_THIN, vgg="ssd_512(20, vgg16_reduced)",
                     dtype="float32", batch=SSD_PARITY_BATCH,
                     size=SSD_PARITY_SIZE, steps=SSD_PARITY_STEPS,
                     optimizer="sgd lr=0.01 momentum=0.9 wd=5e-4"),
         cases=cases, head_rtol=SSD_HEAD_RTOL, loc_atol=SSD_LOC_ATOL,
         loss_rtol=LOSS_RTOL, card=ctx["smi"],
         seconds=time.perf_counter() - t0)
    for name, ok in checks.items():
        if not ok:
            ctx["failures"].append(f"ssd_parity check {name} failed")


def ssd_train_run(torch, batch):
    """The recipe at ``batch``: setup, 1 warm-up, one profiled step, the
    timed steps, then ``MultiBoxTarget`` alone on this batch's heads and
    one timed ``detect`` at batch 8."""
    from torch.profiler import ProfilerActivity, profile
    from tpu_mx_torch import optimizer
    from tpu_mx_torch.gluon import loss
    from tpu_mx_torch.models import SSDTrainingTargets, ssd_512
    from tpu_mx_torch.parallel import CompiledTrainStep

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    net = ssd_512(SSD_CLASSES, backbone="vgg16_reduced", device="cuda",
                  generator=gen)
    wrapper = ssd_train_block(net)
    wrapper.initialize("xavier", gen)
    wrapper.cast("bfloat16")
    step = CompiledTrainStep(wrapper, loss.PassThrough(), optimizer.create(
        "sgd", learning_rate=0.01, momentum=0.9, wd=5e-4,
        multi_precision=True), device="cuda")
    data = (torch.rand((batch, 3, SSD_SIZE, SSD_SIZE), generator=gen,
                       device="cuda") * 0.1).to(torch.bfloat16)
    labels = torch.from_numpy(ssd_labels(batch, SSD_CLASSES)).cuda()
    dummy = torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    reset_port_kernel_launches()
    t1 = time.perf_counter()
    losses = [float(step.step(data, labels, dummy))]   # cuDNN autotunes
    warmup_ms = (time.perf_counter() - t1) * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        losses.append(float(step.step(data, labels, dummy)))
        profiled_ms = (time.perf_counter() - t1) * 1e3
    kernels = sorted(((e.key, e.count, e.self_device_time_total / 1e3)
                      for e in prof.key_averages()
                      if e.self_device_time_total > 0),
                     key=lambda k: -k[2])
    busy_ms = device_busy_ms(torch, prof)
    torch.cuda.reset_peak_memory_stats()
    step_ms = []
    for _ in range(SSD_STEPS):
        t1 = time.perf_counter()
        losses.append(float(step.step(data, labels, dummy)))  # host read
        step_ms.append((time.perf_counter() - t1) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    with torch.no_grad():
        anchors, cls_preds, _ = (t.float() for t in net(data))
    targets = SSDTrainingTargets()
    target_ms = cuda_ms(torch, lambda: targets(anchors, labels, cls_preds),
                        reps=10)
    cls_t = targets(anchors, labels, cls_preds)[2]
    counts = dict(positives=int((cls_t > 0).sum()),
                  negatives=int((cls_t == 0).sum()),
                  ignored=int((cls_t == -1).sum()))
    del cls_preds
    det = net.detect(data[:SSD_DETECT_BATCH])
    detect_ms = cuda_ms(torch, lambda: net.detect(data[:SSD_DETECT_BATCH]),
                        reps=3, warm=1)
    kept = det[det[..., 0] >= 0]
    launches = port_kernel_launches()
    return dict(batch=batch, losses=losses, step_ms=step_ms,
                warmup_ms=warmup_ms, setup_seconds=setup_s,
                peak_memory_bytes=peak, anchors=anchors.shape[1],
                target_ms=target_ms, target_counts=counts,
                detect=dict(batch=SSD_DETECT_BATCH, ms=detect_ms,
                            shape=list(det.shape), kept=kept.shape[0],
                            kept_finite=bool(torch.isfinite(kept).all())),
                kernels=kernels, busy_ms=busy_ms, profiled_ms=profiled_ms,
                launches=launches,
                channels_last=net.backbone.fc6.weight.is_contiguous(
                    memory_format=torch.channels_last),
                weight_dtype=str(net.backbone.fc6.weight.dtype))


def phase_ssd_train(ctx):
    """SSD-512 with the VGG16-reduced backbone (``bench.py::_ssd_once``)
    at 512x512: bf16, momentum SGD with f32 masters, batch 128 (64, then
    32, said so, if it runs out of memory)."""
    import torch

    prior = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True
    fallback = []
    try:
        for batch in SSD_BATCHES:
            try:
                rec = ssd_train_run(torch, batch)
                break
            except torch.cuda.OutOfMemoryError as e:
                fallback.append(f"batch {batch}: {str(e)[:200]}")
            torch.cuda.empty_cache()
        else:
            raise RuntimeError(f"ssd_train: every batch ran out of memory: "
                               f"{fallback}")
    finally:
        torch.backends.cudnn.benchmark = prior
    torch.cuda.empty_cache()
    med = statistics.median(rec["step_ms"])
    flops = SSD512_TRAIN_FLOPS_PER_IMG * rec["batch"]
    tflops = flops / (med * 1e-3) / 1e12
    losses = rec["losses"]
    # groups of the profiled step's device time (torch_train_profile.py's)
    groups = {}
    for name, calls, ms in rec["kernels"]:
        low = name.lower()
        g = next((grp for grp, keys in SSD_GROUPS
                  if any(k in low for k in keys)), "other")
        groups.setdefault(g, [0, 0.0])
        groups[g][0] += calls
        groups[g][1] += ms
    checks = {
        "finite": all(map(math.isfinite, losses)),
        "loss_falls": losses[-1] < losses[0],
        "anchors": rec["anchors"] == SSD_ANCHORS,
        "no_port_kernel_launched": not any(rec["launches"].values()),
        "bf16_weights": rec["weight_dtype"] == "torch.bfloat16",
        "channels_last": rec["channels_last"],
        "detect_shape": rec["detect"]["shape"] == [SSD_DETECT_BATCH,
                                                   SSD_ANCHORS, 6],
        "detect_kept_finite": rec["detect"]["kept"] > 0
        and rec["detect"]["kept_finite"],
    }
    if fallback:
        print(f"ssd_train: fell back to batch {rec['batch']} "
              f"(out of memory above it)", flush=True)
    ctx["ssd_launches"] = rec["launches"]
    emit("ssd_train", ok=all(checks.values()), checks=checks,
         model=dict(factory="ssd_512", classes=SSD_CLASSES,
                    backbone="vgg16_reduced", dtype="bfloat16",
                    init="xavier", memory_format="channels_last"),
         optimizer="sgd lr=0.01 momentum=0.9 wd=5e-4 multi_precision",
         loss="softmax CE + Huber (masked), targets by MultiBoxTarget",
         batch=rec["batch"], batch_fallback=fallback, size=SSD_SIZE,
         reduced={"steps": f"1 warm-up + {SSD_STEPS} timed (the "
                           "reference's recipe: 3 + 10 x 3)"},
         cudnn_benchmark=True, setup_seconds=rec["setup_seconds"],
         warmup_ms=rec["warmup_ms"], losses=losses, step_ms=rec["step_ms"],
         step_ms_median=med, images_per_sec=rec["batch"] / med * 1e3,
         peak_memory_bytes=rec["peak_memory_bytes"],
         flops_per_image=SSD512_TRAIN_FLOPS_PER_IMG,
         achieved_tflops=tflops, peak_tflops=BF16_FLOP_PER_S / 1e12,
         share_of_peak=tflops * 1e12 / BF16_FLOP_PER_S,
         flop_floor_ms=flops / BF16_FLOP_PER_S * 1e3,
         anchors=rec["anchors"], multibox_target_ms=rec["target_ms"],
         target_counts=rec["target_counts"], detect=rec["detect"],
         launches=rec["launches"],
         profiled_step=dict(wall_ms=rec["profiled_ms"],
                            busy_ms=rec["busy_ms"],
                            idle_share=1 - rec["busy_ms"]
                            / rec["profiled_ms"],
                            launches=sum(k[1] for k in rec["kernels"]),
                            groups={g: dict(calls=c, device_ms=m)
                                    for g, (c, m) in sorted(groups.items())},
                            top=[dict(name=k[0][:90], calls=k[1],
                                      device_ms=k[2])
                                 for k in rec["kernels"][:12]]),
         card=ctx["smi"])
    for name, ok in checks.items():
        if not ok:
            ctx["failures"].append(f"ssd_train check {name} failed")


def sum_to(x, shape):
    """``x`` summed over the axes where ``shape`` is 1 (a broadcast's
    gradient)."""
    dims = tuple(i for i, n in enumerate(shape) if n == 1 and x.shape[i] != 1)
    return x.sum(dim=dims, keepdim=True) if dims else x


def bias_case(torch, fa, gen, b, h, t, d, dtype, causal, valid, bias_shape):
    """``parallel.attention(bias=)`` forward and backward (the main path,
    counted), then each flash kernel with the folded bias against its
    plain version; ms with and without the bias, the plain versions' ms
    and SDPA's with the bias in a float mask."""
    from tpu_mx_torch.parallel import attention
    dev, rate = "cuda", 0.1
    bh, scale = b * h, 1.0 / math.sqrt(d)
    f32 = dtype == torch.float32
    q, k, v, do = (torch.randn((b, h, t, d), generator=gen).to(dev, dtype)
                   for _ in range(4))
    bias = torch.randn(bias_shape, generator=gen).to(dev)
    seed = torch.randint(0, 2 ** 31 - 1, (1,), generator=gen,
                         dtype=torch.int32).to(dev)
    vl = torch.tensor(valid, dtype=torch.int32, device=dev)
    counters = (fa.flash_attention, fa.flash_attention_bwd_dq,
                fa.flash_attention_bwd_dkv)
    leaves = [x.detach().requires_grad_() for x in (q, k, v, bias)]
    for c in counters:
        c.launches = 0
    before = routes_of(fa)
    out = attention(*leaves[:3], causal=causal, valid_length=vl,
                    dropout_rate=rate, dropout_seed=seed, bias=leaves[3])
    out.backward(do)
    torch.cuda.synchronize()
    launches = dict(zip(FLASH_KERNELS, (c.launches for c in counters)))

    # the kernels with the bias folded as mha_flash_attention folds it
    kb = bias.expand(b, h, t, t) if bias_shape[2] == 1 else bias
    kb = kb.reshape(-1, t, t)
    fold = lambda x: x.reshape(bh, t, d)
    qf, kf, vf, dof = (fold(x) for x in (q, k, v, do))
    kv = vl.repeat_interleave(h)
    opts = dict(causal=causal, kv_valid=kv, dropout_rate=rate,
                dropout_seed=seed, bias=kb, bias_groups=kb.shape[0])
    got, lse = fa.flash_attention(qf, kf, vf, return_lse=True, **opts)
    ref, ref_lse = fa.flash_attention_plain(qf, kf, vf, scale, causal, kv,
                                            rate, seed, kb)
    delta = fa.flash_attention_delta(dof, ref)
    args = (qf, kf, vf, dof, ref_lse, delta, scale, causal, kv, rate, seed,
            kb)
    want = fa.flash_attention_bwd_plain(*args)
    want_db = sum_to(want[3].reshape(b, h, t, t), bias_shape)
    # d_bias over memory filled with NaN by the call before: every
    # element must be written (masked ones as 0)
    poison = torch.full((bh, t, t), math.nan, device=dev)
    at = poison.data_ptr()
    del poison
    dq, db_full = fa.flash_attention_bwd_dq(*args, want_d_bias=True)
    dk, dv = fa.flash_attention_bwd_dkv(*args)
    torch.cuda.synchronize()
    # the main path and the checked calls: bf16 on the tensor cores only
    routes = {name: route_since(fa, name, before) for name in FLASH_KERNELS}
    cols = torch.arange(t, device=dev)
    masked = cols[None, None, :] >= kv[:, None, None].long()
    if causal:
        masked = masked | (cols[None, None, :] > cols[None, :, None])
    poison_ok = (db_full.data_ptr() == at and bool(torch.isfinite(db_full)
                                                   .all())
                 and bool((db_full[masked.expand_as(db_full)] == 0).all()))
    del db_full

    tol = lambda r: FLASH_ATOL if f32 else BF16_REL * float(r.abs().max())
    err = lambda a, r: float((a.float() - r.float()).abs().max())
    errors = {"out": (err(got, ref), tol(ref)),
              "lse": (err(lse, ref_lse), FLASH_ATOL),
              "dq": (err(dq, want[0]), tol(want[0])),
              "dk": (err(dk, want[1]), tol(want[1])),
              "dv": (err(dv, want[2]), tol(want[2])),
              "d_bias": (err(leaves[3].grad, want_db), tol(want_db)),
              # the main path ran the same kernels on the same inputs
              "attention_out": (err(out.detach().reshape(bh, t, d), got),
                                0.0)}
    rec = dict(shape=f"B={b} H={h} T={t} D={d} "
                     f"{str(dtype).split('.')[-1]} "
                     f"{'causal' if causal else 'non-causal'} valid "
                     f"{min(valid)}-{max(valid)} dropout {rate}",
               bias_shape=list(bias_shape), bias_dtype="float32",
               launches=launches, routes=routes,
               max_abs_err={n: e for n, (e, _) in errors.items()},
               atol={n: a for n, (_, a) in errors.items()},
               d_bias_poison_ok=poison_ok)
    ok = (all(math.isfinite(e) and e <= a for e, a in errors.values())
          and poison_ok and all(n > 0 for n in launches.values())
          and routes == (F32_ROUTES if f32 else BF16_ROUTES))
    rec["ok"] = ok

    plain_opts = dict(causal=causal, kv_valid=kv, dropout_rate=rate,
                      dropout_seed=seed)
    no_bias = args[:-1]
    rec["ms"] = {
        "flash_attention_fwd": cuda_ms(torch, lambda: fa.flash_attention(
            qf, kf, vf, return_lse=True, **opts)),
        "flash_attention_bwd_dq": cuda_ms(
            torch, lambda: fa.flash_attention_bwd_dq(*args,
                                                     want_d_bias=True)),
        "flash_attention_bwd_dkv": cuda_ms(
            torch, lambda: fa.flash_attention_bwd_dkv(*args))}
    rec["ms_no_bias"] = {
        "flash_attention_fwd": cuda_ms(torch, lambda: fa.flash_attention(
            qf, kf, vf, return_lse=True, **plain_opts)),
        "flash_attention_bwd_dq": cuda_ms(
            torch, lambda: fa.flash_attention_bwd_dq(*no_bias)),
        "flash_attention_bwd_dkv": cuda_ms(
            torch, lambda: fa.flash_attention_bwd_dkv(*no_bias))}
    rec["plain_ms"] = {
        "forward": cuda_ms(torch, lambda: fa.flash_attention_plain(
            qf, kf, vf, scale, causal, kv, rate, seed, kb), reps=3, warm=1),
        "backward": cuda_ms(torch, lambda: fa.flash_attention_bwd_plain(
            *args), reps=3, warm=1)}

    # the library yardstick: SDPA with the bias in a float mask, -inf
    # past valid_length (and above the diagonal), no dropout
    sdpa = torch.nn.functional.scaled_dot_product_attention
    pad = torch.zeros((b, 1, 1, t), dtype=dtype, device=dev)
    pad.masked_fill_(cols[None, None, None, :] >= vl[:, None, None, None]
                     .long(), -math.inf)
    mask = bias.to(dtype) + pad
    if causal:
        mask = mask.masked_fill(cols[None, :] > cols[:, None], -math.inf)
    lib = {"forward": cuda_ms(torch, lambda: sdpa(q, k, v, attn_mask=mask)),
           "backward": None}
    lib_error = None
    try:
        lv = [x.detach().requires_grad_() for x in (q, k, v, mask)]
        lout = sdpa(*lv[:3], attn_mask=lv[3])
        lib["backward"] = cuda_ms(torch, lambda: torch.autograd.grad(
            lout, lv, do, retain_graph=True))
        del lout, lv
    except RuntimeError as e:   # SDPA may refuse a gradient for the mask
        lib_error = f"{type(e).__name__}: {e}"[:300]
    rec["library_ms"], rec["library_error"] = lib, lib_error

    elt = q.element_size()
    fpm, qb, kvb, rowb = flash_work(bh, t, d, causal, kv.tolist(), elt)
    bias_b = kb.numel() * kb.element_size()
    db_b = bh * t * t * 4
    work = {"flash_attention_fwd": (2 * qb + 2 * kvb + rowb + 4 * bh
                                    + bias_b, 2 * fpm),
            "flash_attention_bwd_dq": (3 * qb + 2 * kvb + 2 * rowb + 4 * bh
                                       + bias_b + db_b, 3 * fpm),
            "flash_attention_bwd_dkv": (2 * qb + 2 * kvb + 2 * rowb
                                        + 2 * bh * t * d * elt + 4 * bh
                                        + bias_b, 4 * fpm)}
    rec["bound"] = {n: bound(nbytes, *tc_work(flops, f32))
                    for n, (nbytes, flops) in work.items()}
    if f32:   # the same work at the FFMA rate, beside the bound
        rec["bound_ffma"] = {n: bound(nbytes, flops)
                             for n, (nbytes, flops) in work.items()}
    return rec


def phase_attention_bias(ctx):
    import torch
    from tpu_mx_torch.kernels import flash_attention as fa
    gen = torch.Generator().manual_seed(3)
    b, h = TRAIN_BATCH, 12
    valid = torch.randint(TRAIN_VALID[0], TRAIN_VALID[1] + 1, (b,),
                          generator=gen).tolist()
    f32_valid = torch.randint(350, 701, (1,), generator=gen).tolist()
    cases = [(name, b, h, TRAIN_SEQ, 64, torch.bfloat16, False, valid, shape)
             for name, shape in BIAS_LAYOUTS]
    cases.append(("f32_causal", 1, 32, 700, 128, torch.float32, True,
                  f32_valid, (1, 32, 700, 700)))
    recs = {}
    for name, *case in cases:
        rec = bias_case(torch, fa, gen, *case)
        emit("attention_bias", layout=name, card=ctx["smi"], **rec)
        if not rec["ok"]:
            ctx["failures"].append(f"attention_bias {name}: "
                                   f"{rec['max_abs_err']}")
        recs[name] = rec
        torch.cuda.empty_cache()
    ctx["bias"] = recs


def phase_rtc(ctx):
    """The reference's rtc kernels as CUDA source, compiled at run time,
    on 2**26 float32 elements."""
    import torch
    from tpu_mx_torch import nd, rtc
    from tpu_mx_torch.base import MXNetError
    gen = torch.Generator(device="cuda").manual_seed(4)
    x, a, b = (torch.randn(RTC_N, device="cuda", generator=gen)
               for _ in range(3))
    mod = rtc.CudaModule(RTC_SOURCE)
    scale, addmul = mod.get_kernel("scale", alpha=3.0), \
        mod.get_kernel("addmul")
    t0 = time.perf_counter()
    mod.cubin()
    build_s = time.perf_counter() - t0

    rtc.Kernel.launches = 0
    y = scale.launch((x,))
    o = addmul((a, b))
    y_nd = scale.launch((nd.array(x),))         # NDArray in, NDArray out
    torch.cuda.synchronize()
    launches = rtc.Kernel.launches
    want_y, want_o = x * 3.0, a * b + a
    terms = (a * b).abs() + a.abs()
    addmul_rel = float(((o - want_o).abs() / terms.clamp_min(1e-30)).max())
    errs = {"scale": float((y - want_y).abs().max()),
            "addmul": float((o - want_o).abs().max())}
    checks = {"scale_bit_equal": torch.equal(y, want_y),
              "ndarray_scale_bit_equal": isinstance(y_nd, nd.NDArray)
              and torch.equal(y_nd._data, want_y),
              "addmul_rel": addmul_rel <= 1e-6, "launches": launches == 3}
    del y, o, y_nd, want_y, want_o, terms

    buf = torch.empty_like(x)
    nbytes = {"scale": 2 * 4 * RTC_N, "addmul": 3 * 4 * RTC_N}
    flops = {"scale": RTC_N, "addmul": 2 * RTC_N}
    timed = {
        "scale": (lambda: scale.launch((x,)), lambda: x * 3.0,
                  lambda: torch.mul(x, 3.0, out=buf)),
        "addmul": (lambda: addmul((a, b)), lambda: a * b + a,
                   lambda: torch.addcmul(a, a, b, out=buf))}
    kernels = {}
    for name, (kern, plain, lib) in timed.items():
        b_ms, b_by = bound(nbytes[name], flops[name])
        kernels[name] = dict(
            ms=cuda_ms(torch, kern, queued=True),
            ms_with_host=cuda_ms(torch, kern),
            plain_ms=cuda_ms(torch, plain, queued=True),
            library_ms=cuda_ms(torch, lib, queued=True), bound_ms=b_ms,
            bound_by=b_by, max_abs_err=errs[name])
        kernels[name].update(rates(flops[name], kernels[name]["ms"], b_ms))

    refusals = {}
    bad = rtc.CudaModule('extern "C" __global__ void bad(const float* x, '
                         'float* y, int n) { y[0] = undefined_name; }')
    try:
        bad.get_kernel("bad").launch((x[:8],))
        refusals["nvcc_error"] = "no error"
    except MXNetError as e:
        refusals["nvcc_error"] = str(e)[-400:]
    checks["nvcc_log_in_error"] = "undefined_name" in refusals["nvcc_error"]
    try:
        mod.get_kernel("scal")
        refusals["unknown_kernel"] = "no error"
    except MXNetError as e:
        refusals["unknown_kernel"] = str(e)
    checks["unknown_kernel"] = "not found" in refusals["unknown_kernel"]
    ctx["rtc"] = dict(kernels["scale"], launches=launches,
                      shape=f"{RTC_N} float32 elements, scale alpha=3.0",
                      addmul=kernels["addmul"])
    emit("rtc", ok=all(checks.values()), checks=checks, n=RTC_N,
         build_seconds=build_s, launches=launches,
         addmul_max_rel_err_of_terms=addmul_rel, kernels=kernels,
         refusals=refusals, card=ctx["smi"])
    for name, ok in checks.items():
        if not ok:
            ctx["failures"].append(f"rtc check {name} failed")


# -- the imperative surface ---------------------------------------------------
def mnist_data(n=MNIST_N):
    """``examples/mnist/train_mnist.py``'s synthetic set (``load_data``'s
    fallback): blurred one-hot strokes from ``RandomState(0)``."""
    rng = np.random.RandomState(0)
    y = rng.randint(0, 10, n)
    x = rng.rand(n, 1, 28, 28).astype(np.float32) * 0.1
    for i, lbl in enumerate(y):
        x[i, 0, lbl * 2:lbl * 2 + 4, 4:24] += 0.9
    return x, y.astype(np.float32)


def mnist_recipe(x, y, hybridize=False):
    """The example's net, trainer, loss and iterator, on the current
    context: ``lenet(10)``, Xavier, SGD lr 0.05 momentum 0.9 built before
    the first forward, softmax cross-entropy, batch 128, shuffled."""
    import tpu_mx_torch as mx
    from tpu_mx_torch import gluon
    from tpu_mx_torch.models.lenet import lenet
    it = mx.io.NDArrayIter(x, y, batch_size=MNIST_BATCH, shuffle=True,
                           label_name="softmax_label")
    net = lenet(classes=10)
    net.initialize(init="xavier")
    if hybridize:
        net.hybridize()
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": MNIST_LR, "momentum": 0.9})
    return net, trainer, gluon.loss.SoftmaxCrossEntropyLoss(), it


def mnist_epoch(torch, net, trainer, loss_fn, it, on_step=None,
                ranges=False):
    """One epoch of the example's loop body; returns the train accuracy,
    the images seen, each step's host ms and the epoch's wall seconds
    (ending in a synchronize).  ``ranges`` names the loop's parts for a
    profile (``lenet.data``, ``lenet.forward``, ``lenet.backward``,
    ``lenet.trainer``, ``lenet.metric``)."""
    import contextlib

    import tpu_mx_torch as mx
    from tpu_mx_torch import autograd
    if ranges:
        from torch.profiler import record_function as part
    else:
        def part(_name):
            return contextlib.nullcontext()
    it.reset()
    metric = mx.metric.Accuracy()
    n, step_ms = 0, []
    t0 = time.perf_counter()
    while True:
        with part("lenet.data"):
            try:
                batch = next(it)
            except StopIteration:
                break
        t1 = time.perf_counter()
        data, label = batch.data[0], batch.label[0]
        with part("lenet.forward"), autograd.record():
            out = net(data)
            loss = loss_fn(out, label)
        with part("lenet.backward"):
            loss.backward()
        with part("lenet.trainer"):
            trainer.step(data.shape[0])
        with part("lenet.metric"):
            metric.update([label], [out])
        step_ms.append((time.perf_counter() - t1) * 1e3)
        n += data.shape[0]
        if on_step is not None:
            on_step()
    torch.cuda.synchronize()
    return metric.get()[1], n, step_ms, time.perf_counter() - t0


def mnist_evaluate(net, it):
    """The example's ``evaluate``: train accuracy in predict mode."""
    import tpu_mx_torch as mx
    metric = mx.metric.Accuracy()
    it.reset()
    for batch in it:
        metric.update([batch.label[0]], [net(batch.data[0])])
    return metric.get()[1]


def boundary_us(torch, net, x, reps=200):
    """Median host microseconds a forward takes through the imperative
    boundary (an ``NDArray`` in, wrapped, modes set) beyond the same
    forward on the raw tensor, in predict mode without a graph."""
    from tpu_mx_torch import autograd, nd
    arr = nd.array(x)
    t = arr._data
    times = {"nd": [], "tensor": []}
    with autograd.predict_mode(), torch.no_grad():
        net.eval()
        for _ in range(reps):
            for key, arg in (("nd", arr), ("tensor", t)):
                t0 = time.perf_counter()
                net(arg)
                times[key].append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return {k: statistics.median(v) * 1e6 for k, v in times.items()}


def mnist_run(torch, x, y, hybridize, ctx_mem=None):
    """The recipe's 3 epochs and its final train accuracy; with
    ``ctx_mem``, ``memory_allocated`` after each step from the second
    epoch on."""
    net, trainer, loss_fn, it = mnist_recipe(x, y, hybridize)
    epochs = []
    for e in range(MNIST_EPOCHS):
        on_step = None
        if ctx_mem is not None and e > 0:
            def on_step():
                ctx_mem.append(torch.cuda.memory_allocated())
        acc, n, step_ms, wall = mnist_epoch(torch, net, trainer, loss_fn, it,
                                            on_step)
        epochs.append(dict(train_acc=float(acc), images=n, seconds=wall,
                           images_per_sec=n / wall,
                           step_ms_median=statistics.median(step_ms)))
    final = float(mnist_evaluate(net, it))
    return net, trainer, loss_fn, it, epochs, final


def phase_mnist_train(ctx):
    """``examples/mnist/train_mnist.py``'s recipe through the port's
    imperative surface: 3 epochs imperatively, then a fresh net
    hybridized for 3 more, each ending in the example's final train
    accuracy (> 0.9); a profiled fourth epoch of the imperative net."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.backends.cudnn.benchmark = False
    x, y = mnist_data()
    # the earlier phases' nets are reference cycles (a block and its
    # Parameters point at each other); collect them now, so a collection
    # inside the measured window cannot read as this loop's memory
    gc.collect()
    t0 = time.perf_counter()
    reset_port_kernel_launches()
    torch.cuda.reset_peak_memory_stats()
    mem = []
    net, trainer, loss_fn, it, epochs, final = mnist_run(torch, x, y, False,
                                                         mem)
    h_net, _, _, _, h_epochs, h_final = mnist_run(torch, x, y, True)
    launches = port_kernel_launches()
    peak = torch.cuda.max_memory_allocated()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, n, step_ms, wall = mnist_epoch(torch, net, trainer, loss_fn, it)
    busy_ms = device_busy_ms(torch, prof)
    launches_per_step = sum(
        e.count for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA
        and e.self_device_time_total > 0) / len(step_ms)
    bound = boundary_us(torch, net, x[:MNIST_BATCH])
    window = mem[10:110]
    ctx["mnist_launches"] = launches
    checks = {
        "accuracy_imperative": bool(final > MNIST_MIN_ACC),
        "accuracy_hybridized": bool(h_final > MNIST_MIN_ACC),
        "hybridized": all(m._active for m in h_net.modules()),
        "memory_flat": len(window) == 100
        and max(window) - min(window) <= MNIST_MEM_SLACK,
        "no_port_kernel_launched": not any(launches.values()),
        "device_busy": busy_ms > 0,
    }
    step_med = statistics.median(
        [e["step_ms_median"] for e in epochs + h_epochs])
    ctx["mnist"] = dict(final=final, hybridized_final=h_final,
                        step_ms=step_med, idle=1 - busy_ms / (wall * 1e3))
    emit("mnist_train", ok=all(checks.values()), checks=checks,
         model="lenet(classes=10), deferred shapes, xavier",
         optimizer=f"sgd lr={MNIST_LR} momentum=0.9 (Trainer before the "
                   "first forward)",
         data=dict(images=len(x), batch=MNIST_BATCH, shuffle=True,
                   source="examples/mnist/train_mnist.py:27-37"),
         imperative=dict(epochs=epochs, final_train_accuracy=final),
         hybridized=dict(epochs=h_epochs, final_train_accuracy=h_final),
         step_ms_median=step_med, min_accuracy=MNIST_MIN_ACC,
         peak_memory_bytes=peak,
         memory_allocated_100_steps=dict(
             min=min(window) if window else None,
             max=max(window) if window else None, slack=MNIST_MEM_SLACK),
         profiled_epoch=dict(wall_ms=wall * 1e3, device_busy_ms=busy_ms,
                             idle_share=1 - busy_ms / (wall * 1e3),
                             launches_per_step=launches_per_step,
                             step_ms_median=statistics.median(step_ms)),
         boundary_host_us=dict(bound, extra=bound["nd"] - bound["tensor"]),
         launches=launches, seconds=time.perf_counter() - t0,
         card=ctx["smi"])
    for name, ok in checks.items():
        if not ok:
            ctx["failures"].append(f"mnist_train check {name} failed")
    del net, h_net, trainer
    torch.cuda.empty_cache()


def _moved(before, after):
    """Per-tensor relative difference of two runs' updates (by norm)."""
    worst, worst_name = 0.0, None
    for name in before["cpu"]:
        d_cpu = after["cpu"][name] - before["cpu"][name]
        d_gpu = after["cuda"][name] - before["cuda"][name]
        rel = float(np.linalg.norm(d_gpu - d_cpu)
                    / max(np.linalg.norm(d_cpu), 1e-30))
        if rel > worst:
            worst, worst_name = rel, name
    return worst, worst_name


def imperative_case(torch, build, x, y, steps=3):
    """``build()``'s net on the CPU and on the card from one weight set:
    predict-mode logits, then ``steps`` imperative SGD steps."""
    import tpu_mx_torch as mx
    from tpu_mx_torch import autograd, gluon, nd
    logits, losses, before, after = {}, {}, {}, {}
    for dev, context in (("cpu", mx.cpu()), ("cuda", mx.gpu(0))):
        with context:
            net = build()
            net.initialize(init="xavier", generator=torch.Generator(
                device=dev).manual_seed(0))
            net(nd.array(x[:2]))                      # the deferred shapes
            params = net.collect_params()
            if dev == "cuda":                # the CPU net's starting weights
                for k, p in params.items():
                    p.set_data(before["cpu"][k])
            logits[dev] = net(nd.array(x)).asnumpy()
            before[dev] = {k: p.data().asnumpy() for k, p in params.items()}
            trainer = gluon.Trainer(params, "sgd", {"learning_rate": 0.05,
                                                    "momentum": 0.9})
            loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
            data, label = nd.array(x), nd.array(y)
            run = []
            for _ in range(steps):
                with autograd.record():
                    loss = loss_fn(net(data), label)
                loss.backward()
                trainer.step(len(x))
                run.append(float(loss.mean().asscalar()))
            losses[dev] = run
            after[dev] = {k: p.data().asnumpy() for k, p in params.items()}
    logit_err = float(np.abs(logits["cuda"] - logits["cpu"]).max())
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses["cuda"],
                                                      losses["cpu"]))
    worst, worst_name = _moved(before, after)
    return dict(logits_max_abs_err=logit_err, losses=losses,
                loss_rel_err=loss_rel, worst_update_rel_err=worst,
                worst_update_param=worst_name,
                ok=logit_err <= LOGITS_ATOL and loss_rel <= LOSS_RTOL
                and worst <= UPDATE_RTOL)


def imperative_bert_pair(torch, cfg, dtype, seed=0):
    """Two BERT models with one weight set (one generator seed each)."""
    from tpu_mx_torch.models import BERTModel
    return [BERTModel(cfg, dtype=dtype, device="cuda",
                      generator=torch.Generator(device="cuda")
                      .manual_seed(seed)) for _ in range(2)]


def imperative_bert_step(net, trainer, loss_fn, batch):
    """``with autograd.record(): loss = MLMLoss()(net(...), labels)``,
    ``loss.backward()``, ``trainer.step(batch size)``; the mean loss."""
    from tpu_mx_torch import autograd
    with autograd.record():
        loss = loss_fn(net(*batch[:4]), batch[4])
    loss.backward()
    trainer.step(batch[0].shape[0])
    return float(loss.mean().asscalar())


def phase_imperative_parity(ctx):
    """The imperative surface on the card against the CPU: LeNet and an
    MLP with BatchNorm (deferred shapes, float32); and a 2-layer float32
    BERT-base-width step through ``autograd.record``/``Trainer`` against
    ``CompiledTrainStep`` on the card, from the same weights."""
    import torch
    from tpu_mx_torch import gluon, nd, optimizer
    from tpu_mx_torch.models import MLMLoss, bert_base_config
    from tpu_mx_torch.models.lenet import lenet
    from tpu_mx_torch.parallel import CompiledTrainStep

    t0 = time.perf_counter()
    x, y = mnist_data(IMPERATIVE_PARITY_BATCH)

    def mlp():
        net = gluon.nn.HybridSequential()
        net.add(gluon.nn.Dense(64, activation="relu"), gluon.nn.BatchNorm(),
                gluon.nn.Dense(10))
        return net
    cases = {"lenet": imperative_case(torch, lambda: lenet(10), x, y),
             "mlp": imperative_case(torch, mlp, x, y)}

    cfg = dict(bert_base_config(max_len=128), num_layers=2, dropout=0.0)
    imp, comp = imperative_bert_pair(torch, cfg, "float32")
    batch = bert_batch(cfg, 2, 128, 19, (128, 97), np.random.RandomState(2))
    tensors = tuple(torch.from_numpy(b).cuda() for b in batch)
    arrays = [nd.array(b, ctx=None) for b in tensors]
    step = CompiledTrainStep(comp, MLMLoss(), optimizer.create(
        "lamb", learning_rate=1e-4), device="cuda")
    trainer = gluon.Trainer(imp.collect_params(), "lamb",
                            {"learning_rate": 1e-4})
    want = float(step.step(*tensors))
    got = imperative_bert_step(imp, trainer, MLMLoss(), arrays)
    named = dict(comp.named_parameters())
    worst, worst_name = 0.0, None
    for k, p in imp.named_parameters():
        rel = float((p.detach() - named[k].detach()).norm()
                    / named[k].detach().norm().clamp_min(1e-30))
        if rel > worst:
            worst, worst_name = rel, k
    bert = dict(loss_imperative=got, loss_compiled=want,
                loss_rel_err=abs(got - want) / abs(want),
                worst_weight_rel_err=worst, worst_param=worst_name)
    bert["ok"] = bert["loss_rel_err"] <= LOSS_RTOL and worst <= UPDATE_RTOL
    cases["bert_imperative_vs_compiled"] = bert
    checks = {name: c["ok"] for name, c in cases.items()}
    ctx["imperative_parity"] = checks
    emit("imperative_parity", ok=all(checks.values()), checks=checks,
         config=dict(lenet="lenet(10), float32", mlp="Dense(64, relu) -> "
                     "BatchNorm -> Dense(10), deferred shapes",
                     batch=IMPERATIVE_PARITY_BATCH, steps=3,
                     optimizer="sgd lr=0.05 momentum=0.9",
                     bert={**cfg, "dtype": "float32", "batch": 2,
                           "seq": 128, "optimizer": "lamb lr=1e-4"}),
         cases=cases, logits_atol=LOGITS_ATOL, loss_rtol=LOSS_RTOL,
         update_rtol=UPDATE_RTOL, seconds=time.perf_counter() - t0)
    for name, ok in checks.items():
        if not ok:
            ctx["failures"].append(f"imperative_parity check {name} failed")
    del imp, comp, step, trainer
    torch.cuda.empty_cache()


def phase_bert_imperative(ctx):
    """One BERT-base step at the train phase's width (bf16, dropout 0.1,
    batch 32 x 512, ragged valid lengths) through the imperative surface,
    ``Trainer("lamb", multi_precision)``, beside ``CompiledTrainStep``'s
    step from the same weights, in turns."""
    import torch
    from tpu_mx_torch import gluon, nd, optimizer
    from tpu_mx_torch.kernels import flash_attention as fa
    from tpu_mx_torch.models import MLMLoss, bert_base_config
    from tpu_mx_torch.parallel import CompiledTrainStep

    cfg = bert_base_config(max_len=TRAIN_SEQ)
    rng = np.random.RandomState(0)
    valid = rng.randint(TRAIN_VALID[0], TRAIN_VALID[1] + 1, TRAIN_BATCH)
    batch = bert_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, TRAIN_MASKED, valid, rng)
    tensors = tuple(torch.from_numpy(b).cuda() for b in batch)
    arrays = [nd.array(t) for t in tensors]
    t0 = time.perf_counter()
    imp, comp = imperative_bert_pair(torch, cfg, "bfloat16")
    trainer = gluon.Trainer(imp.collect_params(), "lamb",
                            {"learning_rate": 1e-4,
                             "multi_precision": True})
    step = CompiledTrainStep(comp, MLMLoss(), optimizer.create(
        "lamb", learning_rate=1e-4, multi_precision=True))
    loss_fn = MLMLoss()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    losses = {"imperative": [imperative_bert_step(imp, trainer, loss_fn,
                                                  arrays)],
              "compiled": [float(step.step(*tensors))]}   # warm-up
    torch.cuda.reset_peak_memory_stats()
    step_ms = {"imperative": [], "compiled": []}
    counters = (fa.flash_attention, fa.flash_attention_bwd_dq,
                fa.flash_attention_bwd_dkv)
    launches = dict.fromkeys(port_kernel_launches(), 0)
    routes = {k: fa.route_counts() for k in FLASH_KERNELS}
    for _ in range(TRAIN_STEPS):
        for kind in ("imperative", "compiled"):
            if kind == "imperative":    # the imperative path's counts only
                reset_port_kernel_launches()
                for c in counters:
                    c.routes = fa.route_counts()
            t1 = time.perf_counter()
            if kind == "imperative":
                losses[kind].append(imperative_bert_step(imp, trainer,
                                                         loss_fn, arrays))
            else:
                losses[kind].append(float(step.step(*tensors)))
            step_ms[kind].append((time.perf_counter() - t1) * 1e3)
            if kind == "imperative":
                for name, n in port_kernel_launches().items():
                    launches[name] += n
                for name, c in zip(FLASH_KERNELS, counters):
                    for r, n in c.routes.items():
                        routes[name][r] += n
    peak = torch.cuda.max_memory_allocated()
    layers = cfg["num_layers"]
    med = {k: statistics.median(v) for k, v in step_ms.items()}
    first_rel = abs(losses["imperative"][0] - losses["compiled"][0]) \
        / abs(losses["compiled"][0])
    checks = {
        "flash_launches": all(launches[k] == layers * TRAIN_STEPS
                              for k in FLASH_KERNELS),
        "wgmma_routes": all(r == dict(fa.route_counts(),
                                      wgmma=layers * TRAIN_STEPS)
                            for r in routes.values()),
        "paged_and_rtc_idle": launches["paged_attention"] == 0
        and launches["rtc"] == 0,
        "finite": all(math.isfinite(v) for run in losses.values()
                      for v in run),
        "first_loss_matches_compiled": first_rel <= BF16_REL,
    }
    ctx["bert_imperative_launches"] = launches
    ctx["bert_imperative"] = dict(step_ms=med)
    emit("bert_imperative", ok=all(checks.values()), checks=checks,
         model={**cfg, "dtype": "bfloat16"},
         batch=dict(batch=TRAIN_BATCH, seq=TRAIN_SEQ, masked=TRAIN_MASKED,
                    valid_length=[int(v) for v in valid]),
         optimizer="Trainer lamb lr=1e-4 multi_precision, step(32)",
         setup_seconds=setup_s, losses=losses, step_ms=step_ms,
         step_ms_median=med, seq_per_sec={k: TRAIN_BATCH / v * 1e3
                                          for k, v in med.items()},
         first_loss_rel_err=first_rel, first_loss_rtol=BF16_REL,
         peak_memory_bytes=peak, launches=launches,
         launches_per_step={k: v / TRAIN_STEPS for k, v in launches.items()},
         routes=routes, card=ctx["smi"])
    for name, ok in checks.items():
        if not ok:
            ctx["failures"].append(f"bert_imperative check {name} failed")
    del imp, comp, step, trainer
    torch.cuda.empty_cache()


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
                     ("serve", phase_serve),
                     ("serve_features", phase_serve_features),
                     ("train_parity", phase_train_parity),
                     ("train", phase_train),
                     ("train_f32", phase_train_f32),
                     ("resnet_parity", phase_resnet_parity),
                     ("resnet_train", phase_resnet_train),
                     ("lstm_parity", phase_lstm_parity),
                     ("lstm_train", phase_lstm_train),
                     ("ssd_parity", phase_ssd_parity),
                     ("ssd_train", phase_ssd_train),
                     ("imperative_parity", phase_imperative_parity),
                     ("mnist_train", phase_mnist_train),
                     ("bert_imperative", phase_bert_imperative),
                     ("attention_bias", phase_attention_bias),
                     ("rtc", phase_rtc)):
        try:
            fn(ctx)
        except Exception as e:  # noqa: BLE001 — reported, and the run fails
            traceback.print_exc()
            emit(name, ok=False, error=f"{type(e).__name__}: {e}"[:2000])
            ctx["failures"].append(f"phase {name}: {type(e).__name__}")
            if name == "build":
                break
    if ctx["failures"] or not {"kernels", "launches", "train_launches",
                                "train_f32_launches", "f32_kernels",
                                "serve_features_launches",
                                "resnet_parity", "resnet_launches",
                                "lstm_launches", "ssd_launches", "bias",
                                "rtc", "imperative_parity", "mnist_launches",
                                "bert_imperative_launches"} \
            <= ctx.keys():
        print(f"chip_smoke: FAILED: {ctx['failures']}", file=sys.stderr)
        return 1
    launches = {**ctx["train_launches"],
                "paged_attention": ctx["launches"]["paged_attention"]}
    kernels = []
    for name, source, replaces, path in (
            ("flash_attention_fwd", "tpu_mx_torch/csrc/flash_attention_fwd.cu",
             "tpu_mx/kernels/flash_attention.py:263", "train"),
            ("flash_attention_bwd_dq",
             "tpu_mx_torch/csrc/flash_attention_bwd.cu",
             "tpu_mx/kernels/flash_attention.py:465", "train"),
            ("flash_attention_bwd_dkv",
             "tpu_mx_torch/csrc/flash_attention_bwd.cu",
             "tpu_mx/kernels/flash_attention.py:499", "train"),
            ("paged_attention", "tpu_mx_torch/csrc/paged_attention.cu",
             "tpu_mx/kernels/paged_attention.py:223", "serve")):
        e = ctx["kernels"][name]
        row = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "launches": launches[name],
               "launches_path": path, "max_abs_err": e["max_abs_err"],
               "ms": e["ms"], "plain_ms": e["plain_ms"],
               "bound_ms": e["bound_ms"], "bound_by": e["bound_by"],
               "library_ms": e["library_ms"], "shape": e["shape"],
               "tflops": e["tflops"], "bound_over_ms": e["bound_over_ms"],
               "math_route": e["math_route"],
               "launches_resnet": ctx["resnet_launches"][name],
               "launches_lstm": ctx["lstm_launches"][name],
               "launches_ssd": ctx["ssd_launches"][name],
               "launches_mnist": ctx["mnist_launches"][name],
               "launches_bert_imperative":
                   ctx["bert_imperative_launches"][name],
               "launches_serve_features":
                   ctx["serve_features_launches"][name],
               "launches_train_f32": ctx["train_f32_launches"][name]}
        if name == "paged_attention":   # the speculative verify window
            t4 = ctx["paged_tq4"]
            row["tq4"] = {k: t4[k] for k in ("shape", "ms", "ms_queued",
                                             "plain_ms", "bound_ms",
                                             "bound_by", "math_route")}
            row["tq4"]["launches"] = ctx["serve_features_tq4"]
        if "ms_queued" in e:
            row["ms_queued"] = e["ms_queued"]
        path_routes = (ctx["decode_routes"] if name == "paged_attention"
                       else ctx["train_routes"].get(name))
        if path_routes is not None:   # as the main path's run reported
            row["math_route"] = "+".join(
                r for r, n in path_routes.items() if n) or "none"
        if name == "flash_attention_fwd":   # the serving prefill, float32
            s = ctx["serve_fwd"]
            row["serve"] = {k: s[k] for k in (
                "shape", "ms", "ms_queued", "library_ms", "library_ms_queued",
                "plain_ms", "bound_ms", "bound_by", "bound_ms_ffma",
                "math_route")}
            row["serve"]["launches"] = ctx["launches"]["flash_attention_fwd"]
        if name in FLASH_KERNELS:    # float32: train_f32's shape, T=700
            f32 = ctx["f32_kernels"][name]
            row["f32"] = {key: dict(f32[key], launches=(
                ctx["train_f32_launches"][name] if key == "bert" else None))
                for key in ("bert", "t700")}
            row["f32"]["train_f32_routes"] = ctx["train_f32_routes"][name]
        if name in FLASH_KERNELS:    # with the per-head bias, same shape
            bias = ctx["bias"]["per_head"]
            row["bias"] = {
                "shape": bias["shape"], "bias_shape": bias["bias_shape"],
                "launches": bias["launches"][name],
                "ms": bias["ms"][name], "ms_no_bias": bias["ms_no_bias"][name],
                "bound_ms": bias["bound"][name][0],
                "bound_by": bias["bound"][name][1],
                "plain_ms": bias["plain_ms"]["forward" if name ==
                                             "flash_attention_fwd"
                                             else "backward"],
                "library_ms": bias["library_ms"]["forward" if name ==
                                                 "flash_attention_fwd"
                                                 else "backward"]}
        kernels.append(row)
    r = ctx["rtc"]
    kernels.append({"name": "rtc", "route": "cuda",
                    "source": "tpu_mx_torch/rtc.py",
                    "replaces": "tpu_mx/rtc.py:59", "launches": r["launches"],
                    "launches_path": "rtc", "max_abs_err": r["max_abs_err"],
                    "ms": r["ms"], "plain_ms": r["plain_ms"],
                    "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                    "library_ms": r["library_ms"], "shape": r["shape"],
                    "tflops": r["tflops"], "bound_over_ms": r["bound_over_ms"],
                    "math_route": "ffma", "addmul": r["addmul"],
                    "launches_resnet": ctx["resnet_launches"]["rtc"],
                    "launches_lstm": ctx["lstm_launches"]["rtc"],
                    "launches_ssd": ctx["ssd_launches"]["rtc"],
                    "launches_mnist": ctx["mnist_launches"]["rtc"],
                    "launches_bert_imperative":
                        ctx["bert_imperative_launches"]["rtc"],
                    "launches_serve_features":
                        ctx["serve_features_launches"]["rtc"],
                    "launches_train_f32": ctx["train_f32_launches"]["rtc"]})
    print(ctx["smi"], flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
