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
   ``serve_recovery`` — serving's robustness and recovery planes at the
                 same width (``max_batch=8``, block 16, 1024 blocks), each
                 arm against a run with every plane off: (a) the
                 committed-token journal off and on in turns, twice (step
                 ms, fsyncs a step, journal bytes); (b) a child process
                 serving with ``TPUMX_CHAOS=kill9_at_decode_step=4`` and
                 ``journal=`` must exit 137 without rebuilding a kernel,
                 then ``recover()`` here resumes every unfinished stream
                 with one replay prefill each (``tf32x3``), nothing
                 re-decoded, lost, duplicated or re-yielded
                 (``recover()``-to-last-resumed ms); (c) ``deadline=``
                 with a wedged decode step: one ``WatchdogTimeout``, one
                 classified restart to generation 1, a black box that
                 ``tracing.validate_blackbox`` accepts, restart ms (fire
                 to next token), and one pool's memory once the zombie
                 step has ended; (d) a 3-restart storm within
                 ``max_restarts=3``, then ``max_restarts=0``: queued
                 requests fail loudly, the running batch drains; (e) one
                 restart, replay prefill against the legacy prompt-replay
                 arm (tokens re-decoded, wall ms); (f) ``handoff()`` and
                 ``drain()`` mid-run; (g) ``slo=True``: a finite signal,
                 TTFT/ITL window quantiles; (h) the capacity ledger's
                 audit at every step under two tenants, and a forensic
                 record valid under ``validate_forensic_doc`` from a
                 64-block pool; (i) ``StaticBatchingScheduler`` against
                 continuous batching (tokens/s).  Every run's flash
                 launches are on ``tf32x3`` and paged launches on
                 ``split_k``; streams equal the reference run's or split
                 only at a near tie;
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
                 times a step on the ``wgmma`` route.  The trainer's
                 states after step 1 go through ``save_states`` (the
                 reference's pickle; bytes and seconds) into a fresh
                 ``Trainer``'s ``load_states`` (seconds): with step 1's
                 weights and dropout generators restored, the loaded
                 state tensors' checksums equal the saved ones and step
                 2's loss equals the unbroken run's bit for bit;
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
                 nvcc's log reaches the error of bad source.  Each kernel
                 is timed queued (device time), with the launch's host
                 path in the window, and by the host clock over 200
                 launches enqueued back to back (``host_us``), beside
                 ``torch.mul``/``addcmul`` timed the same three ways; ``scale4`` (``scale``
                 written for the card: 16-byte loads and stores) is timed
                 beside ``torch.mul`` and must equal ``x * 3.0`` too.

18. ``zoo_parity`` — the seven vision networks of ``train_imagenet.py``
                 (``alexnet``, ``vgg16``, ``squeezenet1_0``,
                 ``mobilenet1_0``, ``mobilenet_v2_1_0``, ``densenet121``,
                 ``inception_v3``), channels-last float32 at batch 2 and
                 small inputs (``ZOO_PARITY_SIZE``), built on the card and
                 on the CPU from one Xavier weight set (drawn for the
                 channels-first twin), dropout off: eval logits within 1e-4
                 of max|logit|, one momentum-SGD step's loss within 1e-4
                 relative and every convolution's and dense layer's
                 updated tensor within 1e-2 in norm; over the BatchNorm
                 tensors and any tensor whose CPU float32 update is more
                 than 1e-3 from a float64 run of the same step (a shift's
                 gradient sums what the next BatchNorm made cancel), the
                 card's summed error against float64 is at most twice the
                 CPU's or 1e-2 of their update; each optimizer's
                 ``update_core`` (the 13 of the slice, SGD, Adam, LAMB)
                 three steps card against CPU within 1e-5 relative; each of
                 the four schedulers driving ``CompiledTrainStep``'s rate,
                 which must equal ``sched(t)`` at every step;
19. ``zoo_train`` — the seven networks at full width through the
                 example's recipe (``get_model(name, classes=1000)``,
                 Xavier, bfloat16, NHWC, softmax CE, SGD 0.1 / 0.9 / 1e-4
                 with f32 masters, ``CompiledTrainStep``) at batch 128 of
                 224x224 (299x299 for Inception), 1 warm-up and 3 timed
                 steps each (cuDNN's heuristics): step ms, images/s,
                 TFLOP/s at 6 x the forward multiply-adds counted from the
                 layer shapes (held within 5% of the published figures),
                 its share of 989, peak memory, finite losses, and no port
                 kernel launched;
20. ``zoo_example`` — ``examples/image_classification/
                 train_imagenet.py`` unedited, on the card, through a
                 ``sys.modules`` alias of ``tpu_mx`` to the port:
                 ``--network mobilenet_v2_1_0 --layout NHWC --epochs 1
                 --model-prefix <tmp>`` (20 steps at batch 128): it ends,
                 every ``DevicePrefetchIter`` batch arrives on the card in
                 bfloat16, no module of ``tpu_mx/`` nor ``jax`` is loaded,
                 the ``.params`` it wrote has the reference's members (each
                 bfloat16 weight as ``'<V2'``) and loads bit-equal into a
                 fresh network on the CPU; the example's own images/s.

21. ``moe_parity`` — a thin MoE BERT (2 layers of units 64, 2 heads,
                 ``moe_every=1``, 4 experts, top-2, float32, dropout 0.1,
                 batch 4 x 64 with ragged valid lengths) on the card
                 against the CPU from one weight set, the card's layers
                 drawing their dropout masks and seeds from a host
                 generator in the CPU's state: three ``CompiledTrainStep``
                 LAMB steps of MLM loss + 0.01 x aux, with remat off, on
                 (every output recomputed) and on with ``dots_saveable``:
                 losses within 1e-4 relative, every tensor's change
                 within 1e-2 in norm, the routing (experts, slots, drops)
                 equal card against CPU at every call, the remat runs'
                 losses bit-equal to the run without, and the flash
                 kernels on ``tf32x3`` (the forward launched again in the
                 backward only where remat recomputes it);
22. ``moe_train`` — BERT-base with ``moe_every=2`` (6 MoE layers of 8
                 experts, top-2, capacity factor 1.25) in bf16, LAMB with
                 f32 masters, dropout 0.1, MLM loss + 0.01 x aux, batch
                 32 x 512 with ragged valid lengths: 1 warm-up and 3
                 timed steps with remat off, on, and on with
                 ``dots_saveable``, each from the same weights and
                 generator state: step ms, sequences/s, peak memory, the
                 aux term; losses equal across the three, the flash
                 dq and dk/dv 12 times a step on ``wgmma`` (the forward
                 12, or 24 where remat recomputes it); then
                 ``save_checkpoint``, a fresh step's
                 ``load_checkpoint`` and one more step each: equal losses
                 and ``fingerprint()``s;
23. ``bert_example`` — ``examples/bert/pretrain.py`` unedited through a
                 ``sys.modules`` alias of ``tpu_mx`` at its defaults
                 (BERT-base, seq 128, batch 8, 30 LAMB steps, bf16): its
                 own assertion that the loss falls holds, its seq/s,
                 the flash launches (12 a step, ``wgmma``), no module of
                 ``tpu_mx/`` loaded; and the host time of the example's
                 ``MLMLoss`` (its ``hybrid_forward`` on jax-method
                 arrays) beside the same arithmetic on plain tensors;
24. ``moe_example`` — ``examples/moe/train_moe_lm.py`` unedited at its
                 defaults (vocabulary 1000, units 256, hidden 1024, 8
                 experts, 32 x 64, 60 Adam steps): its own assertion
                 that the loss falls holds, every loss it read came off
                 the card, no module of ``tpu_mx/`` loaded;
25. ``operators`` — the rest of the ``nd.*`` operators, CTC and
                 ``nd.Custom`` at the repo's model shapes, each against
                 the port on the CPU on the same inputs (its leading
                 rows where the operator treats rows apart) and timed
                 (median of 20 by CUDA events, with one PyTorch call
                 computing the same function beside it where there is
                 one): ``sort``/``argsort``/``topk(k=50, "both")``/
                 ``argmax_channel`` at the serving logits (8 x 32000
                 f32) and the MLM logits (32 x 76 x 30522 bf16), values
                 distinct in a row, equal; ``sample_multinomial`` from
                 the serving logits (support, never a zero class, a
                 chi-square over 32 bins of 2**16 draws); the sequence
                 operators at the PTB LSTM's (35, 2048, 650) bf16,
                 equal; the indexing operators at BERT's (32, 512, 768)
                 bf16 with 76 positions a row, equal; ``BatchNorm``
                 (training, inference) and ``batch_norm_core`` at
                 ResNet-50's stage-1 (256, 56, 56, 256) bf16
                 channels-last, 2e-2 of max|ref| (statistics 1e-4); the
                 masked softmaxes at BERT's scores (32, 12, 512, 512)
                 bf16 (fully masked rows exact) and ``RMSNorm`` at
                 (16384, 768); ``linalg_gemm2``/``syrk`` at (384, 512,
                 64) bf16 and ``potrf`` of a 1024 x 1024 f32 SPD matrix;
                 ``im2col``/``col2im`` at (32, 64, 56, 56) f32;
                 ``SoftmaxOutput`` forward and injected gradient at the
                 MLM logits in f32 (``normalization="valid"``); CTC at
                 T=400, N=32, C=29, labels 40-120 long (loss 1e-4
                 relative, gradient 1e-3 in norm, ``F.ctc_loss`` timed
                 beside); every other name on 2**24 f32 elements (1e-5
                 of max|ref|; the samplers' means within 5 standard
                 errors); no kernel of the port launches;
26. ``data``  — the data plane on the card's host.  The native
                 library is built from ``native/tpumx_io.cpp`` (its
                 libjpeg as ``tpu_mx_torch.lib.jpeg_link`` finds it);
                 2,560 synthetic 500 x 375 JPEGs (quality 90, ~110 KB,
                 1000 classes, written with OpenCV) packed by
                 ``native_im2rec``; ``ImageRecordIter``'s native arm
                 alone at batch 256 (resize 256, random 224 crop and
                 mirror, uint8 NHWC into page-locked memory): images/s
                 at 2, 4 and min(nproc, 16) threads, two seeded runs
                 bit-equal, the uint8 feed normalised on the card by
                 ``DevicePrefetchIter`` within 1e-5 of the float32
                 host-normalised feed; ``train_imagenet.py`` unedited
                 (ResNet-50 v1, NHWC, s2d stem, batch 256, one epoch)
                 fed from the records through the native pipe, then its
                 synthetic arm, each with its steady images/s;
                 ``ssd/train.py --feed u8`` at its defaults on 512
                 detection records (1-8 boxes over 20 classes) through
                 the native detection pipe; ``train_mnist.py --epochs
                 1`` on MNIST's four idx files (60,000 + 10,000
                 synthetic digits) through ``MNISTIter``; and
                 ``gluon.data.DataLoader`` over ``vision.MNIST`` with
                 ``ToTensor`` and ``Normalize`` at batch 256, serial, 4
                 forked process workers and 4 threads (batches/s, each
                 equal to the serial epoch), then one epoch of LeNet on
                 the card fed by the process workers.  No kernel of the
                 port launches.
27. ``serve_arms`` — serving's decode arms at the ``serve`` width (after
                 ``serve_recovery``): every ``TPUMX_PAGED_DECODE`` (0, 1,
                 kernel) x ``TPUMX_FUSED_DECODE`` (0, 1) combination, the
                 knobs unset, and the host layer loop at window 4 (paged
                 and dense), each on ``serve``'s 8 greedy requests in
                 two rounds (the second in reverse order): tokens/s,
                 decode-step ms, host crossings a token;
                 ``serve.decode_attention{kind}`` one call a layer a step
                 under the arm's kind, the paged kernel's launches on
                 the paged arms and none on dense; every arm's streams
                 against each other and the CPU port's (near ties
                 allowed).  The decode self-check at rate 1.0 on the
                 host loop and the fused arm (no mismatch, the same
                 streams), and with ``flaky_recompute=1`` armed (one
                 ``DataCorruption``, one classified restart, the
                 streams whole);
28. ``crossover`` — forward plus backward of ``local_flash_attention`` on
                 its dense and flash arms (after ``attention_bias``):
                 bf16 and float32, causal and ``valid_length``, H=12
                 D=64 and H=32 D=128, T from 128 to 2048 at 16384 tokens
                 a call; median ms and peak memory of each, the flash
                 output against the dense one (1e-4 in float32,
                 2e-2 x max|ref| in bf16), and the largest T at which
                 dense wins in both dtypes (``TPUMX_DENSE_MAX_KV``'s
                 measured default, beside the code's);
29. ``quantize`` — ``quantize_net`` of ResNet-50 v1 at full width
                 (float32, NHWC, 224 x 224; after ``data``; BatchNorm's
                 running statistics moved by 30 training-mode forwards
                 first): calibrated on 4 batches of 32 synthetic
                 images, one batch of 32
                 through the int8 net; the int32 accumulators of the
                 stem and of a 3 x 3 of stages 3 and 4 bit-equal to the
                 CPU port's on the same int8 inputs, a full
                 3 x 3 x 512 window of 127 x 127 exact (7.4e7 > 2^24),
                 the int8 logits
                 within 1e-3 x max|logit| of the CPU port's int8 net,
                 int8 against float ms and their argmax agreement; then
                 ``examples/quantization/quantize_cnn.py`` at its
                 defaults through the alias, with its own check;
30. ``estimator`` — ``examples/estimator/train.py`` at its defaults
                 through the alias (forked ``DataLoader`` workers, the
                 Estimator on the card): its own asserts, its wall
                 time.
31. ``supervised_train`` — supervised, deterministically resumable
                 training (after ``crossover``): BERT-base at full width
                 and 5 of its 12 layers (bf16, dropout 0.1, LAMB with
                 float32 masters, batch 32 x 512) through ``CompiledTrainStep`` under
                 ``Supervisor(capsule=CapsuleManager(prefix, iters=[it],
                 state=step, interval=2))`` with
                 ``elastic.save_checkpoint``/``auto_resume``, in fresh
                 processes: (A) 2 epochs of 4 steps; (B) the same under
                 ``TPUMX_CHAOS=crash_at_step=6,hard=1,seed=0`` (exit
                 137); (C) a fresh process resuming B at epoch 1 step 3;
                 (D) a real SIGTERM after step 3 (``preemption_handler``
                 writes the step capsule, exit 143) and its resume —
                 losses bit-equal to A's, final fingerprints A's, every
                 manifest verified.  Then in this process: step ms with
                 and without the supervisor and the host ms of each
                 ``train_step.phase``; a hung step the watchdog turns
                 into a restart from the last verified checkpoint
                 (restart ms); a poisoned loss skipped, then past the
                 budget rolled back; three replicas at depth 2 with one
                 bit flipped on rank 2 after step 3 (the step-4 vote
                 names rank 2); two supervised steps under
                 ``mx.profiler`` whose trace holds the three flash
                 kernels by name, 12 each a step, as the launch counts
                 say, and every phase's span.  Capsule bytes and write
                 ms, checkpoint bytes, save and verify s, resume ms.
32. ``fusion`` — ``engine.bulk()`` (after ``supervised_train``):
                 bench.py's 32-op chain (sin, x1.0009, +0.1, tanh, 8
                 times) on f32 at (64, 64) and at BERT-base's activation
                 (32 x 512 x 768), eager against ``bulk(64)`` (one
                 captured CUDA graph replayed a flush): outputs and
                 gradients bit-equal, ms and host us a chain, the card's
                 kernels and the host's launch calls a chain (profiler);
                 ``nd.sgd_update`` over BERT-base's 154 parameters, eager
                 against bulk (bit-equal, ms, launches), then under a
                 learning rate that moves every step (bit-equal each
                 step; the graph cache held to its byte bound);
                 ``examples/mnist/train_mnist.py`` unedited through the
                 alias with ``TPUMX_FUSION=1`` and ``=0`` (images/s, every
                 step's loss equal); the ns the lazy ``_data`` property
                 adds to an eager op.
33. ``kvstore`` — the imperative BERT-base step (bf16, LAMB, 32 x 512)
                 through ``Trainer`` with ``kvstore="device"``,
                 ``update_on_kvstore=True`` and ``compression_params=
                 {"type": "2bit"}`` against ``kvstore=None``, from one
                 weight set, in turns: losses bit-equal (the 2-bit arm's
                 first), ms a step, push/pull host ms a step; the
                 store's checksums taken on the card, a corrupted
                 aggregate refused at pull; then two
                 processes on the card from ``python -m
                 tpu_mx_torch.tools.launch -n 2`` (``dist_sync`` over
                 gloo, 16 x 512 a rank): the known-values push/pull at
                 BERT-base's parameter shapes, three steps with the two
                 replicas' weight fingerprints equal after each, ms a
                 step and of the host-staged reduction.
34. ``fleet`` — the kill-and-rejoin proof under ``python -m
                 tpu_mx_torch.tools.launch --supervise -n 2`` with
                 ``TPUMX_CHAOS=preempt_worker_at_step=3,preempt_rank=1``,
                 each step a BERT-base training step (bf16) on the
                 worker's shard of 32 x 512: rank 1 evicted, restarted
                 and admitted again, every sample-id ledger the
                 uninterrupted oracle's; restart ms, rejoin ms,
                 ``fleet.on_step`` host ms beside step ms.  A second run
                 with ``slow_worker_rank=1``: the launcher's
                 ``FleetAggregator`` names rank 1 in ``data_wait``, the
                 fleet black box passes ``validate_fleet_section`` and
                 ``tpu_mx_torch/tools/fleet_report.py --validate``.
35. ``mesh`` — two ranks that share the card (``python -m
                 tpu_mx_torch.tools.launch -n 2``, gloo; collectives on
                 CUDA tensors staged through the host at one counted
                 place) run each parallel path on BERT-base (6 of
                 its 12 layers, 768 units, 12 heads of 64, 3072 hidden,
                 vocabulary 30522, T=512; float32, dropout 0; global
                 batch cut to ``MESH_BATCH``): tp=2 with
                 ``bert_sharding_rules``, sp=2 Ulysses, sp=2 ring,
                 GPipe over pp=2 (a BERT-base encoder layer a stage, 4
                 microbatches), FSDP dp=2 (Adam), fp8-compressed dp=2
                 under ``accum_steps=2``, ep=2 on the BERT-base MoE (8
                 experts, top-2).  Each against the same calls at world
                 size 1 on the card (rank 0, same weights and global
                 batch): losses within 1e-4, each parameter's change
                 within 1e-2 in norm (the compressed run: against its
                 plain compressed reference, which a control without
                 the reduction and one without error feedback must
                 miss, and its loss falls), the Ulysses and
                 ring dispatch, the flash kernels' launches on each rank;
                 step ms and host-staged bytes and ms by arm.  The
                 operators phase also holds Gluon's two-pass BatchNorm
                 (``TPUMX_BN_ONEPASS=0``, fault C21) on the card to the
                 CPU port.
36. ``wide_heads`` — head dims 192 and 256 (ROADMAP B item 8) on the
                 main paths: the serve cell's traffic at Gemma's layout
                 (TinyLM 4096 wide, 16 heads of 256, 2 layers: depth
                 cut for the CPU port's references) with a
                 float32 pool, a bfloat16 pool and
                 ``TPUMX_SPECULATIVE=12`` (a window past the paged
                 kernel's 8 rows, walked in chunks): request 0 as the
                 CPU port's, the prefill logits and one decode step's
                 (the arm's pool and window) within 2e-4 of the CPU
                 port's, prefill on ``tf32x3``, decode on ``split_k``,
                 no dense arm; ``parallel.attention`` forward and
                 backward at 16 heads (bf16 T=2048 D=256 and 192 with
                 dropout, float32 T=700 D=256) held to the plain twins;
                 the four bias layouts with ``d_bias`` at bf16 T=512
                 D=256.  The kernel phase times every wide instance
                 (and paged decode with bf16 queries, a float16 pool and
                 a window of 12 at H=16 D=256) against its plain
                 version, bound and SDPA, and holds the bias grid (q in
                 float32 and bf16, D=192 and 256, float32, bf16 and
                 float16 biases in the four layouts, with d_bias) to the
                 plain versions and, in float32, to a float64 witness:
                 a float32 case passes on ``FLASH_ATOL`` and its bound
                 both (ROADMAP B item 8c).  Head dims of 320 and more
                 (ROADMAP B item 8b, the runtime-D instances) alike: the
                 serve traffic at 8 heads of 512 (4 layers) in the same
                 three arms, ``parallel.attention`` at bf16 T=2048 D=512
                 (8 heads, dropout 0.1) and D=320 (12 heads), float32
                 T=700 D=384 and T=512 D=1024; the kernel phase times
                 them (with the recompute factor), adds D=320 and 512 to
                 the bias grid and paged decode at D=320 and 512 (bf16
                 queries, a float16 pool, a window of 12, H=8).
37. ``graph`` — sparse storage and the graph API (ROADMAP A item 10
                 (c), (d)): BERT-base (bf16, 32 x 512, predict mode)
                 through ``HybridBlock.export`` and
                 ``SymbolBlock.imports``: the imported program's forward
                 bit-equal to the block's, the flash forward 12 times a
                 forward on ``wgmma``; the symbolic PTB word LM (10000
                 words, 650 x 2 LSTM) in a ``BucketingModule`` (buckets
                 10, 20, 35 at batch 256, six SGD steps through
                 ``fit``): the first step's rows and loss as the CPU
                 port's, the loss falling, the buckets' arrays shared,
                 the checkpoint bit-equal after ``Module.load``; a
                 Criteo-shaped LibSVM file (39 non-zeros a row in 2^20
                 features, 16384 rows) through ``LibSVMIter``,
                 ``sparse.dot`` against the CPU port and float64,
                 ``retain`` and ``row_sparse_pull`` of a 256 MB table
                 against the CPU port.
38. ``contrib`` — ROADMAP A item 10 (e)-(g): BERT-base (full width,
                 dropout 0.1, 32 x 512) declared in float32, 1 + 3
                 imperative LAMB steps, then under ``contrib.amp``
                 (``init``, ``convert_model``, ``init_trainer``,
                 ``scale_loss``) 1 + 3 more: the losses finite and
                 falling, every parameter's dtype as ``convert_model``
                 promised (LayerNorm float32, the rest bf16), the flash
                 forward, dq and dk/dv 12 times a step each on bf16
                 ``wgmma`` with no dense arm, ``has_overflow`` one
                 device-to-host read over its ~150 gradients in fewer
                 than half a launch a gradient (foreach), step ms and
                 peak memory beside the float32 step's; ``Monitor`` over
                 one amp forward (every layer a stat); a 2-layer amp
                 BERT's logits within 2e-2 x max|ref| of the CPU port's;
                 ``train_mnist.py``'s LeNet under ``amp.init("float16")``
                 for 8 steps, step 6's gradient poisoned with inf (the
                 step skipped bit-exactly, the scale halved, the warning,
                 one host read a step); ``Conv2DLSTMCell`` at Moving
                 MNIST's encoder shape, ``LSTMPCell`` 2048 -> 512,
                 ``PixelShuffle2D`` x3 at ESPCN's shape and
                 ``VariationalDropoutCell`` around ``LSTMCell(650)``
                 against the CPU port (1e-4 x max|ref|) or by their
                 properties; ResNet-50 v1's stem and first stage through
                 ``contrib.onnx`` on the card (1e-5 relative);
                 ``Module.install_monitor`` and ``print_summary`` of the
                 symbolic PTB LM; ``check_consistency`` over
                 ``[gpu(0), cpu(0)]``; ``feature_list()``.  Every patched
                 name restored after it (``amp._deinit()`` in a
                 ``finally``).
The kvstore, fleet and mesh phases run 4 of BERT-base's 12 layers,
supervised_train 3 (the script's time).

Then the card's ``name, power.limit`` line, one ``{"kernels": [...]}``
line, and last ``{"ok": true, "device": {...}}``.  Exits non-zero, and
prints no result, if any phase fails or there is no card.
"""
import gc
import json
import math
import os
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

# the wide heads (phase wide_heads and the kernel phase): Gemma's attention
# layout, 16 heads of 256, at the serve cell's width (4096) and traffic,
# 2 layers deep (the CPU port's references of request 0 read every weight
# a token: depth cut for the script's time); the training attention at
# 16 heads, batch 4
WIDE_SERVE = dict(vocab_size=32000, embed_dim=4096, num_heads=16,
                  num_layers=2, max_positions=4096, seed=0)
WIDE_SPEC_WINDOW = 12            # TPUMX_SPECULATIVE of the chunked arm
WIDE_BATCH, WIDE_HEADS = 4, 16
# (key, dtype name, T, D, dropout): the training attention's shapes, each
# causal with ragged valid lengths in [T/2, T]
WIDE_FLASH = (("bf16_d256", "bfloat16", 2048, 256, 0.1),
              ("bf16_d192", "bfloat16", 2048, 192, 0.1),
              ("f32_d256", "float32", 700, 256, 0.0))
WIDE_BIAS_T, WIDE_BIAS_D = 512, 256
# the bias grid of the wide instances: every q dtype, head dim, bias
# dtype and layout, with d_bias, at B=2 H=2 T=136 (a partial tile),
# causal, ragged valid lengths, dropout 0.1
WIDE_GRID_B, WIDE_GRID_H, WIDE_GRID_T = 2, 2, 136
WIDE_GRID_LAYOUTS = ("per_row", "per_head", "shared", "alibi")
# (key, window, query dtype, pool dtype): paged decode at B=8 H=16 D=256
WIDE_PAGED = (("bf16_q", 1, "bfloat16", "float32"),
              ("f16_pool", 1, "float32", "float16"),
              ("window12", WIDE_SPEC_WINDOW, "float32", "float32"))
# head dims of 320 and more (ROADMAP B item 8b), the runtime-D instances.
# No model family of the repo has such heads: the serve cell's width
# (4096) in 8 heads of 512, 4 layers deep, with the wide arms' pools and
# window; the training attention at B=4, causal with ragged valid
# lengths in [T/2, T]
HUGE_SERVE = dict(vocab_size=32000, embed_dim=4096, num_heads=8,
                  num_layers=4, max_positions=4096, seed=0)
# (key, dtype name, heads, T, D, dropout)
HUGE_FLASH = (("bf16_d512", "bfloat16", 8, 2048, 512, 0.1),
              ("bf16_d320", "bfloat16", 12, 2048, 320, 0.0),
              ("f32_d384", "float32", 16, 700, 384, 0.0),
              ("f32_d1024", "float32", 8, 512, 1024, 0.0))
HUGE_GRID_D = (320, 512)         # the bias grid's runtime-D head dims
HUGE_PAGED_HEADS = 8
# (key, window, query dtype, pool dtype, D): paged decode at B=8 H=8
HUGE_PAGED = (("w12_d320", WIDE_SPEC_WINDOW, "bfloat16", "float16", 320),
              ("w12_d512", WIDE_SPEC_WINDOW, "bfloat16", "float16", 512))

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
# bf16 at head dims of 320 and more: the runtime-D forward and dk/dv on
# wgmma (the split-D design), dq on mma.sync (the column-block design)
BF16_DN_ROUTES = {"flash_attention_fwd": "wgmma",
                  "flash_attention_bwd_dq": "mma",
                  "flash_attention_bwd_dkv": "wgmma"}


def flash_routes(f32, d):
    """The routes the flash kernels report for this dtype and head dim."""
    return F32_ROUTES if f32 else BF16_DN_ROUTES if d > 256 else BF16_ROUTES

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
ZOO_NETS = ("alexnet", "vgg16", "squeezenet1_0", "mobilenet1_0",
            "mobilenet_v2_1_0", "densenet121", "inception_v3")
ZOO_CLASSES, ZOO_BATCH, ZOO_STEPS = 1000, 128, 3
ZOO_SIZE = {"inception_v3": 299}              # else 224
ZOO_SGD = dict(learning_rate=0.1, momentum=0.9, wd=1e-4)
# the parity inputs: each net's least (AlexNet 63, VGG 32, SqueezeNet
# 21), 64 for the MobileNets and DenseNet and 171 for Inception, whose
# last BatchNorms would see two samples a channel at 32 (75): float32
# against float64 of the same step there, DenseNet's losses 6e-2 apart
# (Inception's 8e-4; 7e-6 at 171)
ZOO_PARITY_SIZE = {"alexnet": 63, "vgg16": 32, "squeezenet1_0": 21,
                   "mobilenet1_0": 64, "mobilenet_v2_1_0": 64,
                   "densenet121": 64, "inception_v3": 171}
ZOO_PARITY_BATCH = 2
ZOO_LOGITS_REL = 1e-4        # card against CPU, x max|logit| (PERF.md §2)
ZOO_UPDATE_ATOL = 1e-6       # an update below this norm counts as none
ZOO_COND_RTOL = 1e-3         # the CPU's float32 update this far from
ZOO_COND_FACTOR = 2.0        # float64: see zoo_parity_net
ZOO_BN_LEAVES = ("gamma", "beta", "running_mean", "running_var")
ZOO_OPT_RTOL = 1e-5          # three update_core steps, card against CPU
ZOO_SCHED_STEPS = 6
ZOO_SCHEDULERS = (("FactorScheduler", dict(step=2, factor=0.5)),
                  ("MultiFactorScheduler", dict(step=[2, 4], factor=0.3)),
                  ("PolyScheduler", dict(max_update=6, pwr=2)),
                  ("CosineScheduler", dict(max_update=6, final_lr=0.01)))
# forward multiply-adds an image, the published figures the counted ones
# are held to (AlexNet, VGG-16, SqueezeNet 1.0, MobileNet 1.0, MobileNet
# v2 1.0, DenseNet-121, Inception v3)
ZOO_PUBLISHED_GMAC = {"alexnet": 0.7, "vgg16": 15.5, "squeezenet1_0": 0.8,
                      "mobilenet1_0": 0.57, "mobilenet_v2_1_0": 0.3,
                      "densenet121": 2.9, "inception_v3": 5.7}
ZOO_GMAC_RTOL = 0.05
ZOO_EXAMPLE_STEPS = 20       # train_imagenet.py: 128 x 20 synthetic images
MOE_THIN = dict(num_layers=2, units=64, hidden_size=128, num_heads=2,
                vocab_size=120, max_length=64, dropout=0.1)
MOE_THIN_ARGS = dict(moe_every=1, moe_experts=4, moe_top_k=2)
MOE_THIN_VALID = (64, 41, 57, 33)
MOE_THIN_MASKED = 9
MOE_PARITY_STEPS = 3
MOE_ARGS = dict(moe_every=2, moe_experts=8, moe_top_k=2)   # 6 MoE layers
MOE_STEPS = 3
MOE_AUX_WEIGHT = 0.01
MOE_REMAT_ARMS = ((False, None), (True, None), (True, "dots_saveable"))
BERT_EXAMPLE_STEPS, BERT_EXAMPLE_BATCH = 30, 8   # pretrain.py's defaults
MNIST_MIN_ACC = 0.9         # the example's own assert (train_mnist.py:85)
# memory_allocated over 100 steps: one step's saved activations are ~17 MB
# (conv1's and tanh's 5.9 MB each at batch 128), so a graph kept alive
# a step would pass this at once; the allocator's own churn is < 1 MB
MNIST_MEM_SLACK = 4 << 20
IMPERATIVE_PARITY_BATCH = 16

# the data plane (phase data): ImageNet's typical stored JPEG (500 x 375,
# quality 90, ~110 KB of smooth fields with noise), 1000 classes; VOC-style
# detection records (1-8 boxes over 20 classes); MNIST's sizes
DATA_W, DATA_H, DATA_QUALITY = 500, 375, 90
DATA_CLS_IMAGES, DATA_CLASSES = 2560, 1000
DATA_DET_IMAGES, DATA_DET_CLASSES, DATA_DET_BOXES = 512, 20, 8
DATA_NOISE, DATA_CELLS = 24.0, 12     # ~109 KB a file (OpenCV, quality 90)
DATA_BATCH, DATA_SHAPE, DATA_RESIZE = 256, (3, 224, 224), 256
DATA_MNIST = (60000, 10000)
DATA_LOADER_BATCH, DATA_LOADER_WORKERS = 256, 4
DATA_MNIST_NORM = (0.13, 0.31)
DATA_NORM_ATOL = 1e-5        # uint8 normalised on the card vs on the host
DATA_THREADS = (2, 4)        # and min(nproc, 16): the iterator's rate
IMAGENET_MEAN = (123.68, 116.78, 103.94)      # train_imagenet.py's
IMAGENET_STD = (58.39, 57.12, 57.37)

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

// scale written for the card: 16-byte loads and stores, a scalar tail
extern "C" __global__ void scale4(const float* __restrict__ x,
                                  float* __restrict__ y, float alpha, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  int n4 = n >> 2;
  if (i < n4) {
    float4 v = reinterpret_cast<const float4*>(x)[i];
    v.x *= alpha; v.y *= alpha; v.z *= alpha; v.w *= alpha;
    reinterpret_cast<float4*>(y)[i] = v;
  }
  if (i < (n & 3)) y[(n4 << 2) + i] = x[(n4 << 2) + i] * alpha;
}
'''
RTC_BLOCK = 256


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


def host_us(torch, fn, n=200):
    """Host microseconds a call of ``fn`` takes to enqueue its work: ``n``
    calls back to back on the host clock, the card left to catch up
    after (the queue never fills at these kernels' lengths)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / n * 1e6


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
    bf16 ``*_tc_kernel``s and the bf16 runtime-D forward and dk/dv,
    ``flash_{fwd,dkv}_dn_kernel<__nv_bfloat16, ...>``), 1 HMMA (the
    float32 ``*_tf32x3_kernel``s, the float32 runtime-D forward and
    dk/dv, and the runtime-D dq of both dtypes), None neither."""
    if "_tc_kernel" in kernel or any(
            f"{name}<__nv_bfloat16" in kernel
            for name in ("flash_fwd_dn_kernel", "flash_dkv_dn_kernel")):
        return 0
    if "_tf32x3_kernel" in kernel or ("flash_" in kernel
                                      and "_dn_kernel" in kernel):
        return 1
    return None


def phase_build(ctx):
    """Build every source; report ptxas's registers and spills per kernel
    and the HGMMA and HMMA counts per kernel.  The bf16 forward, dq and
    dk/dv instances (``*_tc_kernel``) must hold HGMMA instructions, the
    float32 forward, dq and dk/dv instances (``*_tf32x3_kernel``) HMMA,
    and neither may spill; every other kernel (paged) holds neither."""
    from concurrent.futures import ThreadPoolExecutor
    from tpu_mx_torch.kernels import _build
    t0 = time.perf_counter()
    libs = _build.build_all()
    secs = time.perf_counter() - t0
    # one cuobjdump a library, all at once (each a subprocess)
    with ThreadPoolExecutor(max_workers=len(libs)) as pool:
        sass = dict(zip(libs, pool.map(mma_counts, libs.values())))
    sass_secs = time.perf_counter() - t0 - secs
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
        counts = sass[name]
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
    emit("build", ok=ok, seconds=secs, sass_seconds=sass_secs,
         phase_seconds=time.perf_counter() - t0, ptxas=report, mma=mma,
         mma_wrong=wrong, f32_mix=mix)
    if not ok:
        ctx["failures"].append(f"build: tensor-core instructions where not "
                               f"expected or missing, or a tensor-core "
                               f"kernel spills: {wrong[:4]}")


def paged_case(torch, gen, tq, pool_dtype, h=32, d=128,
               q_dtype="float32"):
    """B=8 ragged rows of 100-800 tokens, H=32, D=128 (or ``h``, ``d``),
    BS=16, tables scattered over a 1024-block pool and padded to the
    cache's bucket; queries in ``q_dtype``."""
    b, bs, n = 8, 16, 1024
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
    q = torch.randn((b, tq, h, d), generator=gen).to(
        dev, getattr(torch, q_dtype))
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
    wide_kernels(torch, fa, pa, gen, ctx)
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
    # with the kernel's dropout too: the like-for-like yardstick
    lib_fwd_dropout = cuda_ms(torch, lambda: sdpa(
        q4, k4, v4, attn_mask=mask, dropout_p=rate)) if rate else None
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
                == flash_routes(f32, d)[name]),
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
    for name in FLASH_KERNELS:
        recs[name]["recompute"] = recompute_factor(name, d, dtype)
    recs["flash_attention_fwd"]["lse_max_abs_err"] = lse_err
    recs["flash_attention_fwd"]["library_ms_dropout"] = lib_fwd_dropout
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
                    if "library_ms_dropout" in r:
                        entries[name]["library_ms_dropout"] = \
                            r["library_ms_dropout"]
                else:
                    f32.setdefault(name, {})[key] = {k: r[k] for k in (
                        ENTRY_KEYS + ("max_abs_err", "bound_ms_ffma",
                                      "bound_by_ffma"))}
            torch.cuda.empty_cache()
    ctx["f32_kernels"] = f32


def wide_valid(torch, gen, t, heads=WIDE_HEADS):
    """Ragged valid lengths in [T/2, T] of the WIDE_BATCH rows, repeated
    over the heads (the folded rows' kv_valid)."""
    rows = torch.randint(t // 2, t + 1, (WIDE_BATCH,), generator=gen)
    return rows.tolist(), rows.repeat_interleave(heads).tolist()


def flash_cases():
    """``(key, dtype name, heads, T, D, dropout)`` of every wide and huge
    training-attention case."""
    return tuple((k, dt, WIDE_HEADS, t, d, r)
                 for k, dt, t, d, r in WIDE_FLASH) + HUGE_FLASH


def recompute_factor(name, d, dtype):
    """The operations a runtime-D kernel does over the single pass's
    (csrc/flash_dn.cuh); 1 below D = 320.  The forward and dk/dv compute
    each score product once a pass of clusters over D, so theirs is the
    number of passes their library launches with (1 up to D = 4096 and
    2048); the dq kernel's blocks own 64 output columns each and
    recompute the score products."""
    if d <= 256:
        return 1.0
    from tpu_mx_torch.kernels import flash_attention as fa
    if name == "flash_attention_bwd_dq":
        return (2 * d / 64 + 1) / 3
    kernel = "fwd" if name == "flash_attention_fwd" else "dkv"
    return float(fa.kernel_split(d, kernel, dtype)["passes"])


def wide_kernels(torch, fa, pa, gen, ctx):
    """The head dim 192 and 256 instances (ROADMAP B item 8) against their
    plain versions at the wide_heads cell's shapes: the flash forward, dq
    and dk/dv (bf16 BH=64 T=2048 causal with dropout at D=256 and 192,
    float32 T=700 D=256 causal), and paged decode at B=8 H=16 D=256 with
    bf16 queries, a float16 pool and a window of 12 (two chunks of the
    kernel's 8 rows).  Each with its ms, plain ms, bound and SDPA's ms,
    in its own entry of the kernels line (``wide``)."""
    wide = {}
    for key, dt, h, t, d, rate in flash_cases():
        _, valid = wide_valid(torch, gen, t, h)
        recs = flash_case(torch, fa, gen, WIDE_BATCH * h, t, d,
                          getattr(torch, dt), True, rate, valid)
        for name, r in recs.items():
            emit("kernel", name=name, wide=key, **r)
            if not r["ok"]:
                ctx["failures"].append(f"{name} {r['shape']}: err "
                                       f"{r['max_abs_err']}, route "
                                       f"{r['math_route']}")
            wide.setdefault(name, {})[key] = {k: r[k] for k in (
                ENTRY_KEYS + ("max_abs_err", "recompute"))}
        torch.cuda.empty_cache()
    for key, tq, qd, pd, h, d in tuple(
            (k, tq, qd, pd, WIDE_HEADS, 256) for k, tq, qd, pd in WIDE_PAGED) \
            + tuple((k, tq, qd, pd, HUGE_PAGED_HEADS, d)
                    for k, tq, qd, pd, d in HUGE_PAGED):
        q, kp, vp, tab, lens, nblk = paged_case(
            torch, gen, tq, getattr(torch, pd), h=h, d=d, q_dtype=qd)
        scale = 1.0 / math.sqrt(d)
        before = dict(pa.paged_attention.routes)
        out = pa.paged_attention(q, kp, vp, tab, lens)
        route = "+".join(r for r, n in pa.paged_attention.routes.items()
                         if n > before[r]) or "none"
        ref = pa.paged_attention_plain(q, kp, vp, tab, lens, scale)
        torch.cuda.synchronize()
        err = float((out.float() - ref.float()).abs().max())
        atol = PAGED_ATOL if qd == "float32" else \
            BF16_REL * float(ref.float().abs().max())
        ok = (math.isfinite(err) and err <= atol and out.dtype == q.dtype
              and route == "split_k")
        call = lambda: pa.paged_attention(q, kp, vp, tab, lens)
        ms = cuda_ms(torch, call)
        ms_queued = cuda_ms(torch, call, queued=True)
        plain_ms = cuda_ms(torch, lambda: pa.paged_attention_plain(
            q, kp, vp, tab, lens, scale), reps=5)
        kv_bytes = sum(nblk) * 16 * h * d * 2 * kp.element_size()
        nbytes = (kv_bytes + 2 * q.numel() * q.element_size()
                  + tab.numel() * 4 + lens.numel() * 4)
        flops = 4 * int(lens.sum()) * h * d * tq
        b_ms, b_by = bound(nbytes, flops)
        rec = dict(shape=f"B=8 Tq={tq} H={h} D={d} BS=16 q={qd} "
                         f"pool={pd} lengths={lens.tolist()}",
                   ms=ms, ms_queued=ms_queued, plain_ms=plain_ms,
                   library_ms=None, bound_ms=b_ms, bound_by=b_by,
                   math_route=route, max_abs_err=err, atol=atol,
                   **rates(flops, ms, b_ms))
        emit("kernel", name="paged_attention", wide=key, ok=ok, **rec)
        if not ok:
            ctx["failures"].append(f"paged_attention {rec['shape']}: err "
                                   f"{err}, route {route}")
        wide.setdefault("paged_attention", {})[key] = rec
    # the split each runtime-D library launches with is the host-side
    # rule's, which the CPU tests check at every head dim
    drift = [(kn, str(dt), d) for kn in ("fwd", "dkv")
             for dt in (torch.bfloat16, torch.float32)
             for d in range(320, 4609, 64)
             if fa.kernel_split(d, kn, dt, 2048, 64)
             != fa.runtime_d_split(d, kn, dt, 2048, 64)]
    emit("runtime_d_split", ok=not drift, head_dims="320-4608 step 64",
         drift=drift)
    if drift:
        ctx["failures"].append(f"runtime_d_split differs from the "
                               f"libraries' split at {drift[:4]}")
    ctx["wide_kernels"] = wide
    wide_bias_grid(torch, fa, gen, ctx)


def attention64(torch, fa, q, k, v, do, kb, kv, rate, seed, scale):
    """The float64 witness of one causal case, by the plain versions'
    formulas on the same inputs, masks and keep mask, every step in
    float64: ``{out, lse, delta, dq, dk, dv, d_bias}`` (``d_bias`` per
    row ``(BH, T, Tk)``; ``kb`` the folded ``(BH|G|1, T, Tk)`` bias),
    and ``bounds``: elementwise bounds on a float32 backward's error
    against it when fed this lse and delta rounded to float32, the
    model of ``fa.f32_bwd_error_bounds`` (3xTF32 products, sums of n
    terms each off by a unit in the last place n/8 times) with the
    bias's, the scale's and the dropout's roundings added, every term
    doubled."""
    q, k, v, do = (x.double() for x in (q, k, v, do))
    bh, t, d = q.shape
    c = lambda n: 3 * 2 ** -22 + 3 * n / 8 * 2 ** -23
    u = 2 ** -23
    qi = torch.arange(t, device=q.device).reshape(1, t, 1)
    ki = torch.arange(t, device=q.device).reshape(1, 1, t)
    ok = (ki <= qi) & (ki < kv.long().reshape(bh, 1, 1))
    keep = fa.dropout_keep_mask(seed, torch.arange(
        bh, device=q.device).reshape(bh, 1, 1), qi, ki, rate)
    planes = kb.double()
    if planes.shape[0] != bh:
        planes = planes.repeat(bh // planes.shape[0], 1, 1)
    qk = q @ k.transpose(1, 2) * scale
    s = torch.where(ok, qk + planes, -math.inf)
    m = s.amax(-1, keepdim=True)
    lse = m + torch.log(torch.where(ok, torch.exp(s - m), 0.0)
                        .sum(-1, keepdim=True))
    p = torch.where(ok, torch.exp(s - lse), 0.0)
    inv = 1.0 / (1.0 - rate)
    p_drop = torch.where(keep, p * inv, 0.0)
    out = p_drop @ v
    delta = (do * out).sum(-1, keepdim=True)
    dp = torch.where(keep, (do @ v.transpose(1, 2)) * inv, 0.0)
    ds = p * (dp - delta)
    dq, dk = ds @ k * scale, ds.transpose(1, 2) @ q * scale
    dv = p_drop.transpose(1, 2) @ do
    sf = torch.where(ok, s, 0.0)
    e_s = c(d) * (q.abs() @ k.abs().transpose(1, 2)) * scale \
        + u * (qk.abs() + planes.abs())
    e_p = torch.where(ok, p * (e_s + u * (lse.abs() + (sf - lse).abs())
                               + 2 ** -21) + 2 ** -126, 0.0)
    e_dp = torch.where(keep, c(d) * (do.abs() @ v.abs().transpose(1, 2))
                       * inv + u * dp.abs(), 0.0)
    e_ds = e_p * (dp - delta).abs() + p * (
        e_dp + u * delta.abs() + 2 * u * (dp - delta).abs())
    e_pd = torch.where(keep, e_p * inv + u * p_drop, 0.0)
    bounds = {
        "d_bias": 2 * e_ds,
        "dq": 2 * ((e_ds + u * ds.abs()) @ k.abs() * scale
                   + c(t) * (ds.abs() @ k.abs()) * scale + u * dq.abs()),
        "dk": 2 * ((e_ds + u * ds.abs()).transpose(1, 2) @ q.abs() * scale
                   + c(t) * (ds.abs().transpose(1, 2) @ q.abs()) * scale
                   + u * dk.abs()),
        "dv": 2 * (e_pd.transpose(1, 2) @ do.abs()
                   + c(t) * (p_drop.transpose(1, 2) @ do.abs()))}
    return dict(out=out, lse=lse[..., 0], delta=delta[..., 0], dq=dq, dk=dk,
                dv=dv, d_bias=ds, bounds=bounds)


def wide_bias_case(torch, fa, gen, dtype, d, bias_dtype, layout):
    """One case of the wide bias grid: ``parallel.attention(bias=)``
    forward and backward (the layout folded as the main path folds it),
    then each kernel with the folded bias against its plain version on
    the same inputs (fed the plain forward's lse and delta).  bf16
    outputs within BF16_REL x max|ref|; float32 ones within FLASH_ATOL,
    and each float32 gradient also within the bounds of its arithmetic
    of the float64 witness (:func:`attention64`; kernel and plain twin
    then fed the witness's lse and delta, each one's distance from the
    witness recorded).  The main path's d_bias against the
    kernel's own d_bias of its forward, summed to the layout and cast
    to the bias's type (the sums' order aside: FLASH_ATOL x max(1, max)
    for a float32 bias, else BF16_REL x max)."""
    from tpu_mx_torch.parallel import attention
    dev, rate = "cuda", 0.1
    b, h, t = WIDE_GRID_B, WIDE_GRID_H, WIDE_GRID_T
    bh, scale = b * h, 1.0 / math.sqrt(d)
    f32 = dtype == torch.float32
    q, k, v, do = (torch.randn((b, h, t, d), generator=gen).to(dev, dtype)
                   for _ in range(4))
    shape = {"per_row": (b, h, t, t), "per_head": (1, h, t, t),
             "shared": (1, 1, t, t), "alibi": (1, h, 1, t)}[layout]
    bias = torch.randn(shape, generator=gen).to(dev, bias_dtype)
    rows = torch.randint(t // 2, t + 1, (b,), generator=gen).tolist()
    vl = torch.tensor(rows, dtype=torch.int32, device=dev)
    kv = vl.repeat_interleave(h)
    seed = torch.randint(0, 2 ** 31 - 1, (1,), generator=gen,
                         dtype=torch.int32).to(dev)
    counters = (fa.flash_attention, fa.flash_attention_bwd_dq,
                fa.flash_attention_bwd_dkv)
    for cnt in counters:
        cnt.launches = 0
    before = routes_of(fa)
    leaves = [x.detach().requires_grad_() for x in (q, k, v, bias)]
    out = attention(*leaves[:3], causal=True, valid_length=vl,
                    dropout_rate=rate, dropout_seed=seed, bias=leaves[3])
    out.backward(do)
    torch.cuda.synchronize()
    launches = dict(zip(FLASH_KERNELS, (cnt.launches for cnt in counters)))

    groups = None
    if layout == "alibi":
        kb = bias.expand(b, h, t, t).reshape(bh, t, t)
    elif layout == "per_head":
        kb, groups = bias.reshape(h, t, t), h
    else:
        kb = bias.reshape(-1, t, t)
    fold = lambda x: x.reshape(bh, t, d)
    qf, kf, vf, dof = (fold(x) for x in (q, k, v, do))
    got, lse = fa.flash_attention(qf, kf, vf, return_lse=True, causal=True,
                                  kv_valid=kv, dropout_rate=rate,
                                  dropout_seed=seed, bias=kb,
                                  bias_groups=groups)
    ref, ref_lse = fa.flash_attention_plain(qf, kf, vf, scale, True, kv,
                                            rate, seed, kb)
    tail = (scale, True, kv, rate, seed, kb)
    args = (qf, kf, vf, dof, ref_lse, fa.flash_attention_delta(dof, ref),
            *tail)
    dq, db = fa.flash_attention_bwd_dq(*args, want_d_bias=True)
    dk, dv = fa.flash_attention_bwd_dkv(*args)
    want = fa.flash_attention_bwd_plain(*args)
    # the main path's d_bias: its own forward's lse and delta, reduced
    own = (qf, kf, vf, dof, lse, fa.flash_attention_delta(dof, got), *tail)
    own_db = sum_to(fa.flash_attention_bwd_dq(*own, want_d_bias=True)[1]
                    .reshape(b, h, t, t), shape).to(bias_dtype)
    routes = {n: route_since(fa, n, before) for n in FLASH_KERNELS}
    err = lambda a, r: float((a.double() - r.double()).abs().max())
    kernel = {"out": got, "lse": lse, "dq": dq, "dk": dk, "dv": dv,
              "d_bias": db}
    plain = {"out": ref, "lse": ref_lse, "dq": want[0], "dk": want[1],
             "dv": want[2], "d_bias": want[3]}
    errors, witness = {}, {}
    for n in kernel:
        r = plain[n]
        tol = FLASH_ATOL if f32 or n == "lse" else \
            BF16_REL * float(r.abs().max())
        e = err(kernel[n], r)
        errors[n] = [e, tol, math.isfinite(e) and e <= tol]
    if f32:
        ex = attention64(torch, fa, qf, kf, vf, dof, kb, kv, rate, seed,
                         scale)
        fed = (qf, kf, vf, dof, ex["lse"].float(), ex["delta"].float(),
               *tail)
        kq, kdb = fa.flash_attention_bwd_dq(*fed, want_d_bias=True)
        kk, kvv = fa.flash_attention_bwd_dkv(*fed)
        pw = fa.flash_attention_bwd_plain(*fed)
        for n, kx, px in (("dq", kq, pw[0]), ("dk", kk, pw[1]),
                          ("dv", kvv, pw[2]), ("d_bias", kdb, pw[3])):
            ek = (kx.double() - ex[n]).abs()
            bound = ex["bounds"][n]
            within = bool((ek <= bound).all())
            witness[n] = dict(
                kernel_vs_f64=float(ek.max()),
                plain_vs_f64=float((px.double() - ex[n]).abs().max()),
                bound_max=float(bound.max()),
                worst_share_of_bound=float(torch.where(
                    bound > 0, ek / bound, ek * math.inf).nan_to_num(0.0)
                    .max()),
                within_bound=within)
            # the float32 gradients hold FLASH_ATOL of the twin themselves
            # since the wide instances sum S and dP a k-step apart (ROADMAP
            # B item 8c): the bound is recorded, and no longer passes a case
            errors[n][2] = errors[n][2] and within
    # the same d_bias summed in another order: relative to its size
    big = float(own_db.double().abs().max())
    tol_db = FLASH_ATOL * max(1.0, big) if bias_dtype == torch.float32 \
        else BF16_REL * big
    e = err(leaves[3].grad, own_db)
    errors["attention_d_bias"] = [e, tol_db, math.isfinite(e) and e <= tol_db]
    # the main path ran the same forward on the same inputs
    e = err(out.detach().reshape(bh, t, d), got)
    errors["attention_out"] = [e, 0.0, e == 0.0]
    ok = (all(x[2] for x in errors.values())
          and all(n > 0 for n in launches.values())
          and routes == flash_routes(f32, d))
    return dict(ok=ok, dtype=str(dtype).split(".")[-1], d=d,
                bias_dtype=str(bias_dtype).split(".")[-1], layout=layout,
                bias_shape=list(shape),
                shape=f"B={b} H={h} T={t} D={d} causal valid {rows} "
                      f"dropout {rate}",
                launches=launches, routes=routes,
                max_abs_err={n: x[0] for n, x in errors.items()},
                atol={n: x[1] for n, x in errors.items()},
                passed={n: x[2] for n, x in errors.items()},
                witness=witness)


def wide_bias_grid(torch, fa, gen, ctx):
    """Every wide bias instance against its plain version: q in float32
    and bf16, D = 192 and 256 and the runtime-D instances' 320 and 512, a
    float32, bf16 and float16 bias in each of the four layouts, all with
    d_bias (:func:`wide_bias_case`)."""
    recs = []
    for dtype in (torch.float32, torch.bfloat16):
        for d in (192, 256) + HUGE_GRID_D:
            for bias_dtype in (torch.float32, torch.bfloat16,
                               torch.float16):
                for layout in WIDE_GRID_LAYOUTS:
                    rec = wide_bias_case(torch, fa, gen, dtype, d,
                                         bias_dtype, layout)
                    emit("wide_bias", card=ctx["smi"], **rec)
                    recs.append(rec)
                    if not rec["ok"]:
                        ctx["failures"].append(
                            f"wide bias {rec['dtype']} D={d} "
                            f"{rec['bias_dtype']} {layout}: "
                            f"{rec['max_abs_err']} {rec['witness']}")
    ctx["wide_bias"] = recs


def flash_mask_bits(torch, fa, ctx):
    """The forward kernel's dropout mask, read out through its output at
    BERT's shape and, through the runtime-D forward, at D = 512 (bf16,
    BH = 16, T = 512), against ``dropout_keep_mask`` bit for bit, and its
    keep rate: with q = 0 every probability is 1/T, and V one-hot over a
    chunk of D keys puts each kept key in its own output column."""
    rate = 0.1
    dev = "cuda"
    seed = torch.tensor([20261016], dtype=torch.int32, device=dev)
    ar = lambda lo, hi, shape: torch.arange(lo, hi, device=dev).reshape(shape)
    for bh, t, d in ((TRAIN_BATCH * 12, TRAIN_SEQ, 64), (16, 512, 512)):
        q = torch.zeros((bh, t, d), dtype=torch.bfloat16, device=dev)
        mismatched = kept = 0
        for c in range(t // d):
            v = torch.zeros((bh, t, d), dtype=torch.bfloat16, device=dev)
            v[:, c * d:(c + 1) * d] = torch.eye(d, device=dev)
            got = fa.flash_attention(q, q, v, dropout_rate=rate,
                                     dropout_seed=seed) > 0
            want = fa.dropout_keep_mask(seed, ar(0, bh, (bh, 1, 1)),
                                        ar(0, t, (1, t, 1)),
                                        ar(c * d, (c + 1) * d, (1, 1, d)),
                                        rate)
            mismatched += int((got != want).sum())
            kept += int(want.sum())
        draws = bh * t * t
        keep_rate = kept / draws
        ok = mismatched == 0 and abs(keep_rate - (1 - rate)) <= 0.005
        emit("dropout_mask", ok=ok, shape=f"BH={bh} T={t} D={d} bf16",
             rate=rate, draws=draws, mismatched_bits=mismatched,
             keep_rate=keep_rate, keep_rate_tolerance=0.005)
        if not ok:
            ctx["failures"].append(f"dropout mask D={d}: {mismatched} bits "
                                   f"differ, keep rate {keep_rate}")


def serve_prompts():
    """The serve traffic's 8 prompts (77-700 tokens), from a seed."""
    rng = np.random.RandomState(1)
    return [rng.randint(0, SERVE["vocab_size"], size=n).tolist()
            for n in PROMPT_LENS]


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
    prompts = serve_prompts()
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
    ctx["serve_model"] = model

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


def serve_run(torch, srv, prompts, new_tokens, track=None, each=None,
              tenants=None, ids="f"):
    """Drive ``srv`` over ``prompts`` from counts at 0: the streams, the
    wall seconds, the kernels' launch counts and routes, the prefill and
    decode events, and the peak of blocks held (read each step).
    ``each(i, reqs)`` runs after step ``i``; ``tenants`` names each
    request's tenant."""
    from tpu_mx_torch import telemetry, tracing
    from tpu_mx_torch.kernels import flash_attention as fa
    from tpu_mx_torch.kernels import paged_attention as pa
    reset_serving_counts()
    reqs = [srv.submit(p, max_new_tokens=new_tokens, request_id=f"{ids}{i}",
                       tenant=None if tenants is None else tenants[i])
            for i, p in enumerate(prompts)]
    if track is not None:
        track(reqs)
    peak, steps = 0, 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while not srv.scheduler.idle():
        srv.step()
        steps += 1
        peak = max(peak, srv.engine.cache.allocator.used)
        if each is not None:
            each(steps, reqs)
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
        streams=[r.tokens for r in reqs], reqs=reqs, steps=steps,
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


def reset_serving_counts():
    """Launch counts, the serving kernels' routes and windows, events and
    telemetry, all to zero: what a run then counts is its own."""
    from tpu_mx_torch import telemetry, tracing
    from tpu_mx_torch.kernels import flash_attention as fa
    from tpu_mx_torch.kernels import paged_attention as pa
    reset_port_kernel_launches()
    fa.flash_attention.routes = fa.route_counts()
    pa.paged_attention.routes = dict.fromkeys(pa.ROUTES, 0)
    pa.paged_attention.windows = {}
    tracing.reset()
    telemetry.reset()


def serving_counts():
    """The launch counts and the serving kernels' routes since the last
    :func:`reset_serving_counts`."""
    from tpu_mx_torch.kernels import flash_attention as fa
    from tpu_mx_torch.kernels import paged_attention as pa
    return dict(launches=port_kernel_launches(),
                flash_routes=dict(fa.flash_attention.routes),
                paged_routes=dict(pa.paged_attention.routes))


def _record(run):
    """A run's numbers for the phase's line (its streams left out)."""
    return {k: v for k, v in run.items() if k not in ("streams", "reqs")}


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

    model = ctx.get("serve_model") or TinyLM(**SERVE, device="cuda")
    ctx["serve_model"] = model
    prompts = serve_prompts()
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


RECOVERY_KW = dict(max_batch=8, block_size=16, num_blocks=1024)
RECOVERY_DEADLINE = 2.0     # s; a decode step at this width takes ~2-5 ms
RECOVERY_STALL = 3.0        # s the wedged decode step sleeps
RECOVERY_FAULT_STEP = 6     # the engine step at which a fault is armed
RECOVERY_STORM = 3          # back-to-back restarts, within max_restarts=3
RECOVERY_KILL_STEP = 4      # the child dies inside this decode step
RECOVERY_EXHAUST_BLOCKS = 64
RECOVERY_TENANTS = ("a", "b")
RECOVERY_MEM_SLACK = 64 << 20   # bytes beside one pool after the zombie

KILL9_CHILD = r'''
import os, sys
import chip_smoke as cs
from tpu_mx_torch.serving import Server, TinyLM
srv = Server(TinyLM(**cs.SERVE, device="cuda"), journal=sys.argv[1],
             **cs.RECOVERY_KW)
for i, p in enumerate(cs.serve_prompts()):
    srv.submit(p, max_new_tokens=cs.NEW_TOKENS, request_id=f"f{i}")
srv.run_until_idle()        # dies inside a decode step: os._exit(137)
print("SHOULD NOT REACH HERE", flush=True)
'''


def arm_at(step, stack, **faults):
    """A ``serve_run`` callback that arms chaos ``faults`` after engine
    step ``step`` (disarmed when ``stack`` closes)."""
    from tpu_mx_torch.contrib import chaos

    def each(i, reqs):
        if i == step:
            stack.enter_context(chaos.enable(**faults))
    return each


def card_routes(run):
    """Every flash launch of the run on ``tf32x3``, every paged launch on
    ``split_k``, and both kernels launched."""
    flash = run["launches"]["flash_attention_fwd"]
    paged = run["launches"]["paged_attention"]
    return (flash > 0 and paged > 0
            and run["flash_routes"].get("tf32x3") == flash
            and sum(run["flash_routes"].values()) == flash
            and run["paged_routes"] == {"split_k": paged})


def zombies():
    import threading
    return [t for t in threading.enumerate()
            if t.name.startswith("watchdog-")]


def report_tools(runs):
    """The port's report tools (``tpu_mx_torch/tools``) run as scripts
    with ``--validate``, a user's post-mortem of what a phase wrote:
    ``runs`` is ``(name, tool, arguments)``; returns each run's exit code
    and its last line (with its standard error when it failed)."""
    here = os.path.dirname(os.path.abspath(__file__))
    out = {}
    for name, tool, args in runs:
        r = subprocess.run(
            [sys.executable, os.path.join(here, "tpu_mx_torch", "tools",
                                          f"{tool}.py"), *args,
             "--validate"], capture_output=True, text=True, timeout=120)
        out[name] = dict(rc=r.returncode, said=(
            r.stdout.strip().splitlines() or [""])[-1][:300],
            **({"stderr": r.stderr[-1500:]} if r.returncode else {}))
    return out


def phase_serve_recovery(ctx):
    """Serving's robustness and recovery planes at TinyLM width 4096, each
    arm held to a reference run with every plane off: the journal's cost,
    kill -9 in a child then ``recover()`` here, the watchdog and restart
    ladder, replay against the legacy arm, drain and handoff, the SLO
    monitor, the capacity ledger and static batching."""
    import contextlib
    import os
    import shutil
    import tempfile
    import torch
    from tpu_mx_torch import telemetry, tracing
    from tpu_mx_torch.kernels import _build
    from tpu_mx_torch.serving import (AdmissionReject, Server,
                                      StaticBatchingScheduler, TinyLM,
                                      validate_forensic_doc)
    from tpu_mx_torch.serving.journal import load as journal_load
    from tpu_mx_torch.serving.journal import journal_path

    t_phase = time.perf_counter()
    model = ctx.pop("serve_model", None) or TinyLM(**SERVE, device="cuda")
    prompts = serve_prompts()
    layers = SERVE["num_layers"]
    _build.BUILD_DIR.parent.mkdir(parents=True, exist_ok=True)
    work = tempfile.mkdtemp(prefix="serve_recovery-",
                            dir=str(_build.BUILD_DIR.parent))
    checks, launches = {}, dict.fromkeys(port_kernel_launches(), 0)
    out = {}

    def count(run):
        for k, n in run["launches"].items():
            launches[k] += n

    def run_arm(name, srv, **kw):
        run = serve_run(torch, srv, prompts, NEW_TOKENS, **kw)
        count(run)
        run.update(restarts=srv.restarts, generation=srv.generation)
        checks[f"{name}_routes"] = card_routes(run)
        return run

    def near_ref(name, got, want=None):
        splits = stream_splits(model, prompts, got, want or ref["streams"])
        checks[f"{name}_streams"] = splits_ok(splits)
        return splits

    try:
        # the reference run: every plane off
        ref = run_arm("reference", Server(model, **RECOVERY_KW))
        checks["reference_done"] = ref["done"]

        # (a) the journal's cost: off and on in turns, twice
        journal = {False: [], True: []}
        for on in (False, True, False, True):
            prefix = os.path.join(work, f"j{len(journal[on])}") if on \
                else None
            srv = Server(model, journal=prefix, **RECOVERY_KW)
            fsyncs = [0]
            if on:
                inner = srv.journal._fsync

                def fsync(inner=inner):
                    fsyncs[0] += 1
                    inner()
                srv.journal._fsync = fsync
            run = run_arm(f"journal_{int(on)}", srv)
            if on:
                srv.journal.close()
                bytes_ = os.path.getsize(journal_path(prefix))
                entries = journal_load(journal_path(prefix))
                # one fsync a step; besides, one an admission, one at close
                step_fsyncs = fsyncs[0] - len(prompts) - 1
                run.update(fsyncs=fsyncs[0], step_fsyncs=step_fsyncs,
                           fsyncs_per_step=step_fsyncs / run["steps"],
                           journal_bytes=bytes_,
                           journal_bytes_per_token=bytes_ / (
                               len(prompts) * NEW_TOKENS),
                           journal_ended=all(e["ended"] and e["tokens"]
                                             == s for e, s in zip(
                                                 entries.values(),
                                                 run["streams"])))
            journal[on].append(run)
            del srv
        checks["journal_streams"] = all(
            splits_ok(stream_splits(model, prompts, r["streams"],
                                    ref["streams"]))
            for r in journal[False] + journal[True])
        checks["journal_one_fsync_a_step"] = all(
            r["step_fsyncs"] == r["steps"] for r in journal[True])
        checks["journal_complete"] = all(r["journal_ended"]
                                         for r in journal[True])
        out["journal"] = {"off": [_record(r) for r in journal[False]],
                          "on": [_record(r) for r in journal[True]]}

        # (b) kill -9 in a child process, recover() here
        prefix = os.path.join(work, "k9")
        libs = sorted(p.name for p in _build.BUILD_DIR.glob("*.so"))
        env = dict(os.environ,
                   TPUMX_CHAOS=f"kill9_at_decode_step={RECOVERY_KILL_STEP}")
        t0 = time.perf_counter()
        child = subprocess.run([sys.executable, "-c", KILL9_CHILD, prefix],
                               capture_output=True, text=True, env=env,
                               cwd=os.path.dirname(os.path.abspath(
                                   __file__)), timeout=300)
        child_s = time.perf_counter() - t0
        checks["kill9_exit_137"] = child.returncode == 137
        checks["kill9_no_rebuild"] = libs == sorted(
            p.name for p in _build.BUILD_DIR.glob("*.so"))
        entries = journal_load(journal_path(prefix))
        committed = {rid: list(e["tokens"]) for rid, e in entries.items()}
        unfinished = [rid for rid, e in entries.items() if not e["ended"]]
        srv = Server(model, journal=prefix, **RECOVERY_KW)
        reset_serving_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        handles = srv.recover()
        pending = {rid for rid, h in handles.items()
                   if len(h.tokens) < NEW_TOKENS}
        yielded = {rid: [] for rid in handles}
        resumed_ms = None
        while not srv.scheduler.idle():
            before = {rid: len(h.tokens) for rid, h in handles.items()}
            srv.step()
            for rid, h in handles.items():
                yielded[rid] += h.tokens[before[rid]:]
            if resumed_ms is None and all(yielded[r] for r in pending):
                torch.cuda.synchronize()
                resumed_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        recover_wall = time.perf_counter() - t0
        rec = serving_counts()
        rec_launches = rec["launches"]
        count(rec)
        prefills = [e["data"] for e in tracing.snapshot()
                    if e["event"] == "serve.prefill"]
        decodes = [e for e in tracing.snapshot()
                   if e["event"] == "serve.decode"]
        got = [list(handles[f"f{i}"].tokens) for i in range(len(prompts))]
        checks.update(
            kill9_journal_clean=len(entries) == len(prompts) and not any(
                e["fallback"] for e in entries.values()),
            kill9_work_committed=any(committed.values()),
            recover_all_unfinished=set(handles) == set(unfinished)
            and all(h.state == "done" for h in handles.values()),
            recover_zero_lost_dup=all(
                committed[rid] + yielded[rid] == list(h.tokens)
                and len(h.tokens) == NEW_TOKENS
                for rid, h in handles.items()),
            recover_one_prefill_each=len(prefills) == len(pending)
            and sorted(p["replayed"] for p in prefills) == sorted(
                len(committed[rid]) for rid in pending)
            and rec_launches["flash_attention_fwd"] == layers * len(pending),
            recover_no_redecode=(
                telemetry.get("serve.redecode_tokens") is None
                and rec_launches["paged_attention"]
                == layers * len(decodes)),
            recover_routes=card_routes(rec))
        recovered = {rid: list(h.tokens) for rid, h in handles.items()}
        splits = near_ref("recover", [recovered.get(f"f{i}", committed.get(
            f"f{i}")) for i in range(len(prompts))])
        out["kill9"] = dict(
            child_exit=child.returncode, child_seconds=child_s,
            child_stderr_tail=child.stderr[-600:],
            committed_tokens={rid: len(t) for rid, t in committed.items()},
            unfinished=len(unfinished), replay_prefills=len(prefills),
            replay_tokens=sum(p["replayed"] for p in prefills),
            launches=rec_launches, recover_to_last_resumed_ms=resumed_ms,
            recover_wall_seconds=recover_wall, splits=splits)
        srv.journal.close()
        del srv, handles

        # (c) the watchdog: one wedged decode step
        box = os.path.join(work, "wd")
        gc.collect()
        m0 = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        srv = Server(model, deadline=RECOVERY_DEADLINE, backoff=0.0,
                     blackbox=box, **RECOVERY_KW)
        pool_bytes = 2 * srv.engine.cache.k_pool.nbytes
        off = time.time() - time.perf_counter()
        with contextlib.ExitStack() as stack:
            wd = run_arm("watchdog", srv, each=arm_at(
                RECOVERY_FAULT_STEP, stack,
                slow_decode_step=1, slow_decode_seconds=RECOVERY_STALL))
        fires = [e for e in tracing.snapshot()
                 if e["event"] == "supervisor.watchdog_fire"]
        restarts = [e for e in tracing.snapshot()
                    if e["event"] == "serve.restart"]
        fire_t = fires[0]["ts"] - off if fires else None
        after = [t for r in wd["reqs"] for t in r.token_times
                 if fire_t is not None and t > fire_t]
        for t in zombies():
            t.join(timeout=2 * RECOVERY_STALL)
        zombie_left = len(zombies())
        gc.collect()
        torch.cuda.synchronize()
        mem_after = torch.cuda.memory_allocated() - m0
        doc = json.loads(open(tracing.blackbox_path(box)).read())
        try:
            tracing.validate_blackbox(doc)
            box_ok = True
        except ValueError:
            box_ok = False
        checks.update(
            watchdog_done=wd["done"],
            watchdog_fired_once=len(fires) == 1
            and telemetry.get("supervisor.watchdog_fires").value == 1,
            watchdog_one_restart=wd["restarts"] == 1
            and wd["generation"] == 1 and len(restarts) == 1
            and "WatchdogTimeout" in restarts[0]["data"]["reason"],
            watchdog_blackbox_valid=box_ok,
            watchdog_zombie_joined=zombie_left == 0,
            watchdog_one_pool_after=mem_after <= pool_bytes
            + RECOVERY_MEM_SLACK)
        near_ref("watchdog", wd["streams"])
        out["watchdog"] = dict(
            _record(wd), deadline_s=RECOVERY_DEADLINE,
            stall_s=RECOVERY_STALL,
            restart_ms=(min(after) - fire_t) * 1e3 if after else None,
            pool_bytes=pool_bytes, peak_bytes_over_model=(
                torch.cuda.max_memory_allocated() - m0),
            bytes_after_zombie=mem_after,
            blackbox_events=len(doc["events"]),
            blackbox_environment={k: doc["environment"].get(k) for k in (
                "torch", "cuda", "device", "nvcc")})
        del srv, wd

        # (d) a restart storm within the budget, then the degrade path
        with contextlib.ExitStack() as stack:
            srv = Server(model, max_restarts=RECOVERY_STORM, backoff=0.0,
                         **RECOVERY_KW)
            storm = run_arm("storm", srv, each=arm_at(
                RECOVERY_FAULT_STEP, stack, restart_storm=RECOVERY_STORM))
        checks["storm_restarts"] = storm["done"] and storm["restarts"] == \
            storm["generation"] == RECOVERY_STORM and not srv.degraded
        near_ref("storm", storm["streams"])
        del srv
        extra = prompts + prompts[:4]
        with contextlib.ExitStack() as stack:
            srv = Server(model, max_restarts=0, backoff=0.0, **RECOVERY_KW)
            reset_serving_counts()
            reqs = [srv.submit(p, max_new_tokens=NEW_TOKENS,
                               request_id=f"d{i}")
                    for i, p in enumerate(extra)]
            each = arm_at(RECOVERY_FAULT_STEP, stack, restart_storm=1)
            step = 0
            while not srv.scheduler.idle():
                srv.step()
                step += 1
                each(step, reqs)
            degrade_counts = serving_counts()
            count(degrade_counts)
        checks["degrade_routes"] = card_routes(degrade_counts)
        failed = [r for r in reqs if r.state == "failed"]
        drained = [r for r in reqs if r.state == "done"]
        checks.update(
            degrade_queued_failed=len(failed) == len(extra) - 8 and all(
                r.finish_reason.startswith("degraded") for r in failed),
            degrade_running_drained=len(drained) == 8 and all(
                len(r.tokens) == NEW_TOKENS for r in drained),
            degrade_closed=srv.degraded and srv.generation == 1)
        near_ref("degrade", [r.tokens for r in reqs[:8]])
        out["storm"] = dict(_record(storm), degrade=dict(
            failed=len(failed), drained=len(drained),
            generation=srv.generation))
        del srv, reqs

        # (e) one restart: replay prefill against the legacy arm
        replay = {}
        for arm in (True, False):
            with contextlib.ExitStack() as stack:
                srv = Server(model, replay=arm, backoff=0.0, **RECOVERY_KW)
                run = run_arm(f"replay_{int(arm)}", srv, each=arm_at(
                    RECOVERY_FAULT_STEP, stack, restart_storm=1))
            red = telemetry.get("serve.redecode_tokens")
            rep = telemetry.get("serve.replay_tokens")
            run.update(redecode_tokens=red.value if red else 0,
                       replay_tokens=rep.value if rep else 0)
            replay[arm] = run
            near_ref(f"replay_{int(arm)}", run["streams"])
            del srv
        checks["replay_no_redecode"] = (
            replay[True]["redecode_tokens"] == 0
            and replay[True]["replay_tokens"] > 0
            and replay[False]["redecode_tokens"] > 0)
        out["replay"] = {"replay": _record(replay[True]),
                         "legacy": _record(replay[False])}

        # (f) drain and handoff mid-run
        srv = Server(model, **RECOVERY_KW)
        moved = []
        hand = run_arm("handoff", srv, each=lambda i, reqs: moved.append(
            srv.handoff()) if i == RECOVERY_FAULT_STEP else None)
        checks["handoff"] = hand["done"] and hand["generation"] == 1 \
            and hand["restarts"] == 0 and moved == [len(prompts)]
        near_ref("handoff", hand["streams"])
        srv = Server(model, **RECOVERY_KW)
        drained_at = []
        drain = run_arm("drain", srv, each=lambda i, reqs: drained_at.append(
            srv.drain()) if i == RECOVERY_FAULT_STEP else None)
        try:
            srv.submit(prompts[0], max_new_tokens=2)
            reason = None
        except AdmissionReject as e:
            reason = e.reason
        srv.resume_admission()
        checks["drain"] = drain["done"] and reason == "draining" \
            and not [r for r in drain["reqs"] if r.state == "failed"]
        near_ref("drain", drain["streams"])
        out["handoff"] = _record(hand)
        out["drain"] = dict(_record(drain), drain_steps=drained_at)
        del srv

        # (g) the live SLO monitor
        srv = Server(model, slo=True, **RECOVERY_KW)
        slo_run = run_arm("slo", srv)
        sig = srv.slo_signal
        q = {f"{m}_{p}": telemetry.get(f"serve.{m}_seconds")
             .window_quantile(float(f"0.{p}"))
             for m in ("ttft", "itl") for p in ("5", "99")}
        checks["slo_signal_finite"] = sig is not None and math.isfinite(
            sig["max_burn_rate"]) and all(
                v is not None and math.isfinite(v) for v in q.values())
        near_ref("slo", slo_run["streams"])
        out["slo"] = dict(_record(slo_run), signal={
            k: sig[k] for k in ("breaching", "max_burn_rate")},
            window_quantiles_s=q, slos={
                n: {k: st[k] for k in ("estimate_seconds", "breaching")}
                for n, st in sig["slos"].items()})
        del srv

        # (h) the capacity ledger, audited at every step; exhaustion
        srv = Server(model, tenants={t: {"weight": 1.0}
                                     for t in RECOVERY_TENANTS},
                     **RECOVERY_KW)
        audits = []

        def audit(i, reqs):
            # audit() checks the identity exactly (fractions) or raises;
            # here its float rendering, against the allocator's count
            rep = srv.engine.cache.audit()
            used = srv.engine.cache.allocator.used * rep["block_bytes"]
            audits.append(rep["used_bytes"] == used and abs(sum(
                d["bytes_amortized"] for d in rep["tenants"].values())
                - used) <= 1e-9 * max(used, 1))
        led = run_arm("ledger", srv, each=audit, tenants=[
            RECOVERY_TENANTS[i % 2] for i in range(len(prompts))])
        checks["ledger_audit_every_step"] = len(audits) == led["steps"] \
            and all(audits)
        near_ref("ledger", led["streams"])
        del srv
        box = os.path.join(work, "cap")
        srv = Server(model, blackbox=box, **dict(
            RECOVERY_KW, num_blocks=RECOVERY_EXHAUST_BLOCKS))
        exh = run_arm("exhaustion", srv)
        recs = srv.engine.cache.forensic_records()
        path = srv.engine.cache.flush_forensics()
        try:
            validate_forensic_doc(json.loads(open(path).read()))
            forensic_ok = True
        except (ValueError, TypeError, OSError):
            forensic_ok = False
        checks.update(
            exhaustion_done=exh["done"],
            exhaustion_forensic=any(r["kind"] == "exhaustion"
                                    for r in recs) and forensic_ok)
        # the four report tools on what the arms wrote: the watchdog's
        # black box, the exhaustion's forensics, the telemetry
        metrics = os.path.join(work, "serve.jsonl")
        telemetry.flush(metrics)
        wd_box = tracing.blackbox_path(os.path.join(work, "wd"))
        out["report_tools"] = report_tools((
            ("blackbox", "blackbox_report", [wd_box]),
            ("slo", "slo_report", [metrics, "--box", wd_box]),
            ("capacity", "capacity_report", [metrics, "--forensics", path]),
            ("telemetry", "telemetry_report", [metrics])))
        checks["report_tools_validate"] = all(
            r["rc"] == 0 for r in out["report_tools"].values())
        near_ref("exhaustion", exh["streams"])
        out["ledger"] = dict(_record(led), audits=len(audits),
                             exhaustion=dict(_record(exh),
                                             forensic_records=len(recs)))
        del srv

        # (i) static batching against continuous batching
        srv = Server(model, scheduler=StaticBatchingScheduler(
            max_batch=RECOVERY_KW["max_batch"]), **RECOVERY_KW)
        static = run_arm("static", srv)
        checks["static_done"] = static["done"]
        near_ref("static", static["streams"])
        out["static"] = dict(_record(static), continuous_tokens_per_sec=ref[
            "tokens_per_sec"], continuous_steps=ref["steps"])
        del srv
    finally:
        shutil.rmtree(work, ignore_errors=True)

    ctx["serve_recovery_launches"] = launches
    emit("serve_recovery", ok=all(checks.values()), checks=checks,
         model={**SERVE, **RECOVERY_KW}, prompts=list(PROMPT_LENS),
         new_tokens=NEW_TOKENS, reference=_record(ref), **out,
         launches=launches, seconds=time.perf_counter() - t_phase,
         card=ctx["smi"])
    for name, ok in checks.items():
        if not ok:
            ctx["failures"].append(f"serve_recovery check {name} failed")


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


# -- the vision zoo ---------------------------------------------------------------
def zoo_net(torch, name, device, classes=ZOO_CLASSES):
    """``vision.get_model(name)`` built channels-last on ``device`` (its
    tensors are deferred until the first forward or ``load_numpy``)."""
    from tpu_mx_torch import layout
    from tpu_mx_torch.context import cpu, gpu
    from tpu_mx_torch.gluon.model_zoo import vision
    with layout.default_layout("NHWC"), (cpu() if device == "cpu"
                                         else gpu(0)):
        return vision.get_model(name, classes=classes)


def zoo_no_dropout(net):
    from tpu_mx_torch.gluon import nn
    for m in net.modules():
        if isinstance(m, nn.Dropout):
            m._rate = 0.0


def zoo_copy(torch, name, device, params, dtype=None):
    """A fresh ``name`` on ``device`` holding ``params`` (reference
    order and shapes), dropout off, in ``dtype`` if given."""
    from tpu_mx_torch.context import cpu, gpu
    from tpu_mx_torch.gluon.block import load_numpy
    net = zoo_net(torch, name, device)
    with cpu() if device == "cpu" else gpu(0):
        load_numpy(net, params)
    zoo_no_dropout(net)
    return net.to(dtype) if dtype is not None else net


def zoo_step(torch, net, x, label, device):
    from tpu_mx_torch import optimizer
    from tpu_mx_torch.gluon import loss
    from tpu_mx_torch.parallel import CompiledTrainStep
    step = CompiledTrainStep(net, loss.SoftmaxCrossEntropyLoss(),
                             optimizer.create("sgd", **ZOO_SGD),
                             device=device)
    dt = next(net.parameters()).dtype
    return float(step.step(torch.from_numpy(x).to(device, dt),
                           torch.from_numpy(label).to(device, dt)))


def zoo_parity_net(torch, name):
    """One network, float32, batch 2 at its parity input, channels-last,
    with Xavier weights drawn for its channels-first twin (the
    reference's Xavier reads a channels-last weight's fan as ``kw·I``,
    which leaves several nets' logits near 1e-20 and their gradients
    all rounding): the card's eval logits and one SGD-momentum step
    against the CPU's from the same weights, and both steps against the
    CPU's float64 step.  A convolution's or dense layer's tensor whose
    CPU float32 update is within ZOO_COND_RTOL of float64 must move
    alike on the card within UPDATE_RTOL in norm.  Over the rest, the
    BatchNorm tensors (a shift's gradient sums what the next BatchNorm
    made cancel; statistics of a few samples) and the tensors float32
    cannot pin, the card's summed error against float64 is at most
    ZOO_COND_FACTOR times the CPU's, or UPDATE_RTOL of their summed
    update."""
    from tpu_mx_torch import layout
    from tpu_mx_torch.context import cpu
    from tpu_mx_torch.gluon.model_zoo import vision
    size = ZOO_PARITY_SIZE[name]
    rng = np.random.RandomState(3)
    x = rng.rand(ZOO_PARITY_BATCH, size, size, 3).astype(np.float32)
    label = rng.randint(0, ZOO_CLASSES, ZOO_PARITY_BATCH).astype(np.float32)
    with cpu(), layout.default_layout("NCHW"):
        src = vision.get_model(name, classes=ZOO_CLASSES)
    src.initialize("xavier", generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        src.eval()(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    params = {p.name: (lambda a: a.transpose(0, 2, 3, 1) if a.ndim == 4
                       else a)(p._ref_view().detach().numpy()).copy()
              for p in src.collect_params().values()}
    nets = {"cpu": zoo_copy(torch, name, "cpu", params),
            "cuda": zoo_copy(torch, name, "cuda", params),
            "f64": zoo_copy(torch, name, "cpu", params, torch.float64)}
    with torch.no_grad():
        want = nets["cpu"].eval()(torch.from_numpy(x))
        got = nets["cuda"].eval()(torch.from_numpy(x).cuda()).cpu()
    logits_err = float((got - want).abs().max())
    logits_tol = ZOO_LOGITS_REL * float(want.abs().max())
    before = {n: p._ref_view().detach().double().clone()
              for n, p in nets["f64"].collect_params().items()}
    losses = {key: zoo_step(torch, nets[key], x, label,
                            "cuda" if key == "cuda" else "cpu")
              for key in ("cuda", "cpu", "f64")}
    loss_rel = abs(losses["cuda"] - losses["cpu"]) / abs(losses["cpu"])
    moved = {key: {n: p._ref_view().detach().cpu().double() - before[n]
                   for n, p in nets[key].collect_params().items()}
             for key in nets}
    worst, worst_name, unmoved, bad = 0.0, None, 0, []
    err_gpu, err_cpu, cond_size, cond = 0.0, 0.0, 0.0, []
    for n, d_64 in moved["f64"].items():
        d_cpu, d_gpu = moved["cpu"][n], moved["cuda"][n]
        size_ = float(d_64.norm())
        if n.endswith(ZOO_BN_LEAVES) or (
                size_ > ZOO_UPDATE_ATOL and
                float((d_cpu - d_64).norm()) > ZOO_COND_RTOL * size_):
            cond.append(n)
            err_gpu += float((d_gpu - d_64).norm()) ** 2
            err_cpu += float((d_cpu - d_64).norm()) ** 2
            cond_size += size_ ** 2
        elif size_ <= ZOO_UPDATE_ATOL:
            unmoved += 1
            if float((d_gpu - d_cpu).norm()) > ZOO_UPDATE_ATOL:
                bad.append(n)
        else:
            rel = float((d_gpu - d_cpu).norm()) / size_
            if rel > worst:
                worst, worst_name = rel, n
            if rel > UPDATE_RTOL:
                bad.append(n)
    err_gpu, err_cpu = math.sqrt(err_gpu), math.sqrt(err_cpu)
    cond_size = math.sqrt(cond_size)
    rec = dict(size=size, batch=ZOO_PARITY_BATCH,
               logits_max_abs_err=logits_err, logits_atol=logits_tol,
               logits_max_abs=float(want.abs().max()), losses=losses,
               loss_rel_err=loss_rel, worst_update_rel_err=worst,
               worst_update_tensor=worst_name, tensors=len(before),
               unmoved_tensors=unmoved, ill_conditioned_tensors=len(cond),
               ill_conditioned_err_card_vs_f64=err_gpu,
               ill_conditioned_err_cpu_vs_f64=err_cpu,
               ill_conditioned_update_norm=cond_size,
               failed_tensors=bad[:8])
    checks = {"logits": logits_err <= logits_tol,
              "loss": loss_rel <= LOSS_RTOL,
              "updates": not bad,
              "ill_conditioned": err_gpu <= max(ZOO_COND_FACTOR * err_cpu,
                                                UPDATE_RTOL * cond_size),
              "finite": math.isfinite(losses["cuda"])}
    return rec, checks


ZOO_OPTIMIZERS = (
    ("sgd", dict(momentum=0.9, wd=1e-4)), ("adam", dict(wd=1e-4)),
    ("lamb", dict(wd=1e-2)), ("lbsgd", dict(momentum=0.9, wd=1e-4)),
    ("nag", dict(momentum=0.9, wd=1e-4)), ("adamw", dict(wd=1e-2)),
    ("rmsprop", dict(centered=False)), ("rmsprop", dict(centered=True)),
    ("adagrad", {}), ("adadelta", {}), ("ftrl", {}), ("signum", {}),
    ("dcasgd", dict(momentum=0.9)), ("sgld", {}), ("adamax", {}),
    ("nadam", {}), ("ftml", {}))


def zoo_optimizer_case(torch, name, kw):
    """Three ``update_core`` steps of ``name`` on the card against the
    CPU from one weight and three gradients: the largest difference of
    the weight and of any state tensor, relative to the CPU's max.
    SGLD's noise comes from each device's own generator: the noise each
    drew (re-drawn from a twin) is taken away first."""
    from tpu_mx_torch import optimizer
    rng = np.random.RandomState(5)
    w0 = rng.randn(257, 129).astype(np.float32)
    grads = [rng.randn(257, 129).astype(np.float32) for _ in range(3)]
    out = {}
    for dev in ("cuda", "cpu"):
        extra = {}
        if name == "sgld":
            extra["generator"] = torch.Generator(dev).manual_seed(7)
            twin = torch.Generator(dev).manual_seed(7)
        opt = optimizer.create(name, learning_rate=0.01, **kw, **extra)
        w = torch.from_numpy(w0).to(dev)
        state = opt.create_state(0, w)
        noise = 0.0
        for t, g in enumerate(grads, 1):
            w, state = opt.update_core(w, torch.from_numpy(g).to(dev), state,
                                       0.01, opt.wd, t)
            if name == "sgld":
                noise = noise + math.sqrt(0.01) * torch.randn(
                    w.shape, generator=twin, device=dev)
        flat = [w - noise] + [s for s in (state if isinstance(
            state, tuple) else (state,)) if s is not None]
        out[dev] = [s.detach().double().cpu() for s in flat]
    return max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
               for a, b in zip(out["cuda"], out["cpu"]))


def zoo_scheduler_case(torch, name, kw):
    """``CompiledTrainStep`` on the card with ``lr_scheduler``: the rate
    each update ran with (read where ``update_core`` takes it) against
    the scheduler's own ``sched(t)``, t = 1..ZOO_SCHED_STEPS."""
    from tpu_mx_torch import optimizer
    from tpu_mx_torch.context import gpu
    from tpu_mx_torch.gluon import loss, nn
    from tpu_mx_torch.optimizer import lr_scheduler
    from tpu_mx_torch.parallel import CompiledTrainStep
    with gpu(0):
        net = nn.Dense(8, in_units=16)
    opt = optimizer.create("sgd", learning_rate=0.2, momentum=0.9,
                           lr_scheduler=getattr(lr_scheduler, name)(**kw))
    used = []
    core = opt.update_core

    def recorded(weight, grad, state, lr, wd, t):
        if not used or used[-1][0] != t:
            used.append((t, lr))
        return core(weight, grad, state, lr, wd, t)
    opt.update_core = recorded
    step = CompiledTrainStep(net, loss.L2Loss(), opt)
    x = torch.rand((4, 16), device="cuda")
    y = torch.rand((4, 8), device="cuda")
    for _ in range(ZOO_SCHED_STEPS):
        step.step(x, y)
    probe = getattr(lr_scheduler, name)(**kw)
    probe.base_lr = 0.2
    want = [(t, probe(t)) for t in range(1, ZOO_SCHED_STEPS + 1)]
    return used, want


def phase_zoo_parity(ctx):
    """The seven vision networks in float32 on the card against the CPU;
    the optimizers' update cores and the schedulers on the card."""
    import torch

    t0 = time.perf_counter()
    prior = torch.backends.mkldnn.enabled
    torch.backends.mkldnn.enabled = False   # see phase_resnet_parity
    try:
        nets, checks = {}, {}
        for name in ZOO_NETS:
            rec, ok = zoo_parity_net(torch, name)
            nets[name] = rec
            checks.update({f"{name}_{k}": v for k, v in ok.items()})
            torch.cuda.empty_cache()
    finally:
        torch.backends.mkldnn.enabled = prior
    opts = {}
    for name, kw in ZOO_OPTIMIZERS:
        key = name + ("_centered" if kw.get("centered") else "")
        opts[key] = zoo_optimizer_case(torch, name, kw)
        checks[f"optimizer_{key}"] = opts[key] <= ZOO_OPT_RTOL
    scheds = {}
    for name, kw in ZOO_SCHEDULERS:
        used, want = zoo_scheduler_case(torch, name, kw)
        scheds[name] = dict(used=used, want=want)
        checks[f"scheduler_{name}"] = len(used) == len(want) and all(
            t == u and abs(a - b) <= 1e-12 * abs(b)
            for (t, a), (u, b) in zip(used, want))
    ctx["zoo_parity"] = nets
    emit("zoo_parity", ok=all(checks.values()), checks=checks, nets=nets,
         config=dict(layout="NHWC", dtype="float32", classes=ZOO_CLASSES,
                     optimizer="sgd lr=0.1 momentum=0.9 wd=1e-4, one step",
                     dropout="rate 0 on both nets"),
         logits_rel=ZOO_LOGITS_REL, loss_rtol=LOSS_RTOL,
         update_rtol=UPDATE_RTOL, cond_rtol=ZOO_COND_RTOL,
         cond_factor=ZOO_COND_FACTOR,
         optimizers_max_rel_err=opts, optimizer_rtol=ZOO_OPT_RTOL,
         schedulers=scheds, seconds=time.perf_counter() - t0)
    for name, ok in checks.items():
        if not ok:
            ctx["failures"].append(f"zoo_parity check {name} failed")


def zoo_gmac(torch, net, size):
    """Forward multiply-adds of one image, counted from the layer shapes
    seen in one forward: a convolution's output elements times its
    input channels per group times its window, a dense layer's output
    times its inputs."""
    from tpu_mx_torch.gluon import nn
    from tpu_mx_torch.gluon.nn.conv_layers import _Conv
    macs = [0]

    def count(block, args, out):
        w = block._parameters["weight"]
        per = math.prod(w.shape[1:]) if isinstance(block, _Conv) \
            else w.shape[1]
        macs[0] += out.numel() * per

    handles = [m.register_forward_hook(count) for m in net.modules()
               if isinstance(m, (_Conv, nn.Dense))]
    with torch.no_grad():
        net.eval()(torch.zeros((1, size, size, 3), device="cuda"))
    for h in handles:
        h.remove()
    return macs[0] / 1e9


def zoo_train_run(torch, name):
    """``train_imagenet.py``'s recipe for ``name``: Xavier, bf16 with
    f32 masters, channels-last, softmax CE, SGD (0.1, momentum 0.9, wd
    1e-4) through ``CompiledTrainStep`` at batch ZOO_BATCH; 1 warm-up
    and ZOO_STEPS timed steps."""
    from tpu_mx_torch import optimizer
    from tpu_mx_torch.gluon import loss
    from tpu_mx_torch.parallel import CompiledTrainStep

    size = ZOO_SIZE.get(name, 224)
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    net = zoo_net(torch, name, "cuda")
    net.initialize("xavier", generator=gen)
    gmac = zoo_gmac(torch, net, size)        # also fixes the shapes
    net.cast("bfloat16")
    step = CompiledTrainStep(net, loss.SoftmaxCrossEntropyLoss(),
                             optimizer.create("sgd", **ZOO_SGD,
                                              multi_precision=True))
    data = torch.rand((ZOO_BATCH, size, size, 3), generator=gen,
                      device="cuda").to(torch.bfloat16)
    label = torch.randint(0, ZOO_CLASSES, (ZOO_BATCH,), generator=gen,
                          device="cuda").float()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    losses = [float(step.step(data, label))]     # warm-up
    warmup_ms = (time.perf_counter() - t1) * 1e3
    torch.cuda.reset_peak_memory_stats()
    step_ms = []
    for _ in range(ZOO_STEPS):
        t1 = time.perf_counter()
        losses.append(float(step.step(data, label)))   # ends in a host read
        step_ms.append((time.perf_counter() - t1) * 1e3)
    med = statistics.median(step_ms)
    flops = 6 * gmac * 1e9 * ZOO_BATCH          # forward 2 x MACs, x 3
    tflops = flops / (med * 1e-3) / 1e12
    first = next(p for p in net.parameters() if p.dim() == 4)
    return dict(size=size, batch=ZOO_BATCH, losses=losses, step_ms=step_ms,
                step_ms_median=med, images_per_sec=ZOO_BATCH / med * 1e3,
                warmup_ms=warmup_ms, setup_seconds=setup_s,
                gmac_per_image=gmac,
                published_gmac_per_image=ZOO_PUBLISHED_GMAC[name],
                train_flops_per_image=6 * gmac * 1e9,
                achieved_tflops=tflops,
                share_of_peak=tflops * 1e12 / BF16_FLOP_PER_S,
                peak_memory_bytes=torch.cuda.max_memory_allocated(),
                weight_dtype=str(first.dtype),
                channels_last=first.is_contiguous(
                    memory_format=torch.channels_last))


def phase_zoo_train(ctx):
    """The seven networks at full width through ``train_imagenet.py``'s
    recipe, one after another; no kernel of the port may launch."""
    import torch

    # cuDNN's heuristics, not its autotuning: on this card autotuning
    # took 5-26 s of warm-up a network and no step was faster for it
    prior = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = False
    reset_port_kernel_launches()
    runs, checks = {}, {}
    try:
        for name in ZOO_NETS:
            rec = zoo_train_run(torch, name)
            runs[name] = rec
            checks[f"{name}_finite"] = all(map(math.isfinite, rec["losses"]))
            checks[f"{name}_bf16"] = rec["weight_dtype"] == "torch.bfloat16"
            checks[f"{name}_gmac"] = abs(rec["gmac_per_image"] / rec[
                "published_gmac_per_image"] - 1) <= ZOO_GMAC_RTOL
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.benchmark = prior
    ctx["zoo_train"] = runs
    ctx["zoo_launches"] = port_kernel_launches()
    checks["no_port_kernel_launched"] = not any(ctx["zoo_launches"].values())
    emit("zoo_train", ok=all(checks.values()), checks=checks, runs=runs,
         recipe="examples/image_classification/train_imagenet.py: "
                "get_model(name, classes=1000), xavier, bfloat16, NHWC, "
                "softmax CE, sgd lr=0.1 momentum=0.9 wd=1e-4 "
                "multi_precision, CompiledTrainStep",
         reduced={"steps": f"1 warm-up + {ZOO_STEPS} timed"},
         cudnn_benchmark=False, launches=ctx["zoo_launches"],
         peak_tflops=BF16_FLOP_PER_S / 1e12, card=ctx["smi"])
    for name, ok in checks.items():
        if not ok:
            ctx["failures"].append(f"zoo_train check {name} failed")


def phase_zoo_example(ctx):
    """``examples/image_classification/train_imagenet.py`` unedited, on
    the card, through a ``sys.modules`` alias of ``tpu_mx`` to the
    port: mobilenet_v2_1_0, NHWC, one epoch of 20 steps at batch 128."""
    import os
    import tempfile
    import zipfile

    import torch

    import tpu_mx_torch as tmx
    from tpu_mx_torch.context import cpu
    from tpu_mx_torch.io import DevicePrefetchIter

    alias = port_alias("gluon", "gluon.model_zoo", "gluon.model_zoo.vision",
                       "parallel", "layout")
    vision = tmx.gluon.model_zoo.vision
    nets, batches = [], []
    get_model, receive = vision.get_model, DevicePrefetchIter._receive

    def recorded_get_model(*args, **kwargs):
        nets.append(get_model(*args, **kwargs))
        return nets[-1]

    def recorded_receive(self, item):
        out = receive(self, item)
        d = out[0].data[0]._data
        batches.append((d.device.type, str(d.dtype)))
        return out

    tmp = tempfile.mkdtemp(prefix="zoo_example_")
    prefix = os.path.join(tmp, "mobilenet_v2")
    try:
        vision.get_model = recorded_get_model
        DevicePrefetchIter._receive = recorded_receive
        _, text, seconds, loaded = run_example(
            "image_classification/train_imagenet.py",
            ["train_imagenet.py", "--network", "mobilenet_v2_1_0",
             "--layout", "NHWC", "--epochs", "1", "--model-prefix", prefix],
            alias)
    finally:
        vision.get_model = get_model
        DevicePrefetchIter._receive = receive
    last = [ln for ln in text.splitlines() if ln.startswith("epoch 0: loss")]
    imgs = float(last[-1].split()[-2]) if last else float("nan")
    loss = float(last[-1].split()[3]) if last else float("nan")
    params = f"{prefix}-0000.params"
    net = nets[0] if nets else None
    members, v2 = {}, []
    if os.path.exists(params):
        with zipfile.ZipFile(params) as z:
            members = {n: z.read(n)[:128] for n in z.namelist()}
        v2 = [n for n, head in members.items() if b"'<V2'" in head]
    keys = set(net._collect_params_with_prefix()) if net is not None \
        else set()
    bit_equal = False
    if net is not None and members:
        with cpu():
            host = zoo_net(torch, "mobilenet_v2_1_0", "cpu")
            host.initialize()
            host.load_parameters(params)
        bit_equal = all(
            torch.equal(a._ref_view().cpu(), b._ref_view())
            for a, b in zip(net._collect_params_with_prefix().values(),
                            host._collect_params_with_prefix().values()))
    checks = {
        "ended": bool(last) and math.isfinite(loss),
        "batches_on_card_bf16": len(batches) == ZOO_EXAMPLE_STEPS and all(
            b == ("cuda", "torch.bfloat16") for b in batches),
        "no_reference_module_loaded": not loaded,
        "no_jax": "jax" not in sys.modules,
        "params_members": set(members) == {"__layout__.npy"} | {
            k + ".npy" for k in keys},
        "params_bf16_as_v2": bool(keys) and len(v2) == len(keys),
        "reloaded_bit_equal_on_cpu": bit_equal,
    }
    # zoo_train reset the counts: they now cover both zoo phases
    ctx["zoo_launches"] = port_kernel_launches()
    checks["no_port_kernel_launched"] = not any(ctx["zoo_launches"].values())
    ctx["zoo_example"] = dict(images_per_sec=imgs, loss=loss)
    emit("zoo_example", ok=all(checks.values()), checks=checks,
         argv=sys.argv[:1] + ["--network", "mobilenet_v2_1_0", "--layout",
                              "NHWC", "--epochs", "1"],
         example_images_per_sec=imgs, final_loss=loss, steps=len(batches),
         seconds=seconds, reference_modules_loaded=loaded[:10],
         params_members=len(members), card=ctx["smi"])
    import shutil
    shutil.rmtree(tmp, ignore_errors=True)
    for name, ok in checks.items():
        if not ok:
            ctx["failures"].append(f"zoo_example check {name} failed")


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
    on 2**26 float32 elements; and ``scale`` written for the card
    (``scale4``), timed beside ``torch.mul``."""
    import torch
    from tpu_mx_torch import nd, rtc
    from tpu_mx_torch.base import MXNetError
    gen = torch.Generator(device="cuda").manual_seed(4)
    x, a, b = (torch.randn(RTC_N, device="cuda", generator=gen)
               for _ in range(3))
    mod = rtc.CudaModule(RTC_SOURCE)
    scale, addmul = mod.get_kernel("scale", alpha=3.0), \
        mod.get_kernel("addmul")
    scale4 = mod.get_kernel("scale4", alpha=3.0)
    grid4 = -(-(RTC_N // 4) // RTC_BLOCK)
    t0 = time.perf_counter()
    mod.cubin()
    build_s = time.perf_counter() - t0

    rtc.Kernel.launches = 0
    y = scale.launch((x,))
    o = addmul((a, b))
    y_nd = scale.launch((nd.array(x),))         # NDArray in, NDArray out
    torch.cuda.synchronize()
    launches = rtc.Kernel.launches
    y4 = scale4.launch((x,), grid=grid4, block=RTC_BLOCK)
    tail = x[:RTC_N - 3]
    y4_tail = scale4.launch((tail,), grid=-(-(tail.numel() // 4)
                                            // RTC_BLOCK),
                            block=RTC_BLOCK)
    want_y, want_o = x * 3.0, a * b + a
    terms = (a * b).abs() + a.abs()
    addmul_rel = float(((o - want_o).abs() / terms.clamp_min(1e-30)).max())
    errs = {"scale": float((y - want_y).abs().max()),
            "addmul": float((o - want_o).abs().max()),
            "scale4": float((y4 - want_y).abs().max())}
    checks = {"scale_bit_equal": torch.equal(y, want_y),
              "ndarray_scale_bit_equal": isinstance(y_nd, nd.NDArray)
              and torch.equal(y_nd._data, want_y),
              "scale4_bit_equal": torch.equal(y4, want_y),
              "scale4_tail_bit_equal": torch.equal(y4_tail, tail * 3.0),
              "addmul_rel": addmul_rel <= 1e-6, "launches": launches == 3}
    del y, o, y_nd, y4, y4_tail, want_y, want_o, terms

    buf = torch.empty_like(x)
    nbytes = {"scale": 2 * 4 * RTC_N, "addmul": 3 * 4 * RTC_N,
              "scale4": 2 * 4 * RTC_N}
    flops = {"scale": RTC_N, "addmul": 2 * RTC_N, "scale4": RTC_N}
    scale_lib = lambda: torch.mul(x, 3.0, out=buf)
    timed = {
        "scale": (lambda: scale.launch((x,)), lambda: x * 3.0, scale_lib),
        "addmul": (lambda: addmul((a, b)), lambda: a * b + a,
                   lambda: torch.addcmul(a, a, b, out=buf)),
        "scale4": (lambda: scale4.launch((x,), grid=grid4,
                                         block=RTC_BLOCK),
                   lambda: x * 3.0, scale_lib)}
    kernels = {}
    for name, (kern, plain, lib) in timed.items():
        b_ms, b_by = bound(nbytes[name], flops[name])
        kernels[name] = dict(
            ms=cuda_ms(torch, kern, queued=True),
            ms_with_host=cuda_ms(torch, kern),
            plain_ms=cuda_ms(torch, plain, queued=True),
            library_ms=cuda_ms(torch, lib, queued=True),
            library_ms_with_host=cuda_ms(torch, lib),
            host_us=host_us(torch, kern), library_host_us=host_us(torch, lib),
            bound_ms=b_ms, bound_by=b_by, max_abs_err=errs[name])
        k = kernels[name]
        k.update(rates(flops[name], k["ms"], b_ms),
                 host_ms=k["ms_with_host"] - k["ms"],
                 library_host_ms=k["library_ms_with_host"] - k["library_ms"],
                 over_library=k["ms"] / k["library_ms"])

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
                      addmul=kernels["addmul"], scale4=kernels["scale4"])
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
                        step_ms=step_med, idle=1 - busy_ms / (wall * 1e3),
                        boundary_us=bound["nd"] - bound["tensor"])
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
    saved = trainer_states_save(torch, imp, trainer, tensors)
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
    states = trainer_states_resume(torch, imp, saved, arrays, loss_fn,
                                   losses["imperative"][1])
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
        **{f"states_{k}": v for k, v in states.pop("checks").items()},
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
         routes=routes, trainer_states=states, card=ctx["smi"])
    for name, ok in checks.items():
        if not ok:
            ctx["failures"].append(f"bert_imperative check {name} failed")
    del imp, comp, step, trainer
    torch.cuda.empty_cache()


def _state_sums(torch, states):
    """Each state tensor's float64 sum, in tree order (a checksum)."""
    out = []
    for s in states:
        if isinstance(s, torch.Tensor):
            out.append(float(s.double().sum()))
        elif isinstance(s, (tuple, list)):
            out += _state_sums(torch, s)
    return out


def trainer_states_save(torch, net, trainer, tensors):
    """After step 1: the trainer's states in the reference's file (bytes,
    seconds), with the weights, the dropout generators' states and a
    checksum of every state tensor kept to resume from."""
    import tempfile
    from tpu_mx_torch.gluon.block import _segment_generators
    path = tempfile.mkdtemp(prefix="chip_states_") + "/bert.states"
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.save_states(path)
    save_s = time.perf_counter() - t0
    gens = _segment_generators(net, tensors)
    return dict(path=path, save_seconds=save_s,
                bytes=os.path.getsize(path),
                weights=[p.data()._data.detach().clone()
                         for p in net.collect_params().values()],
                gens=[(g, g.get_state()) for g in gens],
                sums=_state_sums(torch, trainer._states))


def trainer_states_resume(torch, net, saved, arrays, loss_fn, unbroken):
    """Step 2 again from step 1's weights and generators through a fresh
    ``Trainer`` that loads the saved file: the state tensors load
    bit-equal and step 2's loss equals the unbroken run's bit for bit."""
    from tpu_mx_torch import gluon
    with torch.no_grad():
        for p, w in zip(net.collect_params().values(), saved["weights"]):
            p.data()._data.copy_(w)
    for g, st in saved["gens"]:
        g.set_state(st)
    trainer = gluon.Trainer(net.collect_params(), "lamb",
                            {"learning_rate": 1e-4, "multi_precision": True})
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.load_states(saved["path"])
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    sums = _state_sums(torch, trainer._states)
    loss = imperative_bert_step(net, trainer, loss_fn, arrays)
    os.remove(saved["path"])
    os.rmdir(os.path.dirname(saved["path"]))
    return dict(bytes=saved["bytes"], save_seconds=saved["save_seconds"],
                load_seconds=load_s, step2_loss=loss,
                step2_loss_unbroken=unbroken,
                checks={"loaded_bit_equal": sums == saved["sums"],
                        "step2_loss_bit_equal": loss == unbroken,
                        "update_counts": trainer.optimizer.num_update == 2})


def moe_train_block(bert):
    """The MoE BERT's objective as the reference's MoE examples write it:
    the MLM loss plus ``MOE_AUX_WEIGHT`` x the load-balance term, in the
    forward (the step trains on a net's first output), for
    ``gluon.loss.PassThrough``; the last aux term is kept in ``.aux``."""
    from tpu_mx_torch.gluon.block import HybridBlock
    from tpu_mx_torch.models import MLMLoss

    class MoEBertTrain(HybridBlock):
        def __init__(self):
            super().__init__()
            self.bert = bert
            self._mlm = MLMLoss()
            self.aux = None

        def forward(self, tokens, types, valid, positions, labels):
            logits, aux = self.bert(tokens, types, valid, positions)
            self.aux = aux.detach()
            return self._mlm(logits, labels).mean() + MOE_AUX_WEIGHT * aux

    return MoEBertTrain()


def moe_step(torch, net, lr, device, multi_precision=False):
    from tpu_mx_torch import optimizer
    from tpu_mx_torch.gluon.loss import PassThrough
    from tpu_mx_torch.parallel import CompiledTrainStep
    return CompiledTrainStep(moe_train_block(net), PassThrough(),
                             optimizer.create(
                                 "lamb", learning_rate=lr,
                                 multi_precision=multi_precision),
                             device=device)


def moe_parity_arm(torch, remat, policy, batch):
    """One remat arm of ``moe_parity``: the thin MoE BERT on the CPU and
    on the card from one weight set and one generator state; the losses,
    each parameter's change, the routing of every MoE call, and the
    card's launches and routes."""
    from tpu_mx_torch.kernels import flash_attention as fa
    from tpu_mx_torch.models import BERTModel
    from tpu_mx_torch.parallel import moe as moe_mod

    gen = torch.Generator().manual_seed(0)
    cpu = BERTModel(MOE_THIN, remat=remat, remat_policy=policy,
                    device="cpu", generator=gen, **MOE_THIN_ARGS)
    card = BERTModel.from_numpy(
        {n: p.detach().numpy() for n, p in cpu.named_parameters()},
        MOE_THIN, device="cuda", remat=remat, remat_policy=policy,
        **MOE_THIN_ARGS)
    host = torch.Generator()
    host.set_state(gen.get_state())
    for m in card.modules():     # the CPU's draws, copied to the card
        if isinstance(m.__dict__.get("_generator"), torch.Generator):
            m._generator = host
    before = {n: p.detach().clone() for n, p in cpu.named_parameters()}
    route = moe_mod.moe_route
    out = {}
    for name, net, dev in (("cpu", cpu, "cpu"), ("cuda", card, "cuda")):
        calls = []

        def recorded(probs, top_k, capacity, *split):
            r = route(probs, top_k, capacity, *split)
            calls.append([torch.stack(x).cpu().numpy() for x in r[:3]])
            return r

        step = moe_step(torch, net, 1e-3, dev)
        args = tuple(torch.from_numpy(b).to(dev) for b in batch)
        dummy = torch.zeros(1, device=dev)
        reset_port_kernel_launches()
        wrappers = (fa.flash_attention, fa.flash_attention_bwd_dq,
                    fa.flash_attention_bwd_dkv)
        for c in wrappers:
            c.routes = fa.route_counts()
        moe_mod.moe_route = recorded
        try:
            losses = [float(step.step(*args, dummy))
                      for _ in range(MOE_PARITY_STEPS)]
        finally:
            moe_mod.moe_route = route
        out[name] = dict(losses=losses, calls=calls,
                         launches=port_kernel_launches(),
                         routes={k: dict(c.routes) for k, c in
                                 zip(FLASH_KERNELS, wrappers)})
    worst, worst_name = 0.0, None
    params_card = dict(card.named_parameters())
    for n, p in cpu.named_parameters():
        d_cpu = p.detach() - before[n]
        d_card = params_card[n].detach().cpu() - before[n]
        rel = float((d_card - d_cpu).norm()
                    / d_cpu.norm().clamp_min(1e-30))
        if rel > worst:
            worst, worst_name = rel, n
    routing_equal = len(out["cpu"]["calls"]) == len(out["cuda"]["calls"]) \
        and all(all(np.array_equal(a, b) for a, b in zip(x, y))
                for x, y in zip(out["cpu"]["calls"], out["cuda"]["calls"]))
    drops = int(sum((~c[2].astype(bool)).sum() for c in out["cpu"]["calls"]))
    return dict(losses={k: out[k]["losses"] for k in out},
                worst_update_rel_err=worst, worst_update_param=worst_name,
                routing_equal=routing_equal,
                route_calls=len(out["cuda"]["calls"]), dropped=drops,
                launches=out["cuda"]["launches"],
                routes=out["cuda"]["routes"])


def phase_moe_parity(ctx):
    """The thin MoE BERT through three LAMB steps on the card against the
    CPU (float32, dropout 0.1), with remat off, on and on with
    ``dots_saveable``."""
    import torch
    from tpu_mx_torch.kernels import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    rng = np.random.RandomState(4)
    batch = bert_batch(MOE_THIN, len(MOE_THIN_VALID), MOE_THIN["max_length"],
                       MOE_THIN_MASKED, MOE_THIN_VALID, rng)
    layers = MOE_THIN["num_layers"]
    checks, arms = {}, {}
    launches = dict.fromkeys(port_kernel_launches(), 0)
    for remat, policy in MOE_REMAT_ARMS:
        key = "remat_off" if not remat else f"remat_{policy or 'all'}"
        arm = moe_parity_arm(torch, remat, policy, batch)
        arms[key] = arm
        for k, n in arm["launches"].items():
            launches[k] += n
        losses = arm["losses"]
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses["cuda"],
                                                      losses["cpu"]))
        arm["loss_rel_err"] = rel
        recomputed = remat and policy is None
        per = layers * MOE_PARITY_STEPS
        checks.update({
            f"{key}_loss": rel <= LOSS_RTOL,
            f"{key}_updates": arm["worst_update_rel_err"] <= UPDATE_RTOL,
            f"{key}_routing_equal": arm["routing_equal"],
            f"{key}_finite": all(math.isfinite(x) for x in losses["cuda"]),
            f"{key}_tf32x3": all(
                r == dict(fa.route_counts(), tf32x3=n) for r, n in zip(
                    arm["routes"].values(),
                    (per * (2 if recomputed else 1), per, per))),
        })
        if remat:
            checks[f"{key}_losses_equal_without_remat"] = \
                losses["cuda"] == arms["remat_off"]["losses"]["cuda"]
    ctx["moe_parity_launches"] = launches
    emit("moe_parity", ok=all(checks.values()), checks=checks,
         config={**MOE_THIN, **MOE_THIN_ARGS, "dtype": "float32",
                 "valid_length": list(MOE_THIN_VALID),
                 "masked": MOE_THIN_MASKED, "aux_weight": MOE_AUX_WEIGHT},
         arms=arms, loss_rtol=LOSS_RTOL, update_rtol=UPDATE_RTOL,
         launches=launches, seconds=time.perf_counter() - t0)
    for name, ok in checks.items():
        if not ok:
            ctx["failures"].append(f"moe_parity check {name} failed")
    gc.collect()
    torch.cuda.empty_cache()


def moe_train_net(torch, remat, policy):
    from tpu_mx_torch.models import BERTModel, bert_base_config
    cfg = bert_base_config(max_len=TRAIN_SEQ)
    return cfg, BERTModel(cfg, dtype="bfloat16", device="cuda",
                          generator=torch.Generator(device="cuda")
                          .manual_seed(0), remat=remat, remat_policy=policy,
                          **MOE_ARGS)


def moe_train_arm(torch, remat, policy, batch):
    """``MOE_STEPS`` timed steps (after a warm-up) of the full-width MoE
    BERT; returns the run and its step (for the checkpoint)."""
    from tpu_mx_torch.kernels import flash_attention as fa
    t0 = time.perf_counter()
    cfg, net = moe_train_net(torch, remat, policy)
    step = moe_step(torch, net, 1e-4, "cuda", multi_precision=True)
    dummy = torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    losses = [float(step.step(*batch, dummy))]          # warm-up
    torch.cuda.reset_peak_memory_stats()
    reset_port_kernel_launches()
    wrappers = (fa.flash_attention, fa.flash_attention_bwd_dq,
                fa.flash_attention_bwd_dkv)
    for c in wrappers:
        c.routes = fa.route_counts()
    step_ms, aux = [], []
    for _ in range(MOE_STEPS):
        t1 = time.perf_counter()
        losses.append(float(step.step(*batch, dummy)))  # ends in a host read
        step_ms.append((time.perf_counter() - t1) * 1e3)
        aux.append(float(step.net.aux))
    med = statistics.median(step_ms)
    run = dict(setup_seconds=setup_s, losses=losses, step_ms=step_ms,
               step_ms_median=med, seq_per_sec=TRAIN_BATCH / med * 1e3,
               peak_memory_bytes=torch.cuda.max_memory_allocated(),
               aux=aux, launches=port_kernel_launches(),
               routes={k: dict(c.routes) for k, c in zip(FLASH_KERNELS,
                                                         wrappers)})
    return cfg, run, step


def phase_moe_train(ctx):
    """BERT-base MoE at full width in bf16 on the card: remat off, on and
    on with ``dots_saveable`` from the same weights; then the step's
    checkpoint round trip."""
    import os
    import shutil
    import tempfile

    import torch
    from tpu_mx_torch.kernels import flash_attention as fa
    from tpu_mx_torch.models import bert_base_config

    cfg = bert_base_config(max_len=TRAIN_SEQ)
    rng = np.random.RandomState(0)
    valid = rng.randint(TRAIN_VALID[0], TRAIN_VALID[1] + 1, TRAIN_BATCH)
    batch = bert_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, TRAIN_MASKED, valid, rng)
    batch = tuple(torch.from_numpy(x).cuda() for x in batch)
    layers = cfg["num_layers"]
    arms, checks, step = {}, {}, None
    launches = dict.fromkeys(port_kernel_launches(), 0)
    for remat, policy in MOE_REMAT_ARMS:
        key = "remat_off" if not remat else f"remat_{policy or 'all'}"
        step = None
        gc.collect()
        torch.cuda.empty_cache()
        cfg, run, step = moe_train_arm(torch, remat, policy, batch)
        arms[key] = run
        for k, n in run["launches"].items():
            launches[k] += n
        per = layers * MOE_STEPS
        fwd = per * (2 if remat and policy is None else 1)
        checks.update({
            f"{key}_finite": all(math.isfinite(x) for x in run["losses"]),
            f"{key}_flash_launches": [run["launches"][k] for k in
                                      FLASH_KERNELS] == [fwd, per, per],
            f"{key}_wgmma": all(r == dict(fa.route_counts(), wgmma=n)
                                for r, n in zip(run["routes"].values(),
                                                (fwd, per, per))),
            f"{key}_paged_rtc_idle": run["launches"]["paged_attention"] == 0
            and run["launches"]["rtc"] == 0,
        })
        if remat:
            checks[f"{key}_losses_equal_without_remat"] = \
                run["losses"] == arms["remat_off"]["losses"]
    # the last arm's step: save, a fresh step loads, one more step each
    tmp = tempfile.mkdtemp(prefix="moe_ckpt_")
    path = os.path.join(tmp, "step")
    try:
        t0 = time.perf_counter()
        step.save_checkpoint(path)
        save_s = time.perf_counter() - t0
        size = os.path.getsize(path)
        marker = os.path.exists(step.commit_marker_path(path))
        _, net2 = moe_train_net(torch, *MOE_REMAT_ARMS[-1])
        fresh = moe_step(torch, net2, 1e-4, "cuda", multi_precision=True)
        t0 = time.perf_counter()
        fresh.load_checkpoint(path)
        load_s = time.perf_counter() - t0
        dummy = torch.zeros(1, device="cuda")
        after = [float(s.step(*batch, dummy)) for s in (step, fresh)]
        fps = [s.fingerprint() for s in (step, fresh)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    checks["checkpoint_losses_equal"] = after[0] == after[1]
    checks["checkpoint_fingerprints_equal"] = fps[0] == fps[1] is not None
    checks["checkpoint_marker_written"] = marker
    ctx["moe_train_launches"] = launches
    ctx["moe_train"] = {k: dict(step_ms=v["step_ms_median"],
                                peak=v["peak_memory_bytes"])
                        for k, v in arms.items()}
    emit("moe_train", ok=all(checks.values()), checks=checks,
         model={**cfg, **MOE_ARGS, "capacity_factor": 1.25,
                "dtype": "bfloat16", "aux_weight": MOE_AUX_WEIGHT},
         batch=dict(batch=TRAIN_BATCH, seq=TRAIN_SEQ, masked=TRAIN_MASKED,
                    valid_length=[int(v) for v in valid]),
         optimizer="lamb lr=1e-4 multi_precision", arms=arms,
         checkpoint=dict(bytes=size, save_seconds=save_s,
                         load_seconds=load_s, losses_after=after,
                         fingerprints=fps),
         launches=launches, card=ctx["smi"])
    for name, ok in checks.items():
        if not ok:
            ctx["failures"].append(f"moe_train check {name} failed")
    del step, fresh, net2
    gc.collect()
    torch.cuda.empty_cache()


def run_example(relpath, argv, alias):
    """Run ``examples/<relpath>`` unedited with ``alias`` in
    ``sys.modules`` and ``argv``; returns its globals, its standard
    output, its seconds and the modules of ``tpu_mx/`` loaded meanwhile."""
    import contextlib
    import io as _io
    import os
    import runpy

    here = os.path.dirname(os.path.abspath(__file__))
    saved = {k: sys.modules.get(k) for k in alias}
    old_argv = sys.argv
    out = _io.StringIO()
    t0 = time.perf_counter()
    try:
        sys.modules.update(alias)
        sys.argv = argv
        with contextlib.redirect_stdout(out):
            result = runpy.run_path(os.path.join(here, "examples", relpath),
                                    run_name="__main__")
    finally:
        sys.argv = old_argv
        for k, v in saved.items():
            if v is None:
                sys.modules.pop(k, None)
            else:
                sys.modules[k] = v
    seconds = time.perf_counter() - t0
    ref_dir = os.path.join(here, "tpu_mx") + os.sep
    loaded = sorted(n for n, m in list(sys.modules.items())
                    if (getattr(m, "__file__", None) or "").startswith(
                        ref_dir))
    text = out.getvalue()
    print(text, end="", flush=True)
    return result, text, seconds, loaded


def port_alias(*names):
    import importlib
    import tpu_mx_torch as tmx
    alias = {"tpu_mx": tmx}
    for n in names:
        alias["tpu_mx." + n] = importlib.import_module("tpu_mx_torch." + n)
    return alias


def phase_bert_example(ctx):
    """``examples/bert/pretrain.py`` unedited at its defaults on the card
    through the alias; the host cost of ``hybrid_forward``'s arrays."""
    import torch
    from tpu_mx_torch.kernels import flash_attention as fa

    alias = port_alias("gluon", "models", "models.bert", "parallel")
    reset_port_kernel_launches()
    wrappers = (fa.flash_attention, fa.flash_attention_bwd_dq,
                fa.flash_attention_bwd_dkv)
    for c in wrappers:
        c.routes = fa.route_counts()
    result, text, seconds, loaded = run_example(
        "bert/pretrain.py", ["pretrain.py"], alias)
    launches = port_kernel_launches()
    routes = {k: dict(c.routes) for k, c in zip(FLASH_KERNELS, wrappers)}
    line = [ln for ln in text.splitlines() if "seq/s" in ln]
    m = re.search(r"loss ([\d.]+) -> ([\d.]+)\s+\(([\d.]+) seq/s\)",
                  line[-1]) if line else None
    # C15's cost: the example's loss (its hybrid_forward on jax-method
    # arrays) against the same arithmetic on plain tensors
    gen = torch.Generator(device="cuda").manual_seed(0)
    logits = torch.randn(BERT_EXAMPLE_BATCH, 128, 30522, device="cuda",
                         generator=gen)
    labels = torch.where(torch.rand(BERT_EXAMPLE_BATCH, 128, device="cuda",
                                    generator=gen) < 0.15,
                         torch.randint(0, 30522, (BERT_EXAMPLE_BATCH, 128),
                                       device="cuda", generator=gen),
                         -1).to(torch.int32)
    loss_fn = result["MLMLoss"]()

    def plain():
        flat = logits.reshape(-1, logits.shape[-1])
        lab = labels.reshape(-1)
        mask = lab >= 0
        safe = torch.where(mask, lab, torch.zeros_like(lab))
        ce = -torch.log_softmax(flat, -1).gather(1, safe.long()[:, None])[:, 0]
        ce = torch.where(mask, ce, torch.zeros_like(ce))
        return ce.sum() / torch.clamp(mask.float().sum(), min=1.0)

    traced_us = host_us(torch, lambda: loss_fn(logits, labels), n=100)
    plain_us = host_us(torch, plain, n=100)
    agree = abs(float(loss_fn(logits, labels)) - float(plain())) \
        <= 1e-5 * abs(float(plain()))
    steps = BERT_EXAMPLE_STEPS
    checks = {
        "ended_with_its_assertion": m is not None,
        "no_reference_module_loaded": not loaded,
        "no_jax": "jax" not in sys.modules,
        # the shape-finalizing forward, then the steps
        "flash_launches": [launches[k] for k in FLASH_KERNELS]
        == [12 * (steps + 1), 12 * steps, 12 * steps],
        "wgmma_routes": all(set(r) == set(fa.route_counts()) and
                            r["wgmma"] == n for r, n in zip(
                                routes.values(), (12 * (steps + 1),
                                                  12 * steps, 12 * steps))),
        "loss_matches_plain_twin": agree,
    }
    ctx["bert_example_launches"] = launches
    ctx["bert_example"] = dict(seq_per_sec=float(m.group(3)) if m else None)
    emit("bert_example", ok=all(checks.values()), checks=checks,
         argv=["pretrain.py"], losses=[float(m.group(1)), float(m.group(2))]
         if m else None, example_seq_per_sec=float(m.group(3)) if m
         else None, seconds=seconds, launches=launches, routes=routes,
         loss_host_us=dict(hybrid_forward=traced_us, plain_tensors=plain_us),
         reference_modules_loaded=loaded[:10], card=ctx["smi"])
    for name, ok in checks.items():
        if not ok:
            ctx["failures"].append(f"bert_example check {name} failed")
    gc.collect()
    torch.cuda.empty_cache()


def phase_moe_example(ctx):
    """``examples/moe/train_moe_lm.py`` unedited at its defaults on the
    card through the alias."""
    import torch
    from tpu_mx_torch.parallel import CompiledTrainStep

    alias = port_alias("gluon", "gluon.nn", "gluon.block", "parallel")
    devices = []
    real = CompiledTrainStep.step

    def recorded(self, *batch, **kwargs):
        loss = real(self, *batch, **kwargs)
        devices.append(loss._data.device.type)
        return loss

    reset_port_kernel_launches()
    CompiledTrainStep.step = recorded
    try:
        _, text, seconds, loaded = run_example(
            "moe/train_moe_lm.py", ["train_moe_lm.py"], alias)
    finally:
        CompiledTrainStep.step = real
    m = re.search(r"loss ([\d.]+) -> ([\d.]+) in", text)
    checks = {
        "ended_with_its_assertion": m is not None,
        "losses_on_the_card": len(devices) == 60 and set(devices)
        == {"cuda"},
        "no_reference_module_loaded": not loaded,
        "no_jax": "jax" not in sys.modules,
    }
    ctx["moe_example_launches"] = port_kernel_launches()
    emit("moe_example", ok=all(checks.values()), checks=checks,
         argv=["train_moe_lm.py"],
         losses=[float(m.group(1)), float(m.group(2))] if m else None,
         seconds=seconds, steps=len(devices),
         launches=ctx["moe_example_launches"],
         reference_modules_loaded=loaded[:10], card=ctx["smi"])
    for name, ok in checks.items():
        if not ok:
            ctx["failures"].append(f"moe_example check {name} failed")


OPS_REPS = 20                   # cuda_ms medians of the operators phase
OPS_F32_TOL = 1e-5              # card against CPU, x max|ref|
OPS_STATS_TOL = 1e-4            # float32 statistics / products, x max|ref|
# the two-pass BatchNorm at mean 20, spread 0.1: the mean/spread of 200
# scales each device's rounding of the centred values (x max|ref|)
BN_TWO_PASS_F32_TOL = 5e-4
CTC_LOSS_RTOL = 1e-4
CTC_GRAD_RTOL = 1e-3            # in norm
CTC_SHAPE = dict(T=400, N=32, C=29, label_len=(40, 120), data_len=(300, 400))
OPS_REST = 1 << 24              # elements of the remaining operators' inputs
MULTINOMIAL_DRAWS = 1 << 16
# rows (a batch's leading entries) the CPU port computes where an operator
# treats rows apart: the card runs the whole shape and its leading rows
# are held to the CPU's (the host's half would take minutes at full size)
OPS_CPU_ROWS = {"ordering_mlm": 304, "sequence": 256, "masked_softmax": 6,
                "linalg": 48, "batch_norm": 16, "softmax_output": 304,
                "rest_images": 4, "rest_rows": 256}
CHI2_Z = 5.0                    # the chi-square bound, in standard deviations


def chi2_bound(df, z=CHI2_Z):
    """The chi-square statistic of ``df`` degrees of freedom that ``z``
    standard deviations of the Wilson-Hilferty normal approximation
    reach."""
    a = 2.0 / (9 * df)
    return df * (1 - a + z * math.sqrt(a)) ** 3


def card_draw(torch, rng, shape, low=None, high=None):
    """A float32 tensor of ``shape`` drawn on the card (normal, or uniform
    in ``[low, high)``) from a generator seeded by ``rng``, on the host."""
    g = torch.Generator(device="cuda").manual_seed(int(rng.randint(1 << 31)))
    if low is None:
        return torch.randn(shape, generator=g, device="cuda").cpu()
    return (torch.rand(shape, generator=g, device="cuda") * (high - low)
            + low).cpu()


def distinct_bf16(rows, cols, rng):
    """``(rows, cols)`` bfloat16 logits, each row distinct values (positive
    normal bit patterns in a row-shifted permutation)."""
    import torch
    perm = rng.permutation(cols)
    shift = rng.randint(0, cols, rows)
    idx = (perm[None, :] + shift[:, None] * 7919) % cols
    return torch.from_numpy((idx + 0x0080).astype(np.int16)).view(
        torch.bfloat16)


class OpsCheck:
    """One group of the operators phase: card timings, the CPU port's
    outputs on the same inputs, errors against tolerances."""

    def __init__(self, torch, ctx):
        self.torch, self.ctx = torch, ctx
        self.groups, self.failures = {}, []

    def err(self, card, cpu):
        """Max |card - cpu| over finite entries, and the max |cpu|; the
        non-finite entries must match exactly."""
        t = self.torch
        a = card.detach().double()
        b = cpu.detach().to(card.device).double()     # compared on the card
        same_inf = bool(t.equal(t.isinf(a) & (a > 0), t.isinf(b) & (b > 0))
                        and t.equal(t.isinf(a) & (a < 0),
                                    t.isinf(b) & (b < 0))
                        and t.equal(t.isnan(a), t.isnan(b)))
        fin = t.isfinite(b)
        if not fin.any():
            return (0.0 if same_inf else math.inf), 0.0
        e = float((a[fin] - b[fin]).abs().max()) if same_inf else math.inf
        return e, float(b[fin].abs().max())

    def check(self, group, name, card, cpu, tol, rel=True, exact=False):
        e, scale = self.err(card, cpu)
        limit = 0.0 if exact else tol * (scale if rel else 1.0)
        ok = card.device.type == "cuda" and e <= limit
        g = self.groups[group]
        g.setdefault("checks", {})[name] = ok
        g["cpu_max_abs_err"] = max(g.get("cpu_max_abs_err", 0.0), e)
        g.setdefault("errors", {})[name] = dict(max_abs_err=e, limit=limit)
        if not ok:
            self.failures.append(f"operators {group}: {name} off by {e} "
                                 f"(limit {limit})")
        return ok

    def time(self, group, fn, library=None, key="ms", lib_key="library_ms"):
        g = self.groups.setdefault(group, {})
        g[key] = cuda_ms(self.torch, fn, reps=OPS_REPS)
        if lib_key not in g:
            g[lib_key] = None
        if library is not None:
            g[lib_key] = cuda_ms(self.torch, library, reps=OPS_REPS)
        return g[key]


def ops_ordering(oc, nd, rng):
    """sort / argsort / topk / argmax_channel at the serving logits (8 x
    32000 f32) and the MLM logits (32 x 76 masked positions x 30522 bf16),
    distinct values in a row; sample_multinomial from the serving logits."""
    torch = oc.torch
    serve = torch.from_numpy((rng.permutation(8 * 32000).reshape(8, 32000)
                              .astype(np.float32) - 128000.0) / 1000.0)
    mlm = distinct_bf16(32 * 76, 30522, rng)
    for group, x, k in (("ordering_serve", serve, 8),
                        ("ordering_mlm", mlm, OPS_CPU_ROWS["ordering_mlm"])):
        xc = x.cuda()
        oc.groups[group] = {"shape": list(x.shape), "dtype": str(x.dtype),
                            "cpu_rows": k}
        x = x[:k]
        oc.time(group, lambda: nd.sort(xc, is_ascend=False),
                lambda: torch.sort(xc, descending=True, stable=True))
        oc.time(group, lambda: nd.argsort(xc, is_ascend=False),
                lambda: torch.argsort(xc, descending=True, stable=True),
                key="argsort_ms", lib_key="argsort_library_ms")
        oc.time(group, lambda: nd.topk(xc, k=50, ret_typ="both"),
                lambda: torch.topk(xc, 50), key="topk_ms",
                lib_key="topk_library_ms")
        oc.check(group, "sort", nd.sort(xc, is_ascend=False)[:k],
                 nd.sort(x, is_ascend=False), 0, exact=True)
        oc.check(group, "argsort", nd.argsort(xc, is_ascend=False)[:k],
                 nd.argsort(x, is_ascend=False), 0, exact=True)
        for part, c, h in zip(("topk_values", "topk_indices"),
                              nd.topk(xc, k=50, ret_typ="both"),
                              nd.topk(x, k=50, ret_typ="both")):
            oc.check(group, part, c[:k], h, 0, exact=True)
        if group == "ordering_serve":
            oc.time(group, lambda: nd.argmax_channel(xc),
                    lambda: torch.argmax(xc, dim=1),
                    key="argmax_channel_ms",
                    lib_key="argmax_channel_library_ms")
            oc.check(group, "argmax_channel", nd.argmax_channel(xc),
                     nd.argmax_channel(x), 0, exact=True)
        del xc
    # sampling from the serving logits: 1000 classes of row 0 held at 0
    p = torch.softmax(serve.double() / 64.0, -1).float()
    p[0, :1000] = 0.0
    pc = p.cuda()
    g = oc.groups["multinomial"] = {"shape": list(p.shape),
                                    "draws": MULTINOMIAL_DRAWS}
    oc.time("multinomial", lambda: nd.sample_multinomial(pc),
            lambda: torch.multinomial(pc, 1))
    g["draws_ms"] = cuda_ms(torch, lambda: nd.random.multinomial(
        pc[:1], shape=MULTINOMIAL_DRAWS), reps=OPS_REPS)
    d = nd.random.multinomial(pc[:1], shape=MULTINOMIAL_DRAWS)
    one = nd.sample_multinomial(pc)
    counts = torch.bincount(d.reshape(-1).long(), minlength=32000).cpu()
    bins = counts.reshape(32, 1000).sum(1).double()
    row = p[0].double() / p[0].double().sum()      # the sampler normalizes
    want = row.reshape(32, 1000).sum(1) * MULTINOMIAL_DRAWS
    use = want > 0
    chi2 = float(((bins[use] - want[use]) ** 2 / want[use]).sum())
    df = int(use.sum()) - 1
    g["checks"] = {
        "on_the_card": d.device.type == "cuda" and one.shape == (8,),
        "support": bool(((d >= 0) & (d < 32000)).all()),
        "zero_classes_never_drawn": int(counts[:1000].sum()) == 0,
        "chi2": chi2 <= chi2_bound(df)}
    g.update(chi2=chi2, chi2_df=df, chi2_bound=chi2_bound(df))
    g["cpu_max_abs_err"] = None
    oc.failures += [f"operators multinomial: {k}"
                    for k, ok in g["checks"].items() if not ok]


def ops_sequence(oc, nd, rng):
    """SequenceMask / Reverse / Last at the PTB LSTM's activations (35 x
    2048 x 650 bf16), lengths 1-35."""
    torch = oc.torch
    x = card_draw(torch, rng, (35, 2048, 650)) \
        .bfloat16()
    lens = torch.from_numpy(rng.randint(1, 36, 2048).astype(np.float32))
    xc, lc = x.cuda(), lens.cuda()
    k = OPS_CPU_ROWS["sequence"]
    oc.groups["sequence"] = {"shape": list(x.shape), "dtype": "bfloat16",
                             "cpu_batch": k}
    kw = dict(use_sequence_length=True)
    for name, fn in (("SequenceMask", nd.SequenceMask),
                     ("SequenceReverse", nd.SequenceReverse),
                     ("SequenceLast", nd.SequenceLast)):
        oc.time("sequence", lambda: fn(xc, lc, **kw), key=f"{name}_ms",
                lib_key=f"{name}_library_ms")
        got = fn(xc, lc, **kw)
        oc.check("sequence", name, got[:, :k] if got.dim() == 3 else got[:k],
                 fn(x[:, :k], lens[:k], **kw), 0, exact=True)
    oc.groups["sequence"]["ms"] = oc.groups["sequence"]["SequenceMask_ms"]
    oc.groups["sequence"]["library_ms"] = None


def ops_indexing(oc, nd, rng):
    """gather_nd / scatter_nd / batch_take / choose_element_0index /
    fill_element_0index at BERT's hidden states (32 x 512 x 768 bf16), 76
    masked positions a row."""
    torch = oc.torch
    h = card_draw(torch, rng, (32, 512, 768)) \
        .bfloat16()
    pos = np.stack([rng.choice(512, 76, replace=False) for _ in range(32)])
    idx = torch.from_numpy(np.stack([np.repeat(np.arange(32), 76),
                                     pos.reshape(-1)]).astype(np.float32))
    col = torch.from_numpy(rng.randint(0, 768, 32 * 76).astype(np.float32))
    fill = torch.from_numpy(rng.randn(32 * 76).astype(np.float32)) \
        .bfloat16()
    hc, ic, cc, fc = h.cuda(), idx.cuda(), col.cuda(), fill.cuda()
    oc.groups["indexing"] = {"shape": list(h.shape), "dtype": "bfloat16",
                             "positions": 32 * 76}
    g_card, g_cpu = nd.gather_nd(hc, ic), nd.gather_nd(h, idx)
    cases = (
        ("gather_nd", lambda: nd.gather_nd(hc, ic), g_cpu,
         lambda: hc[ic[0].long(), ic[1].long()]),
        ("scatter_nd", lambda: nd.scatter_nd(g_card, ic, (32, 512, 768)),
         nd.scatter_nd(g_cpu, idx, (32, 512, 768)), None),
        ("batch_take", lambda: nd.batch_take(g_card, cc),
         nd.batch_take(g_cpu, col), None),
        ("choose_element_0index",
         lambda: nd.choose_element_0index(g_card, cc),
         nd.choose_element_0index(g_cpu, col), None),
        ("fill_element_0index",
         lambda: nd.fill_element_0index(g_card, fc, cc),
         nd.fill_element_0index(g_cpu, fill, col), None))
    for name, fn, want, lib in cases:
        oc.time("indexing", fn, lib, key=f"{name}_ms",
                lib_key=f"{name}_library_ms")
        oc.check("indexing", name, fn(), want, 0, exact=True)
    oc.groups["indexing"]["ms"] = oc.groups["indexing"]["gather_nd_ms"]
    oc.groups["indexing"]["library_ms"] = \
        oc.groups["indexing"]["gather_nd_library_ms"]


def ops_batch_norm(oc, nd, autograd, rng):
    """BatchNorm (training and inference) and batch_norm_core at ResNet-50's
    stage-1 activation (256 x 56 x 56 x 256 bf16, channels-last,
    ``axis=3``)."""
    torch = oc.torch
    F = torch.nn.functional
    x = (card_draw(torch, rng, (256, 56, 56, 256))
         * 2 + 0.5).bfloat16()
    gamma, beta, mean, var = (torch.from_numpy(a.astype(np.float32)) for a in
                              (rng.uniform(0.5, 1.5, 256), rng.randn(256),
                               rng.randn(256) * 0.1,
                               rng.uniform(0.5, 2.0, 256)))
    args = (x, gamma, beta, mean, var)
    card = tuple(a.cuda() for a in args)
    xn = card[0].permute(0, 3, 1, 2)            # channels-last strides
    oc.groups["batch_norm"] = {"shape": list(x.shape), "dtype": "bfloat16",
                               "axis": 3}
    kw = dict(axis=3, fix_gamma=False)

    def train(a):
        with autograd.train_mode():
            return nd.BatchNorm(*a, **kw)
    run_mean, run_var = card[3].clone(), card[4].clone()   # F updates them
    oc.time("batch_norm", lambda: train(card), lambda: F.batch_norm(
        xn, run_mean, run_var, card[1], card[2], training=True))
    oc.time("batch_norm", lambda: nd.BatchNorm(*card, **kw),
            lambda: F.batch_norm(xn, card[3], card[4], card[1], card[2],
                                 training=False),
            key="inference_ms", lib_key="inference_library_ms")
    oc.time("batch_norm", lambda: nd.batch_norm_core(*card, 1e-5, True, 3),
            key="core_ms", lib_key="core_library_ms")
    # training-mode BatchNorm is batch_norm_core with batch statistics:
    # both are held to the CPU port's one pass over the whole batch; the
    # inference arm, per sample, on the first samples
    k = OPS_CPU_ROWS["batch_norm"]
    oc.groups["batch_norm"]["cpu_inference_batch"] = k
    got = nd.batch_norm_core(*card, 1e-5, True, 3)
    want = nd.batch_norm_core(*args, 1e-5, True, 3)
    oc.check("batch_norm", "training", train(card), want[0], BF16_REL)
    oc.check("batch_norm", "inference", nd.BatchNorm(*card, **kw)[:k],
             nd.BatchNorm(x[:k], *args[1:], **kw), BF16_REL)
    oc.check("batch_norm", "core_out", got[0], want[0], BF16_REL)
    oc.check("batch_norm", "core_mean", got[1], want[1], OPS_STATS_TOL)
    oc.check("batch_norm", "core_var", got[2], want[2], OPS_STATS_TOL)


def ops_batch_norm_two_pass(oc, nd, autograd, rng):
    """Gluon's ``BatchNorm`` in training under ``TPUMX_BN_ONEPASS=0``
    (the reference's two-pass form, fault C21) on the card against the
    CPU port: 32 x 28 x 28 x 64 channels-last at the large-mean input
    (mean 20, spread 0.1), float32 and bfloat16; the output, the running
    statistics and the input, gamma and beta gradients."""
    torch = oc.torch
    from tpu_mx_torch.gluon import nn
    x0 = (20.0 + 0.1 * rng.randn(32, 28, 28, 64)).astype(np.float32)
    head = rng.randn(32, 28, 28, 64).astype(np.float32)
    prev = os.environ.get("TPUMX_BN_ONEPASS")
    os.environ["TPUMX_BN_ONEPASS"] = "0"
    try:
        for dtype, tol in ((torch.float32, BN_TWO_PASS_F32_TOL),
                           (torch.bfloat16, BF16_REL)):
            group = f"batch_norm_two_pass_{str(dtype)[6:]}"
            oc.groups[group] = {"shape": list(x0.shape), "axis": 3,
                                "dtype": str(dtype)[6:],
                                "TPUMX_BN_ONEPASS": "0"}
            runs = {}
            for dev in ("cuda", "cpu"):
                bn = nn.BatchNorm(axis=3, in_channels=64,
                                  generator=torch.Generator())
                bn.to(device=dev, dtype=dtype)
                bn.train()
                x = torch.from_numpy(x0).to(dev, dtype).requires_grad_()
                y = bn(x)
                (y.float() * torch.from_numpy(head).to(dev)).sum().backward()
                runs[dev] = {"out": y, "running_mean":
                             bn._buffers["running_mean"],
                             "running_var": bn._buffers["running_var"],
                             "dx": x.grad,
                             "dgamma": bn._parameters["gamma"].grad,
                             "dbeta": bn._parameters["beta"].grad}
            for name in runs["cpu"]:
                oc.check(group, name, runs["cuda"][name], runs["cpu"][name],
                         tol)
    finally:
        if prev is None:
            os.environ.pop("TPUMX_BN_ONEPASS", None)
        else:
            os.environ["TPUMX_BN_ONEPASS"] = prev


def ops_masked_softmax(oc, nd, rng):
    """masked_softmax / masked_log_softmax at BERT's attention scores (32 x
    12 x 512 x 512 bf16) with the key-padding mask (one sequence fully
    masked), and RMSNorm at 16384 x 768 bf16."""
    torch = oc.torch
    F = torch.nn.functional
    s = card_draw(torch, rng, (32, 12, 512, 512)) \
        .bfloat16()
    valid = rng.randint(384, 513, 32)
    valid[5] = 0
    mask = torch.from_numpy((np.arange(512)[None, :] < valid[:, None])
                            .astype(np.float32)).reshape(32, 1, 1, 512)
    sc, mc = s.cuda(), mask.cuda()
    oc.groups["masked_softmax"] = {"shape": list(s.shape),
                                   "dtype": "bfloat16",
                                   "fully_masked_rows": 12 * 512}
    oc.time("masked_softmax", lambda: nd.masked_softmax(sc, mc))
    oc.time("masked_softmax", lambda: nd.masked_log_softmax(sc, mc),
            key="log_ms", lib_key="log_library_ms")
    k = OPS_CPU_ROWS["masked_softmax"]
    oc.groups["masked_softmax"]["cpu_batch"] = k
    for name, fn in (("masked_softmax", nd.masked_softmax),
                     ("masked_log_softmax", nd.masked_log_softmax)):
        got, want = fn(sc, mc)[:k], fn(s[:k], mask[:k])
        oc.check("masked_softmax", name, got, want, BF16_REL)
        oc.check("masked_softmax", f"{name}_fully_masked", got[5], want[5],
                 0, exact=True)
    del sc, s
    x = card_draw(torch, rng, (16384, 768)).bfloat16()
    g = torch.from_numpy(rng.uniform(0.5, 1.5, 768).astype(np.float32))
    xc, gc = x.cuda(), g.cuda()
    oc.groups["rms_norm"] = {"shape": list(x.shape), "dtype": "bfloat16"}
    oc.time("rms_norm", lambda: nd.RMSNorm(xc, gc),
            (lambda: F.rms_norm(xc, (768,), gc.bfloat16(), 1e-6))
            if hasattr(F, "rms_norm") else None)
    oc.check("rms_norm", "RMSNorm", nd.RMSNorm(xc, gc), nd.RMSNorm(x, g),
             BF16_REL)


def ops_linalg(oc, nd, rng):
    """linalg_gemm2 / linalg_syrk at BERT's attention product (384 x 512 x
    64 by 384 x 64 x 512 bf16), linalg_gemm with a bias, linalg_potrf on
    a 1024 x 1024 f32 SPD matrix."""
    torch = oc.torch
    a = (card_draw(torch, rng, (384, 512, 64)) / 8) \
        .bfloat16()
    b = (card_draw(torch, rng, (384, 64, 512)) / 8) \
        .bfloat16()
    ac, bc = a.cuda(), b.cuda()
    oc.groups["linalg"] = {"shape": [list(a.shape), list(b.shape)],
                           "dtype": "bfloat16"}
    oc.time("linalg", lambda: nd.linalg_gemm2(ac, bc, alpha=0.125),
            lambda: torch.bmm(ac, bc))
    oc.time("linalg", lambda: nd.linalg_syrk(ac),
            lambda: torch.bmm(ac, ac.transpose(1, 2)), key="syrk_ms",
            lib_key="syrk_library_ms")
    k = OPS_CPU_ROWS["linalg"]
    oc.groups["linalg"]["cpu_batch"] = k
    oc.check("linalg", "linalg_gemm2",
             nd.linalg_gemm2(ac, bc, alpha=0.125)[:k],
             nd.linalg_gemm2(a[:k], b[:k], alpha=0.125), BF16_REL)
    oc.check("linalg", "linalg_syrk", nd.linalg_syrk(ac)[:k],
             nd.linalg_syrk(a[:k]), BF16_REL)
    c = torch.from_numpy(rng.randn(64, 64).astype(np.float32))
    a2 = torch.from_numpy(rng.randn(64, 512).astype(np.float32))
    oc.check("linalg", "linalg_gemm",
             nd.linalg_gemm(a2.cuda(), a2.cuda(), c.cuda(), transpose_b=True,
                            beta=0.5),
             nd.linalg_gemm(a2, a2, c, transpose_b=True, beta=0.5),
             OPS_STATS_TOL)
    m = rng.randn(1024, 1024)
    spd = torch.from_numpy((m @ m.T / 1024 + np.eye(1024)).astype(np.float32))
    sc = spd.cuda()
    oc.time("linalg", lambda: nd.linalg_potrf(sc),
            lambda: torch.linalg.cholesky(sc), key="potrf_ms",
            lib_key="potrf_library_ms")
    oc.check("linalg", "linalg_potrf", nd.linalg_potrf(sc),
             nd.linalg_potrf(spd), OPS_STATS_TOL)


def ops_patches(oc, nd, rng):
    """im2col / col2im at ResNet-50's stage-1 input width (32 x 64 x 56 x
    56 f32, 3 x 3, pad 1)."""
    torch = oc.torch
    F = torch.nn.functional
    x = card_draw(torch, rng, (32, 64, 56, 56))
    xc = x.cuda()
    kw = dict(kernel=(3, 3), pad=(1, 1))
    cols_c, cols = nd.im2col(xc, **kw), nd.im2col(x, **kw)
    oc.groups["patches"] = {"shape": list(x.shape), "dtype": "float32",
                            "cols": list(cols.shape)}
    oc.time("patches", lambda: nd.im2col(xc, **kw),
            lambda: F.unfold(xc, (3, 3), padding=1))
    oc.time("patches", lambda: nd.col2im(cols_c, (56, 56), **kw),
            lambda: F.fold(cols_c, (56, 56), (3, 3), padding=1),
            key="col2im_ms", lib_key="col2im_library_ms")
    oc.check("patches", "im2col", cols_c, cols, OPS_F32_TOL)
    oc.check("patches", "col2im", nd.col2im(cols_c, (56, 56), **kw),
             nd.col2im(cols, (56, 56), **kw), OPS_F32_TOL)


def ops_softmax_output(oc, nd, rng):
    """SoftmaxOutput forward and injected gradient at the MLM logits
    (32 x 76 masked positions x 30522, f32), ``normalization="valid"``."""
    torch = oc.torch
    x = card_draw(torch, rng, (32 * 76, 30522))
    y = torch.from_numpy(rng.randint(0, 30522, 32 * 76).astype(np.float32))
    kw = dict(normalization="valid")

    def run(xx, yy):
        xx = xx.detach().requires_grad_(True)
        out = nd.SoftmaxOutput(xx, yy, **kw)
        out.backward(torch.ones_like(out))
        return out.detach(), xx.grad

    xc, yc = x.cuda(), y.cuda()
    oc.groups["softmax_output"] = {"shape": list(x.shape), "dtype": "float32",
                                   "normalization": "valid"}
    oc.time("softmax_output", lambda: nd.SoftmaxOutput(xc, yc, **kw),
            lambda: torch.softmax(xc, -1))
    oc.time("softmax_output", lambda: run(xc, yc), key="fwd_bwd_ms",
            lib_key="fwd_bwd_library_ms")
    # the CPU port on the leading rows: "valid" divides by the rows given,
    # so its gradient is the card's times N / k there
    k = OPS_CPU_ROWS["softmax_output"]
    oc.groups["softmax_output"]["cpu_rows"] = k
    (oc_out, oc_grad), (cpu_out, cpu_grad) = run(xc, yc), run(x[:k], y[:k])
    oc.check("softmax_output", "forward", oc_out[:k], cpu_out, OPS_F32_TOL)
    oc.check("softmax_output", "gradient", oc_grad[:k] * (32 * 76 / k),
             cpu_grad, OPS_F32_TOL)
    onehot = torch.nn.functional.one_hot(yc.long(), 30522).float()
    oc.check("softmax_output", "gradient_is_softmax_minus_onehot_over_count",
             oc_grad, ((oc_out - onehot) / (32 * 76)).cpu(), OPS_F32_TOL)


def ops_ctc(oc, nd, rng):
    """nd.ctc_loss forward and gradient at T=400, N=32, C=29 (a character
    alphabet and the blank), labels 40-120 long padded with -1, data
    lengths 300-400; F.ctc_loss on the same log-probabilities beside it."""
    torch = oc.torch
    F = torch.nn.functional
    t_len, n, c = CTC_SHAPE["T"], CTC_SHAPE["N"], CTC_SHAPE["C"]
    lo, hi = CTC_SHAPE["label_len"]
    acts = torch.from_numpy(rng.randn(t_len, n, c).astype(np.float32))
    lab_len = rng.randint(lo, hi + 1, n)
    lab = np.full((n, hi), -1, np.float32)
    for i, k in enumerate(lab_len):
        lab[i, :k] = rng.randint(1, c, k)
    lab = torch.from_numpy(lab)
    dlen = torch.from_numpy(rng.randint(CTC_SHAPE["data_len"][0],
                                        CTC_SHAPE["data_len"][1] + 1, n)
                            .astype(np.float32))

    def run(a, lb, dl):
        a = a.detach().requires_grad_(True)
        loss = nd.ctc_loss(a, lb, dl, use_data_lengths=True)
        loss.sum().backward()
        return loss.detach(), a.grad

    ac, lc, dc = acts.cuda(), lab.cuda(), dlen.cuda()
    logp = F.log_softmax(ac, -1)
    targets = lc.clamp(min=0).long()
    tl = torch.from_numpy(lab_len).cuda()

    def library():
        return F.ctc_loss(logp, targets, dc.long(), tl, blank=0,
                          reduction="none", zero_infinity=False)

    def library_fb():
        lp = logp.detach().requires_grad_(True)
        F.ctc_loss(lp, targets, dc.long(), tl, blank=0,
                   reduction="sum").backward()
    g = oc.groups["ctc"] = dict(CTC_SHAPE, label_lengths=[int(v) for v in
                                                          lab_len])
    oc.time("ctc", lambda: nd.ctc_loss(ac, lc, dc, use_data_lengths=True),
            library)
    oc.time("ctc", lambda: run(ac, lc, dc), library_fb, key="fwd_bwd_ms",
            lib_key="fwd_bwd_library_ms")
    (l_card, g_card), (l_cpu, g_cpu) = run(ac, lc, dc), run(acts, lab, dlen)
    rel = float(((l_card.cpu() - l_cpu).abs() / l_cpu.abs()).max())
    grel = float((g_card.cpu() - g_cpu).norm() / g_cpu.norm())
    lib_rel = float(((library().cpu() - l_cpu).abs() / l_cpu.abs()).max())
    g.update(loss_max_rel_err=rel, grad_rel_err_in_norm=grel,
             library_loss_max_rel_diff=lib_rel,
             cpu_max_abs_err=float((l_card.cpu() - l_cpu).abs().max()),
             loss_mean=float(l_cpu.mean()))
    g["checks"] = {"loss": rel <= CTC_LOSS_RTOL,
                   "gradient": grel <= CTC_GRAD_RTOL,
                   "on_the_card": l_card.device.type == "cuda",
                   "agrees_with_F_ctc_loss": lib_rel <= CTC_LOSS_RTOL}
    oc.failures += [f"operators ctc: {k}" for k, ok in g["checks"].items()
                    if not ok]


def ops_rest(oc, nd, mx, rng):
    """Every other name of the slice on 2**24 float32 elements (4096 x
    4096, or a shape of that size), card against CPU within 1e-5 of
    max|ref|; the samplers' means within 5 standard errors; the
    deprecated aliases and a registered custom operator."""
    import warnings
    torch = oc.torch
    sq = (4096, 4096)
    x, y = card_draw(torch, rng, sq), card_draw(torch, rng, sq)
    pos = card_draw(torch, rng, sq, 0.5, 3.0)
    unit = card_draw(torch, rng, sq, 0.05, 0.95)
    near1 = 1 + 1e-3 * card_draw(torch, rng, sq)
    nan = x.clone()
    nan[card_draw(torch, rng, sq, 0.0, 1.0) < 0.01] = math.nan
    ties = card_draw(torch, rng, sq, 0.0, 3.0).floor()
    img = card_draw(torch, rng, (64, 64, 64, 64))
    w = torch.from_numpy(rng.randn(64, 64, 3, 3).astype(np.float32) / 24)
    lab = torch.from_numpy(rng.randint(0, 4096, 4096).astype(np.float32))
    flat = torch.from_numpy(rng.randint(0, 1 << 24, 1 << 20)
                            .astype(np.float32))
    coords = torch.from_numpy(np.stack([rng.randint(-2, 4100, 1 << 20),
                                        rng.randint(-2, 4100, 1 << 20)])
                              .astype(np.float32))
    krm = [torch.from_numpy(rng.randn(r, 1024).astype(np.float32))
           for r in (128, 128)]
    bn = [torch.from_numpy(a.astype(np.float32)) for a in
          (rng.uniform(0.5, 1.5, 64), rng.randn(64), rng.randn(64) * 0.1,
           rng.uniform(0.5, 2.0, 64))]
    cases = [
        ("arctan2", lambda a: nd.arctan2(a[0], a[1]), (x, y), 2),
        ("broadcast_hypot", lambda a: nd.broadcast_hypot(a[0], a[1][:1]),
         (x, y), 2),
        ("broadcast_logical_and",
         lambda a: nd.broadcast_logical_and(a[0], a[1][:1]), (ties, ties), 2),
        ("broadcast_logical_or",
         lambda a: nd.broadcast_logical_or(a[0], a[1][:1]), (ties, ties), 2),
        ("broadcast_logical_xor",
         lambda a: nd.broadcast_logical_xor(a[0], a[1][:1]), (ties, ties), 2),
        ("cumsum", lambda a: nd.cumsum(a[0], axis=1), (x,), 1),
        ("nansum", lambda a: nd.nansum(a[0], axis=1), (nan,), 1),
        ("nanprod", lambda a: nd.nanprod(a[0], axis=1), (near1,), 1),
        ("erfcinv", lambda a: nd.erfcinv(a[0] * 2), (unit,), 1),
        ("polygamma", lambda a: nd.polygamma(1, a[0]), (pos,), 1),
        ("gammainc", lambda a: nd.gammainc(a[0], a[1]), (pos, pos.T), 2),
        ("nextafter", lambda a: nd.nextafter(a[0], a[1]), (x, y), 2),
        ("moments", lambda a: nd.moments(a[0], axes=(1,))[1], (x,), 1),
        ("khatri_rao", lambda a: nd.khatri_rao(a[0], a[1]), krm),
        ("multi_all_finite", lambda a: nd.multi_all_finite(a[0], a[1]),
         (x, nan)),
        ("all_finite", lambda a: nd.all_finite(a[0]), (x,)),
        ("amp_cast", lambda a: nd.amp_cast(a[0], "bfloat16").float(), (x,), 1),
        ("amp_multicast", lambda a: nd.amp_multicast(
            a[0].bfloat16(), a[1])[0], (x, y), 2),
        ("eye", lambda a: nd.eye(4096, ctx=mx.gpu(0) if a[0].is_cuda
                                 else mx.cpu()), (x,)),
        ("linspace", lambda a: nd.linspace(-3.0, 5.0, 1 << 24,
                                           ctx=mx.gpu(0) if a[0].is_cuda
                                           else mx.cpu()), (x,)),
        ("diag", lambda a: nd.diag(a[0], k=3), (x,)),
        ("slice", lambda a: nd.slice(a[0], (1, 0), (4000, None), (3, 2)),
         (x,)),
        ("slice_like", lambda a: nd.slice_like(a[0], a[1][:100, :200]),
         (x, y)),
        ("Crop", lambda a: nd.Crop(a[0], h_w=(40, 50), center_crop=True),
         (img,), 1),
        ("broadcast_axis", lambda a: nd.broadcast_axis(a[0][:1], axis=0,
                                                       size=4096), (x,)),
        ("broadcast_axes", lambda a: nd.broadcast_axes(a[0][:, :1], axis=1,
                                                       size=4096), (x,)),
        ("ravel_multi_index", lambda a: nd.ravel_multi_index(
            a[0], shape=(4096, 4096)), (coords,)),
        ("unravel_index", lambda a: nd.unravel_index(
            a[0], shape=(4096, 4096)), (flat,)),
        ("shape_array", lambda a: nd.shape_array(a[0]), (x,)),
        ("size_array", lambda a: nd.size_array(a[0]), (x,)),
        ("LRN", lambda a: nd.LRN(a[0], nsize=5), (img,), 1),
        ("SoftmaxActivation", lambda a: nd.SoftmaxActivation(
            a[0], mode="channel"), (img,), 1),
        ("SVMOutput", lambda a: _head_grad(torch, nd.SVMOutput, a[0], a[1]),
         (x, lab)),
        ("LinearRegressionOutput", lambda a: _head_grad(
            torch, nd.LinearRegressionOutput, a[0], a[1]), (x, y)),
        ("MAERegressionOutput", lambda a: _head_grad(
            torch, nd.MAERegressionOutput, a[0], a[1]), (x, y)),
        ("LogisticRegressionOutput", lambda a: _head_grad(
            torch, nd.LogisticRegressionOutput, a[0], a[1]), (x, unit)),
        ("MakeLoss", lambda a: _head_grad(
            torch, lambda v, _: nd.MakeLoss(v, normalization="valid"),
            a[0], None), (x,)),
        ("make_loss", lambda a: _head_grad(
            torch, lambda v, _: nd.make_loss(v * 1.0), a[0], None), (x,)),
        ("IdentityAttachKLSparseReg", lambda a: _head_grad(
            torch, lambda v, _: nd.IdentityAttachKLSparseReg(v), a[0], None),
         (unit,)),
        ("BatchNorm_v1", lambda a: nd.BatchNorm_v1(a[0], *a[1:]),
         (img, *bn), 1),
        ("Convolution_v1", lambda a: nd.Convolution_v1(
            a[0], a[1], kernel=(3, 3), pad=(1, 1), no_bias=True), (img, w), 1),
        ("Pooling_v1", lambda a: nd.Pooling_v1(a[0], kernel=(2, 2),
                                               stride=(2, 2)), (img,), 1),
        ("Softmax", lambda a: nd.Softmax(a[0], a[1]), (x, lab), 2),
    ]
    g = oc.groups["rest"] = {"elements": OPS_REST, "names": {},
                             "cpu_rows": OPS_CPU_ROWS["rest_rows"],
                             "cpu_images": OPS_CPU_ROWS["rest_images"]}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        for name, fn, args, *cut in cases:
            card = tuple(a.cuda() for a in args)
            tol = OPS_STATS_TOL if name in ("Convolution_v1", "gammainc",
                                            "polygamma", "khatri_rao",
                                            "moments") else OPS_F32_TOL
            ms = cuda_ms(torch, lambda: fn(card), reps=OPS_REPS)
            got = _tensor(fn(card)).float()
            if cut:     # rows treated apart: the CPU on the leading ones
                k = OPS_CPU_ROWS["rest_images" if args[0].dim() == 4
                                 else "rest_rows"]
                args = tuple(a[:k] if i < cut[0] else a
                             for i, a in enumerate(args))
                got = got[:k]
            ok = oc.check("rest", name, got, _tensor(fn(args)).float(), tol)
            g["names"][name] = dict(ms=ms, ok=ok, cpu_rows=k if cut else None)
    # the samplers' means on the card, 2**24 draws each
    mx.random.seed(0)
    n = OPS_REST
    draws = [("random_randint", lambda: nd.random_randint(2, 9, shape=(n,)),
              5.0, 4.0, lambda d: ((d >= 2) & (d < 9)).all()),
             ("random_gamma", lambda: nd.random_gamma(3.0, 0.5, shape=(n,)),
              1.5, 0.75, lambda d: (d > 0).all()),
             ("random_exponential",
              lambda: nd.random_exponential(2.0, shape=(n,)), 2.0, 4.0,
              lambda d: (d >= 0).all()),
             ("random_poisson", lambda: nd.random_poisson(4.0, shape=(n,)),
              4.0, 4.0, lambda d: ((d >= 0) & (d == d.round())).all()),
             ("random_bernoulli",
              lambda: nd.random_bernoulli(0.3, shape=(n,)), 0.3, 0.21,
              lambda d: ((d == 0) | (d == 1)).all()),
             ("randn", lambda: nd.randn(n), 0.0, 1.0, lambda d: True),
             ("normal_array_loc", lambda: nd.random.normal(
                 loc=nd.zeros((n,)), scale=2.0, shape=(n,)), 0.0, 4.0,
              lambda d: True)]
    for name, fn, mean, var, support in draws:
        ms = cuda_ms(torch, fn, reps=OPS_REPS)
        d = _tensor(fn()).double()
        z = abs(float(d.mean()) - mean) / math.sqrt(var / n)
        ok = d.device.type == "cuda" and bool(support(d)) and z <= 5.0
        g["names"][name] = dict(ms=ms, ok=ok, mean_z=z)
        if not ok:
            oc.failures.append(f"operators rest: {name} (z {z})")
    xc = x.cuda()
    xc[:, 0] = torch.arange(4096, device="cuda")     # each row's own id
    perm = nd.shuffle(xc)
    ok = perm.device.type == "cuda" and bool(torch.equal(
        perm, xc[perm[:, 0].long()])) and bool(torch.equal(
            perm[:, 0].sort().values, xc[:, 0]))
    g["names"]["shuffle"] = dict(ms=cuda_ms(torch, lambda: nd.shuffle(xc),
                                            reps=OPS_REPS), ok=ok)
    if not ok:
        oc.failures.append("operators rest: shuffle")
    g["names"]["Custom"] = ops_custom(oc, nd, mx, x)
    g["ms"] = sum(v["ms"] for v in g["names"].values())
    g["library_ms"] = None


# the slice of ROADMAP A item 10 (a, b): public configurations that use
# these operators.  Faster R-CNN's RPN and ROI head as MXNet's
# example/rcnn ships it with VGG-16 (conv5_3 at 1/16 of a 600 x 1000
# image), R-FCN's position-sensitive head, Deformable ConvNets' res5
# deformable convolution and deformable R-FCN pooling, FlowNetC's
# correlation, an ImageNet spatial transformer
VISION = dict(feat=(1, 512, 38, 63), image=(600.0, 1000.0), stride=16,
              scales=(8, 16, 32), ratios=(0.5, 1, 2), pre_nms=6000,
              post_nms=300, nms=0.7, pooled=7, sample_ratio=2,
              rfcn_dim=21, rfcn_group=7, trans_std=0.1, sample_per_part=4,
              flow=(1, 256, 48, 64), flow_disp=20, flow_stride2=2,
              flow_pad=20, stn=(8, 3, 224, 224), upsample=(1, 256, 38, 63))
OPS_GRAD_RTOL = 1e-2            # card against CPU gradients, in norm
OPS_FAMILY_REPS = 5             # cuda_ms medians of the item-10 groups
OPS_CPU_ROIS = 32               # ROIs the CPU port pools (rows apart)
LINALG_FAMILY = dict(batch=8, n=1024, rhs=256, eig=512, lq=(512, 1024),
                     cpu_batch=2)
SAMPLER_PARAMS = 16             # parameter entries; 2**20 draws each


def _fwd_bwd(torch, fn, args, diff, seed=7):
    """``fn(*args)`` and the gradients of ``args[i]`` (``i`` in
    ``diff``) from one fixed random head gradient."""
    xs = [a.detach().requires_grad_(True) if i in diff else a
          for i, a in enumerate(args)]
    out = fn(*xs)
    head = torch.randn(out.shape, generator=torch.Generator().manual_seed(
        seed)).to(out.device)
    grads = torch.autograd.grad(out, [xs[i] for i in diff], head)
    return out.detach(), grads


def _grad_check(oc, group, name, card, cpu):
    """Each gradient within OPS_GRAD_RTOL of the CPU port's, in norm."""
    errs = [float((c.detach().cpu().double() - h.double()).norm()
                  / max(float(h.double().norm()), 1e-30))
            for c, h in zip(card, cpu)]
    ok = all(e <= OPS_GRAD_RTOL for e in errs) and \
        all(c.device.type == "cuda" for c in card)
    g = oc.groups[group]
    g.setdefault("checks", {})[name + "_grad"] = ok
    g.setdefault("grad_rel_err_in_norm", {})[name] = errs
    if not ok:
        oc.failures.append(f"operators {group}: {name} gradient {errs}")
    return ok


def _timed_nms(torch, contrib, run):
    """``run()`` with ``contrib._nms_keep`` timed by CUDA events (the
    greedy loop inside ``Proposal``): the median ms over 3 calls."""
    real, times = contrib._nms_keep, []

    def timed(*a, **k):
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        out = real(*a, **k)
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
        return out
    contrib._nms_keep = timed
    try:
        for _ in range(3):
            run()
    finally:
        contrib._nms_keep = real
    return statistics.median(times)


def ops_vision(oc, nd, rng):
    """The vision family at Faster R-CNN's, R-FCN's, Deformable ConvNets'
    and FlowNetC's shapes (``VISION``), card against the CPU port: the
    proposals in full, the ROI operators on the CPU's leading
    ``OPS_CPU_ROIS`` of the 300 ROIs (forward and gradient), the rest in
    full with their gradients."""
    from tpu_mx_torch.ndarray import contrib
    torch = oc.torch
    F = torch.nn.functional
    v = VISION
    g = oc.groups["vision"] = {"config": {k: list(x) if isinstance(
        x, tuple) else x for k, x in v.items()}, "names": {},
        "cpu_rois": OPS_CPU_ROIS}
    n_a = len(v["scales"]) * len(v["ratios"])
    _, c, hf, wf = v["feat"]
    feat = card_draw(torch, rng, v["feat"])
    cls = card_draw(torch, rng, (1, 2 * n_a, hf, wf), 0.0, 1.0)
    deltas = card_draw(torch, rng, (1, 4 * n_a, hf, wf)) * 0.1
    im_info = torch.tensor([[v["image"][0], v["image"][1], 1.0]])
    prop = dict(rpn_pre_nms_top_n=v["pre_nms"],
                rpn_post_nms_top_n=v["post_nms"], threshold=v["nms"],
                scales=v["scales"], ratios=v["ratios"],
                feature_stride=v["stride"], output_score=True)
    card_in = (cls.cuda(), deltas.cuda(), im_info.cuda())

    def proposal():
        return nd.Proposal(*card_in, **prop)
    ms = cuda_ms(torch, proposal, reps=3, warm=1)
    nms_ms = _timed_nms(torch, contrib, proposal)
    rois_c, score_c = proposal()
    rois_h, score_h = nd.Proposal(cls, deltas, im_info, **prop)
    ok = oc.check("vision", "Proposal", rois_c, rois_h, OPS_STATS_TOL)
    ok &= oc.check("vision", "Proposal_score", score_c, score_h,
                   OPS_STATS_TOL)
    g["names"]["Proposal"] = dict(ms=ms, nms_ms=nms_ms, ok=ok,
                                  kept=int((score_h > 0).sum()))
    rois = rois_h.reshape(-1, 5)             # the same ROIs on both sides
    k = OPS_CPU_ROIS
    featc, roisc = feat.cuda(), rois.cuda()
    psfeat = card_draw(torch, rng, (1, v["rfcn_dim"] * v["rfcn_group"] ** 2,
                                    hf, wf))
    trans = card_draw(torch, rng, (v["post_nms"], 2, v["pooled"],
                                   v["pooled"]))
    dc_off = card_draw(torch, rng, (1, 18, hf, wf)) * 2.0
    dc_w = card_draw(torch, rng, (c, c, 3, 3)) / math.sqrt(9 * c)
    f1 = card_draw(torch, rng, v["flow"])
    f2 = card_draw(torch, rng, v["flow"])
    img = card_draw(torch, rng, v["stn"])
    loc = torch.tensor([[1.0, 0.0, 0.0, 0.0, 1.0, 0.0]]).repeat(
        v["stn"][0], 1) + 0.05 * card_draw(torch, rng, (v["stn"][0], 6))
    up = card_draw(torch, rng, v["upsample"])
    s16 = 1.0 / v["stride"]
    pk = v["pooled"]
    cases = [
        # name, fn, inputs, differentiable inputs, ROIs treated apart,
        # one PyTorch call computing the same function (or None)
        ("ROIPooling", lambda x, r: nd.ROIPooling(
            x, r, pooled_size=(pk, pk), spatial_scale=s16), (feat, rois),
         (0,), True, None),
        ("ROIAlign", lambda x, r: nd.ROIAlign(
            x, r, pooled_size=(pk, pk), spatial_scale=s16,
            sample_ratio=v["sample_ratio"]), (feat, rois), (0, 1), True,
         None),
        ("PSROIPooling", lambda x, r: nd.PSROIPooling(
            x, r, spatial_scale=s16, output_dim=v["rfcn_dim"],
            pooled_size=pk, group_size=v["rfcn_group"]), (psfeat, rois),
         (0,), True, None),
        ("DeformablePSROIPooling", lambda x, r, t: nd.DeformablePSROIPooling(
            x, r, t, spatial_scale=s16, output_dim=v["rfcn_dim"],
            group_size=v["rfcn_group"], pooled_size=pk, part_size=pk,
            sample_per_part=v["sample_per_part"], trans_std=v["trans_std"]),
         (psfeat, rois, trans), (0, 2), True, None),
        ("DeformableConvolution", lambda x, o, w: nd.contrib
         .DeformableConvolution(x, o, w, kernel=(3, 3), pad=(1, 1),
                                num_filter=c, no_bias=True),
         (feat, dc_off, dc_w), (0, 1, 2), False, None),
        ("Correlation", lambda a, b: nd.Correlation(
            a, b, kernel_size=1, max_displacement=v["flow_disp"],
            stride2=v["flow_stride2"], pad_size=v["flow_pad"]), (f1, f2),
         (0, 1), False, None),
        ("SpatialTransformer", lambda x, t: nd.SpatialTransformer(
            x, t, target_shape=v["stn"][2:]), (img, loc), (0, 1), False,
         lambda x, t: F.grid_sample(x, F.affine_grid(
             t.reshape(-1, 2, 3), list(x.shape), align_corners=True),
             align_corners=True)),
        ("UpSampling", lambda x: nd.UpSampling(x, scale=2), (up,), (0,),
         False, lambda x: F.interpolate(x, scale_factor=2)),
        ("BilinearResize2D", lambda x: nd.BilinearResize2D(
            x, height=hf // 2, width=wf // 2), (up,), (0,), False,
         lambda x: F.interpolate(x, size=(hf // 2, wf // 2),
                                 mode="bilinear", antialias=True)),
    ]
    for name, fn, args, diff, apart, library in cases:
        card = tuple(a.cuda() for a in args)
        ms = cuda_ms(torch, lambda: fn(*card), reps=OPS_FAMILY_REPS)
        fb_ms = cuda_ms(torch, lambda: _fwd_bwd(torch, fn, card, diff),
                        reps=OPS_FAMILY_REPS)
        lib_ms = None if library is None else cuda_ms(
            torch, lambda: library(*card), reps=OPS_FAMILY_REPS)
        # rows apart: the CPU's leading ROIs, on the card too for the
        # gradient (a feature map's gradient sums over every ROI)
        cut = tuple(a[:k] if apart and a.shape[0] == rois.shape[0] else a
                    for a in args)
        got = fn(*card)
        want = fn(*cut)
        ok = oc.check("vision", name, got[:k] if apart else got, want,
                      OPS_STATS_TOL)
        out_c, g_c = _fwd_bwd(torch, fn, tuple(a.cuda() for a in cut), diff)
        out_h, g_h = _fwd_bwd(torch, fn, cut, diff)
        ok &= _grad_check(oc, "vision", name, g_c, g_h)
        g["names"][name] = dict(ms=ms, fwd_bwd_ms=fb_ms, library_ms=lib_ms,
                                ok=ok, shape=[list(a.shape) for a in args])
        torch.cuda.empty_cache()
    g["ms"] = sum(x["ms"] for x in g["names"].values())
    g["library_ms"] = None


def ops_linalg_family(oc, nd, rng):
    """``linalg_*`` on 8 SPD float32 matrices of 1024 x 1024 (A·Aᵀ/n + I,
    drawn on the card): potri of their Cholesky factors, trsm and trmm
    against 256 columns, inverse, slogdet; syevd at 512, gelqf at 512 x
    1024.  The CPU port takes the leading ``cpu_batch`` matrices (each
    matrix apart).  syevd's eigenvalues are held to the CPU port's; its
    eigenvectors (each sign free, and mixed within close eigenvalues
    by any float32 solver) by the residual ``max|Uᵀ·diag(λ)·U - A|`` on
    the card within ``n·eps·max|λ|``; the eigenvalues' distances from
    float64 (the port's, the CPU port's, cuSOLVER's float32 solver's)
    are printed."""
    torch = oc.torch
    cfg = LINALG_FAMILY
    b, n, kb = cfg["batch"], cfg["n"], cfg["cpu_batch"]
    gen = torch.Generator(device="cuda").manual_seed(int(rng.randint(1 << 31)))
    m = torch.randn((b, n, n), generator=gen, device="cuda",
                    dtype=torch.float64)
    spd_c = (m @ m.mT / n + torch.eye(n, device="cuda",
                                      dtype=torch.float64)).float()
    low_c = torch.linalg.cholesky(spd_c.double()).float()
    rhs_c = torch.randn((b, n, cfg["rhs"]), generator=gen, device="cuda")
    e = cfg["eig"]
    sym_c = torch.randn((b, e, e), generator=gen, device="cuda")
    sym_c = (sym_c + sym_c.mT) / 2
    lq_c = torch.randn((b,) + cfg["lq"], generator=gen, device="cuda")
    g = oc.groups["linalg_family"] = dict(cfg, names={}, dtype="float32")
    cases = [
        ("linalg_potri", nd.linalg_potri, (low_c,), (0,),
         lambda a: torch.cholesky_inverse(a)),
        ("linalg_trsm", nd.linalg_trsm, (low_c, rhs_c), (0, 1),
         lambda a, r: torch.linalg.solve_triangular(a, r, upper=False)),
        ("linalg_trmm", lambda a, r: nd.linalg_trmm(a, r, alpha=0.5),
         (low_c, rhs_c), (0, 1), lambda a, r: torch.matmul(a, r)),
        ("linalg_inverse", nd.linalg_inverse, (spd_c,), (0,),
         torch.linalg.inv),
        ("linalg_slogdet", lambda a: nd.linalg_slogdet(a)[1], (spd_c,), (0,),
         torch.linalg.slogdet),
        ("linalg_gelqf", lambda a: torch.cat(
            [x.flatten(1) for x in nd.linalg_gelqf(a)], 1), (lq_c,), (),
         lambda a: torch.linalg.qr(a.mT)),
        ("linalg_syevd", lambda a: nd.linalg_syevd(a)[1], (sym_c,), (),
         lambda a: torch.linalg.eigh(a)),
    ]
    for name, fn, args, diff, library in cases:
        ms = cuda_ms(torch, lambda: fn(*args), reps=OPS_FAMILY_REPS)
        lib_ms = None if library is None else cuda_ms(
            torch, lambda: library(*args), reps=OPS_FAMILY_REPS)
        cut_c = tuple(a[:kb] for a in args)
        cut_h = tuple(a.cpu() for a in cut_c)
        ok = oc.check("linalg_family", name, fn(*args)[:kb], fn(*cut_h),
                      OPS_STATS_TOL)
        if diff:
            _, g_c = _fwd_bwd(torch, fn, cut_c, diff)
            _, g_h = _fwd_bwd(torch, fn, cut_h, diff)
            ok &= _grad_check(oc, "linalg_family", name, g_c, g_h)
        g["names"][name] = dict(ms=ms, library_ms=lib_ms, ok=ok)
    # syevd's eigenvectors (each sign free) by the residual of the
    # reconstruction on the card, within LAPACK's backward-error scale
    # n·eps·max|λ|, the CPU port's residual beside it; the eigenvalues'
    # distance from float64, the port's (float64 inside) and cuSOLVER's
    # float32 solver's
    def residual(a):
        u, lam = nd.linalg_syevd(a)
        return float((u.mT @ (lam[..., None] * u) - a).abs().max()), \
            float(lam.abs().max())
    res_c, lam_max = residual(sym_c)
    res_h, _ = residual(sym_c[:kb].cpu())
    bound = e * torch.finfo(torch.float32).eps * lam_max
    ok = res_c <= bound
    w64 = torch.linalg.eigvalsh(sym_c.double())
    g["names"]["linalg_syevd"].update(
        residual=res_c, cpu_residual=res_h, residual_bound=bound,
        eig_err_vs_f64=float((nd.linalg_syevd(sym_c)[1].double() - w64)
                             .abs().max()),
        library_f32_eig_err_vs_f64=float(
            (torch.linalg.eigvalsh(sym_c).double() - w64).abs().max()),
        cpu_eig_err_vs_f64=float((nd.linalg_syevd(sym_c[:kb].cpu())[1]
                                  .double() - w64[:kb].cpu()).abs().max()),
        ok=ok and g["names"]["linalg_syevd"]["ok"])
    g.setdefault("checks", {})["linalg_syevd_residual"] = ok
    if not ok:
        oc.failures.append(f"operators linalg_family: syevd residual "
                           f"{res_c} (bound {bound})")
    g["ms"] = sum(x["ms"] for x in g["names"].values())
    g["library_ms"] = None
    torch.cuda.empty_cache()


def _z(d, mean, var):
    return abs(float(d.double().mean()) - mean) / math.sqrt(var / d.numel())


def ops_samplers(oc, nd, mx, rng):
    """Every sampler of the slice on the card, 2**24 draws each: the
    ``sample_*`` family with 16 parameter entries (broadcast pairs) and
    2**20 draws an entry, the two negative-binomial ``random_*`` draws
    and ``mx.np.random``; each held by support and each mean within 5
    standard errors (the card's generator is not the CPU's)."""
    torch = oc.torch
    n_par, n_each = SAMPLER_PARAMS, OPS_REST // SAMPLER_PARAMS
    p1 = torch.linspace(0.5, 4.0, n_par, device="cuda")
    p2 = torch.linspace(0.2, 1.0, n_par, device="cuda")
    mx.random.seed(0)
    g = oc.groups["samplers"] = {"draws": OPS_REST, "names": {}}
    fam = [
        ("sample_uniform", lambda: nd.sample_uniform(p1 - 3, p1, shape=n_each),
         (p1 - 3 + p1) / 2, (p1 - p1 + 3) ** 2 / 12, lambda d: True),
        ("sample_normal", lambda: nd.sample_normal(p1, p2, shape=n_each),
         p1, p2 ** 2, lambda d: True),
        ("sample_gamma", lambda: nd.sample_gamma(p1, p2, shape=n_each),
         p1 * p2, p1 * p2 ** 2, lambda d: bool((d > 0).all())),
        ("sample_exponential", lambda: nd.sample_exponential(
            p1, shape=n_each), 1 / p1, 1 / p1 ** 2,
         lambda d: bool((d >= 0).all())),
        ("sample_poisson", lambda: nd.sample_poisson(p1, shape=n_each),
         p1, p1, lambda d: bool(((d >= 0) & (d == d.round())).all())),
        ("sample_negative_binomial", lambda: nd.sample_negative_binomial(
            p1, p2 * 0.8 + 0.1, shape=n_each),
         p1 * (0.9 - p2 * 0.8) / (p2 * 0.8 + 0.1),
         p1 * (0.9 - p2 * 0.8) / (p2 * 0.8 + 0.1) ** 2,
         lambda d: bool(((d >= 0) & (d == d.round())).all())),
        ("sample_generalized_negative_binomial",
         lambda: nd.sample_generalized_negative_binomial(
             p1, p2, shape=n_each), p1, p1 + p2 * p1 ** 2,
         lambda d: bool(((d >= 0) & (d == d.round())).all())),
    ]
    for name, fn, mean, var, support in fam:
        ms = cuda_ms(torch, fn, reps=OPS_FAMILY_REPS)
        d = fn()
        z = max(_z(d[i], float(mean[i]), float(var[i]))
                for i in range(n_par))
        ok = d.device.type == "cuda" and d.shape == (n_par, n_each) and \
            support(d) and z <= CHI2_Z
        g["names"][name] = dict(ms=ms, ok=ok, max_mean_z=z)
    nb = [("random_negative_binomial", lambda: nd.random_negative_binomial(
        3, 0.4, shape=(OPS_REST,)), 4.5, 11.25),
        ("random_generalized_negative_binomial",
         lambda: nd.random_generalized_negative_binomial(
             2.0, 0.5, shape=(OPS_REST,)), 2.0, 4.0)]
    for name, fn, mean, var in nb:
        ms = cuda_ms(torch, fn, reps=OPS_FAMILY_REPS)
        d = fn()._data
        z = _z(d, mean, var)
        ok = d.device.type == "cuda" and bool((d >= 0).all()) and z <= CHI2_Z
        g["names"][name] = dict(ms=ms, ok=ok, mean_z=z)
    r = mx.np.random
    npr = [
        ("np.random.uniform", lambda: r.uniform(-1, 3, OPS_REST), 1.0, 4 / 3),
        ("np.random.normal", lambda: r.normal(2, 0.5, OPS_REST), 2.0, 0.25),
        ("np.random.randint", lambda: r.randint(3, 10, OPS_REST), 6.0, 4.0),
        ("np.random.beta", lambda: r.beta(2, 3, OPS_REST), 0.4, 0.04),
        ("np.random.gamma", lambda: r.gamma(2.5, 2, OPS_REST), 5.0, 10.0),
        ("np.random.exponential", lambda: r.exponential(1.5, OPS_REST), 1.5,
         2.25),
        ("np.random.poisson", lambda: r.poisson(3.5, OPS_REST), 3.5, 3.5),
        ("np.random.binomial", lambda: r.binomial(10, 0.3, OPS_REST), 3.0,
         2.1),
        ("np.random.chisquare", lambda: r.chisquare(3, OPS_REST), 3.0, 6.0),
        ("np.random.geometric", lambda: r.geometric(0.25, OPS_REST), 4.0,
         12.0),
        ("np.random.gumbel", lambda: r.gumbel(1, 2, OPS_REST),
         1 + 2 * 0.5772156649015329, math.pi ** 2 / 6 * 4),
        ("np.random.laplace", lambda: r.laplace(-1, 0.5, OPS_REST), -1.0,
         0.5),
        ("np.random.logistic", lambda: r.logistic(0.5, 1.5, OPS_REST), 0.5,
         math.pi ** 2 / 3 * 2.25),
        ("np.random.lognormal", lambda: r.lognormal(0, 0.5, OPS_REST),
         math.exp(0.125), (math.exp(0.25) - 1) * math.exp(0.25)),
        ("np.random.pareto", lambda: r.pareto(5, OPS_REST), 0.25, 5 / 48),
        ("np.random.power", lambda: r.power(3, OPS_REST), 0.75, 3 / 80),
        ("np.random.rayleigh", lambda: r.rayleigh(2, OPS_REST),
         2 * math.sqrt(math.pi / 2), (4 - math.pi) / 2 * 4),
        ("np.random.weibull", lambda: r.weibull(2, OPS_REST),
         math.gamma(1.5), 1 - math.gamma(1.5) ** 2),
    ]
    for name, fn, mean, var in npr:
        ms = cuda_ms(torch, fn, reps=OPS_FAMILY_REPS)
        d = fn()._data
        z = _z(d, mean, var)
        ok = d.device.type == "cuda" and d.numel() == OPS_REST and \
            bool(torch.isfinite(d.double()).all()) and z <= CHI2_Z
        g["names"][name] = dict(ms=ms, ok=ok, mean_z=z)
    for name, x in g["names"].items():
        if not x["ok"]:
            oc.failures.append(f"operators samplers: {name} ({x})")
    g["ms"] = sum(x["ms"] for x in g["names"].values())
    g["library_ms"] = None


def ops_contrib_np(oc, nd, mx, rng):
    """The rest of ``nd.contrib`` and a cut of ``mx.np`` at the repo's
    model shapes, card against the CPU port, forward and (where they
    differentiate) gradient: ``boolean_mask`` over BERT's 32 x 512 x 768
    activations at its 15% masked positions, ``fft``/``ifft`` at 2**20,
    ``foreach`` and ``while_loop`` over BERT-width states, ``hawkesll``
    over 256 sequences of 256 events, ``AdaptiveAvgPooling2D`` at
    ResNet-50's head, ``index_copy`` into BERT's embedding table, the
    elementwise names and ``mx.np`` on BERT-base's hidden activations
    (32 x 512 positions of 768), ``count_sketch`` at MCB's 2048 -> 16000
    over a batch of 32."""
    torch = oc.torch
    F = torch.nn.functional
    C, npm = nd.contrib, mx.np
    act = card_draw(torch, rng, (32 * 512, 768))
    x = act
    masked = torch.from_numpy((rng.rand(32 * 512) < 0.15).astype(
        np.float32))
    sig = card_draw(torch, rng, (1 << 20,))
    sig2 = card_draw(torch, rng, (1 << 21,))
    seq = card_draw(torch, rng, (128, 32, 768)) * 0.1
    h0 = card_draw(torch, rng, (32, 768)) * 0.1
    head = card_draw(torch, rng, (32, 2048, 7, 7))
    table = card_draw(torch, rng, (30522, 768))
    rows = torch.from_numpy(rng.choice(30522, 2458, replace=False).astype(
        np.float32))
    new = card_draw(torch, rng, (2458, 768))
    hk = [torch.from_numpy(a) for a in _hawkes_arrays(rng, 256, 32, 256)]
    pooled = card_draw(torch, rng, (32, 2048))
    sketch_h = torch.from_numpy(rng.randint(0, 16000, 2048).astype(
        np.float32))
    sketch_s = torch.from_numpy(np.sign(rng.randn(2048)).astype(np.float32))
    spd = card_draw(torch, rng, (512, 512))
    spd = spd @ spd.T / 512 + torch.eye(512)
    ints = (act * 100).floor()

    def body(xt, st):
        s = torch.tanh(xt + st[0])
        return s, [s]

    def loop_cond(i, s):
        return i < 48

    def loop_fn(i, s):
        s2 = torch.tanh(s) * 0.5 + 0.1
        return s2, [i + 1, s2]

    cases = [
        # name, fn, inputs, differentiable inputs, library (or None)
        ("boolean_mask", lambda a, m: C.boolean_mask(a, m), (act, masked),
         (0,), lambda a, m: a[m != 0]),
        ("fft", lambda a: C.fft(a), (sig,), (0,),
         lambda a: torch.view_as_real(torch.fft.fft(a))),
        ("ifft", lambda a: C.ifft(a), (sig2,), (0,), None),
        ("foreach", lambda s, h: C.foreach(body, s, [h])[0], (seq, h0),
         (0, 1), None),
        ("while_loop", lambda h: C.while_loop(
            loop_cond, loop_fn, [torch.zeros((1,), device=h.device), h],
            max_iterations=64)[0], (h0,), (0,), None),
        ("cond", lambda a: C.cond(a[0, 0] > -100, lambda: a * 2,
                                  lambda: a), (x,), (0,), None),
        ("hawkesll", lambda *a: C.hawkesll(*a)[0], tuple(hk),
         (0, 1, 2, 3, 4, 7), None),
        ("AdaptiveAvgPooling2D", lambda a: C.AdaptiveAvgPooling2D(
            a, output_size=1), (head,), (0,),
         lambda a: F.adaptive_avg_pool2d(a, 1)),
        ("index_copy", lambda t, r, n: C.index_copy(t, r, n),
         (table, rows, new), (0, 2),
         lambda t, r, n: t.index_copy(0, r.long(), n)),
        ("count_sketch", lambda a, h, s: C.count_sketch(a, h, s,
                                                         out_dim=16000),
         (pooled, sketch_h, sketch_s), (0,), None),
        ("quadratic", lambda a: C.quadratic(a, 0.5, -1.0, 2.0), (x,), (0,),
         None),
        ("div_sqrt_dim", lambda a: C.div_sqrt_dim(a), (x,), (0,), None),
        ("gradientmultiplier", lambda a: C.gradientmultiplier(a, -0.5),
         (x,), (0,), None),
        ("arange_like", lambda a: C.arange_like(a, axis=1), (x,), (), None),
        ("index_array", lambda a: C.index_array(a[:512]), (x,), (), None),
        ("allclose", lambda a: C.allclose(a, a + 1e-9), (x,), (),
         lambda a: torch.isclose(a, a + 1e-9).all()),
        ("np.sum", lambda a: npm.sum(a, axis=1), (x,), (0,), None),
        ("np.std", lambda a: npm.std(a, axis=0), (x,), (0,), None),
        ("np.median", lambda a: npm.median(a, axis=1), (x,), (0,), None),
        ("np.sort", lambda a: npm.sort(a, axis=1), (x,), (0,), None),
        ("np.cumsum", lambda a: npm.cumsum(a, axis=1), (x,), (0,), None),
        ("np.where", lambda a: npm.where(a > 0, a, a * 0.1), (x,), (0,),
         None),
        ("np.einsum", lambda a: npm.einsum("ij,kj->ik", a[:1024],
                                           a[1024:2048]), (x,), (0,),
         lambda a: torch.matmul(a[:1024], a[1024:2048].T)),
        ("np.histogram", lambda a: npm.histogram(a, bins=64)[0], (x,), (),
         None),
        ("np.unique", lambda a: npm.unique(a), (ints,), (), None),
        ("np.fft.rfft", lambda a: torch.view_as_real(npm.fft.rfft(a)),
         (sig,), (0,), lambda a: torch.fft.rfft(a)),
        ("np.linalg.solve", lambda a, b: npm.linalg.solve(a, b[:512, :512]),
         (spd, x), (0, 1), None),
        ("np.frexp", lambda a: npm.frexp(a)[0], (x,), (0,),
         lambda a: torch.frexp(a)),
    ]
    g = oc.groups["contrib_np"] = {"names": {}}
    for name, fn, args, diff, library in cases:
        card = tuple(a.cuda() for a in args)
        ms = cuda_ms(torch, lambda: fn(*card), reps=OPS_FAMILY_REPS)
        lib_ms = None if library is None else cuda_ms(
            torch, lambda: library(*card), reps=OPS_FAMILY_REPS)
        tol = OPS_F32_TOL if name in ("boolean_mask", "index_copy",
                                      "np.sort", "np.where", "np.frexp",
                                      "arange_like", "index_array",
                                      "allclose", "np.unique",
                                      "np.histogram", "cond",
                                      "gradientmultiplier") \
            else OPS_STATS_TOL
        ok = oc.check("contrib_np", name, _tensor(fn(*card)).float(),
                      _tensor(fn(*args)).float(), tol)
        if diff:
            _, g_c = _fwd_bwd(torch, fn, card, diff)
            _, g_h = _fwd_bwd(torch, fn, args, diff)
            ok &= _grad_check(oc, "contrib_np", name, g_c, g_h)
        g["names"][name] = dict(ms=ms, library_ms=lib_ms, ok=ok)
        torch.cuda.empty_cache()
    g["ms"] = sum(v["ms"] for v in g["names"].values())
    g["library_ms"] = None


def _hawkes_arrays(rng, n, k, t):
    """``hawkesll``'s inputs for ``n`` sequences of ``t`` event slots
    over ``k`` marks (valid lengths t/2..t)."""
    f32 = np.float32
    lags = rng.uniform(0.01, 0.5, (n, t)).astype(f32)
    return [rng.uniform(0.2, 1.0, (n, k)).astype(f32),
            rng.uniform(0.1, 0.6, k).astype(f32),
            rng.uniform(0.5, 2.0, k).astype(f32),
            rng.uniform(0.0, 0.5, (n, k)).astype(f32), lags,
            rng.randint(0, k, (n, t)).astype(f32),
            rng.randint(t // 2, t + 1, n).astype(f32),
            (lags.sum(1) + 1.0).astype(f32)]


def _tensor(v):
    """An operator's result as a tensor (creation operators give arrays)."""
    return v._data if hasattr(v, "_data") else v


def _head_grad(torch, fn, x, y):
    """An output head's forward and its gradient, stacked."""
    x = x.detach().requires_grad_(True)
    out = fn(x, y)
    out.backward(torch.ones_like(out))
    return torch.cat([out.detach().reshape(-1), x.grad.reshape(-1)])


def ops_custom(oc, nd, mx, x):
    """A registered custom operator (x³ with its gradient) on 2**24
    elements, recorded, card against CPU."""
    torch = oc.torch
    from tpu_mx_torch import autograd, operator

    class Cube(operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            self.assign(out_data[0], req[0], in_data[0] ** 3)

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            self.assign(in_grad[0], req[0],
                        3 * in_data[0] ** 2 * out_grad[0])

    @operator.register("chip_cube")
    class CubeProp(operator.CustomOpProp):
        def create_operator(self, ctx, shapes, dtypes):
            return Cube()

    def run(t):
        a = nd.array(t, ctx=mx.gpu(0) if t.is_cuda else mx.cpu())
        a.attach_grad()
        with autograd.record():
            y = nd.Custom(a, op_type="chip_cube")
        y.backward()
        return torch.cat([y._data.detach().reshape(-1),
                          a.grad._data.reshape(-1)])

    xc = x.cuda() / 4
    ms = cuda_ms(torch, lambda: run(xc), reps=OPS_REPS)
    ok = oc.check("rest", "Custom", run(xc), run(x / 4), OPS_F32_TOL)
    return dict(ms=ms, ok=ok)


def phase_operators(ctx):
    """The rest of the ``nd.*`` operators, CTC and ``nd.Custom`` on the
    card at the repo's model shapes, each against the CPU port on the
    same inputs (from ``np.random.RandomState``; the large ones drawn on
    the card by generators it seeds), timed by ``cuda_ms``.  Where an
    operator treats rows apart the CPU computes the leading rows only
    (``OPS_CPU_ROWS``, ``OPS_CPU_ROIS``).  Then ROADMAP A item 10's
    families: the vision operators at Faster R-CNN's, R-FCN's,
    Deformable ConvNets' and FlowNetC's shapes, ``linalg_*`` at 1024,
    the samplers (2**24 draws each, by distribution), the rest of
    ``nd.contrib`` and ``mx.np``; forward within 1e-4 of max|ref|,
    gradients within 1e-2 in norm.  Each group's seconds are
    ``group_seconds``."""
    import torch
    import tpu_mx_torch as mx
    from tpu_mx_torch import autograd, nd

    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False     # float32 products
    torch.backends.cudnn.allow_tf32 = False
    oc = OpsCheck(torch, ctx)
    reset_port_kernel_launches()
    rng = np.random.RandomState(0)
    seconds = {}
    for fn, extra in ((ops_ordering, ()), (ops_sequence, ()),
                      (ops_indexing, ()), (ops_masked_softmax, ()),
                      (ops_linalg, ()), (ops_patches, ()),
                      (ops_softmax_output, ()), (ops_ctc, ()),
                      (ops_batch_norm, (autograd,)),
                      (ops_batch_norm_two_pass, (autograd,)),
                      (ops_rest, (mx,)), (ops_vision, ()),
                      (ops_linalg_family, ()), (ops_samplers, (mx,)),
                      (ops_contrib_np, (mx,))):
        t1 = time.perf_counter()
        fn(oc, nd, *extra, rng)
        torch.cuda.empty_cache()
        seconds[fn.__name__[4:]] = time.perf_counter() - t1
    ctx["operators_launches"] = port_kernel_launches()
    checks = {"all_groups": not oc.failures,
              "no_port_kernel_launched":
                  not any(ctx["operators_launches"].values())}
    emit("operators", ok=all(checks.values()), checks=checks,
         groups=oc.groups, failures=oc.failures[:20],
         seconds=time.perf_counter() - t0, group_seconds=seconds,
         cpu_threads=torch.get_num_threads(),
         launches=ctx["operators_launches"], card=ctx["smi"])
    for name, ok in checks.items():
        if not ok:
            ctx["failures"].append(f"operators check {name} failed")
    ctx["failures"] += oc.failures


def data_jpeg(cv2, rng_seed, bank):
    """One synthetic photograph-like image (BGR uint8, DATA_H x DATA_W):
    a smooth field of DATA_CELLS x DATA_CELLS random colours, bicubic,
    plus noise from ``bank`` at a random offset."""
    r = np.random.RandomState(rng_seed)
    low = r.uniform(0, 255, (DATA_CELLS, DATA_CELLS, 3)).astype(np.float32)
    field = cv2.resize(low, (DATA_W, DATA_H), interpolation=cv2.INTER_CUBIC)
    dy, dx = r.randint(0, 64, 2)
    noise = bank[rng_seed % len(bank), dy:dy + DATA_H, dx:dx + DATA_W]
    return np.clip(field + DATA_NOISE * noise, 0, 255).astype(np.uint8)


def data_encode(cv2, img):
    ok, buf = cv2.imencode(".jpg", img,
                           [cv2.IMWRITE_JPEG_QUALITY, DATA_QUALITY])
    if not ok:
        raise RuntimeError("cv2.imencode failed")
    return buf.tobytes()


def data_write_sets(cv2, tmp, threads):
    """The classification JPEG files with their ``.lst``, the detection
    record file (``recordio.pack_img``) and MNIST's four idx files."""
    import gzip
    import struct
    from concurrent.futures import ThreadPoolExecutor
    from tpu_mx_torch import recordio
    bank = np.random.RandomState(0).normal(
        0, 1, (4, DATA_H + 64, DATA_W + 64, 3)).astype(np.float32)
    root = os.path.join(tmp, "jpeg")
    os.makedirs(root)
    labels = np.random.RandomState(1).randint(0, DATA_CLASSES,
                                              DATA_CLS_IMAGES)

    def write(i):
        data = data_encode(cv2, data_jpeg(cv2, i, bank))
        with open(os.path.join(root, f"{i}.jpg"), "wb") as f:
            f.write(data)
        return len(data)

    with ThreadPoolExecutor(threads) as pool:
        sizes = list(pool.map(write, range(DATA_CLS_IMAGES)))
    lst = os.path.join(tmp, "train.lst")
    with open(lst, "w") as f:
        f.writelines(f"{i}\t{labels[i]}.0\t{i}.jpg\n"
                     for i in range(DATA_CLS_IMAGES))
    rng = np.random.RandomState(2)
    boxes = []
    for _ in range(DATA_DET_IMAGES):
        m = rng.randint(1, DATA_DET_BOXES + 1)
        lo = rng.uniform(0.0, 0.6, (m, 2))
        hi = np.minimum(lo + rng.uniform(0.1, 0.4, (m, 2)), 1.0)
        boxes.append(np.concatenate(
            [rng.randint(0, DATA_DET_CLASSES, (m, 1)), lo, hi], 1))
    with ThreadPoolExecutor(threads) as pool:
        imgs = list(pool.map(lambda i: data_jpeg(cv2, 10 ** 6 + i, bank),
                             range(DATA_DET_IMAGES)))
    det = os.path.join(tmp, "det.rec")
    w = recordio.MXIndexedRecordIO(det[:-4] + ".idx", det, "w")
    for i, (img, b) in enumerate(zip(imgs, boxes)):
        w.write_idx(i, recordio.pack_img(
            recordio.IRHeader(0, b.ravel().astype(np.float32), i, 0), img,
            quality=DATA_QUALITY))
    w.close()
    mnist = os.path.join(tmp, "mnist")
    os.makedirs(mnist)
    for (prefix, n), seed in zip((("train", DATA_MNIST[0]),
                                  ("t10k", DATA_MNIST[1])), (3, 4)):
        x, y = data_mnist_digits(n, seed)
        for kind, arr in (("images-idx3", x), ("labels-idx1", y)):
            with gzip.open(os.path.join(
                    mnist, f"{prefix}-{kind}-ubyte.gz"), "wb",
                    compresslevel=1) as f:
                f.write(struct.pack(">I", 0x0800 | arr.ndim))
                f.write(b"".join(struct.pack(">I", d) for d in arr.shape))
                f.write(arr.tobytes())
    return dict(root=root, lst=lst, det=det, mnist=mnist,
                jpeg_bytes_mean=float(np.mean(sizes)),
                det_boxes_mean=float(np.mean([len(b) for b in boxes])))


def data_mnist_digits(n, seed):
    """MNIST-shaped uint8 digits: train_mnist.py's synthetic strokes (a
    bar over rows 2·label..2·label+4) over noise, moved sideways by up
    to two pixels (a shift along the rows would make classes alike)."""
    rng = np.random.RandomState(seed)
    y = rng.randint(0, 10, n).astype(np.uint8)
    x = rng.randint(0, 26, (n, 28, 28)).astype(np.uint8)
    shift = rng.randint(-2, 3, n)
    for i in range(n):
        r0, c0 = int(y[i]) * 2, 4 + shift[i]
        x[i, r0:r0 + 4, c0:c0 + 20] = 230
    return x, y


def data_iter_rate(io, rec, threads, batches=None):
    """Images a second of ``ImageRecordIter``'s native pipeline alone
    (``iter_next``: read, decode, resize, crop, mirror, batch into
    page-locked memory), one epoch at ``threads``."""
    it = io.ImageRecordIter(
        path_imgrec=rec, data_shape=DATA_SHAPE, batch_size=DATA_BATCH,
        shuffle=True, rand_crop=True, rand_mirror=True, resize=DATA_RESIZE,
        preprocess_threads=threads, output_dtype="uint8",
        output_layout="NHWC", use_native=True)
    t0 = time.perf_counter()
    n = 0
    while it.iter_next():
        n += DATA_BATCH - it.getpad()
        if batches is not None:
            batches.append((it._data.copy(), it._label.copy()))
    return n / (time.perf_counter() - t0), it


def data_step_rate(calls):
    """Images a second between the second and the last call of
    ``CompiledTrainStep.step`` (the host runs at most a step or two
    ahead of the card, so this is the loop's pace past the first
    step's warm-up)."""
    if len(calls) < 3:
        return float("nan")
    return DATA_BATCH * (len(calls) - 2) / (calls[-1] - calls[1])


def data_example(relpath, argv, alias, patch):
    """``run_example`` with ``patch`` ``{(owner, name): replacement}``
    set meanwhile; the example's text and seconds."""
    saved = {k: getattr(*k) for k in patch}
    try:
        for (owner, name), value in patch.items():
            setattr(owner, name, value)
        _, text, seconds, loaded = run_example(relpath, argv, alias)
    finally:
        for (owner, name), value in saved.items():
            setattr(owner, name, value)
    return text, seconds, loaded


def recording(cls, made):
    """A subclass of iterator ``cls`` that appends each instance to
    ``made``."""
    class Recorded(cls):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)
    Recorded.__name__ = cls.__name__
    return Recorded


def data_loader_leg(torch, mnist_dir):
    """``gluon.data.vision.MNIST`` through ``ToTensor`` and ``Normalize``
    at batch 256: one epoch each with no workers, 4 forked process
    workers and 4 threads, on the host (batches/s over the epoch, the
    first batch's seconds, batches/s after it; each kind's batches
    equal the serial ones), then one epoch of LeNet on the card fed by
    the process workers (the parent has started CUDA; the children run
    numpy only)."""
    from tpu_mx_torch import autograd, gluon, metric
    from tpu_mx_torch.context import cpu
    from tpu_mx_torch.gluon.data import DataLoader
    from tpu_mx_torch.gluon.data.vision import MNIST, transforms
    from tpu_mx_torch.models.lenet import lenet
    ds = MNIST(root=mnist_dir, train=True).transform_first(
        transforms.Compose([transforms.ToTensor(),
                            transforms.Normalize(*DATA_MNIST_NORM)]))
    kinds = {"serial": dict(num_workers=0),
             "processes": dict(num_workers=DATA_LOADER_WORKERS,
                               thread_pool=False),
             "threads": dict(num_workers=DATA_LOADER_WORKERS)}
    rates, first, steady, epochs = {}, {}, {}, {}
    with cpu():
        for kind, kw in kinds.items():
            t0 = time.perf_counter()
            stamps, epochs[kind] = [], []
            for d, lab in DataLoader(ds, batch_size=DATA_LOADER_BATCH, **kw):
                epochs[kind].append((d.asnumpy(), lab.asnumpy()))
                stamps.append(time.perf_counter())
            rates[kind] = len(stamps) / (stamps[-1] - t0)
            first[kind] = stamps[0] - t0
            steady[kind] = (len(stamps) - 1) / (stamps[-1] - stamps[0])
    equal = {kind: len(epochs[kind]) == len(epochs["serial"]) and all(
        np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
        for a, b in zip(epochs[kind], epochs["serial"]))
        for kind in ("processes", "threads")}
    shape = epochs["serial"][0][0].shape
    del epochs
    net = lenet(classes=10)
    net.initialize(init="xavier")
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": MNIST_LR, "momentum": 0.9})
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    acc = metric.Accuracy()
    devices = set()
    t0 = time.perf_counter()
    steps = 0
    for data, label in DataLoader(ds, batch_size=DATA_LOADER_BATCH,
                                  shuffle=True, thread_pool=False,
                                  num_workers=DATA_LOADER_WORKERS):
        devices.add(data._data.device.type)
        with autograd.record():
            out = net(data)
            loss = loss_fn(out, label)
        loss.backward()
        trainer.step(data.shape[0])
        acc.update([label], [out])
        steps += 1
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    return dict(batches_per_sec=rates, first_batch_seconds=first,
                steady_batches_per_sec=steady, equal_to_serial=equal,
                batch_shape=list(shape), train_steps=steps,
                train_seconds=train_s, train_batches_per_sec=steps / train_s,
                train_accuracy=float(acc.get()[1]),
                train_devices=sorted(devices))


def phase_data(ctx):
    """The data plane on the card's host: JPEG records through the
    native pipeline into ``train_imagenet.py`` and ``ssd/train.py``,
    MNIST's idx files into ``train_mnist.py``, and ``DataLoader``'s
    worker kinds (see the module's docstring, item 26)."""
    import shutil
    import tempfile

    import cv2                  # the host's JPEG writer (PERF.md's probe)
    import torch

    import tpu_mx_torch as tmx
    from tpu_mx_torch import io, lib
    from tpu_mx_torch.parallel import CompiledTrainStep

    t0 = time.perf_counter()
    reset_port_kernel_launches()
    threads = min(os.cpu_count() or 1, 16)
    tb = time.perf_counter()
    jpeg_link, _ = lib.jpeg_link()
    so = lib.ensure_built()
    build_s = time.perf_counter() - tb
    tmp = tempfile.mkdtemp(prefix="chip_smoke_data_")
    checks, out = {}, {}
    try:
        tw = time.perf_counter()
        sets = data_write_sets(cv2, tmp, threads)
        rec = os.path.join(tmp, "train")
        # the port's im2rec tool, as a user packs a set (its C++ packer)
        here = os.path.dirname(os.path.abspath(__file__))
        tool = subprocess.run(
            [sys.executable, "-m", "tpu_mx_torch.tools.im2rec", "--native",
             "--num-thread", str(threads), "--quality", str(DATA_QUALITY),
             rec, sets["root"]], cwd=here, capture_output=True, text=True,
            timeout=600)
        said = re.search(r"packed (\d+) records \(native\)", tool.stdout)
        packed = int(said.group(1)) if tool.returncode == 0 and said else -1
        out["im2rec"] = dict(rc=tool.returncode, stdout=tool.stdout[-300:],
                             **({"stderr": tool.stderr[-2000:]}
                                if packed < 0 else {}))
        rec += ".rec"
        write_s = time.perf_counter() - tw
        checks["packed_every_image"] = packed == DATA_CLS_IMAGES

        # the iterator alone: rate by threads, seeded runs, the u8 feed
        rates = {}
        for n in sorted(set(DATA_THREADS + (threads,))):
            rates[n], it = data_iter_rate(io, rec, n)
        it.reset()
        it.iter_next()
        checks["native_batches_page_locked"] = \
            torch.from_numpy(it._data).is_pinned()
        del it
        first, second = [], []
        data_iter_rate(io, rec, threads, first)
        data_iter_rate(io, rec, threads, second)
        checks["seeded_iterators_bit_equal"] = len(first) == len(second) \
            == -(-DATA_CLS_IMAGES // DATA_BATCH) and all(
                np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
                for a, b in zip(first, second))
        del first, second
        common = dict(path_imgrec=rec, data_shape=DATA_SHAPE,
                      batch_size=DATA_BATCH, shuffle=True, rand_crop=True,
                      rand_mirror=True, resize=DATA_RESIZE, seed=3,
                      preprocess_threads=threads, use_native=True)
        u8 = io.DevicePrefetchIter(
            io.ImageRecordIter(output_dtype="uint8", output_layout="NHWC",
                               **common),
            normalize=(IMAGENET_MEAN, IMAGENET_STD), normalize_axis=-1)
        f32 = io.ImageRecordIter(
            mean_r=IMAGENET_MEAN[0], mean_g=IMAGENET_MEAN[1],
            mean_b=IMAGENET_MEAN[2], std_r=IMAGENET_STD[0],
            std_g=IMAGENET_STD[1], std_b=IMAGENET_STD[2], **common)
        card = u8.next().data[0]._data
        host = f32.next().data[0].asnumpy()
        u8.close()
        norm_err = float(np.abs(card.permute(0, 3, 1, 2).cpu().numpy()
                                - host).max())
        checks["u8_card_normalised_equals_f32_host"] = \
            card.device.type == "cuda" and norm_err <= DATA_NORM_ATOL

        # train_imagenet.py: record-fed, then its synthetic arm
        alias = port_alias("gluon", "gluon.model_zoo",
                           "gluon.model_zoo.vision", "parallel", "layout")
        made, calls = [], []
        step_fn = CompiledTrainStep.step

        def timed_step(self, *args, **kwargs):
            calls.append(time.perf_counter())
            return step_fn(self, *args, **kwargs)

        prior = torch.backends.cudnn.benchmark
        torch.backends.cudnn.benchmark = True
        imagenet = {}
        try:
            for arm in ("records", "synthetic"):
                calls.clear()
                argv = ["train_imagenet.py", "--batch-size", str(DATA_BATCH),
                        "--layout", "NHWC", "--stem", "s2d", "--epochs", "1"]
                if arm == "records":
                    argv += ["--data-train", rec, "--feed", "u8",
                             "--data-nthreads", str(threads)]
                text, seconds, loaded = data_example(
                    "image_classification/train_imagenet.py", argv, alias,
                    {(tmx.io, "ImageRecordIter"):
                         recording(io.ImageRecordIter, made),
                     (CompiledTrainStep, "step"): timed_step})
                last = [ln for ln in text.splitlines()
                        if ln.startswith("epoch 0: loss")]
                imagenet[arm] = dict(
                    argv=argv[1:], steps=len(calls), seconds=seconds,
                    example_images_per_sec=float(last[-1].split()[-2])
                    if last else float("nan"),
                    steady_images_per_sec=data_step_rate(calls),
                    loss=float(last[-1].split()[3]) if last
                    else float("nan"), reference_modules_loaded=loaded[:10])
        finally:
            torch.backends.cudnn.benchmark = prior
        checks["imagenet_native_pipe"] = len(made) == 1 \
            and made[0].uses_native
        checks["imagenet_records_epoch"] = \
            imagenet["records"]["steps"] == DATA_CLS_IMAGES // DATA_BATCH
        checks["imagenet_losses_finite"] = all(
            math.isfinite(v["loss"]) for v in imagenet.values())
        del made[:]
        gc.collect()
        torch.cuda.empty_cache()

        # ssd/train.py at its defaults on the detection records
        det_made = []
        text, ssd_s, ssd_loaded = data_example(
            "ssd/train.py", ["train.py", "--data-train", sets["det"],
                             "--feed", "u8"],
            port_alias("models", "models.ssd"),
            {(tmx.io, "ImageDetRecordIter"):
                 recording(io.ImageDetRecordIter, det_made)})
        ssd_epochs = [ln for ln in text.splitlines()
                      if ln.startswith("epoch ")]
        checks["ssd_native_pipe"] = len(det_made) == 1 \
            and det_made[0].uses_native
        checks["ssd_two_epochs"] = len(ssd_epochs) == 2
        gc.collect()
        torch.cuda.empty_cache()

        # train_mnist.py on the idx files
        mnist_made = []
        os.environ["MNIST_DIR"] = sets["mnist"]
        try:
            text, mnist_s, mnist_loaded = data_example(
                "mnist/train_mnist.py", ["train_mnist.py", "--epochs", "1"],
                port_alias("models", "models.lenet"),
                {(tmx.io, "MNISTIter"): recording(io.MNISTIter,
                                                  mnist_made)})
        finally:
            del os.environ["MNIST_DIR"]
        mnist_final = [ln for ln in text.splitlines()
                       if ln.startswith("final accuracy")]
        checks["mnist_idx_files"] = len(mnist_made) == 1
        checks["mnist_example_ended"] = bool(mnist_final)

        loader = data_loader_leg(torch, sets["mnist"])
        checks["loader_processes_equal_serial"] = \
            loader["equal_to_serial"]["processes"]
        checks["loader_threads_equal_serial"] = \
            loader["equal_to_serial"]["threads"]
        checks["loader_trains_on_card"] = loader["train_devices"] == \
            ["cuda"] and loader["train_steps"] == \
            -(-DATA_MNIST[0] // DATA_LOADER_BATCH)
        checks["no_reference_module_loaded"] = not (
            imagenet["records"]["reference_modules_loaded"] or ssd_loaded
            or mnist_loaded)
        checks["no_jax"] = "jax" not in sys.modules
        ctx["data_launches"] = port_kernel_launches()
        checks["no_port_kernel_launched"] = \
            not any(ctx["data_launches"].values())
        out = dict(
            out,
            host=dict(nproc=os.cpu_count(), threads=threads,
                      opencv=cv2.__version__, libjpeg=jpeg_link,
                      library=os.path.relpath(so), build_seconds=build_s),
            sets=dict(classification=DATA_CLS_IMAGES, detection=
                      DATA_DET_IMAGES, size=[DATA_W, DATA_H],
                      quality=DATA_QUALITY,
                      jpeg_kb_mean=sets["jpeg_bytes_mean"] / 1e3,
                      det_boxes_mean=sets["det_boxes_mean"],
                      mnist=list(DATA_MNIST), write_seconds=write_s,
                      packed_by="python -m tpu_mx_torch.tools.im2rec "
                                "--native"),
            iterator=dict(images_per_sec_by_threads=rates,
                          batch=DATA_BATCH, shape=list(DATA_SHAPE),
                          resize=DATA_RESIZE, feed="uint8 NHWC",
                          u8_norm_max_abs_err=norm_err,
                          tolerance=DATA_NORM_ATOL),
            train_imagenet=imagenet,
            ssd=dict(epochs=ssd_epochs, seconds=ssd_s),
            mnist=dict(final=mnist_final, seconds=mnist_s),
            data_loader=loader)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit("data", ok=all(checks.values()), checks=checks, **out,
         launches=ctx.get("data_launches"),
         seconds=time.perf_counter() - t0, card=ctx["smi"])
    for name, ok in checks.items():
        if not ok:
            ctx["failures"].append(f"data check {name} failed")


# -- the quantization and estimator examples, the attention crossover and
# -- serving's decode arms
QUANT_NET, QUANT_CLASSES, QUANT_SIZE = "resnet50_v1", 1000, 224
QUANT_BATCH, QUANT_CALIB_BATCHES = 32, 4
# the convolutions whose int32 accumulators are held bit for bit: the stem
# (7 x 7 x 3 taps), a 3 x 3 of stage 3 (2304 taps) and of stage 4 (4608)
QUANT_SAMPLED = ("features.0", "features.6.0.body.3", "features.7.0.body.3")
QUANT_CPU_ROWS = 2           # images the CPU port runs (inference rows are
                             # independent): ~8 GMAC of int32 on the host
QUANT_LOGITS_REL = 1e-3      # int8 logits, card against CPU, x max|logit|
QUANT_REPS = 5
# training-mode forwards that move BatchNorm's running statistics (momentum
# 0.9) to ~0.96 of the batch's: at their initial (0, 1) the untrained
# net's logits are ~1e-5, no test of the int8 path's scale
QUANT_BN_WARM = 30
# the dense/flash crossover: forward plus backward at 16384 tokens a call
CROSS_T = (128, 256, 512, 1024, 2048)
CROSS_TOKENS = 16384
CROSS_SHAPES = ((12, 64), (32, 128))          # BERT-base; a 7B model's
CROSS_REPS, CROSS_WARM = 10, 2
# serving's decode arms: (name, TPUMX_PAGED_DECODE, TPUMX_FUSED_DECODE,
# TPUMX_SPECULATIVE); None leaves a knob unset
SERVE_ARMS = (("default", None, None, None),
              ("dense_host", "0", "0", None),
              ("dense_fused", "0", "1", None),
              ("paged_host", "1", "0", None),
              ("paged_fused", "1", "1", None),
              ("kernel_host", "kernel", "0", None),
              ("kernel_fused", "kernel", "1", None),
              ("paged_host_spec4", "1", "0", str(SPEC_WINDOW)),
              ("dense_host_spec4", "0", "0", str(SPEC_WINDOW)))
SERVE_ARM_KNOBS = ("TPUMX_PAGED_DECODE", "TPUMX_FUSED_DECODE",
                   "TPUMX_SPECULATIVE", "TPUMX_SELF_CHECK",
                   "TPUMX_SELF_CHECK_SEED")


class env_set:
    """Set (a value) or unset (None) environment variables for the extent
    of a ``with`` block, restoring them after."""

    def __init__(self, **values):
        self.values = values

    def __enter__(self):
        self.saved = {k: os.environ.get(k) for k in self.values}
        for k, v in self.values.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def quant_images(torch, seed):
    """A batch of synthetic normalised images, NHWC float32, drawn on the
    card from ``seed``."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn((QUANT_BATCH, QUANT_SIZE, QUANT_SIZE, 3),
                       generator=gen, device="cuda")


def phase_quantize(ctx):
    """``quantize_net`` of ResNet-50 v1 at full width on the card (float32,
    channels-last, 224 x 224): calibrated on QUANT_CALIB_BATCHES batches,
    one batch through the int8 net; the sampled convolutions' int32
    accumulators against the CPU port's, the int8 logits against the CPU
    port's int8 net, int8 against float ms; then
    ``examples/quantization/quantize_cnn.py`` at its defaults."""
    import torch
    from tpu_mx_torch.contrib import quantization as q
    from tpu_mx_torch.ndarray import NDArray
    from tpu_mx_torch.ndarray import quantized_ops as qops

    t0 = time.perf_counter()
    reset_port_kernel_launches()
    net = zoo_net(torch, QUANT_NET, "cuda")
    net.initialize("xavier",
                   generator=torch.Generator(device="cuda").manual_seed(0))
    with torch.no_grad():
        net.eval()(quant_images(torch, 99)[:1])      # fixes the shapes
        net.train()
        warm = quant_images(torch, 98)
        for _ in range(QUANT_BN_WARM):
            net(warm)
        net.eval()
    tc = time.perf_counter()
    qnet = q.quantize_net(net, calib_iter=[
        NDArray(quant_images(torch, i)) for i in range(QUANT_CALIB_BATCHES)])
    torch.cuda.synchronize()
    calib_s = time.perf_counter() - tc
    x = NDArray(quant_images(torch, 100))
    seen = {}
    hooks = [blk.register_forward_pre_hook(
        lambda b, args, n=n: seen.__setitem__(n, args[0]))
        for n, blk in q._named_quantizable(net) if n in QUANT_SAMPLED]
    logits = qnet(x)._data
    for h in hooks:
        h.detach()
    with torch.no_grad():
        flt = net(x)._data
    int8_ms = cuda_ms(torch, lambda: qnet(x), reps=QUANT_REPS, warm=1)
    float_ms = cuda_ms(torch, lambda: net(x), reps=QUANT_REPS, warm=1)
    agree = float((logits.argmax(-1) == flt.argmax(-1)).float().mean())
    # the sampled accumulators: the card's whole batch, its leading rows
    # against the CPU port's on the same int8 inputs
    rows = QUANT_CPU_ROWS
    accs = {}
    for n in QUANT_SAMPLED:
        ql, c = qnet._qmap[n], net.get_submodule(n)
        xq = q.quantize(seen[n], *ql._in_range)[0]._data
        kw = dict(kernel=c._kernel, stride=c._strides, pad=c._padding,
                  dilate=c._dilation, num_filter=c._channels,
                  num_group=c._groups, layout=c._layout)
        rng = (*ql._in_range, ql._wmin, ql._wmax)
        card = qops.quantized_conv(xq, ql._wq._data, None, *rng, **kw)[0]
        host = qops.quantized_conv(xq[:rows].cpu(), ql._wq._data.cpu(),
                                   None, *rng, **kw)[0]
        taps = math.prod(c._kernel) * ql._wq.shape[-1]
        accs[n] = dict(taps=taps, shape=list(card.shape),
                       dtype=str(card.dtype),
                       bit_equal=bool(torch.equal(card[:rows].cpu(), host)),
                       max_abs=int(card.abs().max()),
                       past_f32_exact=int(card.abs().max()) > 1 << 24)
    # every tap of a 3 x 3 x 512 window at 127 x 127 (one at 126): 7.4e7,
    # past what a float32 accumulator holds exactly
    ones = torch.full((1, 3, 3, 512), 127, dtype=torch.int8, device="cuda")
    w = ones.clone()
    w[0, 0, 0, 0] = 126
    full = int(qops.quantized_conv(ones, w, None, -1.0, 1.0, -1.0, 1.0,
                                   kernel=(3, 3), num_filter=1,
                                   layout="NHWC")[0].reshape(-1)[0])
    # the CPU port's int8 net: the same weights, the card's ranges
    params = {p.name: p._ref_view().detach().cpu().numpy()
              for p in net.collect_params().values()}
    host_net = zoo_copy(torch, QUANT_NET, "cpu", params)
    host_q = q._QuantizedNet(host_net, {
        n: type(ql)(host_net.get_submodule(n), ql._in_range)
        for n, ql in qnet._qmap.items()})
    th = time.perf_counter()
    from tpu_mx_torch.context import cpu
    with cpu():
        host_logits = host_q(NDArray(x._data[:rows].cpu()))._data
    host_s = time.perf_counter() - th
    scale = float(host_logits.abs().max())
    logits_err = float((logits[:rows].cpu() - host_logits).abs().max())
    weights_equal = all(
        torch.equal(ql._wq._data.cpu(), host_q._qmap[n]._wq._data)
        for n, ql in qnet._qmap.items())
    # the reference's example at its defaults, through the alias
    alias = port_alias("gluon", "gluon.nn", "contrib", "contrib.quantization")
    try:
        _, text, ex_s, loaded = run_example(
            "quantization/quantize_cnn.py", ["quantize_cnn.py"], alias)
        ex_exit = None
    except SystemExit as e:         # its own check failed
        text, ex_s, loaded, ex_exit = "", None, [], e.code
    ex = {k: float(m.group(1)) for k, m in (
        (k, re.search(pat + r"\s+([\d.]+)", text)) for k, pat in (
            ("float_accuracy", r"float32 accuracy:"),
            ("int8_accuracy", r"int8    accuracy:"),
            ("agreement", r"argmax agreement:"))) if m}
    ctx["quantize_launches"] = port_kernel_launches()
    checks = {
        "leaves": len(qnet._qmap) == 54,
        "accumulators_bit_equal": all(a["bit_equal"] for a in accs.values()),
        "accumulators_int32": all(a["dtype"] == "torch.int32"
                                  for a in accs.values()),
        "full_tap_sum_exact": full == 4608 * 127 * 127 - 127,
        "int8_weights_equal": weights_equal,
        "logits_finite": bool(torch.isfinite(logits).all()),
        "logits_match_cpu": logits_err <= QUANT_LOGITS_REL * scale,
        "example_passed": ex_exit is None and "PASSED" in text,
        "no_reference_module_loaded": not loaded,
        "no_jax": "jax" not in sys.modules,
        "no_port_kernel_launched": not any(ctx["quantize_launches"].values()),
    }
    ctx["quantize"] = dict(int8_ms=int8_ms, float_ms=float_ms,
                           agreement=agree)
    emit("quantize", ok=all(checks.values()), checks=checks,
         net=QUANT_NET, batch=QUANT_BATCH, size=QUANT_SIZE, layout="NHWC",
         calib_batches=QUANT_CALIB_BATCHES, calib_seconds=calib_s,
         quantized_leaves=len(qnet._qmap), int8_ms=int8_ms,
         float_ms=float_ms, int8_over_float=int8_ms / float_ms,
         argmax_agreement=agree, accumulators=accs, cpu_rows=rows,
         full_tap_sum=full, bn_warm_forwards=QUANT_BN_WARM,
         logits_max_abs_err=logits_err, logits_scale=scale,
         logits_tol=QUANT_LOGITS_REL * scale, cpu_seconds=host_s,
         example=dict(ex, seconds=ex_s, exit=ex_exit),
         launches=ctx["quantize_launches"],
         seconds=time.perf_counter() - t0, card=ctx["smi"])
    for name, ok in checks.items():
        if not ok:
            ctx["failures"].append(f"quantize check {name} failed")
    del net, qnet, host_net, host_q
    gc.collect()
    torch.cuda.empty_cache()


def phase_estimator(ctx):
    """``examples/estimator/train.py`` unedited at its defaults on the card
    through the alias: its own asserts (loss < 0.45, accuracy > 0.8, a
    ``best`` checkpoint) hold."""
    import torch
    from tpu_mx_torch.gluon.contrib import estimator as est

    alias = port_alias("gluon", "gluon.nn", "gluon.data", "gluon.contrib",
                       "gluon.contrib.estimator")
    devices = []
    real = est.Estimator.fit

    def recorded(self, *args, **kwargs):
        devices.extend({p.data()._data.device.type
                        for p in self.net.collect_params().values()})
        return real(self, *args, **kwargs)

    reset_port_kernel_launches()
    est.Estimator.fit = recorded
    try:
        _, text, seconds, loaded = run_example(
            "estimator/train.py", ["train.py"], alias)
    finally:
        est.Estimator.fit = real
    m = re.search(r"eval loss ([\d.]+)\s+accuracy ([\d.]+)", text)
    ctx["estimator_launches"] = port_kernel_launches()
    checks = {
        "ended_with_its_assertions": m is not None
        and "checkpoints:" in text,
        "trained_on_the_card": set(devices) == {"cuda"},
        "no_reference_module_loaded": not loaded,
        "no_jax": "jax" not in sys.modules,
    }
    ctx["estimator"] = dict(seconds=seconds)
    emit("estimator", ok=all(checks.values()), checks=checks,
         argv=["train.py"], eval_loss=float(m.group(1)) if m else None,
         accuracy=float(m.group(2)) if m else None, wall_seconds=seconds,
         launches=ctx["estimator_launches"],
         reference_modules_loaded=loaded[:10], card=ctx["smi"])
    for name, ok in checks.items():
        if not ok:
            ctx["failures"].append(f"estimator check {name} failed")
    torch.cuda.empty_cache()


def crossover_point(torch, ra, dtype, h, d, t, causal, gen):
    """Forward plus backward of ``local_flash_attention`` at one point on
    both arms: each arm's median ms and peak memory, and the flash
    output's error against the dense arm's."""
    b = CROSS_TOKENS // t
    q, k, v = (torch.randn((b, h, t, d), generator=gen, device="cuda")
               .to(dtype).requires_grad_() for _ in range(3))
    g = torch.randn((b, h, t, d), generator=gen, device="cuda").to(dtype)
    valid = None if causal else torch.randint(
        t // 2, t + 1, (b,), generator=gen, device="cuda").to(torch.int32)
    rec = {}
    outs = {}
    for mode in ("dense", "flash"):
        with env_set(TPUMX_ATTENTION=mode):
            arm = ra.attention_arm("cuda", d, dtype, mode, t)

            def run():
                out = ra.local_flash_attention(q, k, v, causal=causal,
                                               valid_length=valid)
                out.backward(g)
                return out

            outs[mode] = run().detach().float()
            q.grad = k.grad = v.grad = None
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            run()
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - base
            ms = cuda_ms(torch, run, reps=CROSS_REPS, warm=CROSS_WARM)
            q.grad = k.grad = v.grad = None
        rec[mode] = dict(arm=arm, ms=ms, peak_bytes=peak)
    err = float((outs["flash"] - outs["dense"]).abs().max())
    ref = float(outs["dense"].abs().max())
    tol = FLASH_ATOL if dtype == torch.float32 else BF16_REL * ref
    return dict(b=b, dense_ms=rec["dense"]["ms"], flash_ms=rec["flash"]["ms"],
                dense_peak_bytes=rec["dense"]["peak_bytes"],
                flash_peak_bytes=rec["flash"]["peak_bytes"],
                arms=[rec["dense"]["arm"], rec["flash"]["arm"]],
                max_abs_err=err, tol=tol, ok=err <= tol,
                dense_wins=rec["dense"]["ms"] < rec["flash"]["ms"])


def phase_crossover(ctx):
    """Where the dense arm beats the flash kernels on the card: forward
    plus backward of ``local_flash_attention`` on both arms, bf16 and
    float32, causal and padded (``valid_length`` in [T/2, T]), H=12 D=64
    and H=32 D=128, T in CROSS_T at CROSS_TOKENS tokens a call; the
    largest T at which dense wins in every case of both dtypes (and of
    every T below) is the measured default of ``TPUMX_DENSE_MAX_KV``."""
    import torch
    import importlib
    ra = importlib.import_module("tpu_mx_torch.parallel.ring_attention")

    t0 = time.perf_counter()
    reset_port_kernel_launches()
    gen = torch.Generator(device="cuda").manual_seed(5)
    table = []
    for dtype in (torch.bfloat16, torch.float32):
        for h, d in CROSS_SHAPES:
            for causal in (True, False):
                for t in CROSS_T:
                    p = crossover_point(torch, ra, dtype, h, d, t, causal,
                                        gen)
                    p.update(dtype=str(dtype).replace("torch.", ""), h=h,
                             d=d, t=t, mask="causal" if causal
                             else "valid_length")
                    table.append(p)
                    emit("crossover_point", **p)
                    torch.cuda.empty_cache()
    wins = {t: all(p["dense_wins"] for p in table if p["t"] == t)
            for t in CROSS_T}
    by_dtype = {dt: max([0] + [t for t in CROSS_T if all(
        p["dense_wins"] for p in table if p["t"] <= t and p["dtype"] == dt)])
        for dt in ("bfloat16", "float32")}
    chosen = max([0] + [t for t in CROSS_T
                        if all(wins[u] for u in CROSS_T if u <= t)])
    ctx["crossover_launches"] = port_kernel_launches()
    checks = {
        "every_point": len(table) == 2 * len(CROSS_SHAPES) * 2 * len(CROSS_T),
        "flash_matches_dense": all(p["ok"] for p in table),
        "arms_as_pinned": all(p["arms"] == ["dense", "flash_kernel"]
                              for p in table),
        "flash_launched": ctx["crossover_launches"]["flash_attention_fwd"]
        > 0,
    }
    ctx["crossover"] = dict(chosen=chosen, by_dtype=by_dtype)
    emit("crossover", ok=all(checks.values()), checks=checks,
         tokens=CROSS_TOKENS, shapes=[list(s) for s in CROSS_SHAPES],
         t=list(CROSS_T), dense_wins_by_t=wins,
         dense_max_kv_by_dtype=by_dtype, chosen_default=chosen,
         code_default=ra.DENSE_MAX_KV_DEFAULT,
         default_agrees=chosen == ra.DENSE_MAX_KV_DEFAULT,
         launches=ctx["crossover_launches"],
         seconds=time.perf_counter() - t0, card=ctx["smi"])
    for name, ok in checks.items():
        if not ok:
            ctx["failures"].append(f"crossover check {name} failed")


def serve_arm_run(torch, model, prompts, name, paged, fused, spec,
                  self_check=None, flaky=False):
    """One arm's server over ``prompts`` from counts at 0 (a warm-up
    request first): :func:`serve_run`'s numbers, the engine's arm, the
    decode-attention counts by kind, the host crossings and the
    self-check's counters."""
    from tpu_mx_torch import telemetry, tracing
    from tpu_mx_torch.contrib import chaos
    from tpu_mx_torch.serving import Server
    knobs = dict(TPUMX_PAGED_DECODE=paged, TPUMX_FUSED_DECODE=fused,
                 TPUMX_SPECULATIVE=spec, TPUMX_SELF_CHECK=self_check,
                 TPUMX_SELF_CHECK_SEED=None)
    with env_set(**knobs):
        srv = Server(model, max_batch=8, block_size=16, num_blocks=1024,
                     backoff=0.0)
        srv.submit(prompts[0][:16], max_new_tokens=2, request_id="warm")
        srv.run_until_idle()
        if flaky:
            with chaos.enable(flaky_recompute=1) as cfg:
                run = serve_run(torch, srv, prompts, NEW_TOKENS,
                                ids=name[:2])
            run["flaky_fired"] = cfg.flaky_fired
        else:
            run = serve_run(torch, srv, prompts, NEW_TOKENS, ids=name[:2])

    def value(metric, **labels):
        m = telemetry.get(metric, **labels)
        return 0 if m is None else m.value

    tokens = sum(len(s) for s in run["streams"])
    run.update(
        arm=dict(decode_kind=srv.engine.decode_kind, fused=srv.engine.fused,
                 spec_window=srv.engine.spec_window),
        decode_attention={k: value("serve.decode_attention", kind=k)
                          for k in ("dense", "paged", "paged-kernel")},
        host_crossings=value("serve.host_crossings"),
        host_crossings_per_token=value("serve.host_crossings") / tokens,
        self_checks=value("integrity.self_checks"),
        self_check_mismatches=value("integrity.self_check_mismatches"),
        restarts=srv.restarts,
        restart_reasons=[e["data"]["reason"][:80] for e in
                         tracing.snapshot()
                         if e["event"] == "serve.restart"])
    return run


def phase_serve_arms(ctx):
    """Serving's decode arms at the serve phase's width: every
    ``TPUMX_PAGED_DECODE`` x ``TPUMX_FUSED_DECODE`` combination (and the
    knobs unset, and the host loop at window SPEC_WINDOW) on the same 8
    greedy requests, in two rounds (the second in reverse order); the
    decode self-check at rate 1.0 on the host and the fused arm, and
    with a flaky recompute armed."""
    import torch
    from tpu_mx_torch.serving import Server, TinyLM
    from tpu_mx_torch.supervisor import classify, DataCorruption

    t0 = time.perf_counter()
    model = ctx.get("serve_model") or TinyLM(**SERVE, device="cuda")
    prompts = serve_prompts()
    layers = SERVE["num_layers"]
    # two rounds, the second in reverse order: the first run of a code
    # path pays its warm-up (cuBLAS's handles, the allocator's blocks)
    rounds = {}
    for arms in (SERVE_ARMS, SERVE_ARMS[::-1]):
        for name, paged, fused, spec in arms:
            rounds.setdefault(name, []).append(serve_arm_run(
                torch, model, prompts, name, paged, fused, spec))
    runs = {name: rs[0] for name, rs in rounds.items()}
    for name, fused in (("self_check_host", "0"),
                        ("self_check_fused", "1")):
        runs[name] = serve_arm_run(torch, model, prompts, name, "1", fused,
                                   None, self_check="1.0")
    runs["flaky"] = serve_arm_run(torch, model, prompts, "flaky", "1", "0",
                                  None, self_check="1.0", flaky=True)
    # the CPU port: the same weights, the default arm's plain versions
    th = time.perf_counter()
    cpu = TinyLM.from_numpy(*model.to_numpy(), num_heads=SERVE["num_heads"],
                            device="cpu")
    host = Server(cpu, max_batch=8, block_size=16, num_blocks=1024,
                  device="cpu")
    hreqs = [host.submit(p, max_new_tokens=NEW_TOKENS) for p in prompts]
    host.run_until_idle()
    host_s = time.perf_counter() - th
    want = [r.tokens for r in hreqs]
    splits = {name: stream_splits(model, prompts, r["streams"], want)
              for name, r in runs.items()}
    base = runs["paged_fused"]["streams"]
    checks = {}
    for name, paged, fused, spec in SERVE_ARMS:
        kind = {None: "paged", "1": "paged", "0": "dense",
                "kernel": "paged-kernel"}[paged]
        ok = {"done": True, "arm": True, "decode_attention": True,
              "paged_launches": True}
        for r in rounds[name]:
            steps = r["decode_steps"]
            ok["done"] &= r["done"] and r["streams"] == runs[name]["streams"]
            ok["arm"] &= r["arm"]["decode_kind"] == kind and \
                r["arm"]["fused"] == (fused != "0" and kind != "dense")
            ok["decode_attention"] &= r["decode_attention"] == {
                k: (layers * steps if k == kind else 0)
                for k in ("dense", "paged", "paged-kernel")}
            ok["paged_launches"] &= (
                r["launches"]["paged_attention"] == 0 if kind == "dense"
                else r["launches"]["paged_attention"] == layers * steps)
        checks.update({f"{name}_{k}": v for k, v in ok.items()})
        checks[f"{name}_streams_cpu"] = splits_ok(splits[name])
        checks[f"{name}_streams_arms"] = splits_ok(stream_splits(
            model, prompts, runs[name]["streams"], base))
    for name in ("self_check_host", "self_check_fused"):
        r = runs[name]
        checks[f"{name}_no_mismatch"] = r["self_check_mismatches"] == 0 \
            and r["self_checks"] == r["decode_steps"] > 0 \
            and r["restarts"] == 0
        checks[f"{name}_streams"] = r["streams"] == runs[
            "paged_host" if name.endswith("host") else "paged_fused"][
                "streams"]
    r = runs["flaky"]
    checks["flaky_caught"] = r["flaky_fired"] == 1 and \
        r["self_check_mismatches"] == 1 and r["restarts"] == 1 and \
        classify(DataCorruption("x")) == "corruption" and \
        any("DataCorruption" in s for s in r["restart_reasons"])
    # the restart's replay prefills recompute the committed tokens' K/V
    # on the flash forward: a later token may split only at a near tie
    checks["flaky_streams_whole"] = r["done"] and splits_ok(stream_splits(
        model, prompts, r["streams"], runs["paged_host"]["streams"]))
    every = [r for rs in rounds.values() for r in rs] + [
        runs[n] for n in ("self_check_host", "self_check_fused", "flaky")]
    ctx["serve_arms_launches"] = {
        k: sum(r["launches"][k] for r in every)
        for k in runs["default"]["launches"]}
    per_round = lambda name, key: [r[key] for r in rounds.get(
        name, [runs[name]])]
    table = {name: dict(
        arm=r["arm"], tokens_per_sec=per_round(name, "tokens_per_sec"),
        decode_step_ms_median=per_round(name, "decode_step_ms_median"),
        decode_steps=r["decode_steps"],
        host_crossings_per_token=r["host_crossings_per_token"],
        decode_attention=r["decode_attention"],
        paged_launches=r["launches"]["paged_attention"],
        flash_launches=r["launches"]["flash_attention_fwd"],
        self_checks=r["self_checks"],
        self_check_mismatches=r["self_check_mismatches"],
        restarts=r["restarts"], stream_splits_vs_cpu=[
            s for s, _ in splits[name]])
        for name, r in runs.items()}
    ctx["serve_arms"] = table
    emit("serve_arms", ok=all(checks.values()), checks=checks, arms=table,
         cpu_seconds=host_s, launches=ctx["serve_arms_launches"],
         seconds=time.perf_counter() - t0, card=ctx["smi"])
    for name, ok in checks.items():
        if not ok:
            ctx["failures"].append(f"serve_arms check {name} failed")
    torch.cuda.empty_cache()


# -- supervised, deterministically resumable training (phase
# supervised_train).  The job: BERT under Supervisor + CapsuleManager +
# elastic.save_checkpoint/auto_resume around CompiledTrainStep, fed by a
# seeded shuffling NDArrayIter; each of runs A-D is a fresh process.
SUP_EPOCHS, SUP_STEPS = 2, 4          # 2 epochs of 4 steps
SUP_INTERVAL = 2                      # a step capsule every 2 commits
SUP_CRASH_STEP = 6                    # run B: os._exit(137) after step 6
SUP_PREEMPT_STEP = 3                  # run D: SIGTERM after step 3 commits
SUP_SEED, SUP_DATA_SEED = 11, 7
SUP_DEADLINE = 10.0                   # the in-process watchdog's deadline
SUP_REPLICAS, SUP_REPLICA_LAYERS = 3, 2
SUP_BITFLIP_STEP, SUP_BITFLIP_RANK = 3, 2
SUP_PROFILE_STEPS = 2
SUP_TIMED_STEPS = 3
# of BERT-base's 12 (the script's time: with the head dims of 320 and
# more the whole script took 1061.2 s on a slow host at 5)
SUP_LAYERS = 3

SUPERVISED_CHILD = r'''
import json, sys
import chip_smoke as cs
sys.exit(cs.supervised_child(json.loads(sys.argv[1])))
'''


def supervised_job(spec):
    """The supervised job of ``spec`` (a dict: ``device``, ``cfg``,
    ``dtype``, ``batch``, ``seq``, ``masked``, ``valid``, ``prefix``,
    ``interval``, and optionally ``deadline`` and the supervisor's
    ``sup_kwargs``): the net (weights and dropout drawn from the port's
    process generator after ``random.seed``), the step, a seeded
    shuffling iterator over ``batch x SUP_STEPS`` samples, the capsule
    manager and the supervisor with its save and restore functions.
    Returns them in a dict; ``losses`` records each committed step's loss
    under ``"epoch:step"``."""
    import torch
    from tpu_mx_torch import elastic, optimizer, random, resume, supervisor
    from tpu_mx_torch import io as mxio
    from tpu_mx_torch.models import BERTModel, MLMLoss
    from tpu_mx_torch.parallel import CompiledTrainStep

    dev = spec["device"]
    random.seed(SUP_SEED)
    net = BERTModel(spec["cfg"], dtype=spec["dtype"], device=dev,
                    generator=random.generator(dev))
    opt = optimizer.create("lamb", learning_rate=1e-4,
                           multi_precision=spec["dtype"] == "bfloat16")
    step = CompiledTrainStep(net, MLMLoss(), opt, device=dev)
    rng = np.random.RandomState(SUP_DATA_SEED)
    n = spec["batch"] * SUP_STEPS
    valid = rng.randint(spec["valid"][0], spec["valid"][1] + 1, n)
    tokens, types, valid, pos, labels = bert_batch(
        spec["cfg"], n, spec["seq"], spec["masked"], valid, rng)
    it = mxio.NDArrayIter([tokens, types, valid, pos], labels,
                          batch_size=spec["batch"], shuffle=True,
                          last_batch_handle="discard", seed=SUP_SEED)
    prefix = spec["prefix"]
    mgr = resume.CapsuleManager(prefix, iters=[it], state=step,
                                interval=spec.get("interval", SUP_INTERVAL))
    sup = supervisor.Supervisor(capsule=mgr, backoff=0.0, seed=0,
                                deadline=spec.get("deadline"),
                                **spec.get("sup_kwargs", {}))
    job = dict(net=net, step=step, it=it, mgr=mgr, sup=sup, losses={},
               commits=[], saves=[], capsules=[])

    def save_fn(epoch):
        t0 = time.perf_counter()
        elastic.save_checkpoint(prefix, epoch, net=net, capsule=mgr)
        job["saves"].append(time.perf_counter() - t0)

    def restore_fn():
        epoch = elastic.auto_resume(prefix, net=net)
        step.sync_from_net()
        return epoch

    write_step = mgr.write_step

    def timed_write_step(sup=None):
        t0 = time.perf_counter()
        write_step(sup)
        job["capsules"].append(dict(
            seconds=time.perf_counter() - t0,
            bytes=os.path.getsize(resume.step_state_path(prefix))
            + os.path.getsize(resume.step_capsule_path(prefix))))

    mgr.write_step = timed_write_step
    sup.save_fn, sup.restore_fn = save_fn, restore_fn

    def epoch_fn(epoch):
        if not sup.resume_step(epoch):
            it.reset()
        for b in it:
            loss = sup.step(lambda b=b: step.step(*b.data, *b.label))
            job["losses"][f"{epoch}:{sup.step_in_epoch}"] = \
                float(loss.asnumpy())
            job["commits"].append(time.time())
            if job.get("on_commit"):
                job["on_commit"](sup.steps)

    job["epoch_fn"] = epoch_fn
    job["torch"] = torch
    return job


def supervised_child(spec):
    """One run of the supervised job in a fresh process (``spec["mode"]``:
    ``run`` to the end, ``crash`` under ``TPUMX_CHAOS``, or ``preempt``:
    after step ``SUP_PREEMPT_STEP`` commits, wait for the SIGTERM the
    parent sends, with ``preemption_handler`` armed to write the step
    capsule).  Writes ``spec["out"]`` (JSON): the losses, the final
    fingerprint, the times of each commit and save, the capsule writes,
    the restore the run started from; with ``spec["save_values"]`` the
    final weights and buffers beside it (``<out>.npz``, as float32)."""
    import tpu_mx_torch as mx
    from tpu_mx_torch import checkpoint, tracing
    job = supervised_job(spec)
    sup, step = job["sup"], job["step"]
    progress = spec.get("progress")
    if spec["mode"] == "preempt":
        checkpoint.preemption_handler(lambda: job["mgr"].write_step(sup))

        def on_commit(n):
            with open(progress, "a") as f:
                f.write(f"{n}\n")
            if n == SUP_PREEMPT_STEP:
                time.sleep(120)           # the SIGTERM lands here
                raise SystemExit("no SIGTERM arrived")
        job["on_commit"] = on_commit
    with mx.cpu() if spec["device"] == "cpu" else mx.gpu(0):
        result = sup.run(job["epoch_fn"], begin_epoch=0,
                         num_epoch=SUP_EPOCHS)
    if spec["mode"] == "crash":
        raise SystemExit("crash_at_step did not fire")
    # the run's flight record, for the report tools
    tracing.dump_blackbox(spec["prefix"], reason=f"{spec['mode']} ended")
    restores = [e["data"] for e in tracing.snapshot()
                if e["event"] == "resume.capsule_restore"]
    man = {e: checkpoint.read_manifest(spec["prefix"], e)
           for e in range(SUP_EPOCHS)}
    verify = {}
    for e in range(SUP_EPOCHS):
        t0 = time.perf_counter()
        status = checkpoint.verify_checkpoint(spec["prefix"], e)[0]
        verify[e] = dict(status=status, seconds=time.perf_counter() - t0,
                         bytes=sum(f["size"] for f in
                                   man[e]["files"].values()))
    if spec.get("save_values"):
        np.savez(spec["out"] + ".npz", **{
            k: v.detach().float().cpu().numpy()
            for k, v in step.state_dict()["values"].items()})
    with open(spec["out"], "w") as f:
        json.dump(dict(result=result.as_dict(), losses=job["losses"],
                       fingerprint=step.fingerprint(),
                       commits=job["commits"], saves=job["saves"],
                       capsules=job["capsules"], restores=restores,
                       verify={str(k): v for k, v in verify.items()}), f)
    return 0


def supervised_runs(spec, work, timeout=600):
    """Runs A-D of the supervised job, each a fresh process running
    :data:`SUPERVISED_CHILD` from this file's directory: (A) to the end;
    (B) under ``TPUMX_CHAOS=crash_at_step=6,hard=1,seed=0`` (exit 137
    expected); (C) a fresh process resuming B; (D) a run sent a real
    SIGTERM once step 3 committed (exit 143: 128 + SIGTERM), then a
    fresh process resuming it.  Returns each run's exit code, output,
    wall time from its launch to its first commit (``resume_ms``) and the
    tail of its standard error."""
    import signal
    here = os.path.dirname(os.path.abspath(__file__))
    env = {k: v for k, v in os.environ.items() if k != "TPUMX_CHAOS"}
    runs = {}

    def launch(name, prefix, mode, chaos=None):
        out = os.path.join(work, f"{name}.json")
        progress = os.path.join(work, f"{name}.progress")
        child = dict(spec, prefix=os.path.join(work, prefix), mode=mode,
                     out=out, progress=progress)
        t0 = time.time()
        proc = subprocess.Popen(
            [sys.executable, "-c", SUPERVISED_CHILD, json.dumps(child)],
            cwd=here, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True, env=dict(env, TPUMX_TELEMETRY=os.path.join(
                work, f"{name}.telemetry.jsonl"), **({"TPUMX_CHAOS": chaos}
                                                     if chaos else {})))
        return proc, t0, out, progress

    def finish(name, proc, t0, out):
        _, err = proc.communicate(timeout=timeout)
        rec = dict(rc=proc.returncode, stderr=err[-2000:],
                   wall_s=time.time() - t0)
        if os.path.exists(out):
            with open(out) as f:
                rec["out"] = json.load(f)
            rec["resume_ms"] = (rec["out"]["commits"][0] - t0) * 1e3
        runs[name] = rec

    for name, prefix, mode, chaos in (
            ("A", "a", "run", None),
            ("B", "b", "crash",
             f"crash_at_step={SUP_CRASH_STEP},hard=1,seed=0"),
            ("C", "b", "run", None)):
        finish(name, *launch(name, prefix, mode, chaos)[:3])
    proc, t0, out, progress = launch("D", "d", "preempt")
    deadline = time.time() + timeout
    while proc.poll() is None and time.time() < deadline:
        if os.path.exists(progress) and str(SUP_PREEMPT_STEP) in \
                open(progress).read().split():
            proc.send_signal(signal.SIGTERM)
            break
        time.sleep(0.05)
    finish("D", proc, t0, out)
    finish("D_resume", *launch("D_resume", "d", "run")[:3])
    return runs


def supervised_resume_checks(runs, crash_step, preempt_step, steps):
    """The resume contract on runs A-D: B exits 137 and D 143; C's first
    recorded step is the one after B's crash, D's resume's the one after
    the preemption; their losses are bit-equal to A's for the same steps,
    their final fingerprints equal A's, and every epoch's manifest
    verifies."""
    def key(n):
        return f"{(n - 1) // steps}:{(n - 1) % steps + 1}"

    a = runs["A"].get("out", {})
    checks = {"A_completed": runs["A"]["rc"] == 0
              and a.get("result", {}).get("status") == "completed",
              "B_exit_137": runs["B"]["rc"] == 137,
              "D_exit_143": runs["D"]["rc"] == 128 + 15}
    for name, first in (("C", crash_step + 1),
                        ("D_resume", preempt_step + 1)):
        out = runs[name].get("out")
        if runs[name]["rc"] != 0 or out is None:
            checks[f"{name}_completed"] = False
            continue
        got = out["losses"]
        checks[f"{name}_completed"] = out["result"]["status"] == "completed"
        checks[f"{name}_first_step"] = next(iter(got)) == key(first)
        checks[f"{name}_steps"] = list(got) == [key(n) for n in range(
            first, SUP_EPOCHS * steps + 1)]
        checks[f"{name}_losses_bit_equal"] = all(
            a.get("losses", {}).get(k) == v for k, v in got.items())
        checks[f"{name}_fingerprint"] = (out["fingerprint"] is not None
                                         and out["fingerprint"]
                                         == a.get("fingerprint"))
        checks[f"{name}_resumed_from_step_capsule"] = any(
            r["used"] == "step" for r in out["restores"])
        checks[f"{name}_manifests_verified"] = all(
            v["status"] == "verified" for v in out["verify"].values())
    return checks


def supervised_spec(cfg):
    """The job at the ``train`` phase's shape: BERT-base bf16 (LAMB with
    float32 masters, dropout 0.1), batch 32 x 512, ragged valid
    lengths, 76 masked positions."""
    return dict(device="cuda", cfg=cfg, dtype="bfloat16", batch=TRAIN_BATCH,
                seq=TRAIN_SEQ, masked=TRAIN_MASKED, valid=list(TRAIN_VALID),
                interval=SUP_INTERVAL)


def supervised_counting(job):
    """Wrap ``job``'s step so that ``job["executed"]`` counts the steps
    that ran (a hung step never reaches its body)."""
    step = job["step"]
    inner = step.step
    job["executed"] = 0

    def counted(*a, **k):
        job["executed"] += 1
        return inner(*a, **k)
    step.step = counted


def supervised_replicas(torch, cfg, work, fa_layers, device="cuda",
                        shape=(TRAIN_BATCH, TRAIN_SEQ, TRAIN_MASKED,
                               TRAIN_VALID), dtype="bfloat16"):
    """The fingerprint vote at ``cfg``'s width and depth ``fa_layers``
    (batch, sequence, masked positions and valid range ``shape``): three
    replicas of one seed fed the same batches, each with an
    ``IntegrityMonitor(interval=2)`` on a shared directory, under chaos
    ``bitflip_param_at_step=3, bitflip_rank=2``.  After each step every
    replica's monitor runs ``on_committed_step`` (one thread each, as
    three processes would).  Returns each step's fingerprints and each
    rank's verdicts."""
    import threading
    from tpu_mx_torch import optimizer
    from tpu_mx_torch.contrib import chaos
    from tpu_mx_torch.models import BERTModel, MLMLoss
    from tpu_mx_torch.parallel import CompiledTrainStep
    from tpu_mx_torch.parallel.integrity import IntegrityMonitor
    from tpu_mx_torch.supervisor import DataCorruption

    rcfg = dict(cfg, num_layers=fa_layers)
    n, seq, masked, (lo, hi) = shape
    rng = np.random.RandomState(SUP_DATA_SEED)
    batches = []
    for _ in range(SUP_STEPS):
        valid = rng.randint(lo, hi + 1, n)
        batches.append(tuple(torch.from_numpy(x).to(device) for x in
                             bert_batch(rcfg, n, seq, masked, valid, rng)))
    ranks = range(SUP_REPLICAS)
    steps, monitors = [], []
    for r in ranks:
        net = BERTModel(rcfg, dtype=dtype, device=device,
                        generator=torch.Generator(device=device)
                        .manual_seed(SUP_SEED))
        opt = optimizer.create("lamb", learning_rate=1e-4,
                               multi_precision=dtype == "bfloat16")
        steps.append(CompiledTrainStep(net, MLMLoss(), opt, device=device))
        monitors.append(IntegrityMonitor(work, rank=r, world=list(ranks),
                                         interval=SUP_INTERVAL,
                                         vote_timeout=60.0))
    fps, verdicts = [], {r: [] for r in ranks}
    with chaos.enable(bitflip_param_at_step=SUP_BITFLIP_STEP,
                      bitflip_rank=SUP_BITFLIP_RANK, seed=0) as cfg_:
        for k, batch in enumerate(batches, 1):
            for r in ranks:
                with env_set(TPUMX_FLEET_MEMBER=str(r)):
                    float(steps[r].step(*batch))
            fps.append([s.fingerprint() for s in steps])

            def vote(r, k=k):
                try:
                    v = monitors[r].on_committed_step(k, fp=fps[-1][r])
                    verdicts[r].append(dict(step=k, agree=None if v is None
                                            else v["agree"]))
                except DataCorruption as e:
                    verdicts[r].append(dict(step=k, agree=False,
                                            minority=list(e.minority),
                                            self_corrupt=e.self_corrupt))
            threads = [threading.Thread(target=vote, args=(r,))
                       for r in ranks]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        bitflips = cfg_.bitflips
    return fps, verdicts, bitflips


def phase_supervised_train(ctx):
    """Supervised, deterministically resumable BERT-base training at full
    width, ``SUP_LAYERS`` deep (bf16, dropout 0.1, LAMB with float32
    masters, batch 32 x 512):
    ``CompiledTrainStep`` under ``Supervisor(capsule=CapsuleManager(
    prefix, iters=[it], state=step, interval=2))`` with
    ``elastic.save_checkpoint``/``auto_resume``.  Runs A-D in fresh
    processes (:func:`supervised_runs`); then in this process: step ms
    with and without the supervisor, a hung step the watchdog turns into
    a restart from the last verified checkpoint, a poisoned loss the
    sentinel skips and then rolls back, the three-replica fingerprint
    vote with one bit flipped on rank 2, and two supervised steps under
    ``mx.profiler`` whose trace holds the flash kernels by name."""
    import shutil
    import tempfile
    import torch
    from tpu_mx_torch import optimizer, profiler, tracing
    from tpu_mx_torch.contrib import chaos
    from tpu_mx_torch.kernels import _build
    from tpu_mx_torch.models import MLMLoss, bert_base_config
    from tpu_mx_torch.parallel import CompiledTrainStep
    from tpu_mx_torch.supervisor import Supervisor

    t_phase = time.perf_counter()
    cfg = dict(bert_base_config(max_len=TRAIN_SEQ), num_layers=SUP_LAYERS)
    spec = supervised_spec(cfg)
    layers = cfg["num_layers"]
    _build.BUILD_DIR.parent.mkdir(parents=True, exist_ok=True)
    work = tempfile.mkdtemp(prefix="supervised_train-",
                            dir=str(_build.BUILD_DIR.parent))
    out = {}
    try:
        torch.cuda.empty_cache()
        runs = supervised_runs(spec, work)
        checks = supervised_resume_checks(runs, SUP_CRASH_STEP,
                                          SUP_PREEMPT_STEP, SUP_STEPS)
        a = runs["A"].get("out", {})
        out["runs"] = {
            name: dict(rc=r["rc"], wall_s=r["wall_s"],
                       resume_ms=r.get("resume_ms"),
                       first_step=next(iter(r["out"]["losses"]), None)
                       if "out" in r else None,
                       fingerprint=r.get("out", {}).get("fingerprint"),
                       **({} if r["rc"] in (0, 137, 143)
                          else {"stderr": r["stderr"][-1500:]}))
            for name, r in runs.items()}
        out["losses_A"] = a.get("losses")
        out["capsule"] = dict(
            bytes=[c["bytes"] for c in a.get("capsules", [])],
            write_ms=[c["seconds"] * 1e3 for c in a.get("capsules", [])])
        out["checkpoint"] = dict(
            bytes=[v["bytes"] for v in a.get("verify", {}).values()],
            save_s=a.get("saves"),
            verify_s=[v["seconds"] for v in a.get("verify", {}).values()])
        out["resume_ms"] = {n: runs[n].get("resume_ms")
                            for n in ("C", "D_resume")}
        # run C's documents (the resume after the crash) through the
        # report tools
        out["report_tools"] = report_tools((
            ("blackbox", "blackbox_report",
             [tracing.blackbox_path(os.path.join(work, "b"))]),
            ("telemetry", "telemetry_report",
             [os.path.join(work, "C.telemetry.jsonl")]),
            ("slo", "slo_report", [os.path.join(work, "C.telemetry.jsonl"),
                                   "--box", tracing.blackbox_path(
                                       os.path.join(work, "b"))])))
        checks["report_tools_validate"] = all(
            r["rc"] == 0 for r in out["report_tools"].values())

        # -- in this process: the main path's counts from 0
        reset_port_kernel_launches()
        executed = 0
        # step ms with and without the supervisor, then the phases' host ms
        job = supervised_job(dict(spec, prefix=os.path.join(work, "t"),
                                  interval=0, deadline=SUP_DEADLINE))
        supervised_counting(job)
        step, sup, it = job["step"], job["sup"], job["it"]
        it.reset()
        batches = [next(it) for _ in range(SUP_STEPS)]
        float(step.step(*batches[0].data, *batches[0].label).asnumpy())
        plain_ms, sup_ms = [], []
        for b in batches[1:1 + SUP_TIMED_STEPS]:
            t0 = time.perf_counter()
            float(step.step(*b.data, *b.label).asnumpy())
            plain_ms.append((time.perf_counter() - t0) * 1e3)
        tracing.reset()
        for b in batches[1:1 + SUP_TIMED_STEPS]:
            t0 = time.perf_counter()
            sup.step(lambda b=b: step.step(*b.data, *b.label))
            sup_ms.append((time.perf_counter() - t0) * 1e3)
        phase_ms = {}
        for e in tracing.snapshot():
            if e["event"] == "train_step.phase":
                phase_ms.setdefault(e["data"]["phase"], []).append(
                    e["data"]["seconds"] * 1e3)
        out["step_ms"] = dict(plain=plain_ms, supervised=sup_ms)
        out["phase_host_ms"] = {p: statistics.mean(v)
                                for p, v in phase_ms.items()}
        # two supervised steps of a fresh step under the profiler
        profile = os.path.join(work, "profile.json")
        profiler.set_config(filename=profile)
        pstep = CompiledTrainStep(job["net"], MLMLoss(), optimizer.create(
            "lamb", learning_rate=1e-4, multi_precision=True))
        psup = Supervisor(backoff=0.0)
        before = port_kernel_launches()
        profiler.set_state("run")
        for b in batches[:SUP_PROFILE_STEPS]:
            psup.step(lambda b=b: pstep.step(*b.data, *b.label))
        profiler.set_state("stop")
        table = profiler.dumps()
        profiled = {k: n - before[k] for k, n in
                    port_kernel_launches().items()}
        with open(profile) as f:
            trace = json.load(f)["traceEvents"]
        in_trace = {k: sum(1 for e in trace if e.get("cat") == "kernel"
                           and sym in e["name"])
                    for k, sym in (("flash_attention_fwd",
                                    "flash_fwd_tc_kernel"),
                                   ("flash_attention_bwd_dq",
                                    "flash_dq_tc_kernel"),
                                   ("flash_attention_bwd_dkv",
                                    "flash_dkv_tc_kernel"))}
        spans = {e["name"] for e in trace if e.get("cat") == "tracing"}
        executed += job["executed"] + SUP_PROFILE_STEPS
        out["profiler"] = dict(kernels_in_trace=in_trace,
                               launches=profiled, events=len(trace),
                               table=table.splitlines())
        print(table, flush=True)
        checks["profiler_kernels"] = all(
            in_trace[k] == profiled[k] == layers * SUP_PROFILE_STEPS
            for k in FLASH_KERNELS)
        checks["profiler_phases"] = all(
            f"train_step.phase:{p}" in spans
            for p in tracing.TRAIN_STEP_PHASES)
        del job, pstep, psup, step, sup, batches
        torch.cuda.empty_cache()

        # a hung step: the watchdog fires, the supervisor restarts from the
        # last verified checkpoint (epoch 0's) and finishes
        job = supervised_job(dict(spec, prefix=os.path.join(work, "h"),
                                  interval=0, deadline=SUP_DEADLINE))
        supervised_counting(job)
        with chaos.enable(hang_step=SUP_STEPS + 1, hang_seconds=3600.0):
            res = job["sup"].run(job["epoch_fn"], 0, SUP_EPOCHS)
        fires = [e["ts"] for e in tracing.snapshot()
                 if e["event"] == "supervisor.watchdog_fire"]
        after = [t for t in job["commits"] if fires and t > fires[-1]]
        out["hang"] = dict(result=res.as_dict(), restart_ms=(
            (after[0] - fires[-1]) * 1e3 if after else None),
            steps_run=job["executed"])
        checks["watchdog_restart"] = (res.ok and res.watchdog_fires == 1
                                      and res.restarts == 1
                                      and bool(after))
        executed += job["executed"]
        del job
        torch.cuda.empty_cache()

        # a poisoned loss: skipped within the budget, then past it a
        # rollback to epoch 0's checkpoint
        job = supervised_job(dict(spec, prefix=os.path.join(work, "n"),
                                  interval=0,
                                  sup_kwargs=dict(skip_limit=1)))
        supervised_counting(job)
        with chaos.enable(nan_after=SUP_STEPS + 2, nan_streak=2):
            res = job["sup"].run(job["epoch_fn"], 0, SUP_EPOCHS)
        out["nan"] = dict(result=res.as_dict(), steps_run=job["executed"])
        checks["sentinel_skip_then_rollback"] = (
            res.ok and res.batches_skipped == 1 and res.rollbacks == 1)
        executed += job["executed"]
        del job
        torch.cuda.empty_cache()
        full = port_kernel_launches()

        # the fingerprint vote of three replicas at depth 2
        reset_port_kernel_launches()
        fps, verdicts, bitflips = supervised_replicas(
            torch, cfg, os.path.join(work, "vote"), SUP_REPLICA_LAYERS)
        torch.cuda.empty_cache()
        replica = port_kernel_launches()
        flip = SUP_BITFLIP_STEP
        out["integrity"] = dict(fingerprints=fps, verdicts=verdicts,
                                bitflips=bitflips)
        checks["ranks_0_1_agree"] = all(f[0] == f[1] is not None
                                        for f in fps)
        checks["rank_2_diverges_after_the_flip"] = all(
            (f[2] == f[0]) == (k <= flip) for k, f in enumerate(fps, 1))
        checks["vote_step_2_agrees"] = all(
            v[1] == dict(step=2, agree=True) for v in verdicts.values())
        checks["vote_names_rank_2"] = all(
            verdicts[r][3] == dict(step=4, agree=False, minority=[2],
                                   self_corrupt=r == 2)
            for r in range(SUP_REPLICAS))
        launches = {k: full[k] + replica[k] for k in full}
        want = layers * executed + SUP_REPLICA_LAYERS * SUP_REPLICAS \
            * SUP_STEPS
        checks["flash_launches"] = all(launches[k] == want
                                       for k in FLASH_KERNELS)
        checks["paged_idle"] = launches["paged_attention"] == 0
        out["steps_executed"] = executed
    finally:
        shutil.rmtree(work, ignore_errors=True)
    ctx["supervised_train_launches"] = launches
    emit("supervised_train", ok=all(checks.values()), checks=checks,
         model={**cfg, "dtype": "bfloat16"},
         batch=dict(batch=TRAIN_BATCH, seq=TRAIN_SEQ, masked=TRAIN_MASKED,
                    valid_length=list(TRAIN_VALID)),
         epochs=SUP_EPOCHS, steps_per_epoch=SUP_STEPS,
         capsule_interval=SUP_INTERVAL, **out, launches=launches,
         seconds=time.perf_counter() - t_phase, card=ctx["smi"])
    for name, ok in checks.items():
        if not ok:
            ctx["failures"].append(f"supervised_train check {name} failed")


# -- engine.bulk() and fusion, the kvstore, elastic fleets ------------------
FUSION_BULK = 64                 # engine.bulk(64): bench.py's fusion leg
FUSION_SHAPES = (("bench", (64, 64)), ("bert_activation", (32, 512, 768)))
FUSION_REPS = {"bench": 50, "bert_activation": 10}
FUSION_HOST_N = {"bench": 200, "bert_activation": 20}  # the queue never fills
FUSION_SGD = dict(lr=0.01, wd=1e-4)
# a learning rate that moves every step: each value is a new chain (lr is
# in sgd_update's fuse key) and new graphs, which the cache's byte bound
# must hold to GRAPH_CACHE_BYTES
FUSION_LR_SCHEDULE = tuple(0.01 * 0.9 ** k for k in range(1, 7))
KV_STEPS = 3                     # timed steps an arm (after one warm-up)
# the kvstore and fleet phases' BERT: BERT-base's width, 4 of its 12
# layers (the script's time: with the graph phase the whole script took
# 1150.5 s on a slow host at 12, and with the head dims of 320 and more
# 1061.2 s at 6; the stores' and the fleet's traffic is the parameters',
# which the embeddings dominate, and their checks compare arms alike)
KV_LAYERS = 4
KV_DIST_RANK_BATCH = 16          # dist_sync: 16 x 512 a rank, 32 x 512 global
FLEET_GLOBAL_BATCH = 32          # the churn run's global batch, 32 x 512
FLEET_STRAGGLER_STEPS = 14
FLEET_SLOW_SECONDS = 0.3
FLEET_LEASE = 4.0                # seconds a worker's heartbeat is good for
CHILD_TIMEOUT = 420

WORKER_CHILD = r'''
import time
T0 = time.time()                # the process's start, before any import
import json, os, sys
spec = json.loads(sys.argv[1])
spec["t0"] = T0
if spec.get("no_group"):     # the fleet protocol alone, no collective group
    for k in ("TPUMX_COORDINATOR", "TPUMX_NUM_PROC", "TPUMX_PROC_ID"):
        os.environ.pop(k, None)
import chip_smoke as cs
sys.exit(getattr(cs, spec["fn"])(spec))
'''


def chain32(nd, x):
    """bench.py's fusion chain (``bench.py:950-1010``): sin, x1.0009,
    +0.1, tanh, 8 times — 32 elementwise ops."""
    y = x
    for _ in range(8):
        y = nd.sin(y)
        y = y * 1.0009
        y = y + 0.1
        y = nd.tanh(y)
    return y


LAUNCH_APIS = ("cudaLaunchKernel", "cudaGraphLaunch", "cudaMemcpy")


def profiled_launches(torch, fn):
    """One call of ``fn`` under the profiler: the card's kernel and copy
    executions, and the host's launch API calls by name."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    device = sum(e.count for e in events
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and e.self_device_time_total > 0)
    host = dict.fromkeys(LAUNCH_APIS, 0)
    for e in events:
        for api in LAUNCH_APIS:
            if e.key.startswith(api):
                host[api] += e.count
    return dict(device=device, host_calls=host,
                host_total=sum(host.values()))


def fusion_chain_case(torch, nd, autograd, engine, shape, name):
    """The 32-op chain at ``shape`` (f32) eager against bulk(64): outputs
    and gradients bit-equal, ms, host us and launches a chain."""
    g = torch.Generator(device="cuda").manual_seed(5)
    xt = torch.randn(shape, generator=g, device="cuda")
    x = nd.array(xt)

    def eager():
        return chain32(nd, x)._data

    def fused():
        with engine.bulk(FUSION_BULK):
            y = chain32(nd, x)
        return y._data

    out = dict(shape=list(shape))
    out["equal_forward"] = bool(torch.equal(eager(), fused()))

    def grads(bulk):
        xa = nd.array(xt)
        xa.attach_grad()
        with autograd.record():
            with engine.bulk(bulk):
                y = chain32(nd, xa)
                loss = y.sum()
        loss.backward()
        return y._data.clone(), xa.grad._data.clone(), loss._data.clone()
    (ey, eg, el), (fy, fg, fl) = grads(1), grads(FUSION_BULK)
    out["equal_backward"] = bool(torch.equal(ey, fy) and torch.equal(eg, fg)
                                 and torch.equal(el, fl))
    for kind, fn in (("eager", eager), ("fused", fused)):
        out[f"{kind}_ms"] = cuda_ms(torch, fn, reps=FUSION_REPS[name])
        out[f"{kind}_host_us"] = host_us(torch, fn, n=FUSION_HOST_N[name])
        out[f"{kind}_launches"] = profiled_launches(torch, fn)
    n = xt.numel()
    # each op reads and writes the tensor once: 32 x 8 bytes an element
    out["bound_ms_op_by_op"] = bound(32 * 8 * n, 0)[0]
    out["bound_ms_one_pass"] = bound(8 * n, 0)[0]
    return out


def fusion_sgd_sweep(torch, nd, engine):
    """``nd.sgd_update`` over every BERT-base parameter shape (f32),
    eager against bulk(64): bit-equal results, ms and launches."""
    from tpu_mx_torch.models import BERTModel, bert_base_config
    net = BERTModel(bert_base_config(max_len=TRAIN_SEQ), dtype="bfloat16",
                    device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(0))
    shapes = [tuple(p.shape) for p in net.parameters()]
    del net
    g = torch.Generator(device="cuda").manual_seed(6)
    ws = [nd.array(torch.randn(s, generator=g, device="cuda"))
          for s in shapes]
    gs = [nd.array(torch.randn(s, generator=g, device="cuda") * 1e-3)
          for s in shapes]

    def eager():
        return [nd.sgd_update(w, gr, **FUSION_SGD)._data
                for w, gr in zip(ws, gs)]

    def fused():
        with engine.bulk(FUSION_BULK):
            outs = [nd.sgd_update(w, gr, **FUSION_SGD)
                    for w, gr in zip(ws, gs)]
        return [o._data for o in outs]
    equal = all(torch.equal(a, b) for a, b in zip(eager(), fused()))
    n = sum(int(np.prod(s)) for s in shapes)
    out = dict(keys=len(shapes), params=n, equal=bool(equal),
               eager_ms=cuda_ms(torch, eager, reps=5, warm=1),
               fused_ms=cuda_ms(torch, fused, reps=5, warm=1),
               eager_launches=profiled_launches(torch, eager),
               fused_launches=profiled_launches(torch, fused),
               bound_ms=bound(12 * n, 0)[0])   # read w, g; write w'
    out["lr_schedule"] = fusion_lr_schedule(torch, nd, engine, ws, gs)
    del ws, gs
    return out


def fusion_lr_schedule(torch, nd, engine, ws, gs):
    """The sweep under a learning rate that changes every step
    (``FUSION_LR_SCHEDULE``): each step bit-equal to eager, and the
    graph cache's bytes, graphs, captures and evictions after each, with
    the card's reserved memory."""
    from tpu_mx_torch import fusion
    steps = []
    for lr in FUSION_LR_SCHEDULE:
        kw = dict(FUSION_SGD, lr=lr)
        eager = [nd.sgd_update(w, gr, **kw)._data for w, gr in zip(ws, gs)]
        t0 = time.perf_counter()
        with engine.bulk(FUSION_BULK):
            outs = [nd.sgd_update(w, gr, **kw) for w, gr in zip(ws, gs)]
        fused = [o._data for o in outs]
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        st = fusion.graph_stats()
        steps.append(dict(
            lr=lr, equal=all(torch.equal(a, b)
                             for a, b in zip(eager, fused)),
            fused_ms_with_capture=ms, graphs=st["graphs"],
            graph_bytes=st["bytes"], captures=st["captures"],
            evictions=st["evictions"],
            reserved_bytes=torch.cuda.memory_reserved()))
        del eager, outs, fused
    return dict(steps=steps, capacity_bytes=fusion.GRAPH_CACHE_BYTES,
                equal=all(x["equal"] for x in steps),
                within_bound=all(x["graph_bytes"] <= fusion.GRAPH_CACHE_BYTES
                                 or x["graphs"] == 1 for x in steps),
                evicted=steps[-1]["evictions"] > steps[0]["evictions"])


def fusion_mnist_example(torch, fusion_env):
    """``examples/mnist/train_mnist.py`` unedited through the alias with
    ``TPUMX_FUSION=<fusion_env>``: its printed rates, its loss at every
    step (a recording subclass of the loss stands in for the port's), the
    engine's counters."""
    from tpu_mx_torch import engine, fusion, gluon, random
    losses = []
    base = gluon.loss.SoftmaxCrossEntropyLoss

    class Recorded(base):
        def __call__(self, *args, **kwargs):
            out = super().__call__(*args, **kwargs)
            losses.append(out._data.detach().float().mean())
            return out
    saved = os.environ.get("TPUMX_FUSION")
    os.environ["TPUMX_FUSION"] = fusion_env
    gluon.loss.SoftmaxCrossEntropyLoss = Recorded
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    random.seed(0)
    np.random.seed(0)
    engine.reset_bulk_stats()
    graphs0 = fusion.graph_stats()["captures"]
    try:
        _, text, seconds, loaded = run_example(
            "mnist/train_mnist.py", ["train_mnist.py"],
            port_alias("models", "models.lenet"))
    finally:
        gluon.loss.SoftmaxCrossEntropyLoss = base
        torch.backends.cudnn.deterministic = det
        if saved is None:
            os.environ.pop("TPUMX_FUSION", None)
        else:
            os.environ["TPUMX_FUSION"] = saved
    rates = [float(m) for m in re.findall(r"\((\d+) img/s\)", text)]
    final = re.findall(r"final accuracy: ([0-9.]+)", text)
    stats = engine.bulk_stats()
    return dict(images_per_sec=rates, final_accuracy=float(final[0])
                if final else None, seconds=seconds,
                reference_modules=loaded, steps=len(losses),
                losses=torch.stack(losses).cpu() if losses else None,
                ops_fused=stats["ops_fused"],
                segments_flushed=stats["segments_flushed"],
                flush_reasons=stats["flush_reasons"],
                graph_captures=fusion.graph_stats()["captures"] - graphs0)


def data_property_cost(torch, nd):
    """What the lazy ``_data`` property adds to an eager op: ns an access
    (property against the slot beneath it), the accesses one ``nd.relu``
    on an array makes, and that op's host us."""
    from tpu_mx_torch.ndarray.ndarray import NDArray
    a = nd.array(torch.ones(128, device="cuda"))
    n = 200000
    t0 = time.perf_counter()
    for _ in range(n):
        a._data
    prop_ns = (time.perf_counter() - t0) / n * 1e9
    t0 = time.perf_counter()
    for _ in range(n):
        a._buf
    slot_ns = (time.perf_counter() - t0) / n * 1e9
    prop = NDArray.__dict__["_data"]
    count = [0]

    def counting(self):
        count[0] += 1
        return prop.fget(self)
    NDArray._data = property(counting, prop.fset)
    try:
        nd.relu(a)
    finally:
        NDArray._data = prop
    op_us = host_us(torch, lambda: nd.relu(a), n=2000)
    return dict(property_ns=prop_ns, slot_ns=slot_ns,
                reads_per_op=count[0], eager_relu_host_us=op_us,
                added_us_per_op=(prop_ns - slot_ns) * count[0] / 1e3)


def phase_fusion(ctx):
    """``engine.bulk()`` on the card: the 32-op chain at bench.py's
    (64, 64) and at BERT-base's activation (32 x 512 x 768), eager
    against bulk(64) (one CUDA-graph replay a flush): outputs and
    gradients bit-equal, ms, host us and launches a chain; the
    ``sgd_update`` sweep over BERT-base's parameters; the MNIST example
    unedited with ``TPUMX_FUSION=1`` and ``=0`` (a cold pair, then a
    timed pair; all four runs' losses equal); the host cost of the lazy
    ``_data`` property."""
    import torch
    from tpu_mx_torch import autograd, engine, fusion, nd

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    reset_port_kernel_launches()
    out = {"chains": {}}
    for name, shape in FUSION_SHAPES:
        out["chains"][name] = fusion_chain_case(torch, nd, autograd, engine,
                                                shape, name)
    out["sgd_sweep"] = fusion_sgd_sweep(torch, nd, engine)
    out["data_property"] = data_property_cost(torch, nd)
    # a cold pair first (cuDNN's and the allocator's warm-up), then the
    # pair that is timed, in the other order
    cold = {env: fusion_mnist_example(torch, env) for env in ("0", "1")}
    runs = {env: fusion_mnist_example(torch, env) for env in ("1", "0")}
    launches = port_kernel_launches()
    ctx["fusion_launches"] = launches
    losses = [r.pop("losses") for r in (*cold.values(), *runs.values())]
    out["mnist_example"] = dict(
        runs, cold_images_per_sec={k: r["images_per_sec"]
                                   for k, r in cold.items()},
        losses_equal=all(x is not None and torch.equal(x, losses[0])
                         for x in losses),
        first_last_loss=[float(losses[0][0]), float(losses[0][-1])])
    out["mnist_boundary_host_us"] = ctx.get("mnist", {}).get("boundary_us")
    out["graph_stats"] = fusion.graph_stats()
    out["cache_stats"] = fusion.cache_stats()
    chains = out["chains"].values()
    checks = {
        "chains_forward_bit_equal": all(c["equal_forward"] for c in chains),
        "chains_backward_bit_equal": all(c["equal_backward"]
                                         for c in chains),
        "chain_one_graph_launch": all(
            c["fused_launches"]["host_calls"]["cudaGraphLaunch"] == 1
            for c in chains),
        "sgd_sweep_bit_equal": out["sgd_sweep"]["equal"],
        "lr_schedule_bit_equal": out["sgd_sweep"]["lr_schedule"]["equal"],
        "lr_schedule_graphs_within_bytes":
            out["sgd_sweep"]["lr_schedule"]["within_bound"]
            and out["sgd_sweep"]["lr_schedule"]["evicted"],
        "mnist_losses_equal": out["mnist_example"]["losses_equal"],
        "mnist_fusion_off_is_eager": runs["0"]["ops_fused"] == 0,
        "mnist_accuracy": all((runs[k]["final_accuracy"] or 0)
                              > MNIST_MIN_ACC for k in ("1", "0")),
        "no_reference_modules": not any(runs[k]["reference_modules"]
                                        for k in ("1", "0")),
    }
    emit("fusion", ok=all(checks.values()), checks=checks, **out,
         bulk=FUSION_BULK, launches=launches,
         seconds=time.perf_counter() - t_phase, card=ctx["smi"])
    for name, ok in checks.items():
        if not ok:
            ctx["failures"].append(f"fusion check {name} failed")
    torch.cuda.empty_cache()


def kv_trainer_arm(torch, net, kv_args):
    """A ``Trainer("lamb", multi_precision)`` over ``net`` with the arm's
    kvstore arguments, its ``allreduce_grads`` timed (the push/pull host
    ms a step)."""
    from tpu_mx_torch import gluon
    trainer = gluon.Trainer(net.collect_params(), "lamb",
                            {"learning_rate": 1e-4, "multi_precision": True},
                            **kv_args)
    reduce_ms = []
    inner = trainer.allreduce_grads

    def timed():
        t0 = time.perf_counter()
        inner()
        torch.cuda.synchronize()
        reduce_ms.append((time.perf_counter() - t0) * 1e3)
    trainer.allreduce_grads = timed
    return trainer, reduce_ms


def kv_card_checksums(torch, nd):
    """The store's checksum on the card: a list push and pull of BERT-
    base-sized keys verified there (a word sum a key, one host read a
    pull), and one corrupted aggregate refused at pull."""
    from tpu_mx_torch import kvstore
    kv = kvstore.create("device")
    keys = list(range(4))
    vals = [nd.ones((768, 768), dtype="bfloat16") * float(k + 1)
            for k in keys]
    for k in keys:
        kv.init(k, nd.zeros((768, 768), dtype="bfloat16"))
    kv.push(keys, vals)
    on_card = all(isinstance(kv._checksums[k], torch.Tensor)
                  and kv._checksums[k].is_cuda for k in keys)
    outs = [nd.zeros((768, 768), dtype="bfloat16") for _ in keys]
    kv.pull(keys, outs)
    clean = all(bool((o._data == k + 1).all()) for k, o in zip(keys, outs))
    kv.push(keys, vals)
    kv._store["_pending_2"]._data[3, 5] += 1
    try:
        kv.pull(keys, outs)
        refused = False
    except kvstore.IntegrityError as e:
        refused = "pull(2)" in str(e)
    return dict(checksums_on_card=on_card, clean_pull=clean,
                tamper_refused=refused)


KV_ARMS = (("none", {"kvstore": None}), ("device", {"kvstore": "device"}),
           ("update_on_kvstore", {"kvstore": "device",
                                  "update_on_kvstore": True}),
           ("compression_2bit", {"compression_params": {"type": "2bit"}}))


def kvstore_dist_child(spec):
    """One rank of the two-process ``dist_sync`` run (under the port's
    launcher; ``import tpu_mx_torch`` joined the gloo group): the
    reference's known-values push/pull at BERT-base's parameter shapes,
    then 1 + ``KV_STEPS`` imperative BERT-base steps (bf16, LAMB) on this
    rank's 16 x 512 shard through ``Trainer(kvstore="dist_sync")``, the
    weights' fingerprint after each."""
    import torch
    import torch.distributed as dist
    import tpu_mx_torch as mx
    from tpu_mx_torch import nd
    from tpu_mx_torch.models import BERTModel, MLMLoss, bert_base_config
    from tpu_mx_torch.parallel import integrity
    rank, world = dist.get_rank(), dist.get_world_size()
    cfg = dict(bert_base_config(max_len=TRAIN_SEQ), num_layers=KV_LAYERS)
    res = dict(rank=rank, world=world, backend=dist.get_backend())
    with mx.gpu(0):
        net = BERTModel(cfg, dtype="bfloat16", device="cuda",
                        generator=torch.Generator(device="cuda")
                        .manual_seed(0))
        kv = mx.kv.create("dist_sync")
        res["kv"] = [kv.rank, kv.num_workers]
        shapes = [tuple(p.shape) for p in net.parameters()]
        for k, s in enumerate(shapes):
            kv.init(k, nd.zeros(s, dtype="bfloat16"))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for k, s in enumerate(shapes):
            kv.push(k, nd.ones(s, dtype="bfloat16") * float(rank + 1))
        ok = True
        for k, s in enumerate(shapes):
            o = nd.zeros(s, dtype="bfloat16")
            kv.pull(k, o)
            ok = ok and bool((o._data == world * (world + 1) / 2).all())
        torch.cuda.synchronize()
        res.update(known_values_ok=ok, known_keys=len(shapes),
                   known_ms=(time.perf_counter() - t0) * 1e3)
        rng = np.random.RandomState(0)
        gb = KV_DIST_RANK_BATCH * world
        valid = rng.randint(TRAIN_VALID[0], TRAIN_VALID[1] + 1, gb)
        batch = bert_batch(cfg, gb, TRAIN_SEQ, TRAIN_MASKED, valid, rng)
        lo, hi = rank * KV_DIST_RANK_BATCH, (rank + 1) * KV_DIST_RANK_BATCH
        arrays = [nd.array(torch.from_numpy(b[lo:hi]).cuda()) for b in batch]
        trainer, reduce_ms = kv_trainer_arm(torch, net,
                                            {"kvstore": "dist_sync"})
        reset_port_kernel_launches()
        losses, fps, step_ms = [], [], []
        for _ in range(1 + KV_STEPS):
            t0 = time.perf_counter()
            losses.append(imperative_bert_step(net, trainer, MLMLoss(),
                                               arrays))
            step_ms.append((time.perf_counter() - t0) * 1e3)
            fps.append(int(integrity.device_fingerprint(
                [p.data()._data for p in net.collect_params().values()])))
        res.update(losses=losses, fingerprints=fps, step_ms=step_ms,
                   reduce_ms=reduce_ms, keys=len(trainer._params),
                   launches=port_kernel_launches())
    with open(spec["out"] % rank, "w") as f:
        json.dump(res, f)
    return 0


def phase_kvstore(ctx):
    """The kvstore on the card: the imperative BERT-base step (bf16,
    LAMB, 32 x 512) through ``Trainer`` with each kvstore argument
    against ``kvstore=None`` from the same weights (losses bit-equal
    where the store sums one copy), ms a step and the push/pull host ms
    a step over its keys; then two processes on the card from the port's
    launcher, ``dist_sync`` over gloo at 16 x 512 a rank: the known
    values, three steps with the replicas' weights bit-equal after each,
    ms a step and ms of the host-staged reduction a step."""
    import tempfile
    import torch
    import tpu_mx_torch as mx
    from tpu_mx_torch import nd, telemetry
    from tpu_mx_torch.kernels import _build
    from tpu_mx_torch.models import BERTModel, MLMLoss, bert_base_config

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    cfg = dict(bert_base_config(max_len=TRAIN_SEQ), num_layers=KV_LAYERS)
    rng = np.random.RandomState(0)
    valid = rng.randint(TRAIN_VALID[0], TRAIN_VALID[1] + 1, TRAIN_BATCH)
    batch = bert_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, TRAIN_MASKED, valid, rng)
    out = {"arms": {}}
    with mx.gpu(0):
        arrays = [nd.array(torch.from_numpy(b).cuda()) for b in batch]
        nets = {name: BERTModel(cfg, dtype="bfloat16", device="cuda",
                                generator=torch.Generator(device="cuda")
                                .manual_seed(0)) for name, _ in KV_ARMS}
        arms = {name: kv_trainer_arm(torch, nets[name], kw)
                for name, kw in KV_ARMS}
        losses = {name: [] for name in arms}
        step_ms = {name: [] for name in arms}
        pushes0 = getattr(telemetry.get("kvstore.pushes"), "value", 0)
        reset_port_kernel_launches()
        for i in range(1 + KV_STEPS):
            for name, (trainer, _) in arms.items():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                losses[name].append(imperative_bert_step(
                    nets[name], trainer, MLMLoss(), arrays))
                step_ms[name].append((time.perf_counter() - t0) * 1e3)
        launches = port_kernel_launches()
        pushes = getattr(telemetry.get("kvstore.pushes"), "value", 0) \
            - pushes0
        keys = len(arms["device"][0]._params)
        for name, (trainer, reduce_ms) in arms.items():
            out["arms"][name] = dict(
                losses=losses[name],
                step_ms_median=statistics.median(step_ms[name][1:]),
                push_pull_host_ms_median=statistics.median(reduce_ms[1:])
                if reduce_ms else None,
                bit_equal_to_none=losses[name] == losses["none"])
        del nets, arms
        out["card_checksums"] = kv_card_checksums(torch, nd)
    torch.cuda.empty_cache()
    _build.BUILD_DIR.parent.mkdir(parents=True, exist_ok=True)
    work = tempfile.mkdtemp(prefix="kvstore-", dir=str(_build.BUILD_DIR.parent))
    spec = dict(fn="kvstore_dist_child",
                out=os.path.join(work, "rank%d.json"))
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "tpu_mx_torch.tools.launch", "-n", "2",
         sys.executable, "-c", WORKER_CHILD, json.dumps(spec)],
        cwd=here, capture_output=True, text=True, timeout=CHILD_TIMEOUT)
    dist_wall = time.perf_counter() - t0
    ranks = []
    for i in range(2):
        path = spec["out"] % i
        if os.path.exists(path):
            with open(path) as f:
                ranks.append(json.load(f))
    dist = dict(rc=r.returncode, wall_s=dist_wall,
                stderr=r.stderr[-1500:] if r.returncode else "")
    if len(ranks) == 2:
        dist.update(
            backend=ranks[0]["backend"], known_keys=ranks[0]["known_keys"],
            known_values_ok=[x["known_values_ok"] for x in ranks],
            known_ms=[x["known_ms"] for x in ranks],
            losses=[x["losses"] for x in ranks],
            fingerprints=[x["fingerprints"] for x in ranks],
            step_ms_median=[statistics.median(x["step_ms"][1:])
                            for x in ranks],
            reduce_ms_median=[statistics.median(x["reduce_ms"][1:])
                              for x in ranks],
            keys=ranks[0]["keys"], kv=[x["kv"] for x in ranks])
        for name in launches:
            launches[name] += sum(x["launches"][name] for x in ranks)
    out["dist_sync"] = dist
    ctx["kvstore_launches"] = launches
    fps = dist.get("fingerprints", [[], [None]])
    checks = {
        "device_bit_equal": out["arms"]["device"]["bit_equal_to_none"],
        "update_on_kvstore_bit_equal":
            out["arms"]["update_on_kvstore"]["bit_equal_to_none"],
        "compression_first_step_equal":
            out["arms"]["compression_2bit"]["losses"][0]
            == out["arms"]["none"]["losses"][0],
        "finite": all(math.isfinite(v) for a in out["arms"].values()
                      for v in a["losses"]),
        "pushed_every_key": pushes == 3 * keys * (1 + KV_STEPS),
        "card_checksums": all(out["card_checksums"].values()),
        "flash_launches": all(launches[k] > 0 for k in FLASH_KERNELS),
        "dist_rc": dist["rc"] == 0,
        "dist_known_values": all(dist.get("known_values_ok", [False])),
        "dist_replicas_bit_equal": len(fps) == 2 and fps[0] == fps[1]
        and len(set(fps[0])) == 1 + KV_STEPS,
        "dist_group": dist.get("backend") == "gloo"
        and dist.get("kv") == [[0, 2], [1, 2]],
    }
    emit("kvstore", ok=all(checks.values()), checks=checks, **out,
         keys=keys, pushes=pushes, model={**cfg, "dtype": "bfloat16"},
         batch=dict(batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                    dist_rank_batch=KV_DIST_RANK_BATCH),
         optimizer="Trainer lamb lr=1e-4 multi_precision",
         launches=launches, seconds=time.perf_counter() - t_phase,
         card=ctx["smi"])
    for name, ok in checks.items():
        if not ok:
            ctx["failures"].append(f"kvstore check {name} failed")


def fleet_child(spec):
    """One fleet worker under ``python -m tpu_mx_torch.tools.launch
    --supervise`` (:func:`fleet_worker`), each step a BERT-base training
    step (bf16, LAMB, ``CompiledTrainStep``) on this rank's shard of a
    32 x 512 global batch on the card."""
    import torch
    from tpu_mx_torch import optimizer
    from tpu_mx_torch.models import BERTModel, MLMLoss, bert_base_config
    from tpu_mx_torch.parallel import CompiledTrainStep

    cfg = dict(bert_base_config(max_len=TRAIN_SEQ), num_layers=KV_LAYERS)
    net = BERTModel(cfg, dtype="bfloat16", device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(0))
    step_fn = CompiledTrainStep(net, MLMLoss(), optimizer.create(
        "lamb", learning_rate=1e-4, multi_precision=True), device="cuda")
    rng = np.random.RandomState(0)
    valid = rng.randint(TRAIN_VALID[0], TRAIN_VALID[1] + 1,
                        FLEET_GLOBAL_BATCH)
    glob = [torch.from_numpy(b).cuda() for b in bert_batch(
        cfg, FLEET_GLOBAL_BATCH, TRAIN_SEQ, TRAIN_MASKED, valid, rng)]

    def train(r, w):
        lb = FLEET_GLOBAL_BATCH // w
        return float(step_fn.step(*[b[r * lb:(r + 1) * lb] for b in glob]))
    return fleet_worker(spec, train)


def fleet_worker(spec, train):
    """The fleet protocol of one worker: the reference's churn worker
    (``tests/test_fleet.py``: join, admission, the sample-id ledger over a
    sharded NDArrayIter, the published global cursor for late joiners),
    calling ``train(rank, world_size)`` (a training step on that shard;
    returns its loss) at each step.  ``mode`` ``straggler`` runs
    ``FLEET_STRAGGLER_STEPS`` steps and leaves.  The first ``train`` call
    is made before the worker joins (ROADMAP C28): a first step pays the
    card's one-time start-up (the flash kernels' first load, cuBLAS, the
    optimizer's state: 1.5-2.5 s on an H100 beside a second worker, past
    the 4 s lease in one whole run), and a member with no record yet is
    pending, not lost, so no lease runs before the join.  Each worker's
    ledger ends with the longest gap between two renewals of its lease
    and the start-up step's ms."""
    import pickle
    import tpu_mx_torch as mx
    from tpu_mx_torch import checkpoint as ckpt
    from tpu_mx_torch import tracing
    from tpu_mx_torch.elastic import WorkerFailure
    from tpu_mx_torch.io import NDArrayIter
    from tpu_mx_torch.parallel.fleet import Fleet, MembershipChange

    root = spec["root"]
    member = int(os.environ["TPUMX_FLEET_MEMBER"])
    t_start = spec["t0"]
    reset_port_kernel_launches()
    with open(os.path.join(root, f"started-{member}.log"), "a") as fh:
        fh.write(f"{os.getpid()} {t_start} {time.time()}\n")

    f = Fleet.from_env()
    # the start-up step, on the shard of the world the epoch on disk
    # admits (the launch's, or the survivors' after an eviction)
    ep = f.read_epoch()
    world = [int(m) for m in ep["world"]] if ep and ep["world"] else [member]
    t_warm = time.perf_counter()
    train(world.index(member) if member in world else 0, len(world))
    startup_ms = (time.perf_counter() - t_warm) * 1e3
    # every renewal of this worker's lease, with where it happened: the
    # longest gap between two is what the controller's lease must cover
    beats, where = [], ["admission"]
    renew = f.heartbeat

    def heartbeat():
        renew()
        beats.append((time.time(), where[0]))
    f.heartbeat = heartbeat
    f.join()
    beats.append((time.time(), "join"))
    f.await_admission(timeout=60)
    where[0] = "sync"
    sync = time.monotonic() + 20
    for m in f.world():
        if m == f.member:
            continue
        while m not in f.live() and time.monotonic() < sync:
            f.heartbeat()
            time.sleep(0.05)
    r, w = f.shard()
    X = np.arange(64, dtype=np.float32).reshape(64, 1)
    with mx.cpu():
        it = NDArrayIter(X, batch_size=8, shuffle=True, seed=5,
                         last_batch_handle="discard")
    spath = os.path.join(root, "stream.pkl")
    step = 0
    if os.path.exists(spath):
        with open(spath, "rb") as fh:
            pub = pickle.load(fh)
        it.load_state_dict(pub["state"])
        step = pub["step"]
    it.set_shard(r, w)
    straggler = spec["mode"] == "straggler"
    target = FLEET_STRAGGLER_STEPS if straggler else max(16, step + 8)
    post_rejoin = 0
    led = open(os.path.join(root, f"ledger-{member}-{os.getpid()}.jsonl"),
               "a", buffering=1)
    pace = 0.0 if straggler else (0.25 if member == 0 else 0.05)
    deadline = time.monotonic() + 240
    while time.monotonic() < deadline:
        t0 = time.perf_counter()
        where[0] = f"before step {step + 1}"
        try:
            f.on_step()
        except MembershipChange:
            f.ack()
            try:
                r, w = f.shard()
            except WorkerFailure:
                f.join()
                f.await_admission(timeout=60)
                r, w = f.shard()
                if os.path.exists(spath):
                    with open(spath, "rb") as fh:
                        pub = pickle.load(fh)
                    it.load_state_dict(pub["state"])
                    step = pub["step"]
            it.set_shard(r, w)
            led.write(json.dumps({"membership": True, "step": step,
                                  "gen": f.acked_generation,
                                  "world": w}) + "\n")
            continue
        on_step_ms = (time.perf_counter() - t0) * 1e3
        if member == 0 and not straggler:
            if step >= target and f.acked_generation >= 3 \
                    and post_rejoin >= 3:
                break
            if step >= 96:
                break
        elif step >= target:
            break
        with mx.cpu():
            if not it.iter_next():
                it.reset()
                assert it.iter_next()
        step += 1
        if member == 0 and f.acked_generation >= 3:
            post_rejoin += 1
        lb = FLEET_GLOBAL_BATCH // w
        tracing.set_context(epoch=0, step=step)
        t1 = time.perf_counter()
        loss = train(r, w)
        step_ms = (time.perf_counter() - t1) * 1e3
        led.write(json.dumps(
            {"step": step, "gen": f.acked_generation, "rank": r, "world": w,
             "gids": [int(v) for v in it.global_batch_ids()],
             "mine": [int(v) for v in it.getdata()[0].asnumpy().ravel()],
             "loss": loss, "finite": math.isfinite(loss), "batch": lb,
             "step_ms": step_ms, "on_step_ms": on_step_ms,
             "wall": time.time()}) + "\n")
        if r == 0:
            with ckpt.atomic_write(spath, mode="wb") as fh:
                pickle.dump({"step": step, "state": it.state_dict()}, fh)
        time.sleep(pace)
    f.leave()
    gaps = [(b[0] - a[0], a[1]) for a, b in zip(beats, beats[1:])]
    gap = max(gaps, default=(0.0, None))
    led.write(json.dumps({"lease": f.lease, "beats": len(beats),
                          "max_beat_gap_ms": gap[0] * 1e3,
                          "max_gap_after": gap[1],
                          "startup_step_ms": startup_ms}) + "\n")
    with open(os.path.join(root, f"launches-{member}-{os.getpid()}.json"),
              "w") as fh:
        json.dump(port_kernel_launches(), fh)
    led.close()
    return 0


def fleet_run(work, name, chaos):
    """One supervised two-worker run of :func:`fleet_child` through the
    port's launcher; returns its exit code, output tail, wall seconds,
    run directory and fleet directory."""
    root = os.path.join(work, name)
    fdir = os.path.join(work, name + "-fleet")
    os.makedirs(root)
    spec = dict(fn="fleet_child", root=root, no_group=True,
                mode="churn" if "preempt" in chaos else "straggler")
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "tpu_mx_torch.tools.launch", "--supervise",
         "-n", "2", "--fleet-dir", fdir, "--max-restarts", "2",
         "--backoff", "3.0", "--lease", str(FLEET_LEASE), "--join-timeout",
         "120",
         "--env", f"TPUMX_CHAOS={chaos}",
         sys.executable, "-c", WORKER_CHILD, json.dumps(spec)],
        cwd=here, capture_output=True, text=True, timeout=CHILD_TIMEOUT)
    return dict(rc=r.returncode, stderr=r.stderr[-3000:],
                wall_s=time.perf_counter() - t0, root=root, fleet=fdir)


def _jsonl(path):
    with open(path) as fh:
        return [json.loads(line) for line in fh if line.strip()]


def fleet_oracle(steps=128):
    """The uninterrupted global sample-id stream (one 1-worker iterator)."""
    import tpu_mx_torch as mx
    from tpu_mx_torch.io import NDArrayIter
    with mx.cpu():
        it = NDArrayIter(np.arange(64, dtype=np.float32).reshape(64, 1),
                         batch_size=8, shuffle=True, seed=5,
                         last_batch_handle="discard")
        out = {}
        for s in range(1, steps + 1):
            if not it.iter_next():
                it.reset()
                it.iter_next()
            out[s] = [int(v) for v in it.global_batch_ids()]
    return out


def fleet_churn_checks(run):
    """The reference's kill-and-rejoin contract on a churn run's ledgers,
    and its restart, rejoin and per-step times."""
    import glob as _glob
    root = run["root"]
    oracle = fleet_oracle()
    starts = {m: [line.split() for line in open(os.path.join(
        root, f"started-{m}.log")).read().splitlines()] for m in (0, 1)}
    rows0 = [row for p in _glob.glob(os.path.join(root, "ledger-0-*.jsonl"))
             for row in _jsonl(p)]
    steps0 = sorted((row for row in rows0 if "gids" in row),
                    key=lambda row: row["step"])
    hi = steps0[-1]["step"] if steps0 else 0
    worlds = [row["world"] for row in steps0]
    pids1 = [s[0] for s in starts[1]]
    first = [row for row in _jsonl(os.path.join(
        root, f"ledger-1-{pids1[0]}.jsonl")) if "gids" in row] \
        if pids1 else []
    second = [row for row in _jsonl(os.path.join(
        root, f"ledger-1-{pids1[1]}.jsonl")) if "gids" in row] \
        if len(pids1) > 1 else []
    gen = json.loads(open(os.path.join(run["fleet"], "gen.json")).read())
    checks = {
        "rc": run["rc"] == 0,
        "rank1_restarted_once": len(pids1) == 2 and len(starts[0]) == 1,
        "rank0_no_step_skipped_or_repeated":
            [row["step"] for row in steps0] == list(range(1, hi + 1))
            and hi >= 16,
        "rank0_ledger_is_the_oracle": all(row["gids"] == oracle[row["step"]]
                                          for row in steps0),
        "dp_2_1_2": bool(worlds) and worlds[0] == 2 and 1 in worlds
        and worlds[-1] == 2,
        "rejoined_ledger_is_the_oracle": len(second) >= 4 and all(
            row["gen"] >= 3 and row["world"] == 2 and row["rank"] == 1
            and row["gids"] == oracle[row["step"]]
            and row["mine"] == oracle[row["step"]][4:] for row in second),
        "fleet_back_to_full_world": gen["world"] == [0, 1]
        and gen["generation"] >= 3,
        "bert_losses_finite": all(row["finite"] for row in steps0 + second),
    }
    times = {}
    if first and len(starts[1]) > 1:
        times["restart_ms"] = (float(starts[1][1][1]) - first[-1]["wall"]) \
            * 1e3
        times["rejoin_ms"] = (second[0]["wall"] - float(starts[1][1][1])) \
            * 1e3 if second else None
    rows = steps0 + first + second
    times["step_ms_median"] = statistics.median(r["step_ms"] for r in rows)
    times["on_step_host_ms_median"] = statistics.median(
        r["on_step_ms"] for r in rows)
    times["steps"] = {"rank0": hi, "rank1_first": len(first),
                      "rank1_second": len(second)}
    times["batches"] = sorted({(r["world"], r["batch"]) for r in rows})
    return checks, times


def fleet_beat_gaps(root):
    """``{ledger: [ms, where, start-up ms]}``: each finished worker
    process's longest gap between two renewals of its lease, the point it
    ended at, and its start-up step (made before it joined)."""
    import glob as _glob
    gaps = {}
    for p in sorted(_glob.glob(os.path.join(root, "ledger-*.jsonl"))):
        rows = [r for r in _jsonl(p) if "max_beat_gap_ms" in r]
        if rows:
            gaps[os.path.basename(p)[len("ledger-"):-len(".jsonl")]] = [
                rows[-1]["max_beat_gap_ms"], rows[-1]["max_gap_after"],
                rows[-1]["startup_step_ms"]]
    return gaps


def fleet_kernel_launches(root):
    import glob as _glob
    total = dict.fromkeys(port_kernel_launches(), 0)
    for p in _glob.glob(os.path.join(root, "launches-*.json")):
        with open(p) as f:
            for k, v in json.load(f).items():
                total[k] += v
    return total


def phase_fleet(ctx):
    """Elastic fleets on the card: the reference's kill-and-rejoin proof
    under ``python -m tpu_mx_torch.tools.launch --supervise -n 2`` with
    ``TPUMX_CHAOS=preempt_worker_at_step=3,preempt_rank=1``, each step a
    BERT-base training step on the worker's shard of 32 x 512 (rank 1
    evicted, restarted and admitted again; every ledger the oracle's;
    restart ms, rejoin ms, ``fleet.on_step`` host ms against step ms);
    then a run with ``slow_worker_rank=1`` whose ``FleetAggregator``
    must name rank 1, and whose fleet black box must pass
    ``validate_fleet_section`` and the port's ``fleet_report``."""
    import shutil
    import tempfile
    import torch
    from tpu_mx_torch import telemetry
    from tpu_mx_torch.kernels import _build
    from tpu_mx_torch.models import bert_base_config
    from tpu_mx_torch.parallel import fleet_obs

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    _build.BUILD_DIR.parent.mkdir(parents=True, exist_ok=True)
    work = tempfile.mkdtemp(prefix="fleet-", dir=str(_build.BUILD_DIR.parent))
    out = {}
    try:
        churn = fleet_run(work, "churn",
                          "preempt_worker_at_step=3,preempt_rank=1")
        checks, times = fleet_churn_checks(churn)
        out["churn"] = dict(rc=churn["rc"], wall_s=churn["wall_s"], **times,
                            beat_gaps_ms=fleet_beat_gaps(churn["root"]),
                            **({"stderr": churn["stderr"]}
                               if not all(checks.values()) else {}))
        launches = fleet_kernel_launches(churn["root"])
        slow = fleet_run(work, "straggler",
                         f"slow_worker_rank=1,slow_worker_seconds="
                         f"{FLEET_SLOW_SECONDS}")
        box_path = fleet_obs.fleet_blackbox_path(slow["fleet"])
        box = json.loads(open(box_path).read()) \
            if os.path.exists(box_path) else {}
        sig = box.get("fleet", {}).get("straggler_signal", {})
        try:
            fleet_obs.validate_fleet_section(box, telemetry=telemetry)
            valid = True
        except ValueError as e:
            valid = str(e)[:300]
        here = os.path.dirname(os.path.abspath(__file__))
        rep = subprocess.run(
            [sys.executable, os.path.join(here, "tpu_mx_torch", "tools",
                                          "fleet_report.py"), box_path,
             "--validate"], capture_output=True, text=True, timeout=120)
        for k, v in fleet_kernel_launches(slow["root"]).items():
            launches[k] += v
        gaps = fleet_beat_gaps(slow["root"])
        out["straggler"] = dict(
            rc=slow["rc"], wall_s=slow["wall_s"], signal=sig,
            beat_gaps_ms=gaps,
            section_valid=valid, report_rc=rep.returncode,
            skew_steps=len(box.get("fleet", {}).get("skew_timeline", [])),
            **({"stderr": slow["stderr"]} if slow["rc"] else {}))
        checks.update({
            "straggler_rc": slow["rc"] == 0,
            # both workers renewed their leases in time all run long
            "straggler_beats_within_lease": len(gaps) == 2 and all(
                g[0] < FLEET_LEASE * 1e3 for g in gaps.values()),
            "straggler_named": bool(sig.get("straggling"))
            and sig.get("rank") == 1
            and sig.get("dominant_phase") == "data_wait",
            "fleet_blackbox_valid": valid is True,
            "fleet_report": rep.returncode == 0
            and "slowest=rank 1" in rep.stdout,
            "flash_launches": all(launches[k] > 0 for k in FLASH_KERNELS),
        })
    finally:
        shutil.rmtree(work, ignore_errors=True)
    ctx["fleet_launches"] = launches
    emit("fleet", ok=all(checks.values()), checks=checks, **out,
         model={**bert_base_config(max_len=TRAIN_SEQ), "dtype": "bfloat16",
                "num_layers": KV_LAYERS},
         global_batch=[FLEET_GLOBAL_BATCH, TRAIN_SEQ],
         chaos=dict(churn="preempt_worker_at_step=3,preempt_rank=1",
                    straggler=f"slow_worker_rank=1,slow_worker_seconds="
                              f"{FLEET_SLOW_SECONDS}"),
         launches=launches, seconds=time.perf_counter() - t_phase,
         card=ctx["smi"])
    for name, ok in checks.items():
        if not ok:
            ctx["failures"].append(f"fleet check {name} failed")


# the mesh phase: BERT-base (12 layers, 768 units, 12 heads of 64, 3072
# hidden, vocabulary 30522, T=512), float32, dropout 0; the global batch
# cut to MESH_BATCH (the phase's time: every arm runs twice, on the two
# ranks and at world size 1)
# 4 of BERT-base's 12 layers (the script's time, as KV_LAYERS)
MESH_LAYERS, MESH_BATCH, MESH_STEPS = 4, 4, 3
MESH_VALID = (384, 512)
MESH_PP_MICRO = 4
MESH_COMPRESSED_CALLS = 4        # accum_steps=2: two applied updates
MESH_TIMEOUT = 600
MESH_LOSS_RTOL = 1e-4            # each 2-rank loss against world size 1
MESH_UPDATE_RTOL = 1e-2          # each parameter's change, in norm
# the fp8 arm's parameter change against its plain compressed reference
# (mesh_fp8_plain), in norm: sound runs and the controls lie on either
# side of it
MESH_COMPRESSED_RTOL = 1e-2


def mesh_cfg():
    from tpu_mx_torch.models import bert_base_config
    cfg = bert_base_config(max_len=TRAIN_SEQ)
    cfg.update(num_layers=MESH_LAYERS, dropout=0.0)
    return cfg


def mesh_batch(torch, masked=False):
    """The global batch every rank and the world-size-1 run take:
    tokens, token types, ragged valid lengths and every position's label
    (or, for the MoE objective, 76 masked positions and their labels)."""
    rng = np.random.RandomState(21)
    cfg = mesh_cfg()
    b, t = MESH_BATCH, TRAIN_SEQ
    valid = rng.randint(MESH_VALID[0], MESH_VALID[1] + 1, b)
    if masked:
        return [torch.from_numpy(a).to("cuda") for a in
                bert_batch(cfg, b, t, TRAIN_MASKED, valid, rng)]
    tokens = rng.randint(4, cfg["vocab_size"], (b, t))
    types = rng.randint(0, 2, (b, t))
    labels = rng.randint(0, cfg["vocab_size"], (b, t)).astype(np.float32)
    return [torch.from_numpy(a).to("cuda")
            for a in (tokens, types, valid, labels)]


def mesh_bert_arm(torch, arm, mesh):
    """One BERT arm's net and step (``mesh`` None: world size 1)."""
    from tpu_mx_torch import optimizer
    from tpu_mx_torch.gluon import loss as gloss
    from tpu_mx_torch.gluon.loss import PassThrough
    from tpu_mx_torch.models import BERTModel
    from tpu_mx_torch.models.bert import bert_sharding_rules
    from tpu_mx_torch.parallel import CompiledTrainStep, P, fsdp_rules
    gen = torch.Generator(device="cuda").manual_seed(5)
    if arm == "ep2_moe":
        bert = BERTModel(mesh_cfg(), device="cuda", generator=gen,
                         mesh=mesh, **MOE_ARGS)
        net = moe_train_block(bert)
        return net, CompiledTrainStep(
            net, PassThrough(), optimizer.create("lamb", learning_rate=1e-4),
            mesh=mesh, device="cuda")
    net = BERTModel(mesh_cfg(), device="cuda", generator=gen, mesh=mesh)
    specs = (P("dp", "sp"), P("dp", "sp"), P("dp"), P("dp", "sp"))
    kw = {}
    if arm == "tp2" and mesh is not None:
        kw["rules"] = bert_sharding_rules()
    if arm == "fsdp_dp2" and mesh is not None:
        kw["rules"] = fsdp_rules(dict(net.named_parameters()),
                                 axis_size=mesh.shape["dp"])
    if arm == "fp8_dp2_accum2":
        # the compressed reduction is over dp: the batch splits over dp only
        specs = (P("dp"),) * 4
        kw["accum_steps"] = 2
        if mesh is not None:
            kw["gradient_compression"] = {"type": "fp8"}
    opt = optimizer.create("adam", learning_rate=1e-4) \
        if arm == "fsdp_dp2" else optimizer.create("lamb", learning_rate=1e-4)
    return net, CompiledTrainStep(net, gloss.SoftmaxCrossEntropyLoss(), opt,
                                  mesh=mesh, data_specs=specs,
                                  device="cuda", **kw)


def mesh_pipeline_arm(torch, mesh):
    """``pipeline_apply`` of two BERT-base encoder layers (one a stage,
    ``torch.func.functional_call``), ``MESH_PP_MICRO`` microbatches of the
    global batch's activations, SGD on the stacked parameters; ``mesh``
    None: the two layers one after the other on the whole batch."""
    from tpu_mx_torch.models.bert import TransformerLayer
    from tpu_mx_torch.parallel import pipeline_apply, stack_stage_params
    cfg = mesh_cfg()
    gen = torch.Generator(device="cuda").manual_seed(9)
    layer = TransformerLayer(cfg["units"], cfg["hidden_size"],
                             cfg["num_heads"], dtype=torch.float32,
                             generator=gen).to("cuda")
    stages = []
    for _ in range(2):
        stages.append({k: (torch.randn(v.shape, generator=gen,
                                       device="cuda") * 0.02
                           if v.dim() > 1 else v.detach().clone())
                       for k, v in layer.named_parameters()})
    stacked = stack_stage_params(stages)
    x = torch.randn(MESH_BATCH, TRAIN_SEQ, cfg["units"], generator=gen,
                    device="cuda")
    target = torch.randn(x.shape, generator=gen, device="cuda") * 0.5

    def stage(params, h):
        return torch.func.functional_call(layer, params, (h,))

    def step(stacked):
        for a in stacked.values():
            a.requires_grad_()
        if mesh is None:
            y = x
            for s in range(2):
                y = stage({k: a[s] for k, a in stacked.items()}, y)
        else:
            y = pipeline_apply(stage, stacked, x, mesh,
                               num_microbatches=MESH_PP_MICRO)
        loss = ((y - target) ** 2).mean()
        grads = torch.autograd.grad(loss, list(stacked.values()))
        with torch.no_grad():
            new = {k: (a - 0.5 * g).detach()
                   for (k, a), g in zip(stacked.items(), grads)}
        return loss.detach(), new
    return stacked, step


MESH_ARMS = (
    # name, mesh axes, strategy, step() calls
    ("tp2", {"dp": 1, "sp": 1, "tp": 2}, None, MESH_STEPS),
    ("ulysses_sp2", {"dp": 1, "sp": 2}, "ulysses", MESH_STEPS),
    ("ring_sp2", {"dp": 1, "sp": 2}, "ring", MESH_STEPS),
    ("pipeline_pp2", {"pp": 2}, None, MESH_STEPS),
    ("fsdp_dp2", {"dp": 2}, None, MESH_STEPS),
    ("fp8_dp2_accum2", {"dp": 2}, None, MESH_COMPRESSED_CALLS),
    ("ep2_moe", {"ep": 2}, None, MESH_STEPS),
)


def mesh_run(torch, arm, mesh, calls):
    """``calls`` step() calls of one arm: losses, ms each (host clock to
    the loss's read), and the parameters before and after."""
    if arm == "pipeline_pp2":
        stacked, step = mesh_pipeline_arm(torch, mesh)
        before = {k: a.detach().clone() for k, a in stacked.items()}
        losses, ms = [], []
        for _ in range(calls):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss, stacked = step(stacked)
            losses.append(float(loss))
            ms.append((time.perf_counter() - t0) * 1e3)
        return losses, ms, before, stacked
    net, step = mesh_bert_arm(torch, arm, mesh)
    batch = mesh_batch(torch, masked=arm == "ep2_moe")
    if arm == "ep2_moe":
        batch = batch + [torch.zeros(1, device="cuda")]
    before = {k: p.detach().clone() for k, p in net.named_parameters()}
    losses, ms = [], []
    for _ in range(calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(step.step(*batch)))
        ms.append((time.perf_counter() - t0) * 1e3)
    after = {k: p.detach().clone() for k, p in net.named_parameters()}
    del net, step
    return losses, ms, before, after


def mesh_update_rel_err(before, after, before1, after1):
    """The worst parameter's ``|Δ − Δ1| / |Δ1|`` (changes in norm) of
    a run against its reference run, and that parameter's name."""
    worst, key = 0.0, None
    for k in before:
        d1 = after1[k] - before1[k]
        n1 = float(d1.norm())
        if n1 > 0:
            dm = after[k] - before[k]
            err = float((dm - d1).norm()) / n1
            if err > worst:
                worst, key = err, k
    return worst, key


def mesh_fp8_plain(torch, calls, variant):
    """The fp8 arm's plain compressed reference on one rank, written out
    from the semantics rather than through the step: each of the two dp
    ranks' half of the global batch gives its gradient, accumulated over
    ``accum_steps=2`` calls as ``g/2 + g/2``, quantized by
    ``quantize_fp8_core`` with that rank's error feedback; the two are
    averaged and LAMB applies the mean.  ``variant`` "sound" is that;
    "own" drops rank 1's contribution (a reduction that does not reduce)
    and "no_ef" drops the error feedback: the controls the gate must tell
    from a sound run.  Returns the losses of the ``calls`` calls (the
    mean of the ranks' mean losses) and the parameters before and
    after."""
    from tpu_mx_torch import optimizer
    from tpu_mx_torch.contrib.compression import quantize_fp8_core
    from tpu_mx_torch.gluon import loss as gloss
    net, _ = mesh_bert_arm(torch, "fp8_dp2_accum2", None)
    params = {k: p for k, p in net.named_parameters()
              if p.requires_grad and p.is_floating_point()}
    before = {k: p.detach().clone() for k, p in net.named_parameters()}
    opt = optimizer.create("lamb", learning_rate=1e-4)
    states = {k: opt.create_state(i, p.detach())
              for i, (k, p) in enumerate(params.items())}
    efs = [{k: torch.zeros_like(p) for k, p in params.items()}
           for _ in range(2)]
    halves = [[b.chunk(2, 0)[r] for b in mesh_batch(torch)]
              for r in range(2)]
    loss_fn = gloss.SoftmaxCrossEntropyLoss()
    net.train()
    losses = []
    for t in range(1, calls // 2 + 1):
        deq, rank_losses = [], []
        for r, (*data, labels) in enumerate(halves):
            out = net(*data)
            out = out[0] if isinstance(out, (tuple, list)) else out
            loss = loss_fn(out, labels).float().mean()
            grads = torch.autograd.grad(loss, list(params.values()))
            rank_losses.append(float(loss))
            d = {}
            for k, g in zip(params, grads):
                acc = g.float() / 2 + g.float() / 2
                d[k], ef = quantize_fp8_core(
                    acc, efs[r][k] if variant != "no_ef"
                    else torch.zeros_like(acc))
                efs[r][k] = ef
            deq.append(d)
        losses += [sum(rank_losses) / 2] * 2
        with torch.no_grad():
            for k, p in params.items():
                g = deq[0][k] if variant == "own" \
                    else (deq[0][k] + deq[1][k]) / 2
                w, states[k] = opt.update_core(p.detach(), g.to(p.dtype),
                                               states[k], opt.lr, opt.wd, t)
                p.copy_(w)
    after = {k: p.detach().clone() for k, p in net.named_parameters()}
    del net, params, states, efs
    return losses, before, after


def mesh_child(spec):
    """One of the two ranks of the ``mesh`` phase (under the port's
    launcher; ``import tpu_mx_torch`` joined the gloo group): each arm of
    ``MESH_ARMS`` on its 2-rank mesh, the kernels' launch counters set to
    0 just before and read just after; then rank 0 runs the arm at world
    size 1 on the same card, same weights and global batch, and compares
    the losses and each parameter's change."""
    import torch
    import torch.distributed as dist
    import tpu_mx_torch as mx
    from tpu_mx_torch.parallel import (collectives, dispatch_counts,
                                       make_mesh, set_sp_strategy)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank = dist.get_rank()
    res = {"rank": rank, "backend": dist.get_backend(), "arms": {}}
    with mx.gpu(torch.cuda.current_device()):
        for arm, axes, strategy, calls in MESH_ARMS:
            mesh = make_mesh(axes)
            prev = set_sp_strategy(strategy or "ring")
            counts0 = dict(dispatch_counts)
            staged0 = collectives.host_staged_stats()
            reset_port_kernel_launches()
            try:
                losses, ms, before, after = mesh_run(torch, arm, mesh, calls)
            finally:
                set_sp_strategy(prev)
            torch.cuda.synchronize()
            launches = port_kernel_launches()
            staged = collectives.host_staged_stats()
            out = dict(
                losses=losses, step_ms=ms, launches=launches,
                dispatch={k: dispatch_counts[k] - counts0[k]
                          for k in dispatch_counts},
                host_staged_bytes=staged["bytes"] - staged0["bytes"],
                host_staged_ms=(staged["seconds"] - staged0["seconds"])
                * 1e3, host_staged_calls=staged["calls"] - staged0["calls"])
            dist.barrier()
            if rank == 0 and arm == "fp8_dp2_accum2":
                one, before1, after1 = mesh_fp8_plain(torch, calls, "sound")
                out["control_update_rel_err"] = {}
                for variant in ("own", "no_ef"):
                    _, b, a = mesh_fp8_plain(torch, calls, variant)
                    out["control_update_rel_err"][variant] = \
                        mesh_update_rel_err(b, a, before1, after1)[0]
                    del b, a
            elif rank == 0:
                one, _, before1, after1 = mesh_run(torch, arm, None, calls)
            if rank == 0:
                out["world1_losses"] = one
                out["same_init"] = all(torch.equal(before[k], before1[k])
                                       for k in before)
                out["worst_update_rel_err"], out["worst_update_param"] = \
                    mesh_update_rel_err(before, after, before1, after1)
                del before1, after1
            del before, after
            torch.cuda.empty_cache()
            dist.barrier()
            res["arms"][arm] = out
    with open(spec["out"] % rank, "w") as f:
        json.dump(res, f)
    return 0


def mesh_expected_launches(arm, calls):
    """Each flash kernel's launches on one rank in an arm: one a layer a
    call (the ring's blocks are plain PyTorch, as the reference's are;
    the pipeline's stages run every tick, bubbles included)."""
    if arm == "ring_sp2":
        return 0
    if arm == "pipeline_pp2":
        return (MESH_PP_MICRO + 2 - 1) * calls
    return MESH_LAYERS * calls


def phase_mesh(ctx):
    """Two ranks that share the card (the port's launcher, ``gloo``) run
    each parallel path on BERT-base (``MESH_ARMS``): (a) tp=2 with
    ``bert_sharding_rules`` (Megatron's split of the compute; the weights
    stay whole on each rank), (b) sp=2 Ulysses, (c) sp=2 ring, (d) GPipe
    over pp=2 with a BERT-base encoder layer a stage, (e) FSDP dp=2
    (Adam) and an fp8-compressed dp=2 step under ``accum_steps=2``, (f)
    ep=2 on the BERT-base MoE (8 experts, top-2).  Every rank computes on
    the card; collectives on CUDA tensors are staged through the host
    (``collectives._host_staged``).  Gates: each loss within
    ``MESH_LOSS_RTOL`` and each parameter's change within
    ``MESH_UPDATE_RTOL`` in norm of the world-size-1 run on the card (the
    compressed arm: of its plain compressed reference,
    ``mesh_fp8_plain``, within ``MESH_COMPRESSED_RTOL``, which its
    controls must miss, and its loss must fall), the sp arms' dispatch,
    and the flash kernels' launches on each rank."""
    import tempfile
    import torch
    from tpu_mx_torch.kernels import _build
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    _build.BUILD_DIR.parent.mkdir(parents=True, exist_ok=True)
    work = tempfile.mkdtemp(prefix="mesh-", dir=str(_build.BUILD_DIR.parent))
    spec = dict(fn="mesh_child", out=os.path.join(work, "rank%d.json"))
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "tpu_mx_torch.tools.launch", "-n", "2",
         sys.executable, "-c", WORKER_CHILD, json.dumps(spec)],
        cwd=here, capture_output=True, text=True, timeout=MESH_TIMEOUT)
    wall = time.perf_counter() - t0
    ranks = []
    for i in range(2):
        path = spec["out"] % i
        if os.path.exists(path):
            with open(path) as f:
                ranks.append(json.load(f))
    checks = {"rc": r.returncode == 0, "two_ranks": len(ranks) == 2}
    launches = dict.fromkeys(port_kernel_launches(), 0)
    arms = {}
    if len(ranks) == 2:
        checks["gloo"] = all(x["backend"] == "gloo" for x in ranks)
        for arm, axes, _, calls in MESH_ARMS:
            a0, a1 = ranks[0]["arms"][arm], ranks[1]["arms"][arm]
            one = a0["world1_losses"]
            rel = [abs(x - y) / abs(y) for x, y in zip(a0["losses"], one)]
            want = mesh_expected_launches(arm, calls)
            row = dict(axes=axes, losses=[a0["losses"], a1["losses"]],
                       world1_losses=one, loss_rel_err=max(rel),
                       worst_update_rel_err=a0["worst_update_rel_err"],
                       worst_update_param=a0["worst_update_param"],
                       step_ms=[a0["step_ms"], a1["step_ms"]],
                       step_ms_median=[statistics.median(x["step_ms"][1:])
                                       for x in (a0, a1)],
                       host_staged_bytes=[x["host_staged_bytes"]
                                          for x in (a0, a1)],
                       host_staged_ms=[x["host_staged_ms"] for x in (a0, a1)],
                       host_staged_calls=[x["host_staged_calls"]
                                          for x in (a0, a1)],
                       dispatch=a0["dispatch"],
                       launches=[x["launches"] for x in (a0, a1)],
                       expected_flash_launches=want)
            arms[arm] = row
            for x in (a0, a1):
                for name in launches:
                    launches[name] += x["launches"][name]
            checks[f"{arm}_ranks_agree"] = a0["losses"] == a1["losses"]
            checks[f"{arm}_same_init"] = a0["same_init"]
            checks[f"{arm}_finite"] = all(math.isfinite(v)
                                          for v in a0["losses"])
            if arm == "fp8_dp2_accum2":
                # against the plain compressed reference; the controls
                # (no reduction, no error feedback) must miss it
                row["control_update_rel_err"] = a0["control_update_rel_err"]
                checks[f"{arm}_loss"] = max(rel) <= MESH_LOSS_RTOL
                checks[f"{arm}_loss_moved"] = a0["losses"][-1] \
                    < a0["losses"][0]
                checks[f"{arm}_updates"] = \
                    a0["worst_update_rel_err"] <= MESH_COMPRESSED_RTOL
                for variant, err in a0["control_update_rel_err"].items():
                    checks[f"{arm}_control_{variant}_caught"] = \
                        err > MESH_COMPRESSED_RTOL
            else:
                checks[f"{arm}_loss"] = max(rel) <= MESH_LOSS_RTOL
                checks[f"{arm}_updates"] = \
                    a0["worst_update_rel_err"] <= MESH_UPDATE_RTOL
            checks[f"{arm}_flash_launches"] = all(
                x["launches"][k] == want for x in (a0, a1)
                for k in FLASH_KERNELS)
        checks["ulysses_dispatched"] = \
            arms["ulysses_sp2"]["dispatch"]["ulysses"] >= 1
        checks["ring_dispatched"] = arms["ring_sp2"]["dispatch"]["ring"] >= 1
    ctx["mesh_launches"] = launches
    emit("mesh", ok=all(checks.values()), checks=checks, arms=arms,
         ranks=2, backend="gloo (two ranks share the card; NCCL needs a "
         "card a rank)", model={**mesh_cfg(), "dtype": "float32"},
         cuts=dict(global_batch=f"{MESH_BATCH} x {TRAIN_SEQ} (the train "
                   f"cell's {TRAIN_BATCH} x {TRAIN_SEQ})"),
         steps=MESH_STEPS, launches=launches, wall_s=wall,
         stderr=r.stderr[-3000:] if r.returncode else "",
         seconds=time.perf_counter() - t_phase, card=ctx["smi"])
    for name, ok in checks.items():
        if not ok:
            ctx["failures"].append(f"mesh check {name} failed")


def wide_serve_arm(torch, model, cpu, prompts, name, pool, window,
                   prefill, cpu_stream0=None):
    """One serving arm at 16 heads of 256 (``pool`` a dtype name,
    ``window`` a ``TPUMX_SPECULATIVE`` value or None): the card's run from
    counts at 0, what it counted by kind, request 0 on the CPU port
    with the same weights and pool dtype (``cpu_stream0`` when the caller
    has it already), and the card's prefill logits (``prefill``: the
    phase's one prefill of request 0, which reads no pool) and one
    decode step's against the CPU port's (:func:`wide_logits`, the
    arm's pool and window)."""
    import os
    from tpu_mx_torch import telemetry
    from tpu_mx_torch.serving import Server
    prior = os.environ.get("TPUMX_SPECULATIVE")
    os.environ["TPUMX_SPECULATIVE"] = window or "0"
    try:
        dtype = getattr(torch, pool)
        srv = Server(model, max_batch=8, block_size=16, num_blocks=1024,
                     dtype=dtype)
        run = serve_run(torch, srv, prompts, NEW_TOKENS, ids=name)
        run["decode_attention"] = {
            k: (telemetry.get("serve.decode_attention", kind=k).value
                if telemetry.get("serve.decode_attention", kind=k) else 0)
            for k in ("paged", "paged-kernel", "dense")}
        del srv
        if cpu_stream0 is None:
            ref = Server(cpu, max_batch=1, block_size=16, num_blocks=64,
                         dtype=dtype, device="cpu")
            r = ref.submit(prompts[0], max_new_tokens=NEW_TOKENS,
                           request_id=f"{name}0")
            ref.run_until_idle()
            cpu_stream0 = r.tokens
        run["cpu_stream0"] = cpu_stream0
        run["logits"] = wide_logits(torch, model, cpu, prefill,
                                    cpu_stream0, dtype,
                                    int(window) if window else 1)
    finally:
        if prior is None:
            os.environ.pop("TPUMX_SPECULATIVE", None)
        else:
            os.environ["TPUMX_SPECULATIVE"] = prior
    return run


def wide_logits(torch, model, cpu, prefill, stream, pool, window):
    """One decode step's logits on the card against the CPU port's (same
    weights) after ``prefill`` = ``(k, v, k_cpu, v_cpu, prefill_err)``,
    the card's prefill of request 0 (its K/V, and a copy on the host)
    and its logits' distance from the CPU port's: both caches
    ``pool``-typed and filled with the card's K/V, so that the step's
    window of ``window`` positions of ``stream`` (its last position's
    logits) is what differs; max |difference|s beside LOGITS_ATOL."""
    from tpu_mx_torch.serving import PagedKVCache

    class Given:
        def __init__(self, device):
            self.device = device

        def draft(self, last_tokens, positions, n):
            return torch.tensor([stream[1:n + 1]], device=self.device)

    got = []
    for m, k, v in ((model, *prefill[:2]), (cpu, *prefill[2:4])):
        cache = PagedKVCache(m.num_layers, m.num_heads, m.head_dim,
                             num_blocks=64, dtype=pool, device=m.device)
        cache.prefill("a", k, v)
        cache.reserve_window("a", window)
        tables, lengths = cache.batch_tables(["a"])
        bids, offs = cache.window_slots(["a"], window)
        got.append(np.asarray(m.decode_step(
            cache, [stream[0]], lengths - window, tables, lengths, bids,
            offs, proposer=Given(m.device), want_logits=True)[3],
            np.float64))
    return dict(prefill_max_abs_err=prefill[4],
                decode_max_abs_err=float(np.abs(got[0] - got[1]).max()),
                window=window, atol=LOGITS_ATOL)


def wide_attention_case(torch, fa, gen, key, dt, h, t, d, rate):
    """``parallel.attention`` forward and backward at B=4 and ``h`` heads
    (causal, ragged valid lengths) from launch counts at 0, held to the
    plain forward and backward on the same inputs and dropout seed."""
    from tpu_mx_torch.parallel import attention
    dev, dtype = "cuda", getattr(torch, dt)
    b = WIDE_BATCH
    q, k, v, do = (torch.randn((b, h, t, d), generator=gen).to(dev, dtype)
                   for _ in range(4))
    rows, valid = wide_valid(torch, gen, t, h)
    vl = torch.tensor(rows, dtype=torch.int32, device=dev)
    seed = torch.randint(0, 2 ** 31 - 1, (1,), generator=gen,
                         dtype=torch.int32).to(dev)
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    reset_port_kernel_launches()
    before = routes_of(fa)
    out = attention(*leaves, causal=True, valid_length=vl,
                    dropout_rate=rate, dropout_seed=seed)
    out.backward(do)
    torch.cuda.synchronize()
    launches = port_kernel_launches()
    routes = {n: route_since(fa, n, before) for n in FLASH_KERNELS}
    fold = lambda x: x.reshape(b * h, t, d)
    kv = torch.tensor(valid, dtype=torch.int32, device=dev)
    scale = 1.0 / math.sqrt(d)
    ref, lse = fa.flash_attention_plain(fold(q), fold(k), fold(v), scale,
                                        True, kv, rate, seed)
    want = fa.flash_attention_bwd_plain(
        fold(q), fold(k), fold(v), fold(do), lse,
        fa.flash_attention_delta(fold(do), ref), scale, True, kv, rate, seed)
    f32 = dtype == torch.float32
    tol = lambda r: FLASH_ATOL if f32 else BF16_REL * float(r.abs().max())
    err = lambda a, r: float((fold(a).float() - r.float()).abs().max())
    errors = {"out": (err(out.detach(), ref), tol(ref))}
    for n, leaf, w in zip(("dq", "dk", "dv"), leaves, want):
        errors[n] = (err(leaf.grad, w), tol(w))
    ok = (all(math.isfinite(e) and e <= a for e, a in errors.values())
          and all(launches[n] == 1 for n in FLASH_KERNELS)
          and routes == flash_routes(f32, d))
    return dict(case=key, ok=ok, shape=f"B={b} H={h} T={t} D={d} {dt} "
                f"causal valid {min(rows)}-{max(rows)} dropout {rate}",
                launches=launches, routes=routes,
                max_abs_err={n: e for n, (e, _) in errors.items()},
                atol={n: a for n, (_, a) in errors.items()})


def wide_serve(torch, fa, ctx, cfg, tag=""):
    """The serve cell's traffic at the wide layout ``cfg`` (a TinyLM
    config), f32 pool, bf16 pool, and ``TPUMX_SPECULATIVE=12`` (a window
    past the kernel's 8 rows, walked in chunks) with the f32 pool: each
    arm's request 0 equal to the CPU port's (or split at a near tie), its
    prefill logits and one decode step's (the arm's pool and window)
    within LOGITS_ATOL of the CPU port's, every prefill on the flash
    kernel (``tf32x3``), every decode on the paged kernel (``split_k``),
    no dense arm.  Returns ``(arms, checks, launches)``, each check's
    name prefixed with ``tag``."""
    from tpu_mx_torch.serving import TinyLM
    model = TinyLM(**cfg, device="cuda")
    cpu = TinyLM.from_numpy(*model.to_numpy(), num_heads=cfg["num_heads"],
                            device="cpu")
    prompts = serve_prompts()
    layers = cfg["num_layers"]
    total = dict.fromkeys(port_kernel_launches(), 0)
    arms, checks = {}, {}
    # request 0's prefill on the card (its K/V for each arm's decode
    # logits) and its logits against the CPU port's
    kv = model.prefill(prompts[0])
    prefill = (kv[0], kv[1], kv[0].cpu(), kv[1].cpu(), float(
        (kv[2].double().cpu() - cpu.prefill(prompts[0])[2].double())
        .abs().max()))
    del kv
    for name, pool, window in (("f32_pool", "float32", None),
                               ("bf16_pool", "bfloat16", None),
                               ("spec12", "float32",
                                str(WIDE_SPEC_WINDOW))):
        # greedy speculation is exact: the window's stream is the CPU
        # port's stream of the same pool without it
        run = wide_serve_arm(torch, model, cpu, prompts, name, pool, window,
                             prefill, arms["f32_pool"]["cpu_stream0"]
                             if window else None)
        for n, c in run["launches"].items():
            total[n] += c
        split = stream_splits(model, prompts[:1], run["streams"][:1],
                              [run["cpu_stream0"]])
        flash_n = run["launches"]["flash_attention_fwd"]
        paged_n = run["launches"]["paged_attention"]
        arm_checks = dict(
            done=run["done"],
            stream0_as_cpu=splits_ok(split),
            prefill_flash=run["prefill_attention"] == {
                "flash": flash_n, "dense": 0}
            and flash_n == layers * len(prompts),
            prefill_tf32x3=run["flash_routes"] == dict(
                fa.route_counts(), tf32x3=flash_n),
            decode_paged=run["decode_attention"] == {
                "paged": paged_n, "paged-kernel": 0, "dense": 0}
            and paged_n == layers * run["decode_steps"] > 0,
            decode_split_k=run["paged_routes"] == {"split_k": paged_n},
            prefill_logits=run["logits"]["prefill_max_abs_err"]
            <= LOGITS_ATOL,
            decode_logits=run["logits"]["decode_max_abs_err"]
            <= LOGITS_ATOL)
        if window:
            # windows of 12 (cut only where a request nears its end)
            arm_checks["window_chunked"] = (
                max(run["paged_windows"]) == WIDE_SPEC_WINDOW
                and sum(run["paged_windows"].values()) == paged_n)
            arm_checks["streams_as_f32_pool"] = splits_ok(stream_splits(
                model, prompts, run["streams"],
                arms["f32_pool"]["streams"]))
        checks.update({f"{tag}{name}_{k}": v for k, v in arm_checks.items()})
        arms[name] = run
        emit("wide_heads_serve", arm=tag + name, ok=all(arm_checks.values()),
             checks=arm_checks, pool=pool, spec_window=window,
             heads=cfg["num_heads"], head_dim=model.head_dim,
             stream0_split=split[0], **_record(run))
    del model, cpu, prefill
    torch.cuda.empty_cache()
    return arms, checks, total


def phase_wide_heads(ctx):
    """Head dims 192 and 256 (ROADMAP B item 8) and 320 and more (B item
    8b, the runtime-D instances) on the main paths: (a) the serve cell's
    traffic (:func:`wide_serve`) at Gemma's layout, TinyLM 4096 wide with
    16 heads of 256 (2 layers, vocabulary 32000), and at 8 heads of 512 (4
    layers); (b) ``parallel.attention`` forward and backward at B=4,
    causal with ragged valid lengths (:func:`flash_cases`): bf16 T=2048
    D=256 and 192 with dropout 0.1 and float32 T=700 D=256 at 16 heads,
    bf16 T=2048 D=512 (8 heads, dropout 0.1) and D=320 (12 heads), float32
    T=700 D=384 (16 heads) and T=512 D=1024 (8 heads), each held to its
    plain twin; (c) at bf16 T=512 D=256 the four bias layouts with
    ``d_bias`` (``bias_case``)."""
    import torch
    from tpu_mx_torch.kernels import flash_attention as fa
    t0 = time.perf_counter()
    arms, checks, total = wide_serve(torch, fa, ctx, WIDE_SERVE)
    huge_arms, huge_checks, huge_total = wide_serve(torch, fa, ctx,
                                                    HUGE_SERVE, "d512_")
    checks.update(huge_checks)
    for n, c in huge_total.items():
        total[n] += c
    serve_s = time.perf_counter() - t0

    t1 = time.perf_counter()
    gen = torch.Generator().manual_seed(22)
    attn = {}
    for key, dt, h, t, d, rate in flash_cases():
        rec = wide_attention_case(torch, fa, gen, key, dt, h, t, d, rate)
        for n, c in rec["launches"].items():
            total[n] += c
        attn[key] = rec
        checks[f"attention_{key}"] = rec["ok"]
        emit("wide_heads_attention", card=ctx["smi"], **rec)
        torch.cuda.empty_cache()
    bias = {}
    for name, shape in (("per_row", (WIDE_BATCH, WIDE_HEADS, WIDE_BIAS_T,
                                     WIDE_BIAS_T)),
                        ("per_head", (1, WIDE_HEADS, WIDE_BIAS_T,
                                      WIDE_BIAS_T)),
                        ("shared", (1, 1, WIDE_BIAS_T, WIDE_BIAS_T)),
                        ("alibi", (1, WIDE_HEADS, 1, WIDE_BIAS_T))):
        rows, _ = wide_valid(torch, gen, WIDE_BIAS_T)
        rec = bias_case(torch, fa, gen, WIDE_BATCH, WIDE_HEADS, WIDE_BIAS_T,
                        WIDE_BIAS_D, torch.bfloat16, True, rows, shape)
        for n, c in rec["launches"].items():
            total[n] += c
        bias[name] = rec
        checks[f"bias_{name}"] = rec["ok"]
        emit("wide_heads_bias", layout=name, card=ctx["smi"], **rec)
        torch.cuda.empty_cache()
    ctx["wide_heads_launches"] = total
    ctx["wide_heads"] = dict(arms=arms, huge_arms=huge_arms, attention=attn,
                             bias=bias)
    emit("wide_heads", ok=all(checks.values()), checks=checks,
         model={**WIDE_SERVE, "block_size": 16, "num_blocks": 1024},
         huge_model={**HUGE_SERVE, "block_size": 16, "num_blocks": 1024},
         launches=total, serve_seconds=serve_s,
         attention_seconds=time.perf_counter() - t1,
         seconds=time.perf_counter() - t0, card=ctx["smi"])
    for name, ok in checks.items():
        if not ok:
            ctx["failures"].append(f"wide_heads check {name} failed")


# the graph phase (ROADMAP A item 10 (c), (d)): BERT-base at _bert_once's
# widths exported and imported (bf16, predict mode, 32 x 512, the vocab
# head on 76 masked positions a row); the symbolic PTB word LM at
# _lstm_once's widths in a BucketingModule (float32, batch 256); sparse
# storage at Criteo's shape (39 non-zeros a row in 2^20 hashed features)
GRAPH_SEED = 24
GRAPH_BERT = dict(batch=32, seq=512, masked=76)
GRAPH_LM = dict(vocab=10000, embed=650, hidden=650, layers=2, batch=256,
                buckets=(10, 20, 35), steps=(10, 20, 35, 10, 20, 35),
                lr=0.3, cpu_rows=64)
GRAPH_SPARSE = dict(features=2 ** 20, nnz=39, rows=16384, batch=8192,
                    dim=64, f64_rows=256)
GRAPH_LM_ATOL = 1e-5     # probabilities, card vs CPU port (f32 sums)
GRAPH_DOT_RTOL = 1e-5    # sparse dot, card vs CPU port and float64


def graph_export(torch, ctx, work):
    """(a) ``HybridBlock.export`` of BERT-base and ``SymbolBlock.imports``:
    the imported program's forward on the card equals the exporting
    block's predict-mode forward bit for bit and launches the flash
    forward once a layer, on ``wgmma``."""
    import numpy as np
    import tpu_mx_torch as mx
    from tpu_mx_torch import autograd
    from tpu_mx_torch.gluon import SymbolBlock
    from tpu_mx_torch.kernels import flash_attention as fa
    from tpu_mx_torch.models.bert import BERTModel, bert_base_config
    b, t, m = GRAPH_BERT["batch"], GRAPH_BERT["seq"], GRAPH_BERT["masked"]
    cfg = bert_base_config(max_len=t)
    net = BERTModel(cfg, dtype="bfloat16", device="cuda",
                    generator=torch.Generator(device="cuda")
                    .manual_seed(GRAPH_SEED))
    rng = np.random.RandomState(GRAPH_SEED)
    gpu = mx.gpu(0)
    inputs = [
        mx.nd.array(rng.randint(4, cfg["vocab_size"], (b, t))
                    .astype(np.int32), ctx=gpu),
        mx.nd.array(np.zeros((b, t), np.int32), ctx=gpu),
        mx.nd.array(rng.randint(t // 2, t + 1, (b,)).astype(np.int32),
                    ctx=gpu),
        mx.nd.array(np.stack([rng.choice(t, m, replace=False)
                              for _ in range(b)]).astype(np.int32), ctx=gpu)]
    reset_port_kernel_launches()
    with autograd.predict_mode():
        want = net(*inputs)
    torch.cuda.synchronize()
    prefix = os.path.join(work, "bert")
    t0 = time.perf_counter()
    net.export(prefix, epoch=0)
    export_s = time.perf_counter() - t0
    pt2 = prefix + "-0000.pt2"
    t0 = time.perf_counter()
    blk = SymbolBlock.imports(prefix + "-symbol.json", None,
                              prefix + "-0000.params.npz")
    import_s = time.perf_counter() - t0
    before_launches = fa.flash_attention.launches
    before = routes_of(fa)
    got = blk(*inputs)
    torch.cuda.synchronize()
    launches = fa.flash_attention.launches - before_launches
    route = route_since(fa, "flash_attention_fwd", before)
    counted = port_kernel_launches()
    same = bool(torch.equal(got._data, want._data))
    ms = cuda_ms(torch, lambda: blk(*inputs), reps=5, warm=1)
    eager_ms = cuda_ms(torch, lambda: net(*inputs), reps=5, warm=1)
    checks = dict(flash_launches=launches == cfg["num_layers"],
                  flash_route=route == "wgmma", bit_equal=same,
                  finite=bool(torch.isfinite(got._data).all()),
                  shape=tuple(got.shape) == (b, m, cfg["vocab_size"]))
    rec = dict(model="BERT-base 12 x 768, 12 heads, bf16, predict mode",
               batch=b, seq=t, masked=m, export_seconds=export_s,
               import_seconds=import_s, pt2_bytes=os.path.getsize(pt2),
               params_bytes=os.path.getsize(prefix + "-0000.params.npz"),
               imported_forward_ms=ms, block_forward_ms=eager_ms,
               flash_launches_per_forward=launches, flash_route=route,
               launches=counted)
    emit("graph_export", ok=all(checks.values()), checks=checks,
         card=ctx["smi"], **rec)
    del net, blk, got, want
    torch.cuda.empty_cache()
    return checks, counted


class _BucketBatches:
    """The LM's batches: ids ``(batch, T)`` (a Zipf draw over the
    vocabulary, so that a model can learn its frequencies) and the next
    ids as labels, one bucket ``T`` a batch in ``GRAPH_LM["steps"]``'
    order; the DataIter protocol ``fit`` reads."""

    def __init__(self, mx, rng, steps):
        v, n = GRAPH_LM["vocab"], GRAPH_LM["batch"]
        self._mx = mx
        self._batches = []
        for seq in steps:
            ids = np.minimum(rng.zipf(1.3, (n, seq + 1)) - 1, v - 1) \
                .astype(np.float32)
            self._batches.append((seq, ids[:, :-1].copy(),
                                  ids[:, 1:].copy()))
        self._i = 0
        longest = max(GRAPH_LM["buckets"])
        self.provide_data = [mx.io.DataDesc("data", (n, longest))]
        self.provide_label = [mx.io.DataDesc("softmax_label", (n, longest))]
        self.default_bucket_key = longest

    def batch(self, i, ctx=None):
        seq, x, y = self._batches[i]
        b = self._mx.io.DataBatch(data=[self._mx.nd.array(x, ctx=ctx)],
                                  label=[self._mx.nd.array(y, ctx=ctx)])
        b.bucket_key = seq
        return b

    def reset(self):
        self._i = 0

    def __iter__(self):
        return self

    def __next__(self):
        if self._i >= len(self._batches):
            raise StopIteration
        self._i += 1
        return self.batch(self._i - 1)


def lm_sym_gen(mx):
    """The symbolic PTB word LM: Embedding, a two-layer fused LSTM over
    the packed blob (``sym.RNN``), the vocabulary projection and
    ``SoftmaxOutput`` (gradients normalized by the rows)."""
    v, e, h, n_layers, n = (GRAPH_LM[k] for k in ("vocab", "embed",
                                                   "hidden", "layers",
                                                   "batch"))
    size = mx.nd.rnn_param_size("lstm", e, h, n_layers)

    def sym_gen(seq_len):
        data = mx.sym.Variable("data")
        label = mx.sym.Variable("softmax_label")
        x = mx.sym.swapaxes(mx.sym.Embedding(data, input_dim=v, output_dim=e,
                                             name="embed"), dim1=0, dim2=1)
        zero = mx.sym.zeros(shape=(n_layers, n, h), name="state0")
        out = mx.sym.RNN(x, mx.sym.Variable("lstm_parameters", shape=(size,)),
                         zero, zero, state_size=h, num_layers=n_layers,
                         mode="lstm", name="lstm")
        out = mx.sym.reshape(mx.sym.swapaxes(out, dim1=0, dim2=1),
                             shape=(-1, h))
        pred = mx.sym.FullyConnected(out, num_hidden=v, name="pred")
        return (mx.sym.SoftmaxOutput(pred, mx.sym.reshape(label,
                                                          shape=(-1,)),
                                     normalization="batch", name="softmax"),
                ("data",), ("softmax_label",))
    return sym_gen


def graph_bucketing(torch, ctx, work):
    """(b) The symbolic PTB word LM (10000 words, 650 x 2 LSTM) in a
    ``BucketingModule`` on the card, float32, buckets 10, 20, 35 at batch
    256, six SGD steps through ``fit`` (learning rate 0.3: at 1.0 the
    loss fell from 9.21 to 6.96 in three steps and rose again): the
    first step's output rows and loss against the CPU port bound to the
    same weights, the loss falling, the parameter arrays shared by every
    bucket, and ``save_checkpoint``/``Module.load`` bit-equal on the
    card."""
    import tpu_mx_torch as mx
    gpu = mx.gpu(0)
    rng = np.random.RandomState(GRAPH_SEED)
    data = _BucketBatches(mx, rng, GRAPH_LM["steps"])
    mod = mx.module.BucketingModule(lm_sym_gen(mx),
                                    default_bucket_key=data.default_bucket_key,
                                    context=gpu)
    mod.bind(data.provide_data, data.provide_label)
    torch.manual_seed(GRAPH_SEED)
    mod.init_params(initializer=mx.init.Uniform(0.1))
    arg0, aux0 = mod.get_params()
    host0 = {k: v.asnumpy() for k, v in arg0.items()}
    losses, outs = [], {}

    def record(param):
        # each step's loss on the card: mean -log p[label] of its rows
        out = mod.get_outputs()[0]._data
        lab = param.locals["data_batch"].label[0]._data.reshape(-1).long()
        p = out[torch.arange(out.shape[0], device=out.device), lab]
        losses.append(float(-torch.log(p.clamp_min(1e-30)).mean()))
        if not outs:
            outs["first"] = out[:GRAPH_LM["cpu_rows"]].cpu()

    reset_port_kernel_launches()
    t0 = time.perf_counter()
    mod.fit(data, num_epoch=1, optimizer="sgd",
            optimizer_params={"learning_rate": GRAPH_LM["lr"]},
            eval_metric="ce", batch_end_callback=record)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    counted = port_kernel_launches()
    # the first step on the CPU port, bound to the same weights
    with mx.cpu():
        cpu = mx.module.BucketingModule(
            lm_sym_gen(mx), default_bucket_key=data.default_bucket_key,
            context=mx.cpu())
        first = data.batch(0, ctx=mx.cpu())
        cpu.bind(data.provide_data, data.provide_label, for_training=False)
        cpu.init_params(arg_params=host0, aux_params={})
        cpu.forward(first, is_train=False)
        cpu_out = cpu.get_outputs()[0]._data
        lab = first.label[0]._data.reshape(-1).long()
        p = cpu_out[torch.arange(cpu_out.shape[0]), lab]
        cpu_loss = float(-torch.log(p.clamp_min(1e-30)).mean())
    rows_err = float((outs["first"] - cpu_out[:GRAPH_LM["cpu_rows"]])
                     .abs().max())
    buckets = mod._buckets
    shared = all(b._exec.arg_dict[n] is buckets[35]._exec.arg_dict[n]
                 for b in buckets.values()
                 for n in ("embed_weight", "lstm_parameters", "pred_weight"))
    # checkpoint round trip on the card
    prefix = os.path.join(work, "ptb")
    mod.save_checkpoint(prefix, 1)
    back = mx.module.Module.load(prefix, 1, context=gpu)
    back.bind(data_shapes=[("data", (GRAPH_LM["batch"], 35))],
              label_shapes=[("softmax_label", (GRAPH_LM["batch"], 35))],
              for_training=False)
    back.init_params()
    (a1, _), (a2, _) = mod.get_params(), back.get_params()
    ckpt_equal = sorted(a1) == sorted(a2) and all(
        torch.equal(a1[k]._data, a2[k]._data) for k in a1)
    last = data.batch(len(GRAPH_LM["steps"]) - 1, ctx=gpu)
    mod.forward(last, is_train=False)
    back.forward(last, is_train=False)
    ckpt_equal = ckpt_equal and torch.equal(mod.get_outputs()[0]._data,
                                            back.get_outputs()[0]._data)
    # each bucket's loss below its own first step's, and the last step's
    # below the first's
    steps = GRAPH_LM["steps"]
    falls = losses[-1] < losses[0] and all(
        losses[i] < losses[steps.index(s)] for i, s in enumerate(steps)
        if i > steps.index(s))
    checks = dict(first_rows=rows_err <= GRAPH_LM_ATOL,
                  first_loss=abs(losses[0] - cpu_loss)
                  <= 1e-5 * abs(cpu_loss),
                  loss_falls=falls,
                  finite=all(math.isfinite(x) for x in losses),
                  shared_handles=shared and len(buckets) == 3,
                  checkpoint_bit_equal=ckpt_equal)
    rec = dict(model={k: GRAPH_LM[k] for k in ("vocab", "embed", "hidden",
                                               "layers", "batch")},
               buckets=list(GRAPH_LM["buckets"]),
               steps=list(GRAPH_LM["steps"]), losses=losses,
               cpu_first_loss=cpu_loss, first_rows_max_abs_err=rows_err,
               first_rows=GRAPH_LM["cpu_rows"], atol=GRAPH_LM_ATOL,
               fit_seconds=fit_s, launches=counted)
    emit("graph_bucketing", ok=all(checks.values()), checks=checks,
         card=ctx["smi"], **rec)
    del mod, back, cpu
    torch.cuda.empty_cache()
    return checks, counted


def graph_sparse(torch, ctx, work):
    """(c) Sparse storage at Criteo's shape: a synthetic LibSVM file (39
    non-zeros a row in 2^20 hashed features, 16384 rows) read by
    ``LibSVMIter`` at batch 8192; ``sparse.dot`` of a batch with a dense
    (2^20, 1) float32 weight against the CPU port and, on 256 rows,
    against a float64 densified product; ``retain`` and
    ``row_sparse_pull`` of a (2^20, 64) float32 table (256 MB) on the
    batch's unique feature rows against the CPU port."""
    import tpu_mx_torch as mx
    from tpu_mx_torch.ndarray import sparse
    sp = GRAPH_SPARSE
    rng = np.random.RandomState(GRAPH_SEED)
    cols = np.sort(rng.randint(0, sp["features"], (sp["rows"], sp["nnz"])),
                   axis=1)
    vals = rng.rand(sp["rows"], sp["nnz"]).astype(np.float32)
    labels = rng.randint(0, 2, sp["rows"])
    path = os.path.join(work, "criteo.libsvm")
    with open(path, "w") as f:
        for i in range(sp["rows"]):
            f.write(f"{labels[i]} " + " ".join(
                f"{c}:{v:.6f}" for c, v in zip(cols[i], vals[i])) + "\n")
    gpu = mx.gpu(0)
    reset_port_kernel_launches()
    t0 = time.perf_counter()
    with gpu:
        it = mx.io.LibSVMIter(data_libsvm=path, data_shape=(sp["features"],),
                              batch_size=sp["batch"])
        parse_s = time.perf_counter() - t0
        t1 = time.perf_counter()
        batches = list(it)
        torch.cuda.synchronize()
    iter_s = time.perf_counter() - t1
    csr = batches[0].data[0]
    w = torch.randn((sp["features"], 1), generator=torch.Generator()
                    .manual_seed(GRAPH_SEED))
    wd = mx.nd.array(w, ctx=gpu)
    got = sparse.dot(csr, wd)
    torch.cuda.synchronize()
    host = sparse.csr_matrix((csr.data.asnumpy(), csr.indices.asnumpy(),
                              csr.indptr.asnumpy()), shape=csr.shape,
                             ctx=mx.cpu())
    want = sparse.dot(host, mx.nd.array(w, ctx=mx.cpu()))
    scale = float(want._data.abs().max())
    dot_err = float((got._data.cpu() - want._data).abs().max())
    top = csr.slice(0, sp["f64_rows"])
    f64 = top.todense()._data.double() @ wd._data.double()
    f64_err = float((got._data[:sp["f64_rows"]].double() - f64).abs().max())
    dot_ms = cuda_ms(torch, lambda: sparse.dot(csr, wd), reps=10, warm=2)
    uniq = torch.unique(csr.indices._data)
    table = torch.randn((sp["features"], sp["dim"]),
                        generator=torch.Generator().manual_seed(GRAPH_SEED))
    rsp = sparse.row_sparse_array(
        (mx.nd.array(table, ctx=gpu),
         mx.nd.array(np.arange(sp["features"], dtype=np.int32), ctx=gpu)),
        shape=table.shape)
    kept = sparse.retain(rsp, mx.nd.array(uniq, ctx=gpu))
    host_rsp = sparse.row_sparse_array(
        (mx.nd.array(table, ctx=mx.cpu()),
         mx.nd.array(np.arange(sp["features"], dtype=np.int32),
                     ctx=mx.cpu())), shape=table.shape)
    host_kept = sparse.retain(host_rsp, mx.nd.array(uniq.cpu(), ctx=mx.cpu()))
    retain_equal = torch.equal(kept.indices._data.cpu(),
                               host_kept.indices._data) and torch.equal(
        kept.data._data.cpu(), host_kept.data._data)
    retain_ms = cuda_ms(torch, lambda: sparse.retain(rsp, uniq), reps=5,
                        warm=1)
    pulled = {}
    for c in (gpu, mx.cpu()):
        with c:
            kv = mx.kv.create("local")
            kv.init("table", mx.nd.array(table))
            out = mx.nd.zeros(tuple(table.shape))
            kv.row_sparse_pull("table", out=out,
                               row_ids=mx.nd.array(uniq.cpu()))
            pulled[c] = out._data[uniq.to(out._data.device)].cpu()
            del kv, out
    pull_equal = torch.equal(pulled[gpu], pulled[mx.cpu()]) and torch.equal(
        pulled[gpu], table[uniq.cpu()])
    counted = port_kernel_launches()
    checks = dict(batches=len(batches) == sp["rows"] // sp["batch"]
                  and csr.stype == "csr"
                  and csr.nnz == sp["batch"] * sp["nnz"],
                  dot_vs_cpu=dot_err <= GRAPH_DOT_RTOL * scale,
                  dot_vs_f64=f64_err <= GRAPH_DOT_RTOL * scale,
                  retain_as_cpu=retain_equal, pull_as_cpu=pull_equal)
    rec = dict(rows=sp["rows"], features=sp["features"], nnz=sp["nnz"],
               batch=sp["batch"], file_bytes=os.path.getsize(path),
               parse_seconds=parse_s,
               iterator_rows_per_s=sp["rows"] / (parse_s + iter_s),
               batch_rows_per_s=sp["rows"] / iter_s,
               dot_ms=dot_ms, dot_max_abs_err_cpu=dot_err,
               dot_max_abs_err_f64=f64_err, dot_scale=scale,
               unique_rows=int(uniq.numel()), retain_ms=retain_ms,
               table_bytes=table.numel() * 4, launches=counted)
    emit("graph_sparse", ok=all(checks.values()), checks=checks,
         card=ctx["smi"], **rec)
    del rsp, kept, host_rsp, host_kept
    torch.cuda.empty_cache()
    return checks, counted


def phase_graph(ctx):
    """The graph API and sparse storage on the card (ROADMAP A item 10 (c),
    (d)): (a) :func:`graph_export`, (b) :func:`graph_bucketing`, (c)
    :func:`graph_sparse`.  Each part's launch counts are set to 0 before
    it and read after it; their sum is the phase's."""
    import tempfile
    import torch
    from tpu_mx_torch.kernels import _build
    t0 = time.perf_counter()
    _build.BUILD_DIR.parent.mkdir(parents=True, exist_ok=True)
    total = dict.fromkeys(port_kernel_launches(), 0)
    checks, seconds = {}, {}
    with tempfile.TemporaryDirectory(prefix="graph-",
                                     dir=str(_build.BUILD_DIR.parent)) as work:
        for part, fn in (("export", graph_export),
                         ("bucketing", graph_bucketing),
                         ("sparse", graph_sparse)):
            t1 = time.perf_counter()
            part_checks, counted = fn(torch, ctx, work)
            seconds[part] = time.perf_counter() - t1
            checks.update({f"{part}_{k}": v for k, v in part_checks.items()})
            for n, c in counted.items():
                total[n] += c
    ctx["graph_launches"] = total
    emit("graph", ok=all(checks.values()), checks=checks, launches=total,
         seconds=seconds, phase_seconds=time.perf_counter() - t0,
         card=ctx["smi"])
    for name, ok in checks.items():
        if not ok:
            ctx["failures"].append(f"graph check {name} failed")


# the contrib phase (ROADMAP A item 10 (e)-(g)): contrib.amp on BERT-base
# at the bert cell's widths (bf16 products from a float32 model) and on
# train_mnist.py's LeNet (float16, dynamic loss scaling), the contrib
# layers at their papers' shapes, ONNX of a ResNet-50 v1 stem and first
# stage, Monitor, print_summary, check_consistency and feature_list
CONTRIB_SEED = 25
CONTRIB_LR = 1e-3            # LAMB, multi_precision: the loss falls in 4
CONTRIB_TIMED = 3            # amp steps after 1 warm-up (and the f32 step)
CONTRIB_MON_BATCH = 4        # the monitored BERT forward: 4 x 512
CONTRIB_PARITY = dict(layers=2, batch=2, seq=128, masked=19)
# the poisoned step: the scaler starts at 2^16 and halves on the natural
# overflows of the first steps (4 of them on the card); step 6 comes after
# a clean step, so its skip is the poison's alone (checked before it)
CONTRIB_F16_STEPS, CONTRIB_POISON_STEP = 8, 6
# Shi et al. 2015's Moving-MNIST encoder: 64 x 64 frames in 4 x 4 patches
CONTRIB_CONVLSTM = dict(batch=16, steps=10, channels=16, size=16, hidden=64,
                        kernel=5, cpu_rows=2)
# Sak et al. 2014: 2048 cells projected to 512
CONTRIB_LSTMP = dict(batch=64, steps=20, input=512, hidden=2048, proj=512,
                     cpu_rows=8)
CONTRIB_ESPCN = dict(batch=16, channels=3, factor=3, size=100)  # ESPCN x3
CONTRIB_VDROP = dict(hidden=650, batch=20, steps=5, rate=0.5)
CONTRIB_ONNX = dict(batch=32, size=224)
F32_REL = 1e-4               # float32 parts, card vs CPU port: x max|ref|
ONNX_RTOL = 1e-5


def contrib_bert_steps(torch, net, arrays, steps, amp=None):
    """``1 + steps`` imperative LAMB steps of ``net`` (``Trainer``, with
    ``amp.init_trainer``/``scale_loss`` when ``amp`` is given): the
    losses, the timed steps' ms and the peak memory of the timed steps."""
    from tpu_mx_torch import autograd, gluon
    from tpu_mx_torch.models import MLMLoss
    trainer = gluon.Trainer(net.collect_params(), "lamb",
                            {"learning_rate": CONTRIB_LR,
                             "multi_precision": amp is not None})
    if amp is not None:
        amp.init_trainer(trainer)
    loss_fn = MLMLoss()
    losses, ms = [], []

    def step():
        with autograd.record():
            loss = loss_fn(net(*arrays[:4]), arrays[4])
        if amp is not None:
            with amp.scale_loss(loss, trainer) as scaled:
                scaled.backward()
        else:
            loss.backward()
        trainer.step(arrays[0].shape[0])
        return float(loss.mean().asscalar())
    losses.append(step())                               # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(steps):
        t0 = time.perf_counter()
        losses.append(step())
        ms.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    overflow = None
    if amp is not None:       # has_overflow over BERT-base's gradients
        overflow = contrib_overflow_reads(torch, amp, trainer._params,
                                          launches=True)
    del trainer
    return losses, ms, peak, overflow


def contrib_overflow_reads(torch, amp, params, launches=False):
    """``LossScaler.has_overflow(params)`` under
    ``torch.cuda.set_sync_debug_mode("warn")``: its answer and the
    synchronizing calls it made (one device-to-host read expected).  With
    ``launches``, also one call under the profiler: the host's launch
    and copy API calls (``launches``, gated: the profiler's device
    activity can miss a short window in a long process, its host calls
    are there) and the card's executions it saw (``device``).  The old
    check took two launches a gradient (``isfinite``, ``all``) and a
    stack; the foreach check takes a few a dtype group."""
    import warnings
    from tpu_mx_torch.contrib.amp import amp as amp_mod
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            flag = amp.LossScaler().has_overflow(params)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = [str(m.message) for m in w
             if "called a synchronizing CUDA operation" in str(m.message)]
    rec = dict(params=len(params), overflow=flag, syncs=len(syncs))
    if launches:
        grads = amp_mod._grads(params)
        seen = profiled_launches(
            torch, lambda: amp.LossScaler().has_overflow(params))
        rec.update(launches=seen["host_total"], device=seen["device"],
                   host_calls=seen["host_calls"], gradients=len(grads),
                   dtypes=sorted({str(g.dtype) for g in grads}))
    return rec


def contrib_dtypes_as_promised(torch, net):
    """Every LayerNorm parameter float32, every other one bfloat16."""
    from tpu_mx_torch.gluon.nn import LayerNorm
    norms = {id(p) for m in net.modules() if isinstance(m, LayerNorm)
             for p in m.parameters()}
    bad = [n for n, p in net.named_parameters()
           if p.dtype != (torch.float32 if id(p) in norms
                          else torch.bfloat16)]
    return bad, len(norms)


def contrib_amp_bert(torch, ctx):
    """(a) BERT-base declared in float32 (``_bert_once``'s widths, dropout
    0.1, batch 32 x 512 with ragged valid lengths): 1 + 3 imperative LAMB
    steps in float32, then ``amp.init()``, ``convert_model`` (LayerNorm
    stays float32), ``init_trainer`` and ``scale_loss``, 1 + 3 steps whose
    flash launches and routes are counted; then one monitored amp
    forward at 4 x 512, and the amp forward of a 2-layer full-width BERT
    at 2 x 128 against the CPU port's on the same weights."""
    import importlib
    import tpu_mx_torch as mx
    from tpu_mx_torch import nd
    from tpu_mx_torch.contrib import amp
    from tpu_mx_torch.contrib.amp import amp as amp_mod
    from tpu_mx_torch.kernels import flash_attention as fa
    from tpu_mx_torch.models import BERTModel, bert_base_config
    from tpu_mx_torch.monitor import Monitor
    ring = importlib.import_module("tpu_mx_torch.parallel.ring_attention")
    cfg = bert_base_config(max_len=TRAIN_SEQ)
    rng = np.random.RandomState(CONTRIB_SEED)
    valid = rng.randint(TRAIN_VALID[0], TRAIN_VALID[1] + 1, TRAIN_BATCH)
    batch = bert_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, TRAIN_MASKED, valid, rng)
    arrays = [nd.array(torch.from_numpy(b).cuda()) for b in batch]
    net = BERTModel(cfg, dtype="float32", device="cuda",
                    generator=torch.Generator(device="cuda")
                    .manual_seed(CONTRIB_SEED))
    f32_losses, f32_ms, f32_peak, _ = contrib_bert_steps(
        torch, net, arrays, CONTRIB_TIMED)
    torch.cuda.empty_cache()
    counters = (fa.flash_attention, fa.flash_attention_bwd_dq,
                fa.flash_attention_bwd_dkv)
    rec, checks = {}, {}
    amp.init()
    try:
        amp.convert_model(net)
        bad, n_norm = contrib_dtypes_as_promised(torch, net)
        dense0 = ring.dispatch_counts["dense"]
        reset_port_kernel_launches()
        for c in counters:
            c.routes = fa.route_counts()
        amp_losses, amp_ms, amp_peak, overflow = contrib_bert_steps(
            torch, net, arrays, CONTRIB_TIMED, amp=amp)
        launches = port_kernel_launches()
        routes = {k: dict(c.routes) for k, c in zip(FLASH_KERNELS,
                                                     counters)}
        layers, steps = cfg["num_layers"], CONTRIB_TIMED + 1
        checks.update(
            amp_finite=all(math.isfinite(v) for v in amp_losses),
            amp_loss_falls=amp_losses[-1] < amp_losses[0],
            dtypes_as_promised=not bad and n_norm > 0,
            flash_12_a_step=all(launches[k] == layers * steps
                                for k in FLASH_KERNELS),
            wgmma_route=all(r == dict(fa.route_counts(),
                                      wgmma=layers * steps)
                            for r in routes.values()),
            no_dense_arm=ring.dispatch_counts["dense"] == dense0,
            has_overflow_one_read=overflow["syncs"] == 1
            and overflow["overflow"] is False
            and overflow["params"] == len(list(net.parameters())),
            has_overflow_fused=0 < overflow["launches"]
            < overflow["gradients"] // 2)
        # one monitored forward: every encoder layer records a stat
        mon = Monitor(interval=1).install(net)
        mon.tic()
        with torch.no_grad():
            net.eval()
            net(*[a._data[:CONTRIB_MON_BATCH] for a in arrays[:4]])
        stats = mon.toc()
        mon.uninstall()
        names = [n for _, n, _ in stats]
        checks["monitor_every_layer"] = all(
            any(f"layers.{i}." in n or n.endswith(f"layers.{i}")
                for n in names) for i in range(layers)) and all(
            math.isfinite(v) for _, _, v in stats)
        rec["monitor"] = dict(stats=len(stats), blocks=len(set(names)),
                              first=stats[:3])
        del net
        torch.cuda.empty_cache()
        rec["parity"] = contrib_amp_parity(torch, cfg)
        checks["parity_logits"] = rec["parity"]["ok"]
    finally:
        amp_mod._deinit()
    checks["amp_deinit"] = not getattr(mx.nd.ops.FullyConnected,
                                       "__amp_wrapped__", False) \
        and not amp_mod._amp_state["originals"]
    rec.update(
        f32=dict(losses=f32_losses, step_ms=f32_ms,
                 step_ms_median=statistics.median(f32_ms),
                 peak_memory_bytes=f32_peak),
        amp=dict(losses=amp_losses, step_ms=amp_ms,
                 step_ms_median=statistics.median(amp_ms),
                 peak_memory_bytes=amp_peak, launches=launches,
                 launches_per_step={k: v / steps
                                    for k, v in launches.items()},
                 routes=routes, has_overflow=overflow,
                 dtypes_off_promise=bad[:5],
                 layernorms_float32=n_norm),
        speedup=statistics.median(f32_ms) / statistics.median(amp_ms),
        memory_ratio=amp_peak / f32_peak,
        model={**cfg, "declared": "float32", "amp": "bfloat16"},
        batch=dict(batch=TRAIN_BATCH, seq=TRAIN_SEQ, masked=TRAIN_MASKED),
        optimizer=f"Trainer lamb lr={CONTRIB_LR} (multi_precision under "
        "amp)")
    return rec, checks, launches


def contrib_amp_parity(torch, base_cfg):
    """The amp forward (predict mode) of a 2-layer full-width BERT at
    2 x 128 on the card against the CPU port's, same weights."""
    from tpu_mx_torch.contrib import amp
    from tpu_mx_torch.models import BERTModel
    p = CONTRIB_PARITY
    cfg = dict(base_cfg, num_layers=p["layers"], max_length=p["seq"])
    card = BERTModel(cfg, dtype="float32", device="cuda",
                     generator=torch.Generator(device="cuda")
                     .manual_seed(CONTRIB_SEED + 1))
    host = BERTModel(cfg, dtype="float32", device="cpu",
                     generator=torch.Generator().manual_seed(0))
    host.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    rng = np.random.RandomState(CONTRIB_SEED + 1)
    batch = bert_batch(cfg, p["batch"], p["seq"], p["masked"],
                       (p["seq"], p["seq"] - 31), rng)
    outs = []
    for net, dev in ((card, "cuda"), (host, "cpu")):
        amp.convert_model(net)
        net.eval()
        with torch.no_grad():
            outs.append(net(*[torch.from_numpy(b).to(dev)
                              for b in batch[:4]]).float().cpu())
    err = float((outs[0] - outs[1]).abs().max())
    scale = float(outs[1].abs().max())
    return dict(ok=err <= BF16_REL * scale and bool(torch.isfinite(
        outs[0]).all()), max_abs_err=err, max_ref=scale,
        tolerance=BF16_REL * scale, shape=list(outs[0].shape),
        config=dict(layers=p["layers"], batch=p["batch"], seq=p["seq"]))


def contrib_amp_f16(torch, ctx):
    """(b) ``train_mnist.py``'s LeNet at its defaults under
    ``amp.init("float16")`` with dynamic loss scaling, 8 steps: the first
    steps overflow at the scaler's 2^16 and halve it; at step 6 (its own
    gradients finite) one gradient is set to inf: the step is skipped
    (every weight bit-unchanged), the scale halves, the warning is
    issued, the later losses are finite; ``has_overflow`` reads the card
    once a step (``LossScaler.host_reads``, and the synchronizing calls
    ``torch.cuda.set_sync_debug_mode`` reports)."""
    import warnings
    from tpu_mx_torch import autograd
    from tpu_mx_torch.contrib import amp
    from tpu_mx_torch.contrib.amp import amp as amp_mod
    x, y = mnist_data(MNIST_BATCH * CONTRIB_F16_STEPS)
    amp.init("float16")
    try:
        net, trainer, loss_fn, it = mnist_recipe(x, y)
        amp.init_trainer(trainer)
        scaler = trainer._amp_loss_scaler
        losses, scales, skipped, reads, syncs = [], [], {}, [], None
        for i, b in enumerate(it):
            if i == CONTRIB_F16_STEPS:
                break
            with autograd.record():
                loss = loss_fn(net(b.data[0]), b.label[0])
            with amp.scale_loss(loss, trainer) as scaled:
                scaled.backward()
            if i == CONTRIB_POISON_STEP:
                clean = not scaler.has_overflow(trainer._params)
                g = trainer._params[0].grad._data
                g.view(-1)[0] = float("inf")
                before = [p.data()._data.clone() for p in trainer._params]
                scale0 = scaler.loss_scale
                syncs = contrib_overflow_reads(torch, amp,
                                               trainer._params)["syncs"]
            n0 = amp.LossScaler.host_reads
            with warnings.catch_warnings(record=True) as w:
                warnings.simplefilter("always")
                trainer.step(b.data[0].shape[0])
            reads.append(amp.LossScaler.host_reads - n0)
            if i == CONTRIB_POISON_STEP:
                skipped = dict(
                    weights_bit_unchanged=all(
                        torch.equal(a, p.data()._data)
                        for a, p in zip(before, trainer._params)),
                    scale_halved=scaler.loss_scale == scale0 / 2,
                    clean_before_poison=clean,
                    warned=any("overflow" in str(m.message) for m in w),
                    scale_before=scale0, scale_after=scaler.loss_scale)
            losses.append(float(loss.mean().asscalar()))
            scales.append(scaler.loss_scale)
    finally:
        amp_mod._deinit()
    checks = dict(
        poisoned_step_skipped=bool(skipped)
        and skipped["weights_bit_unchanged"]
        and skipped["clean_before_poison"],
        scale_halved=bool(skipped) and skipped["scale_halved"],
        warned=bool(skipped) and skipped["warned"],
        later_finite=all(math.isfinite(v)
                         for v in losses[CONTRIB_POISON_STEP + 1:]),
        one_host_read_a_step=reads == [1] * CONTRIB_F16_STEPS,
        one_sync_in_has_overflow=syncs == 1)
    rec = dict(losses=losses, loss_scales=scales, poisoned=skipped,
               host_reads_per_step=reads, has_overflow_syncs=syncs,
               params=len(trainer._params),
               recipe="lenet(10), sgd lr 0.05 momentum 0.9, batch 128")
    return rec, checks


def contrib_layers(torch, ctx):
    """(c) The contrib layers at their published shapes on the card, each
    held to the CPU port on the same weights (the leading rows where the
    rows are independent)."""
    import tpu_mx_torch as mx
    from tpu_mx_torch.gluon import rnn
    from tpu_mx_torch.gluon.contrib import nn as cnn
    from tpu_mx_torch.gluon.contrib import rnn as crnn
    torch.backends.cuda.matmul.allow_tf32 = False     # float32 products
    torch.backends.cudnn.allow_tf32 = False
    rec, checks = {}, {}

    def pair(build):
        card = build("cuda", torch.Generator(device="cuda")
                     .manual_seed(CONTRIB_SEED))
        host = build("cpu", torch.Generator().manual_seed(0))
        host.load_state_dict({k: v.cpu()
                              for k, v in card.state_dict().items()})
        return card, host

    def steps(cell, xs, states):
        outs = []
        with torch.no_grad():
            for x in xs:
                out, states = cell(x, states)
                outs.append(out)
        return outs

    def held(name, card_outs, host_outs, rows, t_card):
        a = torch.stack([o[:rows].float().cpu() for o in card_outs])
        b = torch.stack([o.float() for o in host_outs])
        err, scale = float((a - b).abs().max()), float(b.abs().max())
        rec[name] = dict(max_abs_err=err, max_ref=scale,
                         tolerance=F32_REL * scale, card_ms=t_card,
                         cpu_rows=rows, finite=bool(torch.isfinite(a).all()))
        checks[name] = err <= F32_REL * scale and rec[name]["finite"]

    c = CONTRIB_CONVLSTM

    def convlstm(dev, gen):
        cell = crnn.Conv2DLSTMCell(c["hidden"], kernel=c["kernel"],
                                   input_shape=(c["channels"], c["size"],
                                                c["size"]), generator=gen)
        return cell.to(dev)
    card, host = pair(convlstm)
    g = torch.Generator(device="cuda").manual_seed(CONTRIB_SEED + 2)
    xs = [torch.rand(c["batch"], c["channels"], c["size"], c["size"],
                     device="cuda", generator=g) for _ in range(c["steps"])]
    t0 = time.perf_counter()
    outs = steps(card, xs, card.begin_state(c["batch"]))
    torch.cuda.synchronize()
    t_card = (time.perf_counter() - t0) * 1e3
    r = c["cpu_rows"]
    held("conv2d_lstm", outs, steps(host, [x[:r].cpu() for x in xs],
                                    host.begin_state(r)), r, t_card)
    rec["conv2d_lstm"]["shape"] = dict(c)

    p = CONTRIB_LSTMP

    def lstmp(dev, gen):
        return crnn.LSTMPCell(p["hidden"], p["proj"], input_size=p["input"],
                              generator=gen).to(dev)
    card, host = pair(lstmp)
    xs = [torch.randn(p["batch"], p["input"], device="cuda", generator=g)
          for _ in range(p["steps"])]
    t0 = time.perf_counter()
    outs = steps(card, xs, card.begin_state(p["batch"]))
    torch.cuda.synchronize()
    t_card = (time.perf_counter() - t0) * 1e3
    r = p["cpu_rows"]
    held("lstmp", outs, steps(host, [x[:r].cpu() for x in xs],
                              host.begin_state(r)), r, t_card)
    rec["lstmp"]["shape"] = dict(p)

    e = CONTRIB_ESPCN
    f2 = e["factor"] ** 2
    x = torch.rand(e["batch"], e["channels"] * f2, e["size"], e["size"],
                   device="cuda", generator=g)
    shuffle = cnn.PixelShuffle2D(e["factor"])
    with mx.gpu(0):
        out = shuffle(mx.nd.array(x)).asnumpy()
    want = shuffle(x.cpu()).numpy()
    rec["pixelshuffle2d"] = dict(
        input=list(x.shape), output=list(out.shape),
        ms=cuda_ms(torch, lambda: shuffle(x)))
    checks["pixelshuffle2d"] = out.shape == (
        e["batch"], e["channels"], e["size"] * e["factor"],
        e["size"] * e["factor"]) and np.array_equal(out, want)

    v = CONTRIB_VDROP
    base = rnn.LSTMCell(v["hidden"], input_size=v["hidden"],
                        generator=torch.Generator(device="cuda")
                        .manual_seed(CONTRIB_SEED)).cuda()
    cell = crnn.VariationalDropoutCell(
        base, drop_inputs=v["rate"], drop_states=v["rate"],
        drop_outputs=v["rate"], generator=torch.Generator(device="cuda")
        .manual_seed(CONTRIB_SEED))
    cell.train()

    def masks():
        return [cell._mask_in, cell._mask_out] + list(cell._mask_states)
    xs = [torch.randn(v["batch"], v["hidden"], device="cuda", generator=g)
          for _ in range(v["steps"])]
    states, same, drawn = cell.begin_state(v["batch"]), True, []
    with torch.no_grad():
        for i, xx in enumerate(xs):
            out, states = cell(xx, states)
            if i == 0:
                first = [m.clone() for m in masks()]
            same = same and all(torch.equal(a, b)
                                for a, b in zip(first, masks()))
            drawn.append(bool(((out == 0) == (first[1] == 0)).all()))
        cell.reset()
        cell(xs[0], cell.begin_state(v["batch"]))
    redrawn = all(not torch.equal(a, b) for a, b in zip(first, masks()))
    keep = float(torch.cat([(m != 0).float().flatten() for m in first])
                 .mean())
    n = sum(m.numel() for m in first)
    rec["variational_dropout"] = dict(
        config=dict(v), keep_rate=keep,
        keep_tolerance=4 * math.sqrt(v["rate"] * (1 - v["rate"]) / n))
    checks["vdrop_same_mask_every_step"] = same and all(drawn)
    checks["vdrop_redrawn_after_reset"] = redrawn
    checks["vdrop_keep_rate"] = abs(keep - (1 - v["rate"])) <= \
        rec["variational_dropout"]["keep_tolerance"]
    return rec, checks


def contrib_resnet_stage(S):
    """ResNet-50 v1's stem and first bottleneck stage (64 -> 256
    channels, three units, the first with the projection shortcut), in
    inference-mode BatchNorm, as ``mx.sym``."""
    def bn(x, name):
        return S.BatchNorm(x, fix_gamma=False, eps=1e-5, name=name)

    def conv(x, filters, kernel, stride, pad, name):
        return S.Convolution(x, kernel=(kernel, kernel),
                             stride=(stride, stride), pad=(pad, pad),
                             num_filter=filters, no_bias=True, name=name)
    x = S.Variable("data")
    y = S.Activation(bn(conv(x, 64, 7, 2, 3, "conv0"), "bn0"),
                     act_type="relu", name="relu0")
    y = S.Pooling(y, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                  pool_type="max", name="pool0")
    for u in range(3):
        pre = f"stage1_unit{u}_"
        h = S.Activation(bn(conv(y, 64, 1, 1, 0, pre + "conv1"),
                            pre + "bn1"), act_type="relu", name=pre + "relu1")
        h = S.Activation(bn(conv(h, 64, 3, 1, 1, pre + "conv2"),
                            pre + "bn2"), act_type="relu", name=pre + "relu2")
        h = bn(conv(h, 256, 1, 1, 0, pre + "conv3"), pre + "bn3")
        short = bn(conv(y, 256, 1, 1, 0, pre + "sc"), pre + "sc_bn") \
            if u == 0 else y
        y = S.Activation(S.broadcast_add(h, short, name=pre + "add"),
                         act_type="relu", name=pre + "relu")
    return y


def contrib_onnx(torch, ctx, work):
    """(d) The ResNet-50 v1 stem and first stage exported with
    ``contrib.onnx.export_model`` and imported with ``import_model``, both
    graphs bound on the card at 32 x 224 x 224: the outputs within 1e-5
    relative."""
    import tpu_mx_torch as mx
    from tpu_mx_torch.contrib import onnx
    torch.backends.cudnn.allow_tf32 = False
    o = CONTRIB_ONNX
    sym = contrib_resnet_stage(mx.sym)
    shape = (o["batch"], 3, o["size"], o["size"])
    arg_shapes, out_shapes, aux_shapes = sym.infer_shape(data=shape)
    rng = np.random.RandomState(CONTRIB_SEED)
    params = {}
    for n, s in zip(sym.list_arguments(), arg_shapes):
        if n != "data":
            fan = float(np.prod(s[1:])) if len(s) > 1 else 1.0
            params[n] = (rng.randn(*s) * (np.sqrt(2 / fan) if len(s) > 1
                                          else 0.1)
                         + (1.0 if n.endswith("gamma") else 0.0))
    for n, s in zip(sym.list_auxiliary_states(), aux_shapes):
        params[n] = rng.uniform(0.5, 1.5, s) if n.endswith("var") \
            else rng.randn(*s) * 0.1
    params = {k: mx.nd.array(v.astype(np.float32), ctx=mx.gpu(0))
              for k, v in params.items()}
    data = mx.nd.array(rng.rand(*shape).astype(np.float32), ctx=mx.gpu(0))
    path = os.path.join(work, "resnet50_stage1.onnx")
    t0 = time.perf_counter()
    onnx.export_model(sym, params, [shape], path)
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sym2, arg2, aux2 = onnx.import_model(path)
    import_s = time.perf_counter() - t0
    gpu = mx.gpu(0)
    want = sym.eval(ctx=gpu, data=data, **params)[0]
    got = sym2.eval(ctx=gpu, data=data, **arg2, **aux2)[0]
    a, b = got._data, want._data
    err = float((a - b).abs().max())
    scale = float(b.abs().max())
    meta = onnx.get_model_metadata(path)
    rec = dict(file_bytes=os.path.getsize(path), export_seconds=export_s,
               import_seconds=import_s, output=list(b.shape),
               max_abs_err=err, max_ref=scale, rtol=ONNX_RTOL,
               nodes=len(sym.get_internals().list_outputs()),
               params=int(sum(v.size for v in params.values())),
               metadata=meta, imported_on=str(a.device),
               forward_ms=cuda_ms(torch, lambda: sym2.eval(
                   ctx=gpu, data=data, **arg2, **aux2), reps=5, warm=1))
    checks = dict(onnx_outputs=err <= ONNX_RTOL * scale and a.is_cuda,
                  onnx_shape=tuple(b.shape) == (o["batch"], 256, 56, 56),
                  onnx_metadata=meta["input_tensor_data"] == ["data"])
    return rec, checks


def contrib_tools(torch, ctx):
    """(e) ``Module.install_monitor`` on the graph phase's symbolic PTB LM
    for one batch (the reference's hooks nothing: the monitor records
    nothing), its ``print_summary``, ``check_consistency`` over
    ``[gpu(0), cpu(0)]`` at ResNet-50 and BERT-base shapes, and
    ``runtime.feature_list()``."""
    import io as _io
    import contextlib
    import tpu_mx_torch as mx
    from tpu_mx_torch import nd
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rec, checks = {}, {}
    n, seq = GRAPH_LM["batch"], 35
    sym, _, _ = lm_sym_gen(mx)(seq)
    mod = mx.module.Module(sym, context=mx.gpu(0))
    mod.bind(data_shapes=[("data", (n, seq))],
             label_shapes=[("softmax_label", (n, seq))], for_training=False)
    torch.manual_seed(CONTRIB_SEED)
    mod.init_params(initializer=mx.init.Uniform(0.1))
    mon = mx.monitor.Monitor(interval=1)
    mod.install_monitor(mon)
    rng = np.random.RandomState(CONTRIB_SEED)
    ids = np.minimum(rng.zipf(1.3, (n, seq + 1)) - 1,
                     GRAPH_LM["vocab"] - 1).astype(np.float32)
    b = mx.io.DataBatch(data=[nd.array(ids[:, :-1], ctx=mx.gpu(0))],
                        label=[nd.array(ids[:, 1:], ctx=mx.gpu(0))])
    buf = _io.StringIO()
    with contextlib.redirect_stdout(buf):
        mon.tic()
        mod.forward(b, is_train=False)
        mon.toc_print()
    out = mod.get_outputs()[0]._data
    checks["install_monitor"] = buf.getvalue() == "" and bool(
        torch.isfinite(out).all()) and tuple(out.shape) == (
        n * seq, GRAPH_LM["vocab"])
    summary = _io.StringIO()
    with contextlib.redirect_stdout(summary):
        total = mx.viz.print_summary(sym, shape={"data": (n, seq),
                                                 "softmax_label": (n, seq)})
    print(summary.getvalue(), flush=True)
    size = mx.nd.rnn_param_size("lstm", GRAPH_LM["embed"], GRAPH_LM["hidden"],
                                GRAPH_LM["layers"])
    want_total = GRAPH_LM["vocab"] * GRAPH_LM["embed"] + size \
        + GRAPH_LM["vocab"] * GRAPH_LM["hidden"] + GRAPH_LM["vocab"]
    checks["print_summary"] = total == want_total
    rec["print_summary"] = dict(total_params=total, lines=len(
        summary.getvalue().splitlines()))
    del mod
    rng = np.random.RandomState(CONTRIB_SEED + 3)
    cases = {
        "convolution_resnet50_conv2": (
            lambda a: nd.Convolution(a[0], a[1], kernel=(3, 3), pad=(1, 1),
                                     num_filter=64, no_bias=True),
            [rng.randn(8, 64, 56, 56), rng.randn(64, 64, 3, 3) * 0.05]),
        "fullyconnected_bert_ffn1": (
            lambda a: nd.FullyConnected(a[0], a[1], a[2], num_hidden=3072,
                                        flatten=False),
            [rng.randn(4, 128, 768), rng.randn(3072, 768) * 0.03,
             rng.randn(3072) * 0.1]),
        "softmax_bert_scores": (
            lambda a: nd.softmax(a[0], axis=-1),
            [rng.randn(8, 12, 128, 128) * 3])}
    consistency = {}
    for name, (fn, inputs) in cases.items():
        inputs = [x.astype(np.float32) for x in inputs]
        t0 = time.perf_counter()
        # the scale: the largest of the CPU port's output and gradients
        host = mx.test_utils.check_consistency(fn, inputs,
                                               ctx_list=[mx.cpu(0)])[0]
        scale = max(float(np.abs(a).max()) for a in [host[0]] + host[1])
        try:
            res = mx.test_utils.check_consistency(
                fn, inputs, ctx_list=[mx.gpu(0), mx.cpu(0)], rtol=F32_REL,
                atol=F32_REL * scale)
            ok = len(res) == 2
            err = {"output": float(np.abs(res[0][0] - res[1][0]).max()),
                   "grads": [float(np.abs(a - b).max()) for a, b in
                             zip(res[0][1], res[1][1])]}
        except AssertionError as e:
            ok, err = False, str(e)[:300]
        consistency[name] = dict(ok=ok, max_abs_err=err, max_ref=scale,
                                 atol=F32_REL * scale, rtol=F32_REL,
                                 shapes=[list(x.shape) for x in inputs],
                                 seconds=time.perf_counter() - t0)
        checks[f"consistency_{name}"] = ok
    rec["check_consistency"] = consistency
    feats = mx.runtime.Features()
    rec["features"] = {k: f.enabled for k, f in feats.items()}
    print([repr(f) for f in mx.runtime.feature_list()], flush=True)
    checks["features"] = all(feats.is_enabled(k) for k in
                             ("CUDA", "GPU", "NVCC", "KERNELS", "TORCH"))
    return rec, checks


def phase_contrib(ctx):
    """ROADMAP A item 10 (e)-(g) on the card: (a) :func:`contrib_amp_bert`,
    (b) :func:`contrib_amp_f16`, (c) :func:`contrib_layers`, (d)
    :func:`contrib_onnx`, (e) :func:`contrib_tools`.  The launch counts
    are set to 0 before the phase and read after it; the amp BERT-base
    part reports its own (its 4 steps)."""
    import tempfile
    import torch
    import tpu_mx_torch as mx
    from tpu_mx_torch.contrib.amp import amp as amp_mod
    from tpu_mx_torch.kernels import _build
    t0 = time.perf_counter()
    _build.BUILD_DIR.parent.mkdir(parents=True, exist_ok=True)
    total = dict.fromkeys(port_kernel_launches(), 0)
    checks, seconds, recs = {}, {}, {}
    original_fc = mx.nd.ops.FullyConnected
    try:
        with tempfile.TemporaryDirectory(
                prefix="contrib-", dir=str(_build.BUILD_DIR.parent)) as work:
            for part, fn in (("amp_bert", contrib_amp_bert),
                             ("amp_f16", contrib_amp_f16),
                             ("layers", contrib_layers),
                             ("onnx", lambda t, c: contrib_onnx(t, c, work)),
                             ("tools", contrib_tools)):
                t1 = time.perf_counter()
                reset_port_kernel_launches()
                got = fn(torch, ctx)
                for name, c in port_kernel_launches().items():
                    total[name] += c
                seconds[part] = time.perf_counter() - t1
                recs[part], part_checks = got[0], got[1]
                checks.update({f"{part}_{k}": v
                               for k, v in part_checks.items()})
                emit(f"contrib_{part}", ok=all(part_checks.values()),
                     checks=part_checks, seconds=seconds[part],
                     card=ctx["smi"], **got[0])
                torch.cuda.empty_cache()
    finally:
        amp_mod._deinit()
    checks["fully_connected_unpatched"] = \
        mx.nd.ops.FullyConnected is original_fc and \
        mx.nd.FullyConnected is original_fc
    ctx["contrib_launches"] = total
    ctx["contrib"] = dict(amp_step_ms=recs.get("amp_bert", {}).get(
        "amp", {}).get("step_ms_median"))
    emit("contrib", ok=all(checks.values()), checks=checks, launches=total,
         seconds=seconds, phase_seconds=time.perf_counter() - t0,
         card=ctx["smi"])
    for name, ok in checks.items():
        if not ok:
            ctx["failures"].append(f"contrib check {name} failed")


def wide_rows(ctx, name):
    """A kernel's wide instances for the kernels line: each shape's
    numbers from the kernel phase, with the launches of the wide_heads
    phase's run at that shape (the training attention's for the flash
    kernels, the spec12 serving arm's for the window of 12; bf16 queries
    and the float16 pool are paged decode's direct calls, 0)."""
    wide = ctx["wide_heads"]
    rows = {}
    for key, rec in ctx["wide_kernels"][name].items():
        if name == "paged_attention":
            n = wide["arms"]["spec12"]["launches"][name] \
                if key == "window12" else 0
        else:
            n = wide["attention"][key]["launches"][name]
        rows[key] = dict(rec, launches=n)
    # the runtime-D instances on the serving path: 8 heads of 512
    # (float32 prefills; decode with f32 and bf16 pools, windows of 12)
    if name in ("flash_attention_fwd", "paged_attention"):
        rows["serve_d512"] = dict(
            shape="TinyLM 4096 wide, 8 heads of 512, 4 layers, serve "
                  "traffic: f32_pool, bf16_pool, spec12",
            launches=sum(a["launches"][name]
                         for a in wide["huge_arms"].values()))
    return rows


def later_launches(ctx, name):
    """A kernel's launches in the MoE, example, operators, data and later
    phases."""
    return {f"launches_{p}": ctx[f"{p}_launches"][name]
            for p in ("moe_parity", "moe_train", "bert_example",
                      "moe_example", "operators", "data", "serve_arms",
                      "crossover", "quantize", "estimator",
                      "supervised_train", "fusion", "kvstore", "fleet",
                      "mesh", "wide_heads", "graph", "contrib")}


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
    phase_s = {}
    emit("env", card=ctx["smi"], torch=torch.__version__,
         cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvcc=_build.nvcc_version().strip()
         .splitlines()[-1])
    for name, fn in (("build", phase_build), ("kernels", phase_kernels),
                     ("serve", phase_serve),
                     ("serve_features", phase_serve_features),
                     ("serve_recovery", phase_serve_recovery),
                     ("serve_arms", phase_serve_arms),
                     ("train_parity", phase_train_parity),
                     ("train", phase_train),
                     ("train_f32", phase_train_f32),
                     ("resnet_parity", phase_resnet_parity),
                     ("resnet_train", phase_resnet_train),
                     ("lstm_parity", phase_lstm_parity),
                     ("lstm_train", phase_lstm_train),
                     ("ssd_parity", phase_ssd_parity),
                     ("ssd_train", phase_ssd_train),
                     ("zoo_parity", phase_zoo_parity),
                     ("zoo_train", phase_zoo_train),
                     ("zoo_example", phase_zoo_example),
                     ("imperative_parity", phase_imperative_parity),
                     ("mnist_train", phase_mnist_train),
                     ("bert_imperative", phase_bert_imperative),
                     ("moe_parity", phase_moe_parity),
                     ("moe_train", phase_moe_train),
                     ("bert_example", phase_bert_example),
                     ("moe_example", phase_moe_example),
                     ("operators", phase_operators),
                     ("data", phase_data),
                     ("quantize", phase_quantize),
                     ("estimator", phase_estimator),
                     ("attention_bias", phase_attention_bias),
                     ("crossover", phase_crossover),
                     ("supervised_train", phase_supervised_train),
                     ("fusion", phase_fusion),
                     ("kvstore", phase_kvstore),
                     ("fleet", phase_fleet),
                     ("mesh", phase_mesh),
                     ("wide_heads", phase_wide_heads),
                     ("graph", phase_graph),
                     ("contrib", phase_contrib),
                     ("rtc", phase_rtc)):
        t_phase = time.perf_counter()
        try:
            fn(ctx)
        except Exception as e:  # noqa: BLE001 — reported, and the run fails
            traceback.print_exc()
            emit(name, ok=False, error=f"{type(e).__name__}: {e}"[:2000])
            ctx["failures"].append(f"phase {name}: {type(e).__name__}")
            if name == "build":
                break
        finally:
            phase_s[name] = time.perf_counter() - t_phase
    # each phase's wall seconds (the script's time limit is the sum's)
    emit("phase_seconds", seconds=phase_s, total=sum(phase_s.values()))
    if ctx["failures"] or not {"kernels", "launches", "train_launches",
                                "train_f32_launches", "f32_kernels",
                                "serve_features_launches",
                                "serve_recovery_launches",
                                "resnet_parity", "resnet_launches",
                                "lstm_launches", "ssd_launches", "bias",
                                "rtc", "imperative_parity", "mnist_launches",
                                "bert_imperative_launches", "zoo_parity",
                                "zoo_train", "zoo_example",
                                "zoo_launches", "moe_parity_launches",
                                "moe_train_launches", "bert_example_launches",
                                "moe_example_launches",
                                "operators_launches", "data_launches",
                                "serve_arms_launches", "crossover_launches",
                                "quantize_launches",
                                "estimator_launches",
                                "supervised_train_launches",
                                "fusion_launches", "kvstore_launches",
                                "fleet_launches", "mesh_launches",
                                "wide_kernels", "wide_heads_launches",
                                "graph_launches", "contrib_launches"} \
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
               "launches_zoo": ctx["zoo_launches"][name],
               "launches_mnist": ctx["mnist_launches"][name],
               "launches_bert_imperative":
                   ctx["bert_imperative_launches"][name],
               "launches_serve_features":
                   ctx["serve_features_launches"][name],
               "launches_serve_recovery":
                   ctx["serve_recovery_launches"][name],
               "launches_train_f32": ctx["train_f32_launches"][name],
               **later_launches(ctx, name)}
        if name == "paged_attention":   # the speculative verify window
            t4 = ctx["paged_tq4"]
            row["tq4"] = {k: t4[k] for k in ("shape", "ms", "ms_queued",
                                             "plain_ms", "bound_ms",
                                             "bound_by", "math_route")}
            row["tq4"]["launches"] = ctx["serve_features_tq4"]
        # the head dim 192 and 256 instances, with their launches on the
        # wide_heads phase's paths
        row["wide"] = wide_rows(ctx, name)
        if "ms_queued" in e:
            row["ms_queued"] = e["ms_queued"]
        if "library_ms_dropout" in e:   # SDPA with dropout_p=0.1 as well
            row["library_ms_dropout"] = e["library_ms_dropout"]
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
                    "scale4": r["scale4"],
                    "ms_with_host": r["ms_with_host"],
                    "library_ms_with_host": r["library_ms_with_host"],
                    "host_us": r["host_us"],
                    "library_host_us": r["library_host_us"],
                    "launches_resnet": ctx["resnet_launches"]["rtc"],
                    "launches_lstm": ctx["lstm_launches"]["rtc"],
                    "launches_ssd": ctx["ssd_launches"]["rtc"],
                    "launches_zoo": ctx["zoo_launches"]["rtc"],
                    "launches_mnist": ctx["mnist_launches"]["rtc"],
                    "launches_bert_imperative":
                        ctx["bert_imperative_launches"]["rtc"],
                    "launches_serve_features":
                        ctx["serve_features_launches"]["rtc"],
                    "launches_serve_recovery":
                        ctx["serve_recovery_launches"]["rtc"],
                    "launches_train_f32": ctx["train_f32_launches"]["rtc"],
                    **later_launches(ctx, "rtc")})
    print(ctx["smi"], flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
