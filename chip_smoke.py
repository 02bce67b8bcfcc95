#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (future_od_tpu_torch) on one NVIDIA GPU.

Run from the repo root: `python3 chip_smoke.py`. It needs one CUDA card and
nvcc; the kernels are built from future_od_tpu_torch/csrc/ on first use into
build/torch_kernels/. Phases, one line each, every failure fatal:

0. the card's name and power limit (nvidia-smi); the kernel build and its
   seconds; that K1 (csrc/flash_attention.cu), K2
   (csrc/fused_bottleneck.cu), K3 (csrc/fused_stem.cu) and K4, K5 and K6
   (csrc/flash_attention_train.cu) run on the tensor cores: the SASS of each
   of their instantiations (cuobjdump) holds HMMA instructions, and that of
   K8's twelve (csrc/int8_conv.cu: the TMA kernel, the 16-byte and the byte
   gather, tiles of 64 and 128 channels, f32 and bf16 out) IGMMA, wgmma's
   int8 opcode, with its registers, shared memory and spills (ptxas's
   report in the build log, and the runtime's, with the resident blocks an
   SM).
1. each kernel against its plain PyTorch version at the flagship's shapes,
   f32 (TF32 off for matmuls and cuDNN convs) and bf16: max abs error
   within the stated tolerance, the kernel's time, the plain version's, one
   library call's where PyTorch has one (SDPA for K1) or a yardstick where
   none computes the function (K2: cuDNN's convolutions of the block,
   channels-last, plus the add and the relus; K3: cuDNN's 7x7/2 conv + bias
   + relu + max_pool2d), and the least time the card could take for the
   same work (for K1 also its exponentials, at 16 ex2 a clock an SM; K1's,
   K2's and K3's f32 products as three TF32 products each; K3's 147 taps,
   with its design's floor at the 192 it computes beside it).
1e. the head dims added for heads of 16 (runs/nuim_single_frame.py --debug:
   16/16 in the encoder, 32/16 in the conditional cross-attention) and 64
   (64/64): K1 and K4-K6 against their plain versions at each, f32 and
   bf16; then a narrow
   flagship with 4 heads of 16 (hidden 64) on a 1024x1024 clip, 1024
   tokens, through `make_inference_fn` with the default gates: K1 launches
   for every encoder self-attention and the scores and boxes equal the
   all-plain forward's.
2. the flagship at full width (ResNet-50, D=256, 8 heads, ff 2048, 6+6
   layers, 128 queries, 8 classes; random weights from seed 0) answering
   requests of 2 clips x 3 frames at 896x1600 through `make_inference_fn`
   with the default gates: the flash kernel must launch 6 times per forward;
   outputs finite, of the JAX package's shapes.
3. the same with FUTURE_OD_FUSED_RESNET=1 FUTURE_OD_FUSED_STEM=1: 6 fused
   bottleneck and 1 fused stem launches per forward, and the encoder's
   output, the decoder's output, the scores and the boxes equal to an
   all-plain forward's (every kernel gate off) within the stated tolerances
   in f32; then bf16 forwards, timed.
1b. the training flash kernels K4-K6 (and K7, the dropout mask inside them)
   against their plain versions at the stage-1 training shapes (448x800:
   350 tokens, batch 4; the encoder's self-attention and the decoder's image
   cross-attention), f32 and bf16, dropout 0 and 0.1: out, lse, dq, dk and
   dv within the stated tolerance, the device mask equal to the plain one bit
   for bit, and the plain version with another seed failing the check (a
   negative control). Then, at logits of about 1e6 (as the random-init
   backbone feeds the encoder), K5 and K6 given K4's lse keep p <= 1: dv
   equal to an f64 reference, dq and dk at rounding level. Times at f32
   and dropout 0.1, each kernel's three ways: paced (back-to-back calls by
   CUDA events, as phase 1; where the host is slower than the card it
   reads the host), device (the kernel's CUDA time under torch.profiler
   over the calls) and host (the host clock over 100 enqueues without a
   sync), with its launch (grid, the warps that split a query slab's keys,
   registers, resident warps an SM); the host µs of FlashAttentionTrain's
   forward and of its backward through autograd.grad, at the model's
   (B, N, H, d) layout. The library figures are
   F.scaled_dot_product_attention's forward (K4) and backward (one
   autograd.grad, K5 + K6), measured the same three ways; a line gives K5 +
   K6's device time a step beside SDPA's backward.
1c. the kernel-study tools (future_od_tpu_torch/tools, the main path of
   their slice): bench_softmax_floor and bench_fused_bottleneck run whole
   at their full bf16 shapes with the launch counts reset before and read
   after (T1, T2 v2 and T2 v3 must each launch); then each of the three
   kernels against its plain version elementwise at the tools' shapes cut
   to one image, f32 (TF32 off) and bf16: T1 in all three modes on inputs
   whose logits are exact in f32, v2 over tile_h 8/16/32 x im2col at
   layer1 and at tile 8 at block 0, layer2 and layer3, v3 at tile 8 and 16;
   and each kernel's time at the tools' full bf16 shapes beside its plain
   version's and a yardstick (T1: SDPA's forward; T2 v2 and v3: K2's,
   cuDNN's convolutions of the same blocks, channels-last).
1d. the stem study (future_od_tpu_torch/tools/bench_stem.py, the main path
   of its slice): `run()` whole at its full bf16 shape (24 x 896x1600) with
   the launch counts reset before and read after (T3 A, B, B16 and D must
   each launch); then each kernel against its plain version elementwise on
   one image, f32 (TF32 off) and bf16; and each kernel's time at the full
   shape beside its plain version's, its bound and a yardstick (cuDNN's
   7x7/2 conv + relu + max_pool2d for A, B and B16, cuDNN's 3x3 conv over
   D's 128-channel operands for D).
3b. the flagship with the space-to-depth stem (`space_to_depth=True`,
   otherwise phase 2's model) fed the host-packed 12-channel f32 video
   (data/loader.py::host_space_to_depth, as bench.py's BENCH_HOST_S2D
   feeds it), served with the default gates and with
   FUTURE_OD_FUSED_RESNET=1 FUTURE_OD_FUSED_STEM=1 (K3 takes the s2d
   kernel as it is, once a forward); the fused forward's encoder and decoder
   outputs, scores and boxes equal the all-plain forward's within phase 3's
   tolerances; request ms and the host-to-device copy beside phase 2's.
5. the flagship's train step at full width (phase 2's model with
   freeze_stem, the auction matcher and 128 cost slots) on 4 clips x 3
   frames at 448x800 with 256 target slots filled as bench_train.py fills
   them, f32 with TF32 off: (a) at dropout 0 the loss and every parameter's
   gradient with FUTURE_OD_TRAIN_FLASH=1 equal those of plain autograd
   attention within the stated tolerances, with the matcher's indices solved
   once and injected into both, and K4-K6 launch 18 times each per step;
   (b) five `make_train_step` steps at dropout 0.1 with the gate on (the
   main path of this phase, counted), then five with it off: losses finite,
   matcher rounds below 1000, the frozen stem+layer1 bit-identical, every
   trainable tensor moved; step times, peak memory, forward stage times and
   one profiled step.
6. the flagship's run script, `python -m
   future_od_tpu_torch.runs.nusc_spatiotemporal_imu_500ms --synthetic --debug
   --disable_wandb --epochs 2` (its `main()` in this process, its paths in a
   temporary directory), with FUTURE_OD_TRAIN_FLASH=1 FUTURE_OD_FUSED_RESNET=1
   FUTURE_OD_FUSED_STEM=1: epoch 1 at 448x800, batch 32 (the gradient audit, 2
   train steps, 8 eval batches of 2, AP, a checkpoint), epoch 2 at 896x1600,
   batch 16 (4 train steps, 8 eval batches, AP, the checkpoint and its
   `_final`, the net alone). First K4-K6 against their plain versions at both
   stages' shapes (350 tokens at batch 32, 1400 at batch 16; never run by an
   earlier phase), f32, dropout 0.1. The run must launch K4, K5 and K6 18
   times a train step and 18 in the audit, K2 6 times and K3 once an eval
   forward, K1 6 times an eval forward at stage 2 and never at stage 1, and
   none of K1-K3 in a train-mode forward (the counters are set to 0 as each
   stage starts); its losses finite, the auction below its round cap, each AP
   dict of the JAX package's keys and shapes with values in [0, 1] or NaN. A
   fresh Trainer from the script's `get_trainer` (no --restart) loads the
   checkpoint bit for bit (weights, optimizer, epoch, step, meters; `_final`'s
   net too), and each stage's first eval batch, on the final weights, gives
   the scores and boxes of an all-plain forward within phase 3's tolerances.
   Per stage: each train step's ms (CUDA events around the call), each eval
   batch's, the host's wait on the Loader, the peak memory, the launches, and
   one profiled train step's idle share and top kernels (after the checks).
6b. the same script with --bf16, then with --bf16 --accum 2, each run and
   checked as phase 6 runs and checks it: K4-K6 18 times a micro-batch (36
   a step at --accum 2) and in the f32 audit, K1-K3 only in the f32 eval;
   losses finite; the bf16 run's first train step within the stated
   tolerance of phase 6's f32 one (same weights, batch and dropout); the
   checkpoint's weights and AdamW's state f32 and a bit-equal resume; the
   dtypes K4-K6 receive (the JAX package's mixed precision promotes the
   transformer's operands to f32, models/precision.py); per stage the
   numbers of phase 6 and one profiled train step. Then one f32 step at
   dropout 0 of phase 5's full-width model and batch, --accum 2 against 1:
   loss and every gradient within the stated tolerances.
7. the data path at nuScenes' size, on the host: the committed 1600x900
   JPEGs (future_od_tpu_torch/data/fixtures/) decoded by the port's decoder
   (csrc/jpeg_decode.cpp, built with g++) must hash to the digests cv2 gave;
   per frame the decode's, the normalization's and the resizes' ms (to
   448x800 and 896x1600, float32 and uint8); the thread-pool Loader's and
   the worker-process loader's frames a second over clips of the fixtures
   through the dataset's transforms, beside the frames a second phase 6's
   and 6b's stage-1 steps consume.
8. every other model the JAX package builds, at full width (ResNet-50,
   D=256, 8 heads, ff 2048, 6+6 layers, 128 queries):
   8a. the single-frame script, `python -m
   future_od_tpu_torch.runs.nuim_single_frame --synthetic --short_train
   --epochs 1 --disable_wandb` (its `main()` in this process, as phase 6),
   with K2-K6 gated on, at its own 448x800 and batch 32 of single frames:
   first K4-K6 against their plain versions at its shapes (350 tokens, one
   image attention a decoder layer); K4-K6 12 times a train step and in the
   audit, K2 6 times and K3 once an eval forward, no K1; losses finite,
   the AP dicts checked; a later train step's ms, eval ms a batch, peak
   memory and one profiled train step.
   8b. the tracker eval script (`...runs.eval.nusc_tracker_baseline_eval
   --synthetic`, 896x1600, 3 frames) on a checkpoint of a random
   `build_single_frame` with nuScenes' 8 classes, K2/K3 gated on: the
   tracker baseline loads it bit for bit (one tree), K1 6, K2 6 and K3 1
   launches an eval batch, AP in [0, 1] or NaN; eval ms a batch and the
   host tracker's ms apart.
   8c. one request of 2 clips x 3 frames at 896x1600 through
   `make_inference_fn` for the joint, sequential and F2F encoders, the
   slotstates and "attend all at once" detectors and the capturing
   flagship, default gates: K1's launches as counted (joint 8, sequential
   14, else 6), scores and boxes equal an all-plain forward's within phase
   3's tolerances (f32, TF32 off), the captured rows sum to 1; request ms.
   Then K1 against its plain version on the inputs of its joint call (2800
   tokens) and of the sequential encoder's prevout and frame-memory
   cross-attentions.
9. serving at full width (phase 2's flagship, seeds 0 and 1; the kernels
   K1-K3 are the ops fod::flash_attention, fod::fused_bottleneck and
   fod::fused_stem, and phase 1 gives K1's host µs a call through the op
   beside its launch alone):
   9a. `StreamingSession` over 12 lockstep streams (bench.py's batch) of 5
   frames at 896x1600, f32 (TF32 off): each output equals
   `make_inference_fn` on the clip ending at its frame within phase 3's
   tolerances, with the default gates (K1 6 launches an encode, none a
   detect) and the fused gates (K1 6, K2 6, K3 1 an encode); clips/s of the
   session beside the batch path's at 12 clips a request, f32 default and
   bf16 fused; the host-to-device copy of one frame batch beside a clip's.
   9b. the serve script, `python -m future_od_tpu_torch.runs.serve` (its
   `main()` in this process) at the JAX script's defaults (24 streams,
   batch 12, 8 rounds), f32, --bf16 and --bf16 --device_normalize, default
   gates: its JSON line (clips/s, p50/p95/p99, pad fraction 0), K1 6
   launches a dispatch, the rings' MB and the peak memory; then 3 staggered
   streams through max_batch=4 against per-stream sessions within phase
   3's tolerances, and a stream served alone (padded) against the same
   stream sharing its batches (the max difference; 0 when no op mixes
   batch rows).
   9c. `export_inference` at phase 2's request under the default and the
   fused gates and `export_streaming` at one frame batch of 12 (fused),
   each loaded from its bytes: its outputs against the eager ones within
   phase 3's tolerances, its launches (K1 6, and K2 6, K3 1 under the fused
   gates, a forward or encode; none a detect), a wrong shape refused, the
   loaded artifact's request ms beside the eager request's.
10. data parallelism (`future_od_tpu_torch/parallel/`):
   10a. `python -m torch.distributed.run --standalone --nproc_per_node 2`
   runs this file's `--phase10a-rank` role: in each rank the flagship's
   script (`main()`, --synthetic --debug --epochs 1, its epoch at stage 1:
   448x800, global batch 32, 16 a rank, f32, TF32 off, K1-K6 gated on);
   NCCL with a card a rank, gloo with both ranks on one card (printed). Its
   launches (K4-K6 18 a step and in the audit; K2 6, K3 1 an eval batch),
   the checkpoint written once and resumed bit for bit on both ranks, the
   checkpoint's eval at stage 2's size (1400 tokens: K1 6 a forward) on
   both ranks against one process's eval (rank 0) within DIST_AP_ATOL, one
   step at dropout 0 (the reduced gradients and loss against one process's
   on the same 32 clips and weights, within DIST_LOSS_RTOL and
   DIST_GRAD_RTOL); each rank's step ms, the all-reduce's ms (timed, and
   its events under torch.profiler), peak GB a rank.
   10b. torchrun with one rank: the NCCL init, an all-reduce, and a step
   through the one-rank mesh against the same step without a mesh.
   10c. the session and the server over a mesh of two devices (both cards,
   or the one card listed twice) at phase 9's sizes, fused gates, against
   the unsharded ones within phase 3's tolerances; clips/s of each.
   10d. tensor parallelism: torchrun starts 2 ranks of this file's
   `--phase10d-rank` role, a (1, 2) mesh (gloo with both ranks on one
   card), the flagship at full width cut over the model axis (4 of 8 heads
   and half of every FFN a rank, `parallel/mesh.py::shard_model`), each rank
   on all TP_BATCH clips at stage 1 (448x800). One step at dropout 0 and
   one at TP_DROPOUT with K4-K6 (their dropout hashing the global heads),
   each against one process's step on the same weights, batch and seed
   (rank 0), the one process on the TP step's assignment: the loss within
   DIST_LOSS_RTOL, each group's largest gradient gap within TP_GRAD_RTOL
   (10a's form), which a step with a planted fault (copy_to_model's
   backward without its sum) must exceed; both ranks' assignments equal,
   and the one process's own recorded beside them. Then an eval at stage 2's size (1400
   tokens: K1 on 4 heads a rank) against one process's within phase 3's
   tolerances. K4-K6 and K1 must launch on both ranks; each rank's step ms,
   its sums over the model group a step (count and MB) and its peak GB
   beside one process's.
11. the int8 PTQ backbone (ops/quant.py; every trunk convolution on K8,
   csrc/int8_conv.cu, an implicit GEMM on wgmma m64nNk32 s8 with int32 sums,
   the stride-1 1x1s fed by TMA; each input's range and codes by K9,
   csrc/int8_quantize.cu):
   11a. K8 against its plain version (a float64 convolution of the codes,
   exact) at every distinct convolution of the flagship's trunk on 4 frames
   at 896x1600 (the 7x7/2 stem, the s2d 4x4 stem, each stage's 1x1, 3x3,
   3x3/2 and 1x1/2 downsample), f32 and bf16 out: bit-equal; each shape's
   K8 ms, plain ms, cuDNN's bf16 conv of the shape (a yardstick),
   torch._int_mm's ms on the stride-1 1x1s (the same int8 product; the
   faster of the weights row-major and column-major) and the bound at the
   int8 dense peak (1979 TOPS) or the bytes (the codes the windows read);
   K8's and _int_mm's device ms under torch.profiler beside the paced ms;
   per forward, the 53 launches' sums. K9 at every distinct convolution
   input (post-ReLU on a block, signed on a stem), f32 and bf16: its range
   (of |x| and of x) and its codes bit-equal to their plain versions; ms,
   device ms, plain ms, the bytes bound, and the range's one-call yardstick
   (torch.linalg.vector_norm(x, inf, dim=(0, 1, 2))); per forward, K9's 49
   range passes and 53 quantizations.
   11b. the dynamic int8 flagship (phase 2's weights, int8_backbone) through
   make_inference_fn: K8 53, K9 49 + 53 and K1 6 launches a forward (K8
   33, K9 30 + 33, K2 6, K3 1 under the fused gates); the trunk's output
   bit-equal to the same forward with K8's and K9's plain versions in the
   kernels' places, the encoder, decoder, scores and boxes within phase 3's
   tolerances of it; outputs finite; request ms in f32, fused f32 and bf16
   beside phases 2-3's; the backbone's device ms split by part (K8, the
   ranges, the quantization, the weights' smoothing and quantization, the
   residual add and relu, layout copies; future_od_tpu_torch/tools/
   int8_split.py) in f32 and
   bf16; the int8 features' and scores' gap to the float forward (reported:
   random weights).
   11c. the static int8 flagship (int8_static): refused before calibration,
   calibrated on the request's batch (calibrate_int8), then bit-equal to
   the dynamic path on it (trunk, scores, boxes); on another batch its gap
   to float (reported); calibration and request ms, K9's 53 quantizations
   and no range pass a forward, the backbone's split. The same built under
   the fused gates: range buffers only for the 33 int8 convolutions,
   refused, calibrated, then the fused launches and bit-equal to dynamic.
   11d. StreamingSession with the static and the dynamic int8 model over
   phase 9a's 12 streams: clips/s beside phase 9a's f32 default, the static
   session's output against its batch path within phase 9's tolerances;
   `export_inference` of the dynamic int8 model, loaded from its bytes:
   bit-equal to eager, K8 53 and K9 49 + 53 launches; the flagship's eval script
   (`...runs.eval.nusc_500ms_attendprev_decoder_eval --synthetic --int8`) on
   a checkpoint of a random flagship with nuScenes' 8 classes (phase 6's has
   the synthetic data's 2, which the eval scripts' model does not take): K8
   53 and K9 49 + 53 launches an eval batch, its AP dict.
12. the learning loop (future_od_tpu_torch/tools/). 12a. future_overfit_probe
   (the flagship on 8 synthetic three-frame clips at 128x192) for 300
   steps: the mean loss of the last 10 below half of step 0's; AP50 every
   100 steps and the step time. 12b. matcher_drift_branched's base config
   (the auction, batch 16, 256 + 64 images) for 3 epochs through the
   Trainer into build/phase12/drift_base, then quant_ap_check's float and
   int8 arms on that checkpoint over its fit and val0 splits, both arms' AP
   dicts: K8 53, K9 49 + 53 launches a forward of the int8 arm; every
   distinct K8 and K9 call of an int8 forward (16 images at 128x192, the
   trained weights' activations) bit-equal to its plain version (K8 also
   with bf16 out, K9 also on its input scaled to a range of 1e15), timed
   beside its plain version and bound. 12c. the exact solver
   (ops/native_lap.py, g++ on the card's host) against the auction on the
   card on a batch of unique-optimum costs: equal indices.
4. a `kernels` JSON line (with each main-path kernel's launches on phase 6's,
   6b's, 8's, 9's, 10's, 11's and 12's runs), then the device JSON line, last.

Phases 2 and 3 also say where a request's time goes: the device time of the
backbone, the encoder and the detector (CUDA events recorded by forward
hooks at each stage's entry and exit) in the last request, and, for one more
request under torch.profiler, the time the card ran a kernel or a copy, the
share of the request's wall time it ran none, and the kernels with the most
device time. The detection heads' last layers, zero at init, are randomized
so that scores and boxes depend on the image.

Exits non-zero, printing no result, without a CUDA device or outside the
repo.
"""
from __future__ import annotations

import contextlib
import copy
import inspect
import json
import math
import os
import subprocess
import sys
import time
from functools import partial

import numpy as np

# Peaks of one H100 SXM (NVIDIA data sheet, dense): f32 on the CUDA cores,
# bf16 on the tensor cores, HBM3 bandwidth; TF32 on the tensor cores, which
# the port's tensor-core kernels use three times a product for f32 (3xTF32).
PEAK_OPS = {"float32": 67e12, "bfloat16": 989e12}
PEAK_BYTES = 3.35e12
PEAK_TF32 = 495e12
# The exponential unit: 16 ex2 a clock an SM (CUDA C Programming Guide,
# arithmetic instruction throughput, compute capability 9.0).
EX2_PER_CLOCK_SM = 16

GATES = (
    "FUTURE_OD_DISABLE_FLASH", "FUTURE_OD_FLASH_MIN_KEYS", "FUTURE_OD_FLASH_MIN_QUERIES",
    "FUTURE_OD_FUSED_RESNET", "FUTURE_OD_FUSED_STEM", "FUTURE_OD_FUSE_STAGES",
    "FUTURE_OD_TRAIN_FLASH", "FUTURE_OD_INT8_SKIP", "FUTURE_OD_S2D_STEM",
)
BATCH, FRAMES, HEIGHT, WIDTH = 2, 3, 896, 1600
REQUESTS = 3
# Kernel vs plain, elementwise: |out - plain| <= RTOL * |plain| + ATOL *
# max |plain|. f32: sums of up to 1400 products reassociated. bf16: the plain
# versions compute in f32 from the same bf16 values and round where the
# kernels round, so both sides round f32 values once (one bf16 ulp, 2^-7
# relative, apart), plus 1e-3 of the output's scale for a fused bottleneck
# intermediate that reassociation rounds to the other side of a bf16 boundary.
KERNEL_RTOL = {"float32": 0.0, "bfloat16": 2.0**-7}
KERNEL_ATOL = {"float32": 2e-5, "bfloat16": 1e-3}
# Whole forward, fused kernels vs all plain, f32 (TF32 off): f32 rounding
# carried through 50 layers of random weights (the plain side runs some of
# its convolutions as cuDNN FFTs, whose rounding differs most from direct
# sums). Encoder and decoder outputs: max abs difference over max abs
# value; scores are sigmoids; boxes are pixels of a 1600-wide frame. Each is
# 10x the gap measured on an H100 (1.05e-4, 1.04e-6, 9.5e-7, 9.8e-4 px).
ENCODER_RTOL, DECODER_RTOL, SCORE_TOL, BOX_TOL_PX = 1e-3, 1e-5, 1e-5, 1e-2
PHASE3_TOLS = {"encoder_out_rel": ENCODER_RTOL, "decoder_out_rel": DECODER_RTOL,
               "score_err": SCORE_TOL, "box_err_px": BOX_TOL_PX}
TOP_KERNELS = 8
# the port's kernels on the serving and training paths, as the profiler names them
PORT_KERNEL_NAMES = ("flash_attention_kernel", "fused_bottleneck_kernel", "fused_stem_kernel",
                     "train_fwd_kernel", "train_dq_kernel", "train_dkv_kernel",
                     "int8_gemm_tma_kernel", "int8_conv_gather_kernel",
                     "channel_range_kernel", "quantize_kernel", "quantize_channels_kernel")
# Training: bench_train.py's stage-1 config (448x800, 3 frames, 256 target
# slots) at batch 4 instead of 32.
TRAIN_BATCH, TRAIN_HEIGHT, TRAIN_WIDTH, TRAIN_SLOTS, TRAIN_STEPS = 4, 448, 800, 256, 5
TRAIN_TOKENS = (TRAIN_HEIGHT // 32) * (TRAIN_WIDTH // 32)
# (label, BH, Nq, Nk, d, dv, calls per train step): 6 encoder self-attentions
# over 4 clips x 2 past frames x 8 heads; 6 decoder layers x 2 image memories
# of conditional cross-attention, 128 queries, concat heads.
TRAIN_ATTENTIONS = (
    ("encoder", TRAIN_BATCH * 2 * 8, TRAIN_TOKENS, TRAIN_TOKENS, 32, 32, 6),
    ("decoder", TRAIN_BATCH * 8, 128, TRAIN_TOKENS, 64, 32, 12),
)
TRAIN_KERNELS = ("flash_train_fwd", "flash_train_dq", "flash_train_dkv")
HOST_ROUNDS = 5  # phase 1b's host µs: the median of this many rounds
# Train step, flash kernels vs plain autograd attention, f32 (TF32 off), at
# dropout 0 with injected matcher indices: |loss difference| over |loss|,
# and per parameter max |grad difference| over max(max |grad|, GRAD_FLOOR x
# the largest max |grad| of the model). The floor covers gradients that are
# zero but for rounding: key biases (softmax is shift-invariant), the
# egodeep attention's q/k (one key), decoder layer 0's self-attention q/k
# (its values are all equal). Per part of the model, 10x the gap measured on
# an H100: 7.08e-3 in the separate encoder (the random-init backbone
# amplifies f32 rounding in its gradients; the phase also reports how far
# each f32 path lies from the plain path in f64) and 6.72e-5 in the
# detector. The losses were equal to the bit; LOSS_RTOL allows a few f32
# ulps.
LOSS_RTOL, GRAD_FLOOR = 1e-6, 1e-4
GRAD_RTOL = {"separate_encoder": 0.071, "detector": 6.7e-4}
# Phase 1e: (label, B, H, Nq, Nk, d, dv) at heads of 16, the debug config's
# encoder self-attention over 1024 tokens and its decoder's concat heads, and
# at an encoder's heads of 64 (hidden 512 over 8 heads).
HEAD16_ATTENTIONS = (
    ("encoder 16/16", 2, 4, 1024, 1024, 16, 16),
    ("decoder 32/16", 2, 4, 300, 1024, 32, 16),
    ("encoder 64/64", 1, 8, 1024, 1024, 64, 64),
)
# The narrow flagship's scores and boxes (px), through K1 vs all plain, f32:
# tests/test_torch_kernels_cuda.py::test_small_flagship_kernels_vs_plain's.
NARROW_TOLS = {"score_err": 1e-4, "box_err_px": 1e-2}
NARROW_FRAME = 1024  # the narrow flagship's frames: 1024x1024, 32x32 = 1024 tokens
K2_YARDSTICK = ("cuDNN's convolutions of the block (three, and the projection where it has "
                "one), channels-last, plus the add and the relus")
K3_YARDSTICK = "cuDNN's 7x7/2 conv + bias + relu + max_pool2d over the unpacked frames"
# Phase 1c: the kernel-study tools' kernels, with the TPU tools' file:line.
TOOL_KERNELS = {
    "attention_floor": "tools/bench_softmax_floor.py:55",
    "bottleneck_v2": "tools/bench_fused_bottleneck.py:76",
    "fused_layer1": "tools/bench_fused_bottleneck.py:215",
}
TOOL_SOURCES = {"attention_floor": "attention_floor.cu", "bottleneck_v2": "bottleneck_variants.cu",
                "fused_layer1": "bottleneck_variants.cu"}
# T2 in bf16 at the tools' data: an intermediate (h1 or h2) rounded to the
# other side of a bf16 boundary moves an output by a few thousandths of max
# |plain| (K2 in phase 1 on an H100: 3.1e-3; v2 at layer2 there: 5.9e-3
# absolute, past 1e-3 of max), bounded by one ulp of the largest output,
# 2^-8 of max |plain|. In layer1 each of the three blocks' outputs can round
# so, and the later blocks' identity residuals carry it on: 3 x 2^-8 (v3 at
# tile 8 on an H100: 1.17e-2 absolute, past 2^-8 of max).
BOTTLENECK_BF16_ATOL = {"bottleneck_v2": 2.0**-8, "fused_layer1": 3 * 2.0**-8}
# Phase 1d: the stem study's kernels, with the TPU tool's file:line.
STEM_KERNELS = {
    "stem_a": "tools/bench_stem.py:112",
    "stem_b": "tools/bench_stem.py:181",
    "stem_b16": "tools/bench_stem.py:265",
    "stem_d": "tools/bench_stem.py:416",
}

# Phase 6: the flagship's run script as a user starts it, on the synthetic
# data (64 train and 16 validation clips), with every gate of K1-K6 on.
TRAINER_SCRIPT = "future_od_tpu_torch.runs.nusc_spatiotemporal_imu_500ms"
TRAINER_ARGV = ["--synthetic", "--debug", "--disable_wandb", "--epochs", "2"]
TRAINER_GATES = {"FUTURE_OD_TRAIN_FLASH": "1", "FUTURE_OD_FUSED_RESNET": "1",
                 "FUTURE_OD_FUSED_STEM": "1"}
# the script's two stages at --epochs 2, by the video's height: (name, train
# steps, eval batches)
TRAINER_STAGES = {448: ("stage 1 (448x800, batch 32)", 2, 8),
                  896: ("stage 2 (896x1600, batch 16)", 4, 8)}
MAIN_KERNELS = ("flash_attention", "fused_bottleneck", "fused_stem") + TRAIN_KERNELS
# launches a step call must make, by mode and stage: a train step and the
# gradient audit's backward launch K4-K6 on the 6 encoder and 12 decoder
# attentions; an eval forward K2 on 6 stride-1 blocks, K3 once, and K1 on the
# 6 encoder self-attentions where they reach 1024 keys (1400 tokens at stage
# 2; 350 at stage 1)
TRAINER_LAUNCHES = {
    ("train", 448): {name: 18 for name in TRAIN_KERNELS},
    ("train", 896): {name: 18 for name in TRAIN_KERNELS},
    ("audit", 448): {name: 18 for name in TRAIN_KERNELS},
    ("eval", 448): {"fused_bottleneck": 6, "fused_stem": 1},
    ("eval", 896): {"flash_attention": 6, "fused_bottleneck": 6, "fused_stem": 1},
}
AP_KEYS = ("all", "classavg", "threshavg", "classavg threshavg", "generic", "generic threshavg")
# Phase 6b: the script in bf16 and with accumulation (label, extra argv,
# micro-batches a step). The bf16 run's first train step against phase 6's
# f32 one on the same weights, batch and dropout: the loss within
# BF16_FIRST_LOSS_RTOL (bf16 moves the CPU test's tiny flagship 1.5e-3
# from JAX's bf16 loss and 6e-4 from f32; at full width, 10x that margin
# and more for the deeper backbone).
PRECISION_RUNS = (("bf16", ["--bf16"], 1), ("bf16 accum 2", ["--bf16", "--accum", "2"], 2))
BF16_FIRST_LOSS_RTOL = 5e-2
# --accum 2 against 1 at dropout 0, f32, TF32 off: the loss, and each
# group's largest gradient difference over its largest gradient, at 10x the
# gaps measured on an H100 (loss 5.9e-7; encoder 2.7e-4, detector 5.6e-4).
# On the CPU the same comparison is at 1.6e-6 (tests/test_torch_mixed_
# precision.py); on the card the half batch changes cuDNN's algorithms and
# K4-K6's split of a slab across warps (chosen from batch x heads), and the
# random-init encoder's softmax, one-hot at logits near 1e6, amplifies
# those roundings as it does phase 5a's (GRAD_RTOL). Phase 5a's
# per-parameter form is reported beside it (the query embedding, whose
# gradient nearly cancels over the batch: 2.2e-2 of its own largest).
ACCUM_LOSS_RTOL = 6e-6
ACCUM_GRAD_RTOL = {"separate_encoder": 2.7e-3, "detector": 5.6e-3}
# Phase 7: the committed 1600x900 fixtures, decoded and timed on the host.
FIXTURE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "future_od_tpu_torch",
                           "data", "fixtures")
DATA_REPEATS = 10
DATA_BATCHES = 3
DATA_WORKERS = 8
TRAINER_STAGES_BATCH = {448: 32, 896: 16}
# K4-K6 at the shapes of the script's two stages, which no earlier phase
# runs: stage 1 (448x800: 350 tokens, batch 32; the decoder's 256 batch-heads
# take split 1, where phase 1b's batch 4 takes split 4) and stage 2
# (896x1600: 1400 tokens, batch 16). (label, BH, Nq, Nk, d, dv, calls per
# train step)
TRAINER_ATTENTIONS = (
    ("stage 1 encoder", 32 * 2 * 8, 350, 350, 32, 32, 6),
    ("stage 1 decoder", 32 * 8, 128, 350, 64, 32, 12),
    ("stage 2 encoder", 16 * 2 * 8, 1400, 1400, 32, 32, 6),
    ("stage 2 decoder", 16 * 8, 128, 1400, 64, 32, 12),
)

# Phase 8: every model the JAX package builds, at full width (ResNet-50,
# D=256, 8 heads, ff 2048, 6+6 layers, 128 queries).
# 8a: the single-frame script as a user starts it, on the synthetic data (64
# train clips of one frame at 448x800, batch 32: 2 train steps; 128
# validation clips at batch 12: 11 eval batches), with every gate of K2-K6 on.
SINGLE_FRAME_SCRIPT = "future_od_tpu_torch.runs.nuim_single_frame"
SINGLE_FRAME_ARGV = ["--synthetic", "--short_train", "--epochs", "1", "--disable_wandb"]
SINGLE_FRAME_CALLS = {"train": 2, "audit": 1, "eval": 11}
# K4-K6 at its shapes: 32 single frames, 350 tokens, 8 heads; one image
# attention a decoder layer. (label, BH, Nq, Nk, d, dv, calls per train step)
SINGLE_FRAME_ATTENTIONS = (
    ("single-frame encoder", 32 * 8, 350, 350, 32, 32, 6),
    ("single-frame decoder", 32 * 8, 128, 350, 64, 32, 6),
)
# launches a step call must make: K4-K6 on the 6 encoder self-attentions and
# the 6 decoder image attentions of a train step (and of the audit's
# backward); K2 on 6 stride-1 blocks and K3 once an eval forward; no K1 (350
# keys)
SINGLE_FRAME_LAUNCHES = {
    "train": {name: 12 for name in TRAIN_KERNELS},
    "audit": {name: 12 for name in TRAIN_KERNELS},
    "eval": {"fused_bottleneck": 6, "fused_stem": 1},
}
# 8b: the tracker eval script on the synthetic data at 896x1600 (128
# validation clips of 3 frames at batch 12), on a checkpoint of a random
# build_single_frame with nuScenes' 8 classes, with K2 and K3 gated on: an
# eval batch folds its 2 past frames into one backbone and encoder call, so
# K1 launches on the 6 encoder self-attentions (1400 tokens), K2 6 times and
# K3 once.
TRACKER_SCRIPT = "future_od_tpu_torch.runs.eval.nusc_tracker_baseline_eval"
TRACKER_GATES = {"FUTURE_OD_FUSED_RESNET": "1", "FUTURE_OD_FUSED_STEM": "1"}
TRACKER_EVAL_BATCHES = 11
TRACKER_LAUNCHES = {"flash_attention": 6, "fused_bottleneck": 6, "fused_stem": 1}
# 8c: one request of 2 clips x 3 frames at 896x1600 a variant, default gates:
# K1 launches a forward. The per-frame encoder's 6 (the 2 past frames
# folded); joint: 2 layers over the 2 frames' 2800 tokens; sequential: 2
# layers x (frame 0: self; frame 1: self, prevout, frame memory); the
# decoder's 128 queries stay plain (K1 needs 256 queries).
VARIANT_K1 = {"joint": 8, "sequential": 14, "f2f": 6, "slotstates": 6,
              "attend all at once": 6, "capturing flagship": 6}
# K1's calls held against its plain version on the variants' own inputs:
# (variant, index of the K1 call in a forward, what it is)
VARIANT_K1_CALLS = (
    ("joint", 6, "joint self-attention over 2 frames, 2800 tokens"),
    ("sequential", 9, "prevout cross-attention: frame 1's queries, frame 0's encoder output"),
    ("sequential", 10, "frame-memory cross-attention: frame 1's queries, frame 0's raw tokens"),
)


# 9: serving. bench.py's batch of 12 as 12 streams in lockstep, 5 frames
# each (clips end at frames 1-3 of the stream); the serve script at the JAX
# script's defaults (24 streams, batch 12, 8 rounds, 896x1600).
IMU_WIDTHS = {"translation": 3, "acceleration": 3, "rotation": 4, "rotation_rate": 3, "speed": 1}
SERVE_STREAMS, SERVE_STREAM_FRAMES, SERVE_TIMED_STEPS = 12, 5, 6
SERVE_SCRIPT = "future_od_tpu_torch.runs.serve"
SERVE_RUNS = (("f32", []), ("bf16", ["--bf16"]), ("bf16 uint8", ["--bf16", "--device_normalize"]))
FUSED_GATES = {"FUTURE_OD_FUSED_RESNET": "1", "FUTURE_OD_FUSED_STEM": "1"}
FUSED_LAUNCHES = {"flash_attention": 6, "fused_bottleneck": 6, "fused_stem": 1}


# Phase 10: data parallelism. 10a: the flagship's script under `torchrun
# --nproc_per_node 2` at stage 1 (448x800, global batch 32, 16 a rank, f32,
# TF32 off; --epochs 1, its one epoch at stage 1's size), NCCL with a card a
# rank, gloo with both ranks on one card; then the checkpoint's eval at
# stage 2's size (K1's 1400 tokens), and one step at dropout 0 beside one
# process's. 10b: torchrun with one rank (NCCL). 10c: serving over a mesh of
# two devices.
# Phase 11, the int8 PTQ backbone: K8's launches a forward (the stem, 16
# blocks x 3, 4 downsamples) and under the fused gates (K2 takes layer1's and
# layer2's stride-1 blocks, K3 the stem: 20 convolutions); K9's: a range pass
# a dynamic convolution but the downsamples (each shares its block's conv1's:
# 49, 30 fused), a quantization each; the int8 dense peak of one H100 SXM
# (NVIDIA data sheet); the timing target a call kind.
INT8_LAUNCHES = 53
INT8_RANGE_LAUNCHES = 49
INT8_FUSED_LAUNCHES = {"flash_attention": 6, "fused_bottleneck": 6, "fused_stem": 1,
                       "int8_conv": 33, "int8_channel_range": 30, "int8_quantize": 33}
INT8_DYNAMIC_LAUNCHES = {"flash_attention": 6, "int8_conv": INT8_LAUNCHES,
                         "int8_channel_range": INT8_RANGE_LAUNCHES,
                         "int8_quantize": INT8_LAUNCHES}
INT8_STATIC_LAUNCHES = {k: n for k, n in INT8_DYNAMIC_LAUNCHES.items()
                        if k != "int8_channel_range"}
INT8_STATIC_FUSED_LAUNCHES = {k: n for k, n in INT8_FUSED_LAUNCHES.items()
                              if k != "int8_channel_range"}
INT8_KERNELS = ("int8_conv", "int8_channel_range", "int8_quantize")  # K8, K9's two
PEAK_INT8 = 1979e12
INT8_TIME_S = 0.1
INT8_EVAL_SCRIPT = "future_od_tpu_torch.runs.eval.nusc_500ms_attendprev_decoder_eval"
DIST_RANKS = 2
DIST_ARGV = ["--synthetic", "--debug", "--disable_wandb", "--epochs", "1"]
DIST_BATCH = 32
DIST_TIMEOUT_S = 480
# The 2-rank step (16 rows a rank, the gradients summed over the ranks)
# against one process's on the same 32 clips and weights, dropout 0: the
# loss, and each group's largest gradient difference over its largest
# gradient (phase 6b's form); the half batch changes cuDNN's algorithms and
# K4-K6's split as --accum 2 does. 10x the gaps measured on an H100 (two
# ranks sharing the card over gloo: loss 1.33e-7; encoder 9.4e-6, detector
# 2.8e-5); 10b's one-rank mesh step against no mesh is held to the same.
DIST_LOSS_RTOL = 1.4e-6
DIST_GRAD_RTOL = {"separate_encoder": 9.4e-5, "detector": 2.8e-4}
# the 2-rank eval's AP dict against one process's on the same checkpoint
# (measured equal on the H100; the CPU tests' AP tolerance)
DIST_AP_ATOL = 1e-6
# Phase 10d: two ranks of a (1, 2) mesh, each on all TP_BATCH clips at stage
# 1; the eval at stage 2's size on TP_EVAL_BATCH clips
TP_RANKS, TP_BATCH, TP_EVAL_BATCH, TP_DROPOUT = 2, 8, 2, 0.1
TP_TIMEOUT_S = 420
# 10d's gradients against one process's, on the TP step's assignment: the
# auction's answer moves with a last-bit change of the costs where bids
# nearly tie (at dropout 0 the one process's own assignment differs from
# the TP step's in 14 slots, at 0.1 in none), and a slot given to another
# query moves that query's gradients by their own size. Each group's
# largest gap over its largest gradient (10a's form), 10x the larger of the
# two steps' gaps measured on an H100 (encoder 7.4e-5 at dropout 0.1,
# detector 7.5e-6 at 0). The encoder's is above 10a's: the cut sums every
# row-parallel projection in two parts where 10a's cut sums only the
# gradients of two halves of the batch. A step with a planted fault
# (copy_to_model's backward without its sum) measured 0.92 / 0.35, and 10d
# requires it to exceed these bounds.
TP_GRAD_RTOL = {"separate_encoder": 7.4e-4, "detector": 7.5e-5}
# a 10d rank's launches: a train step's (K4-K6 on the 6 encoder and 12
# decoder attentions, as one process's) and the stage-2 eval's (K1 on the 6
# encoder self-attentions)
TP_STEP_LAUNCHES = {name: 18 for name in ("flash_train_fwd", "flash_train_dq", "flash_train_dkv")}
TP_EVAL_LAUNCHES = {"flash_attention": 6}
# 10d's head-share check in phase 1b, at 10d's attentions (label, clips x
# frames of the encoder or clips of the decoder, Nq, Nk, d, dv)
TP_ATTENTIONS = (("encoder", TP_BATCH * 2, TRAIN_TOKENS, TRAIN_TOKENS, 32, 32),
                 ("decoder", TP_BATCH, 128, TRAIN_TOKENS, 64, 32))
RANK_ROLES = ("--phase10a-rank", "--phase10b-rank", "--phase10d-rank")


def log(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def set_gates(**values: str) -> None:
    for name in GATES:
        os.environ.pop(name, None)
    os.environ.update(values)


def gpu_name_and_power() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]


def time_ms(torch, fn, target_s: float = 0.3) -> float:
    """Mean device time of one call, by CUDA events over a run of calls."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    iters = max(3, min(50, int(target_s / max(time.perf_counter() - t0, 1e-6))))
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(ops: float, nbytes: float, dtype: str):
    t_ops, t_bytes = ops / PEAK_OPS[dtype], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def tc_bound(ops: float, nbytes: float, dtype: str):
    """The least time of a product on the tensor cores: bf16 at 989 TFLOP/s,
    f32 as 3xTF32 (three times the operations at 495), or the bytes.
    Returns (ms, "operations" or "bytes", which binds)."""
    products = "3xTF32 products" if dtype == "float32" else "bf16 products"
    t_ops = 3 * ops / PEAK_TF32 if dtype == "float32" else ops / PEAK_OPS[dtype]
    t_bytes = nbytes / PEAK_BYTES
    if t_ops >= t_bytes:
        return t_ops * 1e3, "operations", products
    return t_bytes * 1e3, "bytes", "bytes"


def sm_clock_hz() -> float:
    """The card's highest SM clock, as nvidia-smi reads it."""
    return 1e6 * float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        check=True, capture_output=True, text=True,
    ).stdout.split()[0])


def flash_bound(torch, ops: float, nbytes: float, exps: float, dtype: str):
    """K1's least time: the largest of its products' time (bf16 at 989
    TFLOP/s; f32 as 3xTF32, three times the operations at 495), its bytes'
    and its exponentials' at EX2_PER_CLOCK_SM. Returns (ms, "operations" or
    "bytes", which binds, {each: ms})."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    products = "3xTF32 products" if dtype == "float32" else "bf16 products"
    times = {
        products: (3 * ops / PEAK_TF32 if dtype == "float32" else ops / PEAK_OPS[dtype]),
        "ex2": exps / (EX2_PER_CLOCK_SM * sms * sm_clock_hz()),
        "bytes": nbytes / PEAK_BYTES,
    }
    binds = max(times, key=times.get)
    return (times[binds] * 1e3, "bytes" if binds == "bytes" else "operations", binds,
            {k: t * 1e3 for k, t in times.items()})


def tensor_core_report(lib_name: str, kernel: str, instantiations: int, resources: dict,
                       op: str = "HMMA"):
    """Phase 0's proof that a kernel runs on the tensor cores: `op`
    instructions (HMMA, or IGMMA for int8 wgmma) in the SASS of each
    instantiation of `kernel` in library `lib_name`, with ptxas's registers
    and spills from the build log and `resources` (the runtime's, from the
    kernel's info query). Raises unless there are `instantiations` of them,
    each with `op`."""
    import re
    from pathlib import Path

    from future_od_tpu_torch.ops import _kernels

    lib = _kernels.library_path(lib_name)
    cuobjdump = Path(_kernels._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], check=True,
                          capture_output=True, text=True).stdout
    counts = {}
    for part in sass.split("Function : ")[1:]:
        name = part.split(None, 1)[0]
        if kernel in name:
            counts[name] = {o: part.count(o) for o in (op, "MUFU.EX2", "LDSM", "LDGSTS", "UTMALDG",
                                                       "UTMASTG")}
    if len(counts) != instantiations or not all(c[op] for c in counts.values()):
        raise AssertionError(f"{kernel}'s SASS: {counts}; want {op} in each of "
                             f"{instantiations} instantiations")
    build_log = _kernels.BUILD_DIR / f"{lib_name}.log"
    ptxas = {}
    if build_log.exists():
        for name, stores, loads, regs in re.findall(
                r"Compiling entry function '(\w+)'.*?(\d+) bytes spill stores, (\d+) bytes "
                r"spill loads.*?Used (\d+) registers", build_log.read_text(), re.S):
            if kernel in name:
                ptxas[name] = {"registers": int(regs), "spill_stores": int(stores),
                               "spill_loads": int(loads)}
    return {"sass": counts, "ptxas": ptxas or "no build log", "runtime": resources}


def k1_tensor_core_report():
    """K1: every (dtype, head dims) instantiation."""
    import torch

    from future_od_tpu_torch.ops import flash_attention as fa

    resources = {f"{dt} d{d} dv{dv}": fa.flash_attention_info(d, dv, getattr(torch, dt))
                 for dt in ("float32", "bfloat16") for d, dv in fa.SUPPORTED_HEAD_DIMS}
    return tensor_core_report(fa.NAME, "flash_attention_kernel",
                              2 * len(fa.SUPPORTED_HEAD_DIMS), resources)


def k2_tensor_core_report():
    """K2: every (dtype, cmid) instantiation; the runtime's resources with
    and without the downsample's x chunks."""
    import torch

    from future_od_tpu_torch.ops import fused_resnet as fr

    resources = {f"{dt} cmid{cmid} downsample {ds}":
                 fr.fused_bottleneck_info(cmid, getattr(torch, dt), ds)
                 for dt in ("float32", "bfloat16") for cmid in fr.BOTTLENECK_CMIDS
                 for ds in (False, True)}
    return tensor_core_report(fr.BOTTLENECK, "fused_bottleneck_kernel",
                              2 * len(fr.BOTTLENECK_CMIDS), resources)


def k3_tensor_core_report():
    """K3: both dtypes."""
    import torch

    from future_od_tpu_torch.ops import fused_resnet as fr

    resources = {dt: fr.fused_stem_info(getattr(torch, dt)) for dt in ("float32", "bfloat16")}
    return tensor_core_report(fr.STEM, "fused_stem_kernel", 2, resources)


def k8_tensor_core_report():
    """K8: both output dtypes x both tile widths x its three kernels (the TMA
    GEMM, the 16-byte and the byte gather), on the int8 warpgroup MMA
    (IGMMA, wgmma's SASS)."""
    import torch

    from future_od_tpu_torch.ops import int8_conv as k8

    resources = {f"{dt} {variant} n{bn}": k8.int8_conv_info(getattr(torch, dt), variant, bn)
                 for dt in ("float32", "bfloat16") for variant in k8.VARIANTS
                 for bn in (64, 128)}
    return tensor_core_report(k8.NAME, "int8_", 4 * len(k8.VARIANTS), resources, op="IGMMA")


def train_tensor_core_report():
    """K4, K5 and K6: every (dtype, head dims) instantiation; the runtime's
    resources and launch at the encoder's training shape."""
    import torch

    from future_od_tpu_torch.ops import flash_attention as fa

    _, BH, Nq, Nk, *_ = TRAIN_ATTENTIONS[0]
    reports = {}
    for name, kernel in (("flash_train_fwd", "train_fwd_kernel"),
                         ("flash_train_dq", "train_dq_kernel"),
                         ("flash_train_dkv", "train_dkv_kernel")):
        resources = {f"{dt} d{d} dv{dv}": fa.flash_train_info(name, d, dv, getattr(torch, dt),
                                                               BH, Nq, Nk)
                     for dt in ("float32", "bfloat16") for d, dv in fa.SUPPORTED_HEAD_DIMS}
        reports[name] = tensor_core_report(fa.TRAIN_NAME, kernel,
                                           2 * len(fa.SUPPORTED_HEAD_DIMS), resources)
    return reports


def device_us(torch, fn, calls: int = 20, sessions: int = 3) -> float:
    """Mean device µs a call: the CUDA time of every kernel and copy `fn`
    launched under torch.profiler over `calls` calls, over the calls. The
    first profiler session of a process on a fresh machine has once seen no
    device event at all (on an H100), so a session that sees none is run
    again, up to `sessions` in all; raises if none saw device time."""
    from torch.autograd import DeviceType

    fn()
    torch.cuda.synchronize()
    for _ in range(sessions):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        total = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA and not e.key.startswith("Activity Buffer"))
        if total > 0:
            return total / calls
    raise AssertionError(f"the profiler saw no device time in {sessions} sessions")


def add_or_none(total, value):
    """total + value, None once either is None (a number not measured)."""
    return None if total is None or value is None else total + value


def device_ms_or_none(torch, fn, calls: int = 10):
    """Phase 11's device ms a call (device_us), or None where the profiler
    saw no device activity in its sessions (it has, once, after phase 10
    in the same process): a reported number, not a gate."""
    try:
        return device_us(torch, fn, calls=calls) / 1e3
    except AssertionError:
        return None


def host_us(torch, fn, calls: int = 100) -> float:
    """Mean host µs of one call: the host clock over `calls` enqueues with
    no sync between them (the card is synchronised before and after, off
    the clock)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return seconds / calls * 1e6


def median_and_least(values):
    ordered = sorted(values)
    return ordered[len(ordered) // 2], ordered[0]


def launch_plan(torch, fa, name, BH, Nq, Nk, d, dv, dtype):
    """A training kernel's launch at a shape: grid, threads, the warps that
    split a query slab's keys, registers, spills, resident blocks and warps
    an SM, and the grid's warps an SM."""
    info = fa.flash_train_info(name, d, dv, dtype, BH, Nq, Nk)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    warps = info["threads"] // 32
    return {"grid": [info["grid_x"], info["grid_y"]], "threads": info["threads"],
            "split": info["split"], "registers": info["registers"],
            "local_bytes": info["local_bytes"], "blocks_per_sm": info["blocks_per_sm"],
            "resident_warps_per_sm": info["blocks_per_sm"] * warps,
            "grid_warps_per_sm": info["grid_x"] * info["grid_y"] * warps / sms}


def check_close(name, out, ref, dtype, atol=None):
    """(max abs error, its tolerance at that element's worst case); raises
    where any element is outside RTOL * |plain| + ATOL * max |plain| (ATOL
    the dtype's unless given)."""
    out, ref = out.float(), ref.float()
    diff = (out - ref).abs()
    atol = KERNEL_ATOL[dtype] if atol is None else atol
    tol = KERNEL_RTOL[dtype] * ref.abs() + atol * ref.abs().max()
    if not bool((diff <= tol).all()):
        worst = int(((diff - tol) / tol).argmax())
        raise AssertionError(
            f"{name} {dtype}: |out - plain| {diff.flatten()[worst].item()} > "
            f"{tol.flatten()[worst].item()} at element {worst}"
        )
    return diff.max().item(), tol.flatten()[int(diff.argmax())].item()


def conv_weight(torch, w, dt):
    """An (in, out) matrix or HWIO kernel as cuDNN takes it: OIHW,
    channels-last, in dt."""
    w = w.t()[:, :, None, None] if w.dim() == 2 else w.permute(3, 2, 0, 1)
    return w.to(dt).contiguous(memory_format=torch.channels_last)


def yardstick_weights(torch, weights, dt):
    """A bottleneck's weights ((in, out) matrices, HWIO 3x3, biases) as
    cuDNN takes them (`conv_weight`), biases in dt."""
    return {k: (t.to(dt) if k.startswith("b") else conv_weight(torch, t, dt))
            for k, t in weights.items()}


def block_yardstick(torch, x, w1, b1, w2, b2, w3, b3, wd=None, bd=None):
    """K2's yardstick: cuDNN's convolutions of the block on channels-last
    NHWC x (`yardstick_weights`), plus the add and the relus (no library
    call fuses the block). Returns NHWC."""
    F = torch.nn.functional
    xc = x.permute(0, 3, 1, 2)  # NHWC memory: a channels-last NCHW view
    h = F.relu(F.conv2d(xc, w1, b1))
    h = F.relu(F.conv2d(h, w2, b2, padding=1))
    h = F.conv2d(h, w3, b3)
    return F.relu(h + (xc if wd is None else F.conv2d(xc, wd, bd))).permute(0, 2, 3, 1)


def kernel_phase(torch, dev):
    """Phase 1 on device `dev`. Returns per-kernel records (per-call
    numbers per shape)."""
    import torch.nn.functional as F

    from future_od_tpu_torch.models.resnet import space_to_depth, stem_weights_to_space_to_depth
    from future_od_tpu_torch.ops import flash_attention as fa
    from future_od_tpu_torch.ops import fused_resnet as fr

    gen = torch.Generator(device=dev).manual_seed(1)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    records = {"flash_attention": [], "fused_bottleneck": [], "fused_stem": []}

    # K1: the encoder's self-attention, 2 clips x 2 past frames, 8 heads.
    shape = (2 * BATCH, 8, (HEIGHT // 32) * (WIDTH // 32), 32)
    scale = 1.0 / math.sqrt(shape[-1])
    q32, k32, v32 = randn(*shape), randn(*shape), randn(*shape)
    for dtype in ("float32", "bfloat16"):
        q, k, v = (t.to(getattr(torch, dtype)) for t in (q32, k32, v32))
        out = fa.flash_attention(q, k, v, scale)
        ref = fa.reference_attention(q, k, v, scale)
        err, tol = check_close("flash_attention", out, ref, dtype)
        n_bh, n_h, n_tok, d = shape
        ops, nbytes = fa.attention_cost(n_bh, n_h, n_tok, n_tok, d, d, q.element_size())
        exps = fa.attention_exponentials(n_bh, n_h, n_tok, n_tok)
        b_ms, b_by, b_is, b_each = flash_bound(torch, ops, nbytes, exps, dtype)
        rec = dict(
            shape=list(shape), dtype=dtype, per_forward=6, max_abs_err=err, tol=tol,
            ms=time_ms(torch, lambda: fa.flash_attention(q, k, v, scale)),
            plain_ms=time_ms(torch, lambda: fa.reference_attention(q, k, v, scale)),
            library_ms=time_ms(
                torch, lambda: F.scaled_dot_product_attention(q, k, v, scale=scale)
            ),
            bound_ms=b_ms, bound_by=b_by, bound_is=b_is, bound_each_ms=b_each,
            ops=ops, bytes=nbytes, exps=exps,
            # the host's µs a call: through the op fod::flash_attention (the
            # wrapper, the dispatcher) and the op's CUDA implementation alone
            # (the launch as it was before the op)
            host_us=host_us(torch, lambda: fa.flash_attention(q, k, v, scale)),
            host_us_launch=host_us(torch, lambda: fa.flash_attention_cuda(q, k, v, scale)),
        )
        records["flash_attention"].append(rec)
        log("kernel", kernel="flash_attention", **rec)

    # K2: layer1 block 0 (downsample), a layer1 inner block, a layer2 inner block.
    n_img = 2 * BATCH
    blocks = [
        ("layer1.0", (n_img, HEIGHT // 4, WIDTH // 4), 64, 64, 256, True, 1),
        ("layer1.1", (n_img, HEIGHT // 4, WIDTH // 4), 256, 64, 256, False, 2),
        ("layer2.1", (n_img, HEIGHT // 8, WIDTH // 8), 512, 128, 512, False, 3),
    ]
    for label, (B, H, W), cin, cmid, cout, ds, per_forward in blocks:
        x32 = randn(B, H, W, cin).abs()
        w32 = dict(
            w1=randn(cin, cmid, scale=math.sqrt(2 / cin)), b1=randn(cmid, scale=0.1),
            w2=randn(3, 3, cmid, cmid, scale=math.sqrt(2 / (9 * cmid))), b2=randn(cmid, scale=0.1),
            w3=randn(cmid, cout, scale=math.sqrt(1 / cmid)), b3=randn(cout, scale=0.1),
        )
        if ds:
            w32.update(wd=randn(cin, cout, scale=math.sqrt(1 / cin)), bd=randn(cout, scale=0.1))
        for dtype in ("float32", "bfloat16"):
            dt = getattr(torch, dtype)
            x = x32.to(dt)
            w = {k: (t if k.startswith("b") else t.to(dt)) for k, t in w32.items()}
            packed = fr.pack_bottleneck(dt, **w)  # once, as the model's blocks pack theirs
            out = fr.fused_bottleneck_packed(x, packed)
            ref = fr.bottleneck_plain(x, **w)
            err, tol = check_close(f"fused_bottleneck {label}", out, ref, dtype)
            ops, nbytes = fr.bottleneck_cost(B, H, W, cin, cmid, cout, ds, x.element_size())
            b_ms, b_by, b_is = tc_bound(ops, nbytes, dtype)
            yard = yardstick_weights(torch, w32, dt)
            rec = dict(
                block=label, shape=[B, H, W, cin], cmid=cmid, cout=cout, dtype=dtype,
                per_forward=per_forward, max_abs_err=err, tol=tol,
                ms=time_ms(torch, lambda: fr.fused_bottleneck_packed(x, packed)),
                plain_ms=time_ms(torch, lambda: fr.bottleneck_plain(x, **w)),
                library_ms=time_ms(torch, lambda: block_yardstick(torch, x, **yard)),
                library_is=f"a yardstick: {K2_YARDSTICK}",
                bound_ms=b_ms, bound_by=b_by, bound_is=b_is, ops=ops, bytes=nbytes,
            )
            records["fused_bottleneck"].append(rec)
            log("kernel", kernel="fused_bottleneck", **rec)

    # K3: the 896x1600 stem over space-to-depth input.
    video = randn(n_img, HEIGHT, WIDTH, 3)
    xs32 = space_to_depth(video)
    w7 = randn(7, 7, 3, 64, scale=math.sqrt(2 / 147))
    w4_32 = stem_weights_to_space_to_depth(w7)
    bias = randn(64, scale=0.1)
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        xs, w4 = xs32.to(dt), w4_32.to(dt)
        frames, w7c, bias_dt = video.to(dt).permute(0, 3, 1, 2), conv_weight(torch, w7, dt), bias.to(dt)
        packed = fr.pack_stem(dt, w4, bias)  # once, as the model packs its stem
        out = fr.fused_stem_packed(xs, packed)
        ref = fr.stem_plain(xs, w4, bias)
        err, tol = check_close("fused_stem", out, ref, dtype)
        ops, nbytes = fr.stem_cost(n_img, HEIGHT // 2, WIDTH // 2, xs.element_size())
        b_ms, b_by, b_is = tc_bound(ops, nbytes, dtype)
        # the design computes the s2d kernel's 45 zero taps too: 192 taps, not 147
        ops192, _ = fr.stem_cost(n_img, HEIGHT // 2, WIDTH // 2, xs.element_size(), fr.STEM_K)
        rec = dict(
            shape=list(xs.shape), dtype=dtype, per_forward=1, max_abs_err=err, tol=tol,
            ms=time_ms(torch, lambda: fr.fused_stem_packed(xs, packed)),
            plain_ms=time_ms(torch, lambda: fr.stem_plain(xs, w4, bias)),
            library_ms=time_ms(torch, lambda: F.max_pool2d(
                F.relu(F.conv2d(frames, w7c, bias_dt, stride=2, padding=3)), 3, 2, 1)),
            library_is=f"a yardstick: {K3_YARDSTICK}",
            bound_ms=b_ms, bound_by=b_by, bound_is=b_is, ops=ops, bytes=nbytes,
            design_floor_ms=tc_bound(ops192, nbytes, dtype)[0],
            design_floor_is="192 taps (the s2d kernel's zeros included) on the tensor cores",
        )
        records["fused_stem"].append(rec)
        log("kernel", kernel="fused_stem", **rec)
    torch.cuda.synchronize()
    return records


def train_kernel_phase(torch, dev):
    """Phase 1b on device `dev`: K4-K7 against their plain versions at the
    stage-1 training shapes, and K4-K6 over a share of the heads against the
    all-heads call (`head_share_check`). Returns per-kernel records."""
    from future_od_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=dev).manual_seed(2)
    seed = 12345
    records = {name: [] for name in TRAIN_KERNELS}
    timings, paths = [], {}  # what is timed after the checks
    for label, BH, Nq, Nk, d, dv, per_step in TRAIN_ATTENTIONS:
        q32, k32, do32 = (torch.randn(*s, generator=gen, device=dev)
                          for s in ((BH, Nq, d), (BH, Nk, d), (BH, Nq, dv)))
        v32 = torch.randn(BH, Nk, dv, generator=gen, device=dev)
        nq_pad, nk_pad = fa.train_shapes(Nq, Nk, 256, 512)
        scale = 1.0 / math.sqrt(d)
        for dtype in ("float32", "bfloat16"):
            q, k, v, do = (t.to(getattr(torch, dtype)) for t in (q32, k32, v32, do32))
            costs = fa.train_attention_cost(BH, Nq, Nk, d, dv, q.element_size())
            for rate in (0.0, 0.1):
                args = (seed, scale, rate, nq_pad, nk_pad)
                tag = f"{label} {dtype} rate {rate}"
                ref_out, ref_lse = fa.flash_train_fwd_plain(q, k, v, *args)
                delta = (do.float() * ref_out.float()).sum(-1)
                out, lse = fa.flash_train_fwd(q, k, v, *args)
                errs = {"flash_train_fwd": max(
                    check_close(f"flash_train_fwd out {tag}", out, ref_out, dtype)[0],
                    check_close(f"flash_train_fwd lse {tag}", lse, ref_lse, "float32")[0])}
                dq = fa.flash_dq(q, k, v, do, ref_lse, delta, *args)
                errs["flash_train_dq"] = check_close(
                    f"flash_train_dq {tag}", dq, fa.flash_dq_plain(q, k, v, do, ref_lse, delta, *args),
                    dtype)[0]
                dk, dvv = fa.flash_dkv(q, k, v, do, ref_lse, delta, *args)
                ref_dk, ref_dv = fa.flash_dkv_plain(q, k, v, do, ref_lse, delta, *args)
                errs["flash_train_dkv"] = max(
                    check_close(f"flash_train_dkv dk {tag}", dk, ref_dk, dtype)[0],
                    check_close(f"flash_train_dkv dv {tag}", dvv, ref_dv, dtype)[0])
                if rate > 0:
                    mask = fa.dropout_keep_mask_kernel(seed, BH, Nq, Nk, rate, nq_pad, nk_pad, dev)
                    plain_mask = fa.dropout_keep_mask(
                        seed, torch.arange(BH, device=dev)[:, None, None],
                        torch.arange(Nq, device=dev)[None, :, None],
                        torch.arange(Nk, device=dev)[None, None, :], rate, nq_pad, nk_pad)
                    if not torch.equal(mask, plain_mask):
                        raise AssertionError(f"dropout mask {tag}: device hash differs from plain")
                    wrong, _ = fa.flash_train_fwd_plain(q, k, v, seed + 1, *args[1:])
                    try:
                        check_close(f"negative control {tag}", out, wrong, dtype)
                    except AssertionError:
                        pass
                    else:
                        raise AssertionError(f"negative control {tag}: seed+1 passed the check")
                timed = dtype == "float32" and rate > 0  # the main path's setting
                for name in TRAIN_KERNELS:
                    ops, nbytes = costs[name]
                    b_ms, b_by, b_is = tc_bound(ops, nbytes, dtype)
                    rec = dict(attention=label, shape=[BH, Nq, Nk, d, dv], dtype=dtype, rate=rate,
                               per_step=per_step, max_abs_err=errs[name], ops=ops, bytes=nbytes,
                               bound_ms=b_ms, bound_by=b_by, bound_is=b_is)
                    if timed:  # timed after every check, below
                        kernel, plain = {
                            "flash_train_fwd": (partial(fa.flash_train_fwd, q, k, v, *args),
                                                partial(fa.flash_train_fwd_plain, q, k, v, *args)),
                            "flash_train_dq": (
                                partial(fa.flash_dq, q, k, v, do, ref_lse, delta, *args),
                                partial(fa.flash_dq_plain, q, k, v, do, ref_lse, delta, *args)),
                            "flash_train_dkv": (
                                partial(fa.flash_dkv, q, k, v, do, ref_lse, delta, *args),
                                partial(fa.flash_dkv_plain, q, k, v, do, ref_lse, delta, *args)),
                        }[name]
                        rec["launch"] = launch_plan(torch, fa, name, BH, Nq, Nk, d, dv, q.dtype)
                        timings.append((rec, kernel, plain))
                    records[name].append(rec)
        log("kernel-saturated-logits", attention=label,
            **saturated_logits_check(torch, fa, gen, BH, Nq, Nk, d, dv, seed))
    for label, B, Nq, Nk, d, dv in TP_ATTENTIONS:
        log("kernel-head-share", attention=label,
            **head_share_check(torch, fa, gen, B, Nq, Nk, d, dv, seed))
        paths[label] = autograd_paths(torch, fa, q32, k32, v32, do32, scale,
                                      (seed, scale, 0.1, nq_pad, nk_pad))

    # Times at f32 and rate 0.1, the main path's setting, after every check.
    # Host and paced first: once torch.profiler has run in a process each
    # launch costs the host more (CUPTI stays attached), so the device times,
    # which need the profiler, come last. Paced: back-to-back calls by CUDA
    # events (the host's pace where it is slower than the card); host: the
    # enqueue alone; device: the kernels' own CUDA time.
    for rec, kernel, plain in timings:
        rec.update(ms=time_ms(torch, kernel), plain_ms=time_ms(torch, plain))
    times = {label: {key: {"ms": time_ms(torch, fn)} for key, fn in fns.items()}
             for label, fns in paths.items()}
    # the host's speed drifts between measurements (a shared host), so the
    # host µs are rounds of every closure in turn, kernels and SDPA alike:
    # the median and the least of HOST_ROUNDS
    host = {id(rec): [] for rec, _, _ in timings}
    host.update({(label, key): [] for label, fns in paths.items() for key in fns})
    for _ in range(HOST_ROUNDS):
        for rec, kernel, _ in timings:
            host[id(rec)].append(host_us(torch, kernel))
        for label, fns in paths.items():
            for key, fn in fns.items():
                host[(label, key)].append(host_us(torch, fn))
    for rec, _, _ in timings:
        rec["host_us"], rec["host_us_least"] = median_and_least(host[id(rec)])
    for label, fns in paths.items():
        for key in fns:
            times[label][key]["host_us"], times[label][key]["host_us_least"] = \
                median_and_least(host[(label, key)])
    for rec, kernel, _ in timings:
        rec["device_ms"] = device_us(torch, kernel) / 1e3
    for label, fns in paths.items():
        for key, fn in fns.items():
            times[label][key]["device_ms"] = device_us(torch, fn) / 1e3
        log("kernel-train-autograd", attention=label, **times[label])
        # the library yardstick: SDPA's forward for K4, its backward (one
        # autograd.grad) for K5 and K6 together
        for name, key in (("flash_train_fwd", "sdpa_forward"), ("flash_train_dq", "sdpa_backward"),
                          ("flash_train_dkv", "sdpa_backward")):
            for rec in records[name]:
                if rec["attention"] == label:
                    rec.update({f"library_{k}": x for k, x in times[label][key].items()})
                    if "ms" in rec:
                        rec["autograd"] = {k: times[label][k] for k in ("apply", "backward")}
    for name in TRAIN_KERNELS:
        for rec in records[name]:
            log("kernel", kernel=name, **rec)

    def step_ms(name, key):  # a train step's calls, f32 at rate 0.1
        return sum(r[key] * r["per_step"] for r in records[name] if "device_ms" in r)

    backward = step_ms("flash_train_dq", "device_ms") + step_ms("flash_train_dkv", "device_ms")
    sdpa = step_ms("flash_train_dq", "library_device_ms")
    log("1b-backward-vs-sdpa", k5_device_ms=step_ms("flash_train_dq", "device_ms"),
        k6_device_ms=step_ms("flash_train_dkv", "device_ms"), k5_plus_k6_device_ms=backward,
        sdpa_backward_device_ms=sdpa, ratio=backward / sdpa,
        per="one f32 train step's calls at dropout 0.1, device time under torch.profiler")
    torch.cuda.synchronize()
    return records


def autograd_paths(torch, fa, q32, k32, v32, do32, scale, train_args):
    """Closures over one attention's f32 inputs, grad on: the kernels
    through FlashAttentionTrain at the model's layout ((B, N, H, d) storage
    as transposed views, 8 heads) forward and backward (one autograd.grad:
    δ, K5 and K6), and SDPA's at rate 0, forward and backward."""
    import torch.nn.functional as F

    heads = 8
    qh, kh, vh, doh = (t.reshape(t.shape[0] // heads, heads, *t.shape[1:]).transpose(1, 2)
                       .contiguous().transpose(1, 2) for t in (q32, k32, v32, do32))
    qg, kg, vg = (t.detach().clone().requires_grad_(True) for t in (qh, kh, vh))
    qs, ks, vs = (t[None].clone().requires_grad_(True) for t in (q32, k32, v32))
    out_g = fa.FlashAttentionTrain.apply(qg, kg, vg, *train_args)
    out_s = F.scaled_dot_product_attention(qs, ks, vs, scale=scale)
    return {
        "apply": lambda: fa.FlashAttentionTrain.apply(qg, kg, vg, *train_args),
        "backward": lambda: torch.autograd.grad(out_g, (qg, kg, vg), doh, retain_graph=True),
        "sdpa_forward": lambda: F.scaled_dot_product_attention(qs, ks, vs, scale=scale),
        "sdpa_backward": lambda: torch.autograd.grad(out_s, (qs, ks, vs), do32[None],
                                                     retain_graph=True),
    }


def head_dims_phase(torch, dev):
    """Phase 1e on device `dev`: K1 and K4-K6 at the head dims of heads of
    16 and 64 against their plain versions, then the narrow 4-heads-of-16 flagship
    through `make_inference_fn`. Returns what it measured."""
    from future_od_tpu_torch.models.build import build_flagship
    from future_od_tpu_torch.models.st_detr import SpatioTemporalDETRArgs
    from future_od_tpu_torch.ops import _kernels
    from future_od_tpu_torch.ops import flash_attention as fa
    from future_od_tpu_torch.train.step import make_inference_fn

    gen = torch.Generator(device=dev).manual_seed(5)
    errs = {}
    for label, B, H, Nq, Nk, d, dv in HEAD16_ATTENTIONS:
        q32, k32, do32 = (torch.randn(*s, generator=gen, device=dev)
                          for s in ((B, H, Nq, d), (B, H, Nk, d), (B, H, Nq, dv)))
        v32 = torch.randn(B, H, Nk, dv, generator=gen, device=dev)
        nq_pad, nk_pad = fa.train_shapes(Nq, Nk, 256, 512)
        args = (777, 1.0 / math.sqrt(d), 0.1, nq_pad, nk_pad)
        for dtype in ("float32", "bfloat16"):
            q, k, v, do = (t.to(getattr(torch, dtype)) for t in (q32, k32, v32, do32))
            tag = f"{label} {dtype}"
            e = {"flash_attention": check_close(
                f"flash_attention {tag}", fa.flash_attention(q, k, v, args[1]),
                fa.reference_attention(q, k, v, args[1]), dtype)[0]}
            q, k, v, do = (t.reshape(B * H, *t.shape[2:]) for t in (q, k, v, do))
            ref_out, ref_lse = fa.flash_train_fwd_plain(q, k, v, *args)
            out, lse = fa.flash_train_fwd(q, k, v, *args)
            e["flash_train_fwd"] = max(
                check_close(f"flash_train_fwd out {tag}", out, ref_out, dtype)[0],
                check_close(f"flash_train_fwd lse {tag}", lse, ref_lse, "float32")[0])
            delta = (do.float() * ref_out.float()).sum(-1)
            e["flash_train_dq"] = check_close(
                f"flash_train_dq {tag}", fa.flash_dq(q, k, v, do, ref_lse, delta, *args),
                fa.flash_dq_plain(q, k, v, do, ref_lse, delta, *args), dtype)[0]
            dk, dvv = fa.flash_dkv(q, k, v, do, ref_lse, delta, *args)
            ref_dk, ref_dv = fa.flash_dkv_plain(q, k, v, do, ref_lse, delta, *args)
            e["flash_train_dkv"] = max(check_close(f"flash_train_dkv dk {tag}", dk, ref_dk, dtype)[0],
                                       check_close(f"flash_train_dkv dv {tag}", dvv, ref_dv, dtype)[0])
            errs[tag] = e

    # the narrow flagship: hidden 64 over 4 heads, 1024 tokens a frame
    args = SpatioTemporalDETRArgs(num_classes=4, hidden_dim=64, enc_nheads=4, nheads=4,
                                  enc_layers=2, dec_layers=2, dim_feedforward=128,
                                  num_queries=16, dropout=0.0)
    model = build_flagship(args, generator=torch.Generator().manual_seed(0))
    randomize_heads_(torch, model._model.detector, torch.Generator().manual_seed(1))
    infer = make_inference_fn(model)
    rng = np.random.default_rng(5)
    batch = {"video": rng.standard_normal((1, FRAMES, NARROW_FRAME, NARROW_FRAME, 3),
                                          dtype=np.float32)}
    for key, width in {"translation": 3, "acceleration": 3, "rotation": 4, "rotation_rate": 3,
                       "speed": 1}.items():
        batch[key] = rng.standard_normal((1, FRAMES, width), dtype=np.float32)
    set_gates()
    _kernels.reset_launch_counts()
    out = infer(batch)
    torch.cuda.synchronize()
    counts = launched(_kernels)
    want = {"flash_attention": args.enc_layers}  # one launch a layer over both past frames
    if counts != want:
        raise AssertionError(f"4 heads of 16 at 1024 tokens: launches {counts}, want {want}")
    set_gates(FUTURE_OD_DISABLE_FLASH="1")
    plain = infer(batch)
    set_gates()
    gaps = {"score_err": (out["class_scores"] - plain["class_scores"]).abs().max().item(),
            "box_err_px": (out["boxes"] - plain["boxes"]).abs().max().item()}
    if not all(gaps[k] <= NARROW_TOLS[k] for k in NARROW_TOLS):
        raise AssertionError(f"4 heads of 16: kernels vs plain {gaps}, tolerances {NARROW_TOLS}")
    del model, infer
    torch.cuda.empty_cache()
    return {"max_abs_err": errs, "narrow_flagship": {"launches": counts, **gaps,
                                                     "tolerances": NARROW_TOLS}}


def head_share_check(torch, fa, gen, B, Nq, Nk, d, dv, seed, rate=0.1):
    """K4-K6 over heads h0..h0+4 of 8 (`heads=(4, 8, h0)`, a tensor-parallel
    rank's call) against the all-heads call on (B, 8, N, w) operands, f32
    and bf16, rate 0.1 and 0: each kernel's outputs bit for bit where both
    calls take the same split, within phase 1b's tolerance where they do
    not; and the defaults (no `heads`) bit-equal to heads=(8, 8, 0).
    Returns the splits and, per output, whether it was bit-equal."""
    H, share = 8, 4
    nq_pad, nk_pad = fa.train_shapes(Nq, Nk, 256, 512)
    q32, k32, v32, do32 = (torch.randn(B, H, n, w, generator=gen, device=gen.device)
                           for n, w in ((Nq, d), (Nk, d), (Nk, dv), (Nq, dv)))
    splits = {name: [fa.flash_train_info(name, d, dv, torch.float32, bh, Nq, Nk)["split"]
                     for bh in (B * H, B * share)] for name in TRAIN_KERNELS}
    outputs = (("out", "flash_train_fwd"), ("lse", "flash_train_fwd"), ("dq", "flash_train_dq"),
               ("dk", "flash_train_dkv"), ("dv", "flash_train_dkv"))
    bit_equal = {}
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, do = (t.to(dtype) for t in (q32, k32, v32, do32))
        for r in (rate, 0.0):
            args = (seed, 1.0 / math.sqrt(d), r, nq_pad, nk_pad)

            def calls(heads, part):
                qs, ks, vs, dos = (t[:, part] for t in (q, k, v, do))
                out, lse = fa.flash_train_fwd(qs, ks, vs, *args, heads=heads)
                delta = (dos.float() * out.float()).sum(-1)
                dq = fa.flash_dq(qs, ks, vs, dos, lse, delta, *args, heads=heads)
                dk, dvv = fa.flash_dkv(qs, ks, vs, dos, lse, delta, *args, heads=heads)
                return out, lse, dq, dk, dvv

            full = calls(None, slice(None))
            if not all(torch.equal(a, b) for a, b in zip(full, calls((H, H, 0), slice(None)))):
                raise AssertionError(f"head share: the defaults differ from heads=(8, 8, 0), "
                                     f"{dtype} rate {r}")
            for h0 in (0, share):
                got = calls((share, H, h0), slice(h0, h0 + share))
                for (name, kernel), a, b in zip(outputs, got, full):
                    b = b[:, h0:h0 + share]
                    tag = f"head share {name} h0 {h0} {str(dtype).split('.')[1]} rate {r}"
                    equal = torch.equal(a, b)
                    if splits[kernel][0] == splits[kernel][1] and not equal:
                        raise AssertionError(f"{tag}: differs from the all-heads call's slice "
                                             f"at one split {splits[kernel]}")
                    if not equal:
                        check_close(tag, a, b, "float32" if a.dtype == torch.float32
                                    else "bfloat16")
                    bit_equal[name] = bit_equal.get(name, True) and equal
    return {"shape": [B, H, Nq, Nk, d, dv], "splits_full_vs_share": splits,
            "bit_equal": bit_equal}


def saturated_logits_check(torch, fa, gen, BH, Nq, Nk, d, dv, seed, rate=0.1):
    """K4-K6 in f32 at logits of about 1e6, where every row's softmax is
    one-hot. K5 and K6 get K4's lse, as on the main path, and must recompute
    p <= 1: dv within 2e-5 of its scale of the f64 reference, and dq, dk
    below 1e-6 of the most a gradient with p <= 1 could be (a recompute
    rounded otherwise put p far above 1 here, and a train step's gradient
    went non-finite). Returns the measured ratios."""
    dev = gen.device
    q, k = (torch.randn(BH, n, d, generator=gen, device=dev) * 1e3 for n in (Nq, Nk))
    v = torch.randn(BH, Nk, dv, generator=gen, device=dev)
    do = torch.randn(BH, Nq, dv, generator=gen, device=dev)
    nq_pad, nk_pad = fa.train_shapes(Nq, Nk, 256, 512)
    args = (seed, 1.0 / math.sqrt(d), rate, nq_pad, nk_pad)
    logits = args[1] * q.double() @ k.double().transpose(1, 2)
    top2 = logits.topk(2, dim=-1).values
    # only rows whose top two logits lie 30 apart: their softmax is one-hot
    # in f32 as in f64 (an f32 lse of 1e6 cannot hold log(1 + e^-gap) < 2^-5)
    do = do * (top2[..., 0] - top2[..., 1] > 30.0)[..., None]
    out, lse = fa.flash_train_fwd(q, k, v, *args)
    delta = (do * out).sum(-1)
    dq = fa.flash_dq(q, k, v, do, lse, delta, *args)
    dk, dvv = fa.flash_dkv(q, k, v, do, lse, delta, *args)
    if not all(bool(torch.isfinite(t).all()) for t in (out, lse, dq, dk, dvv)):
        raise AssertionError(f"saturated logits {BH, Nq, Nk, d, dv}: non-finite output")
    p = torch.softmax(logits, -1) * fa._mask(seed, BH, Nq, Nk, rate, nq_pad, nk_pad, dev).double()
    ref_dv = p.transpose(1, 2) @ do.double()
    dlogit_max = 2 * fa.dropout_keep_scale(rate) * dv * do.abs().max() * v.abs().max()
    ratios = {
        "logit_absmax": logits.abs().max().item(),
        "dv_err": ((dvv.double() - ref_dv).abs().max() / ref_dv.abs().max()).item(),
        "dq_over_bound": (dq.abs().max() / (Nk * args[1] * k.abs().max() * dlogit_max)).item(),
        "dk_over_bound": (dk.abs().max() / (Nq * args[1] * q.abs().max() * dlogit_max)).item(),
    }
    if ratios["dv_err"] > 2e-5 or max(ratios["dq_over_bound"], ratios["dk_over_bound"]) > 1e-6:
        raise AssertionError(f"saturated logits {BH, Nq, Nk, d, dv}: p above 1? {ratios}")
    return ratios


def tools_phase(torch, dev):
    """Phase 1c on device `dev`. Returns (per-kernel records, launch counts
    of the tools' run)."""
    import torch.nn.functional as F

    from future_od_tpu_torch.ops import _kernels
    from future_od_tpu_torch.ops import attention_floor as af
    from future_od_tpu_torch.ops import flash_attention as fa
    from future_od_tpu_torch.ops import fused_resnet as fr
    from future_od_tpu_torch.tools import bench_fused_bottleneck as t2
    from future_od_tpu_torch.tools import bench_softmax_floor as t1
    from future_od_tpu_torch.utils.jax_weights import blocks_from_numpy

    # the main path: both tools whole, counted
    _kernels.reset_launch_counts()
    ladder = t1.run()
    rows = t2.run()
    torch.cuda.synchronize()
    counts = {name: _kernels.launch_counts[name] for name in TOOL_KERNELS}
    if not all(counts.values()):
        raise AssertionError(f"the tools' run launched {counts}")
    log("1c-tools", launches=counts, softmax_floor=ladder, fused_bottleneck=rows)

    records = {name: [] for name in TOOL_KERNELS}
    gen = torch.Generator(device=dev).manual_seed(3)
    rng = np.random.default_rng(3)
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}

    def record(name, label, dtype, out, ref, tol_dtype=None, **extra):
        atol = BOTTLENECK_BF16_ATOL.get(name) if dtype == "bfloat16" else None
        err, tol = check_close(f"{name} {label}", out, ref, tol_dtype or dtype, atol)
        records[name].append(dict(check=label, dtype=dtype, max_abs_err=err, tol=tol, **extra))

    # T1 per image: all modes, on inputs whose logits are exact in f32. The
    # function rounds to bf16 inside in every storage type (bf16sm's block row
    # sum: an f32 sum in another order can round to the next bf16 value), so
    # f32 outputs are held to the bf16 tolerance too.
    B, H, T, d = t1.SHAPE
    scale = 1.0 / math.sqrt(d)
    qkv = af.exact_logit_inputs(1, H, T, T, scale, gen)
    for dtype, dt in dtypes.items():
        q, k, v = (a.to(dt) for a in qkv)
        for mode in af.MODES:
            record("attention_floor", f"{mode} {(1, H, T, d)}", dtype,
                   af.attention_floor(q, k, v, scale, mode, t1.BLOCK_K),
                   af.attention_floor_plain(q, k, v, scale, mode, t1.BLOCK_K),
                   tol_dtype="bfloat16")

    # T2 per image, the tool's sections
    def weights(cin, cmid, cout, ds):
        r = lambda *s: rng.normal(size=s).astype(np.float32) * 0.1  # noqa: E731
        w = dict(w1=r(cin, cmid), b1=r(cmid), w2=r(3, 3, cmid, cmid), b2=r(cmid),
                 w3=r(cmid, cout), b3=r(cout))
        if ds:
            w.update(wd=r(cin, cout), bd=r(cout))
        return w

    sections = [("layer1 inner", t2.HEIGHT, t2.WIDTH, 256, 64, False, t2.TILES),
                ("layer1 block0", t2.HEIGHT, t2.WIDTH, 64, 64, True, (8,))]
    sections += [(name, h, w, cin, cmid, False, (8,)) for name, (h, w, cin, cmid)
                 in t2.STAGES.items()]
    for label, h, w, cin, cmid, ds, tiles in sections:
        x32 = torch.randn(1, h, w, cin, generator=gen, device=dev) * 0.1
        w32 = weights(cin, cmid, 256 if ds else cin, ds)
        for dtype, dt in dtypes.items():
            x = x32.to(dt)
            wt = {k: torch.from_numpy(v).to(dev, dt) for k, v in w32.items()}
            ref = fr.bottleneck_plain(x, **wt)
            for tile in tiles:
                for im2col in ((False, True) if len(tiles) > 1 else (True,)):
                    record("bottleneck_v2", f"{label} tile {tile} im2col {int(im2col)}", dtype,
                           fr.fused_bottleneck_v2(x, **wt, tile_h=tile, im2col=im2col), ref,
                           plan=fr.bottleneck_plan(False, tile, cmid, im2col, dt))
    blocks_np = t2.make_layer1_blocks(rng)
    x32 = torch.randn(1, t2.HEIGHT, t2.WIDTH, 64, generator=gen, device=dev) * 0.1
    for dtype, dt in dtypes.items():
        blocks, x = blocks_from_numpy(blocks_np, dt, dev), x32.to(dt)
        ref = fr.layer1_plain(x, blocks)
        for tile in t2.V3_TILES:
            record("fused_layer1", f"tile {tile}", dtype, fr.fused_layer1(x, blocks, tile_h=tile),
                   ref, plan=fr.bottleneck_plan(True, tile, 64, True, dt))

    # times at the tools' full bf16 shapes: one configuration a kernel
    bf16 = torch.bfloat16
    q, k, v = (torch.randn(t1.SHAPE, generator=gen, device=dev).to(bf16) for _ in range(3))
    floor = {mode: time_ms(torch, lambda m=mode: af.attention_floor(q, k, v, scale, m, t1.BLOCK_K))
             for mode in af.MODES}
    floor["full"] = time_ms(torch, lambda: fa.flash_attention(q, k, v, scale))  # K1, the top rung
    x1 = (torch.randn(t2.BATCH, t2.HEIGHT, t2.WIDTH, 256, generator=gen, device=dev) * 0.1).to(bf16)
    w1 = {k_: torch.from_numpy(v_).to(dev, bf16) for k_, v_ in weights(256, 64, 256, False).items()}
    x0 = (torch.randn(t2.BATCH, t2.HEIGHT, t2.WIDTH, 64, generator=gen, device=dev) * 0.1).to(bf16)
    blocks = blocks_from_numpy(blocks_np, bf16, dev)
    # T2's yardsticks (K2's): cuDNN's convolutions of the same blocks
    yard1 = yardstick_weights(torch, w1, bf16)
    yard_blocks = [yardstick_weights(torch, bk, bf16) for bk in blocks]

    def layer1_yardstick(x):
        for bk in yard_blocks:
            x = block_yardstick(torch, x, **bk)
        return x

    timed = {
        "attention_floor": dict(
            per=f"one bf16sm call at {t1.SHAPE}, block_k {t1.BLOCK_K}; library: SDPA forward "
                "(the full softmax, a yardstick: no library call computes the stripped rungs); "
                "the top rung, full, is K1 on the tensor cores, the stripped rungs compute on "
                "the CUDA cores",
            ms=floor["bf16sm"], mode_ms=floor,
            plain_ms=time_ms(torch, lambda: af.attention_floor_plain(q, k, v, scale, "bf16sm",
                                                                     t1.BLOCK_K)),
            library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(q, k, v, scale=scale)),
            cost=af.floor_cost(B, H, T, T, t1.BLOCK_K, 2)),
        "bottleneck_v2": dict(
            per=f"one call at layer1's inner block {tuple(x1.shape)} -> 256, tile 8, im2col",
            ms=time_ms(torch, lambda: fr.fused_bottleneck_v2(x1, **w1, tile_h=8, im2col=True)),
            plain_ms=time_ms(torch, lambda: fr.bottleneck_plain(x1, **w1)),
            library_ms=time_ms(torch, lambda: block_yardstick(torch, x1, **yard1)),
            library_is=f"a yardstick: {K2_YARDSTICK}",
            cost=fr.bottleneck_cost(t2.BATCH, t2.HEIGHT, t2.WIDTH, 256, 64, 256, False, 2)),
        "fused_layer1": dict(
            per=f"one call over layer1's 3 blocks {tuple(x0.shape)} -> 256, tile 8",
            ms=time_ms(torch, lambda: fr.fused_layer1(x0, blocks, tile_h=8)),
            plain_ms=time_ms(torch, lambda: fr.layer1_plain(x0, blocks)),
            library_ms=time_ms(torch, lambda: layer1_yardstick(x0)),
            library_is=f"a yardstick: {K2_YARDSTICK}, for each of the 3 blocks in turn",
            cost=fr.layer1_cost(t2.BATCH, t2.HEIGHT, t2.WIDTH, 64, 2)),
    }
    torch.cuda.synchronize()
    for name, row in timed.items():
        ops, nbytes = row.pop("cost")
        row["bound_ms"], row["bound_by"] = bound(ops, nbytes, "bfloat16")
        row.update(ops=ops, bytes=nbytes)
        log("kernel", kernel=name, **row)
        records[name] = dict(row, calls=records[name])
    return records, counts


def tensor_bytes(*items) -> int:
    return sum(t.numel() * t.element_size() for t in items if hasattr(t, "numel"))


def stem_phase(torch, dev):
    """Phase 1d on device `dev`. Returns (per-kernel records, launch counts
    of the tool's run)."""
    import torch.nn.functional as F

    from future_od_tpu_torch.ops import _kernels
    from future_od_tpu_torch.ops import stem_variants as sv
    from future_od_tpu_torch.tools import bench_stem as t3

    # the main path: the tool whole, counted
    _kernels.reset_launch_counts()
    rows = t3.run()
    torch.cuda.synchronize()
    counts = {name: _kernels.launch_counts[name] for name in STEM_KERNELS}
    if not all(counts.values()):
        raise AssertionError(f"the stem tool's run launched {counts}")
    log("1d-stem-tool", launches=counts, rows=rows)

    # per image: each kernel against its plain version, f32 and bf16
    records = {name: [] for name in STEM_KERNELS}
    gen = torch.Generator(device=dev).manual_seed(4)
    bias = torch.randn(64, generator=gen, device=dev) * 0.1
    x1, w7 = t3.make_inputs((1, t3.HEIGHT, t3.WIDTH, 3), 4, dev, torch.float32)
    for dtype in ("float32", "bfloat16"):
        for name, (kernel, plain, args) in t3.kernel_cases(x1.to(getattr(torch, dtype)), w7,
                                                           bias).items():
            err, tol = check_close(f"{name} one image", kernel(*args), plain(*args), dtype)
            records[name].append(dict(check=f"one image {tuple(x1.shape)}", dtype=dtype,
                                      max_abs_err=err, tol=tol))
    del x1

    # times at the tool's full bf16 shape, the operand construction excluded
    x, w7 = t3.make_inputs((t3.BATCH, t3.HEIGHT, t3.WIDTH, 3), 0, dev, torch.bfloat16)
    ops = t3.operands(x, w7)
    x128, w3p = ops["x128"].permute(0, 3, 1, 2), ops["w3p"].permute(3, 2, 0, 1)
    yardsticks = {
        "stem": ("cuDNN 7x7/2 conv + relu + max_pool2d (the xla7x7 row, three calls)",
                 time_ms(torch, lambda: t3.xla7x7(x, w7))),
        "stem_d": ("cuDNN 3x3 conv over D's 128-channel operands, relu excluded",
                   time_ms(torch, lambda: F.conv2d(x128, w3p, padding=1))),
    }
    del ops, x128, w3p
    hp, wp = t3.HEIGHT // 4, t3.WIDTH // 4
    cases = t3.kernel_cases(x, w7, torch.zeros_like(bias))
    for name in list(cases):
        kernel, plain, args = cases.pop(name)
        out = kernel(*args)
        nbytes = tensor_bytes(*args, out)
        del out
        b_ms, b_by = bound(sv.stem_ops(t3.BATCH, hp, wp), nbytes, "bfloat16")
        lib = yardsticks.get(name, yardsticks["stem"])
        row = dict(
            per=f"one call at the tool's shape, {t3.BATCH} images of {t3.HEIGHT}x{t3.WIDTH} "
                f"bf16, the operands built beforehand",
            ms=time_ms(torch, lambda: kernel(*args)), plain_ms=time_ms(torch, lambda: plain(*args)),
            library_ms=lib[1], library_is=f"a yardstick: {lib[0]}",
            bound_ms=b_ms, bound_by=b_by, ops=sv.stem_ops(t3.BATCH, hp, wp), bytes=nbytes)
        log("kernel", kernel=name, **row)
        records[name] = dict(row, calls=records[name])
        del args
    torch.cuda.synchronize()
    return records, counts


def make_batch(seed: int):
    rng = np.random.default_rng(seed)
    batch = {
        "video": rng.standard_normal((BATCH, FRAMES, HEIGHT, WIDTH, 3), dtype=np.float32)
    }
    for key, width in IMU_WIDTHS.items():
        batch[key] = rng.standard_normal((BATCH, FRAMES, width), dtype=np.float32)
    return batch


def make_train_batch(seed: int, batch: int = TRAIN_BATCH,
                     size: tuple = (TRAIN_HEIGHT, TRAIN_WIDTH)):
    """bench_train.py's fabricated stage-1 batch of `batch` clips (at `size`):
    centers scattered over the image, log-normal sizes, 10% of the 256
    slots active, 8 classes."""
    B, L, (H, W), N = batch, FRAMES, size, TRAIN_SLOTS
    rng = np.random.default_rng(seed)
    cxy = rng.uniform(0.05, 0.95, size=(B, N, 2)).astype(np.float32) * [W, H]
    wh = np.exp(rng.normal(4.0, 0.6, size=(B, N, 2))).astype(np.float32)
    wh = np.clip(wh, 8, [W * 0.5, H * 0.5])
    data = {
        "video": rng.normal(size=(B, L, H, W, 3)).astype(np.float32),
        "boxes": np.concatenate([cxy - wh / 2, cxy + wh / 2], -1).astype(np.float32),
        "classes": rng.integers(0, 8, size=(B, N)),
        "active": (rng.uniform(size=(B, N)) < 0.1).astype(np.int64),
        "annotated_frame_idx": np.full((B,), L - 1),
    }
    for key, width in [("translation", 3), ("acceleration", 3), ("rotation", 4),
                       ("rotation_rate", 3), ("speed", 1)]:
        data[key] = rng.normal(size=(B, L, width)).astype(np.float32)
    return data


def launched(kernels) -> dict:
    """The launch counters that are not 0."""
    return {name: n for name, n in kernels.launch_counts.items() if n}


def set_dropout(torch, model, rate: float) -> None:
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = rate


def injected_indices(torch, model, cfg, batch):
    """The matcher's (levels, B, N) indices on a forward with every kernel
    gate off, to inject into both sides of phase 5a."""
    from future_od_tpu_torch.models.set_criterion import matching_costs_all
    from future_od_tpu_torch.models.st_detr import normalize_outputs
    from future_od_tpu_torch.ops.matching import SOLVERS
    from future_od_tpu_torch.ops.misc import video_hw
    from future_od_tpu_torch.ops.target_utils import to_detr_targets

    with torch.no_grad():
        annotated, _, _ = normalize_outputs(model(batch))
        H, W = video_hw(batch["video"])
        targets = to_detr_targets(H, W, batch["active"], batch["boxes"], batch["classes"])
        costs, active = matching_costs_all(annotated, targets, cfg)
        idx = SOLVERS[cfg.matcher](costs, active)
    return idx.reshape(-1, TRAIN_BATCH, idx.shape[-1])


def gradient_gaps(grads, ref):
    """Per parameter, max |grads - ref| over max(max |ref|, GRAD_FLOOR x the
    largest max |ref| of the model)."""
    floor = GRAD_FLOOR * max(g.abs().max().item() for g in ref.values())
    return {name: (grads[name].double() - g.double()).abs().max().item()
            / max(g.abs().max().item(), floor) for name, g in ref.items()}


def worst_per_group(gaps):
    """{part of the model: (largest gap, its parameter)}."""
    worst = {}
    for name, gap in gaps.items():
        group = name.split(".")[1]
        worst[group] = max(worst.get(group, (0.0, "")), (gap, name))
    return worst


def grad_gap_by_group(grads, ref):
    """Each group's largest |difference| over its largest |gradient| (phase
    6b's form)."""
    by_group = {}
    for name, g in ref.items():
        group = name.split(".")[1]
        diff, top = (grads[name] - g).abs().max().item(), g.abs().max().item()
        d0, t0 = by_group.get(group, (0.0, 0.0))
        by_group[group] = (max(d0, diff), max(t0, top))
    return {k: d / t for k, (d, t) in by_group.items()}


def loss_and_grads(torch, model, cfg, batch, pred_idx_all):
    from future_od_tpu_torch.train.step import forward_and_loss

    model.zero_grad(set_to_none=True)
    loss, _ = forward_and_loss(model, cfg, batch, pred_idx_all)
    loss.backward()
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()
             if p.grad is not None}
    model.zero_grad(set_to_none=True)
    return loss.detach(), grads


def step_stages(torch, model, cfg, optimizer, data):
    """Host ms of each stage of one train step, `make_train_step`'s body
    replayed with a synchronize after each stage: the batch copy, forward,
    matching (costs and the solver), criterion, backward, clip + AdamW, and
    post-processing + mAP intermediaries. The syncs add a little."""
    from future_od_tpu_torch.models.set_criterion import matching_costs_all
    from future_od_tpu_torch.models.st_detr import compute_loss, normalize_outputs
    from future_od_tpu_torch.ops.matching import SOLVERS
    from future_od_tpu_torch.ops.misc import video_hw
    from future_od_tpu_torch.ops.target_utils import to_detr_targets
    from future_od_tpu_torch.train.optimizer import clip_by_global_norm_, global_norm
    from future_od_tpu_torch.train.step import postproc_and_map, to_device_batch

    marks = []

    def mark(name):
        torch.cuda.synchronize()
        marks.append((name, time.perf_counter()))

    mark("start")
    batch = to_device_batch(data, torch.device("cuda"))
    mark("copy")
    model.train()
    optimizer.zero_grad(set_to_none=True)
    annotated, pred_logits, pred_boxes = normalize_outputs(model(batch))
    mark("forward")
    H, W = video_hw(batch["video"])
    targets = to_detr_targets(H, W, batch["active"], batch["boxes"], batch["classes"])
    costs, active = matching_costs_all(annotated, targets, cfg)
    idx, rounds = SOLVERS[cfg.matcher](costs, active, return_rounds=True)
    mark("matching")
    loss, _ = compute_loss(annotated, batch, cfg, idx.reshape(-1, TRAIN_BATCH, idx.shape[-1]))
    mark("criterion")
    loss.backward()
    mark("backward")
    grads = [p.grad for p in optimizer.parameters() if p.grad is not None]
    norm = global_norm(grads)
    if bool(torch.isfinite(norm)):
        clip_by_global_norm_(grads, norm, optimizer.max_norm)
        optimizer.step()
    mark("optimizer")
    postproc_and_map(pred_logits.detach(), pred_boxes.detach(), batch)
    mark("postproc_map")
    ms = {name: 1e3 * (t - marks[i][1]) for i, (name, t) in enumerate(marks[1:])}
    return {**ms, "total": 1e3 * (marks[-1][1] - marks[0][1]),
            "matcher_rounds": int(rounds.max())}


def train_phase(torch):
    """Phase 5. Returns (records, main-path launch counts)."""
    from future_od_tpu_torch.models.build import build_flagship
    from future_od_tpu_torch.models.st_detr import SpatioTemporalDETRArgs
    from future_od_tpu_torch.ops import _kernels
    from future_od_tpu_torch.train.optimizer import build_optimizer
    from future_od_tpu_torch.train.step import make_train_step, to_device_batch

    args = SpatioTemporalDETRArgs(num_classes=8, num_queries=128, lr_backbone=1e-4,
                                  freeze_stem=True, matcher="auction", cost_slots=128)
    cfg = args.criterion_config()
    model = build_flagship(args, generator=torch.Generator().manual_seed(0))
    randomize_heads_(torch, model._model.detector, torch.Generator().manual_seed(1))
    taps = Taps(torch, model)
    data = make_train_batch(seed=0)
    batch = to_device_batch(data, torch.device("cuda"))

    # (a) dropout 0, one set of weights, injected indices: kernels vs plain
    model.train()
    set_dropout(torch, model, 0.0)
    set_gates()
    pred_idx_all = injected_indices(torch, model, cfg, batch)
    loss_off, grads_off = loss_and_grads(torch, model, cfg, batch, pred_idx_all)
    set_gates(FUTURE_OD_TRAIN_FLASH="1")
    _kernels.reset_launch_counts()
    loss_on, grads_on = loss_and_grads(torch, model, cfg, batch, pred_idx_all)
    torch.cuda.synchronize()
    step_counts = {name: _kernels.launch_counts[name] for name in TRAIN_KERNELS}
    want = sum(per_step for *_, per_step in TRAIN_ATTENTIONS)
    if step_counts != {name: want for name in TRAIN_KERNELS}:
        raise AssertionError(f"train flash launches per step {step_counts}, want {want} each")
    if set(grads_on) != set(grads_off):
        raise AssertionError("gate on and off give gradients for different parameters")
    loss_gap = abs(loss_on.item() - loss_off.item()) / abs(loss_off.item())
    grad_gaps = gradient_gaps(grads_on, grads_off)
    worst = worst_per_group(grad_gaps)
    # the f32 noise floor of these gradients: both f32 paths against the
    # plain path in f64 (gate off: the kernels take f32 and bf16 only)
    set_gates()
    model64 = copy.deepcopy(model).double()
    batch64 = {k: v.double() if torch.is_tensor(v) and v.is_floating_point() else v
               for k, v in batch.items()}
    _, grads64 = loss_and_grads(torch, model64, cfg, batch64, pred_idx_all)
    del model64
    vs_f64 = {path: worst_per_group(gradient_gaps(grads, grads64))
              for path, grads in (("kernels", grads_on), ("plain", grads_off))}
    frozen = [n for n, p in model.named_parameters() if not p.requires_grad]
    log("5a-train-kernels-vs-plain-autograd", loss_on=loss_on.item(), loss_off=loss_off.item(),
        loss_rel_gap=loss_gap, max_grad_rel_gap=worst, f32_vs_f64_max_grad_rel_gap=vs_f64,
        grads=len(grads_off), frozen_params=len(frozen), launches_per_step=step_counts,
        tolerances={"loss": LOSS_RTOL, "grad": GRAD_RTOL, "grad_floor": GRAD_FLOOR},
        median_grad_rel_gap=sorted(grad_gaps.values())[len(grad_gaps) // 2])
    if loss_gap > LOSS_RTOL or any(gap > GRAD_RTOL[g] for g, (gap, _) in worst.items()):
        raise AssertionError("train step through the kernels differs from plain autograd")
    if any(n in grads_off for n in frozen) or not frozen:
        raise AssertionError("the frozen stem+layer1 got gradients (or none is frozen)")
    del grads_on, grads_off, grads64

    # (b) real steps at dropout 0.1: gate on (the main path), then off
    set_dropout(torch, model, 0.1)
    optimizer = build_optimizer(model, args.lr, args.lr_backbone, args.weight_decay,
                                args.max_norm, args.freeze_stem)
    step = make_train_step(model, cfg, optimizer)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    runs = {}
    main_counts = None
    live = set()  # parameters that got a nonzero gradient in some step
    # on (the main path, counted), off, on again: warm-up lands on the first
    for gate in ("on", "off", "on again"):
        set_gates(**({} if gate == "off" else {"FUTURE_OD_TRAIN_FLASH": "1"}))
        torch.cuda.reset_peak_memory_stats()
        _kernels.reset_launch_counts()
        seconds, losses, rounds = [], [], []
        for _ in range(TRAIN_STEPS):
            t0 = time.perf_counter()
            loss, stats, od_map, output = step(data, 0)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
            losses.append(loss.item())
            rounds.append(stats["matcher_rounds"].item())
            if not math.isfinite(losses[-1]) or stats["nonfinite_skipped"].item() != 0:
                raise AssertionError(f"gate {gate}: non-finite train step, loss {losses[-1]}")
            if rounds[-1] >= 1000:
                raise AssertionError(f"gate {gate}: auction hit its round cap")
            live.update(n for n, p in model.named_parameters()
                        if p.grad is not None and bool(p.grad.any()))
        counts = launched(_kernels)
        if gate == "on":
            main_counts = counts
        runs[gate] = dict(
            step_ms=[1e3 * x for x in seconds], losses=losses, matcher_rounds=rounds,
            launches=counts,
            peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
            forward_stage_ms=taps.stage_ms(),
            profile=profile_request(torch, lambda b: step(b, 0), data, taps.stages),
            step_stage_ms=step_stages(torch, model, cfg, optimizer, data),
        )
        log(f"5b-train-steps-gate-{gate.replace(' ', '-')}", **runs[gate])
    if main_counts != {name: want * TRAIN_STEPS for name in TRAIN_KERNELS}:
        raise AssertionError(f"gate-on steps launched {main_counts}")
    if runs["off"]["launches"]:
        raise AssertionError(f"gate-off steps launched {runs['off']['launches']}")
    # a trainable tensor whose gradient is exactly zero at every step (the
    # egodeep attention's q projections: softmax over one key) may stay put
    for name, p in model.named_parameters():
        same = torch.equal(p.detach(), before[name])
        if name in frozen and not same:
            raise AssertionError(f"{name}: frozen parameter moved")
        if name in live and same:
            raise AssertionError(f"{name}: trainable parameter with a gradient did not move")
    check = {"trainable_with_gradient": len(live), "frozen": len(frozen),
             "parameters": len(before), "od_map_shapes": [list(t.shape) for t in od_map],
             "boxes_shape": list(output["boxes"].shape)}
    return runs, main_counts, check


def forward(torch, infer, batch, requests: int):
    """Serve `requests` requests; returns (last output, per-request seconds)."""
    out, seconds = None, []
    for _ in range(requests):
        t0 = time.perf_counter()
        out = infer(batch)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    return out, seconds


def check_output(torch, out, num_queries: int, num_classes: int):
    scores, boxes = out["class_scores"], out["boxes"]
    if tuple(scores.shape) != (BATCH, 1, 1, num_queries, num_classes + 1):
        raise AssertionError(f"class_scores shape {tuple(scores.shape)}")
    if tuple(boxes.shape) != (BATCH, 1, 1, num_queries, 4):
        raise AssertionError(f"boxes shape {tuple(boxes.shape)}")
    if not (torch.isfinite(scores).all() and torch.isfinite(boxes).all()):
        raise AssertionError("non-finite outputs")
    if not (scores.min() >= 0 and scores.max() <= 1):
        raise AssertionError("scores outside [0, 1]")


def randomize_heads_(torch, detector, generator) -> None:
    """Replace the detector's zero bbox-delta layer and focal-prior class
    bias with random values, so that boxes and scores depend on the image
    (with the init's heads, boxes are the sigmoid of the reference points
    alone)."""
    last = detector.bbox_embed.layers[-1]
    with torch.no_grad():
        for p, std in ((last.weight, 0.1), (last.bias, 0.1), (detector.class_embed.bias, 1.0)):
            p.copy_(torch.randn(p.shape, generator=generator) * std)


class Taps:
    """Forward hooks on the flagship's stages. Each forward records CUDA
    events at the entry and exit of the backbone, the encoder and the
    detector, and keeps the encoder's output features and the decoder's
    output (hs, every level)."""

    def __init__(self, torch, model):
        core = model._model
        stages = {
            "backbone": core.separate_encoder.backbone,
            "encoder": core.separate_encoder.transformer,
            "detector": core.detector,
        }
        self.stages, self.events, self.values = stages, {}, {}

        def enter(name):
            def hook(module, args):
                self.events[name] = [torch.cuda.Event(enable_timing=True)]
                self.events[name][0].record()
            return hook

        def leave(name):
            def hook(module, args, out):
                self.events[name].append(torch.cuda.Event(enable_timing=True))
                self.events[name][1].record()
            return hook

        def keep(name):
            def hook(module, args, out):
                self.values[name] = out[0]
            return hook

        for name, module in stages.items():
            module.register_forward_pre_hook(enter(name))
            module.register_forward_hook(leave(name))
        core.separate_encoder.register_forward_hook(keep("encoder_out"))
        core.detector.decoder.register_forward_hook(keep("decoder_out"))

    def stage_ms(self):
        """Device ms of each stage in the last forward (after a sync)."""
        return {k: e[0].elapsed_time(e[1]) for k, e in self.events.items()}


def profile_request(torch, infer, batch, stages):
    """One request under torch.profiler: the union of the card's kernel and
    copy time ranges, the share of the request's wall time it ran none, the
    kernels with the most device time, the port's own kernels, and for each
    stage (a module of `stages`, its forward marked by a profiler range) the
    host ms its forward took and the device ms of the kernels it launched."""
    from torch.autograd import DeviceType

    marks, handles = {}, []
    for name, module in stages.items():
        def enter(module, args, name=name):
            marks[name] = torch.profiler.record_function(f"stage:{name}")
            marks[name].__enter__()

        def leave(module, args, out, name=name):
            marks.pop(name).__exit__(None, None, None)

        handles += [module.register_forward_pre_hook(enter), module.register_forward_hook(leave)]
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    try:
        with torch.profiler.profile(activities=activities) as prof:
            t0 = time.perf_counter()
            infer(batch)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        for handle in handles:
            handle.remove()

    def on_device(events):  # without CUPTI's own buffer bookkeeping and the stage marks
        return [e for e in events if e.device_type == DeviceType.CUDA
                and not e.key.startswith(("Activity Buffer", "stage:"))]

    busy, end = 0.0, float("-inf")
    for s, e in sorted((e.time_range.start, e.time_range.end) for e in on_device(prof.events())):
        if e > end:
            busy += e - max(s, end)
            end = e
    by_time = sorted(on_device(prof.key_averages()), key=lambda e: e.self_device_time_total,
                     reverse=True)
    if busy <= 0:
        raise AssertionError("the profiler saw no device activity in a request")
    stage_split = {}
    for e in prof.events():
        if e.device_type == DeviceType.CPU and e.name.startswith("stage:"):
            split = stage_split.setdefault(e.name[len("stage:"):], {"host_ms": 0.0,
                                                                    "kernel_ms": 0.0})
            split["host_ms"] += e.cpu_time_total / 1e3
            split["kernel_ms"] += e.device_time_total / 1e3
    return {
        "profiled_request_ms": wall_ms, "busy_ms": busy / 1e3,
        "idle_share": 1.0 - busy / 1e3 / wall_ms,
        "top_kernels": [{"name": e.key[:90], "calls": e.count,
                         "device_ms": e.self_device_time_total / 1e3}
                        for e in by_time[:TOP_KERNELS]],
        "port_kernels": [{"name": e.key[:90], "calls": e.count,
                          "device_ms": e.self_device_time_total / 1e3}
                         for e in by_time if any(k in e.key for k in PORT_KERNEL_NAMES)],
        "stages": stage_split,
    }


def h2d_ms(torch, array, repeats: int = 3) -> float:
    """Least host ms of one copy of a numpy array to the card (pageable
    memory, as a request copies its video)."""
    best = float("inf")
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.as_tensor(array, device="cuda")
        torch.cuda.synchronize()
        best = min(best, 1e3 * (time.perf_counter() - t0))
    return best


def fused_vs_plain(values, fused, plain_values, plain):
    """Phase 3's gaps of a fused forward from the all-plain one."""
    return {
        "encoder_out_rel": max_rel(values["encoder_out"], plain_values["encoder_out"]),
        "decoder_out_rel": max_rel(values["decoder_out"], plain_values["decoder_out"]),
        "score_err": (fused["class_scores"] - plain["class_scores"]).abs().max().item(),
        "box_err_px": (fused["boxes"] - plain["boxes"]).abs().max().item(),
    }


def s2d_phase(torch, batch, phase2_request_s):
    """Phase 3b: the space-to-depth flagship on the host-packed video."""
    from future_od_tpu_torch.data.loader import host_space_to_depth
    from future_od_tpu_torch.models.build import build_flagship
    from future_od_tpu_torch.models.st_detr import SpatioTemporalDETRArgs
    from future_od_tpu_torch.ops import _kernels
    from future_od_tpu_torch.train.step import make_inference_fn

    args = SpatioTemporalDETRArgs(num_classes=8, num_queries=128, space_to_depth=True)
    model = build_flagship(args, generator=torch.Generator().manual_seed(0))
    randomize_heads_(torch, model._model.detector, torch.Generator().manual_seed(1))
    taps = Taps(torch, model)
    infer = make_inference_fn(model)
    t0 = time.perf_counter()
    packed = dict(batch, video=host_space_to_depth(batch["video"]))
    pack_ms = 1e3 * (time.perf_counter() - t0)

    set_gates()
    _kernels.reset_launch_counts()
    out, default_s = forward(torch, infer, packed, REQUESTS)
    default_counts = launched(_kernels)
    check_output(torch, out, args.num_queries, args.num_classes)
    if default_counts != {"flash_attention": 6 * REQUESTS}:
        raise AssertionError(f"s2d default gates: launches {default_counts}")
    default_stages = taps.stage_ms()
    default_profile = profile_request(torch, infer, packed, taps.stages)

    set_gates(FUTURE_OD_FUSED_RESNET="1", FUTURE_OD_FUSED_STEM="1")
    _kernels.reset_launch_counts()
    fused, fused_s = forward(torch, infer, packed, REQUESTS)
    fused_counts = launched(_kernels)
    want = {"flash_attention": 6, "fused_bottleneck": 6, "fused_stem": 1}
    if fused_counts != {k: n * REQUESTS for k, n in want.items()}:
        raise AssertionError(f"s2d fused gates: launches {fused_counts}, want {want} per forward")
    check_output(torch, fused, args.num_queries, args.num_classes)
    fused_values, fused_stages = dict(taps.values), taps.stage_ms()

    set_gates(FUTURE_OD_DISABLE_FLASH="1")
    _kernels.reset_launch_counts()
    plain, plain_s = forward(torch, infer, packed, 2)
    if any(_kernels.launch_counts.values()):
        raise AssertionError(f"s2d all-plain forward launched {_kernels.launch_counts}")
    diffs = fused_vs_plain(fused_values, fused, taps.values, plain)
    log("3b-s2d-flagship-f32", **diffs, tolerances=PHASE3_TOLS,
        video_shape=list(packed["video"].shape), host_pack_ms=pack_ms,
        h2d_ms={"packed": h2d_ms(torch, packed["video"]),
                "phase 2 video": h2d_ms(torch, batch["video"])},
        request_s={"default": default_s, "fused": fused_s, "plain": plain_s,
                   "phase 2 default (7x7 stem, 3-channel video)": phase2_request_s},
        launches={"default": default_counts, "fused": fused_counts},
        stage_ms={"default": default_stages, "fused": fused_stages}, profile=default_profile)
    if not all(diffs[k] <= PHASE3_TOLS[k] for k in PHASE3_TOLS):
        raise AssertionError("s2d fused forward differs from the all-plain forward")


def trainer_train_kernels(torch, dev, attentions=TRAINER_ATTENTIONS):
    """Phase 6's K4-K6 at both stages' shapes (phase 8a's: `attentions`),
    f32, dropout 0.1: one call each against its plain version (phase 1b's
    tolerances), then each one's time beside the plain version's and its
    bound. Returns per-kernel records."""
    from future_od_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=dev).manual_seed(6)
    records = {name: [] for name in TRAIN_KERNELS}
    for label, BH, Nq, Nk, d, dv, per_step in attentions:
        q, k, do = (torch.randn(*s, generator=gen, device=dev)
                    for s in ((BH, Nq, d), (BH, Nk, d), (BH, Nq, dv)))
        v = torch.randn(BH, Nk, dv, generator=gen, device=dev)
        nq_pad, nk_pad = fa.train_shapes(Nq, Nk, 256, 512)
        args = (12345, 1.0 / math.sqrt(d), 0.1, nq_pad, nk_pad)
        tag = f"{label} float32 rate 0.1"
        ref_out, ref_lse = fa.flash_train_fwd_plain(q, k, v, *args)
        delta = (do.float() * ref_out.float()).sum(-1)
        out, lse = fa.flash_train_fwd(q, k, v, *args)
        errs = {"flash_train_fwd": max(
            check_close(f"flash_train_fwd out {tag}", out, ref_out, "float32")[0],
            check_close(f"flash_train_fwd lse {tag}", lse, ref_lse, "float32")[0])}
        dq = fa.flash_dq(q, k, v, do, ref_lse, delta, *args)
        errs["flash_train_dq"] = check_close(
            f"flash_train_dq {tag}", dq, fa.flash_dq_plain(q, k, v, do, ref_lse, delta, *args),
            "float32")[0]
        dk, dvv = fa.flash_dkv(q, k, v, do, ref_lse, delta, *args)
        ref_dk, ref_dv = fa.flash_dkv_plain(q, k, v, do, ref_lse, delta, *args)
        errs["flash_train_dkv"] = max(
            check_close(f"flash_train_dkv dk {tag}", dk, ref_dk, "float32")[0],
            check_close(f"flash_train_dkv dv {tag}", dvv, ref_dv, "float32")[0])
        del ref_out, out, lse, dq, dk, dvv, ref_dk, ref_dv
        costs = fa.train_attention_cost(BH, Nq, Nk, d, dv, 4)
        grads = (do, ref_lse, delta, *args)
        calls = {
            "flash_train_fwd": (partial(fa.flash_train_fwd, q, k, v, *args),
                                partial(fa.flash_train_fwd_plain, q, k, v, *args)),
            "flash_train_dq": (partial(fa.flash_dq, q, k, v, *grads),
                               partial(fa.flash_dq_plain, q, k, v, *grads)),
            "flash_train_dkv": (partial(fa.flash_dkv, q, k, v, *grads),
                                partial(fa.flash_dkv_plain, q, k, v, *grads)),
        }
        for name, (kernel, plain) in calls.items():
            ops, nbytes = costs[name]
            b_ms, b_by, b_is = tc_bound(ops, nbytes, "float32")
            records[name].append(dict(
                attention=label, shape=[BH, Nq, Nk, d, dv], dtype="float32", rate=0.1,
                per_step=per_step, max_abs_err=errs[name], ms=time_ms(torch, kernel),
                plain_ms=time_ms(torch, plain), ops=ops, bytes=nbytes, bound_ms=b_ms,
                bound_by=b_by, bound_is=b_is,
                launch=launch_plan(torch, fa, name, BH, Nq, Nk, d, dv, torch.float32)))
        del q, k, v, do, delta, ref_lse, grads, calls
        torch.cuda.empty_cache()
    return records


class TrainerProbe:
    """Instruments a run of the Trainer without changing what it computes:
    the step factories as `train/trainer.py` names them, the Loader's
    iterator and the AP aggregation are wrapped while it is installed. Per
    step call it records the mode ("train", "audit" for the gradient report,
    "eval"), the stage (the video's height), the launches of K1-K6 (host
    counters, read before and after the call: no sync), CUDA events around
    the call, the loss and the matcher's rounds; per stage the peak memory
    and the launch totals (the counters are set to 0 as a stage starts); per
    batch the host's wait on the Loader; every AP dict; the first batch and
    output of each stage's train and eval steps."""

    def __init__(self, torch, kernels):
        self.torch, self.kernels = torch, kernels
        self.calls, self.waits, self.aps = [], [], []
        self.peaks, self.totals, self.first = {}, {}, {}
        self.inner = {}
        self._stage, self._undo = None, []

    def _patch(self, owner, name, value):
        self._undo.append((owner, name, getattr(owner, name)))
        setattr(owner, name, value)

    def install(self, trainer_module, loader_module):
        probe = self

        def factory(make, mode):
            def wrapped_make(*args, **kwargs):
                inner = make(*args, **kwargs)
                probe.inner[mode] = inner

                def step(data, *rest):
                    return probe._call(mode, data, lambda: inner(data, *rest))
                step.steps = getattr(inner, "steps", None)
                return step
            return wrapped_make

        self._patch(trainer_module, "make_train_step", factory(trainer_module.make_train_step,
                                                               "train"))
        self._patch(trainer_module, "make_eval_step", factory(trainer_module.make_eval_step,
                                                              "eval"))
        self._patch(trainer_module, "make_grad_report", factory(trainer_module.make_grad_report,
                                                                "audit"))
        aggregate = trainer_module.aggregate_mean_average_precision

        def aggregate_and_keep(*args):
            ap = aggregate(*args)
            probe.aps.append((probe._stage, ap))
            return ap
        self._patch(trainer_module, "aggregate_mean_average_precision", aggregate_and_keep)
        iterate = loader_module.Loader.__iter__

        def timed_iter(loader):
            batches = iterate(loader)
            try:
                while True:
                    t0 = time.perf_counter()
                    try:
                        batch = next(batches)
                    except StopIteration:
                        return
                    probe.waits.append(("train" if loader.shuffle else "eval",
                                        loader.dataset.image_size[0], time.perf_counter() - t0))
                    yield batch
            finally:
                batches.close()
        self._patch(loader_module.Loader, "__iter__", timed_iter)

    def restore(self):
        while self._undo:
            owner, name, value = self._undo.pop()
            setattr(owner, name, value)

    def _enter_stage(self, stage):
        if stage == self._stage:
            return
        self.finish()
        self.kernels.reset_launch_counts()
        self.torch.cuda.reset_peak_memory_stats()
        self._stage = stage

    def finish(self):
        """Close the current stage: its peak memory and launch totals."""
        if self._stage is not None:
            self.torch.cuda.synchronize()
            self.peaks[self._stage] = self.torch.cuda.max_memory_allocated() / 1e9
            self.totals[self._stage] = launched(self.kernels)

    def _call(self, mode, data, run):
        torch = self.torch
        stage = data["video"].shape[2]
        self._enter_stage(stage)
        before = dict(self.kernels.launch_counts)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        out = run()
        end.record()
        host_s = time.perf_counter() - t0
        counts = self.kernels.launch_counts
        record = dict(mode=mode, stage=stage, events=(start, end), t0=t0, host_s=host_s,
                      launches={k: counts[k] - before[k] for k in MAIN_KERNELS
                                if counts[k] != before[k]})
        if mode != "audit":
            loss, stats, _, output = out
            record.update(loss=loss, rounds=stats["matcher_rounds"],
                          skipped=stats.get("nonfinite_skipped"))
            if (mode, stage) not in self.first:
                self.first[(mode, stage)] = (data, {k: v.detach().clone()
                                                    for k, v in output.items()})
        self.calls.append(record)
        return out


def equal_trees(torch, a, b, path="") -> list:
    """The paths where two nested dicts / lists of tensors and values differ
    (tensors bit for bit)."""
    if isinstance(a, dict):
        if set(a) != set(b):
            return [f"{path} keys"]
        return [p for key in a for p in equal_trees(torch, a[key], b[key], f"{path}.{key}")]
    if isinstance(a, (list, tuple)):
        if len(a) != len(b):
            return [f"{path} length"]
        return [p for i, (x, y) in enumerate(zip(a, b))
                for p in equal_trees(torch, x, y, f"{path}[{i}]")]
    if torch.is_tensor(a):
        same = torch.is_tensor(b) and a.device == b.device and torch.equal(a, b)
        return [] if same else [path]
    return [] if (a == b or (a != a and b != b)) else [path]


def check_ap(ap, num_classes: int) -> None:
    """The JAX package's AP dict: its keys and shapes, every value in
    [0, 1] or NaN (a class without annotations)."""
    T, S = 10, 4
    shapes = {"all": (T, num_classes, S), "classavg": (T, S), "threshavg": (num_classes, S),
              "classavg threshavg": (S,), "generic": (T, S), "generic threshavg": (S,)}
    if tuple(ap) != AP_KEYS or any(ap[k].shape != v for k, v in shapes.items()):
        raise AssertionError(f"AP dict {[(k, v.shape) for k, v in ap.items()]}, want {shapes}")
    for key, value in ap.items():
        finite = value[~np.isnan(value)]
        if ((finite < 0) | (finite > 1)).any():
            raise AssertionError(f"AP {key} outside [0, 1]: {value}")


def run_trainer_script(torch, argv, accum: int = 1):
    """The flagship's script, `main(argv)` in this process with K1-K6 gated
    on, its paths in a temporary directory, instrumented by a TrainerProbe:
    the run's checks (`check_trainer_run`, K4-K6 18 times a micro-batch of
    `accum`), and a fresh Trainer from the script's `get_trainer` (no
    --restart) that loads the checkpoint bit for bit (weights, optimizer,
    epoch, step, meters; `_final`'s net too) with every weight f32. Returns
    (per-stage records, the probe, the trained Trainer)."""
    import importlib
    import tempfile

    from future_od_tpu_torch.data import loader as loader_module
    from future_od_tpu_torch.ops import _kernels
    from future_od_tpu_torch.runs import _helper
    from future_od_tpu_torch.runs._model import build_model
    from future_od_tpu_torch.runs.config import config
    from future_od_tpu_torch.train import trainer as trainer_module

    script = importlib.import_module(TRAINER_SCRIPT)
    set_gates(**TRAINER_GATES)
    saved_config = dict(config)
    probe = TrainerProbe(torch, _kernels)
    with tempfile.TemporaryDirectory() as tmp:
        config.update(checkpoint_path=os.path.join(tmp, "checkpoints"),
                      visualization_path=os.path.join(tmp, "visualization"))
        probe.install(trainer_module, loader_module)
        try:
            t0 = time.perf_counter()
            trainer = script.main(argv)
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
            probe.finish()
        finally:
            probe.restore()
            config.clear()
            config.update(saved_config)
        per_stage = check_trainer_run(torch, probe, trainer, accum)
        per_stage["run_s"] = run_s

        args = script.build_parser().parse_args(argv)
        args.experiment_idf = TRAINER_SCRIPT.rsplit(".", 1)[1]
        names = sorted(os.listdir(os.path.join(tmp, "checkpoints")))
        if names != [args.experiment_idf, args.experiment_idf + "_final"]:
            raise AssertionError(f"checkpoints written: {names}")
        config.update(checkpoint_path=os.path.join(tmp, "checkpoints"))
        try:
            fresh = _helper.get_trainer(args, config, trainer._args, _helper.get_lr_func(2),
                                        build_model(args, trainer._args),
                                        trainer._train_loader, trainer._val_loaders)
        finally:
            config.clear()
            config.update(saved_config)
        differ = equal_trees(torch, *({"net": t._model.state_dict(),
                                       "optimizer": t._optimizer.state_dict(),
                                       "epoch": t._epoch, "step": t.step,
                                       "stats": {k: m.state_dict() for k, m in t._stats.items()}}
                                      for t in (fresh, trainer)))
        final = torch.load(os.path.join(tmp, "checkpoints", names[1]), weights_only=True,
                           map_location=next(trainer._model.parameters()).device)
        differ += equal_trees(torch, final["net"], trainer._model.state_dict(), "final.net")
        if differ:
            raise AssertionError(f"resumed Trainer differs from the saved one at {differ[:5]}")
        not_f32 = [k for k, v in final["net"].items() if v.is_floating_point()
                   and v.dtype != torch.float32]
        not_f32 += [k for st in trainer._optimizer.state.values() for k, v in st.items()
                    if v.dim() and v.dtype != torch.float32]
        if not_f32:
            raise AssertionError(f"master weights or AdamW state not f32: {not_f32[:5]}")
        del fresh, final
        torch.cuda.empty_cache()
    return per_stage, probe, trainer


def trainer_phase(torch):
    """Phase 6: the flagship's run script, its checks and its numbers.
    Returns (per-stage records, launch totals per kernel and stage, K4-K6's
    records at the stages' shapes)."""
    from future_od_tpu_torch.ops import _kernels

    dev = torch.device("cuda")
    kernel_records = trainer_train_kernels(torch, dev)
    log("6-trainer-train-kernels-vs-plain", ok=True, card=gpu_name_and_power(),
        records=kernel_records)
    per_stage, probe, trainer = run_trainer_script(torch, TRAINER_ARGV)

    # each stage's first eval batch through the script's eval step on the
    # final weights, with the run's gates (its launches as in the run) and
    # then with every kernel gate off: scores and boxes against each other
    for stage, (name, _, _) in TRAINER_STAGES.items():
        data = probe.first[("eval", stage)][0]
        outputs = {}
        for label, gates in (("fused", TRAINER_GATES), ("plain", {"FUTURE_OD_DISABLE_FLASH": "1"})):
            set_gates(**gates)
            _kernels.reset_launch_counts()
            outputs[label] = probe.inner["eval"](data)[3]
            torch.cuda.synchronize()
            want = TRAINER_LAUNCHES[("eval", stage)] if label == "fused" else {}
            if launched(_kernels) != want:
                raise AssertionError(f"{name} {label} eval launched {launched(_kernels)}, "
                                     f"want {want}")
        fused, plain = outputs["fused"], outputs["plain"]
        diffs = {"score_err": (fused["class_scores"] - plain["class_scores"]).abs().max().item(),
                 "box_err_px": (fused["boxes"] - plain["boxes"]).abs().max().item()}
        if not all(diffs[k] <= PHASE3_TOLS[k] for k in diffs):
            raise AssertionError(f"{name} eval through the kernels differs from all plain: "
                                 f"{diffs}")
        per_stage[stage]["eval_vs_plain"] = {
            **diffs, "tolerances": {k: PHASE3_TOLS[k] for k in diffs}}
        del outputs, fused, plain

    profile_train_steps(torch, trainer, probe, per_stage)
    totals = launch_totals(probe)
    del trainer, probe
    torch.cuda.empty_cache()
    return per_stage, totals, kernel_records


def profile_train_steps(torch, trainer, probe, per_stage) -> None:
    """One profiled train step a stage, on its first batch, after every
    check: per_stage[stage]["profile"]."""
    set_gates(**TRAINER_GATES)
    core = trainer._model._model
    stages = {"backbone": core.separate_encoder.backbone,
              "encoder": core.separate_encoder.transformer, "detector": core.detector}
    for stage in TRAINER_STAGES:
        batch = probe.first[("train", stage)][0]
        per_stage[stage]["profile"] = profile_request(
            torch, lambda b: probe.inner["train"](b, 0), batch, stages)


def launch_totals(probe) -> dict:
    """{kernel: {stage name: launches in the run}}."""
    return {name: {TRAINER_STAGES[s][0]: probe.totals[s].get(name, 0) for s in TRAINER_STAGES}
            for name in MAIN_KERNELS}


def check_trainer_run(torch, probe, trainer, accum: int = 1):
    """Phase 6's checks on a recorded run: each step call's launches (a
    train step's K4-K6 once a micro-batch of `accum`), finite losses,
    matcher rounds, the AP dicts; and its numbers per stage."""
    num_classes = trainer._args.num_classes

    def launches(call):
        counts = TRAINER_LAUNCHES.get((call["mode"], call["stage"]))
        if counts is not None and call["mode"] == "train":
            counts = {k: n * accum for k, n in counts.items()}
        return counts
    check_step_calls(probe.calls, launches)
    for stage, (name, steps, batches) in TRAINER_STAGES.items():
        check_stage_calls(probe, stage, name,
                          {"train": steps, "eval": batches, "audit": 1 if stage == 448 else 0})
    check_aps(probe.aps, (448, 448, 896, 896), num_classes)
    if trainer._epoch != 2 or trainer.step != sum(n for _, n, _ in TRAINER_STAGES.values()):
        raise AssertionError(f"trainer at epoch {trainer._epoch}, step {trainer.step}")

    per_stage = {}
    for stage, (name, _, _) in TRAINER_STAGES.items():
        calls = [c for c in probe.calls if c["stage"] == stage]
        train = [c for c in calls if c["mode"] == "train"]
        evals = [c for c in calls if c["mode"] == "eval"]
        waits = [w for mode, s, w in probe.waits if s == stage and mode == "train"]
        per_stage[stage] = {
            "stage": name,
            "train_step_ms": [c["events"][0].elapsed_time(c["events"][1]) for c in train],
            "train_step_host_ms": [1e3 * c["host_s"] for c in train],
            "train_step_interval_ms": [1e3 * (b["t0"] - a["t0"]) for a, b in zip(train, train[1:])],
            "eval_ms": [c["events"][0].elapsed_time(c["events"][1]) for c in evals],
            "audit_ms": [c["events"][0].elapsed_time(c["events"][1]) for c in calls
                         if c["mode"] == "audit"],
            "loader_wait_ms": [1e3 * w for w in waits],
            "eval_loader_wait_ms": [1e3 * w for mode, s, w in probe.waits
                                    if s == stage and mode == "eval"],
            "losses": [c["loss"].item() for c in train],
            "eval_losses": [c["loss"].item() for c in evals],
            "matcher_rounds": [c["rounds"].item() for c in train + evals],
            "peak_mem_gb": probe.peaks[stage],
            "launches": probe.totals[stage],
            # the validation epoch's AP (a stage aggregates train, then val0)
            "val0_ap": {k: v.tolist()
                        for k, v in [ap for s, ap in probe.aps if s == stage][-1].items()
                        if k.endswith("threshavg")},
        }
        # the first call of a stage carries the allocator's and cuDNN's
        # warm-up at its shapes (and the Loader's first batch): the medians
        # are of the later ones
        for key in ("train_step_ms", "eval_ms", "loader_wait_ms"):
            later = per_stage[stage][key][1:]
            per_stage[stage][f"median_later_{key}"] = sorted(later)[len(later) // 2]
    return per_stage


def precision_phase(torch, f32_first_loss: float):
    """Phase 6b: the script with --bf16, then --bf16 --accum 2, as phase 6
    runs it (`run_trainer_script`); the first train step's loss against
    phase 6's f32 one (same weights, batch and dropout), the dtypes K4-K6
    receive, per stage the numbers of phase 6 and one profiled train step.
    Returns ({label: per-stage records}, {label: launch totals})."""
    from future_od_tpu_torch.models import layers

    runs, totals = {}, {}
    for label, extra, accum in PRECISION_RUNS:
        dtypes = {}
        original = layers.flash_attention_train

        def recording(q, k, v, *rest):
            key = "/".join(str(t.dtype)[6:] for t in (q, k, v))
            dtypes[key] = dtypes.get(key, 0) + 1
            return original(q, k, v, *rest)
        layers.flash_attention_train = recording
        try:
            per_stage, probe, trainer = run_trainer_script(torch, TRAINER_ARGV + extra, accum)
        finally:
            layers.flash_attention_train = original
        first = per_stage[448]["losses"][0]
        gap = abs(first - f32_first_loss) / abs(f32_first_loss)
        if gap > BF16_FIRST_LOSS_RTOL:
            raise AssertionError(f"{label}: first step's loss {first} against f32 "
                                 f"{f32_first_loss}: {gap} > {BF16_FIRST_LOSS_RTOL}")
        profile_train_steps(torch, trainer, probe, per_stage)
        per_stage["first_loss_vs_f32"] = {"loss": first, "f32_loss": f32_first_loss,
                                          "relative_gap": gap, "tolerance": BF16_FIRST_LOSS_RTOL}
        per_stage["k4_k6_input_dtypes"] = dtypes
        runs[label] = per_stage
        totals[label] = launch_totals(probe)
        del trainer, probe
        torch.cuda.empty_cache()
    return runs, totals


def accum_exactness(torch):
    """Phase 6b's exactness check: one f32 train step at dropout 0 of phase
    5's full-width model and batch (4 clips at 448x800, TF32 off), with
    --accum 2 against 1 from the same weights: the loss and every
    parameter's (clipped) gradient within the stated tolerances."""
    from future_od_tpu_torch.models.build import build_flagship
    from future_od_tpu_torch.models.st_detr import SpatioTemporalDETRArgs
    from future_od_tpu_torch.train.optimizer import build_optimizer
    from future_od_tpu_torch.train.step import make_train_step

    args = SpatioTemporalDETRArgs(num_classes=8, num_queries=128, lr_backbone=1e-4,
                                  freeze_stem=True, matcher="auction", cost_slots=128)
    data = make_train_batch(seed=0)
    set_gates(FUTURE_OD_TRAIN_FLASH="1")
    results = {}
    for accum in (1, 2):
        model = build_flagship(args, generator=torch.Generator().manual_seed(0))
        randomize_heads_(torch, model._model.detector, torch.Generator().manual_seed(1))
        set_dropout(torch, model, 0.0)
        optimizer = build_optimizer(model, args.lr, args.lr_backbone)
        step = make_train_step(model, args.criterion_config(), optimizer, accum_steps=accum)
        loss, stats, _, _ = step(data, 0)
        results[accum] = (loss.item(), {n: p.grad.detach().clone()
                                        for n, p in model.named_parameters()
                                        if p.grad is not None},
                          {k: v.item() for k, v in stats.items()})
        del model, optimizer, step
        torch.cuda.empty_cache()
    (loss1, grads1, stats1), (loss2, grads2, stats2) = results[1], results[2]
    loss_gap = abs(loss2 - loss1) / abs(loss1)
    # each group's largest |difference| over its largest |gradient|; beside
    # it, phase 5a's per-parameter form (over each tensor's own largest)
    group_gap = grad_gap_by_group(grads2, grads1)
    if loss_gap > ACCUM_LOSS_RTOL or any(v > ACCUM_GRAD_RTOL[k] for k, v in group_gap.items()):
        raise AssertionError(f"--accum 2 against 1: loss gap {loss_gap}, gradients {group_gap}")
    return {"loss": [loss1, loss2], "loss_gap": loss_gap, "loss_rtol": ACCUM_LOSS_RTOL,
            "grad_gap_by_group": group_gap, "grad_rtol": ACCUM_GRAD_RTOL,
            "grad_gap_per_parameter": worst_per_group(gradient_gaps(grads2, grads1)),
            "matcher_rounds": [stats1["matcher_rounds"], stats2["matcher_rounds"]]}


class FixtureClips:
    """Phase 7's dataset: clips of 3 of the committed 1600x900 JPEGs, read,
    normalized and transformed as the nuScenes dataset's __getitem__ does
    (RandomSizedCrop(0.5, 1) then JointResize to the stage's size, dense
    targets), from files on disk."""

    def __init__(self, paths, size, clips, device_normalize=False):
        self.paths, self.size, self.clips = paths, size, clips
        self.device_normalize = device_normalize

    def __len__(self):
        return self.clips

    def __getitem__(self, i):
        from future_od_tpu_torch.data import transforms as T
        from future_od_tpu_torch.data.image import read_image_rgb
        from future_od_tpu_torch.ops.target_utils import construct_box_targets

        video = np.stack([read_image_rgb(self.paths[(i + k) % len(self.paths)])
                          for k in range(FRAMES)])
        if not self.device_normalize:
            video = T.remap_and_normalize(video)
        boxes = np.array([[100.0, 200.0, 400.0, 500.0], [900.0, 300.0, 1200.0, 700.0]],
                         np.float32)
        video, boxes, classes = T.JointCompose(
            [T.RandomSizedCrop(0.5, 1.0), T.JointResize(self.size)])(video, boxes,
                                                                        np.array([0, 3]))
        boxes, classes, ignore, active = construct_box_targets(boxes, classes, 256)
        return {"video": video, "boxes": boxes, "classes": classes, "active": active,
                "annotated_frame_idx": np.int64(FRAMES - 1), "ignore_boxes": ignore}


def data_phase(torch, stage1_step_ms: dict):
    """Phase 7: the data path at nuScenes' size, on the host. Each committed
    fixture decoded by the port's decoder must hash to the digest cv2 gave
    (`fixtures/manifest.json`); per 900x1600 frame, the decode's, the
    resizes' (float32 as the dataset resizes normalized frames, and uint8
    under device_normalize) and the normalization's ms; the thread-pool
    Loader's and the worker-process loader's frames a second over clips of
    the fixtures, beside phase 6's stage-1 appetite."""
    import hashlib

    from future_od_tpu_torch.data import transforms as T
    from future_od_tpu_torch.data.image import read_image_rgb, resize_linear
    from future_od_tpu_torch.data.loader import Loader, WorkerLoader

    with open(os.path.join(FIXTURE_DIR, "manifest.json")) as f:
        manifest = json.load(f)
    paths = [os.path.join(FIXTURE_DIR, name) for name in sorted(manifest)]
    digests = {}
    for name, path in zip(sorted(manifest), paths):
        pixels = read_image_rgb(path)
        digests[name] = hashlib.sha256(pixels.tobytes()).hexdigest()
        if pixels.shape != (900, 1600, 3) or digests[name] != manifest[name]["pixels_sha256"]:
            raise AssertionError(f"{name}: decoded {pixels.shape}, digest {digests[name]}, "
                                 f"want cv2's {manifest[name]['pixels_sha256']}")

    def per_frame_ms(fn, repeats=DATA_REPEATS):
        fn()
        t0 = time.perf_counter()
        for _ in range(repeats):
            fn()
        return 1e3 * (time.perf_counter() - t0) / repeats

    frame = read_image_rgb(paths[0])
    norm = T.remap_and_normalize(frame[None])[0]
    ms = {
        "decode": {name: per_frame_ms(lambda p=path: read_image_rgb(p))
                   for name, path in zip(sorted(manifest), paths)},
        "normalize": per_frame_ms(lambda: T.remap_and_normalize(frame[None])),
        "resize_f32": {f"{h}x{w}": per_frame_ms(lambda s=(h, w): resize_linear(norm, s))
                       for h, w in ((448, 800), (896, 1600))},
        "resize_u8": {f"{h}x{w}": per_frame_ms(lambda s=(h, w): resize_linear(frame, s))
                      for h, w in ((448, 800), (896, 1600))},
    }
    appetite = {label: TRAINER_STAGES_BATCH[448] * FRAMES / (step_ms / 1e3)
                for label, step_ms in stage1_step_ms.items()}
    loaders = {}
    for name, cls in (("thread Loader", Loader), ("worker-process loader", WorkerLoader)):
        clips = FixtureClips(paths, (448, 800), DATA_BATCHES * TRAINER_STAGES_BATCH[448])
        loader = cls(clips, batch_size=TRAINER_STAGES_BATCH[448], shuffle=True,
                     num_workers=DATA_WORKERS)
        passes = []
        for epoch in (1, 2):  # the first pass starts the worker processes
            loader.set_epoch(epoch)
            t0 = time.perf_counter()
            n = sum(b["video"].shape[0] * b["video"].shape[1] for b in loader)
            passes.append((n, time.perf_counter() - t0))
        del loader  # stops the worker processes
        loaders[name] = {"frames": passes[1][0], "seconds": passes[1][1],
                         "frames_per_s": passes[1][0] / passes[1][1],
                         "first_pass_frames_per_s": passes[0][0] / passes[0][1],
                         "workers": DATA_WORKERS}
    return {"digests_equal_cv2": digests, "ms_per_900x1600_frame": ms,
            "loaders": loaders, "stage1_appetite_frames_per_s": appetite,
            "host_cpus": os.cpu_count(), "card": gpu_name_and_power()}


def check_step_calls(calls, want) -> None:
    """Each recorded step call's launches (`want(call)`), and for the train
    and eval steps a finite loss, no skipped update and the auction below
    its round cap."""
    for call in calls:
        if want(call) is None or call["launches"] != want(call):
            raise AssertionError(f"{call['mode']} at height {call['stage']}: launches "
                                 f"{call['launches']}, want {want(call)}")
        if call["mode"] == "audit":
            continue
        loss, rounds = call["loss"].item(), call["rounds"].item()
        if not math.isfinite(loss) or (call["skipped"] is not None and call["skipped"].item()):
            raise AssertionError(f"{call['mode']} step at height {call['stage']}: loss {loss}")
        if rounds >= 1000:
            raise AssertionError(f"{call['mode']} step: the auction hit its round cap")


def check_stage_calls(probe, stage, name, want) -> None:
    """The step calls a mode at one stage (`want`), and no launch outside
    the step calls."""
    modes = [c["mode"] for c in probe.calls if c["stage"] == stage]
    if {m: modes.count(m) for m in want} != want:
        raise AssertionError(f"{name}: step calls {modes}, want {want}")
    stage_sum = {}
    for call in probe.calls:
        if call["stage"] == stage:
            for k, n in call["launches"].items():
                stage_sum[k] = stage_sum.get(k, 0) + n
    if probe.totals[stage] != stage_sum:
        raise AssertionError(f"{name}: launches outside the steps: {probe.totals[stage]} "
                             f"against {stage_sum}")


def check_aps(aps, stages, num_classes: int) -> None:
    """The AP aggregations were at `stages` (video heights), each dict the
    JAX package's."""
    if [s for s, _ in aps] != list(stages):
        raise AssertionError(f"AP aggregations at {[s for s, _ in aps]}")
    for _, ap in aps:
        check_ap(ap, num_classes)


def single_frame_phase(torch):
    """Phase 8a: the single-frame script, its checks and its numbers.
    Returns (record, K4-K6's records at its shapes, launch totals)."""
    import importlib
    import tempfile

    from future_od_tpu_torch.data import loader as loader_module
    from future_od_tpu_torch.ops import _kernels
    from future_od_tpu_torch.runs.config import config
    from future_od_tpu_torch.train import trainer as trainer_module

    kernel_records = trainer_train_kernels(torch, torch.device("cuda"), SINGLE_FRAME_ATTENTIONS)
    log("8a-single-frame-train-kernels-vs-plain", ok=True, card=gpu_name_and_power(),
        records=kernel_records)
    script = importlib.import_module(SINGLE_FRAME_SCRIPT)
    set_gates(**TRAINER_GATES)
    saved_config = dict(config)
    probe = TrainerProbe(torch, _kernels)
    with tempfile.TemporaryDirectory() as tmp:
        config.update(checkpoint_path=os.path.join(tmp, "checkpoints"),
                      visualization_path=os.path.join(tmp, "visualization"))
        probe.install(trainer_module, loader_module)
        try:
            t0 = time.perf_counter()
            trainer = script.main(SINGLE_FRAME_ARGV)
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
            probe.finish()
        finally:
            probe.restore()
            config.clear()
            config.update(saved_config)
            names = sorted(os.listdir(os.path.join(tmp, "checkpoints")))
    if names != ["nuim_single_frame", "nuim_single_frame_final"]:
        raise AssertionError(f"checkpoints written: {names}")
    video = probe.first[("train", 448)][0]["video"]
    if tuple(video.shape) != (32, 1, 448, 800, 3):
        raise AssertionError(f"single-frame train batch {tuple(video.shape)}")
    check_step_calls(probe.calls, lambda call: SINGLE_FRAME_LAUNCHES[call["mode"]])
    check_stage_calls(probe, 448, "the single-frame run", SINGLE_FRAME_CALLS)
    check_aps(probe.aps, (448, 448), trainer._args.num_classes)
    train = [c for c in probe.calls if c["mode"] == "train"]
    evals = [c for c in probe.calls if c["mode"] == "eval"]
    eval_ms = [c["events"][0].elapsed_time(c["events"][1]) for c in evals]
    record = {
        "script": SINGLE_FRAME_SCRIPT, "argv": SINGLE_FRAME_ARGV, "gates": TRAINER_GATES,
        "run_s": run_s,
        "train_step_ms": [c["events"][0].elapsed_time(c["events"][1]) for c in train],
        "audit_ms": [c["events"][0].elapsed_time(c["events"][1]) for c in probe.calls
                     if c["mode"] == "audit"],
        "eval_ms": eval_ms, "median_later_eval_ms": sorted(eval_ms[1:])[len(eval_ms[1:]) // 2],
        "losses": [c["loss"].item() for c in train],
        "eval_losses": [c["loss"].item() for c in evals],
        "peak_mem_gb": probe.peaks[448], "launches": probe.totals[448],
        "val0_ap": {k: v.tolist() for k, v in probe.aps[-1][1].items()
                    if k.endswith("threshavg")},
    }
    record["later_train_step_ms"] = record["train_step_ms"][1:]
    core = trainer._model._model
    stages = {"backbone": core.separate_encoder.backbone,
              "encoder": core.separate_encoder.transformer, "detector": core.detector}
    set_gates(**TRAINER_GATES)
    record["profile"] = profile_request(
        torch, lambda b: probe.inner["train"](b, 0), probe.first[("train", 448)][0], stages)
    totals = dict(probe.totals[448])
    del trainer, probe, core, stages
    torch.cuda.empty_cache()
    return record, kernel_records, totals


def tracker_eval_phase(torch):
    """Phase 8b: the tracker eval script on a random single-frame
    checkpoint, its checks and its numbers. Returns (record, launch
    totals)."""
    import dataclasses
    import importlib
    import tempfile

    from future_od_tpu_torch.data import nu_scenes
    from future_od_tpu_torch.models.build import build_single_frame
    from future_od_tpu_torch.models.st_detr import SpatioTemporalDETRArgs
    from future_od_tpu_torch.ops import _kernels
    from future_od_tpu_torch.train import trainer as trainer_module
    from future_od_tpu_torch.utils.checkpoint import save_checkpoint

    script = importlib.import_module(TRACKER_SCRIPT)
    args = SpatioTemporalDETRArgs(num_classes=len(nu_scenes.CATEGORY_DICT), num_queries=128,
                                  lr_backbone=1e-4)
    model = build_single_frame(args, generator=torch.Generator().manual_seed(8))
    randomize_heads_(torch, model._model.detector, torch.Generator().manual_seed(9))
    net = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    del model
    calls, tracker_ms = [], []
    make_tracker_eval_step = trainer_module.make_tracker_eval_step

    def timed_tracker(tracker):
        def run(*a):
            t0 = time.perf_counter()
            out = tracker(*a)
            tracker_ms.append(1e3 * (time.perf_counter() - t0))
            return out
        return run

    def instrumented(model, cfg, tracker, **kw):
        step = make_tracker_eval_step(model, cfg, timed_tracker(tracker), **kw)

        def run(data):
            before = dict(_kernels.launch_counts)
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            out = step(data)
            end.record()
            counts = _kernels.launch_counts
            calls.append(dict(events=(start, end), loss=out[0], rounds=out[1]["matcher_rounds"],
                              shape=tuple(data["video"].shape),
                              launches={k: counts[k] - before[k] for k in counts
                                        if counts[k] != before[k]}))
            return out
        return run

    aps = []
    aggregate = trainer_module.aggregate_mean_average_precision
    set_gates(**TRACKER_GATES)
    _kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    trainer_module.make_tracker_eval_step = instrumented
    trainer_module.aggregate_mean_average_precision = lambda *a: aps.append(aggregate(*a)) or (
        aps[-1])
    try:
        with tempfile.TemporaryDirectory() as tmp:
            path = save_checkpoint(tmp, "nuim_single_frame_final", {
                "net": net, "net_type": "SpatioTemporalDETR",
                "detr_args": dataclasses.asdict(args)})
            t0 = time.perf_counter()
            trainer = script.main(["--checkpoint", path, "--synthetic", "--disable_wandb"])
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
    finally:
        trainer_module.make_tracker_eval_step = make_tracker_eval_step
        trainer_module.aggregate_mean_average_precision = aggregate
    totals = launched(_kernels)
    differ = equal_trees(torch, {k: v.cpu() for k, v in trainer._model.state_dict().items()}, net)
    if differ:
        raise AssertionError(f"the tracker baseline did not load the single-frame net: "
                             f"{differ[:5]}")
    if len(calls) != TRACKER_EVAL_BATCHES or len(tracker_ms) != len(calls):
        raise AssertionError(f"{len(calls)} eval calls, {len(tracker_ms)} tracker calls")
    for call in calls:
        if call["launches"] != TRACKER_LAUNCHES or call["shape"][1:] != (3, 896, 1600, 3):
            raise AssertionError(f"tracker eval batch {call['shape']}: launches "
                                 f"{call['launches']}, want {TRACKER_LAUNCHES}")
        if not math.isfinite(call["loss"].item()) or call["rounds"].item() >= 1000:
            raise AssertionError(f"tracker eval loss {call['loss'].item()}")
    if len(aps) != 1:
        raise AssertionError(f"{len(aps)} AP aggregations, want the validation epoch's")
    check_ap(aps[0], args.num_classes)
    eval_ms = [c["events"][0].elapsed_time(c["events"][1]) for c in calls]
    record = {
        "script": TRACKER_SCRIPT, "gates": TRACKER_GATES, "run_s": run_s, "eval_ms": eval_ms,
        "median_later_eval_ms": sorted(eval_ms[1:])[len(eval_ms[1:]) // 2],
        "tracker_host_ms": tracker_ms,
        "median_tracker_host_ms": sorted(tracker_ms)[len(tracker_ms) // 2],
        "eval_losses": [c["loss"].item() for c in calls],
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "launches": totals,
        "val0_ap": {k: v.tolist() for k, v in aps[0].items() if k.endswith("threshavg")},
    }
    del trainer
    torch.cuda.empty_cache()
    return record, totals


def variants_phase(torch):
    """Phase 8c: one request a variant through make_inference_fn with the
    default gates against an all-plain forward, K1's launches, the captured
    weights; then K1 against its plain version on the variants' own inputs
    (2800 tokens, and as a cross-attention). Returns (per-variant records,
    K1's records, K1's launch total)."""
    import torch.nn.functional as F

    from future_od_tpu_torch.models import build, layers
    from future_od_tpu_torch.models.cores import FuturePredCore
    from future_od_tpu_torch.models.st_detr import SpatioTemporalDETRArgs, captured_attention
    from future_od_tpu_torch.ops import _kernels
    from future_od_tpu_torch.ops import flash_attention as fa
    from future_od_tpu_torch.train.step import make_inference_fn

    args = SpatioTemporalDETRArgs(num_classes=8, num_queries=128)

    def with_detector(**mode):
        return lambda g: build.assemble(FuturePredCore(build._separate_encoder(args),
                                                       build._detector(args, 2, **mode)),
                                        args, generator=g)
    builders = {
        "joint": lambda g: build.build_with_joint_encoder(args, "joint", generator=g),
        "sequential": lambda g: build.build_with_joint_encoder(args, "sequential", generator=g),
        "f2f": lambda g: build.build_with_joint_encoder(args, "f2f", generator=g),
        "slotstates": with_detector(use_slotstates=True),
        "attend all at once": with_detector(image_memory_mode="attend all at once"),
        "capturing flagship": lambda g: build.build_flagship(args, generator=g,
                                                             store_attention=True),
    }
    batch = make_batch(seed=8)
    wanted = {(name, index): what for name, index, what in VARIANT_K1_CALLS}
    kept = {}
    original = layers.flash_attention
    records, total = {}, 0
    for name, make in builders.items():
        t0 = time.perf_counter()
        model = make(torch.Generator().manual_seed(8))
        randomize_heads_(torch, model._model.detector, torch.Generator().manual_seed(9))
        infer = make_inference_fn(model)
        seen = [0]

        def keeping(q, k, v, scale, name=name, seen=seen):
            if (name, seen[0]) in wanted:
                kept[(name, seen[0])] = (q.clone(), k.clone(), v.clone(), scale)
            seen[0] += 1
            return original(q, k, v, scale)
        set_gates()
        layers.flash_attention = keeping
        _kernels.reset_launch_counts()
        try:
            out, request_s = forward(torch, infer, batch, 1)
        finally:
            layers.flash_attention = original
        out, more_s = forward(torch, infer, batch, 1)
        counts = launched(_kernels)
        want = {"flash_attention": 2 * VARIANT_K1[name]}
        if counts != want:
            raise AssertionError(f"{name}: launches {counts} in 2 requests, want {want}")
        total += counts["flash_attention"]
        check_output(torch, out, args.num_queries, args.num_classes)
        record = {"request_s": request_s + more_s, "launches_per_request": VARIANT_K1[name]}
        if name == "capturing flagship":
            captured = captured_attention(model)
            if len(captured) != 2 * args.dec_layers or any(len(w) != 1
                                                            for w in captured.values()):
                raise AssertionError(f"captured {[(k, len(w)) for k, w in captured.items()]}")
            record["captured"] = {
                "paths": len(captured),
                "shape": list(captured["core/detector/decoder/layer0/image_attend1"][0].shape),
                "row_sum_err": max((w[0].sum(-1) - 1).abs().max().item()
                                   for w in captured.values())}
            if record["captured"]["row_sum_err"] > 1e-5:
                raise AssertionError(f"captured rows do not sum to 1: {record['captured']}")
        set_gates(FUTURE_OD_DISABLE_FLASH="1")
        _kernels.reset_launch_counts()
        plain, plain_s = forward(torch, infer, batch, 1)
        if any(_kernels.launch_counts.values()):
            raise AssertionError(f"{name} all-plain forward launched {_kernels.launch_counts}")
        record.update(
            score_err=(out["class_scores"] - plain["class_scores"]).abs().max().item(),
            box_err_px=(out["boxes"] - plain["boxes"]).abs().max().item(),
            plain_request_s=plain_s, seconds=time.perf_counter() - t0)
        if record["score_err"] > SCORE_TOL or record["box_err_px"] > BOX_TOL_PX:
            raise AssertionError(f"{name}: the kernels' forward differs from all plain: "
                                 f"{record}")
        records[name] = record
        log("8c-variant", variant=name, ok=True, **record)
        del model, infer, out, plain
        torch.cuda.empty_cache()
    set_gates()
    k1 = []
    for (name, index), what in wanted.items():
        q, k, v, scale = kept[(name, index)]
        err, tol = check_close(f"flash_attention {what}", fa.flash_attention(q, k, v, scale),
                               fa.reference_attention(q, k, v, scale), "float32")
        B, H, Nq, d = q.shape
        Nk, dv = k.shape[2], v.shape[3]
        ops, nbytes = fa.attention_cost(B, H, Nq, Nk, d, dv, q.element_size())
        b_ms, b_by, b_is, _ = flash_bound(torch, ops, nbytes, fa.attention_exponentials(
            B, H, Nq, Nk), "float32")
        k1.append(dict(
            variant=name, call=index, attention=what, shape=[B, H, Nq, Nk, d, dv],
            dtype="float32", max_abs_err=err, tol=tol,
            ms=time_ms(torch, lambda: fa.flash_attention(q, k, v, scale)),
            plain_ms=time_ms(torch, lambda: fa.reference_attention(q, k, v, scale)),
            library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(q, k, v,
                                                                             scale=scale)),
            bound_ms=b_ms, bound_by=b_by, bound_is=b_is))
        log("8c-k1-vs-plain", **k1[-1])
    del kept
    torch.cuda.empty_cache()
    return records, k1, total


def serve_gaps(torch, out, ref) -> dict:
    """Phase 3's output gaps of a served output from its reference."""
    return {"score_err": (out["class_scores"].float() - ref["class_scores"].float()).abs().max().item(),
            "box_err_px": (out["boxes"].float() - ref["boxes"].float()).abs().max().item()}


def check_serve_gaps(what: str, gaps: dict) -> None:
    if gaps["score_err"] > SCORE_TOL or gaps["box_err_px"] > BOX_TOL_PX:
        raise AssertionError(f"{what}: {gaps} beyond phase 3's tolerances "
                             f"{SCORE_TOL}, {BOX_TOL_PX} px")


def make_stream(seed: int, streams: int, frames: int):
    """`streams` lockstep streams of `frames` frames at 896x1600, numpy:
    {"video": (streams, frames, H, W, 3), IMU keys: (streams, frames, d)}."""
    rng = np.random.default_rng(seed)
    stream = {"video": rng.standard_normal((streams, frames, HEIGHT, WIDTH, 3),
                                           dtype=np.float32)}
    for key, width in IMU_WIDTHS.items():
        stream[key] = rng.standard_normal((streams, frames, width), dtype=np.float32)
    return stream


def frame_of(stream, t):
    """Frame t of every stream: {"video": (B, H, W, 3), IMU keys: (B, d)}."""
    return {k: np.ascontiguousarray(v[:, t]) for k, v in stream.items()}


def clip_of(stream, t):
    """The clip whose past frames end at frame t (3 frames, t + 1 the
    future one), as a batch of the JAX package's keys."""
    clip = {k: np.ascontiguousarray(v[:, t - 1:t + 2]) for k, v in stream.items()}
    return dict(clip, annotated_frame_idx=np.full((clip["video"].shape[0],), FRAMES - 1))


class CountedCalls:
    """Wraps a callable; records the launches each call made."""

    def __init__(self, kernels, fn):
        self.kernels, self.fn, self.calls = kernels, fn, []

    def __call__(self, *args):
        before = dict(self.kernels.launch_counts)
        out = self.fn(*args)
        self.calls.append({k: n - before[k] for k, n in self.kernels.launch_counts.items()
                           if n != before[k]})
        return out


def counted_session(torch, model, kernels, hw):
    """A StreamingSession of SERVE_STREAMS-frame batches whose encode and
    detect record the launches of each call."""
    from future_od_tpu_torch.serve import StreamingSession, make_streaming_fns

    session = StreamingSession(model, clip_frames=FRAMES)
    encode, detect = make_streaming_fns(model, FRAMES, hw)
    session.encode, session.detect = CountedCalls(kernels, encode), CountedCalls(kernels, detect)
    return session


def session_phase(torch, model, stream, gate_runs):
    """Phase 9a: StreamingSession over SERVE_STREAMS lockstep streams of
    SERVE_STREAM_FRAMES frames, each output against make_inference_fn on the
    clip that ends at its frame, under each (label, gates, launches an
    encode) of `gate_runs`. Returns {label: record}."""
    from future_od_tpu_torch.ops import _kernels
    from future_od_tpu_torch.train.step import make_inference_fn

    infer = make_inference_fn(model)
    records = {}
    for label, gates, want in gate_runs:
        set_gates(**gates)
        _kernels.reset_launch_counts()
        session = counted_session(torch, model, _kernels, (HEIGHT, WIDTH))
        gaps = []
        for t in range(SERVE_STREAM_FRAMES - 1):  # clips end at frames 1..3
            out = session.step(frame_of(stream, t))
            if t == 0:
                if out is not None:
                    raise AssertionError("the session answered before its window was full")
                continue
            gaps.append(serve_gaps(torch, out, infer(clip_of(stream, t))))
            check_serve_gaps(f"9a session {label}, frame {t}", gaps[-1])
        if any(c != want for c in session.encode.calls) or any(session.detect.calls):
            raise AssertionError(f"9a {label}: launches an encode {session.encode.calls}, a "
                                 f"detect {session.detect.calls}; want {want} and none")
        records[label] = {"gaps": gaps, "encode_launches": session.encode.calls[0],
                          "detect_launches": {}, "encodes": len(session.encode.calls)}
        log("9a-session", run=label, ok=True, **records[label])
    return records


def session_throughput(torch, model, stream, steps: int = SERVE_TIMED_STEPS):
    """clips/s of the session (steps pipelined, one sync at the end, as
    tools/bench_streaming.py times them; each step copies its frame batch
    from the host) beside the batch path at SERVE_STREAMS clips a request
    (synced each), on the same frames."""
    from future_od_tpu_torch.train.step import make_inference_fn

    from future_od_tpu_torch.serve import StreamingSession

    session = StreamingSession(model, clip_frames=FRAMES)
    frames = [frame_of(stream, t) for t in range(SERVE_STREAM_FRAMES)]
    for f in frames[:FRAMES]:
        session.step(f)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(steps):
        session.step(frames[i % len(frames)])
    torch.cuda.synchronize()
    session_s = time.perf_counter() - t0
    infer = make_inference_fn(model)
    clip = clip_of(stream, 1)
    _, request_s = forward(torch, infer, clip, REQUESTS + 1)
    batch_s = median_and_least(request_s[1:])[0]
    return {"session_clips_per_s": SERVE_STREAMS * steps / session_s,
            "session_step_ms": 1e3 * session_s / steps,
            "batch_clips_per_s": SERVE_STREAMS / batch_s, "batch_request_ms": 1e3 * batch_s,
            "batch_request_s": request_s}


def export_phase(torch, model, stream):
    """Phase 9c: export_inference at one request (phase 2's batch) under the
    default and the fused gates, export_streaming at one frame batch of
    SERVE_STREAMS under the fused gates; each loaded from its bytes, run,
    its launches counted and its outputs held against the eager ones."""
    from future_od_tpu_torch.ops import _kernels
    from future_od_tpu_torch.serve import export_inference, export_streaming, load_serving
    from future_od_tpu_torch.serve import make_streaming_fns
    from future_od_tpu_torch.train.step import make_inference_fn, to_device_batch

    device = next(model.parameters()).device
    batch = dict(make_batch(seed=0), annotated_frame_idx=np.full((BATCH,), FRAMES - 1))
    dev_batch = to_device_batch(batch, device)
    records = {}
    for label, gates, want in (("default", {}, {"flash_attention": 6}),
                               ("fused", FUSED_GATES, FUSED_LAUNCHES)):
        set_gates(**gates)
        infer = make_inference_fn(model)
        eager, eager_s = forward(torch, infer, dev_batch, REQUESTS)
        t0 = time.perf_counter()
        blob = export_inference(model, batch)
        export_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        program = load_serving(blob)
        load_s = time.perf_counter() - t0

        def served(b, program=program):
            with torch.inference_mode():
                return program(b)
        _kernels.reset_launch_counts()
        got, served_s = forward(torch, served, dev_batch, REQUESTS)
        counts = launched(_kernels)
        if counts != {k: n * REQUESTS for k, n in want.items()}:
            raise AssertionError(f"9c {label} artifact: launches {counts}, want {want} a forward")
        check_output(torch, got, model.args.num_queries, model.args.num_classes)
        gaps = serve_gaps(torch, got, eager)
        check_serve_gaps(f"9c {label} artifact against eager", gaps)
        try:
            served(dict(dev_batch, video=dev_batch["video"][:, :, :HEIGHT // 2]))
        except Exception as e:  # the artifact's own shape check
            refused = f"{type(e).__name__}: {str(e)[:120]}"
        else:
            raise AssertionError(f"9c {label}: the artifact took a wrong shape")
        records[label] = {"gaps": gaps, "launches": counts, "blob_mb": len(blob) / 1e6,
                          "export_s": export_s, "load_s": load_s,
                          "artifact_request_s": served_s, "eager_request_s": eager_s,
                          "wrong_shape": refused}
        log("9c-export-inference", run=label, ok=True, **records[label])
        del program, blob

    set_gates(**FUSED_GATES)
    frame = frame_of(stream, 0)
    t0 = time.perf_counter()
    encode_blob, detect_blob = export_streaming(model, frame)
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    encode, detect = load_serving(encode_blob), load_serving(detect_blob)
    load_s = time.perf_counter() - t0
    encode, detect = CountedCalls(_kernels, encode), CountedCalls(_kernels, detect)
    live_encode, live_detect = make_streaming_fns(model, FRAMES, (HEIGHT, WIDTH))
    feats, egos, feature_rel = [], [], []
    with torch.inference_mode():
        for t in range(FRAMES - 1):
            f = to_device_batch(frame_of(stream, t), device)
            got_f, got_e = encode(f)
            want_f, _ = live_encode(f)
            feature_rel.append(max_rel(got_f, want_f))
            feats.append(got_f)
            egos.append(got_e)
        features, egodeep = torch.stack(feats, 1), torch.stack(egos, 1)
        offsets = features.new_zeros(features.shape[:2])
        got = detect(features, egodeep, offsets)
        want = live_detect(features, egodeep, offsets)
    encode_counts = {k: sum(c.get(k, 0) for c in encode.calls) for k in FUSED_LAUNCHES}
    detect_counts = detect.calls[0]
    if any(c != FUSED_LAUNCHES for c in encode.calls) or detect_counts:
        raise AssertionError(f"9c streaming artifacts: launches {encode.calls} an encode, "
                             f"{detect_counts} in a detect; want {FUSED_LAUNCHES} and none")
    if max(feature_rel) > ENCODER_RTOL:
        raise AssertionError(f"9c encode artifact: features {feature_rel} of max beyond "
                             f"{ENCODER_RTOL}")
    gaps = serve_gaps(torch, got, want)
    check_serve_gaps("9c detect artifact against eager", gaps)
    records["streaming fused"] = {
        "gaps": gaps, "feature_rel": feature_rel, "encode_launches": encode_counts,
        "detect_launches": detect_counts, "blob_mb": [len(encode_blob) / 1e6,
                                                      len(detect_blob) / 1e6],
        "export_s": export_s, "load_s": load_s}
    log("9c-export-streaming", ok=True, **records["streaming fused"])
    set_gates()
    return records


def serve_script_phase(torch):
    """Phase 9b: the serve script's main() in this process at its JAX
    defaults (24 streams, batch 12, 8 rounds, 896x1600), f32, --bf16 and
    --bf16 --device_normalize, default gates: K1 6 launches a dispatch,
    every dispatch full. Returns ({run: record}, K1's launches in all)."""
    import importlib

    from future_od_tpu_torch.ops import _kernels
    from future_od_tpu_torch.serve import MultiStreamServer

    script = importlib.import_module(SERVE_SCRIPT)
    servers = []

    class Kept(MultiStreamServer):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            servers.append(self)

    records, total = {}, 0
    script.MultiStreamServer = Kept
    try:
        for label, argv in SERVE_RUNS:
            set_gates()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            _kernels.reset_launch_counts()
            t0 = time.perf_counter()
            line = script.main(argv)
            run_s = time.perf_counter() - t0
            counts = launched(_kernels)
            if counts != {"flash_attention": 6 * line["dispatches"]}:
                raise AssertionError(f"9b {label}: launches {counts} in {line['dispatches']} "
                                     "dispatches, want flash 6 a dispatch")
            opts = script.build_parser().parse_args(argv)
            if line["pad_fraction"] != 0 or line["clips"] != opts.streams * opts.rounds:
                raise AssertionError(f"9b {label}: {line}")
            total += counts["flash_attention"]
            records[label] = {"argv": argv, "line": line, "launches": counts, "run_s": run_s,
                              "ring_mb": servers[-1].ring_bytes() / 1e6,
                              "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
            log("9b-serve-script", run=label, ok=True, card=gpu_name_and_power(),
                **records[label])
            servers.clear()
    finally:
        script.MultiStreamServer = MultiStreamServer
    return records, total


def server_checks(torch, model):
    """Phase 9b, after the script: 3 staggered streams through max_batch=4
    against per-stream sessions, and a stream served alone (3 pad rows a
    dispatch) against the same stream sharing its batches (the max
    difference; 0 when no op mixes batch rows)."""
    from future_od_tpu_torch.serve import MultiStreamServer, StreamingSession
    from future_od_tpu_torch.serve.server import split_results

    set_gates()
    stream = make_stream(11, 3, 4)
    frames = {sid: [{k: v[i, t] for k, v in stream.items()} for t in range(4)]
              for i, sid in enumerate("abc")}
    server = MultiStreamServer(model, max_batch=4, clip_frames=FRAMES)
    got = {sid: [] for sid in frames}
    for t in range(4):
        for sid in "abc":
            for rsid, out in split_results(server.submit(sid, frames[sid][t])):
                got[rsid].append(out)
    for rsid, out in split_results(server.flush()):
        got[rsid].append(out)
    gaps = []
    for sid, fs in frames.items():
        session = StreamingSession(model, clip_frames=FRAMES)
        want = [o for o in (session.step({k: v[None] for k, v in f.items()}) for f in fs)
                if o is not None]
        if not len(got[sid]) == len(want) == 3:
            raise AssertionError(f"9b server: stream {sid} gave {len(got[sid])} clips")
        for g, w in zip(got[sid], want):
            gaps.append(serve_gaps(torch, g, {k: v[0] for k, v in w.items()}))
            check_serve_gaps(f"9b server stream {sid} against its session", gaps[-1])
    solo = MultiStreamServer(model, max_batch=4, clip_frames=FRAMES)
    mixed = MultiStreamServer(model, max_batch=4, clip_frames=FRAMES)
    solo_outs, mixed_outs = [], []
    for t in range(FRAMES):
        solo_outs += [o for _, o in split_results(solo.submit("x", frames["a"][t]) + solo.flush())]
        res = mixed.submit("x", frames["a"][t]) + mixed.submit("y", frames["b"][t]) + mixed.flush()
        mixed_outs += [o for sid, o in split_results(res) if sid == "x"]
    padding_diff = max(max((s[k].float() - m[k].float()).abs().max().item()
                           for k in ("boxes", "class_scores"))
                       for s, m in zip(solo_outs, mixed_outs))
    record = {"gaps": gaps, "pad_fraction_solo": solo.stats()["pad_fraction"],
              "padding_max_diff": padding_diff}
    log("9b-server-checks", ok=True, **record)
    return record


def serving_phase(torch):
    """Phase 9: serving at full width. Returns (records, launches by kernel
    and sub-phase)."""
    from future_od_tpu_torch.models.build import build_flagship
    from future_od_tpu_torch.models.st_detr import SpatioTemporalDETRArgs
    from future_od_tpu_torch.ops import _kernels

    args = SpatioTemporalDETRArgs(num_classes=8, num_queries=128)
    model = build_flagship(args, generator=torch.Generator().manual_seed(0))
    randomize_heads_(torch, model._model.detector, torch.Generator().manual_seed(1))
    t0 = time.perf_counter()
    stream = make_stream(10, SERVE_STREAMS, SERVE_STREAM_FRAMES)
    stream_s = time.perf_counter() - t0
    records = {"stream_s": stream_s}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    runs = (("f32 default", {}, {"flash_attention": 6}),
            ("f32 fused", FUSED_GATES, FUSED_LAUNCHES))
    records["9a"] = session_phase(torch, model, stream, runs)
    set_gates()
    records["9a"]["throughput f32 default"] = session_throughput(torch, model, stream)
    records["9a"]["h2d_ms"] = {"one frame batch": h2d_ms(torch, frame_of(stream, 0)["video"]),
                               "a clip batch (3 frames)": h2d_ms(torch, clip_of(stream, 1)["video"])}
    records["9a"]["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    records["9a"]["seconds"] = time.perf_counter() - t0
    log("9a-session-f32", ok=True, card=gpu_name_and_power(),
        **{k: v for k, v in records["9a"].items() if k not in ("f32 default", "f32 fused")})

    t0 = time.perf_counter()
    records["9c"] = export_phase(torch, model, stream)
    records["9c"]["seconds"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    model.to(torch.bfloat16)
    set_gates(**FUSED_GATES)
    _kernels.reset_launch_counts()
    records["9a"]["throughput bf16 fused"] = session_throughput(torch, model, stream)
    records["9a"]["bf16_seconds"] = time.perf_counter() - t0
    log("9a-session-bf16-fused", ok=True, card=gpu_name_and_power(),
        **records["9a"]["throughput bf16 fused"])
    set_gates()
    del model
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    records["9b"], script_k1 = serve_script_phase(torch)
    model = build_flagship(args, generator=torch.Generator().manual_seed(0))
    randomize_heads_(torch, model._model.detector, torch.Generator().manual_seed(1))
    records["9b"]["server checks"] = server_checks(torch, model)
    records["9b"]["seconds"] = time.perf_counter() - t0
    del model, stream
    torch.cuda.empty_cache()

    session_launches = {k: 0 for k in MAIN_KERNELS}
    for rec in (records["9a"]["f32 default"], records["9a"]["f32 fused"]):
        for k, n in rec["encode_launches"].items():
            session_launches[k] += n * rec["encodes"]
    artifact_launches = {k: 0 for k in MAIN_KERNELS}
    for label in ("default", "fused"):
        for k, n in records["9c"][label]["launches"].items():
            artifact_launches[k] += n
    for k, n in records["9c"]["streaming fused"]["encode_launches"].items():
        artifact_launches[k] += n
    launches = {name: {"9a session": session_launches[name],
                       "9b serve script": script_k1 if name == "flash_attention" else 0,
                       "9c artifacts": artifact_launches[name]} for name in MAIN_KERNELS[:3]}
    return records, launches


# ---------------------------------------------------------------------------
# Phase 10: data parallelism over torch.distributed ranks and device meshes.


def torchrun(torch, nproc: int, role: str, out: str, timeout_s: float) -> list:
    """Run this file's `role` in `nproc` ranks under `python -m
    torch.distributed.run --standalone` (a rendezvous on this host), each
    writing <out>/rank<r>.json; the ranks' output goes to <out>/<role>.log.
    Returns the ranks' records; raises with the log's tail if a rank failed
    or the run outlived `timeout_s` (every process of the run is killed)."""
    import shutil
    import signal

    shutil.rmtree(out, ignore_errors=True)  # no checkpoint of an earlier run to resume
    os.makedirs(out)
    log_path = os.path.join(out, f"{role.strip('-')}.log")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", str(nproc), os.path.abspath(__file__), role, out]
    with open(log_path, "w") as log_file:
        proc = subprocess.Popen(cmd, cwd=os.path.dirname(os.path.abspath(__file__)),
                                stdout=log_file, stderr=subprocess.STDOUT,
                                start_new_session=True)
        try:
            rc = proc.wait(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            rc = None
        finally:
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            proc.wait()
    with open(log_path) as f:
        tail = f.read()[-6000:]
    if rc != 0:
        raise AssertionError(f"torchrun {role} x{nproc}: "
                             f"{'timed out' if rc is None else f'exit {rc}'}:\n{tail}")
    records = []
    for r in range(nproc):
        with open(os.path.join(out, f"rank{r}.json")) as f:
            records.append(json.load(f))
    return records


def write_rank_record(out: str, rank: int, record: dict) -> None:
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(record, f)


def dist_model(torch, args, dropout: float = 0.0):
    """Phase 5's full-width flagship (seed 0, heads randomized by seed 1) on
    this rank's card, at `dropout`."""
    from future_od_tpu_torch.models.build import build_flagship

    model = build_flagship(args, generator=torch.Generator().manual_seed(0))
    randomize_heads_(torch, model._model.detector, torch.Generator().manual_seed(1))
    set_dropout(torch, model, dropout)
    return model


def dist_step_grads(torch, args, data, mesh=None):
    """One f32 train step at dropout 0 of `dist_model` on `data` (this
    rank's rows under `mesh`), without the clip: (loss, {name: gradient on
    the host}, the launches, the step, the model)."""
    from future_od_tpu_torch.ops import _kernels
    from future_od_tpu_torch.train.optimizer import build_optimizer
    from future_od_tpu_torch.train.step import make_train_step

    model = dist_model(torch, args)
    optimizer = build_optimizer(model, args.lr, args.lr_backbone, max_norm=0.0)
    step = make_train_step(model, args.criterion_config(), optimizer, mesh=mesh)
    _kernels.reset_launch_counts()
    loss, _, _, _ = step(data, 0)
    torch.cuda.synchronize()
    launches = launched(_kernels)
    grads = {n: p.grad.detach().cpu() for n, p in model.named_parameters() if p.grad is not None}
    return loss.item(), grads, launches, step, model


def check_dist_grads(what: str, loss, grads, ref_loss, ref_grads, grad_rtol=None) -> dict:
    """The loss and the gradients of a data-parallel step against one
    process's on the same global batch and weights, within DIST_LOSS_RTOL
    and `grad_rtol` (default DIST_GRAD_RTOL)."""
    grad_rtol = grad_rtol or DIST_GRAD_RTOL
    if set(grads) != set(ref_grads):
        raise AssertionError(f"{what}: gradients of {sorted(set(grads) ^ set(ref_grads))[:5]} "
                             "on one side only")
    loss_gap = abs(loss - ref_loss) / abs(ref_loss)
    group_gap = grad_gap_by_group(grads, ref_grads)
    record = {"loss": [loss, ref_loss], "loss_gap": loss_gap, "loss_rtol": DIST_LOSS_RTOL,
              "grad_gap_by_group": group_gap, "grad_rtol": grad_rtol,
              "grad_gap_per_parameter": worst_per_group(gradient_gaps(grads, ref_grads))}
    if loss_gap > DIST_LOSS_RTOL or any(v > grad_rtol[k] for k, v in group_gap.items()):
        raise AssertionError(f"{what}: {record}")
    return record


def allreduce_profile(torch, step, data) -> dict:
    """One more data-parallel train step under torch.profiler: the events
    of the all-reduce (the op, gloo's or NCCL's work, NCCL's kernel) with
    their host and device ms."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(data, 0)
        torch.cuda.synchronize()
    events = {}
    for e in prof.key_averages():
        if "allreduce" in e.key.lower().replace("_", ""):
            device_us = getattr(e, "device_time_total", None)
            if device_us is None:
                device_us = getattr(e, "cuda_time_total", 0.0)
            events[e.key] = {"calls": e.count, "host_ms": e.cpu_time_total / 1e3,
                             "device_ms": device_us / 1e3}
    return events


def eval_forwards(loader, rank: int) -> int:
    """The eval batches of a sharded loader in which `rank` has rows: a
    batch of n rows gives ranks 0..n-1 a row at least (`split_rows`)."""
    n, size = len(loader.dataset), loader.batch_size
    rows = [size] * (n // size) + ([n % size] if n % size else [])
    return sum(1 for r in rows if r > rank)


def dist_train_rank(torch, out: str) -> dict:
    """Phase 10a in one rank: the flagship's script at stage 1 (one epoch:
    the audit, 2 train steps of the global batch of 32, 8 eval batches),
    its checkpoint resumed, the eval of the checkpoint at stage 2's size
    beside one process's (rank 0), and one step's reduced gradients at
    dropout 0 beside one process's (rank 0)."""
    import importlib

    import torch.distributed as dist

    from future_od_tpu_torch.data.loader import ARRAY_KEYS
    from future_od_tpu_torch.models.st_detr import SpatioTemporalDETRArgs
    from future_od_tpu_torch.ops import _kernels
    from future_od_tpu_torch.parallel import distributed
    from future_od_tpu_torch.parallel.mesh import make_mesh
    from future_od_tpu_torch.runs import _helper
    from future_od_tpu_torch.runs._loader import get_nusc_loaders
    from future_od_tpu_torch.runs._model import build_model
    from future_od_tpu_torch.runs.config import config
    from future_od_tpu_torch.train import trainer as trainer_module

    t_start = time.perf_counter()
    if not distributed.maybe_initialize_distributed():
        raise AssertionError("10a: no process group (not started by torchrun?)")
    rank, world = distributed.rank(), distributed.world_size()
    record = {"rank": rank, "world": world, "backend": dist.get_backend(),
              "device": str(distributed.local_device()), "cards": torch.cuda.device_count()}
    _kernels.build_all()

    # the script, one epoch at stage 1: its --epochs 1 gives stage 1 no
    # epoch, so stage 2 runs at stage 1's size
    script = importlib.import_module(TRAINER_SCRIPT)
    set_gates(**TRAINER_GATES)
    stages, saved_config = _helper.STAGES, dict(config)
    config.update(checkpoint_path=os.path.join(out, "checkpoints"),
                  visualization_path=os.path.join(out, "visualization"))
    _helper.STAGES = (stages[0], stages[0])
    step_ms, factory = [], trainer_module.make_train_step

    def timed_factory(*a, **k):
        step = factory(*a, **k)

        def timed(*args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            result = step(*args)
            torch.cuda.synchronize()
            step_ms.append(1e3 * (time.perf_counter() - t0))
            return result
        timed.steps = step.steps
        return timed
    trainer_module.make_train_step = timed_factory
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launch_counts()
    try:
        t0 = time.perf_counter()
        trainer = script.main(DIST_ARGV)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
    finally:
        trainer_module.make_train_step = factory
        _helper.STAGES = stages
    script_launches = launched(_kernels)
    want = {k: 2 * v + v for k, v in TRAINER_LAUNCHES[("train", 448)].items()}  # 2 steps + audit
    forwards = eval_forwards(trainer._val_loaders["val0"], rank)
    want.update({k: forwards * v for k, v in TRAINER_LAUNCHES[("eval", 448)].items() if forwards})
    if script_launches != want or len(step_ms) != 2:
        raise AssertionError(f"10a rank {rank}: the script launched {script_launches} in "
                             f"{len(step_ms)} train steps, want {want} in 2")
    check_ap(trainer._ap_by_mode["val0"], trainer._args.num_classes)
    idf = TRAINER_SCRIPT.rsplit(".", 1)[1]
    names = sorted(os.listdir(config["checkpoint_path"]))
    if names != [idf, idf + "_final"]:
        raise AssertionError(f"10a rank {rank}: checkpoints written: {names}")
    record["script"] = {"argv": DIST_ARGV, "run_s": run_s, "train_step_ms": step_ms,
                        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                        "launches": script_launches,
                        "train_rows": trainer._train_loader.batch_size // world,
                        "losses": trainer._stats["train labels loss"].history}

    # a fresh Trainer through the script's get_trainer resumes the checkpoint
    args = script.build_parser().parse_args(DIST_ARGV)
    args.experiment_idf = idf
    fresh = _helper.get_trainer(args, config, trainer._args, _helper.get_lr_func(1),
                                build_model(args, trainer._args), trainer._train_loader,
                                trainer._val_loaders)
    differ = equal_trees(torch, *({"net": t._model.state_dict(),
                                   "optimizer": t._optimizer.state_dict(),
                                   "epoch": t._epoch, "step": t.step,
                                   "stats": {k: m.state_dict() for k, m in t._stats.items()}}
                                  for t in (fresh, trainer)))
    if differ:
        raise AssertionError(f"10a rank {rank}: the resumed Trainer differs at {differ[:5]}")
    del fresh
    record["resumed"] = "bit-equal"

    # the checkpoint's eval at stage 2's size (1400 tokens: K1 launches),
    # over the ranks, then in one process on rank 0
    (size2, batch2) = stages[1]
    _, val = get_nusc_loaders(size2, offsets=script.OFFSETS, config=config, args=args,
                              train_batch_size=batch2)
    trainer._val_loaders = val
    _kernels.reset_launch_counts()
    t0 = time.perf_counter()
    trainer.eval()
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    eval_launches = launched(_kernels)
    forwards = eval_forwards(val["val0"], rank)
    want = {k: forwards * v for k, v in TRAINER_LAUNCHES[("eval", 896)].items() if forwards}
    if eval_launches != want:
        raise AssertionError(f"10a rank {rank}: the stage-2 eval launched {eval_launches}, "
                             f"want {want}")
    ap = trainer._ap_by_mode["val0"]
    record["eval"] = {"size": list(size2), "seconds": eval_s, "launches": eval_launches,
                      "forwards": forwards}
    del trainer
    torch.cuda.empty_cache()
    if rank == 0:
        _, single_val = get_nusc_loaders(size2, offsets=script.OFFSETS, config=config,
                                         args=args, train_batch_size=batch2)
        single_val["val0"].shard = None  # every row, in this process
        single_args = SpatioTemporalDETRArgs(num_classes=8, num_queries=128, lr_backbone=1e-4)
        single = trainer_module.Trainer(
            model=build_model(args, single_args), detr_args=single_args, train_loader=None,
            val_loaders=single_val,
            checkpoint_path=config["checkpoint_path"],
            visualization_path=os.path.join(out, "single"), save_name=idf,
            category_dict=_helper.category_dict_for(single_val["val0"]))
        single.load_checkpoint()
        single.eval()
        ref = single._ap_by_mode["val0"]
        gaps = {k: float(np.nanmax(np.abs(ap[k] - ref[k]), initial=0.0)) for k in ap}
        if any(not np.array_equal(np.isnan(ap[k]), np.isnan(ref[k])) for k in ap) or max(
                gaps.values()) > DIST_AP_ATOL:
            raise AssertionError(f"10a: the 2-rank eval's AP differs from one process's: {gaps}")
        record["eval"]["ap_gap_vs_one_process"] = gaps
        record["eval"]["ap_atol"] = DIST_AP_ATOL
        del single
        torch.cuda.empty_cache()
    distributed.barrier()
    config.clear()
    config.update(saved_config)

    # one step at dropout 0: the reduced gradients beside one process's on
    # the same global batch and weights
    args = SpatioTemporalDETRArgs(num_classes=8, num_queries=128, lr_backbone=1e-4,
                                  freeze_stem=True, matcher="auction", cost_slots=128)
    data = make_train_batch(seed=0, batch=DIST_BATCH)
    rows = slice(rank * DIST_BATCH // world, (rank + 1) * DIST_BATCH // world)
    local = {k: v[rows] for k, v in data.items() if k in ARRAY_KEYS}
    set_gates(FUTURE_OD_TRAIN_FLASH="1")
    mesh = make_mesh()
    torch.cuda.reset_peak_memory_stats()
    loss, grads, launches, step, model = dist_step_grads(torch, args, local, mesh)
    if launches != {name: 18 for name in TRAIN_KERNELS}:
        raise AssertionError(f"10a rank {rank}: a dropout-0 step launched {launches}")
    timed = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(local, 0)
        torch.cuda.synchronize()
        timed.append(1e3 * (time.perf_counter() - t0))
    flat = [p.grad for p in model.parameters() if p.grad is not None]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    distributed.all_reduce_sum_(flat)
    torch.cuda.synchronize()
    allreduce_ms = 1e3 * (time.perf_counter() - t0)
    record["step"] = {
        "rows": DIST_BATCH // world, "step_ms": timed, "launches": launches,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "allreduce_ms": allreduce_ms, "allreduce_elements": sum(g.numel() for g in flat),
        "allreduce_profile": allreduce_profile(torch, step, local)}
    del step, model, flat
    torch.cuda.empty_cache()
    distributed.barrier()
    if rank == 0:
        ref_loss, ref_grads, _, _, _ = dist_step_grads(torch, args, data)
        record["step"]["vs_one_process"] = check_dist_grads(
            "10a: the 2-rank step against one process", loss, grads, ref_loss, ref_grads)
        torch.cuda.empty_cache()
    distributed.barrier()
    record["seconds"] = time.perf_counter() - t_start
    return record


def tp_step(torch, args, data, dropout: float, mesh=None):
    """One f32 train step of `dist_model` at `dropout` on `data`, seed 0,
    without the clip, the model cut over the model axis of `mesh` (or not):
    (loss, {name: its full gradient on the host}, the launches, the step,
    the model, its peak GB)."""
    from future_od_tpu_torch.ops import _kernels
    from future_od_tpu_torch.parallel.mesh import gather_state_dict, shard_model
    from future_od_tpu_torch.train.optimizer import build_optimizer
    from future_od_tpu_torch.train.step import make_train_step

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = dist_model(torch, args, dropout)
    if mesh is not None:
        shard_model(model, mesh)
    optimizer = build_optimizer(model, args.lr, args.lr_backbone, max_norm=0.0)
    step = make_train_step(model, args.criterion_config(), optimizer, mesh=mesh)
    _kernels.reset_launch_counts()
    loss, _, _, _ = step(data, 0)
    torch.cuda.synchronize()
    launches = launched(_kernels)
    peak = torch.cuda.max_memory_allocated() / 1e9
    grads = gather_state_dict(model, {n: p.grad for n, p in model.named_parameters()
                                      if p.grad is not None})
    return (loss.item(), {n: g.detach().cpu() for n, g in grads.items()}, launches, step,
            model, peak)


@contextlib.contextmanager
def solver_tap(name: str, forced=None):
    """Each solve of the matcher `name` appended, on the host, to the list
    it yields; with `forced` (such a list), its indices returned in place
    of the solve's, call for call, so the step trains on that assignment."""
    from future_od_tpu_torch.ops.matching import SOLVERS

    solve = SOLVERS[name]
    solved = []

    def tapped(costs, active, **kwargs):
        out = solve(costs, active, **kwargs)
        idx, rest = (out[0], out[1:]) if isinstance(out, tuple) else (out, None)
        solved.append(idx.cpu())
        if forced is not None:
            idx = forced[len(solved) - 1].to(idx.device)
        return idx if rest is None else (idx, *rest)

    SOLVERS[name] = tapped
    try:
        yield solved
    finally:
        SOLVERS[name] = solve


def assignment_digest(solved) -> str:
    import hashlib

    return hashlib.sha256(b"".join(idx.numpy().tobytes() for idx in solved)).hexdigest()


@contextlib.contextmanager
def planted_copy_fault(distributed):
    """Megatron's f without its backward sum: each rank keeps its own share
    of the gradient of a column-parallel projection's input."""
    backward = distributed._CopyToModel.backward
    distributed._CopyToModel.backward = staticmethod(lambda ctx, grad: (grad, None))
    try:
        yield
    finally:
        distributed._CopyToModel.backward = backward


def local_heads(model) -> int:
    """The heads of the encoder's first self-attention this rank holds."""
    attn = model._model.separate_encoder.transformer.layers[0].self_attn.attn
    return attn.in_proj_weight.shape[0] // (3 * (attn.dim // attn.num_heads))


def tp_train_rank(torch, out: str) -> dict:
    """Phase 10d in one rank of a (1, 2) mesh: the flagship cut over the
    model axis, one step at dropout 0 and one at TP_DROPOUT against one
    process's (rank 0), two more steps timed with the sums over the model
    group counted, then a stage-2 eval (K1) against one process's."""
    import torch.distributed as dist

    from future_od_tpu_torch.data.loader import ARRAY_KEYS
    from future_od_tpu_torch.models.st_detr import SpatioTemporalDETRArgs
    from future_od_tpu_torch.ops import _kernels
    from future_od_tpu_torch.parallel import distributed
    from future_od_tpu_torch.parallel.mesh import make_mesh, shard_model
    from future_od_tpu_torch.runs import _helper
    from future_od_tpu_torch.train.step import make_eval_step

    t_start = time.perf_counter()
    if not distributed.maybe_initialize_distributed():
        raise AssertionError("10d: no process group (not started by torchrun?)")
    rank = distributed.rank()
    _kernels.build_all()
    mesh = make_mesh(1, TP_RANKS)
    record = {"rank": rank, "backend": dist.get_backend(), "cards": torch.cuda.device_count(),
              "mesh": [mesh.shape, mesh.rank, mesh.model_rank], "batch": TP_BATCH}
    args = SpatioTemporalDETRArgs(num_classes=8, num_queries=128, lr_backbone=1e-4,
                                  freeze_stem=True, matcher="auction", cost_slots=128)
    data = {k: v for k, v in make_train_batch(seed=0, batch=TP_BATCH).items() if k in ARRAY_KEYS}
    set_gates(FUTURE_OD_TRAIN_FLASH="1")
    for rate in (0.0, TP_DROPOUT):
        label = f"dropout {rate}"
        with solver_tap(args.matcher) as solved:
            loss, grads, launches, step, model, peak = tp_step(torch, args, data, rate, mesh)
        if launches != TP_STEP_LAUNCHES:
            raise AssertionError(f"10d rank {rank} {label}: a step launched {launches}")
        timed, reduces = [], []
        for _ in range(2):
            distributed.MODEL_REDUCES.update(count=0, bytes=0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(data, 0)
            torch.cuda.synchronize()
            timed.append(1e3 * (time.perf_counter() - t0))
            reduces.append(dict(distributed.MODEL_REDUCES))
        record[label] = {"loss": loss, "launches": launches, "step_ms": timed,
                         "model_reduces_a_step": {"count": reduces[-1]["count"],
                                                  "mb": reduces[-1]["bytes"] / 1e6},
                         "peak_mem_gb": peak, "local_heads": local_heads(model),
                         "assignment_sha256": assignment_digest(solved)}
        del step, model
        distributed.barrier()
        if rank == 0:
            with solver_tap(args.matcher, forced=solved) as own:
                ref_loss, ref_grads, ref_launches, ref_step, _, ref_peak = tp_step(
                    torch, args, data, rate)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ref_step(data, 0)
            torch.cuda.synchronize()
            ref_ms = 1e3 * (time.perf_counter() - t0)
            del ref_step
            record[label]["one_process"] = {
                "step_ms": ref_ms, "peak_mem_gb": ref_peak, "launches": ref_launches,
                "own_assignment_slots_differing": sum(
                    int((a != b).sum()) for a, b in zip(own, solved)),
                "vs": check_dist_grads(f"10d: the (1, 2) step at {label} against one process",
                                       loss, grads, ref_loss, ref_grads, TP_GRAD_RTOL)}
        if rate == 0.0:  # the bounds catch a fault of the cut
            with planted_copy_fault(distributed), solver_tap(args.matcher, forced=solved):
                _, bad_grads, _, _, _, _ = tp_step(torch, args, data, rate, mesh)
            if rank == 0:
                gaps = grad_gap_by_group(bad_grads, ref_grads)
                record[label]["planted_fault_grad_gap"] = gaps
                if not any(v > TP_GRAD_RTOL[k] for k, v in gaps.items()):
                    raise AssertionError(f"10d: a step without copy_to_model's backward sum "
                                         f"is within TP_GRAD_RTOL: {gaps}")
            del bad_grads
        del grads
        torch.cuda.empty_cache()
        distributed.barrier()

    # the eval at stage 2's size: K1 on the rank's 4 heads
    (size2, _) = _helper.STAGES[1]
    batch = {k: v for k, v in make_train_batch(seed=3, batch=TP_EVAL_BATCH, size=size2).items()
             if k in ARRAY_KEYS}
    set_gates()
    model = shard_model(dist_model(torch, args), mesh)
    _kernels.reset_launch_counts()
    loss, _, _, output = make_eval_step(model, args.criterion_config(), mesh=mesh)(batch)
    torch.cuda.synchronize()
    record["eval"] = {"size": list(size2), "clips": TP_EVAL_BATCH, "loss": loss.item(),
                      "launches": launched(_kernels)}
    if record["eval"]["launches"] != TP_EVAL_LAUNCHES:
        raise AssertionError(f"10d rank {rank}: the stage-2 eval launched "
                             f"{record['eval']['launches']}, want {TP_EVAL_LAUNCHES}")
    output = {k: v.float() for k, v in output.items() if k in ("class_scores", "boxes")}
    del model
    torch.cuda.empty_cache()
    distributed.barrier()
    if rank == 0:
        ref_loss, _, _, ref_output = make_eval_step(
            dist_model(torch, args).eval(), args.criterion_config())(batch)
        gaps = serve_gaps(torch, output, ref_output)
        check_serve_gaps("10d: the (1, 2) eval against one process", gaps)
        record["eval"]["vs_one_process"] = {
            **gaps, "loss_gap": abs(loss.item() - ref_loss.item()) / abs(ref_loss.item()),
            "tolerances": {"score_err": SCORE_TOL, "box_err_px": BOX_TOL_PX}}
        torch.cuda.empty_cache()
    distributed.barrier()
    set_gates()
    record["seconds"] = time.perf_counter() - t_start
    return record


def dist_nccl_rank(torch, out: str) -> dict:
    """Phase 10b in one rank of one: the NCCL init, an all-reduce of a CUDA
    tensor, and a train step through the mesh of this one rank beside the
    same step without a mesh (phase 5's batch of 4 at dropout 0)."""
    import torch.distributed as dist

    from future_od_tpu_torch.models.st_detr import SpatioTemporalDETRArgs
    from future_od_tpu_torch.ops import _kernels
    from future_od_tpu_torch.parallel import distributed
    from future_od_tpu_torch.parallel.mesh import make_mesh

    t_start = time.perf_counter()
    if not distributed.maybe_initialize_distributed():
        raise AssertionError("10b: no process group (not started by torchrun?)")
    backend = dist.get_backend()
    if backend != "nccl":
        raise AssertionError(f"10b: one rank on one card chose {backend}, want nccl")
    _kernels.build_all()
    t = torch.full((4,), 2.0, device=distributed.local_device())
    dist.all_reduce(t)
    if t.tolist() != [2.0] * 4:
        raise AssertionError(f"10b: an all-reduce over one rank gave {t.tolist()}")
    args = SpatioTemporalDETRArgs(num_classes=8, num_queries=128, lr_backbone=1e-4,
                                  freeze_stem=True, matcher="auction", cost_slots=128)
    data = make_train_batch(seed=0)
    set_gates(FUTURE_OD_TRAIN_FLASH="1")
    mesh = make_mesh()
    loss, grads, launches, _, _ = dist_step_grads(torch, args, data, mesh)
    torch.cuda.empty_cache()
    ref_loss, ref_grads, _, _, _ = dist_step_grads(torch, args, data)
    record = {"backend": backend, "mesh": mesh.shape, "launches": launches,
              "vs_no_mesh": check_dist_grads("10b: the 1-rank mesh step against no mesh", loss,
                                             grads, ref_loss, ref_grads)}
    distributed.barrier()
    record["seconds"] = time.perf_counter() - t_start
    return record


def serving_mesh_phase(torch, phase9_records) -> tuple:
    """Phase 10c: the session and the server over a mesh of two devices
    (both cards, or the one card listed twice) at phase 9's sizes, fused
    gates, against the unsharded session and server within phase 3's
    tolerances; clips/s beside the unsharded ones. Returns (record,
    launches by kernel)."""
    from future_od_tpu_torch.models.st_detr import SpatioTemporalDETRArgs
    from future_od_tpu_torch.ops import _kernels
    from future_od_tpu_torch.parallel.mesh import batch_sharding, make_mesh
    from future_od_tpu_torch.serve import MultiStreamServer, StreamingSession
    from future_od_tpu_torch.serve.server import split_results

    cards = torch.cuda.device_count()
    devices = [torch.device("cuda", i % cards) for i in range(2)]
    mesh = make_mesh(2, 1, devices=devices)
    model = dist_model(torch, SpatioTemporalDETRArgs(num_classes=8, num_queries=128)).eval()
    stream = make_stream(10, SERVE_STREAMS, SERVE_STREAM_FRAMES)
    frames = [frame_of(stream, t) for t in range(SERVE_STREAM_FRAMES)]
    set_gates(**FUSED_GATES)
    record = {"mesh": [str(d) for d in devices]}
    launches = {k: 0 for k in MAIN_KERNELS}

    def count():
        for k, n in _kernels.launch_counts.items():
            if k in launches:
                launches[k] += n
        _kernels.reset_launch_counts()

    # the session: 12 lockstep streams, 6 a device
    _kernels.reset_launch_counts()
    outs = {}
    for label, kw in (("sharded", {"input_sharding": batch_sharding(mesh)}), ("unsharded", {})):
        session = StreamingSession(model, clip_frames=FRAMES, **kw)
        outs[label] = [session.step(f) for f in frames]
        torch.cuda.synchronize()
        if label == "sharded":
            count()
        _kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for f in frames:
            session.step(f)
        torch.cuda.synchronize()
        record[f"session_{label}_clips_per_s"] = (
            SERVE_STREAMS * len(frames) / (time.perf_counter() - t0))
        if label == "sharded":
            count()
        _kernels.reset_launch_counts()
        del session
    gaps = [serve_gaps(torch, s, u) for s, u in zip(outs["sharded"], outs["unsharded"])
            if u is not None]
    for i, g in enumerate(gaps):
        check_serve_gaps(f"10c sharded session, clip {i}", g)
    record["session_gaps"] = gaps

    # the server: 12 streams, max_batch 12 (6 rows a device), the same schedule
    def serve(server):
        got = {}
        t0 = time.perf_counter()
        for t in range(SERVE_STREAM_FRAMES):
            for sid in range(SERVE_STREAMS):
                res = server.submit(sid, {k: v[sid] for k, v in frames[t].items()})
                for rsid, out in split_results(res):
                    got.setdefault(rsid, []).append(out)
        for rsid, out in split_results(server.flush()):
            got.setdefault(rsid, []).append(out)
        torch.cuda.synchronize()
        return got, time.perf_counter() - t0

    _kernels.reset_launch_counts()
    sharded, sharded_s = serve(MultiStreamServer(model, max_batch=SERVE_STREAMS,
                                                 clip_frames=FRAMES, max_streams=24, mesh=mesh))
    count()
    unsharded, unsharded_s = serve(MultiStreamServer(model, max_batch=SERVE_STREAMS,
                                                     clip_frames=FRAMES, max_streams=24))
    _kernels.reset_launch_counts()
    server_gaps = []
    for sid in range(SERVE_STREAMS):
        if not len(sharded[sid]) == len(unsharded[sid]) == SERVE_STREAM_FRAMES - 1:
            raise AssertionError(f"10c server: stream {sid} gave {len(sharded[sid])} clips")
        for s, u in zip(sharded[sid], unsharded[sid]):
            server_gaps.append(serve_gaps(torch, s, u))
            check_serve_gaps(f"10c sharded server, stream {sid}", server_gaps[-1])
    clips = SERVE_STREAMS * (SERVE_STREAM_FRAMES - 1)
    record.update(server_worst_gap={k: max(g[k] for g in server_gaps) for k in server_gaps[0]},
                  server_sharded_clips_per_s=clips / sharded_s,
                  server_unsharded_clips_per_s=clips / unsharded_s,
                  server_clips_per_s_includes="the first dispatch's warm-up",
                  phase9_session_f32_default_clips_per_s=phase9_records["9a"][
                      "throughput f32 default"]["session_clips_per_s"],
                  tolerances={"score_err": SCORE_TOL, "box_err_px": BOX_TOL_PX})
    set_gates()
    del model
    torch.cuda.empty_cache()
    return record, launches


def distributed_phase(torch, phase9_records) -> tuple:
    """Phase 10: 10a two ranks train under torchrun, 10b one rank over NCCL,
    10c serving over a mesh, 10d two ranks train the flagship cut over a
    model axis. Returns (records, launches by kernel and sub-phase)."""
    out = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "phase10")
    torch.cuda.empty_cache()
    records = {}
    t0 = time.perf_counter()
    ranks = torchrun(torch, DIST_RANKS, "--phase10a-rank", os.path.join(out, "10a"),
                     DIST_TIMEOUT_S)
    backend = {r["backend"] for r in ranks}
    shared = torch.cuda.device_count() < DIST_RANKS
    want = "gloo" if shared else "nccl"
    if backend != {want}:
        raise AssertionError(f"10a: backends {backend}, want {want}")
    records["10a"] = {"backend": want, "cards": torch.cuda.device_count(),
                      "how": ("both ranks share the one card over gloo" if shared
                              else "NCCL, one card a rank"),
                      "seconds": time.perf_counter() - t0, "ranks": ranks}
    log("10a-two-ranks-train", ok=True, card=gpu_name_and_power(), **records["10a"])
    t0 = time.perf_counter()
    (rank,) = torchrun(torch, 1, "--phase10b-rank", os.path.join(out, "10b"), DIST_TIMEOUT_S)
    records["10b"] = dict(rank, seconds=time.perf_counter() - t0)
    log("10b-one-rank-nccl", ok=True, card=gpu_name_and_power(), **records["10b"])
    t0 = time.perf_counter()
    records["10c"], serve_launches = serving_mesh_phase(torch, phase9_records)
    records["10c"]["seconds"] = time.perf_counter() - t0
    log("10c-serving-mesh", ok=True, card=gpu_name_and_power(), **records["10c"])
    t0 = time.perf_counter()
    tp_ranks = torchrun(torch, TP_RANKS, "--phase10d-rank", os.path.join(out, "10d"),
                        TP_TIMEOUT_S)
    records["10d"] = {"how": ("both ranks share the one card over gloo" if shared
                              else "one card a rank"),
                      "seconds": time.perf_counter() - t0, "ranks": tp_ranks}
    log("10d-tensor-parallel", ok=True, card=gpu_name_and_power(), **records["10d"])
    launches = {}
    for name in MAIN_KERNELS:
        launches[name] = {
            **{f"10a rank {r['rank']}": r["script"]["launches"].get(name, 0)
               + r["eval"]["launches"].get(name, 0) + r["step"]["launches"].get(name, 0)
               for r in ranks},
            "10b": records["10b"]["launches"].get(name, 0), "10c": serve_launches[name],
            **{f"10d rank {r['rank']}": sum(r[f"dropout {rate}"]["launches"].get(name, 0)
                                            for rate in (0.0, TP_DROPOUT))
               + r["eval"]["launches"].get(name, 0) for r in tp_ranks}}
    for r in ranks:  # K1 on every rank with rows in the stage-2 eval (2 ranks: both)
        for name in TRAIN_KERNELS + (("flash_attention",) if r["eval"]["forwards"] else ()):
            if not launches[name][f"10a rank {r['rank']}"]:
                raise AssertionError(f"10a: {name} never launched on rank {r['rank']}")
    for rate in (0.0, TP_DROPOUT):  # the replicated matcher agrees across the model group
        if len({r[f"dropout {rate}"]["assignment_sha256"] for r in tp_ranks}) != 1:
            raise AssertionError(f"10d: the ranks' assignments differ at dropout {rate}")
    for r in tp_ranks:  # K4-K6 in the steps and K1 in the eval, on both ranks
        for name in TRAIN_KERNELS + ("flash_attention",):
            if not launches[name][f"10d rank {r['rank']}"]:
                raise AssertionError(f"10d: {name} never launched on rank {r['rank']}")
    return records, launches


def rank_main(role: str, out: str) -> int:
    """A rank of phase 10 (started by `torchrun`): runs its role, writes
    its record."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fn = {"--phase10a-rank": dist_train_rank, "--phase10b-rank": dist_nccl_rank,
          "--phase10d-rank": tp_train_rank}[role]
    record = fn(torch, out)
    write_rank_record(out, record.get("rank", 0), record)
    from future_od_tpu_torch.parallel import distributed

    distributed.destroy()
    return 0


# ---------------------------------------------------------------------------
# Phase 11: the int8 PTQ backbone (ops/quant.py) on K8 (csrc/int8_conv.cu).


def int8_trunk_convs(body, H: int, W: int, frames: int):
    """Every convolution of the trunk `body` (a ResNet) on `frames` images
    of H x W, in order: its geometry as K8 takes it."""
    convs = []

    def add(name, h, w, conv, stride, pad, dil, pad_value=-128):
        convs.append({"name": name, "B": frames, "H": h, "W": w, "Cin": conv.in_channels,
                      "Cout": conv.out_channels, "kernel": tuple(conv.kernel_size),
                      "stride": (stride, stride), "padding": pad,
                      "dilation": (dil, dil), "pad_value": pad_value})

    if body.space_to_depth:
        add("stem (s2d 4x4)", H // 2, W // 2, body.conv1, 1, ((2, 1), (2, 1)), 1, 0)
    else:
        add("stem (7x7/2)", H, W, body.conv1, 2, ((3, 3), (3, 3)), 1, 0)
    h, w = H // 4, W // 4
    for s in range(1, body.num_stages + 1):
        for i, blk in enumerate(getattr(body, f"layer{s}")):
            d, st = blk.dilation, blk.stride
            add(f"layer{s}.{i}.conv1", h, w, blk.conv1, 1, ((0, 0), (0, 0)), 1)
            add(f"layer{s}.{i}.conv2", h, w, blk.conv2, st, ((d, d), (d, d)), d)
            h2, w2 = (h - 1) // st + 1, (w - 1) // st + 1
            add(f"layer{s}.{i}.conv3", h2, w2, blk.conv3, 1, ((0, 0), (0, 0)), 1)
            if blk.downsample is not None:
                add(f"layer{s}.{i}.downsample", h, w, blk.downsample[0], st, ((0, 0), (0, 0)), 1)
            h, w = h2, w2
    return convs


def distinct_convs(convs):
    """{geometry key: (the first conv of that geometry, how many share it)}."""
    out = {}
    for c in convs:
        key = (c["H"], c["W"], c["Cin"], c["Cout"], c["kernel"], c["stride"], c["padding"],
               c["dilation"], c["pad_value"])
        out[key] = (out[key][0] if key in out else c, out.get(key, (None, 0))[1] + 1)
    return out


def k8_case(torch, c, seed: int, dev):
    """Random codes, packed weights, zero points (blocks), scales and bias at
    conv geometry c, on dev."""
    from future_od_tpu_torch.ops import int8_conv as k8

    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randint(-128, 128, (c["B"], c["H"], c["W"], c["Cin"]), dtype=torch.int8,
                      device=dev, generator=g)
    wq = torch.randint(-127, 128, c["kernel"] + (c["Cin"], c["Cout"]), dtype=torch.int8,
                       device=dev, generator=g)
    block = c["pad_value"] == -128
    return {"q": q, "wq": wq, "w": k8.pack_int8_weights(wq),
            "zp": k8.zero_point_correction(wq) if block else None,
            "sw": torch.rand(c["Cout"], device=dev, generator=g) * 1e-4,
            "bias": torch.randn(c["Cout"], device=dev, generator=g)}


def k8_phase(torch, dev):
    """Phase 11a: K8 against its plain version at every distinct convolution
    of the flagship's trunk (4 frames at 896x1600, the 7x7 stem and the s2d
    4x4 one), f32 and bf16 out: bit-equal; K8's, the plain version's, a
    yardstick's (cuDNN's bf16 conv of the shape, channels-last) and, on the
    stride-1 1x1s, torch._int_mm's ms (the same int8 product), and the
    bound at the int8 dense peak. Returns (per-shape records, per-forward
    totals)."""
    from future_od_tpu_torch.models.resnet import ResNet
    from future_od_tpu_torch.ops import int8_conv as k8

    F = torch.nn.functional
    frames = BATCH * (FRAMES - 1)
    trunk = int8_trunk_convs(ResNet(), HEIGHT, WIDTH, frames)
    s2d = int8_trunk_convs(ResNet(space_to_depth=True), HEIGHT, WIDTH, frames)[:1]
    shapes = distinct_convs(trunk)
    shapes.update({k: (c, 0) for k, (c, _) in distinct_convs(s2d).items()})
    records, totals = [], {"ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                           "yardstick_ms": 0.0, "int_mm_ms": 0.0, "ms_on_int_mm_convs": 0.0,
                           "int_mm_device_ms": 0.0, "device_ms_on_int_mm_convs": 0.0,
                           "ops": 0, "bytes": 0, "int_mm_convs": 0}
    for i, (c, count) in enumerate(shapes.values()):
        x = k8_case(torch, c, i, dev)
        geometry = (c["stride"], c["padding"], c["dilation"], c["pad_value"], False)

        def kernel(dt, x=x, geometry=geometry):
            return k8.int8_conv_codes(x["q"], x["w"], x["zp"], x["sw"], x["bias"], *geometry, dt)

        def plain(dt, x=x, c=c, geometry=geometry):
            return k8.int8_conv_plain(x["q"], x["w"].wt, x["zp"], x["sw"], x["bias"],
                                      c["kernel"], *geometry, dt)
        errs = {}
        for dt in (torch.float32, torch.bfloat16):
            out, ref = kernel(dt), plain(dt)
            torch.cuda.synchronize()
            if not torch.equal(out, ref):
                raise AssertionError(f"11a K8 {c['name']} {dt}: differs from its plain version "
                                     f"by {(out.float() - ref.float()).abs().max().item()}")
            errs[str(dt).split(".")[1]] = 0.0
            del out, ref
        ms = time_ms(torch, lambda: kernel(torch.float32), INT8_TIME_S)
        device_ms = device_ms_or_none(torch, lambda: kernel(torch.float32))
        plain_ms = time_ms(torch, lambda: plain(torch.float32), INT8_TIME_S)
        pad = c["padding"]  # cuDNN's input padded beforehand, channels-last
        xc = F.pad(x["q"].to(torch.bfloat16).permute(0, 3, 1, 2),
                   (pad[1][0], pad[1][1], pad[0][0], pad[0][1])).contiguous(
                       memory_format=torch.channels_last)
        wc = x["wq"].permute(3, 2, 0, 1).to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last)
        yard_ms = time_ms(torch, lambda: F.conv2d(xc, wc, stride=c["stride"],
                                                  dilation=c["dilation"]), INT8_TIME_S)
        int_mm_ms = int_mm_layouts = int_mm_device_ms = None
        if c["kernel"] == (1, 1) and c["stride"] == (1, 1):
            a = x["q"].reshape(-1, c["Cin"])
            b_row = x["wq"].reshape(c["Cin"], c["Cout"])
            b_col = b_row.t().contiguous().t()  # cuBLASLt's TN layout
            int_mm_layouts = {
                layout: time_ms(torch, lambda b=b: torch._int_mm(a, b), INT8_TIME_S)
                for layout, b in (("row_major", b_row), ("column_major", b_col))}
            int_mm_ms = min(int_mm_layouts.values())
            int_mm_device_ms = device_ms_or_none(torch, lambda: torch._int_mm(a, b_col))
        ops, nbytes = k8.int8_conv_cost(c["B"], c["H"], c["W"], c["Cin"], c["Cout"],
                                        c["kernel"], c["stride"], c["padding"], c["dilation"], 4)
        t_ops, t_bytes = ops / PEAK_INT8, nbytes / PEAK_BYTES
        rec = {"shape": c["name"], "per_forward": count, "B": c["B"], "H": c["H"], "W": c["W"],
               "Cin": c["Cin"], "Cout": c["Cout"], "kernel": list(c["kernel"]),
               "stride": c["stride"][0], "dilation": c["dilation"][0],
               "max_abs_err": errs, "ms": ms, "device_ms": device_ms, "plain_ms": plain_ms,
               "yardstick_cudnn_bf16_ms": yard_ms, "int_mm_ms": int_mm_ms,
               "int_mm_ms_by_b_layout": int_mm_layouts, "int_mm_device_ms": int_mm_device_ms,
               "bound_ms": 1e3 * max(t_ops, t_bytes),
               "bound_by": "operations" if t_ops >= t_bytes else "bytes",
               "ops": ops, "bytes": nbytes, "tops": ops / ms / 1e9}
        records.append(rec)
        for key, value in (("ms", ms), ("plain_ms", plain_ms), ("bound_ms", rec["bound_ms"]),
                           ("yardstick_ms", yard_ms), ("ops", ops), ("bytes", nbytes)):
            totals[key] += count * value
        totals["device_ms"] = add_or_none(totals["device_ms"], device_ms and count * device_ms)
        if int_mm_ms is not None:
            totals["int_mm_ms"] += count * int_mm_ms
            totals["ms_on_int_mm_convs"] += count * ms
            totals["int_mm_device_ms"] = add_or_none(totals["int_mm_device_ms"],
                                                     int_mm_device_ms and count * int_mm_device_ms)
            totals["device_ms_on_int_mm_convs"] = add_or_none(
                totals["device_ms_on_int_mm_convs"], device_ms and count * device_ms)
            totals["int_mm_convs"] += count
        del x, xc, wc
        torch.cuda.empty_cache()
    t_ops, t_bytes = totals["ops"] / PEAK_INT8, totals["bytes"] / PEAK_BYTES
    totals["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
    totals["launches_per_forward"] = sum(r["per_forward"] for r in records)
    if totals["launches_per_forward"] != INT8_LAUNCHES:
        raise AssertionError(f"11a: {totals['launches_per_forward']} trunk convolutions, want "
                             f"{INT8_LAUNCHES}")
    return records, totals


def k9_phase(torch, dev):
    """Phase 11a, K9: at every distinct convolution input of the trunk (4
    frames at 896x1600, both stems; post-ReLU with channels of spread scales
    and a dead one on a block, signed on a stem), f32 and bf16: the range
    (|x|, and x itself) and the quantization (by the dynamic path's m and
    scale from random weights) bit-equal to their plain versions; f32 ms of
    both, of their plain versions and of the range's one-call yardstick
    (`torch.linalg.vector_norm(x, inf, dim=(0, 1, 2))`), and the bytes
    bound. Returns (records, per-forward totals of both entry points)."""
    from future_od_tpu_torch.models.resnet import ResNet
    from future_od_tpu_torch.ops import int8_quantize as k9
    from future_od_tpu_torch.ops.quant import static_smooth_and_scale

    frames = BATCH * (FRAMES - 1)
    inputs = {}
    for convs, counted in ((int8_trunk_convs(ResNet(), HEIGHT, WIDTH, frames), 1),
                           (int8_trunk_convs(ResNet(space_to_depth=True), HEIGHT, WIDTH,
                                             frames)[:1], 0)):
        for c in convs:
            key = (c["B"], c["H"], c["W"], c["Cin"], c["pad_value"] == -128)
            rec = inputs.setdefault(key, {"conv": c, "ranges": 0, "quantizations": 0})
            rec["ranges"] += counted * ("downsample" not in c["name"])
            rec["quantizations"] += counted
    records = []
    totals = {name: {"ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                     "library_ms": 0.0,
                     "ops": 0, "bytes": 0, "launches_per_forward": 0}
              for name in (k9.RANGE, k9.QUANTIZE)}
    for i, ((B, H, W, C, zero_point), rec) in enumerate(inputs.items()):
        c = rec["conv"]
        g = torch.Generator(device=dev).manual_seed(100 + i)
        x32 = torch.randn((B, H, W, C), device=dev, generator=g)
        if zero_point:
            x32 = torch.relu(x32) * (torch.rand(C, device=dev, generator=g) * 2.9 + 0.1)
            x32[..., 0] = 0.0
        kernel = torch.randn(c["kernel"] + (C, c["Cout"]), device=dev, generator=g) * 0.1
        for dt in (torch.float32, torch.bfloat16):
            x = x32.to(dt)
            for absolute in (True, False):
                out, ref = k9.channel_range(x, absolute), k9.channel_range_plain(x, absolute)
                if not torch.equal(out, ref):
                    raise AssertionError(f"11a K9 range {c['name']} {dt} absolute={absolute}: "
                                         "differs from its plain version")
            m, amax = static_smooth_and_scale(k9.channel_range(x), kernel)
            scale = torch.clamp_min(amax, 1e-12) / (255.0 if zero_point else 127.0)
            q = k9.quantize_codes(x, m, scale, zero_point)
            if not torch.equal(q, k9.quantize_codes_plain(x, m, scale, zero_point)):
                raise AssertionError(f"11a K9 quantize {c['name']} {dt}: differs from its plain "
                                     "version")
            del q
        x = x32
        m, amax = static_smooth_and_scale(k9.channel_range(x), kernel)
        scale = torch.clamp_min(amax, 1e-12) / (255.0 if zero_point else 127.0)
        timed = {
            k9.RANGE: (lambda: k9.channel_range(x), lambda: k9.channel_range_plain(x),
                       lambda: torch.linalg.vector_norm(x, float("inf"), dim=(0, 1, 2)),
                       k9.range_cost(x), rec["ranges"]),
            k9.QUANTIZE: (lambda: k9.quantize_codes(x, m, scale, zero_point),
                          lambda: k9.quantize_codes_plain(x, m, scale, zero_point), None,
                          k9.quantize_cost(x), rec["quantizations"]),
        }
        row = {"input": c["name"], "B": B, "H": H, "W": W, "C": C,
               "zero_point": zero_point, "max_abs_err": 0.0}
        for name, (kernel_fn, plain_fn, library_fn, (ops, nbytes), count) in timed.items():
            t_ops, t_bytes = ops / PEAK_OPS["float32"], nbytes / PEAK_BYTES
            part = {"per_forward": count, "ms": time_ms(torch, kernel_fn, INT8_TIME_S),
                    "device_ms": device_ms_or_none(torch, kernel_fn),
                    "plain_ms": time_ms(torch, plain_fn, INT8_TIME_S),
                    "library_ms": None if library_fn is None else time_ms(torch, library_fn,
                                                                          INT8_TIME_S),
                    "bound_ms": 1e3 * max(t_ops, t_bytes),
                    "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                    "ops": ops, "bytes": nbytes}
            part["gb_per_s"] = nbytes / part["ms"] / 1e6
            row[name] = part
            tot = totals[name]
            for key in ("ms", "plain_ms", "bound_ms", "ops", "bytes"):
                tot[key] += count * part[key]
            tot["device_ms"] = add_or_none(tot["device_ms"],
                                           part["device_ms"] and count * part["device_ms"])
            tot["library_ms"] = (None if part["library_ms"] is None or tot["library_ms"] is None
                                 else tot["library_ms"] + count * part["library_ms"])
            tot["launches_per_forward"] += count
        records.append(row)
        del x, x32, kernel
        torch.cuda.empty_cache()
    for name, tot in totals.items():
        t_ops, t_bytes = tot["ops"] / PEAK_OPS["float32"], tot["bytes"] / PEAK_BYTES
        tot["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
    if (totals[k9.RANGE]["launches_per_forward"] != INT8_RANGE_LAUNCHES
            or totals[k9.QUANTIZE]["launches_per_forward"] != INT8_LAUNCHES):
        raise AssertionError(f"11a: K9's launches a forward {totals}")
    return records, totals


def set_int8(torch, model, int8=None, static=None) -> None:
    """Turn the int8 path (and its static ranges) of model's trunk on or
    off in place, as build_flagship's flags set them (the weights stay)."""
    from future_od_tpu_torch.models.resnet import Bottleneck, ResNet

    for m in model.modules():
        if isinstance(m, (Bottleneck, ResNet)):
            if int8 is not None:
                m.int8 = int8
            if static is not None:
                m.int8_static = static


class TrunkTap:
    """Keeps the trunk's output (NCHW) and the backbone's features of the
    last forward."""

    def __init__(self, model):
        backbone = model._model.separate_encoder.backbone
        self.values = {}
        backbone.body.register_forward_hook(self._keep("trunk"))
        backbone.register_forward_hook(self._keep("features"))

    def _keep(self, name):
        def hook(module, args, out):
            self.values[name] = out.detach().clone()
        return hook


def rel_norm(a, b) -> float:
    """||a - b|| / ||b||, in f32."""
    a, b = a.float(), b.float()
    return ((a - b).norm() / b.norm()).item()


def int8_backbone_split(torch, model, infer, batch) -> dict:
    """The backbone's device ms by part of one profiled request
    (future_od_tpu_torch/tools/int8_split.py), or why it was not measured
    (the profiler saw no K8 kernel: a reported number, not a gate)."""
    from future_od_tpu_torch.tools.int8_split import int8_backbone_split as split

    try:
        return split(model, infer, batch)
    except AssertionError as e:
        return {"not_measured": str(e)}


def plain_k8(quant, k8):
    """quant.int8_conv_codes with K8's plain version in the kernel's place."""
    def run(q, w, zp, sw, bias, strides, padding, dilation, pad_value, relu, out_dtype):
        return k8.int8_conv_plain(q, w.wt, zp, sw, bias, w.kernel_hw, strides, padding,
                                  dilation, pad_value, relu, out_dtype)
    return run


@contextlib.contextmanager
def plain_int8_kernels(quant):
    """Within it, ops/quant.py runs K8's and K9's plain versions in the
    kernels' places."""
    from future_od_tpu_torch.ops import int8_conv as k8
    from future_od_tpu_torch.ops import int8_quantize as k9

    swaps = {"int8_conv_codes": plain_k8(quant, k8), "channel_range": k9.channel_range_plain,
             "quantize_codes": k9.quantize_codes_plain}
    originals = {name: getattr(quant, name) for name in swaps}
    for name, fn in swaps.items():
        setattr(quant, name, fn)
    try:
        yield
    finally:
        for name, fn in originals.items():
            setattr(quant, name, fn)


def int8_request_phase(torch, batch, phase2_s, phase3_bf16_s):
    """Phase 11b: the dynamic int8 flagship (phase 2's weights) through
    make_inference_fn: K8 53, K9 49 + 53 and K1 6 launches a forward
    (INT8_DYNAMIC_LAUNCHES; INT8_FUSED_LAUNCHES under the fused gates); the
    trunk bit-equal to the same forward with K8's and K9's plain versions in
    their places, the encoder, decoder, scores and boxes within phase 3's
    gates of it; f32 and bf16 request ms and the backbone's split; the int8
    features' and scores' gap to the float forward (random weights:
    reported only). Returns (record, the f32 model's launches)."""
    from future_od_tpu_torch.models.build import build_flagship
    from future_od_tpu_torch.models.st_detr import SpatioTemporalDETRArgs
    from future_od_tpu_torch.ops import _kernels, quant
    from future_od_tpu_torch.train.step import make_inference_fn

    args = SpatioTemporalDETRArgs(num_classes=8, num_queries=128, int8_backbone=True)
    model = build_flagship(args, generator=torch.Generator().manual_seed(0))
    randomize_heads_(torch, model._model.detector, torch.Generator().manual_seed(1))
    taps, tap = Taps(torch, model), TrunkTap(model)
    infer = make_inference_fn(model)
    record = {}
    set_gates()
    _kernels.reset_launch_counts()
    out, seconds = forward(torch, infer, batch, REQUESTS)
    counts = launched(_kernels)
    want = {k: n * REQUESTS for k, n in INT8_DYNAMIC_LAUNCHES.items()}
    if counts != want:
        raise AssertionError(f"11b int8 default gates: launches {counts}, want {want}")
    check_output(torch, out, args.num_queries, args.num_classes)
    trunk, features, values = tap.values["trunk"], tap.values["features"], dict(taps.values)
    record["f32"] = {"request_s": seconds, "stage_ms": taps.stage_ms(), "launches": counts,
                     "phase2_float_request_s": phase2_s,
                     "backbone_split": int8_backbone_split(torch, model, infer, batch)}

    with plain_int8_kernels(quant):
        _kernels.reset_launch_counts()
        plain = infer(batch)
        torch.cuda.synchronize()
    if any(_kernels.launch_counts[k] for k in ("int8_conv", "int8_channel_range",
                                               "int8_quantize")):
        raise AssertionError("11b: the plain-K8-K9 forward launched K8 or K9")
    if not torch.equal(trunk, tap.values["trunk"]):
        raise AssertionError("11b: the int8 trunk differs from the one through K8's and K9's "
                             "plain versions")
    diffs = fused_vs_plain(values, out, taps.values, plain)
    if not all(diffs[k] <= PHASE3_TOLS[k] for k in PHASE3_TOLS):
        raise AssertionError(f"11b: outputs through K8 and K9 differ from the plain forward "
                             f"{diffs}")
    record["vs_plain_k8_k9"] = {"trunk_equal": True, **diffs, "tolerances": PHASE3_TOLS}

    set_int8(torch, model, int8=False)
    float_out = infer(batch)
    torch.cuda.synchronize()
    set_int8(torch, model, int8=True)
    record["int8_vs_float"] = {
        "features_rel_norm": rel_norm(features, tap.values["features"]),
        "trunk_rel_norm": rel_norm(trunk, tap.values["trunk"]),
        "score_max_abs": (out["class_scores"] - float_out["class_scores"]).abs().max().item(),
        "box_max_abs_px": (out["boxes"] - float_out["boxes"]).abs().max().item(),
        "note": "random weights: reported, not gated"}

    set_gates(**FUSED_GATES)
    _kernels.reset_launch_counts()
    fused, fused_s = forward(torch, infer, batch, REQUESTS)
    counts_fused = launched(_kernels)
    want_fused = {k: n * REQUESTS for k, n in INT8_FUSED_LAUNCHES.items()}
    if counts_fused != want_fused:
        raise AssertionError(f"11b int8 fused gates: launches {counts_fused}, want {want_fused}")
    check_output(torch, fused, args.num_queries, args.num_classes)
    record["f32 fused"] = {"request_s": fused_s, "stage_ms": taps.stage_ms(),
                           "launches": counts_fused}

    model.to(torch.bfloat16)
    set_gates()
    _kernels.reset_launch_counts()
    bf16, bf16_s = forward(torch, infer, batch, REQUESTS)
    counts_bf16 = launched(_kernels)
    if counts_bf16 != want:
        raise AssertionError(f"11b int8 bf16: launches {counts_bf16}, want {want}")
    check_output(torch, bf16, args.num_queries, args.num_classes)
    record["bf16"] = {"request_s": bf16_s, "stage_ms": taps.stage_ms(), "launches": counts_bf16,
                      "phase3_float_bf16_fused_request_s": phase3_bf16_s,
                      "backbone_split": int8_backbone_split(torch, model, infer, batch),
                      "score_diff_vs_f32": (bf16["class_scores"].float()
                                            - out["class_scores"]).abs().max().item()}
    set_gates()
    del model, infer, taps, tap
    torch.cuda.empty_cache()
    return record, counts


def int8_static_phase(torch, batch):
    """Phase 11c: the static-int8 flagship (phase 2's weights): refused
    before calibration, then calibrated on `batch`; on it the static request
    equals the dynamic one bit for bit (trunk and outputs); on another batch
    its gap to the float forward (reported). Returns (record, the model)."""
    from future_od_tpu_torch.models.build import build_flagship
    from future_od_tpu_torch.models.st_detr import SpatioTemporalDETRArgs
    from future_od_tpu_torch.ops import _kernels
    from future_od_tpu_torch.ops.quant import assert_calibrated
    from future_od_tpu_torch.train.step import calibrate_int8, make_inference_fn

    args = SpatioTemporalDETRArgs(num_classes=8, num_queries=128, int8_static=True)
    set_gates()
    model = build_flagship(args, generator=torch.Generator().manual_seed(0))
    randomize_heads_(torch, model._model.detector, torch.Generator().manual_seed(1))
    tap = TrunkTap(model)
    refused_uncalibrated("11c", lambda: assert_calibrated(model),
                         lambda: make_inference_fn(model))
    set_gates()
    t0 = time.perf_counter()
    calibrate_int8(model, [batch])
    torch.cuda.synchronize()
    calibrate_s = time.perf_counter() - t0
    assert_calibrated(model)
    infer = make_inference_fn(model)
    _kernels.reset_launch_counts()
    static, static_s = forward(torch, infer, batch, REQUESTS)
    counts = launched(_kernels)
    want = {k: n * REQUESTS for k, n in INT8_STATIC_LAUNCHES.items()}
    if counts != want:
        raise AssertionError(f"11c static: launches {counts}, want {want}")
    split = int8_backbone_split(torch, model, infer, batch)
    check_output(torch, static, args.num_queries, args.num_classes)
    trunk_static = tap.values["trunk"]
    set_int8(torch, model, static=False)
    dynamic, dynamic_s = forward(torch, infer, batch, REQUESTS)
    set_int8(torch, model, static=True)
    if not (torch.equal(trunk_static, tap.values["trunk"])
            and all(torch.equal(static[k], dynamic[k]) for k in ("class_scores", "boxes"))):
        raise AssertionError("11c: static differs from dynamic on the calibration batch")
    other = make_batch(seed=1)
    static_other = infer(other)
    trunk_other = tap.values["trunk"]
    set_int8(torch, model, int8=False)
    float_other = infer(other)
    torch.cuda.synchronize()
    set_int8(torch, model, int8=True)
    record = {"calibrate_s": calibrate_s, "request_s": static_s, "dynamic_request_s": dynamic_s,
              "launches": counts, "backbone_split": split,
              "equal_to_dynamic_on_calibration_batch": True,
              "other_batch_vs_float": {
                  "trunk_rel_norm": rel_norm(trunk_other, tap.values["trunk"]),
                  "score_max_abs": (static_other["class_scores"]
                                    - float_other["class_scores"]).abs().max().item(),
                  "note": "random weights: reported, not gated"},
              "fused_gates": static_fused_check(torch, args, model, batch)}
    del infer, tap
    return record, model


def refused_uncalibrated(label: str, *calls) -> None:
    """Each call must raise the uncalibrated-ranges ValueError."""
    for call in calls:
        try:
            call()
        except ValueError as e:
            if "uncalibrated" not in str(e):
                raise
        else:
            raise AssertionError(f"{label}: an uncalibrated static model was not refused")


def static_fused_check(torch, args, model, batch) -> dict:
    """Static int8 built and served under the fused gates: ranges only for
    the 33 convolutions the int8 path reaches (K2 and K3 take the rest),
    refused before calibration, then served with the fused launches and
    equal to the dynamic path on the calibration batch bit for bit."""
    from future_od_tpu_torch.models.build import build_flagship
    from future_od_tpu_torch.ops import _kernels
    from future_od_tpu_torch.ops.quant import assert_calibrated
    from future_od_tpu_torch.train.step import calibrate_int8, make_inference_fn

    set_gates(**FUSED_GATES)
    fused = build_flagship(args, generator=torch.Generator().manual_seed(0))
    fused.load_state_dict({k: v for k, v in model.state_dict().items()
                           if not k.endswith("_amax")}, strict=False)
    ranges = [k for k, _ in fused.named_buffers() if k.endswith("_amax")]
    if len(ranges) != INT8_FUSED_LAUNCHES["int8_conv"]:
        raise AssertionError(f"11c fused gates: {len(ranges)} range buffers, want "
                             f"{INT8_FUSED_LAUNCHES['int8_conv']}")
    refused_uncalibrated("11c fused gates", lambda: assert_calibrated(fused))
    calibrate_int8(fused, [batch])
    infer = make_inference_fn(fused)
    _kernels.reset_launch_counts()
    static, _ = forward(torch, infer, batch, 1)
    counts = launched(_kernels)
    if counts != INT8_STATIC_FUSED_LAUNCHES:
        raise AssertionError(f"11c fused gates: launches {counts}, want "
                             f"{INT8_STATIC_FUSED_LAUNCHES}")
    set_int8(torch, fused, static=False)
    dynamic = infer(batch)
    torch.cuda.synchronize()
    if not all(torch.equal(static[k], dynamic[k]) for k in ("class_scores", "boxes")):
        raise AssertionError("11c fused gates: static differs from dynamic on the calibration "
                             "batch")
    set_gates()
    del infer, fused
    torch.cuda.empty_cache()
    return {"ranges": len(ranges), "launches": counts,
            "equal_to_dynamic_on_calibration_batch": True}


def int8_serving_phase(torch, static_model, batch, phase9_clips_per_s):
    """Phase 11d: the session over phase 9a's 12 streams with the dynamic
    and the static int8 flagship (clips/s beside phase 9a's float default;
    the static session's output against its batch path within phase 9's
    gates, which a dynamic per-batch scale cannot promise); the dynamic int8
    artifact against eager bit for bit (K8 53 a forward); the flagship's
    eval script with --int8 on a checkpoint of a random nuScenes-class
    flagship. Returns (record, K8's launches by run)."""
    import dataclasses
    import importlib
    import tempfile

    from future_od_tpu_torch.data import nu_scenes
    from future_od_tpu_torch.models.build import build_flagship
    from future_od_tpu_torch.models.st_detr import SpatioTemporalDETRArgs
    from future_od_tpu_torch.ops import _kernels
    from future_od_tpu_torch.serve import StreamingSession, export_inference, load_serving
    from future_od_tpu_torch.train import trainer as trainer_module
    from future_od_tpu_torch.train.step import make_inference_fn, to_device_batch
    from future_od_tpu_torch.utils.checkpoint import save_checkpoint

    record, k8_launches = {}, {}

    def int8_counts():
        return {k: _kernels.launch_counts[k] for k in INT8_KERNELS}

    stream = make_stream(10, SERVE_STREAMS, SERVE_STREAM_FRAMES)
    set_gates()
    session = StreamingSession(static_model, clip_frames=FRAMES)
    for t in range(2):
        out = session.step(frame_of(stream, t))
    gaps = serve_gaps(torch, out, make_inference_fn(static_model)(clip_of(stream, 1)))
    check_serve_gaps("11d static session against its batch path", gaps)
    _kernels.reset_launch_counts()
    record["session static"] = session_throughput(torch, static_model, stream)
    record["session static"]["vs_batch_path"] = gaps
    k8_launches["11d session static"] = int8_counts()
    del session
    set_int8(torch, static_model, static=False)
    _kernels.reset_launch_counts()
    record["session dynamic"] = session_throughput(torch, static_model, stream)
    k8_launches["11d session dynamic"] = int8_counts()
    record["phase9a_f32_default_session_clips_per_s"] = phase9_clips_per_s
    del stream

    device = next(static_model.parameters()).device
    dev_batch = to_device_batch(batch, device)
    eager = make_inference_fn(static_model)(dev_batch)
    t0 = time.perf_counter()
    blob = export_inference(static_model, batch)
    export_s = time.perf_counter() - t0
    program = load_serving(blob)
    _kernels.reset_launch_counts()
    with torch.inference_mode():
        got = program(dev_batch)
    torch.cuda.synchronize()
    counts = launched(_kernels)
    if counts != INT8_DYNAMIC_LAUNCHES:
        raise AssertionError(f"11d int8 artifact: launches {counts}, want "
                             f"{INT8_DYNAMIC_LAUNCHES}")
    if not all(torch.equal(got[k], eager[k]) for k in ("class_scores", "boxes")):
        raise AssertionError("11d: the int8 artifact differs from eager")
    k8_launches["11d artifact"] = {k: counts[k] for k in INT8_KERNELS}
    record["artifact"] = {"equal_to_eager": True, "export_s": export_s,
                          "blob_mb": len(blob) / 1e6, "launches": counts}
    del program, blob
    torch.cuda.empty_cache()

    script = importlib.import_module(INT8_EVAL_SCRIPT)
    args = SpatioTemporalDETRArgs(num_classes=len(nu_scenes.CATEGORY_DICT), num_queries=128,
                                  lr_backbone=1e-4)
    model = build_flagship(args, generator=torch.Generator().manual_seed(8))
    randomize_heads_(torch, model._model.detector, torch.Generator().manual_seed(9))
    net = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    del model
    aps, eval_launches = [], []
    aggregate = trainer_module.aggregate_mean_average_precision
    make_eval_step = trainer_module.make_eval_step

    def counted_eval_step(*a, **kw):
        step = make_eval_step(*a, **kw)

        def run(data):
            before = int8_counts()
            out = step(data)
            eval_launches.append({k: n - before[k] for k, n in int8_counts().items()})
            return out
        return run

    trainer_module.aggregate_mean_average_precision = lambda *a: aps.append(aggregate(*a)) or (
        aps[-1])
    trainer_module.make_eval_step = counted_eval_step
    try:
        with tempfile.TemporaryDirectory() as tmp:
            path = save_checkpoint(tmp, "w6_nusc_500ms_attendprev_decoder", {
                "net": net, "net_type": "SpatioTemporalDETR",
                "detr_args": dataclasses.asdict(args)})
            t0 = time.perf_counter()
            trainer = script.main(["--checkpoint", path, "--synthetic", "--disable_wandb",
                                   "--int8"])
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
    finally:
        trainer_module.aggregate_mean_average_precision = aggregate
        trainer_module.make_eval_step = make_eval_step
    if not trainer._args.int8_backbone:
        raise AssertionError("11d: --int8 did not reach the eval model")
    want = {k: INT8_DYNAMIC_LAUNCHES[k] for k in INT8_KERNELS}
    if not eval_launches or any(n != want for n in eval_launches):
        raise AssertionError(f"11d eval: K8's and K9's launches a batch {eval_launches}, "
                             f"want {want}")
    if len(aps) != 1:
        raise AssertionError(f"11d eval: {len(aps)} AP aggregations")
    check_ap(aps[0], args.num_classes)
    k8_launches["11d eval script"] = {k: sum(n[k] for n in eval_launches)
                                      for k in INT8_KERNELS}
    record["eval script"] = {"script": INT8_EVAL_SCRIPT, "run_s": run_s,
                             "batches": len(eval_launches),
                             "val0_ap": {k: v.tolist() for k, v in aps[0].items()
                                         if k.endswith("threshavg")}}
    del trainer
    torch.cuda.empty_cache()
    return record, k8_launches


def int8_phase(torch, batch, phase2_s, phase3_bf16_s, phase9_clips_per_s, dev=None):
    """Phase 11, the int8 PTQ backbone: 11a-11d (11a's tensors on dev,
    default the card). Returns the kernels-line rows of K8 and of K9's two
    entry points."""
    t0 = time.perf_counter()
    shapes, totals = k8_phase(torch, dev or torch.device("cuda"))
    log("11a-k8-vs-plain", ok=True, card=gpu_name_and_power(), totals=totals, shapes=shapes,
        seconds=time.perf_counter() - t0)
    t1 = time.perf_counter()
    k9_records, k9_totals = k9_phase(torch, dev or torch.device("cuda"))
    log("11a-k9-vs-plain", ok=True, card=gpu_name_and_power(), totals=k9_totals,
        inputs=k9_records, seconds=time.perf_counter() - t1)
    t1 = time.perf_counter()
    request, main_counts = int8_request_phase(torch, batch, phase2_s, phase3_bf16_s)
    log("11b-int8-request", ok=True, card=gpu_name_and_power(), **request,
        seconds=time.perf_counter() - t1)
    t1 = time.perf_counter()
    static, static_model = int8_static_phase(torch, batch)
    log("11c-int8-static", ok=True, card=gpu_name_and_power(), **static,
        seconds=time.perf_counter() - t1)
    t1 = time.perf_counter()
    serving, k8_launches = int8_serving_phase(torch, static_model, batch, phase9_clips_per_s)
    log("11d-int8-serving", ok=True, card=gpu_name_and_power(), **serving,
        seconds=time.perf_counter() - t1)
    del static_model
    torch.cuda.empty_cache()
    log("11-int8", ok=True, seconds=time.perf_counter() - t0)
    row = {
        "name": "int8_conv", "route": "cuda", "source": "future_od_tpu_torch/csrc/int8_conv.cu",
        "replaces": "future_od_tpu/ops/quant.py:99 and :121 (XLA's int8 convolution, "
                    "lax.conv_general_dilated with int32 sums; not a Pallas kernel)",
        "launches": main_counts["int8_conv"], "max_abs_err": 0.0,
        "ms": totals["ms"], "device_ms": totals["device_ms"],
        "ms_is": "paced: back-to-back calls timed by CUDA events (the host's pace where it is "
                 "slower); device_ms the kernel's CUDA time under torch.profiler",
        "plain_ms": totals["plain_ms"], "bound_ms": totals["bound_ms"],
        "bound_by": totals["bound_by"], "library_ms": None,
        "library_is": "none: no PyTorch call computes an int8 convolution",
        "yardstick_ms": totals["yardstick_ms"],
        "yardstick_is": "cuDNN's bf16 convolutions of the same 53 shapes, channels-last",
        "int_mm_ms": totals["int_mm_ms"], "ms_on_int_mm_convs": totals["ms_on_int_mm_convs"],
        "int_mm_convs": totals["int_mm_convs"],
        "int_mm_device_ms": totals["int_mm_device_ms"],
        "device_ms_on_int_mm_convs": totals["device_ms_on_int_mm_convs"],
        "int_mm_is": "torch._int_mm (cuBLAS int8 GEMM) on the stride-1 1x1 convolutions, "
                     "the same int32 product without the epilogue, the faster of the weights "
                     "row-major and column-major",
        "per": f"one forward's {INT8_LAUNCHES} launches, {BATCH * (FRAMES - 1)} frames at "
               f"{HEIGHT}x{WIDTH}, f32 out",
        "phase11_launches": {"11b f32 default": main_counts["int8_conv"],
                             **{k: n["int8_conv"] for k, n in k8_launches.items()}},
        "calls": shapes,
    }
    k9_replaces = ("future_od_tpu/ops/quant.py:44-80, 91-93, 157-158, 300-301 (the "
                   "activations' ranges and quantization, which XLA fuses into its int8 "
                   "convolutions; not a Pallas kernel)")
    rows = [row]
    for name, what in (("int8_channel_range", "the per-channel range of each dynamic "
                                              "convolution's input (a block's conv1 and "
                                              "downsample share one)"),
                       ("int8_quantize", "the codes of each convolution's input")):
        tot = k9_totals[name]
        rows.append({
            "name": name, "route": "cuda",
            "source": "future_od_tpu_torch/csrc/int8_quantize.cu", "replaces": k9_replaces,
            "launches": main_counts[name], "max_abs_err": 0.0,
            **{k: tot[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                                   "library_ms")},
            "library_is": ("torch.linalg.vector_norm(x, inf, dim=(0, 1, 2))"
                           if name == "int8_channel_range" else
                           "none: no PyTorch call divides by per-channel factors and a scale "
                           "and rounds to zero-point codes"),
            "per": f"one forward's {tot['launches_per_forward']} launches ({what}), "
                   f"{BATCH * (FRAMES - 1)} frames at {HEIGHT}x{WIDTH}, f32 in",
            "phase11_launches": {"11b f32 default": main_counts[name],
                                 **{k: n[name] for k, n in k8_launches.items()}},
            "calls": [{"input": r["input"], "B": r["B"], "H": r["H"], "W": r["W"], "C": r["C"],
                       **r[name]} for r in k9_records],
        })
    return rows

# ---------------------------------------------------------------------------
# Phase 12: the learning loop on the card (future_od_tpu_torch/tools/).

PROBE_STEPS = 300  # 12a: steps of future_overfit_probe after the first
PROBE_INTERVAL = 100
# 12a's gate: the mean loss of the last PROBE_TAIL steps below this fraction
# of step 0's
PROBE_LOSS_FRACTION = 0.5
PROBE_TAIL = 10
DRIFT_EPOCHS = 3  # 12b: epochs of matcher_drift_branched's base config
DRIFT_BATCH = 16
DRIFT_FORWARDS = 20  # quant_ap_check's splits at batch 16: 256 fit + 64 val0 images
K9_FAR_RANGE = 1e15  # the JAX drift_base's activation ranges (BENCHMARKS.md, round 3)
MATCH_PROBLEMS = (16, 32, 12)  # 12c: images, queries, target slots


class Int8Calls:
    """Within it, ops/quant.py's calls of K8 and K9 run as before and the
    operands of the first call of each distinct shape are kept, with how
    many calls share that shape."""

    NAMES = ("int8_conv_codes", "channel_range", "quantize_codes")

    def __init__(self, quant):
        self.quant, self.calls = quant, {name: {} for name in self.NAMES}

    def _wrap(self, name, fn):
        signature = inspect.signature(fn)

        def run(*args, **kwargs):
            bound = signature.bind(*args, **kwargs)
            bound.apply_defaults()
            args = tuple(bound.arguments.values())
            key = tuple(tuple(a.shape) if hasattr(a, "shape") else
                        (a.wt.shape, a.kernel_hw) if hasattr(a, "wt") else repr(a)
                        for a in args)
            rec = self.calls[name].setdefault(key, {"args": None, "count": 0})
            if rec["args"] is None:
                rec["args"] = tuple(a.clone() if hasattr(a, "clone") else a for a in args)
            rec["count"] += 1
            return fn(*args)
        return run

    def __enter__(self):
        self.originals = {name: getattr(self.quant, name) for name in self.NAMES}
        for name, fn in self.originals.items():
            setattr(self.quant, name, self._wrap(name, fn))
        return self

    def __exit__(self, *exc):
        for name, fn in self.originals.items():
            setattr(self.quant, name, fn)


def probe_phase(torch, dev, check=False) -> dict:
    """12a: future_overfit_probe (the flagship on 8 three-frame clips at
    128x192) for PROBE_STEPS steps: the loss must fall below
    PROBE_LOSS_FRACTION of step 0's; AP50 and the step time."""
    from future_od_tpu_torch.tools import future_overfit_probe

    t0 = time.perf_counter()
    steps = 4 if check else PROBE_STEPS
    rec = future_overfit_probe.run(check, steps, str(dev), 1 if check else PROBE_INTERVAL)
    losses = rec["losses"]
    tail = float(np.mean(losses[-PROBE_TAIL:]))
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"12a: non-finite probe losses {losses}")
    if not check and tail >= PROBE_LOSS_FRACTION * losses[0]:
        raise AssertionError(f"12a: the loss {losses[0]:.3f} -> {tail:.3f} (mean of the last "
                             f"{PROBE_TAIL}) did not fall below {PROBE_LOSS_FRACTION} of it")
    return {"steps": steps + 1, "first_loss": losses[0], "tail_loss": tail,
            "tail_over_first": tail / losses[0], "gate": PROBE_LOSS_FRACTION,
            "lines": rec["lines"], "step_ms": rec["step_ms"],
            "seconds": time.perf_counter() - t0}


def replay_int8_calls(torch, quant, calls, time_s: float) -> dict:
    """Each recorded K8 and K9 call of one int8 forward through the kernel
    and through its plain version: bit-equal (K8 also with bf16 out; K9
    also on its input scaled to a range of K9_FAR_RANGE, with the scale
    alike). Times a call and a forward's sums, and the bounds."""
    from future_od_tpu_torch.ops import int8_conv as k8
    from future_od_tpu_torch.ops import int8_quantize as k9

    plain_conv = plain_k8(quant, k8)
    out = {"int8_conv": [], k9.RANGE: [], k9.QUANTIZE: []}
    for key, rec in calls["int8_conv_codes"].items():
        q, w, zp, sw, bias, strides, padding, dilation, pad_value, relu, dtype = rec["args"]
        for dt in (dtype, torch.bfloat16 if dtype == torch.float32 else torch.float32):
            args = (q, w, zp, sw, bias, strides, padding, dilation, pad_value, relu, dt)
            if not torch.equal(k8.int8_conv_codes(*args), plain_conv(*args)):
                raise AssertionError(f"12b K8 {tuple(q.shape)} -> Cout {w.wt.shape[0]} "
                                     f"{w.kernel_hw} stride {strides} {dt}: differs from its "
                                     "plain version")
        ops, nbytes = k8.int8_conv_cost(*q.shape, w.wt.shape[0], w.kernel_hw, strides, padding,
                                        dilation, 4)
        t_ops, t_bytes = ops / PEAK_INT8, nbytes / PEAK_BYTES
        out["int8_conv"].append({
            "q": list(q.shape), "Cout": w.wt.shape[0], "kernel": list(w.kernel_hw),
            "stride": list(strides), "pad_value": pad_value, "per_forward": rec["count"],
            "ms": time_ms(torch, lambda: k8.int8_conv_codes(*rec["args"]), time_s),
            "plain_ms": time_ms(torch, lambda: plain_conv(*rec["args"]), time_s),
            "bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"})
    for name, kernel, plain in ((k9.RANGE, k9.channel_range, k9.channel_range_plain),
                                (k9.QUANTIZE, k9.quantize_codes, k9.quantize_codes_plain)):
        for key, rec in calls["channel_range" if name == k9.RANGE else "quantize_codes"].items():
            x = rec["args"][0]
            amax = x.float().abs().max().item()
            factor = K9_FAR_RANGE / max(amax, 1e-30)
            far = (x.float() * factor).to(x.dtype)
            cases = {"recorded": rec["args"]}
            if name == k9.RANGE:
                cases["far"] = (far,) + rec["args"][1:]
            else:
                cases["far"] = (far, rec["args"][1], rec["args"][2] * factor, rec["args"][3])
            for case, args in cases.items():
                if not torch.equal(kernel(*args), plain(*args)):
                    raise AssertionError(f"12b K9 {name} {tuple(x.shape)} ({case}, max |x| "
                                         f"{amax if case == 'recorded' else K9_FAR_RANGE:.3g}): "
                                         "differs from its plain version")
            ops, nbytes = (k9.range_cost if name == k9.RANGE else k9.quantize_cost)(x)
            t_ops, t_bytes = ops / PEAK_OPS["float32"], nbytes / PEAK_BYTES
            out[name].append({
                "x": list(x.shape), "max_abs_x": amax, "per_forward": rec["count"],
                "ms": time_ms(torch, lambda: kernel(*rec["args"]), time_s),
                "plain_ms": time_ms(torch, lambda: plain(*rec["args"]), time_s),
                "bound_ms": 1e3 * max(t_ops, t_bytes),
                "bound_by": "operations" if t_ops >= t_bytes else "bytes"})
    totals = {}
    for name, recs in out.items():
        totals[name] = {k: sum(r[k] * r["per_forward"] for r in recs)
                        for k in ("ms", "plain_ms", "bound_ms")}
        totals[name]["launches_per_forward"] = sum(r["per_forward"] for r in recs)
    return {"calls": out, "per_forward": totals}


def drift_quant_phase(torch, dev, check=False) -> dict:
    """12b: matcher_drift_branched's base config (the auction, batch 16, 256
    + 64 synthetic images at 128x192) for DRIFT_EPOCHS epochs through the
    Trainer into build/phase12/drift_base; then quant_ap_check's float and
    int8 arms on that checkpoint over its "fit" and "val0" splits, the int8
    arm counted: K8 53, K9 49 + 53 launches a forward. Each distinct K8 and
    K9 call of an int8 forward on a fit batch is replayed against its plain
    version (`replay_int8_calls`)."""
    from future_od_tpu_torch.data.loader import ARRAY_KEYS, collate
    from future_od_tpu_torch.ops import _kernels, quant
    from future_od_tpu_torch.tools import _convergence as conv
    from future_od_tpu_torch.tools import matcher_drift_branched, quant_ap_check

    t0 = time.perf_counter()
    ckpt_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "phase12")
    batch = conv.CHECK_BATCH if check else DRIFT_BATCH
    base = matcher_drift_branched.make_trainer(
        "auction", "drift_base", batch, conv.CHECK_SAMPLES if check else 256, ckpt_dir,
        conv.CHECK_VAL_SAMPLES if check else 64, check=check, device=str(dev))
    base.train(DRIFT_EPOCHS)
    labels = base._stats["train labels loss"].history
    if not all(math.isfinite(v) for v in labels):
        raise AssertionError(f"12b: non-finite labels loss over the epochs {labels}")
    for mode in ("train", "val0"):
        check_ap(base._ap_by_mode[mode], 2)
    train_s = time.perf_counter() - t0
    ckpt = os.path.join(ckpt_dir, "drift_base")
    float_aps = quant_ap_check.evaluate(False, ckpt, batch, check, str(dev))

    trainer = quant_ap_check.make_trainer(True, ckpt, batch, check, str(dev))
    fit = trainer._val_loaders["fit"].dataset  # its first batch (the loader keeps the order)
    first = collate([fit[i] for i in range(batch)])
    with Int8Calls(quant) as recorded:
        trainer._eval_step({k: v for k, v in first.items() if k in ARRAY_KEYS})
    per_forward = {name: sum(r["count"] for r in recs.values())
                   for name, recs in recorded.calls.items()}
    want = {"int8_conv_codes": INT8_LAUNCHES, "channel_range": INT8_RANGE_LAUNCHES,
            "quantize_codes": INT8_LAUNCHES}
    if per_forward != want:
        raise AssertionError(f"12b: int8 calls a forward {per_forward}, want {want}")
    _kernels.reset_launch_counts()
    trainer._run_eval()
    counts = launched(_kernels)
    forwards = sum(len(loader) for loader in trainer._val_loaders.values())
    expect = ({} if dev.type != "cuda" else
              {"int8_conv": INT8_LAUNCHES * forwards, "int8_channel_range":
               INT8_RANGE_LAUNCHES * forwards, "int8_quantize": INT8_LAUNCHES * forwards})
    if counts != expect:
        raise AssertionError(f"12b: the int8 arm launched {counts}, want {expect}")
    int8_aps = quant_ap_check.split_aps(trainer)
    for aps in (float_aps, int8_aps):
        for mode, rec in aps.items():
            if not all(0.0 <= v <= 1.0 for v in rec["ap50"]):
                raise AssertionError(f"12b: AP50 out of [0, 1]: {mode} {rec}")
    replay = replay_int8_calls(torch, quant, recorded.calls, INT8_TIME_S)
    return {"epochs": DRIFT_EPOCHS, "train_labels_loss": labels, "train_s": train_s,
            "base_ap50": {m: conv.ap50(base._ap_by_mode[m]) for m in ("train", "val0")},
            "float": float_aps, "int8": int8_aps,
            "fit_ap50_abs_delta": [abs(a - b) for a, b in zip(float_aps["fit"]["ap50"],
                                                              int8_aps["fit"]["ap50"])],
            "forwards": forwards, "launches": counts, "kernels": replay,
            "seconds": time.perf_counter() - t0}


def exact_matching_phase(torch, dev) -> dict:
    """12c: one batch of matching problems with a unique optimum solved by
    the exact solver on the card's host (ops/native_lap.py, built with g++
    there) and by the auction on the card: the same indices. Every target
    prefers one popular query (cost 0) and has its own planted query
    (0.1 + 0.05 k for the k-th target, distinct) among queries costing 1-2,
    so the targets bid against each other for several rounds, and the
    optimum (the popular query to the target whose planted one is dearest)
    beats every other assignment by 0.05, above the auction's slack of N x
    its eps."""
    from future_od_tpu_torch.ops.matching import auction_assignment, hungarian_assignment

    B, M, N = MATCH_PROBLEMS
    g = torch.Generator().manual_seed(12)
    cost = 1.0 + torch.rand((B, M, N), generator=g)
    active = torch.rand((B, N), generator=g) < 0.75
    active[:, :2] = True
    for b in range(B):
        rows = torch.randperm(M, generator=g)[:N + 1]
        cost[b, rows[0], :] = 0.0  # the popular query
        cost[b, rows[1:], torch.arange(N)] = 0.1 + 0.05 * torch.randperm(N, generator=g).float()
    cost, active = cost.to(dev), active.to(dev)
    t0 = time.perf_counter()
    exact = hungarian_assignment(cost, active)
    exact_ms = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    auction, rounds = auction_assignment(cost, active, return_rounds=True)
    auction_ms = 1e3 * (time.perf_counter() - t0)
    if not torch.equal(exact, auction):
        raise AssertionError("12c: the exact solver and the auction disagree on a "
                             "unique-optimum cost")
    return {"problems": [B, M, N], "exact_host_ms": exact_ms, "auction_ms": auction_ms,
            "auction_rounds_max": int(rounds.max()), "device": str(exact.device)}


def learning_phase(torch, dev=None, check=False) -> dict:
    """Phase 12, the learning loop: 12a-12c (on dev, default the card;
    check: the tools' tiny sizes, for a rehearsal on the CPU)."""
    dev = dev or torch.device("cuda")
    t0 = time.perf_counter()
    records = {}
    for name, fn in (("12a-future-overfit-probe", probe_phase),
                     ("12b-drift-base-int8-ap", drift_quant_phase)):
        records[name] = fn(torch, dev, check)
        log(name, ok=True, card=gpu_name_and_power(),
            **{k: v for k, v in records[name].items() if k != "kernels"})
    kernels = records["12b-drift-base-int8-ap"]["kernels"]
    log("12b-int8-kernels-vs-plain", ok=True, card=gpu_name_and_power(), **kernels)
    records["12c-exact-matching"] = exact_matching_phase(torch, dev)
    log("12c-exact-matching", ok=True, **records["12c-exact-matching"])
    log("12-learning-loop", ok=True, seconds=time.perf_counter() - t0)
    return records


def max_rel(a, b) -> float:
    """max |a - b| over max |b|."""
    return ((a.float() - b.float()).abs().max() / b.float().abs().max()).item()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; needs one CUDA card",
              file=sys.stderr)
        return 1
    from future_od_tpu_torch.models.build import build_flagship
    from future_od_tpu_torch.models.st_detr import SpatioTemporalDETRArgs
    from future_od_tpu_torch.ops import _kernels
    from future_od_tpu_torch.train.step import make_inference_fn

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = gpu_name_and_power()
    print(card, flush=True)
    log("0-device", card=card, torch=torch.__version__, cuda=torch.version.cuda,
        kind=torch.cuda.get_device_name(0), count=torch.cuda.device_count())
    log("0-build", seconds=_kernels.build_all(), build_dir=str(_kernels.BUILD_DIR))
    log("0-k1-tensor-cores", **k1_tensor_core_report())
    log("0-k2-tensor-cores", **k2_tensor_core_report())
    log("0-k3-tensor-cores", **k3_tensor_core_report())
    log("0-k4-k6-tensor-cores", **train_tensor_core_report())
    log("0-k8-tensor-cores", **k8_tensor_core_report())

    t0 = time.perf_counter()
    records = kernel_phase(torch, torch.device("cuda"))
    log("1-kernels-vs-plain", ok=True, seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    train_records = train_kernel_phase(torch, torch.device("cuda"))
    log("1b-train-kernels-vs-plain", ok=True, seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    log("1e-head-dims", ok=True, **head_dims_phase(torch, torch.device("cuda")),
        seconds=time.perf_counter() - t0)

    t0 = time.perf_counter()
    tool_records, tool_counts = tools_phase(torch, torch.device("cuda"))
    log("1c-tools-kernels-vs-plain", ok=True, seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    stem_records, stem_counts = stem_phase(torch, torch.device("cuda"))
    log("1d-stem-kernels-vs-plain", ok=True, seconds=time.perf_counter() - t0)

    t0 = time.perf_counter()
    args = SpatioTemporalDETRArgs(num_classes=8, num_queries=128)
    model = build_flagship(args, generator=torch.Generator().manual_seed(0))
    randomize_heads_(torch, model._model.detector, torch.Generator().manual_seed(1))
    taps = Taps(torch, model)
    infer = make_inference_fn(model)
    batch = make_batch(seed=0)
    set_gates()
    _kernels.reset_launch_counts()
    out, seconds = forward(torch, infer, batch, REQUESTS)
    main_counts = launched(_kernels)
    check_output(torch, out, args.num_queries, args.num_classes)
    if main_counts != {"flash_attention": 6 * REQUESTS}:
        raise AssertionError(f"default gates: launches {main_counts}, want flash 6/forward")
    log("2-flagship-f32", ok=True, requests=REQUESTS, request_s=seconds,
        launches=main_counts, stage_ms=taps.stage_ms(),
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
        profile=profile_request(torch, infer, batch, taps.stages), seconds=time.perf_counter() - t0)

    t0 = time.perf_counter()
    set_gates(FUTURE_OD_FUSED_RESNET="1", FUTURE_OD_FUSED_STEM="1")
    _kernels.reset_launch_counts()
    fused, fused_s = forward(torch, infer, batch, REQUESTS)
    fused_counts = launched(_kernels)
    want = {"flash_attention": 6, "fused_bottleneck": 6, "fused_stem": 1}
    if fused_counts != {k: n * REQUESTS for k, n in want.items()}:
        raise AssertionError(f"fused gates: launches {fused_counts}, want {want} per forward")
    check_output(torch, fused, args.num_queries, args.num_classes)
    fused_values, fused_stages = dict(taps.values), taps.stage_ms()
    fused_profile = profile_request(torch, infer, batch, taps.stages)
    set_gates(FUTURE_OD_DISABLE_FLASH="1")
    _kernels.reset_launch_counts()
    plain, plain_s = forward(torch, infer, batch, 2)
    if any(_kernels.launch_counts.values()):
        raise AssertionError(f"all-plain forward launched {_kernels.launch_counts}")
    diffs = fused_vs_plain(fused_values, fused, taps.values, plain)
    log("3-fused-vs-plain-f32", **diffs, tolerances=PHASE3_TOLS,
        score_range=[plain["class_scores"].min().item(), plain["class_scores"].max().item()],
        box_std_px=plain["boxes"].std().item(), fused_request_s=fused_s,
        plain_request_s=plain_s, launches=fused_counts, stage_ms=fused_stages,
        profile=fused_profile)
    if not all(diffs[k] <= PHASE3_TOLS[k] for k in PHASE3_TOLS):
        raise AssertionError("fused forward differs from the all-plain forward")

    model.to(torch.bfloat16)
    set_gates(FUTURE_OD_FUSED_RESNET="1", FUTURE_OD_FUSED_STEM="1")
    _kernels.reset_launch_counts()
    bf16, bf16_s = forward(torch, infer, batch, REQUESTS)
    bf16_counts = launched(_kernels)
    if bf16_counts != {k: n * REQUESTS for k, n in want.items()}:
        raise AssertionError(f"bf16 fused: launches {bf16_counts}")
    check_output(torch, bf16, args.num_queries, args.num_classes)
    log("3-flagship-bf16", ok=True, request_s=bf16_s, launches=bf16_counts,
        stage_ms=taps.stage_ms(),
        score_diff_vs_f32=(bf16["class_scores"].float() - fused["class_scores"]).abs().max().item(),
        box_diff_vs_f32_px=(bf16["boxes"].float() - fused["boxes"]).abs().max().item(),
        profile=profile_request(torch, infer, batch, taps.stages), seconds=time.perf_counter() - t0)
    torch.cuda.synchronize()
    del model, infer, taps
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    s2d_phase(torch, batch, seconds)
    log("3b-s2d-flagship", ok=True, seconds=time.perf_counter() - t0)
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    train_runs, train_counts, train_check = train_phase(torch)
    log("5-train-step", ok=True, **train_check, seconds=time.perf_counter() - t0)
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    trainer_runs, trainer_counts, trainer_records = trainer_phase(torch)
    for stage, (name, _, _) in TRAINER_STAGES.items():
        log(f"6-trainer-{name.split(' (')[0].replace(' ', '-')}", ok=True,
            card=gpu_name_and_power(), **trainer_runs[stage])
    log("6-trainer", ok=True, script=TRAINER_SCRIPT, argv=TRAINER_ARGV, gates=TRAINER_GATES,
        run_s=trainer_runs["run_s"], launches=trainer_counts, seconds=time.perf_counter() - t0)

    t0 = time.perf_counter()
    precision_runs, precision_totals = precision_phase(torch, trainer_runs[448]["losses"][0])
    for label, runs in precision_runs.items():
        for stage, (name, _, _) in TRAINER_STAGES.items():
            log(f"6b-{label.replace(' ', '-')}-{name.split(' (')[0].replace(' ', '-')}", ok=True,
                card=gpu_name_and_power(), **runs[stage])
        argv = TRAINER_ARGV + next(extra for name, extra, _ in PRECISION_RUNS if name == label)
        log(f"6b-{label.replace(' ', '-')}", ok=True, argv=argv, run_s=runs["run_s"],
            first_loss_vs_f32=runs["first_loss_vs_f32"],
            k4_k6_input_dtypes=runs["k4_k6_input_dtypes"], launches=precision_totals[label])
    log("6b-accum-exactness", ok=True, **accum_exactness(torch))
    log("6b-trainer-precision", ok=True, seconds=time.perf_counter() - t0)
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    appetite = {"f32": trainer_runs[448]["median_later_train_step_ms"],
                "bf16": precision_runs["bf16"][448]["median_later_train_step_ms"]}
    log("7-data-path", ok=True, **data_phase(torch, appetite), seconds=time.perf_counter() - t0)

    t0 = time.perf_counter()
    single_record, single_kernels, single_totals = single_frame_phase(torch)
    log("8a-single-frame-script", ok=True, card=gpu_name_and_power(), **single_record,
        seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    tracker_record, tracker_totals = tracker_eval_phase(torch)
    log("8b-tracker-eval", ok=True, card=gpu_name_and_power(), **tracker_record,
        seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    variant_records, variant_k1, variant_k1_total = variants_phase(torch)
    log("8c-variants", ok=True, card=gpu_name_and_power(), variants=variant_records,
        k1_vs_plain=variant_k1, seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    serving_records, phase9_launches = serving_phase(torch)
    log("9-serving", ok=True, card=gpu_name_and_power(), seconds=time.perf_counter() - t0,
        **{k: serving_records[k]["seconds"] for k in ("9a", "9b", "9c")})
    t0 = time.perf_counter()
    dist_records, phase10_launches = distributed_phase(torch, serving_records)
    log("10-data-parallel", ok=True, card=gpu_name_and_power(),
        seconds=time.perf_counter() - t0,
        **{k: dist_records[k]["seconds"] for k in ("10a", "10b", "10c", "10d")})
    int8_rows = int8_phase(torch, batch, seconds, bf16_s,
                        serving_records["9a"]["throughput f32 default"]["session_clips_per_s"])
    learning = learning_phase(torch)
    int8_ap = learning["12b-drift-base-int8-ap"]
    for row in int8_rows:  # K8's and K9's launches and times on phase 12b's path
        row["phase12_launches"] = {"12b int8 AP (fit + val0)": int8_ap["launches"][row["name"]]}
        row["phase12"] = {
            "per": f"one int8 forward of quant_ap_check's path ({DRIFT_BATCH} images at "
                   "128x192, the trained drift_base checkpoint), f32 out",
            **int8_ap["kernels"]["per_forward"][row["name"]],
            "calls": int8_ap["kernels"]["calls"][row["name"]]}
    phase8_launches = {
        name: {"8a single-frame script": single_totals.get(name, 0),
               "8b tracker eval": tracker_totals.get(name, 0),
               "8c variants": variant_k1_total if name == "flash_attention" else 0}
        for name in MAIN_KERNELS}

    sources = {
        "flash_attention": "future_od_tpu/ops/flash_attention.py:68",
        "fused_bottleneck": "future_od_tpu/ops/fused_resnet.py:44",
        "fused_stem": "future_od_tpu/ops/fused_resnet.py:189",
    }
    launches = {
        "flash_attention": main_counts["flash_attention"],
        "fused_bottleneck": fused_counts["fused_bottleneck"],
        "fused_stem": fused_counts["fused_stem"],
    }
    kernels = []
    for name, recs in records.items():
        f32 = [r for r in recs if r["dtype"] == "float32"]
        per_fwd = lambda key: sum(r[key] * r["per_forward"] for r in f32)  # noqa: E731
        lib = [r["library_ms"] for r in f32]
        bound_is = {}
        if name == "flash_attention":  # the 3xTF32 products, the ex2 or the bytes
            b_ms, b_by = per_fwd("bound_ms"), f32[0]["bound_by"]
            bound_is = {"bound_is": f32[0]["bound_is"]}
        else:  # K2, K3: the 3xTF32 products or the bytes
            b_ms, b_by, b_is = tc_bound(per_fwd("ops"), per_fwd("bytes"), "float32")
            bound_is = {"bound_is": b_is}
            if name == "fused_stem":
                bound_is["design_floor_ms"] = per_fwd("design_floor_ms")
                bound_is["design_floor_is"] = f32[0]["design_floor_is"]
        if "library_is" in f32[0]:
            bound_is["library_is"] = f32[0]["library_is"]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"future_od_tpu_torch/csrc/{name}.cu",
            "replaces": sources[name], "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in f32),
            "ms": per_fwd("ms"), "plain_ms": per_fwd("plain_ms"),
            "bound_ms": b_ms, "bound_by": b_by, **bound_is,
            "library_ms": None if None in lib else per_fwd("library_ms"),
            "per": f"one f32 forward's launches, {BATCH} clips x {FRAMES - 1} past frames "
                   f"x {HEIGHT}x{WIDTH}",
            "calls": recs,
        })
    train_sources = {
        "flash_train_fwd": "future_od_tpu/ops/flash_attention.py:260",
        "flash_train_dq": "future_od_tpu/ops/flash_attention.py:309",
        "flash_train_dkv": "future_od_tpu/ops/flash_attention.py:350",
    }
    for name, recs in train_records.items():
        timed = [r for r in recs if "ms" in r]  # f32, rate 0.1, one per attention
        f32 = [r for r in recs if r["dtype"] == "float32"]
        per_step = lambda key: sum(r[key] * r["per_step"] for r in timed)  # noqa: E731
        # the bound: every product on the tensor cores (f32 as 3xTF32) or the bytes
        b_ms, b_by, b_is = tc_bound(per_step("ops"), per_step("bytes"), "float32")
        row = {
            "name": name, "route": "cuda",
            "source": "future_od_tpu_torch/csrc/flash_attention_train.cu",
            "replaces": train_sources[name], "launches": train_counts[name],
            "max_abs_err": max(r["max_abs_err"] for r in f32),
            "ms": per_step("ms"), "device_ms": per_step("device_ms"),
            "host_us": {r["attention"]: r["host_us"] for r in timed},
            "plain_ms": per_step("plain_ms"),
            "bound_ms": b_ms, "bound_by": b_by, "bound_is": b_is,
            "library_ms": per_step("library_ms"),
            "library_device_ms": per_step("library_device_ms"),
            "library_host_us": {r["attention"]: r["library_host_us"] for r in timed},
            "ms_is": "paced: back-to-back calls timed by CUDA events",
            "per": f"one f32 train step's launches at dropout 0.1, {TRAIN_BATCH} clips x "
                   f"{FRAMES - 1} past frames x {TRAIN_HEIGHT}x{TRAIN_WIDTH}",
            "calls": recs,
        }
        # the design keeps the logits (q·kᵀ, bit-equal in all three kernels) on
        # the CUDA cores: that design's floor, apart from the card's bound
        logits = sum(2 * r["shape"][0] * r["shape"][1] * r["shape"][2] * r["shape"][3]
                     * r["per_step"] for r in timed)
        products = tc_bound(per_step("ops") - logits, 0, "float32")[0]
        row["design_floor_ms"] = max(bound(logits, per_step("bytes"), "float32")[0], products)
        row["design_floor_is"] = ("the logits' f32 FMA chains on the CUDA cores, the other "
                                  "products as 3xTF32 on the tensor cores, or the bytes")
        if name == "flash_train_fwd":
            row["includes"] = ("the dropout mask future_od_tpu_torch/csrc/dropout_mask.cuh "
                               "(replaces future_od_tpu/ops/flash_attention.py:242)")
        else:
            row["library_covers"] = "SDPA backward (one autograd.grad), dq and dk/dv together"
        kernels.append(row)
    for name, rec in tool_records.items():
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"future_od_tpu_torch/csrc/{TOOL_SOURCES[name]}",
            "replaces": TOOL_KERNELS[name], "launches": tool_counts[name],
            "max_abs_err": max(c["max_abs_err"] for c in rec["calls"] if c["dtype"] == "bfloat16"),
            **{k: rec[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                                   "library_is", "per") if k in rec},
            "calls": rec["calls"],
        })
    for name, rec in stem_records.items():
        kernels.append({
            "name": name, "route": "cuda",
            "source": "future_od_tpu_torch/csrc/stem_variants.cu",
            "replaces": STEM_KERNELS[name], "launches": stem_counts[name],
            "max_abs_err": max(c["max_abs_err"] for c in rec["calls"] if c["dtype"] == "bfloat16"),
            **{k: rec[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                                   "library_is", "per")},
            "calls": rec["calls"],
        })
    kernels.extend(int8_rows)
    for row in kernels:  # the launches on phase 6's, 6b's, 8's and 9's runs, by stage
        if row["name"] in phase8_launches:
            row["phase8_launches"] = phase8_launches[row["name"]]
        if row["name"] in phase9_launches:
            row["phase9_launches"] = phase9_launches[row["name"]]
        if row["name"] in phase10_launches:
            row["phase10_launches"] = phase10_launches[row["name"]]
        if row["name"] == "flash_attention":
            row["host_us"] = {r["dtype"]: {"op": r["host_us"], "launch": r["host_us_launch"]}
                              for r in row["calls"]}
        if row["name"] == "flash_attention":
            row["phase8_calls"] = variant_k1
        if row["name"] in single_kernels:
            row["phase8_calls"] = single_kernels[row["name"]]
        if row["name"] in trainer_counts:
            row["trainer_launches"] = trainer_counts[row["name"]]
            for label, counts in precision_totals.items():
                row[f"trainer_launches_{label.replace(' ', '_')}"] = counts[row["name"]]
        if row["name"] in trainer_records:
            row["trainer_calls"] = trainer_records[row["name"]]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] in RANK_ROLES:  # a rank of phase 10
        sys.exit(rank_main(*sys.argv[1:]))
    sys.exit(main())
