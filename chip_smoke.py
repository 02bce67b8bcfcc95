#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (future_od_tpu_torch) on one NVIDIA GPU.

Run from the repo root: `python3 chip_smoke.py`. It needs one CUDA card and
nvcc; the kernels are built from future_od_tpu_torch/csrc/ on first use into
build/torch_kernels/. Phases, one line each, every failure fatal:

0. the card's name and power limit (nvidia-smi); the kernel build and its
   seconds; that K1 (csrc/flash_attention.cu), K2
   (csrc/fused_bottleneck.cu), K3 (csrc/fused_stem.cu) and K4, K5 and K6
   (csrc/flash_attention_train.cu) run on the tensor cores: the SASS of each
   of their instantiations (cuobjdump) holds HMMA instructions, with its
   registers, shared memory and spills (ptxas's report in the build log, and
   the runtime's, with the resident blocks an SM).
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
   version's and, for T1, SDPA's forward.
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
4. a `kernels` JSON line (with each main-path kernel's launches on phase 6's
   run), then the device JSON line, last.

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

import copy
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
    "FUTURE_OD_TRAIN_FLASH",
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
                     "train_fwd_kernel", "train_dq_kernel", "train_dkv_kernel")
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


def tensor_core_report(lib_name: str, kernel: str, instantiations: int, resources: dict):
    """Phase 0's proof that a kernel runs on the tensor cores: HMMA
    instructions in the SASS of each instantiation of `kernel` in library
    `lib_name`, with ptxas's registers and spills from the build log and
    `resources` (the runtime's, from the kernel's info query). Raises unless
    there are `instantiations` of them, each with HMMA."""
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
            counts[name] = {op: part.count(op) for op in ("HMMA", "MUFU.EX2", "LDSM", "LDGSTS")}
    if len(counts) != instantiations or not all(c["HMMA"] for c in counts.values()):
        raise AssertionError(f"{kernel}'s SASS: {counts}; want HMMA in each of "
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
        )
        records["flash_attention"].append(rec)
        log("kernel", kernel="flash_attention", **rec)

    def conv_weight(w, dt):  # (in, out) matrix or HWIO -> OIHW, channels-last, in dt
        w = w.t()[:, :, None, None] if w.dim() == 2 else w.permute(3, 2, 0, 1)
        return w.to(dt).contiguous(memory_format=torch.channels_last)

    def block_yardstick(x, w1, b1, w2, b2, w3, b3, wd=None, bd=None):
        """K2's yardstick: cuDNN's convolutions of the block on channels-last
        x, plus the add and the relus (no library call fuses the block)."""
        xc = x.permute(0, 3, 1, 2)  # NHWC memory: a channels-last NCHW view
        h = F.relu(F.conv2d(xc, w1, b1))
        h = F.relu(F.conv2d(h, w2, b2, padding=1))
        h = F.conv2d(h, w3, b3)
        return F.relu(h + (xc if wd is None else F.conv2d(xc, wd, bd)))

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
            yard = {k: (t.to(dt) if k.startswith("b") else conv_weight(t, dt))
                    for k, t in w32.items()}
            rec = dict(
                block=label, shape=[B, H, W, cin], cmid=cmid, cout=cout, dtype=dtype,
                per_forward=per_forward, max_abs_err=err, tol=tol,
                ms=time_ms(torch, lambda: fr.fused_bottleneck_packed(x, packed)),
                plain_ms=time_ms(torch, lambda: fr.bottleneck_plain(x, **w)),
                library_ms=time_ms(torch, lambda: block_yardstick(x, **yard)),
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
        frames, w7c, bias_dt = video.to(dt).permute(0, 3, 1, 2), conv_weight(w7, dt), bias.to(dt)
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
    stage-1 training shapes. Returns per-kernel records."""
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
            plain_ms=time_ms(torch, lambda: fr.bottleneck_plain(x1, **w1)), library_ms=None,
            cost=fr.bottleneck_cost(t2.BATCH, t2.HEIGHT, t2.WIDTH, 256, 64, 256, False, 2)),
        "fused_layer1": dict(
            per=f"one call over layer1's 3 blocks {tuple(x0.shape)} -> 256, tile 8",
            ms=time_ms(torch, lambda: fr.fused_layer1(x0, blocks, tile_h=8)),
            plain_ms=time_ms(torch, lambda: fr.layer1_plain(x0, blocks)), library_ms=None,
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
    widths = {"translation": 3, "acceleration": 3, "rotation": 4, "rotation_rate": 3, "speed": 1}
    for key, width in widths.items():
        batch[key] = rng.standard_normal((BATCH, FRAMES, width), dtype=np.float32)
    return batch


def make_train_batch(seed: int):
    """bench_train.py's fabricated stage-1 batch at TRAIN_BATCH clips:
    centers scattered over the image, log-normal sizes, 10% of the 256
    slots active, 8 classes."""
    B, L, H, W, N = TRAIN_BATCH, FRAMES, TRAIN_HEIGHT, TRAIN_WIDTH, TRAIN_SLOTS
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


def trainer_train_kernels(torch, dev):
    """Phase 6's K4-K6 at both stages' shapes, f32, dropout 0.1: one call
    each against its plain version (phase 1b's tolerances), then each one's
    time beside the plain version's and its bound. Returns per-kernel
    records."""
    from future_od_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=dev).manual_seed(6)
    records = {name: [] for name in TRAIN_KERNELS}
    for label, BH, Nq, Nk, d, dv, per_step in TRAINER_ATTENTIONS:
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


def trainer_phase(torch):
    """Phase 6: the flagship's run script, its checks and its numbers.
    Returns (per-stage records, launch totals per kernel and stage)."""
    import importlib
    import tempfile

    from future_od_tpu_torch.data import loader as loader_module
    from future_od_tpu_torch.ops import _kernels
    from future_od_tpu_torch.runs import _helper
    from future_od_tpu_torch.runs._model import build_model
    from future_od_tpu_torch.runs.config import config
    from future_od_tpu_torch.train import trainer as trainer_module

    script = importlib.import_module(TRAINER_SCRIPT)
    dev = torch.device("cuda")
    kernel_records = trainer_train_kernels(torch, dev)
    log("6-trainer-train-kernels-vs-plain", ok=True, card=gpu_name_and_power(),
        records=kernel_records)
    set_gates(**TRAINER_GATES)
    saved_config = dict(config)
    probe = TrainerProbe(torch, _kernels)
    with tempfile.TemporaryDirectory() as tmp:
        config.update(checkpoint_path=os.path.join(tmp, "checkpoints"),
                      visualization_path=os.path.join(tmp, "visualization"))
        probe.install(trainer_module, loader_module)
        try:
            t0 = time.perf_counter()
            trainer = script.main(TRAINER_ARGV)
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
            probe.finish()
        finally:
            probe.restore()
            config.clear()
            config.update(saved_config)
        per_stage = check_trainer_run(torch, probe, trainer)
        per_stage["run_s"] = run_s

        # a fresh Trainer from the script's get_trainer, without --restart,
        # loads the checkpoint: equal to the trained one bit for bit
        args = script.build_parser().parse_args(TRAINER_ARGV)
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
        del fresh, final
        torch.cuda.empty_cache()

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

    # one profiled train step a stage, on its first batch, after every check
    set_gates(**TRAINER_GATES)
    core = trainer._model._model
    stages = {"backbone": core.separate_encoder.backbone,
              "encoder": core.separate_encoder.transformer, "detector": core.detector}
    for stage in TRAINER_STAGES:
        batch = probe.first[("train", stage)][0]
        per_stage[stage]["profile"] = profile_request(
            torch, lambda b: probe.inner["train"](b, 0), batch, stages)
    totals = {name: {TRAINER_STAGES[s][0]: probe.totals[s].get(name, 0) for s in TRAINER_STAGES}
              for name in MAIN_KERNELS}
    del trainer, probe, core, stages
    torch.cuda.empty_cache()
    return per_stage, totals, kernel_records


def check_trainer_run(torch, probe, trainer):
    """Phase 6's checks on a recorded run: each step call's launches, finite
    losses, matcher rounds, the AP dicts; and its numbers per stage."""
    num_classes = trainer._args.num_classes
    for call in probe.calls:
        want = TRAINER_LAUNCHES.get((call["mode"], call["stage"]))
        if want is None or call["launches"] != want:
            raise AssertionError(f"{call['mode']} at height {call['stage']}: launches "
                                 f"{call['launches']}, want {want}")
        if call["mode"] == "audit":
            continue
        loss, rounds = call["loss"].item(), call["rounds"].item()
        if not math.isfinite(loss) or (call["skipped"] is not None and call["skipped"].item()):
            raise AssertionError(f"{call['mode']} step at height {call['stage']}: loss {loss}")
        if rounds >= 1000:
            raise AssertionError(f"{call['mode']} step: the auction hit its round cap")
    for stage, (name, steps, batches) in TRAINER_STAGES.items():
        modes = [c["mode"] for c in probe.calls if c["stage"] == stage]
        want = {"train": steps, "eval": batches, "audit": 1 if stage == 448 else 0}
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
    if [s for s, _ in probe.aps] != [448, 448, 896, 896]:
        raise AssertionError(f"AP aggregations at {[s for s, _ in probe.aps]}")
    for _, ap in probe.aps:
        check_ap(ap, num_classes)
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
            **{k: rec[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "per")},
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
    for row in kernels:  # the launches on phase 6's run, by stage
        if row["name"] in trainer_counts:
            row["trainer_launches"] = trainer_counts[row["name"]]
        if row["name"] in trainer_records:
            row["trainer_calls"] = trainer_records[row["name"]]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
