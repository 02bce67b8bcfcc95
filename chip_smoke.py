#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (future_od_tpu_torch) on one NVIDIA GPU.

Run from the repo root: `python3 chip_smoke.py`. It needs one CUDA card and
nvcc; the kernels are built from future_od_tpu_torch/csrc/ on first use into
build/torch_kernels/. Phases, one line each, every failure fatal:

0. the card's name and power limit (nvidia-smi); the kernel build and its
   seconds.
1. each kernel against its plain PyTorch version at the flagship's shapes,
   f32 (TF32 off for matmuls and cuDNN convs) and bf16: max abs error
   within the stated tolerance, the kernel's time, the plain version's, one
   library call's where PyTorch has one, and the least time the card could
   take for the same work.
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
4. a `kernels` JSON line, then the device JSON line, last.

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

import json
import math
import os
import subprocess
import sys
import time

import numpy as np

# Peaks of one H100 SXM (NVIDIA data sheet, dense): f32 on the CUDA cores,
# bf16 on the tensor cores, HBM3 bandwidth.
PEAK_OPS = {"float32": 67e12, "bfloat16": 989e12}
PEAK_BYTES = 3.35e12

GATES = (
    "FUTURE_OD_DISABLE_FLASH", "FUTURE_OD_FLASH_MIN_KEYS", "FUTURE_OD_FLASH_MIN_QUERIES",
    "FUTURE_OD_FUSED_RESNET", "FUTURE_OD_FUSED_STEM", "FUTURE_OD_FUSE_STAGES",
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
TOP_KERNELS = 8


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


def check_close(name, out, ref, dtype):
    """(max abs error, its tolerance at that element's worst case); raises
    where any element is outside RTOL * |plain| + ATOL * max |plain|."""
    out, ref = out.float(), ref.float()
    diff = (out - ref).abs()
    tol = KERNEL_RTOL[dtype] * ref.abs() + KERNEL_ATOL[dtype] * ref.abs().max()
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
        b_ms, b_by = bound(ops, nbytes, dtype)
        rec = dict(
            shape=list(shape), dtype=dtype, per_forward=6, max_abs_err=err, tol=tol,
            ms=time_ms(torch, lambda: fa.flash_attention(q, k, v, scale)),
            plain_ms=time_ms(torch, lambda: fa.reference_attention(q, k, v, scale)),
            library_ms=time_ms(
                torch, lambda: F.scaled_dot_product_attention(q, k, v, scale=scale)
            ),
            bound_ms=b_ms, bound_by=b_by, ops=ops, bytes=nbytes,
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
            out = fr.fused_bottleneck(x, **w)
            ref = fr.bottleneck_plain(x, **w)
            err, tol = check_close(f"fused_bottleneck {label}", out, ref, dtype)
            ops, nbytes = fr.bottleneck_cost(B, H, W, cin, cmid, cout, ds, x.element_size())
            b_ms, b_by = bound(ops, nbytes, dtype)
            rec = dict(
                block=label, shape=[B, H, W, cin], cmid=cmid, cout=cout, dtype=dtype,
                per_forward=per_forward, max_abs_err=err, tol=tol,
                ms=time_ms(torch, lambda: fr.fused_bottleneck(x, **w)),
                plain_ms=time_ms(torch, lambda: fr.bottleneck_plain(x, **w)),
                library_ms=None, bound_ms=b_ms, bound_by=b_by, ops=ops, bytes=nbytes,
            )
            records["fused_bottleneck"].append(rec)
            log("kernel", kernel="fused_bottleneck", **rec)

    # K3: the 896x1600 stem over space-to-depth input.
    video = randn(n_img, HEIGHT, WIDTH, 3)
    xs32 = space_to_depth(video)
    w4_32 = stem_weights_to_space_to_depth(randn(7, 7, 3, 64, scale=math.sqrt(2 / 147)))
    bias = randn(64, scale=0.1)
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        xs, w4 = xs32.to(dt), w4_32.to(dt)
        out = fr.fused_stem(xs, w4, bias)
        ref = fr.stem_plain(xs, w4, bias)
        err, tol = check_close("fused_stem", out, ref, dtype)
        ops, nbytes = fr.stem_cost(n_img, HEIGHT // 2, WIDTH // 2, xs.element_size())
        b_ms, b_by = bound(ops, nbytes, dtype)
        rec = dict(
            shape=list(xs.shape), dtype=dtype, per_forward=1, max_abs_err=err, tol=tol,
            ms=time_ms(torch, lambda: fr.fused_stem(xs, w4, bias)),
            plain_ms=time_ms(torch, lambda: fr.stem_plain(xs, w4, bias)),
            library_ms=None, bound_ms=b_ms, bound_by=b_by, ops=ops, bytes=nbytes,
        )
        records["fused_stem"].append(rec)
        log("kernel", kernel="fused_stem", **rec)
    torch.cuda.synchronize()
    return records


def make_batch(seed: int):
    rng = np.random.default_rng(seed)
    batch = {
        "video": rng.standard_normal((BATCH, FRAMES, HEIGHT, WIDTH, 3), dtype=np.float32)
    }
    widths = {"translation": 3, "acceleration": 3, "rotation": 4, "rotation_rate": 3, "speed": 1}
    for key, width in widths.items():
        batch[key] = rng.standard_normal((BATCH, FRAMES, width), dtype=np.float32)
    return batch


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
        self.events, self.values = {}, {}

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


def profile_request(torch, infer, batch):
    """One request under torch.profiler: the union of the card's kernel and
    copy time ranges, the share of the request's wall time it ran none, and
    the kernels with the most device time."""
    from torch.autograd import DeviceType

    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        infer(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    def on_device(events):  # without CUPTI's own buffer bookkeeping
        return [e for e in events
                if e.device_type == DeviceType.CUDA and not e.key.startswith("Activity Buffer")]

    busy, end = 0.0, float("-inf")
    for s, e in sorted((e.time_range.start, e.time_range.end) for e in on_device(prof.events())):
        if e > end:
            busy += e - max(s, end)
            end = e
    top = sorted(on_device(prof.key_averages()), key=lambda e: e.self_device_time_total,
                 reverse=True)[:TOP_KERNELS]
    if busy <= 0:
        raise AssertionError("the profiler saw no device activity in a request")
    return {
        "profiled_request_ms": wall_ms, "busy_ms": busy / 1e3,
        "idle_share": 1.0 - busy / 1e3 / wall_ms,
        "top_kernels": [{"name": e.key[:90], "calls": e.count,
                         "device_ms": e.self_device_time_total / 1e3} for e in top],
    }


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

    t0 = time.perf_counter()
    records = kernel_phase(torch, torch.device("cuda"))
    log("1-kernels-vs-plain", ok=True, seconds=time.perf_counter() - t0)

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
    main_counts = dict(_kernels.launch_counts)
    check_output(torch, out, args.num_queries, args.num_classes)
    if main_counts["flash_attention"] != 6 * REQUESTS or main_counts["fused_bottleneck"] \
            or main_counts["fused_stem"]:
        raise AssertionError(f"default gates: launches {main_counts}, want flash 6/forward")
    log("2-flagship-f32", ok=True, requests=REQUESTS, request_s=seconds,
        launches=main_counts, stage_ms=taps.stage_ms(),
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
        profile=profile_request(torch, infer, batch), seconds=time.perf_counter() - t0)

    t0 = time.perf_counter()
    set_gates(FUTURE_OD_FUSED_RESNET="1", FUTURE_OD_FUSED_STEM="1")
    _kernels.reset_launch_counts()
    fused, fused_s = forward(torch, infer, batch, REQUESTS)
    fused_counts = dict(_kernels.launch_counts)
    want = {"flash_attention": 6, "fused_bottleneck": 6, "fused_stem": 1}
    if fused_counts != {k: n * REQUESTS for k, n in want.items()}:
        raise AssertionError(f"fused gates: launches {fused_counts}, want {want} per forward")
    check_output(torch, fused, args.num_queries, args.num_classes)
    fused_values, fused_stages = dict(taps.values), taps.stage_ms()
    fused_profile = profile_request(torch, infer, batch)
    set_gates(FUTURE_OD_DISABLE_FLASH="1")
    _kernels.reset_launch_counts()
    plain, plain_s = forward(torch, infer, batch, 2)
    if any(_kernels.launch_counts.values()):
        raise AssertionError(f"all-plain forward launched {_kernels.launch_counts}")
    diffs = {
        "encoder_out_rel": max_rel(fused_values["encoder_out"], taps.values["encoder_out"]),
        "decoder_out_rel": max_rel(fused_values["decoder_out"], taps.values["decoder_out"]),
        "score_err": (fused["class_scores"] - plain["class_scores"]).abs().max().item(),
        "box_err_px": (fused["boxes"] - plain["boxes"]).abs().max().item(),
    }
    tols = {"encoder_out_rel": ENCODER_RTOL, "decoder_out_rel": DECODER_RTOL,
            "score_err": SCORE_TOL, "box_err_px": BOX_TOL_PX}
    log("3-fused-vs-plain-f32", **diffs, tolerances=tols,
        score_range=[plain["class_scores"].min().item(), plain["class_scores"].max().item()],
        box_std_px=plain["boxes"].std().item(), fused_request_s=fused_s,
        plain_request_s=plain_s, launches=fused_counts, stage_ms=fused_stages,
        profile=fused_profile)
    if not all(diffs[k] <= tols[k] for k in tols):
        raise AssertionError("fused forward differs from the all-plain forward")

    model.to(torch.bfloat16)
    set_gates(FUTURE_OD_FUSED_RESNET="1", FUTURE_OD_FUSED_STEM="1")
    _kernels.reset_launch_counts()
    bf16, bf16_s = forward(torch, infer, batch, REQUESTS)
    bf16_counts = dict(_kernels.launch_counts)
    if bf16_counts != {k: n * REQUESTS for k, n in want.items()}:
        raise AssertionError(f"bf16 fused: launches {bf16_counts}")
    check_output(torch, bf16, args.num_queries, args.num_classes)
    log("3-flagship-bf16", ok=True, request_s=bf16_s, launches=bf16_counts,
        stage_ms=taps.stage_ms(),
        score_diff_vs_f32=(bf16["class_scores"].float() - fused["class_scores"]).abs().max().item(),
        box_diff_vs_f32_px=(bf16["boxes"].float() - fused["boxes"]).abs().max().item(),
        profile=profile_request(torch, infer, batch), seconds=time.perf_counter() - t0)
    torch.cuda.synchronize()

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
        b_ms, b_by = bound(per_fwd("ops"), per_fwd("bytes"), "float32")
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"future_od_tpu_torch/csrc/{name}.cu",
            "replaces": sources[name], "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in f32),
            "ms": per_fwd("ms"), "plain_ms": per_fwd("plain_ms"),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None if None in lib else per_fwd("library_ms"),
            "per": f"one f32 forward's launches, {BATCH} clips x {FRAMES - 1} past frames "
                   f"x {HEIGHT}x{WIDTH}",
            "calls": recs,
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
