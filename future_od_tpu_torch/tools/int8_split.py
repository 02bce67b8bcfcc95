"""Where the int8 backbone's time goes: a profiled request split by part.

`int8_backbone_split(model, infer, batch)` serves one request under
torch.profiler with a mark around each function of INT8_SPLIT_MARKS and
counts each device kernel for the innermost marked function that launched
it: K8 (the int8 convolution), the activations' ranges, their
quantization, the weights' smoothing and quantization (with the BN fold),
the residual add and relu, and layout copies (an `aten::contiguous` or
`aten::clone` between the kernel and its mark); a backbone kernel under no
mark is "other" (the stem's pool, casts). It returns the backbone's device
ms by part and in all, and the host ms its forward took under the profiler.
A name missing from the package (an older or newer `ops/quant.py`) is
skipped, so the same split runs on an earlier tree.

Run on the card (the int8 flagship at 2 clips x 3 frames of 896x1600,
random weights from seed 0; dynamic f32 and bf16, static f32 calibrated on
the request's batch; 3 requests each, then the split):

    python future_od_tpu_torch/tools/int8_split.py [--package-root DIR]

`--package-root` puts another checkout's package first on the path (the
parent commit's, unpacked with `git archive`), so one call can time both
trees on one card. `chip_smoke.py` phase 11b-c runs the same split.
"""
from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import time

# (module or class, function, part); the innermost marked caller of a kernel
# names its part
INT8_SPLIT_MARKS = (
    ("future_od_tpu_torch.ops.quant", "int8_conv_codes", "K8"),
    ("future_od_tpu_torch.ops.quant", "channel_range", "range"),
    ("future_od_tpu_torch.ops.quant", "smooth_factors", "range"),
    ("future_od_tpu_torch.ops.quant", "observe_channel_amax", "range"),
    ("future_od_tpu_torch.ops.quant", "_amax", "range"),
    ("future_od_tpu_torch.ops.quant", "quantize_codes", "quantize"),
    ("future_od_tpu_torch.ops.quant", "int8_conv_nonneg", "quantize"),
    ("future_od_tpu_torch.ops.quant", "int8_conv", "quantize"),
    ("future_od_tpu_torch.ops.quant", "int8_conv_nonneg_static", "quantize"),
    ("future_od_tpu_torch.ops.quant", "int8_conv_static", "quantize"),
    ("future_od_tpu_torch.ops.quant", "_conv_nonneg_core", "quantize"),
    ("future_od_tpu_torch.ops.quant", "_conv_signed_core", "quantize"),
    ("future_od_tpu_torch.ops.quant", "static_smooth_and_scale", "weights"),
    ("future_od_tpu_torch.ops.quant", "_smoothed_weights", "weights"),
    ("future_od_tpu_torch.ops.quant", "static_weights", "weights"),
    ("future_od_tpu_torch.ops.quant", "pack_int8_weights", "weights"),
    ("future_od_tpu_torch.ops.quant", "zero_point_correction", "weights"),
    ("future_od_tpu_torch.models.resnet", "_int8_conv", "weights"),
    ("future_od_tpu_torch.models.resnet.Bottleneck", "int8_forward", "residual"),
)
INT8_SPLIT_PARTS = ("K8", "range", "quantize", "weights", "residual", "layout", "other")
IMU_WIDTHS = {"translation": 3, "acceleration": 3, "rotation": 4, "rotation_rate": 3, "speed": 1}


def mark_owners():
    """[(owner, function name, part)] of INT8_SPLIT_MARKS that the importable
    package has."""
    found = []
    for path, attr, part in INT8_SPLIT_MARKS:
        mod_path, _, last = path.rpartition(".")
        owner = (getattr(importlib.import_module(mod_path), last) if last[0].isupper()
                 else importlib.import_module(path))
        if attr in owner.__dict__:
            found.append((owner, attr, part))
    return found


def int8_backbone_split(model, infer, batch) -> dict:
    """One request (after one unprofiled) with INT8_SPLIT_MARKS in place:
    the backbone's device ms and kernel count by part, beside its total and
    the host ms its forward took (under the profiler)."""
    import torch
    from torch.autograd import DeviceType

    backbone = model._model.separate_encoder.backbone
    patched = []
    for owner, attr, part in mark_owners():
        fn = owner.__dict__[attr]

        def marked(*a, _fn=fn, _part=part, **kw):
            with torch.profiler.record_function(f"int8split:{_part}"):
                return _fn(*a, **kw)
        setattr(owner, attr, marked)
        patched.append((owner, attr, fn))

    def enter(module, args):
        enter.mark = torch.profiler.record_function("int8split:backbone")
        enter.mark.__enter__()

    def leave(module, args, out):
        enter.mark.__exit__(None, None, None)

    handles = [backbone.register_forward_pre_hook(enter), backbone.register_forward_hook(leave)]
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    try:
        infer(batch)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=activities) as prof:
            infer(batch)
            torch.cuda.synchronize()
    finally:
        for handle in handles:
            handle.remove()
        for owner, attr, fn in reversed(patched):
            setattr(owner, attr, fn)
    split = {part: {"device_ms": 0.0, "kernels": 0} for part in INT8_SPLIT_PARTS}
    total, host_ms = 0.0, 0.0
    for e in prof.events():
        if e.device_type != DeviceType.CPU:
            continue
        if e.name == "int8split:backbone":
            host_ms += e.cpu_time_total / 1e3
        if not e.kernels:
            continue
        part, layout, p = None, False, e
        while p is not None:
            if p.name in ("aten::contiguous", "aten::clone"):
                layout = True
            if p.name.startswith("int8split:"):
                part = p.name[len("int8split:"):]
                break
            p = p.cpu_parent
        while p is not None and p.name != "int8split:backbone":
            p = p.cpu_parent
        if part is None or p is None:  # not in the backbone
            continue
        part = "layout" if layout else ("other" if part == "backbone" else part)
        ms = sum(k.duration for k in e.kernels) / 1e3
        split[part]["device_ms"] += ms
        split[part]["kernels"] += len(e.kernels)
        total += ms
    if split["K8"]["kernels"] == 0:
        raise AssertionError(f"the int8 split saw no K8 kernel: {split}")
    return {"backbone_device_ms": total, "backbone_host_ms": host_ms, "parts": split}


def request_batch(seed: int, clips: int = 2, frames: int = 3, height: int = 896,
                  width: int = 1600) -> dict:
    """A request's numpy batch: video N(0, 1) and the IMU signals, from seed."""
    import numpy as np

    rng = np.random.default_rng(seed)
    batch = {"video": rng.normal(size=(clips, frames, height, width, 3)).astype(np.float32)}
    for key, w in IMU_WIDTHS.items():
        batch[key] = rng.normal(size=(clips, frames, w)).astype(np.float32)
    return batch


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--package-root", default=os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))),
        help="the checkout whose future_od_tpu_torch is timed")
    parser.add_argument("--requests", type=int, default=3)
    args = parser.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.package_root))
    import torch

    if not torch.cuda.is_available():
        print("int8_split: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from future_od_tpu_torch.models.build import build_flagship
    from future_od_tpu_torch.models.st_detr import SpatioTemporalDETRArgs
    from future_od_tpu_torch.ops import _kernels
    from future_od_tpu_torch.train.step import calibrate_int8, make_inference_fn

    print(json.dumps({"package": os.path.dirname(_kernels.__file__),
                      "card": torch.cuda.get_device_name(0),
                      "build_s": _kernels.build_all()}), flush=True)
    for name in ("FUTURE_OD_FUSED_RESNET", "FUTURE_OD_FUSED_STEM", "FUTURE_OD_INT8_SKIP"):
        os.environ.pop(name, None)
    batch = request_batch(0)
    for label, static, dtypes in (("dynamic", False, ("f32", "bf16")), ("static", True, ("f32",))):
        model = build_flagship(SpatioTemporalDETRArgs(
            num_classes=8, num_queries=128, int8_backbone=not static, int8_static=static),
            generator=torch.Generator().manual_seed(0))
        if static:
            calibrate_int8(model, [batch])
        for dt in dtypes:
            if dt == "bf16":
                model.to(torch.bfloat16)
            infer = make_inference_fn(model)
            request_ms = []
            for _ in range(args.requests):
                t0 = time.perf_counter()
                infer(batch)
                torch.cuda.synchronize()
                request_ms.append((time.perf_counter() - t0) * 1e3)
            print(json.dumps({"run": f"{label} {dt}", "request_ms": request_ms,
                              **int8_backbone_split(model, infer, batch)}), flush=True)
        del model, infer
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
