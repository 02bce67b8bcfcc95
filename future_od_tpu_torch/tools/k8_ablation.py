"""Where K8's time goes, without a profiler of the kernel's insides: copies
of `csrc/int8_conv.cu` with one piece of work removed each, built in
parallel (one nvcc each) and timed at trunk shapes of the int8 flagship (4
frames at 896x1600, f32 out) against the unchanged source.

- `base`: the source as it is;
- `no_store`: the epilogue's TMA stores dropped (values computed and staged);
- `no_epilogue`: the whole epilogue skipped (the main loop alone);
- `no_mma`: the wgmma instructions dropped (loads, gathers and epilogue stay).

The copies compute wrong outputs: only their times mean anything. Each is
timed by CUDA events over back-to-back launches through its C entry point
(no wrapper), so the times are the device's. A removal whose text is no
longer in the source raises: update the tool with the kernel.

Run on the card:  python -m future_od_tpu_torch.tools.k8_ablation
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys

ABLATIONS = {
    "base": (),
    "no_store": (("        tma_store(out_map, n0 + box * kBoxCols, m0, "
                  "smem_addr(staging + box * kBoxBytes));", "        ;"),),
    "no_epilogue": (("  if (t == 0) bulk_wait_read();  // the group's last stores have read "
                     "the staging tile", "  return;"),),
    "no_mma": (("        wgmma<kBN>(acc, sw128_desc(a) + 2 * k, sw128_desc(b) + 2 * k);",
                "        ;"),
               ("      wgmma<kBN>(acc, sw128_desc(a) + 2 * k, sw128_desc(b) + 2 * k);",
                "      ;")),
}
# (name, B, H, W, Cin, kernel, Cout, stride, padding, pad value): the TMA
# kernel's output-heavy and deep-K 1x1s, the gather's 3x3s at both tile
# widths, a strided downsample and the 7x7 stem
SHAPES = (
    ("layer1.0.conv3", 4, 224, 400, 64, 1, 256, 1, 0, -128),
    ("layer3.1.conv1", 4, 56, 100, 1024, 1, 256, 1, 0, -128),
    ("layer1.0.conv2", 4, 224, 400, 64, 3, 64, 1, 1, -128),
    ("layer3.1.conv2", 4, 56, 100, 256, 3, 256, 1, 1, -128),
    ("layer2.0.downsample", 4, 224, 400, 256, 1, 512, 2, 0, -128),
    ("stem (7x7/2)", 4, 896, 1600, 3, 7, 64, 2, 3, 0),
)
CALLS = 30


def build(out_dir) -> dict:
    """{ablation: loaded library}, each built from an edited copy."""
    from future_od_tpu_torch.ops import _kernels

    source = (_kernels.CSRC_DIR / "int8_conv.cu").read_text()
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, edits in ABLATIONS.items():
        text = source
        for old, new in edits:
            if old not in text:
                raise ValueError(f"k8_ablation {name}: {old.strip()[:60]!r} is not in the source")
            text = text.replace(old, new)
        path = out_dir / f"{name}.cu"
        path.write_text(text)
        cmd = [_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-I", str(_kernels.CSRC_DIR), "-o",
               str(out_dir / f"{name}.so"), str(path)]
        jobs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True)
    libs = {}
    for name, proc in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"k8_ablation {name}: nvcc failed:\n{log[-3000:]}")
        lib = ctypes.CDLL(str(out_dir / f"{name}.so"))
        lib.fod_int8_conv.argtypes = _kernels.KERNELS["int8_conv"]["fod_int8_conv"]
        lib.fod_int8_conv.restype = ctypes.c_int
        libs[name] = lib
    return libs


def main(argv=None) -> int:
    import torch

    from future_od_tpu_torch.ops import _kernels
    from future_od_tpu_torch.ops import int8_conv as k8

    if not torch.cuda.is_available():
        print("k8_ablation: needs a CUDA card", file=sys.stderr)
        return 1
    libs = build(_kernels.BUILD_DIR.parent / "k8_ablation")
    dev = torch.device("cuda")
    print(json.dumps({"card": torch.cuda.get_device_name(0), "ablations": list(libs)}))
    for name, B, H, W, C, ks, Co, st, pad, pad_value in SHAPES:
        g = torch.Generator(device=dev).manual_seed(0)
        q = torch.randint(-128, 128, (B, H, W, C), dtype=torch.int8, device=dev, generator=g)
        wq = torch.randint(-127, 128, (ks, ks, C, Co), dtype=torch.int8, device=dev, generator=g)
        w = k8.pack_int8_weights(wq)
        zp = k8.zero_point_correction(wq)
        sw = torch.rand(Co, device=dev, generator=g) * 1e-4
        bias = torch.randn(Co, device=dev, generator=g)
        Ho, Wo = (H + 2 * pad - ks) // st + 1, (W + 2 * pad - ks) // st + 1
        out = torch.empty((B, Ho, Wo, Co), device=dev)
        args = (q.data_ptr(), w.wt.data_ptr(), zp.data_ptr(), sw.data_ptr(), bias.data_ptr(),
                out.data_ptr(), B, H, W, C, Ho, Wo, Co, ks, ks, st, st, pad, pad, 1, 1,
                w.wt.shape[1], pad_value, 1, _kernels.DTYPE_CODES[torch.float32],
                _kernels.stream_of(q))
        row = {}
        for ablation, lib in libs.items():
            for _ in range(3):
                if lib.fod_int8_conv(*args):
                    raise RuntimeError(f"k8_ablation {ablation} {name}: launch failed")
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(CALLS):
                lib.fod_int8_conv(*args)
            end.record()
            torch.cuda.synchronize()
            row[ablation] = start.elapsed_time(end) / CALLS
        print(json.dumps({"shape": name, "ms": row}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
