"""Build, load and launch the port's CUDA kernels, and build and load its
host C++ libraries.

Every kernel is CUDA C++ for Hopper under `future_od_tpu_torch/csrc/`, with a
plain C entry point. At first use all kernel libraries are compiled from
those sources — one `nvcc` per source, all started together — into
`build/torch_kernels/` at the root of the checkout (listed in .gitignore),
and loaded with ctypes. The port runs from a checkout: an installed copy
would have neither the sources nor a writable build directory beside it. A library's file name carries a hash of its sources and flags,
so an edited source is rebuilt and an unchanged one is reused.

Each entry point returns the `cudaGetLastError()` code of its launch; the
wrappers raise when it is not 0. `launch_counts` holds one counter per
kernel entry point (its name without the `fod_` prefix), which its wrapper
increments where it launches the kernel and nowhere else; `chip_smoke.py`
reads them to show the main path went through the kernels.

The host libraries (`HOST_LIBRARIES`: the JPEG decoder, the resizes and the
normalization; the exact assignment solver) are plain C++ built with g++,
which both the CPU-only test machines and the card's machine have, so they
run and are tested everywhere.

Nothing here runs at import time: the CPU tests import every module, and
a machine without a card has no nvcc.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional

import torch

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xptxas=-v",
    "-shared", "-Xcompiler", "-fPIC",
)

_P, _I, _F, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint32
# dropout: seed, threshold, keep value, nq_pad, nk_pad
_DROPOUT = [_U, _U, _F, _I, _I]
# kernel library (csrc/<name>.cu) -> {C entry point: argtypes}
KERNELS: Dict[str, Dict[str, list]] = {
    # q, k, v, out, bh, nq, nk, d, dv, scale*log2(e), dtype, stream
    "flash_attention": {
        "fod_flash_attention": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _P],
        # d, dv, dtype, int[5] out (launches nothing)
        "fod_flash_attention_info": [_I, _I, _I, _P],
    },
    # x, w1, b1, w2, b2, w3, b3, wd, bd, w1t, w2t, out, B, H, W, cin, cmid, cout, dtype,
    # stream
    "fused_bottleneck": {
        "fod_fused_bottleneck": [_P] * 12 + [_I] * 7 + [_P],
        # cmid, dtype, downsample, int[5] out (launches nothing)
        "fod_fused_bottleneck_info": [_I, _I, _I, _P],
    },
    # x_s2d, packed w, bias, out, B, Hc, Wc, dtype, stream
    "fused_stem": {
        "fod_fused_stem": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
        # dtype, int[5] out (launches nothing)
        "fod_fused_stem_info": [_I, _P],
    },
    "flash_attention_train": {
        # one packed TrainArgs (ops/flash_attention.py::_TRAIN_ARGS)
        "fod_flash_train_fwd": [ctypes.c_char_p],
        "fod_flash_train_dq": [ctypes.c_char_p],
        "fod_flash_train_dkv": [ctypes.c_char_p],
        # which (0 K4, 1 K5, 2 K6), d, dv, dtype, bh, nq, nk, int[9] out (launches nothing)
        "fod_flash_train_info": [_I] * 7 + [_P],
        # out, bh, nq, nk, dropout..., h_local, h_full, h0, stream
        "fod_dropout_keep_mask": [_P, _I, _I, _I] + _DROPOUT + [_I, _I, _I, _P],
    },
    # q, k, v, out, bh, nq, nk, nk_pad, block_k, scale*log2(e), mode, dtype, stream
    "attention_floor": {
        "fod_attention_floor": [_P] * 4 + [_I] * 5 + [_F, _I, _I, _P],
        # mode, dtype, int[5] out (launches nothing)
        "fod_attention_floor_info": [_I, _I, _P],
    },
    "bottleneck_variants": {
        # x, w1, b1, w2, b2, w3, b3, wd, bd, w1t, w2t, out, B, H, W, cin, cmid, cout,
        # tile_h, im2col, dtype, stream
        "fod_bottleneck_v2": [_P] * 12 + [_I] * 9 + [_P],
        # x, 30 weight pointers, out, B, H, W, cin, tile_h, dtype, stream
        "fod_fused_layer1": [_P] * 3 + [_I] * 6 + [_P],
        # layer1, tile_h, cmid, im2col, downsample, dtype, int[8] out (launches nothing)
        "fod_bottleneck_plan": [_I] * 6 + [_P],
    },
    # q, w, zp, sw, bias, out, B, H, W, Cin, Ho, Wo, Cout, KH, KW, sh, sw, pt, pl, dh,
    # dw, Kp, pad_value, relu, dtype, stream
    "int8_conv": {
        "fod_int8_conv": [_P] * 6 + [_I] * 19 + [_P],
        # dtype, variant, bn, int[5] out (launches nothing)
        "fod_int8_conv_info": [_I, _I, _I, _P],
    },
    "int8_quantize": {
        # x, out, n, C, absolute, dtype, stream
        "fod_int8_channel_range": [_P, _P, ctypes.c_int64, _I, _I, _I, _P],
        # x, m, scale, q, n, C, zero_point, dtype, stream
        "fod_int8_quantize": [_P] * 4 + [ctypes.c_int64, _I, _I, _I, _P],
    },
    "stem_variants": {
        # patches / sp, w, bias, out, B, Hp, Wp, Js, dtype, stream
        "fod_stem_a": [_P] * 4 + [_I] * 5 + [_P],
        "fod_stem_b": [_P] * 4 + [_I] * 5 + [_P],
        "fod_stem_b16": [_P] * 4 + [_I] * 5 + [_P],
        # xp, w9, out, B, Hp, Wp, dtype, stream
        "fod_stem_d": [_P] * 3 + [_I] * 4 + [_P],
        # dtype, int[5] out (launches nothing)
        "fod_stem_d_info": [_I, _P],
    },
}
# host libraries (csrc/<name>.cpp, no CUDA): built with g++, here and on the
# card's machine alike; {C entry point: (argtypes, restype)}
GXX_FLAGS = ("-std=c++17", "-O3", "-shared", "-fPIC", "-ffp-contract=off")
HOST_LIBRARIES: Dict[str, Dict[str, tuple]] = {
    "jpeg_decode": {
        # data, size, int* height, int* width, int* components
        "fod_jpeg_header": ([_P, ctypes.c_int64, _P, _P, _P], _I),
        # data, size, out (H, W, 3) uint8, height, width
        "fod_jpeg_decode": ([_P, ctypes.c_int64, _P, _I, _I], _I),
        # src, sh, sw, cn, dst, dh, dw
        "fod_resize_linear_u8": ([_P, _I, _I, _I, _P, _I, _I], None),
        "fod_resize_linear_f32": ([_P, _I, _I, _I, _P, _I, _I], None),
        # src uint8, pixels, channels, mean, std, dst float32
        "fod_normalize_u8": ([_P, ctypes.c_int64, _I, _P, _P, _P], None),
    },
    # the exact assignment solver (ops/native_lap.py): rows, cols, cost
    # (rows, cols) float64, int32 column of each row out
    "lap": {"lap_solve": ([_I, _I, _P, _P], _I)},
}
# entry points that launch no kernel, so have no launch counter
QUERIES = ("fod_attention_floor_info", "fod_bottleneck_plan", "fod_flash_attention_info",
           "fod_flash_train_info", "fod_fused_bottleneck_info", "fod_fused_stem_info",
           "fod_int8_conv_info", "fod_stem_d_info")

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

launch_counts: Dict[str, int] = {
    fn[len("fod_"):]: 0 for entries in KERNELS.values() for fn in entries if fn not in QUERIES
}

_libs: Dict[str, ctypes.CDLL] = {}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (neither on PATH nor under CUDA_HOME); the port's "
            "CUDA kernels are built from csrc/ at first use"
        )
    return path


def library_path(name: str) -> Path:
    digest = hashlib.sha256()
    for src in sorted(CSRC_DIR.glob("*.cuh")) + [CSRC_DIR / f"{name}.cu"]:
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build_all() -> float:
    """Compile every kernel library that is not built yet, one nvcc process
    per source, all running at once. Returns the wall seconds spent. The
    compiler's output (ptxas register and shared-memory report included)
    goes to build/torch_kernels/<name>.log."""
    missing = [name for name in KERNELS if not library_path(name).exists()]
    if not missing:
        return 0.0
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    start = time.perf_counter()
    jobs = []
    for name in missing:
        out = library_path(name)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC_DIR), "-o", str(tmp),
               str(CSRC_DIR / f"{name}.cu")]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        jobs.append((name, out, tmp, proc))
    failed = []
    for name, out, tmp, proc in jobs:
        log, _ = proc.communicate()
        (BUILD_DIR / f"{name}.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log[-4000:]}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - start


def host_library_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC_DIR / f"{name}.cpp").read_bytes())
    digest.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def host_library(name: str) -> ctypes.CDLL:
    """The loaded host library `name` (`HOST_LIBRARIES`), compiled with g++
    from csrc/<name>.cpp at first use (a few seconds) into the build
    directory. Processes that build it at once (loader workers) each write a
    temporary file and rename it into place."""
    lib = _libs.get(name)
    if lib is None:
        path = host_library_path(name)
        if not path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
            gxx = shutil.which("g++") or shutil.which("c++")
            if gxx is None:
                raise RuntimeError(f"g++ not found: {name} is built from csrc/{name}.cpp")
            proc = subprocess.run([gxx, *GXX_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cpp")],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"{name} build failed:\n{proc.stderr[-4000:]}")
            os.replace(tmp, path)
        lib = ctypes.CDLL(str(path))
        for fn, (argtypes, restype) in HOST_LIBRARIES[name].items():
            entry = getattr(lib, fn)
            entry.argtypes, entry.restype = argtypes, restype
        _libs[name] = lib
    return lib


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library `name`, building all libraries first if
    needed."""
    lib = _libs.get(name)
    if lib is None:
        build_all()
        lib = ctypes.CDLL(str(library_path(name)))
        for fn, argtypes in KERNELS[name].items():
            entry = getattr(lib, fn)
            entry.argtypes = argtypes
            entry.restype = ctypes.c_int
        lib.fod_error_string.argtypes = [ctypes.c_int]
        lib.fod_error_string.restype = ctypes.c_char_p
        _libs[name] = lib
    return lib


def call(name: str, fn: str, *args, device: Optional[torch.device] = None) -> None:
    """Launch through entry point `fn` of library `name` (ctypes keeps an
    entry point as an attribute after its first lookup); raise on a
    non-zero launch status (a refused launch never runs, and a later
    synchronize would not report it). The entry points launch on the
    current device (and keep their per-device attributes there), so a
    launch on operands of `device` makes it current for the call: an
    operand on cuda:1 while cuda:0 is current would otherwise get a launch
    on cuda:0 with cuda:1's stream."""
    lib = library(name)
    if device is None or device.index is None or device.index == torch.cuda.current_device():
        code = getattr(lib, fn)(*args)
    else:
        with torch.cuda.device(device):
            code = getattr(lib, fn)(*args)
    if code != 0:
        msg = lib.fod_error_string(code).decode()
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {code}: {msg}")


def stream_of(t: torch.Tensor) -> int:
    """The raw handle of the current stream on CUDA tensor t's device,
    without building a torch.cuda.Stream object."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def check_cuda_device(name: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor lies on one CUDA device."""
    device = tensors[0].device
    for t in tensors:
        if t.device != device or t.device.type != "cuda":
            raise ValueError(f"{name}: operands must share one CUDA device, got {t.device}")


def check_cuda_operands(name: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor on one device."""
    check_cuda_device(name, *tensors)
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
