"""ResNet stem variants at 896x1600, b12 x 2 frames, bf16, on one CUDA card.
(Port of tools/bench_stem.py.)

Every variant computes the stem's conv + relu + 3x3/2 max pool (BN folded
away: zero bias) on one batch, x ~ N(0, 1) and w7 ~ N(0, 0.1^2) from numpy
seed 0 as the TPU tool draws them. Rows, each timed and compared with the
first (relmax: max |Δ| over max |first|):

- `xla7x7`: the 7x7/2 conv as cuDNN runs it, relu, max_pool2d;
- `s2d_host`: the 4x4/1 conv over host-packed space-to-depth(2) input
  (12 channels) with the (4, 4, 12, 64) kernel;
- `s2d4_host`: the 3x3/1 conv over space-to-depth(4) input (48 channels)
  with the (3, 3, 48, 256) kernel, pooled in packed form
  (models/resnet.py::s2d4_stem_pool);
- `s2d4_p128`: the same with the 48 channels zero-padded to 128;
- `s2d4_im2col`: the same as one product over a 432-column patch matrix;
- `A`, `B`, `B16`: the stem from the unpacked video through kernels A, B and
  B16 (ops/stem_variants.py), the patch or pad construction included, as
  the TPU tool's jitted pallasA/B/B16 include it;
- `D`: kernel D over the 128-channel s2d(4) frames, with its pool.

The non-kernel rows run cuDNN and torch.matmul, where the TPU tool has XLA.
Times are device time per call (utils/timing.py). A row that raises stops the
run (the TPU tool printed FAILED and went on).

Run on the card:   python -m future_od_tpu_torch.tools.bench_stem
On the CPU (the TPU tool's interpret check at (2, 64, 96, 3) f32, through
the plain versions, untimed):  ... --check
"""
from __future__ import annotations

import argparse
import sys
from typing import List

import numpy as np
import torch
import torch.nn.functional as F

from future_od_tpu_torch.models.resnet import (
    s2d4_stem_pool,
    space_to_depth,
    space_to_depth4,
    stem_weights_to_s2d4,
    stem_weights_to_space_to_depth,
)
from future_od_tpu_torch.ops.stem_variants import (
    D_CIN,
    im2col_pool,
    im2col_pool16,
    im2col_pool_plain,
    matmul_pool,
    matmul_pool_plain,
    tap_conv,
    tap_conv_plain,
)
from future_od_tpu_torch.utils.device import DeviceLike, resolve_device
from future_od_tpu_torch.utils.timing import device_ms_chained

BATCH, HEIGHT, WIDTH = 24, 896, 1600  # b12 x 2 frames: the backbone's batch
CHECK_SHAPE = (2, 64, 96, 3)
CHECK_TOL = 2e-4  # the TPU tool's, f32 reformulations of one conv
# kernel D rounds both operands to bf16 (2^-9 relative each), so a product
# moves by up to 2^-8 of |x||w|; relu and the max pool do not grow that
D_ROUNDING = 2.0**-8


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def _oihw(w):
    return w.permute(3, 2, 0, 1)


def pool(a: torch.Tensor) -> torch.Tensor:
    """maxpool 3x3/2 pad 1 (-inf padding), NHWC."""
    return _nhwc(F.max_pool2d(_nchw(a), 3, 2, 1))


def xla7x7(x, w7):
    c = F.conv2d(_nchw(x), _oihw(w7.to(x.dtype)), stride=2, padding=3)
    return pool(_nhwc(F.relu(c)))


def xlaim2col(x, w7):
    w4 = stem_weights_to_space_to_depth(w7).to(x.dtype)
    s = space_to_depth(x)
    Hc, Wc = s.shape[1], s.shape[2]
    sp = F.pad(s, (0, 0, 2, 1, 2, 1))
    patches = torch.cat([sp[:, dy:dy + Hc, dx:dx + Wc] for dy in range(4) for dx in range(4)],
                        dim=-1)
    return pool(F.relu(patches @ w4.reshape(192, 64)))


def s2d_host(s, w4):
    c = F.conv2d(F.pad(_nchw(s), (2, 1, 2, 1)), _oihw(w4))
    return pool(_nhwc(F.relu(c)))


def xla_s2d(x, w7):
    return s2d_host(space_to_depth(x), stem_weights_to_space_to_depth(w7).to(x.dtype))


def s2d4_host(x48, w3):
    return s2d4_stem_pool(_nhwc(F.relu(F.conv2d(_nchw(x48), _oihw(w3), padding=1))))


def s2d4_im2col(x48, w3):
    B, hp, wp, c = x48.shape
    xp = F.pad(x48, (0, 0, 1, 1, 1, 1))
    pats = torch.cat([xp[:, di:di + hp, dj:dj + wp] for di in range(3) for dj in range(3)],
                     dim=-1)
    return s2d4_stem_pool(F.relu(pats @ w3.reshape(9 * c, -1)))


def a_operands(x, w7):
    """pallasA's operands: the (B, 2Hp+1, Js, 192) patches (columns padded
    to a multiple of 8), w (192, 64) in x's dtype, a zero f32 bias, and Wp."""
    w4 = stem_weights_to_space_to_depth(w7)
    s = space_to_depth(x)
    hp, wp = s.shape[1] // 2, s.shape[2] // 2
    sp = F.pad(s, (0, 0, 3, 1, 3, 1))
    nj = 2 * wp + 1
    jpad = (-nj) % 8
    patches = torch.cat(
        [F.pad(sp[:, di:di + 2 * hp + 1, dj:dj + nj], (0, 0, 0, jpad))
         for di in range(4) for dj in range(4)],
        dim=-1,
    )
    bias = torch.zeros(64, dtype=torch.float32, device=x.device)
    return patches, w4.reshape(192, 64).to(x.dtype), bias, wp


def b_operands(x, w7, channels: int = 12):
    """pallasB's (channels 12) or pallasB16's (16) operands: the s2d input
    padded by (3, 1) rows, (3, 1 + jpad) columns (and 12 -> 16 channels),
    w (16 * channels, 64) in x's dtype, a zero f32 bias, and Wp."""
    w4 = F.pad(stem_weights_to_space_to_depth(w7), (0, 0, 0, channels - 12))
    s = space_to_depth(x)
    wc = s.shape[2]
    jpad = (-(wc + 4)) % 8
    sp = F.pad(s, (0, channels - 12, 3, 1 + jpad, 3, 1))
    bias = torch.zeros(64, dtype=torch.float32, device=x.device)
    return sp, w4.reshape(16 * channels, 64).to(x.dtype), bias, wc // 2


def d_operands(x128, w3p):
    """pallasD's operands: x128 padded by 1 all round, w3p as (9, 128, 256) bf16."""
    return F.pad(x128, (0, 0, 1, 1, 1, 1)), w3p.reshape(9, D_CIN, -1).to(torch.bfloat16)


def kernel_cases(x, w7, bias):
    """{launch counter: (kernel wrapper, its plain version, operands)} of the
    four kernels on the operands built from video x and kernel w7, `bias`
    in place of the zero bias of A, B and B16."""
    patches, wa, _, wp = a_operands(x, w7)
    sp, wb, _, _ = b_operands(x, w7, 12)
    sp16, wb16, _, _ = b_operands(x, w7, 16)
    o = operands(x, w7)
    return {
        "stem_a": (matmul_pool, matmul_pool_plain, (patches, wa, bias, wp)),
        "stem_b": (im2col_pool, im2col_pool_plain, (sp, wb, bias, wp)),
        "stem_b16": (im2col_pool16, im2col_pool_plain, (sp16, wb16, bias, wp)),
        "stem_d": (tap_conv, tap_conv_plain, d_operands(o["x128"], o["w3p"])),
    }


def stem_a(x, w7, tile_p: int = 8):
    patches, w, bias, wp = a_operands(x, w7)
    return matmul_pool(patches, w, bias, wp, tile_p)


def stem_b(x, w7, tile_p: int = 8):
    sp, w, bias, wp = b_operands(x, w7, 12)
    return im2col_pool(sp, w, bias, wp, tile_p)


def stem_b16(x, w7, tile_p: int = 8):
    sp, w, bias, wp = b_operands(x, w7, 16)
    return im2col_pool16(sp, w, bias, wp, tile_p)


def stem_d(x128, w3p, tile_p: int = 8):
    """Kernel D's conv, then its pool (outside the kernel, as on the TPU)."""
    return s2d4_stem_pool(tap_conv(*d_operands(x128, w3p), tile_p))


def d_tolerance(x, w7):
    """Elementwise bound on |stem_d - xla7x7| in f32: D_ROUNDING of the
    pooled sum of |x||w| over each 7x7 window, plus CHECK_TOL."""
    mag = F.conv2d(_nchw(x.abs()), _oihw(w7.abs()), stride=2, padding=3)
    return D_ROUNDING * pool(_nhwc(mag)) + CHECK_TOL


def operands(x, w7):
    """The rows' inputs from one video x and 7x7 kernel w7 (f32): x12, x48,
    x128 and the s2d weights in x's dtype."""
    x48 = space_to_depth4(x)
    w3 = stem_weights_to_s2d4(w7).to(x.dtype)
    return dict(
        x12=space_to_depth(x), x48=x48, x128=F.pad(x48, (0, D_CIN - x48.shape[-1])),
        w4=stem_weights_to_space_to_depth(w7).to(x.dtype), w3=w3,
        w3p=F.pad(w3, (0, 0, 0, D_CIN - w3.shape[2])),
    )


def rows_of(x, w7):
    """(name, fn, input, weight) of every row, in the order they run."""
    o = operands(x, w7)
    return [
        ("xla7x7", xla7x7, x, w7),
        ("s2d_host", s2d_host, o["x12"], o["w4"]),
        ("s2d4_host", s2d4_host, o["x48"], o["w3"]),
        ("s2d4_p128", s2d4_host, o["x128"], o["w3p"]),
        ("s2d4_im2col", s2d4_im2col, o["x48"], o["w3"]),
        ("A", stem_a, x, w7),
        ("B", stem_b, x, w7),
        ("B16", stem_b16, x, w7),
        ("D", stem_d, o["x128"], o["w3p"]),
    ]


def make_inputs(shape, seed: int, device, dtype):
    """x ~ N(0, 1) in dtype and w7 ~ N(0, 0.1^2) f32, numpy-seeded as the
    TPU tool draws them."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(device, dtype)
    w7 = torch.from_numpy(rng.normal(size=(7, 7, shape[-1], 64)).astype(np.float32) * 0.1)
    return x, w7.to(device)


def run(device: DeviceLike = None) -> List[dict]:
    """Time every row at the TPU tool's shape; one record per row (name, ms,
    relmax)."""
    device = resolve_device(device)
    x, w7 = make_inputs((BATCH, HEIGHT, WIDTH, 3), 0, device, torch.bfloat16)
    print(f"== stem variants {tuple(x.shape)} {x.dtype} on {device} ==", flush=True)
    records, ref = [], None
    for name, fn, xin, win in rows_of(x, w7):
        out = fn(xin, win).float()
        if not bool(torch.isfinite(out).all()):
            raise AssertionError(f"{name}: non-finite output")
        if ref is None:
            ref = out
        relmax = ((out - ref).abs().max() / (ref.abs().max() + 1e-9)).item()
        del out
        ms = device_ms_chained(fn, xin, win)
        print(f"  {name:12s} {ms:8.3f} ms   relmax={relmax:.2e}", flush=True)
        records.append(dict(name=name, ms=ms, relmax=relmax))
    print("DONE", flush=True)
    return records


def check() -> List[dict]:
    """The TPU tool's interpret check on the CPU through the plain versions:
    every row against xla7x7 at CHECK_SHAPE in f32, within CHECK_TOL, D
    within `d_tolerance`. Returns (name, max abs error) records."""
    x, w7 = make_inputs(CHECK_SHAPE, 2, "cpu", torch.float32)
    ref = xla7x7(x, w7)
    extra = [("xlaim2col", xlaim2col, x, w7), ("xla_s2d", xla_s2d, x, w7)]
    records = []
    for name, fn, xin, win in extra + rows_of(x, w7)[1:]:
        diff = (fn(xin, win) - ref).abs()
        tol = d_tolerance(x, w7) if name == "D" else torch.full_like(ref, CHECK_TOL)
        err = diff.max().item()
        print(f"{name}: maxerr={err:.2e}", flush=True)
        if not bool((diff <= tol).all()):
            raise AssertionError(f"{name}: max error {err} beyond its tolerance")
        records.append(dict(name=name, max_abs_err=err))
    print("interpret check OK", flush=True)
    return records


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--check", action="store_true",
                        help="the interpret check on the CPU through the plain versions")
    args = parser.parse_args(argv)
    if args.check:
        check()
    else:
        run()
    return 0


if __name__ == "__main__":
    sys.exit(main())
