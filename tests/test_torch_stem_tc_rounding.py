"""The rounding of the tensor-core fused stem (csrc/fused_stem.cu), emulated
on the CPU and held to the tolerances its check on the card uses
(chip_smoke.py phase 1).

The kernel is an implicit GEMM: M = conv positions, N = 64, K = 192 rows in
(dy, dx, c) order, each position's A row read from the staged NHWC window.
The kernel cannot run here, but what it rounds can: this file emulates it in
torch, `mma.sync` by `mma.sync` (tests/test_torch_flash_tc_rounding.py's
model: each `mma.sync` adds its exact products to its accumulator and rounds
the sum toward zero to f32):

- bf16 storage: the window and the weights as stored, k-steps of 16;
- f32 storage, 3xTF32: each operand split into tf32 big + small, the products
  big·small + small·big + big·big on k-steps of 8;
- in both, every 32 reduction rows sum into a fresh accumulator that is added
  to the running one in f32, rounding to nearest; then relu(acc + bias) is
  rounded to the storage type, positions outside the conv output are -inf,
  and each pool takes its 3x3/2 max. A conv position's value does not depend
  on the tile that computes it, so the whole image is emulated at once.

At tests/test_torch_kernels_cuda.py::test_fused_stem's shapes and inputs
(videos of 2 x 64x96 and 1 x 40x72, the 7x7 weights N(0, 0.1) transformed
to s2d, biases N(0, 0.1)), each emulation must lie within chip_smoke.py
phase 1's tolerance of the port's plain version (`stem_plain`), and at
phase 1's weight scales too; once, at 2 x 64x96, within it of the JAX
package's `fused_stem` in interpret mode. The worst ratios (error over
tolerance) this file measures: 0.034 (f32) and 0.200 (bf16: one of the
49152 outputs a bf16 ulp off, at phase 1's weights; none at 0.1) against the
plain version, 0.034 and 0 against the JAX kernel (which the plain version
equals to within 0 of the tolerance). A negative control: one TF32 product
(no split) puts the f32 output at 15 times its tolerance. `pack_stem`'s
fragment order is checked by reading the weights back as the kernel's lanes
load them.

About 7 s alone, 12 s with the imports (`JAX_PLATFORMS=cpu python -m pytest
tests/test_torch_stem_tc_rounding.py -q`).
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from future_od_tpu.ops.fused_resnet import fused_stem as jax_fused_stem

from future_od_tpu_torch.models.resnet import space_to_depth, stem_weights_to_space_to_depth
from future_od_tpu_torch.ops.fused_resnet import STEM_K, pack_stem, stem_plain
from test_torch_flash_tc_rounding import (  # noqa: F401 (one_torch_thread: autouse)
    mma_chain,
    one_torch_thread,
    parts_1xtf32,
    parts_3xtf32,
    parts_as_stored,
    tolerance_ratio,
)

FRESH_ROWS = 32  # reduction rows the kernel sums into a fresh accumulator
K_STEP = {torch.float32: 8, torch.bfloat16: 16}
DESIGNS = {torch.float32: parts_3xtf32, torch.bfloat16: parts_as_stored}


def patches(x_s2d) -> torch.Tensor:
    """(B, Hc, Wc, 12) -> (B * Hc * Wc, 192): each conv position's A row in
    the kernel's K order (dy, dx, c), from the input zero-padded by (2, 1) in
    H and W (conv row r reads input rows r - 2 .. r + 1)."""
    B, Hc, Wc, _ = x_s2d.shape
    xp = F.pad(x_s2d.float(), (0, 0, 2, 1, 2, 1))
    taps = [xp[:, dy:dy + Hc, dx:dx + Wc] for dy in range(4) for dx in range(4)]
    return torch.stack(taps, dim=3).reshape(B * Hc * Wc, STEM_K)


def emulate(x_s2d, w4, bias, parts=None) -> torch.Tensor:
    """The kernel's function with its rounding: x_s2d (B, Hc, Wc, 12) and w4
    (4, 4, 12, 64) in the storage type, bias f32. Returns (B, Hc/2, Wc/2, 64)
    in x's dtype."""
    dtype = x_s2d.dtype
    parts = parts or DESIGNS[dtype]
    B, Hc, Wc, _ = x_s2d.shape
    a, w = patches(x_s2d), w4.to(dtype).float().reshape(STEM_K, -1)
    acc = torch.zeros(a.shape[0], w.shape[1])
    for k0 in range(0, STEM_K, FRESH_ROWS):
        ks = slice(k0, k0 + FRESH_ROWS)
        acc = acc + mma_chain(torch.zeros_like(acc), parts(a[:, ks], w[ks]), K_STEP[dtype])
    conv = torch.relu(acc + bias.float()).to(dtype).float().reshape(B, Hc, Wc, -1)
    return F.max_pool2d(conv.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1).to(dtype)


def stem_inputs(shape, dtype, w_scale=0.1, seed=0):
    """test_fused_stem's inputs: a video N(0, 1) of `shape` (B, H, W, 3),
    7x7 weights N(0, w_scale) as the s2d kernel, a bias N(0, 0.1)."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    w7 = torch.from_numpy((rng.normal(size=(7, 7, 3, 64)) * w_scale).astype(np.float32))
    bias = torch.from_numpy((rng.normal(size=(64,)) * 0.1).astype(np.float32))
    return space_to_depth(x).to(dtype), stem_weights_to_space_to_depth(w7).to(dtype), bias


SHAPES = [(2, 64, 96, 3), (1, 40, 72, 3)]


@pytest.mark.parametrize("w_scale", [0.1, math.sqrt(2 / 147)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
def test_emulated_rounding_within_phase1_tolerance(dtype, shape, w_scale):
    """At test_fused_stem's weights (0.1) and at phase 1's (He: sqrt(2/147))."""
    xs, w4, bias = stem_inputs(shape, dtype, w_scale)
    out = emulate(xs, w4, bias)
    ref = stem_plain(xs, w4, bias)
    assert out.dtype == dtype and out.shape == ref.shape
    assert tolerance_ratio(out, ref) <= 1.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_emulated_rounding_matches_jax_interpret(dtype):
    xs, w4, bias = stem_inputs(SHAPES[0], dtype)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    ref = jax_fused_stem(jnp.asarray(xs.float().numpy(), jdt), jnp.asarray(w4.float().numpy(), jdt),
                         jnp.asarray(bias.numpy()), tile_p=8, interpret=True)
    ref = torch.from_numpy(np.array(ref, np.float32)).to(dtype)
    assert tolerance_ratio(emulate(xs, w4, bias), ref) <= 1.0


def test_one_tf32_product_fails_the_f32_tolerance():
    xs, w4, bias = stem_inputs(SHAPES[0], torch.float32)
    out = emulate(xs, w4, bias, parts=parts_1xtf32)
    assert tolerance_ratio(out, stem_plain(xs, w4, bias)) > 1.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pack_stem_fragment_order(dtype):
    """Read the packed weights back as the kernel's lanes load them: for
    k-step ks, pass p (n-tiles 4p .. 4p + 3) and lane (g, t), the 16 bytes at
    (4 ks + 2p + jj) 32 + lane hold (b0, b1) of n-tile 4p + 2jj, then of
    4p + 2jj + 1 (PTX mma B fragments, n = 8 n-tile + g): bf16 b0 rows 2t,
    2t + 1 of the k-step, b1 rows 2t + 8, 2t + 9 (the lower row in the low
    half); tf32 b0 row t, b1 row t + 4."""
    # distinct values: f32 integers; bf16 the first 12288 bit patterns (finite, from +0 up)
    w4 = (torch.arange(STEM_K * 64, dtype=torch.float32) if dtype == torch.float32 else
          torch.arange(STEM_K * 64, dtype=torch.int16).view(torch.bfloat16)).reshape(4, 4, 12, 64)
    p = pack_stem(dtype, w4, torch.zeros(64))
    w = w4.float().reshape(STEM_K, 64)
    bf16 = dtype == torch.bfloat16
    step = 16 if bf16 else 8
    words = p.frag.float().reshape(-1, 4, 2) if bf16 else p.frag.float().reshape(-1, 4, 1)
    seen = torch.zeros_like(w, dtype=torch.bool)
    for ks in range(STEM_K // step):
        for jj in range(4):
            for lane in range(32):
                g, t = lane // 4, lane % 4
                vals = words[(4 * ks + jj) * 32 + lane]
                for word in range(4):
                    n = 8 * (2 * jj + word // 2) + g
                    which = word % 2
                    rows = ([step * ks + 2 * t + 8 * which + h for h in range(2)] if bf16
                            else [step * ks + t + 4 * which])
                    for half, k in enumerate(rows):
                        assert vals[word, half] == w[k, n], (ks, jj, lane, word, half)
                        seen[k, n] = True
    assert bool(seen.all())
