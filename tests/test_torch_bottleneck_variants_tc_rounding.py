"""The rounding of the tensor-core study kernels T2 v2 and v3
(csrc/bottleneck_variants.cu over csrc/bottleneck_tile.cuh), emulated on the
CPU and held to the tolerances their check on the card uses.

Both run K2's stages, so this file reuses K2's emulation
(tests/test_torch_bottleneck_tc_rounding.py: each `mma.sync` rounds its f32
sum toward zero; bf16 as stored, f32 as 3xTF32; a fresh accumulator every 32
reduction rows; h1 and h2 near a bf16 rounding boundary recomputed as
sequential sums). What is new:

- v2 with im2col = 0 sums the 3x3 as nine tap chains, each over its cmid
  rows from zero (fresh accumulators every 32 rows within it), added to the
  result in f32 in tap order; with im2col = 1 it is K2's one chain;
- v3 chains layer1's three blocks, each output rounded to the storage type
  and zero outside the image, the next block's input.

At chip_smoke.py phase 1c's inputs (the tool's weights, N(0, 0.1^2), and
activations 0.1 N(0, 1)), a layer1 inner block (cin 256, cmid 64, cout 256)
on two 16x16 images and layer1's three blocks on a 12x12 one, each emulation
must lie within phase 1c's tolerance of the port's plain version
(`bottleneck_plain`, `layer1_plain`): f32 2e-5 of max |plain|, bf16 2^-7
relative plus 2^-8 (v2) or 3 x 2^-8 (v3) of max |plain|. With numpy seeds 0-2
v2 lies at 0.036-0.041 of it in f32 (either im2col) and 0 in bf16 (0-2
outputs off the plain ones), v3 at 0.067-0.095 in f32 and 0-0.29 in bf16. The
same holds against the JAX tool's kernels in interpret mode (`_v2_kernel` on
one 16x16 image, `_v3_kernel` on one 16x12, tile 8): v2 at 0.031-0.037 (f32)
and 0-0.002 (bf16), v3 at 0.076-0.092 and 0.14-0.28, seeds 0-2.
Negative controls: one TF32 product (no split) puts v2's tap chains and v3
past the f32 tolerance (v3: 32-48x). Without the bf16 near-tie recompute
(NEAR_TIE 0) v2 stays inside the bf16 tolerance, at 0-0.45 of it over seeds
0-4 (an output one bf16 step off is within the 2^-7 relative part), so the
control counts outputs instead: 0-2 of 131,072 leave the plain value with
the recompute, 0-500 without (seed 3: 1 against 500). The file takes about
11 s of tests, 22 s with the imports, alone (`JAX_PLATFORMS=cpu python -m
pytest tests/test_torch_bottleneck_variants_tc_rounding.py -q`).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from future_od_tpu_torch.ops.fused_resnet import bottleneck_plain, layer1_plain
from future_od_tpu_torch.tools.bench_fused_bottleneck import make_layer1_blocks
from future_od_tpu_torch.utils.jax_weights import blocks_from_numpy
from test_torch_bottleneck_tc_rounding import NEAR_TIE, product, relu_rounded, stored
from test_torch_flash_tc_rounding import (  # noqa: F401 (one_torch_thread: autouse)
    one_torch_thread,
    parts_1xtf32,
)
from test_torch_tools_kernels import bottleneck_tool  # noqa: F401 (the JAX tool, interpreted)

# chip_smoke.py phase 1c: f32 KERNEL_ATOL, bf16 KERNEL_RTOL and BOTTLENECK_BF16_ATOL
RTOL = {torch.float32: 0.0, torch.bfloat16: 2.0**-7}
ATOL = {"bottleneck_v2": {torch.float32: 2e-5, torch.bfloat16: 2.0**-8},
        "fused_layer1": {torch.float32: 2e-5, torch.bfloat16: 3 * 2.0**-8}}


def tolerance_ratio(out, ref, kernel) -> float:
    """The worst element's |out - ref| over its phase-1c tolerance."""
    dtype = ref.dtype
    out, ref = out.float(), ref.float()
    tol = RTOL[dtype] * ref.abs() + ATOL[kernel][dtype] * ref.abs().max()
    return ((out - ref).abs() / tol).max().item()


def emulate(x, w, im2col=True, design=None, near_tie=NEAR_TIE):
    """v2's function with its rounding: x (B, H, W, cin) in the storage type,
    weights as `bottleneck_plain` takes them; the downsample's product, where
    there is one, continues h2 w3's chain. Returns (B, H, W, cout) in x's
    dtype."""
    dtype = x.dtype
    B, H, W, cin = x.shape
    cmid = w["w1"].shape[1]
    xs = x.float().reshape(-1, cin)
    mats = {k: stored(w[k], dtype) for k in ("w1", "w2", "w3")}
    mats["w2"] = mats["w2"].reshape(9 * cmid, cmid)
    h1 = relu_rounded(product(xs, mats["w1"], dtype, design), w["b1"].float(), xs, mats["w1"],
                      dtype, near_tie)
    h1 = h1.reshape(B, H, W, cmid).permute(0, 3, 1, 2)
    # im2col of the zero-padded h1, columns in (dy, dx, channel) order as w2's rows
    cols = F.unfold(h1, 3, padding=1).reshape(B, cmid, 9, H * W)
    cols = cols.permute(0, 3, 2, 1).reshape(B * H * W, 9 * cmid)
    if im2col:
        acc = product(cols, mats["w2"], dtype, design)
    else:  # nine tap chains, each from zero, summed in f32 in tap order
        acc = torch.zeros(cols.shape[0], cmid)
        for tap in range(9):
            rows = slice(tap * cmid, (tap + 1) * cmid)
            acc = acc + product(cols[:, rows], mats["w2"][rows], dtype, design)
    h2 = relu_rounded(acc, w["b2"].float(), cols, mats["w2"], dtype, near_tie)
    if w.get("wd") is None:
        out = product(h2, mats["w3"], dtype, design) + w["b3"].float() + xs
    else:
        acc = product(torch.cat([h2, xs], 1), torch.cat([mats["w3"], stored(w["wd"], dtype)]),
                      dtype, design)
        out = acc + w["b3"].float() + w["bd"].float()
    return torch.relu(out).to(dtype).reshape(B, H, W, -1)


def emulate_layer1(x, blocks, design=None, near_tie=NEAR_TIE):
    """v3's function with its rounding: the blocks' v2 emulation (im2col) in
    turn, each output rounded to x's dtype; F.unfold's zero padding is the
    kernel's zero outside the image."""
    for bk in blocks:
        x = emulate(x, bk, True, design, near_tie)
    return x


def inner_block(rng, dtype, B=2, H=16, W=16, cin=256, cmid=64):
    """Phase 1c's layer1 inner block: the tool's weights, activations 0.1 N(0, 1)."""
    def r(*s):
        return torch.from_numpy(rng.normal(size=s).astype(np.float32) * 0.1)

    x = r(B, H, W, cin).to(dtype)
    w = dict(w1=r(cin, cmid), b1=r(cmid), w2=r(3, 3, cmid, cmid), b2=r(cmid), w3=r(cmid, cin),
             b3=r(cin))
    return x, {k: v if k.startswith("b") else v.to(dtype) for k, v in w.items()}


def layer1(rng, dtype, H=12, W=12):
    blocks = blocks_from_numpy(make_layer1_blocks(rng), dtype, torch.device("cpu"))
    x = torch.from_numpy(rng.normal(size=(1, H, W, 64)).astype(np.float32) * 0.1).to(dtype)
    return x, blocks


@pytest.mark.parametrize("im2col", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_v2_emulated_rounding_within_phase1c_tolerance(rng, dtype, im2col):
    x, w = inner_block(rng, dtype)
    out = emulate(x, w, im2col)
    assert out.dtype == dtype and out.shape == x.shape
    assert tolerance_ratio(out, bottleneck_plain(x, **w), "bottleneck_v2") <= 1.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_v3_emulated_rounding_within_phase1c_tolerance(rng, dtype):
    x, blocks = layer1(rng, dtype)
    out = emulate_layer1(x, blocks)
    assert out.dtype == dtype and out.shape == (*x.shape[:3], 256)
    assert tolerance_ratio(out, layer1_plain(x, blocks), "fused_layer1") <= 1.0


def test_v2_tap_chains_one_tf32_product_fails_the_f32_tolerance(rng):
    x, w = inner_block(rng, torch.float32)
    out = emulate(x, w, im2col=False, design=(parts_1xtf32, True))
    assert tolerance_ratio(out, bottleneck_plain(x, **w), "bottleneck_v2") > 1.0


def test_v3_one_tf32_product_fails_the_f32_tolerance(rng):
    x, blocks = layer1(rng, torch.float32)
    out = emulate_layer1(x, blocks, design=(parts_1xtf32, True))
    assert tolerance_ratio(out, layer1_plain(x, blocks), "fused_layer1") > 1.0


def to_jax(v, dtype):
    """A tensor as the JAX tool takes it: biases f32, the rest in `dtype`."""
    return jnp.asarray(v.float().numpy(), jnp.float32 if dtype == torch.float32 else jnp.bfloat16)


def jax_weights(w, dtype):
    return {k: to_jax(v, torch.float32 if k.startswith("b") else dtype) for k, v in w.items()}


def from_jax(ref, dtype):
    return torch.from_numpy(np.array(ref, np.float32)).to(dtype)


@pytest.mark.parametrize("im2col", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_v2_emulated_rounding_matches_jax_interpret(bottleneck_tool, rng, dtype,  # noqa: F811
                                                    im2col):
    """The layer1 inner block on one 16x16 image: the emulation against the
    JAX tool's `_v2_kernel` in interpret mode, at tile 8."""
    x, w = inner_block(rng, dtype, B=1)
    ref = bottleneck_tool.fused_v2(to_jax(x, dtype), **jax_weights(w, dtype), tile_h=8,
                                   im2col=im2col)
    ref = from_jax(ref, dtype)
    assert tolerance_ratio(emulate(x, w, im2col), ref, "bottleneck_v2") <= 1.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_v3_emulated_rounding_matches_jax_interpret(bottleneck_tool, rng, dtype):  # noqa: F811
    """Layer1's three blocks on one 16x12 image (tiles on both image edges,
    the width padded): the emulation against the JAX tool's `_v3_kernel` in
    interpret mode, at tile 8."""
    x, blocks = layer1(rng, dtype, H=16, W=12)
    ref = bottleneck_tool.fused_layer1(to_jax(x, dtype), [jax_weights(bk, dtype) for bk in blocks],
                                       tile_h=8, interpret=True)
    ref = from_jax(ref, dtype)
    assert tolerance_ratio(emulate_layer1(x, blocks), ref, "fused_layer1") <= 1.0


@pytest.mark.parametrize("im2col", [False, True])
def test_v2_near_tie_recompute_flips_fewer_outputs(im2col):
    """bf16 over numpy seeds 0-4: without the near-tie recompute more of v2's
    outputs leave the plain version's value (see the module's docstring for
    why this is a count and not the tolerance)."""
    off = {NEAR_TIE: 0, 0.0: 0}
    for seed in range(5):
        x, w = inner_block(np.random.default_rng(seed), torch.bfloat16)
        plain = bottleneck_plain(x, **w)
        for near_tie in off:
            off[near_tie] += int((emulate(x, w, im2col, near_tie=near_tie) != plain).sum())
    assert 5 * off[NEAR_TIE] < off[0.0], off
