"""The rounding of the tensor-core fused bottleneck (csrc/fused_bottleneck.cu),
emulated on the CPU and held to the tolerances its check on the card uses.

The kernel cannot run here, but what it rounds can: this file emulates its
three products in torch, `mma.sync` by `mma.sync`, in the kernel's order
(tests/test_torch_flash_tc_rounding.py's model: each `mma.sync` adds its
exact products to its accumulator and rounds the sum toward zero to f32):

- bf16 storage: the operands as stored, k-steps of 16;
- f32 storage, 3xTF32: each operand split into tf32 big + small, the products
  big·small + small·big + big·big on k-steps of 8;
- in both, every 32 reduction rows (K = cin, 9 * cmid in (dy, dx, channel)
  order, cmid) sum into a fresh accumulator that is added to the running one
  in f32, rounding to nearest; h1 and h2 are rounded to the storage type after
  bias and relu, and the output after bias, residual and relu;
- in bf16, an h1 or h2 within NEAR_TIE (relative, the kernel's kNearTie) of
  a bf16 rounding boundary is the sequential f32 FMA sum of its reduction
  instead (the kernel's recompute).

At a layer2-like block (cin 512, cmid 128, cout 512, identity residual;
chip_smoke.py phase 1's weight scales) on two 16x16 images, each emulation
must lie within chip_smoke.py phase 1's tolerance of the port's plain version
(`bottleneck_plain`). With numpy seeds 0-2 the f32 emulation lies at
0.038-0.046 of its tolerance and bf16 at 0.20-0.58, with 3-6 of the 262144
bf16 outputs off the plain ones (the CPU's convolutions chain their sums as
the recompute does). Negative controls: one TF32 product (no split) fails the
f32 tolerance (about 20x); one chain through each whole product drifts: in
f32 it lies 18-20x further from the f64 function, and without the recompute
bf16's truncating chain puts 442-2109 outputs off, a fresh accumulator every
32 rows 6-260; the recompute puts 3-6 off where the tensor cores alone put
6-260. The tests ask for 5x where seed 0 shows 20-29x. At a small block
(cin 64, cmid 64, cout 256, with the downsample) each emulation also lies
within the tolerance of the JAX kernel in interpret mode: with seeds 0-2 at
0.030-0.037 of it in f32 and 0-0.68 in bf16, as the port's plain version
lies at 0-0.68. The near-tie test
holds the bf16 emulation against `chained`, the block with every sum one
sequential fmaf chain, whose order no thread count changes: with seed 0, 3
outputs off with the recompute and 60 without, on 1, 2 and 4 threads. The
file takes about 9 s of tests, 15 s with the imports, alone
(`one_torch_thread`: one torch thread a test).
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from future_od_tpu.ops.fused_resnet import fused_bottleneck as jax_fused_bottleneck

from future_od_tpu_torch.ops.fused_resnet import bottleneck_plain
from test_torch_flash_tc_rounding import (  # noqa: F401 (one_torch_thread: autouse)
    mma_chain,
    one_torch_thread,
    parts_1xtf32,
    parts_3xtf32,
    parts_as_stored,
    tolerance_ratio,
)

FRESH_ROWS = 32  # reduction rows the kernel sums into a fresh accumulator
NEAR_TIE = 2.0**-18  # csrc/bottleneck_tile.cuh's kNearTie
K_STEP = {torch.float32: 8, torch.bfloat16: 16}
# (parts, a fresh accumulator every FRESH_ROWS rows) by storage type: the kernel's
DESIGNS = {torch.float32: (parts_3xtf32, True), torch.bfloat16: (parts_as_stored, True)}


def product(a, b, dtype, design=None):
    """a (M, K) @ b (K, N) with the kernel's rounding for `dtype`."""
    parts, fresh = DESIGNS[dtype] if design is None else design
    acc = torch.zeros(a.shape[0], b.shape[1])
    if not fresh:
        return mma_chain(acc, parts(a, b), K_STEP[dtype])
    for k0 in range(0, a.shape[1], FRESH_ROWS):
        ks = slice(k0, k0 + FRESH_ROWS)
        acc = acc + mma_chain(torch.zeros_like(acc), parts(a[:, ks], b[ks]), K_STEP[dtype])
    return acc


def stored(x, dtype):
    return x.to(dtype).float()


def sequential(a, b):
    """a (F, K) times b (K, F), row by column: one fmaf a term, k ascending
    (the product exact in f64, the sum rounded to f32 each step)."""
    s = torch.zeros(a.shape[0])
    for k in range(a.shape[1]):
        s = (s.double() + a[:, k].double() * b[k].double()).float()
    return s


def chain(a, b):
    """a (M, K) @ b (K, N) with every output one sequential fmaf chain, k
    ascending (`sequential` on every pair): an order fixed by the function,
    whatever torch's thread count."""
    s = torch.zeros(a.shape[0], b.shape[1])
    a64, b64 = a.double(), b.double()
    for k in range(a.shape[1]):
        s = (s.double() + a64[:, k, None] * b64[k]).float()
    return s


def relu_rounded(acc, bias, a, b, dtype, near_tie):
    """relu(acc + bias) rounded to dtype; in bf16, values within near_tie
    (relative) of a rounding boundary take the sequential sum of a @ b
    instead of acc, as the kernel recomputes them."""
    r = torch.relu(acc + bias)
    if dtype == torch.bfloat16 and near_tie > 0:
        near = (r * (1 - near_tie)).to(dtype) != (r * (1 + near_tie)).to(dtype)
        rows, cols = near.nonzero(as_tuple=True)
        r[rows, cols] = torch.relu(sequential(a[rows], b[:, cols]) + bias[cols])
    return stored(r, dtype)


def emulate(x, w, design=None, near_tie=NEAR_TIE):
    """The kernel's function with its rounding: x (B, H, W, cin) in the
    storage type, weights as `bottleneck_plain` takes them (the downsample's
    product, where there is one, continues h2 w3's chain, as the kernel's
    chunks do). Returns (B, H, W, cout) in x's dtype."""
    dtype = x.dtype
    B, H, W, cin = x.shape
    cmid = w["w1"].shape[1]
    xs = x.float().reshape(-1, cin)
    mats = {k: stored(w[k], dtype) for k in ("w1", "w2", "w3")}
    mats["w2"] = mats["w2"].reshape(9 * cmid, cmid)
    h1 = relu_rounded(product(xs, mats["w1"], dtype, design), w["b1"], xs, mats["w1"], dtype,
                      near_tie)
    h1 = h1.reshape(B, H, W, cmid).permute(0, 3, 1, 2)
    # im2col of the zero-padded h1, columns in (dy, dx, channel) order as w2's rows
    cols = F.unfold(h1, 3, padding=1).reshape(B, cmid, 9, H * W)
    cols = cols.permute(0, 3, 2, 1).reshape(B * H * W, 9 * cmid)
    h2 = relu_rounded(product(cols, mats["w2"], dtype, design), w["b2"], cols, mats["w2"], dtype,
                      near_tie)
    if w.get("wd") is None:
        out = product(h2, mats["w3"], dtype, design) + w["b3"] + xs
    else:
        acc = product(torch.cat([h2, xs], 1), torch.cat([mats["w3"], stored(w["wd"], dtype)]),
                      dtype, design)
        out = acc + w["b3"] + w["bd"]
    return torch.relu(out).to(dtype).reshape(B, H, W, -1)


def chained(x, w):
    """The block (identity residual) with every reduction one sequential
    fmaf chain in the kernel's (dy, dx, channel) order, each intermediate
    rounded to x's dtype after bias and relu, as the kernel's recompute
    rounds a near tie."""
    dtype = x.dtype
    B, H, W, cin = x.shape
    cmid = w["w1"].shape[1]
    xs = x.float().reshape(-1, cin)
    h1 = stored(torch.relu(chain(xs, stored(w["w1"], dtype)) + w["b1"]), dtype)
    h1 = h1.reshape(B, H, W, cmid).permute(0, 3, 1, 2)
    cols = F.unfold(h1, 3, padding=1).reshape(B, cmid, 9, H * W)
    cols = cols.permute(0, 3, 2, 1).reshape(B * H * W, 9 * cmid)
    w2 = stored(w["w2"], dtype).reshape(9 * cmid, cmid)
    h2 = stored(torch.relu(chain(cols, w2) + w["b2"]), dtype)
    out = chain(h2, stored(w["w3"], dtype)) + w["b3"] + xs
    return torch.relu(out).to(dtype).reshape(B, H, W, -1)


def exact_f64(x, w):
    """The block's function in f64, nothing rounded (identity residual)."""
    xc = x.double().permute(0, 3, 1, 2)
    w = {k: v.double() for k, v in w.items()}
    h = F.relu(F.conv2d(xc, w["w1"].t()[:, :, None, None], w["b1"]))
    h = F.relu(F.conv2d(h, w["w2"].permute(3, 2, 0, 1), w["b2"], padding=1))
    h = F.conv2d(h, w["w3"].t()[:, :, None, None], w["b3"])
    return F.relu(h + xc).permute(0, 2, 3, 1)


def layer2_block(rng, dtype, B=2, H=16, W=16, cin=512, cmid=128, cout=None):
    """chip_smoke.py phase 1's inputs at a layer2 inner block: x = |N(0, 1)|,
    He-scaled weights, biases N(0, 0.1). With cout, the block has the
    downsample (cin -> cout) as layer1.0 has."""
    def r(*s, scale=1.0):
        return torch.from_numpy((rng.normal(size=s) * scale).astype(np.float32))

    x = r(B, H, W, cin).abs().to(dtype)
    width = cin if cout is None else cout
    w = dict(w1=r(cin, cmid, scale=math.sqrt(2 / cin)), b1=r(cmid, scale=0.1),
             w2=r(3, 3, cmid, cmid, scale=math.sqrt(2 / (9 * cmid))), b2=r(cmid, scale=0.1),
             w3=r(cmid, width, scale=math.sqrt(1 / cmid)), b3=r(width, scale=0.1))
    if cout is not None:
        w.update(wd=r(cin, cout, scale=math.sqrt(1 / cin)), bd=r(cout, scale=0.1))
    return x, {k: v if k.startswith("b") else v.to(dtype) for k, v in w.items()}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_emulated_rounding_within_phase1_tolerance(rng, dtype):
    x, w = layer2_block(rng, dtype)
    out = emulate(x, w)
    assert out.dtype == dtype and out.shape == x.shape
    assert tolerance_ratio(out, bottleneck_plain(x, **w)) <= 1.0


def test_one_tf32_product_fails_the_f32_tolerance(rng):
    x, w = layer2_block(rng, torch.float32)
    out = emulate(x, w, design=(parts_1xtf32, True))
    assert tolerance_ratio(out, bottleneck_plain(x, **w)) > 1.0


def test_f32_fresh_accumulator_beats_one_chain(rng):
    """The truncating sums of one chain through each whole product drift
    further from the f64 function than a fresh accumulator every 32 rows."""
    x, w = layer2_block(rng, torch.float32)
    exact = exact_f64(x, w)
    errs = {fresh: (emulate(x, w, design=(parts_3xtf32, fresh)).double() - exact).abs().max().item()
            for fresh in (True, False)}
    assert 5 * errs[True] < errs[False], errs


def test_bf16_fresh_accumulator_flips_fewer_outputs(rng):
    """In bf16 one chain's bias toward zero moves h1 and h2 to the lower bf16
    neighbour together, and with them the outputs (tensor cores alone)."""
    x, w = layer2_block(rng, torch.bfloat16)
    ref = bottleneck_plain(x, **w)
    off = {fresh: int((emulate(x, w, design=(parts_as_stored, fresh), near_tie=0.0) != ref).sum())
           for fresh in (True, False)}
    assert 5 * off[True] < off[False], off


def test_near_tie_recompute_flips_fewer_outputs(rng):
    """Intermediates near a bf16 rounding boundary, summed as sequential FMA
    chains, round as a reference that chains every sum does (`chained`, whose
    order does not depend on torch's threads)."""
    x, w = layer2_block(rng, torch.bfloat16)
    ref = chained(x, w)
    off = {near_tie: int((emulate(x, w, near_tie=near_tie) != ref).sum())
           for near_tie in (NEAR_TIE, 0.0)}
    assert 5 * off[NEAR_TIE] < off[0.0], off


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_emulated_rounding_matches_jax_interpret(rng, dtype):
    """A layer1.0-like block (cin 64, cmid 64, cout 256, the downsample) on
    one 16x16 image: the emulation against the JAX kernel in interpret mode."""
    x, w = layer2_block(rng, dtype, B=1, cin=64, cmid=64, cout=256)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    ref = jax_fused_bottleneck(
        jnp.asarray(x.float().numpy(), jdt),
        **{k: jnp.asarray(v.float().numpy(), jnp.float32 if k.startswith("b") else jdt)
           for k, v in w.items()},
        tile_h=8, interpret=True)
    ref = torch.from_numpy(np.array(ref, np.float32)).to(dtype)
    assert tolerance_ratio(emulate(x, w), ref) <= 1.0
