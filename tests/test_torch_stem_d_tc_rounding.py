"""The rounding of the tensor-core stem-study kernel T3d (csrc/stem_variants.cu,
`fod_stem_d`), emulated on the CPU and held to the tolerance its check on the
card uses (chip_smoke.py phase 1d).

The kernel is an implicit GEMM: M = output pixels, N = 256, K = 9 taps x 128
channels in (tap, channel) order, each pixel's A row read from the staged halo
at the tap's shift. Both operands are bf16 values (xp rounded to bf16 whatever
its storage type, w9 bf16), so every product is exact and only the f32
summation differs from the plain version's. This file emulates it in torch,
`mma.sync` by `mma.sync` (tests/test_torch_flash_tc_rounding.py's model: each
m16n8k16 adds its exact products to its accumulator and rounds the sum toward
zero to f32): one chain through all 72 k-steps of 16 rows (the kernel keeps no
fresh accumulators: the products are exact and the chain's bias stays far
inside the tolerance), then relu, rounded to xp's dtype. A pixel's value does
not depend on the tile that computes it, so the whole image is emulated at
once.

At tests/test_torch_kernels_cuda.py::test_stem_variants' shapes and inputs
(videos of 2 x 64x96 and 1 x 48x40, 7x7 weights N(0, 0.1)) the emulation must
lie within phase 1d's tolerance of the port's plain version
(`tap_conv_plain`), and, pooled as the tool pools it, within it of the TPU
tool's `pallasD` (tools/bench_stem.py::_kernelD) in interpret mode at the
tool's check inputs. The worst ratios (error over tolerance) this file
measured: 0.017 (f32) and 0.40 (bf16: one bf16 ulp, within RTOL's two) against
the plain version, 0.018 and 0.52 against the JAX kernel (fresh accumulators
every 32 rows, as `mma_chunk` keeps them, would give 0.0086 and 0.40 against
the plain version). A negative control: f32 xp taken without its rounding to
bf16 (the TPU kernel rounds it) lies at 90 times the f32 tolerance.

About 13 s alone (`JAX_PLATFORMS=cpu python -m pytest
tests/test_torch_stem_d_tc_rounding.py -q`).
"""
import importlib.util
import os

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from future_od_tpu_torch.models.resnet import s2d4_stem_pool
from future_od_tpu_torch.ops.stem_variants import D_CIN, tap_conv_plain
from future_od_tpu_torch.tools import bench_stem
from test_torch_flash_tc_rounding import (  # noqa: F401 (one_torch_thread: autouse)
    mma_chain,
    one_torch_thread,
    parts_as_stored,
    tolerance_ratio,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K_STEP = 16  # bf16 m16n8k16
SHAPES = [(2, 64, 96, 3), (1, 48, 40, 3)]


def patches(xp, round_x: bool = True) -> torch.Tensor:
    """(B, Hp+2, Wp+2, 128) -> (B * Hp * Wp, 1152): each output pixel's A row
    in the kernel's K order (tap, channel), tap = 3 dy + dx, as bf16 values
    (round_x False: as stored, the negative control)."""
    B, h2, w2, _ = xp.shape
    hp, wp = h2 - 2, w2 - 2
    x = xp.to(torch.bfloat16).float() if round_x else xp.float()
    taps = [x[:, t // 3:t // 3 + hp, t % 3:t % 3 + wp] for t in range(9)]
    return torch.stack(taps, dim=3).reshape(B * hp * wp, 9 * D_CIN)


def emulate(xp, w9, round_x: bool = True) -> torch.Tensor:
    """The kernel's function with its rounding: (B, Hp, Wp, 256) in xp's dtype."""
    B, h2, w2, _ = xp.shape
    a, w = patches(xp, round_x), w9.to(torch.bfloat16).float().reshape(9 * D_CIN, -1)
    acc = mma_chain(torch.zeros(a.shape[0], w.shape[1]), parts_as_stored(a, w), K_STEP)
    return torch.relu(acc).to(xp.dtype).reshape(B, h2 - 2, w2 - 2, -1)


def case(shape, dtype, seed=0):
    """test_stem_variants' D operands: a video N(0, 1) of `shape`, 7x7
    weights N(0, 0.1), through the tool's operand construction."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dtype)
    w7 = torch.from_numpy((rng.normal(size=(7, 7, 3, 64)) * 0.1).astype(np.float32))
    _, _, args = bench_stem.kernel_cases(x, w7, torch.zeros(64))["stem_d"]
    return args


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
def test_emulated_rounding_within_phase1d_tolerance(dtype, shape):
    xp, w9 = case(shape, dtype)
    out = emulate(xp, w9)
    ref = tap_conv_plain(xp, w9)
    assert out.dtype == dtype and out.shape == ref.shape
    assert tolerance_ratio(out, ref) <= 1.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_emulated_rounding_matches_jax_interpret(dtype):
    """Pooled as the tool pools D's output, against pallasD (its _kernelD in
    interpret mode) on the tool's check inputs."""
    spec = importlib.util.spec_from_file_location(
        "bench_stem_tpu", os.path.join(REPO, "tools", "bench_stem.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    rng = np.random.default_rng(2)  # the tool's check_interpret draws
    x = rng.normal(size=bench_stem.CHECK_SHAPE).astype(np.float32)
    w7 = (rng.normal(size=(7, 7, 3, 64)) * 0.1).astype(np.float32)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jx = jnp.asarray(x).astype(jdt)
    w3 = tool.stem_weights_to_s2d4(jnp.asarray(w7)).astype(jdt)
    x128 = jnp.pad(tool.space_to_depth4(jx), ((0, 0), (0, 0), (0, 0), (0, D_CIN - 48)))
    ref = tool.pallasD(x128, jnp.pad(w3, ((0, 0), (0, 0), (0, D_CIN - 48), (0, 0))),
                       interpret=True)
    ref = torch.from_numpy(np.array(ref.astype(jnp.float32))).to(dtype)
    ops = bench_stem.operands(torch.from_numpy(x).to(dtype), torch.from_numpy(w7))
    out = s2d4_stem_pool(emulate(*bench_stem.d_operands(ops["x128"], ops["w3p"])))
    assert out.shape == ref.shape
    assert tolerance_ratio(out, ref) <= 1.0


def test_unrounded_x_fails_the_f32_tolerance():
    """The tolerance and the model discriminate: f32 xp used as stored (not
    rounded to bf16) lies outside phase 1d's f32 tolerance."""
    xp, w9 = case(SHAPES[0], torch.float32)
    assert tolerance_ratio(emulate(xp, w9, round_x=False), tap_conv_plain(xp, w9)) > 1.0
