"""The port's kernel-study kernels (future_od_tpu_torch/ops/attention_floor.py,
fused_bottleneck_v2 and fused_layer1 in ops/fused_resnet.py) against the
Pallas kernels of the JAX repo's tools, and the ported tools' CPU check.

On the CPU each wrapper runs its plain PyTorch version; those are held
against the tools' Pallas kernels in interpret mode on the same numpy-seeded
inputs. `variant()` and `fused_v2` have no interpret flag, so the tool
module's `pl` is swapped for a shim whose `pallas_call` interprets (the
tools themselves are loaded from their files and not edited).
tests/test_torch_kernels_cuda.py holds the CUDA kernels against the same
plain versions on a card.
"""
import functools
import importlib.util
import math
import os

import numpy as np
import pytest

import jax.numpy as jnp
import torch
from jax.experimental import pallas as pl

from future_od_tpu_torch.ops import _kernels
from future_od_tpu_torch.ops.attention_floor import (
    LOG2E,
    MODES,
    attention_floor,
    attention_floor_plain,
)
from future_od_tpu_torch.ops.fused_resnet import (
    bottleneck_plain,
    fused_bottleneck_v2,
    fused_layer1,
    layer1_cost,
    layer1_plain,
    layer1_recompute,
)
from future_od_tpu_torch.tools import bench_fused_bottleneck, bench_softmax_floor
from future_od_tpu_torch.utils.jax_weights import blocks_from_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# f32 on both sides, sums reassociated: the JAX tool's own interpret check
# holds v3 to 2e-4 (tools/bench_fused_bottleneck.py::check_interpret)
ATOL = 2e-4


def _load_tool(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _InterpretPallas:
    """`pl` with pallas_call run in interpret mode; every other name as is."""

    pallas_call = staticmethod(functools.partial(pl.pallas_call, interpret=True))

    def __getattr__(self, name):
        return getattr(pl, name)


@pytest.fixture(scope="module")
def floor_tool():
    mod = _load_tool("bench_softmax_floor")
    mod.pl = _InterpretPallas()
    return mod


@pytest.fixture(scope="module")
def bottleneck_tool():
    mod = _load_tool("bench_fused_bottleneck")
    mod.pl = _InterpretPallas()
    return mod


def t(x):
    return torch.from_numpy(np.array(x))


# bf16 outputs: both sides compute in f32 from the same bf16 values and round
# where the kernels round, so they are at most one bf16 ulp (2^-7 relative)
# apart, plus 1e-3 of the output's scale for an intermediate that f32
# reassociation rounds to the other side of a bf16 boundary (PR 1's rule).
BF16_ATOL = 1e-3
# Chained layer1: each block's output can round to the other side of a bf16
# boundary, one ulp (2^-8 of at most the largest output) off, and the later
# blocks' identity residuals carry that on to the result: 3 x 2^-8.
BF16_CHAINED_ATOL = 3 * 2.0**-8


def assert_bf16_close(out, ref, atol=BF16_ATOL):
    """Elementwise within one bf16 ulp plus atol of max |ref|."""
    assert out.dtype == torch.bfloat16
    ref = np.asarray(jnp.asarray(ref).astype(jnp.float32))
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=2**-7, atol=atol * np.abs(ref).max())


def exact_logit_qkv(rng, B, H, Nq, Nk, scale):
    """numpy (q, k, v) whose logits bf16(q·scale·log2 e)·kᵀ are exact in f32
    in any summation order (|q'| in [1/16, 1), integer keys in [-3, 3]), so
    the JAX kernel and the plain version round every logit to the same bf16
    value: the bf16 chain would turn a one-ulp f32 difference into a gap of
    a few % on that key."""
    u = rng.uniform(1 / 16, 1.0, size=(B, H, Nq, 32)) * rng.choice([-1.0, 1.0], (B, H, Nq, 32))
    q = (u / (scale * LOG2E)).astype(np.float32)
    k = rng.integers(-3, 4, size=(B, H, Nk, 32)).astype(np.float32)
    v = rng.normal(size=(B, H, Nk, 32)).astype(np.float32)
    return q, k, v


class TestAttentionFloor:
    @pytest.mark.parametrize("mode", list(MODES))
    def test_plain_matches_pallas_interpret(self, floor_tool, rng, mode):
        """bf16, 40 keys in blocks of 16: 8 zero keys enter every row unmasked."""
        scale = 1.0 / math.sqrt(32)
        q, k, v = exact_logit_qkv(rng, 1, 2, 24, 40, scale)
        bf = lambda a: jnp.asarray(a).astype(jnp.bfloat16)  # noqa: E731
        ref = floor_tool.variant(mode, scale, 8, 16)(bf(q), bf(k), bf(v))
        as_torch = lambda a: t(a).to(torch.bfloat16)  # noqa: E731
        out = attention_floor(as_torch(q), as_torch(k), as_torch(v), scale, mode, 16)
        assert out.shape == ref.shape
        assert_bf16_close(out, ref)

    def test_padded_keys_enter_the_function(self, rng):
        """Zero keys past Nk change unsafe and bf16sm (not dots): the port
        pads to block_k as the TPU wrapper does."""
        q, k, v = (t(a).to(torch.bfloat16) for a in exact_logit_qkv(rng, 1, 1, 8, 40, 0.2))
        for mode, changed in (("dots", False), ("unsafe", True), ("bf16sm", True)):
            a = attention_floor_plain(q, k, v, 0.2, mode, 8)  # 40 keys: no padding
            b = attention_floor_plain(q, k, v, 0.2, mode, 16)  # 8 zero keys
            assert (not torch.equal(a, b)) == changed, mode

    def test_wrapper_takes_plain_version_on_cpu(self, rng):
        q, k, v = (t(a) for a in exact_logit_qkv(rng, 1, 2, 9, 20, 0.3))
        before = dict(_kernels.launch_counts)
        for mode in MODES:
            torch.testing.assert_close(attention_floor(q, k, v, 0.3, mode, 16),
                                       attention_floor_plain(q, k, v, 0.3, mode, 16),
                                       rtol=0, atol=0)
        assert _kernels.launch_counts == before  # no kernel launched, none counted

    def test_wrapper_never_falls_back_off_cpu(self):
        q = torch.empty((1, 2, 8, 32), device="meta")
        with pytest.raises(ValueError, match="CUDA"):
            attention_floor(q, q, q, 1.0, "dots", 16)
        with pytest.raises(ValueError, match="head dims"):
            attention_floor(q[..., :16], q[..., :16], q[..., :16], 1.0, "dots", 16)
        with pytest.raises(ValueError, match="mode"):
            attention_floor(q, q, q, 1.0, "full", 16)


def bottleneck_weights(rng, cin, cmid, cout, downsample, scale=0.2):
    r = lambda *s: (rng.normal(size=s) * scale).astype(np.float32)  # noqa: E731
    w = dict(w1=r(cin, cmid), b1=r(cmid), w2=r(3, 3, cmid, cmid), b2=r(cmid),
             w3=r(cmid, cout), b3=r(cout))
    if downsample:
        w.update(wd=r(cin, cout), bd=r(cout))
    return w


class TestBottleneckV2:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("downsample", [False, True])
    @pytest.mark.parametrize("im2col", [False, True])
    @pytest.mark.parametrize("tile_h", [4, 8])
    def test_plain_matches_pallas_interpret(self, bottleneck_tool, rng, tile_h, im2col,
                                            downsample, dtype):
        cin = 16 if downsample else 32
        x = np.abs(rng.normal(size=(1, 16, 12, cin))).astype(np.float32)
        w = bottleneck_weights(rng, cin, 16, 32, downsample)
        jdt = getattr(jnp, dtype)
        ref = bottleneck_tool.fused_v2(jnp.asarray(x).astype(jdt),
                                       **{k: jnp.asarray(v) for k, v in w.items()},
                                       tile_h=tile_h, im2col=im2col)
        out = fused_bottleneck_v2(t(x).to(getattr(torch, dtype)), **{k: t(v) for k, v in w.items()},
                                  tile_h=tile_h, im2col=im2col)
        if dtype == "bfloat16":
            assert_bf16_close(out, ref)
        else:
            np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)

    def test_wrapper_takes_plain_version_on_cpu(self, rng):
        x = t(rng.normal(size=(1, 8, 8, 32)).astype(np.float32))
        w = {k: t(v) for k, v in bottleneck_weights(rng, 32, 8, 32, False).items()}
        before = dict(_kernels.launch_counts)
        torch.testing.assert_close(fused_bottleneck_v2(x, **w, tile_h=16, im2col=False),
                                   bottleneck_plain(x, **w), rtol=0, atol=0)
        assert _kernels.launch_counts == before

    def test_wrapper_never_falls_back_off_cpu(self, rng):
        w = {k: t(v).to("meta") for k, v in bottleneck_weights(rng, 64, 256, 256, True).items()}
        x = torch.empty((1, 8, 8, 64), device="meta")
        with pytest.raises(ValueError, match="CUDA"):
            fused_bottleneck_v2(x, **w)
        w32 = {k: t(v).to("meta") for k, v in bottleneck_weights(rng, 64, 32, 256, True).items()}
        with pytest.raises(ValueError, match="unsupported shapes"):
            fused_bottleneck_v2(x, **w32)  # cmid 32: not instantiated


def layer1_blocks(rng, dtype):
    """The tool's make_layer1_blocks for both packages from one seed."""
    seed = int(rng.integers(1 << 30))
    ours = bench_fused_bottleneck.make_layer1_blocks(np.random.default_rng(seed))
    return ours, blocks_from_numpy(ours, dtype, device="cpu")


class TestFusedLayer1:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("tile_h", [4, 8])
    def test_plain_matches_pallas_interpret(self, bottleneck_tool, rng, tile_h, dtype):
        """H = 16 puts tiles on both image edges (the TPU kernel's clamped
        halo rows must not leak); W = 12 pads the width."""
        blocks_np, blocks = layer1_blocks(rng, getattr(torch, dtype))
        x = rng.normal(size=(1, 16, 12, 64)).astype(np.float32)
        jdt = getattr(jnp, dtype)
        jax_blocks = [{k: jnp.asarray(v).astype(jdt) for k, v in bk.items()} for bk in blocks_np]
        ref = bottleneck_tool.fused_layer1(jnp.asarray(x).astype(jdt), jax_blocks, tile_h=tile_h,
                                           interpret=True)
        out = fused_layer1(t(x).to(getattr(torch, dtype)), blocks, tile_h=tile_h)
        if dtype == "bfloat16":
            assert_bf16_close(out, ref, BF16_CHAINED_ATOL)
        else:
            np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)

    def test_port_blocks_equal_the_tools(self, bottleneck_tool):
        ours = bench_fused_bottleneck.make_layer1_blocks(np.random.default_rng(3))
        theirs = bottleneck_tool.make_layer1_blocks(np.random.default_rng(3), jnp.float32)
        assert [sorted(b) for b in ours] == [sorted(b) for b in theirs]
        for a, b in zip(ours, theirs):
            for k in a:
                np.testing.assert_array_equal(a[k], np.asarray(b[k]))

    def test_wrapper_takes_plain_version_on_cpu(self, rng):
        _, blocks = layer1_blocks(rng, torch.float32)
        x = t(rng.normal(size=(1, 8, 8, 64)).astype(np.float32))
        before = dict(_kernels.launch_counts)
        torch.testing.assert_close(fused_layer1(x, blocks), layer1_plain(x, blocks),
                                   rtol=0, atol=0)
        assert _kernels.launch_counts == before

    def test_wrapper_never_falls_back_off_cpu(self, rng):
        _, blocks = layer1_blocks(rng, torch.float32)
        meta = [{k: v.to("meta") for k, v in bk.items()} for bk in blocks]
        x = torch.empty((1, 8, 8, 64), device="meta")
        with pytest.raises(ValueError, match="CUDA"):
            fused_layer1(x, meta)
        with pytest.raises(ValueError, match="downsample"):
            fused_layer1(x, meta[:2])

    def test_recompute_and_cost(self):
        # whole-width rows (the TPU kernel's strip) recompute less than 8x8 tiles
        assert layer1_recompute(8, 400) < layer1_recompute(16, 8) < layer1_recompute(8, 8) < 1.8
        ops, nbytes = layer1_cost(2, 8, 8, 64, 2)
        assert ops == 2 * 2 * 64 * (64 * 64 + 9 * 64 * 64 + 2 * 64 * 256
                                    + 2 * (256 * 64 + 9 * 64 * 64 + 64 * 256))
        assert nbytes > 2 * 2 * 64 * (64 + 256)


@pytest.mark.parametrize("tool", [bench_softmax_floor, bench_fused_bottleneck])
def test_tool_check_runs_on_cpu(tool, capsys):
    assert tool.main(["--check"]) == 0
    out = capsys.readouterr().out
    assert "(not timed)" in out and " ms" not in out


@pytest.mark.parametrize("tool", [bench_softmax_floor, bench_fused_bottleneck])
def test_tools_run_on_cuda_by_default(tool, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tool.main([])
