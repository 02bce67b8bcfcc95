"""The port's kernels (future_od_tpu_torch/ops) against the JAX package's
Pallas kernels.

On the CPU each wrapper runs its kernel's plain PyTorch version; those are
held against the Pallas kernels in interpret mode on the same numpy-seeded
inputs, as tests/test_flash_attention.py and tests/test_fused_resnet.py hold
the Pallas kernels against XLA. tests/test_torch_kernels_cuda.py holds the
CUDA kernels against these plain versions on a card.
"""
import math

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from future_od_tpu.models.resnet import space_to_depth as jax_space_to_depth
from future_od_tpu.models.resnet import (
    stem_weights_to_space_to_depth as jax_stem_weights_to_space_to_depth,
)
from future_od_tpu.ops.flash_attention import flash_attention as jax_flash_attention
from future_od_tpu.ops.fused_resnet import fused_bottleneck as jax_fused_bottleneck
from future_od_tpu.ops.fused_resnet import fused_stem as jax_fused_stem

from future_od_tpu_torch.models.resnet import space_to_depth, stem_weights_to_space_to_depth
from future_od_tpu_torch.ops import _kernels
from future_od_tpu_torch.ops.flash_attention import flash_attention, reference_attention
from future_od_tpu_torch.ops.fused_resnet import (
    bottleneck_plain,
    fused_bottleneck,
    fused_stem,
    stem_plain,
)

# f32 on both sides, reassociated sums: the JAX kernel tests' own tolerance
# (test_fused_resnet.py: 2e-4; test_flash_attention.py: 2e-5 at unit scale)
ATOL = 2e-4


def assert_bf16_close(out, ref):
    """bf16 outputs: both sides compute in f32 from the same bf16 values and
    round where the kernels round, so they are at most one bf16 ulp (2^-7
    relative) apart, plus 1e-3 of the output's scale for an intermediate that
    f32 reassociation rounds to the other side of a bf16 boundary."""
    assert out.dtype == torch.bfloat16
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(
        out.float().numpy(), ref, rtol=2**-7, atol=1e-3 * np.abs(ref).max()
    )


def t(x):
    return torch.from_numpy(np.array(x))


def bottleneck_weights(rng, cin, cmid, cout, downsample, scale=0.2):
    r = lambda *s: (rng.normal(size=s) * scale).astype(np.float32)  # noqa: E731
    w = dict(w1=r(cin, cmid), b1=r(cmid), w2=r(3, 3, cmid, cmid), b2=r(cmid),
             w3=r(cmid, cout), b3=r(cout))
    if downsample:
        w.update(wd=r(cin, cout), bd=r(cout))
    return w


def stem_inputs(rng, B, H, W):
    x = rng.normal(size=(B, H, W, 3)).astype(np.float32)
    w7 = (rng.normal(size=(7, 7, 3, 64)) * 0.1).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, size=(64,)).astype(np.float32)
    shift = (rng.normal(size=(64,)) * 0.1).astype(np.float32)
    return x, w7, scale, shift


class TestFlashAttentionPlain:
    @pytest.mark.parametrize(
        "B,H,Nq,Nk,d,dv",
        [
            (1, 2, 64, 200, 32, 32),  # Nk padded to 256 by the Pallas kernel
            (2, 2, 40, 130, 64, 32),  # the conditional cross-attention's concat heads
            (1, 1, 300, 300, 32, 32),
        ],
    )
    def test_plain_matches_pallas_interpret(self, rng, B, H, Nq, Nk, d, dv):
        q = rng.normal(size=(B, H, Nq, d)).astype(np.float32)
        k = rng.normal(size=(B, H, Nk, d)).astype(np.float32)
        v = rng.normal(size=(B, H, Nk, dv)).astype(np.float32)
        scale = 1.0 / math.sqrt(d)
        ref = jax_flash_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale, interpret=True
        )
        out = reference_attention(t(q), t(k), t(v), scale)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)

    def test_bf16_plain_matches_pallas_interpret(self, rng):
        q = rng.normal(size=(1, 2, 48, 32)).astype(np.float32)
        k = rng.normal(size=(1, 2, 160, 32)).astype(np.float32)
        v = rng.normal(size=(1, 2, 160, 32)).astype(np.float32)
        as_jax = lambda a: jnp.asarray(a).astype(jnp.bfloat16)  # noqa: E731
        ref = jax_flash_attention(as_jax(q), as_jax(k), as_jax(v), 0.2, interpret=True)
        as_torch = lambda a: t(a).to(torch.bfloat16)  # noqa: E731
        out = reference_attention(as_torch(q), as_torch(k), as_torch(v), 0.2)
        assert_bf16_close(out, ref)

    def test_wrapper_takes_plain_version_on_cpu(self, rng):
        q, k, v = (t(rng.normal(size=(1, 2, 9, 32)).astype(np.float32)) for _ in range(3))
        before = dict(_kernels.launch_counts)
        torch.testing.assert_close(
            flash_attention(q, k, v, 0.3), reference_attention(q, k, v, 0.3), rtol=0, atol=0
        )
        assert _kernels.launch_counts == before  # no kernel launched, none counted

    def test_wrapper_never_falls_back_off_cpu(self):
        q = torch.empty((1, 2, 8, 32), device="meta")
        with pytest.raises(ValueError, match="CUDA"):
            flash_attention(q, q, q, 1.0)
        with pytest.raises(ValueError, match="head dims"):
            flash_attention(q[..., :16], q[..., :16], q[..., :16], 1.0)


class TestFusedBottleneckPlain:
    @pytest.mark.parametrize("downsample", [False, True])
    def test_plain_matches_pallas_interpret(self, rng, downsample):
        B, H, W, cin, cmid = 2, 16, 24, 64, 16
        cout = 64
        x = rng.normal(size=(B, H, W, cin)).astype(np.float32) * 0.2
        w = bottleneck_weights(rng, cin, cmid, cout, downsample)
        ref = jax_fused_bottleneck(
            jnp.asarray(x), **{k: jnp.asarray(v) for k, v in w.items()},
            tile_h=8, interpret=True,
        )
        out = bottleneck_plain(t(x), **{k: t(v) for k, v in w.items()})
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)

    @pytest.mark.parametrize("downsample", [False, True])
    def test_bf16_plain_matches_pallas_interpret(self, rng, downsample):
        B, H, W, cin, cmid, cout = 1, 16, 16, 64, 16, 64
        x = np.abs(rng.normal(size=(B, H, W, cin))).astype(np.float32)
        w = bottleneck_weights(rng, cin, cmid, cout, downsample)
        ref = jax_fused_bottleneck(
            jnp.asarray(x).astype(jnp.bfloat16), **{k: jnp.asarray(v) for k, v in w.items()},
            tile_h=8, interpret=True,
        )
        out = bottleneck_plain(t(x).to(torch.bfloat16), **{k: t(v) for k, v in w.items()})
        assert_bf16_close(out, ref)

    def test_wrapper_takes_plain_version_on_cpu(self, rng):
        x = t(rng.normal(size=(1, 8, 8, 32)).astype(np.float32))
        w = {k: t(v) for k, v in bottleneck_weights(rng, 32, 8, 32, False).items()}
        torch.testing.assert_close(fused_bottleneck(x, **w), bottleneck_plain(x, **w),
                                   rtol=0, atol=0)

    def test_wrapper_never_falls_back_off_cpu(self, rng):
        w = {k: t(v).to("meta") for k, v in bottleneck_weights(rng, 64, 64, 256, True).items()}
        x = torch.empty((1, 8, 8, 64), device="meta")
        with pytest.raises(ValueError, match="CUDA"):
            fused_bottleneck(x, **w)
        with pytest.raises(ValueError, match="unsupported shapes"):
            fused_bottleneck(x, **{**w, "wd": None, "bd": None})  # identity needs cin == cout


class TestFusedStemPlain:
    def test_space_to_depth_and_weight_transform_match_jax(self, rng):
        x, w7, _, _ = stem_inputs(rng, 1, 8, 12)
        np.testing.assert_array_equal(
            space_to_depth(t(x)).numpy(), np.asarray(jax_space_to_depth(jnp.asarray(x)))
        )
        np.testing.assert_array_equal(
            stem_weights_to_space_to_depth(t(w7)).numpy(),
            np.asarray(jax_stem_weights_to_space_to_depth(jnp.asarray(w7))),
        )

    @pytest.mark.parametrize("B,H,W", [(2, 64, 96), (1, 32, 64)])
    def test_plain_matches_pallas_interpret(self, rng, B, H, W):
        x, w7, scale, shift = stem_inputs(rng, B, H, W)
        w4_jax = jax_stem_weights_to_space_to_depth(jnp.asarray(w7)) * scale
        ref = jax_fused_stem(
            jax_space_to_depth(jnp.asarray(x)), w4_jax, jnp.asarray(shift),
            tile_p=8, interpret=True,
        )
        w4 = stem_weights_to_space_to_depth(t(w7)) * t(scale)
        out = stem_plain(space_to_depth(t(x)), w4, t(shift))
        assert out.shape == ref.shape
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)

    def test_bf16_plain_matches_pallas_interpret(self, rng):
        x, w7, scale, shift = stem_inputs(rng, 1, 32, 64)
        xs = jax_space_to_depth(jnp.asarray(x)).astype(jnp.bfloat16)
        w4 = (jax_stem_weights_to_space_to_depth(jnp.asarray(w7)) * scale).astype(jnp.bfloat16)
        ref = jax_fused_stem(xs, w4, jnp.asarray(shift), tile_p=8, interpret=True)
        as_torch = lambda a: t(np.asarray(a.astype(jnp.float32))).to(torch.bfloat16)  # noqa: E731
        assert_bf16_close(stem_plain(as_torch(xs), as_torch(w4), t(shift)), ref)

    def test_wrapper_takes_plain_version_on_cpu(self, rng):
        x, w7, scale, shift = stem_inputs(rng, 1, 32, 32)
        xs, w4 = space_to_depth(t(x)), stem_weights_to_space_to_depth(t(w7))
        torch.testing.assert_close(fused_stem(xs, w4, t(shift)), stem_plain(xs, w4, t(shift)),
                                   rtol=0, atol=0)

    def test_wrapper_never_falls_back_off_cpu(self):
        xs = torch.empty((1, 16, 16, 12), device="meta")
        w4 = torch.empty((4, 4, 12, 64), device="meta")
        with pytest.raises(ValueError, match="CUDA"):
            fused_stem(xs, w4, torch.empty(64, device="meta"))
