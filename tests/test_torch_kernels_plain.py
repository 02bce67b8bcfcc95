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

from future_od_tpu_torch.models import layers as port_layers
from future_od_tpu_torch.models.resnet import (
    Bottleneck,
    space_to_depth,
    stem_weights_to_space_to_depth,
)
from future_od_tpu_torch.ops import _kernels
from future_od_tpu_torch.ops import flash_attention as fa
from future_od_tpu_torch.ops.flash_attention import (
    SUPPORTED_HEAD_DIMS,
    flash_attention,
    reference_attention,
)
from future_od_tpu_torch.ops.fused_resnet import (
    bottleneck_plain,
    fused_bottleneck,
    fused_bottleneck_packed,
    fused_stem,
    pack_bottleneck,
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
        """Off the CPU the wrapper launches or raises: at head dims it pads
        (8) it stops at the missing card; above 256 it raises on them."""
        q = torch.empty((1, 2, 8, 32), device="meta")
        with pytest.raises(ValueError, match="CUDA"):
            flash_attention(q, q, q, 1.0)
        with pytest.raises(ValueError, match="CUDA"):
            flash_attention(q[..., :8], q[..., :8], q[..., :8], 1.0)
        wide = torch.empty((1, 2, 8, 264), device="meta")
        with pytest.raises(ValueError, match="head dims"):
            flash_attention(wide, wide, wide, 1.0)


class TestHeadDimDispatch:
    """The flash gates (models/layers.py) look at sizes only: attention at any
    head dims past them goes to the kernels' wrappers, which take their plain
    versions on the CPU and, off it, launch a built pair (padding any pair up
    to 256 onto one) or raise. Nothing in front of a wrapper gives way to the
    plain attention on the card."""

    @pytest.mark.parametrize("d,dv", SUPPORTED_HEAD_DIMS)
    def test_wrappers_take_the_built_pairs(self, d, dv):
        """Off the CPU (meta tensors) a built pair passes the head-dim check
        and stops only at the missing card."""
        q, k, v = (torch.empty((1, 2, 64, n), device="meta") for n in (d, d, dv))
        with pytest.raises(ValueError, match="CUDA"):
            flash_attention(q, k, v, 1.0)
        q, k, v = (t.reshape(2, 64, -1) for t in (q, k, v))
        with pytest.raises(ValueError, match="CUDA"):
            fa.flash_train_fwd(q, k, v, 7, 1.0, 0.0, 256, 512)

    @pytest.mark.parametrize("d,dv", [(8, 8), (16, 8), (16, 32), (128, 64), (128, 128),
                                      (256, 128), (136, 64), (264, 128), (64, 272)])
    def test_wrappers_raise_on_other_pairs(self, d, dv):
        """Off the CPU (meta tensors) every pair up to 256, built or not
        (the wrappers pad it onto a built one), passes the head-dim check
        and stops only at the missing card; above 256 the wrappers raise on
        the head dims."""
        match = "head dims" if max(d, dv) > fa.MAX_HEAD_DIM else "CUDA"
        q, k, v = (torch.empty((1, 2, 64, n), device="meta") for n in (d, d, dv))
        with pytest.raises(ValueError, match=match):
            flash_attention(q, k, v, 1.0)
        q, k, v = (t.reshape(2, 64, -1) for t in (q, k, v))
        with pytest.raises(ValueError, match=match):
            fa.flash_train_fwd(q, k, v, 7, 1.0, 0.0, 256, 512)

    @pytest.mark.parametrize("training", [False, True])
    @pytest.mark.parametrize("d", [8, 16, 64])
    def test_attend_heads_routes_by_size_alone(self, rng, monkeypatch, training, d):
        """4 heads of d over 1024 keys and queries, above both size gates:
        the kernel's wrapper (its plain version here) takes the attention at
        every d, built or not, and gives the plain result."""
        monkeypatch.setenv("FUTURE_OD_TRAIN_FLASH", "1")
        name = "flash_attention_train" if training else "flash_attention"
        seen, original = [], getattr(port_layers, name)
        monkeypatch.setattr(port_layers, name, lambda *a, **k: seen.append(1) or original(*a, **k))
        qh, kh, vh = (t(rng.normal(size=(1, 1024, 4, d)).astype(np.float32)) for _ in range(3))
        drop = torch.nn.Dropout(0.0).train(training)
        out = port_layers.attend_heads(qh, kh, vh, d**-0.5, drop)
        assert len(seen) == 1 and out.shape == (1, 1024, 4 * d)
        monkeypatch.setenv("FUTURE_OD_DISABLE_FLASH", "1")
        torch.testing.assert_close(out, port_layers.attend_heads(qh, kh, vh, d**-0.5, drop),
                                   rtol=0, atol=2e-6)


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

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_packed_weights(self, rng, dtype):
        """pack_bottleneck: weights in the storage type, w2 as the im2col
        matrix, in bf16 w1 and w2 transposed; fused_bottleneck_packed gives
        fused_bottleneck's result."""
        x = t(np.abs(rng.normal(size=(1, 8, 12, 64)))).to(dtype)
        w = {k: t(v) for k, v in bottleneck_weights(rng, 64, 64, 256, True).items()}
        p = pack_bottleneck(dtype, **w)
        assert p.w1.dtype == p.w2.dtype == p.wd.dtype == dtype and p.b1.dtype == torch.float32
        assert p.w2.shape == (9 * 64, 64)
        if dtype == torch.bfloat16:
            torch.testing.assert_close(p.w1t, p.w1.t(), rtol=0, atol=0)
            torch.testing.assert_close(p.w2t, p.w2.t(), rtol=0, atol=0)
        else:
            assert p.w1t is None and p.w2t is None
        torch.testing.assert_close(fused_bottleneck_packed(x, p), fused_bottleneck(x, **w),
                                   rtol=0, atol=0)

    def test_packed_for_another_dtype_is_refused(self, rng):
        w = {k: t(v) for k, v in bottleneck_weights(rng, 64, 64, 256, True).items()}
        p = pack_bottleneck(torch.float32, **w)
        p = type(p)(*(None if v is None else v.to("meta") for v in p))
        with pytest.raises(ValueError, match="packed for"):
            fused_bottleneck_packed(torch.empty((1, 8, 8, 64), device="meta",
                                                dtype=torch.bfloat16), p)

    def test_block_packs_its_weights_once(self):
        """models/resnet.py's Bottleneck keeps its pack until a parameter or
        buffer changes: written in place, or cast."""
        block = Bottleneck(64, 64, downsample=True).eval()
        first = block.fused_weights(torch.float32)
        assert block.fused_weights(torch.float32) is first
        with torch.no_grad():
            block.conv1.weight.mul_(2.0)
        again = block.fused_weights(torch.float32)
        assert again is not first
        torch.testing.assert_close(again.w1, 2.0 * first.w1)
        block.to(torch.bfloat16)
        with torch.inference_mode():  # as make_inference_fn calls it
            packed = block.fused_weights(torch.bfloat16)
            assert block.fused_weights(torch.bfloat16) is packed
        assert packed.w1.dtype == torch.bfloat16 and packed.w1t is not None
        assert not packed.w1.is_inference() and not packed.w1.requires_grad

    def test_wrapper_refuses_cin_off_the_staged_chunk(self, rng):
        """The kernel stages 64 input channels a chunk (bf16; 32 in f32)."""
        w = {k: t(v).to("meta") for k, v in bottleneck_weights(rng, 96, 64, 256, True).items()}
        with pytest.raises(ValueError, match="unsupported shapes"):
            fused_bottleneck(torch.empty((1, 8, 8, 96), device="meta"), **w)


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
