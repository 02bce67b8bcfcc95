"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here needs a CUDA device (the kernels are CUDA C++ with no CPU
mode) and skips without one. This file imports only torch, numpy and the
port, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py -q

(`--noconftest`: tests/conftest.py configures JAX.) The first test builds the
kernels with nvcc.
"""
import math

import numpy as np
import pytest
import torch

from future_od_tpu_torch.models.build import build_flagship
from future_od_tpu_torch.models.resnet import space_to_depth, stem_weights_to_space_to_depth
from future_od_tpu_torch.models.st_detr import SpatioTemporalDETRArgs
from future_od_tpu_torch.ops import _kernels
from future_od_tpu_torch.ops import flash_attention as fa
from future_od_tpu_torch.ops.attention_floor import (
    MODES,
    attention_floor,
    attention_floor_plain,
    exact_logit_inputs,
)
from future_od_tpu_torch.ops.flash_attention import flash_attention, reference_attention
from future_od_tpu_torch.ops.fused_resnet import (
    bottleneck_plain,
    bottleneck_plan,
    fused_bottleneck,
    fused_bottleneck_v2,
    fused_layer1,
    fused_stem,
    layer1_plain,
    stem_plain,
)
from future_od_tpu_torch.tools import bench_stem
from future_od_tpu_torch.train.step import make_inference_fn

pytestmark = pytest.mark.cuda

# Elementwise: |out - plain| <= RTOL * |plain| + ATOL * max |plain|. f32:
# reassociated sums. bf16: the plain versions compute in f32 from the same
# bf16 values and round where the kernels round, so both sides round f32
# values once (one bf16 ulp, 2^-7 relative, apart), plus 1e-3 of the output's
# scale for a fused bottleneck intermediate rounded to the other side of a
# bf16 boundary.
RTOL = {torch.float32: 0.0, torch.bfloat16: 2.0**-7}
ATOL = {torch.float32: 2e-5, torch.bfloat16: 1e-3}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are CUDA C++ with no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture
def np_rng():
    return np.random.default_rng(0)


def on(device, dtype, *arrays):
    return [torch.from_numpy(np.asarray(a, np.float32)).to(device, dtype) for a in arrays]


def assert_close(out, ref, dtype, tol_dtype=None, atol=None):
    """Within the tolerance of tol_dtype (default dtype); atol overrides its
    ATOL."""
    assert out.dtype == ref.dtype == dtype
    out, ref = out.float(), ref.float()
    tol_dtype = dtype if tol_dtype is None else tol_dtype
    atol = ATOL[tol_dtype] if atol is None else atol
    tol = RTOL[tol_dtype] * ref.abs() + atol * ref.abs().max()
    diff = (out - ref).abs()
    assert bool((diff <= tol).all()), (diff.max().item(), ref.abs().max().item())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "B,H,Nq,Nk,d,dv",
    [(4, 8, 1400, 1400, 32, 32), (1, 2, 70, 130, 64, 32), (1, 1, 17, 65, 32, 32),
     # cutting the 16-row mma tiles and the 64-key tiles raggedly
     (1, 1, 1, 1, 32, 32), (1, 3, 100, 1400, 32, 32), (2, 8, 1400, 1400, 64, 32),
     # heads of 16 (runs/nuim_single_frame.py --debug): the encoder's 16/16 and
     # the conditional cross-attention's 32/16
     (2, 4, 1024, 1024, 16, 16), (1, 2, 70, 130, 16, 16), (1, 1, 17, 65, 32, 16),
     (2, 4, 300, 1024, 32, 16),
     # an encoder's heads of 64 (hidden 512 over 8 heads)
     (1, 8, 1024, 1024, 64, 64), (1, 2, 70, 130, 64, 64)],
)
def test_flash_attention(cuda, np_rng, dtype, B, H, Nq, Nk, d, dv):
    q, k, v = on(cuda, dtype, np_rng.normal(size=(B, H, Nq, d)),
                 np_rng.normal(size=(B, H, Nk, d)), np_rng.normal(size=(B, H, Nk, dv)))
    before = _kernels.launch_counts["flash_attention"]
    out = flash_attention(q, k, v, 1.0 / math.sqrt(d))
    torch.cuda.synchronize()
    assert _kernels.launch_counts["flash_attention"] == before + 1
    assert out.dtype == dtype and out.shape == (B, H, Nq, dv)
    assert_close(out, reference_attention(q, k, v, 1.0 / math.sqrt(d)), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("scale", [-0.2, 0.0])
def test_flash_attention_scale_sign(cuda, np_rng, dtype, scale):
    """A negative scale (folded into q) and scale 0 (a plain mean of v; the
    ragged key tile's missing keys must still weigh 0)."""
    q, k, v = on(cuda, dtype, np_rng.normal(size=(1, 2, 70, 64)),
                 np_rng.normal(size=(1, 2, 130, 64)), np_rng.normal(size=(1, 2, 130, 32)))
    out = flash_attention(q, k, v, scale)
    torch.cuda.synchronize()
    assert_close(out, reference_attention(q, k, v, scale), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [32, 64])
def test_flash_attention_large_logits(cuda, np_rng, dtype, d):
    """Logits of about 1e3: the softmax is nearly one-hot and the running max
    moves from tile to tile. Integer q and k and a power-of-two scale keep
    the logits exact in f32 on both sides, so the f32 tolerance measures the
    kernel and not the plain version's rounding of 1e3-sized logits."""
    q, k = on(cuda, dtype, np_rng.integers(-64, 65, size=(1, 2, 200, d)),
              np_rng.integers(-64, 65, size=(1, 2, 300, d)))
    (v,) = on(cuda, dtype, np_rng.normal(size=(1, 2, 300, 32)))
    logits = (q.float() @ k.float().transpose(-1, -2)) * 0.125
    assert 500.0 < logits.abs().max().item() < 1e4
    out = flash_attention(q, k, v, 0.125)
    torch.cuda.synchronize()
    assert_close(out, reference_attention(q, k, v, 0.125), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "B,H,W,cin,cmid,cout,downsample",
    [(2, 12, 20, 64, 64, 256, True), (1, 9, 11, 256, 64, 256, False),
     (1, 16, 16, 512, 128, 512, False),
     # one row of 8 x 16 tiles, the last one ragged (W % 16 != 0), at each cin
     # with and without the downsample; 200 is layer2's width (12.5 tiles)
     (1, 8, 20, 64, 64, 256, True), (1, 8, 24, 256, 64, 256, True),
     (1, 8, 24, 256, 64, 256, False), (1, 8, 40, 512, 128, 512, True),
     (1, 8, 200, 512, 128, 512, False)],
)
def test_fused_bottleneck(cuda, np_rng, dtype, B, H, W, cin, cmid, cout, downsample):
    (x,) = on(cuda, dtype, np.abs(np_rng.normal(size=(B, H, W, cin))))
    shapes = dict(w1=(cin, cmid), b1=(cmid,), w2=(3, 3, cmid, cmid), b2=(cmid,),
                  w3=(cmid, cout), b3=(cout,))
    if downsample:
        shapes.update(wd=(cin, cout), bd=(cout,))
    w = {
        k: on(cuda, torch.float32 if k.startswith("b") else dtype,
              np_rng.normal(size=s) * math.sqrt(1.0 / s[0]))[0]
        for k, s in shapes.items()
    }
    before = _kernels.launch_counts["fused_bottleneck"]
    out = fused_bottleneck(x, **w)
    torch.cuda.synchronize()
    assert _kernels.launch_counts["fused_bottleneck"] == before + 1
    assert_close(out, bottleneck_plain(x, **w), dtype)


def test_fused_bottleneck_every_intermediate_on_a_tie(cuda):
    """bf16, every h1 and h2 exactly on a bf16 rounding tie (h1 = 1 + 2^-8,
    h2 = 1 - 2^-9): every value is flagged for the sequential recompute,
    the queue overflows in both stages and each stage recomputes all of its
    values; both round the ties to even as the plain version does."""
    bf16, f32 = torch.bfloat16, torch.float32
    x = torch.zeros(1, 8, 20, 64, device=cuda)
    x[..., 0] = 1.0078125  # 1 + 2^-7
    w1 = torch.zeros(64, 64, device=cuda)
    w1[0] = 0.99609375  # 1 - 2^-8: x w1 = 1 + 2^-8 - 2^-15, exact
    w2 = torch.zeros(3, 3, 64, 64, device=cuda)
    w2[1, 1, 0] = 0.99609375  # the centre tap of channel 0 only
    gen = torch.Generator(device=cuda).manual_seed(0)
    w = dict(w1=w1.to(bf16), b1=torch.full((64,), 2.0**-15, device=cuda), w2=w2.to(bf16),
             b2=torch.full((64,), 2.0**-9, device=cuda),
             w3=(torch.randn(64, 256, generator=gen, device=cuda) * 0.1).to(bf16),
             b3=torch.zeros(256, device=cuda), wd=torch.zeros(64, 256, device=cuda, dtype=bf16),
             bd=torch.zeros(256, device=cuda, dtype=f32))
    out = fused_bottleneck(x.to(bf16), **w)
    torch.cuda.synchronize()
    assert_close(out, bottleneck_plain(x.to(bf16), **w), bf16)


# videos: 16 x 24 pools (two row tiles of 7 rows, the second ragged); 10 x 18 and
# 15 x 25 (ragged row and column tiles of 7 x 8 pools)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,W", [(2, 64, 96), (1, 40, 72), (1, 60, 100)])
def test_fused_stem(cuda, np_rng, dtype, B, H, W):
    x = torch.from_numpy(np_rng.normal(size=(B, H, W, 3)).astype(np.float32))
    w7 = torch.from_numpy((np_rng.normal(size=(7, 7, 3, 64)) * 0.1).astype(np.float32))
    (bias,) = on(cuda, torch.float32, np_rng.normal(size=(64,)) * 0.1)
    xs = space_to_depth(x).to(cuda, dtype)
    w4 = stem_weights_to_space_to_depth(w7).to(cuda, dtype)
    before = _kernels.launch_counts["fused_stem"]
    out = fused_stem(xs, w4, bias)
    torch.cuda.synchronize()
    assert _kernels.launch_counts["fused_stem"] == before + 1
    assert_close(out, stem_plain(xs, w4, bias), dtype)


def bottleneck_weights(device, dtype, np_rng, cin, cmid, cout, downsample):
    shapes = dict(w1=(cin, cmid), b1=(cmid,), w2=(3, 3, cmid, cmid), b2=(cmid,),
                  w3=(cmid, cout), b3=(cout,))
    if downsample:
        shapes.update(wd=(cin, cout), bd=(cout,))
    return {
        k: on(device, torch.float32 if k.startswith("b") else dtype,
              np_rng.normal(size=s) * math.sqrt(1.0 / s[0]))[0]
        for k, s in shapes.items()
    }


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize(
    "B,H,Nq,Nk,block_k",
    [(1, 8, 1400, 1400, 1408),  # the tool's rows, one image: 8 zero keys a row
     (1, 2, 70, 40, 16),  # 3 key blocks in bf16sm, 8 zero keys
     (2, 1, 17, 130, 64)],  # 62 zero keys: the bf16 running max starts at 0
)
def test_attention_floor(cuda, dtype, mode, B, H, Nq, Nk, block_k):
    """T1, every mode, against its plain version on inputs whose logits are
    exact in f32 (`exact_logit_inputs`), so both sides round them alike. The
    function rounds to bf16 inside in every storage type (the block's row sum
    in bf16sm: an f32 sum taken in another order can round to the next bf16
    value), so f32 outputs are held to the bf16 tolerance too."""
    scale = 1.0 / math.sqrt(32)
    gen = torch.Generator(device=cuda).manual_seed(Nq)
    q, k, v = (t.to(dtype) for t in exact_logit_inputs(B, H, Nq, Nk, scale, gen))
    before = _kernels.launch_counts["attention_floor"]
    out = attention_floor(q, k, v, scale, mode, block_k)
    torch.cuda.synchronize()
    assert _kernels.launch_counts["attention_floor"] == before + 1
    assert out.shape == (B, H, Nq, 32)
    assert_close(out, attention_floor_plain(q, k, v, scale, mode, block_k), dtype, torch.bfloat16)


V2_SHAPES = [  # (B, H, W, cin, cmid, cout, downsample): ragged tiles at every edge
    (2, 20, 13, 256, 64, 256, False),
    (1, 19, 11, 64, 128, 256, True),
    (1, 12, 9, 1024, 256, 1024, False),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("im2col", [False, True])
@pytest.mark.parametrize("tile_h", [8, 16, 32])
@pytest.mark.parametrize("B,H,W,cin,cmid,cout,downsample", V2_SHAPES)
def test_bottleneck_v2(cuda, np_rng, dtype, im2col, tile_h, B, H, W, cin, cmid, cout, downsample):
    (x,) = on(cuda, dtype, np.abs(np_rng.normal(size=(B, H, W, cin))))
    w = bottleneck_weights(cuda, dtype, np_rng, cin, cmid, cout, downsample)
    before = _kernels.launch_counts["bottleneck_v2"]
    out = fused_bottleneck_v2(x, **w, tile_h=tile_h, im2col=im2col)
    torch.cuda.synchronize()
    assert _kernels.launch_counts["bottleneck_v2"] == before + 1
    assert_close(out, bottleneck_plain(x, **w), dtype)
    plan = bottleneck_plan(False, tile_h, cmid, im2col, dtype)
    assert plan["tile_w"] >= 1 and (plan["k_chunk"] > 0) == im2col


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tile_h", [4, 8, 16])
def test_fused_layer1(cuda, np_rng, dtype, tile_h):
    """T2 v3 against three chained plain bottlenecks; 20x27 puts ragged tiles
    at the bottom and right edges and tiles at all four. In bf16 each block's
    output can round to the other side of a bf16 boundary (one ulp, 2^-8 of
    at most max |plain|), and the later blocks' identity residuals carry it
    to the result: 3 x 2^-8."""
    (x,) = on(cuda, dtype, np.abs(np_rng.normal(size=(2, 20, 27, 64))))
    blocks = [bottleneck_weights(cuda, dtype, np_rng, 64 if i == 0 else 256, 64, 256, i == 0)
              for i in range(3)]
    before = _kernels.launch_counts["fused_layer1"]
    out = fused_layer1(x, blocks, tile_h=tile_h)
    torch.cuda.synchronize()
    assert _kernels.launch_counts["fused_layer1"] == before + 1
    assert_close(out, layer1_plain(x, blocks), dtype,
                 atol=3 * 2.0**-8 if dtype == torch.bfloat16 else None)


# The stage-1 training shapes (448x800: 350 tokens) at batch 4: the encoder's
# self-attention over 4 clips x 2 past frames x 8 heads, and the decoder's
# image cross-attention with concat heads over 4 clips x 8 heads.
TRAIN_SHAPES = [(64, 350, 350, 32, 32), (32, 128, 350, 64, 32)]
# The flagship script's training shapes: stage 1 (448x800: 350 tokens) at
# batch 32, where the decoder's 256 batch-heads take split 1, and stage 2
# (896x1600: 1400 tokens) at batch 16: the encoder's self-attention over
# clips x 2 past frames x 8 heads, the decoder's image cross-attention over
# clips x 8 heads.
SCRIPT_TRAIN_SHAPES = [(512, 350, 350, 32, 32), (256, 128, 350, 64, 32),
                       (256, 1400, 1400, 32, 32), (128, 128, 1400, 64, 32)]
# the same attentions at heads of 16 (runs/nuim_single_frame.py --debug), and
# an encoder self-attention at heads of 64
HEAD16_TRAIN_SHAPES = [(32, 350, 350, 16, 16), (16, 128, 350, 32, 16)]
HEAD64_TRAIN_SHAPES = [(32, 350, 350, 64, 64)]
# ragged edges at every built head-dim pair: 17 and 129 queries or keys (one
# real row or key past a 16-row slab, a 64-key tile or a 128-row block), at
# few batch*heads, where K4 and K5 split a slab's keys across warps
RAGGED_TRAIN_SHAPES = [(BH, Nq, Nk, d, dv) for d, dv in fa.SUPPORTED_HEAD_DIMS
                       for BH, Nq, Nk in ((2, 17, 129), (3, 129, 17))]


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("BH,Nq,Nk,d,dv", TRAIN_SHAPES + SCRIPT_TRAIN_SHAPES + HEAD16_TRAIN_SHAPES
                         + HEAD64_TRAIN_SHAPES + RAGGED_TRAIN_SHAPES)
def test_flash_train_kernels(cuda, np_rng, dtype, rate, BH, Nq, Nk, d, dv):
    """K4, K5 and K6 against their plain versions on the same inputs (K5 and
    K6 given the plain forward's lse and delta)."""
    q, k, v, do = on(cuda, dtype, np_rng.normal(size=(BH, Nq, d)), np_rng.normal(size=(BH, Nk, d)),
                     np_rng.normal(size=(BH, Nk, dv)), np_rng.normal(size=(BH, Nq, dv)))
    nq_pad, nk_pad = fa.train_shapes(Nq, Nk, 256, 512)
    args = (777, 1.0 / math.sqrt(d), rate, nq_pad, nk_pad)
    ref_out, ref_lse = fa.flash_train_fwd_plain(q, k, v, *args)
    delta = (do.float() * ref_out.float()).sum(-1)
    before = dict(_kernels.launch_counts)
    out, lse = fa.flash_train_fwd(q, k, v, *args)
    dq = fa.flash_dq(q, k, v, do, ref_lse, delta, *args)
    dk, dv_ = fa.flash_dkv(q, k, v, do, ref_lse, delta, *args)
    torch.cuda.synchronize()
    for name in ("flash_train_fwd", "flash_train_dq", "flash_train_dkv"):
        assert _kernels.launch_counts[name] == before[name] + 1, name
    assert_close(out, ref_out, dtype)
    torch.testing.assert_close(lse, ref_lse, rtol=0, atol=2e-5 * ref_lse.abs().max().item())
    assert_close(dq, fa.flash_dq_plain(q, k, v, do, ref_lse, delta, *args), dtype)
    ref_dk, ref_dv = fa.flash_dkv_plain(q, k, v, do, ref_lse, delta, *args)
    assert_close(dk, ref_dk, dtype)
    assert_close(dv_, ref_dv, dtype)


def test_flash_train_dkv_splits(cuda):
    """K6 splits a 16-key slab's queries across 2 or 4 warps where 64-key
    blocks would not give every SM two: the test shapes reach every split."""
    splits = {shape: fa.flash_train_info("flash_train_dkv", shape[3], shape[4], torch.float32,
                                         *shape[:3])["split"]
              for shape in (TRAIN_SHAPES[0], TRAIN_SHAPES[1], RAGGED_TRAIN_SHAPES[0])}
    assert sorted(splits.values()) == [1, 2, 4], splits


@pytest.mark.parametrize("magnitude", [1e3, 3.2e3])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("BH,Nq,Nk,d,dv", TRAIN_SHAPES)
def test_flash_train_saturated_logits(cuda, np_rng, rate, magnitude, BH, Nq, Nk, d, dv):
    """Logits of about 1e6 and 1e7 (q and k of `magnitude`), as a randomly
    initialised backbone feeds the encoder: every row's softmax is one-hot.
    K5 and K6, given K4's lse, must recompute p <= 1 (K4 and K5 on the tensor
    cores compute the logits as K6 does, bit for bit), so that dv equals the
    f64 reference and dq, dk stay at rounding level (a recompute rounded
    otherwise put p far above 1 here)."""
    q, k, v, do = on(cuda, torch.float32, np_rng.normal(size=(BH, Nq, d)) * magnitude,
                     np_rng.normal(size=(BH, Nk, d)) * magnitude,
                     np_rng.normal(size=(BH, Nk, dv)), np_rng.normal(size=(BH, Nq, dv)))
    nq_pad, nk_pad = fa.train_shapes(Nq, Nk, 256, 512)
    args = (777, 1.0 / math.sqrt(d), rate, nq_pad, nk_pad)
    logits = args[1] * q.double() @ k.double().transpose(1, 2)
    top2 = logits.topk(2, dim=-1).values
    # only rows whose top two logits lie 30 apart: their softmax is one-hot
    # in f32 as in f64 (an f32 lse of 1e6 cannot hold log(1 + e^-gap) < 2^-5)
    do = do * (top2[..., 0] - top2[..., 1] > 30.0)[..., None]
    out, lse = fa.flash_train_fwd(q, k, v, *args)
    delta = (do * out).sum(-1)
    dq = fa.flash_dq(q, k, v, do, lse, delta, *args)
    dk, dv_ = fa.flash_dkv(q, k, v, do, lse, delta, *args)
    assert all(bool(torch.isfinite(t).all()) for t in (out, lse, dq, dk, dv_))
    p = torch.softmax(logits, -1)
    if rate > 0:
        p = p * fa._mask(777, BH, Nq, Nk, rate, nq_pad, nk_pad, cuda).double()
    ref_dv = p.transpose(1, 2) @ do.double()
    torch.testing.assert_close(dv_.double(), ref_dv, rtol=0, atol=2e-5 * ref_dv.abs().max().item())
    # the most |dlogits| can be with p <= 1, times the largest row of the
    # other operand and the number of terms summed
    dlogit_max = 2 * fa.dropout_keep_scale(rate) * dv * do.abs().max() * v.abs().max()
    for grad, other, terms in ((dq, k, Nk), (dk, q, Nq)):
        bound = terms * args[1] * other.abs().max() * dlogit_max
        assert grad.abs().max() <= 1e-6 * bound, (grad.abs().max().item(), bound.item())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("BH,Nq,Nk,d,dv", TRAIN_SHAPES)
def test_flash_train_strided_views(cuda, np_rng, dtype, BH, Nq, Nk, d, dv):
    """The model's layout: (B, N, H, d) storage passed as (B, H, N, d) views.
    The kernels read it in place and give the contiguous copies' results bit
    for bit; out and the gradients come back in the (B, N, H, w) layout."""
    H = 8
    qh, kh, vh, doh = on(cuda, dtype, np_rng.normal(size=(BH // H, Nq, H, d)),
                         np_rng.normal(size=(BH // H, Nk, H, d)),
                         np_rng.normal(size=(BH // H, Nk, H, dv)),
                         np_rng.normal(size=(BH // H, Nq, H, dv)))
    args = (777, 1.0 / math.sqrt(d), 0.1, *fa.train_shapes(Nq, Nk, 256, 512))
    results = []
    for views in (True, False):
        q, k, v = (t.transpose(1, 2) if views else t.transpose(1, 2).contiguous()
                   for t in (qh, kh, vh))
        q, k, v = (t.detach().requires_grad_(True) for t in (q, k, v))
        out = fa.FlashAttentionTrain.apply(q, k, v, *args)
        out.backward(doh.transpose(1, 2))
        results.append((out, q.grad, k.grad, v.grad))
    for got, want in zip(*results):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert results[0][0].transpose(1, 2).is_contiguous()
    assert results[0][1].transpose(1, 2).is_contiguous()


@pytest.mark.parametrize("BH,Nq,Nk,d,dv", SCRIPT_TRAIN_SHAPES)
def test_flash_train_bf16_autograd_at_step_shapes(cuda, np_rng, BH, Nq, Nk, d, dv):
    """K4-K6 in bf16 under autograd at the Trainer step's shapes, in the
    model's (B, N, H, d) layout, from f32 master tensors cast to bf16 (as
    `train/step.py`'s mixed precision casts its parameters): the masters'
    gradients are f32 and equal those of autograd through the plain version
    within the bf16 tolerance, and each kernel launches once."""
    H = 8
    masters = [torch.from_numpy(np_rng.normal(size=(BH // H, n, H, w)).astype(np.float32))
               .to(cuda).requires_grad_(True) for n, w in ((Nq, d), (Nk, d), (Nk, dv))]
    doh = on(cuda, torch.float32, np_rng.normal(size=(BH // H, Nq, H, dv)))[0]
    args = (777, 1.0 / math.sqrt(d), 0.1, *fa.train_shapes(Nq, Nk, 256, 512))
    grads = []
    for kernel in (True, False):
        q, k, v = (m.to(torch.bfloat16).transpose(1, 2) for m in masters)
        before = dict(_kernels.launch_counts)
        out = (fa.FlashAttentionTrain.apply(q, k, v, *args) if kernel
               else fa.flash_train_fwd_plain(q, k, v, *args)[0])
        assert out.dtype == torch.bfloat16
        out.float().backward(doh.transpose(1, 2))
        torch.cuda.synchronize()
        launched = {n for n in ("flash_train_fwd", "flash_train_dq", "flash_train_dkv")
                    if _kernels.launch_counts[n] == before[n] + 1}
        assert len(launched) == (3 if kernel else 0)
        assert all(m.grad.dtype == torch.float32 for m in masters)
        grads.append([m.grad.clone() for m in masters])
        for m in masters:
            m.grad = None
    for got, want in zip(*grads):
        assert_close(got.to(torch.bfloat16), want.to(torch.bfloat16), torch.bfloat16)


# (B, Nq, Nk, d, dv) at 8 heads: chip_smoke phase 10d's encoder and decoder
# attentions (8 clips), and an encoder of 6 clips. On an H100 (132 SMs) a
# call over 4 of the 8 heads takes the all-heads call's split at the first
# (and in K4 and K5 at the second), not in K6 at the second nor at the third
# (a smaller grid splits a slab's rows over more warps)
HEAD_SHARE_SHAPES = [(16, 350, 350, 32, 32), (8, 128, 350, 64, 32), (6, 350, 350, 32, 32)]


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Nq,Nk,d,dv", HEAD_SHARE_SHAPES)
def test_flash_train_head_share_is_the_full_call_slice(cuda, np_rng, dtype, rate, B, Nq, Nk, d,
                                                       dv):
    """K4, K5 and K6 over heads h0..h0+4 of 8 (`heads=(4, 8, h0)`, a
    tensor-parallel rank's call) give the all-heads call's slice: bit for
    bit where both calls take the same split, within the kernels'
    tolerance where they do not; the dropout mask is the same either way
    (hashed at the global heads). The defaults equal heads=(8, 8, 0)."""
    H, share = 8, 4
    q, k, v, do = on(cuda, dtype, *(np_rng.normal(size=(B, H, n, w))
                                    for n, w in ((Nq, d), (Nk, d), (Nk, dv), (Nq, dv))))
    args = (777, 1.0 / math.sqrt(d), rate, *fa.train_shapes(Nq, Nk, 256, 512))

    def calls(heads, part):
        qs, ks, vs, dos = (t[:, part] for t in (q, k, v, do))
        out, lse = fa.flash_train_fwd(qs, ks, vs, *args, heads=heads)
        delta = (dos.float() * out.float()).sum(-1)
        return (out, lse, fa.flash_dq(qs, ks, vs, dos, lse, delta, *args, heads=heads),
                *fa.flash_dkv(qs, ks, vs, dos, lse, delta, *args, heads=heads))

    full = calls(None, slice(None))
    assert all(torch.equal(a, b) for a, b in zip(full, calls((H, H, 0), slice(None))))
    # the outputs each kernel writes: K4 out and lse, K5 dq, K6 dk and dv
    kernels = ("flash_train_fwd",) * 2 + ("flash_train_dq",) + ("flash_train_dkv",) * 2
    same = {name: fa.flash_train_info(name, d, dv, torch.float32, B * H, Nq, Nk)["split"]
            == fa.flash_train_info(name, d, dv, torch.float32, B * share, Nq, Nk)["split"]
            for name in set(kernels)}
    for h0 in (0, share):
        got = calls((share, H, h0), slice(h0, h0 + share))
        for name, a, b in zip(kernels, got, (t[:, h0:h0 + share] for t in full)):
            if same[name]:
                assert torch.equal(a, b), name
            elif a.dtype == dtype:
                assert_close(a, b, dtype)
            else:  # lse, f32 at either dtype
                torch.testing.assert_close(a, b, rtol=0, atol=2e-5 * b.abs().max().item())


@pytest.mark.parametrize("rate", [0.0, 0.1, 0.5])
@pytest.mark.parametrize("BH,Nq,Nk,d,dv", TRAIN_SHAPES)
def test_dropout_mask_kernel_bits(cuda, rate, BH, Nq, Nk, d, dv):
    """K7 on the card equals the plain hash bit for bit."""
    nq_pad, nk_pad = fa.train_shapes(Nq, Nk, 256, 512)
    for seed in (0, 777, 2**31 - 2):
        out = fa.dropout_keep_mask_kernel(seed, BH, Nq, Nk, rate, nq_pad, nk_pad, cuda)
        bh = torch.arange(BH, device=cuda)[:, None, None]
        row = torch.arange(Nq, device=cuda)[None, :, None]
        col = torch.arange(Nk, device=cuda)[None, None, :]
        ref = fa.dropout_keep_mask(seed, bh, row, col, rate, nq_pad, nk_pad)
        assert torch.equal(out, ref)
        # a call over heads 4..8 of 8 hashes the global batch·heads
        share = fa.dropout_keep_mask_kernel(seed, BH // 2, Nq, Nk, rate, nq_pad, nk_pad, cuda,
                                            heads=(4, 8, 4))
        assert torch.equal(share, ref.reshape(BH // 8, 8, Nq, Nk)[:, 4:].reshape(BH // 2, Nq, Nk))


# (video shape, tile_p): the stem kernels tile 8x8 pool outputs (A, B, B16) and
# 128 pixels (D) a block; 16x24 pools are two row tiles (tile 0's masked padding
# row and the next tile's real first row), 12x10 ragged tiles at every edge
STEM_SHAPES = [((2, 64, 96, 3), 8), ((1, 48, 40, 3), 4)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,tile_p", STEM_SHAPES)
@pytest.mark.parametrize("kernel", ["stem_a", "stem_b", "stem_b16", "stem_d"])
def test_stem_variants(cuda, np_rng, dtype, shape, tile_p, kernel):
    (x,) = on(cuda, dtype, np_rng.normal(size=shape))
    w7, bias = on(cuda, torch.float32, np_rng.normal(size=(7, 7, 3, 64)) * 0.1,
                  np_rng.normal(size=(64,)) * 0.1)
    wrapper, plain, args = bench_stem.kernel_cases(x, w7, bias)[kernel]
    before = _kernels.launch_counts[kernel]
    out = wrapper(*args, tile_p=tile_p)
    torch.cuda.synchronize()
    assert _kernels.launch_counts[kernel] == before + 1
    channels = 256 if kernel == "stem_d" else 64
    assert out.shape == (shape[0], shape[1] // 4, shape[2] // 4, channels)
    assert_close(out, plain(*args), dtype)


@pytest.mark.parametrize("kernel", ["stem_a", "stem_b", "stem_b16", "stem_d"])
def test_stem_variants_refuse_unwritten_rows(cuda, np_rng, kernel):
    (x,) = on(cuda, torch.float32, np_rng.normal(size=(1, 64, 96, 3)))
    w7, bias = on(cuda, torch.float32, np_rng.normal(size=(7, 7, 3, 64)), np.zeros(64))
    wrapper, _, args = bench_stem.kernel_cases(x, w7, bias)[kernel]
    before = _kernels.launch_counts[kernel]
    with pytest.raises(ValueError, match="not a multiple of tile_p"):
        wrapper(*args, tile_p=5)  # Hp = 16
    assert _kernels.launch_counts[kernel] == before


def test_small_flagship_kernels_vs_plain(cuda, np_rng, monkeypatch):
    """A narrow flagship at 64x96 with every kernel gate open (flash lowered
    to this size's 6 tokens) equals the same model with every gate shut."""
    args = SpatioTemporalDETRArgs(
        num_classes=4, hidden_dim=64, enc_nheads=2, nheads=2, enc_layers=2, dec_layers=2,
        dim_feedforward=96, num_queries=8, dropout=0.0,
    )
    model = build_flagship(args, device=cuda)
    # the init's zero bbox-delta layer would make boxes independent of the image
    last, gen = model._model.detector.bbox_embed.layers[-1], torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in (last.weight, last.bias, model._model.detector.class_embed.bias):
            p.copy_(torch.randn(p.shape, generator=gen) * 0.5)
    infer = make_inference_fn(model, device=cuda)
    batch = {"video": np_rng.normal(size=(2, 3, 64, 96, 3)).astype(np.float32)}
    for key, width in {"translation": 3, "acceleration": 3, "rotation": 4,
                       "rotation_rate": 3, "speed": 1}.items():
        batch[key] = np_rng.normal(size=(2, 3, width)).astype(np.float32)
    monkeypatch.setenv("FUTURE_OD_DISABLE_FLASH", "1")
    plain = infer(batch)
    monkeypatch.delenv("FUTURE_OD_DISABLE_FLASH")
    for name, value in {"FUTURE_OD_FLASH_MIN_KEYS": "1", "FUTURE_OD_FLASH_MIN_QUERIES": "1",
                        "FUTURE_OD_FUSED_RESNET": "1", "FUTURE_OD_FUSED_STEM": "1"}.items():
        monkeypatch.setenv(name, value)
    _kernels.reset_launch_counts()
    fused = infer(batch)
    torch.cuda.synchronize()
    # D=64 over 2 heads: head dim 32 (encoder) and 64/32 (conditional heads)
    assert _kernels.launch_counts == {
        **{name: 0 for name in _kernels.launch_counts},
        "flash_attention": 2 + 2 * 2, "fused_bottleneck": 6, "fused_stem": 1,
    }
    for key, tol in (("class_scores", 1e-4), ("boxes", 1e-2)):  # boxes in pixels
        assert (fused[key] - plain[key]).abs().max().item() <= tol


def test_narrow_flagship_heads_of_16(cuda, np_rng, monkeypatch):
    """4 heads of 16 (hidden 64, as runs/nuim_single_frame.py --debug) at
    1024 tokens a frame (1024x1024), the default gates: the encoder's
    self-attentions launch K1 at d 16, where the card raised before head
    dims entered the gate, and the output equals the all-plain forward."""
    args = SpatioTemporalDETRArgs(
        num_classes=4, hidden_dim=64, enc_nheads=4, nheads=4, enc_layers=2, dec_layers=2,
        dim_feedforward=128, num_queries=16, dropout=0.0,
    )
    model = build_flagship(args, device=cuda)
    last, gen = model._model.detector.bbox_embed.layers[-1], torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in (last.weight, last.bias, model._model.detector.class_embed.bias):
            p.copy_(torch.randn(p.shape, generator=gen) * 0.5)
    infer = make_inference_fn(model, device=cuda)
    batch = {"video": np_rng.normal(size=(1, 3, 1024, 1024, 3)).astype(np.float32)}
    for key, width in {"translation": 3, "acceleration": 3, "rotation": 4,
                       "rotation_rate": 3, "speed": 1}.items():
        batch[key] = np_rng.normal(size=(1, 3, width)).astype(np.float32)
    for name in ("FUTURE_OD_DISABLE_FLASH", "FUTURE_OD_FLASH_MIN_KEYS",
                 "FUTURE_OD_FLASH_MIN_QUERIES", "FUTURE_OD_FUSED_RESNET"):
        monkeypatch.delenv(name, raising=False)
    _kernels.reset_launch_counts()
    out = infer(batch)
    torch.cuda.synchronize()
    # one launch per encoder layer over both past frames; the decoder's 16
    # queries stay plain
    assert _kernels.launch_counts["flash_attention"] == 2
    monkeypatch.setenv("FUTURE_OD_DISABLE_FLASH", "1")
    plain = infer(batch)
    for key, tol in (("class_scores", 1e-4), ("boxes", 1e-2)):  # boxes in pixels
        assert (out[key] - plain[key]).abs().max().item() <= tol


def op_cases(device, dtype, gen):
    """(op name, its arguments, its plain version's output) for K1-K3 at
    small shapes, the packed weights as the model's wrappers pass them."""
    from future_od_tpu_torch.ops import fused_resnet as fr

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(device)

    q, k, v = randn(2, 2, 300, 32), randn(2, 2, 1100, 32), randn(2, 2, 1100, 32)
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    x = randn(1, 16, 24, 64).abs().to(dtype)
    w = dict(w1=randn(64, 64, scale=0.125), b1=randn(64, scale=0.1),
             w2=randn(3, 3, 64, 64, scale=0.04), b2=randn(64, scale=0.1),
             w3=randn(64, 256, scale=0.125), b3=randn(256, scale=0.1),
             wd=randn(64, 256, scale=0.125), bd=randn(256, scale=0.1))
    xs = randn(2, 32, 48, 12).to(dtype)
    stem = fr.pack_stem(dtype, randn(4, 4, 12, 64, scale=0.1), randn(64, scale=0.1))
    return [
        ("flash_attention", (q, k, v, 0.2), reference_attention(q, k, v, 0.2)),
        ("fused_bottleneck", (x, *fr.pack_bottleneck(dtype, **w)), bottleneck_plain(x, **w)),
        ("fused_stem", (xs, stem.w4, stem.bias, stem.frag), stem_plain(xs, stem.w4, stem.bias)),
    ]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ops_launch_their_kernels(cuda, dtype):
    """Each op's CUDA implementation, called as the exported graph calls it,
    launches its kernel once and equals the plain version."""
    for name, args, plain in op_cases(cuda, dtype, torch.Generator().manual_seed(3)):
        before = _kernels.launch_counts[name]
        out = getattr(torch.ops.fod, name)(*args)
        torch.cuda.synchronize()
        assert _kernels.launch_counts[name] == before + 1
        assert out.shape == plain.shape and out.dtype == plain.dtype
        assert_close(out, plain, dtype)


def test_loaded_artifact_launches_the_kernels(cuda, np_rng, monkeypatch, tmp_path):
    """A batch program exported on the CPU with every kernel gate open,
    loaded onto the card (`load_serving` moves it): K1, K2 and K3 launch as
    the eager forward on the card launches them, and the outputs agree."""
    from future_od_tpu_torch.serve import export_inference, load_serving

    args = SpatioTemporalDETRArgs(
        num_classes=4, hidden_dim=64, enc_nheads=2, nheads=2, enc_layers=2, dec_layers=2,
        dim_feedforward=96, num_queries=8, dropout=0.0,
    )
    model = build_flagship(args, device="cpu")
    batch = {"video": np_rng.normal(size=(2, 3, 64, 96, 3)).astype(np.float32),
             "annotated_frame_idx": np.full((2,), 2)}
    for key, width in {"translation": 3, "acceleration": 3, "rotation": 4,
                       "rotation_rate": 3, "speed": 1}.items():
        batch[key] = np_rng.normal(size=(2, 3, width)).astype(np.float32)
    for name, value in {"FUTURE_OD_FLASH_MIN_KEYS": "1", "FUTURE_OD_FLASH_MIN_QUERIES": "1",
                        "FUTURE_OD_FUSED_RESNET": "1", "FUTURE_OD_FUSED_STEM": "1"}.items():
        monkeypatch.setenv(name, value)
    program = load_serving(export_inference(model, batch, path=str(tmp_path / "p.pt2")),
                           device=cuda)
    want = {"flash_attention": 2 + 2 * 2, "fused_bottleneck": 6, "fused_stem": 1}
    _kernels.reset_launch_counts()
    with torch.inference_mode():
        got = program({k: torch.as_tensor(v, device=cuda) for k, v in batch.items()})
    torch.cuda.synchronize()
    assert {k: _kernels.launch_counts[k] for k in want} == want
    _kernels.reset_launch_counts()
    eager = make_inference_fn(model.to(cuda), device=cuda)(batch)
    assert {k: _kernels.launch_counts[k] for k in want} == want
    for key, tol in (("class_scores", 1e-4), ("boxes", 1e-2)):  # boxes in pixels
        assert (got[key] - eager[key]).abs().max().item() <= tol


def test_kernels_launch_on_their_operands_card(np_rng):
    """The device guard: with cuda:0 current, K1-K6 (and K7 inside K4-K6)
    on operands of cuda:1 launch there, on cuda:1's stream, and equal their
    plain versions. Needs two cards; skips with one."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices: the guard matters only off the current card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 1)
    before = dict(_kernels.launch_counts)
    q, k, v = on(dev, torch.float32, np_rng.normal(size=(1, 2, 1024, 32)),
                 np_rng.normal(size=(1, 2, 1024, 32)), np_rng.normal(size=(1, 2, 1024, 32)))
    assert_close(flash_attention(q, k, v, 0.2), reference_attention(q, k, v, 0.2), torch.float32)
    (x,) = on(dev, torch.float32, np.abs(np_rng.normal(size=(1, 8, 20, 64))))
    w = bottleneck_weights(dev, torch.float32, np_rng, 64, 64, 256, True)
    assert_close(fused_bottleneck(x, **w), bottleneck_plain(x, **w), torch.float32)
    xs = space_to_depth(torch.from_numpy(np_rng.normal(size=(1, 64, 96, 3)).astype(np.float32)))
    w4 = stem_weights_to_space_to_depth(torch.from_numpy(
        (np_rng.normal(size=(7, 7, 3, 64)) * 0.1).astype(np.float32)))
    xs, w4 = xs.to(dev), w4.to(dev)
    (bias,) = on(dev, torch.float32, np_rng.normal(size=(64,)) * 0.1)
    assert_close(fused_stem(xs, w4, bias), stem_plain(xs, w4, bias), torch.float32)
    q, k, v, do = on(dev, torch.float32, *(np_rng.normal(size=(16, 300, 32)) for _ in range(4)))
    args = (777, 1.0 / math.sqrt(32), 0.1, *fa.train_shapes(300, 300, 256, 512))
    ref_out, ref_lse = fa.flash_train_fwd_plain(q, k, v, *args)
    delta = (do.float() * ref_out.float()).sum(-1)
    out, _ = fa.flash_train_fwd(q, k, v, *args)
    assert_close(out, ref_out, torch.float32)
    assert_close(fa.flash_dq(q, k, v, do, ref_lse, delta, *args),
                 fa.flash_dq_plain(q, k, v, do, ref_lse, delta, *args), torch.float32)
    dk, dv = fa.flash_dkv(q, k, v, do, ref_lse, delta, *args)
    ref_dk, ref_dv = fa.flash_dkv_plain(q, k, v, do, ref_lse, delta, *args)
    assert_close(dk, ref_dk, torch.float32)
    assert_close(dv, ref_dv, torch.float32)
    torch.cuda.synchronize(dev)
    assert torch.cuda.current_device() == 0
    for name in ("flash_attention", "fused_bottleneck", "fused_stem", "flash_train_fwd",
                 "flash_train_dq", "flash_train_dkv"):
        assert _kernels.launch_counts[name] == before[name] + 1, name


# (B, H, W, Cin, KH, KW, Cout, stride, ((top, bottom), (left, right)), dilation,
# pad value): the trunk's kinds at odd sizes (a ragged last block of pixels),
# both stems, a dilated 3x3, asymmetric padding; the TMA kernel (stride-1 1x1s)
# with tiles of 64 and 128 channels, several K stages, K padded past Cin (48),
# and Cout = 192 (tiles of 64 channels on both kernels)
INT8_SHAPES = [
    (2, 17, 23, 64, 1, 1, 64, 1, ((0, 0), (0, 0)), 1, -128),
    (2, 20, 30, 512, 1, 1, 256, 1, ((0, 0), (0, 0)), 1, -128),
    (1, 9, 31, 48, 1, 1, 192, 1, ((0, 0), (0, 0)), 1, -128),
    (1, 11, 13, 64, 3, 3, 192, 1, ((1, 1), (1, 1)), 1, -128),
    (2, 17, 23, 64, 3, 3, 128, 1, ((1, 1), (1, 1)), 1, -128),
    (1, 30, 41, 128, 3, 3, 128, 2, ((1, 1), (1, 1)), 1, -128),
    (1, 13, 11, 512, 3, 3, 512, 1, ((2, 2), (2, 2)), 2, -128),
    (1, 14, 15, 256, 1, 1, 1024, 2, ((0, 0), (0, 0)), 1, -128),
    (2, 64, 96, 3, 7, 7, 64, 2, ((3, 3), (3, 3)), 1, 0),
    (2, 32, 48, 12, 4, 4, 64, 1, ((2, 1), (2, 1)), 1, 0),
    (1, 9, 10, 32, 3, 3, 64, 2, ((0, 2), (1, 0)), 1, 5),
]


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", INT8_SHAPES)
def test_int8_conv(cuda, dtype, relu, shape):
    """K8 equals its plain version bit for bit: exact int32 sums, the
    epilogue rounded as the plain version rounds it; zero points and bias
    present on the block convs, absent on the stems."""
    from future_od_tpu_torch.ops import int8_conv as k8

    B, H, W, C, KH, KW, Co, s, p, d, pad = shape
    g = torch.Generator(device=cuda).manual_seed(sum(shape[:7]))
    q = torch.randint(-128, 128, (B, H, W, C), dtype=torch.int8, device=cuda, generator=g)
    wq = torch.randint(-127, 128, (KH, KW, C, Co), dtype=torch.int8, device=cuda, generator=g)
    w = k8.pack_int8_weights(wq)
    block = pad == -128
    zp = k8.zero_point_correction(wq) if block else None
    sw = torch.rand(Co, device=cuda, generator=g) * 1e-4
    bias = torch.randn(Co, device=cuda, generator=g) if block else None
    before = _kernels.launch_counts["int8_conv"]
    out = k8.int8_conv_codes(q, w, zp, sw, bias, (s, s), p, (d, d), pad, relu, dtype)
    torch.cuda.synchronize()
    assert _kernels.launch_counts["int8_conv"] == before + 1
    ref = k8.int8_conv_plain(q, w.wt, zp, sw, bias, (KH, KW), (s, s), p, (d, d), pad, relu, dtype)
    assert out.dtype == dtype and torch.equal(out, ref)


def test_int8_conv_refuses(cuda):
    from future_od_tpu_torch.ops import int8_conv as k8

    q = torch.zeros((1, 8, 8, 64), dtype=torch.int8, device=cuda)
    w = k8.pack_int8_weights(torch.ones((1, 1, 64, 96), dtype=torch.int8, device=cuda))
    sw = torch.ones(96, device=cuda)
    with pytest.raises(ValueError, match="multiple of 64"):
        k8.int8_conv_codes(q, w, None, sw, None, (1, 1), ((0, 0), (0, 0)), (1, 1), 0, False,
                           torch.float32)
    w = k8.pack_int8_weights(torch.ones((1, 1, 64, 64), dtype=torch.int8, device=cuda))
    misaligned = torch.zeros(4097, dtype=torch.int8, device=cuda)[1:].view(1, 8, 8, 64)
    with pytest.raises(ValueError, match="aligned"):
        k8.int8_conv_codes(misaligned, w, None, sw[:64], None, (1, 1), ((0, 0), (0, 0)), (1, 1),
                           0, False, torch.float32)


@pytest.mark.parametrize("zero_point", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(3, 5, 7, 3), (2, 9, 11, 64), (1, 1, 1, 5), (5, 3, 2, 2048),
                                   (4, 7, 13, 12), (2, 3, 3, 1), (1, 37, 41, 48), (1, 3, 3, 16)])
def test_int8_quantize(cuda, dtype, zero_point, shape):
    """K9 equals its plain version bit for bit: the range of |x| and of x (odd
    C, element counts that leave a partial 16 bytes, channels past 16-byte
    lanes), and the codes of x / m / scale with planted exact ties and values
    past the clamp limits, with m and without."""
    from future_od_tpu_torch.ops import int8_quantize as k9

    g = torch.Generator(device=cuda).manual_seed(sum(shape))
    C = shape[-1]
    x = torch.randn(shape, device=cuda, generator=g)
    if zero_point:
        x = torch.relu(x)
    m = torch.rand(C, device=cuda, generator=g) + 0.5
    scale = (x.abs().amax() / m.min() / (255.0 if zero_point else 127.0)).reshape(())
    flat = x.view(-1)
    ties = torch.arange(flat.numel(), device=cuda) % 3 == 0  # t + 0.5 after both divisions
    mc = m.repeat(flat.numel() // C)
    t = torch.randint(-300, 300, (flat.numel(),), device=cuda, generator=g).float() + 0.5
    if zero_point:
        t = t.abs()
    flat[ties] = (t * scale * mc)[ties]
    x = x.to(dtype)
    before = {n: _kernels.launch_counts[n] for n in (k9.RANGE, k9.QUANTIZE)}
    for absolute in (True, False):
        assert torch.equal(k9.channel_range(x, absolute), k9.channel_range_plain(x, absolute))
    for mm in (m, None):
        q = k9.quantize_codes(x, mm, scale, zero_point)
        torch.cuda.synchronize()
        assert q.dtype == torch.int8
        assert torch.equal(q, k9.quantize_codes_plain(x, mm, scale, zero_point))
    assert _kernels.launch_counts[k9.RANGE] == before[k9.RANGE] + 2
    assert _kernels.launch_counts[k9.QUANTIZE] == before[k9.QUANTIZE] + 2


def test_int8_quantize_refuses(cuda):
    from future_od_tpu_torch.ops import int8_quantize as k9

    x = torch.rand((2, 4, 4, 8), device=cuda)
    m, scale = torch.ones(8, device=cuda), torch.tensor(0.1, device=cuda)
    with pytest.raises(ValueError, match="f32 or bf16"):
        k9.channel_range(x.to(torch.float16))
    with pytest.raises(ValueError, match="channels"):
        k9.channel_range(torch.zeros((1, k9.MAX_CHANNELS + 1), device=cuda))
    with pytest.raises(ValueError, match="m must be"):
        k9.quantize_codes(x, m[:4], scale, True)
    with pytest.raises(ValueError, match="scale must be"):
        k9.quantize_codes(x, m, scale.double(), True)
    with pytest.raises(ValueError, match="CUDA"):
        k9.quantize_codes(x, m.cpu(), scale, True)
    with pytest.raises(ValueError, match="aligned"):
        k9.channel_range(torch.rand(257, device=cuda)[1:].view(2, 4, 4, 8))


@pytest.mark.parametrize("static", [False, True])
def test_int8_flagship_trunk_equals_plain(cuda, np_rng, monkeypatch, static):
    """A narrow int8 flagship at 64x96: K8 launches 53 times a forward (the
    trunk's convolutions), K9 a quantization each and, on the dynamic path,
    49 range passes (a block's conv1 and downsample share one); the trunk's
    output equals the same forward's with K8's and K9's plain versions in
    their places, bit for bit; static after its calibration equals dynamic."""
    from future_od_tpu_torch.ops import int8_conv as k8
    from future_od_tpu_torch.ops import int8_quantize as k9
    from future_od_tpu_torch.ops import quant
    from future_od_tpu_torch.train.step import calibrate_int8

    args = SpatioTemporalDETRArgs(num_classes=4, hidden_dim=64, enc_nheads=2, nheads=2,
                                  enc_layers=1, dec_layers=1, dim_feedforward=96,
                                  num_queries=8, dropout=0.0, int8_backbone=True,
                                  int8_static=static)
    model = build_flagship(args, device=cuda)
    batch = {"video": np_rng.normal(size=(2, 3, 64, 96, 3)).astype(np.float32)}
    for key, width in {"translation": 3, "acceleration": 3, "rotation": 4,
                       "rotation_rate": 3, "speed": 1}.items():
        batch[key] = np_rng.normal(size=(2, 3, width)).astype(np.float32)
    if static:
        calibrate_int8(model, [batch], device=cuda)
    trunk = []
    model._model.separate_encoder.backbone.body.register_forward_hook(
        lambda m, a, out: trunk.append(out.clone()))
    infer = make_inference_fn(model, device=cuda)
    _kernels.reset_launch_counts()
    infer(batch)
    torch.cuda.synchronize()
    assert _kernels.launch_counts["int8_conv"] == 53
    assert _kernels.launch_counts[k9.QUANTIZE] == 53
    assert _kernels.launch_counts[k9.RANGE] == (0 if static else 49)

    def plain(q, w, zp, sw, bias, strides, padding, dilation, pad_value, relu, out_dtype):
        return k8.int8_conv_plain(q, w.wt, zp, sw, bias, w.kernel_hw, strides, padding,
                                  dilation, pad_value, relu, out_dtype)

    monkeypatch.setattr(quant, "int8_conv_codes", plain)
    monkeypatch.setattr(quant, "channel_range", k9.channel_range_plain)
    monkeypatch.setattr(quant, "quantize_codes", k9.quantize_codes_plain)
    _kernels.reset_launch_counts()
    infer(batch)
    assert not any(_kernels.launch_counts[n] for n in ("int8_conv", k9.RANGE, k9.QUANTIZE))
    assert torch.equal(trunk[0], trunk[1])


def drift_base_trunk_convs():
    """Every distinct convolution of the single-frame trunk on the drift_base
    path (quant_ap_check: 16 images at 128x192): (B, H, W, Cin, KH, KW,
    Cout, stride, padding, dilation, pad value), in trunk order."""
    from future_od_tpu_torch.models.resnet import ResNet

    with torch.device("meta"):
        body = ResNet()
    B, h, w = 16, 128 // 4, 192 // 4
    convs = [(B, 128, 192, 3, 7, 7, 64, 2, ((3, 3), (3, 3)), 1, 0)]
    for s in range(1, body.num_stages + 1):
        for blk in getattr(body, f"layer{s}"):
            d, st = blk.dilation, blk.stride
            h2, w2 = (h - 1) // st + 1, (w - 1) // st + 1
            for conv, hh, ww, stride, pad, dil in (
                    (blk.conv1, h, w, 1, ((0, 0), (0, 0)), 1),
                    (blk.conv2, h, w, st, ((d, d), (d, d)), d),
                    (blk.conv3, h2, w2, 1, ((0, 0), (0, 0)), 1),
                    (blk.downsample[0] if blk.downsample is not None else None, h, w, st,
                     ((0, 0), (0, 0)), 1)):
                if conv is not None:
                    convs.append((B, hh, ww, conv.in_channels, *conv.kernel_size,
                                  conv.out_channels, stride, pad, dil, -128))
            h, w = h2, w2
    return list(dict.fromkeys(convs))


DRIFT_BASE_CONVS = drift_base_trunk_convs()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", DRIFT_BASE_CONVS, ids=str)
def test_int8_conv_drift_base_shapes(cuda, dtype, shape):
    """K8 at every distinct convolution of the 128x192 batch-16 trunk, bit
    for bit: the TMA 1x1s of layer4 with far fewer tiles than SMs (4x6 maps,
    384 pixels), the gathered 3x3s whose padding covers most of a 4x6
    window, the stem on 16x128x192x3."""
    from future_od_tpu_torch.ops import int8_conv as k8

    B, H, W, C, KH, KW, Co, s, p, d, pad = shape
    g = torch.Generator(device=cuda).manual_seed(B * H * W + C * Co + KH)
    q = torch.randint(-128, 128, (B, H, W, C), dtype=torch.int8, device=cuda, generator=g)
    wq = torch.randint(-127, 128, (KH, KW, C, Co), dtype=torch.int8, device=cuda, generator=g)
    w = k8.pack_int8_weights(wq)
    block = pad == -128
    zp = k8.zero_point_correction(wq) if block else None
    sw = torch.rand(Co, device=cuda, generator=g) * 1e-4
    bias = torch.randn(Co, device=cuda, generator=g)
    out = k8.int8_conv_codes(q, w, zp, sw, bias, (s, s), p, (d, d), pad, block, dtype)
    ref = k8.int8_conv_plain(q, w.wt, zp, sw, bias, (KH, KW), (s, s), p, (d, d), pad, block,
                             dtype)
    assert torch.equal(out, ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", sorted({(c[0], c[1], c[2], c[3], c[10] == -128)
                                          for c in DRIFT_BASE_CONVS}), ids=str)
def test_int8_quantize_drift_base_ranges(cuda, dtype, shape):
    """K9 at every distinct convolution input of the same trunk, at the
    ranges of the JAX package's trained drift_base checkpoint (activations
    up to about 1e15, channels 10-60x apart): the range (of |x| and of x)
    and the codes, with the dynamic path's m and scale, bit-equal to their
    plain versions."""
    from future_od_tpu_torch.ops import int8_quantize as k9

    B, H, W, C, zero_point = shape
    g = torch.Generator(device=cuda).manual_seed(B * H * W + C)
    spread = torch.where(torch.rand(C, device=cuda, generator=g) < 0.05,
                         10.0 + 50.0 * torch.rand(C, device=cuda, generator=g),
                         torch.rand(C, device=cuda, generator=g) + 0.1)
    x = torch.randn((B, H, W, C), device=cuda, generator=g) * spread
    if zero_point:
        x = torch.relu(x)
    x = (x * (1e15 / x.abs().amax())).to(dtype)  # the largest |x| at 1e15
    for absolute in (True, False):
        assert torch.equal(k9.channel_range(x, absolute), k9.channel_range_plain(x, absolute))
    amax = k9.channel_range(x)
    assert 0.99e15 < amax.max().item() < 1.01e15
    m = torch.sqrt(amax.clamp_min(1e-5))  # a smoothing factor a channel, as the path's
    scale = ((amax / m).max() / (255.0 if zero_point else 127.0)).reshape(())
    for mm in (m, None):
        sc = scale if mm is not None else (amax.max() / (255.0 if zero_point else 127.0)).reshape(())
        assert torch.equal(k9.quantize_codes(x, mm, sc, zero_point),
                           k9.quantize_codes_plain(x, mm, sc, zero_point))
