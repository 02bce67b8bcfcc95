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
