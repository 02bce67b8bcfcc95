"""The rounding of the tensor-core training flash kernels K4, K5 and K6
(csrc/flash_attention_train.cu), emulated on the CPU and held to the
tolerances their check on the card uses (chip_smoke.py phase 1b).

The kernels cannot run here, but what they round can: this file emulates
them in torch, pass by pass as a warp walks the keys, and `mma.sync` by
`mma.sync`. Where a grid of 64-row blocks would not fill the card (the
decoder's 128 queries, and this file's shapes) the kernels split each
64-key tile between the 4 warps of a 16-row slab (`split_for`); the
emulation takes the split as a parameter: each part walks its keys of
every tile in passes of 32 keys (16 at split 4), then the block merges the
parts into part 0 in order, (max, sum, out) rescaled by exp for K4 and dq
summed for K5. Its rounding:

- the logits on the CUDA cores, each the sequential chain fmaf over c of
  (q[c]·scale)·k[c] in f32 (bit-equal to K6's; emulated as an exact f64 sum
  of the f32 accumulator and the exact product, rounded to f32);
- K4: the online softmax a pass (max, exp, the row sum before dropout), the
  dropout mask, then P·v on the tensor cores into a fresh accumulator a
  pass, added to the running output in f32;
- K5: dS = do·vᵀ on the tensor cores (a fresh accumulator every 32 columns),
  dlogits = p ⊙ (dS ⊙ mask - δ) in f32, then dlogits·k into a fresh
  accumulator a pass, added to dq in f32, times the scale at the end;
- f32 storage: 3xTF32 products (tf32 big/small splits, k-steps of 8); bf16:
  the stored operands (k-steps of 16) with P and dlogits as a hi + lo pair
  of bf16.

Each `mma.sync` is modelled as its accumulator plus its exact products,
rounded toward zero to f32 (the tensor cores' f32 sums truncate); the model
is the pessimistic one of tests/test_torch_flash_tc_rounding.py.

At BH 2, Nq 40, Nk 100 (a ragged last pass), d 32 and 64, dv 32, both
dtypes, dropout 0 and 0.1 and splits 1 and 4, each emulation must lie
within phase 1b's tolerances of the plain versions
(`flash_train_fwd_plain`, `flash_dq_plain`), and the chained forward and
dq at the kernel's own split (4) within them of the JAX package's Pallas
kernels in interpret mode. The worst ratios (error over tolerance) this
file measures, split 1; split 4: out 0.031; 0.028 (f32) and 0.568; 0.568
(bf16), dq 0.037; 0.035 and 0.356; 0.356 against the plain versions; out
0.023 and 0.568, dq 0.039 and 0.330 against the JAX kernels at split 4. A
negative control: one TF32 product (no split of the operands) puts out and
dq at 15 and 18 times the f32 tolerance at either split.

K6 (`emulate_dkv`) is K5 mirrored: keys are the rows, the logits the same
chain in the transposed layout (bit-equal to `chained_logits`), dSᵀ = v·doᵀ
with a fresh accumulator every 32 columns, then dv += (p ⊙ mask)ᵀ·do and dk
+= dlogitsᵀ·q a pass of queries into fresh accumulators, the split's parts
summed in order; f32 takes q·scale rounded to f32 as dk's operand (the
kernel scales its q tile in place), bf16 q as stored and the scale at the
end. K6 splits a slab's queries by `split_for` over its keys: split 4 at
this file's shapes. Worst ratios, split 1 and 4 alike within 0.01: dk 0.072
and dv 0.027 (f32), dk 0.350 and dv 0.492 (bf16) against `flash_dkv_plain`;
dk 0.035, dv 0.029 (f32) and 0.373, 0.492 (bf16) against the JAX kernels at
split 4. One TF32 product puts dk and dv at 22 and 30 times the f32
tolerance.

About 13 s of tests, 20 s with the imports, alone on one torch thread
(`one_torch_thread`; `JAX_PLATFORMS=cpu python -m pytest
tests/test_torch_flash_train_tc_rounding.py -q`).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from future_od_tpu.ops.flash_attention import flash_attention_train as jax_flash_attention_train

from future_od_tpu_torch.ops import flash_attention as fa
from test_torch_flash_tc_rounding import (  # noqa: F401 (one_torch_thread: autouse)
    mma_chain,
    one_torch_thread,
    parts_1xtf32,
    parts_3xtf32,
    parts_as_stored,
    parts_hi_lo,
    tolerance_ratio,
)

TILE_K, WARPS = 64, 4  # keys a staged tile; warps a block
PASS_N = 4  # n-tiles of 8 keys a warp takes a pass at most (32 keys)
COLUMNS = 32  # columns of dS's reduction a fresh accumulator
SMS = 132  # an H100 SXM's SMs, which `split_for` reads from the card
K_STEP = {torch.float32: 8, torch.bfloat16: 16}
# (the A·B parts of a product whose A is an f32 intermediate, of dS = do·vᵀ)
DESIGNS = {torch.float32: (parts_3xtf32, parts_3xtf32),
           torch.bfloat16: (parts_hi_lo, parts_as_stored)}
SEED = 777


def chained_logits(q, k, scale: float) -> torch.Tensor:
    """(q·scale)·kᵀ as every kernel rounds it: acc = fmaf(q[c]·scale, k[c],
    acc) for c in order, in f32."""
    qs = q.float() * scale
    kf = k.float()
    acc = torch.zeros((*q.shape[:-1], k.shape[-2]))
    for c in range(q.shape[-1]):
        acc = (qs[..., c, None].double() * kf[..., None, :, c].double() + acc.double()).float()
    return acc


def kernel_split(nq: int, bh: int, sms: int = SMS) -> int:
    """csrc/flash_attention_train.cu's `split_for`: the warps that share a
    16-row slab, the fewest that give at least two blocks an SM."""
    split = 1
    while split < WARPS and -(-nq // (16 * (WARPS // split))) * bh < 2 * sms:
        split *= 2
    return split


def key_passes(nk: int, split: int):
    """For each of a slab's `split` warps, its passes as (first key, end):
    part p takes n-tiles [p nt, (p + 1) nt) of every staged tile, nt = 8 /
    split, in passes of min(nt, 4) n-tiles (32 keys; 16 at split 4); keys
    past nk are masked, so a pass ends at nk and an empty one adds nothing."""
    nt = TILE_K // 8 // split
    step = min(nt, PASS_N)
    return [[(k0, min(k0 + 8 * step, nk))
             for tile0 in range(0, nk, TILE_K)
             for k0 in range(tile0 + 8 * part * nt, tile0 + 8 * (part + 1) * nt, 8 * step)
             if k0 < nk]
            for part in range(split)]


def emulate_fwd(q, k, v, scale, rate, nq_pad, nk_pad, pv_parts=None, split=1):
    """K4's (out, lse) with its rounding. q, k (BH, N, d), v (BH, Nk, dv).
    Each of the `split` warps of a slab keeps its own (max, sum, out) over
    its passes; the block then merges parts 1.. into part 0 in order."""
    dtype = q.dtype
    pv_parts = pv_parts or DESIGNS[dtype][0]
    logits = chained_logits(q, k, scale)
    mask = fa._mask_like(SEED, logits, rate, nq_pad, nk_pad) if rate > 0 else None
    parts = []
    for passes in key_passes(k.shape[-2], split):
        row_max = torch.full((*q.shape[:-1], 1), -math.inf)
        row_sum = torch.zeros_like(row_max)
        acc = torch.zeros((*q.shape[:-1], v.shape[-1]))
        for k0, k1 in passes:
            s = logits[..., k0:k1]
            new_max = torch.maximum(row_max, s.amax(-1, keepdim=True))
            corr = torch.exp(row_max - new_max)
            p = torch.exp(s - new_max)
            row_sum = row_sum * corr + p.sum(-1, keepdim=True)
            if mask is not None:
                p = p * mask[..., k0:k1]
            fresh = mma_chain(torch.zeros_like(acc), pv_parts(p, v[..., k0:k1, :].float()),
                              K_STEP[dtype])
            acc = acc * corr + fresh
            row_max = new_max
        parts.append((row_max, row_sum, acc))
    row_max, row_sum, acc = parts[0]  # part 0 holds key 0: its max is finite
    for m, l, o in parts[1:]:
        mx = torch.maximum(row_max, m)
        fa_, fb = torch.exp(row_max - mx), torch.where(m == -math.inf, 0.0, torch.exp(m - mx))
        row_sum, acc, row_max = row_sum * fa_ + l * fb, acc * fa_ + o * fb, mx
    return (acc / row_sum).to(dtype), (row_max + torch.log(row_sum))[..., 0]


def emulate_dq(q, k, v, do, lse, delta, scale, rate, nq_pad, nk_pad, dl_parts=None, split=1):
    """K5's dq with its rounding: each of the `split` warps of a slab sums
    its passes, and the block adds parts 1.. to part 0 in order."""
    dtype = q.dtype
    dl_parts = dl_parts or DESIGNS[dtype][0]
    logits = chained_logits(q, k, scale)
    vt = v.float().transpose(-1, -2)
    ds = torch.zeros_like(logits)
    for c0 in range(0, v.shape[-1], COLUMNS):
        cols = slice(c0, c0 + COLUMNS)
        ds = ds + mma_chain(torch.zeros_like(logits),
                            DESIGNS[dtype][1](do.float()[..., cols], vt[..., cols, :]),
                            K_STEP[dtype])
    if rate > 0:
        ds = ds * fa._mask_like(SEED, logits, rate, nq_pad, nk_pad)
    dlogits = torch.exp(logits - lse[..., None]) * (ds - delta[..., None])
    dq = None
    for passes in key_passes(k.shape[-2], split):
        part = torch.zeros(q.shape)
        for k0, k1 in passes:
            part = part + mma_chain(torch.zeros_like(part),
                                    dl_parts(dlogits[..., k0:k1], k[..., k0:k1, :].float()),
                                    K_STEP[dtype])
        dq = part if dq is None else dq + part
    return (dq * scale).to(dtype)


def chained_logits_t(k, q, scale: float) -> torch.Tensor:
    """K6's logits sᵀ, keys as rows: acc = fmaf(k[c], q[c]·scale, acc) for c
    in order, in f32 (the same bits as `chained_logits` transposed: fmaf's
    product is exact, so its two factors may swap)."""
    qs = q.float() * scale
    kf = k.float()
    acc = torch.zeros((*k.shape[:-1], q.shape[-2]))
    for c in range(k.shape[-1]):
        acc = (kf[..., c, None].double() * qs[..., None, :, c].double() + acc.double()).float()
    return acc


def emulate_dkv(q, k, v, do, lse, delta, scale, rate, nq_pad, nk_pad, parts=None, split=1):
    """K6's (dk, dv) with its rounding: K5 mirrored, keys as the rows. The
    logits in the transposed layout; dSᵀ = v·doᵀ (a fresh accumulator every
    32 columns of v); p, the mask and dlogits in f32; then each of the
    `split` warps of a 16-key slab walks its queries of every 64-query tile
    (`key_passes` over the queries: passes of 32, 16 at split 4) into fresh
    accumulators, dv += (p ⊙ mask)ᵀ·do and dk += dlogitsᵀ·q', and the block
    adds parts 1.. to part 0 in order. f32: q' is q·scale rounded to f32, as
    the kernel scales its q tile in place, and dk takes no scale at the end;
    bf16: q' is q as stored, and dk is multiplied by the scale at the end."""
    dtype = q.dtype
    parts = parts or DESIGNS[dtype][0]
    logits_t = chained_logits_t(k, q, scale)
    ds_t = torch.zeros_like(logits_t)
    dot = do.float().transpose(-1, -2)
    for c0 in range(0, v.shape[-1], COLUMNS):
        cols = slice(c0, c0 + COLUMNS)
        ds_t = ds_t + mma_chain(torch.zeros_like(logits_t),
                                DESIGNS[dtype][1](v.float()[..., cols], dot[..., cols, :]),
                                K_STEP[dtype])
    p_t = torch.exp(logits_t - lse[..., None, :])
    pd_t = p_t
    if rate > 0:
        mask_t = fa._mask_like(SEED, logits_t.transpose(-1, -2), rate, nq_pad,
                               nk_pad).transpose(-1, -2)
        pd_t, ds_t = p_t * mask_t, ds_t * mask_t
    dl_t = p_t * (ds_t - delta[..., None, :])
    f32 = dtype == torch.float32
    qb = q.float() * scale if f32 else q.float()
    dk = dv = None
    for passes in key_passes(q.shape[-2], split):
        part_k, part_v = torch.zeros(k.shape), torch.zeros(v.shape)
        for q0, q1 in passes:
            part_v = part_v + mma_chain(torch.zeros_like(part_v),
                                        parts(pd_t[..., q0:q1], do.float()[..., q0:q1, :]),
                                        K_STEP[dtype])
            part_k = part_k + mma_chain(torch.zeros_like(part_k),
                                        parts(dl_t[..., q0:q1], qb[..., q0:q1, :]), K_STEP[dtype])
        dk = part_k if dk is None else dk + part_k
        dv = part_v if dv is None else dv + part_v
    if not f32:
        dk = dk * scale
    return dk.to(dtype), dv.to(dtype)


def inputs(rng, BH, Nq, Nk, d, dv, dtype):
    arrays = (rng.normal(size=(BH, n, w)).astype(np.float32)
              for n, w in ((Nq, d), (Nk, d), (Nk, dv), (Nq, dv)))
    return [torch.from_numpy(a).to(dtype) for a in arrays]


SHAPES = [(2, 40, 100, 32, 32), (2, 40, 100, 64, 32)]


def test_kernel_split_and_key_passes():
    """The split the kernel takes at the main path's shapes and at this
    file's (BH 2, Nq 40: split 4), and every key in exactly one pass of one
    part, in passes of 32 keys (16 at split 4) that never cross a tile."""
    assert kernel_split(350, 64) == 1 and kernel_split(128, 32) == 4
    assert kernel_split(40, 2) == 4 and kernel_split(256, 64) == 2
    for nk in (17, 100, 129, 350):
        for split in (1, 2, 4):
            passes = [p for part in key_passes(nk, split) for p in part]
            keys = sorted(key for k0, k1 in passes for key in range(k0, k1))
            assert keys == list(range(nk))
            assert all(k1 - k0 <= (16 if split == 4 else 32) for k0, k1 in passes)
            assert all(k0 // TILE_K == (k1 - 1) // TILE_K for k0, k1 in passes)
    assert key_passes(100, 1) == [[(0, 32), (32, 64), (64, 96), (96, 100)]]


@pytest.mark.parametrize("split", [1, 4])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("BH,Nq,Nk,d,dv", SHAPES)
def test_emulated_k4_k5_within_phase1b_tolerance(rng, dtype, rate, split, BH, Nq, Nk, d, dv):
    """At split 1 (the encoder's walk) and split 4 (the decoder's, and the
    kernel's own at this shape): 16-key passes and the in-block merge."""
    q, k, v, do = inputs(rng, BH, Nq, Nk, d, dv, dtype)
    nq_pad, nk_pad = fa.train_shapes(Nq, Nk, 256, 512)
    args = (SEED, 1.0 / math.sqrt(d), rate, nq_pad, nk_pad)
    ref_out, ref_lse = fa.flash_train_fwd_plain(q, k, v, *args)
    out, lse = emulate_fwd(q, k, v, *args[1:], split=split)
    assert out.dtype == dtype and out.shape == ref_out.shape
    assert tolerance_ratio(out, ref_out) <= 1.0
    assert tolerance_ratio(lse, ref_lse) <= 1.0
    delta = (do.float() * ref_out.float()).sum(-1)
    dq = emulate_dq(q, k, v, do, ref_lse, delta, *args[1:], split=split)
    assert tolerance_ratio(dq, fa.flash_dq_plain(q, k, v, do, ref_lse, delta, *args)) <= 1.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_emulated_chain_matches_jax_interpret(rng, dtype):
    """K4's out and lse, then K5's dq and K6's dk and dv from them, against
    the Pallas forward and backward in interpret mode (out, and dq, dk, dv of
    the vjp), at dropout 0.1."""
    B, H, Nq, Nk, d, dv = 1, 2, 40, 100, 64, 32
    q, k, v, do = inputs(rng, B * H, Nq, Nk, d, dv, dtype)
    rate, scale = 0.1, 1.0 / math.sqrt(d)
    nq_pad, nk_pad = fa.train_shapes(Nq, Nk, 256, 512)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jq, jk, jv, jdo = (jnp.asarray(t.float().numpy().reshape(B, H, *t.shape[1:]), jdt)
                       for t in (q, k, v, do))

    def jax_fn(q_, k_, v_):
        return jax_flash_attention_train(q_, k_, v_, jnp.int32(SEED), scale, rate, 256, 512, True)

    ref, vjp = jax.vjp(jax_fn, jq, jk, jv)
    ref_dq, ref_dk, ref_dv = vjp(jdo)
    as_torch = lambda x: torch.from_numpy(np.array(x, np.float32)).reshape(B * H, *x.shape[2:]).to(dtype)  # noqa: E731
    split = kernel_split(Nq, B * H)  # 4, as the kernel splits this shape
    out, lse = emulate_fwd(q, k, v, scale, rate, nq_pad, nk_pad, split=split)
    assert tolerance_ratio(out, as_torch(ref)) <= 1.0
    delta = (do.float() * out.float()).sum(-1)
    dq = emulate_dq(q, k, v, do, lse, delta, scale, rate, nq_pad, nk_pad, split=split)
    assert tolerance_ratio(dq, as_torch(ref_dq)) <= 1.0
    # K6 at its own split at this shape (4: 100 keys over 2 batch*heads)
    dk, dv_ = emulate_dkv(q, k, v, do, lse, delta, scale, rate, nq_pad, nk_pad,
                          split=kernel_split(Nk, B * H))
    assert tolerance_ratio(dk, as_torch(ref_dk)) <= 1.0
    assert tolerance_ratio(dv_, as_torch(ref_dv)) <= 1.0


def test_chained_logits_are_the_sequential_fma():
    """The emulated chain is K6's `logit<D>`: on integer-valued inputs every
    partial sum is exact, so it equals the exact dot product."""
    g = torch.Generator().manual_seed(0)
    q = torch.randint(-8, 9, (2, 5, 32), generator=g).float()
    k = torch.randint(-8, 9, (2, 7, 32), generator=g).float()
    torch.testing.assert_close(chained_logits(q, k, 0.25), 0.25 * q @ k.transpose(1, 2),
                               rtol=0, atol=0)


@pytest.mark.parametrize("split", [1, 4])
def test_one_tf32_product_fails_the_f32_tolerance(rng, split):
    q, k, v, do = inputs(rng, 2, 40, 100, 64, 32, torch.float32)
    nq_pad, nk_pad = fa.train_shapes(40, 100, 256, 512)
    args = (SEED, 0.125, 0.0, nq_pad, nk_pad)
    ref_out, ref_lse = fa.flash_train_fwd_plain(q, k, v, *args)
    out, _ = emulate_fwd(q, k, v, *args[1:], pv_parts=parts_1xtf32, split=split)
    delta = (do * ref_out).sum(-1)
    dq = emulate_dq(q, k, v, do, ref_lse, delta, *args[1:], dl_parts=parts_1xtf32, split=split)
    assert tolerance_ratio(out, ref_out) > 1.0
    assert tolerance_ratio(dq, fa.flash_dq_plain(q, k, v, do, ref_lse, delta, *args)) > 1.0


def test_k6_split_at_the_main_path():
    """K6 takes `split_for` over its keys: the encoder (64 x 350 keys) at
    split 1, the decoder (32 batch*heads, 350 keys: 192 blocks of 64 keys on
    132 SMs) at split 2, this file's shapes (2 x 100 keys) at split 4."""
    assert kernel_split(350, 64) == 1 and kernel_split(350, 32) == 2
    assert kernel_split(100, 2) == 4


def test_transposed_logits_are_bit_equal(rng):
    """K6's chain with keys as rows gives K4's and K5's logits bit for bit."""
    q, k, _, _ = inputs(rng, 2, 40, 100, 32, 32, torch.float32)
    assert torch.equal(chained_logits_t(k, q, 1.0 / math.sqrt(32)),
                       chained_logits(q, k, 1.0 / math.sqrt(32)).transpose(-1, -2))


@pytest.mark.parametrize("split", [1, 4])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("BH,Nq,Nk,d,dv", SHAPES)
def test_emulated_k6_within_phase1b_tolerance(rng, dtype, rate, split, BH, Nq, Nk, d, dv):
    """At split 1 (the encoder's walk) and split 4 (the kernel's own at this
    shape): 16-query passes and the in-block sum of dk and dv."""
    q, k, v, do = inputs(rng, BH, Nq, Nk, d, dv, dtype)
    nq_pad, nk_pad = fa.train_shapes(Nq, Nk, 256, 512)
    args = (SEED, 1.0 / math.sqrt(d), rate, nq_pad, nk_pad)
    ref_out, ref_lse = fa.flash_train_fwd_plain(q, k, v, *args)
    delta = (do.float() * ref_out.float()).sum(-1)
    dk, dv_ = emulate_dkv(q, k, v, do, ref_lse, delta, *args[1:], split=split)
    ref_dk, ref_dv = fa.flash_dkv_plain(q, k, v, do, ref_lse, delta, *args)
    assert dk.dtype == dv_.dtype == dtype and dk.shape == k.shape and dv_.shape == v.shape
    assert tolerance_ratio(dk, ref_dk) <= 1.0
    assert tolerance_ratio(dv_, ref_dv) <= 1.0


@pytest.mark.parametrize("split", [1, 4])
def test_k6_one_tf32_product_fails_the_f32_tolerance(rng, split):
    q, k, v, do = inputs(rng, 2, 40, 100, 64, 32, torch.float32)
    nq_pad, nk_pad = fa.train_shapes(40, 100, 256, 512)
    args = (SEED, 0.125, 0.0, nq_pad, nk_pad)
    ref_out, ref_lse = fa.flash_train_fwd_plain(q, k, v, *args)
    delta = (do * ref_out).sum(-1)
    dk, dv_ = emulate_dkv(q, k, v, do, ref_lse, delta, *args[1:], parts=parts_1xtf32, split=split)
    ref_dk, ref_dv = fa.flash_dkv_plain(q, k, v, do, ref_lse, delta, *args)
    assert tolerance_ratio(dk, ref_dk) > 1.0
    assert tolerance_ratio(dv_, ref_dv) > 1.0
