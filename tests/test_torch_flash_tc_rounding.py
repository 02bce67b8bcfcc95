"""The rounding of the tensor-core flash attention (csrc/flash_attention.cu),
emulated on the CPU and held to the tolerances its check on the card uses.

The kernel cannot run here, but what it rounds can: this file emulates it in
torch, tile by tile as the kernel walks the keys (64 a tile, online softmax,
p = exp2((s - max) * scale * log2(e))), `mma.sync` by `mma.sync`:

- f32 storage, 3xTF32: each f32 operand x is split into big = tf32(x) and
  small = tf32(x - big), tf32 by round-to-nearest (ties away) on the f32 bit
  pattern to 10 mantissa bits (cvt.rna.tf32.f32), and each product is
  big·small + small·big + big·big on k-steps of 8, for q·kᵀ and for P·v; a
  tile's P·v starts from zero and is added to the output's accumulator in
  f32 (round to nearest);
- bf16 storage: q·kᵀ from the stored bf16 values (exact products), k-steps
  of 16; P as a hi + lo pair of bf16, two P·v products a k-step, into one
  accumulator over all key tiles; the output rounded to bf16.

Each `mma.sync` is modelled as its accumulator plus its exact products,
rounded toward zero to f32: the tensor cores' f32 sums truncate. The model is
pessimistic: it puts the first design on the card (f32 P·v in one chain
through every key tile) at 1.17 of the f32 tolerance where the card measured
0.69 (chip_smoke.py phase 1's check of the flagship encoder).

Each emulation must lie within chip_smoke.py phase 1's tolerances of the
port's plain version (`reference_attention`) and of the JAX package's
`flash_attention` run in interpret mode, at the encoder's shape cut to one
image, at the decoder's head dims (64, 32) and at a ragged key count.
Negative controls show the tolerances and the model discriminate: one TF32
product (no split) fails the f32 tolerance; the one-chain f32 P·v lies far
further from the plain version than the per-tile one; P rounded once to
bf16 lies further than the hi + lo pair.
"""
import math

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from future_od_tpu.ops.flash_attention import flash_attention as jax_flash_attention

from future_od_tpu_torch.ops.flash_attention import LOG2E, reference_attention

# chip_smoke.py phase 1 (KERNEL_RTOL, KERNEL_ATOL): |out - plain| <= RTOL *
# |plain| + ATOL * max |plain|
RTOL = {torch.float32: 0.0, torch.bfloat16: 2.0**-7}
ATOL = {torch.float32: 2e-5, torch.bfloat16: 1e-3}
BLOCK_K = 64  # keys a tile, as the kernel walks them


def tf32(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: round the f32 bit pattern to 10 mantissa bits, ties
    away from zero (the sign bit is apart from the magnitude)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split_tf32(x: torch.Tensor):
    big = tf32(x)
    return big, tf32(x - big)


def bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def toward_zero(x: torch.Tensor) -> torch.Tensor:
    """f64 to f32, rounded toward zero."""
    f = x.float()
    return torch.where(f.double().abs() > x.abs(), torch.nextafter(f, torch.zeros_like(f)), f)


def mma_chain(c, parts, k_step: int):
    """c + the sum of a @ b over `parts` [(a, b), ...] in the kernel's
    order: for each k-step of k_step columns, every part in order, each
    `mma.sync` rounding its f32 sum toward zero."""
    for k0 in range(0, parts[0][0].shape[-1], k_step):
        cols = slice(k0, k0 + k_step)
        for a, b in parts:
            c = toward_zero(c.double() + a[..., cols].double() @ b[..., cols, :].double())
    return c


def parts_3xtf32(a, b):
    (a_big, a_small), (b_big, b_small) = split_tf32(a), split_tf32(b)
    return [(a_big, b_small), (a_small, b_big), (a_big, b_big)]


def parts_1xtf32(a, b):
    """TF32 operands, no split: the negative control."""
    return [(tf32(a), tf32(b))]


def parts_as_stored(a, b):
    return [(a, b)]


def parts_hi_lo(p, v):
    hi = bf16(p)
    return [(bf16(p - hi), v), (hi, v)]


def parts_once(p, v):
    """P rounded once to bf16: the negative control."""
    return [(bf16(p), v)]


@pytest.fixture(autouse=True)
def one_torch_thread(request):
    """Each test on one torch thread, the count restored after it. The suite
    runs a whole file on one of its xdist workers (--dist loadfile), and six
    workers each with torch's default threads (one a core) oversubscribe the
    cores: the emulations' time went to that, not to their arithmetic. A
    module's KEEP_TORCH_THREADS names tests that keep the threads they run
    with. The port's other emulation files import this fixture."""
    if request.node.originalname in getattr(request.module, "KEEP_TORCH_THREADS", ()):
        yield
        return
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


# the kernel's designs by storage type
F32_3XTF32 = dict(k_step=8, qk=parts_3xtf32, pv=parts_3xtf32, pv_per_tile=True)
BF16_HI_LO = dict(k_step=16, qk=parts_as_stored, pv=parts_hi_lo, pv_per_tile=False)


def emulate(q, k, v, scale: float, design=None, round_output: bool = True) -> torch.Tensor:
    """The kernel's function with its rounding. q, k (B, H, N, d), v (B, H,
    Nk, dv) in f32 or bf16; `design` defaults to the kernel's for q's dtype.
    Returns (B, H, Nq, dv), in q's dtype if round_output, else in f32."""
    dtype = q.dtype
    if design is None:
        design = F32_3XTF32 if dtype == torch.float32 else BF16_HI_LO
    q, k, v = q.float(), k.float(), v.float()
    c = torch.tensor(scale * LOG2E, dtype=torch.float32)
    shape = (*q.shape[:-1], 1)
    row_max = torch.full(shape, -math.inf)
    row_sum = torch.zeros(shape)
    acc = torch.zeros((*q.shape[:-1], v.shape[-1]))
    step = design["k_step"]
    for k0 in range(0, k.shape[-2], BLOCK_K):
        kt, vt = k[..., k0:k0 + BLOCK_K, :], v[..., k0:k0 + BLOCK_K, :]
        s = mma_chain(torch.zeros(*q.shape[:-1], kt.shape[-2]),
                      design["qk"](q, kt.transpose(-1, -2)), step)
        new_max = torch.maximum(row_max, s.amax(-1, keepdim=True))
        corr = torch.exp2((row_max - new_max) * c)
        p = torch.exp2((s - new_max) * c)
        row_sum = row_sum * corr + p.sum(-1, keepdim=True)
        if design["pv_per_tile"]:
            acc = acc * corr + mma_chain(torch.zeros_like(acc), design["pv"](p, vt), step)
        else:
            acc = mma_chain(acc * corr, design["pv"](p, vt), step)
        row_max = new_max
    out = acc / row_sum
    return out.to(dtype) if round_output else out


def tolerance_ratio(out, ref) -> float:
    """The worst element's |out - ref| over its phase-1 tolerance."""
    dtype = ref.dtype
    out, ref = out.float(), ref.float()
    tol = RTOL[dtype] * ref.abs() + ATOL[dtype] * ref.abs().max()
    return ((out - ref).abs() / tol).max().item()


def inputs(rng, B, H, Nq, Nk, d, dv, dtype):
    arrays = (rng.normal(size=(B, H, n, w)).astype(np.float32)
              for n, w in ((Nq, d), (Nk, d), (Nk, dv)))
    return [torch.from_numpy(a).to(dtype) for a in arrays]


def test_tf32_split(rng):
    x = torch.from_numpy(
        (rng.normal(size=4096) * 10.0 ** rng.integers(-20, 20, size=4096)).astype(np.float32))
    big, small = split_tf32(x)
    for part in (big, small):
        assert bool((part.view(torch.int32) & 0x1FFF == 0).all())
    # big + small holds x to 2^-22 relative (11 + 11 significant bits)
    err = (x.double() - big.double() - small.double()).abs()
    assert bool((err <= 2.0**-22 * x.double().abs()).all())
    # ties go away from zero
    tie = torch.tensor([1.0 + 2.0**-11, -(1.0 + 2.0**-11)], dtype=torch.float32)
    assert tf32(tie).tolist() == [1.0 + 2.0**-10, -(1.0 + 2.0**-10)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "B,H,Nq,Nk,d,dv",
    [(1, 8, 1400, 1400, 32, 32),  # the encoder's self-attention, one image
     (1, 2, 100, 300, 64, 32),    # the decoder's concat heads
     (1, 1, 17, 65, 32, 32)],     # one real key in the last tile
)
def test_emulated_rounding_within_phase1_tolerance(rng, dtype, B, H, Nq, Nk, d, dv):
    q, k, v = inputs(rng, B, H, Nq, Nk, d, dv, dtype)
    scale = 1.0 / math.sqrt(d)
    out = emulate(q, k, v, scale)
    assert out.dtype == dtype and out.shape == (B, H, Nq, dv)
    assert tolerance_ratio(out, reference_attention(q, k, v, scale)) <= 1.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,Nq,Nk,d,dv", [(1, 2, 70, 130, 64, 32), (1, 1, 17, 65, 32, 32)])
def test_emulated_rounding_matches_jax_interpret(rng, dtype, B, H, Nq, Nk, d, dv):
    q, k, v = inputs(rng, B, H, Nq, Nk, d, dv, dtype)
    scale = 1.0 / math.sqrt(d)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    ref = jax_flash_attention(*(jnp.asarray(t.float().numpy(), jdt) for t in (q, k, v)), scale,
                              interpret=True)
    ref = torch.from_numpy(np.array(ref, np.float32)).to(dtype)
    assert tolerance_ratio(emulate(q, k, v, scale), ref) <= 1.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_emulated_rounding_large_logits(rng, dtype):
    """Logits of about 1e3, exact in f32 (integer q and k, a power-of-two
    scale): the softmax is nearly one-hot and the running max moves."""
    q, k = (torch.from_numpy(rng.integers(-64, 65, size=(1, 2, n, 32)).astype(np.float32))
            .to(dtype) for n in (200, 300))
    v = torch.from_numpy(rng.normal(size=(1, 2, 300, 32)).astype(np.float32)).to(dtype)
    logits = (q.float() @ k.float().transpose(-1, -2)) * 0.125
    assert 500.0 < logits.abs().max().item() < 1e4
    assert tolerance_ratio(emulate(q, k, v, 0.125), reference_attention(q, k, v, 0.125)) <= 1.0


def test_one_tf32_product_fails_the_f32_tolerance(rng):
    q, k, v = inputs(rng, 1, 8, 1400, 1400, 32, 32, torch.float32)
    scale = 1.0 / math.sqrt(32)
    one = dict(F32_3XTF32, qk=parts_1xtf32, pv=parts_1xtf32)
    assert tolerance_ratio(emulate(q, k, v, scale, one), reference_attention(q, k, v, scale)) > 1.0


def test_f32_pv_per_tile_beats_one_chain(rng):
    """The truncating sums of one P·v chain through every key tile drift;
    a fresh accumulator a tile, added on the CUDA cores, does not."""
    q, k, v = inputs(rng, 1, 2, 1400, 1400, 32, 32, torch.float32)
    scale = 1.0 / math.sqrt(32)
    exact = reference_attention(q.double(), k.double(), v.double(), scale)
    errs = {per_tile: (emulate(q, k, v, scale, dict(F32_3XTF32, pv_per_tile=per_tile)).double()
                       - exact).abs().max().item()
            for per_tile in (True, False)}
    assert 3 * errs[True] < errs[False], errs


def test_bf16_p_hi_lo_beats_one_rounding(rng):
    """Before the output's own bf16 rounding, the hi + lo pair leaves P's
    rounding more than 16x smaller than P rounded once."""
    q, k, v = inputs(rng, 1, 2, 1400, 1400, 32, 32, torch.bfloat16)
    scale = 1.0 / math.sqrt(32)
    exact = reference_attention(q.double(), k.double(), v.double(), scale)
    errs = {pv.__name__: (emulate(q, k, v, scale, dict(BF16_HI_LO, pv=pv), round_output=False)
                          .double() - exact).abs().max().item()
            for pv in (parts_hi_lo, parts_once)}
    assert errs["parts_hi_lo"] * 16 < errs["parts_once"], errs
