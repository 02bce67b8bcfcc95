"""The softmax-floor ladder (port of tools/bench_softmax_floor.py's variants).

`attention_floor(q, k, v, scale, mode, block_k)` launches the CUDA kernel
`csrc/attention_floor.cu`, which replaces the Pallas TPU kernel
`_variant_kernel` of that tool: the inference flash attention with parts of
its softmax stripped, to measure what the softmax costs. Modes:

- "dots": q·kᵀ then P·V with the logits as P, no softmax;
- "unsafe": exp2 and the row sum, no running max and no corrections;
- "bf16sm": the full online softmax with its per-element chain in bf16.

The kernel is K1's own (`csrc/flash_forward.cuh`, shared with
`csrc/flash_attention.cu`): the same tiles, staging and tensor-core products,
the rung a compile-time mode, so the ladder's gaps are K1's.

Each mode computes what the TPU kernel computes, rounding included (see
`attention_floor_plain`), with the keys zero-padded to a multiple of
`block_k` and the padded keys not masked, as the TPU wrapper pads them: with
the tool's 1400 keys and block_k 1408, eight zero keys enter every row. On
CPU tensors the wrapper runs `attention_floor_plain`; on CUDA tensors it
launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from future_od_tpu_torch.ops import _kernels
from future_od_tpu_torch.ops.flash_attention import LOG2E, attention_cost

NAME = "attention_floor"
MODES = {"dots": 0, "unsafe": 1, "bf16sm": 2}
HEAD_DIM = 32  # q/k and v head dim the kernel is instantiated for (the encoder's)
LN2_BF16 = 0.69140625  # bf16(ln 2): jnp.exp2 of a bf16 x is bf16(exp(bf16(bf16(ln 2) * x)))
BF16_MAX_INIT = -30000.0  # the TPU kernel's initial running max, in bf16


def padded_keys(nk: int, block_k: int) -> int:
    """nk rounded up to a multiple of block_k, as the TPU wrapper pads."""
    return -(-nk // block_k) * block_k


def _bf16(t: torch.Tensor) -> torch.Tensor:
    """t's value after a round trip through bf16, in f32."""
    return t.to(torch.bfloat16).float()


def attention_floor_plain(q, k, v, scale: float, mode: str, block_k: int) -> torch.Tensor:
    """Plain version, in f32 with the TPU kernel's roundings. q, k: (B, H,
    Nq|Nk, d); v: (B, H, Nk, dv) -> (B, H, Nq, dv) in q's dtype.

    q' = bf16(q * f32(scale * log2 e)) and the logits l = q'·kᵀ over the
    zero-padded keys, then:
    - dots: Σ bf16(l)·v;
    - unsafe: p = exp2(l), Σ bf16(p)·v / Σ p;
    - bf16sm: per block of block_k keys, l = bf16(l), m' = max(m, max l)
      (m starts at bf16(-30000)), the correction exp2(bf16(m - m')) in f32,
      p = jnp.exp2 in bf16 of bf16(l - m'), the row sum grown by the block's
      sum of p rounded to bf16, and acc·correction + p·v.
    """
    if mode not in MODES:
        raise ValueError(f"{NAME}: mode {mode!r} not in {tuple(MODES)}")
    nk = k.shape[2]
    pad = (0, 0, 0, padded_keys(nk, block_k) - nk)
    kf, vf = F.pad(k.float(), pad), F.pad(v.float(), pad)
    qs = _bf16(q.float() * torch.tensor(scale * LOG2E, dtype=torch.float32))
    logits = torch.matmul(qs, kf.transpose(-1, -2))
    if mode == "dots":
        out = torch.matmul(_bf16(logits), vf)
    elif mode == "unsafe":
        p = torch.exp2(logits)
        out = torch.matmul(_bf16(p), vf) / p.sum(-1, keepdim=True)
    else:
        row_max = _bf16(torch.full(logits.shape[:-1] + (1,), BF16_MAX_INIT, device=q.device))
        row_sum = torch.zeros_like(row_max)
        acc = torch.zeros(logits.shape[:-1] + (vf.shape[-1],), device=q.device)
        for b0 in range(0, kf.shape[2], block_k):
            lb = _bf16(logits[..., b0:b0 + block_k])
            new_max = torch.maximum(row_max, lb.amax(-1, keepdim=True))
            correction = torch.exp2(_bf16(row_max - new_max))
            p = _bf16(torch.exp(_bf16(LN2_BF16 * _bf16(lb - new_max))))
            row_sum = row_sum * correction + _bf16(p.sum(-1, keepdim=True))
            acc = acc * correction + torch.matmul(p, vf[..., b0:b0 + block_k, :])
            row_max = new_max
        out = acc / row_sum
    return out.to(q.dtype)


def attention_floor(q, k, v, scale: float, mode: str, block_k: int) -> torch.Tensor:
    """One rung of the ladder (`attention_floor_plain`'s function). q, k, v:
    (B, H, N, 32), f32 or bf16, one dtype; block_k sets the key padding (and,
    in bf16sm, the rescale blocks). Returns (B, H, Nq, 32) in q's dtype."""
    if q.device.type == "cpu":
        return attention_floor_plain(q, k, v, scale, mode, block_k)
    if mode not in MODES:
        raise ValueError(f"{NAME}: mode {mode!r} not in {tuple(MODES)}")
    B, H, Nq, d = q.shape
    Nk = k.shape[2]
    if k.shape != (B, H, Nk, d) or v.shape != (B, H, Nk, v.shape[3]):
        raise ValueError(f"{NAME}: shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    if d != HEAD_DIM or v.shape[3] != HEAD_DIM:
        raise ValueError(f"{NAME}: head dims (d={d}, dv={v.shape[3]}); want {HEAD_DIM}")
    if q.dtype not in _kernels.DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{NAME}: dtypes {q.dtype}/{k.dtype}/{v.dtype}; want one of f32, bf16")
    if block_k <= 0:
        raise ValueError(f"{NAME}: block_k {block_k}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    _kernels.check_cuda_operands(NAME, q, k, v)
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError(f"{NAME}: operands must be 16-byte aligned (16-byte async copies)")
    out = torch.empty_like(q)
    _kernels.call(
        NAME, "fod_attention_floor",
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B * H, Nq, Nk, padded_keys(Nk, block_k), block_k, float(scale) * LOG2E,
        MODES[mode], _kernels.DTYPE_CODES[q.dtype], _kernels.stream_of(q),
        device=q.device,
    )
    _kernels.launch_counts[NAME] += 1
    return out


def attention_floor_info(mode: str, dtype: torch.dtype) -> dict:
    """A rung's kernel resources on the current card: registers a thread,
    static and dynamic shared bytes a block, local (spill) bytes a thread,
    resident blocks an SM. Launches nothing."""
    out = (ctypes.c_int * 5)()
    _kernels.call(NAME, "fod_attention_floor_info", MODES[mode], _kernels.DTYPE_CODES[dtype],
                  ctypes.addressof(out))
    keys = ("registers", "static_smem_bytes", "dynamic_smem_bytes", "local_bytes",
            "blocks_per_sm")
    return dict(zip(keys, out))


def floor_exponentials(B: int, H: int, Nq: int, Nk: int, block_k: int, mode: str) -> int:
    """The exponentials a rung needs at least: one a logit over the padded
    keys, none for dots (bf16sm's corrections, one a row and block, not
    counted)."""
    return 0 if mode == "dots" else B * H * Nq * padded_keys(Nk, block_k)


def floor_cost(B: int, H: int, Nq: int, Nk: int, block_k: int, itemsize: int):
    """(operations, bytes) one call needs at least: the two products over
    the padded keys (the function's own), each input read once, the output
    written once. bf16sm's second pass of q·kᵀ is the kernel's, not counted."""
    ops, _ = attention_cost(B, H, Nq, padded_keys(Nk, block_k), HEAD_DIM, HEAD_DIM, itemsize)
    _, nbytes = attention_cost(B, H, Nq, Nk, HEAD_DIM, HEAD_DIM, itemsize)
    return ops, nbytes


def exact_logit_inputs(B: int, H: int, Nq: int, Nk: int, scale: float,
                       generator: torch.Generator):
    """(q, k, v) in f32 whose logits q'·kᵀ are exact in f32 in any order of
    summation: |q'| in [1/16, 1) (so its bf16 grid is no finer than 2^-11),
    keys small integers in [-3, 3], 32 terms below 2^7. The kernel and the
    plain version then round every logit alike, and can be held together
    elementwise; with other data a logit one f32 ulp apart now and then rounds
    to another bf16 value, which the bf16 chain turns into a visible gap."""
    dev = generator.device
    u = torch.rand((B, H, Nq, HEAD_DIM), generator=generator, device=dev) * (15 / 16) + 1 / 16
    sign = torch.randint(0, 2, u.shape, generator=generator, device=dev) * 2 - 1
    q = sign * u / (scale * LOG2E)
    k = torch.randint(-3, 4, (B, H, Nk, HEAD_DIM), generator=generator, device=dev).float()
    v = torch.randn((B, H, Nk, HEAD_DIM), generator=generator, device=dev)
    return q, k, v
