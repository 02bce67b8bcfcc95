"""Flash attention (port of future_od_tpu/ops/flash_attention.py::flash_attention).

`flash_attention` launches the CUDA kernel `csrc/flash_attention.cu`, which
replaces the Pallas TPU kernel `_flash_kernel`: softmax(q·kᵀ·scale)·v with an
online softmax over key tiles, f32 dots and sums, output in q's dtype. The
(Nq, Nk) logits never reach device memory. On a CPU tensor it runs
`reference_attention`, the plain version of the same function.
"""
from __future__ import annotations

import torch

from future_od_tpu_torch.ops import _kernels

NAME = "flash_attention"
LOG2E = 1.4426950408889634
# (head dim of q/k, head dim of v) the kernel is instantiated for: the
# encoder's 32/32 and the conditional cross-attention's concat heads 64/32
SUPPORTED_HEAD_DIMS = ((32, 32), (64, 32))


def reference_attention(q, k, v, scale: float) -> torch.Tensor:
    """Plain version: softmax((q kᵀ) * scale) v in f32, cast to q's dtype.
    q, k: (B, H, Nq|Nk, d); v: (B, H, Nk, dv) -> (B, H, Nq, dv)."""
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    return torch.matmul(torch.softmax(logits, dim=-1), v.float()).to(q.dtype)


def flash_attention(q, k, v, scale: float) -> torch.Tensor:
    """softmax(q·kᵀ·scale)·v without materializing the logits.

    q, k: (B, H, Nq|Nk, d); v: (B, H, Nk, dv); f32 or bf16. Returns
    (B, H, Nq, dv) in q's dtype. CPU tensors take `reference_attention`;
    CUDA tensors launch the kernel or raise.
    """
    if q.device.type == "cpu":
        return reference_attention(q, k, v, scale)
    B, H, Nq, d = q.shape
    Nk, dv = k.shape[2], v.shape[3]
    if k.shape != (B, H, Nk, d) or v.shape[:3] != (B, H, Nk):
        raise ValueError(f"{NAME}: shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    if (d, dv) not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"{NAME}: head dims (d={d}, dv={dv}) not in {SUPPORTED_HEAD_DIMS}")
    if q.dtype not in _kernels.DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{NAME}: dtypes {q.dtype}/{k.dtype}/{v.dtype}; want one of f32, bf16")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    _kernels.check_cuda_operands(NAME, q, k, v)
    out = torch.empty((B, H, Nq, dv), dtype=q.dtype, device=q.device)
    _kernels.call(
        NAME, "fod_flash_attention",
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B * H, Nq, Nk, d, dv, float(scale) * LOG2E,
        _kernels.DTYPE_CODES[q.dtype], _kernels.stream_of(q),
    )
    _kernels.launch_counts[NAME] += 1
    return out


def attention_cost(B: int, H: int, Nq: int, Nk: int, d: int, dv: int, itemsize: int):
    """(operations, bytes) one call needs at least: the two products, each
    input read once and the output written once."""
    ops = 2 * B * H * Nq * Nk * (d + dv)
    nbytes = itemsize * B * H * (Nq * d + Nk * d + Nk * dv + Nq * dv)
    return ops, nbytes
