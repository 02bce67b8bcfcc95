"""Flash attention (port of future_od_tpu/ops/flash_attention.py).

Inference: `flash_attention` launches the CUDA kernel `csrc/flash_attention.cu`,
which replaces the Pallas TPU kernel `_flash_kernel`: softmax(q·kᵀ·scale)·v with
an online softmax over key tiles, f32 max, sums and accumulators, output in q's
dtype. Its products run on the tensor cores (`mma.sync`): bf16 operands as
stored with P as a hi + lo pair of bf16, f32 operands as three TF32 products
(3xTF32, f32 accuracy). The (Nq, Nk) logits never reach device memory. On a
CPU tensor it runs `reference_attention`, the plain version of the same
function. The call is the `torch.library` op `fod::flash_attention` (CPU:
the plain version; CUDA: the launch; a fake implementation for tracing), so
`torch.export` keeps the kernel in an exported graph as one node
(serve/export.py).

Training: `flash_attention_train` is the differentiable counterpart with
attention-weight dropout inside the kernels (`FlashAttentionTrain`). Its
forward, dq and dk/dv kernels (`csrc/flash_attention_train.cu`) replace the
Pallas kernels `_flash_fwd_kernel`, `_flash_dq_kernel` and `_flash_dkv_kernel`;
all three regenerate one dropout mask, a hash of each element's flat index
in the JAX kernels' padded (nq_pad, nk_pad) geometry and of the seed
(`dropout_keep_mask`, `csrc/dropout_mask.cuh`). The geometry comes from the
JAX block sizes (`train_shapes`), never from the CUDA tiles, so the mask is
the TPU kernels' bit for bit. A call over a share of a layer's heads (tensor
parallelism: `heads=(H_local, H, h0)`) hashes each element at its global
batch·head, (bh // H_local)·H + h0 + bh % H_local, so a share draws the
same mask as the call over every head. All three run their products on the tensor
cores and compute the logits on the CUDA cores, each the same sequential
f32 chain, bit for bit. The kernels read q, k, v and do by strides, so
attend_heads' transposed (B, N, H, d) views go in without a copy, and write
their outputs in that layout; a call packs its arguments into one struct
(`_TRAIN_ARGS`), since the host's time a call is part of the kernel's cost.
On CPU tensors the plain versions run.

Head dims: K1 and K4-K6 are built for the pairs of SUPPORTED_HEAD_DIMS; the
wrappers run any other (d, dv) up to MAX_HEAD_DIM on the smallest built
pair that holds it, its operands zero-padded and its outputs sliced back
(`kernel_head_dims`, `pad_head_dim`: for K1 inside the op's CUDA
implementation, so `fod::flash_attention`'s signature, fake and CPU arm are
unchanged; for K4-K6 in `flash_train_fwd`, `flash_dq` and `flash_dkv`).
Above MAX_HEAD_DIM they raise.
"""
from __future__ import annotations

import ctypes
import functools
import math
import struct
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from future_od_tpu_torch.ops import _kernels

NAME = "flash_attention"
TRAIN_NAME = "flash_attention_train"
LOG2E = 1.4426950408889634
# (head dim of q/k, head dim of v) the kernels (K1 and K4-K6) are
# instantiated for: the flagship encoder's 32/32 and its conditional
# cross-attention's concat heads 64/32, the same at heads of 16
# (runs/nuim_single_frame.py --debug: hidden 64 over 4 heads) 16/16 and 32/16,
# an encoder's heads of 64 (hidden 512 over 8 heads) 64/64 and that config's
# concat heads 128/64, heads of 128, 128/128, the concat heads of heads of 128
# (hidden 1024 over 8 heads) 256/128, and heads of 256, 256/256. The wrappers
# take any pair up to MAX_HEAD_DIM on the card by zero-padding it onto the
# smallest built pair that holds it (`kernel_head_dims`); above it they raise
# (no config of the family reaches it). They never take the plain version there.
SUPPORTED_HEAD_DIMS = ((32, 32), (64, 32), (16, 16), (32, 16), (64, 64), (128, 64), (128, 128),
                       (256, 128), (256, 256))
MAX_HEAD_DIM = 256


def kernel_head_dims(d: int, dv: int, name: str = NAME) -> Tuple[int, int]:
    """The built pair (D, DV) a call at head dims (d, dv) runs: the smallest
    of SUPPORTED_HEAD_DIMS (by D + DV) with D >= d and DV >= dv. The
    wrappers zero-pad q and k along d and v (and do) along dv to it, and
    slice the outputs back: zero columns add exact zeros to every logit and
    to dq, dk and dv, and the caller's scale (of the true d) is kept. Raises
    ValueError above MAX_HEAD_DIM (ROADMAP Queue 3: no kernel is built
    there)."""
    fits = [(D, DV) for D, DV in SUPPORTED_HEAD_DIMS if D >= d and DV >= dv]
    if not fits:
        raise ValueError(f"{name}: head dims (d={d}, dv={dv}) above {MAX_HEAD_DIM}: no kernel "
                         f"is built for them (ROADMAP Queue 3); built {SUPPORTED_HEAD_DIMS}")
    return min(fits, key=lambda p: (p[0] + p[1], p))


def pad_head_dim(t: torch.Tensor, width: int) -> torch.Tensor:
    """t zero-padded along its last dim to `width` (t itself when it has
    that width)."""
    return t if t.shape[-1] == width else F.pad(t, (0, width - t.shape[-1]))


def reference_attention(q, k, v, scale: float) -> torch.Tensor:
    """Plain version: softmax((q kᵀ) * scale) v in f32, cast to q's dtype.
    q, k: (B, H, Nq|Nk, d); v: (B, H, Nk, dv) -> (B, H, Nq, dv)."""
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    return torch.matmul(torch.softmax(logits, dim=-1), v.float()).to(q.dtype)


def flash_attention(q, k, v, scale: float) -> torch.Tensor:
    """softmax(q·kᵀ·scale)·v without materializing the logits.

    q, k: (B, H, Nq|Nk, d); v: (B, H, Nk, dv); f32 or bf16. Returns
    (B, H, Nq, dv) in q's dtype. CPU tensors take `reference_attention`;
    CUDA tensors launch the kernel or raise, other devices raise. The call
    is the op `fod::flash_attention`, which `torch.export` keeps as one
    node; off the CPU its operands are checked before it, so an export on
    the card refuses what the kernel would.
    """
    if q.device.type != "cpu":
        _check_attention(q, k, v)
    return _FLASH_ATTENTION(q, k, v, float(scale))


def _check_attention(q, k, v) -> None:
    """Raise unless K1 takes these operands: matching shapes, head dims up
    to MAX_HEAD_DIM, f32 or bf16, one CUDA device."""
    B, H, Nq, d = q.shape
    Nk, dv = k.shape[2], v.shape[3]
    if k.shape != (B, H, Nk, d) or v.shape[:3] != (B, H, Nk):
        raise ValueError(f"{NAME}: shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    kernel_head_dims(d, dv)
    if q.dtype not in _kernels.DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{NAME}: dtypes {q.dtype}/{k.dtype}/{v.dtype}; want one of f32, bf16")
    _kernels.check_cuda_device(NAME, q, k, v)


def flash_attention_cuda(q, k, v, scale: float) -> torch.Tensor:
    """The op's CUDA implementation: check, launch K1, count the launch
    (chip_smoke.py times it beside the op to give the dispatcher's cost).
    Head dims that are not a built pair run on the pair `kernel_head_dims`
    gives, q and k zero-padded along d and v along dv, the output sliced
    back (a contiguous copy)."""
    _check_attention(q, k, v)
    B, H, Nq, d = q.shape
    Nk, dv = k.shape[2], v.shape[3]
    D, DV = kernel_head_dims(d, dv)
    q, k = (pad_head_dim(t, D).contiguous() for t in (q, k))
    v = pad_head_dim(v, DV).contiguous()
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError(f"{NAME}: operands must be 16-byte aligned (16-byte async copies)")
    out = torch.empty((B, H, Nq, DV), dtype=q.dtype, device=q.device)
    _kernels.call(
        NAME, "fod_flash_attention",
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B * H, Nq, Nk, D, DV, float(scale) * LOG2E,
        _kernels.DTYPE_CODES[q.dtype], _kernels.stream_of(q),
        device=q.device,
    )
    _kernels.launch_counts[NAME] += 1
    return out if DV == dv else out[..., :dv].contiguous()


def _attention_fake(q, k, v, scale):
    return q.new_empty(q.shape[:3] + v.shape[3:])


# fod::flash_attention: CPU the plain version, CUDA the launch, a fake for
# tracing. Defined through torch.library.Library, whose dispatch costs the
# host a few µs a call (a custom_op's Python autograd wrapper costs more).
_LIB = torch.library.Library("fod", "FRAGMENT")  # the ops live as long as it
_LIB.define("flash_attention(Tensor q, Tensor k, Tensor v, float scale) -> Tensor")
_LIB.impl("flash_attention", reference_attention, "CPU")
_LIB.impl("flash_attention", flash_attention_cuda, "CUDA")
torch.library.register_fake("fod::flash_attention", _attention_fake, lib=_LIB)
_FLASH_ATTENTION = torch.ops.fod.flash_attention.default


def attention_cost(B: int, H: int, Nq: int, Nk: int, d: int, dv: int, itemsize: int):
    """(operations, bytes) one call needs at least: the two products, each
    input read once and the output written once."""
    ops = 2 * B * H * Nq * Nk * (d + dv)
    nbytes = itemsize * B * H * (Nq * d + Nk * d + Nk * dv + Nq * dv)
    return ops, nbytes


def attention_exponentials(B: int, H: int, Nq: int, Nk: int) -> int:
    """The exponentials one call needs at least: one a logit."""
    return B * H * Nq * Nk


def flash_attention_info(d: int, dv: int, dtype: torch.dtype) -> dict:
    """The kernel instantiation's resources on the current card: registers a
    thread, static and dynamic shared bytes a block, local (spill) bytes a
    thread, resident blocks an SM. Launches nothing."""
    out = (ctypes.c_int * 5)()
    _kernels.call(NAME, "fod_flash_attention_info", d, dv, _kernels.DTYPE_CODES[dtype],
                  ctypes.addressof(out))
    keys = ("registers", "static_smem_bytes", "dynamic_smem_bytes", "local_bytes",
            "blocks_per_sm")
    return dict(zip(keys, out))


# ---------------------------------------------------------------------------
# Differentiable flash attention with in-kernel dropout (training path)
# ---------------------------------------------------------------------------

_MASK32 = 0xFFFFFFFF


def dropout_threshold(rate: float) -> int:
    """The uint32 threshold below which a hash drops its element."""
    return min(int(rate * (2**32)), 2**32 - 1)


def dropout_keep_scale(rate: float) -> float:
    """The value of a kept element of the mask: 1 / (1 - rate) in f32."""
    return float(np.float32(1.0) / np.float32(1.0 - rate))


def global_heads(bh, heads: Optional[Tuple[int, int, int]]):
    """The global batch·head of a call's batch·head `bh` (an int or an
    integer tensor) when the call holds `heads` = (H_local, H, h0): H_local
    of a layer's H heads a batch, from head h0 (None: all of them)."""
    if heads is None:
        return bh
    h_local, h_full, h0 = heads
    return (bh // h_local) * h_full + h0 + bh % h_local


def dropout_keep_mask(seed: int, bh, row, col, rate: float, nq_pad: int, nk_pad: int):
    """Plain K7: the dropout mask value (0 or 1/(1-rate), f32) of the
    elements at (global) batch·head `bh`, query `row`, key `col` (integer
    tensors that broadcast together). A PCG-style hash of the flat index
    (bh·nq_pad + row)·nk_pad + col XOR seed·0x9E3779B9 in wrapping uint32,
    emulated in int64 masked to 32 bits (torch has no uint32 arithmetic)."""
    bh, row, col = (torch.as_tensor(x, dtype=torch.int64) for x in (bh, row, col))
    idx = ((bh * nq_pad + row) * nk_pad + col) & _MASK32
    x = idx ^ ((int(seed) * 0x9E3779B9) & _MASK32)
    x = (x * 747796405 + 2891336453) & _MASK32
    w = (((x >> ((x >> 28) + 4)) ^ x) * 277803737) & _MASK32
    bits = (w >> 22) ^ w
    keep = bits >= dropout_threshold(rate)
    return keep.to(torch.float32) * dropout_keep_scale(rate)


def train_shapes(Nq: int, Nk: int, block_q: int, block_k: int) -> Tuple[int, int]:
    """(nq_pad, nk_pad): the padded geometry of the JAX kernels
    (`_train_shapes`), which fixes the dropout mask's flat index."""
    block_q = min(block_q, max(8, Nq))
    block_k = min(block_k, max(128, Nk))
    return -(-Nq // block_q) * block_q, -(-Nk // block_k) * block_k


def _mask(seed, BH, Nq, Nk, rate, nq_pad, nk_pad, device, heads=None):
    bh = global_heads(torch.arange(BH, device=device), heads)[:, None, None]
    row = torch.arange(Nq, device=device)[None, :, None]
    col = torch.arange(Nk, device=device)[None, None, :]
    return dropout_keep_mask(seed, bh, row, col, rate, nq_pad, nk_pad)


def _mask_like(seed, logits, rate, nq_pad, nk_pad, heads=None):
    """The mask over logits (..., Nq, Nk), the leading dims flattened into
    the batch·head index as the JAX kernels' grid flattens them, at the
    global batch·heads of `heads` (`global_heads`)."""
    *lead, Nq, Nk = logits.shape
    return _mask(seed, math.prod(lead), Nq, Nk, rate, nq_pad, nk_pad,
                 logits.device, heads).reshape(logits.shape)


def flash_train_fwd_plain(q, k, v, seed: int, scale: float, rate: float, nq_pad: int,
                          nk_pad: int, heads=None):
    """Plain K4. q (..., Nq, d), k (..., Nk, d), v (..., Nk, dv), the leading
    dims (BH,) or (B, H) -> (out (..., Nq, dv) in q's dtype, lse (..., Nq)
    f32). The row sum is taken before the mask multiplies p, as in the TPU
    kernel. `heads`: (H_local, H, h0) of a call over a share of the heads
    (`global_heads`), None for all of them."""
    logits = torch.matmul(q.float() * scale, k.float().transpose(-1, -2))
    row_max = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - row_max)
    row_sum = p.sum(dim=-1, keepdim=True)
    if rate > 0.0:
        p = p * _mask_like(seed, logits, rate, nq_pad, nk_pad, heads)
    out = torch.matmul(p, v.float()) / row_sum
    return out.to(q.dtype), (row_max + torch.log(row_sum))[..., 0]


def _recompute(q, k, v, do, lse, delta, seed, scale, rate, nq_pad, nk_pad, heads=None):
    """p = exp(scale·q·kᵀ - lse), the mask, and dlogits = p ⊙ (dS ⊙ mask - δ)
    with dS = do·vᵀ, in f32 — what K5 and K6 recompute per tile. The logits
    are rounded as the forward rounds them ((q·scale)·kᵀ), so p <= 1 however
    large they are."""
    logits = torch.matmul(q.float() * scale, k.float().transpose(-1, -2))
    p = torch.exp(logits - lse[..., None])
    ds = torch.matmul(do.float(), v.float().transpose(-1, -2))
    mask = None
    if rate > 0.0:
        mask = _mask_like(seed, logits, rate, nq_pad, nk_pad, heads)
        ds = ds * mask
    return p, mask, p * (ds - delta[..., None])


def flash_dq_plain(q, k, v, do, lse, delta, seed: int, scale: float, rate: float,
                   nq_pad: int, nk_pad: int, heads=None):
    """Plain K5: dq = Σ p ⊙ (dS ⊙ mask - δ) · k · scale, in q's dtype."""
    _, _, dlogits = _recompute(q, k, v, do, lse, delta, seed, scale, rate, nq_pad, nk_pad,
                               heads)
    return (torch.matmul(dlogits, k.float()) * scale).to(q.dtype)


def flash_dkv_plain(q, k, v, do, lse, delta, seed: int, scale: float, rate: float,
                    nq_pad: int, nk_pad: int, heads=None):
    """Plain K6: dk = (p ⊙ (dS ⊙ mask - δ))ᵀ · q · scale and
    dv = (p ⊙ mask)ᵀ · do, in k's and v's dtypes."""
    p, mask, dlogits = _recompute(q, k, v, do, lse, delta, seed, scale, rate, nq_pad, nk_pad,
                                  heads)
    p_dropped = p if mask is None else p * mask
    dv = torch.matmul(p_dropped.transpose(-1, -2), do.float())
    dk = torch.matmul(dlogits.transpose(-1, -2), q.float()) * scale
    return dk.to(k.dtype), dv.to(v.dtype)


# csrc/flash_attention_train.cu's TrainArgs, one a call: eight operands as
# (pointer, batch, head and row strides in elements) — q, k, v, do, two
# outputs, lse, delta — then the stream, b, h, nq, nk, d, dv, dtype, scale,
# the dropout seed and threshold, the keep value, nq_pad and nk_pad, then the
# heads the call holds of the layer's (H_local, H, h0). It is passed by
# value, so all of its sizeof (328 bytes, no tail padding) is read. One packed
# buffer costs the ctypes call far less than 33 converted arguments.
_TRAIN_ARGS = struct.Struct("<" + "Qqqq" * 8 + "Q7if2If2i3i")
_NO_OPERAND = (0, 0, 0, 0)


def _dims(t):
    """(B, H, N, w) of a (B, H, N, w) or (BH, N, w) tensor, a (BH, N, w) one
    being one batch of BH heads: arithmetic on the shape, no view (a view
    costs the host about as much as an allocation)."""
    shape = t.shape
    return tuple(shape) if len(shape) == 4 else (1, *shape)


def _fields(t, rank: int):
    """(pointer, batch, head and row strides) of a rank-`rank` operand
    ((B, H, N, w) for 4, (B, H, N) for 3) given in it or one rank lower
    (one batch)."""
    st = t.stride()
    if len(st) == rank:
        return (t.data_ptr(), *st[:3])
    return (t.data_ptr(), 0, *st[:2])


def _empty_rows(x, n: int, width: int, dtype):
    """An output with x's leading dims, n rows of `width`: laid out (B, N, H,
    width) for a (B, H, N, d) x — the layout attend_heads reshapes without a
    copy — and contiguous for a (BH, N, d) one."""
    if x.dim() == 4:
        B, H = x.shape[:2]
        return torch.empty_strided((B, H, n, width), (n * H * width, width, H * width, 1),
                                   dtype=dtype, device=x.device)
    return torch.empty((x.shape[0], n, width), dtype=dtype, device=x.device)


def _train_call(fn: str, q, k, v, do, o0, o1, lse, delta, scale: float, dropout) -> None:
    """Launch entry point `fn` of the training kernels on one packed
    TrainArgs: q, k, v, do (or None) and the outputs o0, o1 (or None) as
    (B, H, N, w) or (BH, N, w), lse and delta (or None) as (B, H, Nq) or
    (BH, Nq) f32. An input whose last dim is strided or whose rows are not
    16-byte aligned (the kernels copy rows 16 bytes at a time) goes in as a
    contiguous copy; the outputs are the wrappers' own, which fit."""
    held, fields = [], []
    for t in (q, k, v, do):
        if t is None:
            fields += _NO_OPERAND
            continue
        st = t.stride()
        m = t.element_size()
        if st[-1] != 1 or (t.data_ptr() | st[0] * m | st[1] * m | st[-2] * m) % 16:
            t = t.contiguous()
            held.append(t)  # alive until the launch is enqueued
        fields += _fields(t, 4)
    for t in (o0, o1):
        fields += _NO_OPERAND if t is None else _fields(t, 4)
    for t in (lse, delta):
        fields += _NO_OPERAND if t is None else _fields(t, 3)
    B, H, Nq, d = _dims(q)
    args = _TRAIN_ARGS.pack(*fields, _kernels.stream_of(q), B, H, Nq, k.shape[-2], d,
                            v.shape[-1], _kernels.DTYPE_CODES[q.dtype], scale, *dropout)
    _kernels.call(TRAIN_NAME, fn, args, device=q.device)


def _train_kernel_args(q, k, v, name):
    """(B, H, Nq, Nk, d, dv) of (B, H, N, w) or (BH, N, w) operands; raises
    on what the kernels do not take (head dims above MAX_HEAD_DIM among it)."""
    if not q.dim() == k.dim() == v.dim() or q.dim() not in (3, 4):
        raise ValueError(f"{name}: shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    B, H, Nq, d = _dims(q)
    Nk, dv = k.shape[-2], v.shape[-1]
    if _dims(k) != (B, H, Nk, d) or _dims(v)[:3] != (B, H, Nk):
        raise ValueError(f"{name}: shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    kernel_head_dims(d, dv, name)
    if q.dtype not in _kernels.DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{name}: dtypes {q.dtype}/{k.dtype}/{v.dtype}; want one of f32, bf16")
    return B, H, Nq, Nk, d, dv


def _check_devices(name, *tensors):
    index = tensors[0].get_device()  # -1 off the card; no torch.device built
    if not tensors[0].is_cuda or any(t.get_device() != index or not t.is_cuda for t in tensors):
        raise ValueError(f"{name}: operands must share one CUDA device, got "
                         f"{[str(t.device) for t in tensors]}")


@functools.lru_cache(maxsize=None)
def _dropout_constants(rate: float) -> Tuple[int, float]:
    return dropout_threshold(rate), dropout_keep_scale(rate)


def _dropout_args(seed: int, rate: float, nq_pad: int, nk_pad: int, heads=None):
    """(seed, threshold, keep value, nq_pad, nk_pad, H_local, H, h0) as the
    kernels take them. The threshold is computed here, exactly as the TPU
    kernel computes it; threshold 0 (rate 0) keeps every element at value 1.
    `heads` None (every head) is (1, 1, 0), which leaves bh as it is."""
    share = (1, 1, 0) if heads is None else tuple(int(h) for h in heads)
    if rate <= 0.0:
        return (0, 0, 1.0, nq_pad, nk_pad, *share)
    return (int(seed) & _MASK32, *_dropout_constants(rate), nq_pad, nk_pad, *share)


def flash_train_fwd(q, k, v, seed: int, scale: float, rate: float, nq_pad: int, nk_pad: int,
                    heads=None):
    """K4: (out, lse) of `flash_train_fwd_plain`, for (BH, N, w) or (B, H, N,
    w) operands of any strides; CPU tensors run the plain version, CUDA
    tensors launch `fod_flash_train_fwd` or raise. `heads`: (H_local, H,
    h0), the share of a layer's heads the call holds (`global_heads`)."""
    if q.is_cpu:
        return flash_train_fwd_plain(q, k, v, seed, scale, rate, nq_pad, nk_pad, heads)
    _, _, Nq, _, d, dv = _train_kernel_args(q, k, v, "flash_train_fwd")
    _check_devices("flash_train_fwd", q, k, v)
    D, DV = kernel_head_dims(d, dv)
    q, k, v = pad_head_dim(q, D), pad_head_dim(k, D), pad_head_dim(v, DV)
    out = _empty_rows(q, Nq, DV, q.dtype)
    lse = torch.empty(q.shape[:-1], dtype=torch.float32, device=q.device)
    _train_call("fod_flash_train_fwd", q, k, v, None, out, None, lse, None, scale,
                _dropout_args(seed, rate, nq_pad, nk_pad, heads))
    _kernels.launch_counts["flash_train_fwd"] += 1
    return out[..., :dv], lse


def flash_dq(q, k, v, do, lse, delta, seed: int, scale: float, rate: float, nq_pad: int,
             nk_pad: int, heads=None):
    """K5: dq of `flash_dq_plain`, laid out as q's outputs are (see
    `flash_train_fwd`); CPU tensors run the plain version, CUDA tensors
    launch `fod_flash_train_dq` or raise."""
    if q.is_cpu:
        return flash_dq_plain(q, k, v, do, lse, delta, seed, scale, rate, nq_pad, nk_pad, heads)
    _, _, Nq, _, d, dv = _train_kernel_args(q, k, v, "flash_dq")
    _check_grad_operands("flash_dq", q, v, do, lse, delta)
    _check_devices("flash_dq", q, k, v, do, lse, delta)
    D, DV = kernel_head_dims(d, dv)
    q, k, v, do = pad_head_dim(q, D), pad_head_dim(k, D), pad_head_dim(v, DV), pad_head_dim(do, DV)
    dq = _empty_rows(q, Nq, D, q.dtype)
    _train_call("fod_flash_train_dq", q, k, v, do, dq, None, lse, delta, scale,
                _dropout_args(seed, rate, nq_pad, nk_pad, heads))
    _kernels.launch_counts["flash_train_dq"] += 1
    return dq[..., :d]


def flash_dkv(q, k, v, do, lse, delta, seed: int, scale: float, rate: float, nq_pad: int,
              nk_pad: int, heads=None):
    """K6: (dk, dv) of `flash_dkv_plain`, laid out as `flash_train_fwd`'s
    outputs are; CPU tensors run the plain version, CUDA tensors launch
    `fod_flash_train_dkv` or raise."""
    if q.is_cpu:
        return flash_dkv_plain(q, k, v, do, lse, delta, seed, scale, rate, nq_pad, nk_pad, heads)
    _, _, _, Nk, d, dv = _train_kernel_args(q, k, v, "flash_dkv")
    _check_grad_operands("flash_dkv", q, v, do, lse, delta)
    _check_devices("flash_dkv", q, k, v, do, lse, delta)
    D, DV = kernel_head_dims(d, dv)
    q, k, v, do = pad_head_dim(q, D), pad_head_dim(k, D), pad_head_dim(v, DV), pad_head_dim(do, DV)
    dk, dvv = _empty_rows(k, Nk, D, k.dtype), _empty_rows(v, Nk, DV, v.dtype)
    _train_call("fod_flash_train_dkv", q, k, v, do, dk, dvv, lse, delta, scale,
                _dropout_args(seed, rate, nq_pad, nk_pad, heads))
    _kernels.launch_counts["flash_train_dkv"] += 1
    return dk[..., :d], dvv[..., :dv]


def _check_grad_operands(name, q, v, do, lse, delta):
    rows = q.shape[:-1]
    if do.shape != (*rows, v.shape[-1]) or do.dtype != q.dtype:
        raise ValueError(f"{name}: do {tuple(do.shape)} {do.dtype}")
    if lse.shape != rows or delta.shape != rows \
            or lse.dtype != torch.float32 or delta.dtype != torch.float32:
        raise ValueError(f"{name}: lse/delta must be {tuple(rows)} f32")


def flash_train_info(kernel: str, d: int, dv: int, dtype: torch.dtype, BH: int, Nq: int,
                     Nk: int) -> dict:
    """K4, K5 or K6's instantiation (`kernel`: a launch counter's name) on
    the current card: registers a thread, static and dynamic shared bytes a
    block, local (spill) bytes a thread, resident blocks an SM, and its
    launch at (BH, Nq, Nk): grid, threads a block, and the warps that split
    a query slab's keys. Launches nothing."""
    which = ("flash_train_fwd", "flash_train_dq", "flash_train_dkv").index(kernel)
    out = (ctypes.c_int * 9)()
    _kernels.call(TRAIN_NAME, "fod_flash_train_info", which, d, dv,
                  _kernels.DTYPE_CODES[dtype], BH, Nq, Nk, ctypes.addressof(out))
    keys = ("registers", "static_smem_bytes", "dynamic_smem_bytes", "local_bytes",
            "blocks_per_sm", "grid_x", "grid_y", "threads", "split")
    return dict(zip(keys, out))


def dropout_keep_mask_kernel(seed: int, BH: int, Nq: int, Nk: int, rate: float, nq_pad: int,
                             nk_pad: int, device, heads=None) -> torch.Tensor:
    """K7 on the card: the (BH, Nq, Nk) f32 keep-mask the kernels apply,
    written by `fod_dropout_keep_mask` (only to hold the device hash
    against `dropout_keep_mask` bit for bit); `heads` as K4's."""
    out = torch.empty((BH, Nq, Nk), dtype=torch.float32, device=device)
    _kernels.check_cuda_operands("dropout_keep_mask", out)
    _kernels.call(
        TRAIN_NAME, "fod_dropout_keep_mask", out.data_ptr(), BH, Nq, Nk,
        *_dropout_args(seed, rate, nq_pad, nk_pad, heads), _kernels.stream_of(out),
        device=out.device,
    )
    _kernels.launch_counts["dropout_keep_mask"] += 1
    return out


class FlashAttentionTrain(torch.autograd.Function):
    """softmax(q·kᵀ·scale) with dropout, times v, and its gradient, through
    K4 (forward) and K5/K6 (backward); δ = rowsum(do ⊙ out) is plain torch,
    as in the JAX package. q, k (B, H, N, d) or (BH, N, d), v (..., Nk, dv),
    any strides: the kernels read them in place and write their outputs in
    the (B, N, H, w) layout."""

    @staticmethod
    def forward(ctx, q, k, v, seed: int, scale: float, rate: float, nq_pad: int, nk_pad: int,
                heads=None):
        out, lse = flash_train_fwd(q, k, v, seed, scale, rate, nq_pad, nk_pad, heads)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (seed, scale, rate, nq_pad, nk_pad, heads)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        delta = (do.float() * out.float()).sum(dim=-1)
        dq = flash_dq(q, k, v, do, lse, delta, *ctx.args)
        dk, dv = flash_dkv(q, k, v, do, lse, delta, *ctx.args)
        return dq, dk, dv, None, None, None, None, None, None


def flash_attention_train(q, k, v, seed: int, scale: float, dropout_rate: float = 0.0,
                          block_q: int = 256, block_k: int = 512,
                          heads: Optional[Tuple[int, int, int]] = None) -> torch.Tensor:
    """Differentiable fused attention with in-kernel attention-weight
    dropout. q, k (B, H, N, d); v (B, H, Nk, dv), any strides (attend_heads
    passes transposed (B, N, H, d) views, which the kernels read in place);
    seed an int in [0, 2^31) (unused at rate 0). block_q/block_k are the JAX
    kernels' blocks, which set the dropout mask's geometry only. `heads`:
    (H_local, H, h0) when q holds H_local = q.shape[1] of a layer's H heads,
    from head h0 (tensor parallelism): the dropout mask is then that slice
    of the all-heads call's. Returns (B, H, Nq, dv), on the card a view of
    (B, Nq, H, dv) storage."""
    if heads is not None:
        h_local, h_full, h0 = heads
        if h_local != q.shape[1] or h0 < 0 or h0 + h_local > h_full:
            raise ValueError(f"heads {heads}: q holds {q.shape[1]} heads")
    nq_pad, nk_pad = train_shapes(q.shape[2], k.shape[2], block_q, block_k)
    return FlashAttentionTrain.apply(q, k, v, int(seed), float(scale), float(dropout_rate),
                                     nq_pad, nk_pad, heads)


def train_attention_cost(BH: int, Nq: int, Nk: int, d: int, dv: int, itemsize: int):
    """{kernel: (operations, bytes)} one call of K4, K5 and K6 needs at
    least: the products each computes (dropout and the exponentials not
    counted), each input read once and each output written once."""
    qk, pv = 2 * BH * Nq * Nk * d, 2 * BH * Nq * Nk * dv
    q_b, k_b = itemsize * BH * Nq * d, itemsize * BH * Nk * d
    v_b, o_b, row_b = itemsize * BH * Nk * dv, itemsize * BH * Nq * dv, 4 * BH * Nq
    return {
        # q·kᵀ, p·v; reads q, k, v; writes out, lse
        "flash_train_fwd": (qk + pv, q_b + k_b + v_b + o_b + row_b),
        # q·kᵀ, do·vᵀ, dlogits·k; reads q, k, v, do, lse, δ; writes dq
        "flash_train_dq": (2 * qk + pv, 2 * q_b + k_b + v_b + o_b + 2 * row_b),
        # q·kᵀ, do·vᵀ, pᵀ·do, dlogitsᵀ·q; reads q, k, v, do, lse, δ; writes dk, dv
        "flash_train_dkv": (2 * qk + 2 * pv, q_b + 2 * k_b + 2 * v_b + o_b + 2 * row_b),
    }
