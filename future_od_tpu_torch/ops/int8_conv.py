"""The int8 convolution of int8 codes (K8): `csrc/int8_conv.cu` on the card.

The JAX package computes the int8 PTQ backbone's convolutions with XLA
(`future_od_tpu/ops/quant.py:99,121`: `lax.conv_general_dilated` of int8
operands with `preferred_element_type=int32`), not with a Pallas kernel. No
PyTorch call computes an int8 convolution on CUDA, so the port has this
kernel of its own: an implicit-GEMM NHWC convolution of int8 codes by int8
HWIO weights on the tensor cores (`wgmma` m64nNk32, int32 sums; the
stride-1 1x1s fed by TMA in a persistent kernel, the others by a cp.async
gather; see the source's notes), any kernel size, stride, dilation and
asymmetric padding, the padding in the quantized domain (`pad_value`: -128
for the zero-point path, 0 for the signed one), and the epilogue of
`ops/quant.py`'s cores:

    out = cast((acc + zp[c]) as f32 * sw[c] + bias[c]), then relu if asked

with `sw = scale * ws` (the activation scale times the weights' per-channel
scales) and `zp = 128 * sum(wq[..., c])` (None on the signed path). Each
product and sum is rounded once, as XLA rounds them; relu commutes with the
cast, so `relu=True` equals relu after the call.

The weights go in packed (`pack_int8_weights`): (Cout, Kp) int8, a row an
output channel with its K = KH*KW*Cin values in (kh, kw, ci) order, zero
padded to Kp, a multiple of 32 (the mma's k-step: the 7x7 stem's K = 147
becomes 160).

`int8_conv_codes` is the op `fod::int8_conv` (`torch.library`, kept as one
node by `torch.export`): on CPU tensors it runs `int8_conv_plain`, on CUDA
tensors it launches the kernel or raises. The plain version convolves the
codes in float64 (every product and partial sum is an integer below 2^53,
so it is exact: layer4's 3x3 reaches |acc| = 128*127*4608 = 7.49e7, above
f32's 2^24) and runs the same epilogue.
"""
from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Optional, Sequence

import torch
import torch.nn.functional as F

from future_od_tpu_torch.ops import _kernels

NAME = "int8_conv"
K_STEP = 32  # the mma's k-step in int8 values: Kp is a multiple of it
COUT_STEP = 64  # Cout a multiple of it (a tile owns 128 channels, or 64)
VARIANTS = {"byte gather": 0, "vector gather": 1, "tma": 2}  # int8_conv_info's variants


class Int8ConvWeights(NamedTuple):
    """A convolution's int8 weights as K8 reads them (`pack_int8_weights`)."""

    wt: torch.Tensor  # (Cout, Kp) int8, rows (kh, kw, ci), zero padded
    kernel_hw: tuple  # (KH, KW)


def pack_int8_weights(wq: torch.Tensor) -> Int8ConvWeights:
    """HWIO int8 weights -> K8's (Cout, Kp) layout (`Int8ConvWeights`)."""
    KH, KW, Cin, Cout = wq.shape
    K = KH * KW * Cin
    Kp = -(-K // K_STEP) * K_STEP
    wt = wq.reshape(K, Cout).t()
    if Kp != K:
        wt = F.pad(wt, (0, Kp - K))
    return Int8ConvWeights(wt.contiguous(), (KH, KW))


def zero_point_correction(wq: torch.Tensor) -> torch.Tensor:
    """128 * the sum of each output channel's int8 weights, int32: the
    zero-point path's per-channel constant (quant.py's `zp_corr`)."""
    return 128 * wq.to(torch.int32).sum(dim=tuple(range(wq.ndim - 1)), dtype=torch.int32)


def output_hw(H: int, W: int, kernel_hw, strides, padding, dilation):
    """The output's (Ho, Wo) for padding ((top, bottom), (left, right))."""
    (pt, pb), (pl, pr) = padding
    Ho = (H + pt + pb - dilation[0] * (kernel_hw[0] - 1) - 1) // strides[0] + 1
    Wo = (W + pl + pr - dilation[1] * (kernel_hw[1] - 1) - 1) // strides[1] + 1
    return Ho, Wo


def int8_conv_plain(q, wt, zp, sw, bias, kernel_hw, strides, padding, dilation,
                    pad_value: int, relu: bool, out_dtype) -> torch.Tensor:
    """Plain version of K8: q (B, H, W, Cin) int8 codes padded by `padding`
    ((top, bottom), (left, right)) with `pad_value`, convolved with the
    packed weights wt (Cout, Kp) in float64 (exact), then the epilogue.
    Returns (B, Ho, Wo, Cout) in out_dtype."""
    KH, KW = kernel_hw
    Cin, Cout = q.shape[3], wt.shape[0]
    w = wt[:, :KH * KW * Cin].reshape(Cout, KH, KW, Cin).permute(0, 3, 1, 2).double()
    (pt, pb), (pl, pr) = padding
    x = F.pad(q.permute(0, 3, 1, 2).double(), (pl, pr, pt, pb), value=float(pad_value))
    acc = F.conv2d(x, w, stride=tuple(strides), dilation=tuple(dilation)).to(torch.int32)
    if zp is not None:
        acc = acc + zp[:, None, None]
    out = acc.float() * sw[:, None, None]
    if bias is not None:
        out = out + bias.float()[:, None, None]
    out = out.to(out_dtype)
    if relu:
        out = torch.relu(out)
    return out.permute(0, 2, 3, 1).contiguous()


def _padding4(padding) -> list:
    (pt, pb), (pl, pr) = padding
    return [int(pt), int(pb), int(pl), int(pr)]


def int8_conv_codes(q: torch.Tensor, w: Int8ConvWeights, zp: Optional[torch.Tensor],
                    sw: torch.Tensor, bias: Optional[torch.Tensor], strides: Sequence[int],
                    padding, dilation: Sequence[int], pad_value: int, relu: bool,
                    out_dtype: torch.dtype) -> torch.Tensor:
    """The convolution of int8 codes q (B, H, W, Cin) by packed int8 weights,
    with the epilogue above: the op `fod::int8_conv` (its CUDA
    implementation checks the operands; on another device, such as meta,
    they are checked before it)."""
    if q.device.type not in ("cpu", "cuda"):
        _check(q, w.wt, zp, sw, bias, out_dtype)
    return _INT8_CONV(q, w.wt, zp, sw, bias, list(w.kernel_hw), list(strides),
                      _padding4(padding), list(dilation), int(pad_value), bool(relu), out_dtype)


def _check(q, wt, zp, sw, bias, out_dtype) -> None:
    """Raise unless K8 takes these operands: int8 codes and weights, Cout a
    multiple of COUT_STEP, per-channel f32 scales (int32 zero points), f32
    or bf16 out, one CUDA device."""
    Cout = wt.shape[0]
    if q.dtype != torch.int8 or wt.dtype != torch.int8 or wt.dim() != 2 or wt.shape[1] % K_STEP:
        raise ValueError(f"{NAME}: want int8 codes and (Cout, Kp % {K_STEP} == 0) int8 "
                         f"weights, got {q.dtype} {tuple(q.shape)}, {wt.dtype} "
                         f"{tuple(wt.shape)}")
    if Cout % COUT_STEP or q.dim() != 4:
        raise ValueError(f"{NAME}: Cout {Cout} must be a multiple of {COUT_STEP}")
    if sw.dtype != torch.float32 or sw.shape != (Cout,):
        raise ValueError(f"{NAME}: sw must be ({Cout},) f32")
    if zp is not None and (zp.dtype != torch.int32 or zp.shape != (Cout,)):
        raise ValueError(f"{NAME}: zp must be ({Cout},) int32")
    if bias is not None and (bias.dtype != torch.float32 or bias.shape != (Cout,)):
        raise ValueError(f"{NAME}: bias must be ({Cout},) f32")
    if out_dtype not in _kernels.DTYPE_CODES:
        raise ValueError(f"{NAME}: out dtype {out_dtype}; want f32 or bf16")
    _kernels.check_cuda_device(NAME, *(t for t in (q, wt, zp, sw, bias) if t is not None))


def _geometry(q, kernel_hw, stride, padding, dilation):
    """((Ho, Wo), padding as ((top, bottom), (left, right))) of the op's
    flat padding."""
    pad = ((padding[0], padding[1]), (padding[2], padding[3]))
    return output_hw(q.shape[1], q.shape[2], kernel_hw, stride, pad, dilation), pad


def _int8_conv_plain(q, wt, zp, sw, bias, kernel_hw, stride, padding, dilation, pad_value,
                     relu, out_dtype):
    _, pad = _geometry(q, kernel_hw, stride, padding, dilation)
    return int8_conv_plain(q, wt, zp, sw, bias, kernel_hw, stride, pad, dilation, pad_value,
                           relu, out_dtype)


def _int8_conv_fake(q, wt, zp, sw, bias, kernel_hw, stride, padding, dilation, pad_value,
                    relu, out_dtype):
    (Ho, Wo), _ = _geometry(q, kernel_hw, stride, padding, dilation)
    return q.new_empty((q.shape[0], Ho, Wo, wt.shape[0]), dtype=out_dtype)


def _int8_conv_cuda(q, wt, zp, sw, bias, kernel_hw, stride, padding, dilation, pad_value,
                    relu, out_dtype):
    _check(q, wt, zp, sw, bias, out_dtype)
    (Ho, Wo), _ = _geometry(q, kernel_hw, stride, padding, dilation)
    B, H, W, Cin = q.shape
    Cout, Kp = wt.shape
    KH, KW = kernel_hw
    if Kp != -(-KH * KW * Cin // K_STEP) * K_STEP or Ho <= 0 or Wo <= 0:
        raise ValueError(f"{NAME}: weights (Cout, {Kp}) do not fit a {KH}x{KW} kernel over "
                         f"{Cin} channels, or the output is empty")
    q = q.contiguous()
    ops = [t for t in (q, wt, zp, sw, bias) if t is not None]
    _kernels.check_cuda_operands(NAME, *ops)
    if q.data_ptr() % 16 or wt.data_ptr() % 16:
        raise ValueError(f"{NAME}: the codes and the weights must be 16-byte aligned")
    out = torch.empty((B, Ho, Wo, Cout), dtype=out_dtype, device=q.device)
    if out.numel():
        _kernels.call(
            NAME, "fod_int8_conv",
            q.data_ptr(), wt.data_ptr(), None if zp is None else zp.data_ptr(), sw.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr(),
            B, H, W, Cin, Ho, Wo, Cout, KH, KW, stride[0], stride[1], padding[0],
            padding[2], dilation[0], dilation[1], Kp, int(pad_value), int(relu),
            _kernels.DTYPE_CODES[out_dtype], _kernels.stream_of(q),
            device=q.device,
        )
        _kernels.launch_counts[NAME] += 1
    return out


# fod::int8_conv: CPU the plain version, CUDA the launch, a fake for tracing
# (torch.library.Library, as the other fod:: ops).
_LIB = torch.library.Library("fod", "FRAGMENT")  # the op lives as long as it
_LIB.define("int8_conv(Tensor q, Tensor wt, Tensor? zp, Tensor sw, Tensor? bias, "
            "int[] kernel_hw, int[] stride, int[] padding, int[] dilation, int pad_value, "
            "bool relu, ScalarType out_dtype) -> Tensor")
_LIB.impl("int8_conv", _int8_conv_plain, "CPU")
_LIB.impl("int8_conv", _int8_conv_cuda, "CUDA")
torch.library.register_fake("fod::int8_conv", _int8_conv_fake, lib=_LIB)
_INT8_CONV = torch.ops.fod.int8_conv.default


def int8_conv_info(dtype: torch.dtype, variant: str, bn: int) -> Dict[str, int]:
    """The kernel instantiation's resources on the current card (`variant`,
    a key of VARIANTS: the TMA kernel of the stride-1 1x1s, the 16-byte
    gather taken when Cin % 16 == 0, or the byte gather of the stems; `bn`
    the tile's 64 or 128 channels): registers a thread, static and dynamic
    shared bytes a block, local (spill) bytes a thread, resident blocks an
    SM. Launches nothing."""
    out = (ctypes.c_int * 5)()
    _kernels.call(NAME, "fod_int8_conv_info", _kernels.DTYPE_CODES[dtype], VARIANTS[variant],
                  int(bn), ctypes.addressof(out))
    keys = ("registers", "static_smem_bytes", "dynamic_smem_bytes", "local_bytes",
            "blocks_per_sm")
    return dict(zip(keys, out))


def int8_conv_cost(B: int, H: int, W: int, Cin: int, Cout: int, kernel_hw, strides, padding,
                   dilation, out_itemsize: int):
    """(operations, bytes) one K8 call needs at least: 2 * KH*KW*Cin per
    output element (the unpadded K), the codes that some window reads (a
    quarter of the input for a 1x1/2 convolution) and the int8 weights read
    once, the per-channel vectors, and the output written once."""
    Ho, Wo = output_hw(H, W, kernel_hw, strides, padding, dilation)
    K = kernel_hw[0] * kernel_hw[1] * Cin
    ops = 2 * B * Ho * Wo * Cout * K
    rows = _touched(H, kernel_hw[0], strides[0], dilation[0], padding[0][0], Ho)
    cols = _touched(W, kernel_hw[1], strides[1], dilation[1], padding[1][0], Wo)
    nbytes = B * rows * cols * Cin + K * Cout + 12 * Cout + out_itemsize * B * Ho * Wo * Cout
    return ops, nbytes


def _touched(size: int, kernel: int, stride: int, dilation: int, pad_lo: int, out: int) -> int:
    """How many of an input axis's `size` positions the `out` windows read."""
    read = {o * stride + j * dilation - pad_lo for o in range(out) for j in range(kernel)}
    return len(read & set(range(size)))
