"""The int8 activation quantizer (K9): `csrc/int8_quantize.cu` on the card.

The activation side of the int8 PTQ backbone's convolutions, in two entry
points over an NHWC f32 or bf16 tensor x:

- `channel_range(x, absolute=True)`: the per-channel max of |x| (or of x,
  `absolute=False`) over every other axis, at least 0 and 0 over an empty
  tensor, as a (C,) f32: `_amax(x.float().abs(), dims)`, the JAX package's
  `jnp.max(..., initial=0.0)`;
- `quantize_codes(x, m, scale, zero_point)`: the int8 codes
  `clamp(round((x.float() / m) / scale), 0, 255) - 128` (the zero-point path,
  post-ReLU inputs) or `clamp(round(... / scale), -127, 127)` (the signed
  path), each division rounded once, round half to even; `m` None skips the
  first division (an input already smoothed).

The JAX package has no Pallas kernel here: XLA fuses the same chain into its
int8 convolutions (`future_od_tpu/ops/quant.py:44-80, 91-93, 120, 157-158,
300-301`). Each is a `fod::` op (`torch.library`, kept by `torch.export`): on
CPU tensors the plain version below (the torch chain `ops/quant.py` ran
before the kernel), on CUDA tensors the kernel or an error. Both agree bit
for bit: a max of floats is exact in any order, and the kernel divides with
`__fdiv_rn` and rounds with `rintf`, as torch's CUDA division and
`torch.round` do.
"""
from __future__ import annotations

from typing import Optional

import torch

from future_od_tpu_torch.ops import _kernels

NAME = "int8_quantize"
RANGE, QUANTIZE = "int8_channel_range", "int8_quantize"  # the launch counters
QMAX = 127.0
MAX_CHANNELS = 12288  # the range's shared slots a block (48 KB)


def _amax(t: torch.Tensor, dims=None) -> torch.Tensor:
    """jnp.max(t, axis=dims, initial=0.0): the max over dims (all by
    default), at least 0, and 0 over an empty tensor."""
    dims = tuple(range(t.ndim)) if dims is None else tuple(dims)
    if t.numel() == 0:
        shape = [s for i, s in enumerate(t.shape) if i not in dims]
        return t.new_zeros(shape)
    return torch.clamp_min(torch.amax(t, dim=dims), 0.0)


def channel_range_plain(x: torch.Tensor, absolute: bool = True) -> torch.Tensor:
    """Plain version of K9's range."""
    x32 = x.float()
    return _amax(x32.abs() if absolute else x32, range(x.ndim - 1))


def quantize_codes_plain(x: torch.Tensor, m: Optional[torch.Tensor], scale: torch.Tensor,
                         zero_point: bool) -> torch.Tensor:
    """Plain version of K9's quantization."""
    x32 = x.float() if m is None else x.float() / m
    if zero_point:
        return (torch.clamp(torch.round(x32 / scale), 0.0, 255.0) - 128.0).to(torch.int8)
    return torch.clamp(torch.round(x32 / scale), -QMAX, QMAX).to(torch.int8)


def channel_range(x: torch.Tensor, absolute: bool = True) -> torch.Tensor:
    """The per-channel range of x, (C,) f32: the op `fod::int8_channel_range`
    (its CUDA implementation checks the operands; on another device, such as
    meta, they are checked before it)."""
    if x.device.type not in ("cpu", "cuda"):
        _check(RANGE, x)
    return _RANGE_OP(x, bool(absolute))


def quantize_codes(x: torch.Tensor, m: Optional[torch.Tensor], scale: torch.Tensor,
                   zero_point: bool) -> torch.Tensor:
    """The int8 codes of x: the op `fod::int8_quantize` (checked as
    `channel_range` is)."""
    if x.device.type not in ("cpu", "cuda"):
        _check(QUANTIZE, x, m, scale)
    return _QUANTIZE_OP(x, m, scale, bool(zero_point))


def _check(name: str, x, m=None, scale=None) -> None:
    """Raise unless K9 takes these operands: f32 or bf16 x with at least one
    axis and at most MAX_CHANNELS channels (the range), a (C,) f32 m or
    None, a one-element f32 scale, one CUDA device."""
    if x.dtype not in _kernels.DTYPE_CODES or x.dim() < 1:
        raise ValueError(f"{name}: want f32 or bf16 x with a channel axis, got {x.dtype} "
                         f"{tuple(x.shape)}")
    C = x.shape[-1]
    if name == RANGE and not 0 < C <= MAX_CHANNELS:
        raise ValueError(f"{name}: {C} channels; want 1 to {MAX_CHANNELS}")
    if m is not None and (m.dtype != torch.float32 or tuple(m.shape) != (C,)):
        raise ValueError(f"{name}: m must be ({C},) f32, got {m.dtype} {tuple(m.shape)}")
    if scale is not None and (scale.dtype != torch.float32 or scale.numel() != 1):
        raise ValueError(f"{name}: scale must be one f32, got {scale.dtype} "
                         f"{tuple(scale.shape)}")
    _kernels.check_cuda_device(name, *(t for t in (x, m, scale) if t is not None))


def _flat(name: str, x: torch.Tensor) -> torch.Tensor:
    x = x.contiguous()
    if x.data_ptr() % 16:
        raise ValueError(f"{name}: x must be 16-byte aligned")
    return x


def _range_cuda(x, absolute):
    _check(RANGE, x)
    out = torch.empty(x.shape[-1], dtype=torch.float32, device=x.device)  # zeroed by the call
    if not x.numel():
        return out.zero_()
    x = _flat(RANGE, x)
    _kernels.call(NAME, "fod_int8_channel_range", x.data_ptr(), out.data_ptr(), x.numel(),
                  x.shape[-1], int(absolute), _kernels.DTYPE_CODES[x.dtype],
                  _kernels.stream_of(x), device=x.device)
    _kernels.launch_counts[RANGE] += 1
    return out


def _quantize_cuda(x, m, scale, zero_point):
    _check(QUANTIZE, x, m, scale)
    out = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    if x.numel():
        x = _flat(QUANTIZE, x)
        m = None if m is None else m.contiguous()
        _kernels.call(NAME, "fod_int8_quantize", x.data_ptr(), None if m is None else m.data_ptr(),
                      scale.data_ptr(), out.data_ptr(), x.numel(), x.shape[-1], int(zero_point),
                      _kernels.DTYPE_CODES[x.dtype], _kernels.stream_of(x), device=x.device)
        _kernels.launch_counts[QUANTIZE] += 1
    return out


def _range_fake(x, absolute):
    return x.new_empty((x.shape[-1],), dtype=torch.float32)


def _quantize_fake(x, m, scale, zero_point):
    return x.new_empty(x.shape, dtype=torch.int8)


# fod::int8_channel_range and fod::int8_quantize: CPU the plain versions, CUDA the
# launches, fakes for tracing (torch.library.Library, as the other fod:: ops).
_LIB = torch.library.Library("fod", "FRAGMENT")  # the ops live as long as it
_LIB.define("int8_channel_range(Tensor x, bool absolute) -> Tensor")
_LIB.define("int8_quantize(Tensor x, Tensor? m, Tensor scale, bool zero_point) -> Tensor")
_LIB.impl("int8_channel_range", channel_range_plain, "CPU")
_LIB.impl("int8_channel_range", _range_cuda, "CUDA")
_LIB.impl("int8_quantize", quantize_codes_plain, "CPU")
_LIB.impl("int8_quantize", _quantize_cuda, "CUDA")
torch.library.register_fake("fod::int8_channel_range", _range_fake, lib=_LIB)
torch.library.register_fake("fod::int8_quantize", _quantize_fake, lib=_LIB)
_RANGE_OP = torch.ops.fod.int8_channel_range.default
_QUANTIZE_OP = torch.ops.fod.int8_quantize.default


def range_cost(x: torch.Tensor):
    """(operations, bytes) one range call needs at least: x read once, the
    (C,) f32 written once; one comparison an element."""
    return x.numel(), x.numel() * x.element_size() + 4 * x.shape[-1]


def quantize_cost(x: torch.Tensor, divisions: int = 2):
    """(operations, bytes) one quantization needs at least: x read once, m
    (C,) f32 and the scale read once, one int8 code written an element; two
    divisions, a rounding and a clamp an element."""
    return (divisions + 2) * x.numel(), (x.numel() * (x.element_size() + 1)
                                         + 4 * x.shape[-1] + 4)
