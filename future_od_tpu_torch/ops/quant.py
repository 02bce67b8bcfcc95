"""Int8 post-training quantization for the backbone's convolutions (port of
future_od_tpu/ops/quant.py, with its names and its op order).

Scheme (standard conv PTQ):
  - weights: symmetric per-output-channel int8, the frozen-BN scale folded
    into the kernel before quantization;
  - activations: per-tensor int8 with a dynamic (abs-max) scale, or a scale
    from calibrated per-channel ranges (the `_static` forms);
  - SmoothQuant (alpha 0.5) scale migration per input channel;
  - post-ReLU inputs use a fixed zero point of 128 (`int8_conv_nonneg`),
    the stem's signed input the symmetric range (`int8_conv`);
  - the int8 x int8 convolution with int32 sums is K8
    (`ops/int8_conv.py::int8_conv_codes`, the op `fod::int8_conv`), whose
    epilogue dequantizes by `scale * ws[c]`, adds the bias and casts.

The activations' per-channel ranges and their quantization are K9
(`ops/int8_quantize.py`, the ops `fod::int8_channel_range` and
`fod::int8_quantize`): one pass over a convolution's input for its range
(a block's conv1 and downsample share it) and one that writes its codes.
The dynamic path takes its smoothing factors and its per-tensor range from
the per-channel ranges (`static_smooth_and_scale`), as the static path
takes them from calibrated ones. The rest (the smoothing factors, the
quantization of the weights) is plain torch on per-channel vectors and
weights, as XLA computes it in the JAX package. Rounding is half to even
(`torch.round`, as `jnp.round`). The
smoothing factors' square root is taken in float64 and rounded to f32 once:
torch's f32 `sqrt` on the CPU is not correctly rounded (about 0.7 % of
inputs come out 1 ulp off), and one factor off flips that channel's codes;
numpy and XLA round it correctly, and so does the float64 route.

The functions take NHWC activations and HWIO kernels, as the JAX functions
do. The optional `relu` of the conv functions (not in the JAX signatures)
applies relu in K8's epilogue; relu commutes with the final cast, so it
equals relu of the result.
"""
from __future__ import annotations

from typing import Mapping, Sequence, Tuple, Union

import torch

from future_od_tpu_torch.ops.int8_conv import (
    int8_conv_codes,
    pack_int8_weights,
    zero_point_correction,
)
from future_od_tpu_torch.ops.int8_quantize import QMAX, _amax, channel_range, quantize_codes


def _sqrt(t: torch.Tensor) -> torch.Tensor:
    """Correctly rounded f32 square root (see the module's docstring)."""
    return torch.sqrt(t.double()).float()


def _kernel_in_amax(kernel: torch.Tensor) -> torch.Tensor:
    """Per-input-channel kernel abs-max: every axis but the input one (-2)."""
    w32 = kernel.float()
    return torch.amax(w32.abs(), dim=tuple(i for i in range(kernel.ndim) if i != kernel.ndim - 2))


def smooth_factors(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Per-input-channel scale-migration factors m (SmoothQuant, alpha 0.5):
    m_c = sqrt(amax(x_c) / colmax(w_c)); dead channels (all-zero
    activations) keep m = 1."""
    return static_smooth_and_scale(channel_range(x), kernel)[0]


def quantize_weight_per_channel(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """HWIO kernel -> (int8 kernel, f32 per-output-channel scale), symmetric:
    q = round(w / s), s = max |w| over (H, W, I) per O."""
    w32 = w.float()
    amax = torch.amax(w32.abs(), dim=tuple(range(w.ndim - 1)))
    scale = torch.clamp_min(amax, 1e-12) / QMAX
    q = torch.clamp(torch.round(w32 / scale), -QMAX, QMAX).to(torch.int8)
    return q, scale


def quantize_act_per_tensor(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Activation tensor -> (int8 tensor, scalar f32 scale), dynamic abs-max
    symmetric quantization (the tensor's range: the max of its channels')."""
    scale = torch.clamp_min(_amax(channel_range(x.reshape(-1, 1))), 1e-12) / QMAX
    return quantize_codes(x, None, scale, zero_point=False), scale


def _pairs(padding) -> tuple:
    return tuple((int(p[0]), int(p[1])) for p in padding)


def _conv_nonneg_core(x32, scale, wq, ws, bias, strides, padding, dilation, out_dtype,
                      relu: bool = False, packed=None, m=None):
    """Shared zero-point-128 conv body (dynamic and static paths): quantize
    the smoothed input x32 / m (x32 itself without m) with the given
    per-tensor scale (K9), pad in the quantized domain with -128 (= x 0),
    the int8 conv with int32 sums, the per-channel zero-point correction,
    dequantize, bias (K8). `packed`: (K8's weights, zp) already made of
    wq."""
    q = quantize_codes(x32, m, scale, zero_point=True)
    w, zp = packed if packed is not None else (pack_int8_weights(wq), zero_point_correction(wq))
    return int8_conv_codes(q, w, zp, scale * ws, None if bias is None else bias.float(),
                           strides, _pairs(padding), dilation, -128, relu, out_dtype)


def _conv_signed_core(x32, scale, wq, ws, bias, strides, padding, dilation, out_dtype,
                      relu: bool = False, packed=None, m=None):
    """Shared symmetric-signed conv body (dynamic and static paths); zero
    padding is exact in the quantized domain (0 maps to q = 0)."""
    q = quantize_codes(x32, m, scale, zero_point=False)
    w = packed[0] if packed is not None else pack_int8_weights(wq)
    return int8_conv_codes(q, w, None, scale * ws, None if bias is None else bias.float(),
                           strides, _pairs(padding), dilation, 0, relu, out_dtype)


def _smoothed_weights(kernel, m):
    return quantize_weight_per_channel(kernel.float() * m[None, None, :, None])


def _dynamic_scale(x, kernel, qrange: float, x_range):
    """(m, per-tensor scale) of the dynamic path from the input's
    per-channel range (K9's range pass, or `x_range` when the caller has
    it). `static_smooth_and_scale` gives m by `smooth_factors`' formula and
    the per-tensor range as max_c(amax_c / m_c), which equals the range of
    x / m bit for bit: dividing by a positive constant and rounding are both
    monotone, so the largest |x_c| gives the largest |x_c| / m_c (on the
    zero-point path x >= 0, post-ReLU, and its max is its range)."""
    m, amax = static_smooth_and_scale(channel_range(x) if x_range is None else x_range, kernel)
    return m, torch.clamp_min(amax, 1e-12) / qrange


def int8_conv_nonneg(x, kernel, bias=None, strides: Sequence[int] = (1, 1),
                     padding=((0, 0), (0, 0)), dilation: Sequence[int] = (1, 1),
                     relu: bool = False, x_range=None) -> torch.Tensor:
    """int8 conv for non-negative (post-ReLU) NHWC inputs with the full 8-bit
    range recovered by a fixed zero point of 128: q = round(x/s) - 128 with
    s = max(x)/255, padded in the quantized domain with -128 (x = 0), so
    conv(x)/s == conv_valid(q_pad) + 128 * sum(w[c]) exactly. Output dtype
    follows x. `x_range`: `channel_range(x)` when the caller has it (a
    block's conv1 and downsample read the same x)."""
    m, scale = _dynamic_scale(x, kernel, 255.0, x_range)
    wq, ws = _smoothed_weights(kernel, m)
    return _conv_nonneg_core(x, scale, wq, ws, bias, strides, padding, dilation, x.dtype,
                             relu, m=m)


def int8_conv(x, kernel, bias=None, strides: Sequence[int] = (1, 1),
              padding=((0, 0), (0, 0)), dilation: Sequence[int] = (1, 1),
              relu: bool = False, x_range=None) -> torch.Tensor:
    """Float-in / float-out NHWC conv on the int8 path, symmetric (the stem's
    signed input). `kernel` is the effective HWIO kernel (frozen-BN scale
    folded in), `bias` the folded BN shift. Output dtype follows x."""
    m, scale = _dynamic_scale(x, kernel, QMAX, x_range)
    wq, ws = _smoothed_weights(kernel, m)
    return _conv_signed_core(x, scale, wq, ws, bias, strides, padding, dilation, x.dtype,
                             relu, m=m)


def observe_channel_amax(x: torch.Tensor, nonneg: bool) -> torch.Tensor:
    """Per-input-channel activation range, (C,) f32: the one statistic the
    static calibration stores per conv (K9's range pass: of x when nonneg,
    else of |x|)."""
    return channel_range(x, absolute=not nonneg)


def static_smooth_and_scale(amax_c: torch.Tensor, kernel: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(stored per-channel act range, effective kernel) -> (smoothing factors
    m, post-smoothing per-tensor act range), by `smooth_factors`' rule from
    the calibrated ranges. A bf16 range stays bf16 until the division, as
    jnp promotes it."""
    w_amax = _kernel_in_amax(kernel)
    m = _sqrt(torch.clamp_min(amax_c, 1e-12) / torch.clamp_min(w_amax, 1e-12))
    m = torch.where(amax_c > 0.0, m, torch.ones_like(m))
    return m, _amax(amax_c / m)


def _static_scale(amax: torch.Tensor, qrange: float) -> torch.Tensor:
    """Per-tensor scale from a calibrated range. A never-calibrated (zero)
    range falls back to scale 1 (plain round-to-integer: degraded, not
    saturated); for amax > 0 it is the dynamic path's max(amax, 1e-12) /
    qrange bit for bit."""
    return torch.where(amax > 0.0, torch.clamp_min(amax, 1e-12),
                       torch.full_like(amax, qrange)) / qrange


def assert_calibrated(ranges: Union[torch.nn.Module, Mapping[str, torch.Tensor]]) -> None:
    """Eager guard for the static-int8 path: raise ValueError if a stored
    range is still all zero (no calibration pass observed that conv, e.g.
    calibration ran under another FUTURE_OD_INT8_SKIP than inference).
    `ranges`: a model (its `*_amax` buffers) or a mapping name -> range."""
    if isinstance(ranges, torch.nn.Module):
        ranges = {n: b for n, b in ranges.named_buffers() if n.endswith("_amax")}
    dead = [name for name, t in ranges.items() if not bool((t > 0).any())]
    if dead:
        raise ValueError(
            f"static-int8 ranges are uncalibrated (all zero): {dead}; run a calibration "
            "pass (models/resnet.py::int8_calibration) with the same FUTURE_OD_INT8_SKIP "
            "setting inference will use")


def static_weights(kernel: torch.Tensor, amax_c: torch.Tensor, qrange: float):
    """What a static conv keeps between calls (its weights and ranges only):
    (m, scale, ws, (K8's weights, zp or None))."""
    m, amax = static_smooth_and_scale(amax_c, kernel)
    wq, ws = _smoothed_weights(kernel, m)
    zp = zero_point_correction(wq) if qrange == 255.0 else None
    return m, _static_scale(amax, qrange), ws, (pack_int8_weights(wq), zp)


def int8_conv_nonneg_static(x, kernel, amax_c, bias=None, strides: Sequence[int] = (1, 1),
                            padding=((0, 0), (0, 0)), dilation: Sequence[int] = (1, 1),
                            relu: bool = False, kept=None) -> torch.Tensor:
    """`int8_conv_nonneg` with calibrated ranges: no per-call activation
    reduction. Given amax_c equal to the input's true per-channel range it
    equals the dynamic path bit for bit (the same op order: x/m, then
    /scale). `kept`: `static_weights(kernel, amax_c, 255.0)` made before."""
    m, scale, ws, packed = kept if kept is not None else static_weights(kernel, amax_c, 255.0)
    return _conv_nonneg_core(x, scale, None, ws, bias, strides, padding, dilation, x.dtype,
                             relu, packed, m)


def int8_conv_static(x, kernel, amax_c, bias=None, strides: Sequence[int] = (1, 1),
                     padding=((0, 0), (0, 0)), dilation: Sequence[int] = (1, 1),
                     relu: bool = False, kept=None) -> torch.Tensor:
    """`int8_conv` (signed, the stem) with calibrated per-channel ranges.
    `kept`: `static_weights(kernel, amax_c, QMAX)` made before."""
    m, scale, ws, packed = kept if kept is not None else static_weights(kernel, amax_c, QMAX)
    return _conv_signed_core(x, scale, None, ws, bias, strides, padding, dilation, x.dtype,
                             relu, packed, m)
