"""Fused ResNet blocks (port of future_od_tpu/ops/fused_resnet.py).

- `fused_bottleneck` launches `csrc/fused_bottleneck.cu`, which replaces the
  Pallas TPU kernel `_bottleneck_kernel`: a stride-1 bottleneck
  1x1 -> 3x3 -> 1x1 (+ identity or 1x1 downsample residual) with BN folded
  into the weights and f32 biases, intermediates kept on chip.
- `fused_stem` launches `csrc/fused_stem.cu`, which replaces `_stem_kernel`:
  the 7x7/2 stem conv as a 4x4/1 conv over 2x2 space-to-depth input, + bias,
  ReLU and the 3x3/2 max pool (padding -inf), the conv output kept on chip.

Both take NHWC tensors and HWIO / (in, out) weights as the JAX functions do.
On CPU tensors they run `bottleneck_plain` / `stem_plain`, the plain versions
of the same functions; on CUDA tensors they launch the kernel or raise.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from future_od_tpu_torch.ops import _kernels

BOTTLENECK = "fused_bottleneck"
STEM = "fused_stem"
BOTTLENECK_CMIDS = (64, 128)  # widths the kernel is instantiated for
BOTTLENECK_COUT_STEP = 128  # the kernel writes output channels 128 at a time
BOTTLENECK_CIN_STEP = 16  # its reduction slice
STEM_CIN, STEM_COUT = 12, 64
STEM_TAPS = 7 * 7 * 3  # taps of the 7x7/2 conv; the s2d 4x4 kernel's other 45 are zeros


def _conv1x1_weight(w: torch.Tensor) -> torch.Tensor:
    """(in, out) matrix -> OIHW 1x1 conv weight."""
    return w.t()[:, :, None, None]


def bottleneck_plain(x, w1, b1, w2, b2, w3, b3, wd=None, bd=None) -> torch.Tensor:
    """Plain version of `fused_bottleneck`: three (four) f32 convolutions of
    the values the kernel reads (weights in x's dtype, f32 biases), with the
    two intermediates rounded to x's dtype and the output rounded once, where
    the kernel (and the TPU kernel) round them. x: (B, H, W, cin) ->
    (B, H, W, cout)."""
    dt = x.dtype

    def stored(t):  # t's value after a round trip through x's dtype
        return t.to(dt).float()

    xc = x.float().permute(0, 3, 1, 2)
    h = stored(F.relu(F.conv2d(xc, _conv1x1_weight(stored(w1)), b1.float())))
    h = stored(F.relu(F.conv2d(h, stored(w2).permute(3, 2, 0, 1), b2.float(), padding=1)))
    h = F.conv2d(h, _conv1x1_weight(stored(w3)), b3.float())
    res = xc if wd is None else F.conv2d(xc, _conv1x1_weight(stored(wd)), bd.float())
    return F.relu(h + res).to(dt).permute(0, 2, 3, 1)


def fused_bottleneck(
    x: torch.Tensor,  # (B, H, W, cin)
    w1: torch.Tensor,  # (cin, cmid)  BN-folded
    b1: torch.Tensor,  # (cmid,)
    w2: torch.Tensor,  # (3, 3, cmid, cmid) HWIO
    b2: torch.Tensor,
    w3: torch.Tensor,  # (cmid, cout)
    b3: torch.Tensor,
    wd: Optional[torch.Tensor] = None,  # (cin, cout) downsample, or None
    bd: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """relu(conv1x1(relu(conv3x3(relu(conv1x1(x))))) + residual), stride 1,
    NHWC in and out, in x's dtype."""
    if x.device.type == "cpu":
        return bottleneck_plain(x, w1, b1, w2, b2, w3, b3, wd, bd)
    B, H, W, cin = x.shape
    cmid, cout = w1.shape[1], w3.shape[1]
    if (
        cmid not in BOTTLENECK_CMIDS
        or cin % BOTTLENECK_CIN_STEP
        or cout % BOTTLENECK_COUT_STEP
        or w1.shape != (cin, cmid)
        or w2.shape != (3, 3, cmid, cmid)
        or w3.shape != (cmid, cout)
        or (wd is None) != (bd is None)
        or (wd is None and cin != cout)
        or (wd is not None and wd.shape != (cin, cout))
    ):
        raise ValueError(
            f"{BOTTLENECK}: unsupported shapes x {tuple(x.shape)} w1 {tuple(w1.shape)} "
            f"w3 {tuple(w3.shape)} (cmid in {BOTTLENECK_CMIDS}, cin % "
            f"{BOTTLENECK_CIN_STEP} == 0, cout % {BOTTLENECK_COUT_STEP} == 0)"
        )
    if x.dtype not in _kernels.DTYPE_CODES:
        raise ValueError(f"{BOTTLENECK}: dtype {x.dtype}; want f32 or bf16")
    dt = x.dtype
    x = x.contiguous()
    w1, w3 = w1.to(dt).contiguous(), w3.to(dt).contiguous()
    w2 = w2.to(dt).reshape(9 * cmid, cmid).contiguous()
    b1, b2, b3 = (b.float().contiguous() for b in (b1, b2, b3))
    ops = [x, w1, b1, w2, b2, w3, b3]
    if wd is not None:
        wd, bd = wd.to(dt).contiguous(), bd.float().contiguous()
        ops += [wd, bd]
    _kernels.check_cuda_operands(BOTTLENECK, *ops)
    out = torch.empty((B, H, W, cout), dtype=dt, device=x.device)
    _kernels.call(
        BOTTLENECK, "fod_fused_bottleneck",
        x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
        w3.data_ptr(), b3.data_ptr(),
        None if wd is None else wd.data_ptr(), None if bd is None else bd.data_ptr(),
        out.data_ptr(), B, H, W, cin, cmid, cout,
        _kernels.DTYPE_CODES[dt], _kernels.stream_of(x),
    )
    _kernels.launch_counts[BOTTLENECK] += 1
    return out


def stem_plain(x_s2d, w4, bias) -> torch.Tensor:
    """Plain version of `fused_stem`, in f32 on the values the kernel reads,
    rounded once to x's dtype at the end as the kernel rounds: zero-pad the
    s2d input by (2, 1) in H and W, conv with w4 + bias, ReLU,
    max_pool2d(3, 2, 1) (which pads with -inf).
    x_s2d: (B, Hc, Wc, 12) -> (B, Hc/2, Wc/2, 64)."""
    dt = x_s2d.dtype
    xc = F.pad(x_s2d.float().permute(0, 3, 1, 2), (2, 1, 2, 1))
    y = F.relu(F.conv2d(xc, w4.to(dt).float().permute(3, 2, 0, 1), bias.float()))
    return F.max_pool2d(y, 3, 2, 1).to(dt).permute(0, 2, 3, 1)


def fused_stem(
    x_s2d: torch.Tensor,  # (B, Hc, Wc, 12) space-to-depth(2) input
    w4: torch.Tensor,  # (4, 4, 12, 64) s2d stem kernel, BN-folded
    bias: torch.Tensor,  # (64,)
) -> torch.Tensor:
    """relu(conv4x4/1 pad (2,1)(x_s2d) + bias) -> maxpool3x3/2 pad 1, NHWC,
    in x's dtype. Equals the 7x7/2 stem on the unpacked image
    (models/resnet.py::stem_weights_to_space_to_depth)."""
    if x_s2d.device.type == "cpu":
        return stem_plain(x_s2d, w4, bias)
    B, Hc, Wc, C = x_s2d.shape
    if C != STEM_CIN or Hc % 2 or Wc % 2 or w4.shape != (4, 4, STEM_CIN, STEM_COUT):
        raise ValueError(f"{STEM}: unsupported shapes x {tuple(x_s2d.shape)} w4 {tuple(w4.shape)}")
    if x_s2d.dtype not in _kernels.DTYPE_CODES:
        raise ValueError(f"{STEM}: dtype {x_s2d.dtype}; want f32 or bf16")
    dt = x_s2d.dtype
    x_s2d = x_s2d.contiguous()
    w = w4.to(dt).contiguous()
    b = bias.float().contiguous()
    _kernels.check_cuda_operands(STEM, x_s2d, w, b)
    out = torch.empty((B, Hc // 2, Wc // 2, STEM_COUT), dtype=dt, device=x_s2d.device)
    _kernels.call(
        STEM, "fod_fused_stem",
        x_s2d.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), B, Hc, Wc,
        _kernels.DTYPE_CODES[dt], _kernels.stream_of(x_s2d),
    )
    _kernels.launch_counts[STEM] += 1
    return out


def bottleneck_cost(B, H, W, cin, cmid, cout, downsample: bool, itemsize: int):
    """(operations, bytes) one `fused_bottleneck` call needs at least: its
    four products, x read once, out written once, weights read once."""
    per_px = cin * cmid + 9 * cmid * cmid + cmid * cout + (cin * cout if downsample else 0)
    ops = 2 * B * H * W * per_px
    weights = per_px * itemsize + 4 * (2 * cmid + cout * (2 if downsample else 1))
    nbytes = itemsize * B * H * W * (cin + cout) + weights
    return ops, nbytes


def stem_cost(B, Hc, Wc, itemsize: int):
    """(operations, bytes) one `fused_stem` call needs at least: the 7x7/2
    conv's products (not the s2d kernel's structural zeros), the input and
    the s2d weights read once, the pooled output written once."""
    k = 16 * STEM_CIN
    ops = 2 * B * Hc * Wc * STEM_TAPS * STEM_COUT
    nbytes = itemsize * (B * Hc * Wc * STEM_CIN + B * (Hc // 2) * (Wc // 2) * STEM_COUT
                         + k * STEM_COUT) + 4 * STEM_COUT
    return ops, nbytes
