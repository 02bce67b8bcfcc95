"""ResNet backbone with frozen BatchNorm (port of future_od_tpu/models/resnet.py).

torchvision-v1 topology and parameter names (`conv1`, `bn1`,
`layer{s}.{b}.conv{i}`, `layer{s}.{b}.downsample.{0,1}`), FrozenBatchNorm2d
semantics (fixed statistics + affine, eps 1e-5), optional layer4 dilation
whose block 0 keeps dilation 1, and a 1x1 `input_proj` to the transformer
width. The public interface is NHWC; inside, tensors are NCHW in the
channels_last memory format, so NHWC views cost nothing.

Environment gates (names and semantics of the JAX package, read at each
forward; the two fused ones in inference only):
- FUTURE_OD_FUSED_RESNET=1: stride-1, dilation-1 blocks of the stages listed
  in FUTURE_OD_FUSE_STAGES (default "01", i.e. layer1 and layer2) whose input
  height is a multiple of 8 run the fused bottleneck kernel;
- FUTURE_OD_FUSED_STEM=1 (with FUTURE_OD_FUSED_RESNET=1): the stem runs the
  fused stem kernel over space-to-depth input when the incoming video's
  H % 32 == 0 and W % 4 == 0 (its stored dims: a host-packed video's are
  halved);
- FUTURE_OD_S2D_STEM=1: a 7x7 model computes its stem as the exactly
  equivalent 4x4/1 conv over space_to_depth(x), the weights transformed by
  stem_weights_to_space_to_depth.
The fused gates fold frozen BN into the conv weights and biases as the JAX
package does; a bottleneck and the stem keep their folded, packed weights
until their parameters or buffers change (`Bottleneck.fused_weights`,
`ResNet.fused_stem_weights`).

The int8 PTQ backbone (`int8`, and `int8_static` for calibrated ranges;
ops/quant.py, every convolution on K8) runs in inference only (not
`self.training`, JAX's `deterministic`), after the gates above as in the
JAX package: a block the fused gate takes and the fused stem run before
int8, and FUTURE_OD_S2D_STEM=1 keeps the stem float. FUTURE_OD_INT8_SKIP, a
comma list of "stem" and stage indices "1".."4", keeps those in float. A
block's convolutions take the zero-point path on BN-folded kernels (k * s,
bias t); the stem is signed (7x7/2 pad 3, or the s2d 4x4 with pad (2, 1))
with relu and the max pool after it and no bn1. With `int8_static` each
int8 convolution has a per-input-channel range buffer, `<conv>_amax` (the
JAX "quant" collection: `conv1_amax` .. `conv3_amax`,
`downsample_conv_amax` a block, `conv1_amax` on the trunk for the stem).
As JAX creates these leaves at init, the gates at construction decide
which exist: none on a block FUTURE_OD_INT8_SKIP names, none on a block the
fused gate takes (its input height assumed a multiple of 8, as at every
configuration whose height is a multiple of 64) and none for the stem
under the fused stem gate; a static convolution without its range raises.
Under `int8_calibration(model)` a forward runs the dynamic
path and raises each range to the running max of its conv's input (|x| for
the stem); otherwise the static convolutions quantize with the stored
ranges, their weights kept until the weights or ranges change.

`space_to_depth` builds the stem with the s2d-format (4, 4, 12, 64) kernel
(`conv1` is a 12 -> 64 4x4 conv): a 12-channel (host-packed, (di, dj, c)
order; data/loader.py::host_space_to_depth) video goes in as it is, a
3-channel one is packed on the device first.

`freeze_stem` is the stem+layer1 freeze cut: those parameters never train
(requires_grad False) and, in training, the stem and layer1 run under
torch.no_grad(), so no graph is built below the cut — the counterpart of the
JAX package's stop_gradient after layer1.
"""
from __future__ import annotations

import contextlib
import math
import os

import torch
import torch.nn.functional as F
from torch import nn

from future_od_tpu_torch.ops import quant
from future_od_tpu_torch.ops.fused_resnet import (
    BottleneckWeights,
    StemWeights,
    fused_bottleneck_packed,
    fused_stem_packed,
    pack_bottleneck,
    pack_stem,
)

# ImageNet statistics for the uint8 ingestion path (device_normalize).
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

STAGE_BLOCKS = {
    "resnet50": (3, 4, 6, 3),
    "resnet101": (3, 4, 23, 3),
}


def device_normalize(x: torch.Tensor, out_dtype) -> torch.Tensor:
    """uint8 video -> normalized float on the device, in the host path's op
    order. Accepts packed layouts (3, 12 or 48 channels, (di, dj, c) order)."""
    reps = x.shape[-1] // 3
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=x.device).repeat(reps)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=x.device).repeat(reps)
    return ((x.float() / 255.0 - mean) / std).to(out_dtype)


def fused_resnet_allowed() -> bool:
    """The fused bottleneck gate (opt-in FUTURE_OD_FUSED_RESNET=1)."""
    return os.environ.get("FUTURE_OD_FUSED_RESNET", "0") == "1"


def fused_stem_allowed() -> bool:
    """The fused stem gate (opt-in FUTURE_OD_FUSED_STEM=1 with
    FUTURE_OD_FUSED_RESNET=1)."""
    return os.environ.get("FUTURE_OD_FUSED_STEM", "0") == "1" and fused_resnet_allowed()


def int8_skip() -> set:
    """FUTURE_OD_INT8_SKIP's entries: "stem" and stage indices "1".."4" kept
    in float under int8."""
    return {t for t in os.environ.get("FUTURE_OD_INT8_SKIP", "").split(",") if t}


@contextlib.contextmanager
def int8_calibration(model: nn.Module):
    """Within it, forwards of `model`'s static-int8 trunks run the dynamic
    int8 path and raise each `<conv>_amax` range to the running max of its
    input (the JAX package's mutable-"quant" apply). Run it in inference
    (e.g. through `make_inference_fn`) on the batches to calibrate on."""
    modules = [m for m in model.modules() if isinstance(m, (Bottleneck, ResNet))]
    for m in modules:
        m.calibrating = True
    try:
        yield model
    finally:
        for m in modules:
            m.calibrating = False


def _int8_conv(module: nn.Module, name: str, x, conv: nn.Conv2d, bn, static: bool,
               nonneg: bool, relu: bool, x_range=None, **geometry):
    """One int8 convolution of the trunk on NHWC x: conv's kernel with bn
    folded in (k * s, bias t), by ops/quant.py's dynamic or static path
    (`static`: the module's `<name>_amax` range; its weights kept on the
    module until conv's or bn's tensors or the range change). Under
    calibration the dynamic path runs and the range takes the running max
    of x (`nonneg`: x, else |x|). `x_range`: x's per-channel max |x| for
    the dynamic path, when the caller has it. The BN-folded kernel and bias
    are kept on the module as well, until conv's or bn's tensors change."""
    def fold():
        scale, shift = bn.scale_shift()
        return _hwio(conv) * scale, shift
    kernel, shift = kept_pack(module, f"_int8_fold_{name}", (conv.weight, *bn.buffers()),
                              x.dtype, fold)
    amax = getattr(module, f"{name}_amax", None) if static else None
    if static and amax is None:
        raise ValueError(f"{name}: static int8 without a range buffer (the module was "
                         "built under another FUTURE_OD_INT8_SKIP or fused gate, or the "
                         "fused gate's shape condition fails on this input)")
    qrange = 255.0 if nonneg else quant.QMAX
    if amax is not None and not module.calibrating:
        kept = kept_pack(module, f"_int8_{name}", (conv.weight, *bn.buffers(), amax), x.dtype,
                         lambda: quant.static_weights(kernel, amax, qrange))
        fn = quant.int8_conv_nonneg_static if nonneg else quant.int8_conv_static
        return fn(x, None, None, shift, relu=relu, kept=kept, **geometry)
    if amax is not None:
        amax.copy_(torch.maximum(amax, quant.observe_channel_amax(x, nonneg=nonneg)))
    fn = quant.int8_conv_nonneg if nonneg else quant.int8_conv
    return fn(x, kernel, shift, relu=relu, x_range=x_range, **geometry)


def kept_pack(module: nn.Module, attr: str, tensors, dtype, build):
    """`build()`, the pack of `tensors` for the fused kernels in `dtype`, kept
    on `module` as `attr` until one of them is replaced, moved, cast or
    written in place. The pack holds plain tensors without autograd history,
    also when it is built in inference mode. Tensors made in inference mode
    keep no version count, so their pack is built anew at every call. Under
    `torch.export` the pack is traced as the graph's own ops, so an exported
    program repacks at every call and follows a `load_state_dict` of its
    weights."""
    if torch.compiler.is_compiling():
        return build()
    key = None if any(t.is_inference() for t in tensors) else (
        dtype, *((id(t), t.data_ptr(), t.dtype, t._version) for t in tensors))
    kept = getattr(module, attr, None)
    if key is None or kept is None or kept[0] != key:
        with torch.inference_mode(False), torch.no_grad():
            kept = (key, build())
        setattr(module, attr, kept)
    return kept[1]


def space_to_depth(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, H/2, W/2, 4C), channel order (di, dj, c)."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // 2, 2, W // 2, 2, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, H // 2, W // 2, 4 * C)


def stem_weights_to_space_to_depth(w7: torch.Tensor) -> torch.Tensor:
    """The (7, 7, 3, 64) HWIO stem kernel -> the exactly equivalent
    (4, 4, 12, 64) kernel over space-to-depth input: packed-kernel index kp
    and intra-pixel offset di map to unpacked index ki = 2·kp + di - 1
    (outside [0, 7) -> zero weight)."""
    kh, kw, c_in, c_out = w7.shape
    assert (kh, kw) == (7, 7)
    w4 = w7.new_zeros((4, 4, 2, 2, c_in, c_out))
    for kp in range(4):
        for lp in range(4):
            for di in range(2):
                for dj in range(2):
                    ki, kj = 2 * kp + di - 1, 2 * lp + dj - 1
                    if 0 <= ki < 7 and 0 <= kj < 7:
                        w4[kp, lp, di, dj] = w7[ki, kj]
    return w4.reshape(4, 4, 4 * c_in, c_out)


def space_to_depth4(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, H/4, W/4, 16C), channel order (di, dj, c)."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // 4, 4, W // 4, 4, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, H // 4, W // 4, 16 * C)


def stem_weights_to_s2d4(w7: torch.Tensor) -> torch.Tensor:
    """The (7, 7, 3, 64) HWIO stem kernel -> the exactly equivalent
    (3, 3, 48, 256) kernel over 4x space-to-depth input. A packed cell holds
    a 4x4 pixel tile, i.e. a 2x2 group of the stride-2 conv's outputs, so the
    packed conv (kernel 3, pad 1) emits all four as output channels in
    (a, b, c) order: 7x7 output pixel (2p+a, 2q+b, c) lands in cell (p, q).
    Packed kernel index kp and intra-cell offset di map to unpacked index
    ki = 4·kp + di - 2a - 1 (outside [0, 7) -> zero weight; each ki has one
    (kp, di), so coverage is exact)."""
    kh, kw, c_in, c_out = w7.shape
    assert (kh, kw) == (7, 7)
    w3 = w7.new_zeros((3, 3, 4, 4, c_in, 2, 2, c_out))
    for kp in range(3):
        for lp in range(3):
            for di in range(4):
                for dj in range(4):
                    for a in range(2):
                        for b in range(2):
                            ki, kj = 4 * kp + di - 2 * a - 1, 4 * lp + dj - 2 * b - 1
                            if 0 <= ki < 7 and 0 <= kj < 7:
                                w3[kp, lp, di, dj, :, a, b] = w7[ki, kj]
    return w3.reshape(3, 3, 16 * c_in, 4 * c_out)


def s2d4_stem_pool(y: torch.Tensor) -> torch.Tensor:
    """maxpool 3x3/2 pad 1 taken directly on the s2d(4) stem conv's packed
    output y (B, P, Q, (a, b, C)), with no depth-to-space transpose.

    Pool output (p, q) covers conv rows 2p-1 .. 2p+1 = packed (p-1, a=1),
    (p, a=0), (p, a=1), and columns likewise, so the 3x3 window factorizes
    into a column max over the b slices, then a row max over the a slices.
    The inputs are post-ReLU (>= 0) and every window holds a real pixel, so
    zero-padding the shifted slices equals the reference -inf padding."""
    C = y.shape[-1] // 4
    y00, y01, y10, y11 = (y[..., i * C:(i + 1) * C] for i in range(4))

    def shift_w(t):  # t[:, :, q - 1], zero at q = 0
        return F.pad(t, (0, 0, 1, 0))[:, :, :-1]

    def shift_h(t):  # t[:, p - 1], zero at p = 0
        return F.pad(t, (0, 0, 0, 0, 1, 0))[:, :-1]

    col0 = torch.maximum(torch.maximum(shift_w(y01), y00), y01)
    col1 = torch.maximum(torch.maximum(shift_w(y11), y10), y11)
    return torch.maximum(torch.maximum(shift_h(col1), col0), col1)


def _hwio(conv: nn.Conv2d) -> torch.Tensor:
    return conv.weight.permute(2, 3, 1, 0)


def _matrix(conv: nn.Conv2d) -> torch.Tensor:
    """1x1 conv weight as an (in, out) matrix."""
    return conv.weight[:, :, 0, 0].t()


class FrozenBatchNorm2d(nn.Module):
    """BatchNorm with constant statistics and affine (buffers, never
    updated): y = (x - mean) * weight / sqrt(var + eps) + bias."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.register_buffer("weight", torch.ones(features))
        self.register_buffer("bias", torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def scale_shift(self):
        """The affine (scale, shift) applied — folded into the preceding
        conv by the fused kernels."""
        scale = self.weight * torch.rsqrt(self.running_var + self.eps)
        return scale, self.bias - self.running_mean * scale

    def forward(self, x):  # NCHW
        scale, shift = self.scale_shift()
        return x * scale[:, None, None] + shift[:, None, None]


class Bottleneck(nn.Module):
    """torchvision-v1 bottleneck: 1x1 -> 3x3(stride, dilation) -> 1x1 (x4)."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1, dilation: int = 1,
                 downsample: bool = False, stage: int = 0, int8: bool = False,
                 int8_static: bool = False):
        super().__init__()
        self.stride, self.dilation, self.stage = stride, dilation, stage
        self.int8, self.int8_static, self.calibrating = int8, int8_static, False
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = FrozenBatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride=stride, padding=dilation,
                               dilation=dilation, bias=False)
        self.bn2 = FrozenBatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, 4 * planes, 1, bias=False)
        self.bn3 = FrozenBatchNorm2d(4 * planes)
        self.downsample = None
        if downsample:
            self.downsample = nn.Sequential(
                nn.Conv2d(inplanes, 4 * planes, 1, stride=stride, bias=False),
                FrozenBatchNorm2d(4 * planes),
            )
        if int8_static and str(stage + 1) not in int8_skip() and not self.fusable():
            for name, c in (("conv1", inplanes), ("conv2", planes), ("conv3", planes)) + (
                    (("downsample_conv", inplanes),) if downsample else ()):
                self.register_buffer(f"{name}_amax", torch.zeros(c))

    def fusable(self) -> bool:
        """The fused gate's conditions that do not depend on the input."""
        return (
            self.stride == 1
            and self.dilation == 1
            and str(self.stage) in os.environ.get("FUTURE_OD_FUSE_STAGES", "01")
            and fused_resnet_allowed()
        )

    def use_fused(self, x) -> bool:
        return not self.training and x.shape[2] % 8 == 0 and self.fusable()

    def fused_weights(self, dtype) -> BottleneckWeights:
        """The block's BN-folded weights packed for the fused kernel in
        `dtype`, kept until a parameter or buffer changes (`kept_pack`)."""
        return kept_pack(self, "_fused", (*self.parameters(), *self.buffers()), dtype,
                         lambda: self._pack_fused(dtype))

    def _pack_fused(self, dtype) -> BottleneckWeights:
        s1, t1 = self.bn1.scale_shift()
        s2, t2 = self.bn2.scale_shift()
        s3, t3 = self.bn3.scale_shift()
        wd = bd = None
        if self.downsample is not None:
            sd, bd = self.downsample[1].scale_shift()
            wd = _matrix(self.downsample[0]) * sd
        return pack_bottleneck(
            dtype,
            _matrix(self.conv1) * s1, t1,
            _hwio(self.conv2) * s2, t2,
            _matrix(self.conv3) * s3, t3,
            wd, bd,
        )

    def forward(self, x):  # NCHW, channels_last
        if self.use_fused(x):
            out = fused_bottleneck_packed(x.permute(0, 2, 3, 1), self.fused_weights(x.dtype))
            return out.permute(0, 3, 1, 2)
        skipped = str(self.stage + 1) in int8_skip()
        if self.int8 and not self.training and not skipped:
            return self.int8_forward(x.permute(0, 2, 3, 1), self.int8_static).permute(0, 3, 1, 2)
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


    def int8_forward(self, x, static: bool):
        """The block on the int8 path: NHWC x (post-ReLU) -> NHWC, every
        convolution on the zero-point path, the residual add and relu in x's
        dtype. On the dynamic path conv1 and the downsample share one range
        pass over x."""
        d = self.dilation
        x_range = None
        if self.downsample is not None and (not static or self.calibrating):
            x_range = quant.channel_range(x)
        out = _int8_conv(self, "conv1", x, self.conv1, self.bn1, static, True, True, x_range)
        out = _int8_conv(self, "conv2", out, self.conv2, self.bn2, static, True, True,
                         strides=(self.stride, self.stride), padding=((d, d), (d, d)),
                         dilation=(d, d))
        out = _int8_conv(self, "conv3", out, self.conv3, self.bn3, static, True, False)
        identity = x
        if self.downsample is not None:
            identity = _int8_conv(self, "downsample_conv", x, self.downsample[0],
                                  self.downsample[1], static, True, False, x_range,
                                  strides=(self.stride, self.stride))
        return F.relu(out + identity)


class ResNet(nn.Module):
    """ResNet trunk returning the layer4 feature map (stride 32, or 16 with
    dilation)."""

    def __init__(self, name_id: str = "resnet50", dilation: bool = False,
                 freeze_stem: bool = False, space_to_depth: bool = False, int8: bool = False,
                 int8_static: bool = False):
        super().__init__()
        self.freeze_stem, self.space_to_depth = freeze_stem, space_to_depth
        self.int8, self.int8_static, self.calibrating = int8, int8_static, False
        if space_to_depth:  # padding (2, 1) is applied with F.pad in forward
            self.conv1 = nn.Conv2d(4 * 3, 64, 4, bias=False)
        else:
            self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = FrozenBatchNorm2d(64)
        if int8_static and not fused_stem_allowed():
            self.register_buffer("conv1_amax", torch.zeros(self.conv1.in_channels))
        inplanes, planes = 64, 64
        for stage_idx, num_blocks in enumerate(STAGE_BLOCKS[name_id]):
            stride = 1 if stage_idx == 0 else 2
            dil = 1
            if stage_idx == 3 and dilation:
                stride, dil = 1, 2
            blocks = []
            for block_idx in range(num_blocks):
                # torchvision: a dilated stage's first block keeps the
                # previous dilation (1)
                blocks.append(Bottleneck(
                    inplanes, planes,
                    stride=stride if block_idx == 0 else 1,
                    dilation=1 if block_idx == 0 else dil,
                    downsample=(block_idx == 0),
                    stage=stage_idx,
                    int8=int8,
                    int8_static=int8_static,
                ))
                inplanes = 4 * planes
            setattr(self, f"layer{stage_idx + 1}", nn.Sequential(*blocks))
            planes *= 2
        self.num_stages = len(STAGE_BLOCKS[name_id])
        if freeze_stem:
            for module in (self.conv1, self.layer1):
                module.requires_grad_(False)

    def use_fused_stem(self, x) -> bool:
        return (
            not self.training
            and x.shape[1] % 32 == 0
            and x.shape[2] % 4 == 0
            and fused_stem_allowed()
        )

    def use_s2d_math(self, x) -> bool:
        """FUTURE_OD_S2D_STEM=1 on a 7x7 model with even H and W."""
        return (
            not self.space_to_depth
            and os.environ.get("FUTURE_OD_S2D_STEM", "0") == "1"
            and x.shape[1] % 2 == 0
            and x.shape[2] % 2 == 0
        )

    def fused_stem_weights(self, dtype) -> StemWeights:
        """conv1 with bn1 folded in, as the s2d (4, 4, 12, 64) kernel (the
        7x7 one transformed unless the model is built with it), packed for
        the fused stem in `dtype` and kept until conv1's or bn1's tensors
        change (`kept_pack`)."""
        def build():
            scale, shift = self.bn1.scale_shift()
            w4 = _hwio(self.conv1)
            if not self.space_to_depth:
                w4 = stem_weights_to_space_to_depth(w4)
            return pack_stem(dtype, w4 * scale, shift)

        tensors = (*self.conv1.parameters(), *self.bn1.parameters(), *self.bn1.buffers())
        return kept_pack(self, "_fused_stem", tensors, dtype, build)

    def stem(self, x):
        """(B, H, W, 3) or, with space_to_depth, host-packed (B, H/2, W/2,
        12) video, float or uint8 -> the pooled stem output, NCHW."""
        fused = self.use_fused_stem(x)  # on the video as it came in
        if self.space_to_depth and x.shape[-1] != 4 * 3:
            x = space_to_depth(x)
        dtype = self.conv1.weight.dtype
        x = device_normalize(x, dtype) if x.dtype == torch.uint8 else x.to(dtype)
        if fused:
            if not self.space_to_depth:
                x = space_to_depth(x)
            return fused_stem_packed(x, self.fused_stem_weights(dtype)).permute(0, 3, 1, 2)
        s2d_math = self.use_s2d_math(x)
        if self.int8 and not self.training and "stem" not in int8_skip() and not s2d_math:
            geometry = ({"padding": ((2, 1), (2, 1))} if self.space_to_depth else
                        {"strides": (2, 2), "padding": ((3, 3), (3, 3))})
            x = _int8_conv(self, "conv1", x, self.conv1, self.bn1, self.int8_static, False,
                           True, **geometry)
            return F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, 1)
        if self.space_to_depth:
            x = self.conv1(F.pad(x.permute(0, 3, 1, 2), (2, 1, 2, 1)))
        elif s2d_math:
            w4 = stem_weights_to_space_to_depth(_hwio(self.conv1)).permute(3, 2, 0, 1)
            x = F.conv2d(F.pad(space_to_depth(x).permute(0, 3, 1, 2), (2, 1, 2, 1)), w4)
        else:
            x = self.conv1(x.permute(0, 3, 1, 2))
        return F.max_pool2d(F.relu(self.bn1(x)), 3, 2, 1)

    def forward(self, x):
        """x: video frames (see `stem`) -> NCHW (channels_last) features."""
        below_cut = (torch.no_grad() if self.freeze_stem and self.training
                     else contextlib.nullcontext())
        with below_cut:
            x = self.layer1(self.stem(x))
        for i in range(1, self.num_stages):
            x = getattr(self, f"layer{i + 1}")(x)
        return x


class CDetrBackbone(nn.Module):
    """ResNet trunk + 1x1 projection to hidden_dim: (B, H, W, 3) (or its
    12-channel packing, with space_to_depth) -> (B, H/32, W/32, hidden_dim)."""

    def __init__(self, hidden_dim: int = 256, name_id: str = "resnet50",
                 dilation: bool = False, freeze_stem: bool = False,
                 space_to_depth: bool = False, int8: bool = False, int8_static: bool = False):
        super().__init__()
        self.body = ResNet(name_id, dilation, freeze_stem, space_to_depth, int8, int8_static)
        self.input_proj = nn.Conv2d(2048, hidden_dim, 1)

    def forward(self, x):
        return self.input_proj(self.body(x)).permute(0, 2, 3, 1)


def init_conv_(conv: nn.Conv2d, generator) -> None:
    """The JAX package's conv init: variance_scaling(2.0, fan_out, normal),
    zero bias."""
    fan_out = conv.out_channels * conv.kernel_size[0] * conv.kernel_size[1]
    with torch.no_grad():
        conv.weight.normal_(0.0, math.sqrt(2.0 / fan_out), generator=generator)
        if conv.bias is not None:
            conv.bias.zero_()
