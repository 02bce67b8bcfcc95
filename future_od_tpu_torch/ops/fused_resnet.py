"""Fused ResNet blocks (port of future_od_tpu/ops/fused_resnet.py).

- `fused_bottleneck` launches `csrc/fused_bottleneck.cu`, which replaces the
  Pallas TPU kernel `_bottleneck_kernel`: a stride-1 bottleneck
  1x1 -> 3x3 -> 1x1 (+ identity or 1x1 downsample residual) with BN folded
  into the weights and f32 biases, intermediates kept on chip, the products
  on the tensor cores (bf16 as stored, f32 as three TF32 products).
  `fused_bottleneck_packed` is the same over weights packed once
  (`pack_bottleneck`).
- `fused_stem` launches `csrc/fused_stem.cu`, which replaces `_stem_kernel`:
  the 7x7/2 stem conv as a 4x4/1 conv over 2x2 space-to-depth input, + bias,
  ReLU and the 3x3/2 max pool (padding -inf), the conv output kept on chip,
  the conv an implicit GEMM on the tensor cores. `fused_stem_packed` is the
  same over weights packed once (`pack_stem`).
- `fused_bottleneck_v2` and `fused_layer1` launch `csrc/bottleneck_variants.cu`,
  which replaces the kernel-study tool's `_v2_kernel` and `_v3_kernel`
  (tools/bench_fused_bottleneck.py): the bottleneck with a choice of row tile
  and of the 3x3's reduction order (im2col), and all of layer1's three chained
  bottlenecks in one kernel with the chain on chip. Both run K2's tile stages
  (`csrc/bottleneck_tile.cuh`) on the tensor cores.

All take NHWC tensors and HWIO / (in, out) weights as the JAX functions do.
On CPU tensors they run `bottleneck_plain` / `stem_plain` / `layer1_plain`,
the plain versions of the same functions; on CUDA tensors they launch the
kernel or raise. `fused_bottleneck_packed` and `fused_stem_packed`, the
model's calls, are the `torch.library` ops `fod::fused_bottleneck` and
`fod::fused_stem` (the packed weights as tensor arguments, None for an
absent downsample), which `torch.export` keeps as nodes.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from future_od_tpu_torch.ops import _kernels

BOTTLENECK = "fused_bottleneck"
STEM = "fused_stem"
BOTTLENECK_CMIDS = (64, 128)  # widths the kernel is instantiated for
BOTTLENECK_COUT_STEP = 128  # output channels a pass of the kernel (bf16; f32 64)
BOTTLENECK_CIN_STEP = 64  # its staged reduction chunk (bf16; f32 32)
VARIANTS = "bottleneck_variants"
V2_CMIDS = (64, 128, 256)  # widths fod_bottleneck_v2 is instantiated for
# the shape fod_fused_layer1 takes: layer1's input from the stem, 64 channels
LAYER1_CIN, LAYER1_CMID, LAYER1_COUT, LAYER1_BLOCKS = 64, 64, 256, 3
STEM_CIN, STEM_COUT = 12, 64
STEM_TAPS = 7 * 7 * 3  # taps of the 7x7/2 conv; the s2d 4x4 kernel's other 45 are zeros
STEM_K = 16 * STEM_CIN  # the s2d kernel's reduction rows, (dy, dx, c) order: 192


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


def _check_bottleneck(name, cin, dtype, w1, w2, w3, wd, bd, cmids, cin_step) -> None:
    """Raise unless the kernels take these shapes and this dtype of x."""
    cmid, cout = w1.shape[1], w3.shape[1]
    if (
        cmid not in cmids
        or cin % cin_step
        or cout % BOTTLENECK_COUT_STEP
        or w1.shape != (cin, cmid)
        or w2.shape != (3, 3, cmid, cmid)
        or w3.shape != (cmid, cout)
        or (wd is None) != (bd is None)
        or (wd is None and cin != cout)
        or (wd is not None and wd.shape != (cin, cout))
    ):
        raise ValueError(
            f"{name}: unsupported shapes cin {cin} w1 {tuple(w1.shape)} "
            f"w3 {tuple(w3.shape)} (cmid in {cmids}, cin % "
            f"{cin_step} == 0, cout % {BOTTLENECK_COUT_STEP} == 0)"
        )
    if dtype not in _kernels.DTYPE_CODES:
        raise ValueError(f"{name}: dtype {dtype}; want f32 or bf16")


def _bottleneck_operands(dt, w1, b1, w2, b2, w3, b3, wd=None, bd=None) -> List:
    """The weights as the kernels read them: matrices in the storage type
    (w2 as the (9*cmid, cmid) im2col matrix, rows in (dy, dx, c) order),
    f32 biases, contiguous; None for an absent downsample."""
    cmid = w1.shape[1]
    mats = [w.to(dt).contiguous() for w in (w1, w2.reshape(9 * cmid, cmid), w3)]
    vecs = [b.float().contiguous() for b in (b1, b2, b3)]
    ops = [mats[0], vecs[0], mats[1], vecs[1], mats[2], vecs[2]]
    if wd is None:
        return ops + [None, None]
    return ops + [wd.to(dt).contiguous(), bd.float().contiguous()]


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


class BottleneckWeights(NamedTuple):
    """A bottleneck's weights as `fused_bottleneck`'s kernel reads them
    (`pack_bottleneck`), in the kernel's argument order."""

    w1: torch.Tensor  # (cin, cmid), storage type
    b1: torch.Tensor  # f32
    w2: torch.Tensor  # (9*cmid, cmid), rows in (dy, dx, c) order
    b2: torch.Tensor
    w3: torch.Tensor  # (cmid, cout)
    b3: torch.Tensor
    wd: Optional[torch.Tensor]  # (cin, cout) downsample, or None
    bd: Optional[torch.Tensor]
    w1t: Optional[torch.Tensor]  # bf16: w1 and w2 transposed; None in f32
    w2t: Optional[torch.Tensor]


def pack_bottleneck(dtype, w1, b1, w2, b2, w3, b3, wd=None, bd=None) -> BottleneckWeights:
    """The weights of `fused_bottleneck` packed for x of `dtype`: matrices in
    the storage type, f32 biases, and in bf16 w1 and w2 transposed as well
    (a column contiguous, for the kernel's recompute of intermediates near a
    bf16 rounding boundary). Weights that do not change are packed once
    (models/resnet.py's Bottleneck keeps its pack) and passed to
    `fused_bottleneck_packed`."""
    ops = _bottleneck_operands(dtype, w1, b1, w2, b2, w3, b3, wd, bd)
    transposed = [None, None]
    if dtype == torch.bfloat16:
        transposed = [ops[0].t().contiguous(), ops[2].t().contiguous()]
    return BottleneckWeights(*ops, *transposed)


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
    return fused_bottleneck_packed(x, pack_bottleneck(x.dtype, w1, b1, w2, b2, w3, b3, wd, bd))


def fused_bottleneck_packed(x: torch.Tensor, p: BottleneckWeights) -> torch.Tensor:
    """`fused_bottleneck` of x (B, H, W, cin) and weights packed for x's
    dtype by `pack_bottleneck`: the op `fod::fused_bottleneck`, which
    `torch.export` keeps as one node (off the CPU its operands are checked
    before it)."""
    if x.device.type != "cpu":
        _check_packed_bottleneck(x, *p)
    return _FUSED_BOTTLENECK(x, *p)


def _check_packed_bottleneck(x, w1, b1, w2, b2, w3, b3, wd, bd, w1t, w2t) -> None:
    """Raise unless K2 takes x and these packed weights: the built widths,
    weights packed for x's dtype, one CUDA device."""
    cmid = w1.shape[1]
    _check_bottleneck(BOTTLENECK, x.shape[3], x.dtype, w1, w2.reshape(3, 3, cmid, cmid), w3,
                      wd, bd, BOTTLENECK_CMIDS, BOTTLENECK_CIN_STEP)
    if w1.dtype != x.dtype or (w1t is None) != (x.dtype == torch.float32):
        raise ValueError(f"{BOTTLENECK}: weights packed for {w1.dtype}, x is {x.dtype}")
    ops = (x, w1, b1, w2, b2, w3, b3, wd, bd, w1t, w2t)
    _kernels.check_cuda_device(BOTTLENECK, *(t for t in ops if t is not None))


def _fused_bottleneck_plain(x, w1, b1, w2, b2, w3, b3, wd, bd, w1t, w2t):
    cmid = w1.shape[1]
    return bottleneck_plain(x, w1, b1, w2.reshape(3, 3, cmid, cmid), b2, w3, b3, wd,
                            bd).contiguous()


def _fused_bottleneck_fake(x, w1, b1, w2, b2, w3, b3, wd, bd, w1t, w2t):
    return x.new_empty(x.shape[:3] + w3.shape[1:])


def _fused_bottleneck_cuda(x, w1, b1, w2, b2, w3, b3, wd, bd, w1t, w2t):
    _check_packed_bottleneck(x, w1, b1, w2, b2, w3, b3, wd, bd, w1t, w2t)
    B, H, W, cin = x.shape
    cmid, cout = w1.shape[1], w3.shape[1]
    ops = [x.contiguous(), w1, b1, w2, b2, w3, b3, wd, bd, w1t, w2t]
    _kernels.check_cuda_operands(BOTTLENECK, *(t for t in ops if t is not None))
    if any(t.data_ptr() % 16 for t in ops if t is not None):
        raise ValueError(f"{BOTTLENECK}: operands must be 16-byte aligned (16-byte async copies)")
    out = torch.empty((B, H, W, cout), dtype=x.dtype, device=x.device)
    _kernels.call(
        BOTTLENECK, "fod_fused_bottleneck",
        *(_ptr(t) for t in ops), out.data_ptr(), B, H, W, cin, cmid, cout,
        _kernels.DTYPE_CODES[x.dtype], _kernels.stream_of(x),
        device=x.device,
    )
    _kernels.launch_counts[BOTTLENECK] += 1
    return out


def fused_bottleneck_info(cmid: int, dtype: torch.dtype, downsample: bool) -> Dict[str, int]:
    """The kernel instantiation's resources on the current card: registers a
    thread, static and dynamic shared bytes a block (the downsample's x
    chunks take more), local (spill) bytes a thread, resident blocks an SM.
    Launches nothing."""
    out = (ctypes.c_int * 5)()
    _kernels.call(BOTTLENECK, "fod_fused_bottleneck_info", cmid, _kernels.DTYPE_CODES[dtype],
                  int(downsample), ctypes.addressof(out))
    keys = ("registers", "static_smem_bytes", "dynamic_smem_bytes", "local_bytes",
            "blocks_per_sm")
    return dict(zip(keys, out))


def bottleneck_plan(layer1: bool, tile_h: int, cmid: int, im2col: bool,
                    dtype: torch.dtype, downsample: bool = False) -> Dict[str, int]:
    """How `fused_bottleneck_v2` (layer1 False) or `fused_layer1` (True)
    lays out a launch on the current card: the column tile a block owns with
    its tile_h rows, the 3x3's reduction rows a chain (k_chunk: 9 cmid with
    im2col, cmid for nine tap chains), shared memory bytes a block, blocks
    resident at once, the rows of a band (a block computes its tile_h rows
    band_h at a time), and the kernel's registers, local (spill) bytes a
    thread and blocks an SM."""
    out = (ctypes.c_int * 8)()
    _kernels.call(VARIANTS, "fod_bottleneck_plan", int(layer1), tile_h, cmid, int(im2col),
                  int(downsample), _kernels.DTYPE_CODES[dtype], ctypes.addressof(out))
    return dict(zip(("tile_w", "k_chunk", "smem_bytes", "resident_blocks", "band_h",
                     "registers", "local_bytes", "blocks_per_sm"), out))


def fused_bottleneck_v2(x, w1, b1, w2, b2, w3, b3, wd=None, bd=None, tile_h: int = 8,
                        im2col: bool = True) -> torch.Tensor:
    """`fused_bottleneck`'s function (its plain version is `bottleneck_plain`),
    with the study tool's choices: a block owns tile_h output rows (by a
    column tile `bottleneck_plan` gives), and the 3x3 runs as one product
    chain over its 9 cmid reduction rows (im2col) or as 9 tap chains summed
    in f32. cmid 64, 128 or 256. The weights are packed at each call
    (`pack_bottleneck`: in bf16, w1 and w2 transposed too)."""
    if x.device.type == "cpu":
        return bottleneck_plain(x, w1, b1, w2, b2, w3, b3, wd, bd)
    name = "bottleneck_v2"
    _check_bottleneck(name, x.shape[3], x.dtype, w1, w2, w3, wd, bd, V2_CMIDS,
                      BOTTLENECK_CIN_STEP)
    if tile_h <= 0:
        raise ValueError(f"{name}: tile_h {tile_h}")
    B, H, W, cin = x.shape
    cmid, cout = w1.shape[1], w3.shape[1]
    x = x.contiguous()
    ops = list(pack_bottleneck(x.dtype, w1, b1, w2, b2, w3, b3, wd, bd))
    _kernels.check_cuda_operands(name, x, *(t for t in ops if t is not None))
    out = torch.empty((B, H, W, cout), dtype=x.dtype, device=x.device)
    _kernels.call(
        VARIANTS, "fod_bottleneck_v2",
        x.data_ptr(), *(_ptr(t) for t in ops), out.data_ptr(), B, H, W, cin, cmid, cout,
        tile_h, int(im2col), _kernels.DTYPE_CODES[x.dtype], _kernels.stream_of(x),
        device=x.device,
    )
    _kernels.launch_counts[name] += 1
    return out


def _block_args(bk):
    return (bk["w1"], bk["b1"], bk["w2"], bk["b2"], bk["w3"], bk["b3"], bk.get("wd"),
            bk.get("bd"))


def layer1_plain(x, blocks) -> torch.Tensor:
    """Plain version of `fused_layer1`: the blocks' `bottleneck_plain` in
    turn, each output rounded to x's dtype as the TPU kernel rounds it."""
    for bk in blocks:
        x = bottleneck_plain(x, *_block_args(bk))
    return x


def fused_layer1(x, blocks, tile_h: int = 8) -> torch.Tensor:
    """ResNet-50 layer1 in one kernel: x (B, H, W, 64) through three chained
    stride-1 bottlenecks (`blocks`: dicts w1, b1, w2 (3, 3, 64, 64), b2, w3,
    b3, and wd, bd in block 0 only; cmid 64, cout 256), each block's output
    rounded to x's dtype. A block of the kernel owns tile_h output rows by
    `bottleneck_plan`'s column tile, computed in bands of its band_h rows
    with the two inner outputs in shared memory."""
    if x.device.type == "cpu":
        return layer1_plain(x, blocks)
    name = "fused_layer1"
    if len(blocks) != LAYER1_BLOCKS or "wd" not in blocks[0] or any("wd" in b for b in blocks[1:]):
        raise ValueError(f"{name}: want {LAYER1_BLOCKS} blocks, a downsample in block 0 only")
    cin = x.shape[3]
    if cin != LAYER1_CIN:
        raise ValueError(f"{name}: x has {cin} channels; want layer1's {LAYER1_CIN}")
    for i, bk in enumerate(blocks):
        _check_bottleneck(name, cin if i == 0 else LAYER1_COUT, x.dtype, bk["w1"], bk["w2"],
                          bk["w3"], bk.get("wd"), bk.get("bd"), (LAYER1_CMID,),
                          BOTTLENECK_CIN_STEP)
        if bk["w3"].shape[1] != LAYER1_COUT:
            raise ValueError(f"{name}: block {i} cout {bk['w3'].shape[1]}; want {LAYER1_COUT}")
    if tile_h <= 0:
        raise ValueError(f"{name}: tile_h {tile_h}")
    B, H, W, _ = x.shape
    x = x.contiguous()
    ops = [t for bk in blocks for t in pack_bottleneck(x.dtype, *_block_args(bk))]
    _kernels.check_cuda_operands(name, x, *(t for t in ops if t is not None))
    weights = (ctypes.c_void_p * len(ops))(*(_ptr(t) for t in ops))
    out = torch.empty((B, H, W, LAYER1_COUT), dtype=x.dtype, device=x.device)
    _kernels.call(
        VARIANTS, "fod_fused_layer1",
        x.data_ptr(), ctypes.addressof(weights), out.data_ptr(), B, H, W, cin, tile_h,
        _kernels.DTYPE_CODES[x.dtype], _kernels.stream_of(x), device=x.device,
    )
    _kernels.launch_counts[name] += 1
    return out


def layer1_recompute(tile_h: int, tile_w: int, cin: int = 64) -> float:
    """Operations `fused_layer1` does over those its three bottlenecks need:
    block k's 1x1 into h1 runs on the tile grown by 3 - k pixels a side, its
    3x3, expansion and downsample on the tile grown by 2 - k."""
    def grown(g):
        return (tile_h + 2 * g) * (tile_w + 2 * g) / (tile_h * tile_w)

    c, m = LAYER1_COUT, LAYER1_CMID
    done = need = 0.0
    for k in range(LAYER1_BLOCKS):
        first = (cin if k == 0 else c) * m
        rest = 9 * m * m + m * c + (cin * c if k == 0 else 0)
        done += first * grown(3 - k) + rest * grown(2 - k)
        need += first + rest
    return done / need


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


class StemWeights(NamedTuple):
    """The stem's weights as `fused_stem`'s kernel reads them (`pack_stem`)."""

    w4: torch.Tensor  # (4, 4, 12, 64) HWIO, BN-folded, storage type: the plain version's
    bias: torch.Tensor  # (64,) f32
    frag: torch.Tensor  # w4's (192, 64) matrix in the kernel's fragment order


def stem_fragment_order(bf16: bool) -> torch.Tensor:
    """Flat indices into the stem's (192, 64) weight matrix (rows (dy, dx, c))
    in the order csrc/fused_stem.cu's lanes load their mma B fragments: for
    each k-step, each pair of n-tiles jp and each lane (g, t), 16 bytes holding
    (b0, b1) of n-tile 2jp, then of 2jp + 1, n = 8 n-tile + g. bf16
    (m16n8k16): b0 is rows 2t, 2t + 1 of the k-step's 16, b1 rows 2t + 8, +
    9, two values a 32-bit word, the lower row in the low half. f32 (tf32
    m16n8k8): b0 is row t of the k-step's 8, b1 row t + 4. A tensor made at
    each call over indices computed once (a tensor made under `torch.export`
    is the trace's own, and must not be kept)."""
    return torch.from_numpy(_stem_fragment_indices(bf16))


@functools.lru_cache(maxsize=None)
def _stem_fragment_indices(bf16: bool) -> np.ndarray:
    step = 16 if bf16 else 8
    ks, jp, lane, word = np.meshgrid(np.arange(STEM_K // step), np.arange(4), np.arange(32),
                                     np.arange(4), indexing="ij")
    g, t, j, which = lane // 4, lane % 4, 2 * jp + word // 2, word % 2
    if bf16:
        k = (step * ks + 2 * t + 8 * which)[..., None] + np.arange(2)
        n = np.broadcast_to((8 * j + g)[..., None], k.shape)
    else:
        k, n = step * ks + t + 4 * which, 8 * j + g
    return (k * STEM_COUT + n).reshape(-1)


def pack_stem(dtype, w4, bias) -> StemWeights:
    """The stem's BN-folded s2d kernel w4 (4, 4, 12, 64) and bias packed for
    x of `dtype`: w4 in the storage type, as its (192, 64) matrix in the
    kernel's fragment order too (`stem_fragment_order`), and the bias in f32.
    models/resnet.py's ResNet packs its stem once (`fused_stem_weights`)."""
    w4 = w4.to(dtype)
    order = stem_fragment_order(dtype == torch.bfloat16).to(w4.device)
    return StemWeights(w4, bias.float().contiguous(), w4.reshape(-1)[order].contiguous())


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
    if w4.shape != (4, 4, STEM_CIN, STEM_COUT):
        raise ValueError(f"{STEM}: unsupported shapes x {tuple(x_s2d.shape)} w4 {tuple(w4.shape)}")
    return fused_stem_packed(x_s2d, pack_stem(x_s2d.dtype, w4, bias))


def fused_stem_packed(x_s2d: torch.Tensor, p: StemWeights) -> torch.Tensor:
    """`fused_stem` of x_s2d (B, Hc, Wc, 12) and weights packed for its
    dtype by `pack_stem`: the op `fod::fused_stem`, which `torch.export`
    keeps as one node (off the CPU its operands are checked before it)."""
    if x_s2d.device.type != "cpu":
        _check_packed_stem(x_s2d, p.frag, p.bias)
    return _FUSED_STEM(x_s2d, p.w4, p.bias, p.frag)


def _check_packed_stem(x_s2d, frag, bias) -> None:
    """Raise unless K3 takes x_s2d and these packed weights: 12 channels,
    even dims, weights packed for x's dtype, one CUDA device."""
    B, Hc, Wc, C = x_s2d.shape
    if C != STEM_CIN or Hc % 2 or Wc % 2 or frag.shape != (STEM_K * STEM_COUT,):
        raise ValueError(f"{STEM}: unsupported shapes x {tuple(x_s2d.shape)} "
                         f"weights {tuple(frag.shape)}")
    dt = x_s2d.dtype
    if dt not in _kernels.DTYPE_CODES or frag.dtype != dt:
        raise ValueError(f"{STEM}: dtypes x {dt}, weights {frag.dtype}; want one of f32, bf16")
    _kernels.check_cuda_device(STEM, x_s2d, frag, bias)


def _fused_stem_plain(x_s2d, w4, bias, frag):
    return stem_plain(x_s2d, w4, bias).contiguous()


def _fused_stem_fake(x_s2d, w4, bias, frag):
    B, Hc, Wc, _ = x_s2d.shape
    return x_s2d.new_empty((B, Hc // 2, Wc // 2, STEM_COUT))


def _fused_stem_cuda(x_s2d, w4, bias, frag):
    _check_packed_stem(x_s2d, frag, bias)
    B, Hc, Wc, _ = x_s2d.shape
    x_s2d = x_s2d.contiguous()
    _kernels.check_cuda_operands(STEM, x_s2d, frag, bias)
    if x_s2d.data_ptr() % 16 or frag.data_ptr() % 16:
        raise ValueError(f"{STEM}: x and the packed weights must be 16-byte aligned")
    out = torch.empty((B, Hc // 2, Wc // 2, STEM_COUT), dtype=x_s2d.dtype, device=x_s2d.device)
    _kernels.call(
        STEM, "fod_fused_stem",
        x_s2d.data_ptr(), frag.data_ptr(), bias.data_ptr(), out.data_ptr(), B, Hc, Wc,
        _kernels.DTYPE_CODES[x_s2d.dtype], _kernels.stream_of(x_s2d),
        device=x_s2d.device,
    )
    _kernels.launch_counts[STEM] += 1
    return out


# fod::fused_bottleneck and fod::fused_stem: CPU the plain versions, CUDA
# the launches, fakes for tracing (torch.library.Library, as K1's op).
_LIB = torch.library.Library("fod", "FRAGMENT")  # the ops live as long as it
_LIB.define("fused_bottleneck(Tensor x, Tensor w1, Tensor b1, Tensor w2, Tensor b2, Tensor w3, "
            "Tensor b3, Tensor? wd, Tensor? bd, Tensor? w1t, Tensor? w2t) -> Tensor")
_LIB.impl("fused_bottleneck", _fused_bottleneck_plain, "CPU")
_LIB.impl("fused_bottleneck", _fused_bottleneck_cuda, "CUDA")
torch.library.register_fake("fod::fused_bottleneck", _fused_bottleneck_fake, lib=_LIB)
_LIB.define("fused_stem(Tensor x_s2d, Tensor w4, Tensor bias, Tensor frag) -> Tensor")
_LIB.impl("fused_stem", _fused_stem_plain, "CPU")
_LIB.impl("fused_stem", _fused_stem_cuda, "CUDA")
torch.library.register_fake("fod::fused_stem", _fused_stem_fake, lib=_LIB)
_FUSED_BOTTLENECK = torch.ops.fod.fused_bottleneck.default
_FUSED_STEM = torch.ops.fod.fused_stem.default


def fused_stem_info(dtype: torch.dtype) -> Dict[str, int]:
    """The kernel instantiation's resources on the current card: registers a
    thread, static and dynamic shared bytes a block, local (spill) bytes a
    thread, resident blocks an SM. Launches nothing."""
    out = (ctypes.c_int * 5)()
    _kernels.call(STEM, "fod_fused_stem_info", _kernels.DTYPE_CODES[dtype], ctypes.addressof(out))
    keys = ("registers", "static_smem_bytes", "dynamic_smem_bytes", "local_bytes",
            "blocks_per_sm")
    return dict(zip(keys, out))


def bottleneck_cost(B, H, W, cin, cmid, cout, downsample: bool, itemsize: int):
    """(operations, bytes) one `fused_bottleneck` call needs at least: its
    four products, x read once, out written once, weights read once."""
    per_px = cin * cmid + 9 * cmid * cmid + cmid * cout + (cin * cout if downsample else 0)
    ops = 2 * B * H * W * per_px
    weights = per_px * itemsize + 4 * (2 * cmid + cout * (2 if downsample else 1))
    nbytes = itemsize * B * H * W * (cin + cout) + weights
    return ops, nbytes


def stem_cost(B, Hc, Wc, itemsize: int, taps: int = STEM_TAPS):
    """(operations, bytes) one `fused_stem` call needs at least: the 7x7/2
    conv's products (`taps` 147, not the s2d kernel's structural zeros; 192
    counts the products the kernel computes), the input and the s2d weights
    read once, the pooled output written once."""
    k = STEM_K
    ops = 2 * B * Hc * Wc * taps * STEM_COUT
    nbytes = itemsize * (B * Hc * Wc * STEM_CIN + B * (Hc // 2) * (Wc // 2) * STEM_COUT
                         + k * STEM_COUT) + 4 * STEM_COUT
    return ops, nbytes


def layer1_cost(B, H, W, cin, itemsize: int):
    """(operations, bytes) one `fused_layer1` call needs at least: the three
    bottlenecks' products (not the halo recompute), x read once, the output
    written once, every weight read once."""
    ops = nbytes = 0
    for k in range(LAYER1_BLOCKS):
        c = cin if k == 0 else LAYER1_COUT
        o, b = bottleneck_cost(B, H, W, c, LAYER1_CMID, LAYER1_COUT, k == 0, itemsize)
        ops, nbytes = ops + o, nbytes + b - itemsize * B * H * W * (c + LAYER1_COUT)
    return ops, nbytes + itemsize * B * H * W * (cin + LAYER1_COUT)
