"""The stem study's kernels (port of the Pallas kernels of tools/bench_stem.py).

Each wrapper launches one kernel of `csrc/stem_variants.cu` on CUDA tensors
and runs its plain PyTorch version on CPU tensors:

- `matmul_pool` (kernel A, replaces `_kernelA`): materialized patches
  (B, 2Hp+1, Js, 192) times w (192, 64) + bias, relu, 3x3/2 max pool;
- `im2col_pool` (B, `_kernelB`) and `im2col_pool16` (B16, `_kernelB16`): the
  same, with the patches gathered from the padded space-to-depth rows
  (B, 2Hp+4, Js, 12 or 16), w (192 or 256, 64);
- `tap_conv` (D, `_kernelD`): the s2d(4) stem conv as 9 tap products over
  (B, Hp+2, Wp+2, 128) with w9 (9, 128, 256), relu, the packed
  (B, Hp, Wp, 256) output (models/resnet.py::s2d4_stem_pool pools it).
  D is an implicit GEMM on the tensor cores (bf16 `mma.sync`, one f32 sum
  over the (tap, channel) reduction rows); A, B and B16 compute on the CUDA
  cores in f32.

The operand layouts are the TPU tool's (tools/bench_stem.py::pallasA etc.
build them; so does future_od_tpu_torch/tools/bench_stem.py). Conv coordinate
i in [0, 2Hp] is conv row i - 1 and j in [0, 2Wp] conv column j - 1, so
row 0 and column 0 are the pool's padding: their values are masked out of
the max (they are real conv values of a window over real pixels, and relu
can make them positive).

`tile_p` is the TPU kernel's row tile. It writes only Hp // tile_p tiles, so
where tile_p does not divide Hp its output's last rows are never written;
every function here raises ValueError on such shapes instead. The CUDA
kernels tile for the card, whatever tile_p is.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from future_od_tpu_torch.ops import _kernels
from future_od_tpu_torch.ops.fused_resnet import STEM_COUT, STEM_TAPS

LIB = "stem_variants"
PATCH_K = 16 * 12  # kernel A's patch columns: 4x4 taps x 12 channels
D_CIN, D_COUT = 128, 256  # kernel D's channels: s2d(4)'s 48, zero-padded; 4 x 64 packed


def _check_tile(name: str, hp: int, tile_p: int) -> None:
    if tile_p <= 0 or hp % tile_p:
        raise ValueError(
            f"{name}: Hp {hp} is not a multiple of tile_p {tile_p}; the TPU kernel "
            f"would leave the last {hp % tile_p if tile_p > 0 else hp} rows unwritten"
        )


def _check_dtype(name: str, x: torch.Tensor) -> None:
    if x.dtype not in _kernels.DTYPE_CODES:
        raise ValueError(f"{name}: dtype {x.dtype}; want f32 or bf16")


def pool_plain(conv: torch.Tensor, wp: int) -> torch.Tensor:
    """The kernels' pool: conv (B, 2Hp+1, >= 2Wp+1, C) f32 post-relu values in
    conv coordinates -> (B, Hp, Wp, C), each output the max over i in
    2p .. 2p+2, j in 2q .. 2q+2, with row 0 and column 0 out of every max."""
    conv = conv[:, :, : 2 * wp + 1].clone()
    conv[:, 0] = float("-inf")
    conv[:, :, 0] = float("-inf")
    return F.max_pool2d(conv.permute(0, 3, 1, 2), 3, 2).permute(0, 2, 3, 1)


def matmul_pool_plain(patches, w, bias, wp: int) -> torch.Tensor:
    """Plain version of `matmul_pool`: the product in f32 of the values the
    kernel reads (w in the patches' dtype), + bias, relu, `pool_plain`,
    rounded once to the patches' dtype."""
    dt = patches.dtype
    conv = patches[:, :, : 2 * wp + 1].float() @ w.to(dt).float() + bias.float()
    return pool_plain(F.relu(conv), wp).to(dt)


def matmul_pool(patches: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, wp: int,
                tile_p: int = 8) -> torch.Tensor:
    """Kernel A: patches (B, 2Hp+1, Js, 192), Js >= 2wp+1, row i / column j
    holding the 16 taps x 12 channels conv position (i, j) reads; w (192, 64)
    (cast to the patches' dtype); bias (64,) f32 -> the pooled
    (B, Hp, wp, 64) in the patches' dtype, f32 sums."""
    name = "stem_a"
    B, n, js, k = patches.shape
    hp = (n - 1) // 2
    if n % 2 == 0 or k != PATCH_K or js < 2 * wp + 1 or w.shape != (PATCH_K, STEM_COUT):
        raise ValueError(f"{name}: patches {tuple(patches.shape)} w {tuple(w.shape)} wp {wp}")
    _check_tile(name, hp, tile_p)
    _check_dtype(name, patches)
    if patches.device.type == "cpu":
        return matmul_pool_plain(patches, w, bias, wp)
    patches = patches.contiguous()
    w = w.to(patches.dtype).contiguous()
    bias = bias.float().contiguous()
    _kernels.check_cuda_operands(name, patches, w, bias)
    out = torch.empty((B, hp, wp, STEM_COUT), dtype=patches.dtype, device=patches.device)
    _kernels.call(
        LIB, "fod_stem_a", patches.data_ptr(), w.data_ptr(), bias.data_ptr(), out.data_ptr(),
        B, hp, wp, js, _kernels.DTYPE_CODES[patches.dtype], _kernels.stream_of(patches),
        device=patches.device,
    )
    _kernels.launch_counts[name] += 1
    return out


def im2col_pool_plain(sp, w, bias, wp: int) -> torch.Tensor:
    """Plain version of `im2col_pool` and `im2col_pool16`: the patch matrix
    of the padded s2d rows sp (B, 2Hp+4, Js, C), (B, 2Hp+1, 2wp+1, 16C) with
    taps in (di, dj, c) order, through `matmul_pool_plain`."""
    n = sp.shape[1] - 3
    patches = torch.cat(
        [sp[:, di:di + n, dj:dj + 2 * wp + 1] for di in range(4) for dj in range(4)], dim=-1)
    return matmul_pool_plain(patches, w, bias, wp)


def _im2col_pool(name: str, channels: int, sp, w, bias, wp: int, tile_p: int) -> torch.Tensor:
    B, nrow, js, c = sp.shape
    hp = (nrow - 4) // 2
    if (c != channels or nrow % 2 or hp <= 0 or js < 2 * wp + 4
            or w.shape != (16 * channels, STEM_COUT)):
        raise ValueError(f"{name}: sp {tuple(sp.shape)} w {tuple(w.shape)} wp {wp}")
    _check_tile(name, hp, tile_p)
    _check_dtype(name, sp)
    if sp.device.type == "cpu":
        return im2col_pool_plain(sp, w, bias, wp)
    sp = sp.contiguous()
    w = w.to(sp.dtype).contiguous()
    bias = bias.float().contiguous()
    _kernels.check_cuda_operands(name, sp, w, bias)
    out = torch.empty((B, hp, wp, STEM_COUT), dtype=sp.dtype, device=sp.device)
    _kernels.call(
        LIB, f"fod_{name}", sp.data_ptr(), w.data_ptr(), bias.data_ptr(), out.data_ptr(),
        B, hp, wp, js, _kernels.DTYPE_CODES[sp.dtype], _kernels.stream_of(sp),
        device=sp.device,
    )
    _kernels.launch_counts[name] += 1
    return out


def im2col_pool(sp: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, wp: int,
                tile_p: int = 8) -> torch.Tensor:
    """Kernel B: the s2d input padded by (3, 1) rows and (3, >= 1) columns,
    sp (B, 2Hp+4, Js, 12), Js >= 2wp+4; w (192, 64); bias (64,) f32 ->
    `matmul_pool` of its patches, (B, Hp, wp, 64)."""
    return _im2col_pool("stem_b", 12, sp, w, bias, wp, tile_p)


def im2col_pool16(sp: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, wp: int,
                  tile_p: int = 8) -> torch.Tensor:
    """Kernel B16: as `im2col_pool` with the channels zero-padded 12 -> 16:
    sp (B, 2Hp+4, Js, 16), w (256, 64)."""
    return _im2col_pool("stem_b16", 16, sp, w, bias, wp, tile_p)


def tap_conv_plain(xp: torch.Tensor, w9: torch.Tensor) -> torch.Tensor:
    """Plain version of `tap_conv`: both operands rounded to bf16, the 9 tap
    products summed in f32, relu, rounded once to xp's dtype."""
    B, h2, w2, _ = xp.shape
    hp, wp = h2 - 2, w2 - 2
    x = xp.to(torch.bfloat16).float()
    w = w9.to(torch.bfloat16).float()
    acc = sum(x[:, t // 3:t // 3 + hp, t % 3:t % 3 + wp] @ w[t] for t in range(9))
    return F.relu(acc).to(xp.dtype)


def tap_conv(xp: torch.Tensor, w9: torch.Tensor, tile_p: int = 8) -> torch.Tensor:
    """Kernel D: the s2d(4) input padded by 1 all round, xp (B, Hp+2, Wp+2,
    128) (48 real channels, zero-padded), w9 (9, 128, 256) tap-major (cast to
    bf16) -> relu of the 3x3 conv, (B, Hp, Wp, 256) in xp's dtype, the
    channels in packed (a, b, c) order. Operands round to bf16 whatever xp's
    dtype, as the TPU kernel's do; f32 sums."""
    name = "stem_d"
    B, h2, w2, c = xp.shape
    hp, wp = h2 - 2, w2 - 2
    if c != D_CIN or hp <= 0 or wp <= 0 or w9.shape != (9, D_CIN, D_COUT):
        raise ValueError(f"{name}: xp {tuple(xp.shape)} w9 {tuple(w9.shape)}")
    _check_tile(name, hp, tile_p)
    _check_dtype(name, xp)
    if xp.device.type == "cpu":
        return tap_conv_plain(xp, w9)
    xp = xp.contiguous()
    w9 = w9.to(torch.bfloat16).contiguous()
    _kernels.check_cuda_operands(name, xp, w9)
    if xp.data_ptr() % 16 or w9.data_ptr() % 16:
        raise ValueError(f"{name}: operands must be 16-byte aligned (16-byte async copies)")
    out = torch.empty((B, hp, wp, D_COUT), dtype=xp.dtype, device=xp.device)
    _kernels.call(
        LIB, "fod_stem_d", xp.data_ptr(), w9.data_ptr(), out.data_ptr(), B, hp, wp,
        _kernels.DTYPE_CODES[xp.dtype], _kernels.stream_of(xp),
        device=xp.device,
    )
    _kernels.launch_counts[name] += 1
    return out


def tap_conv_info(dtype: torch.dtype) -> dict:
    """Kernel D's resources on the current card for xp's storage type:
    registers a thread, static and dynamic shared bytes a block, local
    (spill) bytes a thread, resident blocks an SM. Launches nothing."""
    out = (ctypes.c_int * 5)()
    _kernels.call(LIB, "fod_stem_d_info", _kernels.DTYPE_CODES[dtype], ctypes.addressof(out))
    keys = ("registers", "static_smem_bytes", "dynamic_smem_bytes", "local_bytes",
            "blocks_per_sm")
    return dict(zip(keys, out))


def tap_conv_ops(B: int, hp: int, wp: int) -> int:
    """Operations of kernel D's own products at B x hp x wp output pixels:
    all 9 x 128 reduction rows and 256 channels (its design floor; the
    stem's real work is `stem_ops`)."""
    return 2 * B * hp * wp * 9 * D_CIN * D_COUT


def stem_ops(B: int, hp: int, wp: int) -> int:
    """Operations of one stem over B images whose pooled output is hp x wp:
    the 7x7/2 conv's products at its (2hp) x (2wp) positions, the 147 real
    taps (not the s2d kernels' structural zeros, nor D's zero channels)."""
    return 2 * B * (2 * hp) * (2 * wp) * STEM_TAPS * STEM_COUT
