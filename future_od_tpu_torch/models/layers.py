"""Attention primitives and small blocks (port of future_od_tpu/models/layers.py).

Batch-first (B, N, D) throughout. Parameter names follow the reference
PyTorch checkpoint that future_od_tpu/utils/checkpoint_convert.py reads
(`query_content`, `fun.out_proj`, `attn.in_proj_weight`, `mlp.0`, ...), so
`utils/jax_weights.py` is that converter's exact inverse.

`attend_heads` keeps the JAX dispatch, unless FUTURE_OD_DISABLE_FLASH=1:
in inference the flash kernel runs with >= FUTURE_OD_FLASH_MIN_KEYS (1024)
keys and >= FUTURE_OD_FLASH_MIN_QUERIES (256) queries; in training the
differentiable flash kernels with in-kernel dropout run when
FUTURE_OD_TRAIN_FLASH=1 (default off) and there are >= TRAIN_FLASH_MIN_KEYS
(256) keys. Every other attention is a plain einsum + softmax (+ dropout).

Flax's LayerNorm epsilon is 1e-6 (torch's default is 1e-5): every LayerNorm
here passes LN_EPS.

Attention capture (`SlotToImageAttention(store_attention=True)`, the JAX
`sow("intermediates", "attention_weights", ...)`): each call appends the
head-averaged softmax weights (B, Nq, Nk) to the module's `captured` list,
and takes the plain path, as the JAX gate does. FUTURE_OD_PACKED_PROJ=1
runs the projections that share an input as one matmul over their
concatenated weights (the JAX `_packed`); the parameters stay the same.
"""
from __future__ import annotations

import math
import os
from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from future_od_tpu_torch.ops.flash_attention import flash_attention, flash_attention_train

LN_EPS = 1e-6
TRAIN_FLASH_MIN_KEYS = 256
# the JAX kernels' blocks, which fix the in-kernel dropout mask's geometry
TRAIN_FLASH_BLOCKS = (256, 512)


def layer_norm(dim: int) -> nn.LayerNorm:
    return nn.LayerNorm(dim, eps=LN_EPS)


def init_linear_(weight: torch.Tensor, bias: Optional[torch.Tensor], generator) -> None:
    """The JAX package's TorchLinear init: xavier-uniform weight and the
    torch-default U(±1/sqrt(fan_in)) bias."""
    fan_out, fan_in = weight.shape
    a = math.sqrt(6.0 / (fan_in + fan_out))
    with torch.no_grad():
        weight.uniform_(-a, a, generator=generator)
        if bias is not None:
            bound = 1.0 / math.sqrt(fan_in)
            bias.uniform_(-bound, bound, generator=generator)


def packed_proj_enabled() -> bool:
    """Projections that share an input run as one matmul (the JAX gate,
    layers.py:73-82)."""
    return os.environ.get("FUTURE_OD_PACKED_PROJ", "0") == "1"


def packed_linear(x: torch.Tensor, linears: Sequence[nn.Linear]) -> List[torch.Tensor]:
    """Several nn.Linear projections of one input as one F.linear over their
    concatenated weights and biases; the per-projection outputs, in order."""
    weight = torch.cat([lin.weight for lin in linears])
    bias = torch.cat([lin.bias for lin in linears])
    return list(F.linear(x, weight, bias).split([lin.out_features for lin in linears], dim=-1))


def flash_gate(num_queries: int, num_keys: int) -> bool:
    """Whether inference attention goes to the flash kernel (the JAX gate,
    layers.py:157-170, without its not-on-CPU check: on the CPU the
    kernel's wrapper runs the plain version)."""
    if os.environ.get("FUTURE_OD_DISABLE_FLASH", "0") == "1":
        return False
    min_keys = int(os.environ.get("FUTURE_OD_FLASH_MIN_KEYS", 1024))
    min_q = int(os.environ.get("FUTURE_OD_FLASH_MIN_QUERIES", 256))
    return num_keys >= min_keys and num_queries >= min_q


def train_flash_gate(num_keys: int) -> bool:
    """Whether training attention goes to the differentiable flash kernels
    (the JAX gate, layers.py:171-176, without its not-on-CPU check)."""
    if os.environ.get("FUTURE_OD_DISABLE_FLASH", "0") == "1":
        return False
    return os.environ.get("FUTURE_OD_TRAIN_FLASH", "0") == "1" and num_keys >= TRAIN_FLASH_MIN_KEYS


def draw_dropout_seed(rate: float) -> int:
    """The per-call int32 seed of the in-kernel dropout, in [0, 2^31 - 1) as
    the JAX package draws it, from torch's default CPU generator (which the
    train step seeds), so drawing it costs no device sync. 0 at rate 0."""
    if rate <= 0.0:
        return 0
    return int(torch.randint(0, 2**31 - 1, ()))


def attention_core(scale: float, logits, v, dropout: nn.Dropout,
                   capture: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
    """softmax(logits * scale) @ v with attention-weight dropout.
    logits (B, H, Nq, Nk); v (B, Nk, H, dv) -> (B, Nq, H*dv). `capture`
    receives the head-averaged weights (B, Nq, Nk), before the dropout."""
    weights = torch.softmax(logits * scale, dim=-1)
    if capture is not None:
        capture.append(weights.detach().mean(dim=1))
    weights = dropout(weights)
    out = torch.einsum("bhqk,bkhd->bqhd", weights, v)
    return out.reshape(*out.shape[:2], -1)


def attend_heads(qh, kh, vh, scale: float, dropout: nn.Dropout,
                 capture: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
    """Multi-head attention core: qh, kh (B, N, H, d); vh (B, Nk, H, dv)
    -> (B, Nq, H*dv). Operands of mixed dtypes (the JAX package's mixed
    precision, `models/precision.py`) promote as jnp's do. With `capture`
    (a list that receives the head-averaged weights) the plain path runs."""
    dtype = torch.promote_types(torch.promote_types(qh.dtype, kh.dtype), vh.dtype)
    qh, kh, vh = qh.to(dtype), kh.to(dtype), vh.to(dtype)
    q, k, v = qh.transpose(1, 2), kh.transpose(1, 2), vh.transpose(1, 2)  # (B, H, N, d)
    out = None
    if capture is None and dropout.training:
        if train_flash_gate(kh.shape[1]):
            rate = float(dropout.p)
            out = flash_attention_train(q, k, v, draw_dropout_seed(rate), scale, rate,
                                        *TRAIN_FLASH_BLOCKS)
    elif capture is None and flash_gate(qh.shape[1], kh.shape[1]):
        out = flash_attention(q, k, v, scale)
    if out is not None:  # (B, H, Nq, dv)
        out = out.transpose(1, 2)
        return out.reshape(*out.shape[:2], -1)
    logits = torch.einsum("bqhd,bkhd->bhqk", qh, kh)
    return attention_core(scale, logits, vh, dropout, capture)


class MLP(nn.Module):
    """num_layers-deep ReLU MLP (`layers.{i}`)."""

    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int, num_layers: int):
        super().__init__()
        dims = [input_dim] + [hidden_dim] * (num_layers - 1) + [output_dim]
        self.layers = nn.ModuleList(
            nn.Linear(dims[i], dims[i + 1]) for i in range(num_layers)
        )

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x


class FeedForward(nn.Sequential):
    """Linear -> ReLU -> Dropout -> Linear (-> Dropout): keys `0` and `3`."""

    def __init__(self, dim: int, hidden_dim: int, dropout: float = 0.1,
                 dropout_after: bool = False):
        layers = [nn.Linear(dim, hidden_dim), nn.ReLU(), nn.Dropout(dropout),
                  nn.Linear(hidden_dim, dim)]
        if dropout_after:
            layers.append(nn.Dropout(dropout))
        super().__init__(*layers)


class HeadOutput(nn.Module):
    """The reference's input-projection-free MultiheadAttention, of which
    only the output projection holds weights (`<attention>.fun.out_proj`)."""

    def __init__(self, dim: int):
        super().__init__()
        self.out_proj = nn.Linear(dim, dim)


class SlotToSlotAttention(nn.Module):
    """Decoder self-attention: separate content/pos projections for q and k,
    value from content only."""

    def __init__(self, dim: int, num_heads: int, dropout: float = 0.1):
        super().__init__()
        self.dim, self.num_heads = dim, num_heads
        for name in ("query_content", "query_pos", "key_content", "key_pos", "value"):
            setattr(self, name, nn.Linear(dim, dim))
        self.fun = HeadOutput(dim)
        self.attn_drop = nn.Dropout(dropout)

    def forward(self, query_content, query_pos, key_content, key_pos):
        D, H = self.dim, self.num_heads
        if packed_proj_enabled() and query_content is key_content and query_pos is key_pos:
            # the self-attention: 5 projections -> 2 matmuls
            qc, kc, v = packed_linear(query_content,
                                      (self.query_content, self.key_content, self.value))
            qp, kp = packed_linear(query_pos, (self.query_pos, self.key_pos))
            q, k = qc + qp, kc + kp
        else:
            q = self.query_content(query_content) + self.query_pos(query_pos)
            k = self.key_content(key_content) + self.key_pos(key_pos)
            v = self.value(key_content)
        B, Nq, _ = q.shape
        Nk = k.shape[1]
        logits = torch.einsum(
            "bqhd,bkhd->bhqk", q.reshape(B, Nq, H, D // H), k.reshape(B, Nk, H, D // H)
        )
        out = attention_core(
            1.0 / math.sqrt(D // H), logits, v.reshape(B, Nk, H, D // H), self.attn_drop
        )
        return self.fun.out_proj(out)


class EgodeepAttention(nn.Module):
    """Cross-attention to the IMU embedding token(s). With `ff_dim` set,
    appends the reference's norm(out + dropout(out)) -> norm(out + mlp(out))
    block (encoder flavour); the "residual" really is out + dropout(out)."""

    def __init__(self, dim: int, num_heads: int, dropout: float = 0.1,
                 ff_dim: Optional[int] = None):
        super().__init__()
        self.dim, self.num_heads = dim, num_heads
        for name in ("query_content", "query_pos", "key", "value"):
            setattr(self, name, nn.Linear(dim, dim))
        self.fun = HeadOutput(dim)
        self.attn_drop = nn.Dropout(dropout)
        self.ff_dim = ff_dim
        if ff_dim is not None:
            self.drop = nn.Dropout(dropout)
            self.norm1 = layer_norm(dim)
            self.norm2 = layer_norm(dim)
            self.mlp = FeedForward(dim, ff_dim, dropout, dropout_after=True)

    def forward(self, query_content, query_pos, key):
        D, H = self.dim, self.num_heads
        q = self.query_content(query_content) + self.query_pos(query_pos)
        if packed_proj_enabled():
            k, v = packed_linear(key, (self.key, self.value))
        else:
            k, v = self.key(key), self.value(key)
        B, Nq, _ = q.shape
        Nk = k.shape[1]
        logits = torch.einsum(
            "bqhd,bkhd->bhqk", q.reshape(B, Nq, H, D // H), k.reshape(B, Nk, H, D // H)
        )
        out = attention_core(
            1.0 / math.sqrt(D // H), logits, v.reshape(B, Nk, H, D // H), self.attn_drop
        )
        out = self.fun.out_proj(out)
        if self.ff_dim is not None:
            out = self.norm1(out + self.drop(out))
            out = self.norm2(out + self.mlp(out))
        return out


class SlotToImageAttention(nn.Module):
    """Conditional cross-attention: per head, queries concat(content, sine)
    and keys concat(content (+ sine on the first layer), sine), each D/H
    wide, attending into D/H-wide values with scale 1/sqrt(2D/H).
    `use_query_pos=False` is decoder layers >= 1, which have no query_pos
    projection. `store_attention`: each call appends its head-averaged
    weights (B, Nq, Nk) to `captured` (`captured_attention` in
    models/st_detr.py reads them, keyed as the JAX intermediates)."""

    def __init__(self, dim: int, num_heads: int, dropout: float = 0.1,
                 use_query_pos: bool = True, store_attention: bool = False):
        super().__init__()
        self.dim, self.num_heads = dim, num_heads
        self.use_query_pos = use_query_pos
        self.store_attention = store_attention
        self.captured: List[torch.Tensor] = []
        names = ["query_content", "query_sine", "key_content", "key_pos", "value"]
        if use_query_pos:
            names.append("query_pos")
        for name in names:
            setattr(self, name, nn.Linear(dim, dim))
        self.fun = HeadOutput(dim)
        self.attn_drop = nn.Dropout(dropout)

    def forward(self, query_content, query_pos, query_sine, key_content,
                key_pos_flag: bool, key_sine):
        """key_pos_flag: add the projected key sine into the key content
        (the first layer's `key_pos is not None` switch)."""
        D, H = self.dim, self.num_heads
        if packed_proj_enabled():
            v, k_content = packed_linear(key_content, (self.value, self.key_content))
        else:
            v = self.value(key_content)
            k_content = self.key_content(key_content)
        q_content = self.query_content(query_content)
        if self.use_query_pos and query_pos is not None:
            q_content = q_content + self.query_pos(query_pos)
        q_sine = self.query_sine(query_sine)
        k_sine = self.key_pos(key_sine)
        if key_pos_flag:
            k_content = k_content + k_sine
        B, Nq, _ = q_content.shape
        Nk = k_content.shape[1]
        hd = D // H
        qh = torch.cat(
            [q_content.reshape(B, Nq, H, hd), q_sine.reshape(B, Nq, H, hd)], dim=-1
        )
        kh = torch.cat(
            [k_content.reshape(B, Nk, H, hd), k_sine.reshape(B, Nk, H, hd)], dim=-1
        )
        out = attend_heads(
            qh, kh, v.reshape(B, Nk, H, hd), 1.0 / math.sqrt(2 * D // H), self.attn_drop,
            self.captured if self.store_attention else None,
        )
        return self.fun.out_proj(out)


class SelfAttention(nn.Module):
    """nn.MultiheadAttention-style attention with a packed (3D, D) input
    projection; the caller adds positional encodings to q/k."""

    def __init__(self, dim: int, num_heads: int, dropout: float = 0.1):
        super().__init__()
        self.dim, self.num_heads = dim, num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * dim))
        self.out_proj = nn.Linear(dim, dim)
        self.attn_drop = nn.Dropout(dropout)
        self.reset_parameters(None)

    def reset_parameters(self, generator) -> None:
        """Each of q/k/v is its own (D, D) TorchLinear in the JAX package."""
        D = self.dim
        for i in range(3):
            init_linear_(
                self.in_proj_weight[i * D : (i + 1) * D],
                self.in_proj_bias[i * D : (i + 1) * D],
                generator,
            )

    def forward(self, query, key, value):
        D, H = self.dim, self.num_heads
        w, b = self.in_proj_weight, self.in_proj_bias
        if packed_proj_enabled() and query is key:
            # the encoder's self-attention: q and k share src + pos
            q, k = F.linear(query, w[: 2 * D], b[: 2 * D]).split(D, dim=-1)
        else:
            q = F.linear(query, w[:D], b[:D])
            k = F.linear(key, w[D : 2 * D], b[D : 2 * D])
        v = F.linear(value, w[2 * D :], b[2 * D :])
        B, Nq, _ = q.shape
        Nk = k.shape[1]
        out = attend_heads(
            q.reshape(B, Nq, H, D // H),
            k.reshape(B, Nk, H, D // H),
            v.reshape(B, Nk, H, D // H),
            1.0 / math.sqrt(D // H),
            self.attn_drop,
        )
        return self.out_proj(out)


class EncoderAttention(nn.Module):
    """Encoder attention block, post-norm: attention + dropout/norm, FFN + norm."""

    def __init__(self, dim: int, num_heads: int, ff_dim: int, dropout: float = 0.1):
        super().__init__()
        self.attn = SelfAttention(dim, num_heads, dropout)
        self.drop = nn.Dropout(dropout)
        self.norm1 = layer_norm(dim)
        self.norm2 = layer_norm(dim)
        self.mlp = FeedForward(dim, ff_dim, dropout, dropout_after=True)

    def forward(self, src, query_base, key_base, val_base):
        src = self.norm1(src + self.drop(self.attn(query_base, key_base, val_base)))
        return self.norm2(src + self.mlp(src))
