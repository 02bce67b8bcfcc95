"""Transformer encoder with egodeep, prevout and frame-memory attention (port
of future_od_tpu/models/encoder.py).

Batch-first (B, N, D); the per-frame encoder runs folded over (B·L) on the
batch axis. A layer holds a module only where the JAX layer creates its
parameters: `prevout_attn` under `use_prevout`, `previmage_attn.{i}` for
the first `num_previmages` remembered frames, and `egodeep_attend` with
`norm_eda` under `use_egodeep`.
"""
from __future__ import annotations

from typing import List, Optional

import torch
from torch import nn

from future_od_tpu_torch.models.layers import EgodeepAttention, EncoderAttention, layer_norm


class TransformerEncoderLayer(nn.Module):
    """Self-attention over the image tokens with positional encodings on
    q/k; then cross-attention to the previous frame's encoder output
    (prevout) and to each remembered raw frame; then the egodeep
    cross-attention to the IMU token(s)."""

    def __init__(self, dim: int, num_heads: int, ff_dim: int = 2048, dropout: float = 0.1,
                 num_previmages: int = 0, use_prevout: bool = False,
                 use_egodeep: bool = False):
        super().__init__()
        self.self_attn = EncoderAttention(dim, num_heads, ff_dim, dropout)
        self.prevout_attn = (EncoderAttention(dim, num_heads, ff_dim, dropout)
                             if use_prevout else None)
        self.previmage_attn = nn.ModuleList(
            EncoderAttention(dim, num_heads, ff_dim, dropout) for _ in range(num_previmages)
        )
        self.egodeep_attend = None
        if use_egodeep:
            self.egodeep_attend = EgodeepAttention(dim, num_heads, dropout, ff_dim=ff_dim)
            self.norm_eda = layer_norm(dim)
        self.drop = nn.Dropout(dropout)

    def forward(self, x, image_pos, egodeep=None, prevout: Optional[torch.Tensor] = None,
                image_feature_memory: Optional[List[torch.Tensor]] = None):
        qk = x + image_pos
        x = self.self_attn(x, qk, qk, x)
        if prevout is not None and self.prevout_attn is not None:
            x = self.prevout_attn(x, x + image_pos, prevout + image_pos, prevout)
        for attend, prev in zip(self.previmage_attn, image_feature_memory or []):
            x = attend(x, x + image_pos, prev + image_pos, prev)
        if egodeep is not None and self.egodeep_attend is not None:
            new = self.egodeep_attend(x, image_pos, egodeep)
            x = self.norm_eda(x + self.drop(new))
        return x


class TransformerEncoder(nn.Module):
    """Stack of encoder layers (`layers.{i}`); every layer sees the same
    prevout, frame memory, positions and egodeep tokens."""

    def __init__(self, num_layers: int, dim: int, num_heads: int, ff_dim: int = 2048,
                 dropout: float = 0.1, num_previmages: int = 0, use_prevout: bool = False,
                 use_egodeep: bool = False):
        super().__init__()
        self.layers = nn.ModuleList(
            TransformerEncoderLayer(dim, num_heads, ff_dim, dropout, num_previmages,
                                    use_prevout, use_egodeep)
            for _ in range(num_layers)
        )

    def forward(self, image_features, image_pos, egodeep=None, prevout=None,
                image_feature_memory=None):
        for layer in self.layers:
            image_features = layer(image_features, image_pos, egodeep, prevout,
                                   image_feature_memory)
        return image_features
