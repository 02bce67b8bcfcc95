"""Transformer encoder with egodeep attention (port of
future_od_tpu/models/encoder.py, the per-frame path the flagship runs).

Batch-first (B, N, D); the per-frame encoder runs folded over (B·L) on the
batch axis. The prevout and frame-memory attentions of the JAX encoder are
not ported yet.
"""
from __future__ import annotations

from torch import nn

from future_od_tpu_torch.models.layers import EgodeepAttention, EncoderAttention, layer_norm


class TransformerEncoderLayer(nn.Module):
    """Self-attention over the image tokens with positional encodings on
    q/k, then the egodeep cross-attention to the IMU token."""

    def __init__(self, dim: int, num_heads: int, ff_dim: int = 2048, dropout: float = 0.1):
        super().__init__()
        self.self_attn = EncoderAttention(dim, num_heads, ff_dim, dropout)
        self.egodeep_attend = EgodeepAttention(dim, num_heads, dropout, ff_dim=ff_dim)
        self.drop = nn.Dropout(dropout)
        self.norm_eda = layer_norm(dim)

    def forward(self, x, image_pos, egodeep=None):
        qk = x + image_pos
        x = self.self_attn(x, qk, qk, x)
        if egodeep is not None:
            new = self.egodeep_attend(x, image_pos, egodeep)
            x = self.norm_eda(x + self.drop(new))
        return x


class TransformerEncoder(nn.Module):
    """Stack of encoder layers (`layers.{i}`)."""

    def __init__(self, num_layers: int, dim: int, num_heads: int, ff_dim: int = 2048,
                 dropout: float = 0.1):
        super().__init__()
        self.layers = nn.ModuleList(
            TransformerEncoderLayer(dim, num_heads, ff_dim, dropout)
            for _ in range(num_layers)
        )

    def forward(self, image_features, image_pos, egodeep=None):
        for layer in self.layers:
            image_features = layer(image_features, image_pos, egodeep)
        return image_features
