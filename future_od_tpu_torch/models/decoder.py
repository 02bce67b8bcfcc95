"""Conditional-DETR transformer decoder with frame memory and egodeep
conditioning (port of future_od_tpu/models/decoder.py).

Carried over exactly: post-norm order (self-attention -> one conditional
image attention per remembered frame -> egodeep attention -> FFN); layer 0
optionally "special" (unscaled query sine, positional projections added into
the content paths); layers >= 1 without a query_pos projection in their
image attentions; one shared final LayerNorm on every level's output.
The slotstates attention is not ported yet (the flagship does not use it).
"""
from __future__ import annotations

from typing import List, Tuple

import torch
from torch import nn

from future_od_tpu_torch.models.layers import (
    MLP,
    EgodeepAttention,
    FeedForward,
    SlotToImageAttention,
    SlotToSlotAttention,
    layer_norm,
)
from future_od_tpu_torch.models.precision import cast_like
from future_od_tpu_torch.ops.posenc import gen_sineembed_for_position


class TransformerDecoderLayer(nn.Module):
    def __init__(self, dim: int, num_heads: int, ff_dim: int = 2048, dropout: float = 0.1,
                 num_images: int = 1, image_attn_query_pos: bool = True):
        super().__init__()
        self.self_attend = SlotToSlotAttention(dim, num_heads, dropout)
        self.norm_sa = layer_norm(dim)
        self.image_attend = nn.ModuleList(
            SlotToImageAttention(dim, num_heads, dropout, use_query_pos=image_attn_query_pos)
            for _ in range(num_images)
        )
        self.norm_ia = nn.ModuleList(layer_norm(dim) for _ in range(num_images))
        self.egodeep_attend = EgodeepAttention(dim, num_heads, dropout, ff_dim=None)
        self.norm_eda = layer_norm(dim)
        self.feedforward = FeedForward(dim, ff_dim, dropout)
        self.norm_out = layer_norm(dim)
        self.drop = nn.Dropout(dropout)

    def forward(self, query_content, query_pos, query_sine,
                image_content_lst: List[torch.Tensor], image_pos_lst: List[torch.Tensor],
                is_first: bool = False, egodeep=None):
        x = query_content
        new = self.self_attend(x, query_pos, x, query_pos)
        x = self.norm_sa(x + self.drop(new))
        # one conditional cross-attention per remembered frame; a shorter
        # memory list skips the later attention modules
        for attend, norm, image_content, image_pos in zip(
            self.image_attend, self.norm_ia, image_content_lst, image_pos_lst
        ):
            new = attend(
                query_content=x,
                query_pos=query_pos if is_first else None,
                query_sine=query_sine,
                key_content=image_content,
                key_pos_flag=is_first,
                key_sine=image_pos,
            )
            x = norm(x + self.drop(new))
        if egodeep is not None:
            new = self.egodeep_attend(x, query_pos, egodeep)
            x = self.norm_eda(x + self.drop(new))
        new = self.feedforward(x)
        return self.norm_out(x + self.drop(new))


class TransformerDecoder(nn.Module):
    """Decoder stack with the reference-point head and the per-layer
    conditional sine scaling; returns every level."""

    def __init__(self, num_layers: int, dim: int, num_heads: int, ff_dim: int = 2048,
                 dropout: float = 0.1, num_images: int = 1):
        super().__init__()
        self.dim = dim
        # only layers after the special first one scale the query sine: a
        # one-layer decoder has no query_scale, as in the JAX package
        self.query_scale = MLP(dim, dim, dim, 2) if num_layers > 1 else None
        self.ref_point_head = MLP(dim, dim, 2, 2)
        self.norm = layer_norm(dim)
        self.layers = nn.ModuleList(
            TransformerDecoderLayer(
                dim, num_heads, ff_dim, dropout, num_images, image_attn_query_pos=(i == 0)
            )
            for i in range(num_layers)
        )

    def forward(self, query_content, query_pos, image_content_lst, image_pos_lst,
                first_layer_special: bool = True,
                egodeep=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """Returns (per-layer outputs (num_layers, B, M, D), reference points
        (B, M, 2))."""
        reference_points = torch.sigmoid(self.ref_point_head(query_pos))
        unscaled_query_sine = cast_like(
            gen_sineembed_for_position(reference_points, self.dim), query_pos)
        intermediate = []
        x = query_content
        for layer_id, layer in enumerate(self.layers):
            if layer_id == 0 and first_layer_special:
                query_sine = unscaled_query_sine
            elif self.query_scale is None:
                raise ValueError("a one-layer decoder runs only with first_layer_special")
            else:
                query_sine = self.query_scale(x) * unscaled_query_sine
            x = layer(
                x, query_pos, query_sine, image_content_lst, image_pos_lst,
                is_first=(layer_id == 0) and first_layer_special,
                egodeep=egodeep,
            )
            intermediate.append(self.norm(x))
        return torch.stack(intermediate, dim=0), reference_points
