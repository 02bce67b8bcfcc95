"""Conditional-DETR transformer decoder with frame memory and egodeep
conditioning (port of future_od_tpu/models/decoder.py).

Carried over exactly: post-norm order (self-attention -> one conditional
image attention per remembered frame -> slotstates attention -> egodeep
attention -> FFN); layer 0 optionally "special" (unscaled query sine,
positional projections added into the content paths); layers >= 1 without a
query_pos projection in their image attentions; one shared final LayerNorm
on every level's output. A layer holds `slotstates_attend`/`norm_ssa` only
under `use_slotstates` and `egodeep_attend`/`norm_eda` only under
`use_egodeep`, where the JAX layer creates their parameters.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

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
                 num_images: int = 1, query_pos_attends: int = 1,
                 use_slotstates: bool = False, use_egodeep: bool = True,
                 store_attention: bool = False):
        super().__init__()
        self.self_attend = SlotToSlotAttention(dim, num_heads, dropout)
        self.norm_sa = layer_norm(dim)
        self.image_attend = nn.ModuleList(
            SlotToImageAttention(dim, num_heads, dropout, use_query_pos=j < query_pos_attends,
                                 store_attention=store_attention)
            for j in range(num_images)
        )
        self.norm_ia = nn.ModuleList(layer_norm(dim) for _ in range(num_images))
        self.slotstates_attend = None
        if use_slotstates:
            self.slotstates_attend = SlotToSlotAttention(dim, num_heads, dropout)
            self.norm_ssa = layer_norm(dim)
        self.egodeep_attend = None
        if use_egodeep:
            self.egodeep_attend = EgodeepAttention(dim, num_heads, dropout, ff_dim=None)
            self.norm_eda = layer_norm(dim)
        self.feedforward = FeedForward(dim, ff_dim, dropout)
        self.norm_out = layer_norm(dim)
        self.drop = nn.Dropout(dropout)

    def forward(self, query_content, query_pos, query_sine,
                image_content_lst: List[torch.Tensor], image_pos_lst: List[torch.Tensor],
                is_first: bool = False, egodeep=None, slotstates_content=None):
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
        if slotstates_content is not None and self.slotstates_attend is not None:
            # the state's positions are the queries' own
            new = self.slotstates_attend(x, query_pos, slotstates_content, query_pos)
            x = self.norm_ssa(x + self.drop(new))
        if egodeep is not None and self.egodeep_attend is not None:
            new = self.egodeep_attend(x, query_pos, egodeep)
            x = self.norm_eda(x + self.drop(new))
        new = self.feedforward(x)
        return self.norm_out(x + self.drop(new))


class TransformerDecoder(nn.Module):
    """Decoder stack with the reference-point head and the per-layer
    conditional sine scaling; returns every level."""

    def __init__(self, num_layers: int, dim: int, num_heads: int, ff_dim: int = 2048,
                 dropout: float = 0.1, num_images: int = 1, use_slotstates: bool = False,
                 use_egodeep: bool = True, store_attention: bool = False,
                 scales_first_layer: bool = False, query_pos_attends: Optional[int] = None):
        super().__init__()
        self.dim = dim
        # the JAX decoder creates query_scale where it first calls it: on the
        # layers after a special first one, on the first layer too when it
        # is not special on some pass (`scales_first_layer`), and on the
        # slotstates. A one-layer decoder whose layer is always special has
        # none. Layer 0's image attentions project query_pos only where a
        # pass with a special first layer reaches them: the first
        # `query_pos_attends` (default all).
        has_scale = num_layers > 1 or use_slotstates or scales_first_layer
        self.query_scale = MLP(dim, dim, dim, 2) if has_scale else None
        if query_pos_attends is None:
            query_pos_attends = num_images
        self.ref_point_head = MLP(dim, dim, 2, 2)
        self.norm = layer_norm(dim)
        self.layers = nn.ModuleList(
            TransformerDecoderLayer(
                dim, num_heads, ff_dim, dropout, num_images,
                query_pos_attends=query_pos_attends if i == 0 else 0,
                use_slotstates=use_slotstates, use_egodeep=use_egodeep,
                store_attention=store_attention,
            )
            for i in range(num_layers)
        )

    def forward(self, query_content, query_pos, image_content_lst, image_pos_lst,
                first_layer_special: bool = True, egodeep=None,
                slotstates_content=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """Returns (per-layer outputs (num_layers, B, M, D), reference points
        (B, M, 2)). The JAX decoder also computes a slotstates sine,
        query_scale(slotstates_content) * unscaled sine, that no attention
        reads; the port leaves it out."""
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
                egodeep=egodeep, slotstates_content=slotstates_content,
            )
            intermediate.append(self.norm(x))
        return torch.stack(intermediate, dim=0), reference_points
