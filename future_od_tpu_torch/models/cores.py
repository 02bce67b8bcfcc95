"""Model cores (port of future_od_tpu/models/cores.py, the flagship's parts):
per-frame encoding, the recurrent frame-memory detector and FuturePredCore.

Images are NHWC; features (B, L, h, w, D) channels-last. All frames run the
backbone and the per-frame encoder as one folded (B·L) batch. The detector
runs "attend one at a time": one decoder pass per frame with an image memory
of up to num_images frames. Without slotstates a non-final frame's decoder
output is never read, so that pass is skipped (the recurrence carries only
the raw frame features).
"""
from __future__ import annotations

import math
from typing import List

import torch
from torch import nn

from future_od_tpu_torch.models.decoder import TransformerDecoder
from future_od_tpu_torch.models.encoder import TransformerEncoder
from future_od_tpu_torch.models.layers import MLP
from future_od_tpu_torch.models.precision import cast_like
from future_od_tpu_torch.models.resnet import CDetrBackbone
from future_od_tpu_torch.ops.misc import inverse_sigmoid
from future_od_tpu_torch.ops.posenc import spatial_encoding, spatio_temporal_encoding


class ImuEncoder(nn.Sequential):
    """IMU embedding MLP: Linear(imu_dim -> width) -> ReLU -> Linear(-> dim)
    (keys `0` and `2`)."""

    def __init__(self, imu_dim: int, dim: int, width: int = 128):
        super().__init__(nn.Linear(imu_dim, width), nn.ReLU(), nn.Linear(width, dim))


class SeparateEncoder(nn.Module):
    """Per-frame feature extraction: backbone on the folded (B·L) frames,
    IMU -> egodeep token, per-frame transformer encoder over the h·w tokens
    with egodeep cross-attention."""

    def __init__(self, hidden_dim: int, imu_dim: int, enc_layers: int = 6,
                 enc_heads: int = 8, ff_dim: int = 2048, dropout: float = 0.1,
                 backbone_name: str = "resnet50", backbone_dilation: bool = False,
                 freeze_stem: bool = False, backbone_space_to_depth: bool = False):
        super().__init__()
        self.backbone = CDetrBackbone(hidden_dim, backbone_name, backbone_dilation, freeze_stem,
                                      backbone_space_to_depth)
        self.imu_layers = ImuEncoder(imu_dim, hidden_dim)
        self.transformer = None
        if enc_layers > 0:
            self.transformer = TransformerEncoder(enc_layers, hidden_dim, enc_heads, ff_dim, dropout)

    def forward(self, images, imu=None):
        """images (B, L, H, W, C), C = 3 (or 12, host-packed, with the
        space-to-depth stem); imu (B, L, imu_dim). Returns features
        (B, L, h, w, D) and egodeep (B, L, D) or None."""
        B, L, H, W, C = images.shape
        features = self.backbone(images.reshape(B * L, H, W, C))
        _, h, w, D = features.shape
        egodeep = None if imu is None else self.imu_layers(cast_like(imu, features))
        if self.transformer is not None:
            pos = spatial_encoding(h, w, D, device=features.device)
            pos = cast_like(pos.reshape(1, h * w, D), features)
            tokens = features.reshape(B * L, h * w, D)
            ego_tok = None if egodeep is None else egodeep.reshape(B * L, 1, D)
            features = self.transformer(tokens, pos, ego_tok)
        return features.reshape(B, L, h, w, D), egodeep


class CDetrDetectorSpatioTemporal(nn.Module):
    """Recurrent conditional-DETR detection head in "attend one at a time"
    mode, first layer special "always": learned query embeddings, one decoder
    pass per frame over the current frame plus up to num_images-1 remembered
    ones; only the final frame's prediction is returned: its final decoder
    level, and in training with `aux_loss` also the earlier levels
    (`aux_outputs`); in eval too when the caller asks (`aux_levels`, the
    eval step's loss)."""

    def __init__(self, num_classes: int, hidden_dim: int, num_queries: int = 300,
                 dec_layers: int = 6, dec_heads: int = 8, ff_dim: int = 2048,
                 dropout: float = 0.1, num_images: int = 1, aux_loss: bool = False):
        super().__init__()
        self.num_queries, self.hidden_dim, self.num_images = num_queries, hidden_dim, num_images
        self.aux_loss = aux_loss
        self.decoder = TransformerDecoder(
            dec_layers, hidden_dim, dec_heads, ff_dim, dropout, num_images=num_images
        )
        self.class_embed = nn.Linear(hidden_dim, num_classes)
        self.bbox_embed = MLP(hidden_dim, hidden_dim, 4, 3)
        self.query_embed = nn.Embedding(num_queries, hidden_dim)

    def reset_heads_(self, generator) -> None:
        """Focal-prior class bias, zero bbox delta head, N(0, 1) queries."""
        prior_prob = 0.01
        with torch.no_grad():
            self.class_embed.bias.fill_(-math.log((1 - prior_prob) / prior_prob))
            self.bbox_embed.layers[-1].weight.zero_()
            self.bbox_embed.layers[-1].bias.zero_()
            self.query_embed.weight.normal_(0.0, 1.0, generator=generator)

    def forward(self, features, pos_enc, egodeep=None, aux_levels: bool = False):
        """features (B, L, h, w, D); pos_enc (L, h, w, D) or (B, L, h, w, D);
        egodeep (B, L, D) or None; aux_levels: return the aux levels in eval
        mode too."""
        B, L, h, w, D = features.shape
        frames = features.reshape(B, L, h * w, D)
        memory: List[torch.Tensor] = []
        for l in range(L - 1):
            # a non-final frame's decoder pass is dead: only the raw frame
            # joins the image memory
            memory = ([frames[:, l]] + memory)[: self.num_images - 1]
        pos = cast_like(pos_enc, features).expand(B, L, h, w, D)[:, -1].reshape(B, h * w, D)
        ego = egodeep[:, -1:] if egodeep is not None else None
        return self.detect(frames[:, -1], pos, ego, memory, aux_levels)

    def detect(self, frame_features, pos_embed, egodeep, memory: List[torch.Tensor],
               aux_levels: bool = False):
        """One decoder pass over the current frame + remembered frames."""
        B = frame_features.shape[0]
        query_pos = self.query_embed.weight[None].expand(B, self.num_queries, self.hidden_dim)
        query_content = torch.zeros_like(query_pos)
        image_content_lst = [frame_features] + memory
        image_pos_lst = [pos_embed for _ in image_content_lst]
        hs, reference = self.decoder(
            query_content, query_pos, image_content_lst, image_pos_lst,
            first_layer_special=True, egodeep=egodeep,
        )  # hs (num_layers, B, M, D); reference (B, M, 2)
        ref_logit = inverse_sigmoid(reference)

        def heads(levels):  # (..., B, M, D) -> logits, sigmoid boxes
            deltas = self.bbox_embed(levels)
            coords = torch.cat([deltas[..., :2] + ref_logit, deltas[..., 2:]], dim=-1)
            return self.class_embed(levels), torch.sigmoid(coords)

        # the final level alone in inference; the aux levels in one batched
        # call in training and in the eval step
        final_class, final_coord = heads(hs[-1])
        out = {"pred_logits": final_class, "pred_boxes": final_coord}
        if self.aux_loss and (self.training or aux_levels):
            aux_class, aux_coord = heads(hs[:-1])
            out["aux_outputs"] = [
                {"pred_logits": aux_class[i], "pred_boxes": aux_coord[i]}
                for i in range(hs.shape[0] - 1)
            ]
        return out


class FuturePredCore(nn.Module):
    """The paper's main model: drop the future frame, encode the past,
    predict the future frame's boxes. Positional encodings are spatial only
    (the flagship's no_temporal_pos)."""

    def __init__(self, separate_encoder: SeparateEncoder,
                 detector: CDetrDetectorSpatioTemporal):
        super().__init__()
        self.separate_encoder = separate_encoder
        self.detector = detector

    def forward(self, images, imu=None, aux_levels: bool = False):
        images = images[:, :-1]
        if imu is not None:
            imu = imu[:, :-1]
        features, egodeep = self.separate_encoder(images, imu)
        B, L, h, w, D = features.shape
        pos_enc = spatio_temporal_encoding(L, h, w, D, no_temporal=True, device=features.device)
        return self.detector(features, pos_enc, egodeep, aux_levels)
